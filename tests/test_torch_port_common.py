"""Shared set-up for the port's CPU tests (``tests/test_torch_port_*.py``).

Inputs are made from numpy seeds and handed to both packages as numpy
arrays; JAX stays on the CPU and the port runs with ``device="cpu"``.  This
module holds helpers only.
"""

import numpy as np
import pytest

H, W = 40, 60
N_POINTS = 900


def tiny_cfg(get_default_cfg, point_capacity=1024, buckets=(),
             dtype="float32"):
    """The small middle-fusion config of ``tests/test_serving.py`` (cr 1,
    ViT 32 px / patch 16 / width 64 / depth 2 / 2 heads), for either
    package's ``get_default_cfg``."""
    cfg = get_default_cfg()
    cfg.MODEL.TYPE = "MiddleFusionTransformer"
    cfg.MODEL.DUAL_HEAD = True
    cfg.MODEL.NUM_CLASSES = 20
    cfg.MODEL.USE_IMAGE = True
    cfg.MODEL.USE_LIDAR = True
    cfg.MODEL.USE_FUSION = True
    cfg.MODEL.middle_feat_block_number = 0
    cfg.MODEL.late_feat_block_number = 1
    cfg.MODEL.VIT_IMG_SIZE = 32
    cfg.MODEL.VIT_PATCH = 16
    cfg.MODEL.VIT_EMBED_DIM = 64
    cfg.MODEL.VIT_DEPTH = 2
    cfg.MODEL.VIT_HEADS = 2
    cfg.DATASET.TYPE = "SyntheticSCN"
    cfg.DATASET.SyntheticSCN.image_height = H
    cfg.DATASET.SyntheticSCN.image_width = W
    cfg.DATASET.SyntheticSCN.num_points = N_POINTS
    cfg.TPU.POINT_CAPACITY = point_capacity
    cfg.TPU.CAPACITY_BUCKETS = tuple(buckets)
    cfg.TPU.COMPUTE_DTYPE = dtype
    cfg.freeze()
    return cfg


def jax_variables(cfg, seed=3):
    """Random JAX params and batch stats for ``cfg`` as numpy trees, with
    non-trivial running statistics so that eval-mode BN is exercised."""
    import jax

    from fusiontransformer_tpu.models.build import build_model
    from fusiontransformer_tpu.modules.SemanticTrainer import init_train_state

    state = init_train_state(cfg, build_model(cfg)[0], None, 1,
                             rng_seed=seed)
    params = jax.tree_util.tree_map(np.asarray, state.params)
    rng = np.random.RandomState(seed)

    def randomize(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = randomize(v)
            elif k == "mean":
                out[k] = (0.2 * rng.randn(*v.shape)).astype(np.float32)
            else:
                out[k] = (0.5 + rng.rand(*v.shape)).astype(np.float32)
        return out

    stats = randomize(jax.tree_util.tree_map(np.asarray, state.batch_stats))
    return params, stats


def record(i, n_points=N_POINTS):
    """A raw request record (the schema of ``tests/test_serving.py``)."""
    from fusiontransformer_tpu_torch.data.synthetic import SyntheticSCN

    gen = SyntheticSCN(split=("test",), num_scans=1, num_points=n_points,
                       image_height=H, image_width=W)
    rng = np.random.RandomState(100 + i)
    points, _, _ = gen._make_scan(rng)
    return {
        "points": points,
        "feats": np.concatenate(
            [points, rng.rand(len(points), 1).astype(np.float32)], 1),
        "img": rng.rand(H, W, 3).astype(np.float32),
        "points_img": gen._project(points),
    }


CLASS_WEIGHTS = [0., 1.58003993, 3.69774469, 3.2460013, 2.65342029,
                 2.61079801, 3.27744058, 3.48282471, 3.45874555, 1.,
                 2.07298878, 1.26831551, 2.65889542, 1.37436805, 1.4891881,
                 1.03083152, 2.25629999, 1.51838281, 2.51986332, 3.08564901]
# Gradient bounds of the train-step comparisons; the reasons are in
# tests/test_torch_port_train.py.
LEAF_RTOL, LEAF_ATOL, MEDIAN_RTOL = 2e-2, 1e-7, 1e-4


def train_cfg(get_cfg, opt="Adam"):
    """tiny_cfg with the flagship's training settings (middlefusion.yaml:
    Adam, wd 5e-4, lambda_xm 0.1, its class weights), batch 2."""
    cfg = tiny_cfg(get_cfg)
    cfg.defrost()
    cfg.OPTIMIZER.TYPE = opt
    cfg.OPTIMIZER.BASE_LR = 1e-2
    cfg.OPTIMIZER.WEIGHT_DECAY = 5e-4
    cfg.TRAIN.CLASS_WEIGHTS = list(CLASS_WEIGHTS)
    cfg.TRAIN.FusionTransformer.lambda_xm = 0.1
    cfg.TRAIN.BATCH_SIZE = 2
    cfg.DATASET.TRAIN = ("train",)
    cfg.DATASET.VAL = ("val",)
    cfg.freeze()
    return cfg


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the importing module's tests (restored
    after): the test session runs several processes on the same cores, and
    torch's CPU thread pools, oversubscribed, slow every process down many
    times over."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# Reading a tensor back to the host: on the card each of these waits for the
# device, which a CUDA-graph capture refuses.
HOST_READS = {"Tensor": ("item", "tolist", "numpy", "cpu", "__bool__",
                         "__int__", "__float__", "nonzero", "bincount",
                         "unique", "masked_select"),
              "torch": ("nonzero", "bincount", "unique", "masked_select")}


def refuse_host_data(monkeypatch, reads=False):
    """From here on, host data cannot enter a tensor op: building a tensor
    from host values, or indexing one with a list or an array, raises.  With
    ``reads``, so does every op of HOST_READS."""
    import torch

    def refuse(*a, **k):
        raise AssertionError("a tensor built from host data inside the step")

    for name in ("tensor", "as_tensor", "from_numpy"):
        monkeypatch.setattr(torch, name, refuse)

    def host_index(idx):
        parts = idx if isinstance(idx, tuple) else (idx,)
        return any(isinstance(p, (list, np.ndarray)) for p in parts)

    for slot in ("__getitem__", "__setitem__"):
        orig = getattr(torch.Tensor, slot)

        def checked(self, idx, *rest, _orig=orig):
            if host_index(idx):
                raise AssertionError(f"a tensor indexed by host data "
                                     f"inside the step: {idx!r}")
            return _orig(self, idx, *rest)

        monkeypatch.setattr(torch.Tensor, slot, checked)
    if not reads:
        return
    for owner, names in HOST_READS.items():
        for name in names:
            def read(*a, _name=name, **k):
                raise AssertionError(f"{_name}: a read back to the host "
                                     f"inside the step")
            monkeypatch.setattr(torch.Tensor if owner == "Tensor" else torch,
                                name, read)


# Datasets and a collate for the loader's worker pool: module-level, so the
# workers unpickle them by import path, and numpy-only at import.
class Draws:
    """Scan i is (i, a draw from numpy's global generator)."""

    def __len__(self):
        return 7

    def __getitem__(self, i):
        return i, int(np.random.randint(1 << 30))


class CudaProbe:
    """Scan i is whether the process that makes it has initialised CUDA."""

    def __len__(self):
        return 4

    def __getitem__(self, i):
        import torch
        return torch.cuda.is_initialized()


def broken_collate(items):
    raise ValueError("bad scan")
