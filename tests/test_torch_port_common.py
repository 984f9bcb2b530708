"""Shared set-up for the port's CPU tests (``tests/test_torch_port_*.py``).

Inputs are made from numpy seeds and handed to both packages as numpy
arrays; JAX stays on the CPU and the port runs with ``device="cpu"``.  This
module holds helpers only.
"""

import numpy as np

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
