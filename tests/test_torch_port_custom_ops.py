"""The model-path kernels as ``torch.library`` custom ops (``ftx``
namespace), on the CPU: each op passes ``torch.library.opcheck`` (schema,
fake kernel, autograd registration, AOT dispatch), its CPU kernel is its
plain version bit for bit, its fake kernel gives the real result's shapes
and dtypes, and a train step reaches K1 / K2 (or K1' / K2') and K3 at E = 1
and 8 through the ops only.
"""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

from fusiontransformer_tpu_torch.ops.kernels import binned_conv as bc
from fusiontransformer_tpu_torch.ops.kernels import segment_sum as ss

from test_torch_port_common import one_thread  # noqa: F401

V, CIN, COUT, K, S = 64, 12, 20, 9, 24


def _feats(dtype, rs, rows=V, cols=CIN):
    return torch.from_numpy(rs.randn(rows, cols).astype(np.float32)).to(dtype)


def _grouped_maps(rs):
    """Group-pooled maps [V/8, S]: distinct live bins per group, some
    sentinel bins (>= 216) and sentinel rows (V)."""
    bins = np.stack([rs.permutation(216)[:S] for _ in range(V // 8)])
    bins[:, -3:] = 216
    src = rs.randint(0, V + 1, size=bins.shape)
    return (torch.from_numpy(src.astype(np.int32)),
            torch.from_numpy(bins.astype(np.int32)))


def _slot_maps(rs):
    """Per-voxel maps [V, K]: distinct taps per voxel, sentinel taps (27)
    and rows (V)."""
    taps = np.stack([rs.permutation(27)[:K] for _ in range(V)])
    taps[:, -2:] = 27
    src = rs.randint(0, V + 1, size=taps.shape)
    return (torch.from_numpy(src.astype(np.int32)),
            torch.from_numpy(taps.astype(np.int32)))


def _case(name, dtype, seed=0):
    """(op, args, plain version) of one op at small sizes."""
    rs = np.random.RandomState(seed)
    feats = _feats(dtype, rs)
    w = torch.from_numpy(
        (0.1 * rs.randn(27, CIN, COUT)).astype(np.float32)).to(dtype)
    dout = _feats(dtype, rs, cols=COUT)
    if name == "sorted_segment_weighted_sum":
        n, num_out = 300, 40
        ids = np.sort(rs.randint(0, num_out, size=n))
        ids[-20:] = num_out             # padding at the tail
        g = _feats(torch.float32, rs, rows=n, cols=7)
        e = 8 if dtype == torch.bfloat16 else 1
        wt = torch.from_numpy(rs.rand(n, e).astype(np.float32))
        precise = dtype == torch.float32
        return (torch.ops.ftx.sorted_segment_weighted_sum,
                (g, wt, torch.from_numpy(ids.astype(np.int32)), num_out,
                 precise), ss.sorted_segment_weighted_sum_ref)
    grouped = "grouped" in name
    src, codes = _grouped_maps(rs) if grouped else _slot_maps(rs)
    ref = {"binned_conv_grouped_fwd": bc.binned_conv_grouped_ref,
           "binned_conv_slots_fwd": bc.binned_conv_slots_ref,
           "binned_conv_grouped_bwd": bc.binned_conv_grouped_bwd_ref,
           "binned_conv_slots_bwd": bc.binned_conv_slots_bwd_ref}[name]
    args = (feats, src, codes, w)
    if name.endswith("_bwd"):
        args = (dout, *args)
    return getattr(torch.ops.ftx, name), args, ref


OPS = ("binned_conv_grouped_fwd", "binned_conv_slots_fwd",
       "binned_conv_grouped_bwd", "binned_conv_slots_bwd",
       "sorted_segment_weighted_sum")
CASES = [(name, dt) for name in OPS
         for dt in (torch.float32, torch.bfloat16)]
IDS = [f"{n}-{'f32' if d == torch.float32 else 'bf16'}" for n, d in CASES]


@pytest.mark.parametrize("name,dtype", CASES, ids=IDS)
def test_opcheck(name, dtype):
    op, args, _ = _case(name, dtype)
    torch.library.opcheck(op, args)


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.mark.parametrize("name,dtype", CASES, ids=IDS)
def test_cpu_kernel_is_the_plain_version_and_fake_matches(name, dtype):
    op, args, ref = _case(name, dtype)
    got = _as_tuple(op(*args))
    want = _as_tuple(ref(*args))
    assert len(got) == len(want)
    for g, r in zip(got, want):
        assert g.dtype == torch.float32
        assert torch.equal(g, r)
    with FakeTensorMode() as mode:
        fake_args = [mode.from_tensor(a) if torch.is_tensor(a) else a
                     for a in args]
        fake = _as_tuple(op(*fake_args))
    assert [(tuple(f.shape), f.dtype) for f in fake] == \
        [(tuple(g.shape), g.dtype) for g in got]


def test_the_wrappers_call_the_ops_with_checked_operands():
    op, args, _ = _case("binned_conv_slots_fwd", torch.float32)
    feats, src, tap, w = args
    assert torch.equal(bc.binned_conv_slots_fwd(*args), op(*args))
    with pytest.raises(ValueError, match=r"\[V, K\]"):
        bc.binned_conv_slots_fwd(feats, src[:, :0], tap[:, :0], w)
    with pytest.raises(ValueError, match="num_out"):
        ss.sorted_segment_weighted_sum(feats, feats[:, :1],
                                       torch.zeros(V, dtype=torch.int32), -1)


class _OpLog(TorchDispatchMode):
    """The ``ftx`` ops dispatched under it, with K3's weight columns."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.name()
        if name.startswith("ftx::"):
            e = args[1].shape[1] if "segment" in name else None
            self.calls.append((name.split("::")[1], e))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("slot_pool", [True, False],
                         ids=["group-pooled", "per-voxel"])
def test_a_train_step_reaches_the_kernels_through_the_ops(slot_pool):
    from fusiontransformer_tpu_torch.config.defaults import get_default_cfg
    from fusiontransformer_tpu_torch.data.build import build_dataloader
    from fusiontransformer_tpu_torch.models.build import build_model
    from fusiontransformer_tpu_torch.modules import steps
    from fusiontransformer_tpu_torch.solver.build import build_optimizer

    from test_torch_port_common import train_cfg
    cfg = train_cfg(get_default_cfg)
    cfg.defrost()
    cfg.TPU.CONV_SLOT_POOL = slot_pool
    cfg.freeze()
    batch = next(iter(build_dataloader(cfg, "train")))
    model = build_model(cfg, "cpu")
    opt, _ = build_optimizer(cfg, model.parameters())
    step = steps.make_train_step(cfg, model, opt)
    with _OpLog() as log:
        step(steps.device_batch(batch, "cpu"), torch.Generator(),
             steps.batch_level_caps(cfg, batch))
    kind = "grouped" if slot_pool else "slots"
    names = {n for n, _ in log.calls}
    assert names == {f"binned_conv_{kind}_fwd", f"binned_conv_{kind}_bwd",
                     "sorted_segment_weighted_sum"}
    convs = sum(n == f"binned_conv_{kind}_fwd" for n, _ in log.calls)
    assert convs > 0
    assert sum(n == f"binned_conv_{kind}_bwd" for n, _ in log.calls) == convs
    e = sorted({e for n, e in log.calls if e is not None})
    assert e == [1, 8]
