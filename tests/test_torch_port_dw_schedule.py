"""The schedule of K2 / K2''s dW reduction (``ops/kernels/binned_conv.py``)
on the CPU: how ``dw_schedule`` splits the groups into chunks, the scratch
it asks for, the waves its grid gives on an H100 at the flagship's shapes,
and which dW kernel each operand dtype launches, through a stubbed loader
(no card, no launch).
"""

import functools

import pytest
import torch

from fusiontransformer_tpu_torch.config.defaults import get_default_cfg
from fusiontransformer_tpu_torch.models.spvcnn import SPVCNN, SubMConv3
from fusiontransformer_tpu_torch.modules.steps import level_caps_for_n
from fusiontransformer_tpu_torch.ops.kernels import LAUNCHES
from fusiontransformer_tpu_torch.ops.kernels import binned_conv as bc

CONFIG = "configs/semantic_kitti/middlefusion.yaml"
BATCH = 10
# The level each ks3 conv of the SPVCNN backbone runs at (L4 is dense).
LEVEL_OF = {"stem0": 0, "stem1": 0, "stage1": 1, "stage2": 2, "stage3": 3,
            "stage4": 4, "up1": 3, "up2": 2, "up3": 1, "up4": 0}
WIDTHS = [(4, 32), (32, 64), (128, 96), (192, 128), (384, 256), (96, 96),
          (1024, 1024)]
DTYPES = [torch.bfloat16, torch.float32]


@functools.lru_cache(maxsize=None)
def flagship_shapes():
    """(V, Cin, Cout) of every slot-map conv of the flagship's train step at
    batch 10, for each capacity bucket: the level caps' ceilings for the
    batch's point buffer, and half of them (adaptive caps of a sparse
    batch)."""
    cfg = get_default_cfg()
    cfg.merge_from_file(CONFIG)
    convs = set()
    for name, m in SPVCNN(cr=1.0).named_modules():
        level = LEVEL_OF.get(name.split("_")[0])
        if isinstance(m, SubMConv3) and level is not None and level < 4:
            convs.add((level, m.kernel.shape[1], m.kernel.shape[2]))
    assert len(convs) == 15
    shapes = set()
    for bucket in cfg.TPU.CAPACITY_BUCKETS:
        caps = level_caps_for_n(cfg, BATCH * bucket)
        for level, cin, cout in convs:
            for v in (caps[level], caps[level] // 16 * 8):
                shapes.add((v, cin, cout))
    return tuple(sorted(shapes))


def chunks(sched, v):
    ng = v // 8
    return [(k * sched.chunk_groups, min(ng, (k + 1) * sched.chunk_groups))
            for k in range(sched.nchunks)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cin,cout", WIDTHS)
@pytest.mark.parametrize("v", [8, 64, 8 * 397, 8 * 8 * 64 + 24, 190720])
def test_every_group_falls_in_exactly_one_chunk(dtype, cin, cout, v):
    sched = bc.dw_schedule(v, cin, cout, dtype)
    parts = chunks(sched, v)
    assert all(a < b for a, b in parts)                 # none empty
    assert [g for a, b in parts for g in range(a, b)] == list(range(v // 8))
    if dtype == torch.bfloat16:
        assert sched.route == 1
        assert sched.chunk_groups % (bc.DW_STEP // 8) == 0   # whole k-steps
        assert sched.tile_m in (32, 64) and sched.tile_n in (32, 64)
    else:
        assert (sched.route, sched.tile_m, sched.tile_n) == (0, 32, 32)


@pytest.mark.parametrize("width,tile", [(4, 32), (32, 32), (64, 64), (96, 32),
                                        (128, 64), (192, 64), (384, 64)])
def test_tiles_pad_the_width_least(width, tile):
    assert bc._tile(width) == tile


@pytest.mark.parametrize("dtype", DTYPES)
def test_scratch_stays_within_budget_at_the_flagship_shapes(dtype):
    for v, cin, cout in flagship_shapes():
        sched = bc.dw_schedule(v, cin, cout, dtype)
        table = 27 * v * 4 if sched.route == 1 else 0
        assert sched.scratch_bytes == (sched.nchunks * 27 * cin * cout * 4
                                       + table)
        assert sched.scratch_bytes <= bc.DW_SCRATCH, (v, cin, cout, sched)


def test_grid_gives_two_waves_at_the_flagship_shapes():
    """Blocks over the most of them the 132 SMs can hold at once: the
    tensor-core kernel at its shared-memory residency, the CUDA-core kernel
    (138 KB of shared memory) at one block an SM."""
    for v, cin, cout in flagship_shapes():
        sched = bc.dw_schedule(v, cin, cout, torch.bfloat16)
        tiles = -(-cin // sched.tile_m) * -(-cout // sched.tile_n)
        resident = bc.SMS * bc.dw_resident_blocks(sched.tile_m, sched.tile_n)
        assert 27 * tiles * sched.nchunks >= 2 * resident, (v, cin, cout)
        sched = bc.dw_schedule(v, cin, cout, torch.float32)
        tiles = -(-cin // 32) * -(-cout // 32)
        assert tiles * sched.nchunks >= 2 * bc.SMS, (v, cin, cout)


def test_resident_blocks_follow_the_ring():
    # 3 stages x 64 voxels x (64 + 64) bf16 = 48 KB: four blocks an SM.
    assert bc.dw_resident_blocks(64, 64) == 4
    assert bc.dw_resident_blocks(64, 32) == 6
    assert bc.dw_resident_blocks(32, 32) == 9


class _StubLib:
    """Stands in for the built library: records each call, returns ``rc``."""

    def __init__(self, rc=0):
        self.rc, self.calls = rc, []

    def __getattr__(self, symbol):
        def fn(*args):
            self.calls.append((symbol, args))
            return self.rc
        return fn


def _operands(dtype, kind, v=8 * 40, cin=32, cout=64, k=5):
    gen = torch.Generator().manual_seed(0)
    feats = torch.randn(v, cin, generator=gen).to(dtype)
    dout = torch.randn(v, cout, generator=gen).to(dtype)
    w = torch.randn(27, cin, cout, generator=gen).to(dtype)
    if kind == "grouped":
        src = torch.zeros((v // 8, 24), dtype=torch.int32)
        return ("ftx_binned_conv_grouped_bwd", bc.BWD_NAME, dout, feats, src,
                torch.full_like(src, 216), w)
    src = torch.zeros((v, k), dtype=torch.int32)
    return ("ftx_binned_conv_slots_bwd", bc.SLOTS_BWD_NAME, dout, feats, src,
            torch.full_like(src, 27), w)


@pytest.mark.parametrize("kind", ["grouped", "slots"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_dtype_picks_the_dw_kernel(monkeypatch, dtype, kind):
    """bf16 operands launch the tensor-core dW (route 1, with its row table
    and its own launch count), f32 operands the CUDA-core one (route 0)."""
    lib = _StubLib()
    monkeypatch.setattr(bc, "load", lambda name: lib)
    symbol, name, dout, feats, src, codes, w = _operands(dtype, kind)
    before = (LAUNCHES[name], LAUNCHES[bc.DW_MMA_NAME])
    dx, dw = bc._run_bwd(name, symbol, dout, feats, src, codes, w, stream=0)
    assert dx.shape == feats.shape and dw.shape == w.shape
    assert dx.dtype == dw.dtype == torch.float32
    (called, args), = lib.calls
    assert called == symbol
    ptrs, ints, stream = args[:10], args[10:20], args[20]
    v, cin = feats.shape
    sched = bc.dw_schedule(v, cin, w.shape[2], dtype)
    assert ints == (v, src.shape[1], cin, w.shape[2], *sched[:5],
                    0 if dtype == torch.float32 else 1)
    assert stream == 0
    mma = dtype == torch.bfloat16
    assert sched.route == int(mma)
    assert (ptrs[6] is not None) == mma                  # the row table
    assert LAUNCHES[name] == before[0] + 1
    assert LAUNCHES[bc.DW_MMA_NAME] == before[1] + int(mma)


@pytest.mark.parametrize("dtype", DTYPES)
def test_a_failed_launch_raises_and_counts_nothing(monkeypatch, dtype):
    monkeypatch.setattr(bc, "load", lambda name: _StubLib(rc=1))
    symbol, name, dout, feats, src, codes, w = _operands(dtype, "grouped")
    before = dict(LAUNCHES)
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        bc._run_bwd(name, symbol, dout, feats, src, codes, w, stream=0)
    assert dict(LAUNCHES) == before
