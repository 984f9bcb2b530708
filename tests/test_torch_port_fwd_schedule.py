"""The tensor-core forward of the binned conv (K1, K1', and the dX of K2 /
K2') on the CPU: the tiles ``fwd_schedule`` gives, the route each operand
dtype takes through a stubbed loader (no card, no launch), and the row
table ``bin_rows_ref`` that the kernels read, bit-exact against the JAX
package's tap-major binning of both kinds of map.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusiontransformer_tpu.ops.sparse_conv import (_binned_tap_major,
                                                   _grouped_tap_major)
from fusiontransformer_tpu_torch.ops.kernels import LAUNCHES
from fusiontransformer_tpu_torch.ops.kernels import binned_conv as bc

from test_torch_port_dw_schedule import DTYPES, _StubLib, flagship_shapes

RAGGED_V = [8, 56, 64, 72, 8 * 397, 5504, 19072 - 8]


def _covered(n, tile, tiles):
    """Each index of range(n) once over ``tiles`` tiles of ``tile``."""
    spans = [(i * tile, min(n, (i + 1) * tile)) for i in range(tiles)]
    assert all(a < b for a, b in spans)                  # none empty
    assert [i for a, b in spans for i in range(a, b)] == list(range(n))


@pytest.mark.parametrize("dtype", DTYPES)
def test_every_voxel_falls_in_exactly_one_tile(dtype):
    """At every (V, Cin, Cout) of the flagship's slot-map convs (its 15
    (level, Cin, Cout) shapes at the batch-10 caps), with Cin and Cout
    swapped for dX, and at ragged V."""
    shapes = set(flagship_shapes())
    widths = {(cin, cout) for _, cin, cout in shapes}
    shapes |= {(v, cin, cout) for v in RAGGED_V for cin, cout in widths}
    for v, cin, cout in sorted(shapes):
        for a, b in ((cin, cout), (cout, cin)):
            sched = bc.fwd_schedule(v, a, b, dtype)
            _covered(v, sched.tile_m, sched.tiles_m)
            _covered(b, sched.tile_n, sched.tiles_n)
            if dtype == torch.bfloat16:
                assert sched.route == 1 and sched.tile_m == bc.FWD_TILE_M
                assert sched.tile_n in (32, 64) and sched.tile_k in (32, 64)
                assert sched.tile_k == bc._tile(a)
            else:
                assert sched == (0, 8, b, a, v // 8, 1)


@pytest.mark.parametrize("v,cout,tile_n", [
    (5504, 256, 64),        # L3 at batch 1: 86 x 4 blocks
    (5504, 96, 32),         # 96 pads least at 32
    (1024, 256, 32),        # 16 x 4 blocks < FWD_MIN_BLOCKS: split Cout
    (178048, 32, 32), (178048, 128, 64)])
def test_cout_tile_halves_on_a_small_grid(v, cout, tile_n):
    sched = bc.fwd_schedule(v, 64, cout, torch.bfloat16)
    assert sched.tile_n == tile_n
    if tile_n == 64:
        assert sched.tiles_m * sched.tiles_n >= bc.FWD_MIN_BLOCKS


def _fwd_operands(dtype, kind, v=8 * 40, cin=20, cout=64, k=5):
    gen = torch.Generator().manual_seed(1)
    feats = torch.randn(v, cin, generator=gen).to(dtype)
    w = torch.randn(27, cin, cout, generator=gen).to(dtype)
    if kind == "grouped":
        src = torch.zeros((v // 8, 24), dtype=torch.int32)
        return ("ftx_binned_conv_grouped_fwd", bc.NAME, feats, src,
                torch.full_like(src, 216), w)
    src = torch.zeros((v, k), dtype=torch.int32)
    return ("ftx_binned_conv_slots_fwd", bc.SLOTS_NAME, feats, src,
            torch.full_like(src, 27), w)


COUNTS = (bc.FWD_MMA_NAME, bc.FWD_CORE_NAME)


@pytest.mark.parametrize("kind", ["grouped", "slots"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_dtype_picks_the_forward_kernel(monkeypatch, dtype, kind):
    """bf16 operands launch the tensor-core forward (route 1, the
    ``binned_conv_fwd_mma`` count), f32 the CUDA-core one (route 0,
    ``binned_conv_fwd_cuda_core``); the wrapper's own count either way.
    The forward asks for no scratch: each tile bins its own slot codes."""
    lib = _StubLib()
    monkeypatch.setattr(bc, "load", lambda name: lib)
    symbol, name, feats, src, codes, w = _fwd_operands(dtype, kind)
    before = [LAUNCHES[n] for n in (name, *COUNTS)]
    out = bc._run_fwd(name, symbol, feats, src, codes, w, stream=0)
    v, cin = feats.shape
    cout = w.shape[2]
    assert out.shape == (v, cout) and out.dtype == torch.float32
    (called, args), = lib.calls
    assert called == symbol
    ptrs, ints, stream = args[:5], args[5:13], args[13]
    sched = bc.fwd_schedule(v, cin, cout, dtype)
    mma = dtype == torch.bfloat16
    assert ints == (v, src.shape[1], cin, cout, sched.route, sched.tile_n,
                    sched.tile_k, int(mma))
    assert sched.route == int(mma) and stream == 0
    assert None not in ptrs
    assert [LAUNCHES[n] for n in (name, *COUNTS)] == [
        before[0] + 1, before[1] + mma, before[2] + 1 - mma]


@pytest.mark.parametrize("dtype", DTYPES)
def test_a_failed_forward_launch_raises_and_counts_nothing(monkeypatch,
                                                           dtype):
    monkeypatch.setattr(bc, "load", lambda name: _StubLib(rc=700))
    symbol, name, feats, src, codes, w = _fwd_operands(dtype, "slots")
    before = dict(LAUNCHES)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        bc._run_fwd(name, symbol, feats, src, codes, w, stream=0)
    assert dict(LAUNCHES) == before


@pytest.mark.parametrize("kind", ["grouped", "slots"])
def test_the_backward_passes_one_row_table_to_dx_and_dw(monkeypatch, kind):
    """A bf16 backward hands the C function one row table (scratch that
    both its dX and its dW read), no flipped copy of W, the dW tiles of
    ``dw_schedule`` and the dX tiles of ``fwd_schedule`` with Cin and Cout
    swapped; the table counts against the dW scratch budget."""
    from test_torch_port_dw_schedule import _operands
    lib = _StubLib()
    monkeypatch.setattr(bc, "load", lambda name: lib)
    symbol, name, dout, feats, src, codes, w = _operands(torch.bfloat16, kind)
    bc._run_bwd(name, symbol, dout, feats, src, codes, w, stream=0)
    (_, args), = lib.calls
    wt, rows, ints = args[5], args[6], args[10:22]
    v, cin = feats.shape
    cout = w.shape[2]
    assert wt is None and rows is not None
    dxs = bc.fwd_schedule(v, cout, cin, torch.bfloat16)
    assert ints[-3:-1] == (dxs.tile_n, dxs.tile_k)
    sched = bc.dw_schedule(v, cin, cout, torch.bfloat16)
    assert sched.scratch_bytes == sched.nchunks * 27 * cin * cout * 4 \
        + 27 * v * 4


# --------------------------------------------------------------------------- #
def _grouped_maps(rng, ng, s, cut=None):
    """Random group-pooled maps: each group's live bins distinct, some live
    bins fed by the sentinel row V (padding), then sentinel slots; ``cut``
    drops the slots past it (a pool cut short, as under slot overflow)."""
    v = ng * 8
    src = np.full((ng, s), v, np.int32)
    binp = np.full((ng, s), 216, np.int32)
    for g in range(ng):
        n = rng.randint(0, s + 1)
        binp[g, :n] = rng.choice(216, n, replace=False)
        src[g, :n] = rng.randint(0, v + 1, n)            # V: a padding row
    if cut is not None:
        src[:, cut:], binp[:, cut:] = v, 216
    return src, binp


def _per_voxel_maps(rng, v, k):
    """Per-voxel maps as ``tap_slot_maps`` builds them: the first K live
    taps of each voxel in tap order, then sentinels; K < the live taps
    drops the rest (tap overflow)."""
    live = rng.rand(v, 27) < 0.4
    live[:, 13] = rng.rand(v) < 0.9                      # the center tap
    src = np.full((v, k), v, np.int32)
    tap = np.full((v, k), 27, np.int32)
    dropped = 0
    for u in range(v):
        taps = np.flatnonzero(live[u])
        dropped += max(0, len(taps) - k)
        taps = taps[:k]
        tap[u, :len(taps)] = taps
        src[u, :len(taps)] = rng.randint(0, v, len(taps))
    return src, tap, dropped


def _table_tap_major(rows, x):
    """[V, 27, C] from a row table: x[rows[t, u]] (zero where -1)."""
    v = x.shape[0]
    xe = torch.cat([x, x.new_zeros((1, x.shape[1]))])
    return xe[torch.where(rows >= 0, rows, v).long()].transpose(0, 1)


@pytest.mark.parametrize("cut", [None, 5])
def test_bin_rows_matches_jax_grouped_binning(cut):
    """The row table of group-pooled maps gathers exactly the JAX
    package's ``_grouped_tap_major`` (f32, integer-valued features)."""
    rng = np.random.RandomState(3)
    src, binp = _grouped_maps(rng, 37, 24, cut)
    v = src.shape[0] * 8
    x = np.arange(v * 3, dtype=np.float32).reshape(v, 3) + 1
    want = np.asarray(_grouped_tap_major(jnp.asarray(x), jnp.asarray(src),
                                         jnp.asarray(binp), jnp.float32))
    rows = bc.bin_rows_ref(torch.from_numpy(src), torch.from_numpy(binp))
    assert rows.shape == (27, v) and rows.dtype == torch.int32
    got = _table_tap_major(rows, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (rows >= 0).sum() == ((binp < 216) & (src < v)).sum()


@pytest.mark.parametrize("k", [27, 16, 3])
def test_bin_rows_matches_jax_per_voxel_binning(k):
    """The row table of per-voxel K-slot maps gathers exactly the JAX
    package's ``_binned_tap_major``, without tap overflow (K = 27) and with
    it (K = 16, 3: taps dropped)."""
    rng = np.random.RandomState(k)
    v = 8 * 29
    src, tap, dropped = _per_voxel_maps(rng, v, k)
    assert dropped == 0 if k == 27 else dropped > 0
    x = np.arange(v * 3, dtype=np.float32).reshape(v, 3) + 1
    want = np.asarray(_binned_tap_major(jnp.asarray(x), jnp.asarray(src),
                                        jnp.asarray(tap), jnp.float32))
    rows = bc.bin_rows_ref(torch.from_numpy(src), torch.from_numpy(tap),
                           per_voxel=True)
    got = _table_tap_major(rows, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def test_live_tile_share_counts_tiles_with_a_live_bin():
    rows = torch.full((27, 72), -1, dtype=torch.int32)
    rows[0, 3] = 5          # tile 0 (voxels 0-63) of tap 0
    rows[26, 70] = 1        # tile 1 (voxels 64-71, ragged) of tap 26
    assert bc.live_tile_share(rows, 64) == pytest.approx(2 / 54)
    assert bc.live_tile_share(rows, 8) == pytest.approx(2 / 243)
