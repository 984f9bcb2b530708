"""The port's tool kernels T1-T4 and microbenches against the JAX tools.

The JAX side runs as the JAX package's own tests run Pallas on the CPU: the
three row-gather probes of ``tools/microbench_dma_gather.py`` (loaded by
path, ``CHUNK`` set to 256) and JAX's TPU flash attention, all under
``pltpu.force_tpu_interpret_mode()``.  The port's plain versions (what its
wrappers run for CPU tensors) are held against them on numpy-made inputs:

* T1 bit for bit on every 8-row block wholly inside the table (the TPU
  leaves the rows past the table's end undefined, the port makes them 0);
* T2/T3 within ``SUM_RTOL`` of the sum of |rows|: both sum the same f32
  values, the TPU in index order, the port in torch's order, and 256 f32
  additions move a sum by at most 255 * 2^-24 (1.5e-5) of it;
* T4 within ``ATTN_TOL`` of each output's ``sum_j p_ij |v_j|``
  (``ops/kernels/flash_attention.py`` derives it: the probabilities are
  rounded to bf16 before or after the normalisation, then the output).
"""

import importlib.util
import itertools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from fusiontransformer_tpu_torch.data.collate import collate_padded
from fusiontransformer_tpu_torch.data.synthetic import SyntheticSCN
from fusiontransformer_tpu_torch.ops.hierarchy import build_hierarchy
from fusiontransformer_tpu_torch.ops.kernels import LAUNCHES, row_gather
from fusiontransformer_tpu_torch.ops.kernels.flash_attention import (
    ATTN_TOL, attention_error_scale, flash_attention, flash_attention_ref)
from fusiontransformer_tpu_torch.ops.kernels.row_gather import (
    gather_blocks8, gather_blocks8_ref, gather_rows_sum_pipelined,
    MIN_SLICE, gather_rows_sum_ref, gather_rows_sum_smem, grid_plan,
    smem_plan)
from fusiontransformer_tpu_torch.tools import (microbench_attention,
                                               microbench_dma_gather,
                                               microbench_gather)
from fusiontransformer_tpu_torch.utils import profiler

REPO = pathlib.Path(__file__).resolve().parents[1]
R = 1001           # table rows: not a multiple of 8
CHUNK = 256
SUM_RTOL = 2e-5


@pytest.fixture(scope="module")
def jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_microbench_dma_gather", REPO / "tools/microbench_dma_gather.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def slot_indices():
    """The first CHUNK entries of the port's per-voxel L0 src map of a small
    scan at a level capacity of R - 1: the sentinel is the table's last row."""
    ds = SyntheticSCN(split=("train",), num_scans=1, num_points=900,
                      image_height=37, image_width=61)
    b = collate_padded([ds[0]], 1, 1024, 37, 61)
    hier = build_hierarchy(*(torch.as_tensor(b[k]) for k in
                             ("coords", "pt_batch", "pt_valid")),
                           (R - 1, 800, 600, 400, 200), tap_slots=(16,) * 5)
    src = hier.levels[0].slot_idx[0].reshape(-1)[:CHUNK].to(torch.int32)
    assert int(src.max()) == R - 1 and int(src.min()) >= 0
    return src.numpy()


def _inputs(c, kind, slot_indices):
    rs = np.random.RandomState(c)
    table = rs.randn(R, c).astype(np.float32)
    if kind == "random":
        idx = rs.randint(0, R, CHUNK).astype(np.int32)
        idx[[0, 5, 100]] = R - 1
    else:
        idx = slot_indices.copy()
    return (torch.as_tensor(table).to(torch.bfloat16),
            jnp.asarray(table, dtype=jnp.bfloat16), idx)


@pytest.mark.parametrize("kind", ["random", "slot maps"])
@pytest.mark.parametrize("c", [32, 128])
def test_gather_blocks8_matches_pallas_mosaic_bs(jax_tool, slot_indices,
                                                 monkeypatch, c, kind):
    monkeypatch.setattr(jax_tool, "CHUNK", CHUNK)
    feats, jfeats, idx = _inputs(c, kind, slot_indices)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_tool.mosaic_bs_gather(
            jfeats, jnp.asarray(idx)).astype(jnp.float32))
    got = gather_blocks8(feats, torch.as_tensor(idx)).float().numpy()
    assert got.shape == want.shape == (CHUNK, c)
    rows = (idx[:CHUNK // 8, None] // 8 * 8 + np.arange(8)).reshape(-1)
    inside = np.repeat(idx[:CHUNK // 8] // 8 * 8 + 8 <= R, 8)
    assert inside.sum() >= 16 and not inside.all()
    np.testing.assert_array_equal(got[inside], want[inside])
    # The block that runs past the end: its rows in the table are copied,
    # the rest are 0.
    table = feats.float().numpy()
    in_table = ~inside & (rows < R)
    np.testing.assert_array_equal(got[in_table], table[rows[in_table]])
    assert not got[~inside & (rows >= R)].any()


@pytest.mark.parametrize("kind", ["random", "slot maps"])
@pytest.mark.parametrize("c", [32, 128])
def test_gather_rows_sum_matches_pallas_dma_chain_and_vmem_dyn(
        jax_tool, slot_indices, monkeypatch, c, kind):
    monkeypatch.setattr(jax_tool, "CHUNK", CHUNK)
    feats, jfeats, idx = _inputs(c, kind, slot_indices)
    ix = torch.as_tensor(idx)
    scale = gather_rows_sum_ref(feats.abs(), ix).max().item()
    for jax_fn, port_fn in ((jax_tool.dma_chain_gather,
                             gather_rows_sum_pipelined),
                            (jax_tool.vmem_dyn_gather, gather_rows_sum_smem)):
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(jax_fn(jfeats, jnp.asarray(idx)))
        got = port_fn(feats, ix).numpy()
        assert got.shape == want.shape == (1, c) and got.dtype == np.float32
        assert np.abs(got - want).max() <= SUM_RTOL * scale


def _qkv(b, h, n, seed):
    rs = np.random.RandomState(seed)
    return [rs.randn(b, h, n, 64).astype(np.float32) for _ in range(3)]


def _held(got, q, k, v):
    """got [B, H, N, 64] (torch) against the port's plain version's error
    scale on the same bf16 inputs."""
    tq, tk, tv = (torch.as_tensor(np.asarray(x, np.float32)).to(
        torch.bfloat16) for x in (q, k, v))
    scale = attention_error_scale(tq, tk, tv, 64 ** -0.5)
    return ((got - flash_attention_ref(tq, tk, tv, 64 ** -0.5).float()).abs()
            <= ATTN_TOL * scale).all().item()


@pytest.mark.parametrize("n", [128, 256])
def test_flash_attention_ref_matches_pallas_flash(n):
    from jax.experimental.pallas.ops.tpu.flash_attention import (
        flash_attention as j_flash)
    q, k, v = (jnp.asarray(x, jnp.bfloat16) for x in _qkv(1, 2, n, n))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(j_flash(q, k, v, sm_scale=64 ** -0.5)
                          .astype(jnp.float32))
    assert _held(torch.from_numpy(want.copy()), q, k, v)


@pytest.mark.parametrize("n", [578, 70])
def test_flash_attention_ref_matches_the_einsum_formulation(n):
    """f32 scores of bf16 operands, f32 softmax, bf16(p) @ v in f32, bf16:
    the ViT's arithmetic, at lengths the TPU kernel refuses."""
    q, k, v = (jnp.asarray(x, jnp.bfloat16) for x in _qkv(2, 3, n, n))
    s = jnp.einsum("bhqd,bhkd->bhqk", q, k,
                   preferred_element_type=jnp.float32) * 64 ** -0.5
    p = jax.nn.softmax(s, axis=-1).astype(jnp.bfloat16)
    want = jnp.einsum("bhqk,bhkd->bhqd", p, v,
                      preferred_element_type=jnp.float32).astype(jnp.bfloat16)
    want = torch.as_tensor(np.asarray(want.astype(jnp.float32)))
    assert _held(want, q, k, v)
    tq, tk, tv = (torch.as_tensor(np.asarray(x.astype(jnp.float32))).to(
        torch.bfloat16) for x in (q, k, v))
    got = flash_attention(tq, tk, tv, 64 ** -0.5)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 3, n, 64)


@pytest.mark.parametrize("b,h,n", [(1, 2, 70), (2, 3, 33), (1, 1, 1),
                                   (2, 2, 129)])
def test_sdpa_variant_matches_jax_dot_product_attention(b, h, n):
    """The microbench's ``sdpa`` against the JAX tool's
    ``dot_product_attention`` (``jax.nn.dot_product_attention``, [b, n, h, d]
    layout) on the same bf16 inputs, within ATTN_TOL of sum_j p_ij |v_j|."""
    q, k, v = _qkv(b, h, n, n)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16).swapaxes(1, 2)
                  for x in (q, k, v))
    want = jax.nn.dot_product_attention(jq, jk, jv, scale=64 ** -0.5)
    want = torch.as_tensor(np.asarray(want.swapaxes(1, 2).astype(
        jnp.float32)))
    tq, tk, tv = (torch.as_tensor(x).to(torch.bfloat16) for x in (q, k, v))
    got = microbench_attention.sdpa(tq, tk, tv)
    assert got.dtype == torch.bfloat16 and got.shape == (b, h, n, 64)
    scale = attention_error_scale(tq, tk, tv, 64 ** -0.5)
    assert ((got.float() - want).abs() <= ATTN_TOL * scale).all()


def test_wrappers_on_the_cpu_run_the_plain_versions_and_check_arguments():
    rs = np.random.RandomState(0)
    feats = torch.as_tensor(rs.randn(R, 32).astype(np.float32)).to(
        torch.bfloat16)
    idx = torch.as_tensor(rs.randint(0, R, 64).astype(np.int32))
    before = dict(LAUNCHES)
    assert torch.equal(gather_blocks8(feats, idx),
                       gather_blocks8_ref(feats, idx))
    for fn in (gather_rows_sum_pipelined, gather_rows_sum_smem):
        assert torch.equal(fn(feats, idx), gather_rows_sum_ref(feats, idx))
    q = torch.randn(1, 2, 9, 64).to(torch.bfloat16)
    assert torch.equal(flash_attention(q, q, q, 0.125),
                       flash_attention_ref(q, q, q, 0.125))
    assert dict(LAUNCHES) == before       # nothing launched on the CPU

    bad = idx.clone()
    bad[3] = R
    for fn in (gather_blocks8, gather_rows_sum_pipelined,
               gather_rows_sum_smem):
        with pytest.raises(IndexError):
            fn(feats, bad)
        with pytest.raises(TypeError):
            fn(feats.float(), idx)
        with pytest.raises(TypeError):
            fn(feats, idx.long())
        with pytest.raises(ValueError):
            fn(feats[None], idx)
    with pytest.raises(IndexError):
        gather_rows_sum_ref(feats, -idx - 1)
    with pytest.raises(ValueError, match="multiple of 8"):
        gather_blocks8(feats, idx[:60])
    with pytest.raises(ValueError, match="C % 8"):
        gather_rows_sum_pipelined(feats[:, :12].contiguous(), idx)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q[..., :32], q[..., :32], q[..., :32], 0.125)
    with pytest.raises(TypeError):
        flash_attention(q.half(), q.half(), q.half(), 0.125)
    with pytest.raises(ValueError, match="shapes differ"):
        flash_attention(q, q[:, :1], q[:, :1], 0.125)


def test_smem_plan_fits_the_flagship_tables_and_its_limits():
    """T3 holds the whole table in one cluster, row r in block r % S: L0
    (17409 x 32, 1.11 MB) in 8 blocks of 2177 rows (139 KB each), L2 (7809
    x 128, 2.0 MB) in 16 of 489 (125 KB); the largest table a cluster of 16
    holds at C = 32 is 56048 rows, and one row more raises before any
    launch.  Any C: a row is ceil(C / 8) 16-byte chunks (C = 6 as C = 8),
    rows of more than 512 chunks keep their block sum beside the table."""
    assert smem_plan(17409, 32) == (8, 2177)
    assert smem_plan(7809, 128) == (16, 489)
    assert smem_plan(1001, 32) == (1, 1001)
    assert smem_plan(50, 24) == (1, 50)
    assert smem_plan(56048, 32) == (16, 3503)
    assert smem_plan(17409, 6) == smem_plan(17409, 8) == (2, 8705)
    assert smem_plan(50, 1) == (1, 50)
    assert smem_plan(300, 4100) == (16, 19)
    assert smem_plan(60, 9000) == (8, 8)
    for rows, c in ((56049, 32), (120_000, 32), (14011, 128), (1000, 2048),
                    (224_241, 6), (2, 60_000)):
        with pytest.raises(ValueError, match="cluster of 16"):
            smem_plan(rows, c)
    for rows, c in ((17409, 32), (7809, 128), (56048, 32)):
        size, rpb = smem_plan(rows, c)
        assert size * rpb >= rows > (size // 2) * rpb or size == 1
    feats = torch.zeros(56049, 32, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="cluster of 16"):
        gather_rows_sum_smem(feats, torch.zeros(8, dtype=torch.int32))
    rs = np.random.RandomState(6)
    feats = torch.as_tensor(rs.randn(17409, 6).astype(np.float32)).to(
        torch.bfloat16)
    idx = torch.as_tensor(rs.randint(0, 17409, 1000).astype(np.int32))
    assert torch.equal(gather_rows_sum_smem(feats, idx),
                       gather_rows_sum_ref(feats, idx))


def test_ticket_slot_is_one_per_device_and_stream(monkeypatch):
    """T2 / T3 calls on one (device, stream) share a ticket; another stream
    or card gets another; past TICKET_SLOTS the wrapper raises."""
    monkeypatch.setattr(row_gather, "_ticket_slots", {})
    monkeypatch.setattr(row_gather, "_next_slot", itertools.count())
    a = row_gather.ticket_slot(0, 0)
    assert row_gather.ticket_slot(0, 0) == a
    others = {row_gather.ticket_slot(0, 7), row_gather.ticket_slot(1, 0),
              row_gather.ticket_slot(1, 7)}
    assert len(others | {a}) == 4
    monkeypatch.setattr(row_gather, "_next_slot",
                        itertools.count(row_gather.TICKET_SLOTS))
    with pytest.raises(RuntimeError, match="streams"):
        row_gather.ticket_slot(0, 9)


@pytest.mark.parametrize("n", [0, 1, 4, 1023, 1024, 1025, 2047, 2048, 2049,
                               8191, 8192, 8193, 16384, 124931, 278528])
@pytest.mark.parametrize("size,cap", [(8, 33), (8, 1), (8, 15), (16, 7),
                                      (1, 264)])
def test_grid_plan_covers_every_index_once_in_block_order(n, size, cap):
    """Block b takes [b * slice, (b + 1) * slice) of [0, n), as the kernels
    cut it: every index once, in block order, a multiple of 4 a slice, no
    more clusters than the card holds (cap) or than give each block
    MIN_SLICE indices.  H100 caps: T2 33 clusters of 8; T3 15 clusters of 8
    at L0, 7 of 16 at L2."""
    clusters, slice_ = grid_plan(n, size, cap)
    blocks = clusters * size
    assert 1 <= clusters <= cap and slice_ > 0 and slice_ % 4 == 0
    ranges = [(min(n, b * slice_), min(n, (b + 1) * slice_))
              for b in range(blocks)]
    covered = np.concatenate([np.arange(*r) for r in ranges] + [[]])
    np.testing.assert_array_equal(covered, np.arange(n))
    assert clusters == 1 or (clusters - 1) * size * MIN_SLICE < n
    if clusters < cap:      # not cut by the card: MIN_SLICE or more a block
        assert n <= blocks * MIN_SLICE
    # no cluster is left without indices
    assert n == 0 or ranges[(clusters - 1) * size][1] > \
        ranges[(clusters - 1) * size][0]


TOOL_RUNS = {
    "microbench_dma_gather": (microbench_dma_gather, [
        "--points", "900", "--chunk", "256", "--iters", "1"]),
    "microbench_gather": (microbench_gather, [
        "--rows", "512", "--iters", "1"]),
    "microbench_attention": (microbench_attention, [
        "--heads", "2", "--tokens", "70", "--depth", "2", "--iters", "1",
        "1", "2"]),
}


@pytest.mark.parametrize("tool", sorted(TOOL_RUNS))
def test_tools_run_on_the_cpu(tool, capsys):
    mod, argv = TOOL_RUNS[tool]
    rows = mod.main(["--device", "cpu", *argv])
    out = capsys.readouterr().out
    assert out.startswith("device: cpu")
    if tool == "microbench_dma_gather":
        assert [r["level"] for r in rows] == [0, 2]
        for r in rows:
            assert r["whole_rows"] == 16 * r["cap"]
            assert set(r["ms"]) == set(mod.VARIANTS)
            assert max(r["err"].values()) == 0.0
    elif tool == "microbench_gather":
        assert len(rows) == 8 and all(r["ms"] > 0 for r in rows)
    else:
        shares = [r["flash_vs_einsum_share_of_bound"] for r in rows
                  if "flash_vs_einsum_share_of_bound" in r]
        assert len(shares) == 2 and max(shares) <= 1.0
        assert {r["variant"] for r in rows if "variant" in r} == {
            "einsum_f32sm", "flash", "sdpa"}


@pytest.mark.parametrize("tool", sorted(TOOL_RUNS))
def test_tools_raise_without_a_card(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TOOL_RUNS[tool][0].main([])


def test_profiler_on_the_cpu(tmp_path, capsys, monkeypatch):
    @profiler.profile
    def work(x):
        return x * 2

    assert work(3) == 6
    assert "cumulative" in capsys.readouterr().out
    with profiler.device_trace(tmp_path / "trace") as prof:
        torch.ones(64, 64).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    assert len(prof.key_averages()) > 0
    ms, times = profiler.time_host(lambda: torch.ones(8).sum(), iters=3)
    assert len(times) == 3 and ms >= 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        profiler.time_cuda(lambda: None)
