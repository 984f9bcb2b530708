"""The port's CUDA kernels and engine on a card (marker ``cuda``).

These need an NVIDIA GPU with nvcc and skip elsewhere; on a GPU machine run
``python -m pytest -m cuda tests/test_torch_port_cuda.py``.  Each kernel is
held against its plain version on the same CUDA tensors; both sum the same
f32 products in another order, so the bound is 2e-5 of the sum of |terms|.
"""

import numpy as np
import pytest
import torch

from fusiontransformer_tpu_torch.ops.host_slots import build_batch_slot_maps
from fusiontransformer_tpu_torch.ops.kernels import LAUNCHES
from fusiontransformer_tpu_torch.ops.kernels.binned_conv import (
    binned_conv_grouped_fwd, binned_conv_grouped_ref)
from fusiontransformer_tpu_torch.ops.kernels.segment_sum import (
    sorted_segment_weighted_sum, sorted_segment_weighted_sum_ref)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _check_fwd(fwd, ref, name, x, src, codes, w):
    """One forward launch against its plain version (2e-5 of the sum of
    |terms|), bitwise equal across two launches, on the route of its dtype:
    bf16 on the tensor-core kernel, f32 on the CUDA-core one."""
    from fusiontransformer_tpu_torch.ops.kernels.binned_conv import (
        FWD_CORE_NAME, FWD_MMA_NAME)
    mma = int(x.dtype == torch.bfloat16)
    before = (LAUNCHES[name], LAUNCHES[FWD_MMA_NAME], LAUNCHES[FWD_CORE_NAME])
    out = fwd(x, src, codes, w)
    assert (LAUNCHES[name], LAUNCHES[FWD_MMA_NAME],
            LAUNCHES[FWD_CORE_NAME]) == (before[0] + 1, before[1] + mma,
                                         before[2] + 1 - mma)
    want = ref(x, src, codes, w)
    scale = ref(x.abs(), src, codes, w.abs()).max()
    torch.cuda.synchronize()
    assert (out - want).abs().max().item() <= 2e-5 * scale.item()
    assert torch.equal(out, fwd(x, src, codes, w))
    return out


@pytest.mark.parametrize("maps", ["full", "ragged", "empty"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("cin,cout", [(4, 32), (20, 36), (96, 96),
                                      (384, 256)])
def test_binned_conv_kernel_matches_plain(cuda, dtype, cin, cout, maps):
    """K1 against its plain version on the card at the flagship's widths
    and a ragged one (20, 36: plain loads, not 16-byte copies), bitwise
    repeatable.  ``maps``: two scans' group-pooled maps; their first 397
    groups with tap 0 empty (V not a multiple of the 64-voxel tile); every
    bin empty (a zero output)."""
    src, binp = _grouped_maps(cuda)
    if maps == "ragged":
        src, binp = _ragged_without_tap0(src, binp, "grouped")
    elif maps == "empty":
        binp = torch.full_like(binp, 216)
    cap = src.shape[0] * 8
    gen = torch.Generator().manual_seed(cin)
    x = torch.randn(cap, cin, generator=gen).to(cuda, dtype)
    w = torch.randn(27, cin, cout, generator=gen).to(cuda, dtype)
    out = _check_fwd(binned_conv_grouped_fwd, binned_conv_grouped_ref,
                     "binned_conv_grouped_fwd", x, src, binp, w)
    assert out.any() == (maps != "empty")


@pytest.mark.parametrize("precise", [False, True])
@pytest.mark.parametrize("e,c", [(1, 257), (8, 128)])
def test_segment_sum_kernel_matches_plain(cuda, precise, e, c):
    rs = np.random.RandomState(e + c)
    n, v, nvalid = 5000, 2000, 1900
    extra = rs.multinomial(n - 100 - nvalid, np.ones(nvalid) / nvalid)
    ids = np.repeat(np.arange(nvalid), extra + 1)
    ids = np.concatenate([ids, np.full(n - len(ids), v)]).astype(np.int32)
    g = torch.as_tensor(rs.randn(n, c).astype(np.float32), device=cuda)
    w_np = rs.rand(n, e).astype(np.float32)
    w_np[ids >= v] = 0
    w = torch.as_tensor(w_np, device=cuda)
    ids_t = torch.as_tensor(ids, device=cuda)
    out = sorted_segment_weighted_sum(g, w, ids_t, v, precise)
    ref = sorted_segment_weighted_sum_ref(g, w, ids_t, v, precise)
    scale = sorted_segment_weighted_sum_ref(g.abs(), w, ids_t, v, True).max()
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() <= 2e-5 * scale.item()
    assert not out[nvalid:].any()


def test_engine_on_the_card_matches_the_cpu(cuda):
    """Tiny f32 engine: card (kernels) vs CPU (plain versions)."""
    from fusiontransformer_tpu_torch.config.defaults import get_default_cfg
    from fusiontransformer_tpu_torch.models.build import build_model
    from fusiontransformer_tpu_torch.serving.engine import InferenceEngine
    from test_torch_port_common import record, tiny_cfg

    cfg = tiny_cfg(get_default_cfg)
    cpu_model = build_model(cfg, device="cpu", seed=1)
    gpu_model = build_model(cfg, device="cuda", seed=1)
    gpu, cpu = (InferenceEngine(cfg, model=gpu_model),
                InferenceEngine(cfg, model=cpu_model, device="cpu"))
    rec = record(0)
    for key in ("labels", "labels_2d", "labels_3d"):
        agree = np.mean(gpu.predict(rec)[key] == cpu.predict(rec)[key])
        assert agree >= 0.999, (key, agree)
    assert LAUNCHES["binned_conv_grouped_fwd"] > 0
    assert LAUNCHES["sorted_segment_weighted_sum"] > 0


@pytest.mark.parametrize("shape_a,shape_b", [((3, 70, 96), (96, 40)),
                                             ((2, 4, 50, 64), (2, 4, 64, 50))])
def test_bf16_matmul_returns_f32_products(cuda, shape_a, shape_b):
    """The card's bf16 GEMM (f32 output) against the CPU formulation: the
    f32 product of bf16-rounded operands, within f32 summation order."""
    from fusiontransformer_tpu_torch.ops.sparse_conv import cdt_matmul
    gen = torch.Generator().manual_seed(len(shape_a))
    a = torch.randn(*shape_a, generator=gen)
    b = torch.randn(*shape_b, generator=gen)
    got = cdt_matmul(a.to(cuda), b.to(cuda), torch.bfloat16)
    want = cdt_matmul(a, b, torch.bfloat16)
    assert got.dtype == torch.float32
    assert got.shape == want.shape
    terms = torch.matmul(a.bfloat16().float().abs(),
                         b.bfloat16().float().abs())
    assert ((got.cpu() - want).abs() <= 2e-5 * terms).all()


def _grouped_maps(cuda, cap=6144, level=1):
    from fusiontransformer_tpu_torch.data.synthetic import SyntheticSCN
    ds = SyntheticSCN(num_scans=2, num_points=3000, image_height=37,
                      image_width=61)
    coords = [np.asarray(ds[i]["coords"]) for i in range(2)]
    maps, overflow = build_batch_slot_maps(coords, (cap,) * 5, [level])
    assert overflow == 0
    return [torch.as_tensor(m, device=cuda) for m in maps[level]]


def _ragged_without_tap0(src, codes, kind, groups=397):
    """The maps' first ``groups`` groups (a group count that is a multiple
    of neither the dW kernel's 8-group k-step nor its chunk), rows past them
    made the sentinel, and tap 0 emptied in every group."""
    v = groups * 8
    n = groups if kind == "grouped" else v
    src, codes = src[:n].clone(), codes[:n].clone()
    if kind == "grouped":
        codes[codes // 8 == 0] = 216             # bins 0-7 are tap 0's
    else:
        codes[codes == 0] = 27
    src[src >= v] = v
    return src, codes


def _check_bwd(bwd, bwd_ref, name, dout, x, src, codes, w, tap0_empty):
    """One backward launch against its plain version: dX and dW within 2e-5
    of the sum of |terms|, both bitwise equal across two launches, bf16 dX
    and dW on the tensor-core kernels (f32 on the CUDA-core ones), dW[26]
    zero where tap 0 is empty."""
    from fusiontransformer_tpu_torch.ops.kernels.binned_conv import (
        DW_MMA_NAME, FWD_CORE_NAME, FWD_MMA_NAME)
    names = (name, DW_MMA_NAME, FWD_MMA_NAME, FWD_CORE_NAME)
    before = [LAUNCHES[n] for n in names]
    dx, dw = bwd(dout, x, src, codes, w)
    mma = int(x.dtype == torch.bfloat16)
    assert [LAUNCHES[n] for n in names] == [
        before[0] + 1, before[1] + mma, before[2] + mma, before[3] + 1 - mma]
    rdx, rdw = bwd_ref(dout, x, src, codes, w)
    sdx, sdw = bwd_ref(dout.abs(), x.abs(), src, codes, w.abs())
    torch.cuda.synchronize()
    assert (dx - rdx).abs().max().item() <= 2e-5 * sdx.max().item()
    assert (dw - rdw).abs().max().item() <= 2e-5 * sdw.max().item()
    dx2, dw2 = bwd(dout, x, src, codes, w)
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)
    if tap0_empty:
        assert not dw[26].any() and not rdw[26].any()


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("cin,cout", [(4, 32), (20, 36), (32, 64), (128, 96),
                                      (192, 128), (384, 256)])
def test_binned_conv_bwd_kernel_matches_plain(cuda, dtype, cin, cout, ragged):
    """K2 (dX and dW) against its plain version on the card, at the widths
    of the flagship's grouped levels and a ragged one; both sum the same f32
    products in another order (2e-5 of the sum of |terms|).  dX and dW are
    bitwise repeatable; bf16 takes the tensor-core kernels, f32 the
    CUDA-core ones.  ``ragged``: 397 groups with tap 0 empty everywhere."""
    from fusiontransformer_tpu_torch.ops.kernels.binned_conv import (
        BWD_NAME, binned_conv_grouped_bwd, binned_conv_grouped_bwd_ref)
    src, binp = _grouped_maps(cuda)
    if ragged:
        src, binp = _ragged_without_tap0(src, binp, "grouped")
    cap = src.shape[0] * 8
    gen = torch.Generator().manual_seed(cin + cout)
    x = torch.randn(cap, cin, generator=gen).to(cuda, dtype)
    w = torch.randn(27, cin, cout, generator=gen).to(cuda, dtype)
    dout = torch.randn(cap, cout, generator=gen).to(cuda, dtype)
    _check_bwd(binned_conv_grouped_bwd, binned_conv_grouped_bwd_ref,
               BWD_NAME, dout, x, src, binp, w, ragged)


def _per_voxel_maps(cuda, k, level=1):
    """Per-voxel K-slot maps built on the card by the hierarchy."""
    from fusiontransformer_tpu_torch.data.collate import collate_padded
    from fusiontransformer_tpu_torch.data.synthetic import SyntheticSCN
    from fusiontransformer_tpu_torch.ops.hierarchy import build_hierarchy
    ds = SyntheticSCN(num_scans=2, num_points=3000, image_height=37,
                      image_width=61)
    b = collate_padded([ds[0], ds[1]], 2, 3072, 37, 61)
    args = [torch.as_tensor(b[key], device=cuda)
            for key in ("coords", "pt_batch", "pt_valid")]
    caps = (6144, 6144, 4096, 3072, 2048)
    hier = build_hierarchy(*args, caps, tap_slots=(k,) * 4 + (0,))
    return hier.levels[level].slot_idx


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k,cin,cout,ragged", [
    (16, 4, 32, False), (16, 128, 96, False), (5, 32, 64, False),
    (16, 384, 256, False), (1, 32, 64, False), (27, 192, 128, False),
    (27, 64, 128, True), (1, 128, 96, True), (5, 384, 256, True),
    (16, 20, 36, False), (16, 96, 96, True)])
def test_binned_conv_slots_kernels_match_plain(cuda, dtype, k, cin, cout,
                                               ragged):
    """K1' and K2' (dX, dW) against their plain versions on the card, on
    per-voxel maps the hierarchy built there (K < 27 drops live taps), 2e-5
    of the sum of |terms|; bitwise repeatable across two launches, bf16 on
    the tensor-core kernels.  ``ragged``: 397 groups with tap 0 empty."""
    from fusiontransformer_tpu_torch.ops.kernels.binned_conv import (
        SLOTS_BWD_NAME, SLOTS_NAME, binned_conv_slots_bwd,
        binned_conv_slots_bwd_ref, binned_conv_slots_fwd,
        binned_conv_slots_ref)
    src, tap = _per_voxel_maps(cuda, k)
    if ragged:
        src, tap = _ragged_without_tap0(src, tap, "slots")
    v = src.shape[0]
    gen = torch.Generator().manual_seed(cin + cout + k)
    x = torch.randn(v, cin, generator=gen).to(cuda, dtype)
    w = torch.randn(27, cin, cout, generator=gen).to(cuda, dtype)
    dout = torch.randn(v, cout, generator=gen).to(cuda, dtype)
    _check_fwd(binned_conv_slots_fwd, binned_conv_slots_ref, SLOTS_NAME, x,
               src, tap, w)
    _check_bwd(binned_conv_slots_bwd, binned_conv_slots_bwd_ref,
               SLOTS_BWD_NAME, dout, x, src, tap, w, ragged)


def test_devoxelize_adjoint_runs_k3_e8_on_the_card(cuda):
    """The devoxelize gradient with a plan (K3 at E=8) on the card against
    the same op on the CPU (plain version)."""
    from fusiontransformer_tpu_torch.data.collate import collate_padded
    from fusiontransformer_tpu_torch.data.synthetic import SyntheticSCN
    from fusiontransformer_tpu_torch.ops import sparse_conv as sc
    from fusiontransformer_tpu_torch.ops.hierarchy import build_hierarchy
    from fusiontransformer_tpu_torch.ops.kernels.segment_sum import (
        launch_name)
    ds = SyntheticSCN(num_scans=2, num_points=3000, image_height=37,
                      image_width=61)
    b = collate_padded([ds[0], ds[1]], 2, 3072, 37, 61)
    caps = (6144, 6144, 4096, 3072, 2048)
    grads = {}
    for dev in ("cpu", cuda):
        args = [torch.as_tensor(b[k], device=dev)
                for k in ("coords", "pt_batch", "pt_valid")]
        hier = build_hierarchy(*args, caps)
        gen = torch.Generator().manual_seed(0)
        vox = torch.randn(caps[2], 128, generator=gen).to(dev)
        vox.requires_grad_(True)
        dout = torch.randn(len(b["pt_valid"]), 128, generator=gen).to(dev)
        before = LAUNCHES[launch_name(8)]
        sc.devoxelize_trilinear(vox, hier.pt_corner_idx[2],
                                hier.pt_corner_w[2],
                                plan=sc.devox_plan(hier, 2),
                                compute_dtype=torch.float32).backward(dout)
        grads[str(dev)] = vox.grad.cpu()
        if dev == cuda:
            assert LAUNCHES[launch_name(8)] == before + 1
    scale = grads["cpu"].abs().max().item()
    assert (grads["cuda"] - grads["cpu"]).abs().max().item() <= 1e-5 * scale


def test_train_step_on_the_card_matches_the_cpu(cuda, monkeypatch):
    """One tiny f32 train step (dropout off) from the same weights: losses,
    the confusion matrices, and every gradient, with the leaf and median
    bounds of ``test_torch_port_train`` (the same conditioning applies)."""
    from fusiontransformer_tpu_torch.config.defaults import get_default_cfg
    from test_torch_port_common import train_cfg
    _train_step_card_vs_cpu(monkeypatch, train_cfg(get_default_cfg))


def test_per_voxel_train_step_on_the_card_matches_the_cpu(cuda, monkeypatch):
    """As above with ``TPU.CONV_SLOT_POOL`` off: per-voxel K-slot maps built
    on each device, K1' / K2' on the card."""
    from fusiontransformer_tpu_torch.config.defaults import get_default_cfg
    from fusiontransformer_tpu_torch.ops.kernels.binned_conv import (
        SLOTS_BWD_NAME)
    from test_torch_port_common import train_cfg
    cfg = train_cfg(get_default_cfg)
    cfg.defrost()
    cfg.TPU.CONV_SLOT_POOL = False
    cfg.freeze()
    before = LAUNCHES[SLOTS_BWD_NAME]
    metrics = _train_step_card_vs_cpu(monkeypatch, cfg)
    assert LAUNCHES[SLOTS_BWD_NAME] > before
    assert int(metrics["tap_overflow"]) == 0


def _train_step_card_vs_cpu(monkeypatch, cfg):
    from fusiontransformer_tpu_torch.data.build import build_dataloader
    from fusiontransformer_tpu_torch.models import spvcnn
    from fusiontransformer_tpu_torch.models.build import build_model
    from fusiontransformer_tpu_torch.modules import steps
    from fusiontransformer_tpu_torch.solver.build import build_optimizer
    from test_torch_port_common import LEAF_ATOL, LEAF_RTOL, MEDIAN_RTOL

    monkeypatch.setattr(spvcnn, "DROPOUT", 0.0)
    batch = next(iter(build_dataloader(cfg, "train")))
    caps = steps.batch_level_caps(cfg, batch)
    res = {}
    for dev in ("cpu", "cuda"):
        model = build_model(cfg, dev, seed=2)
        opt, _ = build_optimizer(cfg, model.parameters())
        grads = {}
        opt.register_step_pre_hook(lambda o, a, k, m=model, g=grads: g.update(
            {n: p.grad.cpu().clone() for n, p in m.named_parameters()}))
        metrics = steps.make_train_step(cfg, model, opt)(
            steps.device_batch(batch, dev), torch.Generator(dev), caps)
        res[dev] = ({k: v.cpu() for k, v in metrics.items()}, grads)
    (mc, gc), (mg, gg) = res["cpu"], res["cuda"]
    for k in ("total_loss", "seg_loss_2d", "seg_loss_3d"):
        torch.testing.assert_close(mg[k], mc[k], rtol=1e-5, atol=0)
    for k in ("cm_2d", "cm_3d"):
        assert torch.equal(mg[k], mc[k])
    shares = []
    for n, g in gc.items():
        err = (gg[n] - g).abs().max().item()
        scale = g.abs().max().item()
        assert err <= LEAF_RTOL * scale + LEAF_ATOL, (n, err, scale)
        if scale > 0:
            shares.append(err / scale)
    assert np.median(shares) <= MEDIAN_RTOL
    return mg


@pytest.mark.parametrize("shape_a,shape_b", [((3, 70, 96), (96, 40)),
                                             ((2, 4, 50, 64), (2, 4, 64, 50))])
def test_bf16_matmul_gradients(cuda, shape_a, shape_b):
    """The card's bf16 GEMM is differentiable: each operand's gradient is
    the GEMM of the bf16-rounded incoming gradient with the other operand,
    in the operand's dtype; against the CPU formulation (f32 incoming
    gradient) within 1e-2 of the sum of |terms| (one bf16 rounding of the
    gradient, then of the result)."""
    from fusiontransformer_tpu_torch.ops.sparse_conv import cdt_matmul
    gen = torch.Generator().manual_seed(len(shape_b))
    a = torch.randn(*shape_a, generator=gen)
    b = torch.randn(*shape_b, generator=gen)
    g = torch.randn(*shape_a[:-1], shape_b[-1], generator=gen)
    grads = {}
    for dev in ("cpu", cuda):
        ta = a.detach().to(dev).requires_grad_(True)
        tb = b.detach().to(dev).requires_grad_(True)
        cdt_matmul(ta, tb, torch.bfloat16).backward(g.to(dev))
        grads[str(dev)] = (ta.grad.cpu(), tb.grad.cpu())
    terms_a = torch.matmul(g.abs(), b.abs().transpose(-1, -2))
    terms_b = torch.matmul(a.abs().transpose(-1, -2), g.abs())
    if b.dim() == 2:
        terms_b = terms_b.reshape(-1, *terms_b.shape[-2:]).sum(0)
    for got, want, terms in zip(grads["cuda"], grads["cpu"],
                                (terms_a, terms_b)):
        assert got.shape == want.shape
        assert ((got - want).abs() <= 1e-2 * terms + 1e-6).all()


# --------------------------------------------------------------------------- #
# The tool kernels T1-T4 (row gathers, flash attention).

def _gather_inputs(cuda, r, c, n, seed):
    rs = np.random.RandomState(seed)
    feats = torch.as_tensor(rs.randn(r, c).astype(np.float32)).to(
        cuda, torch.bfloat16)
    idx = rs.randint(0, r, n).astype(np.int32)
    idx[:min(n, 3)] = r - 1          # the last row: a partial 8-row block
    return feats, torch.as_tensor(idx, device=cuda)


@pytest.mark.parametrize("r,c,n", [(1001, 8, 8), (1001, 32, 1000),
                                   (17409, 32, 16384), (7809, 128, 16392),
                                   (33, 136, 64)])
def test_gather_blocks8_kernel_matches_plain(cuda, r, c, n):
    """T1 copies: bit for bit equal to its plain version, rows past the
    table's end zero; an index out of range raises, or with check=False
    gives a zero block."""
    from fusiontransformer_tpu_torch.ops.kernels.row_gather import (
        BLOCKS8, gather_blocks8, gather_blocks8_ref)
    feats, idx = _gather_inputs(cuda, r, c, n, r + c)
    before = LAUNCHES[BLOCKS8]
    out = gather_blocks8(feats, idx)
    assert LAUNCHES[BLOCKS8] == before + 1
    assert out.shape == (n, c) and out.dtype == torch.bfloat16
    assert torch.equal(out, gather_blocks8_ref(feats, idx))
    if r % 8:
        assert not out[(r % 8):8].any()   # block 0 starts at 8*((r-1)//8)
    bad = idx.clone()
    bad[0] = r
    with pytest.raises(IndexError):
        gather_blocks8(feats, bad)
    out = gather_blocks8(feats, bad, check=False)
    torch.cuda.synchronize()
    assert not out[:8].any()
    assert torch.equal(out[8:], gather_blocks8_ref(feats, idx)[8:])


@pytest.mark.parametrize("kind", ["pipelined", "smem"])
@pytest.mark.parametrize("r,c,n", [(1001, 8, 1), (1001, 32, 0),
                                   (1001, 32, 1003), (17409, 32, 16389),
                                   (7809, 128, 124931), (50, 24, 7)])
def test_gather_rows_sum_kernels_match_plain(cuda, kind, r, c, n):
    """T2 and T3 against the plain f32 sum within 2e-5 of the sum of
    |rows|, equal bit for bit across two launches; an index out of range
    raises, or with check=False counts as a zero row."""
    from fusiontransformer_tpu_torch.ops.kernels import row_gather as rg
    name, fn = {"pipelined": (rg.PIPELINED, rg.gather_rows_sum_pipelined),
                "smem": (rg.SMEM, rg.gather_rows_sum_smem)}[kind]
    feats, idx = _gather_inputs(cuda, r, c, n, r + c + n)
    before = LAUNCHES[name]
    a = fn(feats, idx)
    b = fn(feats, idx)
    assert LAUNCHES[name] == before + 2
    assert a.shape == (1, c) and a.dtype == torch.float32
    assert torch.equal(a, b)
    ref = rg.gather_rows_sum_ref(feats, idx)
    scale = rg.gather_rows_sum_ref(feats.abs(), idx).max().item()
    assert (a - ref).abs().max().item() <= 2e-5 * scale
    if n:
        bad = idx.clone()
        bad[-1] = -1
        with pytest.raises(IndexError):
            fn(feats, bad)
        got = fn(feats, bad, check=False)
        want = rg.gather_rows_sum_ref(feats, idx[:-1])
        assert (got - want).abs().max().item() <= 2e-5 * scale


def test_gather_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    from fusiontransformer_tpu_torch.ops.kernels import row_gather as rg
    feats, idx = _gather_inputs(cuda, 1001, 32, 64, 0)
    for fn in (rg.gather_blocks8, rg.gather_rows_sum_pipelined,
               rg.gather_rows_sum_smem):
        with pytest.raises(TypeError):
            fn(feats.float(), idx)
        with pytest.raises(TypeError):
            fn(feats, idx.long())
        with pytest.raises(ValueError):
            fn(feats, idx.cpu())
        with pytest.raises(ValueError, match="contiguous"):
            fn(feats.t().contiguous().t(), idx)
        with pytest.raises(ValueError, match="contiguous"):
            fn(feats, idx[::2])
    with pytest.raises(ValueError, match="multiple of 8"):
        rg.gather_blocks8(feats, idx[:20])
    with pytest.raises(ValueError, match="C % 8"):
        rg.gather_rows_sum_pipelined(feats[:, :4].contiguous(), idx)
    with pytest.raises(ValueError, match="aligned"):
        rg.gather_rows_sum_smem(feats[:, :4].contiguous()[1:], idx)
    with pytest.raises(ValueError, match="even one column"):
        rg.gather_rows_sum_smem(
            torch.zeros(120_000, 8, dtype=torch.bfloat16, device=cuda), idx)


def _attention_held(out, q, k, v):
    from fusiontransformer_tpu_torch.ops.kernels.flash_attention import (
        ATTN_TOL, attention_error_scale, flash_attention_ref)
    ref = flash_attention_ref(q, k, v, 0.125).float()
    scale = attention_error_scale(q, k, v, 0.125)
    return bool(((out.float() - ref).abs() <= ATTN_TOL * scale).all())


@pytest.mark.parametrize("n", [1, 63, 65, 578])
@pytest.mark.parametrize("b,h", [(1, 1), (2, 3)])
def test_flash_attention_kernel_matches_plain(cuda, n, b, h):
    """T4 against its plain version, three calls chained (each output the
    next query), on unit-normal inputs and on the two inputs of
    ``chip_smoke.py`` that catch a dropped or zero-scored ragged tail."""
    from fusiontransformer_tpu_torch.ops.kernels.flash_attention import (
        NAME, flash_attention)
    rs = np.random.RandomState(n + b)
    q, k, v = (torch.as_tensor(rs.randn(b, h, n, 64).astype(np.float32)).to(
        cuda, torch.bfloat16) for _ in range(3))
    before = LAUNCHES[NAME]
    x = q
    for _ in range(3):
        out = flash_attention(x, k, v, 0.125)
        assert out.shape == q.shape and out.dtype == torch.bfloat16
        assert _attention_held(out, x, k, v)
        x = out
    assert LAUNCHES[NAME] == before + 3
    from chip_smoke import negative_scores, tail_heavy
    for make in (tail_heavy, negative_scores):
        q, k, v = make(b, h, n)
        assert _attention_held(flash_attention(q, k, v, 0.125), q, k, v)


def test_flash_attention_kernel_keeps_the_ragged_tail(cuda):
    """At N = 578 = 9*64 + 2 the last two keys are a tile of their own: a
    kernel that drops them fails the bound on the tail-heavy input."""
    from chip_smoke import tail_heavy
    from fusiontransformer_tpu_torch.ops.kernels.flash_attention import (
        flash_attention)
    q, k, v = tail_heavy(2, 3, 578)
    assert _attention_held(flash_attention(q, k, v, 0.125), q, k, v)
    dropped = flash_attention(q, k[:, :, :576].contiguous(),
                              v[:, :, :576].contiguous(), 0.125)
    assert not _attention_held(dropped, q, k, v)
    # Queries and keys of other lengths.
    kq = q[:, :, :65].contiguous()
    assert _attention_held(flash_attention(kq, k, v, 0.125), kq, k, v)


def test_flash_attention_wrapper_raises_on_what_the_kernel_does_not_take(
        cuda):
    from fusiontransformer_tpu_torch.ops.kernels.flash_attention import (
        flash_attention)
    q = torch.randn(1, 2, 70, 64, device=cuda).to(torch.bfloat16)
    with pytest.raises(TypeError):
        flash_attention(q.half(), q.half(), q.half(), 0.125)
    with pytest.raises(ValueError, match="head dim"):
        d32 = q[..., :32].contiguous()
        flash_attention(d32, d32, d32, 0.125)
    with pytest.raises(ValueError, match="shapes differ"):
        flash_attention(q, q[:1, :1], q[:1, :1], 0.125)
    with pytest.raises(ValueError):
        flash_attention(q, q.cpu(), q, 0.125)
    with pytest.raises(ValueError, match="contiguous"):
        qt = q.transpose(1, 2).contiguous().transpose(1, 2)
        flash_attention(qt, q, q, 0.125)
