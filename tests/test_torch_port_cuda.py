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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("cin,cout", [(4, 32), (96, 96), (384, 256)])
def test_binned_conv_kernel_matches_plain(cuda, dtype, cin, cout):
    from fusiontransformer_tpu_torch.data.synthetic import SyntheticSCN
    ds = SyntheticSCN(num_scans=2, num_points=3000, image_height=37,
                      image_width=61)
    coords = [np.asarray(ds[i]["coords"]) for i in range(2)]
    cap = 6144
    maps, overflow = build_batch_slot_maps(coords, (cap,) * 5, [1])
    assert overflow == 0
    src, binp = (torch.as_tensor(m, device=cuda) for m in maps[1])
    gen = torch.Generator().manual_seed(cin)
    x = torch.randn(cap, cin, generator=gen).to(cuda, dtype)
    w = torch.randn(27, cin, cout, generator=gen).to(cuda, dtype)
    before = LAUNCHES["binned_conv_grouped_fwd"]
    out = binned_conv_grouped_fwd(x, src, binp, w)
    assert LAUNCHES["binned_conv_grouped_fwd"] == before + 1
    ref = binned_conv_grouped_ref(x, src, binp, w)
    scale = binned_conv_grouped_ref(x.abs(), src, binp, w.abs()).max()
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() <= 2e-5 * scale.item()


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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("cin,cout", [(4, 32), (32, 64), (128, 96),
                                      (384, 256)])
def test_binned_conv_bwd_kernel_matches_plain(cuda, dtype, cin, cout):
    """K2 (dX and dW) against its plain version on the card, at the widths
    of the flagship's grouped levels; both sum the same f32 products in
    another order (2e-5 of the sum of |terms|).  dW is bitwise repeatable."""
    from fusiontransformer_tpu_torch.ops.kernels.binned_conv import (
        BWD_NAME, binned_conv_grouped_bwd, binned_conv_grouped_bwd_ref)
    src, binp = _grouped_maps(cuda)
    cap = src.shape[0] * 8
    gen = torch.Generator().manual_seed(cin + cout)
    x = torch.randn(cap, cin, generator=gen).to(cuda, dtype)
    w = torch.randn(27, cin, cout, generator=gen).to(cuda, dtype)
    dout = torch.randn(cap, cout, generator=gen).to(cuda, dtype)
    before = LAUNCHES[BWD_NAME]
    dx, dw = binned_conv_grouped_bwd(dout, x, src, binp, w)
    assert LAUNCHES[BWD_NAME] == before + 1
    rdx, rdw = binned_conv_grouped_bwd_ref(dout, x, src, binp, w)
    sdx, sdw = binned_conv_grouped_bwd_ref(dout.abs(), x.abs(), src, binp,
                                           w.abs())
    torch.cuda.synchronize()
    assert (dx - rdx).abs().max().item() <= 2e-5 * sdx.max().item()
    assert (dw - rdw).abs().max().item() <= 2e-5 * sdw.max().item()
    _, dw2 = binned_conv_grouped_bwd(dout, x, src, binp, w)
    assert torch.equal(dw, dw2)


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
@pytest.mark.parametrize("k,cin,cout", [(16, 4, 32), (16, 128, 96),
                                        (5, 32, 64), (16, 384, 256)])
def test_binned_conv_slots_kernels_match_plain(cuda, dtype, k, cin, cout):
    """K1' and K2' (dX, dW) against their plain versions on the card, on
    per-voxel maps the hierarchy built there (K=5 drops live taps), 2e-5 of
    the sum of |terms|; dW bitwise repeatable across two launches."""
    from fusiontransformer_tpu_torch.ops.kernels.binned_conv import (
        SLOTS_BWD_NAME, SLOTS_NAME, binned_conv_slots_bwd,
        binned_conv_slots_bwd_ref, binned_conv_slots_fwd,
        binned_conv_slots_ref)
    src, tap = _per_voxel_maps(cuda, k)
    v = src.shape[0]
    gen = torch.Generator().manual_seed(cin + cout + k)
    x = torch.randn(v, cin, generator=gen).to(cuda, dtype)
    w = torch.randn(27, cin, cout, generator=gen).to(cuda, dtype)
    dout = torch.randn(v, cout, generator=gen).to(cuda, dtype)
    before = (LAUNCHES[SLOTS_NAME], LAUNCHES[SLOTS_BWD_NAME])
    out = binned_conv_slots_fwd(x, src, tap, w)
    dx, dw = binned_conv_slots_bwd(dout, x, src, tap, w)
    assert (LAUNCHES[SLOTS_NAME], LAUNCHES[SLOTS_BWD_NAME]) == (
        before[0] + 1, before[1] + 1)
    ref = binned_conv_slots_ref(x, src, tap, w)
    rdx, rdw = binned_conv_slots_bwd_ref(dout, x, src, tap, w)
    scale = binned_conv_slots_ref(x.abs(), src, tap, w.abs()).max()
    sdx, sdw = binned_conv_slots_bwd_ref(dout.abs(), x.abs(), src, tap,
                                         w.abs())
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() <= 2e-5 * scale.item()
    assert (dx - rdx).abs().max().item() <= 2e-5 * sdx.max().item()
    assert (dw - rdw).abs().max().item() <= 2e-5 * sdw.max().item()
    _, dw2 = binned_conv_slots_bwd(dout, x, src, tap, w)
    assert torch.equal(dw, dw2)


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
