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
