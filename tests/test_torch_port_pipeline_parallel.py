"""The GPipe ViT in the port (``parallel/pipeline_parallel.py``) on the CPU,
against the JAX package's ``pipeline_parallel.py``
(``test_pipeline_parallel.py``): two gloo ranks, each a spawned process
(``torch_dp_ranks.py``) over a ``FileStore`` in ``tmp_path``, as two
stages of a ViT of depth 4, width 64, 4 heads, 32 px, from JAX's weights.

* ``stack_vit_blocks`` / ``unstack_vit_blocks`` round trip, with JAX's
  ``[stages, blocks a stage, ...]`` layout.
* At 1, 2 and 4 microbatches of a batch of 4: the taps (blocks 1 and 3)
  within 2e-5 of JAX's ``make_pp_forward`` on a 2-device pipe mesh and of
  the sequential backbone; the gradients of the sum of their squares
  within 1e-4 of the sequential backbone's (each rank's stage and the
  embedding's, full on every rank); the hand-off through ``all_gather``
  (the way of a gloo group on the card) bit for bit the point-to-point
  one.

The ranks' run is joined with a timeout: a hang fails the tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusiontransformer_tpu.models.vit import VisionTransformer2D as JViT
from fusiontransformer_tpu.parallel import pipeline_parallel as jpp
from fusiontransformer_tpu_torch.parallel import pipeline_parallel as pp

import torch_dp_ranks as ranks
from test_torch_port_common import one_thread  # noqa: F401

STAGES = 2
TAPS = (1, 3)
MICROS = (1, 2, 4)
FWD_TOL, GRAD_TOL = 2e-5, 1e-4      # tests/test_pipeline_parallel.py


def _vit():
    return JViT(img_size=32, patch_size=16, embed_dim=64, depth=4,
                num_heads=4, compute_dtype=jnp.float32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def pp_run(tmp_path_factory):
    """JAX's sequential taps and gradients, its pipelined taps at each
    microbatch count; the port's two stages."""
    rs = np.random.RandomState(0)
    imgs = rs.standard_normal((4, 32, 32, 3)).astype(np.float32)
    vit = _vit()
    params = jax.tree_util.tree_map(
        np.asarray, vit.init(jax.random.PRNGKey(0), imgs)["params"])
    seq = jax.tree_util.tree_map(np.asarray, vit.apply({"params": params},
                                                       imgs))

    def loss(p):
        out = vit.apply({"params": p}, imgs)
        return sum(jnp.sum(out[str(k)] ** 2) for k in TAPS)

    grads = _flat(jax.grad(loss)(params))
    mesh = jpp.make_pp_mesh(STAGES)
    staged, rest = jpp.stack_vit_blocks(params, STAGES)
    piped = {m: jax.tree_util.tree_map(np.asarray, jpp.make_pp_forward(
        vit, mesh, n_micro=m, tap_blocks=TAPS)(staged, rest, imgs))
        for m in MICROS}
    port = ranks.spawn(tmp_path_factory.mktemp("pp"), "pp", params, imgs,
                       MICROS, TAPS, world=STAGES, timeout=300)
    return {"seq": seq, "grads": grads, "piped": piped, "params": params,
            "port": port}


def test_stack_unstack_round_trip_in_jaxs_layout(pp_run):
    params = {k: torch.tensor(v) for k, v in _flat(pp_run["params"]).items()}
    staged, rest = pp.stack_vit_blocks(params, STAGES)
    j_staged, j_rest = jpp.stack_vit_blocks(pp_run["params"], STAGES)
    j_staged, j_rest = _flat(j_staged), _flat(j_rest)
    assert staged.keys() == j_staged.keys() and rest.keys() == j_rest.keys()
    for k, v in staged.items():
        assert tuple(v.shape[:2]) == (STAGES, 2)
        np.testing.assert_array_equal(v.numpy(), j_staged[k], err_msg=k)
    back = pp.unstack_vit_blocks(staged, rest)
    assert back.keys() == params.keys()
    assert all(torch.equal(back[k], params[k]) for k in params)
    with pytest.raises(ValueError, match="do not divide"):
        pp.stack_vit_blocks(params, 3)


@pytest.mark.parametrize("micro", MICROS)
def test_pp_forward_matches_jax(pp_run, micro):
    """Every rank's taps (and the last block's) against JAX's pipelined
    and sequential ones."""
    for r in range(STAGES):
        got = pp_run["port"][r][(micro, "p2p")]["taps"]
        assert set(got) == {str(k) for k in TAPS}
        for k, v in got.items():
            for want in (pp_run["piped"][micro][k], pp_run["seq"][k]):
                np.testing.assert_allclose(v.numpy(), want, rtol=FWD_TOL,
                                           atol=FWD_TOL, err_msg=k)


@pytest.mark.parametrize("micro", MICROS)
def test_pp_gradients_match_the_sequential_backbone(pp_run, micro):
    """Rank s's gradient of its stage's blocks is the sequential
    backbone's of those blocks; the embedding's is the full one on every
    rank; the hand-off through ``all_gather`` gives the same bits."""
    grads = pp_run["grads"]
    want_staged, want_rest = pp.stack_vit_blocks(
        {k: torch.tensor(v) for k, v in grads.items()}, STAGES)
    for r in range(STAGES):
        out = pp_run["port"][r][(micro, "p2p")]
        for k, g in out["stage_grads"].items():
            np.testing.assert_allclose(g.numpy(), want_staged[k][r].numpy(),
                                       rtol=GRAD_TOL, atol=GRAD_TOL,
                                       err_msg=f"stage {r} {k}")
        for k, g in out["rest_grads"].items():
            np.testing.assert_allclose(g.numpy(), want_rest[k].numpy(),
                                       rtol=GRAD_TOL, atol=GRAD_TOL,
                                       err_msg=k)
        other = pp_run["port"][r][(micro, "gather")]
        for part in ("taps", "stage_grads", "rest_grads"):
            assert all(torch.equal(v, other[part][k])
                       for k, v in out[part].items()), part
