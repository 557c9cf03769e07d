"""The port's edge-embedder backward against the JAX package's: the plain
backward (what CPU tensors take, and the kernel's reference on the card)
against the JAX Pallas backward kernel in interpret mode and against
``jax.vjp`` of the JAX XLA twin, and ``EdgeEmbedderFunction`` with "pallas"
against the plain backward and against its "xla" branch.

Inputs at the widths the kernels take (CP 64, edge width 128), small N.
Tolerances: float32 1e-4, bf16 5e-2, each gradient on the scale of
max(1, its own max-abs) (``assert_grads_close``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from framedipt_tpu.model.pallas import edge_embedder as j_emb

from framedipt_tpu_torch.model.kernels import edge_embedder as t_emb

from tests.test_torch_cuda import assert_grads_close, emb_args, emb_to_torch
from tests.torch_threads import one_torch_thread  # noqa: F401


NAMES = ("d_g", "d_h", "d_pos_rows", "d_pos_cols", "d_i_term", "d_j_term", "d_row_mask",
         "d_col_mask", "d_w_rel", "d_w_dist", "d_b0", "d_w1", "d_b1", "d_w2", "d_b2",
         "d_ln_scale", "d_ln_bias")
C = 128


def _jax_args(args, dtype):
    return [jnp.asarray(x, jnp.float32 if i in (2, 3, 15, 16) else dtype)
            for i, x in enumerate(args)]


def _kw(bins):
    return {"bins_lower": bins[0], "bins_upper": bins[1]}


def _without_coords(want):
    """The JAX gradients with the coordinates' (the port's None) set to
    None."""
    want = list(want)
    want[2] = want[3] = None
    return want


@pytest.mark.parametrize("n_bins", [22, 0])
def test_plain_backward_matches_pallas_interpret(n_bins):
    """All gradients against the JAX backward kernel run in interpret mode
    with tile_i=8, tile_j=16: B=2, N=20 (not a tile multiple), the last rows
    masked, with and without the distogram; the JAX coordinate gradients
    are exactly 0, the port's None."""
    rng = np.random.default_rng(31 + n_bins)
    args, bins = emb_args(rng, 2, 20, C, n_bins)
    g = rng.normal(size=(2, 20, 20, C)).astype(np.float32)
    got = t_emb.edge_embedder_bwd(torch.as_tensor(g), *emb_to_torch(args, torch.float32), **_kw(bins))
    j_args, j_bins = _jax_args(args, jnp.float32), bins
    if not n_bins:
        # The JAX kernel takes no zero-row block: one bin that no distance
        # falls in is the same function.
        j_args[9] = jnp.zeros((1, C), jnp.float32)
        j_bins = ((1e30,), (-1e30,))
    with pltpu.force_tpu_interpret_mode():
        want = list(j_emb.fused_edge_embedder_bwd(jnp.asarray(g), *j_args, **_kw(j_bins),
                                                  tile_i=8, tile_j=16))
    assert not np.asarray(want[2]).any() and not np.asarray(want[3]).any()
    if not n_bins:
        assert not np.asarray(want[9]).any()
        want[9] = want[9][:0]
    assert_grads_close(got, _without_coords(want), 1e-4, NAMES)
    assert (got[6][:, -3:] != 0).all() and (got[7][:, -3:] != 0).all()  # masked rows
    assert got[9].shape == (n_bins, C)


@pytest.mark.parametrize("dtype,tol", [(jnp.float32, 1e-4), (jnp.bfloat16, 5e-2)])
def test_plain_backward_matches_xla_vjp(dtype, tol):
    """Against ``jax.vjp`` of the XLA twin, whose coordinate gradients are
    NaN on the d = 0 pairs (the port gives none)."""
    rng = np.random.default_rng(33)
    args, bins = emb_args(rng, 1, 13, C, 22)
    g = rng.normal(size=(1, 13, 13, C)).astype(np.float32)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    got = t_emb.edge_embedder_bwd(torch.as_tensor(g).to(tdt), *emb_to_torch(args, tdt), **_kw(bins))
    @jax.jit
    def xla_vjp(cot, *a):
        return jax.vjp(lambda *x: j_emb._xla_edge_embedder(*x, *bins), *a)[1](cot)

    want = list(xla_vjp(jnp.asarray(g, dtype), *_jax_args(args, dtype)))
    want[2] = want[3] = None
    assert_grads_close(got, want, tol, NAMES)
    assert got[0].dtype == tdt and got[15].dtype == torch.float32


@pytest.mark.parametrize("n_bins", [22, 0])
def test_function_pallas_equals_plain_backward_and_xla_branch(n_bins):
    """``EdgeEmbedderFunction.apply("pallas", ...)`` through
    ``torch.autograd.grad`` on the CPU equals ``edge_embedder_bwd_plain``
    exactly and the "xla" branch (autograd of the plain forward) within
    1e-4; the coordinates get None; an input that needs no gradient gets
    None."""
    rng = np.random.default_rng(35)
    args, bins = emb_args(rng, 2, 11, C, n_bins)
    g = torch.as_tensor(rng.normal(size=(2, 11, 11, C)).astype(np.float32))
    targs = [a.clone().requires_grad_(i not in (2, 3)) for i, a in
             enumerate(emb_to_torch(args, torch.float32))]
    ins = [a for a in targs if a.requires_grad]
    via_pallas = torch.autograd.grad(t_emb.EdgeEmbedderFunction.apply("pallas", *bins, *targs),
                                     ins, g)
    via_xla = torch.autograd.grad(t_emb.EdgeEmbedderFunction.apply("xla", *bins, *targs), ins, g)
    direct = [d for d in t_emb.edge_embedder_bwd_plain(g, *targs, **_kw(bins)) if d is not None]
    for a, b in zip(via_pallas, direct):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert_grads_close(via_pallas, via_xla, 1e-4, [n for i, n in enumerate(NAMES) if i not in (2, 3)])

    pos = targs[2].detach().clone().requires_grad_()
    frozen = [a.detach() for a in targs]
    w1 = targs[11]
    out = t_emb.EdgeEmbedderFunction.apply("pallas", *bins, *frozen[:2], pos, pos, *frozen[4:11],
                                           w1, *frozen[12:])
    d_pos, d_w1 = torch.autograd.grad(out, [pos, w1], g, allow_unused=True)
    assert d_pos is None
    torch.testing.assert_close(d_w1, direct[9], atol=0, rtol=0)


def test_backward_counts_no_launch_on_the_cpu():
    rng = np.random.default_rng(37)
    args, bins = emb_args(rng, 1, 6, C, 4)
    before = t_emb.edge_embedder_bwd.launches
    t_emb.edge_embedder_bwd(torch.ones(1, 6, 6, C), *emb_to_torch(args, torch.float32), **_kw(bins))
    assert t_emb.edge_embedder_bwd.launches == before
