"""The port's backward passes against the JAX package: the pair MLP's plain
backward against the Pallas backward kernel (interpret mode, small tiles)
and against ``jax.vjp`` of the XLA twin; ``PairMLPFunction`` against its
plain backward and against autograd of the plain forward; and
``EdgeEmbedderFunction`` ("xla") against ``jax.vjp`` of the embedder's XLA
twin.

Tolerances: float32 1e-4, bf16 5e-2, as the forward tests; a gradient that
is a sum over the pair grid is measured against its own max-abs (every
gradient is compared as |got - want| <= tol * max(1, max|want|))."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from framedipt_tpu.model.pallas import edge_embedder as j_emb
from framedipt_tpu.model.pallas import pair_mlp as j_pair

from framedipt_tpu_torch.model.kernels import edge_embedder as t_emb
from framedipt_tpu_torch.model.kernels import pair_mlp as t_pair

from tests.test_torch_cuda import (
    assert_grads_close,
    emb_args,
    emb_to_torch,
    pair_args,
    pair_to_torch,
)

NAMES = ("d_pair", "d_i_term", "d_j_term", "d_row_mask", "d_col_mask", "d_w0", "d_b0",
         "d_w1", "d_b1", "d_wf", "d_bf", "d_ln_scale", "d_ln_bias", "d_fi", "d_fj", "d_wfe")


def _to_jax(args, dtype):
    return [None if x is None else jnp.asarray(x, jnp.float32 if i in (11, 12) else dtype)
            for i, x in enumerate(args)]


def _cotangent(rng, B, N, c_out):
    return rng.normal(size=(B, N, N, c_out)).astype(np.float32)


@pytest.mark.parametrize("residual", [True, False])
def test_pair_mlp_bwd_plain_matches_pallas_interpret(residual):
    """All 16 gradients (the mask gradients too) against the JAX backward
    kernel, run in interpret mode with tile_i=8, tile_j=16: widths 16/48/16,
    N=20 (not a tile multiple) with the last rows masked."""
    rng = np.random.default_rng(21)
    args = pair_args(rng, 2, 20, 16, 48, 16, residual)
    g = _cotangent(rng, 2, 20, 16)
    got = t_pair.pair_mlp_bwd(torch.as_tensor(g), *pair_to_torch(args, torch.float32))
    ja = _to_jax(args, jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        want = j_pair.fused_pair_mlp_bwd(jnp.asarray(g), *ja, tile_i=8, tile_j=16)
    assert_grads_close(got, want, 1e-4, NAMES)
    assert (got[3][:, -3:] != 0).any()  # mask gradients where the mask is 0


@pytest.mark.parametrize("dtype,tol", [(jnp.float32, 1e-4), (jnp.bfloat16, 5e-2)])
@pytest.mark.parametrize("residual", [True, False])
def test_pair_mlp_bwd_plain_matches_xla_vjp(dtype, tol, residual):
    rng = np.random.default_rng(22)
    args = pair_args(rng, 1, 13, 16, 48, 16, residual)
    g = _cotangent(rng, 1, 13, 16)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    got = t_pair.pair_mlp_bwd(torch.as_tensor(g).to(tdt), *pair_to_torch(args, tdt))
    ja = _to_jax(args, dtype)
    present = [i for i, a in enumerate(ja) if a is not None]

    def f(*xs):
        full = list(ja)
        for i, x in zip(present, xs):
            full[i] = x
        return j_pair._xla_pair_mlp(*full)

    _, vjp = jax.vjp(f, *[ja[i] for i in present])
    want = [None] * 16
    for i, d in zip(present, vjp(jnp.asarray(g, dtype))):
        want[i] = d
    assert_grads_close(got, want, tol, NAMES)
    assert got[0].dtype == tdt


@pytest.mark.parametrize("residual", [True, False])
def test_pair_mlp_function_matches_plain_backward_and_autograd(residual):
    """``PairMLPFunction`` through ``torch.autograd.grad`` on the CPU equals
    ``pair_mlp_bwd_plain`` exactly, and equals autograd through
    ``pair_mlp_plain`` (which checks the hand-written backward formulas);
    an input that needs no gradient gets None."""
    rng = np.random.default_rng(23)
    args = pair_to_torch(pair_args(rng, 2, 11, 16, 48, 16, residual), torch.float32)
    g = torch.as_tensor(_cotangent(rng, 2, 11, 16))
    args = [None if a is None else a.clone().requires_grad_(i not in (3, 4))
            for i, a in enumerate(args)]
    ins = [a for a in args if a is not None and a.requires_grad]
    via_fn = torch.autograd.grad(t_pair.PairMLPFunction.apply(*args), ins, g)
    via_plain = torch.autograd.grad(t_pair.pair_mlp_plain(*args), ins, g)
    direct = [d for d, a in zip(t_pair.pair_mlp_bwd_plain(g, *args), args)
              if a is not None and a.requires_grad]
    for a, b in zip(via_fn, direct):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    names = [n for n, a in zip(NAMES, args) if a is not None and a.requires_grad]
    assert_grads_close(via_fn, via_plain, 1e-4, names)

    row_mask = args[3].clone().requires_grad_()
    out = t_pair.PairMLPFunction.apply(*args[:3], row_mask, *args[4:])
    (d_rm,) = torch.autograd.grad(out, [row_mask], g)
    torch.testing.assert_close(d_rm, t_pair.pair_mlp_bwd_plain(g, *args)[3], atol=0, rtol=0)


def _emb_jax(args, dtype):
    return [jnp.asarray(x, jnp.float32 if i in (2, 3, 15, 16) else dtype)
            for i, x in enumerate(args)]


@pytest.mark.parametrize("n_bins", [22, 0])
def test_edge_embedder_function_xla_matches_jax_vjp(n_bins):
    """With "xla" the backward is the VJP of the plain formulation: every
    gradient but the coordinates' equals ``jax.vjp`` of the JAX XLA twin,
    with the d = 0 diagonal present (its coordinate gradient is NaN in the
    twin; the port returns None there, the JAX kernel 0)."""
    rng = np.random.default_rng(24)
    args, bins = emb_args(rng, 2, 14, 16, n_bins)
    g = rng.normal(size=(2, 14, 14, 16)).astype(np.float32)
    targs = [a.clone().requires_grad_(i not in (2, 3)) for i, a in
             enumerate(emb_to_torch(args, torch.float32))]
    out = t_emb.EdgeEmbedderFunction.apply("xla", *bins, *targs)
    ins = [a for a in targs if a.requires_grad]
    got = torch.autograd.grad(out, ins, torch.as_tensor(g))
    ja = _emb_jax(args, jnp.float32)
    _, vjp = jax.vjp(lambda *a: j_emb._xla_edge_embedder(*a, *bins), *ja)
    want = [w for i, w in enumerate(vjp(jnp.asarray(g))) if i not in (2, 3)]
    names = [f"arg{i}" for i in range(17) if i not in (2, 3)]
    assert_grads_close(got, want, 1e-4, names)

    pos = targs[2].detach().clone().requires_grad_()
    out = t_emb.EdgeEmbedderFunction.apply("xla", *bins, *targs[:2], pos, pos, *targs[4:])
    assert out.grad_fn is not None
    assert torch.autograd.grad(out.sum(), [pos], allow_unused=True) == (None,)


def test_edge_embedder_function_pallas_backward_raises():
    """The embedder's backward kernel is not ported: "pallas" runs the
    forward and raises NotImplementedError, naming the ROADMAP item, when
    a gradient is taken."""
    args, bins = emb_args(np.random.default_rng(25), 1, 6, 8, 4)
    targs = [a.requires_grad_(i not in (2, 3)) for i, a in
             enumerate(emb_to_torch(args, torch.float32))]
    out = t_emb.EdgeEmbedderFunction.apply("pallas", *bins, *targs)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 2 item 2"):
        out.sum().backward()
