"""The CUDA kernels against their plain versions on the card, and the input
builders that tests/test_torch_kernels.py shares.

This file imports neither JAX nor the JAX package, so it runs on a GPU
machine without them:

    python -m pytest -m gpu tests/test_torch_cuda.py

Tolerances: float32 atol/rtol 1e-4, bf16 5e-2 (as the CPU tests). Without a
card the tests skip."""
import numpy as np
import pytest
import torch

from framedipt_tpu_torch.model.kernels import edge_embedder as t_emb
from framedipt_tpu_torch.model.kernels import pair_mlp as t_pair


def pair_args(rng, B, N, c_in, h, c_out, residual, zero_rows=3):
    """numpy inputs of the pair MLP in the wrapper's argument order."""
    def a(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    mask = np.ones((B, N), np.float32)
    mask[:, N - zero_rows:] = 0.0
    args = [a(B, N, N, c_in), a(B, N, h, scale=0.5), a(B, N, h, scale=0.5), mask, mask,
            a(c_in, h, scale=c_in**-0.5), a(h, scale=0.1), a(h, h, scale=h**-0.5), a(h, scale=0.1),
            a(h, c_out, scale=h**-0.5), a(c_out, scale=0.1),
            1.0 + a(c_out, scale=0.1), a(c_out, scale=0.1)]
    if residual:
        args += [a(B, N, c_out, scale=0.5), a(B, N, c_out, scale=0.5), a(c_in, c_out, scale=c_in**-0.5)]
    else:
        args += [None, None, None]
    return args


def pair_to_torch(args, dtype):
    out = []
    for i, x in enumerate(args):
        if x is None:
            out.append(None)
        elif i in (11, 12):  # LayerNorm params stay float32
            out.append(torch.as_tensor(x))
        else:
            out.append(torch.as_tensor(x).to(dtype))
    return out


def emb_args(rng, B, N, c, n_bins, same_pos=True):
    """numpy inputs of the edge embedder in the wrapper's argument order,
    with a d = 0 pair off the diagonal and a distance near a bin edge, and
    the (lower, upper) bin edges; n_bins = 0 is a model without the
    self-conditioning distogram."""
    def a(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    seq_idx = np.sort(rng.integers(0, 3 * N, size=(B, N)), axis=-1)
    g, h = t_emb.rel_cp_factors(torch.as_tensor(seq_idx), 32)
    pos = a(B, N, 3, scale=6.0)
    pos[:, 1] = pos[:, 0]  # a d=0 pair off the diagonal
    mask = np.ones((B, N), np.float32)
    mask[:, N - 3:] = 0.0
    lower = np.linspace(1e-5, 20.0, n_bins)
    upper = np.concatenate([lower[1:], [1e8]]) if n_bins else lower
    if n_bins:
        pos[:, 2] = pos[:, 3] + np.asarray([lower[-1], 0.0, 0.0], np.float32)  # near a bin edge
    args = [g.numpy(), h.numpy(), pos, pos if same_pos else a(B, N, 3, scale=6.0),
            a(B, N, c, scale=0.5), a(B, N, c, scale=0.5), mask, mask,
            t_emb.expand_w_rel(torch.as_tensor(a(32, c, scale=0.3))).numpy(),
            a(n_bins, c, scale=0.3), a(c, scale=0.1), a(c, c, scale=c**-0.5), a(c, scale=0.1),
            a(c, c, scale=c**-0.5), a(c, scale=0.1), 1.0 + a(c, scale=0.1), a(c, scale=0.1)]
    return args, (tuple(float(x) for x in lower), tuple(float(x) for x in upper))


def emb_to_torch(args, dtype):
    # Coordinates and LayerNorm params stay float32.
    return [torch.as_tensor(x) if i in (2, 3, 15, 16) else torch.as_tensor(x).to(dtype)
            for i, x in enumerate(args)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_match_plain_versions(dtype):
    """On the card: both kernels against their plain versions at the
    serving widths, ragged N=200, B=2, and each launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    rng = np.random.default_rng(0)
    args = pair_args(rng, 2, 200, 128, 384, 128, True)
    args = [None if a is None else a.cuda() for a in pair_to_torch(args, dtype)]
    before = t_pair.pair_mlp.launches
    torch.testing.assert_close(t_pair.pair_mlp(*args), t_pair.pair_mlp_plain(*args),
                               atol=tol, rtol=tol)
    assert t_pair.pair_mlp.launches == before + 1
    for n_bins in (22, 0):  # with and without the self-conditioning distogram
        args, bins = emb_args(rng, 2, 200, 128, n_bins)
        args = [a.cuda() for a in emb_to_torch(args, dtype)]
        before = t_emb.edge_embedder.launches
        torch.testing.assert_close(t_emb.edge_embedder(*args, *bins),
                                   t_emb.edge_embedder_plain(*args, *bins), atol=tol, rtol=tol)
        assert t_emb.edge_embedder.launches == before + 1
