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
from framedipt_tpu_torch.model.kernels import ipa_attention as t_ipa
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


def ipa_args(rng, B, N, H, C, Pq, Pv, c_z, zero_rows=3, masked_row=1):
    """numpy inputs of the IPA attention before the point augmentation:
    (q pre-scaled, k, v [B,N,H*C], q_pts, k_pts [B,N,H,Pq,3], v_pts
    [B,N,H,Pv,3], point weights [H], z [B,N,N,c_z], mask [B,N], wb [c_z,H]
    pre-scaled, wdz [c_z,c_z//4]), with a padded tail and one fully masked
    row inside the valid range."""
    def a(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    mask = np.ones((B, N), np.float32)
    mask[:, N - zero_rows:] = 0.0
    mask[0, masked_row] = 0.0
    pt_w = np.log1p(np.exp(a(H))) * np.sqrt(1.0 / (3 * (Pq * 9.0 / 2)))
    return [a(B, N, H * C, scale=(3 * C) ** -0.5), a(B, N, H * C), a(B, N, H * C),
            a(B, N, H, Pq, 3, scale=3.0), a(B, N, H, Pq, 3, scale=3.0), a(B, N, H, Pv, 3, scale=3.0),
            pt_w.astype(np.float32), a(B, N, N, c_z), mask,
            a(c_z, H, scale=(3 * c_z) ** -0.5), a(c_z, c_z // 4, scale=c_z**-0.5)]


def ipa_to_torch(args, dtype, device="cpu"):
    """The wrapper's arguments (before the keywords) from :func:`ipa_args`."""
    q, k, v, qp, kp, vp, w, z, mask, wb, wdz = (torch.as_tensor(x, device=device) for x in args)
    qhat, khat, vpt = t_ipa.build_point_inputs(qp, kp, vp, w)
    return [q.to(dtype), k.to(dtype), v.to(dtype), qhat, khat, vpt, z.to(dtype), mask,
            wb.to(dtype), wdz.to(dtype)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_ipa_attention_matches_plain_version(dtype):
    """On the card: the IPA attention kernel against its plain version at
    the default widths, ragged N=200 (several key tiles) with a padded tail
    and a fully masked row, B=2; the launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    args = ipa_to_torch(ipa_args(np.random.default_rng(1), 2, 200, 8, 256, 8, 12, 128),
                        dtype, "cuda")
    before = t_ipa.ipa_attention.launches
    got = t_ipa.ipa_attention(*args, no_heads=8, no_v_points=12)
    want = t_ipa.ipa_attention_plain(*args, no_heads=8, no_v_points=12)
    assert t_ipa.ipa_attention.launches == before + 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=tol, rtol=tol)
        assert (g[0, 1] == 0).all()  # the fully masked row


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


def assert_grads_close(got, want, tol, names=None):
    """Each gradient (a tensor or an array) within tol of its reference on
    the scale max(1, its own max-abs): a gradient summed over the pair grid
    grows with N^2. A None reference wants a None gradient."""
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        name = names[i] if names else f"gradient {i}"
        assert (a is None) == (b is None), name
        if b is None:
            continue
        a = np.asarray(a.float() if isinstance(a, torch.Tensor) else a, np.float32)
        b = np.asarray(b.float() if isinstance(b, torch.Tensor) else b, np.float32)
        assert a.shape == b.shape, (name, a.shape, b.shape)
        scale = max(1.0, float(np.abs(b).max(initial=0.0)))
        err = float(np.abs(a - b).max(initial=0.0))
        assert err <= tol * scale, f"{name}: max err {err} > {tol} * {scale}"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,residual", [(2, 200, True), (1, 256, True), (2, 130, False)])
def test_cuda_pair_mlp_bwd_matches_plain_version(dtype, B, N, residual):
    """On the card: the backward kernel against its plain version at a
    ragged shape with masked rows and at a serving shape, all 16 gradients;
    two launches give the same bits; one launch counted per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    rng = np.random.default_rng(N)
    args = pair_to_torch(pair_args(rng, B, N, 128, 384, 128, residual, zero_rows=N // 10), dtype)
    args = [None if a is None else a.cuda() for a in args]
    g = torch.as_tensor(rng.normal(size=(B, N, N, 128)).astype(np.float32)).to(dtype).cuda()
    before = t_pair.pair_mlp_bwd.launches
    got = t_pair.pair_mlp_bwd(g, *args)
    again = t_pair.pair_mlp_bwd(g, *args)
    assert t_pair.pair_mlp_bwd.launches == before + 2
    assert_grads_close([None if a is None else a.cpu() for a in got],
                       [None if b is None else b.cpu() for b in t_pair.pair_mlp_bwd_plain(g, *args)], tol)
    for a, b in zip(got, again):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.gpu
def test_cuda_pair_mlp_function_matches_autograd_of_plain_version():
    """On the card: ``PairMLPFunction``'s gradients (forward and backward
    kernels) against autograd through ``pair_mlp_plain``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(3)
    args = pair_to_torch(pair_args(rng, 2, 96, 128, 384, 128, True), torch.float32)
    args = [a.cuda().requires_grad_(i not in (3, 4)) for i, a in enumerate(args)]
    g = torch.as_tensor(rng.normal(size=(2, 96, 96, 128)).astype(np.float32)).cuda()
    ins = [a for a in args if a.requires_grad]
    got = torch.autograd.grad(t_pair.PairMLPFunction.apply(*args), ins, g)
    want = torch.autograd.grad(t_pair.pair_mlp_plain(*args), ins, g)
    assert_grads_close([a.cpu() for a in got], [b.cpu() for b in want], 1e-4)
