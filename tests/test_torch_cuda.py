"""The CUDA kernels against their plain versions on the card (every float32
edge-embedder and pair-MLP forward on its wgmma kernel, differentiated or
not, each backward's float32 kernel A on wgmma too; the mma.sync kernels in
bf16; float32 kernel B of both backwards, on wgmma, also alone against
float64), and the
input builders that tests/test_torch_kernels.py shares; on the card also the de
novo model's forward at N=500 through the kernels against their plain
versions, and the port's ProteinMPNN and its train step against the
recorded reference.

This file imports neither JAX nor the JAX package, so it runs on a GPU
machine without them:

    python -m pytest -m gpu tests/test_torch_cuda.py

Tolerances: float32 atol/rtol 1e-4, bf16 5e-2 (as the CPU tests). Without a
card the tests skip."""
import hashlib

import numpy as np
import pytest
import torch

from framedipt_tpu_torch.model.kernels import edge_embedder as t_emb
from framedipt_tpu_torch.model.kernels import ipa_attention as t_ipa
from framedipt_tpu_torch.model.kernels import pair_mlp as t_pair
from framedipt_tpu_torch.model.kernels import wgrad as t_wgrad


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
    if N > 1:
        pos[:, 1] = pos[:, 0]  # a d=0 pair off the diagonal
    mask = np.ones((B, N), np.float32)
    mask[:, max(N - 3, 1):] = 0.0
    lower = np.linspace(1e-5, 20.0, n_bins)
    upper = np.concatenate([lower[1:], [1e8]]) if n_bins else lower
    if n_bins and N > 3:
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
@pytest.mark.parametrize("N", [200, 768])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_ipa_attention_matches_plain_version(dtype, N):
    """On the card: the IPA attention kernels against their plain version at
    the default widths, B=2, ragged N=200 (several key tiles, split keys)
    and N=768 (past the JAX kernel's N <= 640 gate), with a padded tail and
    a fully masked row, which gives exactly 0; two launches give the same
    bits; each call counted once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    args = ipa_to_torch(ipa_args(np.random.default_rng(N), 2, N, 8, 256, 8, 12, 128),
                        dtype, "cuda")
    before = t_ipa.ipa_attention.launches
    got = t_ipa.ipa_attention(*args, no_heads=8, no_v_points=12)
    want = t_ipa.ipa_attention_plain(*args, no_heads=8, no_v_points=12)
    again = t_ipa.ipa_attention(*args, no_heads=8, no_v_points=12)
    assert t_ipa.ipa_attention.launches == before + 2
    for g, w, a in zip(got, want, again):
        torch.testing.assert_close(g, w, atol=tol, rtol=tol)
        assert torch.equal(g, a)  # two launches, the same bits
        assert (g[0, 1] == 0).all()  # the fully masked row


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_match_plain_versions(dtype):
    """On the card: both kernels against their plain versions at the
    serving widths, ragged N=200, B=2, and each launch counted; the pair MLP
    also at tiny and ragged shapes (B=1 N=1, B=1 N=17: one partial tile)
    and without its residual terms, two launches giving the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    rng = np.random.default_rng(0)
    for B, N, residual in ((2, 200, True), (1, 1, True), (1, 17, True), (1, 17, False),
                           (2, 200, False)):
        args = pair_args(rng, B, N, 128, 384, 128, residual, zero_rows=min(3, N - 1))
        args = [None if a is None else a.cuda() for a in pair_to_torch(args, dtype)]
        before = t_pair.pair_mlp.launches
        got = t_pair.pair_mlp(*args)
        torch.testing.assert_close(got, t_pair.pair_mlp_plain(*args), atol=tol, rtol=tol)
        assert torch.equal(got, t_pair.pair_mlp(*args)), (B, N, residual)
        assert t_pair.pair_mlp.launches == before + 2
    for n_bins in (22, 0):  # with and without the self-conditioning distogram
        args, bins = emb_args(rng, 2, 200, 128, n_bins)
        args = [a.cuda() for a in emb_to_torch(args, dtype)]
        before = t_emb.edge_embedder.launches
        torch.testing.assert_close(t_emb.edge_embedder(*args, *bins),
                                   t_emb.edge_embedder_plain(*args, *bins), atol=tol, rtol=tol)
        assert t_emb.edge_embedder.launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_row_blocks_match_the_full_launch(dtype):
    """On the card: the last rank's row block at sp=4 of a ragged N=230
    (56 rows of 58, two padded), as the sequence-parallel sampler launches
    it, through both kernels against the same rows of the full launch (bits
    equal), its padded rows 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from framedipt_tpu_torch.parallel.sp import row_block

    rng = np.random.default_rng(3)
    n, size, index, rows = 230, 4, 3, 58
    pair = [None if a is None else a.cuda()
            for a in pair_to_torch(pair_args(rng, 2, n, 128, 384, 128, True), dtype)]
    emb, bins = emb_args(rng, 2, n, 128, 22)
    emb = [a.cuda() for a in emb_to_torch(emb, dtype)]
    for fn, args, row_side, extra in ((t_pair.pair_mlp, pair, (0, 1, 3, 13), ()),
                                      (t_emb.edge_embedder, emb, (0, 2, 4, 6), bins)):
        full = fn(*args, *extra)
        block = fn(*[row_block(a, index, size) if i in row_side else a
                     for i, a in enumerate(args)], *extra)
        assert block.shape == (2, rows) + full.shape[2:]
        assert torch.equal(block[:, :n - index * rows], full[:, index * rows:])
        assert not block[:, n - index * rows:].any()


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,residual", [(2, 200, True), (2, 200, False), (1, 17, True),
                                          (1, 17, False)])
def test_cuda_pair_mlp_wgmma_matches_plain_version(B, N, residual):
    """On the card: the float32 forward without gradients (csrc/pair_mlp_wg.cu,
    wgmma and TMA) against the plain version within 1e-4, two launches
    bit-identical, counted on its route; its first step's TF32 weight parts
    equal wgmma_weight_split's bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(11)
    args = pair_args(rng, B, N, 128, 384, 128, residual, zero_rows=min(3, N - 1))
    args = [None if a is None else a.cuda() for a in pair_to_torch(args, torch.float32)]
    total, wgmma, mma = (t_pair.pair_mlp.launches, t_pair.pair_mlp.launches_wgmma,
                         t_pair.pair_mlp.launches_mma)
    got = t_pair.pair_mlp(*args)
    torch.testing.assert_close(got, t_pair.pair_mlp_plain(*args), atol=1e-4, rtol=1e-4)
    assert torch.equal(got, t_pair.pair_mlp(*args))
    assert (t_pair.pair_mlp.launches, t_pair.pair_mlp.launches_wgmma,
            t_pair.pair_mlp.launches_mma) == (total + 2, wgmma + 2, mma)
    (pair, i_term, j_term, row_mask, col_mask, w0, b0, w1, b1, wf, bf, ln_scale, ln_bias, fi, fj,
     wfe) = args
    split = torch.full((t_pair.WG_SPLIT_FLOATS,), float("nan"), device="cuda")
    out = torch.empty_like(got)
    ptrs = [None if a is None else a.data_ptr() for a in
            (pair, i_term, j_term, fi, fj, row_mask, col_mask, w0, b0, w1, b1, wf, bf, wfe,
             ln_scale, ln_bias, out, split)]
    assert t_pair._wg_kernel()(int(residual), *ptrs, B, N, N,
                               torch.cuda.current_stream().cuda_stream) == 0
    assert torch.equal(out, got)
    want = t_pair.wgmma_weight_split(*(None if w is None else w.cpu() for w in (w0, w1, wf, wfe)))
    n = t_pair.WG_SPLIT_FLOATS - (0 if residual else 2 * 128 * 128)  # Wfe's part unwritten
    assert torch.equal(split.cpu()[:n].view(torch.int32), want[:n].view(torch.int32))


@pytest.mark.gpu
def test_cuda_wgmma_probe_reads_float32_as_tf32():
    """On the card: one TF32 wgmma with raw float32 values in shared memory
    reads each as TF32, truncated or rounded (chip_smoke.py prints which),
    through the fragment layout the kernel assumes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a = torch.zeros(64, 8, device="cuda")
    a[torch.arange(64), torch.arange(64) % 8] = 1.0
    b = torch.as_tensor(np.random.default_rng(5).normal(size=(64, 8)).astype(np.float32)).cuda()
    d = t_pair.wgmma_tf32_probe(a, b)
    assert all(torch.equal(d[r], d[r % 8]) for r in range(64))
    read = torch.stack([d[r] for r in range(8)], 1)
    trunc = (b.view(torch.int32) & ~0x1FFF).view(torch.float32)
    assert torch.equal(read, trunc) or torch.equal(read, t_pair.tf32_rna(b))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["autograd", "inference_mode", "no_grad"])
def test_cuda_edge_transition_route(mode):
    """On the card at the kernels' widths: the edge transition's float32
    pair MLP launches the wgmma kernel under autograd (and its backward,
    kernel A on wgmma, runs), under inference_mode and under no_grad; the
    outputs with and without gradients are the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from framedipt_tpu_torch.model.ipa import EdgeTransition

    torch.manual_seed(0)
    layer = EdgeTransition(256, 128, 128, torch.float32).cuda()
    rng = np.random.default_rng(9)
    node = torch.as_tensor(rng.normal(size=(2, 40, 256)).astype(np.float32)).cuda()
    edge = torch.as_tensor(rng.normal(size=(2, 40, 40, 128)).astype(np.float32)).cuda()
    mask = torch.ones(2, 40, device="cuda")
    wgmma, mma = t_pair.pair_mlp.launches_wgmma, t_pair.pair_mlp.launches_mma
    ctx = {"inference_mode": torch.inference_mode, "no_grad": torch.no_grad,
           "autograd": torch.enable_grad}[mode]
    with ctx():
        out = layer(node, edge, mask)
    assert (t_pair.pair_mlp.launches_wgmma - wgmma, t_pair.pair_mlp.launches_mma - mma) == (1, 0)
    if mode == "autograd":
        bwd = t_pair.pair_mlp_bwd.launches_wgmma
        out.sum().backward()
        assert layer.final_layer.weight.grad is not None
        assert t_pair.pair_mlp_bwd.launches_wgmma == bwd + 1
    with torch.no_grad():
        other = layer(node, edge, mask) if mode == "autograd" else None
    if other is not None:
        assert torch.equal(out.detach(), other)


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


def kernel_relu_masks(g, args, tol, **kw):
    """The backward kernels' relu decisions (y0 > 0, y1 > 0), after checking
    that their recompute equals the forward kernel's output and that every
    relu site where the plain forward decides otherwise holds an activation
    within tol of 0 (the two forwards round differently)."""
    rec = {}
    t_pair.pair_mlp_bwd(g, *args, recompute=rec, **kw)
    # The forward that autograd differentiates (float32: the wgmma kernel;
    # bf16: the mma.sync kernel).
    assert torch.equal(rec["out"], t_pair.pair_mlp(*args))
    y0, y1, _ = t_pair._pre_norm(*args[:3], *args[5:11], *args[13:])
    for plain_y, kern_y in ((y0, rec["y0"]), (y1, rec["y1"])):
        flip = (plain_y > 0) != (kern_y > 0)
        if flip.any():
            assert float(torch.maximum(plain_y[flip].float(), kern_y[flip].float()).max()) <= tol
    return rec["y0"] > 0, rec["y1"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,residual,chunk_rows", [
    (2, 200, True, None), (1, 256, True, None), (2, 130, False, None),
    (1, 1, True, None), (1, 17, True, None), (2, 130, True, 60)])
def test_cuda_pair_mlp_bwd_matches_plain_version(dtype, B, N, residual, chunk_rows):
    """On the card: the backward kernels against their plain version at a
    ragged shape with masked rows, at a serving shape, at one pair and one
    partial tile, and with a workspace cap that makes the wrapper run in
    several chunks (chunk_rows grid rows each), all 16 gradients; two
    launches give the same bits; one launch counted per call. The kernels'
    recompute runs the forward kernel's code: its output equals the forward
    kernel's, every relu site where the plain forward falls on the other side
    of 0 holds an activation within rounding of 0 (tol), and the gradients
    are held against the plain backward through the recompute's relu
    decisions (the gradient jumps at such a site)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    rng = np.random.default_rng(N)
    args = pair_to_torch(pair_args(rng, B, N, 128, 384, 128, residual, zero_rows=max(1, N // 10)),
                         dtype)
    args = [None if a is None else a.cuda() for a in args]
    g = torch.as_tensor(rng.normal(size=(B, N, N, 128)).astype(np.float32)).to(dtype).cuda()
    kw = {}
    if chunk_rows:
        kw["workspace_cap"] = 4 * t_pair.split_workspace_floats(chunk_rows * N, dtype)
        chunks = t_pair.plan_bwd_chunks(B, N, N, kw["workspace_cap"], dtype)
        assert len(chunks) == -(-B * N // chunk_rows)
    before = t_pair.pair_mlp_bwd.launches
    got = t_pair.pair_mlp_bwd(g, *args, **kw)
    again = t_pair.pair_mlp_bwd(g, *args, **kw)
    assert t_pair.pair_mlp_bwd.launches == before + 2
    masks = kernel_relu_masks(g, args, tol, **kw)
    want = t_pair.pair_mlp_bwd_plain(g, *args, relu_masks=masks)
    assert_grads_close([None if a is None else a.cpu() for a in got],
                       [None if b is None else b.cpu() for b in want], tol)
    for a, b in zip(got, again):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,residual,chunk_rows", [
    (1, 1, True, None), (1, 17, True, None), (1, 17, False, None), (2, 200, True, 60),
    (2, 200, False, 60), (2, 256, True, None)])
def test_cuda_pair_mlp_bwd_wgmma_kernel_a(B, N, residual, chunk_rows):
    """On the card: the float32 backward, kernel A on wgmma and TMA
    (csrc/pair_mlp_bwd_wg.cu), at one pair, one partial tile, B=2 N=200 in
    several chunks and B=2 N=256: every gradient within 1e-4 of the plain
    version through the recompute's relu decisions, two launches
    bit-identical and counted on the wgmma route, the recompute equal to
    ``pair_mlp``'s output, and the first step's TF32 weight
    parts equal to wgmma_weight_split's and chain_weight_split's bit for
    bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(100 + N)
    args = pair_to_torch(pair_args(rng, B, N, 128, 384, 128, residual,
                                   zero_rows=min(3, max(N - 1, 0))), torch.float32)
    args = [None if a is None else a.cuda() for a in args]
    g = torch.as_tensor(rng.normal(size=(B, N, N, 128)).astype(np.float32)).cuda()
    kw = {}
    if chunk_rows:
        kw["workspace_cap"] = 4 * t_pair.split_workspace_floats(chunk_rows * N)
        assert len(t_pair.plan_bwd_chunks(B, N, N, kw["workspace_cap"])) == -(-B * N // chunk_rows)
    total, wgmma, mma = (t_pair.pair_mlp_bwd.launches, t_pair.pair_mlp_bwd.launches_wgmma,
                         t_pair.pair_mlp_bwd.launches_mma)
    got = t_pair.pair_mlp_bwd(g, *args, **kw)
    again = t_pair.pair_mlp_bwd(g, *args, **kw)
    assert (t_pair.pair_mlp_bwd.launches, t_pair.pair_mlp_bwd.launches_wgmma,
            t_pair.pair_mlp_bwd.launches_mma) == (total + 2, wgmma + 2, mma)
    masks = kernel_relu_masks(g, args, 1e-4, **kw)
    want = t_pair.pair_mlp_bwd_plain(g, *args, relu_masks=masks)
    assert_grads_close([None if a is None else a.cpu() for a in got],
                       [None if b is None else b.cpu() for b in want], 1e-4)
    for a, b in zip(got, again):
        assert (a is None and b is None) or torch.equal(a, b)
    # The C entry with scratch of our own: both weight splits, bit for bit.
    (pair, i_term, j_term, row_mask, col_mask, w0, b0, w1, b1, wf, bf, ln_scale, ln_bias, fi, fj,
     wfe) = args
    split = torch.full((2 * t_pair.WG_SPLIT_FLOATS,), float("nan"), device="cuda")
    ws = torch.empty(t_pair.split_workspace_floats(B * N * N), device="cuda")
    out = torch.zeros(t_pair.W_PART_FLOATS + 2 * B * N * t_pair.ROW_PART, device="cuda")
    d_pair = torch.empty_like(pair)
    ptrs = [None if a is None else a.data_ptr() for a in
            (g, pair, i_term, j_term, fi, fj, row_mask, col_mask, w0, b0, w1, b1, wf, bf, wfe,
             ln_scale, ln_bias, d_pair, ws)]
    wred = out.data_ptr()
    rowred = wred + 4 * t_pair.W_PART_FLOATS
    colred = rowred + 4 * B * N * t_pair.ROW_PART
    assert t_pair._bwd_wg_kernel()(int(residual), *ptrs, ws.numel(), split.data_ptr(), wred,
                                   rowred, colred, B, N, N, 0, B * N, None,
                                   torch.cuda.current_stream().cuda_stream) == 0
    assert torch.equal(d_pair, got[0])
    n = t_pair.WG_SPLIT_FLOATS - (0 if residual else 2 * 128 * 128)  # Wfe's part unwritten
    cpu = [None if w is None else w.cpu() for w in (w0, w1, wf, wfe)]
    for part, want_split in ((split[:t_pair.WG_SPLIT_FLOATS], t_pair.wgmma_weight_split(*cpu)),
                             (split[t_pair.WG_SPLIT_FLOATS:], t_pair.chain_weight_split(*cpu))):
        assert torch.equal(part.cpu()[:n].view(torch.int32), want_split[:n].view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("P,M,N,slices", [(1, 128, 128, 8), (289, 384, 384, 8),
                                          (2 * 200 * 200, 128, 384, 8), (289, 64, 128, 44),
                                          (5_000, 64, 128, 44)])
def test_cuda_wgrad_f32_matches_float64(P, M, N, slices):
    """On the card: float32 kernel B alone (csrc/wgrad_wg.cuh through
    ``wgrad_f32``) against float64 a^T b within 1e-4 of its max-abs: one
    pair, one partial step, a ragged chunk of 80,000 pairs, the embedder's
    64-row job; two launches give the same bits; one launch counted each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(P + M)
    a = torch.as_tensor(np.maximum(rng.normal(size=(P, M)), 0.0).astype(np.float32)).cuda()
    b = torch.as_tensor(rng.normal(size=(P, N)).astype(np.float32)).cuda()
    before = t_wgrad.wgrad_f32.launches
    got = t_wgrad.wgrad_f32(a, b, slices)
    again = t_wgrad.wgrad_f32(a, b, slices)
    assert t_wgrad.wgrad_f32.launches == before + 2
    want = a.double().t() @ b.double()
    assert float((got.double() - want).abs().max()) <= 1e-4 * float(want.abs().max())
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("P,M,N,slices", [(1, 128, 128, 8), (289, 384, 384, 8),
                                          (2 * 200 * 200, 128, 384, 8), (289, 64, 128, 44),
                                          (5_000, 64, 128, 44)])
def test_cuda_wgrad_bf16_matches_float64(P, M, N, slices):
    """On the card: bf16 kernel B alone (csrc/wgrad_bf16.cuh through
    ``wgrad_bf16``) against float64 a^T b of the same bf16 operands within
    1e-4 of its max-abs: one pair, one partial step, a ragged chunk of
    80,000 pairs, the embedder's 64-row job; two launches give the same
    bits; one launch counted each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(P + M + 1)
    a = torch.as_tensor(np.maximum(rng.normal(size=(P, M)), 0.0)).to(torch.bfloat16).cuda()
    b = torch.as_tensor(rng.normal(size=(P, N))).to(torch.bfloat16).cuda()
    before = t_wgrad.wgrad_bf16.launches
    got = t_wgrad.wgrad_bf16(a, b, slices)
    again = t_wgrad.wgrad_bf16(a, b, slices)
    assert t_wgrad.wgrad_bf16.launches == before + 2
    want = a.double().t() @ b.double()
    assert float((got.double() - want).abs().max()) <= 1e-4 * float(want.abs().max())
    assert torch.equal(got, again)


@pytest.mark.gpu
def test_cuda_float32_backwards_launch_the_wgmma_kernel_b():
    """On the card, read from torch.profiler: a float32 pair-MLP backward and
    a float32 embedder backward each launch kernel B as
    ``wgrad_wg_kernel`` (csrc/wgrad_wg.cuh) once a chunk and never bf16's
    ``wgrad_bf16_kernel`` (csrc/wgrad_bf16.cuh); a bf16 pair-MLP backward
    and a bf16 embedder backward the other way round."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(5)

    def names(fn):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return [e.name for e in prof.events() if "wgrad" in e.name]

    for dtype in (torch.float32, torch.bfloat16):
        args = [None if a is None else a.cuda()
                for a in pair_to_torch(pair_args(rng, 1, 40, 128, 384, 128, True), dtype)]
        g = torch.as_tensor(rng.normal(size=(1, 40, 40, 128)).astype(np.float32)).to(dtype).cuda()
        got = names(lambda: t_pair.pair_mlp_bwd(g, *args))
        want = "wgrad_wg_kernel" if dtype == torch.float32 else "wgrad_bf16_kernel"
        assert len(got) == 1 and want in got[0], got
    raw, bins = emb_args(rng, 1, 40, 128, 22)
    for dtype in (torch.float32, torch.bfloat16):
        eargs = [a.cuda() for a in emb_to_torch(raw, dtype)]
        g = torch.as_tensor(rng.normal(size=(1, 40, 40, 128)).astype(np.float32)).to(dtype).cuda()
        got = names(lambda: t_emb.edge_embedder_bwd(g, *eargs, bins_lower=bins[0],
                                                    bins_upper=bins[1]))
        want = "wgrad_wg_kernel" if dtype == torch.float32 else "wgrad_bf16_kernel"
        assert len(got) == 1 and want in got[0], got


@pytest.mark.gpu
def test_cuda_pair_mlp_function_matches_autograd_of_plain_version():
    """On the card: ``PairMLPFunction``'s gradients (forward and backward
    kernels) against autograd through ``pair_mlp_plain``, taken through the
    kernels' relu decisions (``kernel_relu_masks``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(3)
    args = pair_to_torch(pair_args(rng, 2, 96, 128, 384, 128, True), torch.float32)
    args = [a.cuda().requires_grad_(i not in (3, 4)) for i, a in enumerate(args)]
    g = torch.as_tensor(rng.normal(size=(2, 96, 96, 128)).astype(np.float32)).cuda()
    ins = [a for a in args if a.requires_grad]
    got = torch.autograd.grad(t_pair.PairMLPFunction.apply(*args), ins, g)
    with torch.no_grad():
        masks = kernel_relu_masks(g, [a.detach() for a in args], 1e-4)
    want = torch.autograd.grad(t_pair.pair_mlp_plain(*args, relu_masks=masks), ins, g)
    assert_grads_close([a.cpu() for a in got], [b.cpu() for b in want], 1e-4)


def emb_differentiated(args, bins):
    """The edge-embedder forward as autograd records it:
    EdgeEmbedderFunction on inputs that require gradients."""
    with torch.enable_grad():
        ins = [a.detach().requires_grad_() for a in args]
        return t_emb.EdgeEmbedderFunction.apply("pallas", *bins, *ins).detach()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,n_bins", [(1, 1, 22), (1, 17, 22), (3, 75, 22), (3, 75, 0)])
def test_cuda_edge_embedder_matches_plain_version(dtype, B, N, n_bins):
    """On the card: the edge-embedder forward (csrc/edge_embedder_wg.cu in
    float32, csrc/edge_embedder.cu in bf16) against its plain version at one
    pair, one partial tile and a ragged grid, with and without distance
    bins; two launches give the same bits, and so does the forward autograd
    records (the same kernel); one launch counted per call, on the dtype's
    route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    args, bins = emb_args(np.random.default_rng(N + n_bins), B, N, 128, n_bins)
    args = [a.cuda() for a in emb_to_torch(args, dtype)]
    route = "launches_wgmma" if dtype == torch.float32 else "launches_mma"
    before, on_route = t_emb.edge_embedder.launches, getattr(t_emb.edge_embedder, route)
    got = t_emb.edge_embedder(*args, *bins)
    again = t_emb.edge_embedder(*args, *bins)
    assert t_emb.edge_embedder.launches == before + 2
    assert getattr(t_emb.edge_embedder, route) == on_route + 2
    torch.testing.assert_close(got, t_emb.edge_embedder_plain(*args, *bins), atol=tol, rtol=tol)
    assert torch.equal(got, again)
    assert torch.equal(got, emb_differentiated(args, bins))


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,n_bins", [(2, 200, 22), (1, 17, 22), (1, 1, 22), (2, 200, 0)])
def test_cuda_edge_embedder_wgmma_matches_plain_version(B, N, n_bins):
    """On the card: the float32 forward without gradients
    (csrc/edge_embedder_wg.cu, wgmma and TMA) against the plain version
    within 1e-4, two launches bit-identical, counted on its route; its first
    step's TF32 weight parts equal wgmma_weight_split's bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args, bins = emb_args(np.random.default_rng(N + n_bins + 1), B, N, 128, n_bins)
    args = [a.cuda() for a in emb_to_torch(args, torch.float32)]
    total, wgmma, mma = (t_emb.edge_embedder.launches, t_emb.edge_embedder.launches_wgmma,
                         t_emb.edge_embedder.launches_mma)
    got = t_emb.edge_embedder(*args, *bins)
    torch.testing.assert_close(got, t_emb.edge_embedder_plain(*args, *bins), atol=1e-4, rtol=1e-4)
    assert torch.equal(got, t_emb.edge_embedder(*args, *bins))
    assert (t_emb.edge_embedder.launches, t_emb.edge_embedder.launches_wgmma,
            t_emb.edge_embedder.launches_mma) == (total + 2, wgmma + 2, mma)
    edges = t_emb._edges(*bins, args[0].device)
    split = torch.full((t_emb.WG_SPLIT_FLOATS,), float("nan"), device="cuda")
    out = torch.empty_like(got)
    ptrs = ([a.data_ptr() for a in args[:10]] + [edges[0].data_ptr(), edges[1].data_ptr()]
            + [a.data_ptr() for a in args[10:]] + [out.data_ptr(), split.data_ptr()])
    assert t_emb._wg_kernel()(*ptrs, n_bins, B, N, N, torch.cuda.current_stream().cuda_stream) == 0
    assert torch.equal(out, got)
    want = t_emb.wgmma_weight_split(*(args[k].cpu() for k in (8, 11, 13)))
    assert torch.equal(split.cpu().view(torch.int32), want.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("needs_grad", [False, True])
def test_cuda_edge_embedder_row_blocks_on_both_routes(needs_grad):
    """On the card: each rank's row block at sp=4 of a ragged N=230 (58 rows,
    the last 56 and two padded) through the float32 forward without and with
    autograd recording it (the wgmma kernel either way) against the same rows of the
    full launch, bit for bit, the padded rows 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from framedipt_tpu_torch.parallel.sp import row_block

    args, bins = emb_args(np.random.default_rng(5), 2, 230, 128, 22)
    args = [a.cuda() for a in emb_to_torch(args, torch.float32)]
    def forward(ins):
        return emb_differentiated(ins, bins) if needs_grad else t_emb.edge_embedder(*ins, *bins)

    full = forward(args)
    for index in range(4):
        block = forward([row_block(a, index, 4) if i in (0, 2, 4, 6) else a
                         for i, a in enumerate(args)])
        valid = min(230, 58 * (index + 1)) - 58 * index
        assert block.shape == (2, 58, 230, 128)
        assert torch.equal(block[:, :valid], full[:, 58 * index:58 * index + valid])
        assert not block[:, valid:].any()


# sha256 of the differentiated edge_embedder's output bytes for
# emb_args(default_rng(97), 3, 75, 128, 22) on an NVIDIA H100 80GB HBM3:
# bf16's (csrc/edge_embedder.cu) as the build before the forward's tile
# became the backward's recompute (edge_embedder_tc.cuh) gave them; float32's
# (csrc/edge_embedder_wg.cu) as the build before the wgmma forward's unit
# became the float32 backward's recompute (edge_embedder_wg.cuh) gave them.
EMB_FORWARD_SHA256 = {
    torch.float32: "d6972038ded1d99485a3114e88a90464efa856be4a13b2d9d3c6e34301074a8a",
    torch.bfloat16: "d769df20453f7180def773a2a14e523e391f22a71d4e50b699bc69ddeec3caa8",
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_edge_embedder_output_unchanged(dtype):
    """On the card: the forward autograd records (float32 the wgmma kernel,
    bf16 the mma.sync one) gives the same bits as before its code was
    shared with the backward's recompute; so does the forward without
    gradients."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args, bins = emb_args(np.random.default_rng(97), 3, 75, 128, 22)
    args = [a.cuda() for a in emb_to_torch(args, dtype)]
    out = emb_differentiated(args, bins)
    as_int = out.view(torch.int16 if dtype == torch.bfloat16 else torch.int32)
    assert hashlib.sha256(as_int.cpu().numpy().tobytes()).hexdigest() == EMB_FORWARD_SHA256[dtype]
    assert torch.equal(out, t_emb.edge_embedder(*args, *bins))


def emb_kernel_relu_masks(g, args, bins, tol, **kw):
    """The embedder backward kernels' relu decisions (y0 > 0, y1 > 0),
    after checking that their recompute equals the output of the forward
    kernel whose code it shares (the dtype's route: the wgmma kernel in
    float32, the mma.sync one in bf16) and that every relu
    site where the plain forward decides otherwise holds an activation
    within tol of 0."""
    rec = {}
    t_emb.edge_embedder_bwd(g, *args, bins_lower=bins[0], bins_upper=bins[1], recompute=rec, **kw)
    assert torch.equal(rec["out"], t_emb.edge_embedder(*args, *bins))
    _, _, y0, y1, _ = t_emb._pre_norm(*args[:6], *args[8:15], *bins)
    for plain_y, kern_y in ((y0, rec["y0"]), (y1, rec["y1"])):
        flip = (plain_y > 0) != (kern_y > 0)
        if flip.any():
            assert float(torch.maximum(plain_y[flip].float(), kern_y[flip].float()).max()) <= tol
    return rec["y0"] > 0, rec["y1"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,n_bins,chunk_rows", [
    (2, 200, 22, None), (1, 256, 22, None), (2, 130, 0, None), (1, 1, 22, None),
    (1, 17, 22, None), (1, 17, 0, None), (2, 130, 22, 60), (1, 70, 22, None)])
def test_cuda_edge_embedder_bwd_matches_plain_version(dtype, B, N, n_bins, chunk_rows):
    """On the card: the embedder's backward kernels (float32: kernel A on
    wgmma, csrc/edge_embedder_bwd_wg.cu) against their plain version at a
    ragged shape with masked rows, at a serving shape, at one pair and one
    partial tile, with and without distance bins, at N=70 (two units a row,
    the second ragged), and with a workspace cap that makes the wrapper run
    in several chunks (chunk_rows grid rows each), every gradient; two
    launches give the same bits; one launch counted per call, on the dtype's
    route. The kernels' recompute runs the forward
    kernel's code: its output equals the forward kernel's, every relu site
    where the plain forward falls on the other side of 0 holds an activation
    within rounding of 0 (tol), and the gradients are held against the plain
    backward through the recompute's relu decisions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    rng = np.random.default_rng(N + n_bins)
    args, bins = emb_args(rng, B, N, 128, n_bins)
    args = [a.cuda() for a in emb_to_torch(args, dtype)]
    g = torch.as_tensor(rng.normal(size=(B, N, N, 128)).astype(np.float32)).to(dtype).cuda()
    kw = {"bins_lower": bins[0], "bins_upper": bins[1]}
    cap = {}
    if chunk_rows:
        cap["workspace_cap"] = 4 * t_emb.split_workspace_floats(
            chunk_rows * N, n_bins, dtype, t_emb.split_parts(chunk_rows, N, dtype))
        assert len(t_emb.plan_bwd_chunks(B, N, N, n_bins, cap["workspace_cap"], dtype)) == -(
            -B * N // chunk_rows)
    route = "launches_wgmma" if dtype == torch.float32 else "launches_mma"
    before, on_route = t_emb.edge_embedder_bwd.launches, getattr(t_emb.edge_embedder_bwd, route)
    got = t_emb.edge_embedder_bwd(g, *args, **kw, **cap)
    again = t_emb.edge_embedder_bwd(g, *args, **kw, **cap)
    assert t_emb.edge_embedder_bwd.launches == before + 2
    assert getattr(t_emb.edge_embedder_bwd, route) == on_route + 2
    masks = emb_kernel_relu_masks(g, args, bins, tol, **cap)
    want = t_emb.edge_embedder_bwd_plain(g, *args, **kw, relu_masks=masks)
    assert_grads_close([None if a is None else a.cpu() for a in got],
                       [None if b is None else b.cpu() for b in want], tol)
    for a, b in zip(got, again):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2.0**-7)])
def test_cuda_edge_embedder_bwd_chunks_agree(dtype, tol):
    """On the card: the backward in 13 chunks of 20 grid rows gives the
    one-chunk gradients up to float32 reordering of the sums (bf16: then
    each gradient rounds to bf16, so a reordering can move it by one bf16
    step, 2^-7 of its value)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(11)
    args, bins = emb_args(rng, 2, 130, 128, 22)
    args = [a.cuda() for a in emb_to_torch(args, dtype)]
    g = torch.as_tensor(rng.normal(size=(2, 130, 130, 128)).astype(np.float32)).to(dtype).cuda()
    kw = {"bins_lower": bins[0], "bins_upper": bins[1]}
    cap = 4 * t_emb.split_workspace_floats(20 * 130, 22, dtype, t_emb.split_parts(20, 130, dtype))
    assert len(t_emb.plan_bwd_chunks(2, 130, 130, 22, cap, dtype)) == 13
    one = t_emb.edge_embedder_bwd(g, *args, **kw)
    many = t_emb.edge_embedder_bwd(g, *args, **kw, workspace_cap=cap)
    assert_grads_close([None if a is None else a.cpu() for a in many],
                       [None if b is None else b.cpu() for b in one], tol)


@pytest.mark.gpu
@pytest.mark.parametrize("B,N", [(2, 200), (1, 17), (1, 70)])
def test_cuda_edge_embedder_bwd_wgmma_kernel_a_scratch(B, N):
    """On the card: the float32 backward's C entry (kernel A on wgmma) with
    NaN-filled scratch writes the forward's and the chain's TF32 weight
    parts (wgmma_weight_split, chain_weight_split) bit for bit, and its
    d_w_rel equals the wrapper's; the wrapper counts its call on the wgmma
    route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(B * N)
    args, bins = emb_args(rng, B, N, 128, 22)
    args = [a.cuda() for a in emb_to_torch(args, torch.float32)]
    g = torch.as_tensor(rng.normal(size=(B, N, N, 128)).astype(np.float32)).cuda()
    edges = t_emb._edges(*bins, args[0].device)
    split = torch.full((2 * t_emb.WG_SPLIT_FLOATS,), float("nan"), device="cuda")
    ws = torch.empty(t_emb.split_workspace_floats(B * N * N, 22, torch.float32,
                                                  t_emb.split_parts(B * N, N)), device="cuda")
    sums = torch.zeros(t_emb.W_PART_FLOATS + (B * N + B * N) * t_emb.ROW_PART, device="cuda")
    base = sums.data_ptr()
    ptrs = ([g.data_ptr()] + [a.data_ptr() for a in args[:10]]
            + [edges[0].data_ptr(), edges[1].data_ptr()] + [a.data_ptr() for a in args[10:]])
    err = t_emb._bwd_wg_kernel()(
        *ptrs, ws.data_ptr(), ws.numel(), split.data_ptr(), base, base + 4 * t_emb.W_PART_FLOATS,
        base + 4 * (t_emb.W_PART_FLOATS + B * N * t_emb.ROW_PART), 22, B, N, N, 0, B * N, None,
        torch.cuda.current_stream().cuda_stream)
    assert err == 0
    w = [args[k].cpu() for k in (8, 11, 13)]
    want = torch.cat([t_emb.wgmma_weight_split(*w), t_emb.chain_weight_split(*w)])
    assert torch.equal(split.cpu().view(torch.int32), want.view(torch.int32))
    wgmma = t_emb.edge_embedder_bwd.launches_wgmma
    got = t_emb.edge_embedder_bwd(g, *args, bins_lower=bins[0], bins_upper=bins[1])
    assert t_emb.edge_embedder_bwd.launches_wgmma == wgmma + 1
    assert torch.equal(sums[:64 * 128].view(64, 128), got[8])


@pytest.mark.gpu
def test_cuda_edge_embedder_function_pallas_matches_autograd_of_plain_version():
    """On the card: ``EdgeEmbedderFunction`` with "pallas" (forward and
    backward kernels) against autograd through ``edge_embedder_plain``,
    taken through the backward kernels' relu decisions
    (``emb_kernel_relu_masks``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(5)
    args, bins = emb_args(rng, 2, 96, 128, 22)
    args = [a.cuda().requires_grad_(i not in (2, 3)) for i, a in
            enumerate(emb_to_torch(args, torch.float32))]
    g = torch.as_tensor(rng.normal(size=(2, 96, 96, 128)).astype(np.float32)).cuda()
    ins = [a for a in args if a.requires_grad]
    before = t_emb.edge_embedder_bwd.launches
    got = torch.autograd.grad(t_emb.EdgeEmbedderFunction.apply("pallas", *bins, *args), ins, g)
    assert t_emb.edge_embedder_bwd.launches == before + 1
    with torch.no_grad():
        masks = emb_kernel_relu_masks(g, [a.detach() for a in args], bins, 1e-4)
    want = torch.autograd.grad(t_emb.edge_embedder_plain(*args, *bins, relu_masks=masks), ins, g)
    assert_grads_close([a.cpu() for a in got], [b.cpu() for b in want], 1e-4)


def denovo_feats(rng, N, device):
    """A de novo model input of one structure of N residues: every residue
    diffused, frames of unit quaternions and translations spread as the
    reference distribution spreads them, t = 0.6."""
    qs = rng.normal(size=(1, N, 4))
    qs /= np.linalg.norm(qs, axis=-1, keepdims=True)
    feats = {
        "res_mask": np.ones((1, N)), "fixed_mask": np.zeros((1, N)),
        "seq_idx": np.arange(N)[None], "t": np.asarray([0.6]),
        "sc_ca_t": rng.normal(size=(1, N, 3)) * 8.0,
        "rigids_t": np.concatenate([qs, rng.normal(size=(1, N, 3)) * 8.0], axis=-1),
        "torsion_angles_sin_cos": np.zeros((1, N, 7, 2)),
    }
    return {k: torch.as_tensor(v, dtype=torch.int64 if k == "seq_idx" else torch.float32,
                               device=device) for k, v in feats.items()}


@pytest.mark.gpu
def test_cuda_denovo_forward_n500_matches_plain_versions(monkeypatch):
    """On the card: the default model at the de novo config
    (inpainting=False, the embedder without aatype), float32, one structure
    of N=500 (a partial tile), the fixtures' synthesised weights: the
    forward through the kernels against the same forward through their
    plain versions (every output within 1e-3 of its scale), one embedder
    and three pair-MLP launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from framedipt_tpu_torch.diffusion import SE3Diffuser
    from framedipt_tpu_torch.model import ScoreNetwork
    from framedipt_tpu_torch.model.weights import synth_state_dict
    from framedipt_tpu_torch.tools.config import Config, resolve_kernel_flags
    from framedipt_tpu_torch.tools.device import set_full_precision_matmul

    set_full_precision_matmul()
    cfg = Config()
    resolve_kernel_flags(cfg, torch.device("cuda"))
    net = ScoreNetwork(cfg.model, SE3Diffuser(cfg.diffuser, device="cuda"), inpainting=False)
    net.load_state_dict(synth_state_dict(net), strict=True)
    net.cuda().eval()
    feats = denovo_feats(np.random.default_rng(500), 500, "cuda")
    before = (t_emb.edge_embedder.launches, t_pair.pair_mlp.launches)
    with torch.inference_mode():
        got = net(feats)
    assert (t_emb.edge_embedder.launches, t_pair.pair_mlp.launches) == (
        before[0] + 1, before[1] + cfg.model.ipa.num_blocks - 1)
    monkeypatch.setattr(t_emb, "edge_embedder", t_emb.edge_embedder_plain)
    monkeypatch.setattr(t_pair, "pair_mlp", t_pair.pair_mlp_plain)
    with torch.inference_mode():
        want = net(feats)
    for key in ("psi", "rot_score", "trans_score", "atom37"):
        g, w = got[key].float().cpu(), want[key].float().cpu()
        assert torch.isfinite(g).all(), key
        scale = max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) / scale < 1e-3, key


@pytest.mark.gpu
def test_cuda_mpnn_matches_recorded_reference():
    """On the card: the port's ProteinMPNN with the recorded fixture's
    synthesised weights against the recorded reference ProteinMPNN:
    log-probabilities in a random and a fixed order and unconditional, and
    the scores, within 2e-4 (products in full float32); the near-greedy
    sample's S and decoding order equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import pathlib

    from framedipt_tpu_torch.model import mpnn
    from framedipt_tpu_torch.model.weights import synth_value
    from framedipt_tpu_torch.tools.device import set_full_precision_matmul

    set_full_precision_matmul()
    z = np.load(pathlib.Path(__file__).parent / "parity" / "fixtures" / "recorded_mpnn_parity.npz")
    model = mpnn.ProteinMPNN(mpnn.MPNNConfig(k_neighbors=48))
    model.load_state_dict({str(n): torch.as_tensor(synth_value(
        str(n), tuple(int(x) for x in s.split(",")), seed=int(z["seed"])))
        for n, s in zip(z["manifest_names"], z["manifest_shapes"])}, strict=True)
    model.cuda().eval()
    f = {k[3:]: torch.as_tensor(z[k], device="cuda") for k in z.files if k.startswith("in_")}
    x = (f["X"], f["S"], f["mask"], f["chain_M"], f["residue_idx"], f["chain_encoding_all"])
    with torch.inference_mode():
        lp = mpnn.mpnn_log_probs(model, *x, randn=torch.as_tensor(z["randn_fwd"], device="cuda"))
        fixed = mpnn.mpnn_log_probs(model, *x,
                                    decoding_order=torch.as_tensor(z["order_fixed"], device="cuda"))
        uncond = mpnn.mpnn_unconditional_log_probs(model, f["X"], f["mask"], f["residue_idx"],
                                                   f["chain_encoding_all"])
        scores = mpnn.mpnn_scores(f["S"], lp, f["mask"] * f["chain_M"])
    for got, key in ((lp, "log_probs_rand"), (fixed, "log_probs_fixed"),
                     (uncond, "log_probs_uncond"), (scores, "scores")):
        np.testing.assert_allclose(got.cpu().numpy(), z[key], atol=2e-4, rtol=2e-4, err_msg=key)
    out = mpnn.mpnn_sample(model, torch.Generator(device="cuda").manual_seed(3), f["X"],
                           torch.as_tensor(z["randn_smp"], device="cuda"), f["S"], f["chain_M"],
                           f["chain_encoding_all"], f["residue_idx"], f["mask"], temperature=1e-4)
    np.testing.assert_array_equal(out["S"].cpu().numpy(), z["sample_S"])
    np.testing.assert_array_equal(out["decoding_order"].cpu().numpy(), z["sample_order"])


@pytest.mark.gpu
def test_cuda_mpnn_train_step_matches_recorded_reference():
    """On the card: ProteinMPNN's train step at the published width on the
    recorded structure and weights (dropout 0, no noise, the recording's
    decoding order): the loss within 2e-4 (relative) of the smoothed loss of
    the recorded log-probabilities, and every gradient within 1e-4 of its
    max-abs of the same step on the CPU (the card's gather backward sums
    with atomics, in another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import pathlib

    from framedipt_tpu_torch.model import mpnn
    from framedipt_tpu_torch.model.weights import synth_value
    from framedipt_tpu_torch.tools.device import set_full_precision_matmul
    from framedipt_tpu_torch.train.mpnn_train import MPNNTrainer, smoothed_loss

    set_full_precision_matmul()
    z = np.load(pathlib.Path(__file__).parent / "parity" / "fixtures" / "recorded_mpnn_parity.npz")
    sd = {str(n): torch.as_tensor(synth_value(str(n), tuple(int(x) for x in s.split(",")),
                                              seed=int(z["seed"])))
          for n, s in zip(z["manifest_names"], z["manifest_shapes"])}
    f = {k[3:]: torch.as_tensor(z[k]) for k in z.files if k.startswith("in_")}
    randn = torch.as_tensor(z["randn_fwd"])

    def first_step(device):
        model = mpnn.ProteinMPNN(mpnn.MPNNConfig(k_neighbors=48, dropout=0.0))
        model.load_state_dict(sd, strict=True)
        m = MPNNTrainer(model.to(device)).step(
            {k: v.to(device) for k, v in f.items()},
            torch.Generator(device=device).manual_seed(0), randn=randn.to(device))
        return float(m["loss"]), {n: p.grad.cpu() for n, p in model.named_parameters()}

    loss, grads = first_step("cuda")
    _, cpu_grads = first_step("cpu")
    want = float(smoothed_loss(f["S"], torch.as_tensor(z["log_probs_rand"]), f["mask"] * f["chain_M"]))
    assert abs(loss - want) <= 2e-4 * want, (loss, want)
    for name, ref in cpu_grads.items():
        assert float((grads[name] - ref).abs().max()) <= 1e-4 * float(ref.abs().max()), name
