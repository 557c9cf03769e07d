"""The bf16 edge-embedder backward's decomposition
(``csrc/edge_embedder_bwd.cu``, ``fdk_edge_embedder_bwd_split`` with dtype
bf16), emulated in torch on the CPU, and its chunk planner.

The emulation (``emulate_split_bwd`` on bf16 inputs) takes the kernels'
steps in their order and rounds where they round (the JAX kernel's rounding
points, edge_embedder.py:433-530): per chunk of grid rows
(``plan_bwd_chunks``), kernel A's bf16 recompute (m, y0, y1 rounded as the
forward), its float32 LayerNorm backward (dem, dx; d_b2 from the unrounded
dx), dxd = bf16(dx), dy1 = bf16(dxd W2^T) then the relu mask, dy0 likewise,
dm = dy0 W_rel^T in float32; the tiles' vector partials (d_b1 and d_w_dist
from the bf16 dy1 and dy0 summed in float32); the row and column sums in
index order (dm * H_j and dm * G_i with G, H widened); kernel B's weight
gradients as split-K sums of bf16 operands (``split_k_bf16``, the 64-row
d_w_rel job included); then the partials summed in order, chunk after chunk.
It is held against the JAX backward kernel in bf16 (interpret mode) and the
port's plain backward in bf16, every gradient within 5e-2 of its own
max-abs, with 22 and 0 distance bins, with the planner forced to 5 chunks.
The kernels themselves are held against the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 3).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from framedipt_tpu.model.pallas import edge_embedder as j_emb

from framedipt_tpu_torch.model.kernels import edge_embedder as t_emb

from tests.test_torch_cuda import emb_args, emb_to_torch
from tests.test_torch_edge_embedder_bwd import NAMES, _jax_args, _without_coords
from tests.test_torch_edge_embedder_bwd_split import emulate_split_bwd, rows_cap
from tests.test_torch_pair_mlp_bwd_bf16 import assert_within_max_abs
from tests.torch_threads import one_torch_thread  # noqa: F401


F32, BF16 = torch.float32, torch.bfloat16
C, CP = t_emb.C, t_emb.CP
TOL = 5e-2


def bf16_case(seed, B, N, n_bins):
    """numpy inputs at the kernels' widths (the last rows masked), their bf16
    tensors, the bin edges and a bf16 cotangent."""
    rng = np.random.default_rng(seed)
    args, bins = emb_args(rng, B, N, C, n_bins)
    grad = torch.as_tensor(rng.normal(size=(B, N, N, C)).astype(np.float32)).to(BF16)
    return args, emb_to_torch(args, BF16), bins, grad


@pytest.mark.parametrize("n_bins", [22, 0])
def test_bf16_decomposition_matches_jax_and_plain_backward(n_bins):
    """B=2 N=20 at the kernels' widths (800 pairs: tiles of 64 pairs cross
    grid rows and chunk ends), the last rows masked, in 5 chunks of 8 grid
    rows (a chunk crosses the batch boundary): every gradient against the
    JAX backward kernel in bf16, interpret mode, and against
    edge_embedder_bwd_plain in bf16."""
    B, N = 2, 20
    args, targs, bins, grad = bf16_case(51 + n_bins, B, N, n_bins)
    chunks, got = emulate_split_bwd(grad, *targs, bins, cap=rows_cap(8, N, n_bins, BF16))
    assert chunks == [(0, 8), (8, 16), (16, 24), (24, 32), (32, 40)]
    assert all(a is None or torch.isfinite(a).all() for a in got)
    assert_within_max_abs(got, t_emb.edge_embedder_bwd_plain(
        grad, *targs, bins_lower=bins[0], bins_upper=bins[1]), TOL, NAMES)
    assert (got[6][:, -3:] != 0).all() and (got[7][:, -3:] != 0).all()  # masked rows
    if n_bins:
        assert (got[9] != 0).any()
    j_args, j_bins = _jax_args(args, jnp.bfloat16), bins
    if not n_bins:
        # The JAX kernel takes no zero-row block: one bin that no distance
        # falls in is the same function.
        j_args[9] = jnp.zeros((1, C), jnp.bfloat16)
        j_bins = ((1e30,), (-1e30,))
    with pltpu.force_tpu_interpret_mode():
        want = list(j_emb.fused_edge_embedder_bwd(
            jnp.asarray(grad.float().numpy(), jnp.bfloat16), *j_args,
            bins_lower=j_bins[0], bins_upper=j_bins[1], tile_i=8, tile_j=16))
    if not n_bins:
        want[9] = want[9][:0]
    assert_within_max_abs(got, _without_coords(want), TOL, NAMES)


def test_dm_stays_float32():
    """dm = dy0 W_rel^T is float32 in the JAX kernel (no rounding after the
    product): the emulation's d_g and d_h, cast to bf16, are the plain
    backward's bits but where the order of their float32 sums rounds
    otherwise (under 1% of the elements; 0 here), and with dm rounded to
    bf16 first over 10% of them move."""
    _, targs, bins, grad = bf16_case(57, 1, 12, 22)
    want = t_emb.edge_embedder_bwd_plain(grad, *targs, bins_lower=bins[0], bins_upper=bins[1])
    _, got = emulate_split_bwd(grad, *targs, bins)
    _, rounded = emulate_split_bwd(grad, *targs, bins, round_dm=True)
    for i in (0, 1):  # d_g, d_h
        n = want[i].numel()
        kept = int((got[i].to(BF16) != want[i]).sum())
        moved = int((rounded[i].to(BF16) != want[i]).sum())
        assert kept <= 0.01 * n and moved >= 0.1 * n, (NAMES[i], kept, moved, n)


def float32_workspace_floats(pairs: int, n_bins: int) -> int:
    """The float32 workspace as it was before bf16 took the chunked route."""
    groups = -(-(-(-pairs // 64)) // 32)
    return pairs * (5 * C + 2 * CP + 1) + 44 * (CP * C + 2 * C * C) + groups * 33 * (4 + n_bins) * C


@pytest.mark.parametrize("N", [256, 512, 768])
def test_bf16_chunk_planner_stays_under_the_cap(N):
    """bf16 chunks tile the grid under the 1 GiB cap, the training shape in
    one chunk (0.25 GB: 417 floats a pair against float32's 769); float32's
    workspace and plan do not move."""
    B = 2
    for n_bins in (22, 0, t_emb.MAX_BINS):
        chunks = t_emb.plan_bwd_chunks(B, N, N, n_bins, dtype=BF16)
        assert chunks[0][0] == 0 and chunks[-1][1] == B * N
        assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
        sizes = [m1 - m0 for m0, m1 in chunks]
        assert set(sizes[:-1]) <= {sizes[0]} and 0 < sizes[-1] <= sizes[0]
        assert max(4 * t_emb.split_workspace_floats(s * N, n_bins, BF16) for s in sizes) <= 1 << 30
        if len(chunks) > 1:  # the fewest chunks: one chunk fewer would break the cap
            fewer = -(-B * N // (len(chunks) - 1))
            assert 4 * t_emb.split_workspace_floats(fewer * N, n_bins, BF16) > 1 << 30
        for pairs in (0, 1, 63, 64, 65, N * N, B * N * N):
            assert t_emb.split_workspace_floats(pairs, n_bins) == float32_workspace_floats(
                pairs, n_bins)
        assert t_emb.plan_bwd_chunks(B, N, N, n_bins, dtype=F32) == t_emb.plan_bwd_chunks(
            B, N, N, n_bins)
        assert len(chunks) <= len(t_emb.plan_bwd_chunks(B, N, N, n_bins))
    if N == 256:
        assert t_emb.plan_bwd_chunks(B, N, N, 22, dtype=BF16) == [(0, B * N)]
        assert 0.24e9 < 4 * t_emb.split_workspace_floats(B * N * N, 22, BF16) < 0.26e9
    assert t_emb.SPLIT_PAIR_FLOATS[BF16] == 417 and t_emb.SPLIT_PAIR_FLOATS[F32] == 769
