"""The float32 edge-embedder backward's decomposition
(``csrc/edge_embedder_bwd.cu``, ``fdk_edge_embedder_bwd_split``), emulated in
torch on the CPU, and its chunk planner (bf16: ``emulate_split_bwd`` on bf16
inputs, ``tests/test_torch_edge_embedder_bwd_bf16.py``).

The emulation takes the kernels' steps in their order: per chunk of grid
rows (``plan_bwd_chunks``), kernel A's per-pair workspace (m, y0, y1, dx,
dy1, dy0, dm, dem; its products as float32 products here, their 3xTF32
arithmetic is ``tests/test_torch_edge_embedder_tc.py``'s) and its per-tile
vector partials (d_b1 and d_w_dist over a tile's rows in order, d_b2 |
d_ln_scale | d_ln_bias per warp over its rows, then over the warps), the row
and column sums in index order (d_g from dm * H_j, d_h from dm * G_i, each
product rounded), kernel B's weight gradients as split-K sums
(``SPLIT_SLICES`` slices of 32-pair steps, each step's pairs in the wgmma
kernel's k order, three TF32 products per 8 of them summed into a zeroed
fragment, as ``tests/test_torch_pair_mlp_bwd_split.py`` emulates it), then the slice partials and the tile partials summed in order
and added chunk after chunk. It is held against the JAX backward kernel
(interpret mode) and the port's plain backward at 1e-4 (every gradient as
|got - want| <= tol * max(1, max|want|)), with and without distance bins, at
a ragged N whose 64-pair tiles run past the grid's rows and the chunks'
ends, with the planner forced to several chunks. The kernels themselves are
held against the plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 3).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from framedipt_tpu.model.pallas import edge_embedder as j_emb

from framedipt_tpu_torch.model.kernels import edge_embedder as t_emb
from framedipt_tpu_torch.model.layers import matmul_f32

from tests.test_torch_cuda import assert_grads_close, emb_args, emb_to_torch
from tests.test_torch_edge_embedder_bwd import NAMES, _jax_args, _without_coords
from tests.test_torch_pair_mlp_bwd_bf16 import split_k_bf16
from tests.test_torch_pair_mlp_bwd_split import KERNEL_B_ORDER, in_order, split_k, tile_partials
from tests.torch_threads import one_torch_thread  # noqa: F401

F32, BF16 = torch.float32, torch.bfloat16
C, CP = t_emb.C, t_emb.CP


def emulate_split_bwd(grad, g, h, pos_rows, pos_cols, i_term, j_term, row_mask, col_mask,
                      w_rel, w_dist, b0, w1, b1, w2, b2, ln_scale, ln_bias, bins,
                      cap=t_emb.BWD_WORKSPACE_CAP, round_dm=False, order=KERNEL_B_ORDER):
    """The kernels' decomposition in g's dtype; returns (chunks, the
    gradients in float32, in edge_embedder_bwd's order). bf16 rounds where
    the JAX kernel rounds: the recompute as the forward, dxd = bf16(dx)
    (d_b2 sums dx unrounded), dy1 and dy0 before their relu masks; dm stays
    float32 (``round_dm``: rounded to bf16 instead, to show that the
    rounding point matters); kernel B's products are bf16 MMA. ``order``:
    float32 kernel B's order of a step's pairs (``split_k``)."""
    B, Nr, Nc, _ = grad.shape
    n_bins = len(bins[0])
    dtype = g.dtype
    # Kernel A, per pair (its rows do not depend on the chunk).
    m, onehot, y0, y1, out = t_emb._pre_norm(g, h, pos_rows, pos_cols, i_term, j_term, w_rel,
                                             w_dist, b0, w1, b1, w2, b2, *bins)
    out = out.float()
    mean = out.mean(dim=-1, keepdim=True)
    xc = out - mean
    inv = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + 1e-6)
    xhat = xc * inv
    grad = grad.float()
    emask = (row_mask[:, :, None] * col_mask[:, None, :]).float()[..., None]
    dem = torch.sum((xhat * ln_scale + ln_bias) * grad, dim=-1)
    gm = grad * emask
    dxhat = gm * ln_scale
    dx = (dxhat - dxhat.mean(-1, keepdim=True) - xhat * (dxhat * xhat).mean(-1, keepdim=True)) * inv
    dxd = dx.to(dtype)
    dy1 = matmul_f32(dxd, w2.t()) * (y1 > 0).to(dtype)
    dy0 = matmul_f32(dy1, w1.t()) * (y0 > 0).to(dtype)
    dm = torch.matmul(dy0.float(), w_rel.float().t())
    if round_dm:
        dm = dm.to(dtype).float()

    P_all = B * Nr * Nc
    flat = {n: v.reshape(P_all, -1) for n, v in
            (("m", m), ("y0", y0), ("y1", y1), ("dx", dx), ("dxd", dxd), ("dy1", dy1),
             ("dy0", dy0), ("dm", dm), ("lns", gm * xhat), ("lnb", gm))}
    # Each pair adds dy0 to its bin's row of d_w_dist (a zero row elsewhere).
    flat["wdist"] = (onehot.float()[..., :, None] * dy0.float()[..., None, :]).reshape(
        P_all, n_bins * C)
    dem_f = dem.reshape(-1)
    b_of = torch.arange(P_all) // (Nr * Nc)
    m_of = torch.arange(P_all) // Nc  # flat grid row b * Nr + i
    col_of = b_of * Nc + torch.arange(P_all) % Nc  # flat column b * Nc + j
    g_f, h_f = g.reshape(B * Nr, CP).float(), h.reshape(B * Nc, CP).float()
    per_row = torch.cat([flat["dm"] * h_f[col_of], flat["dy0"].float(),
                         (dem_f * col_mask.reshape(-1).float()[col_of])[:, None]], 1)
    per_col = torch.cat([flat["dm"] * g_f[m_of], flat["dy0"].float(),
                         (dem_f * row_mask.reshape(-1).float()[m_of])[:, None]], 1)
    jobs = {"w_rel": ("m", "dy0"), "w1": ("y0", "dy1"), "w2": ("y1", "dxd")}
    grads = {n: torch.zeros(s) for n, s in t_emb._W_PARTS}
    rows = torch.zeros(B * Nr, t_emb.ROW_PART)
    cols = torch.zeros(B * Nc, t_emb.ROW_PART)
    chunks = t_emb.plan_bwd_chunks(B, Nr, Nc, n_bins, cap, dtype)
    for m0, m1 in chunks:
        q = slice(m0 * Nc, m1 * Nc)
        # Row sums (a row lies in one chunk) and column sums, in index order.
        rows[m0:m1] = in_order(per_row[q].view(m1 - m0, Nc, -1), 1)
        for b in range(m0 // Nr, (m1 - 1) // Nr + 1):
            lo, hi = max(m0, b * Nr), min(m1, (b + 1) * Nr)
            part = per_col[lo * Nc:hi * Nc].view(hi - lo, Nc, -1)
            cols[b * Nc:(b + 1) * Nc] += in_order(part, 0)
        # Kernel B, then the tiles' vector partials.
        for name, (a, b_) in jobs.items():
            if dtype == BF16:
                grads[name] += split_k_bf16(flat[a][q], flat[b_][q], t_emb.SPLIT_SLICES)
            else:
                grads[name] += split_k(flat[a][q], flat[b_][q], t_emb.SPLIT_SLICES, order)
        grads["b1"] += tile_partials(flat["dy1"][q].float(), rows_then_warps=False)
        if n_bins:
            grads["w_dist"][:n_bins] += tile_partials(flat["wdist"][q],
                                                      rows_then_warps=False).view(n_bins, C)
        for name, key in (("b2", "dx"), ("ln_scale", "lns"), ("ln_bias", "lnb")):
            grads[name] += tile_partials(flat[key][q], rows_then_warps=True)

    rows, cols = rows.view(B, Nr, -1), cols.view(B, Nc, -1)
    d_b0 = torch.sum(rows[..., CP:-1], dim=(0, 1))
    return chunks, (rows[..., :CP], cols[..., :CP], None, None, rows[..., CP:-1],
                    cols[..., CP:-1], rows[..., -1], cols[..., -1], grads["w_rel"],
                    grads["w_dist"][:n_bins], d_b0, grads["w1"], grads["b1"], grads["w2"],
                    grads["b2"], grads["ln_scale"], grads["ln_bias"])


def rows_cap(rows: int, Nc: int, n_bins: int, dtype=F32) -> int:
    """A workspace cap that holds ``rows`` grid rows of Nc pairs."""
    return 4 * t_emb.split_workspace_floats(rows * Nc, n_bins, dtype)


@pytest.mark.parametrize("n_bins", [22, 0])
def test_split_decomposition_matches_jax_and_plain_backward(n_bins):
    """B=2 N=20 at the kernels' widths (800 pairs: tiles of 64 pairs cross
    grid rows and chunk ends), the last rows masked, in 5 chunks of 8 grid
    rows (a chunk crosses the batch boundary): every gradient against the
    JAX backward kernel in interpret mode and against
    edge_embedder_bwd_plain."""
    B, N = 2, 20
    rng = np.random.default_rng(41 + n_bins)
    args, bins = emb_args(rng, B, N, C, n_bins)
    grad = rng.normal(size=(B, N, N, C)).astype(np.float32)
    targs = emb_to_torch(args, F32)
    chunks, got = emulate_split_bwd(torch.as_tensor(grad), *targs, bins,
                                    cap=rows_cap(8, N, n_bins))
    assert chunks == [(0, 8), (8, 16), (16, 24), (24, 32), (32, 40)]
    assert_grads_close(got, t_emb.edge_embedder_bwd_plain(
        torch.as_tensor(grad), *targs, bins_lower=bins[0], bins_upper=bins[1]), 1e-4, NAMES)
    j_args, j_bins = _jax_args(args, jnp.float32), bins
    if not n_bins:
        # The JAX kernel takes no zero-row block: one bin that no distance
        # falls in is the same function.
        j_args[9] = jnp.zeros((1, C), jnp.float32)
        j_bins = ((1e30,), (-1e30,))
    with pltpu.force_tpu_interpret_mode():
        want = list(j_emb.fused_edge_embedder_bwd(jnp.asarray(grad), *j_args,
                                                  bins_lower=j_bins[0], bins_upper=j_bins[1],
                                                  tile_i=8, tile_j=16))
    if not n_bins:
        want[9] = want[9][:0]
    assert_grads_close(got, _without_coords(want), 1e-4, NAMES)
    assert (got[6][:, -3:] != 0).all() and (got[7][:, -3:] != 0).all()  # masked rows
    if n_bins:
        assert (got[9] != 0).any()


def test_one_chunk_and_many_chunks_agree():
    """The same inputs in one chunk and in one grid row a chunk (B=1 N=9):
    the chunked sums are the same gradients up to float32 reordering."""
    rng = np.random.default_rng(43)
    args, bins = emb_args(rng, 1, 9, C, 22)
    grad = torch.as_tensor(rng.normal(size=(1, 9, 9, C)).astype(np.float32))
    targs = emb_to_torch(args, F32)
    one_chunks, one = emulate_split_bwd(grad, *targs, bins)
    many_chunks, many = emulate_split_bwd(grad, *targs, bins, cap=1)
    assert one_chunks == [(0, 9)]
    assert many_chunks == [(m, m + 1) for m in range(9)]
    assert_grads_close(many, one, 1e-5, NAMES)


@pytest.mark.parametrize("B,N", [(2, 256), (1, 512), (1, 768), (2, 768)])
def test_chunk_planner_stays_under_the_cap_and_tiles_the_grid(B, N):
    for n_bins in (22, 0, t_emb.MAX_BINS):
        chunks = t_emb.plan_bwd_chunks(B, N, N, n_bins)
        assert chunks[0][0] == 0 and chunks[-1][1] == B * N
        assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
        sizes = [m1 - m0 for m0, m1 in chunks]
        assert set(sizes[:-1]) <= {sizes[0]} and 0 < sizes[-1] <= sizes[0]
        assert max(4 * t_emb.split_workspace_floats(s * N, n_bins) for s in sizes) <= 1 << 30
        if len(chunks) == 1:
            continue
        # The fewest chunks: one chunk fewer would break the cap.
        fewer = -(-B * N // (len(chunks) - 1))
        assert 4 * t_emb.split_workspace_floats(fewer * N, n_bins) > 1 << 30
    # The training shape runs in one chunk (0.44 GB); B=1 N=768 needs two.
    assert t_emb.plan_bwd_chunks(2, 256, 256, 22) == [(0, 512)]
    assert 0.43e9 < 4 * t_emb.split_workspace_floats(2 * 256 * 256, 22) < 0.45e9
    assert len(t_emb.plan_bwd_chunks(1, 768, 768, 22)) == 2


def test_chunk_planner_edges():
    assert t_emb.plan_bwd_chunks(0, 5, 5, 22) == []
    assert t_emb.plan_bwd_chunks(1, 1, 1, 22) == [(0, 1)]
    assert t_emb.plan_bwd_chunks(2, 3, 4, 0, cap_bytes=1) == [(m, m + 1) for m in range(6)]
    assert t_emb.plan_bwd_chunks(2, 10, 7, 22, cap_bytes=rows_cap(6, 7, 22)) == [
        (0, 5), (5, 10), (10, 15), (15, 20)]
