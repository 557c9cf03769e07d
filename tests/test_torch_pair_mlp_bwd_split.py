"""The float32 pair-MLP backward's decomposition (``csrc/pair_mlp_bwd_wg.cu``,
``fdk_pair_mlp_bwd_wg``; the split's rest in ``csrc/pair_mlp_split.cuh``),
emulated in torch on the CPU, and its chunk planner.

The emulation takes the kernels' steps in their order: per chunk of grid
rows (``plan_bwd_chunks``), kernel A's per-pair activations and gradients
(y0, y1, dx, dy1, dy0, dem; its products as float32 products here, their
3xTF32 arithmetic is ``tests/test_torch_pair_mlp_tc.py``'s) and its
per-tile vector partials (d_b1 | d_bf | d_ln_scale | d_ln_bias, each tile's
rows summed in the kernel's order), the
row and column sums in index order, kernel B's weight gradients as split-K
sums (``SPLIT_SLICES`` slices, each a chain of 32-pair steps, each step's
pairs in the wgmma kernel's k order, three TF32 products per 8 of them
summed into a zeroed fragment and added with one float32 rounding), then the slice partials and the tile partials summed in
order and added chunk after chunk. It is held against the JAX backward
kernel (interpret mode) and the port's plain backward at 1e-4 (every
gradient as |got - want| <= tol * max(1, max|want|)), with the planner
forced to several chunks. The kernels themselves are held against the plain
version on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase
3).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from framedipt_tpu.model.pallas import pair_mlp as j_pair

from framedipt_tpu_torch.model.kernels import pair_mlp as t_pair
from framedipt_tpu_torch.model.layers import matmul_f32

from tests.test_torch_cuda import assert_grads_close, pair_args, pair_to_torch
from tests.test_torch_pair_mlp_tc import split
from tests.torch_threads import one_torch_thread  # noqa: F401

F32 = torch.float32
NAMES = ("d_pair", "d_i_term", "d_j_term", "d_row_mask", "d_col_mask", "d_w0", "d_b0",
         "d_w1", "d_b1", "d_wf", "d_bf", "d_ln_scale", "d_ln_bias", "d_fi", "d_fj", "d_wfe")
WARPS = 8  # kernel A's warps; each takes SPLIT_TILE / WARPS rows of the LayerNorm backward
# The pair of a step at each k position 4 c + r of float32 kernel B's tiles
# (csrc/wgrad_wg.cuh's step_pair).
KERNEL_B_ORDER = tuple(8 * r + (c ^ (2 * r)) for c in range(8) for r in range(4))


def in_order(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` one element after another, in float32."""
    x = x.movedim(dim, 0)
    s = torch.zeros_like(x[0])
    for v in x:
        s = s + v
    return s


def mma_k8(acc, a, b):
    return (acc.double() + a.double() @ b.double()).float()


def split_k(a: torch.Tensor, b: torch.Tensor, slices: int = t_pair.SPLIT_SLICES,
            order=KERNEL_B_ORDER) -> torch.Tensor:
    """a^T b over the rows of a chunk, as float32 kernel B
    (``csrc/wgrad_wg.cuh``) sums it: ``slices`` slices of whole 32-row steps
    (zero rows past the chunk), each step's rows taken in ``order`` (the
    kernel's k positions, KERNEL_B_ORDER; ``range(32)``: the rows' own
    order), 3xTF32 per 8 positions into a zeroed step sum, the step sums
    added in order; then the slices added in order."""
    P = a.shape[0]
    k_slice = -(-(-(-P // slices)) // 32) * 32
    pad = slices * k_slice - P
    a = torch.cat([a, a.new_zeros(pad, a.shape[1])]).view(slices, -1, 32, a.shape[1])
    b = torch.cat([b, b.new_zeros(pad, b.shape[1])]).view(slices, -1, 32, b.shape[1])
    a, b = a[:, :, list(order)], b[:, :, list(order)]
    acc = a.new_zeros(slices, a.shape[-1], b.shape[-1])
    for step in range(a.shape[1]):
        part = torch.zeros_like(acc)
        for k in range(0, 32, 8):
            at = a[:, step, k:k + 8].transpose(1, 2)
            a_hi, a_lo = split(at.contiguous())
            b_hi, b_lo = split(b[:, step, k:k + 8].contiguous())
            part = mma_k8(part, a_lo, b_hi)
            part = mma_k8(part, a_hi, b_lo)
            part = mma_k8(part, a_hi, b_hi)
        acc = acc + part
    return in_order(acc, 0)


def tile_partials(per_pair: torch.Tensor, rows_then_warps: bool) -> torch.Tensor:
    """Sums of [P, C] per SPLIT_TILE-pair tile (zero past the chunk), then
    per SPLIT_GROUP tiles, then over the groups, in order. Kernel A sums
    d_b1 over a tile's rows in order and the LayerNorm sums per warp over
    its rows, then over the warps."""
    P, C = per_pair.shape
    tiles = -(-P // t_pair.SPLIT_TILE)
    groups = -(-tiles // t_pair.SPLIT_GROUP)
    x = torch.cat([per_pair, per_pair.new_zeros(groups * t_pair.SPLIT_GROUP * t_pair.SPLIT_TILE - P, C)])
    x = x.view(groups * t_pair.SPLIT_GROUP, t_pair.SPLIT_TILE, C)
    if rows_then_warps:
        tile = in_order(in_order(x.view(x.shape[0], WARPS, -1, C), 2), 1)
    else:
        tile = in_order(x, 1)
    return in_order(in_order(tile.view(groups, t_pair.SPLIT_GROUP, C), 1), 0)


def kernel_a_float32(g, pair, i_term, j_term, row_mask, col_mask, w0, b0, w1, b1, wf, bf,
                     ln_scale, ln_bias, fi=None, fj=None, wfe=None, matmul=matmul_f32):
    """Kernel A's per-pair results (their rows do not depend on the chunk):
    y0, y1, dx, dy1, dy0, dem, d_pair, and the LayerNorm sums' terms g em
    xhat ("lns") and g em ("lnb"). ``matmul(a, w)``: its products, float32
    products here (a kernel's arithmetic may be emulated in their place)."""
    # The recompute, in the kernels' addition order (t_pair._pre_norm's).
    y0 = torch.relu(matmul(pair, w0) + i_term[:, :, None, :] + j_term[:, None, :, :] + b0)
    y1 = torch.relu(matmul(y0, w1) + b1)
    out = matmul(y1, wf)
    if wfe is not None:
        out = out + matmul(pair, wfe)
        out = out + fi[:, :, None, :] + fj[:, None, :, :]
    out = out + bf
    mean = out.mean(dim=-1, keepdim=True)
    xc = out - mean
    inv = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + 1e-6)
    xhat = xc * inv
    emask = (row_mask[:, :, None] * col_mask[:, None, :])[..., None]
    dem = torch.sum((xhat * ln_scale + ln_bias) * g, dim=-1)
    gm = g * emask
    dxhat = gm * ln_scale
    dx = (dxhat - dxhat.mean(-1, keepdim=True) - xhat * (dxhat * xhat).mean(-1, keepdim=True)) * inv
    dy1 = matmul(dx, wf.t()) * (y1 > 0)
    dy0 = matmul(dy1, w1.t()) * (y0 > 0)
    d_pair = matmul(dy0, w0.t())
    if wfe is not None:
        d_pair = d_pair + matmul(dx, wfe.t())
    return {"y0": y0, "y1": y1, "dx": dx, "dy1": dy1, "dy0": dy0, "dem": dem,
            "d_pair": d_pair, "lns": gm * xhat, "lnb": gm}


def emulate_split_bwd(g, pair, i_term, j_term, row_mask, col_mask, w0, b0, w1, b1, wf, bf,
                      ln_scale, ln_bias, fi=None, fj=None, wfe=None, cap=t_pair.BWD_WORKSPACE_CAP,
                      matmul=matmul_f32, order=KERNEL_B_ORDER):
    """The float32 kernels' decomposition; returns (chunks, the 16 gradients).
    ``matmul``: kernel A's products (:func:`kernel_a_float32`); ``order``:
    kernel B's order of a step's pairs (:func:`split_k`)."""
    B, Nr, Nc, _ = pair.shape
    residual = wfe is not None
    a = kernel_a_float32(g, pair, i_term, j_term, row_mask, col_mask, w0, b0, w1, b1, wf, bf,
                         ln_scale, ln_bias, fi, fj, wfe, matmul)
    d_pair, dem = a["d_pair"], a["dem"]

    flat = {n: a[n].reshape(B * Nr * Nc, -1) for n in ("y0", "y1", "dx", "dy1", "dy0", "lns",
                                                        "lnb")}
    flat["pair"] = pair.reshape(B * Nr * Nc, -1)
    dem_f = dem.reshape(-1)
    rmask, cmask = row_mask.reshape(-1), col_mask.reshape(-1)
    prods = {"w0": ("pair", "dy0"), "w1": ("y0", "dy1"), "wf": ("y1", "dx")}
    if residual:
        prods["wfe"] = ("pair", "dx")
    grads = {n: torch.zeros(s) for n, s in t_pair._W_PARTS}
    rows = torch.zeros(B * Nr, t_pair.ROW_PART)
    cols = torch.zeros(B * Nc, t_pair.ROW_PART)
    chunks = t_pair.plan_bwd_chunks(B, Nr, Nc, cap)
    for m0, m1 in chunks:
        q = slice(m0 * Nc, m1 * Nc)
        # Row sums (a row lies in one chunk) and column sums, in index order.
        per_pair = torch.cat([flat["dy0"][q], flat["dx"][q], torch.zeros(m1 * Nc - m0 * Nc, 1)], 1)
        m_of = torch.arange(m0 * Nc, m1 * Nc) // Nc
        j_of = torch.arange(m0 * Nc, m1 * Nc) % Nc
        b_of = m_of // Nr
        per_row = per_pair.clone()
        per_row[:, -1] = dem_f[q] * cmask[b_of * Nc + j_of]
        rows[m0:m1] = in_order(per_row.view(m1 - m0, Nc, -1), 1)
        per_col = per_pair.clone()
        per_col[:, -1] = dem_f[q] * rmask[m_of]
        for b in range(m0 // Nr, (m1 - 1) // Nr + 1):
            lo, hi = max(m0, b * Nr), min(m1, (b + 1) * Nr)
            part = per_col[(lo - m0) * Nc:(hi - m0) * Nc].view(hi - lo, Nc, -1)
            cols[b * Nc:(b + 1) * Nc] += in_order(part, 0)
        # Kernel B, then the tiles' vector partials.
        for name, (a, b_) in prods.items():
            grads[name] += split_k(flat[a][q], flat[b_][q], order=order)
        grads["b1"] += tile_partials(flat["dy1"][q], rows_then_warps=False)
        for name, key in (("bf", "dx"), ("ln_scale", "lns"), ("ln_bias", "lnb")):
            grads[name] += tile_partials(flat[key][q], rows_then_warps=True)

    rows, cols = rows.view(B, Nr, -1), cols.view(B, Nc, -1)
    H = t_pair.HIDDEN
    d_b0 = torch.sum(rows[..., :H], dim=(0, 1))
    opt = (lambda v: v) if residual else (lambda v: None)
    return chunks, (d_pair, rows[..., :H], cols[..., :H], rows[..., -1], cols[..., -1],
                    grads["w0"], d_b0, grads["w1"], grads["b1"], grads["wf"], grads["bf"],
                    grads["ln_scale"], grads["ln_bias"], opt(rows[..., H:-1]),
                    opt(cols[..., H:-1]), opt(grads["wfe"]))


def rows_cap(rows: int, Nc: int, dtype: torch.dtype = F32) -> int:
    """A workspace cap that holds ``rows`` grid rows of Nc pairs."""
    return 4 * t_pair.split_workspace_floats(rows * Nc, dtype)


@pytest.mark.parametrize("residual", [True, False])
def test_split_decomposition_matches_jax_and_plain_backward(residual):
    """B=2 N=20 at the kernels' widths, the last rows masked, in 5 chunks of
    8 grid rows (a chunk crosses the batch boundary): all 16 gradients
    against the JAX backward kernel in interpret mode and against
    pair_mlp_bwd_plain."""
    B, N = 2, 20
    rng = np.random.default_rng(91)
    args = pair_to_torch(pair_args(rng, B, N, 128, 384, 128, residual), F32)
    g = torch.as_tensor(rng.normal(size=(B, N, N, 128)).astype(np.float32))
    chunks, got = emulate_split_bwd(g, *args, cap=rows_cap(8, N))
    assert chunks == [(0, 8), (8, 16), (16, 24), (24, 32), (32, 40)]
    assert_grads_close(got, t_pair.pair_mlp_bwd_plain(g, *args), 1e-4, NAMES)
    ja = [None if x is None else jnp.asarray(x) for x in pair_args(np.random.default_rng(91), B, N,
                                                                   128, 384, 128, residual)]
    with pltpu.force_tpu_interpret_mode():
        want = j_pair.fused_pair_mlp_bwd(jnp.asarray(g.numpy()), *ja, tile_i=8, tile_j=16)
    assert_grads_close(got, want, 1e-4, NAMES)
    assert (got[3][:, -3:] != 0).any()  # mask gradients where the mask is 0


def test_one_chunk_and_many_chunks_agree():
    """The same inputs in one chunk and in one grid row a chunk (B=1 N=9):
    the chunked sums are the same gradients up to float32 reordering."""
    rng = np.random.default_rng(92)
    args = pair_to_torch(pair_args(rng, 1, 9, 128, 384, 128, True), F32)
    g = torch.as_tensor(rng.normal(size=(1, 9, 9, 128)).astype(np.float32))
    one_chunks, one = emulate_split_bwd(g, *args)
    many_chunks, many = emulate_split_bwd(g, *args, cap=1)
    assert one_chunks == [(0, 9)]
    assert many_chunks == [(m, m + 1) for m in range(9)]
    assert_grads_close(many, one, 1e-5, NAMES)


@pytest.mark.parametrize("N", [256, 512, 768])
def test_chunk_planner_stays_under_the_cap_and_tiles_the_grid(N):
    B = 2
    chunks = t_pair.plan_bwd_chunks(B, N, N)
    assert chunks[0][0] == 0 and chunks[-1][1] == B * N
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
    assert all(m1 > m0 for m0, m1 in chunks)
    sizes = [m1 - m0 for m0, m1 in chunks]
    assert max(sizes) - min(sizes) <= 1
    assert max(4 * t_pair.split_workspace_floats(s * N) for s in sizes) <= 1 << 30
    if N == 256:  # the training shape runs in one chunk (0.89 GB)
        assert chunks == [(0, B * N)]
        assert 0.85e9 < 4 * t_pair.split_workspace_floats(B * N * N) < 0.9e9
    else:  # the fewest chunks: one chunk fewer would break the cap
        fewer = -(-B * N // (len(chunks) - 1))
        assert 4 * t_pair.split_workspace_floats(fewer * N) > 1 << 30


def test_chunk_planner_edges():
    assert t_pair.plan_bwd_chunks(0, 5, 5) == []
    assert t_pair.plan_bwd_chunks(1, 1, 1) == [(0, 1)]
    assert t_pair.plan_bwd_chunks(2, 3, 4, cap_bytes=1) == [(m, m + 1) for m in range(6)]
    assert t_pair.plan_bwd_chunks(2, 10, 7, cap_bytes=rows_cap(6, 7)) == [
        (0, 5), (5, 10), (10, 15), (15, 20)]
