"""The bf16 pair-MLP backward's decomposition (``csrc/pair_mlp_bwd.cu``,
``fdk_pair_mlp_bwd_split`` with dtype bf16), emulated in torch on the CPU,
and its chunk planner.

The emulation takes the kernels' steps in their order and rounds where they
round (the JAX kernel's rounding points, pair_mlp.py:483-516): per chunk of
grid rows (``plan_bwd_chunks``), kernel A's bf16 recompute (y0, y1) and its
float32 dx and dem, dxd = bf16(dx), dy1 = bf16(dxd Wf^T) then the relu mask,
dy0 likewise, d_pair = bf16(bf16(dy0 W0^T) + bf16(dxd Wfe^T)); the tiles'
vector partials (d_b1 from the bf16 dy1, d_bf from the float32 dx); the row
and column sums in index order (dy0's bf16 values and dx in float32); kernel
B's weight gradients as split-K sums of bf16 operands (``SPLIT_SLICES``
slices, each a chain of 64-pair steps, each step four 16-deep bf16 products
summed exactly and rounded once to float32 into a zeroed accumulator, added
to the slice's sum); then the partials summed in order, chunk after chunk. It
is held against the JAX backward kernel in bf16 (interpret mode) and the
port's plain backward in bf16, every gradient within 5e-2 of its own
max-abs, residual and not, with the planner forced to 5 chunks. The kernels
themselves are held against the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 3).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from framedipt_tpu.model.pallas import pair_mlp as j_pair

from framedipt_tpu_torch.model.kernels import pair_mlp as t_pair
from framedipt_tpu_torch.model.layers import matmul_f32

from tests.test_torch_cuda import pair_args, pair_to_torch
from tests.test_torch_pair_mlp_bwd_split import NAMES, in_order, rows_cap, tile_partials

F32, BF16 = torch.float32, torch.bfloat16
TOL = 5e-2


def split_k_bf16(a: torch.Tensor, b: torch.Tensor, slices: int = t_pair.SPLIT_SLICES) -> torch.Tensor:
    """a^T b over the rows of a chunk (bf16 operands), as the bf16 kernel B
    (csrc/wgrad_bf16.cuh) sums it: ``slices`` slices of whole 64-row steps
    (zero rows past the chunk); per step four 16-deep products, each summed
    exactly and rounded to float32 into the step's zeroed sum; the step sums
    added in order; then the slices added in order."""
    P = a.shape[0]
    k_slice = -(-(-(-P // slices)) // 64) * 64
    pad = slices * k_slice - P
    a = torch.cat([a, a.new_zeros(pad, a.shape[1])]).double().view(slices, -1, 64, a.shape[1])
    b = torch.cat([b, b.new_zeros(pad, b.shape[1])]).double().view(slices, -1, 64, b.shape[1])
    acc = torch.zeros(slices, a.shape[-1], b.shape[-1])
    for step in range(a.shape[1]):
        part = torch.zeros_like(acc)
        for k in range(0, 64, 16):
            part = (part.double() + a[:, step, k:k + 16].transpose(1, 2) @ b[:, step, k:k + 16]).float()
        acc = acc + part
    return in_order(acc, 0)


def emulate_bf16_bwd(g, pair, i_term, j_term, row_mask, col_mask, w0, b0, w1, b1, wf, bf,
                     ln_scale, ln_bias, fi=None, fj=None, wfe=None,
                     cap=t_pair.BWD_WORKSPACE_CAP):
    """The bf16 kernels' decomposition; returns (chunks, the 16 gradients,
    d_pair rounded once)."""
    B, Nr, Nc, _ = pair.shape
    residual = wfe is not None
    # Kernel A, per pair (its rows do not depend on the chunk).
    y0, y1, out = t_pair._pre_norm(pair, i_term, j_term, w0, b0, w1, b1, wf, bf, fi, fj, wfe)
    x = out.float()
    xc = x - x.mean(dim=-1, keepdim=True)
    inv = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + 1e-6)
    xhat = xc * inv
    gf = g.float()
    emask = (row_mask[:, :, None] * col_mask[:, None, :]).float()[..., None]
    dem = torch.sum((xhat * ln_scale + ln_bias) * gf, dim=-1)
    gm = gf * emask
    dxhat = gm * ln_scale
    dx = (dxhat - dxhat.mean(-1, keepdim=True) - xhat * (dxhat * xhat).mean(-1, keepdim=True)) * inv
    dxd = dx.to(BF16)
    dy1 = matmul_f32(dxd, wf.t()) * (y1 > 0).to(BF16)
    dy0 = matmul_f32(dy1, w1.t()) * (y0 > 0).to(BF16)
    d_pair = matmul_f32(dy0, w0.t())
    once = None
    if residual:
        once = (torch.matmul(dy0.float(), w0.t().float())
                + torch.matmul(dxd.float(), wfe.t().float())).to(BF16)
        d_pair = d_pair + matmul_f32(dxd, wfe.t())

    flat = {n: v.reshape(B * Nr * Nc, -1) for n, v in
            (("pair", pair), ("y0", y0), ("y1", y1), ("dx", dx), ("dxd", dxd), ("dy1", dy1),
             ("dy0", dy0), ("lns", gm * xhat), ("lnb", gm))}
    dem_f = dem.reshape(-1)
    rmask, cmask = row_mask.float().reshape(-1), col_mask.float().reshape(-1)
    prods = {"w0": ("pair", "dy0"), "w1": ("y0", "dy1"), "wf": ("y1", "dxd")}
    if residual:
        prods["wfe"] = ("pair", "dxd")
    grads = {n: torch.zeros(s) for n, s in t_pair._W_PARTS}
    rows = torch.zeros(B * Nr, t_pair.ROW_PART)
    cols = torch.zeros(B * Nc, t_pair.ROW_PART)
    chunks = t_pair.plan_bwd_chunks(B, Nr, Nc, cap, BF16)
    for m0, m1 in chunks:
        q = slice(m0 * Nc, m1 * Nc)
        # Row sums (a row lies in one chunk) and column sums, in index order.
        per_pair = torch.cat([flat["dy0"][q].float(), flat["dx"][q], torch.zeros(m1 * Nc - m0 * Nc, 1)], 1)
        m_of = torch.arange(m0 * Nc, m1 * Nc) // Nc
        j_of = torch.arange(m0 * Nc, m1 * Nc) % Nc
        per_row = per_pair.clone()
        per_row[:, -1] = dem_f[q] * cmask[(m_of // Nr) * Nc + j_of]
        rows[m0:m1] = in_order(per_row.view(m1 - m0, Nc, -1), 1)
        per_col = per_pair.clone()
        per_col[:, -1] = dem_f[q] * rmask[m_of]
        for b in range(m0 // Nr, (m1 - 1) // Nr + 1):
            lo, hi = max(m0, b * Nr), min(m1, (b + 1) * Nr)
            part = per_col[(lo - m0) * Nc:(hi - m0) * Nc].view(hi - lo, Nc, -1)
            cols[b * Nc:(b + 1) * Nc] += in_order(part, 0)
        # Kernel B, then the tiles' vector partials.
        for name, (a, b_) in prods.items():
            grads[name] += split_k_bf16(flat[a][q], flat[b_][q])
        grads["b1"] += tile_partials(flat["dy1"][q].float(), rows_then_warps=False)
        for name, key in (("bf", "dx"), ("ln_scale", "lns"), ("ln_bias", "lnb")):
            grads[name] += tile_partials(flat[key][q], rows_then_warps=True)

    rows, cols = rows.view(B, Nr, -1), cols.view(B, Nc, -1)
    H = t_pair.HIDDEN
    d_b0 = torch.sum(rows[..., :H], dim=(0, 1))
    opt = (lambda v: v) if residual else (lambda v: None)

    def cast(v, ref):
        return None if v is None else v.to(ref.dtype)

    return chunks, (
        d_pair, cast(rows[..., :H], i_term), cast(cols[..., :H], j_term),
        cast(rows[..., -1], row_mask), cast(cols[..., -1], col_mask), cast(grads["w0"], w0),
        cast(d_b0, b0), cast(grads["w1"], w1), cast(grads["b1"], b1), cast(grads["wf"], wf),
        cast(grads["bf"], bf), grads["ln_scale"], grads["ln_bias"],
        cast(opt(rows[..., H:-1]), pair), cast(opt(cols[..., H:-1]), pair),
        cast(opt(grads["wfe"]), pair)), once


def assert_within_max_abs(got, want, tol, names):
    """Each gradient within tol of its reference's own max-abs (an empty
    one, as d_w_dist without distance bins, on both sides)."""
    assert len(got) == len(want)
    for name, a, b in zip(names, got, want):
        assert (a is None) == (b is None), name
        if b is None:
            continue
        a = np.asarray(a.float() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32))
        b = np.asarray(b.float() if isinstance(b, torch.Tensor) else np.asarray(b, np.float32))
        assert a.shape == b.shape, (name, a.shape, b.shape)
        err, scale = float(np.abs(a - b).max(initial=0.0)), float(np.abs(b).max(initial=0.0))
        assert err <= tol * scale, f"{name}: max err {err} > {tol} * {scale}"


def bf16_args(residual, seed, B=2, N=20, folded=False):
    """numpy inputs at the kernels' widths; ``folded``: b0 and bf zero (the
    JAX kernel adds b0 to i_term and bf to fi before the grid, which rounds
    otherwise in bf16 and can move a relu decision at a site within an ulp
    of 0; with zero biases both add the same terms in the same order)."""
    args = pair_args(np.random.default_rng(seed), B, N, 128, 384, 128, residual)
    if folded:
        args[6] = np.zeros_like(args[6])
        args[10] = np.zeros_like(args[10])
    return args


@pytest.mark.parametrize("residual", [True, False])
def test_bf16_decomposition_matches_jax_and_plain_backward(residual):
    """B=2 N=20 at the kernels' widths, the last rows masked, in 5 chunks of
    8 grid rows (a chunk crosses the batch boundary): all 16 gradients
    against the JAX backward kernel in bf16, interpret mode (folded biases),
    and against pair_mlp_bwd_plain in bf16."""
    B, N = 2, 20
    for folded in (False, True):
        np_args = bf16_args(residual, 93, B, N, folded)
        args = pair_to_torch(np_args, BF16)
        g = torch.as_tensor(np.random.default_rng(94).normal(size=(B, N, N, 128))
                            .astype(np.float32)).to(BF16)
        chunks, got, _ = emulate_bf16_bwd(g, *args, cap=rows_cap(8, N, BF16))
        assert chunks == [(0, 8), (8, 16), (16, 24), (24, 32), (32, 40)]
        assert all(a is None or torch.isfinite(a.float()).all() for a in got)
        assert_within_max_abs(got, t_pair.pair_mlp_bwd_plain(g, *args), TOL, NAMES)
        assert (got[3][:, -3:] != 0).any()  # mask gradients where the mask is 0
    ja = [None if x is None else jnp.asarray(x, jnp.float32 if i in (11, 12) else jnp.bfloat16)
          for i, x in enumerate(np_args)]
    with pltpu.force_tpu_interpret_mode():
        want = j_pair.fused_pair_mlp_bwd(jnp.asarray(g.float().numpy(), jnp.bfloat16), *ja,
                                         tile_i=8, tile_j=16)
    assert_within_max_abs(got, want, TOL, NAMES)


def test_d_pair_rounds_twice():
    """d_pair = bf16(bf16(dy0 W0^T) + bf16(dxd Wfe^T)), as the JAX kernel
    and the plain version round it; one rounding of the float32 sum gives
    other bits."""
    np_args = bf16_args(True, 95, 1, 12)
    args = pair_to_torch(np_args, BF16)
    g = torch.as_tensor(np.random.default_rng(96).normal(size=(1, 12, 12, 128))
                        .astype(np.float32)).to(BF16)
    _, got, once = emulate_bf16_bwd(g, *args)
    assert torch.equal(got[0], t_pair.pair_mlp_bwd_plain(g, *args)[0])
    assert not torch.equal(got[0], once)


def float32_workspace_floats(pairs: int) -> int:
    """The float32 workspace before bf16 took the chunked route."""
    groups = -(-(-(-pairs // 64)) // 32)
    return pairs * (4 * 384 + 128 + 1) + 8 * t_pair.W_PART_FLOATS + (groups * 33) * (384 + 3 * 128)


@pytest.mark.parametrize("N", [256, 512, 768])
def test_bf16_chunk_planner_stays_under_the_cap(N):
    """bf16 chunks tile the grid under the 1 GiB cap, the training shape in
    one chunk (0.52 GB: 0.50 GB of activations); float32's workspace and plan do not move."""
    B = 2
    chunks = t_pair.plan_bwd_chunks(B, N, N, dtype=BF16)
    assert chunks[0][0] == 0 and chunks[-1][1] == B * N
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
    sizes = [m1 - m0 for m0, m1 in chunks]
    assert set(sizes[:-1]) <= {sizes[0]} and 0 < sizes[-1] <= sizes[0]
    assert max(4 * t_pair.split_workspace_floats(s * N, BF16) for s in sizes) <= 1 << 30
    if N == 256:
        assert chunks == [(0, B * N)]
        assert 0.5e9 < 4 * t_pair.split_workspace_floats(B * N * N, BF16) < 0.53e9
    else:  # the fewest chunks: one chunk fewer would break the cap
        fewer = -(-B * N // (len(chunks) - 1))
        assert 4 * t_pair.split_workspace_floats(fewer * N, BF16) > 1 << 30
    for pairs in (0, 1, 63, 64, 65, N * N, B * N * N):
        assert t_pair.split_workspace_floats(pairs) == float32_workspace_floats(pairs)
    assert t_pair.plan_bwd_chunks(B, N, N, dtype=F32) == t_pair.plan_bwd_chunks(B, N, N)
    assert len(chunks) <= len(t_pair.plan_bwd_chunks(B, N, N))
