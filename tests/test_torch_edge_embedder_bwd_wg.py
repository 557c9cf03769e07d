"""The float32 edge-embedder backward's kernel A on wgmma and TMA
(``csrc/edge_embedder_bwd_wg.cu``), emulated in torch on the CPU, and what
its route, partials and build rest on.

The emulation takes kernel A's arithmetic on its walk: units of one grid row
and 64 consecutive columns (ragged at the row's end: the empty columns read
the next batch's or zero rows, run with a zero cotangent and edge mask, and
are not stored), the recompute as the wgmma forward's
(``tests/test_torch_edge_embedder_tc.py``: its A fragments, the split
weights of ``wgmma_weight_split``, each 32-deep slice summed apart), the
LayerNorm backward on the recompute's statistics, the chain's products as
32-deep 3xTF32 slices with B's hi and lo from the stored weights
(``chain_weight_split``), the relu decisions the recompute's; one vector
partial a unit (d_b1 and d_b2 as the three store warps sum them, every
third row in order, then the three sums; d_w_dist over each bin's rows in
order; d_ln_scale and d_ln_bias over each warp's 16 rows, then the four
warps), the units' partials summed 32 at a time, then the groups; and the rest of the
split backward as ``tests/test_torch_edge_embedder_bwd_split.py`` emulates
it (the row and column sums in order, kernel B's split-K sums). It is held
against the plain backward through the same relu decisions, against float64
and against the JAX backward kernel in interpret mode, every gradient within
1e-4 of max(1, its max-abs). The kernel itself is held against the plain
version on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 3).

    python -m pytest tests/test_torch_edge_embedder_bwd_wg.py -s   # prints the errors
"""
import ast
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from framedipt_tpu.model.pallas import edge_embedder as j_emb

from framedipt_tpu_torch.model.kernels import build
from framedipt_tpu_torch.model.kernels import edge_embedder as t_emb

from tests.test_torch_cuda import assert_grads_close, emb_args, emb_to_torch
from tests.test_torch_edge_embedder_bwd import NAMES, _jax_args, _without_coords
from tests.test_torch_edge_embedder_tc import product_wgmma_slices, wgmma_parts
from tests.test_torch_pair_mlp_bwd_split import KERNEL_B_ORDER, in_order, split_k
from tests.torch_threads import one_torch_thread  # noqa: F401

F32 = torch.float32
C, CP, UNIT, GROUP = t_emb.C, t_emb.CP, t_emb.SPLIT_TILE, t_emb.SPLIT_GROUP


def chain_parts(w_rel, w1, w2):
    """(hi, lo) [k, n] of W2^T, W1^T and W_rel^T from the chain's split:
    each slot is a weight as stored ([n, k]), so B = slot^T."""
    split_w = t_emb.chain_weight_split(w_rel, w1, w2)
    parts, off = [], 0
    for n in (CP, C, C):
        size = n * C
        hi = split_w[off:off + size].view(n, C)
        lo = split_w[off + size:off + 2 * size].view(n, C)
        parts.append((hi.t(), lo.t()))
        off += 2 * size
    return parts[::-1]


def kernel_a_units(grad, args, bins):
    """Kernel A over every unit of the grid (its rows do not depend on the
    chunk); a dict of [U, 64, .] per-unit arrays (m, y0, y1, dx, dy1, dy0,
    dm, dem, the cotangent-scaled LayerNorm terms, the pre-norm output's
    LayerNorm "out"), "keep" (the columns inside the row), each unit's grid
    row "row" and first column "j0"."""
    (g, h, pos_r, pos_c, i_term, j_term, row_mask, col_mask, w_rel, w_dist, b0, w1, b1, w2, b2,
     ln_scale, ln_bias) = args
    (B, Nr, _), Nc = g.shape, h.shape[1]
    n_jb = -(-Nc // UNIT)
    b, i, jb = (x.reshape(-1) for x in torch.meshgrid(
        torch.arange(B), torch.arange(Nr), torch.arange(n_jb), indexing="ij"))
    rows = (b * Nc + jb * UNIT)[:, None] + torch.arange(UNIT)  # [U, 64] column rows
    inside = rows < B * Nc  # rows past the grid read as zeros (TMA)
    safe = rows.clamp(max=B * Nc - 1)
    j = (jb * UNIT)[:, None] + torch.arange(UNIT)
    keep = j < Nc  # the columns inside the row: stored, and given the cotangent

    def column_rows(t):
        return torch.where(inside[..., None], t.reshape(B * Nc, -1)[safe], 0.0)

    H, J, pc = column_rows(h), column_rows(j_term), column_rows(pos_c)
    G, IT, pr = g[b, i], i_term[b, i], pos_r[b, i]
    (wr_hi, wr_lo), (w1_hi, w1_lo), (w2_hi, w2_lo) = wgmma_parts(w_rel, w1, w2)
    m = G[:, None, :] * H
    x = product_wgmma_slices(m, wr_hi, wr_lo)
    diff = pr[:, None, :] - pc
    sq = diff * diff
    d = torch.sqrt((sq[..., 0] + sq[..., 1]) + sq[..., 2])
    lower, upper = (torch.tensor(e, dtype=F32) for e in bins)
    hit = (d[..., None] > lower) & (d[..., None] < upper) & keep[..., None]
    if len(bins[0]):
        x = torch.where(hit.any(-1, keepdim=True), x + hit.float() @ w_dist, x)
    y0 = torch.relu(((x + IT[:, None, :]) + J) + b0)
    y1 = torch.relu(product_wgmma_slices(y0, w1_hi, w1_lo) + b1)
    pre = product_wgmma_slices(y1, w2_hi, w2_lo) + b2
    mean = pre.sum(-1, keepdim=True) / C
    centered = pre - mean
    rstd = 1.0 / torch.sqrt((centered * centered).sum(-1, keepdim=True) / C + 1e-6)
    mask = torch.where(keep, row_mask[b, i][:, None] * col_mask.reshape(-1)[safe], 0.0)
    cot = torch.where(keep[..., None], grad.reshape(B * Nr * Nc, C)[
        ((b * Nr + i) * Nc)[:, None] + j.clamp(max=Nc - 1)], 0.0)
    # The LayerNorm backward on the accumulators.
    xh = centered * rstd
    dem = ((xh * ln_scale + ln_bias) * cot).sum(-1)
    gm = cot * mask[..., None]
    m1 = (gm * ln_scale).sum(-1, keepdim=True) / C
    m2 = (gm * ln_scale * xh).sum(-1, keepdim=True) / C
    dx = (gm * ln_scale - m1 - xh * m2) * rstd
    # The chain, through the stored weights' split; the recompute's relus.
    (c2_hi, c2_lo), (c1_hi, c1_lo), (cr_hi, cr_lo) = chain_parts(w_rel, w1, w2)
    dy1 = product_wgmma_slices(dx, c2_hi, c2_lo) * (y1 > 0)
    dy0 = product_wgmma_slices(dy1, c1_hi, c1_lo) * (y0 > 0)
    dm = product_wgmma_slices(dy0, cr_hi, cr_lo)
    onehot = hit.float() if len(bins[0]) else torch.zeros(*hit.shape[:2], 0)
    return {"m": m, "y0": y0, "y1": y1, "dx": dx, "dy1": dy1, "dy0": dy0, "dm": dm, "dem": dem,
            "lns": gm * xh, "lnb": gm, "onehot": onehot,
            "out": (xh * ln_scale + ln_bias) * mask[..., None],
            "keep": keep, "row": b * Nr + i, "j0": jb * UNIT}


def unit_partials(a) -> torch.Tensor:
    """Kernel A's vector partial of each unit, [U, (4 + n_bins) * C]: d_b1 |
    d_b2 as the three store warps sum them (warp s every third row from row
    s, in order; then the three sums in order), d_ln_scale | d_ln_bias over
    each consumer warp's 16 rows and then the four warps, d_w_dist's bin
    rows over each bin's rows in order."""
    U = a["dx"].shape[0]

    def store_warps(x):
        s0, s1, s2 = (in_order(x[:, s::3], 1) for s in range(3))
        return (s0 + s1) + s2

    def warps(x):
        return in_order(in_order(x.view(U, 4, 16, -1), 2), 1)

    wdist = in_order(a["onehot"][..., :, None] * a["dy0"][..., None, :], 1).reshape(U, -1)
    return torch.cat([store_warps(a["dy1"]), store_warps(a["dx"]), warps(a["lns"]),
                      warps(a["lnb"]), wdist], 1)


def emulate_wg_bwd(grad, args, bins, cap=t_emb.BWD_WORKSPACE_CAP):
    """The float32 backward with kernel A on wgmma; returns (chunks, the
    gradients in float32 in edge_embedder_bwd's order, kernel A's units)."""
    g, h, row_mask, col_mask, w_rel = args[0], args[1], args[6], args[7], args[8]
    (B, Nr, _), Nc = g.shape, h.shape[1]
    n_bins = len(bins[0])
    a = kernel_a_units(grad, args, bins)
    keep = a["keep"]
    # The workspace rows: the units' stored columns, in unit order, which is
    # the flat pair order.
    flat = {n: a[n][keep] for n in ("m", "y0", "y1", "dx", "dy1", "dy0", "dm")}
    dem = a["dem"][keep]
    vparts = unit_partials(a)
    P_all = B * Nr * Nc
    m_of = torch.arange(P_all) // Nc  # flat grid row b * Nr + i
    col_of = (m_of // Nr) * Nc + torch.arange(P_all) % Nc  # flat column b * Nc + j
    g_f, h_f = g.reshape(B * Nr, CP), h.reshape(B * Nc, CP)
    per_row = torch.cat([flat["dm"] * h_f[col_of], flat["dy0"],
                         (dem * col_mask.reshape(-1)[col_of])[:, None]], 1)
    per_col = torch.cat([flat["dm"] * g_f[m_of], flat["dy0"],
                         (dem * row_mask.reshape(-1)[m_of])[:, None]], 1)
    jobs = {"w_rel": ("m", "dy0"), "w1": ("y0", "dy1"), "w2": ("y1", "dx")}
    grads = {n: torch.zeros(s) for n, s in t_emb._W_PARTS}
    rows = torch.zeros(B * Nr, t_emb.ROW_PART)
    cols = torch.zeros(B * Nc, t_emb.ROW_PART)
    vec = t_emb.split_vec_floats(n_bins)
    chunks = t_emb.plan_bwd_chunks(B, Nr, Nc, n_bins, cap, F32)
    for m0, m1 in chunks:
        q = slice(m0 * Nc, m1 * Nc)
        rows[m0:m1] = in_order(per_row[q].view(m1 - m0, Nc, -1), 1)
        for b in range(m0 // Nr, (m1 - 1) // Nr + 1):
            lo, hi = max(m0, b * Nr), min(m1, (b + 1) * Nr)
            part = per_col[lo * Nc:hi * Nc].view(hi - lo, Nc, -1)
            cols[b * Nc:(b + 1) * Nc] += in_order(part, 0)
        for name, (x, y) in jobs.items():
            grads[name] += split_k(flat[x][q], flat[y][q], t_emb.SPLIT_SLICES, KERNEL_B_ORDER)
        # The chunk's units' partials, 32 at a time, then the groups.
        units = vparts[(a["row"] >= m0) & (a["row"] < m1)]
        assert units.shape[0] == t_emb.split_parts(m1 - m0, Nc)
        groups = -(-units.shape[0] // GROUP)
        padded = torch.cat([units, units.new_zeros(groups * GROUP - units.shape[0], vec)])
        s = in_order(in_order(padded.view(groups, GROUP, vec), 1), 0)
        for k, name in enumerate(("b1", "b2", "ln_scale", "ln_bias")):
            grads[name] += s[k * C:(k + 1) * C]
        grads["w_dist"][:n_bins] += s[4 * C:].view(n_bins, C)
    rows, cols = rows.view(B, Nr, -1), cols.view(B, Nc, -1)
    d_b0 = torch.sum(rows[..., CP:-1], dim=(0, 1))
    return chunks, (rows[..., :CP], cols[..., :CP], None, None, rows[..., CP:-1],
                    cols[..., CP:-1], rows[..., -1], cols[..., -1], grads["w_rel"],
                    grads["w_dist"][:n_bins], d_b0, grads["w1"], grads["b1"], grads["w2"],
                    grads["b2"], grads["ln_scale"], grads["ln_bias"]), a


def relu_masks(a, B, Nr, Nc):
    """The emulated recompute's relu decisions as [B, Nr, Nc, C] bools."""
    keep = a["keep"]
    return tuple((a[k][keep] > 0).view(B, Nr, Nc, C) for k in ("y0", "y1"))


def bwd_float64(grad, args, bins, masks):
    """Every gradient of the forward in float64 through autograd (the
    coordinates' None), the relus replaced by the given decisions."""
    names = ("g", "h", "pos_r", "pos_c", "i_term", "j_term", "row_mask", "col_mask", "w_rel",
             "w_dist", "b0", "w1", "b1", "w2", "b2", "ln_scale", "ln_bias")
    t = {n: x.double().requires_grad_(n not in ("pos_r", "pos_c")) for n, x in zip(names, args)}
    diff = args[2][:, :, None, :] - args[3][:, None, :, :]
    d = torch.sqrt(torch.sum(diff * diff, dim=-1))
    lower, upper = (torch.tensor(e, dtype=F32) for e in bins)
    onehot = ((d[..., None] > lower) & (d[..., None] < upper)).double()
    m0, m1 = (m.double() for m in masks)
    mm = t["g"][:, :, None, :] * t["h"][:, None, :, :]
    x = (mm @ t["w_rel"] + onehot @ t["w_dist"] + t["i_term"][:, :, None] + t["j_term"][:, None]
         + t["b0"])
    y1 = ((x * m0) @ t["w1"] + t["b1"]) * m1
    out = y1 @ t["w2"] + t["b2"]
    mean = out.mean(-1, keepdim=True)
    var = ((out - mean) ** 2).mean(-1, keepdim=True)
    y = (((out - mean) / torch.sqrt(var + 1e-6) * t["ln_scale"] + t["ln_bias"])
         * (t["row_mask"][:, :, None] * t["col_mask"][:, None])[..., None])
    wanted = [n for n in names if n not in ("pos_r", "pos_c")]
    got = dict(zip(wanted, torch.autograd.grad(y, [t[n] for n in wanted], grad.double())))
    return tuple(None if n in ("pos_r", "pos_c") else got[n] for n in names)


def _jax_grads(args_np, grad, bins):
    j_args, j_bins = _jax_args(args_np, jnp.float32), bins
    if not len(bins[0]):
        # The JAX kernel takes no zero-row block: one bin that no distance
        # falls in is the same function.
        j_args[9] = jnp.zeros((1, C), jnp.float32)
        j_bins = ((1e30,), (-1e30,))
    with pltpu.force_tpu_interpret_mode():
        want = list(j_emb.fused_edge_embedder_bwd(jnp.asarray(grad), *j_args,
                                                  bins_lower=j_bins[0], bins_upper=j_bins[1],
                                                  tile_i=8, tile_j=16))
    if not len(bins[0]):
        want[9] = want[9][:0]
    return _without_coords(want)


# (B, N, n_bins, grid rows a chunk): N = 20, one unit a row running 44
# columns past it, in 5 chunks of 8 rows (a chunk crosses the batch
# boundary), with and without distance bins; N = 70, two units a row, the
# second 6 columns wide, in 3 chunks.
CASES = {"n20_bins": (2, 20, 22, 8), "n20_no_bins": (2, 20, 0, 8), "n70_ragged": (1, 70, 22, 24)}


@pytest.mark.parametrize("case", list(CASES))
def test_wgmma_kernel_a_matches_plain_float64_and_jax(case):
    """Kernel A's arithmetic on its unit walk, emulated, with the rest of the
    split backward, against the plain backward through the emulated
    recompute's relu decisions, against float64 through them, and against
    the JAX backward kernel in interpret mode (its own decisions), every
    gradient within 1e-4 of max(1, its max-abs); the recompute's LayerNorm
    output is the wgmma forward's (1e-4 of the plain version)."""
    B, N, n_bins, per = CASES[case]
    rng = np.random.default_rng(251 + N + n_bins)
    args_np, bins = emb_args(rng, B, N, C, n_bins)
    args = emb_to_torch(args_np, F32)
    grad = torch.as_tensor(rng.normal(size=(B, N, N, C)).astype(np.float32))
    cap = 4 * t_emb.split_workspace_floats(per * N, n_bins, F32, t_emb.split_parts(per, N))
    chunks, got, a = emulate_wg_bwd(grad, args, bins, cap=cap)
    assert chunks == [(m, min(m + per, B * N)) for m in range(0, B * N, per)]
    masks = relu_masks(a, B, N, N)
    kw = {"bins_lower": bins[0], "bins_upper": bins[1]}
    plain = t_emb.edge_embedder_bwd_plain(grad, *args, **kw, relu_masks=masks)
    exact = bwd_float64(grad, args, bins, masks)
    for label, want in (("plain", plain), ("float64", exact),
                        ("JAX interpret", _jax_grads(args_np, grad.numpy(), bins))):
        want = [None if y is None else np.asarray(
            y.detach() if isinstance(y, torch.Tensor) else y, np.float64) for y in want]
        worst = max(float(np.abs(x.double().numpy() - y).max(initial=0.0))
                    / max(1.0, float(np.abs(y).max(initial=0.0)))
                    for x, y in zip(got, want) if y is not None)
        print(f"{case}: emulated kernel A against {label}: worst error {worst:.3e} of "
              "max(1, max-abs)")
        assert_grads_close(got, want, 1e-4, NAMES)
    fwd = a["out"][a["keep"]].view(B, N, N, C)
    torch.testing.assert_close(fwd, t_emb.edge_embedder_plain(*args, *bins), atol=1e-4, rtol=1e-4)
    assert (got[6][:, -3:] != 0).all() and (got[7][:, -3:] != 0).all()  # masked rows
    if n_bins:
        assert (got[9] != 0).any()


def test_ragged_units_add_nothing_and_count_one_partial_each():
    """At N = 70 (two units a row, the second 6 columns wide) every stored
    array is zero-free of the empty columns' values: their cotangent,
    edge mask and gradients are 0, so each unit's partial is the same with
    them and without them; the partials are one a unit, rows x ceil(Nc /
    64), more than the flat 64-pair tiles at a ragged Nc, and the float32
    workspace and planner count them so."""
    rng = np.random.default_rng(77)
    args_np, bins = emb_args(rng, 1, 70, C, 22)
    args = emb_to_torch(args_np, F32)
    grad = torch.as_tensor(rng.normal(size=(1, 70, 70, C)).astype(np.float32))
    a = kernel_a_units(grad, args, bins)
    empty = ~a["keep"]
    assert int(empty.sum()) == 70 * 58  # 58 empty columns in each row's second unit
    for name in ("dx", "dy1", "dy0", "dm", "lns", "lnb"):
        assert not a[name][empty].any(), name
    assert not a["dem"][empty].any() and not a["onehot"][empty].any()
    with_empty = unit_partials(a)
    trimmed = {k: (torch.where(a["keep"][..., None], v, 0.0) if v.dim() == 3 else v)
               for k, v in a.items()}
    assert torch.equal(unit_partials(trimmed), with_empty)
    assert with_empty.shape[0] == t_emb.split_parts(70, 70) == 140
    for rows, Nc, units, tiles in ((5, 100, 10, 8), (8, 20, 8, 3), (4, 256, 16, 16), (1, 1, 1, 1)):
        assert t_emb.split_parts(rows, Nc) == units
        assert t_emb.split_parts(rows, Nc, torch.bfloat16) == tiles
    # 33 units need two groups of partials, 32 tiles one.
    assert (t_emb.split_workspace_floats(33 * 64, 22, F32, 33)
            - t_emb.split_workspace_floats(33 * 64, 22, F32, 32)
            == (GROUP + 1) * t_emb.split_vec_floats(22))
    # The planner sizes a float32 chunk by its units.
    cap = 4 * t_emb.split_workspace_floats(40 * 20, 22, F32, t_emb.split_parts(40, 20))
    assert t_emb.plan_bwd_chunks(2, 20, 20, 22, cap) == [(0, 40)]
    assert 4 * t_emb.split_workspace_floats(40 * 20, 22) < cap  # by tiles, it would fit more


def test_chain_weight_split_laid_back_gives_each_stored_weight():
    """The chain's TF32 split (what kernel A's first step writes for the
    input-gradient chain after the forward's) holds, slot by slot, W_rel, W1
    and W2 as stored ([n, k] for their transposes): hi and lo TF32 values,
    hi + lo within 2^-22 of each weight's element; it is the forward's split
    of the transposed weights."""
    rng = np.random.default_rng(9)
    args_np, _ = emb_args(rng, 1, 3, C, 22)
    w_rel, w1, w2 = (torch.as_tensor(args_np[k]) for k in (8, 11, 13))
    split = t_emb.chain_weight_split(w_rel, w1, w2)
    assert split.shape == (t_emb.WG_SPLIT_FLOATS,)
    off = 0
    for w in (w_rel, w1, w2):
        n = w.numel()
        hi, lo = split[off:off + n].view(w.shape), split[off + n:off + 2 * n].view(w.shape)
        assert torch.equal(hi, t_emb.tf32_rna(hi)) and torch.equal(lo, t_emb.tf32_rna(lo))
        err = (hi.double() + lo.double() - w.double()).abs()
        assert bool((err <= 2.0**-22 * w.double().abs()).all())
        off += 2 * n
    assert off == t_emb.WG_SPLIT_FLOATS
    assert torch.equal(split, t_emb.wgmma_weight_split(w_rel.t(), w1.t(), w2.t()))


def test_float32_backward_launches_the_wgmma_kernel_a_or_raises():
    """Read from the wrapper: after the CPU branch ``edge_embedder_bwd`` asks
    ``forward_route(dtype)`` once; the "wgmma" route
    (float32) calls csrc/edge_embedder_bwd_wg.cu's entry (``_bwd_wg_kernel``)
    and nothing else, the other route csrc/edge_embedder_bwd.cu's
    (``_split_kernel``); no ``try``. And the C sources: edge_embedder_bwd.cu's
    entry no longer instantiates a float32 kernel A, edge_embedder.cu's no
    float32 forward."""
    fn = ast.parse(inspect.getsource(t_emb.edge_embedder_bwd)).body[0]
    calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call)]
    routes = [c for c in calls if ast.unparse(c.func) == "forward_route"]
    assert [ast.unparse(c) for c in routes] == ["forward_route(dtype)"]
    assert t_emb.forward_route(torch.float32) == "wgmma"
    assert t_emb.forward_route(torch.bfloat16) == "mma"
    branches = [n for n in ast.walk(fn) if isinstance(n, ast.If)
                and ast.unparse(n.test) == "route == 'wgmma'"]

    def called(nodes):
        return {ast.unparse(n.func) for body in nodes for s in body for n in ast.walk(s)
                if isinstance(n, ast.Call)}

    launch = [b for b in branches if "_bwd_wg_kernel()" in called([b.body])]
    assert len(launch) == 1
    assert "_split_kernel()" not in called([launch[0].body])
    assert "_split_kernel()" in called([launch[0].orelse])
    assert "_bwd_wg_kernel()" not in called([launch[0].orelse])
    assert not any(isinstance(n, ast.Try) for n in ast.walk(fn))
    bwd = (build.CSRC / "edge_embedder_bwd.cu").read_text()
    assert "launch_split<float" not in bwd and "launch_split<__nv_bfloat16" in bwd
    fwd = (build.CSRC / "edge_embedder.cu").read_text()
    assert "launch<float>" not in fwd and "launch<__nv_bfloat16>" in fwd


def test_build_names_the_wgmma_backward_source():
    """The build compiles csrc/edge_embedder_bwd_wg.cu into its own library,
    every header it includes (the forward's unit, the split backward's rest)
    is hashed with it, the forward includes the same unit header, and
    neither includes the mma.sync tile code."""
    assert build.SOURCES["edge_embedder_bwd_wg"] == "edge_embedder_bwd_wg.cu"
    includes = {}
    for name in ("edge_embedder_bwd_wg.cu", "edge_embedder_wg.cu", "edge_embedder_bwd.cu",
                 "edge_embedder_wg.cuh", "edge_embedder_split.cuh"):
        includes[name] = [line.split('"')[1] for line in
                          (build.CSRC / name).read_text().splitlines()
                          if line.startswith('#include "')]
        assert includes[name] and all(f in build.HEADERS for f in includes[name]), name
    assert includes["edge_embedder_bwd_wg.cu"] == ["edge_embedder_wg.cuh", "edge_embedder_split.cuh"]
    assert includes["edge_embedder_wg.cu"] == ["edge_embedder_wg.cuh"]
    assert "edge_embedder_split.cuh" in includes["edge_embedder_bwd.cu"]
    assert "tc_product.cuh" not in includes["edge_embedder_wg.cuh"] + includes["edge_embedder_split.cuh"]
