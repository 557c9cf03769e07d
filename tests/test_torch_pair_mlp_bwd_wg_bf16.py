"""The bf16 pair-MLP backward's kernel A on wgmma and TMA
(``csrc/pair_mlp_bwd_wg_bf16.cu``, on the bf16 forward's tile code
``csrc/pair_mlp_wg_bf16.cuh``), mirrored in Python and checked on the CPU:

- the chain's B operand: each chain slice is 128 stored rows (n) x 64
  stored columns (k) of a weight as stored ([in, out]), two TMA boxes of 64
  rows; the K-major descriptor (``wg::desc_sw128``, transpose flag 0) of
  every k16 step, decoded by the PTX ISA's canonical K-major layout over the
  swizzled boxes, reads W^T (k, n) = W[n, k], every element once;
- the chain's slice map (``chain_coords``): Wf^T, W1^T, W0^T and Wfe^T each
  covered once a tile, in the order the chain's products take them, after
  the forward's slices;
- the tiles: warpgroup g of 128-pair tile t owns the chunk's rows 128 t +
  64 g .. and writes split tile 2 t + g's vector partial; the tensor map of
  pair covers the chunk's rows only, so a tile's rows past the chunk read as
  zeros (the next chunk's pairs are not loaded);
- kernel A's arithmetic emulated tile by tile (the recompute's and the
  chain's products each summed over its whole K in float32 by 16-deep steps
  added truncated, the bf16 rounding points, the chain masked by the
  recompute's relu decisions; the LayerNorm sums in runs of 8 rows), then the
  rest of the split backward (the row and column sums, kernel B's split-K
  sums, the ordered partial sums), in chunks: every gradient within 5e-2 of
  its own max-abs of the JAX backward kernel in bf16 (interpret mode,
  jitted) and of ``pair_mlp_bwd_plain``, with and without the residual
  terms, in chunks whose last tile's second warpgroup lies wholly past the
  chunk;
- the sources: no mma.sync, ldmatrix or ``pair_mlp_tc.cuh`` in the new
  file, and the build lists it and neither deleted file.

The kernel itself is held against the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 3).
"""
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from framedipt_tpu.model.pallas import pair_mlp as j_pair

from framedipt_tpu_torch.model.kernels import build
from framedipt_tpu_torch.model.kernels import pair_mlp as t_pair

from tests.test_torch_cuda import pair_to_torch
from tests.test_torch_pair_mlp_bwd_bf16 import assert_within_max_abs, bf16_args, split_k_bf16
from tests.test_torch_pair_mlp_bwd_split import NAMES, in_order, rows_cap
from tests.test_torch_pair_mlp_wg_bf16 import (
    BOX_BYTES, C_IN, C_OUT, HALF, HID, NC, RES_SLICE, SLICE_K, TILE, add_steps, desc_sw128,
    k_major_address, rnd, slice_coords, swap_offsets)
from tests.test_torch_wgrad_bf16 import tma_box
from tests.torch_threads import one_torch_thread  # noqa: F401

BF16 = torch.bfloat16
TOL = 5e-2
SRC = build.CSRC / "pair_mlp_bwd_wg_bf16.cu"
HDR = build.CSRC / "pair_mlp_wg_bf16.cuh"


# ---- the chain's slices and B operand -----------------------------------------


def chain_coords(s: int) -> tuple[str, int, int]:
    """``chain_coords`` of the tile code: slice s of a tile's chain as
    (weight, first stored row n0, first stored column k0): the block
    W[n0:n0 + 128, k0:k0 + 64] of the weight as stored, which is the 64 (k)
    x 128 (n) slice W^T[k0:k0 + 64, n0:n0 + 128]."""
    if s < 6:
        return "wf", (s // 2) * NC, (s % 2) * SLICE_K
    if s < RES_SLICE:
        hc, v = divmod(s - 6, 8)
        if v < HID // SLICE_K:
            return "w1", hc * NC, v * SLICE_K
        return "w0", 0, hc * NC + (v - HID // SLICE_K) * SLICE_K
    return "wfe", 0, (s - RES_SLICE) * SLICE_K


def test_chain_slice_map_is_the_sources_and_covers_each_transpose_once():
    """chain_coords here is the C function's, case by case; over a tile's
    chain slices (32 with the residual terms) each stored weight's every
    element lies in exactly one slice, in the order the chain takes them
    (dxd Wf^T by output chunk; per dy0 chunk W1^T's six, then W0^T's two;
    Wfe^T's two), and the producer streams them after the forward's."""
    src = HDR.read_text()
    body = src[src.index("chain_coords(const Maps& m, int s"):]
    body = body[:body.index("\n}\n")]
    for line in ("row = (s / kKSlices) * NC;", "col = (s % kKSlices) * kSliceK;",
                 "const int hc = (s - kW0Slices) / kChunkSlices, v = (s - kW0Slices) % kChunkSlices;",
                 "row = hc * NC;", "col = v * kSliceK;", "return &m.w1;",
                 "col = hc * NC + (v - HID / kSliceK) * kSliceK;", "return &m.w0;",
                 "col = (s - kResSlice) * kSliceK;", "return &m.wfe;"):
        assert line in body, line
    assert [chain_coords(s)[0] for s in range(32)] == (
        ["wf"] * 6 + (["w1"] * 6 + ["w0"] * 2) * 3 + ["wfe"] * 2)
    shapes = {"w0": (C_IN, HID), "w1": (HID, HID), "wf": (HID, C_OUT), "wfe": (C_IN, C_OUT)}
    seen = {k: np.zeros(v, np.int64) for k, v in shapes.items()}
    for s in range(RES_SLICE + 2):
        name, n0, k0 = chain_coords(s)
        seen[name][n0:n0 + 128, k0:k0 + SLICE_K] += 1
    assert all((v == 1).all() for v in seen.values())
    produce = src[src.index("void produce(Smem& sm"):]
    produce = produce[:produce.index("\n}\n")]
    assert produce.index("slice_coords(maps, s, col, row)") < produce.index(
        "chain_coords(maps, s, col, row)")
    assert "for (int s = 0; CHAIN && s < kSlices; ++s, ++n) {" in produce
    assert "produce<RESIDUAL, true>(sm, maps, a.tiles);" in SRC.read_text()


@pytest.mark.parametrize("stage", [0, 2])
def test_chain_b_descriptors_read_the_transposed_weight(stage):
    """For every k16 step kk of a chain stage, the K-major B descriptor (the
    stage's first box + 32 kk bytes; its second box, rows 64 .. 127, 8 KB
    further, as the stride byte offset walks on) reads (k, n) = stored
    element (n, 16 kk + k) of the 128 x 64 block TMA staged as two boxes of
    64 rows: W^T's element (k, n). Every element of the stage once; with the
    descriptor's offsets swapped it reads others."""
    src = HDR.read_text()
    assert ("wgmma_m64n128k16_kb(acc, wg::desc_sw128(a + 16 * kk), wg::desc_sw128(b + 16 * kk),"
            in src)
    assert '"%64, %65, p, 1, 1, 0, 0;\\n}"' in src  # B K-major: transpose flag 0
    assert "wg::tma_load_2d(sm.w[st][0], map, &sm.full[st], col, row);" in src
    assert "wg::tma_load_2d(sm.w[st][1], map, &sm.full[st], col, row + 64);" in src
    base = stage * 2 * BOX_BYTES
    staged = {}
    for j in range(2):  # box j: stored rows 64 j .., columns 0 .. 63 of the block
        staged.update({a: (64 * j + r, c) for a, (r, c) in tma_box(base + j * BOX_BYTES).items()})
    seen, wrong = set(), 0
    for kk in range(SLICE_K // 16):
        desc = desc_sw128(base + 2 * 16 * kk)
        swapped = swap_offsets(desc)
        for n in range(128):
            for k in range(16):
                addr = k_major_address(desc, n, k)
                assert staged[addr] == (n, 16 * kk + k)
                seen.add(addr)
                start = (swapped & 0x3FFF) << 4
                sbo = ((swapped >> 32) & 0x3FFF) << 4
                alt = start + (n // 8) * sbo + (n % 8) * 128 + 2 * k
                alt ^= ((alt >> 7) & 7) << 4
                wrong += staged.get(alt) != (n, 16 * kk + k)
    assert len(seen) == 128 * SLICE_K and wrong > 0


# ---- the tiles and the chunk --------------------------------------------------


def test_warpgroups_write_their_split_tiles_and_the_pair_map_is_the_chunks():
    """Read from the source: warpgroup g of tile t starts at the chunk's row
    128 t + 64 g and writes split tile 2 t + g's vector partial (only if that
    split tile lies in the chunk: past it the launch's zeros stay); the pair
    map is encoded over the chunk's rows (base pair + q0 * 128, P rows), its
    boxes 128 rows."""
    src = SRC.read_text()
    assert "const long long lp0 = t * kTile + kHalf * group, p0 = a.q0 + lp0;" in src
    assert "float* vp = a.ws.vpart + (2 * t + group) * kVec;" in src
    assert "const bool inside = lp0 < a.P;" in src
    assert "!wg::bf16_sw128_map(&maps.pair, pair + q0 * C_IN, P, C_IN, kTile))" in src
    assert "cudaMemsetAsync(ws.vpart + split * kVec, 0," in src
    assert "static_assert(kHalf == kRows" in src


def pair_box(flat_pair: torch.Tensor, q0: int, P: int, t: int) -> torch.Tensor:
    """The TMA box of tile t through the chunk's pair map: rows q0 + 128 t ..
    of the flat pairs, zeros past the chunk's P rows (the map's end)."""
    rows = torch.arange(TILE) + TILE * t
    box = torch.zeros(TILE, C_IN, dtype=flat_pair.dtype)
    box[rows < P] = flat_pair[q0 + rows[rows < P]]
    return box


def test_pair_box_zero_fills_past_the_chunk():
    """A chunk's last tile reads zeros past the chunk although the grid's
    next chunk follows in memory."""
    flat = torch.arange(1, 401 * C_IN + 1, dtype=torch.float32).view(401, C_IN)
    box = pair_box(flat, 140, 140, 1)  # the second chunk of 140 pairs, tile 1: rows 268 ..
    assert torch.equal(box[:12], flat[268:280])
    assert not box[12:].any()  # rows 280 .. 395 exist in the grid, not in the chunk


# ---- kernel A's arithmetic ----------------------------------------------------


class ChainRing:
    """The ring as a consumer warpgroup sees it in kernel A: each tile's
    forward slices (``slice_coords``), then its chain's (``chain_coords``),
    the count running across tiles."""

    def __init__(self, weights: dict, residual: bool):
        self.w, self.n = weights, 0
        self.half = RES_SLICE + (2 if residual else 0)

    def take(self, chain: bool, name: str, a: int, b: int) -> torch.Tensor:
        """The next slice as a 64 (k) x 128 (n) operand; (a, b) = (output
        column, input row) of a forward slice, (stored row, stored column) of a
        chain slice."""
        s = self.n % (2 * self.half)
        assert (s >= self.half) == chain, (self.n, chain)
        got = chain_coords(s - self.half) if chain else slice_coords(s)
        assert got == (name, a, b), (self.n, got, (name, a, b))
        self.n += 1
        w = self.w[name]
        return w[a:a + 128, b:b + SLICE_K].t() if chain else w[b:b + SLICE_K, a:a + NC]

    def product(self, x: torch.Tensor, chain: bool, name: str, a: int, b: int,
                acc: torch.Tensor | None = None) -> torch.Tensor:
        """acc (+)= x [rows, K] @ the ring's next K / 64 slices, the whole K
        in one accumulator (zero when acc is None); a chain slice's stored
        column, a forward slice's input row, steps 64 a slice."""
        acc = torch.zeros(x.shape[0], NC) if acc is None else acc
        for s in range(x.shape[1] // SLICE_K):
            w = self.take(chain, name, a, b + SLICE_K * s)
            acc = add_steps(acc, x[:, SLICE_K * s:SLICE_K * (s + 1)], w)
        return acc


def emulate_kernel_a(g, pair, i_term, j_term, row_mask, col_mask, w0, b0, w1, b1, wf, bf,
                     ln_scale, ln_bias, fi, fj, wfe, m0: int, m1: int) -> dict:
    """Kernel A over the chunk of grid rows m0 .. m1 - 1: the workspace's
    arrays (y0, y1, dy1, dy0, dxd in bf16 values; dx, dem float32), d_pair
    of the chunk's pairs, and vpart (one row a split tile, zero past the
    chunk's), tile by tile, warpgroup by warpgroup."""
    residual = wfe is not None
    B, Nr, Nc, _ = pair.shape
    q0, P = m0 * Nc, (m1 - m0) * Nc
    tiles = -(-P // TILE)
    split = -(-P // HALF)
    groups = -(-split // t_pair.SPLIT_GROUP)
    f = lambda x: x.float()  # noqa: E731
    flat, gflat = pair.reshape(-1, C_IN), g.reshape(-1, C_OUT)
    weights = {"w0": f(w0), "w1": f(w1), "wf": f(wf), "wfe": None if wfe is None else f(wfe)}
    ws = {k: torch.zeros(P, c) for k, c in (("y0", HID), ("y1", HID), ("dy1", HID),
                                            ("dy0", HID), ("dxd", C_OUT), ("dx", C_OUT))}
    ws["dem"] = torch.zeros(P)
    d_pair = torch.zeros(P, C_IN)
    vpart = torch.zeros(groups * t_pair.SPLIT_GROUP, t_pair.SPLIT_VEC)
    for t in range(tiles):
        box = pair_box(flat, q0, P, t)
        ring = ChainRing(weights, residual)
        ring.n = t * 2 * ring.half  # every warpgroup takes every slice of every tile
        for grp in range(2):
            ring.n = t * 2 * ring.half
            lp0 = t * TILE + HALF * grp
            rows = torch.arange(lp0, lp0 + HALF)
            valid = rows < P
            p = q0 + rows
            b_, rem = p // (Nr * Nc), p % (Nr * Nc)
            prow = torch.where(valid, b_ * Nr + rem // Nc, 0)  # max(pt.row, 0)
            pcol = torch.where(valid, b_ * Nc + rem % Nc, 0)
            x = f(box[HALF * grp:HALF * (grp + 1)])
            it, jt = f(i_term).reshape(-1, HID)[prow], f(j_term).reshape(-1, HID)[pcol]
            # The recompute (forward_tile).
            y0 = torch.empty(HALF, HID)
            for cb in range(HID // NC):
                acc = ring.product(x, False, "w0", cb * NC, 0)
                c = slice(cb * NC, (cb + 1) * NC)
                y0[:, c] = torch.relu(rnd(rnd(rnd(rnd(acc) + it[:, c]) + jt[:, c]) + f(b0)[c]))
            y1 = torch.empty(HALF, HID)
            acc_out = None
            for hc in range(HID // NC):
                c = slice(hc * NC, (hc + 1) * NC)
                y1[:, c] = torch.relu(rnd(rnd(ring.product(y0, False, "w1", hc * NC, 0))
                                          + f(b1)[c]))
                acc_out = ring.product(y1[:, c], False, "wf", 0, hc * NC, acc_out)
            v = rnd(acc_out)
            if residual:
                v = rnd(v + rnd(ring.product(x, False, "wfe", 0, 0)))
                v = rnd(v + f(fi).reshape(-1, C_OUT)[prow])
                v = rnd(v + f(fj).reshape(-1, C_OUT)[pcol])
            v = rnd(v + f(bf))
            # The mask and LayerNorm backward.
            gv = torch.where(valid[:, None], f(gflat[p.clamp(max=gflat.shape[0] - 1)]), 0.0)
            xc = v - v.sum(-1, keepdim=True) / C_OUT
            inv = 1.0 / torch.sqrt((xc * xc).sum(-1, keepdim=True) / C_OUT + 1e-6)
            xh = xc * inv
            em = rnd(f(row_mask).reshape(-1)[prow] * f(col_mask).reshape(-1)[pcol])[:, None]
            dem = ((xh * ln_scale + ln_bias) * gv).sum(-1)
            gm = gv * em
            dxh = gm * ln_scale
            dx = (dxh - dxh.sum(-1, keepdim=True) / C_OUT
                  - xh * (dxh * xh).sum(-1, keepdim=True) / C_OUT) * inv
            dx = torch.where(valid[:, None], dx, 0.0)
            dxd = rnd(dx)
            # The chain, through the same ring, masked by the recompute's
            # relu decisions.
            dy1 = torch.empty(HALF, HID)
            for cb in range(HID // NC):
                c = slice(cb * NC, (cb + 1) * NC)
                dy1[:, c] = rnd(ring.product(dxd, True, "wf", cb * NC, 0)) * (y1[:, c] > 0)
            dy0 = torch.empty(HALF, HID)
            acc_dp = None
            for hc in range(HID // NC):
                c = slice(hc * NC, (hc + 1) * NC)
                dy0[:, c] = rnd(ring.product(dy1, True, "w1", hc * NC, 0)) * (y0[:, c] > 0)
                acc_dp = ring.product(dy0[:, c], True, "w0", 0, hc * NC, acc_dp)
            dp = rnd(acc_dp)
            if residual:
                dp = rnd(dp + rnd(ring.product(dxd, True, "wfe", 0, 0)))
            assert ring.n == (t + 1) * 2 * ring.half
            keep = rows[valid]
            for k, val in (("y0", y0), ("y1", y1), ("dy1", dy1), ("dy0", dy0), ("dxd", dxd),
                           ("dx", dx)):
                ws[k][keep] = val[valid]
            ws["dem"][keep] = dem[valid]
            d_pair[keep] = dp[valid]
            if lp0 < P:  # split tile 2 t + grp: d_b1 over its rows, the LayerNorm sums by runs
                runs = lambda z: in_order(in_order(  # noqa: E731
                    torch.where(valid[:, None], z, 0.0).view(8, 8, -1), 1), 0)
                vpart[2 * t + grp] = torch.cat([
                    in_order(dy1, 0), runs(dx), runs(gm * xh), runs(gm)])
    return {"ws": ws, "d_pair": d_pair, "vpart": vpart, "P": P}


def emulate_bwd(g, *args, cap=t_pair.BWD_WORKSPACE_CAP):
    """The bf16 backward with kernel A emulated tile by tile and the rest as
    the kernels sum it; returns (chunks, the 16 gradients)."""
    (pair, i_term, j_term, row_mask, col_mask, w0, b0, w1, b1, wf, bf, ln_scale, ln_bias, fi, fj,
     wfe) = args
    B, Nr, Nc, _ = pair.shape
    residual = wfe is not None
    grads = {n: torch.zeros(s) for n, s in t_pair._W_PARTS}
    rows = torch.zeros(B * Nr, t_pair.ROW_PART)
    cols = torch.zeros(B * Nc, t_pair.ROW_PART)
    d_pair = torch.zeros(B * Nr * Nc, C_IN)
    rmask, cmask = row_mask.float().reshape(-1), col_mask.float().reshape(-1)
    chunks = t_pair.plan_bwd_chunks(B, Nr, Nc, cap, BF16)
    for m0, m1 in chunks:
        a = emulate_kernel_a(g, *args, m0, m1)
        ws, P = a["ws"], a["P"]
        d_pair[m0 * Nc:m1 * Nc] = a["d_pair"]
        m_of = torch.arange(m0 * Nc, m1 * Nc) // Nc
        j_of = torch.arange(m0 * Nc, m1 * Nc) % Nc
        per_pair = torch.cat([ws["dy0"], ws["dx"], torch.zeros(P, 1)], 1)
        per_row = per_pair.clone()
        per_row[:, -1] = ws["dem"] * cmask[(m_of // Nr) * Nc + j_of]
        rows[m0:m1] = in_order(per_row.view(m1 - m0, Nc, -1), 1)
        per_col = per_pair.clone()
        per_col[:, -1] = ws["dem"] * rmask[m_of]
        for b in range(m0 // Nr, (m1 - 1) // Nr + 1):
            lo, hi = max(m0, b * Nr), min(m1, (b + 1) * Nr)
            part = per_col[(lo - m0) * Nc:(hi - m0) * Nc].view(hi - lo, Nc, -1)
            cols[b * Nc:(b + 1) * Nc] += in_order(part, 0)
        q = pair.reshape(-1, C_IN)[m0 * Nc:m1 * Nc]
        bf16 = lambda k: ws[k].to(BF16)  # noqa: E731
        grads["w0"] += split_k_bf16(q, bf16("dy0"))
        grads["w1"] += split_k_bf16(bf16("y0"), bf16("dy1"))
        grads["wf"] += split_k_bf16(bf16("y1"), bf16("dxd"))
        if residual:
            grads["wfe"] += split_k_bf16(q, bf16("dxd"))
        vec = in_order(in_order(a["vpart"].view(-1, t_pair.SPLIT_GROUP, t_pair.SPLIT_VEC), 1), 0)
        H = HID
        grads["b1"] += vec[:H]
        grads["bf"] += vec[H:H + C_OUT]
        grads["ln_scale"] += vec[H + C_OUT:H + 2 * C_OUT]
        grads["ln_bias"] += vec[H + 2 * C_OUT:]
    rows, cols = rows.view(B, Nr, -1), cols.view(B, Nc, -1)
    opt = (lambda v: v) if residual else (lambda v: None)

    def cast(v, ref):
        return None if v is None else v.to(ref.dtype)

    return chunks, (
        d_pair.view(B, Nr, Nc, C_IN).to(BF16), cast(rows[..., :HID], i_term),
        cast(cols[..., :HID], j_term), cast(rows[..., -1], row_mask), cast(cols[..., -1], col_mask),
        cast(grads["w0"], w0), cast(torch.sum(rows[..., :HID], dim=(0, 1)), b0),
        cast(grads["w1"], w1), cast(grads["b1"], b1), cast(grads["wf"], wf),
        cast(grads["bf"], bf), grads["ln_scale"], grads["ln_bias"],
        cast(opt(rows[..., HID:-1]), pair), cast(opt(cols[..., HID:-1]), pair),
        cast(opt(grads["wfe"]), pair))


@functools.cache
def jax_bwd(residual: bool):
    """The JAX backward kernel in bf16, interpret mode, jitted (op by op its
    interpret-mode callbacks can deadlock against the main thread)."""
    with pltpu.force_tpu_interpret_mode():
        fn = jax.jit(functools.partial(j_pair.fused_pair_mlp_bwd, tile_i=8, tile_j=16))
        np_args = bf16_args(residual, 131, 1, 20, folded=True)
        ja = [None if x is None else jnp.asarray(x, jnp.float32 if i in (11, 12) else jnp.bfloat16)
              for i, x in enumerate(np_args)]
        g = np.random.default_rng(132).normal(size=(1, 20, 20, 128)).astype(np.float32)
        want = fn(jnp.asarray(g, jnp.bfloat16), *ja)
        return np_args, g, [None if w is None else np.asarray(w, np.float32) for w in want]


@pytest.mark.parametrize("residual", [True, False])
def test_emulated_kernel_a_matches_jax_and_plain_backward(residual):
    """B=1 N=20 at the kernels' widths, the last rows masked, in 3 chunks of
    7, 7 and 6 grid rows (140 and 120 pairs: the last tile's second warpgroup
    wholly past the chunk in the first two, a partial 64-pair split tile in
    the third): every gradient of the emulation within 5e-2 of its own
    max-abs of the JAX backward kernel in bf16 (interpret mode, biases
    folded to 0) and of pair_mlp_bwd_plain in bf16; the recompute's relu
    decisions those of the plain forward."""
    np_args, g_np, want = jax_bwd(residual)
    args = pair_to_torch(np_args, BF16)
    g = torch.as_tensor(g_np).to(BF16)
    chunks, got = emulate_bwd(g, *args, cap=rows_cap(7, 20, BF16))
    assert chunks == [(0, 7), (7, 14), (14, 20)]
    assert all(x is None or torch.isfinite(x.float()).all() for x in got)
    assert_within_max_abs(got, t_pair.pair_mlp_bwd_plain(g, *args), TOL, NAMES)
    assert_within_max_abs(got, want, TOL, NAMES)
    assert (got[3][:, -3:] != 0).any()  # mask gradients where the mask is 0


# ---- the sources ----------------------------------------------------------------


def test_sources_have_no_mma_sync_and_the_build_lists_the_new_file():
    """The new kernel A is wgmma and TMA only: no mma.sync, ldmatrix,
    cp.async or tile code of the removed ``pair_mlp_tc.cuh``; the build
    compiles it as ``pair_mlp_bwd_wg_bf16`` and hashes the headers it
    includes; ``pair_mlp_bwd.cu`` and ``pair_mlp_tc.cuh`` are gone from
    csrc/ and from the build; the wrapper binds the new C entry (31
    arguments: no dtype, no transposed weights) and transposes no weight."""
    code = re.sub(r"//[^\n]*", "", SRC.read_text())
    for gone in ("mma.sync", "ldmatrix", "cp.async.ca", "pair_mlp_tc.cuh", "tc_product.cuh",
                 "mma_bf16(", "MlpStream"):
        assert gone not in code, gone
    assert build.SOURCES["pair_mlp_bwd_wg_bf16"] == "pair_mlp_bwd_wg_bf16.cu"
    assert "pair_mlp_bwd" not in build.SOURCES
    assert "pair_mlp_tc.cuh" not in build.HEADERS
    assert not (build.CSRC / "pair_mlp_bwd.cu").exists()
    assert not (build.CSRC / "pair_mlp_tc.cuh").exists()
    includes = [line.split('"')[1] for line in SRC.read_text().splitlines()
                if line.startswith('#include "')]
    assert includes == ["pair_mlp_wg_bf16.cuh", "pair_mlp_split.cuh"]
    assert all(f in build.HEADERS for f in includes)
    entry = SRC.read_text()
    entry = entry[entry.index('extern "C" int fdk_pair_mlp_bwd_wg_bf16('):]
    entry = entry[:entry.index(")")]
    assert len(entry.split(",")) == 31
    assert re.findall(r"__global__ void __launch_bounds__\([^)]*\)\s*(\w+)\(", SRC.read_text()) == [
        "bf16_bwd_tile_kernel"]
    import inspect
    wrapper = inspect.getsource(t_pair.pair_mlp_bwd)
    assert ".t().contiguous()" not in wrapper and "_bwd_wg_bf16_kernel()" in wrapper
    assert "launches_wgmma_bf16" in wrapper and "launches_mma" not in wrapper
