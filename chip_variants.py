#!/usr/bin/env python3
"""Time the edge-embedder forward kernels, the bf16 pair-MLP forward on
wgmma, the pair-MLP backward's kernel A (float32 and bf16), the float32
edge-embedder backward's kernel A and kernel B of both split backwards
(both dtypes) beside variants of their sources, on one CUDA card.

    python3 chip_variants.py [--parent DIR] [--out FILE]
                             [--only mma|wgmma|bwd|emb_bwd|wgrad|bf16_fwd|bf16_bwd]

Each variant is this checkout's ``framedipt_tpu_torch/csrc`` with text
patches applied to a copy, built by nvcc (one process per variant, all
started together) and loaded in place of the library the wrapper
``edge_embedder`` calls: variants of ``edge_embedder.cu`` (the ``mma.sync``
kernel, every bf16 forward) and of ``edge_embedder_wg.cu`` with its unit's
header ``edge_embedder_wg.cuh`` (the wgmma kernel, every float32 forward),
of ``edge_embedder_bwd_wg.cu`` (the float32 embedder backward, kernel A on
wgmma: three ring stages, the relu decisions in registers, and one part
removed at a time: the products, the workspace stores, the chain, the
partial sums), the backward held and timed at B=2 N=256 by its call and by
kernel A's device time beside the parent's float32 backward (with
``--parent``), then this checkout's kernel A and its three-stage variant
over six input draws of their own seeds and a copy of the first draw at
other addresses, three rounds each, with the card's SM clock sampled every
50 ms meanwhile (what one reading of kernel A is worth), and of ``pair_mlp_bwd_wg.cu`` (the float32 pair-MLP backward,
kernel A on wgmma: its relu decisions read back from the workspace in place
of registers, and one part removed at a time: the products, the workspace
stores, the LayerNorm backward, the relu masks), the backward held and timed
at B=2 N=256 by its call and by kernel A's device time (torch.profiler),
and of ``wgrad_wg.cuh`` (float32 kernel B, built into both backwards'
libraries: A through the transform too, two ring stages, and one part
removed at a time: the transform, the products, two of the three TF32
products, the TMA loads), each backward timed at B=2 N=256 by its call and
by kernel B's device time, and of ``wgrad_bf16.cuh`` (bf16 kernel B, built
into both bf16 backwards' libraries: 32-pair steps, five and six ring
stages, and one part removed at a time: the products, the TMA loads; and
every block loading one job's rows of slice 0, which stay in L2), likewise
in bf16; then bf16 kernel B's device ms inside both bf16 backwards over six
placements of the call's memory (PLACEMENT_PADS_MB), three rounds each,
beside the same products as ``torch.mm`` in bf16 and, with ``--parent``,
the parent's ``mma.sync`` kernel B, with each one's median and spread; and
of ``pair_mlp_wg_bf16.cuh`` (the bf16 pair-MLP forward on wgmma: its slice
loop rolled, a ring of two stages, and one part removed at a time: the
products, the epilogues' loads from device memory, the weights' TMA loads),
each variant held or timed at FWD_SHAPES beside, with ``--parent``, the
parent's bf16 forward, then this checkout's kernel and the parent's at
FWD_SHAPES over six placements of the inputs (PLACEMENT_PADS_MB), three
rounds each, by device ms of one call (torch.profiler) and CUDA events,
median and spread; and of ``pair_mlp_bwd_wg_bf16.cu`` (the bf16 pair-MLP
backward's kernel A on wgmma: the relu decisions read back from the
workspace, TMA stores, and one part removed at a time: the chain's
products, every product, the workspace stores, the LayerNorm backward),
held against the plain version (B=1 N=1, N=17, B=2 N=200, also in 10
chunks) and timed by kernel A's device ms and the call at B=2 N=256, then
this checkout's kernel A over six placements beside, with ``--parent``,
the parent's (``pair_mlp_bwd.cu``, mma.sync, in a tree that has it).
``--only`` builds and times one kernel's variants (``wgrad``: both dtypes'
kernel B; ``bf16_fwd``: the bf16 pair-MLP forward; ``bf16_bwd``: the bf16
pair-MLP backward's kernel A). Variants that
change how a kernel works are held against the plain version (float32 1e-4,
bf16 5e-2) at B=1 N=1, B=1 N=17, B=2 N=200 and B=2 N=256; variants that
remove a part of the work give wrong outputs and are only timed, to show
what that part costs. With ``--parent`` (a tree unpacked from an earlier
commit: ``git archive <rev> | tar -x -C DIR``; the parent's sources that
exist are built), that tree's ``edge_embedder.cu`` is timed too and must
give the same bits as this checkout's at B=1 N=1, B=1 N=17, B=2 N=200 and
B=2 N=256 with and without distance bins in bf16 (the forward's tile is
shared with the bf16 embedder backward's recompute); its
``pair_mlp_wg_bf16.cu`` (bf16), ``pair_mlp_wg.cu`` and ``pair_mlp_bwd_wg.cu``
(float32, with and without the residual terms), ``edge_embedder_wg.cu``
(float32), ``edge_embedder_bwd_wg.cu`` (float32, also held against the
plain version), ``edge_embedder_bwd.cu`` (bf16: every gradient but kernel
B's) and ``ipa_attention.cu`` (both dtypes) must give the same bits as this
checkout's; its bf16 pair-MLP backward (``pair_mlp_bwd.cu``) is compared
gradient by gradient, the ones that keep its bits named, this checkout's
held against the plain version (the dtype's tolerance of each gradient's
max-abs through the recompute's relu decisions); and the forwards
(differentiated) and both
backwards in both dtypes are timed beside the parent's, the backwards by
call and by kernel A's and kernel B's device ms. The parent's wrappers run
through that tree's own wrapper modules (which must take this checkout's
signatures), and they bind its C entries as it built them.

Times: CUDA events over 20 launches at B=2 N=256 (the wgmma variants also at
B=2 N=896) in float32 and, for the mma.sync kernel, bf16, every variant once
a round, three rounds in alternating order; this checkout's and the parent's
other kernels likewise. Prints one line per check and per timing, then the
card's name and power limit; writes the times as JSON to ``--out``. Exits
non-zero if a variant fails to build or a checked one disagrees with the
plain version or the parent.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import pathlib
import shutil
import subprocess
import sys
import tempfile

import torch

REPO = pathlib.Path(__file__).resolve().parent

# A parent tree's backward kernels that this checkout no longer has: bf16
# kernel A of csrc/pair_mlp_bwd.cu (PR 27 and before) and the mma.sync
# kernel B (PR 25 and before), for bwd_parts_ms's kinds.
PARENT_PARTS = (("A", "split_tile_kernel"), ("B", "wgrad_kernel"))
EMB = "edge_embedder.cu"
EMB_TC = "edge_embedder_tc.cuh"
TC = "tc_product.cuh"
# The layer-1 epilogue's and the CP product's loads as the kernel issues
# them, and as a plain loop that uses each value as it arrives.
BATCHED_FILL = """    float gv[kFill], hv[kFill];
#pragma unroll
    for (int u = 0; u < kFill; ++u) {
      const int idx = tid + u * kBlock, r = idx / CP, k = idx - r * CP;
      gv[u] = ld<T>(g + (size_t)max(pt.row[r], 0) * CP + k);
      hv[u] = ld<T>(h + (size_t)pt.col[r] * CP + k);
    }
#pragma unroll
    for (int u = 0; u < kFill; ++u) {
      const int idx = tid + u * kBlock, r = idx / CP, k = idx - r * CP;
      M[r * L::LDM + k] = pt.row[r] < 0 ? 0.f : rnd<T>(gv[u] * hv[u]);
    }"""
PLAIN_FILL = """    for (int idx = tid; idx < kRows * CP; idx += kBlock) {
      const int r = idx / CP, k = idx - r * CP;
      M[r * L::LDM + k] = pt.row[r] < 0 ? 0.f
                                        : rnd<T>(ld<T>(g + (size_t)pt.row[r] * CP + k) *
                                                 ld<T>(h + (size_t)pt.col[r] * CP + k));
    }"""
EPI1_LOADS = """        it[ni][q >> 1] = ld2(i_term + (size_t)prow * C + c);
        jt[ni][q >> 1] = ld2(j_term + (size_t)pt.col[r] * C + c);
        wd[ni][q >> 1] = bn >= 0 ? ld2(w_dist + (size_t)bn * C + c) : make_float2(0.f, 0.f);"""
BATCHED_EPI1 = """#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float2 it[kNi][2], jt[kNi][2], wd[kNi][2];
      for_each_elem([&](int r, int c, int mi, int ni, int q) {
        if (mi != half || (q & 1)) return;
        const int prow = max(pt.row[r], 0), bn = bin[r];
        it[ni][q >> 1] = ld2(i_term + (size_t)prow * C + c);
        jt[ni][q >> 1] = ld2(j_term + (size_t)pt.col[r] * C + c);
        wd[ni][q >> 1] = bn >= 0 ? ld2(w_dist + (size_t)bn * C + c) : make_float2(0.f, 0.f);
      });
      for_each_elem([&](int r, int c, int mi, int ni, int q) {
        if (mi != half || (q & 1)) return;
        const bool has_bin = bin[r] >= 0;
        const float2 a = it[ni][q >> 1], b = jt[ni][q >> 1], w = wd[ni][q >> 1], bb = ld2(b0 + c);
        const float v0 = emb_y0<T>(acc[mi][ni][q], has_bin, w.x, a.x, b.x, bb.x);
        const float v1 = emb_y0<T>(acc[mi][ni][q + 1], has_bin, w.y, a.y, b.y, bb.y);
        X[r * L::LDX + c] = v0;
        X[r * L::LDX + c + 1] = v1;
        if (STORE) store_relu_bits(keep.m0, 0, mi, ni, q, v0, v1);
      });
    }
"""
PLAIN_EPI1 = """    for_each_elem([&](int r, int c, int mi, int ni, int q) {
      if (q & 1) return;
      const int prow = max(pt.row[r], 0), pcol = pt.col[r], bn = bin[r];
      const float2 it = ld2(i_term + (size_t)prow * C + c);
      const float2 jt = ld2(j_term + (size_t)pcol * C + c);
      const float2 bb = ld2(b0 + c);
      const float2 w = bn >= 0 ? ld2(w_dist + (size_t)bn * C + c) : make_float2(0.f, 0.f);
      const float v0 = emb_y0<T>(acc[mi][ni][q], bn >= 0, w.x, it.x, jt.x, bb.x);
      const float v1 = emb_y0<T>(acc[mi][ni][q + 1], bn >= 0, w.y, it.y, jt.y, bb.y);
      X[r * L::LDX + c] = v0;
      X[r * L::LDX + c + 1] = v1;
      if (STORE) store_relu_bits(keep.m0, 0, mi, ni, q, v0, v1);
    });
"""
MMA3 = """          mma_tf32(part[mi][ni], alo[mi], bhi);
          mma_tf32(part[mi][ni], ahi[mi], blo);
          mma_tf32(part[mi][ni], ahi[mi], bhi);
"""
MMA_BF16 = """          mma_bf16(acc[mi][2 * np], a[mi], b[0], b[1]);
          mma_bf16(acc[mi][2 * np + 1], a[mi], b[2], b[3]);
"""
# 128-pair tiles: 16 warps, four down the rows.
TILE128 = {
    "common.cuh": [("constexpr int kThreads = 256;", "constexpr int kThreads = 512;"),
                   ("constexpr int kRows = 64;", "constexpr int kRows = 128;")],
    TC: [
        ("constexpr int kBlock = 2 * kColWarps * 32;", "constexpr int kBlock = 4 * kColWarps * 32;"),
        ("((warp & 1) * 32 + (lane & 15)) * lda", "((warp & 3) * 32 + (lane & 15)) * lda"),
        ("t * kLdw + (warp >> 1) * kWarpCols + g;", "t * kLdw + (warp >> 2) * kWarpCols + g;"),
        ("A + ((warp & 1) * 32 + g) * lda", "A + ((warp & 3) * 32 + g) * lda"),
        ("kLdw + (warp >> 1) * kWarpCols + (lane >> 4) * 8;",
         "kLdw + (warp >> 2) * kWarpCols + (lane >> 4) * 8;"),
        ("  static_assert(WeightStream<__nv_bfloat16, Map, STAGES>::kCopies == kKc / 16,\n"
         "                \"one copy a k step\");\n", ""),
        ("      ws.copy(s + STAGES - 1, kk / 16);",
         "      if (kk / 16 < WeightStream<__nv_bfloat16, Map, STAGES>::kCopies)\n"
         "        ws.copy(s + STAGES - 1, kk / 16);"),
        ("r0 = (warp & 1) * 32 + (lane >> 2), c0 = (warp >> 1) * kWarpCols",
         "r0 = (warp & 3) * 32 + (lane >> 2), c0 = (warp >> 2) * kWarpCols"),
    ],
}
STAGES = "template <typename T> constexpr int kEmbStages = sizeof(T) == 4 ? 2 : 3;"
EMB_WG = "edge_embedder_wg.cu"
EMB_WGH = "edge_embedder_wg.cuh"  # the unit's code, shared with the float32 backward's kernel A
WG_MMA3 = """        wg::wgmma_m64n128k8_tf32(d, lo[kk], bh, kk > 0);
        wg::wgmma_m64n128k8_tf32(d, hi[kk], bl, 1);
        wg::wgmma_m64n128k8_tf32(d, hi[kk], bh, 1);
"""
WG_MMA3_64 = WG_MMA3.replace("m64n128k8", "m64n64k8")
WG_SLICE_LOADS = """      wg::mbar_arrive_expect_tx(&sm.full[st], 2 * lo_row * 32 * 4);
      wg::tma_load_2d(sm.hi[st], map, &sm.full[st], c_in, 0);
      wg::tma_load_2d(sm.lo[st], map, &sm.full[st], c_in, lo_row);
"""
WG_STORE = "      __stcs(reinterpret_cast<float2*>(out + ((size_t)un.prow * Nc + j[e]) * C + c),"
WG_STAGES = "  if (smem_bytes<3, false>(n_bins) <= kSmemLimit) return launch_kernel<3>(FDK_ARGS);\n"
WG_EPI1 = """    const float v0 = emb_y0<float>(acc[i], bn >= 0, wd.x, iv.x, jt.x, bb.x);
    const float v1 = emb_y0<float>(acc[i + 1], bn >= 0, wd.y, iv.y, jt.y, bb.y);
"""
# A second block of A fragments, loaded while the previous block's products
# run (a hook between the slice's commit and its wait).
WG_DOUBLE_BUFFER = [
    ("""  template <bool FIRST, int NA>
  __device__ __forceinline__ void slice(uint32_t (&hi)[4][4], uint32_t (&lo)[4][4],
                                        float (&acc)[NA]) {""",
     """  template <bool FIRST, typename Next, int NA>
  __device__ __forceinline__ void slice(uint32_t (&hi)[4][4], uint32_t (&lo)[4][4],
                                        float (&acc)[NA], Next next) {"""),
    ("    wg::wgmma_commit();\n    wg::wgmma_wait<0>();",
     "    wg::wgmma_commit();\n    next();\n    wg::wgmma_wait<0>();"),
    ("""    uint32_t hi[4][4], lo[4][4];
    load(0, hi, lo);
    slice<true>(hi, lo, acc);
#pragma unroll 1
    for (int ks = 1; ks < KS; ++ks) {
      load(ks, hi, lo);
      slice<false>(hi, lo, acc);
    }""",
     """    uint32_t xh[4][4], xl[4][4], yh[4][4], yl[4][4];
    load(0, xh, xl);
    slice<true>(xh, xl, acc, [&] { load(1, yh, yl); });
#pragma unroll 1
    for (int ks = 1; ks + 1 < KS; ks += 2) {
      slice<false>(yh, yl, acc, [&] { load(ks + 1, xh, xl); });
      slice<false>(xh, xl, acc, [&] { load(ks + 2, yh, yl); });
    }
    slice<false>(yh, yl, acc, [] {});"""),
]
WG_REGS = [("    wg::setmaxnreg_dec<40>();", "    wg::setmaxnreg_dec<24>();"),
           ("    wg::setmaxnreg_inc<232>();", "    wg::setmaxnreg_inc<240>();")]
# The float32 embedder backward's kernel A (edge_embedder_bwd_wg.cu, on the
# forward's unit in edge_embedder_wg.cuh). name: (patches, checked against
# the plain version): three ring stages (they fit up to 24 bins; checked at
# 22 and 0), the relu decisions kept in registers for the chain (in place
# of shared memory); one part removed at a time: the products (the
# slices still stream), the workspace stores (the store warp still takes
# each region over; dm not stored), the chain (its slices, products and
# epilogues' inputs: the epilogues mask stale values), the partial sums
# (d_b1, d_b2, d_ln_scale, d_ln_bias, d_w_dist).
EMB_BWD_WG = "edge_embedder_bwd_wg.cu"
EMB_BWD_CHAIN = "    ring.template product<kLayerSlices>(act, acc);\n"
EMB_BWD_VARIANTS = {
    "emb_bwd_three_stages": ({EMB_BWD_WG: [("constexpr int kStages = 2;",
                                             "constexpr int kStages = 3;")]}, True),
    "emb_bwd_relu_in_registers": ({EMB_BWD_WG: [
        ("masked_store(A, acc, {bw.relu[w][1][0][tc], bw.relu[w][1][1][tc]});",
         "masked_store(A, acc, hk.m1);"),
        ("masked_store(A, acc, {bw.relu[w][0][0][tc], bw.relu[w][0][1][tc]});",
         "masked_store(A, acc, hk.m0);")]}, True),
    "emb_bwd_no_products": ({EMB_WGH: [(WG_MMA3, ""), (WG_MMA3_64, "")]}, False),
    "emb_bwd_no_stores": ({EMB_BWD_WG: [
        ("for (int idx = h; idx < cols[w] * (CP / 4); idx += 32 * kStoreWarps)",
         "for (int idx = h; idx < 0; idx += 32 * kStoreWarps)"),
        ("          __stcs(reinterpret_cast<float4*>(rows + r * C), v);",
         "          if (r < 0) __stcs(reinterpret_cast<float4*>(rows + r * C), v);"),
        ("      if (ok[e])\n        __stcs(", "      if (ok[e] && a.n_bins < 0)\n        __stcs(")]},
        False),
    "emb_bwd_no_chain": ({EMB_WGH: [("    if (BWD) slices(kTileSlices, kTileSlices + kChainSlices);\n",
                                     "")],
                          EMB_BWD_WG: [(EMB_BWD_CHAIN, ""),
                                       ("    ring.template product<kLayerSlices>(act, dm);\n",
                                        "    for (int i = 0; i < 32; ++i) dm[i] = acc[i];\n")]},
                         False),
    "emb_bwd_no_partials": ({EMB_BWD_WG: [
        ("    warp_columns([&](int i) { return gv[i] * acc[i]; }, bw.red[w][warp][0]);", ""),
        ("    warp_columns([&](int i) { return gv[i]; }, bw.red[w][warp][1]);", ""),
        ("    if (valid) {\n      float* vp", "    if (a.n_bins < 0) {\n      float* vp"),
        ("        if (i == 2 || i == 3) {", "        if (i < 0) {"),
        ("        if (i == 4 && cols[w]) {", "        if (i < 0) {")]}, False),
}
# The float32 pair-MLP backward's kernel A (pair_mlp_bwd_wg.cu, on the
# forward's tile code in pair_mlp_wg.cuh).
BWD_WG = "pair_mlp_bwd_wg.cu"
BWD_MASKS = "constexpr bool kMasksInRegisters = true;"
BWD_MMA3 = """      wg::wgmma_m64n64k8_tf32(part, lo[kk], bh, kk > 0);
      wg::wgmma_m64n64k8_tf32(part, hi[kk], bl, 1);
      wg::wgmma_m64n64k8_tf32(part, hi[kk], bh, 1);
"""
# No workspace stores (the store warps still take each region over).
BWD_NO_STORES = [("idx < rows * per_row; idx += 96)", "idx < rows * per_row && ld < 0; idx += 96)"),
                 ("    if (pt.row[r] < 0) continue;\n    const float4 v =",
                  "    if (pt.row[r] < 0 || ld > 0) continue;\n    const float4 v =")]
BWD_LN = "    layer_norm_backward(sm, pt, "
BWD_PICKS = [("uint32_t m = kMasksInRegisters ? pick(h.m1, cb) : 0u;", "uint32_t m = ~0u;"),
             ("uint32_t m = kMasksInRegisters ? pick(h.m0, hc) : 0u;", "uint32_t m = ~0u;"),
             ("    if (kMasksInRegisters) put(m0, cb,", "    if (cb < 0) put(m0, cb,"),
             ("    if (kMasksInRegisters) put(m1, hc,", "    if (hc < 0) put(m1, hc,")]
# The weight slices not loaded (the full barriers arrive at once).
BWD_NO_TMA = [("""        wg::mbar_arrive_expect_tx(&sm.full[st], 2 * kSliceBytes);
        wg::tma_load_2d(sm.hi[st], map, &sm.full[st], c_in, c_out);
        wg::tma_load_2d(sm.lo[st], map, &sm.full[st], c_in, c_lo);
""", "        wg::mbar_arrive(&sm.full[st]);\n")]
# Two consumer warpgroups and one producer warp, no setmaxnreg: ptxas may
# then give every thread 224 registers (65,536 / 288), not 168; the
# consumers store the workspace themselves (no store warps).
BWD_STORE_WARPS = "constexpr bool kStoreWarps = true;"
BWD_288 = [(BWD_STORE_WARPS, BWD_STORE_WARPS.replace("true", "false")),
           ("__global__ void __launch_bounds__(kBlockWG, 1)\nbwd_tile_kernel",
            "__global__ void __launch_bounds__(kConsumers + 32, 1)\nbwd_tile_kernel"),
           ("    wg::setmaxnreg_dec<40>();\n", ""), ("    wg::setmaxnreg_inc<232>();\n", ""),
           ("kBlockWG, kSmemBytes, stream>>>(\n      maps, a);",
            "kConsumers + 32, kSmemBytes, stream>>>(\n      maps, a);")]
# name: (patches, checked against the plain version): the relu decisions
# read back from the workspace; the workspace stored by the consumers themselves,
# between the products; 288 threads (and without stores); no products (the
# slices still stream); no workspace stores; no weight slices (and no
# stores); no LayerNorm backward (dx is X's old contents); no relu masks
# (neither recorded nor applied).
BWD_VARIANTS = {
    "bwd_mask_reload": ({BWD_WG: [(BWD_MASKS, BWD_MASKS.replace("true", "false"))]}, True),
    "bwd_consumer_stores": ({BWD_WG: [(BWD_STORE_WARPS, BWD_STORE_WARPS.replace("true",
                                                                                "false"))]},
                            True),
    "bwd_288_threads": ({BWD_WG: BWD_288}, True),
    "bwd_288_no_stores": ({BWD_WG: BWD_288 + BWD_NO_STORES}, False),
    "bwd_no_products": ({"pair_mlp_wg.cuh": [(BWD_MMA3, "")]}, False),
    "bwd_no_stores": ({BWD_WG: BWD_NO_STORES}, False),
    "bwd_no_weight_tma": ({"pair_mlp_wg.cuh": BWD_NO_TMA}, False),
    "bwd_no_weight_tma_no_stores": ({"pair_mlp_wg.cuh": BWD_NO_TMA, BWD_WG: BWD_NO_STORES}, False),
    "bwd_no_layernorm": ({BWD_WG: [(BWD_LN, "    if (a.Nr < 0) layer_norm_backward(sm, pt, ")]},
                         False),
    "bwd_no_relu_masks": ({BWD_WG: BWD_PICKS}, False),
}
# Float32 kernel B (wgrad_wg.cuh), built into both backwards' libraries.
WGRAD = "wgrad_wg.cuh"
WGRAD_A_T = "constexpr bool kWgradATransform = false;"
WGRAD_STAGES = "constexpr int kWgradStages = kWgradATransform ? 2 : 3;"
WGRAD_MMA3 = """      wg::wgmma_m64n128k8_tf32(part, lo[kk], bh, kk > 0);
      wg::wgmma_m64n128k8_tf32(part, hi[kk], bl, 1);
      wg::wgmma_m64n128k8_tf32(part, hi[kk], bh, 1);
"""
WGRAD_TRANSFORM = "        transpose_split(tl[kTB], tl[kTBhi], tl[kTBlo], 128, idx - 32);\n"
WGRAD_TMA = """        wg::mbar_arrive_expect_tx(&sm.full[st], bytes);
        for (int b = 0; b < jb.rows / 32; ++b)
          wg::tma_load_2d(sm.tile[st][kTA] + b * (kWgradStep * 32), am, &sm.full[st],
                          jb.a_col + 32 * b, row);
        for (int b = 0; b < 4; ++b)
          wg::tma_load_2d(sm.tile[st][kTB] + b * (kWgradStep * 32), bm, &sm.full[st],
                          jb.b_col + 32 * b, row);
"""
# name: (patches, checked against the plain version): A through the
# transform too (its hi and lo tiles read by wgmma from shared memory; two
# stages); two ring stages; one part removed at a time: the transform
# (Bm^T's tiles left as they are), the products, one TF32 product a k step
# in place of three, the TMA loads (the full barriers arrive at once); the
# transform and the products together.
WGRAD_NO_TMA = (WGRAD_TMA, "        wg::mbar_arrive(&sm.full[st]);\n")
WGRAD_VARIANTS = {
    "wgrad_a_transform": ({WGRAD: [(WGRAD_A_T, WGRAD_A_T.replace("false", "true"))]}, True),
    "wgrad_two_stages": ({WGRAD: [(WGRAD_STAGES, WGRAD_STAGES.replace("? 2 : 3", "? 2 : 2"))]},
                         True),
    "wgrad_no_transform": ({WGRAD: [(WGRAD_TRANSFORM, "")]}, False),
    "wgrad_no_products": ({WGRAD: [(WGRAD_MMA3, "")]}, False),
    "wgrad_one_tf32_product": ({WGRAD: [(WGRAD_MMA3, WGRAD_MMA3.split("\n", 2)[2])]}, False),
    "wgrad_no_tma": ({WGRAD: [WGRAD_NO_TMA]}, False),
    "wgrad_no_transform_no_products": ({WGRAD: [(WGRAD_TRANSFORM, ""), (WGRAD_MMA3, "")]}, False),
}
# The library each backward's float32 kernel B is built into, and its source.
WGRAD_LIBS = {"pair": ("pair_mlp_bwd_wg", BWD_WG), "emb": ("edge_embedder_bwd_wg", EMB_BWD_WG)}
# bf16 kernel B (wgrad_bf16.cuh), built into both bf16 backwards' libraries.
WGRAD_BF16 = "wgrad_bf16.cuh"
WB_STEP = "constexpr int kWbStep = 64;"
WB_STAGES = "constexpr int kWbStages = 4;"
WB_MMA = """#pragma unroll
  for (int kk = 0; kk < kWbStep / 16; ++kk)
    wgmma_m64n128k16_bf16_mn(part, wg::desc_mn_sw128(as + kk * 16 * 64, kWbBoxBytes),
                             wg::desc_mn_sw128(bs + kk * 16 * 64, kWbBoxBytes), kk > 0);
"""
WB_TMA = """        wg::mbar_arrive_expect_tx(&sm.full[st], bytes);
        for (int b = 0; b < jb.rows / 64; ++b)
          wg::tma_load_2d(sm.a[st][b], am, &sm.full[st], jb.a_col + 64 * b, row);
        for (int b = 0; b < 2; ++b)
          wg::tma_load_2d(sm.b[st][b], bm, &sm.full[st], jb.b_col + 64 * b, row);
"""
# Every block loads the rows of the launch's last job (128 rows of A) and of
# slice 0, so the blocks' 1.07 GB of reads (the pair MLP) come from 8 MB that
# stay in L2; each block still runs its own job's step count.
WB_L2_RESIDENT = [
    ("      const CUtensorMap* am = &jobs.map[jb.a_map];\n"
     "      const CUtensorMap* bm = &jobs.map[jb.b_map];",
     "      const WgradJob& lj = jobs.job[gridDim.x - 1];\n"
     "      const CUtensorMap* am = &jobs.map[lj.a_map];\n"
     "      const CUtensorMap* bm = &jobs.map[lj.b_map];"),
    ("const int row = (int)(k_begin + (long long)it * kWbStep);",
     "const int row = it * kWbStep;"),
    ("am, &sm.full[st], jb.a_col + 64 * b, row)", "am, &sm.full[st], lj.a_col + 64 * b, row)"),
    ("bm, &sm.full[st], jb.b_col + 64 * b, row)", "bm, &sm.full[st], lj.b_col + 64 * b, row)"),
]
# name: (patches, checked against the plain version): 32-pair steps; five
# and six ring stages; one part removed at a time: the products, the TMA
# loads (the full barriers arrive at once); every block on one job's rows
# held in L2 (does L2 or HBM feed the operands?).
WGRAD_BF16_VARIANTS = {
    "wgrad_bf16_step32": ({WGRAD_BF16: [(WB_STEP, WB_STEP.replace("64", "32"))]}, True),
    "wgrad_bf16_stages5": ({WGRAD_BF16: [(WB_STAGES, WB_STAGES.replace("4", "5"))]}, True),
    "wgrad_bf16_stages6": ({WGRAD_BF16: [(WB_STAGES, WB_STAGES.replace("4", "6"))]}, True),
    "wgrad_bf16_no_products": ({WGRAD_BF16: [(WB_MMA, "")]}, False),
    "wgrad_bf16_no_tma": ({WGRAD_BF16: [(WB_TMA, "        wg::mbar_arrive(&sm.full[st]);\n")]},
                          False),
    "wgrad_bf16_l2_resident": ({WGRAD_BF16: WB_L2_RESIDENT}, False),
}
WGRAD_BF16_LIBS = {"pair": ("pair_mlp_bwd_wg_bf16", "pair_mlp_bwd_wg_bf16.cu"),
                   "emb": ("edge_embedder_bwd", "edge_embedder_bwd.cu")}
# The pair-MLP backward's gradients in the wrapper's order.
PAIR_GRAD_NAMES = ("d_pair", "d_i_term", "d_j_term", "d_row_mask", "d_col_mask", "d_w0", "d_b0",
                   "d_w1", "d_b1", "d_wf", "d_bf", "d_ln_scale", "d_ln_bias", "d_fi", "d_fj",
                   "d_wfe")
# The gradients the embedder's kernel B makes, by index of its backward's
# outputs: d_w_rel, d_w1, d_w2.
EMB_KERNEL_B_GRADS = (8, 11, 13)
# Blocks allocated first (MB) in the placements over which bf16 kernel B is
# timed beside the parent's and torch.mm.
PLACEMENT_PADS_MB = (0, 1, 3, 17, 65, 257)
# name: (patches {file: [(old, new)]}, checked against the plain version);
# the mma.sync kernel's (edge_embedder.cu)
VARIANTS = {
    "bf16_two_stages": ({EMB_TC: [(STAGES, STAGES.replace("? 2 : 3", "? 2 : 2"))]}, True),
    "tile128": (TILE128, True),
    "unbatched_loads": ({EMB_TC: [(BATCHED_FILL, PLAIN_FILL), (BATCHED_EPI1, PLAIN_EPI1)]}, True),
    "no_products": ({TC: [(MMA3, ""), (MMA_BF16, "")]}, False),
    "no_layernorm_store": ({EMB: [
        ("  layer_norm_store<T>(et.X, L::LDX, *et.pt, p0, ln_scale, ln_bias, out);",
         "  if (n_bins == 12345) layer_norm_store<T>(et.X, L::LDX, *et.pt, p0, ln_scale, ln_bias, out);")]},
        False),
    "no_weight_stream": ({TC: [("    if (s >= total) return;",
                                "    if (s >= total || s >= STAGES - 1) return;")]}, False),
    "no_cp_fill": ({EMB_TC: [(BATCHED_FILL, "    const float gv = 0.5f;\n    for (int idx = tid; "
                           "idx < kRows * CP; idx += kBlock)\n      M[(idx / CP) * L::LDM + idx % CP] = gv;")]},
                   False),
    "no_layer1_terms": ({EMB_TC: [(EPI1_LOADS, "        it[ni][q >> 1] = make_float2(0.1f, 0.2f);\n"
                                "        jt[ni][q >> 1] = it[ni][q >> 1];\n"
                                "        wd[ni][q >> 1] = bn >= 0 ? it[ni][q >> 1] : make_float2(0.f, prow);")]},
                        False),
    "no_bins": ({EMB_TC: [("    bin[tid] = prow < 0 ? -1\n", "    bin[tid] = prow < 0 || n_bins > 0 ? -1\n")]},
                False),
}
# The wgmma kernel's (edge_embedder_wg.cu, float32): two ring stages at
# every n_bins; a second block of A fragments; 240 registers a consumer
# thread (24 the producer's); no products; one TF32 product a k step; no
# weight slices by TMA (the full barriers arrive at once); neither (the
# CUDA-core work and the barriers alone); layer 1's epilogue without its
# gathers and adds; the outputs not stored.
WG_NO_PRODUCTS = (WG_MMA3, "")
WG_NO_TMA = (WG_SLICE_LOADS, "      wg::mbar_arrive(&sm.full[st]);\n")
WG_VARIANTS = {
    "wg_two_stages": ({EMB_WG: [(WG_STAGES, "")]}, True),
    "wg_double_buffer": ({EMB_WGH: WG_DOUBLE_BUFFER}, True),
    "wg_regs_240": ({EMB_WG: WG_REGS}, True),
    "wg_no_products": ({EMB_WGH: [WG_NO_PRODUCTS]}, False),
    "wg_one_tf32_product": ({EMB_WGH: [(WG_MMA3, WG_MMA3.split("\n", 2)[2])]}, False),
    "wg_no_weight_tma": ({EMB_WGH: [WG_NO_TMA]}, False),
    "wg_no_products_no_tma": ({EMB_WGH: [WG_NO_PRODUCTS, WG_NO_TMA]}, False),
    "wg_bare_epilogue1": ({EMB_WGH: [(WG_EPI1, "    const float v0 = acc[i], v1 = acc[i + 1];\n")]},
                          False),
    "wg_no_store": ({EMB_WG: [(WG_STORE, "      if (Nc == -1) " + WG_STORE.lstrip())]}, False),
}


# The bf16 pair-MLP forward on wgmma (csrc/pair_mlp_wg_bf16.cu, tile code
# pair_mlp_wg_bf16.cuh): each product's slice loop rolled (ptxas then copies
# a second accumulator set through local memory), its ring one stage
# shorter (a fourth stage does not fit: 233,824 bytes of shared memory
# against 232,448), and one part removed
# at a time: the products, the epilogues' loads from device memory (i_term,
# j_term, fi, fj), the weights' TMA loads (the stage's barrier completed by
# a plain arrival).
FWD = "pair_mlp_wg_bf16.cu"
FWD_H = "pair_mlp_wg_bf16.cuh"
FWD_TMA = """      wg::mbar_arrive_expect_tx(&sm.full[st], 2 * kBoxBytes);
      wg::tma_load_2d(sm.w[st][0], map, &sm.full[st], col, row);
      wg::tma_load_2d(sm.w[st][1], map, &sm.full[st], col + 64, row);"""
FWD_MMA = "          wgmma_m64n128k16(acc, wg::desc_sw128(a + 16 * kk),"
FWD_NO_PRODUCTS = (FWD_MMA, FWD_MMA.replace("wgmma_m64n128k16(", "if (kk < 0) wgmma_m64n128k16("))
FWD_VARIANTS = {
    "fwd_rolled_slices": ({FWD_H: [("#pragma unroll\n    for (int s = 0; s < S; ++s) {",
                                    "#pragma unroll 1\n    for (int s = 0; s < S; ++s) {")]}, True),
    "fwd_two_stages": ({FWD_H: [("constexpr int kStages = 3;", "constexpr int kStages = 2;")]},
                       True),
    "fwd_no_products": ({FWD_H: [FWD_NO_PRODUCTS]}, False),
    "fwd_no_epilogue_loads": ({FWD_H: [
        ("        it[i / 2] = ld_pair(i_term + (size_t)max(pt.row[r], 0) * HID + c);",
         "        it[i / 2] = 0u;"),
        ("        jt[i / 2] = ld_pair(j_term + (size_t)pt.col[r] * HID + c);", "        jt[i / 2] = 0u;"),
        ("        fiv[i / 2] = ld_pair(fi + (size_t)max(pt.row[r], 0) * C_OUT + c);",
         "        fiv[i / 2] = 0u;"),
        ("        fjv[i / 2] = ld_pair(fj + (size_t)pt.col[r] * C_OUT + c);", "        fjv[i / 2] = 0u;")]},
        False),
    "fwd_no_weight_tma": ({FWD_H: [(FWD_TMA, "      (void)map;\n      wg::mbar_arrive(&sm.full[st]);")]},
                          False),
}
# The shapes the bf16 forward is timed at: the serving shape, the CLI's
# bucket, a de novo structure below one wave of tiles.
FWD_SHAPES = ((2, 256), (2, 896), (1, 100))
# The bf16 pair-MLP backward's kernel A on wgmma (csrc/pair_mlp_bwd_wg_bf16.cu,
# on the bf16 forward's tile): the relu decisions read back from the
# workspace in place of shared memory (BF16_BWD_MASKS_RELOAD); the workspace
# stored by TMA bulk stores from the store warps' lane 0 in place of their
# 16-byte stores (BF16_BWD_TMA_STORES); and one part removed at a time: the
# chain's products, every product, the workspace stores (the store warps
# still take each region over), the LayerNorm backward (dxd is X's old
# contents); and a build that reads its phases' cycles (BF16_BWD_TIMELINE).
BF16_BWD = "pair_mlp_bwd_wg_bf16.cu"
BF16_BWD_MASKS_GET = """  __device__ __forceinline__ void get(int which, int chunk, uint32_t (&m)[2]) const {
#pragma unroll
    for (int w = 0; w < 2; ++w) m[w] = bs.masks[(which * (HID / NC) + chunk) * 2 + w][threadIdx.x];
  }
"""
BF16_BWD_MASKS_RELOAD = [
    ("  uint32_t masks[kMaskWords][kConsumers];", "  uint32_t masks[1][kConsumers];"),
    ("void record(int which, int chunk, int i, float v0, float v1) {\n",
     "void record(int which, int chunk, int i, float v0, float v1) {\n    return;\n"),
    # The chunk's words from the values the store warps wrote to the
    # warpgroup's rows (plain loads: this block wrote them).
    (BF16_BWD_MASKS_GET, """  __device__ __forceinline__ void get(int which, int chunk, const bf16* rows,
                                      const PairTile& pt, uint32_t (&m)[2]) const {
    m[0] = m[1] = 0u;
    for_each_pair([&](int r, int c, int i) {
      if (pt.row[r] < 0) return;
      const int k = i >> 1;
      m[k >> 4] |= relu_pair(*reinterpret_cast<const uint32_t*>(rows + (size_t)r * HID + c)) >>
                   (15 - (k & 15));
    });
  }
"""),
    ("m.get(1, cb, mw);", "m.get(1, cb, a.ws.y1 + lp0 * HID + cb * NC, pt, mw);"),
    ("m.get(0, hc, mw);", "m.get(0, hc, a.ws.y0 + lp0 * HID + hc * NC, pt, mw);")]
BF16_BWD_TMA_STORES = {
    "wgmma_tma.cuh": [("__device__ __forceinline__ void prefetch_tensor_map(", """\
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(src)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ void prefetch_tensor_map(""")],
    BF16_BWD: [
        # The workspace arrays' tensor maps (boxes of 64 rows x 64 columns).
        ("  int Nr, Nc;\n};", "  int Nr, Nc;\n  CUtensorMap wsm[5];  // y0, y1, dy1, dy0, dxd\n};"),
        ("  const BwdArgs a{", "  BwdArgs a{"),
        (" tiles, Nr, Nc};\n", """ tiles, Nr, Nc};
  const bf16* arrays[5] = {ws.y0, ws.y1, ws.dy1, ws.dy0, ws.dxd};
  for (int i = 0; i < 5; ++i)
    if (!wg::bf16_sw128_map(&a.wsm[i], arrays[i], P, i < 4 ? HID : C_OUT, kHalf))
      return cudaErrorInvalidValue;
"""),
        # Lane 0 of store warp 0 issues the region's bulk stores; they have
        # read shared memory before the region is released.
        ("  // A row's 16-byte chunks lie side by side in device memory.\n", """\
  if (me == 0 && rows > 0) {
    for (int b = 0; b < blocks; ++b)
      wg::tma_store_2d(&a.wsm[arr], S + b * kBlock, c0 + 64 * b, (int)lp0);
    wg::bulk_commit();
    wg::bulk_wait_read();
  }
  if (me >= 0) return;
"""),
        ("      t0 = 0;\n    }\n  }\n}\n",
         "      t0 = 0;\n    }\n  }\n  if (w == 0 && lane == 0) wg::bulk_wait();  // the last stores done\n}\n")]}
BF16_BWD_CHAIN_MMA = ("          wgmma_m64n128k16_kb(acc, wg::desc_sw128(a + 16 * kk), "
                      "wg::desc_sw128(b + 16 * kk),")
BF16_BWD_NO_CHAIN_PRODUCTS = (BF16_BWD_CHAIN_MMA, BF16_BWD_CHAIN_MMA.replace(
    "wgmma_m64n128k16_kb(", "if (kk < 0) wgmma_m64n128k16_kb("))
# Kernel A's phases in cycles: clock64() read by thread 0 of each consumer
# warpgroup of block 0 after each phase of its first 16 tiles (a build of its
# own, timed apart), read back through a C entry of the patched copy.
BF16_BWD_PHASES = ("X loaded", "recompute", "LayerNorm backward", "dxd handed over",
                   "channel sums", "dy1", "dy1 handed over", "dy0 and W0^T", "Wfe^T, d_pair")
BF16_BWD_MARKS = ("    wg::mbar_wait(&sm.xfull, k & 1);\n",
                  "    forward_tile<RESIDUAL>(sm, ring, pt, a.i_term, a.j_term, a.fi, a.fj, h);\n",
                  "a.ws.dx + lp0 * C_OUT, a.ws.dem + lp0);\n",
                  "    ho.hand();            // dxd\n",
                  "    wg::bar_sync(1 + group, 128);  // the channel sums read: Y0 takes dy1\n",
                  "    tile_written(group);  // dy1 whole\n",
                  "    ho.hand();            // dy1 (dxd copied first)\n",
                  "      ring.product<NC, true>(sm.y1[0], acc_dp, hc == 0);\n    }\n",
                  "    wg::bar_sync(1 + group, 128);  // the tile's bookkeeping read\n")
BF16_BWD_TIMELINE = [(m, m + f"    PHASE_MARK({i + 1});\n") for i, m in enumerate(BF16_BWD_MARKS)] + [
    ("static_assert(kHalf == kRows,",
     "__device__ long long phase_clock[2][16][12];\n"
     "#define PHASE_MARK(i) do { if (blockIdx.x == 0 && (threadIdx.x & 127) == 0 && k < 16) "
     "phase_clock[group][k][i] = clock64(); } while (0)\nstatic_assert(kHalf == kRows,"),
    ("    wg::bar_sync(1 + group, 128);  // the warpgroup's bookkeeping\n",
     "    wg::bar_sync(1 + group, 128);  // the warpgroup's bookkeeping\n    PHASE_MARK(0);\n"),
    ("// C interface, for one chunk: rows m0",
     'extern "C" int fdk_phase_clock(void* out) {\n  return (int)cudaMemcpyFromSymbol('
     "out, fdk::wgb::phase_clock, sizeof(fdk::wgb::phase_clock));\n}\n\n"
     "// C interface, for one chunk: rows m0")]
BF16_BWD_VARIANTS = {
    "bf16_bwd_timeline": ({BF16_BWD: BF16_BWD_TIMELINE}, False),
    "bf16_bwd_masks_reload": ({BF16_BWD: BF16_BWD_MASKS_RELOAD}, True),
    "bf16_bwd_tma_stores": (BF16_BWD_TMA_STORES, True),
    "bf16_bwd_no_chain_products": ({FWD_H: [BF16_BWD_NO_CHAIN_PRODUCTS]}, False),
    "bf16_bwd_no_products": ({FWD_H: [BF16_BWD_NO_CHAIN_PRODUCTS, FWD_NO_PRODUCTS]}, False),
    "bf16_bwd_no_stores": ({BF16_BWD: [("per_row = 8 * blocks, n = rows * per_row;",
                                        "per_row = 8 * blocks, n = ld < 0 ? rows : 0;")]},
                           False),
    "bf16_bwd_no_layernorm": ({BF16_BWD: [("    layer_norm_backward(sm, group, pt, ",
                                           "    if (a.Nr < 0) layer_norm_backward(sm, group, pt, ")]},
                              False),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def patched_copy(root: pathlib.Path, name: str, patches: dict, source: str) -> pathlib.Path:
    from framedipt_tpu_torch.model.kernels import build

    d = root / name
    shutil.copytree(build.CSRC, d)
    for fname, pairs in patches.items():
        src = (d / fname).read_text()
        for old, new in pairs:
            if old not in src:
                raise RuntimeError(f"variant {name}: patch does not apply to {fname}: {old[:60]!r}")
            src = src.replace(old, new)
        (d / fname).write_text(src)
    return d / source


def parent_module(tree: pathlib.Path, name: str):
    """The parent tree's kernel wrapper module ``name`` (its imports resolve
    to this checkout's package, its libraries to what ``use`` installs)."""
    path = tree / "framedipt_tpu_torch" / "model" / "kernels" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"parent_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def time_beside_parent(cs, pmods, libs, new_libs, use, gen, keep: dict) -> dict:
    """This checkout's pair-MLP forward and backward and embedder forward
    (differentiated) and backward (float32, bf16) beside the parent's, B=2
    N=256, CUDA events over 20 calls, three rounds in alternating order; the
    backwards through each tree's own wrapper (``pmods``: the parent's),
    also by kernel A's and kernel B's device ms. The float32 embedder
    backward's inputs go to ``keep``."""
    from framedipt_tpu_torch.model.kernels import edge_embedder as t_emb
    from framedipt_tpu_torch.model.kernels import pair_mlp as t_pair

    # label: (this checkout's library kind, the parent's, this checkout's
    # call, the parent's call)
    cases = {}
    parent_pair = pmods["pair_mlp"]
    for dtype in (torch.float32, torch.bfloat16):
        a = cs.pair_mlp_inputs(2, 256, dtype, gen)
        g = torch.randn(2, 256, 256, 128, generator=gen, device="cuda").to(dtype)
        # The forward autograd differentiates: the wgmma kernels in both
        # trees.
        kind = parent_kind = "pair_mlp_wg" if dtype == torch.float32 else "pair_mlp_wg_bf16"
        cases[f"pair_mlp {str(dtype)[6:]}, differentiated"] = (
            kind, parent_kind, lambda a=a: t_pair.pair_mlp(*a),
            lambda a=a: parent_pair.pair_mlp(*a))
        # Each dtype's backward through its library (the parent's bf16 one
        # is pair_mlp_bwd.cu, kernel A on mma.sync).
        kind, parent_kind = (("pair_mlp_bwd_wg", "pair_mlp_bwd_wg") if dtype == torch.float32
                             else ("pair_mlp_bwd_wg_bf16", "pair_mlp_bwd"))
        cases[f"pair_mlp_bwd {str(dtype)[6:]}"] = (
            kind, parent_kind, lambda a=a, g=g: t_pair.pair_mlp_bwd(g, *a),
            lambda a=a, g=g: parent_pair.pair_mlp_bwd(g, *a))
    parent_emb = pmods["edge_embedder"]
    for dtype in (torch.float32, torch.bfloat16):
        args = cs.edge_embedder_inputs(2, 256, dtype, gen)
        *e, lower, upper = args
        g = torch.randn(2, 256, 256, 128, generator=gen, device="cuda").to(dtype)
        if dtype == torch.float32:
            # The forward autograd differentiates: the wgmma kernel (the
            # route of every float32 forward) in both trees.
            cases["edge_embedder float32, differentiated"] = (
                "edge_embedder_wg", "edge_embedder_wg",
                lambda a=args: t_emb.edge_embedder(*a),
                lambda a=args: parent_emb.edge_embedder(*a))
            keep["the parent comparison's inputs"] = (e, lower, upper, g)
        # Each dtype's backward through its library (float32: kernel A on
        # wgmma in both trees).
        kind = "edge_embedder_bwd_wg" if dtype == torch.float32 else "edge_embedder_bwd"
        cases[f"edge_embedder_bwd {str(dtype)[6:]}"] = (
            kind, kind,
            lambda e=e, g=g, lo=lower, up=upper: t_emb.edge_embedder_bwd(
                g, *e, bins_lower=lo, bins_upper=up),
            lambda e=e, g=g, lo=lower, up=upper: parent_emb.edge_embedder_bwd(
                g, *e, bins_lower=lo, bins_upper=up))
    times = {}
    for label, (kind, parent_kind, new_fn, parent_fn) in cases.items():
        t = {"new": [], "parent": []}
        for rnd in range(3):
            for who in (("new", "parent") if rnd % 2 == 0 else ("parent", "new")):
                if who == "new":
                    use(kind, new_libs[kind])
                else:
                    use(parent_kind, libs["parent" if parent_kind == "edge_embedder"
                                          else f"parent_{parent_kind}"])
                fn = new_fn if who == "new" else parent_fn
                t[who].append(cs.cuda_time_ms(fn, 20))
                if "_bwd" in kind:  # kernel A's and kernel B's device ms
                    # The parent's bf16 kernel B is the mma.sync wgrad_kernel.
                    parts = cs.bwd_parts_ms(fn, (cs.BWD_PARTS if kind.startswith("pair")
                                                 else cs.EMB_BWD_PARTS) + PARENT_PARTS)
                    t.setdefault(f"{who} kernel A", []).append(cs.part_ms(parts, "A", who))
                    t.setdefault(f"{who} kernel B", []).append(cs.part_ms(parts, "B", who))
        use(kind, new_libs[kind])
        if parent_kind != kind and parent_kind in new_libs:
            use(parent_kind, new_libs[parent_kind])
        log(f"{label} B=2 N=256: " + "; ".join(
            f"{'this checkout' if who.startswith('new') else 'the parent'}"
            f"{who[who.find(' '):] if ' ' in who else ''} " + ", ".join(f"{x:.4f}" for x in xs)
            + " ms" for who, xs in t.items()))
        times[label] = t
    return times


def pair_bwd_check(cs, label: str, a, g, **kw) -> bool:
    """The pair-MLP backward on ``a``, ``g`` (``kw``: the wrapper's keywords)
    against the plain version through its recompute's relu decisions (the
    dtype's tolerance of each gradient's max-abs), two launches
    bit-identical, the recompute equal to the forward autograd
    differentiates; logs one line, returns whether it passed."""
    from framedipt_tpu_torch.model.kernels import pair_mlp as t_pair

    rec = {}
    got = t_pair.pair_mlp_bwd(g, *a, recompute=rec, **kw)
    again = t_pair.pair_mlp_bwd(g, *a, **kw)
    ref = t_pair.pair_mlp_bwd_plain(g, *a, relu_masks=(rec["y0"] > 0, rec["y1"] > 0))
    rel, err = cs.grad_errors(got, ref, label)
    same = all(x is None or torch.equal(x, y) for x, y in zip(got, again))
    fwd = torch.equal(rec["out"], t_pair.pair_mlp(*a))
    tol = cs.TOL[a[0].dtype]
    log(f"{label}: max err {err:.3e} abs, {rel:.3e} of the gradient's max-abs (tol {tol}), "
        f"two launches bit-identical: {same}, recompute equal to the forward: {fwd}")
    return rel <= tol and same and fwd


def emb_bwd_check(cs, label: str, tensors, lower, upper, g) -> bool:
    """The embedder backward against the plain version through its
    recompute's relu decisions (the dtype's tolerance of each gradient's
    max-abs), two launches bit-identical; logs one line, returns whether it
    passed."""
    from framedipt_tpu_torch.model.kernels import edge_embedder as t_emb

    kw = {"bins_lower": lower, "bins_upper": upper}
    rec = {}
    got = t_emb.edge_embedder_bwd(g, *tensors, recompute=rec, **kw)
    again = t_emb.edge_embedder_bwd(g, *tensors, **kw)
    ref = t_emb.edge_embedder_bwd_plain(g, *tensors, **kw,
                                        relu_masks=(rec["y0"] > 0, rec["y1"] > 0))
    rel, err = cs.grad_errors(got, ref, label)
    same = all(x is None or torch.equal(x, y) for x, y in zip(got, again))
    tol = cs.TOL[tensors[0].dtype]
    log(f"{label}: max err {err:.3e} abs, {rel:.3e} of the gradient's max-abs (tol {tol}), "
        f"two launches bit-identical: {same}")
    return rel <= tol and same


def wgrad_checks(cs, name: str, site: str, gen, dtype=torch.float32) -> int:
    """A kernel B variant that should still be right (``name``, built into
    ``site``'s library of ``dtype`` and in use) held through its backward
    against the plain version, and in bf16 at the pair MLP's site also alone
    (``wgrad_bf16``) against float64 at a ragged 80,000-pair chunk and the
    64-row job, 1e-4 of the max-abs; returns the failures."""
    from framedipt_tpu_torch.model.kernels import wgrad as t_wgrad

    fails = 0
    d = str(dtype)[6:]
    if site == "pair":
        for B, N in ((1, 1), (1, 17), (2, 200)):
            for residual in (True, False):
                a = cs.pair_mlp_inputs(B, N, dtype, gen, residual=residual)
                g = torch.randn(B, N, N, 128, generator=gen, device="cuda").to(dtype)
                fails += not pair_bwd_check(
                    cs, f"{name} {d} B={B} N={N} residual={residual}", a, g)
        if dtype == torch.float32:
            return fails
        for P, M, N, slices in ((80_000, 384, 384, 8), (5_000, 64, 128, 44)):
            a = torch.randn(P, M, generator=gen, device="cuda").to(dtype)
            b = torch.randn(P, N, generator=gen, device="cuda").to(dtype)
            ref = a.double().t() @ b.double()
            err = float((t_wgrad.wgrad_bf16(a, b, slices).double() - ref).abs().max())
            rel = err / float(ref.abs().max())
            log(f"{name} wgrad_bf16 P={P} M={M} N={N} slices={slices}: {rel:.3e} of the "
                "product's max-abs against float64 (tol 1e-4)")
            fails += rel > 1e-4
    else:
        for B, N in ((1, 1), (1, 17), (2, 200)):
            for n_bins in (22, 0):
                *tensors, lower, upper = cs.edge_embedder_inputs(B, N, dtype, gen, n_bins=n_bins)
                g = torch.randn(B, N, N, 128, generator=gen, device="cuda").to(dtype)
                fails += not emb_bwd_check(cs, f"{name} {d} B={B} N={N} n_bins={n_bins}",
                                           tensors, lower, upper, g)
    return fails


def time_wgrad_variants(cs, libs, names, site: str, use, gen, dtype=torch.float32) -> dict:
    """Kernel B's device ms (torch.profiler) and the whole call's ms (CUDA
    events over 10 calls) of the ``dtype`` backward of ``site`` ("pair": the
    pair MLP, "emb": the embedder) at B=2 N=256 through each library in
    ``names`` (this checkout's first), three rounds in alternating order."""
    from framedipt_tpu_torch.model.kernels import edge_embedder as t_emb
    from framedipt_tpu_torch.model.kernels import pair_mlp as t_pair

    lib_name = (WGRAD_LIBS if dtype == torch.float32 else WGRAD_BF16_LIBS)[site][0]
    if site == "pair":
        a = cs.pair_mlp_inputs(2, 256, dtype, gen)
        g = torch.randn(2, 256, 256, 128, generator=gen, device="cuda").to(dtype)
        fn, kinds = (lambda: t_pair.pair_mlp_bwd(g, *a)), cs.BWD_PARTS
    else:
        *e, lower, upper = cs.edge_embedder_inputs(2, 256, dtype, gen)
        g = torch.randn(2, 256, 256, 128, generator=gen, device="cuda").to(dtype)
        fn = lambda: t_emb.edge_embedder_bwd(g, *e, bins_lower=lower, bins_upper=upper)  # noqa: E731
        kinds = cs.EMB_BWD_PARTS
    t = {n: {"call": [], "B": []} for n in names}
    for rnd in range(3):
        for name in (names if rnd % 2 == 0 else names[::-1]):
            use(lib_name, libs[name])
            t[name]["call"].append(cs.cuda_time_ms(fn, 10))
            t[name]["B"].append(cs.part_ms(cs.bwd_parts_ms(fn, kinds + PARENT_PARTS), "B", name))
    use(lib_name, libs[names[0]])
    for name in names:
        log(f"{name} {str(dtype)[6:]} {'pair_mlp_bwd' if site == 'pair' else 'edge_embedder_bwd'} "
            "B=2 N=256: call " + ", ".join(f"{x:.4f}" for x in t[name]["call"]) + " ms; kernel B "
            + ", ".join(f"{x:.4f}" for x in t[name]["B"]) + " ms")
    return t


def spread(xs) -> str:
    """median [min, max] of the readings xs."""
    v = sorted(xs)
    return f"median {v[len(v) // 2]:.4f} [{v[0]:.4f}, {v[-1]:.4f}] over {len(v)}"


def time_wgrad_bf16_placements(cs, libs, new_libs, use, gen, pmods) -> dict:
    """bf16 kernel B's device ms (torch.profiler, one call) inside each bf16
    backward at B=2 N=256 over the placements PLACEMENT_PADS_MB (torch's
    cache emptied, a block of that many MB allocated first, the inputs copied
    after it, so that the call's workspace lands elsewhere), three rounds a
    placement in alternating order: this checkout's kernel, with ``pmods``
    the parent's (its mma.sync kernel B through its own wrapper and library),
    and the same products as torch.mm calls in bf16 on arrays of the
    workspace's shapes placed likewise (``chip_smoke.wgrad_products``; device
    ms under torch.profiler, and CUDA events over 5 calls). Logs each
    placement's readings, then each one's median and spread."""
    from framedipt_tpu_torch.model.kernels import edge_embedder as t_emb
    from framedipt_tpu_torch.model.kernels import pair_mlp as t_pair

    pair_in = cs.pair_mlp_inputs(2, 256, torch.bfloat16, gen)
    emb_in = cs.edge_embedder_inputs(2, 256, torch.bfloat16, gen)
    g0 = torch.randn(2, 256, 256, 128, generator=gen, device="cuda").to(torch.bfloat16)
    old_kinds = {"pair": cs.BWD_PARTS + (("B", "wgrad_kernel"),),
                 "emb": cs.EMB_BWD_PARTS + (("B", "wgrad_kernel"),)}
    t = {}
    for pad_mb in PLACEMENT_PADS_MB:
        torch.cuda.empty_cache()
        pad = torch.empty(max(pad_mb << 20, 1), dtype=torch.uint8, device="cuda")
        a = [x.clone() if torch.is_tensor(x) else x for x in pair_in]
        *e, lo, up = [x.clone() if torch.is_tensor(x) else x for x in emb_in]
        g = g0.clone()
        mm = {site: cs.wgrad_products(lib, torch.bfloat16, gen)
              for site, lib in (("pair", "pair_mlp_bwd_wg_bf16"), ("emb", "edge_embedder_bwd"))}
        calls = {
            "this checkout pair": ("pair_mlp_bwd_wg_bf16", new_libs["pair_mlp_bwd_wg_bf16"],
                                   lambda: t_pair.pair_mlp_bwd(g, *a), cs.BWD_PARTS),
            "this checkout emb": ("edge_embedder_bwd", new_libs["edge_embedder_bwd"],
                                  lambda: t_emb.edge_embedder_bwd(g, *e, bins_lower=lo,
                                                                  bins_upper=up),
                                  cs.EMB_BWD_PARTS)}
        if pmods:
            calls["the parent pair"] = (
                "pair_mlp_bwd", libs["parent_pair_mlp_bwd"],
                lambda: pmods["pair_mlp"].pair_mlp_bwd(g, *a), old_kinds["pair"])
            calls["the parent emb"] = (
                "edge_embedder_bwd", libs["parent_edge_embedder_bwd"],
                lambda: pmods["edge_embedder"].edge_embedder_bwd(g, *e, bins_lower=lo,
                                                                 bins_upper=up),
                old_kinds["emb"])
        here = {}
        for rnd in range(3):
            for key in (list(calls) if rnd % 2 == 0 else list(calls)[::-1]):
                kind, lib, fn, kinds = calls[key]
                use(kind, lib)
                here.setdefault(key, []).append(
                    cs.part_ms(cs.bwd_parts_ms(fn, kinds + PARENT_PARTS), "B", key))
            for site, fn in mm.items():
                here.setdefault(f"torch.mm {site}", []).append(cs.device_time(fn)[0])
                here.setdefault(f"torch.mm {site} (events)", []).append(cs.cuda_time_ms(fn, 5))
        use("pair_mlp_bwd_wg_bf16", new_libs["pair_mlp_bwd_wg_bf16"])
        use("edge_embedder_bwd", new_libs["edge_embedder_bwd"])
        log(f"bf16 kernel B B=2 N=256, {pad_mb} MB allocated first: " + "; ".join(
            f"{k} " + ", ".join(f"{x:.4f}" for x in v) + " ms" for k, v in here.items()))
        for k, v in here.items():
            t.setdefault(k, []).extend(v)
        del pad, a, e, g, mm
    for k, v in t.items():
        log(f"bf16 kernel B B=2 N=256 over {len(PLACEMENT_PADS_MB)} placements, {k}: "
            f"{spread(v)} ms")
    return t


def time_emb_bwd_variants(cs, libs, names, use, gen, parent_fn=None) -> dict:
    """The float32 embedder backward at B=2 N=256 through each library in
    ``names`` (this checkout's "new_emb_bwd" and the variants), and with
    ``parent_fn`` the parent's float32 backward (its kernel A on mma.sync):
    CUDA events over 10 calls and kernel A's device ms (torch.profiler),
    three rounds in alternating order."""
    from framedipt_tpu_torch.model.kernels import edge_embedder as t_emb

    *e, lower, upper = cs.edge_embedder_inputs(2, 256, torch.float32, gen)
    g = torch.randn(2, 256, 256, 128, generator=gen, device="cuda")
    calls = {n: (lambda: t_emb.edge_embedder_bwd(g, *e, bins_lower=lower, bins_upper=upper))
             for n in names}
    if parent_fn is not None:
        calls["parent"] = lambda: parent_fn(g, *e, bins_lower=lower, bins_upper=upper)
    order = list(calls)
    t = {n: {"call": [], "A": []} for n in order}
    for rnd in range(3):
        for name in (order if rnd % 2 == 0 else order[::-1]):
            if name == "parent":
                use("edge_embedder_bwd", libs["parent_edge_embedder_bwd"])
            else:
                use("edge_embedder_bwd_wg", libs[name])
            t[name]["call"].append(cs.cuda_time_ms(calls[name], 10))
            t[name]["A"].append(cs.part_ms(cs.bwd_parts_ms(calls[name], cs.EMB_BWD_PARTS), "A", name))
    use("edge_embedder_bwd_wg", libs["new_emb_bwd"])
    for name in order:
        log(f"{name} float32 edge_embedder_bwd B=2 N=256: call "
            + ", ".join(f"{x:.4f}" for x in t[name]["call"]) + " ms; kernel A "
            + ", ".join(f"{x:.4f}" for x in t[name]["A"]) + " ms")
    return t


def time_emb_bwd_spread(cs, libs, names, use, extra: dict, draws: int = 6) -> dict:
    """Kernel A's device ms (torch.profiler) through each library in
    ``names``, float32 B=2 N=256, three rounds a condition in alternating
    order: ``draws`` input draws (seeds 1000 ..); the first draw's tensors
    copied to other addresses; the first draw with the workspace allocated
    anew after a block of 2, 64 or 256 MB (the allocator's cache emptied);
    and each of ``extra``'s inputs (label: (tensors, lower, upper, g)) as
    they are, copied, and with only the cotangent g or only the forward's
    inputs copied, or after a block of 256 KB or 1 MB (the call's own
    small buffers placed elsewhere). ``nvidia-smi`` samples the SM clock, the power
    draw and the temperature every 50 ms meanwhile: the spread of one
    reading and whether the values, the addresses or the clocks move it."""
    from framedipt_tpu_torch.model.kernels import edge_embedder as t_emb

    def copies(e, g):
        return [x.clone() if torch.is_tensor(x) else x for x in e], g.clone()

    def conditions():
        first = None
        for d in range(draws):
            gen = torch.Generator(device="cuda").manual_seed(1000 + d)
            *e, lower, upper = cs.edge_embedder_inputs(2, 256, torch.float32, gen)
            g = torch.randn(2, 256, 256, 128, generator=gen, device="cuda")
            first = first or (e, lower, upper, g)
            yield f"seed {1000 + d}", (e, lower, upper, g)
        e, lower, upper, g = first
        e2, g2 = copies(e, g)
        yield "seed 1000, copies", (e2, lower, upper, g2)
        for mb in (2, 64, 256):
            pad = torch.empty(mb << 20, dtype=torch.uint8, device="cuda")
            torch.cuda.empty_cache()
            yield f"seed 1000, workspace after {mb} MB", first
            del pad
        for label, (e, lower, upper, g) in extra.items():
            yield label, (e, lower, upper, g)
            e2, g2 = copies(e, g)
            yield f"{label}, copies", (e2, lower, upper, g2)
            yield f"{label}, the cotangent copied", (e, lower, upper, g2)
            yield f"{label}, the forward's inputs copied", (e2, lower, upper, g)
            del e2, g2
            for kb in (256, 1024):
                # The call's own small buffers (the weight splits, the bin
                # edges, the reductions) land elsewhere.
                pad = torch.empty(kb << 10, dtype=torch.uint8, device="cuda")
                yield f"{label}, after a {kb} KB block", (e, lower, upper, g)
                del pad

    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader,nounits", "-lms", "50"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    t = {n: {} for n in names}
    try:
        for label, (e, lower, upper, g) in conditions():
            for rnd in range(3):
                for name in (names if rnd % 2 == 0 else names[::-1]):
                    use("edge_embedder_bwd_wg", libs[name])
                    fn = (lambda e=e, g=g, lo=lower, up=upper: t_emb.edge_embedder_bwd(
                        g, *e, bins_lower=lo, bins_upper=up))
                    fn()
                    t[name].setdefault(label, []).append(
                        cs.part_ms(cs.bwd_parts_ms(fn, cs.EMB_BWD_PARTS), "A", name))
    finally:
        smi.terminate()
        samples = smi.communicate(timeout=30)[0]
    use("edge_embedder_bwd_wg", libs[names[0]])
    for name in names:
        every = sorted(x for xs in t[name].values() for x in xs)
        log(f"{name} kernel A spread float32 B=2 N=256: min {every[0]:.4f} median "
            f"{every[len(every) // 2]:.4f} max {every[-1]:.4f} ms over {len(every)}; "
            + "; ".join(f"{k} " + ", ".join(f"{x:.4f}" for x in xs)
                        for k, xs in t[name].items()))
    rows = [[float(v) for v in line.split(",")] for line in samples.splitlines()
            if line.count(",") == 2 and "N/A" not in line]
    clock = {}
    if rows:
        for i, key in enumerate(("sm_mhz", "power_w", "temp_c")):
            vals = sorted(r[i] for r in rows)
            clock[key] = [vals[0], vals[len(vals) // 2], vals[-1]]
        log(f"kernel A spread: {len(rows)} nvidia-smi samples, SM clock / power / temperature "
            "min, median, max: " + "; ".join(f"{k} {v}" for k, v in clock.items()))
    return {"A": t, "clock": clock}


def time_bwd_variants(cs, libs, names, use, gen) -> dict:
    """The float32 pair-MLP backward at B=2 N=256 through each library in
    ``names`` (this checkout's "new_bwd" and the variants): CUDA events over
    10 calls and kernel A's device ms (torch.profiler), three rounds in
    alternating order."""
    from framedipt_tpu_torch.model.kernels import pair_mlp as t_pair

    a = cs.pair_mlp_inputs(2, 256, torch.float32, gen)
    g = torch.randn(2, 256, 256, 128, generator=gen, device="cuda")
    t = {n: {"call": [], "A": []} for n in names}
    for rnd in range(3):
        for name in (names if rnd % 2 == 0 else names[::-1]):
            use("pair_mlp_bwd_wg", libs[name])
            t[name]["call"].append(cs.cuda_time_ms(lambda: t_pair.pair_mlp_bwd(g, *a), 10))
            t[name]["A"].append(cs.part_ms(
                cs.bwd_parts_ms(lambda: t_pair.pair_mlp_bwd(g, *a), cs.BWD_PARTS + PARENT_PARTS),
                "A", name))
    use("pair_mlp_bwd_wg", libs["new_bwd"])
    for name in names:
        log(f"{name} float32 B=2 N=256: call " + ", ".join(f"{x:.4f}" for x in t[name]["call"])
            + " ms; kernel A " + ", ".join(f"{x:.4f}" for x in t[name]["A"]) + " ms")
    return t


def fwd_checks(cs, name: str, gen, reference=None) -> int:
    """The bf16 forward through the library ``name`` stands in for against
    the plain version (5e-2 abs+rel) at B=1 N=1, B=1 N=17, B=2 N=200 and
    B=2 N=256 with and without the residual terms, two launches
    bit-identical, and, given ``reference`` (a function of the inputs), its
    bits equal to it; logs one line each, returns the failures."""
    from framedipt_tpu_torch.model.kernels import pair_mlp as t_pair

    fails = 0
    for B, N in ((1, 1), (1, 17), (2, 200), (2, 256)):
        for residual in (True, False):
            a = cs.pair_mlp_inputs(B, N, torch.bfloat16, gen, residual=residual)
            got = t_pair.pair_mlp(*a)
            err, excess = cs.max_violation(got, t_pair.pair_mlp_plain(*a), cs.TOL[torch.bfloat16])
            same = torch.equal(got, t_pair.pair_mlp(*a))
            line = (f"{name} bfloat16 B={B} N={N} residual={residual}: max_abs_err={err:.3e} "
                    f"(tol {cs.TOL[torch.bfloat16]} abs+rel), two launches bit-identical: {same}")
            ok = excess <= 0 and same
            if reference is not None:
                ref_same = torch.equal(got, reference(a))
                line += f", this checkout's bits {ref_same}"
                ok = ok and ref_same
            log(line)
            fails += not ok
    return fails


def time_fwd(cs, libs, names, use, gen, pmods) -> dict:
    """The bf16 forward at FWD_SHAPES (residual), CUDA events over 20
    launches, three rounds in alternating order: this checkout's kernel
    (``new_fwd``) and its variants (``names``) and, with ``pmods``, the
    parent's bf16 forward through its own wrapper and library."""
    from framedipt_tpu_torch.model.kernels import pair_mlp as t_pair

    times = {}
    for B, N in FWD_SHAPES:
        a = cs.pair_mlp_inputs(B, N, torch.bfloat16, gen)
        calls = {n: ("pair_mlp_wg_bf16", libs[n], lambda: t_pair.pair_mlp(*a)) for n in names}
        if pmods:
            calls["the parent's"] = ("pair_mlp_wg_bf16", libs["parent_pair_mlp_wg_bf16"],
                                     lambda: pmods["pair_mlp"].pair_mlp(*a))
        t = {k: [] for k in calls}
        for rnd in range(3):
            for key in (list(calls) if rnd % 2 == 0 else list(calls)[::-1]):
                kind, lib, fn = calls[key]
                use(kind, lib)
                t[key].append(cs.cuda_time_ms(fn, 20))
        use("pair_mlp_wg_bf16", libs["new_fwd"])
        flops, nbytes = cs.pair_mlp_cost(B, N, torch.bfloat16)
        bound_ms, by = cs.bound(flops, nbytes, cs.TENSOR_CORE_FLOPS[torch.bfloat16])
        for key, xs in t.items():
            log(f"bf16 pair-MLP forward B={B} N={N}, {key}: " + ", ".join(f"{x:.4f}" for x in xs)
                + f" ms (bound {bound_ms:.4f} ms, {by})")
        times[f"B={B} N={N}"] = t
    return times


def time_fwd_placements(cs, libs, use, gen, pmods) -> dict:
    """This checkout's bf16 forward (csrc/pair_mlp_wg_bf16.cu) and, with
    ``pmods``, the parent's at FWD_SHAPES over the placements PLACEMENT_PADS_MB (torch's cache
    emptied, a block of that many MB allocated first, the inputs copied
    after it), three rounds a placement in alternating order: device ms of
    one call (torch.profiler) and CUDA events over 20 calls. Logs each
    placement's readings, then each one's median and spread."""
    from framedipt_tpu_torch.model.kernels import pair_mlp as t_pair

    t = {}
    for B, N in FWD_SHAPES:
        inputs = cs.pair_mlp_inputs(B, N, torch.bfloat16, gen)
        for pad_mb in PLACEMENT_PADS_MB:
            torch.cuda.empty_cache()
            pad = torch.empty(max(pad_mb << 20, 1), dtype=torch.uint8, device="cuda")
            a = [x.clone() if torch.is_tensor(x) else x for x in inputs]
            calls = {"pair_mlp_wg_bf16": (libs["new_fwd"], lambda: t_pair.pair_mlp(*a))}
            if pmods:
                calls["the parent's"] = (libs["parent_pair_mlp_wg_bf16"],
                                         lambda: pmods["pair_mlp"].pair_mlp(*a))
            here = {}
            for rnd in range(3):
                for key in (list(calls) if rnd % 2 == 0 else list(calls)[::-1]):
                    use("pair_mlp_wg_bf16", calls[key][0])
                    fn = calls[key][1]
                    device = cs.device_time(fn)[0]
                    if device > 0:  # 0: the profiler recorded no device time this call
                        here.setdefault(f"{key} device", []).append(device)
                    here.setdefault(f"{key} events", []).append(cs.cuda_time_ms(fn, 20))
            log(f"bf16 pair-MLP forward B={B} N={N}, {pad_mb} MB allocated first: " + "; ".join(
                f"{k} " + ", ".join(f"{x:.4f}" for x in v) + " ms" for k, v in here.items()))
            for k, v in here.items():
                t.setdefault(f"B={B} N={N} {k}", []).extend(v)
            del pad, a
    use("pair_mlp_wg_bf16", libs["new_fwd"])
    for k, v in t.items():
        log(f"bf16 pair-MLP forward over {len(PLACEMENT_PADS_MB)} placements, {k}: {spread(v)} ms")
    return t


def bf16_bwd_checks(cs, name: str, gen) -> int:
    """The bf16 pair-MLP backward through the library ``name`` stands in for
    (in use) held by ``pair_bwd_check`` at B=1 N=1, B=1 N=17, B=2 N=200 and
    B=2 N=200 in 10 chunks, with and without the residual terms; returns
    the failures."""
    from framedipt_tpu_torch.model.kernels import pair_mlp as t_pair

    fails = 0
    for B, N, chunks in ((1, 1, None), (1, 17, None), (2, 200, None), (2, 200, 40)):
        for residual in (True, False):
            a = cs.pair_mlp_inputs(B, N, torch.bfloat16, gen, residual=residual)
            g = torch.randn(B, N, N, 128, generator=gen, device="cuda").to(torch.bfloat16)
            label = f"{name} bfloat16 B={B} N={N} residual={residual}"
            if chunks is None:
                fails += not pair_bwd_check(cs, label, a, g)
            else:
                cap = 4 * t_pair.split_workspace_floats(chunks * N, torch.bfloat16)
                fails += not pair_bwd_check(cs, label + f" in chunks of {chunks} rows", a, g,
                                            workspace_cap=cap)
    return fails


def time_bf16_bwd(cs, libs, names, use, gen) -> dict:
    """The bf16 pair-MLP backward at B=2 N=256 through each library in
    ``names`` (this checkout's "new_bf16_bwd" first, then its variants): kernel
    A's device ms (torch.profiler, one call) and the call's ms (CUDA events
    over 10 calls), three rounds in alternating order."""
    from framedipt_tpu_torch.model.kernels import pair_mlp as t_pair

    a = cs.pair_mlp_inputs(2, 256, torch.bfloat16, gen)
    g = torch.randn(2, 256, 256, 128, generator=gen, device="cuda").to(torch.bfloat16)
    t = {n: {"call": [], "A": []} for n in names}
    for rnd in range(3):
        for name in (names if rnd % 2 == 0 else names[::-1]):
            use("pair_mlp_bwd_wg_bf16", libs[name])
            t[name]["call"].append(cs.cuda_time_ms(lambda: t_pair.pair_mlp_bwd(g, *a), 10))
            t[name]["A"].append(cs.part_ms(
                cs.bwd_parts_ms(lambda: t_pair.pair_mlp_bwd(g, *a), cs.BWD_PARTS + PARENT_PARTS),
                "A", name))
    use("pair_mlp_bwd_wg_bf16", libs[names[0]])
    for name in names:
        log(f"{name} bf16 B=2 N=256: kernel A " + ", ".join(f"{x:.4f}" for x in t[name]["A"])
            + " ms; call " + ", ".join(f"{x:.4f}" for x in t[name]["call"]) + " ms")
    return t


def bf16_bwd_phases(cs, lib, use, gen) -> dict:
    """Kernel A's cycles by phase (BF16_BWD_PHASES) at B=2 N=256 from the
    ``bf16_bwd_timeline`` build ``lib``: the mean over block 0's first
    tiles (up to 16) and both consumer warpgroups, after three calls."""
    import numpy as np

    from framedipt_tpu_torch.model.kernels import pair_mlp as t_pair

    a = cs.pair_mlp_inputs(2, 256, torch.bfloat16, gen)
    g = torch.randn(2, 256, 256, 128, generator=gen, device="cuda").to(torch.bfloat16)
    use("pair_mlp_bwd_wg_bf16", lib)
    for _ in range(3):
        t_pair.pair_mlp_bwd(g, *a)
    torch.cuda.synchronize()
    clocks = np.zeros((2, 16, 12), np.int64)
    lib.fdk_phase_clock.argtypes = [ctypes.c_void_p]
    if lib.fdk_phase_clock(clocks.ctypes.data) != 0:
        raise RuntimeError("fdk_phase_clock failed")
    tiles = -(-2 * 256 * 256 // 128)
    seen = min(16, -(-tiles // torch.cuda.get_device_properties(0).multi_processor_count))
    d = np.diff(clocks[:, :seen, :len(BF16_BWD_PHASES) + 1], axis=-1).mean(axis=(0, 1))
    out = {name: float(x) for name, x in zip(BF16_BWD_PHASES, d)}
    log(f"bf16 kernel A B=2 N=256, cycles a tile by phase (block 0, {seen} tiles, both "
        "warpgroups): " + ", ".join(f"{k} {v:.0f}" for k, v in out.items())
        + f"; the tile {sum(out.values()):.0f}")
    return out


def time_bf16_bwd_placements(cs, libs, use, gen, pmods) -> dict:
    """bf16 kernel A's device ms (torch.profiler, one call) and the whole
    call's (CUDA events over 10 calls) at B=2 N=256 over the placements
    PLACEMENT_PADS_MB (torch's cache emptied, a block of that many MB
    allocated first, the inputs copied after it), three rounds a placement
    in alternating order: this checkout's kernel A and, with ``pmods``, the
    parent's (its mma.sync kernel A, pair_mlp_bwd.cu, through its own
    wrapper and library) in the same process. Logs each placement's
    readings, then each one's median and spread."""
    from framedipt_tpu_torch.model.kernels import pair_mlp as t_pair

    inputs = cs.pair_mlp_inputs(2, 256, torch.bfloat16, gen)
    g0 = torch.randn(2, 256, 256, 128, generator=gen, device="cuda").to(torch.bfloat16)
    t = {}
    for pad_mb in PLACEMENT_PADS_MB:
        torch.cuda.empty_cache()
        pad = torch.empty(max(pad_mb << 20, 1), dtype=torch.uint8, device="cuda")
        a = [x.clone() if torch.is_tensor(x) else x for x in inputs]
        g = g0.clone()
        calls = {"this checkout": ("pair_mlp_bwd_wg_bf16", libs["new_bf16_bwd"],
                                   lambda: t_pair.pair_mlp_bwd(g, *a))}
        if pmods:
            calls["the parent"] = ("pair_mlp_bwd", libs["parent_pair_mlp_bwd"],
                                   lambda: pmods["pair_mlp"].pair_mlp_bwd(g, *a))
        here = {}
        for rnd in range(3):
            for key in (list(calls) if rnd % 2 == 0 else list(calls)[::-1]):
                kind, lib, fn = calls[key]
                use(kind, lib)
                here.setdefault(f"{key} kernel A", []).append(
                    cs.part_ms(cs.bwd_parts_ms(fn, cs.BWD_PARTS + PARENT_PARTS), "A", key))
                here.setdefault(f"{key} call", []).append(cs.cuda_time_ms(fn, 10))
        log(f"bf16 pair-MLP backward B=2 N=256, {pad_mb} MB allocated first: " + "; ".join(
            f"{k} " + ", ".join(f"{x:.4f}" for x in v) + " ms" for k, v in here.items()))
        for k, v in here.items():
            t.setdefault(k, []).extend(v)
        del pad, a, g
    use("pair_mlp_bwd_wg_bf16", libs["new_bf16_bwd"])
    for k, v in t.items():
        log(f"bf16 pair-MLP backward B=2 N=256 over {len(PLACEMENT_PADS_MB)} placements, {k}: "
            f"{spread(v)} ms")
    return t


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=pathlib.Path, default=None)
    ap.add_argument("--out", type=pathlib.Path, default=None)
    ap.add_argument("--only", choices=("mma", "wgmma", "bwd", "emb_bwd", "wgrad", "bf16_fwd",
                                       "bf16_bwd"), default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        log("chip_variants: no CUDA device")
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from framedipt_tpu_torch.model.kernels import build
    from framedipt_tpu_torch.model.kernels import edge_embedder as t_emb
    from framedipt_tpu_torch.model.kernels import ipa_attention as t_ipa
    from framedipt_tpu_torch.model.kernels import pair_mlp as t_pair
    from framedipt_tpu_torch.model.kernels import wgrad as t_wgrad
    from framedipt_tpu_torch.tools.device import set_full_precision_matmul

    set_full_precision_matmul()
    # name: (library kind, checked, the call); "new" and "new_wg" are this
    # checkout's kernels.
    kinds = {"new": ("edge_embedder", True), "new_wg": ("edge_embedder_wg", True)}
    variants = {}
    if args.only in (None, "mma"):
        variants.update({n: (p, ok, "edge_embedder", EMB) for n, (p, ok) in VARIANTS.items()})
    if args.only in (None, "wgmma"):
        variants.update({n: (p, ok, "edge_embedder_wg", EMB_WG)
                         for n, (p, ok) in WG_VARIANTS.items()})
    if args.only in (None, "bwd"):
        variants.update({n: (p, ok, "pair_mlp_bwd_wg", BWD_WG)
                         for n, (p, ok) in BWD_VARIANTS.items()})
    if args.only in (None, "emb_bwd"):
        variants.update({n: (p, ok, "edge_embedder_bwd_wg", EMB_BWD_WG)
                         for n, (p, ok) in EMB_BWD_VARIANTS.items()})
    if args.only in (None, "wgrad"):
        for site, (_, source) in WGRAD_LIBS.items():
            variants.update({f"{n}_{site}": (p, ok, f"wgrad_{site}", source)
                             for n, (p, ok) in WGRAD_VARIANTS.items()})
        for site, (_, source) in WGRAD_BF16_LIBS.items():
            variants.update({f"{n}_{site}": (p, ok, f"wgrad_bf16_{site}", source)
                             for n, (p, ok) in WGRAD_BF16_VARIANTS.items()})
    if args.only in (None, "bf16_fwd"):
        variants.update({n: (p, ok, "pair_mlp_wg_bf16", FWD) for n, (p, ok) in FWD_VARIANTS.items()})
    if args.only in (None, "bf16_bwd"):
        variants.update({n: (p, ok, "pair_mlp_bwd_wg_bf16", BF16_BWD)
                         for n, (p, ok) in BF16_BWD_VARIANTS.items()})
    kinds.update({n: (kind, ok) for n, (_, ok, kind, _) in variants.items()})
    work = pathlib.Path(tempfile.mkdtemp(prefix="chip_variants_"))
    try:
        sources = {name: patched_copy(work, name, patches, source)
                   for name, (patches, _, _, source) in variants.items()}
        parent = None if args.parent is None else args.parent / "framedipt_tpu_torch" / "csrc"
        if parent is not None:
            # The parent's sources as it has them (an earlier tree may lack
            # some): its bf16 kernel A is pair_mlp_bwd.cu's.
            sources.update({k: v for k, v in {
                            "parent": parent / EMB,
                            "parent_pair_mlp_wg_bf16": parent / "pair_mlp_wg_bf16.cu",
                            "parent_pair_mlp_bwd": parent / "pair_mlp_bwd.cu",
                            "parent_pair_mlp_wg": parent / "pair_mlp_wg.cu",
                            "parent_pair_mlp_bwd_wg": parent / "pair_mlp_bwd_wg.cu",
                            "parent_edge_embedder_wg": parent / EMB_WG,
                            "parent_edge_embedder_bwd": parent / "edge_embedder_bwd.cu",
                            "parent_edge_embedder_bwd_wg": parent / "edge_embedder_bwd_wg.cu",
                            "parent_ipa_attention": parent / "ipa_attention.cu"}.items()
                            if v.exists()})
            kinds["parent"] = ("edge_embedder", False)
        procs = {name: subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(work / f"{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for name, src in sources.items()}
        build.build_all()
        if args.only in (None, "bf16_bwd"):  # this checkout's bf16 kernel A, as ptxas saw it
            for line in build.build_log.get("pair_mlp_bwd_wg_bf16", {}).get("log", "").splitlines():
                if "bf16_bwd_tile_kernel" in line or "spill" in line or "registers" in line:
                    log(f"  pair_mlp_bwd_wg_bf16: {line.strip()[:160]}")
        libs = {"new": build.library("edge_embedder"), "new_wg": build.library("edge_embedder_wg"),
                "new_bwd": build.library("pair_mlp_bwd_wg"),
                "new_emb_bwd": build.library("edge_embedder_bwd_wg"),
                "new_wgrad_pair": build.library("pair_mlp_bwd_wg"),
                "new_wgrad_emb": build.library("edge_embedder_bwd_wg"),
                "new_wgrad_bf16_pair": build.library("pair_mlp_bwd_wg_bf16"),
                "new_bf16_bwd": build.library("pair_mlp_bwd_wg_bf16"),
                "new_wgrad_bf16_emb": build.library("edge_embedder_bwd"),
                "new_fwd": build.library("pair_mlp_wg_bf16")}
        fails = 0
        for name, proc in procs.items():
            out = proc.communicate()[0]
            if proc.returncode:
                log(f"{name}: nvcc failed\n{out}")
                fails += 1
                continue
            libs[name] = ctypes.CDLL(str(work / f"{name}.so"))
            for line in out.splitlines():
                if "registers" in line or "spill" in line or "C7512" in line:
                    log(f"  {name}: {line.strip()[:160]}")
        new_libs = {n: build.library(n) for n in ("pair_mlp_wg_bf16", "pair_mlp_bwd_wg_bf16",
                                                  "pair_mlp_wg",
                                                  "pair_mlp_bwd_wg", "edge_embedder",
                                                  "edge_embedder_wg", "edge_embedder_bwd",
                                                  "edge_embedder_bwd_wg", "ipa_attention")}
        pmods = {} if parent is None else {
            n: parent_module(args.parent, n) for n in ("pair_mlp", "edge_embedder")}

        def use(kind: str, lib) -> None:
            build._libs[kind] = lib
            for mod in (t_emb, t_pair, t_wgrad, t_ipa, *pmods.values()):
                for entry in ("_kernel", "_wg_kernel", "_split_kernel", "_bwd_kernel",
                              "_bwd_wg_kernel", "_bf16_kernel", "_wg_bf16_kernel",
                              "_bwd_wg_bf16_kernel"):
                    if hasattr(mod, entry):
                        getattr(mod, entry).cache_clear()

        def call(name: str, a):
            """The embedder through the kernel ``name`` stands in for (the
            dtype picks it)."""
            return t_emb.edge_embedder(*a)

        def dtypes(name: str):
            return (torch.float32,) if kinds[name][0] == "edge_embedder_wg" else (torch.bfloat16,)

        gen = torch.Generator(device="cuda").manual_seed(0)
        bwd_names = [n for n, (kind, _) in kinds.items() if kind == "pair_mlp_bwd_wg" and n in libs]
        for name in [n for n in bwd_names if kinds[n][1]]:
            use("pair_mlp_bwd_wg", libs[name])
            for B, N in ((1, 1), (1, 17), (2, 200)):
                for residual in (True, False):
                    a = cs.pair_mlp_inputs(B, N, torch.float32, gen, residual=residual)
                    g = torch.randn(B, N, N, 128, generator=gen, device="cuda")
                    fails += not pair_bwd_check(
                        cs, f"{name} float32 B={B} N={N} residual={residual}", a, g)
            use("pair_mlp_bwd_wg", libs["new_bwd"])
        emb_bwd_names = [n for n, (kind, _) in kinds.items()
                         if kind == "edge_embedder_bwd_wg" and n in libs]
        for name in [n for n in emb_bwd_names if kinds[n][1]]:
            use("edge_embedder_bwd_wg", libs[name])
            for B, N in ((1, 1), (1, 17), (2, 200)):
                for n_bins in (22, 0):
                    *tensors, lower, upper = cs.edge_embedder_inputs(B, N, torch.float32, gen,
                                                                     n_bins=n_bins)
                    g = torch.randn(B, N, N, 128, generator=gen, device="cuda")
                    fails += not emb_bwd_check(cs, f"{name} float32 B={B} N={N} n_bins={n_bins}",
                                               tensors, lower, upper, g)
            use("edge_embedder_bwd_wg", libs["new_emb_bwd"])
        wgrad_names = {site: [n for n, (kind, _) in kinds.items() if kind == f"wgrad_{site}"
                              and n in libs] for site in WGRAD_LIBS}
        for site, names in wgrad_names.items():
            for name in [n for n in names if kinds[n][1]]:
                use(WGRAD_LIBS[site][0], libs[name])
                fails += wgrad_checks(cs, name, site, gen)
            use(WGRAD_LIBS[site][0], libs[f"new_wgrad_{site}"])
        wgrad_bf16_names = {site: [n for n, (kind, _) in kinds.items()
                                   if kind == f"wgrad_bf16_{site}" and n in libs]
                            for site in WGRAD_BF16_LIBS}
        for site, names in wgrad_bf16_names.items():
            for name in [n for n in names if kinds[n][1]]:
                use(WGRAD_BF16_LIBS[site][0], libs[name])
                fails += wgrad_checks(cs, name, site, gen, torch.bfloat16)
            use(WGRAD_BF16_LIBS[site][0], libs[f"new_wgrad_bf16_{site}"])
        fwd_names = [n for n, (kind, _) in kinds.items() if kind == "pair_mlp_wg_bf16" and n in libs]
        for name in [n for n in fwd_names if kinds[n][1]]:
            use("pair_mlp_wg_bf16", libs[name])
            fails += fwd_checks(cs, name, gen)
        use("pair_mlp_wg_bf16", libs["new_fwd"])
        if args.only in (None, "bf16_fwd"):
            fails += fwd_checks(cs, "pair_mlp_wg_bf16", gen)
        bf16_bwd_names = [n for n, (kind, _) in kinds.items()
                          if kind == "pair_mlp_bwd_wg_bf16" and n in libs]
        for name in [n for n in bf16_bwd_names if kinds[n][1]]:
            use("pair_mlp_bwd_wg_bf16", libs[name])
            fails += bf16_bwd_checks(cs, name, gen)
        use("pair_mlp_bwd_wg_bf16", libs["new_bf16_bwd"])
        if args.only in (None, "bf16_bwd"):
            fails += bf16_bwd_checks(cs, "pair_mlp_bwd_wg_bf16", gen)
        kinds = {n: v for n, v in kinds.items()
                 if v[0] not in ("pair_mlp_bwd_wg", "edge_embedder_bwd_wg", "pair_mlp_wg_bf16",
                                 "pair_mlp_bwd_wg_bf16")
                 and not v[0].startswith("wgrad_")}
        emb_only = {None: None, "mma": "edge_embedder", "wgmma": "edge_embedder_wg"}.get(args.only, "")
        checked = [n for n, (kind, ok) in kinds.items() if ok and n in libs
                   and emb_only in (None, kind)]
        for name in checked:
            use(kinds[name][0], libs[name])
            for dtype in dtypes(name):
                for B, N in ((1, 1), (1, 17), (2, 200), (2, 256)):
                    a = cs.edge_embedder_inputs(B, N, dtype, gen)
                    got = call(name, a)
                    err, excess = cs.max_violation(got, t_emb.edge_embedder_plain(*a), cs.TOL[dtype])
                    same = torch.equal(got, call(name, a))
                    log(f"{name} {str(dtype)[6:]} B={B} N={N}: max_abs_err={err:.3e} "
                        f"(tol {cs.TOL[dtype]} abs+rel), two launches bit-identical: {same}")
                    fails += excess > 0 or not same
            use(kinds[name][0], libs["new" if kinds[name][0] == "edge_embedder" else "new_wg"])
        if "parent" in libs:
            # The mma.sync forward is bf16's only now.
            for dtype in (torch.bfloat16,):
                for B, N in ((1, 1), (1, 17), (2, 200), (2, 256)):
                    for n_bins in (22, 0):
                        a = cs.edge_embedder_inputs(B, N, dtype, gen, n_bins=n_bins)
                        outs = []
                        for name in ("new", "parent"):
                            use("edge_embedder", libs[name])
                            outs.append(call(name, a))
                        same = torch.equal(*outs)
                        log(f"edge_embedder {str(dtype)[6:]} B={B} N={N} n_bins={n_bins}: the "
                            f"parent's bits {same}")
                        fails += not same
            use("edge_embedder", libs["new"])
        if "parent_pair_mlp_wg_bf16" in libs and "parent_pair_mlp_bwd" in libs:
            # bf16: this checkout's forward against the parent's (the same
            # kernel), and the backward (kernel A redesigned; the parent's is
            # pair_mlp_bwd.cu's): which gradients keep the parent's bits, and
            # this checkout's held against the plain version.
            for B, N, chunks in ((2, 200, None), (2, 200, 40), (2, 256, None)):
                for residual in (True, False):
                    a = cs.pair_mlp_inputs(B, N, torch.bfloat16, gen, residual=residual)
                    outs = []
                    for lib, wrapper in ((new_libs["pair_mlp_wg_bf16"], t_pair),
                                         (libs["parent_pair_mlp_wg_bf16"], pmods["pair_mlp"])):
                        use("pair_mlp_wg_bf16", lib)
                        outs.append(wrapper.pair_mlp(*a))
                    use("pair_mlp_wg_bf16", new_libs["pair_mlp_wg_bf16"])
                    same = torch.equal(*outs)
                    kw = ({} if chunks is None else {"workspace_cap": 4 * t_pair.split_workspace_floats(
                        chunks * N, torch.bfloat16)})
                    label = (f"pair_mlp bf16 B={B} N={N} residual={residual}"
                             + ("" if chunks is None else f" in chunks of {chunks} rows"))
                    g = torch.randn(B, N, N, 128, generator=gen, device="cuda").to(torch.bfloat16)
                    grads = []
                    for kind, lib, wrapper in (
                            ("pair_mlp_bwd_wg_bf16", new_libs["pair_mlp_bwd_wg_bf16"], t_pair),
                            ("pair_mlp_bwd", libs["parent_pair_mlp_bwd"], pmods["pair_mlp"])):
                        use(kind, lib)
                        grads.append(wrapper.pair_mlp_bwd(g, *a, **kw))
                    use("pair_mlp_bwd_wg_bf16", new_libs["pair_mlp_bwd_wg_bf16"])
                    kept = [PAIR_GRAD_NAMES[i] for i, (x, y) in enumerate(zip(*grads))
                            if x is not None and torch.equal(x, y)]
                    moved = [PAIR_GRAD_NAMES[i] for i, (x, y) in enumerate(zip(*grads))
                             if x is not None and not torch.equal(x, y)]
                    log(f"{label}: the forward's bits the parent's {same}; the backward's gradients "
                        f"with the parent's kernel A's bits: {', '.join(kept) or 'none'}; moved: "
                        f"{', '.join(moved) or 'none'}")
                    fails += not (same and pair_bwd_check(cs, f"pair_mlp_bwd {label}", a, g, **kw))
        if "parent_pair_mlp_bwd_wg" in libs:
            # float32: the same kernels as the parent's, held against the
            # plain version and against the parent's bits.
            for B, N in ((1, 17), (2, 200), (2, 256)):
                for residual in (True, False):
                    a = cs.pair_mlp_inputs(B, N, torch.float32, gen, residual=residual)
                    g = torch.randn(B, N, N, 128, generator=gen, device="cuda")
                    label = f"pair_mlp_bwd float32 B={B} N={N} residual={residual}"
                    fails += not pair_bwd_check(cs, label, a, g)
                    grads = []
                    for lib, wrapper in ((new_libs["pair_mlp_bwd_wg"], t_pair),
                                         (libs["parent_pair_mlp_bwd_wg"], pmods["pair_mlp"])):
                        use("pair_mlp_bwd_wg", lib)
                        grads.append(wrapper.pair_mlp_bwd(g, *a))
                    same = all(x is None or torch.equal(x, y) for x, y in zip(*grads))
                    log(f"{label}: the parent's bits {same}")
                    fails += not same
            use("pair_mlp_bwd_wg", new_libs["pair_mlp_bwd_wg"])
        if "parent_pair_mlp_wg" in libs:
            for B, N in ((1, 17), (2, 200)):
                for residual in (True, False):
                    a = cs.pair_mlp_inputs(B, N, torch.float32, gen, residual=residual)
                    outs = []
                    for lib in (new_libs["pair_mlp_wg"], libs["parent_pair_mlp_wg"]):
                        use("pair_mlp_wg", lib)
                        outs.append(t_pair.pair_mlp(*a))
                    same = torch.equal(*outs)
                    log(f"pair_mlp_wg float32 B={B} N={N} residual={residual}: the parent's "
                        f"bits {same}")
                    fails += not same
            use("pair_mlp_wg", new_libs["pair_mlp_wg"])
        if "parent_edge_embedder_wg" in libs:
            for B, N in ((1, 17), (2, 200), (2, 256)):
                for n_bins in (22, 0):
                    a = cs.edge_embedder_inputs(B, N, torch.float32, gen, n_bins=n_bins)
                    outs = []
                    for lib in (new_libs["edge_embedder_wg"], libs["parent_edge_embedder_wg"]):
                        use("edge_embedder_wg", lib)
                        outs.append(t_emb.edge_embedder(*a))
                    same = torch.equal(*outs)
                    log(f"edge_embedder_wg float32 B={B} N={N} n_bins={n_bins}: the parent's "
                        f"bits {same}")
                    fails += not same
            use("edge_embedder_wg", new_libs["edge_embedder_wg"])
        if "parent_ipa_attention" in libs:
            for dtype in (torch.float32, torch.bfloat16):
                for B, N in ((1, 17), (2, 256)):
                    a = cs.ipa_attention_inputs(B, N, dtype, gen)
                    outs = []
                    for lib in (new_libs["ipa_attention"], libs["parent_ipa_attention"]):
                        use("ipa_attention", lib)
                        outs.append(t_ipa.ipa_attention(*a, no_heads=cs.IPA_H,
                                                        no_v_points=cs.IPA_PV))
                    same = all(torch.equal(x, y) for x, y in zip(*outs))
                    log(f"ipa_attention {str(dtype)[6:]} B={B} N={N}: the parent's bits {same}")
                    fails += not same
            use("ipa_attention", new_libs["ipa_attention"])
        if "parent_edge_embedder_bwd_wg" in libs:
            # float32 (kernel A on wgmma in both trees): against the plain
            # version and the parent's bits.
            for B, N in ((1, 17), (2, 200), (2, 256)):
                for n_bins in (22, 0):
                    *tensors, lower, upper = cs.edge_embedder_inputs(B, N, torch.float32, gen,
                                                                     n_bins=n_bins)
                    g = torch.randn(B, N, N, 128, generator=gen, device="cuda")
                    label = f"edge_embedder_bwd float32 B={B} N={N} n_bins={n_bins}"
                    fails += not emb_bwd_check(cs, label, tensors, lower, upper, g)
                    grads = []
                    for lib, wrapper in ((new_libs["edge_embedder_bwd_wg"], t_emb),
                                         (libs["parent_edge_embedder_bwd_wg"],
                                          pmods["edge_embedder"])):
                        use("edge_embedder_bwd_wg", lib)
                        grads.append(wrapper.edge_embedder_bwd(g, *tensors, bins_lower=lower,
                                                               bins_upper=upper))
                    same = all(x is None or torch.equal(x, y) for x, y in zip(*grads))
                    log(f"{label}: the parent's bits {same}")
                    fails += not same
            use("edge_embedder_bwd_wg", new_libs["edge_embedder_bwd_wg"])
        if "parent_edge_embedder_bwd" in libs:
            for dtype in (torch.bfloat16,):
                for B, N in ((1, 1), (1, 17), (2, 200), (2, 256)):
                    for n_bins in (22, 0):
                        *tensors, lower, upper = cs.edge_embedder_inputs(B, N, dtype, gen,
                                                                         n_bins=n_bins)
                        g = torch.randn(B, N, N, 128, generator=gen, device="cuda").to(dtype)
                        grads = []
                        for lib, wrapper in ((new_libs["edge_embedder_bwd"], t_emb),
                                             (libs["parent_edge_embedder_bwd"],
                                              pmods["edge_embedder"])):
                            use("edge_embedder_bwd", lib)
                            grads.append(wrapper.edge_embedder_bwd(g, *tensors, bins_lower=lower,
                                                                   bins_upper=upper))
                        same = all(x is None or torch.equal(x, y) for i, (x, y)
                                   in enumerate(zip(*grads)) if i not in EMB_KERNEL_B_GRADS)
                        log(f"edge_embedder_bwd {str(dtype)[6:]} B={B} N={N} n_bins={n_bins}: "
                            f"the parent's bits in every gradient but kernel B's {same}")
                        use("edge_embedder_bwd", new_libs["edge_embedder_bwd"])
                        same = same and emb_bwd_check(
                            cs, f"edge_embedder_bwd {str(dtype)[6:]} B={B} N={N} n_bins={n_bins}",
                            tensors, lower, upper, g)
                        fails += not same
            use("edge_embedder_bwd", new_libs["edge_embedder_bwd"])
        times, kept = {}, {}
        if parent is not None:
            times["parent"] = time_beside_parent(cs, pmods, libs, new_libs, use, gen, kept)
        if bwd_names:
            times["pair_mlp_bwd float32 B=2 N=256"] = time_bwd_variants(
                cs, libs, ["new_bwd"] + bwd_names, use, gen)
        if emb_bwd_names:
            times["edge_embedder_bwd float32 B=2 N=256"] = time_emb_bwd_variants(
                cs, libs, ["new_emb_bwd"] + emb_bwd_names, use, gen,
                pmods["edge_embedder"].edge_embedder_bwd if pmods else None)
            if "emb_bwd_three_stages" in libs:
                times["edge_embedder_bwd kernel A spread"] = time_emb_bwd_spread(
                    cs, libs, ["new_emb_bwd", "emb_bwd_three_stages"], use, kept)
        for site, names in wgrad_names.items():
            if names:
                times[f"kernel B {site} float32 B=2 N=256"] = time_wgrad_variants(
                    cs, libs, [f"new_wgrad_{site}"] + names, site, use, gen)
        for site, names in wgrad_bf16_names.items():
            if names:
                times[f"kernel B {site} bf16 B=2 N=256"] = time_wgrad_variants(
                    cs, libs, [f"new_wgrad_bf16_{site}"] + names, site, use, gen, torch.bfloat16)
        if args.only in (None, "wgrad"):
            times["bf16 kernel B placements"] = time_wgrad_bf16_placements(
                cs, libs, new_libs, use, gen, pmods)
        if args.only in (None, "bf16_bwd"):
            if "bf16_bwd_timeline" in libs:
                times["bf16 kernel A phases"] = bf16_bwd_phases(cs, libs["bf16_bwd_timeline"], use,
                                                                gen)
            times["bf16 pair-MLP backward"] = time_bf16_bwd(
                cs, libs, ["new_bf16_bwd"] + [n for n in bf16_bwd_names
                                              if n != "bf16_bwd_timeline"], use, gen)
            times["bf16 pair-MLP backward placements"] = time_bf16_bwd_placements(
                cs, libs, use, gen, pmods)
        if args.only in (None, "bf16_fwd"):
            times["bf16 pair-MLP forward"] = time_fwd(cs, libs, ["new_fwd"] + fwd_names, use, gen,
                                                      pmods)
            times["bf16 pair-MLP forward placements"] = time_fwd_placements(cs, libs, use, gen,
                                                                            pmods)
        timed = [n for n in libs if n in kinds and emb_only != "" and (
            args.only is None or n in ("new", "new_wg", "parent") or kinds[n][0] == emb_only)]
        for dtype, B, N in ((torch.float32, 2, 256), (torch.bfloat16, 2, 256),
                            (torch.float32, 2, 896)) if timed else ():
            order = [n for n in timed if dtype in dtypes(n)
                     and (N == 256 or kinds[n][0] == "edge_embedder_wg" or n == "new")]
            a = cs.edge_embedder_inputs(B, N, dtype, gen)
            t = {n: [] for n in order}
            for rnd in range(3):
                for name in (order if rnd % 2 == 0 else order[::-1]):
                    use(kinds[name][0], libs[name])
                    t[name].append(cs.cuda_time_ms(lambda: call(name, a), 20))
            for name in order:
                log(f"{name} {str(dtype)[6:]} B={B} N={N}: " + ", ".join(f"{x:.4f}" for x in t[name])
                    + " ms")
            times[f"{str(dtype)[6:]} B={B} N={N}"] = t
        use("edge_embedder", libs["new"])
        use("edge_embedder_wg", libs["new_wg"])
        card = cs.card_line()
        log(card)
        if args.out is not None:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            args.out.write_text(json.dumps({"card": card, "ms": times}, indent=1))
        return 1 if fails else 0
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
