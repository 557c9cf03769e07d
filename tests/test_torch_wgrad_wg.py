"""Float32 kernel B of the split backwards (``csrc/wgrad_wg.cuh``: weight
gradients G = A^T Bm on wgmma and TMA), its plan and layout mirrored in
Python and checked on the CPU:

- the slice planner: every pair of a chunk in exactly one slice, whole
  32-pair steps, zero rows read only past the chunk's last pair, at one
  pair, 17^2, 2 x 200^2 pairs and over the chunks the backwards' planners
  cut;
- the transform's K-major hi/lo index map: every element of a step's
  staged rows read once and written once, at the swizzled address that the
  wgmma descriptor of its k position reads, for the 128-wide operands and
  the embedder's 64-wide m; the A^T fragments' k positions those of the
  descriptor; the bank of every shared access of a warp distinct;
- the kernel's arithmetic emulated (3xTF32 per 8 k positions into a zeroed
  step sum, truncated toward zero as the tensor cores sum, each step added
  with round-to-nearest, the slices summed in order), in the kernel's order
  of a step's pairs and in the rows' own order, against float64 A^T Bm, and
  both backwards' decompositions with it against the JAX backward kernels
  in interpret mode;
- the C sources: both float32 call sites launch the wgmma kernel, bf16
  ``csrc/wgrad_bf16.cuh``'s (``tests/test_torch_wgrad_bf16.py``), which
  takes bf16 only; and the wrapper of the kernel alone (``wgrad_f32``): the
  plain version on the CPU, the kernel or an error on the card.

The kernel itself is held against float64 on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 3).
"""
import ast
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from framedipt_tpu.model.pallas import edge_embedder as j_emb
from framedipt_tpu.model.pallas import pair_mlp as j_pair

from framedipt_tpu_torch.model.kernels import build
from framedipt_tpu_torch.model.kernels import edge_embedder as t_emb
from framedipt_tpu_torch.model.kernels import pair_mlp as t_pair
from framedipt_tpu_torch.model.kernels import wgrad

from tests.test_torch_cuda import (assert_grads_close, emb_args, emb_to_torch, pair_args,
                                   pair_to_torch)
from tests.test_torch_edge_embedder_bwd_split import C as EMB_C
from tests.test_torch_edge_embedder_bwd_split import NAMES as EMB_NAMES
from tests.test_torch_edge_embedder_bwd_split import _jax_args, _without_coords
from tests.test_torch_edge_embedder_bwd_split import emulate_split_bwd as emulate_emb
from tests.test_torch_edge_embedder_bwd_split import rows_cap as emb_rows_cap
from tests.test_torch_pair_mlp_bwd_split import (KERNEL_B_ORDER, NAMES, emulate_split_bwd,
                                                  rows_cap)
from tests.test_torch_pair_mlp_tc import f32_toward_zero, split
from tests.torch_threads import one_torch_thread  # noqa: F401

STEP = 32  # pairs a step (kWgradStep)
KERNEL = KERNEL_B_ORDER
ORDERS = {"kernel": KERNEL, "rows": tuple(range(STEP))}


def step_pair(c: int, r: int) -> int:
    """``step_pair`` of csrc/wgrad_wg.cuh: the pair at k position 4 c + r."""
    return 8 * r + (c ^ (2 * r))


def wgrad_plan(P: int, slices: int) -> list[tuple[int, int, int]]:
    """(first pair, end pair, steps) of each of the ``slices`` K slices of P
    pairs, as ``launch_wgrad_wg`` cuts them: k_slice = ceil(ceil(P / slices)
    / STEP) STEP pairs a slice, the last slices short or empty."""
    k_slice = -(-(-(-P // slices)) // STEP) * STEP
    plan = []
    for s in range(slices):
        lo = min(P, s * k_slice)
        hi = min(P, lo + k_slice)
        plan.append((lo, hi, -(-(hi - lo) // STEP)))
    return plan


def kmajor_offset(n: int, p: int) -> int:
    """Float offset of row n, k position p of a K-major [rows][32] tile with
    the 128-byte swizzle (16-byte chunk p // 4 of the row at chunk
    (p // 4) ^ (n % 8)), as the wgmma descriptor of k step p // 8 (its start
    at float 8 (p // 8)) reads it."""
    return n * 32 + (((p >> 2) ^ (n & 7)) << 2) + (p & 3)


def staged_offset(k: int, c: int) -> int:
    """Float offset of pair k, column c of a step's rows as TMA stages them
    (``staged`` of csrc/wgrad_wg.cuh): column box c // 32 of [32 pairs][32
    floats], each row's chunk c // 4 % 8 at (c // 4 % 8) ^ (k % 8)."""
    return (c >> 5) * (STEP * 32) + k * 32 + ((((c >> 2) & 7) ^ (k & 7)) << 2) + (c & 3)


# ---- the slice planner ------------------------------------------------------


def check_plan(P: int, slices: int) -> None:
    plan = wgrad_plan(P, slices)
    assert len(plan) == slices
    covered = []
    for s, (lo, hi, steps) in enumerate(plan):
        covered += range(lo, hi)
        assert steps == -(-(hi - lo) // STEP)
        # Rows read: lo .. lo + 32 steps; past hi only where hi is the chunk's end.
        end = lo + STEP * steps
        assert end >= hi and (end == hi or hi == P)
        if hi < P:
            assert (hi - lo) % STEP == 0  # whole steps
    assert covered == list(range(P))  # every pair once, in slice order


@pytest.mark.parametrize("P", [1, 17 * 17, 2 * 200 * 200])
@pytest.mark.parametrize("slices", [8, 44])
def test_plan_covers_every_pair_once_in_whole_steps(P, slices):
    """The pair MLP's 8 slices and the embedder's 44: one pair, one partial
    step, a grid of 80,000 pairs."""
    check_plan(P, slices)


@pytest.mark.parametrize("site", ["pair", "emb"])
def test_plan_over_the_backwards_chunks(site):
    """Each chunk of a backward the planner cuts into several (B=2 N=200
    under a small workspace cap; B=2 N=256 in one) is planned alone."""
    if site == "pair":
        chunks = t_pair.plan_bwd_chunks(2, 200, 200, rows_cap(37, 200))
        slices = t_pair.SPLIT_SLICES
    else:
        chunks = t_emb.plan_bwd_chunks(2, 200, 200, 22, emb_rows_cap(37, 200, 22))
        slices = t_emb.SPLIT_SLICES
    assert len(chunks) > 5
    for m0, m1 in chunks:
        check_plan((m1 - m0) * 200, slices)
    check_plan(2 * 256 * 256, slices)


# ---- the layout -------------------------------------------------------------


def test_step_order_is_the_kernels():
    """The kernel's order of a step's pairs is a permutation, and the
    formula is step_pair's in the CUDA source."""
    assert sorted(KERNEL) == list(range(STEP))
    assert KERNEL == tuple(step_pair(p // 4, p % 4) for p in range(STEP))
    src = (build.CSRC / "wgrad_wg.cuh").read_text()
    assert "return 8 * r + (c ^ (2 * r));" in src


def transform_moves(cols: int):
    """(thread, loop index, source offset in the staged rows, destination
    offset in the K-major tiles) of every float that transpose_split moves,
    as its loop over 4 x 4 blocks runs (96 threads)."""
    moves = []
    for idx in range(96):
        for u in range(idx, cols * 2, 96):
            c, q = u & 7, u >> 3
            for r in range(4):
                for i in range(4):
                    n = 4 * q + i
                    src = staged_offset(step_pair(c, r), 4 * q + i)
                    dst = n * 32 + ((c ^ (n & 7)) << 2) + r
                    moves.append((idx, u, src, dst))
    return moves


@pytest.mark.parametrize("cols", [128, 64])
def test_transform_lands_every_element_once_where_wgmma_reads_it(cols):
    """Every float of a staged step (32 pairs x cols, four or two column
    boxes) is read once and written once into the [cols][32] K-major tile,
    and the element at row n, k position p there is staged pair KERNEL[p],
    column n: what the descriptor of k step p // 8 reads
    (kmajor_offset). 128: the 128-wide operands; 64: the embedder's m."""
    moves = transform_moves(cols)
    srcs = sorted(m[2] for m in moves)
    dsts = sorted(m[3] for m in moves)
    assert srcs == list(range(STEP * cols))
    assert dsts == list(range(32 * cols))
    staged = np.arange(STEP * cols)  # the value at each staged offset is its offset
    tile = np.full(32 * cols, -1)
    for _, _, src, dst in moves:
        tile[dst] = staged[src]
    for n in range(cols):
        for p in range(32):
            assert tile[kmajor_offset(n, p)] == staged_offset(KERNEL[p], n)


@pytest.mark.parametrize("group", [0, 1])
def test_fragments_read_the_descriptors_k_positions(group):
    """Consumer warpgroup `group`'s A^T fragments (load_frags): for k step kk
    each warp's 16 rows x 8 k positions once, positions 8 kk .. 8 kk + 7 (the
    B descriptor's), element (m, p) read from staged pair KERNEL[p], column
    m."""
    for kk in range(4):
        seen = set()
        for warp in range(4):
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                m = 64 * group + 16 * warp + g
                for i in range(4):
                    row, pos = m + 8 * (i & 1), 4 * (2 * kk + (i >> 1)) + t
                    assert 8 * kk <= pos < 8 * kk + 8
                    read = staged_offset(step_pair(2 * kk + (i >> 1), t), row)
                    assert read == staged_offset(KERNEL[pos], row)
                    seen.add((row, pos))
        assert seen == {(64 * group + r, 8 * kk + j) for r in range(64) for j in range(8)}


def banks(offsets) -> int:
    return len({o % 32 for o in offsets})


@pytest.mark.parametrize("access", ["fragments", "transform_reads", "transform_writes"])
def test_shared_accesses_are_bank_conflict_free(access):
    """Each warp-wide shared access hits 32 distinct banks: the A^T
    fragment loads (4-byte, per register), and the transform's 16-byte
    reads and writes (per 8-lane phase: 8 distinct 16-byte chunks)."""
    if access == "fragments":
        for group in range(2):
            for warp in range(4):
                for kk in range(4):
                    for i in range(4):
                        offs = []
                        for lane in range(32):
                            g, t = lane >> 2, lane & 3
                            m = 64 * group + 16 * warp + g + 8 * (i & 1)
                            offs.append(staged_offset(step_pair(2 * kk + (i >> 1), t), m))
                        assert banks(offs) == 32, (group, warp, kk, i)
        return
    for base in range(0, 256, 32):  # a warp's 32 consecutive u of the loop
        for j in range(4):
            for phase in range(4):
                chunks = set()
                for lane in range(8 * phase, 8 * phase + 8):
                    u = base + lane
                    c, q = u & 7, u >> 3
                    if access == "transform_reads":
                        off = staged_offset(step_pair(c, j), 4 * q)
                    else:
                        n = 4 * q + j
                        off = kmajor_offset(n, 4 * c)
                    assert off % 4 == 0
                    chunks.add((off // 4) % 8)
                assert len(chunks) == 8, (access, base, j, phase)


# ---- the arithmetic ---------------------------------------------------------


def emulate_kernel_b(a: torch.Tensor, b: torch.Tensor, slices: int, order) -> torch.Tensor:
    """a^T b as the kernel sums it: the plan's slices, each step's 32 pairs
    (zero past P) at k positions in ``order``, per 8 positions three TF32
    products (lo hi, hi lo, hi hi), each added to the step sum truncated
    toward zero; each step sum added to the slice's with round-to-nearest;
    the slices added in order."""
    P = a.shape[0]
    total = torch.zeros(a.shape[1], b.shape[1])
    for lo, _, steps in wgrad_plan(P, slices):
        acc = torch.zeros_like(total)
        for s in range(steps):
            rows = [lo + STEP * s + k for k in order]
            pa = torch.stack([a[r] if r < P else torch.zeros_like(a[0]) for r in rows])
            pb = torch.stack([b[r] if r < P else torch.zeros_like(b[0]) for r in rows])
            part = torch.zeros_like(total, dtype=torch.float64)
            for k in range(0, STEP, 8):
                a_hi, a_lo = split(pa[k:k + 8].t().contiguous())
                b_hi, b_lo = split(pb[k:k + 8].contiguous())
                for x, y in ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)):
                    part = f32_toward_zero(part + x.double() @ y.double()).double()
            acc = (acc.double() + part).float()
        total = total + acc
    return total


@pytest.mark.parametrize("P,M,N,slices", [(1, 128, 128, 8), (289, 384, 128, 8),
                                          (2000, 64, 128, 44), (1000, 128, 256, 3)])
def test_emulated_kernel_b_matches_float64(P, M, N, slices):
    """The emulated sums, in the kernel's order of a step's pairs and in the
    rows' own, each within 1e-4 of float64 A^T Bm's max-abs (the card's
    gate), relu-like and signed operands; the two orders agree within 1e-5 of
    it (``-s`` prints the errors)."""
    rng = np.random.default_rng(P + M + N)
    a = torch.as_tensor(np.maximum(rng.normal(size=(P, M)), 0.0).astype(np.float32))
    b = torch.as_tensor(rng.normal(size=(P, N)).astype(np.float32))
    exact = a.double().t() @ b.double()
    scale = float(exact.abs().max())
    got = {name: emulate_kernel_b(a, b, slices, order) for name, order in ORDERS.items()}
    errs = {name: float((g.double() - exact).abs().max()) / scale for name, g in got.items()}
    between = float((got["kernel"] - got["rows"]).abs().max()) / scale
    print(f"P={P} M={M} N={N} slices={slices}: {errs} of max-abs against float64, "
          f"{between:.3e} between the orders")
    assert max(errs.values()) <= 1e-4 and between <= 1e-5


@pytest.mark.parametrize("order", list(ORDERS))
def test_pair_mlp_decomposition_in_either_order_matches_jax(order):
    """The float32 pair-MLP backward's decomposition with kernel B's sums in
    the kernel's order and in the rows' own (B=2 N=20, 5 chunks) against the
    JAX backward kernel in interpret mode and pair_mlp_bwd_plain, 1e-4."""
    B, N = 2, 20
    rng = np.random.default_rng(124)
    raw = pair_args(rng, B, N, 128, 384, 128, True)
    args = pair_to_torch(raw, torch.float32)
    g = torch.as_tensor(rng.normal(size=(B, N, N, 128)).astype(np.float32))
    _, got = emulate_split_bwd(g, *args, cap=rows_cap(8, N), order=ORDERS[order])
    assert_grads_close(got, t_pair.pair_mlp_bwd_plain(g, *args), 1e-4, NAMES)
    with pltpu.force_tpu_interpret_mode():
        want = j_pair.fused_pair_mlp_bwd(jnp.asarray(g.numpy()), *map(jnp.asarray, raw),
                                         tile_i=8, tile_j=16)
    assert_grads_close(got, want, 1e-4, NAMES)


@pytest.mark.parametrize("order", list(ORDERS))
def test_embedder_decomposition_in_either_order_matches_jax(order):
    """The float32 embedder backward's decomposition (kernel B's 64-row
    d_w_rel job included) with kernel B's sums in either order (B=2 N=13, 22
    bins, in chunks of 4 grid rows) against the JAX backward kernel in
    interpret mode and edge_embedder_bwd_plain, 1e-4."""
    B, N = 2, 13
    rng = np.random.default_rng(125)
    raw, bins = emb_args(rng, B, N, EMB_C, 22)
    grad = rng.normal(size=(B, N, N, EMB_C)).astype(np.float32)
    args = emb_to_torch(raw, torch.float32)
    chunks, got = emulate_emb(torch.as_tensor(grad), *args, bins, cap=emb_rows_cap(4, N, 22),
                              order=ORDERS[order])
    assert len(chunks) == 7
    assert_grads_close(got, t_emb.edge_embedder_bwd_plain(
        torch.as_tensor(grad), *args, bins_lower=bins[0], bins_upper=bins[1]), 1e-4, EMB_NAMES)
    with pltpu.force_tpu_interpret_mode():
        want = j_emb.fused_edge_embedder_bwd(jnp.asarray(grad), *_jax_args(raw, jnp.float32),
                                             bins_lower=bins[0], bins_upper=bins[1],
                                             tile_i=8, tile_j=16)
    assert_grads_close(got, _without_coords(list(want)), 1e-4, EMB_NAMES)


# ---- the sources and the wrapper --------------------------------------------


def test_float32_call_sites_launch_the_wgmma_kernel_b():
    """Read from the C sources: both split backwards (pair_mlp_split.cuh,
    edge_embedder_split.cuh) build kernel B's tensor maps through wgrad_map
    (float32 maps for float32 arrays, wgrad_wg.cuh's overload) and launch
    launch_wgrad_wg in float32 and wgrad_bf16.cuh's launch_wgrad_bf16 in
    bf16, both kernels on wgmma and TMA; the float32 kernel splits its
    operands into TF32 parts, the bf16 one has no transform; the build
    hashes both headers with every library that includes them."""
    split = (build.CSRC / "pair_mlp_split.cuh").read_text()
    emb = (build.CSRC / "edge_embedder_split.cuh").read_text()
    for src, bf16_test in ((split, "if constexpr (kBf16<T>)"),
                           (emb, "if constexpr (sizeof(T) == 2)")):
        assert '#include "wgrad_bf16.cuh"' in src
        kernel_b = src[src.index("  // Kernel B:"):]
        kernel_b = kernel_b[:kernel_b.index("if (err != cudaSuccess) return err;")]
        assert "wgrad_map(jobs, " in kernel_b
        branch = kernel_b[kernel_b.index(bf16_test):]
        bf16_part, f32_part = branch.split("else", 1)
        assert "launch_wgrad_bf16<T>(" in bf16_part and "launch_wgrad_wg(" not in bf16_part
        assert "launch_wgrad_wg(" in f32_part and "launch_wgrad_bf16" not in f32_part
    wb = (build.CSRC / "wgrad_bf16.cuh").read_text()
    assert '#include "wgrad_wg.cuh"' in wb
    assert 'static_assert(sizeof(T) == 2, "bf16 only' in wb
    assert "split_tf32" not in wb and "mma_tf32" not in wb and "transpose_split" not in wb
    assert "m64n128k16.f32.bf16.bf16" in wb and "tma_load_2d(" in wb
    wg = (build.CSRC / "wgrad_wg.cuh").read_text()
    assert "wgmma_m64n128k8_tf32(" in wg and "tma_load_2d(" in wg and "split_tf32(" in wg
    assert "inline bool wgrad_map(WgradJobs& jobs, int i, const float* base" in wg
    assert "wgrad_wg.cuh" in build.HEADERS and "wgrad_bf16.cuh" in build.HEADERS
    assert "extern \"C\" int fdk_wgrad_f32(" in (build.CSRC / "pair_mlp_bwd_wg.cu").read_text()


def test_wgrad_f32_takes_the_plain_version_only_on_the_cpu():
    """Read from the wrapper: the plain version is called once, as the body
    of ``if a.device.type == "cpu": return ...``; no ``try``; the launch
    count grows only after the C entry returned 0. On CPU tensors it gives
    float32 a^T b; a tensor on another device is refused."""
    fn = ast.parse(inspect.getsource(wgrad.wgrad_f32)).body[0]
    guard = fn.body[1]
    assert ast.unparse(guard.test) == "a.device.type == 'cpu'"
    assert ast.unparse(guard.body[0]) == "return wgrad_plain(a, b)"
    assert len([n for n in ast.walk(fn) if isinstance(n, ast.Call)
                and ast.unparse(n.func) == "wgrad_plain"]) == 1
    assert not any(isinstance(n, ast.Try) for n in ast.walk(fn))
    src = ast.unparse(fn)
    assert src.index("if err != 0") < src.index("wgrad_f32.launches += 1")
    rng = np.random.default_rng(3)
    a = torch.as_tensor(rng.normal(size=(70, 64)).astype(np.float32))
    b = torch.as_tensor(rng.normal(size=(70, 128)).astype(np.float32))
    before = wgrad.wgrad_f32.launches
    assert torch.allclose(wgrad.wgrad_f32(a, b), (a.double().t() @ b.double()).float(),
                          rtol=1e-5, atol=1e-4)
    assert wgrad.wgrad_f32.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        wgrad.wgrad_f32(a.to("meta"), b.to("meta"))
