"""bf16 kernel B of the split backwards (``csrc/wgrad_bf16.cuh``: weight
gradients G = A^T Bm on wgmma, both operands MN-major from TMA-staged rows),
its plan and layout mirrored in Python and checked on the CPU:

- the slice planner: every pair of a chunk in exactly one slice, whole
  64-pair steps, zero rows read only past the chunk's last pair;
- the shared memory: an emulation of the bf16 TMA boxes (64 columns x 64
  pairs, 128-byte swizzle) and of the MN-major descriptors that the kernel
  builds, decoded by the PTX ISA's canonical MN-major layout with the
  128-byte swizzle; for every k16 instruction of each warpgroup the
  descriptors read A^T(m, k) = A[k][m] and Bm(k, n) = Bm[k][n], every staged
  element once a step (the 64-row job's one box of A, both 64-wide atoms of
  Bm);
- the kernel's arithmetic emulated (per step four 16-deep products summed
  into a zeroed accumulator with the tensor cores' truncated sums, the step
  added with round-to-nearest, the slices in order) against float64 A^T Bm;
- the C sources: both split backwards' bf16 branch builds bf16 tensor maps
  and launches this kernel, and the ``mma.sync`` kernel B is gone; the
  wrapper of the kernel alone (``wgrad_bf16``): the plain version on the
  CPU, the kernel or an error on the card.

The kernel itself is held against float64 on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 3).
"""
import ast
import inspect
import re

import numpy as np
import pytest
import torch

from framedipt_tpu_torch.model.kernels import build
from framedipt_tpu_torch.model.kernels import wgrad

from tests.test_torch_pair_mlp_bwd_bf16 import split_k_bf16
from tests.test_torch_pair_mlp_tc import f32_toward_zero
from tests.torch_threads import one_torch_thread  # noqa: F401

STEP = 64        # pairs a step (kWbStep)
STAGES = 4       # ring stages (kWbStages)
BOX = STEP * 64  # bf16 elements of one TMA box
BOX_BYTES = 2 * BOX
SRC = build.CSRC / "wgrad_bf16.cuh"


def test_constants_are_the_kernels():
    """The step, the ring and the box of this file are the kernel's."""
    src = SRC.read_text()
    assert "constexpr int kWbStep = 64;" in src
    assert f"constexpr int kWbStages = {STAGES};" in src
    assert "constexpr int kWbBox = kWbStep * 64;" in src
    assert "constexpr uint32_t kWbBoxBytes = kWbBox * 2;" in src


# ---- the slice planner ------------------------------------------------------


def wgrad_plan(P: int, slices: int) -> list[tuple[int, int, int]]:
    """(first pair, end pair, steps) of each of the ``slices`` K slices of P
    pairs, as ``launch_wgrad_bf16`` cuts them: k_slice = ceil(ceil(P /
    slices) / STEP) STEP pairs a slice, the last slices short or empty."""
    k_slice = -(-(-(-P // slices)) // STEP) * STEP
    plan = []
    for s in range(slices):
        lo = min(P, s * k_slice)
        hi = min(P, lo + k_slice)
        plan.append((lo, hi, -(-(hi - lo) // STEP)))
    return plan


@pytest.mark.parametrize("P", [1, 17 * 17, 80_000])
@pytest.mark.parametrize("slices", [8, 44])
def test_plan_covers_every_pair_once_in_whole_steps(P, slices):
    """The pair MLP's 8 slices and the embedder's 44: one pair, one partial
    step, a ragged 80,000-pair chunk. Rows read past a slice's end only where
    it is the chunk's end (TMA fills them with zeros)."""
    src = SRC.read_text()
    assert ("const long long k_slice = ((P + slices - 1) / slices + kWbStep - 1) / kWbStep * "
            "kWbStep;") in src
    plan = wgrad_plan(P, slices)
    assert len(plan) == slices
    covered = []
    for lo, hi, steps in plan:
        covered += range(lo, hi)
        end = lo + STEP * steps
        assert end >= hi and (end == hi or hi == P)
        if hi < P:
            assert (hi - lo) % STEP == 0
    assert covered == list(range(P))


# ---- the shared memory ------------------------------------------------------


def swizzle128(addr: int) -> int:
    """The 128-byte swizzle of TMA and wgmma on a shared-memory byte address:
    the 16-byte chunk bits 4-6 XOR the 128-byte row bits 7-9."""
    return addr ^ (((addr >> 7) & 7) << 4)


def tma_box(base: int):
    """{byte address: (row, column)} of a TMA box of STEP rows x 64 bf16
    columns (128-byte rows) written at a 1024-byte aligned base with
    CU_TENSOR_MAP_SWIZZLE_128B."""
    assert base % 1024 == 0
    return {swizzle128(base + 128 * r + 2 * c): (r, c) for r in range(STEP) for c in range(64)}


def desc_mn_sw128(addr: int, lbo: int) -> int:
    """``wg::desc_mn_sw128`` of csrc/wgmma_tma.cuh: start address >> 4 in bits
    0-13, the leading byte offset >> 4 in bits 16-29, the stride byte offset
    1024 >> 4 in bits 32-45, the 128-byte swizzle (1) in bits 62-63."""
    return (((addr & 0x3FFFF) >> 4) | (((lbo >> 4) & 0x3FFF) << 16) | ((1024 >> 4) << 32)
            | (1 << 62))


def mn_major_address(desc: int, mn: int, k: int) -> int:
    """The shared-memory byte of element (mn, k) of a bf16 wgmma operand read
    MN-major (transpose flag 1) through descriptor ``desc``, by the PTX ISA's
    canonical MN-major layout with the 128-byte swizzle, ((T, 8, m), (8, k)) :
    ((1, T, LBO), (8 T, SBO)) with T = 8 elements (16 bytes): 64 contiguous
    elements along MN, the next 64 LBO bytes further; K rows 128 bytes apart,
    8-row groups SBO bytes apart; then the swizzle."""
    assert desc >> 62 == 1  # 128-byte swizzle
    start = (desc & 0x3FFF) << 4
    lbo = ((desc >> 16) & 0x3FFF) << 4
    sbo = ((desc >> 32) & 0x3FFF) << 4
    return swizzle128(start + (mn // 64) * lbo + (mn % 64) * 2 + (k // 8) * sbo + (k % 8) * 128)


def stage_layout(stage: int) -> tuple[list[int], list[int]]:
    """Base byte offsets of A's two boxes and Bm's two boxes of ring stage
    ``stage`` in ``WgradBf16Smem`` (a[kWbStages][2][kWbBox], then
    b[kWbStages][2][kWbBox]), from its 1024-byte aligned start."""
    a = [(2 * stage + j) * BOX_BYTES for j in range(2)]
    b = [(2 * STAGES + 2 * stage + j) * BOX_BYTES for j in range(2)]
    return a, b


@pytest.mark.parametrize("rows", [128, 64])
@pytest.mark.parametrize("stage", [0, STAGES - 1])
def test_descriptors_read_each_operand_where_tma_staged_it(rows, stage):
    """For every k16 instruction (kk = 0..3) of each active warpgroup, the A
    descriptor (the group's box + 16 kk rows) reads A^T(m, k) = the staged
    A[16 kk + k][64 group + m] and the B descriptor (Bm's first box + 16 kk
    rows, the second 64 columns one box further) reads Bm(k, n) = the staged
    Bm[16 kk + k][n]; over a step every staged element is read once by each
    group that needs it. rows = 64: the embedder's d_w_rel job (one box of A,
    warpgroup 0 alone)."""
    src = SRC.read_text()
    assert "wg::desc_mn_sw128(as + kk * 16 * 64, kWbBoxBytes)" in src
    assert "wg::desc_mn_sw128(bs + kk * 16 * 64, kWbBoxBytes)" in src
    assert "const __nv_bfloat16* as = sm.a[st][group];" in src
    assert "const __nv_bfloat16* bs = sm.b[st][0];" in src
    assert "for (int b = 0; b < jb.rows / 64; ++b)" in src
    assert "const bool active = 64 * group < jb.rows;" in src
    a_base, b_base = stage_layout(stage)
    staged = {}  # byte -> (operand, pair in the step, column of the tile)
    for j in range(rows // 64):
        staged.update({addr: ("A", r, 64 * j + c) for addr, (r, c) in tma_box(a_base[j]).items()})
    for j in range(2):
        staged.update({addr: ("B", r, 64 * j + c) for addr, (r, c) in tma_box(b_base[j]).items()})
    for group in range(2):
        if 64 * group >= rows:
            continue
        seen_a, seen_b = set(), set()
        for kk in range(STEP // 16):
            da = desc_mn_sw128(a_base[group] + kk * 16 * 64 * 2, BOX_BYTES)
            db = desc_mn_sw128(b_base[0] + kk * 16 * 64 * 2, BOX_BYTES)
            for k in range(16):
                for m in range(64):
                    addr = mn_major_address(da, m, k)
                    assert staged[addr] == ("A", 16 * kk + k, 64 * group + m)
                    seen_a.add(addr)
                for n in range(128):
                    addr = mn_major_address(db, n, k)
                    assert staged[addr] == ("B", 16 * kk + k, n)
                    seen_b.add(addr)
        assert len(seen_a) == STEP * 64 and len(seen_b) == STEP * 128


def test_descriptor_encoding_is_the_sources():
    """desc_mn_sw128 here encodes the fields as csrc/wgmma_tma.cuh does, and
    every box and k step starts on a 1024-byte swizzle pattern (the
    descriptor's base offset stays 0)."""
    src = (build.CSRC / "wgmma_tma.cuh").read_text()
    body = src[src.index("uint64_t desc_mn_sw128("):]
    body = body[:body.index("\n}\n")]
    assert "((addr & 0x3FFFF) >> 4) | (uint64_t((lbo >> 4) & 0x3FFF) << 16) |" in body
    assert "(uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);" in body
    assert BOX_BYTES % 1024 == 0 and (16 * 64 * 2) % 1024 == 0
    d = desc_mn_sw128(0x12400, BOX_BYTES)
    assert (d & 0x3FFF) << 4 == 0x12400
    assert ((d >> 16) & 0x3FFF) << 4 == BOX_BYTES and ((d >> 32) & 0x3FFF) << 4 == 1024
    assert (d >> 49) & 7 == 0 and d >> 62 == 1


def test_wgmma_reads_both_operands_mn_major():
    """The instruction: m64n128k16, bf16 inputs, float32 sums, A and B from
    shared-memory descriptors, both transpose flags 1; the first of a step's
    products ignores the accumulator (kk > 0)."""
    src = SRC.read_text()
    assert "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " in src
    assert '"%64, %65, p, 1, 1, 1, 1;\\n}"' in src
    assert re.search(r"kWbBoxBytes\), kk > 0\);", src)
    for gone in ("ldmatrix", "cp_async", "mma_bf16(", "transpose_split"):
        assert gone not in src


# ---- the arithmetic ---------------------------------------------------------


def emulate_kernel_b(a: torch.Tensor, b: torch.Tensor, slices: int) -> torch.Tensor:
    """a^T b (bf16 operands) as the kernel sums it: the plan's slices, each a
    chain of 64-pair steps (zero rows past P); per step four 16-deep
    products, each exact and added to the zeroed step sum truncated toward
    zero, as the tensor cores sum; each step sum added to the slice's with
    round-to-nearest; the slices added in order."""
    P, M, N = a.shape[0], a.shape[1], b.shape[1]
    total = torch.zeros(M, N)
    for lo, _, steps in wgrad_plan(P, slices):
        rows = torch.arange(lo, lo + STEP * steps)
        pa = torch.zeros(len(rows), M, dtype=torch.float64)
        pb = torch.zeros(len(rows), N, dtype=torch.float64)
        valid = rows < P
        pa[valid], pb[valid] = a[rows[valid]].double(), b[rows[valid]].double()
        pa, pb = pa.view(steps, STEP, M), pb.view(steps, STEP, N)
        part = torch.zeros(steps, M, N, dtype=torch.float64)
        for k in range(0, STEP, 16):
            prod = pa[:, k:k + 16].transpose(1, 2) @ pb[:, k:k + 16]
            part = f32_toward_zero(part + prod).double()
        acc = torch.zeros(M, N)
        for s in range(steps):
            acc = (acc.double() + part[s]).float()
        total = total + acc
    return total


@pytest.mark.parametrize("P,M,N,slices", [(1, 128, 128, 8), (289, 384, 128, 8),
                                          (2000, 64, 128, 44), (1000, 128, 256, 3)])
def test_emulated_kernel_b_matches_float64(P, M, N, slices):
    """The emulated sums within 1e-4 of float64 A^T Bm's max-abs (the card's
    gate) on bf16 operands, relu-like and signed; the backwards'
    decomposition tests' ``split_k_bf16`` (the same steps, sums rounded to
    nearest) within 1e-5 of it (``-s`` prints the errors)."""
    rng = np.random.default_rng(P + M + N)
    a = torch.as_tensor(np.maximum(rng.normal(size=(P, M)), 0.0)).to(torch.bfloat16)
    b = torch.as_tensor(rng.normal(size=(P, N))).to(torch.bfloat16)
    exact = a.double().t() @ b.double()
    scale = float(exact.abs().max())
    got = emulate_kernel_b(a, b, slices)
    err = float((got.double() - exact).abs().max()) / scale
    between = float((got - split_k_bf16(a, b, slices)).abs().max()) / scale
    print(f"P={P} M={M} N={N} slices={slices}: {err:.3e} of max-abs against float64, "
          f"{between:.3e} from split_k_bf16")
    assert err <= 1e-4 and between <= 1e-5


# ---- the sources and the wrapper --------------------------------------------


@pytest.mark.parametrize("header,bf16_test", [("pair_mlp_split.cuh", "if constexpr (kBf16<T>)"),
                                              ("edge_embedder_split.cuh",
                                               "if constexpr (sizeof(T) == 2)")])
def test_bf16_call_sites_launch_the_wgmma_kernel_b(header, bf16_test):
    """Read from the C sources: each split backward's kernel B builds its
    tensor maps through wgrad_map, whose bf16 overload makes bf16 maps
    (bf16_sw128_map, 64-pair boxes), and its bf16 branch launches
    launch_wgrad_bf16, the float32 one launch_wgrad_wg."""
    src = (build.CSRC / header).read_text()
    assert '#include "wgrad_bf16.cuh"' in src and "wgrad_tc" not in src
    kernel_b = src[src.index("  // Kernel B:"):]
    kernel_b = kernel_b[:kernel_b.index("if (err != cudaSuccess) return err;")]
    assert kernel_b.count("wgrad_map(jobs, ") == 6
    branch = kernel_b[kernel_b.index(bf16_test):]
    bf16_part, f32_part = branch.split("else", 1)
    assert "launch_wgrad_bf16<T>(" in bf16_part and "launch_wgrad_wg(" not in bf16_part
    assert "launch_wgrad_wg(" in f32_part and "launch_wgrad_bf16" not in f32_part
    wb = SRC.read_text()
    overload = wb[wb.index("inline bool wgrad_map(WgradJobs& jobs, int i, const __nv_bfloat16* base"):]
    assert "wg::bf16_sw128_map(&jobs.map[i], base, (uint64_t)rows, (uint64_t)cols, kWbStep)" in overload
    tma = (build.CSRC / "wgmma_tma.cuh").read_text()
    bf16_map = tma[tma.index("inline bool bf16_sw128_map("):]
    assert "CU_TENSOR_MAP_DATA_TYPE_BFLOAT16" in bf16_map and "CU_TENSOR_MAP_SWIZZLE_128B" in bf16_map
    assert "const cuuint32_t box[2] = {64, box_rows};" in bf16_map


def test_the_mma_sync_kernel_b_is_gone():
    """No wgrad_tc.cuh in csrc/ or in the build's headers; the kernel's name
    holds neither ``wgrad_kernel`` nor ``wgrad_wg_kernel`` (the profile
    matchers go by substring); grid_of lives in common.cuh; the C entry of the
    kernel alone is in the bf16 pair-MLP backward's library."""
    assert not (build.CSRC / "wgrad_tc.cuh").exists()
    assert "wgrad_tc.cuh" not in build.HEADERS and "wgrad_bf16.cuh" in build.HEADERS
    for f in build.CSRC.iterdir():
        assert "wgrad_tc" not in f.read_text(), f.name
    src = SRC.read_text()
    names = set(re.findall(r"__global__ void __launch_bounds__\([^)]*\)\s*(\w+)\(", src))
    assert names == {"wgrad_bf16_kernel"}
    assert "int grid_of(long long total)" in (build.CSRC / "common.cuh").read_text()
    assert 'extern "C" int fdk_wgrad_bf16(' in (build.CSRC / "pair_mlp_bwd_wg_bf16.cu").read_text()


def test_wgrad_bf16_takes_the_plain_version_only_on_the_cpu():
    """Read from the wrapper: the plain version is called once, as the body
    of ``if a.device.type == "cpu": return ...``; no ``try``; the launch
    count grows only after the C entry returned 0. On CPU tensors it gives
    float32 a^T b of the bf16 values; a tensor on another device is
    refused."""
    fn = ast.parse(inspect.getsource(wgrad.wgrad_bf16)).body[0]
    guard = fn.body[1]
    assert ast.unparse(guard.test) == "a.device.type == 'cpu'"
    assert ast.unparse(guard.body[0]) == "return wgrad_plain(a, b)"
    assert len([n for n in ast.walk(fn) if isinstance(n, ast.Call)
                and ast.unparse(n.func) == "wgrad_plain"]) == 1
    assert not any(isinstance(n, ast.Try) for n in ast.walk(fn))
    src = ast.unparse(fn)
    assert src.index("if err != 0") < src.index("wgrad_bf16.launches += 1")
    assert "_bf16_kernel()" in src
    rng = np.random.default_rng(4)
    a = torch.as_tensor(rng.normal(size=(70, 64))).to(torch.bfloat16)
    b = torch.as_tensor(rng.normal(size=(70, 128))).to(torch.bfloat16)
    before = wgrad.wgrad_bf16.launches
    got = wgrad.wgrad_bf16(a, b)
    assert got.dtype == torch.float32
    assert torch.allclose(got, (a.double().t() @ b.double()).float(), rtol=1e-5, atol=1e-4)
    assert wgrad.wgrad_bf16.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        wgrad.wgrad_bf16(a.to("meta"), b.to("meta"))
