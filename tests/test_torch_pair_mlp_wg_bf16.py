"""The bf16 pair-MLP forward on wgmma and TMA (``csrc/pair_mlp_wg_bf16.cu``,
tile code ``csrc/pair_mlp_wg_bf16.cuh``), mirrored in Python and checked on
the CPU:

- its arithmetic emulated at the kernel's widths (128 / 384 / 128): the
  walk over 128-pair tiles of the flat grid (rows past the grid zero, never
  kept), the weight ring's slices in the producer's order (W0 by output
  chunk, then W1's and Wf's for each 128-column chunk of y1, then Wfe), each
  product's whole K summed in float32 by 16-deep steps, each step's exact
  sum added truncated toward zero as the tensor cores add (Wf's three chunks
  into one accumulator), and common.cuh's bf16 rounding points (pair_y0,
  pair_y1, pair_out_v; b0 and bf not folded), the LayerNorm in float32; held
  against the JAX kernel in bf16 (interpret mode), the port's plain version
  in bf16 and float64, within 5e-2 of the reference's max-abs, with and
  without the residual terms (``-s`` prints the errors);
- the truncated whole-K sums against float64 at K = 128 and 384: far under
  the bf16 rounding that follows them;
- the shared memory: A's K-major descriptors (``wg::desc_sw128``) over the
  bf16 tiles as TMA writes X and the epilogues write y0 and y1 (``swz``), and
  B's MN-major descriptors (``wg::desc_mn_sw128``) over the TMA boxes of the
  weights as stored, decoded by the PTX ISA's canonical layouts: every k16
  step reads the elements it should, each element of a slice once; with the
  descriptors' byte offsets swapped it reads others;
- the route: a float32 forward takes "wgmma", a bf16 forward "wgmma_bf16",
  under ``torch.no_grad()``, ``torch.inference_mode()`` or autograd alike;
  the C source and the build list the kernel.

The kernel itself is held against the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 3).
"""
import ast
import inspect
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from framedipt_tpu.model.pallas import pair_mlp as j_pair

from framedipt_tpu_torch.model import ipa as t_ipa_mod
from framedipt_tpu_torch.model.kernels import build
from framedipt_tpu_torch.model.kernels import pair_mlp as t_pair

from tests.test_torch_cuda import pair_args, pair_to_torch
from tests.test_torch_pair_mlp_tc import f32_toward_zero
from tests.test_torch_wgrad_bf16 import desc_mn_sw128, mn_major_address, swizzle128, tma_box
from tests.torch_threads import one_torch_thread  # noqa: F401

BF16 = torch.bfloat16
TOL = 5e-2
C_IN, HID, C_OUT, NC = 128, 384, 128, 128
TILE, HALF, SLICE_K, STAGES = 128, 64, 64, 3   # kTile, kHalf, kSliceK, kStages
BOX_BYTES = 64 * 64 * 2                        # kBoxBytes: one TMA box of 64 x 64 bf16
BLOCK = TILE * 64                              # kBlock: elements of one column block of a tile
RES_SLICE = 30                                 # kResSlice; Wfe's two follow
HDR = build.CSRC / "pair_mlp_wg_bf16.cuh"
SRC = build.CSRC / "pair_mlp_wg_bf16.cu"


def test_constants_are_the_kernels():
    """The tile, the ring and the slices of this file are the kernel's."""
    src = HDR.read_text()
    for line in ("constexpr int kTile = 128;", "constexpr int kHalf = 64;",
                 "constexpr int kStages = 3;", "constexpr int kSliceK = 64;",
                 "constexpr int kBox = 64 * 64;", "constexpr uint32_t kBoxBytes = kBox * 2;",
                 "constexpr int kBlock = kTile * 64;",
                 "constexpr int kResSlice = kW0Slices + (HID / NC) * kChunkSlices;  // 30"):
        assert line in src, line


# ---- the arithmetic ---------------------------------------------------------


def slice_coords(s: int) -> tuple[str, int, int]:
    """``slice_coords`` of the tile code: slice s of a tile's weight stream
    as (weight, first output column, first input row) of a 64 (k) x 128 (n)
    block of the weight as stored ([in, out])."""
    if s < 6:
        return "w0", (s // 2) * NC, (s % 2) * SLICE_K
    if s < RES_SLICE:
        hc, v = divmod(s - 6, 8)
        if v < HID // SLICE_K:
            return "w1", hc * NC, v * SLICE_K
        return "wf", 0, hc * NC + (v - HID // SLICE_K) * SLICE_K
    return "wfe", 0, (s - RES_SLICE) * SLICE_K


def test_slice_map_is_the_sources():
    """slice_coords here is the C function's, case by case."""
    src = HDR.read_text()
    body = src[src.index("slice_coords(const Maps& m, int s"):]
    body = body[:body.index("\n}\n")]
    for line in ("col = (s / kKSlices) * NC;", "row = (s % kKSlices) * kSliceK;",
                 "const int hc = (s - kW0Slices) / kChunkSlices, v = (s - kW0Slices) % kChunkSlices;",
                 "row = v * kSliceK;", "row = hc * NC + (v - HID / kSliceK) * kSliceK;",
                 "row = (s - kResSlice) * kSliceK;"):
        assert line in body, line
    assert [slice_coords(s)[0] for s in range(32)] == (
        ["w0"] * 6 + (["w1"] * 6 + ["wf"] * 2) * 3 + ["wfe"] * 2)


class Ring:
    """The weight ring as a consumer warpgroup sees it: each tile's slices
    in the producer's order, the count running across tiles."""

    def __init__(self, weights: dict, residual: bool):
        self.w, self.n = weights, 0
        self.per_tile = RES_SLICE + (2 if residual else 0)

    def take(self, name: str, col: int, row: int) -> torch.Tensor:
        got = slice_coords(self.n % self.per_tile)
        assert got == (name, col, row), (self.n, got, (name, col, row))
        self.n += 1
        return self.w[name][row:row + SLICE_K, col:col + NC]


def add_steps(acc: torch.Tensor, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """acc + a @ w (bf16 values) as the tensor cores sum it: by 16-deep
    steps, each step's exact sum added to the float32 accumulator truncated
    toward zero."""
    acc = acc.double()
    for k0 in range(0, a.shape[1], 16):
        acc = f32_toward_zero(acc + a[:, k0:k0 + 16].double() @ w[k0:k0 + 16].double()).double()
    return acc.float()


def product(ring: Ring, a: torch.Tensor, name: str, col: int, row: int,
            acc: torch.Tensor | None = None) -> torch.Tensor:
    """acc (+)= a [rows, K] @ the ring's next K / 64 slices (weight
    ``name``, output columns col .., input rows row ..), the whole K in the
    one accumulator (zero when acc is None)."""
    acc = torch.zeros(a.shape[0], NC) if acc is None else acc
    for s in range(a.shape[1] // SLICE_K):
        w = ring.take(name, col, row + SLICE_K * s)
        acc = add_steps(acc, a[:, SLICE_K * s:SLICE_K * (s + 1)], w)
    return acc


def rnd(x: torch.Tensor) -> torch.Tensor:
    """common.cuh's rnd<bf16>: to the nearest bf16, as float32."""
    return x.float().to(BF16).float()


def emulate_kernel(pair, i_term, j_term, row_mask, col_mask, w0, b0, w1, b1, wf, bf,
                   ln_scale, ln_bias, fi=None, fj=None, wfe=None) -> torch.Tensor:
    """The kernel's output, tile by tile of the flat [B * Nr * Nc] grid."""
    residual = wfe is not None
    B, Nr, Nc, _ = pair.shape
    total = B * Nr * Nc
    tiles = -(-total // TILE)
    ring = Ring({"w0": w0, "w1": w1, "wf": wf, "wfe": wfe}, residual)
    flat = torch.zeros(tiles * TILE, C_IN, dtype=BF16)  # TMA's zero fill past the grid
    flat[:total] = pair.reshape(total, C_IN)
    out = torch.empty(total, C_OUT, dtype=BF16)
    f = lambda t: t.float()  # noqa: E731
    for t in range(tiles):
        p = torch.arange(t * TILE, (t + 1) * TILE)
        valid = p < total
        b, rem = p // (Nr * Nc), p % (Nr * Nc)
        i, j = rem // Nc, rem % Nc
        row = torch.where(valid, b * Nr + i, 0)  # max(pt.row, 0)
        col = torch.where(valid, b * Nc + j, 0)
        x = flat[t * TILE:(t + 1) * TILE]
        it, jt = f(i_term).reshape(-1, HID)[row], f(j_term).reshape(-1, HID)[col]
        y0 = torch.empty(TILE, HID)
        for cb in range(HID // NC):
            acc = product(ring, x, "w0", cb * NC, 0)
            c = slice(cb * NC, (cb + 1) * NC)
            v = rnd(rnd(rnd(rnd(acc) + it[:, c]) + jt[:, c]) + f(b0)[c])
            y0[:, c] = torch.relu(v)
        acc_out = None
        for hc in range(HID // NC):
            acc1 = product(ring, y0, "w1", hc * NC, 0)
            y1 = torch.relu(rnd(rnd(acc1) + f(b1)[hc * NC:(hc + 1) * NC]))
            acc_out = product(ring, y1, "wf", 0, hc * NC, acc_out)
        v = rnd(acc_out)
        if residual:
            res = product(ring, x, "wfe", 0, 0)
            v = rnd(v + rnd(res))
            v = rnd(v + f(fi).reshape(-1, C_OUT)[row])
            v = rnd(v + f(fj).reshape(-1, C_OUT)[col])
        v = rnd(v + f(bf))
        mean = v.sum(-1, keepdim=True) / C_OUT
        d = v - mean
        rstd = 1.0 / torch.sqrt((d * d).sum(-1, keepdim=True) / C_OUT + 1e-6)
        mask = rnd(f(row_mask).reshape(-1)[row] * f(col_mask).reshape(-1)[col])
        y = ((d * rstd * ln_scale + ln_bias) * mask[:, None]).to(BF16)
        out[p[valid]] = y[valid]  # rows past the grid are never stored
    assert ring.n == tiles * ring.per_tile
    return out.view(B, Nr, Nc, C_OUT)


def float64_pair_mlp(pair, i_term, j_term, row_mask, col_mask, w0, b0, w1, b1, wf, bf,
                     ln_scale, ln_bias, fi=None, fj=None, wfe=None) -> torch.Tensor:
    """The same function in float64 on the bf16 inputs, unrounded."""
    d = lambda t: None if t is None else t.double()  # noqa: E731
    pair, i_term, j_term, w0, b0, w1, b1, wf, bf, fi, fj, wfe = map(
        d, (pair, i_term, j_term, w0, b0, w1, b1, wf, bf, fi, fj, wfe))
    y0 = torch.relu(pair @ w0 + i_term[:, :, None] + j_term[:, None] + b0)
    y1 = torch.relu(y0 @ w1 + b1)
    out = y1 @ wf + bf
    if wfe is not None:
        out = out + pair @ wfe + fi[:, :, None] + fj[:, None]
    mean = out.mean(-1, keepdim=True)
    var = ((out - mean) ** 2).mean(-1, keepdim=True)
    normed = (out - mean) / torch.sqrt(var + 1e-6) * ln_scale.double() + ln_bias.double()
    return normed * (row_mask.double()[:, :, None] * col_mask.double()[:, None])[..., None]


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


@pytest.mark.parametrize("B,N,residual", [(2, 20, True), (1, 12, False)],
                         ids=["b2_n20_residual", "b1_n12_plain_mlp"])
def test_emulated_kernel_matches_jax_plain_and_float64(B, N, residual):
    """B=2 N=20 (800 pairs: six whole tiles and a ragged seventh) with the
    residual terms, B=1 N=12 (144 pairs: one whole tile and 16 pairs) without;
    the last rows masked: the emulated kernel within 5e-2 of the max-abs of
    the JAX kernel in bf16 (interpret mode), of pair_mlp_plain in bf16 and of
    float64."""
    np_args = pair_args(np.random.default_rng(27 + N), B, N, C_IN, HID, C_OUT, residual)
    args = pair_to_torch(np_args, BF16)
    got = emulate_kernel(*args)
    assert torch.isfinite(got.float()).all()
    assert (got[:, -3:] == 0).all() and (got[:, :, -3:] == 0).all()  # masked rows, columns
    plain = t_pair.pair_mlp_plain(*args)
    exact = float64_pair_mlp(*args)
    ja = [None if x is None else jnp.asarray(x, jnp.float32 if i in (11, 12) else jnp.bfloat16)
          for i, x in enumerate(np_args)]
    with pltpu.force_tpu_interpret_mode():
        want = j_pair.fused_pair_mlp(*ja[:13], fi=ja[13], fj=ja[14], wfe=ja[15],
                                     tile_i=16, tile_j=32)
    errs = {"jax": rel_err(got.float(), np.asarray(want, np.float32)),
            "plain": rel_err(got.float(), plain.float()),
            "float64": rel_err(got.double(), exact)}
    print(f"B={B} N={N} residual={residual}: of the reference's max-abs "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    assert all(e <= TOL for e in errs.values()), errs


@pytest.mark.parametrize("K", [128, 384])
def test_truncated_whole_k_sums_stay_under_bf16_rounding(K):
    """The kernel's sums (whole K, 16-deep steps added truncated) against
    float64 on bf16 operands, relu-like A as the hidden layers give it:
    within 2^-14 of the product's max-abs, while rounding the exact product
    to bf16 moves it by up to 2^-9 of itself (``-s`` prints both)."""
    rng = np.random.default_rng(K)
    a = torch.as_tensor(np.maximum(rng.normal(size=(256, K)), 0.0)).to(BF16)
    w = torch.as_tensor(rng.normal(size=(K, NC)) * K ** -0.5).to(BF16)
    got = add_steps(torch.zeros(256, NC), a, w)
    exact = a.double() @ w.double()
    scale = float(exact.abs().max())
    trunc = float((got.double() - exact).abs().max()) / scale
    bf16 = float(((rnd(exact) - exact).abs() / exact.abs().clamp_min(1e-30)).max())
    print(f"K={K}: truncated whole-K sums {trunc:.3e} of max-abs; bf16 rounding up to {bf16:.3e}")
    assert trunc <= 2.0 ** -14 and bf16 > 8 * trunc


# ---- the shared memory ------------------------------------------------------


def swz(r: int, c: int) -> int:
    """``swz`` of the tile code: element offset of (r, c) of a tile."""
    return (c >> 6) * BLOCK + r * 64 + ((((c >> 3) & 7) ^ (r & 7)) << 3) + (c & 7)


def desc_sw128(addr: int) -> int:
    """``wg::desc_sw128`` of csrc/wgmma_tma.cuh: start address >> 4 in bits
    0-13, leading byte offset 1 (unused), stride byte offset 1024 >> 4 in bits
    32-45, the 128-byte swizzle (1) in bits 62-63."""
    return ((addr & 0x3FFFF) >> 4) | (1 << 16) | ((1024 >> 4) << 32) | (1 << 62)


def k_major_address(desc: int, m: int, k: int) -> int:
    """The shared-memory byte of element (m, k), k < 16, of a bf16 wgmma A
    operand read K-major (transpose flag 0) through ``desc``, by the PTX
    ISA's canonical K-major layout with the 128-byte swizzle: rows of 128
    bytes (64 elements along K), 8-row groups SBO bytes apart, the k16 step
    inside one row; then the swizzle."""
    assert desc >> 62 == 1  # 128-byte swizzle
    start = (desc & 0x3FFF) << 4
    sbo = ((desc >> 32) & 0x3FFF) << 4
    assert start % 128 + 2 * 15 < 128  # a k16 step stays inside its row
    return swizzle128(start + (m // 8) * sbo + (m % 8) * 128 + 2 * k)


def swap_offsets(desc: int) -> int:
    """The descriptor with its leading and stride byte offsets swapped."""
    lbo, sbo = (desc >> 16) & 0x3FFF, (desc >> 32) & 0x3FFF
    return (desc & ~((0x3FFF << 16) | (0x3FFF << 32))) | (sbo << 16) | (lbo << 32)


def test_tile_layout_is_tmas():
    """Where the epilogues write (r, c) of a tile (``swz``) is where TMA
    writes it: in column block c // 64, a box of 64 columns and 128-byte
    rows with the 128-byte swizzle (two 64-row boxes make the 128 rows of a
    tile, every box on a 1024-byte boundary)."""
    src = HDR.read_text()
    assert ("return (c >> 6) * kBlock + r * 64 + ((((c >> 3) & 7) ^ (r & 7)) << 3) + (c & 7);"
            in src)
    for cb in range(HID // 64):
        where = {}
        for half in range(2):
            base = 2 * (cb * BLOCK + half * 64 * 64)
            where.update({a: (64 * half + r, 64 * cb + c) for a, (r, c) in tma_box(base).items()})
        for r in range(TILE):
            for c in range(64 * cb, 64 * cb + 64):
                assert where[2 * swz(r, c)] == (r, c)


@pytest.mark.parametrize("operand,blocks", [("x", C_IN // 64), ("y0", HID // 64),
                                            ("y1", NC // 64)])
@pytest.mark.parametrize("group", [0, 1])
def test_a_descriptors_read_the_warpgroups_rows(operand, blocks, group):
    """For every slice s and k16 step kk of a product, warpgroup ``group``'s
    A descriptor (its rows of column block s, + 32 kk bytes; desc_sw128 here
    encodes the fields as csrc/wgmma_tma.cuh does) reads (m, k) = tile
    element (64 group + m, 64 s + 16 kk + k), each of the warpgroup's
    elements once; with the offsets swapped it reads others."""
    src = HDR.read_text()
    tma = (build.CSRC / "wgmma_tma.cuh").read_text()
    body = tma[tma.index("uint64_t desc_sw128("):]
    body = body[:body.index("\n}\n")]
    assert ("return ((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) | (uint64_t(1024 >> 4) << 32) |"
            in body and "(uint64_t(1) << 62);" in body)
    assert "const bf16* a0 = A + group * (kHalf * 64);" in src
    assert "const bf16* a = a0 + s * kBlock;" in src
    assert "wgmma_m64n128k16(acc, wg::desc_sw128(a + 16 * kk)," in src
    layout = {2 * swz(r, c): (r, c) for r in range(TILE) for c in range(64 * blocks)}
    seen = set()
    for s in range(blocks):
        for kk in range(SLICE_K // 16):
            start = 2 * (group * HALF * 64 + s * BLOCK + 16 * kk)
            desc = desc_sw128(start)
            swapped = swap_offsets(desc)
            wrong = 0
            for m in range(HALF):
                for k in range(16):
                    addr = k_major_address(desc, m, k)
                    assert layout[addr] == (64 * group + m, 64 * s + 16 * kk + k)
                    seen.add(addr)
                    alt = swizzle128(((swapped & 0x3FFF) << 4) + (m // 8) * (
                        ((swapped >> 32) & 0x3FFF) << 4) + (m % 8) * 128 + 2 * k)
                    wrong += layout.get(alt) != (64 * group + m, 64 * s + 16 * kk + k)
            assert wrong > 0
    assert len(seen) == HALF * 64 * blocks


@pytest.mark.parametrize("stage", [0, STAGES - 1])
def test_b_descriptors_read_the_weights_as_stored(stage):
    """For every k16 step kk of a stage, the B descriptor (the stage's first
    box + 16 kk rows, the second 64 columns one box further) reads (k, n) =
    the slice's element (16 kk + k, n) of the weight as stored ([in, out]:
    k the input row, n the output column), as TMA stages its two boxes;
    every element of the slice once; with the offsets swapped it reads
    others."""
    src = HDR.read_text()
    assert "wg::desc_mn_sw128(b + kk * 16 * 64, kBoxBytes)," in src
    assert "const bf16* b = sm.w[st][0];" in src
    assert "wg::tma_load_2d(sm.w[st][0], map, &sm.full[st], col, row);" in src
    assert "wg::tma_load_2d(sm.w[st][1], map, &sm.full[st], col + 64, row);" in src
    base = stage * 2 * BOX_BYTES
    staged = {}
    for j in range(2):
        staged.update({a: (r, 64 * j + c) for a, (r, c) in tma_box(base + j * BOX_BYTES).items()})
    seen = set()
    wrong = 0
    for kk in range(SLICE_K // 16):
        desc = desc_mn_sw128(base + kk * 16 * 64 * 2, BOX_BYTES)
        for k in range(16):
            for n in range(NC):
                addr = mn_major_address(desc, n, k)
                assert staged[addr] == (16 * kk + k, n)
                seen.add(addr)
                wrong += staged.get(mn_major_address(swap_offsets(desc), n, k)) != (16 * kk + k, n)
    assert len(seen) == SLICE_K * NC and wrong > 0


def test_the_instruction_and_the_tile_have_no_split():
    """m64n128k16, bf16 inputs, float32 sums, A and B from shared-memory
    descriptors, A K-major (flag 0) and B MN-major (flag 1); the first
    product of a fresh sum ignores the accumulator; no ldmatrix, no cp.async,
    no TF32 split and no weight preparation."""
    src = HDR.read_text()
    assert "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " in src
    assert '"%64, %65, p, 1, 1, 0, 1;\\n}"' in src
    assert "(s > 0 || kk > 0 || !fresh) ? 1 : 0" in src
    for text in (src, SRC.read_text()):
        code = re.sub(r"//[^\n]*", "", text)
        for gone in ("ldmatrix", "cp_async", "split_tf32", "prepare_weights", "mma_bf16("):
            assert gone not in code


# ---- the route and the build ------------------------------------------------


def test_build_and_c_entry():
    """The build compiles csrc/pair_mlp_wg_bf16.cu and hashes its tile
    header; the C entry takes residual, the 17 pointers of the wrapper's
    inputs and output (no dtype, no scratch), B, Nr, Nc and the stream, as the wrapper binds it; the
    tile's kernel is the only __global__ one."""
    assert build.SOURCES["pair_mlp_wg_bf16"] == "pair_mlp_wg_bf16.cu"
    assert "pair_mlp_wg_bf16.cuh" in build.HEADERS
    src = SRC.read_text()
    entry = src[src.index('extern "C" int fdk_pair_mlp_wg_bf16('):]
    entry = entry[:entry.index(")")]
    params = [p.strip() for p in entry.split("(", 1)[1].split(",")]
    assert len(params) == 22 and params[0] == "int residual" and params[-1] == "void* stream"
    assert [p.split()[0] for p in params[-4:-1]] == ["int"] * 3
    assert re.findall(r"__global__ void __launch_bounds__\([^)]*\)\s*(\w+)\(", src) == [
        "pair_mlp_wg_bf16_kernel"]
    fn = ast.parse(inspect.getsource(t_pair._wg_bf16_kernel.__wrapped__)).body[0]
    assert "library('pair_mlp_wg_bf16').fdk_pair_mlp_wg_bf16" in ast.unparse(fn)
    assert "[ctypes.c_void_p] * 17" in ast.unparse(fn)


@pytest.mark.parametrize("mode", ["inference_mode", "no_grad", "autograd"])
@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["float32", "bf16"])
def test_edge_transition_routes_by_grad_mode(mode, dtype):
    """The edge transition on the CPU with the wrapper spied on: the route
    its call would take on the card, ``forward_route(pair.dtype)``: float32
    "wgmma" and bf16 "wgmma_bf16" whichever the mode (the samplers under
    ``torch.inference_mode()``, the self-conditioning forward under
    ``torch.no_grad()``, the train step's forward under autograd)."""
    seen = []
    wrapper = t_pair.pair_mlp

    def spy(*args):
        seen.append(t_pair.forward_route(args[0].dtype))
        return wrapper(*args)

    mp = pytest.MonkeyPatch()
    mp.setattr(t_pair, "pair_mlp", spy)
    try:
        torch.manual_seed(0)
        layer = t_ipa_mod.EdgeTransition(16, 8, 8, dtype)
        rng = np.random.default_rng(3)
        node = torch.as_tensor(rng.normal(size=(1, 5, 16)).astype(np.float32)).to(dtype)
        edge = torch.as_tensor(rng.normal(size=(1, 5, 5, 8)).astype(np.float32)).to(dtype)
        ctx = {"inference_mode": torch.inference_mode, "no_grad": torch.no_grad,
               "autograd": torch.enable_grad}[mode]
        with ctx():
            out = layer(node, edge, torch.ones(1, 5))
    finally:
        mp.undo()
    want = "wgmma" if dtype == torch.float32 else "wgmma_bf16"
    assert seen == [want]
    assert out.requires_grad == (mode == "autograd")
