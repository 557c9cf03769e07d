"""The arithmetic of the edge-embedder forward kernels' float32 products,
emulated in torch on the CPU.

``csrc/edge_embedder.cu`` (3xTF32 on ``mma.sync`` through
``csrc/tc_product.cuh``): each 32-deep slice of k sums into a zeroed
accumulator, 3xTF32 k step by k step (``tests/test_torch_pair_mlp_tc.py``),
with the tensor cores' float32 sums rounded toward zero, and each slice's sum
is then added to the running sum with round-to-nearest. The operands are the
embedder's own: the rel-offset CP factors of a chain with a break
(``rel_cp_factors``; their products cancel in sin/cos angle additions,
K = 64) against the row-duplicated rel kernel, and relu activations against
fan-in scaled weights (K = 128). Each product, and the whole forward through
the LayerNorm, is held against float64: no worse than twice the error of the
CUDA-core kernel's float32 fma chain, and the forward within 1e-4 of the
plain version.

``csrc/edge_embedder_wg.cu`` (the float32 forward without gradients, wgmma
and TMA), on its own tile walk: units of one row i and 64 consecutive
columns (ragged at the row's end; rows past the grid read as zeros, rows
past a batch's Nc as the next batch's), m = G_i * H_j rounded to float32 as
the A fragment is loaded, B's TF32 hi and lo parts as the kernel's first
step writes them (``wgmma_weight_split``, K-major, no permutation), each
32-deep slice summed apart (the first into the running sum itself), the
epilogues in common.cuh's order; square grids and row blocks (Nr != Nc),
with 22 and 0 distance bins, against the plain version and the JAX Pallas
kernel in interpret mode (1e-4) and against float64 (twice the fma chain's
error). The kernels themselves are held against their plain version on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 3).

    python -m pytest tests/test_torch_edge_embedder_tc.py -s   # prints the errors
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from framedipt_tpu.model.pallas import edge_embedder as j_emb

from framedipt_tpu_torch.model.kernels import build
from framedipt_tpu_torch.model.kernels import edge_embedder as t_emb
from tests.test_torch_cuda import emb_args, emb_to_torch
from tests.test_torch_pair_mlp_tc import f32_toward_zero, product_fma_chain, split
from tests.torch_threads import one_torch_thread  # noqa: F401


SLICE = 32  # rows of one staged weight slice: the kernel's kKc


def mma_k8_rz(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One m16n8k8 step: the products of TF32 values are exact, their sum
    with the accumulator is taken wide and rounded toward zero to float32."""
    exact = acc.double() + a.double() @ b.double()
    near = exact.float()
    over = near.double().abs() > exact.abs()
    return torch.where(over, torch.nextafter(near, torch.zeros_like(near)), near)


def product_sliced_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """tc_product.cuh's float32 product: per 32-deep slice a zeroed sum of
    k steps of a_lo b_hi, a_hi b_lo, a_hi b_hi, added to the running sum
    with round-to-nearest."""
    acc = torch.zeros(a.shape[0], b.shape[1])
    for k0 in range(0, a.shape[1], SLICE):
        part = torch.zeros_like(acc)
        for k in range(k0, k0 + SLICE, 8):
            a_hi, a_lo = split(a[:, k : k + 8])
            b_hi, b_lo = split(b[k : k + 8])
            part = mma_k8_rz(part, a_lo, b_hi)
            part = mma_k8_rz(part, a_hi, b_lo)
            part = mma_k8_rz(part, a_hi, b_hi)
        acc = acc + part
    return acc


def product_exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a.double() @ b.double()


def embedder_forward(prod, args, bins, wide=False):
    """The kernel's forward with the products taken by ``prod``, the
    epilogues in common.cuh's order; float64 throughout when ``wide``."""
    dt = torch.float64 if wide else torch.float32
    (g, h, _, _, i_term, j_term, row_mask, col_mask, w_rel, w_dist, b0, w1, b1, w2, b2,
     ln_scale, ln_bias) = (torch.as_tensor(x).to(dt) for x in args)
    (B, Nr, cp), Nc = g.shape, h.shape[1]
    m = (g[:, :, None, :] * h[:, None, :, :]).reshape(-1, cp)
    x = prod(m, w_rel).to(dt)
    if len(bins[0]):
        # The bins of the float32 distances in both precisions: a pair on a
        # bin edge would otherwise fall in another bin in float64.
        pos_r, pos_c = (torch.as_tensor(args[i]) for i in (2, 3))
        d = torch.sqrt(((pos_r[:, :, None, :] - pos_c[:, None, :, :]) ** 2).sum(-1)).reshape(-1)
        lower, upper = (torch.as_tensor(e, dtype=torch.float32) for e in bins)
        hit = (d[:, None] > lower) & (d[:, None] < upper)
        x = x + (hit.to(dt) @ w_dist)  # at most one bin: the row gather
    x = x + i_term[:, :, None, :].expand(B, Nr, Nc, -1).reshape(x.shape)
    x = x + j_term[:, None, :, :].expand(B, Nr, Nc, -1).reshape(x.shape)
    y0 = torch.relu(x + b0)
    y1 = torch.relu(prod(y0, w1).to(dt) + b1)
    out = prod(y1, w2).to(dt) + b2
    mean = out.mean(-1, keepdim=True)
    var = ((out - mean) ** 2).mean(-1, keepdim=True)
    normed = (out - mean) / torch.sqrt(var + 1e-6) * ln_scale + ln_bias
    emask = (row_mask[:, :, None] * col_mask[:, None, :]).reshape(-1, 1)
    return (normed * emask).reshape(B, Nr, Nc, -1)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(5)
    args, bins = emb_args(rng, 1, 24, 128, 22)
    seq_idx = np.arange(24)[None]
    seq_idx[:, 12:] += 40  # a chain break
    g, h = t_emb.rel_cp_factors(torch.as_tensor(seq_idx) + 300, 32)
    args[0], args[1] = g.numpy(), h.numpy()
    return args, bins


def _errors(a, b, exact):
    def err(c):
        return float((c.double() - exact).abs().max())

    return err(product_fma_chain(a, b)), err(product_sliced_3xtf32(a, b))


def test_cp_product_keeps_float32_accuracy(inputs):
    """K = 64: the CP factors' products against the duplicated rel kernel,
    whose sin/cos terms cancel to the sinusoid of the offset."""
    args, _ = inputs
    g, h, w_rel = (torch.as_tensor(args[i]) for i in (0, 1, 8))
    m = (g[:, :, None, :] * h[:, None, :, :]).reshape(-1, 64)
    exact = product_exact(m, w_rel)
    e_fma, e_3x = _errors(m, w_rel, exact)
    print(f"K=64 (CP product): max abs error against float64: fma chain {e_fma:.3e}, "
          f"sliced 3xTF32 {e_3x:.3e} (max |exact| {float(exact.abs().max()):.3f})")
    assert e_3x <= 2.0 * e_fma


def test_hidden_product_keeps_float32_accuracy(inputs):
    """K = 128: relu activations against a fan-in scaled weight."""
    args, _ = inputs
    rng = np.random.default_rng(6)
    y = torch.as_tensor(np.maximum(rng.normal(size=(576, 128)), 0.0).astype(np.float32))
    w1 = torch.as_tensor(args[11])
    exact = product_exact(y, w1)
    e_fma, e_3x = _errors(y, w1, exact)
    print(f"K=128 (hidden layer): max abs error against float64: fma chain {e_fma:.3e}, "
          f"sliced 3xTF32 {e_3x:.3e} (max |exact| {float(exact.abs().max()):.3f})")
    assert e_3x <= 2.0 * e_fma


def test_forward_keeps_float32_accuracy(inputs):
    """The whole forward through the LayerNorm: the sliced 3xTF32 products
    against float64, against the fma chain's error, and against the plain
    version at the card's float32 tolerance."""
    args, bins = inputs
    exact = embedder_forward(product_exact, args, bins, wide=True)
    e_fma = float((embedder_forward(product_fma_chain, args, bins) - exact).abs().max())
    got = embedder_forward(product_sliced_3xtf32, args, bins)
    e_3x = float((got.double() - exact).abs().max())
    plain = t_emb.edge_embedder_plain(*emb_to_torch(args, torch.float32), *bins)
    e_plain = float((got - plain).abs().max())
    print(f"forward: max abs error against float64: fma chain {e_fma:.3e}, sliced 3xTF32 "
          f"{e_3x:.3e}; against the plain version {e_plain:.3e}")
    assert e_3x <= 2.0 * e_fma
    torch.testing.assert_close(got, plain, atol=1e-4, rtol=1e-4)


# ---- the wgmma forward (csrc/edge_embedder_wg.cu) -------------------------

UNIT = 64  # pairs of a unit: one row, 64 consecutive columns


def wgmma_parts(w_rel, w1, w2):
    """(hi, lo) [in, out] of W_rel, W1, W2 from the kernel's split weights."""
    split_w = t_emb.wgmma_weight_split(w_rel, w1, w2)
    parts, off = [], 0
    for n_in in (64, 128, 128):
        n = n_in * 128
        hi, lo = split_w[off:off + n].view(128, n_in), split_w[off + n:off + 2 * n].view(128, n_in)
        parts.append((hi.t(), lo.t()))
        off += 2 * n
    return parts


def product_wgmma_slices(a: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """A [..., 64, K] (float32) @ the split weight [K, 128]: per 32-deep slice
    the k steps a_lo b_hi, a_hi b_lo, a_hi b_hi summed toward zero, the first
    slice into the running sum itself, each later one added to it with round
    to nearest."""
    acc = None
    for k0 in range(0, a.shape[-1], 32):
        part = torch.zeros(*a.shape[:-1], hi.shape[1], dtype=torch.float64)
        for k in range(k0, k0 + 32, 8):
            a_hi, a_lo = split(a[..., k:k + 8])
            for x, y in ((a_lo, hi[k:k + 8]), (a_hi, lo[k:k + 8]), (a_hi, hi[k:k + 8])):
                part = f32_toward_zero(part + x.double() @ y.double()).double()
        acc = part.float() if acc is None else (acc.double() + part).float()
    return acc


def emulate_wgmma_forward(args, bins) -> torch.Tensor:
    """edge_embedder_wg.cu's forward on the CPU: its units, its A fragments
    (m = G_i * H_j rounded to float32 before the split), its split weights
    and sliced sums, common.cuh's epilogues; [B, Nr, Nc, 128]."""
    (g, h, pos_r, pos_c, i_term, j_term, row_mask, col_mask, w_rel, w_dist, b0, w1, b1, w2, b2,
     ln_scale, ln_bias) = args
    (B, Nr, cp), Nc = g.shape, h.shape[1]
    n_jb = -(-Nc // UNIT)
    b, i, jb = (x.reshape(-1) for x in torch.meshgrid(
        torch.arange(B), torch.arange(Nr), torch.arange(n_jb), indexing="ij"))
    rows = (b * Nc + jb * UNIT)[:, None] + torch.arange(UNIT)  # [U, 64] column rows
    inside = rows < B * Nc  # rows past the grid read as zeros (TMA)
    safe = rows.clamp(max=B * Nc - 1)

    def column_rows(t):
        return torch.where(inside[..., None], t.reshape(B * Nc, -1)[safe], 0.0)

    H, J, pc = column_rows(h), column_rows(j_term), column_rows(pos_c)
    G, IT, pr = g[b, i], i_term[b, i], pos_r[b, i]
    (wr_hi, wr_lo), (w1_hi, w1_lo), (w2_hi, w2_lo) = wgmma_parts(w_rel, w1, w2)
    m = G[:, None, :] * H  # float32: the kernel's __fmul_rn
    x = product_wgmma_slices(m, wr_hi, wr_lo)
    # common.cuh pair_bin: d from unfused float32 operations, open intervals.
    diff = pr[:, None, :] - pc
    sq = diff * diff
    d = torch.sqrt((sq[..., 0] + sq[..., 1]) + sq[..., 2])
    lower, upper = (torch.tensor(e, dtype=torch.float32) for e in bins)
    hit = (d[..., None] > lower) & (d[..., None] < upper)
    if len(bins[0]):
        x = torch.where(hit.any(-1, keepdim=True), x + hit.float() @ w_dist, x)
    y0 = torch.relu(((x + IT[:, None, :]) + J) + b0)
    y1 = torch.relu(product_wgmma_slices(y0, w1_hi, w1_lo) + b1)
    pre = product_wgmma_slices(y1, w2_hi, w2_lo) + b2
    mean = pre.sum(-1, keepdim=True) / 128
    centered = pre - mean
    rstd = 1.0 / torch.sqrt((centered * centered).sum(-1, keepdim=True) / 128 + 1e-6)
    j = (jb * UNIT)[:, None] + torch.arange(UNIT)
    mask = row_mask[b, i][:, None] * col_mask.reshape(-1)[safe]
    y = (centered * rstd * ln_scale + ln_bias) * mask[..., None]
    out = torch.zeros(B, Nr, Nc, 128)
    keep = j < Nc
    out[b[:, None].expand_as(j)[keep], i[:, None].expand_as(j)[keep], j[keep]] = y[keep]
    return out


# (B, N, rows of a row block or None): a square grid of a ragged N (one
# unit a row, its columns past Nc the next batch's), and a row block of 5 of
# N=70 rows (two units a row, the second ragged).
WG_CASES = {"square": (2, 24, None), "row_block": (2, 70, (30, 35))}


def _wg_case(case, n_bins):
    B, N, rows = WG_CASES[case]
    args, bins = emb_args(np.random.default_rng(N + n_bins), B, N, 128, n_bins)
    if rows is not None:  # g, pos_rows, i_term, row_mask: the block's rows
        args = [a[:, rows[0]:rows[1]] if k in (0, 2, 4, 6) else a for k, a in enumerate(args)]
    return args, bins


@pytest.mark.parametrize("n_bins", [22, 0])
@pytest.mark.parametrize("case", list(WG_CASES))
def test_wgmma_forward_matches_plain_and_jax(case, n_bins):
    """The wgmma kernel's tile walk and sums, emulated, against the plain
    version and the JAX Pallas kernel in interpret mode on the same numpy
    inputs (float32, 1e-4), and against float64 within twice the error of
    the float32 fma chain."""
    args, bins = _wg_case(case, n_bins)
    targs = emb_to_torch(args, torch.float32)
    got = emulate_wgmma_forward(targs, bins)
    plain = t_emb.edge_embedder_plain(*targs, *bins)
    jargs, jbins = [jnp.asarray(a) for a in args], bins
    if not n_bins:
        # The JAX kernel pads its bins with always-false ones ([+inf, -inf])
        # and zero W_dist rows; with no bin at all it is given one such.
        jargs[9], jbins = jnp.zeros((1, 128), jnp.float32), ((1e30,), (-1e30,))
    with pltpu.force_tpu_interpret_mode():
        want = j_emb.fused_edge_embedder(*jargs, bins_lower=jbins[0], bins_upper=jbins[1],
                                         tile_i=8, tile_j=16)
    exact = embedder_forward(product_exact, targs, bins, wide=True)
    e_fma = float((embedder_forward(product_fma_chain, targs, bins) - exact).abs().max())
    e_wg = float((got.double() - exact).abs().max())
    print(f"{case} n_bins={n_bins}: against float64: fma chain {e_fma:.3e}, wgmma {e_wg:.3e}; "
          f"against the plain version {float((got - plain).abs().max()):.3e}")
    torch.testing.assert_close(got, plain, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    assert e_wg <= 2.0 * e_fma


def test_wgmma_weight_split_laid_back_gives_the_plain_output():
    """The K-major hi and lo parts the wgmma kernel's first step writes,
    laid back to [in, out] as hi + lo, give edge_embedder_plain's output
    (float32, 1e-5); each part is a TF32 value, hi + lo within 2^-21 of the
    weight, and the layout's offsets mirror the kernel's (hi then lo; W_rel
    expanded, W1, W2)."""
    args, bins = emb_args(np.random.default_rng(8), 1, 9, 128, 22)
    targs = emb_to_torch(args, torch.float32)
    weights = [targs[k] for k in (8, 11, 13)]
    assert t_emb.wgmma_weight_split(*weights).shape == (t_emb.WG_SPLIT_FLOATS,)
    laid = []
    for w, (hi, lo) in zip(weights, wgmma_parts(*weights)):
        assert torch.equal(hi, t_emb.tf32_rna(hi)) and torch.equal(lo, t_emb.tf32_rna(lo))
        assert float((hi + lo - w).abs().max()) <= 2.0**-21 * float(w.abs().max())
        laid.append((hi + lo).contiguous())
    back = list(targs)
    back[8], back[11], back[13] = laid
    torch.testing.assert_close(t_emb.edge_embedder_plain(*back, *bins),
                               t_emb.edge_embedder_plain(*targs, *bins), atol=1e-5, rtol=1e-5)


def test_build_names_the_wgmma_source():
    """The build compiles csrc/edge_embedder_wg.cu into its own library, and
    every header it includes is hashed with it."""
    assert build.SOURCES["edge_embedder_wg"] == "edge_embedder_wg.cu"
    source = (build.CSRC / "edge_embedder_wg.cu").read_text()
    includes = [line.split('"')[1] for line in source.splitlines()
                if line.startswith('#include "')]
    assert includes and all(f in build.HEADERS for f in includes)
    assert "edge_embedder_tc.cuh" not in includes  # not the mma.sync kernels' tile code
