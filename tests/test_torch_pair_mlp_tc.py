"""The arithmetic of the pair-MLP mma.sync tile's float32 products
(``csrc/pair_mlp_tc.cuh``, 3xTF32 on the tensor cores), emulated in torch on the
CPU: each operand x splits into hi = tf32(x) and lo = tf32(x - hi)
(``cvt.rna.tf32.f32``: round to nearest, ties away from zero, to 10 mantissa
bits), and each k step of 8 adds a_lo b_hi, then a_hi b_lo, then a_hi b_hi
to the float32 accumulator.

At the pair MLP's depths (K = 128 and 384) its error against float64 is no
worse than twice that of a float32 fma chain (the CUDA-core kernel it
replaces); a single TF32 product is hundreds of times worse, which is why
the kernel takes three. The kernel itself is held against its plain version
on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 3).

The float32 forward that takes no gradient runs on wgmma
(``csrc/pair_mlp_wg.cu``): the same 3xTF32 products, with B's parts made by
the kernel's first step and each 32-deep slice summed apart (below).

    python -m pytest tests/test_torch_pair_mlp_tc.py -s   # prints the errors
"""
import numpy as np
import pytest
import torch

from framedipt_tpu_torch.model.kernels import pair_mlp as t_pair
from tests.test_torch_cuda import pair_args, pair_to_torch
from tests.torch_threads import one_torch_thread  # noqa: F401


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (ties away from zero), as float32:
    add half of the 13 dropped bits to the magnitude, then drop them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def mma_k8(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One m16n8k8 step: the products of TF32 values are exact, their sum is
    taken wide and added to the float32 accumulator with one rounding."""
    return (acc.double() + a.double() @ b.double()).float()


def product_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    acc = torch.zeros(a.shape[0], b.shape[1])
    for k in range(0, a.shape[1], 8):
        a_hi, a_lo = split(a[:, k : k + 8])
        b_hi, b_lo = split(b[k : k + 8])
        acc = mma_k8(acc, a_lo, b_hi)
        acc = mma_k8(acc, a_hi, b_lo)
        acc = mma_k8(acc, a_hi, b_hi)
    return acc


def product_1xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    acc = torch.zeros(a.shape[0], b.shape[1])
    for k in range(0, a.shape[1], 8):
        acc = mma_k8(acc, tf32_rna(a[:, k : k + 8]), tf32_rna(b[k : k + 8]))
    return acc


def product_fma_chain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The CUDA-core kernel's sum: fmaf over k in order (the product exact,
    one rounding per step)."""
    acc = torch.zeros(a.shape[0], b.shape[1])
    for k in range(a.shape[1]):
        acc = (acc.double() + a[:, k : k + 1].double() * b[k : k + 1].double()).float()
    return acc


def test_tf32_rounding_is_to_nearest_ties_away():
    one_ulp = 2.0**-10  # TF32 spacing in [1, 2)
    x = torch.tensor([1.0, 1.0 + one_ulp / 2, -(1.0 + one_ulp / 2), 1.0 + 0.49 * one_ulp,
                      1.0 + 1.5 * one_ulp, 3.0e-3])
    got = tf32_rna(x)
    want = torch.tensor([1.0, 1.0 + one_ulp, -(1.0 + one_ulp), 1.0, 1.0 + 2 * one_ulp])
    assert torch.equal(got[:5], want)
    assert got.view(torch.int32)[5] & 0x1FFF == 0  # 10 mantissa bits left
    hi, lo = split(torch.tensor([np.float32(np.pi)]))
    assert abs(float(hi) + float(lo) - float(np.float32(np.pi))) < 2.0**-21 * np.pi


@pytest.mark.parametrize("K", [128, 384])
def test_3xtf32_keeps_float32_accuracy(K):
    """Operands as the pair MLP's products see them: relu activations
    against fan-in scaled weights (64 pairs x 128 output columns)."""
    rng = np.random.default_rng(K)
    a = torch.as_tensor(np.maximum(rng.normal(size=(64, K)), 0.0).astype(np.float32))
    b = torch.as_tensor((rng.normal(size=(K, 128)) / np.sqrt(K)).astype(np.float32))
    exact = a.double() @ b.double()

    def err(c):
        return float((c.double() - exact).abs().max())

    e_fma, e_3x, e_1x = err(product_fma_chain(a, b)), err(product_3xtf32(a, b)), err(product_1xtf32(a, b))
    print(f"K={K}: max abs error against float64: fma chain {e_fma:.3e}, "
          f"3xTF32 {e_3x:.3e}, one TF32 product {e_1x:.3e} (max |exact| "
          f"{float(exact.abs().max()):.3f})")
    assert e_3x <= 2.0 * e_fma
    assert e_1x > 100.0 * e_fma  # a single TF32 product would need a looser gate


# The wgmma forward (csrc/pair_mlp_wg.cu): B's hi and lo come from the
# kernel's first step, tf32 to nearest (wgmma_weight_split; on an H100 the
# tensor cores read a raw float32 operand truncated to TF32, chip_smoke.py
# phase 3's probe, so the kernel hands them exact TF32 values); each k step
# of 8 adds a_lo b_hi, a_hi b_lo, a_hi b_hi into a fresh accumulator for
# each 32-deep slice, the tensor cores truncating each sum (toward zero),
# and the slice's sum is added to the running sum with round to nearest.


def f32_toward_zero(x: torch.Tensor) -> torch.Tensor:
    """float64 -> float32 rounded toward zero."""
    y = x.float()
    over = y.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(y, torch.zeros_like(y)), y)


def product_wgmma_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    acc = torch.zeros(a.shape[0], b.shape[1])
    b_hi = t_pair.tf32_rna(b)
    b_lo = t_pair.tf32_rna(b - b_hi)
    for k0 in range(0, a.shape[1], 32):
        part = torch.zeros_like(acc).double()
        for k in range(k0, k0 + 32, 8):
            a_hi, a_lo = split(a[:, k : k + 8])
            for x, y in ((a_lo, b_hi[k : k + 8]), (a_hi, b_lo[k : k + 8]), (a_hi, b_hi[k : k + 8])):
                part = f32_toward_zero(part + x.double() @ y.double()).double()
        acc = (acc.double() + part).float()
    return acc


def test_tf32_rna_matches_the_tests_rounding():
    x = torch.as_tensor(np.random.default_rng(1).normal(size=1000).astype(np.float32))
    assert torch.equal(t_pair.tf32_rna(x), tf32_rna(x))


@pytest.mark.parametrize("K", [128, 384])
def test_wgmma_3xtf32_slices_keep_float32_accuracy(K):
    """The wgmma kernel's sums, emulated, at the pair MLP's depths: within
    twice the float32 fma chain's error against float64, though each TF32
    sum is truncated (fresh accumulator each 32-deep slice)."""
    rng = np.random.default_rng(K + 1)
    a = torch.as_tensor(np.maximum(rng.normal(size=(64, K)), 0.0).astype(np.float32))
    b = torch.as_tensor((rng.normal(size=(K, 128)) / np.sqrt(K)).astype(np.float32))
    exact = a.double() @ b.double()

    def err(c):
        return float((c.double() - exact).abs().max())

    e_fma, e_wg = err(product_fma_chain(a, b)), err(product_wgmma_3xtf32(a, b))
    print(f"K={K}: max abs error against float64: fma chain {e_fma:.3e}, wgmma 3xTF32 {e_wg:.3e}")
    assert e_wg <= 2.0 * e_fma


def test_wgmma_weight_split_laid_back_gives_the_plain_output():
    """The K-major hi and lo parts handed to the wgmma kernel, laid back to
    [in, out] as hi + lo, give pair_mlp_plain's output (float32, 1e-5), and
    the layout's offsets mirror the kernel's (hi then lo, W0, W1, Wf, Wfe)."""
    rng = np.random.default_rng(7)
    args = pair_to_torch(pair_args(rng, 1, 9, 128, 384, 128, True), torch.float32)
    w0, w1, wf, wfe = args[5], args[7], args[9], args[15]
    split_w = t_pair.wgmma_weight_split(w0, w1, wf, wfe)
    assert split_w.shape == (t_pair.WG_SPLIT_FLOATS,)
    laid, off = [], 0
    for w in (w0, w1, wf, wfe):
        n_in, n_out = w.shape
        hi = split_w[off : off + n_in * n_out].view(n_out, n_in)
        lo = split_w[off + n_in * n_out : off + 2 * n_in * n_out].view(n_out, n_in)
        assert torch.equal(hi, t_pair.tf32_rna(hi)) and torch.equal(lo, t_pair.tf32_rna(lo))
        assert float(((hi + lo).t() - w).abs().max()) <= 2.0**-21 * float(w.abs().max())
        laid.append((hi + lo).t().contiguous())
        off += 2 * n_in * n_out
    assert off == t_pair.WG_SPLIT_FLOATS
    back = list(args)
    back[5], back[7], back[9], back[15] = laid
    torch.testing.assert_close(t_pair.pair_mlp_plain(*back), t_pair.pair_mlp_plain(*args),
                               atol=1e-5, rtol=1e-5)
    no_res = t_pair.wgmma_weight_split(w0, w1, wf)
    assert torch.equal(no_res[: off - 2 * 128 * 128], split_w[: off - 2 * 128 * 128])
    assert not no_res[off - 2 * 128 * 128 :].any()
