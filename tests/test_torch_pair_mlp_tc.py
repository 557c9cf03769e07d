"""The arithmetic of the pair-MLP forward kernel's float32 products
(``csrc/pair_mlp.cu``, 3xTF32 on the tensor cores), emulated in torch on the
CPU: each operand x splits into hi = tf32(x) and lo = tf32(x - hi)
(``cvt.rna.tf32.f32``: round to nearest, ties away from zero, to 10 mantissa
bits), and each k step of 8 adds a_lo b_hi, then a_hi b_lo, then a_hi b_hi
to the float32 accumulator.

At the pair MLP's depths (K = 128 and 384) its error against float64 is no
worse than twice that of a float32 fma chain (the CUDA-core kernel it
replaces); a single TF32 product is hundreds of times worse, which is why
the kernel takes three. The kernel itself is held against its plain version
on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 3).

    python -m pytest tests/test_torch_pair_mlp_tc.py -s   # prints the errors
"""
import numpy as np
import pytest
import torch


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
