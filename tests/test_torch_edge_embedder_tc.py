"""The arithmetic of the edge-embedder forward kernel's float32 products
(``csrc/edge_embedder.cu``, 3xTF32 on the tensor cores through
``csrc/tc_product.cuh``), emulated in torch on the CPU: each 32-deep slice
of k sums into a zeroed accumulator, 3xTF32 k step by k step
(``tests/test_torch_pair_mlp_tc.py``), with the tensor cores' float32 sums
rounded toward zero, and each slice's sum is then added to the running sum
with round-to-nearest.

The operands are the embedder's own: the rel-offset CP factors of a chain
with a break (``rel_cp_factors``; their products cancel in sin/cos angle
additions, K = 64) against the row-duplicated rel kernel, and relu
activations against fan-in scaled weights (K = 128). Each product, and the
whole forward through the LayerNorm, is held against float64: no worse than
twice the error of the CUDA-core kernel's float32 fma chain, and the forward
within 1e-4 of the plain version. The kernel itself is held against its
plain version on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``
phase 3).

    python -m pytest tests/test_torch_edge_embedder_tc.py -s   # prints the errors
"""
import numpy as np
import pytest
import torch

from framedipt_tpu_torch.model.kernels import edge_embedder as t_emb
from tests.test_torch_cuda import emb_args, emb_to_torch
from tests.test_torch_pair_mlp_tc import product_fma_chain, split

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
    B, N, cp = g.shape
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
    x = x + i_term[:, :, None, :].expand(B, N, N, -1).reshape(x.shape)
    x = x + j_term[:, None, :, :].expand(B, N, N, -1).reshape(x.shape)
    y0 = torch.relu(x + b0)
    y1 = torch.relu(prod(y0, w1).to(dt) + b1)
    out = prod(y1, w2).to(dt) + b2
    mean = out.mean(-1, keepdim=True)
    var = ((out - mean) ** 2).mean(-1, keepdim=True)
    normed = (out - mean) / torch.sqrt(var + 1e-6) * ln_scale + ln_bias
    emask = (row_mask[:, :, None] * col_mask[:, None, :]).reshape(-1, 1)
    return (normed * emask).reshape(B, N, N, -1)


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
