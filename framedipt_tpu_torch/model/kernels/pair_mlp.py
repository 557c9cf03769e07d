"""Pair MLP of the edge transition: CUDA kernel wrapper and plain version.

Computes, per pair (i, j) of a [B, Nr, Nc, C_in] edge tensor,

    y0  = relu(pair @ W0 + i_term_i + j_term_j + b0)
    y1  = relu(y0 @ W1 + b1)
    out = y1 @ Wf (+ pair @ Wfe + fi_i + fj_j) + bf      # residual variant
    out = LayerNorm(out) * row_mask_i * col_mask_j

Each product accumulates in float32 and is rounded to the compute dtype;
LayerNorm statistics are float32 (eps 1e-6). ``residual=False`` (no
fi/fj/wfe) is the plain MLP variant.

:func:`pair_mlp` takes the kernel (``csrc/pair_mlp.cu``) for CUDA tensors
and :func:`pair_mlp_plain` for CPU tensors, which exist for the tests.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from framedipt_tpu_torch.model.kernels.build import library
from framedipt_tpu_torch.model.layers import layer_norm_f32

F32 = torch.float32
C_IN, HIDDEN, C_OUT = 128, 384, 128  # widths the kernel is built for


def pair_mlp_plain(
    pair, i_term, j_term, row_mask, col_mask,
    w0, b0, w1, b1, wf, bf, ln_scale, ln_bias,
    fi=None, fj=None, wfe=None,
):
    """Plain PyTorch version of the kernel (the XLA twin's formulation)."""
    dtype = pair.dtype

    def mm(x, w):
        return torch.matmul(x.to(F32), w.to(F32)).to(dtype)

    y0 = torch.relu(mm(pair, w0) + i_term[:, :, None, :] + j_term[:, None, :, :] + b0)
    y1 = torch.relu(mm(y0, w1) + b1)
    out = mm(y1, wf)
    if wfe is not None:
        out = out + mm(pair, wfe)
        out = out + fi[:, :, None, :] + fj[:, None, :, :]
    out = out + bf
    normed = layer_norm_f32(out, ln_scale, ln_bias)
    emask = row_mask[:, :, None] * col_mask[:, None, :]
    return (normed * emask[..., None].to(F32)).to(dtype)


def _check(name, t, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"pair_mlp: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"pair_mlp: {name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"pair_mlp: {name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"pair_mlp: {name} is not contiguous")


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _kernel():
    """The C entry point of csrc/pair_mlp.cu, built and bound at first use."""
    fn = library("pair_mlp").fdk_pair_mlp
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 17 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    return fn


def pair_mlp(
    pair, i_term, j_term, row_mask, col_mask,
    w0, b0, w1, b1, wf, bf, ln_scale, ln_bias,
    fi=None, fj=None, wfe=None,
):
    """Masked-LayerNorm pair MLP, [B, Nr, Nc, C_out] in pair's dtype.

    CPU tensors take :func:`pair_mlp_plain`; CUDA tensors launch the kernel
    (or raise). Weights are [in, out]; masks are in the compute dtype,
    ln_scale/ln_bias float32. Adds one to ``pair_mlp.launches`` per launch."""
    if pair.device.type == "cpu":
        return pair_mlp_plain(
            pair, i_term, j_term, row_mask, col_mask,
            w0, b0, w1, b1, wf, bf, ln_scale, ln_bias, fi, fj, wfe,
        )
    if pair.device.type != "cuda":
        raise ValueError(f"pair_mlp: unsupported device {pair.device}")
    residual = wfe is not None
    if residual != (fi is not None) or residual != (fj is not None):
        raise ValueError("pair_mlp: fi, fj and wfe go together")
    dtype, dev = pair.dtype, pair.device
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"pair_mlp: unsupported dtype {dtype}")
    B, Nr, Nc, c_in = pair.shape
    if (c_in, w1.shape[0], wf.shape[1]) != (C_IN, HIDDEN, C_OUT):
        raise ValueError(
            f"pair_mlp: kernel is built for widths {(C_IN, HIDDEN, C_OUT)}, got "
            f"{(c_in, w1.shape[0], wf.shape[1])}"
        )
    checks = [
        ("pair", pair, (B, Nr, Nc, C_IN), dtype),
        ("i_term", i_term, (B, Nr, HIDDEN), dtype),
        ("j_term", j_term, (B, Nc, HIDDEN), dtype),
        ("row_mask", row_mask, (B, Nr), dtype),
        ("col_mask", col_mask, (B, Nc), dtype),
        ("w0", w0, (C_IN, HIDDEN), dtype),
        ("b0", b0, (HIDDEN,), dtype),
        ("w1", w1, (HIDDEN, HIDDEN), dtype),
        ("b1", b1, (HIDDEN,), dtype),
        ("wf", wf, (HIDDEN, C_OUT), dtype),
        ("bf", bf, (C_OUT,), dtype),
        ("ln_scale", ln_scale, (C_OUT,), F32),
        ("ln_bias", ln_bias, (C_OUT,), F32),
    ]
    if residual:
        checks += [
            ("fi", fi, (B, Nr, C_OUT), dtype),
            ("fj", fj, (B, Nc, C_OUT), dtype),
            ("wfe", wfe, (C_IN, C_OUT), dtype),
        ]
    for name, t, shape, dt in checks:
        _check(name, t, shape, dt, dev)

    out = torch.empty((B, Nr, Nc, C_OUT), dtype=dtype, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel()(
            _DTYPE_CODE[dtype], int(residual),
            ptr(pair), ptr(i_term), ptr(j_term), ptr(fi), ptr(fj),
            ptr(row_mask), ptr(col_mask),
            ptr(w0), ptr(b0), ptr(w1), ptr(b1), ptr(wf), ptr(bf), ptr(wfe),
            ptr(ln_scale), ptr(ln_bias), ptr(out),
            B, Nr, Nc, stream,
        )
    if err != 0:
        raise RuntimeError(f"pair_mlp kernel launch failed: cudaError_t {err}")
    pair_mlp.launches += 1
    return out


pair_mlp.launches = 0
