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

The backward: :func:`pair_mlp_bwd` takes the backward kernel
(``csrc/pair_mlp_bwd.cu``) for CUDA tensors and :func:`pair_mlp_bwd_plain`
for CPU tensors. Both recompute the forward from the inputs and return every
input gradient; :class:`PairMLPFunction` binds forward and backward for
autograd and saves only the inputs, never the [B, N, N, hidden]
activations.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from framedipt_tpu_torch.model.kernels.build import library
from framedipt_tpu_torch.model.layers import layer_norm_f32

F32 = torch.float32
C_IN, HIDDEN, C_OUT = 128, 384, 128  # widths the kernel is built for


def _mm(x, w):
    """x @ w accumulated in float32, rounded to x's dtype."""
    return torch.matmul(x.to(F32), w.to(F32)).to(x.dtype)


def _pre_norm(pair, i_term, j_term, w0, b0, w1, b1, wf, bf, fi, fj, wfe):
    """(y0, y1, pre-norm output), added in the kernels' order (b0 and bf
    not folded), which decides every relu mask; the forward kernel and the
    backward kernel's recompute follow it too (``common.cuh``)."""
    y0 = torch.relu(_mm(pair, w0) + i_term[:, :, None, :] + j_term[:, None, :, :] + b0)
    y1 = torch.relu(_mm(y0, w1) + b1)
    out = _mm(y1, wf)
    if wfe is not None:
        out = out + _mm(pair, wfe)
        out = out + fi[:, :, None, :] + fj[:, None, :, :]
    return y0, y1, out + bf


def pair_mlp_plain(
    pair, i_term, j_term, row_mask, col_mask,
    w0, b0, w1, b1, wf, bf, ln_scale, ln_bias,
    fi=None, fj=None, wfe=None,
):
    """Plain PyTorch version of the kernel (the XLA twin's formulation)."""
    _, _, out = _pre_norm(pair, i_term, j_term, w0, b0, w1, b1, wf, bf, fi, fj, wfe)
    normed = layer_norm_f32(out, ln_scale, ln_bias)
    emask = row_mask[:, :, None] * col_mask[:, None, :]
    return (normed * emask[..., None].to(F32)).to(pair.dtype)


def pair_mlp_bwd_plain(
    g, pair, i_term, j_term, row_mask, col_mask,
    w0, b0, w1, b1, wf, bf, ln_scale, ln_bias,
    fi=None, fj=None, wfe=None,
):
    """Plain PyTorch version of the backward kernel: recompute the forward
    in :func:`pair_mlp_plain`'s order (b0 and bf not folded), then
    back-propagate step by step as the JAX package's backward kernel does.
    Returns (d_pair, d_i_term, d_j_term, d_row_mask, d_col_mask, d_w0, d_b0,
    d_w1, d_b1, d_wf, d_bf, d_ln_scale, d_ln_bias, d_fi, d_fj, d_wfe), summed
    in float32 and cast to each input's dtype (the last three None without
    the residual terms)."""
    dtype = pair.dtype
    residual = wfe is not None

    def t_dot(a, b):  # sum over every pair of a^T b, float32
        return torch.einsum("bijp,bijq->pq", a.to(F32), b.to(F32))

    y0, y1, out = _pre_norm(pair, i_term, j_term, w0, b0, w1, b1, wf, bf, fi, fj, wfe)
    x = out.to(F32)
    mean = x.mean(dim=-1, keepdim=True)
    centered = x - mean
    var = (centered * centered).mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + 1e-6)
    xhat = centered * inv
    yln = xhat * ln_scale.to(F32) + ln_bias.to(F32)
    rmask, cmask = row_mask.to(F32), col_mask.to(F32)
    emask = (row_mask[:, :, None] * col_mask[:, None, :]).to(F32)

    gf = g.to(F32)
    gm = gf * emask[..., None]
    # Mask gradients (through out = yln * emask): nonzero where a mask is 0.
    dem = torch.sum(yln * gf, dim=-1)
    d_rm = torch.sum(dem * cmask[:, None, :], dim=2)
    d_cm = torch.sum(dem * rmask[:, :, None], dim=1)
    # LayerNorm backward (biased variance, eps inside the rsqrt).
    d_lns = torch.sum(gm * xhat, dim=(0, 1, 2))
    d_lnb = torch.sum(gm, dim=(0, 1, 2))
    dxhat = gm * ln_scale.to(F32)
    mu1 = dxhat.mean(dim=-1, keepdim=True)
    mu2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    dx = (dxhat - mu1 - xhat * mu2) * inv
    dxd = dx.to(dtype)
    # Final projection.
    d_wf = t_dot(y1, dxd)
    d_bf = torch.sum(dx, dim=(0, 1, 2))
    d_fi = d_fj = d_wfe = None
    if residual:
        d_wfe = t_dot(pair, dxd)
        d_fi = torch.sum(dx, dim=2)
        d_fj = torch.sum(dx, dim=1)
    # Second layer; relu'(0) = 0.
    dy1 = _mm(dxd, wf.t()) * (y1 > 0).to(dtype)
    d_b1 = torch.sum(dy1.to(F32), dim=(0, 1, 2))
    d_w1 = t_dot(y0, dy1)
    # First layer.
    dy0 = _mm(dy1, w1.t()) * (y0 > 0).to(dtype)
    d_w0 = t_dot(pair, dy0)
    d_i_term = torch.sum(dy0.to(F32), dim=2)
    d_j_term = torch.sum(dy0.to(F32), dim=1)
    d_pair = _mm(dy0, w0.t())
    if residual:
        d_pair = d_pair + _mm(dxd, wfe.t())
    d_b0 = torch.sum(d_i_term, dim=(0, 1))

    def cast(v, ref):
        return None if v is None else v.to(ref.dtype)

    return (
        d_pair.to(dtype), cast(d_i_term, i_term), cast(d_j_term, j_term),
        cast(d_rm, row_mask), cast(d_cm, col_mask), cast(d_w0, w0), cast(d_b0, b0),
        cast(d_w1, w1), cast(d_b1, b1), cast(d_wf, wf), cast(d_bf, bf),
        cast(d_lns, ln_scale), cast(d_lnb, ln_bias),
        cast(d_fi, fi), cast(d_fj, fj), cast(d_wfe, wfe),
    )


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
# Per-block float32 partials of the grid-reduced gradients, in this order:
# d_w0, d_w1, d_wf, d_b1, d_bf, d_ln_scale, d_ln_bias, then d_wfe (residual
# only). Mirrors the offsets in csrc/pair_mlp_bwd.cu.
_W_PARTS = (
    ("w0", (C_IN, HIDDEN)), ("w1", (HIDDEN, HIDDEN)), ("wf", (HIDDEN, C_OUT)),
    ("b1", (HIDDEN,)), ("bf", (C_OUT,)), ("ln_scale", (C_OUT,)), ("ln_bias", (C_OUT,)),
    ("wfe", (C_IN, C_OUT)),
)
W_PART_FLOATS = sum(int(np.prod(shape)) for _, shape in _W_PARTS)
ROW_PART = HIDDEN + C_OUT + 1  # d_i_term | d_fi | d_row_mask per row partial
TILE_I, TILE_J = 4, 8  # pairs of one backward tile


@functools.cache
def _kernel():
    """The C entry point of csrc/pair_mlp.cu, built and bound at first use."""
    fn = library("pair_mlp").fdk_pair_mlp
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 17 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    return fn


@functools.cache
def _bwd_kernel():
    """The C entry point of csrc/pair_mlp_bwd.cu, built and bound at first
    use."""
    fn = library("pair_mlp_bwd").fdk_pair_mlp_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 28 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    return fn


def _check_inputs(fn_name, pair, i_term, j_term, row_mask, col_mask,
                  w0, b0, w1, b1, wf, bf, ln_scale, ln_bias, fi, fj, wfe):
    """Shapes, dtypes, device and contiguity the kernels take; returns
    (residual, B, Nr, Nc)."""
    residual = wfe is not None
    if residual != (fi is not None) or residual != (fj is not None):
        raise ValueError(f"{fn_name}: fi, fj and wfe go together")
    dtype, dev = pair.dtype, pair.device
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"{fn_name}: unsupported dtype {dtype}")
    B, Nr, Nc, c_in = pair.shape
    if (c_in, w1.shape[0], wf.shape[1]) != (C_IN, HIDDEN, C_OUT):
        raise ValueError(
            f"{fn_name}: kernel is built for widths {(C_IN, HIDDEN, C_OUT)}, got "
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
    return residual, B, Nr, Nc


def _ptr(t):
    return None if t is None else t.data_ptr()


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
    residual, B, Nr, Nc = _check_inputs(
        "pair_mlp", pair, i_term, j_term, row_mask, col_mask,
        w0, b0, w1, b1, wf, bf, ln_scale, ln_bias, fi, fj, wfe,
    )
    dev = pair.device
    out = torch.empty((B, Nr, Nc, C_OUT), dtype=pair.dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel()(
            _DTYPE_CODE[pair.dtype], int(residual),
            _ptr(pair), _ptr(i_term), _ptr(j_term), _ptr(fi), _ptr(fj),
            _ptr(row_mask), _ptr(col_mask),
            _ptr(w0), _ptr(b0), _ptr(w1), _ptr(b1), _ptr(wf), _ptr(bf), _ptr(wfe),
            _ptr(ln_scale), _ptr(ln_bias), _ptr(out),
            B, Nr, Nc, stream,
        )
    if err != 0:
        raise RuntimeError(f"pair_mlp kernel launch failed: cudaError_t {err}")
    pair_mlp.launches += 1
    return out


pair_mlp.launches = 0


def bwd_workspace_floats(B: int, Nr: int, Nc: int, blocks: int) -> int:
    """Float32 scratch of one backward launch: ``blocks`` per-block weight
    partial sets, the per-tile row and column partials, and their sums."""
    n_ti, n_tj = -(-Nr // TILE_I), -(-Nc // TILE_J)
    return ((blocks + 1) * W_PART_FLOATS
            + ROW_PART * (B * Nr * (n_tj + 1) + B * Nc * (n_ti + 1)))


def pair_mlp_bwd(
    g, pair, i_term, j_term, row_mask, col_mask,
    w0, b0, w1, b1, wf, bf, ln_scale, ln_bias,
    fi=None, fj=None, wfe=None,
):
    """Every input gradient of :func:`pair_mlp` for the cotangent ``g``, in
    :func:`pair_mlp_bwd_plain`'s order and dtypes.

    CPU tensors take :func:`pair_mlp_bwd_plain`; CUDA tensors launch the
    backward kernel (or raise). The grid-reduced gradients are summed in
    float32 from per-block partials in a fixed order (no atomics), so two
    launches on the same inputs give the same bits. Adds one to
    ``pair_mlp_bwd.launches`` per launch."""
    if pair.device.type == "cpu":
        return pair_mlp_bwd_plain(
            g, pair, i_term, j_term, row_mask, col_mask,
            w0, b0, w1, b1, wf, bf, ln_scale, ln_bias, fi, fj, wfe,
        )
    if pair.device.type != "cuda":
        raise ValueError(f"pair_mlp_bwd: unsupported device {pair.device}")
    residual, B, Nr, Nc = _check_inputs(
        "pair_mlp_bwd", pair, i_term, j_term, row_mask, col_mask,
        w0, b0, w1, b1, wf, bf, ln_scale, ln_bias, fi, fj, wfe,
    )
    dtype, dev = pair.dtype, pair.device
    _check("g", g, (B, Nr, Nc, C_OUT), dtype, dev)
    n_ti, n_tj = -(-Nr // TILE_I), -(-Nc // TILE_J)
    # Persistent blocks, one per SM: each owns one weight partial set.
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = max(1, min(B * n_ti * n_tj, sms))
    # The kernel's transposed-weight products read W^T row-major.
    w0t, w1t, wft = (w.t().contiguous() for w in (w0, w1, wf))
    wfet = wfe.t().contiguous() if residual else None
    d_pair = torch.empty_like(pair)
    ws = torch.empty(bwd_workspace_floats(B, Nr, Nc, blocks), dtype=F32, device=dev)
    sizes = [blocks * W_PART_FLOATS, B * Nr * n_tj * ROW_PART, B * Nc * n_ti * ROW_PART,
             W_PART_FLOATS, B * Nr * ROW_PART, B * Nc * ROW_PART]
    wpart, rowpart, colpart, wred, rowred, colred = torch.split(ws, sizes)
    if B * Nr * Nc:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = _bwd_kernel()(
                _DTYPE_CODE[dtype], int(residual),
                _ptr(g), _ptr(pair), _ptr(i_term), _ptr(j_term), _ptr(fi), _ptr(fj),
                _ptr(row_mask), _ptr(col_mask),
                _ptr(w0), _ptr(b0), _ptr(w1), _ptr(b1), _ptr(wf), _ptr(bf), _ptr(wfe),
                _ptr(ln_scale), _ptr(ln_bias), _ptr(w0t), _ptr(w1t), _ptr(wft), _ptr(wfet),
                _ptr(d_pair), _ptr(wpart), _ptr(rowpart), _ptr(colpart),
                _ptr(wred), _ptr(rowred), _ptr(colred),
                B, Nr, Nc, blocks, stream,
            )
        if err != 0:
            raise RuntimeError(f"pair_mlp_bwd kernel launch failed: cudaError_t {err}")
        pair_mlp_bwd.launches += 1
    else:
        wred.zero_()
        rowred.zero_()
        colred.zero_()

    parts, off = {}, 0
    for name, shape in _W_PARTS:
        n = int(np.prod(shape))
        parts[name] = wred[off : off + n].view(shape)
        off += n
    rows = rowred.view(B, Nr, ROW_PART)
    cols = colred.view(B, Nc, ROW_PART)
    d_i_term, d_j_term = rows[..., :HIDDEN], cols[..., :HIDDEN]
    d_b0 = torch.sum(d_i_term, dim=(0, 1))

    def cast(v, ref):
        return None if ref is None else v.to(ref.dtype)

    return (
        d_pair, cast(d_i_term, i_term), cast(d_j_term, j_term),
        cast(rows[..., -1], row_mask), cast(cols[..., -1], col_mask),
        cast(parts["w0"], w0), cast(d_b0, b0), cast(parts["w1"], w1), cast(parts["b1"], b1),
        cast(parts["wf"], wf), cast(parts["bf"], bf),
        cast(parts["ln_scale"], ln_scale), cast(parts["ln_bias"], ln_bias),
        cast(rows[..., HIDDEN:-1], fi), cast(cols[..., HIDDEN:-1], fj), cast(parts["wfe"], wfe),
    )


pair_mlp_bwd.launches = 0


class PairMLPFunction(torch.autograd.Function):
    """:func:`pair_mlp` with :func:`pair_mlp_bwd` as its backward. Saves
    only the inputs (the backward recomputes the forward), never the
    [B, N, N, hidden] activations. Takes the arguments of :func:`pair_mlp`
    positionally; ``fi``, ``fj``, ``wfe`` may be None."""

    @staticmethod
    def forward(ctx, *args):
        ctx.save_for_backward(*args)
        return pair_mlp(*args)

    @staticmethod
    def backward(ctx, g):
        grads = pair_mlp_bwd(g.contiguous(), *ctx.saved_tensors)
        return tuple(d if need else None for d, need in zip(grads, ctx.needs_input_grad))
