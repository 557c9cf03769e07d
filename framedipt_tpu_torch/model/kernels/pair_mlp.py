"""Pair MLP of the edge transition: CUDA kernel wrapper and plain version.

Computes, per pair (i, j) of a [B, Nr, Nc, C_in] edge tensor,

    y0  = relu(pair @ W0 + i_term_i + j_term_j + b0)
    y1  = relu(y0 @ W1 + b1)
    out = y1 @ Wf (+ pair @ Wfe + fi_i + fj_j) + bf      # residual variant
    out = LayerNorm(out) * row_mask_i * col_mask_j

Each product accumulates in float32 and is rounded to the compute dtype;
LayerNorm statistics are float32 (eps 1e-6). ``residual=False`` (no
fi/fj/wfe) is the plain MLP variant.

:func:`pair_mlp` takes :func:`pair_mlp_plain` for CPU tensors, which exist
for the tests, and one of two kernels for CUDA tensors, as
:func:`forward_route` says: every float32 forward, differentiated or not,
launches ``csrc/pair_mlp_wg.cu`` (wgmma and TMA, 3xTF32), and every bf16
forward ``csrc/pair_mlp_wg_bf16.cu`` (wgmma and TMA, bf16). Each dtype's
backward recomputes the forward through the forward kernel's own tile code,
so its bits and the backward's relu decisions are the forward's.

The backward: :func:`pair_mlp_bwd` takes the backward kernels for CUDA
tensors (kernel A on wgmma and TMA, float32: ``csrc/pair_mlp_bwd_wg.cu``,
bf16: ``csrc/pair_mlp_bwd_wg_bf16.cu``; both share the row and column sums,
kernel B's code and the ordered sums) and :func:`pair_mlp_bwd_plain` for CPU
tensors. Both
recompute the forward from the inputs and return every input gradient;
:class:`PairMLPFunction` binds forward and backward for autograd and saves
only the inputs, never the [B, N, N, hidden] activations. In both dtypes the
kernels run per chunk of grid rows (:func:`plan_bwd_chunks`) with a
transient workspace of the chunk's activations and their gradients
(:func:`split_workspace_floats`).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from framedipt_tpu_torch.model.kernels.build import library
from framedipt_tpu_torch.model.layers import layer_norm_f32, matmul_f32

F32 = torch.float32
C_IN, HIDDEN, C_OUT = 128, 384, 128  # widths the kernel is built for


def _relu(x, mask):
    """relu(x), or, given the relu's decisions (bool, True where x counts as
    positive), x where they hold and 0 elsewhere."""
    return torch.relu(x) if mask is None else x * mask.to(x.dtype)


def _pre_norm(pair, i_term, j_term, w0, b0, w1, b1, wf, bf, fi, fj, wfe, relu_masks=None):
    """(y0, y1, pre-norm output), added in the kernels' order (b0 and bf
    not folded), which decides every relu mask; the forward kernel and the
    backward kernel's recompute follow it too (``common.cuh``).
    ``relu_masks``: the two relus' decisions, or None (their own)."""
    m0, m1 = (None, None) if relu_masks is None else relu_masks
    y0 = _relu(matmul_f32(pair, w0) + i_term[:, :, None, :] + j_term[:, None, :, :] + b0, m0)
    y1 = _relu(matmul_f32(y0, w1) + b1, m1)
    out = matmul_f32(y1, wf)
    if wfe is not None:
        out = out + matmul_f32(pair, wfe)
        out = out + fi[:, :, None, :] + fj[:, None, :, :]
    return y0, y1, out + bf


def pair_mlp_plain(
    pair, i_term, j_term, row_mask, col_mask,
    w0, b0, w1, b1, wf, bf, ln_scale, ln_bias,
    fi=None, fj=None, wfe=None, relu_masks=None,
):
    """Plain PyTorch version of the kernel (the XLA twin's formulation).
    ``relu_masks``: see :func:`pair_mlp_bwd_plain`."""
    _, _, out = _pre_norm(pair, i_term, j_term, w0, b0, w1, b1, wf, bf, fi, fj, wfe, relu_masks)
    normed = layer_norm_f32(out, ln_scale, ln_bias)
    emask = row_mask[:, :, None] * col_mask[:, None, :]
    return (normed * emask[..., None].to(F32)).to(pair.dtype)


def pair_mlp_bwd_plain(
    g, pair, i_term, j_term, row_mask, col_mask,
    w0, b0, w1, b1, wf, bf, ln_scale, ln_bias,
    fi=None, fj=None, wfe=None, relu_masks=None,
):
    """Plain PyTorch version of the backward kernel: recompute the forward
    in :func:`pair_mlp_plain`'s order (b0 and bf not folded), then
    back-propagate step by step as the JAX package's backward kernel does.
    Returns (d_pair, d_i_term, d_j_term, d_row_mask, d_col_mask, d_w0, d_b0,
    d_w1, d_b1, d_wf, d_bf, d_ln_scale, d_ln_bias, d_fi, d_fj, d_wfe), summed
    in float32 and cast to each input's dtype (the last three None without
    the residual terms).

    ``relu_masks`` (bool [B, Nr, Nc, hidden] each, or None): the two relus'
    decisions (y0 > 0, y1 > 0) to take in place of this recompute's, for
    holding a kernel whose forward rounds otherwise against this arithmetic
    (the gradient jumps where a pre-activation rounds to the other side of
    0)."""
    dtype = pair.dtype
    residual = wfe is not None

    def t_dot(a, b):  # sum over every pair of a^T b, float32
        return torch.einsum("bijp,bijq->pq", a.to(F32), b.to(F32))

    y0, y1, out = _pre_norm(pair, i_term, j_term, w0, b0, w1, b1, wf, bf, fi, fj, wfe,
                            relu_masks)
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
    m0, m1 = (y0 > 0, y1 > 0) if relu_masks is None else relu_masks
    dy1 = matmul_f32(dxd, wf.t()) * m1.to(dtype)
    d_b1 = torch.sum(dy1.to(F32), dim=(0, 1, 2))
    d_w1 = t_dot(y0, dy1)
    # First layer.
    dy0 = matmul_f32(dy1, w1.t()) * m0.to(dtype)
    d_w0 = t_dot(pair, dy0)
    d_i_term = torch.sum(dy0.to(F32), dim=2)
    d_j_term = torch.sum(dy0.to(F32), dim=1)
    d_pair = matmul_f32(dy0, w0.t())
    if residual:
        d_pair = d_pair + matmul_f32(dxd, wfe.t())
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
# The grid-reduced gradients (float32), in this order: d_w0, d_w1, d_wf,
# d_b1, d_bf, d_ln_scale, d_ln_bias, then d_wfe (residual only). Mirrors the
# offsets in csrc/pair_mlp_split.cuh.
_W_PARTS = (
    ("w0", (C_IN, HIDDEN)), ("w1", (HIDDEN, HIDDEN)), ("wf", (HIDDEN, C_OUT)),
    ("b1", (HIDDEN,)), ("bf", (C_OUT,)), ("ln_scale", (C_OUT,)), ("ln_bias", (C_OUT,)),
    ("wfe", (C_IN, C_OUT)),
)
W_PART_FLOATS = sum(int(np.prod(shape)) for _, shape in _W_PARTS)
ROW_PART = HIDDEN + C_OUT + 1  # d_i_term | d_fi | d_row_mask per row

# The backward (csrc/pair_mlp_split.cuh; kernel A in csrc/pair_mlp_bwd_wg.cu,
# float32, and csrc/pair_mlp_bwd_wg_bf16.cu, bf16): the split tile of flat
# pairs (bf16's kernel A runs two a 128-pair tile, one a warpgroup);
# per pair in the workspace y0, y1, dy1, dy0 (HIDDEN each) in the dtype, in
# bf16 also dxd = bf16(dx) (C_OUT), then float32 dx (C_OUT) and dem (1);
# kernel B's K slices, each a partial set of W_PART_FLOATS; one vector
# partial (d_b1 | d_bf | d_ln_scale | d_ln_bias) per tile, summed
# SPLIT_GROUP at a time, then the groups.
SPLIT_TILE = 64
SPLIT_PAIR_FLOATS = {torch.float32: 4 * HIDDEN + C_OUT + 1,
                     torch.bfloat16: (4 * HIDDEN + C_OUT) // 2 + C_OUT + 1}
SPLIT_SLICES = 8
SPLIT_GROUP = 32
SPLIT_VEC = HIDDEN + 3 * C_OUT
BWD_WORKSPACE_CAP = 1 << 30  # bytes of one chunk's workspace
# The wgmma forward's scratch: each weight's TF32 hi and lo parts, K-major
# (mirrors kSplitFloats in csrc/pair_mlp_wg.cuh); the float32 backward takes
# two (the forward's and the chain's).
WG_SPLIT_FLOATS = 2 * (C_IN * HIDDEN + HIDDEN * HIDDEN + HIDDEN * C_OUT + C_IN * C_OUT)


@functools.cache
def _wg_kernel():
    """The C entry point of csrc/pair_mlp_wg.cu, built and bound at first use."""
    fn = library("pair_mlp_wg").fdk_pair_mlp_wg
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 18 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    return fn


@functools.cache
def _wg_bf16_kernel():
    """The C entry point of csrc/pair_mlp_wg_bf16.cu, built and bound at
    first use."""
    fn = library("pair_mlp_wg_bf16").fdk_pair_mlp_wg_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 17 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    return fn


def forward_route(dtype: torch.dtype) -> str:
    """Which kernel a pair-MLP forward on CUDA tensors launches, with or
    without gradients: "wgmma" (``csrc/pair_mlp_wg.cu``) in float32,
    "wgmma_bf16" (``csrc/pair_mlp_wg_bf16.cu``) in bf16; the backward takes
    the same rule (``csrc/pair_mlp_bwd_wg.cu``, ``csrc/pair_mlp_bwd_wg_bf16.cu``),
    its kernel A recomputing through that forward's tile code. The edge
    embedder has a rule of its own (:func:`.edge_embedder.forward_route`)."""
    return "wgmma" if dtype == torch.float32 else "wgmma_bf16"


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (ties away from zero), as float32:
    ``cvt.rna.tf32.f32``, which the kernels split their operands with."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def wgmma_weight_split(w0, w1, wf, wfe=None) -> torch.Tensor:
    """What the wgmma kernel's first step (``prepare_weights`` in
    ``csrc/pair_mlp_wg.cu``) writes to its scratch, in PyTorch: for W0, W1,
    Wf and Wfe in turn ([in, out] float32 each), hi = tf32(w^T) and then lo =
    tf32(w^T - hi), both K-major ([out, in]); WG_SPLIT_FLOATS floats, Wfe's
    part zero without the residual terms (the kernel leaves it unwritten).
    hi + lo holds w to about 2^-22 of its size."""
    parts = []
    for w, shape in ((w0, (C_IN, HIDDEN)), (w1, (HIDDEN, HIDDEN)), (wf, (HIDDEN, C_OUT)),
                     (wfe, (C_IN, C_OUT))):
        wt = torch.zeros(shape[::-1], dtype=F32) if w is None else w.t().to(F32).contiguous()
        hi = tf32_rna(wt)
        parts += [hi.flatten(), tf32_rna(wt - hi).flatten()]
    return torch.cat(parts)


def chain_weight_split(w0, w1, wf, wfe=None) -> torch.Tensor:
    """What the float32 backward's first step writes for its input-gradient
    chain (``prepare_weights<false>`` in ``csrc/pair_mlp_wg.cuh``), in
    PyTorch: the chain's products are the forward's on Wf^T, W1^T, W0^T and
    Wfe^T, whose K-major layout is each weight as stored, so the slots hold
    Wf, W1, W0 and Wfe untransposed, split into TF32 hi and lo.
    WG_SPLIT_FLOATS floats, Wfe's part zero without the residual terms."""
    return wgmma_weight_split(wf.t(), w1.t(), w0.t(), None if wfe is None else wfe.t())


def wgmma_tf32_probe(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """d = a @ b.T from one m64n64k8 TF32 wgmma (``csrc/pair_mlp_wg.cu``)
    with b's raw float32 values in shared memory: a [64, 8] (TF32 values),
    b [64, 8] float32 on the card; d [64, 64]. Shows how the tensor cores
    read a float32 operand that is not a TF32 value."""
    if a.shape != (64, 8) or b.shape != (64, 8) or a.device.type != "cuda":
        raise ValueError("wgmma_tf32_probe: a and b are [64, 8] on the card")
    a, b = a.float().contiguous(), b.float().contiguous()
    d = torch.empty(64, 64, dtype=F32, device=a.device)
    fn = library("pair_mlp_wg").fdk_wgmma_tf32_probe
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), b.data_ptr(), d.data_ptr(),
                 torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wgmma_tf32_probe launch failed: cudaError_t {err}")
    return d


@functools.cache
def _bwd_wg_bf16_kernel():
    """The C entry point of csrc/pair_mlp_bwd_wg_bf16.cu (one chunk, bf16),
    built and bound at first use."""
    fn = library("pair_mlp_bwd_wg_bf16").fdk_pair_mlp_bwd_wg_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 19 + [ctypes.c_longlong] + [
        ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
    return fn


@functools.cache
def _bwd_wg_kernel():
    """The C entry point of csrc/pair_mlp_bwd_wg.cu (one chunk, float32),
    built and bound at first use."""
    fn = library("pair_mlp_bwd_wg").fdk_pair_mlp_bwd_wg
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 19 + [ctypes.c_longlong] + [
        ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
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


# The kernels stream the weights (and the backward's kernel B the pair
# tensor) 16 bytes at a time, and read the first layer's terms two elements
# at a time; the wgmma kernels read the residual terms two at a time.
_ALIGN = {"w0": 16, "w1": 16, "wf": 16, "wfe": 16, "pair": 16, "i_term": 8, "j_term": 8, "b0": 8,
          "fi": 4, "fj": 4}


def _check_aligned(fn_name, **tensors):
    for name, t in tensors.items():
        if t is not None and t.data_ptr() % _ALIGN[name]:
            raise ValueError(f"{fn_name}: {name} is not {_ALIGN[name]}-byte aligned")


def pair_mlp(
    pair, i_term, j_term, row_mask, col_mask,
    w0, b0, w1, b1, wf, bf, ln_scale, ln_bias,
    fi=None, fj=None, wfe=None,
):
    """Masked-LayerNorm pair MLP, [B, Nr, Nc, C_out] in pair's dtype.

    CPU tensors take :func:`pair_mlp_plain`; CUDA tensors launch the kernel
    that :func:`forward_route` names for the dtype, or raise. Weights are
    [in, out]; masks are in the compute dtype, ln_scale/ln_bias float32.
    Adds one to ``pair_mlp.launches`` per launch, and to
    ``pair_mlp.launches_wgmma`` or ``pair_mlp.launches_wgmma_bf16`` by
    route."""
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
    route = forward_route(pair.dtype)
    # The kernels bring the pair rows by TMA (16-byte aligned).
    _check_aligned("pair_mlp", w0=w0, w1=w1, wf=wf, wfe=wfe, i_term=i_term, j_term=j_term,
                   b0=b0, pair=pair, fi=fi, fj=fj)
    dev = pair.device
    out = torch.empty((B, Nr, Nc, C_OUT), dtype=pair.dtype, device=dev)
    ptrs = (_ptr(pair), _ptr(i_term), _ptr(j_term), _ptr(fi), _ptr(fj),
            _ptr(row_mask), _ptr(col_mask),
            _ptr(w0), _ptr(b0), _ptr(w1), _ptr(b1), _ptr(wf), _ptr(bf), _ptr(wfe),
            _ptr(ln_scale), _ptr(ln_bias), _ptr(out))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if route == "wgmma":
            # The kernel's first step writes the weights' K-major TF32 hi and
            # lo parts here (2 MB) each call; caching them beside the other
            # layouts that model/ipa.py rebuilds each forward is ROADMAP
            # queue 4 item 3.
            split = torch.empty(WG_SPLIT_FLOATS, dtype=F32, device=dev)
            err = _wg_kernel()(int(residual), *ptrs, _ptr(split), B, Nr, Nc, stream)
        else:
            err = _wg_bf16_kernel()(int(residual), *ptrs, B, Nr, Nc, stream)
    if err != 0:
        raise RuntimeError(f"pair_mlp kernel launch failed ({route}): cudaError_t {err}")
    pair_mlp.launches += 1
    pair_mlp.launches_wgmma += route == "wgmma"
    pair_mlp.launches_wgmma_bf16 += route == "wgmma_bf16"
    return out


pair_mlp.launches = pair_mlp.launches_wgmma = pair_mlp.launches_wgmma_bf16 = 0


def split_workspace_floats(pairs: int, dtype: torch.dtype = F32) -> int:
    """Float32 words of the backward's workspace for a chunk of ``pairs``
    pairs in ``dtype``: the per-pair activations and gradients, kernel B's
    slice partials and the tiles' vector partials (mirrors
    ``split_ws_floats`` in csrc/pair_mlp_split.cuh)."""
    groups = -(-(-(-pairs // SPLIT_TILE)) // SPLIT_GROUP)
    return (pairs * SPLIT_PAIR_FLOATS[dtype] + SPLIT_SLICES * W_PART_FLOATS
            + (groups * SPLIT_GROUP + groups) * SPLIT_VEC)


def plan_row_chunks(rows: int, Nc: int, cap_bytes: int, ws_floats,
                    pair_floats: int) -> list[tuple[int, int]]:
    """Chunks (m0, m1) of ``rows`` grid rows of Nc pairs, in order, that
    tile the rows exactly, of near-equal size, each with a workspace of
    ``ws_floats(pairs)`` floats of at most ``cap_bytes`` (one row a chunk
    where even one row exceeds it); ``pair_floats``, the workspace's floats
    a pair, gives the first guess."""
    if rows == 0 or Nc == 0:
        return []
    per = max(1, min(rows, (cap_bytes // 4 - ws_floats(0)) // (Nc * pair_floats + 1)))
    while per > 1 and 4 * ws_floats(per * Nc) > cap_bytes:
        per -= 1
    n = -(-rows // per)
    per = -(-rows // n)
    return [(m, min(rows, m + per)) for m in range(0, rows, per)]


def plan_bwd_chunks(B: int, Nr: int, Nc: int, cap_bytes: int = BWD_WORKSPACE_CAP,
                    dtype: torch.dtype = F32) -> list[tuple[int, int]]:
    """Chunks (m0, m1) of the flat [B * Nr] grid rows, in order, that tile
    the rows exactly, of near-equal size, each with a workspace in ``dtype``
    of at most ``cap_bytes`` (one row a chunk where even one row exceeds
    it)."""
    return plan_row_chunks(B * Nr, Nc, cap_bytes,
                           lambda pairs: split_workspace_floats(pairs, dtype),
                           SPLIT_PAIR_FLOATS[dtype])


def pair_mlp_bwd(
    g, pair, i_term, j_term, row_mask, col_mask,
    w0, b0, w1, b1, wf, bf, ln_scale, ln_bias,
    fi=None, fj=None, wfe=None, *, workspace_cap: int = BWD_WORKSPACE_CAP,
    recompute=None,
):
    """Every input gradient of :func:`pair_mlp` for the cotangent ``g``, in
    :func:`pair_mlp_bwd_plain`'s order and dtypes.

    CPU tensors take :func:`pair_mlp_bwd_plain`; CUDA tensors launch the
    backward kernels (or raise): kernel A recomputes the forward on wgmma
    and TMA through the forward kernel's tile, in float32
    ``csrc/pair_mlp_bwd_wg.cu``, in bf16 ``csrc/pair_mlp_bwd_wg_bf16.cu``.
    The grid runs in the chunks of
    :func:`plan_bwd_chunks` (each workspace at most ``workspace_cap``
    bytes); the grid-reduced gradients are summed in float32 from partials
    in a fixed order (no atomics), the chunks' sums added in chunk order, so
    two launches on the same inputs give the same bits. ``recompute``, a
    dict, if given, receives the kernels' recompute, which runs the forward
    kernel's code: "out" (the same bits as :func:`pair_mlp`), "y0" and "y1"
    ([B, Nr, Nc, hidden] in pair's dtype: the activations whose relu
    decisions the gradients take). Adds one to ``pair_mlp_bwd.launches`` per
    call, and to ``pair_mlp_bwd.launches_wgmma`` or
    ``pair_mlp_bwd.launches_wgmma_bf16`` by route (:func:`forward_route`'s
    rule)."""
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
    _check_aligned("pair_mlp_bwd", w0=w0, w1=w1, wf=wf, wfe=wfe, pair=pair, i_term=i_term,
                   j_term=j_term, b0=b0)
    route = forward_route(dtype)
    if route == "wgmma":
        # Kernel A's first step writes the weights' TF32 parts here: the
        # forward's, then the chain's (chain_weight_split: the stored
        # weights, untransposed). bf16's kernel A reads the stored weights.
        split = torch.empty(2 * WG_SPLIT_FLOATS, dtype=F32, device=dev)
    d_pair = torch.empty_like(pair)
    inputs = [_ptr(g), _ptr(pair), _ptr(i_term), _ptr(j_term), _ptr(fi), _ptr(fj),
              _ptr(row_mask), _ptr(col_mask),
              _ptr(w0), _ptr(b0), _ptr(w1), _ptr(b1), _ptr(wf), _ptr(bf), _ptr(wfe),
              _ptr(ln_scale), _ptr(ln_bias)]
    fwd_out = None
    if recompute is not None:
        recompute.update({k: torch.empty(B, Nr, Nc, c, dtype=dtype, device=dev)
                          for k, c in (("out", C_OUT), ("y0", HIDDEN), ("y1", HIDDEN))})
        fwd_out = _ptr(recompute["out"])
    # Outputs zeroed: the chunks add to them in order.
    out = torch.zeros(W_PART_FLOATS + (B * Nr + B * Nc) * ROW_PART, dtype=F32, device=dev)
    wred, rowred, colred = torch.split(out, [W_PART_FLOATS, B * Nr * ROW_PART, B * Nc * ROW_PART])
    sums = (_ptr(wred), _ptr(rowred), _ptr(colred), B, Nr, Nc)
    chunks = plan_bwd_chunks(B, Nr, Nc, workspace_cap, dtype)
    if chunks:
        n_ws = split_workspace_floats(max(m1 - m0 for m0, m1 in chunks) * Nc, dtype)
        ws = torch.empty(n_ws, dtype=F32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            for m0, m1 in chunks:
                if route == "wgmma":
                    err = _bwd_wg_kernel()(
                        int(residual), *inputs, _ptr(d_pair), _ptr(ws), n_ws,
                        _ptr(split), *sums, m0, m1, fwd_out, stream)
                else:
                    err = _bwd_wg_bf16_kernel()(
                        int(residual), *inputs, _ptr(d_pair), _ptr(ws), n_ws, *sums, m0, m1,
                        fwd_out, stream)
                if err != 0:
                    raise RuntimeError(
                        f"pair_mlp_bwd kernel launch failed ({route}): cudaError_t {err}")
                if recompute is not None:  # the workspace starts with y0, then y1
                    n, acts = (m1 - m0) * Nc * HIDDEN, ws.view(dtype)
                    for k, part in (("y0", acts[:n]), ("y1", acts[n:2 * n])):
                        recompute[k].view(-1, HIDDEN)[m0 * Nc:m1 * Nc] = part.view(-1, HIDDEN)
        del ws
        pair_mlp_bwd.launches += 1
        pair_mlp_bwd.launches_wgmma += route == "wgmma"
        pair_mlp_bwd.launches_wgmma_bf16 += route == "wgmma_bf16"

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


pair_mlp_bwd.launches = pair_mlp_bwd.launches_wgmma = pair_mlp_bwd.launches_wgmma_bf16 = 0


class PairMLPFunction(torch.autograd.Function):
    """:func:`pair_mlp` with :func:`pair_mlp_bwd` as its backward. Saves
    only the inputs (the backward recomputes the forward), never the
    [B, N, N, hidden] activations. Takes the arguments of :func:`pair_mlp`
    positionally; ``fi``, ``fj``, ``wfe`` may be None."""

    @staticmethod
    def forward(ctx, pair, i_term, j_term, row_mask, col_mask, w0, b0, w1, b1, wf, bf,
                ln_scale, ln_bias, fi=None, fj=None, wfe=None):
        args = (pair, i_term, j_term, row_mask, col_mask, w0, b0, w1, b1, wf, bf,
                ln_scale, ln_bias, fi, fj, wfe)
        ctx.save_for_backward(*args)
        return pair_mlp(*args)

    @staticmethod
    def backward(ctx, g):
        grads = pair_mlp_bwd(g.contiguous(), *ctx.saved_tensors)
        # One gradient an input.
        return tuple(d if need else None for d, need in zip(grads, ctx.needs_input_grad))
