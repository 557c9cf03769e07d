"""Embedder edge branch: CUDA kernel wrapper and plain version.

Per pair (i, j), from O(N) inputs only:

    x = (G_i * H_j) @ W_rel                  # rel-offset sinusoid, CP form
      + W_dist[bin(|ca_i - ca_j|)]           # distogram one-hot row, or 0
      + i_term_i + j_term_j
    x = relu(x + b0); x = relu(x @ W1 + b1); x = x @ W2 + b2
    out = LayerNorm(x) * row_mask_i * col_mask_j

``G, H`` (:func:`rel_cp_factors`) are per-residue factors whose product
sums, through the row-duplicated kernel :func:`expand_w_rel`, to the
sinusoid embedding of ``seq_idx_i - seq_idx_j``. A distance bin n holds
``lower[n] < d < upper[n]``, strictly, so d = 0 and a distance on an edge
give no bin. Products accumulate in float32 and are rounded to the compute
dtype; LayerNorm statistics are float32 (eps 1e-6).

:func:`edge_embedder` takes the kernel (``csrc/edge_embedder.cu``) for CUDA
tensors and :func:`edge_embedder_plain` for CPU tensors.
:class:`EdgeEmbedderFunction` makes it differentiable: its backward is the
VJP of the plain formulation recomputed from the saved O(N) inputs (the JAX
package's ``pallas_emb_bwd_impl="xla"``); the backward kernel is not ported
yet.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from framedipt_tpu_torch.model.kernels.build import library
from framedipt_tpu_torch.model.layers import layer_norm_f32

F32 = torch.float32
CP, C = 64, 128  # CP-factor and edge widths the kernel is built for
MAX_BINS = 64


def rel_cp_factors(
    seq_idx: torch.Tensor, embed_size: int, max_len: int = 2056
) -> tuple[torch.Tensor, torch.Tensor]:
    """CP factors G, H [..., 2*embed_size]: for every frequency x_k,
    sin((i-j)x_k) = s_i c_j + c_i (-s_j) and cos((i-j)x_k) = c_i c_j + s_i s_j.
    Layout G = [s, c, c, s], H = [c, -s, c, s]."""
    k = np.arange(embed_size // 2, dtype=np.float32)
    x = torch.as_tensor(
        (np.pi / max_len ** (2.0 * k / embed_size)).astype(np.float32),
        device=seq_idx.device,
    )
    ang = seq_idx.to(F32)[..., None] * x
    s, c = torch.sin(ang), torch.cos(ang)
    return torch.cat([s, c, c, s], dim=-1), torch.cat([c, -s, c, s], dim=-1)


def expand_w_rel(w_rel: torch.Tensor) -> torch.Tensor:
    """Duplicate the rel-embedding kernel rows [2K, C] -> [4K, C] to match
    the CP factor layout (sin rows first, then cos rows)."""
    K = w_rel.shape[0] // 2
    ws, wc = w_rel[:K], w_rel[K:]
    return torch.cat([ws, ws, wc, wc], dim=0)


def edge_embedder_plain(
    g, h, pos_rows, pos_cols, i_term, j_term, row_mask, col_mask,
    w_rel, w_dist, b0, w1, b1, w2, b2, ln_scale, ln_bias,
    bins_lower, bins_upper,
):
    """Plain PyTorch version of the kernel (the XLA twin's formulation)."""
    dtype = g.dtype

    def mm(x, w):
        return torch.matmul(x.to(F32), w.to(F32)).to(dtype)

    m = g[:, :, None, :] * h[:, None, :, :]
    x = mm(m, w_rel)
    diff = pos_rows.to(F32)[:, :, None, :] - pos_cols.to(F32)[:, None, :, :]
    d = torch.sqrt(torch.sum(diff * diff, dim=-1))
    lower = torch.as_tensor(bins_lower, dtype=F32, device=g.device)
    upper = torch.as_tensor(bins_upper, dtype=F32, device=g.device)
    onehot = ((d[..., None] > lower) & (d[..., None] < upper)).to(dtype)
    x = x + mm(onehot, w_dist)
    x = x + i_term[:, :, None, :] + j_term[:, None, :, :]
    x = torch.relu(x + b0)
    x = torch.relu(mm(x, w1) + b1)
    x = mm(x, w2) + b2
    normed = layer_norm_f32(x, ln_scale, ln_bias)
    emask = row_mask[:, :, None] * col_mask[:, None, :]
    return (normed * emask[..., None].to(F32)).to(dtype)


@functools.lru_cache(maxsize=16)
def _bin_edges(lower: tuple, upper: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor([lower, upper], dtype=F32, device=device).contiguous()


def _check(name, t, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"edge_embedder: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"edge_embedder: {name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"edge_embedder: {name} has shape {tuple(t.shape)}, expected {shape}"
        )
    if not t.is_contiguous():
        raise ValueError(f"edge_embedder: {name} is not contiguous")


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _kernel():
    """The C entry point of csrc/edge_embedder.cu, built and bound at first
    use."""
    fn = library("edge_embedder").fdk_edge_embedder
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 20 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    return fn


def edge_embedder(
    g, h, pos_rows, pos_cols, i_term, j_term, row_mask, col_mask,
    w_rel, w_dist, b0, w1, b1, w2, b2, ln_scale, ln_bias,
    bins_lower, bins_upper,
):
    """Masked-LayerNorm embedder edge output, [B, Nr, Nc, C] in g's dtype.

    CPU tensors take :func:`edge_embedder_plain`; CUDA tensors launch the
    kernel (or raise). Coordinates and ln_scale/ln_bias are float32, every
    other tensor in the compute dtype; bins_lower/upper are tuples of
    floats, empty when the model embeds no self-conditioning distogram.
    Adds one to ``edge_embedder.launches`` per launch."""
    if g.device.type == "cpu":
        return edge_embedder_plain(
            g, h, pos_rows, pos_cols, i_term, j_term, row_mask, col_mask,
            w_rel, w_dist, b0, w1, b1, w2, b2, ln_scale, ln_bias,
            bins_lower, bins_upper,
        )
    if g.device.type != "cuda":
        raise ValueError(f"edge_embedder: unsupported device {g.device}")
    dtype, dev = g.dtype, g.device
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"edge_embedder: unsupported dtype {dtype}")
    B, Nr, cp = g.shape
    Nc = h.shape[1]
    n_bins = len(bins_lower)
    if (cp, w1.shape[0]) != (CP, C) or not 0 <= n_bins <= MAX_BINS:
        raise ValueError(
            f"edge_embedder: kernel is built for CP {CP}, width {C}, <= {MAX_BINS} "
            f"bins; got {cp}, {w1.shape[0]}, {n_bins}"
        )
    if len(bins_upper) != n_bins:
        raise ValueError("edge_embedder: bins_lower and bins_upper differ in length")
    for name, t, shape, dt in [
        ("g", g, (B, Nr, CP), dtype),
        ("h", h, (B, Nc, CP), dtype),
        ("pos_rows", pos_rows, (B, Nr, 3), F32),
        ("pos_cols", pos_cols, (B, Nc, 3), F32),
        ("i_term", i_term, (B, Nr, C), dtype),
        ("j_term", j_term, (B, Nc, C), dtype),
        ("row_mask", row_mask, (B, Nr), dtype),
        ("col_mask", col_mask, (B, Nc), dtype),
        ("w_rel", w_rel, (CP, C), dtype),
        ("w_dist", w_dist, (n_bins, C), dtype),
        ("b0", b0, (C,), dtype),
        ("w1", w1, (C, C), dtype),
        ("b1", b1, (C,), dtype),
        ("w2", w2, (C, C), dtype),
        ("b2", b2, (C,), dtype),
        ("ln_scale", ln_scale, (C,), F32),
        ("ln_bias", ln_bias, (C,), F32),
    ]:
        _check(name, t, shape, dt, dev)
    edges = _bin_edges(
        tuple(float(x) for x in bins_lower), tuple(float(x) for x in bins_upper), dev
    )

    out = torch.empty((B, Nr, Nc, C), dtype=dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel()(
            _DTYPE_CODE[dtype],
            g.data_ptr(), h.data_ptr(), pos_rows.data_ptr(), pos_cols.data_ptr(),
            i_term.data_ptr(), j_term.data_ptr(), row_mask.data_ptr(), col_mask.data_ptr(),
            w_rel.data_ptr(), w_dist.data_ptr(), edges[0].data_ptr(), edges[1].data_ptr(),
            b0.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            ln_scale.data_ptr(), ln_bias.data_ptr(), out.data_ptr(),
            n_bins, B, Nr, Nc, stream,
        )
    if err != 0:
        raise RuntimeError(f"edge_embedder kernel launch failed: cudaError_t {err}")
    edge_embedder.launches += 1
    return out


edge_embedder.launches = 0


class EdgeEmbedderFunction(torch.autograd.Function):
    """:func:`edge_embedder` for autograd. Arguments: the backward setting
    (``model.ipa.pallas_emb_bwd_impl``), then :func:`edge_embedder`'s
    arguments with the bin edges first: ``(bwd_impl, bins_lower,
    bins_upper, g, h, pos_rows, ..., ln_bias)``.

    Saves only the O(N) inputs. With "xla" the backward recomputes
    :func:`edge_embedder_plain` from them under autograd and returns its
    VJP, the JAX package's own formulation of this backward (not a stand-in
    for a missing kernel); "pallas", the backward kernel, is not ported yet
    and raises. The coordinates get no gradient (None): in the JAX package
    theirs is exactly 0, and the self-conditioning CA never requires one."""

    @staticmethod
    def forward(ctx, bwd_impl, bins_lower, bins_upper, *args):
        ctx.bwd_impl, ctx.bins = bwd_impl, (bins_lower, bins_upper)
        ctx.save_for_backward(*args)
        return edge_embedder(*args, bins_lower, bins_upper)

    @staticmethod
    def backward(ctx, grad):
        if ctx.bwd_impl != "xla":
            raise NotImplementedError(
                f"edge embedder backward {ctx.bwd_impl!r}: the backward kernel is not "
                "ported yet (ROADMAP queue 2 item 2); use model.ipa.pallas_emb_bwd_impl=xla"
            )
        needs = list(ctx.needs_input_grad[3:])
        needs[2] = needs[3] = False  # pos_rows, pos_cols
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(need) for t, need in zip(ctx.saved_tensors, needs)]
            out = edge_embedder_plain(*inputs, *ctx.bins)
            wanted = [t for t, need in zip(inputs, needs) if need]
            got = iter(torch.autograd.grad(out, wanted, grad) if wanted else ())
        return (None, None, None) + tuple(next(got) if need else None for need in needs)
