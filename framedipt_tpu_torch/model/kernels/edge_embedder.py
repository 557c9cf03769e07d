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

:func:`edge_embedder` takes :func:`edge_embedder_plain` for CPU tensors and
one of two kernels for CUDA tensors, as :func:`forward_route` says: every
float32 forward, differentiated or not, launches ``csrc/edge_embedder_wg.cu``
(wgmma and TMA, 3xTF32), every bf16 forward ``csrc/edge_embedder.cu``
(``mma.sync``); each dtype's backward recomputes through that kernel's tile
code bit for bit. The backward: :func:`edge_embedder_bwd` takes the backward
kernels for CUDA tensors (float32: kernel A on wgmma and TMA,
``csrc/edge_embedder_bwd_wg.cu``; bf16: ``csrc/edge_embedder_bwd.cu``) and
:func:`edge_embedder_bwd_plain` for CPU tensors; both recompute the forward
from the O(N) inputs and return every input gradient but the coordinates'.
In both dtypes the kernels run per chunk of grid rows
(:func:`plan_bwd_chunks`) with a transient workspace of the chunk's
activations and their gradients (:func:`split_workspace_floats`).
:class:`EdgeEmbedderFunction` binds them for autograd; with
``pallas_emb_bwd_impl="xla"`` its backward is instead the VJP of the plain
formulation (the JAX package's remat twin).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from framedipt_tpu_torch.model.kernels.build import library
from framedipt_tpu_torch.model.kernels.pair_mlp import _relu, plan_row_chunks, tf32_rna
from framedipt_tpu_torch.model.layers import layer_norm_f32, matmul_f32

F32 = torch.float32
CP, C = 64, 128  # CP-factor and edge widths the kernel is built for
MAX_BINS = 64
# The wgmma forward's scratch: each weight's TF32 hi and lo parts, K-major
# (mirrors kSplitFloats in csrc/edge_embedder_wg.cu).
WG_SPLIT_FLOATS = 2 * (CP * C + 2 * C * C)


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


def _pre_norm(g, h, pos_rows, pos_cols, i_term, j_term, w_rel, w_dist, b0, w1, b1, w2, b2,
              bins_lower, bins_upper, relu_masks=None):
    """(m, onehot, y0, y1, pre-norm output), added in the kernels' order
    (b0 after the node terms), which decides every relu mask; the forward
    kernel and the backward kernels' recompute follow it (``common.cuh``).
    ``relu_masks``: the two relus' decisions, or None (their own)."""
    m = g[:, :, None, :] * h[:, None, :, :]
    diff = pos_rows.to(F32)[:, :, None, :] - pos_cols.to(F32)[:, None, :, :]
    d = torch.sqrt(torch.sum(diff * diff, dim=-1))
    lower = torch.as_tensor(bins_lower, dtype=F32, device=g.device)
    upper = torch.as_tensor(bins_upper, dtype=F32, device=g.device)
    onehot = ((d[..., None] > lower) & (d[..., None] < upper)).to(g.dtype)
    m0, m1 = (None, None) if relu_masks is None else relu_masks
    x = matmul_f32(m, w_rel) + matmul_f32(onehot, w_dist)
    y0 = _relu(x + i_term[:, :, None, :] + j_term[:, None, :, :] + b0, m0)
    y1 = _relu(matmul_f32(y0, w1) + b1, m1)
    return m, onehot, y0, y1, matmul_f32(y1, w2) + b2


def edge_embedder_plain(
    g, h, pos_rows, pos_cols, i_term, j_term, row_mask, col_mask,
    w_rel, w_dist, b0, w1, b1, w2, b2, ln_scale, ln_bias,
    bins_lower, bins_upper, relu_masks=None,
):
    """Plain PyTorch version of the kernel (the XLA twin's formulation).
    ``relu_masks``: see :func:`edge_embedder_bwd_plain`."""
    *_, x = _pre_norm(g, h, pos_rows, pos_cols, i_term, j_term, w_rel, w_dist, b0, w1, b1,
                      w2, b2, bins_lower, bins_upper, relu_masks)
    normed = layer_norm_f32(x, ln_scale, ln_bias)
    emask = row_mask[:, :, None] * col_mask[:, None, :]
    return (normed * emask[..., None].to(F32)).to(g.dtype)


def edge_embedder_bwd_plain(
    grad, g, h, pos_rows, pos_cols, i_term, j_term, row_mask, col_mask,
    w_rel, w_dist, b0, w1, b1, w2, b2, ln_scale, ln_bias,
    *, bins_lower, bins_upper, relu_masks=None,
):
    """Plain PyTorch version of the backward kernels: recompute the forward
    in :func:`edge_embedder_plain`'s order, then back-propagate step by step
    as the JAX package's backward kernel does, for any widths. Returns the
    gradients in the forward's argument order: (d_g, d_h, None, None,
    d_i_term, d_j_term, d_row_mask, d_col_mask, d_w_rel, d_w_dist, d_b0,
    d_w1, d_b1, d_w2, d_b2, d_ln_scale, d_ln_bias), summed in float32 and
    cast to each input's dtype. The coordinates get None: the distogram is a
    step function of them (the JAX kernel returns zeros).

    ``relu_masks`` (bool [B, Nr, Nc, 128] each, or None): the two relus'
    decisions (y0 > 0, y1 > 0) to take in place of this recompute's, for
    holding a kernel whose forward rounds otherwise against this arithmetic
    (the gradient jumps where a pre-activation rounds to the other side of
    0)."""
    dtype = g.dtype

    def t_dot(a, b):  # sum over every pair of a^T b, float32
        return torch.einsum("bijp,bijq->pq", a.to(F32), b.to(F32))

    m, onehot, y0, y1, out = _pre_norm(g, h, pos_rows, pos_cols, i_term, j_term, w_rel, w_dist,
                                       b0, w1, b1, w2, b2, bins_lower, bins_upper, relu_masks)
    m0, m1 = (y0 > 0, y1 > 0) if relu_masks is None else relu_masks
    x = out.to(F32)
    mean = x.mean(dim=-1, keepdim=True)
    centered = x - mean
    var = (centered * centered).mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + 1e-6)
    xhat = centered * inv
    yln = xhat * ln_scale.to(F32) + ln_bias.to(F32)
    rmask, cmask = row_mask.to(F32), col_mask.to(F32)
    emask = (row_mask[:, :, None] * col_mask[:, None, :]).to(F32)

    gf = grad.to(F32)
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
    # Third layer; relu'(0) = 0.
    d_w2 = t_dot(y1, dxd)
    d_b2 = torch.sum(dx, dim=(0, 1, 2))
    dy1 = matmul_f32(dxd, w2.t()) * m1.to(dtype)
    # Second layer.
    d_w1 = t_dot(y0, dy1)
    d_b1 = torch.sum(dy1.to(F32), dim=(0, 1, 2))
    dy0 = matmul_f32(dy1, w1.t()) * m0.to(dtype)
    # First layer: the node terms, the distogram rows, the CP product.
    d_i_term = torch.sum(dy0.to(F32), dim=2)
    d_j_term = torch.sum(dy0.to(F32), dim=1)
    d_w_rel = t_dot(m, dy0)
    d_w_dist = t_dot(onehot, dy0)
    dm = torch.matmul(dy0.to(F32), w_rel.to(F32).t())
    d_g = torch.sum(dm * h.to(F32)[:, None, :, :], dim=2)
    d_h = torch.sum(dm * g.to(F32)[:, :, None, :], dim=1)
    d_b0 = torch.sum(d_i_term, dim=(0, 1))
    return (
        d_g.to(g.dtype), d_h.to(h.dtype), None, None,
        d_i_term.to(i_term.dtype), d_j_term.to(j_term.dtype),
        d_rm.to(row_mask.dtype), d_cm.to(col_mask.dtype),
        d_w_rel.to(w_rel.dtype), d_w_dist.to(w_dist.dtype), d_b0.to(b0.dtype),
        d_w1.to(w1.dtype), d_b1.to(b1.dtype), d_w2.to(w2.dtype), d_b2.to(b2.dtype),
        d_lns.to(ln_scale.dtype), d_lnb.to(ln_bias.dtype),
    )


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


@functools.cache
def _bwd_wg_kernel():
    """The C entry point of csrc/edge_embedder_bwd_wg.cu (one chunk, float32),
    built and bound at first use."""
    fn = library("edge_embedder_bwd_wg").fdk_edge_embedder_bwd_wg
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 21 + [ctypes.c_longlong] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2)
    return fn


@functools.cache
def _wg_kernel():
    """The C entry point of csrc/edge_embedder_wg.cu, built and bound at first
    use."""
    fn = library("edge_embedder_wg").fdk_edge_embedder_wg
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 21 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    return fn


def wgmma_weight_split(w_rel, w1, w2) -> torch.Tensor:
    """What the wgmma kernel's first step (``prepare_weights`` in
    ``csrc/edge_embedder_wg.cu``) writes to its scratch, in PyTorch: for the
    expanded W_rel [64, 128], W1 and W2 [128, 128] in turn (float32, [in,
    out]), hi = tf32(w^T) and then lo = tf32(w^T - hi), both K-major ([out,
    in]); WG_SPLIT_FLOATS floats."""
    parts = []
    for w in (w_rel, w1, w2):
        wt = w.t().to(F32).contiguous()
        hi = tf32_rna(wt)
        parts += [hi.flatten(), tf32_rna(wt - hi).flatten()]
    return torch.cat(parts)


def chain_weight_split(w_rel, w1, w2) -> torch.Tensor:
    """What the float32 backward's first step writes for its input-gradient
    chain (``prepare_weights<false>`` in ``csrc/edge_embedder_wg.cuh``),
    after the forward's split, in PyTorch: the chain's products are the
    forward's on W_rel^T, W1^T and W2^T, whose K-major layout is each weight
    as stored, so the forward's slots hold W_rel, W1 and W2 untransposed
    ([n, k]), split into TF32 hi and lo. WG_SPLIT_FLOATS floats."""
    return wgmma_weight_split(w_rel.t(), w1.t(), w2.t())


def _check_inputs(fn_name, g, h, pos_rows, pos_cols, i_term, j_term, row_mask, col_mask,
                  w_rel, w_dist, b0, w1, b1, w2, b2, ln_scale, ln_bias, bins_lower, bins_upper):
    """Shapes, dtypes, device and contiguity the kernels take; returns
    (B, Nr, Nc, n_bins)."""
    dtype, dev = g.dtype, g.device
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"{fn_name}: unsupported dtype {dtype}")
    B, Nr, cp = g.shape
    Nc = h.shape[1]
    n_bins = len(bins_lower)
    if (cp, w1.shape[0]) != (CP, C) or not 0 <= n_bins <= MAX_BINS:
        raise ValueError(
            f"{fn_name}: kernel is built for CP {CP}, width {C}, <= {MAX_BINS} "
            f"bins; got {cp}, {w1.shape[0]}, {n_bins}"
        )
    if len(bins_upper) != n_bins:
        raise ValueError(f"{fn_name}: bins_lower and bins_upper differ in length")
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
    return B, Nr, Nc, n_bins


def _check_aligned(fn_name, w_rel, w1, w2, i_term, j_term, b0, b1, b2, rows=()):
    """The tensor-core kernels stream the weights into shared memory 16 bytes
    at a time and read the per-channel terms two elements at a time; the
    wgmma kernel brings the row-side and column-side rows (``rows``: (name,
    tensor) pairs) by bulk copies and TMA, 16 bytes aligned."""
    for name, t, align in (("w_rel", w_rel, 16), ("w1", w1, 16), ("w2", w2, 16),
                           ("i_term", i_term, 8), ("j_term", j_term, 8), ("b0", b0, 8),
                           ("b1", b1, 8), ("b2", b2, 8), *((n, r, 16) for n, r in rows)):
        if t.data_ptr() % align:
            raise ValueError(f"{fn_name}: {name} is not {align}-byte aligned")


def _edges(bins_lower, bins_upper, dev) -> torch.Tensor:
    return _bin_edges(
        tuple(float(x) for x in bins_lower), tuple(float(x) for x in bins_upper), dev
    )


def forward_route(dtype: torch.dtype) -> str:
    """Which kernel an embedder forward on CUDA tensors launches: "wgmma"
    (``csrc/edge_embedder_wg.cu``) in float32 and "mma"
    (``csrc/edge_embedder.cu``) in bf16, with or without gradients: each
    dtype's backward recomputes through that kernel's
    tile code (float32's kernel A in ``csrc/edge_embedder_bwd_wg.cu`` through
    ``edge_embedder_wg.cuh``, bf16's in ``csrc/edge_embedder_bwd.cu`` through
    ``edge_embedder_tc.cuh``), so a differentiated forward's relu decisions
    are its backward's. The pair MLP's rule is the same, in a function of its
    own (:func:`.pair_mlp.forward_route`)."""
    return "wgmma" if dtype == torch.float32 else "mma"


def edge_embedder(
    g, h, pos_rows, pos_cols, i_term, j_term, row_mask, col_mask,
    w_rel, w_dist, b0, w1, b1, w2, b2, ln_scale, ln_bias,
    bins_lower, bins_upper,
):
    """Masked-LayerNorm embedder edge output, [B, Nr, Nc, C] in g's dtype.

    CPU tensors take :func:`edge_embedder_plain`; CUDA tensors launch the
    kernel that :func:`forward_route` names for the dtype, or raise. Coordinates and ln_scale/ln_bias are float32, every other tensor
    in the compute dtype; bins_lower/upper are tuples of floats, empty when
    the model embeds no self-conditioning distogram. Adds one to
    ``edge_embedder.launches`` per launch, and to
    ``edge_embedder.launches_wgmma`` or ``edge_embedder.launches_mma`` by
    route."""
    if g.device.type == "cpu":
        return edge_embedder_plain(
            g, h, pos_rows, pos_cols, i_term, j_term, row_mask, col_mask,
            w_rel, w_dist, b0, w1, b1, w2, b2, ln_scale, ln_bias,
            bins_lower, bins_upper,
        )
    if g.device.type != "cuda":
        raise ValueError(f"edge_embedder: unsupported device {g.device}")
    B, Nr, Nc, n_bins = _check_inputs(
        "edge_embedder", g, h, pos_rows, pos_cols, i_term, j_term, row_mask, col_mask,
        w_rel, w_dist, b0, w1, b1, w2, b2, ln_scale, ln_bias, bins_lower, bins_upper,
    )
    route = forward_route(g.dtype)
    _check_aligned("edge_embedder", w_rel, w1, w2, i_term, j_term, b0, b1, b2,
                   rows=(("g", g), ("h", h), ("i_term", i_term), ("j_term", j_term))
                   if route == "wgmma" else ())
    dtype, dev = g.dtype, g.device
    edges = _edges(bins_lower, bins_upper, dev)

    out = torch.empty((B, Nr, Nc, C), dtype=dtype, device=dev)
    ptrs = (g.data_ptr(), h.data_ptr(), pos_rows.data_ptr(), pos_cols.data_ptr(),
            i_term.data_ptr(), j_term.data_ptr(), row_mask.data_ptr(), col_mask.data_ptr(),
            w_rel.data_ptr(), w_dist.data_ptr(), edges[0].data_ptr(), edges[1].data_ptr(),
            b0.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            ln_scale.data_ptr(), ln_bias.data_ptr(), out.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if route == "wgmma":
            # The kernel's first step writes the weights' K-major TF32 hi and
            # lo parts here (320 KB) each call.
            split = torch.empty(WG_SPLIT_FLOATS, dtype=F32, device=dev)
            err = _wg_kernel()(*ptrs, split.data_ptr(), n_bins, B, Nr, Nc, stream)
        else:
            err = _kernel()(_DTYPE_CODE[dtype], *ptrs, n_bins, B, Nr, Nc, stream)
    if err != 0:
        raise RuntimeError(f"edge_embedder kernel launch failed ({route}): cudaError_t {err}")
    edge_embedder.launches += 1
    edge_embedder.launches_wgmma += route == "wgmma"
    edge_embedder.launches_mma += route == "mma"
    return out


edge_embedder.launches = edge_embedder.launches_wgmma = edge_embedder.launches_mma = 0


# The grid-summed gradients in float32, in this order (d_w_dist has MAX_BINS
# rows, the first n_bins used). Mirrors the offsets in
# csrc/edge_embedder_bwd.cu.
_W_PARTS = (
    ("w_rel", (CP, C)), ("w_dist", (MAX_BINS, C)), ("w1", (C, C)), ("w2", (C, C)),
    ("b1", (C,)), ("b2", (C,)), ("ln_scale", (C,)), ("ln_bias", (C,)),
)
W_PART_FLOATS = sum(int(np.prod(shape)) for _, shape in _W_PARTS)


def _w_parts(wred: torch.Tensor) -> dict[str, torch.Tensor]:
    """The grid-summed gradients, by name, as views of ``wred``."""
    parts, off = {}, 0
    for name, shape in _W_PARTS:
        n = int(np.prod(shape))
        parts[name] = wred[off : off + n].view(shape)
        off += n
    return parts


ROW_PART = CP + C + 1  # d_g | d_i_term | d_row_mask per row sum (columns alike)

# The backward (csrc/edge_embedder_split.cuh's workspace, filled by kernel A:
# float32 csrc/edge_embedder_bwd_wg.cu, bf16 csrc/edge_embedder_bwd.cu): per
# pair y0, y1, dx (bf16: dxd), dy1, dy0 (C each) and m (CP) in the dtype,
# then float32 dm (CP) and dem (1); kernel B's K slices, each a partial set
# of d_w_rel | d_w1 | d_w2; kernel A's vector partials (d_b1 | d_b2 |
# d_ln_scale | d_ln_bias | d_w_dist; float32: one a unit of one grid row
# and SPLIT_TILE columns, bf16: one a tile of SPLIT_TILE flat pairs), summed
# SPLIT_GROUP at a time, then the groups.
SPLIT_TILE = 64
SPLIT_PAIR_FLOATS = {torch.float32: 5 * C + 2 * CP + 1,
                     torch.bfloat16: (5 * C + CP) // 2 + CP + 1}
SPLIT_SLICES = 44
SPLIT_B_PARTS = CP * C + 2 * C * C
SPLIT_GROUP = 32
BWD_WORKSPACE_CAP = 1 << 30  # bytes of one chunk's workspace


def split_vec_floats(n_bins: int) -> int:
    """Floats of one tile's vector partial."""
    return (4 + n_bins) * C


def split_parts(rows: int, Nc: int, dtype: torch.dtype = F32) -> int:
    """Kernel A's vector partials for a chunk of ``rows`` grid rows of Nc
    pairs: float32 one a unit (a row's columns in runs of SPLIT_TILE, the
    last ragged), bf16 one a tile of SPLIT_TILE of the chunk's flat pairs."""
    if dtype == F32:
        return rows * -(-Nc // SPLIT_TILE)
    return -(-(rows * Nc) // SPLIT_TILE)


def split_workspace_floats(pairs: int, n_bins: int, dtype: torch.dtype = F32,
                           parts: int | None = None) -> int:
    """Float32 words of the backward's workspace for a chunk of ``pairs``
    pairs in ``dtype``: the per-pair activations and gradients, kernel B's
    slice partials and kernel A's ``parts`` vector partials
    (:func:`split_parts`; by default one a tile of SPLIT_TILE flat pairs)
    (mirrors ``split_ws_floats`` in csrc/edge_embedder_split.cuh)."""
    parts = -(-pairs // SPLIT_TILE) if parts is None else parts
    groups = -(-parts // SPLIT_GROUP)
    return (pairs * SPLIT_PAIR_FLOATS[dtype] + SPLIT_SLICES * SPLIT_B_PARTS
            + (groups * SPLIT_GROUP + groups) * split_vec_floats(n_bins))


def plan_bwd_chunks(B: int, Nr: int, Nc: int, n_bins: int, cap_bytes: int = BWD_WORKSPACE_CAP,
                    dtype: torch.dtype = F32) -> list[tuple[int, int]]:
    """Chunks (m0, m1) of the flat [B * Nr] grid rows, in order, that tile
    the rows exactly, of near-equal size, each with a workspace in ``dtype``
    of at most ``cap_bytes`` (one row a chunk where even one row exceeds
    it)."""
    return plan_row_chunks(
        B * Nr, Nc, cap_bytes,
        lambda pairs: split_workspace_floats(pairs, n_bins, dtype,
                                             split_parts(pairs // Nc, Nc, dtype)),
        SPLIT_PAIR_FLOATS[dtype])


@functools.cache
def _split_kernel():
    """The C entry point of csrc/edge_embedder_bwd.cu (one chunk a call),
    built and bound at first use."""
    fn = library("edge_embedder_bwd").fdk_edge_embedder_bwd_split
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 24 + [ctypes.c_longlong]
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2)
    return fn


def edge_embedder_bwd(
    grad, g, h, pos_rows, pos_cols, i_term, j_term, row_mask, col_mask,
    w_rel, w_dist, b0, w1, b1, w2, b2, ln_scale, ln_bias,
    *, bins_lower, bins_upper, workspace_cap: int = BWD_WORKSPACE_CAP, recompute=None,
):
    """Every input gradient of :func:`edge_embedder` for the cotangent
    ``grad`` but the coordinates' (None), in :func:`edge_embedder_bwd_plain`'s
    order and dtypes.

    CPU tensors take :func:`edge_embedder_bwd_plain`; CUDA tensors launch
    the backward kernels (or raise): kernel A recomputes through the tile of
    the forward that :func:`forward_route` gives a differentiated call, in
    float32 ``csrc/edge_embedder_bwd_wg.cu`` (wgmma and TMA), in bf16
    ``csrc/edge_embedder_bwd.cu`` (``mma.sync``). The grid runs in the chunks of
    :func:`plan_bwd_chunks` (each workspace at most ``workspace_cap``
    bytes); the grid-summed gradients are summed in float32 from partials in
    a fixed order (no atomics), the chunks' sums added in chunk order, so
    two launches on the same inputs give the same bits. ``recompute``, a
    dict, if given, receives the kernels' recompute, which runs the forward
    kernel's code: "out" (the same bits as :func:`edge_embedder`), "y0" and
    "y1" ([B, Nr, Nc, 128] in g's dtype, the activations whose relu
    decisions the gradients take). Adds one to ``edge_embedder_bwd.launches``
    per call, and to ``edge_embedder_bwd.launches_wgmma`` or
    ``edge_embedder_bwd.launches_mma`` by route."""
    if g.device.type == "cpu":
        return edge_embedder_bwd_plain(
            grad, g, h, pos_rows, pos_cols, i_term, j_term, row_mask, col_mask,
            w_rel, w_dist, b0, w1, b1, w2, b2, ln_scale, ln_bias,
            bins_lower=bins_lower, bins_upper=bins_upper,
        )
    args = (g, h, pos_rows, pos_cols, i_term, j_term, row_mask, col_mask,
            w_rel, w_dist, b0, w1, b1, w2, b2, ln_scale, ln_bias)
    if g.device.type != "cuda":
        raise ValueError(f"edge_embedder_bwd: unsupported device {g.device}")
    B, Nr, Nc, n_bins = _check_inputs("edge_embedder_bwd", *args, bins_lower, bins_upper)
    dtype, dev = g.dtype, g.device
    _check("grad", grad, (B, Nr, Nc, C), dtype, dev)
    edges = _edges(bins_lower, bins_upper, dev)
    ptrs = [grad.data_ptr(), *(t.data_ptr() for t in args[:10]), edges[0].data_ptr(),
            edges[1].data_ptr(), *(t.data_ptr() for t in args[10:])]
    route = forward_route(dtype)
    _check_aligned("edge_embedder_bwd", w_rel, w1, w2, i_term, j_term, b0, b1, b2,
                   rows=(("g", g), ("h", h), ("i_term", i_term), ("j_term", j_term))
                   if route == "wgmma" else ())
    if route == "wgmma":
        # Kernel A's first step writes the weights' TF32 parts here: the
        # forward's, then the chain's (chain_weight_split: the stored
        # weights, untransposed).
        weights = [torch.empty(2 * WG_SPLIT_FLOATS, dtype=F32, device=dev)]
    else:
        # bf16's input-gradient chain reads W^T row-major; W_rel^T [C, CP]
        # padded with zero columns to [C, C], the width of every product.
        w_relt = torch.zeros(C, C, dtype=dtype, device=dev)
        w_relt[:, :CP] = w_rel.t()
        weights = [w_relt, *(w.t().contiguous() for w in (w1, w2))]
    # Outputs zeroed: the chunks add to them in order.
    sums = torch.zeros(W_PART_FLOATS + (B * Nr + B * Nc) * ROW_PART, dtype=F32, device=dev)
    wred, rowred, colred = torch.split(sums, [W_PART_FLOATS, B * Nr * ROW_PART, B * Nc * ROW_PART])
    fwd_out = None
    if recompute is not None:
        recompute.update({k: torch.empty(B, Nr, Nc, C, dtype=dtype, device=dev)
                          for k in ("out", "y0", "y1")})
        fwd_out = recompute["out"].data_ptr()
    chunks = plan_bwd_chunks(B, Nr, Nc, n_bins, workspace_cap, dtype)
    if chunks:
        most = max(m1 - m0 for m0, m1 in chunks)
        n_ws = split_workspace_floats(most * Nc, n_bins, dtype, split_parts(most, Nc, dtype))
        ws = torch.empty(n_ws, dtype=F32, device=dev)
        sums_ptrs = (wred.data_ptr(), rowred.data_ptr(), colred.data_ptr(), n_bins, B, Nr, Nc)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            for m0, m1 in chunks:
                if route == "wgmma":
                    err = _bwd_wg_kernel()(*ptrs, ws.data_ptr(), n_ws, weights[0].data_ptr(),
                                           *sums_ptrs, m0, m1, fwd_out, stream)
                else:
                    err = _split_kernel()(
                        _DTYPE_CODE[dtype], *ptrs, *(w.data_ptr() for w in weights),
                        ws.data_ptr(), n_ws, *sums_ptrs, m0, m1, fwd_out, stream)
                if err != 0:
                    raise RuntimeError(
                        f"edge_embedder_bwd kernel launch failed ({route}): cudaError_t {err}")
                if recompute is not None:  # the workspace starts with y0, then y1
                    n, acts = (m1 - m0) * Nc * C, ws.view(dtype)
                    for k, part in (("y0", acts[:n]), ("y1", acts[n:2 * n])):
                        recompute[k].view(-1, C)[m0 * Nc:m1 * Nc] = part.view(-1, C)
        del ws
        edge_embedder_bwd.launches += 1
        edge_embedder_bwd.launches_wgmma += route == "wgmma"
        edge_embedder_bwd.launches_mma += route == "mma"

    # The relu input is base + i_term + j_term + b0: d_b0 sums d_i_term.
    d_b0 = torch.sum(rowred.view(B, Nr, ROW_PART)[..., CP:-1], dim=(0, 1)).to(dtype)
    # Every gradient but ln_scale's and ln_bias's in the dtype, in one cast
    # (float32: the sums themselves).
    wred_t, rowred_t, colred_t = torch.split(
        sums.to(dtype), [W_PART_FLOATS, B * Nr * ROW_PART, B * Nc * ROW_PART])
    parts, parts_f = _w_parts(wred_t), _w_parts(wred)
    rows = rowred_t.view(B, Nr, ROW_PART)
    cols = colred_t.view(B, Nc, ROW_PART)
    return (
        rows[..., :CP], cols[..., :CP], None, None, rows[..., CP:-1], cols[..., CP:-1],
        rows[..., -1], cols[..., -1], parts["w_rel"], parts["w_dist"][:n_bins], d_b0,
        parts["w1"], parts["b1"], parts["w2"], parts["b2"],
        parts_f["ln_scale"], parts_f["ln_bias"],
    )


edge_embedder_bwd.launches = edge_embedder_bwd.launches_wgmma = 0
edge_embedder_bwd.launches_mma = 0


class EdgeEmbedderFunction(torch.autograd.Function):
    """:func:`edge_embedder` for autograd. Arguments: the backward setting
    (``model.ipa.pallas_emb_bwd_impl``), then :func:`edge_embedder`'s
    arguments with the bin edges first: ``(bwd_impl, bins_lower,
    bins_upper, g, h, pos_rows, ..., ln_bias)`` (:func:`forward_route`
    picks the kernel by dtype, whose relu decisions the backward shares).

    Saves only the O(N) inputs. "pallas" runs :func:`edge_embedder_bwd`
    (the backward kernel on CUDA tensors, its plain version on CPU tensors);
    "xla" recomputes :func:`edge_embedder_plain` from the inputs under
    autograd and returns its VJP, the JAX package's remat formulation of
    this backward. The coordinates get no gradient (None): in the JAX
    package theirs is exactly 0, and the self-conditioning CA never
    requires one."""

    @staticmethod
    def forward(ctx, bwd_impl, bins_lower, bins_upper, g, h, pos_rows, pos_cols, i_term,
                j_term, row_mask, col_mask, w_rel, w_dist, b0, w1, b1, w2, b2, ln_scale,
                ln_bias):
        args = (g, h, pos_rows, pos_cols, i_term, j_term, row_mask, col_mask, w_rel, w_dist,
                b0, w1, b1, w2, b2, ln_scale, ln_bias)
        ctx.bwd_impl, ctx.bins = bwd_impl, (bins_lower, bins_upper)
        ctx.save_for_backward(*args)
        return edge_embedder(*args, bins_lower, bins_upper)

    @staticmethod
    def backward(ctx, grad):
        needs = list(ctx.needs_input_grad[3:20])  # the 17 tensors
        needs[2] = needs[3] = False  # pos_rows, pos_cols
        if ctx.bwd_impl == "pallas":
            grads = edge_embedder_bwd(grad.contiguous(), *ctx.saved_tensors,
                                      bins_lower=ctx.bins[0], bins_upper=ctx.bins[1])
            return (None, None, None) + tuple(d if need else None for d, need in zip(grads, needs))
        if ctx.bwd_impl != "xla":
            raise ValueError(
                f"pallas_emb_bwd_impl must be 'xla' or 'pallas', got {ctx.bwd_impl!r}"
            )
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(need) for t, need in zip(ctx.saved_tensors, needs)]
            out = edge_embedder_plain(*inputs, *ctx.bins)
            wanted = [t for t, need in zip(inputs, needs) if need]
            got = iter(torch.autograd.grad(out, wanted, grad) if wanted else ())
        return (None, None, None) + tuple(next(got) if need else None for need in needs)
