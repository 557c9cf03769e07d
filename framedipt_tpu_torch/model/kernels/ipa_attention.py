"""Fused IPA attention: CUDA kernel wrapper, plain version and point inputs.

Per query row i and head h, over all keys j of the same sample:

    s_hij = q_ih . k_jh                      # q pre-scaled by sqrt(1/(3C))
          + qhat_ih . khat_jh                # -0.5 w_h |q_pts - k_pts|^2
          + (z_ij @ Wb)_h                    # pair bias, Wb pre-scaled by sqrt(1/3)
          + inf * (mask_i * mask_j - 1)
    p_hij = softmax_j(s_hij)                 # float32
    o_ih      = sum_j p_hij v_jh             # p rounded to the compute dtype
    o_pt_ih   = sum_j p_hij v_pts_jh         # float32 p, global frame
    o_pair_ih = sum_j p_hij (z_ij @ Wdz)     # rounded p; z @ Wdz rounded too

and a row whose own mask is 0 gets exactly zero in all three outputs. Each
product accumulates in float32. The point term is one augmented dot product
(:func:`build_point_inputs`). ``linear_b``'s bias cancels in the softmax and
``down_z``'s bias is added to o_pair by the caller.

:func:`ipa_attention` takes the kernels (``csrc/ipa_attention.cu``) for CUDA
tensors and :func:`ipa_attention_plain` for CPU tensors. One call
launches three CUDA kernels: P, the pair projection (its plain version
:func:`ipa_pair_projection_plain`); S, the attention walking the keys in
tiles, split into ranges by :func:`plan_ipa_splits`; F, which merges the
splits and sums o_pair (S and F together: :func:`ipa_attend_plain`).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from framedipt_tpu_torch.model.kernels.build import library

F32 = torch.float32
# Widths the kernel is built for: heads, channels per head, augmented
# query/key point lanes per head (3*8 + 2, padded to 28), value point lanes
# per head (3*12), pair channels, down-projected pair channels.
H, C, PQW, PVW, CZ, DZ = 8, 256, 28, 36, 128, 32
# Kernel S's tiles: query rows per block, keys per tile; the most key splits.
ROW_TILE, KEY_TILE, MAX_SPLITS = 64, 32, 16
# Streaming multiprocessors of the card the split plan fills (an H100 SXM).
H100_SMS = 132


def plan_ipa_splits(B: int, N: int, sms: int = H100_SMS) -> tuple[int, int]:
    """(splits, key tiles per split) of kernel S: the keys' tiles of
    KEY_TILE split into contiguous ranges. Kernel S runs one block an SM, so
    a launch of B * H * (row tiles) * splits blocks takes ceil(blocks / sms)
    waves, each block walking its key tiles after loading its query tile
    (as many bytes as a key tile); the plan takes the fewest splits that
    minimize waves x (tiles per split + 1). Every tile falls in exactly one
    split, and no split is empty."""
    row_blocks = B * H * -(-N // ROW_TILE)
    key_tiles = max(1, -(-N // KEY_TILE))
    best = None
    for want in range(1, min(key_tiles, MAX_SPLITS) + 1):
        per = -(-key_tiles // want)
        splits = -(-key_tiles // per)
        cost = -(-max(1, row_blocks * splits) // sms) * (per + 1)
        if best is None or cost < best[0]:
            best = (cost, splits, per)
    return best[1], best[2]


def _pad4(n: int) -> int:
    return -(-n // 4) * 4


def build_point_inputs(
    q_pts: torch.Tensor,  # [B, N, H, Pq, 3] global-frame query points
    k_pts: torch.Tensor,  # [B, N, H, Pq, 3]
    v_pts: torch.Tensor,  # [B, N, H, Pv, 3]
    pt_weights: torch.Tensor,  # [H] softplus'd head weights * sqrt(1/(3*(Pq*9/2)))
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pre-scale and augment the points so one dot product per (i, j, h)
    gives the point logit -0.5 w_h |q - k|^2:

        q' = sqrt(0.5 w_h) q,  k' = sqrt(0.5 w_h) k
        qhat = [2 q', -|q'|^2, -1],  khat = [k', 1, |k'|^2]

    Returns float32 (qhat [B,N,H*QW], khat [B,N,H*QW], vpt [B,N,H*VW]) with
    each head's lanes zero-padded to a multiple of 4 (QW = 28, VW = 36 at the
    default widths)."""
    B, N, Hh, Pq, _ = q_pts.shape
    Pv = v_pts.shape[3]
    s = torch.sqrt(0.5 * pt_weights.to(F32))[None, None, :, None, None]
    qs = (q_pts.to(F32) * s).reshape(B, N, Hh, Pq * 3)
    ks = (k_pts.to(F32) * s).reshape(B, N, Hh, Pq * 3)
    sq_q = torch.sum(qs * qs, dim=-1, keepdim=True)
    sq_k = torch.sum(ks * ks, dim=-1, keepdim=True)
    ones = torch.ones_like(sq_q)
    qw, vw = _pad4(Pq * 3 + 2), _pad4(Pv * 3)
    pad = torch.zeros(B, N, Hh, qw - Pq * 3 - 2, dtype=F32, device=qs.device)
    qhat = torch.cat([2.0 * qs, -sq_q, -ones, pad], dim=-1)
    khat = torch.cat([ks, ones, sq_k, pad], dim=-1)
    vpt = torch.cat(
        [v_pts.to(F32).reshape(B, N, Hh, Pv * 3),
         torch.zeros(B, N, Hh, vw - Pv * 3, dtype=F32, device=qs.device)],
        dim=-1,
    )
    return qhat.reshape(B, N, -1), khat.reshape(B, N, -1), vpt.reshape(B, N, -1)


def ipa_attention_plain(q, k, v, qhat, khat, vpt, z, mask, wb, wdz, *,
                        no_heads, no_v_points, inf=1e5):
    """Plain PyTorch version of the kernel, with its contract and rounding
    points (the Pallas kernel's formulation, row softmax in one piece)."""
    dtype = q.dtype
    B, N, _ = q.shape
    Hh, Pv = no_heads, no_v_points

    def heads(x):
        return x.reshape(B, N, Hh, -1).to(F32)

    logits = torch.einsum("bihc,bjhc->bhij", heads(q), heads(k))
    logits = logits + torch.einsum("bihe,bjhe->bhij", heads(qhat), heads(khat))
    zf = z.to(F32)
    zb = torch.einsum("bijc,ch->bhij", zf, wb.to(F32))
    pz = torch.einsum("bijc,cd->bijd", zf, wdz.to(F32)).to(dtype).to(F32)
    mask = mask.to(F32)
    maskterm = inf * (mask[:, :, None] * mask[:, None, :] - 1.0)
    p = torch.softmax(logits + zb + maskterm[:, None], dim=-1)  # [B, H, N, N]
    p_c = p.to(dtype).to(F32)
    rm = mask[:, :, None]
    o = torch.einsum("bhij,bjhc->bihc", p_c, heads(v)).reshape(B, N, -1) * rm
    o_pt = torch.einsum("bhij,bjhe->bihe", p, heads(vpt))[..., : Pv * 3]
    o_pt = o_pt.reshape(B, N, Hh * Pv, 3) * rm[..., None]
    o_pair = torch.einsum("bhij,bijd->bihd", p_c, pz).reshape(B, N, -1) * rm
    return o, o_pt, o_pair


def ipa_pair_projection_plain(z, wb, wdz):
    """Plain version of kernel P: the pair bias zb = z @ Wb, float32 [B, H,
    N, N], and the pair values pz = z @ Wdz rounded to z's dtype, [B, N, N,
    dz]; products in float32."""
    zf = z.to(F32)
    zb = torch.einsum("bijc,ch->bhij", zf, wb.to(F32))
    pz = torch.einsum("bijc,cd->bijd", zf, wdz.to(F32)).to(z.dtype)
    return zb, pz


def ipa_attend_plain(q, k, v, qhat, khat, vpt, zb, pz, mask, *, no_heads, no_v_points,
                     inf=1e5):
    """Plain version of kernels S and F: the attention given the
    pair bias zb and pair values pz of :func:`ipa_pair_projection_plain`,
    with :func:`ipa_attention_plain`'s rounding points and outputs."""
    dtype = q.dtype
    B, N, _ = q.shape
    Hh, Pv = no_heads, no_v_points

    def heads(x):
        return x.reshape(B, N, Hh, -1).to(F32)

    logits = torch.einsum("bihc,bjhc->bhij", heads(q), heads(k))
    logits = logits + torch.einsum("bihe,bjhe->bhij", heads(qhat), heads(khat))
    mask = mask.to(F32)
    maskterm = inf * (mask[:, :, None] * mask[:, None, :] - 1.0)
    p = torch.softmax(logits + zb + maskterm[:, None], dim=-1)
    p_c = p.to(dtype).to(F32)
    rm = mask[:, :, None]
    o = torch.einsum("bhij,bjhc->bihc", p_c, heads(v)).reshape(B, N, -1) * rm
    o_pt = torch.einsum("bhij,bjhe->bihe", p, heads(vpt))[..., : Pv * 3]
    o_pt = o_pt.reshape(B, N, Hh * Pv, 3) * rm[..., None]
    o_pair = torch.einsum("bhij,bijd->bihd", p_c, pz.to(F32)).reshape(B, N, -1) * rm
    return o, o_pt, o_pair


def _check(name, t, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"ipa_attention: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"ipa_attention: {name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"ipa_attention: {name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"ipa_attention: {name} is not contiguous and 16-byte aligned")


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _kernel():
    """The C entry point of csrc/ipa_attention.cu, built and bound at first use."""
    fn = library("ipa_attention").fdk_ipa_attention
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 17 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_void_p,
    ]
    return fn


def ipa_attention(q, k, v, qhat, khat, vpt, z, mask, wb, wdz, *,
                  no_heads, no_v_points, inf=1e5):
    """IPA attention of the query rows against all keys: float32
    (o [B,N,H*C], o_pt [B,N,H*Pv,3] in the global frame, o_pair [B,N,H*dz]).

    q, k, v [B,N,H*C], z [B,N,N,c_z], wb [c_z,H] and wdz [c_z,dz] are in the
    compute dtype; qhat, khat, vpt (:func:`build_point_inputs`) and mask
    [B,N] are float32. CPU tensors take :func:`ipa_attention_plain`; CUDA
    tensors launch kernels P, S and F (or raise). Adds one to
    ``ipa_attention.launches`` per call."""
    if q.device.type == "cpu":
        return ipa_attention_plain(q, k, v, qhat, khat, vpt, z, mask, wb, wdz,
                                   no_heads=no_heads, no_v_points=no_v_points, inf=inf)
    if q.device.type != "cuda":
        raise ValueError(f"ipa_attention: unsupported device {q.device}")
    dtype, dev = q.dtype, q.device
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"ipa_attention: unsupported dtype {dtype}")
    B, N, hc = q.shape
    widths = (no_heads, hc // no_heads, qhat.shape[-1] // no_heads, 3 * no_v_points,
              z.shape[-1], wdz.shape[-1])
    if widths != (H, C, PQW, PVW, CZ, DZ) or hc % no_heads:
        raise ValueError(
            f"ipa_attention: kernel is built for widths (H, C, QW, VW, c_z, dz) = "
            f"{(H, C, PQW, PVW, CZ, DZ)}, got {widths}"
        )
    for name, t, shape, dt in (
        ("q", q, (B, N, H * C), dtype),
        ("k", k, (B, N, H * C), dtype),
        ("v", v, (B, N, H * C), dtype),
        ("qhat", qhat, (B, N, H * PQW), F32),
        ("khat", khat, (B, N, H * PQW), F32),
        ("vpt", vpt, (B, N, H * PVW), F32),
        ("z", z, (B, N, N, CZ), dtype),
        ("mask", mask, (B, N), F32),
        ("wb", wb, (CZ, H), dtype),
        ("wdz", wdz, (CZ, DZ), dtype),
    ):
        _check(name, t, shape, dt, dev)

    o = torch.empty((B, N, H * C), dtype=F32, device=dev)
    o_pt = torch.empty((B, N, H * no_v_points, 3), dtype=F32, device=dev)
    o_pair = torch.empty((B, N, H * DZ), dtype=F32, device=dev)
    # The kernels' transient workspace (31 MB at B=2 N=256 in float32).
    splits, per_split = plan_ipa_splits(
        B, N, torch.cuda.get_device_properties(dev).multi_processor_count)
    zb = torch.empty((B, H, N, N), dtype=F32, device=dev)
    pz = torch.empty((B, N, N, DZ), dtype=dtype, device=dev)
    mt = torch.empty((B, H, N, -(-N // KEY_TILE)), dtype=F32, device=dev)
    part = torch.empty((splits * B * N * H * (C + PVW + 2),), dtype=F32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel()(
            _DTYPE_CODE[dtype],
            q.data_ptr(), k.data_ptr(), v.data_ptr(), qhat.data_ptr(), khat.data_ptr(),
            vpt.data_ptr(), z.data_ptr(), mask.data_ptr(), wb.data_ptr(), wdz.data_ptr(),
            o.data_ptr(), o_pt.data_ptr(), o_pair.data_ptr(),
            zb.data_ptr(), pz.data_ptr(), mt.data_ptr(), part.data_ptr(),
            B, N, splits, per_split, float(inf), stream,
        )
    if err != 0:
        raise RuntimeError(f"ipa_attention kernel launch failed: cudaError_t {err}")
    ipa_attention.launches += 1
    return o, o_pt, o_pair


ipa_attention.launches = 0
