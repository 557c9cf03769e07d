"""Quaternion algebra on torch tensors.

Quaternions are stored ``(w, x, y, z)`` with the scalar part first (the
tensor_7 rigid-frame layout). Every function is branchless over the batch.
"""
from __future__ import annotations

import torch


def safe_norm(
    x: torch.Tensor, dim: int = -1, keepdim: bool = False, eps: float = 1e-20
) -> torch.Tensor:
    """L2 norm as sqrt(sum + eps): finite gradient at x = 0."""
    return torch.sqrt(torch.sum(x * x, dim=dim, keepdim=keepdim) + eps)


def normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalize quaternions to unit length along the last axis."""
    return q / torch.clamp_min(safe_norm(q, keepdim=True), eps)


def multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1 * q2."""
    w1, x1, y1, z1 = torch.unbind(q1, dim=-1)
    w2, x2, y2, z2 = torch.unbind(q2, dim=-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def multiply_by_vec(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Multiply ``q`` by the pure quaternion ``(0, v)`` (the backbone update
    primitive: the composed quaternion is ``q + q*(0, v)``)."""
    zero = torch.zeros_like(v[..., :1])
    return multiply(q, torch.cat([zero, v], dim=-1))


def invert(q: torch.Tensor) -> torch.Tensor:
    """Conjugate of a unit quaternion (its inverse)."""
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> 3x3 rotation matrix. [..., 4] -> [..., 3, 3]."""
    q = normalize(q)
    w, x, y, z = torch.unbind(q, dim=-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def from_rotmat(m: torch.Tensor) -> torch.Tensor:
    """3x3 rotation matrix -> unit quaternion (w, x, y, z), branchless: all
    four pivot candidates are computed and the largest pivot is selected."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    tr = m00 + m11 + m22
    pw = 1.0 + tr
    px = 1.0 + m00 - m11 - m22
    py = 1.0 - m00 + m11 - m22
    pz = 1.0 - m00 - m11 + m22

    sw = torch.sqrt(torch.clamp_min(pw, 1e-12)) * 2.0
    qw = torch.stack(
        [0.25 * sw, (m21 - m12) / sw, (m02 - m20) / sw, (m10 - m01) / sw], dim=-1
    )
    sx = torch.sqrt(torch.clamp_min(px, 1e-12)) * 2.0
    qx = torch.stack(
        [(m21 - m12) / sx, 0.25 * sx, (m01 + m10) / sx, (m02 + m20) / sx], dim=-1
    )
    sy = torch.sqrt(torch.clamp_min(py, 1e-12)) * 2.0
    qy = torch.stack(
        [(m02 - m20) / sy, (m01 + m10) / sy, 0.25 * sy, (m12 + m21) / sy], dim=-1
    )
    sz = torch.sqrt(torch.clamp_min(pz, 1e-12)) * 2.0
    qz = torch.stack(
        [(m10 - m01) / sz, (m02 + m20) / sz, (m12 + m21) / sz, 0.25 * sz], dim=-1
    )

    pivots = torch.stack([pw, px, py, pz], dim=-1)
    best = torch.argmax(pivots, dim=-1)  # [...]
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # [..., 4cand, 4]
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cands, -2, idx)[..., 0, :]
    return normalize(q)


def to_rotvec(q: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Unit quaternion -> axis-angle rotation vector, small-angle safe:
    sign-flip so w >= 0, then scale = angle/sin(angle/2) with the Taylor
    series ``2 + a^2/12 + 7 a^4/2880`` below 1e-3."""
    flip = (q[..., :1] < 0).to(q.dtype)
    q = -q * flip + (1.0 - flip) * q
    angle = 2.0 * torch.atan2(safe_norm(q[..., 1:]), q[..., 0])
    angle2 = angle * angle
    small_scale = 2.0 + angle2 / 12.0 + 7.0 * angle2 * angle2 / 2880.0
    large_scale = angle / torch.sin(angle / 2.0 + eps)
    small = (angle <= 1e-3).to(q.dtype)
    scale = small * small_scale + (1.0 - small) * large_scale
    return scale[..., None] * q[..., 1:]


def from_rotvec(v: torch.Tensor) -> torch.Tensor:
    """Axis-angle rotation vector -> unit quaternion, small-angle safe."""
    angle = safe_norm(v, keepdim=True)
    half = 0.5 * angle
    sin_half_over_angle = torch.where(
        angle < 1e-3,
        0.5 - angle * angle / 48.0,
        torch.sin(half) / torch.clamp_min(angle, 1e-20),
    )
    w = torch.cos(half)
    return torch.cat([w, v * sin_half_over_angle], dim=-1)
