"""SO(3) maps on torch tensors: small-angle-safe exp/log and composition."""
from __future__ import annotations

import torch

from framedipt_tpu_torch.geometry import quat


def hat(v: torch.Tensor) -> torch.Tensor:
    """Rotation vector [..., 3] -> skew-symmetric matrix [..., 3, 3]."""
    x, y, z = torch.unbind(v, dim=-1)
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(v.shape[:-1] + (3, 3))


def exp(v: torch.Tensor) -> torch.Tensor:
    """Exponential map: rotation vector [..., 3] -> rotation matrix, by
    Rodrigues' formula with Taylor fallbacks below angle^2 = 1e-6."""
    a2 = torch.sum(v * v, dim=-1, keepdim=True)[..., None]  # [..., 1, 1]
    small = a2 < 1e-6
    safe_a2 = torch.where(small, torch.ones_like(a2), a2)
    safe_a = torch.sqrt(safe_a2)
    sin_a_over_a = torch.where(small, 1.0 - a2 / 6.0, torch.sin(safe_a) / safe_a)
    one_minus_cos_over_a2 = torch.where(
        small, 0.5 - a2 / 24.0, (1.0 - torch.cos(safe_a)) / safe_a2
    )
    k = hat(v)
    # 3x3 product written out so it never goes to a reduced-precision GEMM.
    k2 = (k[..., :, :, None] * k[..., None, :, :]).sum(-2)
    eye = torch.eye(3, dtype=v.dtype, device=v.device).expand(k.shape)
    return eye + sin_a_over_a * k + one_minus_cos_over_a2 * k2


def log(mat: torch.Tensor) -> torch.Tensor:
    """Logarithm map: rotation matrix [..., 3, 3] -> rotation vector, via the
    quaternion (stable at both omega ~ 0 and omega ~ pi)."""
    return quat.to_rotvec(quat.from_rotmat(mat))


def compose_rotvec(r1: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    """log(exp(r1) @ exp(r2)), composed in quaternion space."""
    return quat.to_rotvec(quat.multiply(quat.from_rotvec(r1), quat.from_rotvec(r2)))
