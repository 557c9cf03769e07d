"""Rigid-frame transforms: ``(quaternion [..., 4], translation [..., 3])``.

Rotation matrices are materialized only where frames are applied to points.
``compose_q_update_vec`` threads the fork's ``update_mask`` so fixed
(inpainting) residues keep their frames exactly.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from framedipt_tpu_torch.geometry import quat as quat_ops


def matvec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] @ [..., 3] -> [..., 3], written out (no GEMM)."""
    return (m * v[..., None, :]).sum(-1)


def matTvec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3]^T @ [..., 3] -> [..., 3]."""
    return (m * v[..., :, None]).sum(-2)


class Rigid(NamedTuple):
    """Batch of rigid transforms: unit quaternions (w,x,y,z) + translations."""

    qs: torch.Tensor  # [..., 4]
    trans: torch.Tensor  # [..., 3]

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.trans.shape[:-1])

    @staticmethod
    def identity(shape: tuple[int, ...], dtype=torch.float32, device=None) -> "Rigid":
        qs = torch.zeros(shape + (4,), dtype=dtype, device=device)
        qs[..., 0] = 1.0
        return Rigid(qs, torch.zeros(shape + (3,), dtype=dtype, device=device))

    @staticmethod
    def from_tensor7(t: torch.Tensor, normalize: bool = False) -> "Rigid":
        qs = t[..., :4]
        if normalize:
            qs = quat_ops.normalize(qs)
        return Rigid(qs, t[..., 4:])

    @staticmethod
    def from_rotmat_trans(mats: torch.Tensor, trans: torch.Tensor) -> "Rigid":
        return Rigid(quat_ops.from_rotmat(mats), trans)

    @staticmethod
    def from_3_points(
        p_neg_x: torch.Tensor,
        origin: torch.Tensor,
        p_xy: torch.Tensor,
        eps: float = 1e-8,
    ) -> "Rigid":
        """Gram-Schmidt frame from three points (AF2 Algorithm 21)."""
        e0 = origin - p_neg_x
        e1 = p_xy - origin
        e0 = e0 / torch.sqrt(torch.sum(e0 * e0, dim=-1, keepdim=True) + eps)
        e1 = e1 - e0 * torch.sum(e0 * e1, dim=-1, keepdim=True)
        e1 = e1 / torch.sqrt(torch.sum(e1 * e1, dim=-1, keepdim=True) + eps)
        e2 = torch.cross(e0, e1, dim=-1)
        mats = torch.stack([e0, e1, e2], dim=-1)  # columns are the basis
        return Rigid.from_rotmat_trans(mats, origin)

    def rot_mats(self) -> torch.Tensor:
        return quat_ops.to_rotmat(self.qs)

    def to_tensor7(self) -> torch.Tensor:
        return torch.cat([self.qs, self.trans], dim=-1)

    def apply(self, pts: torch.Tensor) -> torch.Tensor:
        """Apply the transform to points [..., 3]."""
        return matvec(self.rot_mats(), pts) + self.trans

    def invert_apply(self, pts: torch.Tensor) -> torch.Tensor:
        return matTvec(self.rot_mats(), pts - self.trans)

    def compose(self, other: "Rigid") -> "Rigid":
        """self o other (``other`` first in point space)."""
        new_q = quat_ops.multiply(self.qs, other.qs)
        return Rigid(quat_ops.normalize(new_q), self.apply(other.trans))

    def invert(self) -> "Rigid":
        inv_q = quat_ops.invert(self.qs)
        inv_t = -matvec(quat_ops.to_rotmat(inv_q), self.trans)
        return Rigid(inv_q, inv_t)

    def compose_q_update_vec(
        self, update: torch.Tensor, update_mask: torch.Tensor | None = None
    ) -> "Rigid":
        """Compose with a 6-dof update [..., 6]: (1, bx, by, bz) quaternion +
        frame-local translation. ``update_mask`` gates both parts so masked
        frames are exactly unchanged."""
        q_vec, t_vec = update[..., :3], update[..., 3:]
        quat_update = quat_ops.multiply_by_vec(self.qs, q_vec)
        if update_mask is not None:
            quat_update = quat_update * update_mask
        new_qs = quat_ops.normalize(self.qs + quat_update)
        trans_update = matvec(self.rot_mats(), t_vec)
        if update_mask is not None:
            trans_update = trans_update * update_mask
        return Rigid(new_qs, self.trans + trans_update)

    def scale_trans(self, factor) -> "Rigid":
        return Rigid(self.qs, self.trans * factor)
