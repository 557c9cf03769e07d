"""Frame -> all-atom conversion (AF2 rigid-group conventions) on torch
tensors: backbone frames + psi -> atom37 / atom14 backbone atoms."""
from __future__ import annotations

import functools

import numpy as np
import torch

from framedipt_tpu_torch.data import constants as rc
from framedipt_tpu_torch.geometry.rigid import Rigid, matvec


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> tuple[torch.Tensor, ...]:
    """Chemical tables on ``device`` (built once per device)."""
    def put(x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    return (
        put(rc.restype_rigid_group_default_frame, torch.float32),  # [21, 8, 4, 4]
        put(rc.restype_atom14_rigid_group_positions, torch.float32),  # [21, 14, 3]
        put(rc.restype_atom14_mask, torch.float32),  # [21, 14]
        put(rc.restype_atom14_to_rigid_group, torch.int64),  # [21, 14]
    )


def _mat_compose(m1, t1, m2, t2):
    """(m1, t1) o (m2, t2): apply m2 first."""
    m = (m1[..., :, :, None] * m2[..., None, :, :]).sum(-2)
    return m, matvec(m1, t2) + t1


def torsion_angles_to_frames(
    bb_rigids: Rigid, alpha: torch.Tensor, aatype: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Backbone frames [..., N] + 7 torsion (sin, cos) [..., N, 7, 2] ->
    the 8 rigid-group frames in global coordinates:
    (rot_mats [..., N, 8, 3, 3], trans [..., N, 8, 3])."""
    default_frames = _tables(alpha.device)[0]
    default_4x4 = default_frames[aatype]  # [..., N, 8, 4, 4]
    default_m = default_4x4[..., :3, :3]
    default_t = default_4x4[..., :3, 3]

    # Prepend the identity backbone "torsion" (sin=0, cos=1).
    bb_rot = torch.zeros_like(alpha[..., :1, :])
    bb_rot[..., 1] = 1.0
    alpha8 = torch.cat([bb_rot, alpha], dim=-2)  # [..., N, 8, 2]
    sin_a, cos_a = alpha8[..., 0], alpha8[..., 1]

    zeros = torch.zeros_like(sin_a)
    ones = torch.ones_like(sin_a)
    rot_x = torch.stack(
        [
            ones, zeros, zeros,
            zeros, cos_a, -sin_a,
            zeros, sin_a, cos_a,
        ],
        dim=-1,
    ).reshape(sin_a.shape + (3, 3))

    all_m, all_t = _mat_compose(default_m, default_t, rot_x, torch.zeros_like(default_t))

    # Chi frames chain: chi_k is defined relative to chi_{k-1}.
    chi1_m, chi1_t = all_m[..., 4, :, :], all_t[..., 4, :]
    chi2_m, chi2_t = _mat_compose(chi1_m, chi1_t, all_m[..., 5, :, :], all_t[..., 5, :])
    chi3_m, chi3_t = _mat_compose(chi2_m, chi2_t, all_m[..., 6, :, :], all_t[..., 6, :])
    chi4_m, chi4_t = _mat_compose(chi3_m, chi3_t, all_m[..., 7, :, :], all_t[..., 7, :])

    to_bb_m = torch.cat(
        [all_m[..., :5, :, :], chi2_m[..., None, :, :], chi3_m[..., None, :, :],
         chi4_m[..., None, :, :]],
        dim=-3,
    )
    to_bb_t = torch.cat(
        [all_t[..., :5, :], chi2_t[..., None, :], chi3_t[..., None, :],
         chi4_t[..., None, :]],
        dim=-2,
    )
    bb_m = bb_rigids.rot_mats()[..., None, :, :]
    bb_t = bb_rigids.trans[..., None, :]
    return _mat_compose(bb_m, bb_t, to_bb_m, to_bb_t)


def frames_to_atom14_pos(
    group_m: torch.Tensor, group_t: torch.Tensor, aatype: torch.Tensor
) -> torch.Tensor:
    """Idealized atom14 positions from the 8 group frames."""
    _, atom14_pos, atom14_mask, atom14_group = _tables(group_m.device)
    group_idx = atom14_group[aatype]  # [..., N, 14]
    m = torch.take_along_dim(group_m, group_idx[..., None, None], dim=-3)
    t = torch.take_along_dim(group_t, group_idx[..., None], dim=-2)
    pos = matvec(m, atom14_pos[aatype]) + t
    return pos * atom14_mask[aatype][..., None]


def compute_backbone(
    bb_rigids: Rigid,
    psi_torsions: torch.Tensor,
    aatype: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backbone frames + psi -> (atom37, atom37_mask, aatype, atom14).

    psi fills all 7 torsion slots, UNK (20) maps to ALA (0) for geometry,
    atom37 backbone slots are N/CA/C/CB/O with the atom14 -> atom37 CB/O
    swap."""
    shape = bb_rigids.shape
    torsions = psi_torsions[..., None, :].expand(psi_torsions.shape[:-1] + (7, 2))
    if aatype is None:
        aatype = torch.zeros(shape, dtype=torch.int64, device=psi_torsions.device)
    aatype = torch.where(aatype == rc.unk_restype_index, 0, aatype).long()

    group_m, group_t = torsion_angles_to_frames(bb_rigids, torsions, aatype)
    atom14 = frames_to_atom14_pos(group_m, group_t, aatype)

    atom37 = torch.zeros(shape + (37, 3), dtype=atom14.dtype, device=atom14.device)
    # atom14 order: N, CA, C, O, CB ; atom37 order: N, CA, C, CB, O.
    atom37[..., :3, :] = atom14[..., :3, :]
    atom37[..., 3, :] = atom14[..., 4, :]
    atom37[..., 4, :] = atom14[..., 3, :]
    atom37_mask = torch.any(atom37 != 0, dim=-1)
    return atom37, atom37_mask, aatype, atom14
