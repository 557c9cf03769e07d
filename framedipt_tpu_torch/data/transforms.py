"""Host-side featurization (numpy): atom37 -> backbone frames and torsion
angles, as the JAX package's ``data/transforms.py`` computes them.

Conventions: backbone frame = Gram-Schmidt on (C, CA, N) composed with
diag(-1, 1, -1); psi sin/cos sign-flipped (AF2).
"""
from __future__ import annotations

import numpy as np

from framedipt_tpu_torch.data import constants as rc


def _gram_schmidt_frames(p_neg_x, origin, p_xy, eps=1e-8):
    """Rotation matrices (columns e0|e1|e2) + translations."""
    e0 = origin - p_neg_x
    e1 = p_xy - origin
    denom = np.sqrt(np.sum(e0**2, axis=-1, keepdims=True) + eps)
    e0 = e0 / denom
    dot = np.sum(e0 * e1, axis=-1, keepdims=True)
    e1 = e1 - e0 * dot
    denom1 = np.sqrt(np.sum(e1**2, axis=-1, keepdims=True) + eps)
    e1 = e1 / denom1
    e2 = np.cross(e0, e1)
    rots = np.stack([e0, e1, e2], axis=-1)
    return rots, origin


def backbone_rigid_tensor7(
    aatype: np.ndarray, atom37: np.ndarray, atom37_mask: np.ndarray
) -> np.ndarray:
    """Backbone (rigid group 0) frame as tensor7 [N, 7] (quat wxyz + trans).

    Group 0 is built from (C, CA, N) for the 20 standard residue types, so
    this is the group-0 slice of the AF2 atom37_to_frames transform; unknown
    residues (aatype 20) have no group and get the identity frame at 0."""
    aatype = np.clip(np.asarray(aatype, np.int64), 0, 20)
    a = rc.atom_order
    rots, trans = _gram_schmidt_frames(
        atom37[:, a["C"]], atom37[:, a["CA"]], atom37[:, a["N"]]
    )
    flip = np.eye(3, dtype=rots.dtype)
    flip[0, 0] = -1.0
    flip[2, 2] = -1.0
    rots = rots @ flip
    exists = np.prod(atom37_mask[:, [a["C"], a["CA"], a["N"]]], axis=-1)
    exists = exists * (aatype < rc.restype_num)
    rot = (rots * exists[:, None, None]).astype(np.float32)
    trans = (trans * exists[:, None]).astype(np.float32)
    quat = _rotmat_to_quat_np(rot)
    return np.concatenate([quat, trans], axis=-1).astype(np.float32)


def _rotmat_to_quat_np(m: np.ndarray) -> np.ndarray:
    from scipy.spatial.transform import Rotation

    flat = m.reshape(-1, 3, 3)
    # Guard degenerate (all-zero) frames from missing atoms.
    dets = np.linalg.det(flat)
    ok = np.abs(dets - 1.0) < 0.5
    safe = np.where(ok[:, None, None], flat, np.eye(3)[None])
    q = Rotation.from_matrix(safe).as_quat()  # xyzw
    q = np.concatenate([q[:, 3:], q[:, :3]], axis=-1)  # wxyz
    return q.reshape(m.shape[:-2] + (4,)).astype(np.float32)


def _build_chi_atom_idx() -> tuple[np.ndarray, np.ndarray]:
    chi_atoms = rc.chi_angles_atoms
    chi_mask = np.asarray(rc.chi_angles_mask, np.float32)
    idx = np.zeros((21, 4, 4), np.int64)
    for r_i, r1 in enumerate(rc.restypes):
        resname = rc.restype_1to3[r1]
        for chi_i, atoms in enumerate(chi_atoms[resname]):
            idx[r_i, chi_i] = [rc.atom_order[a] for a in atoms]
    return idx, chi_mask


_CHI_ATOM_IDX, _CHI_MASK = _build_chi_atom_idx()
_CHI_PI_PERIODIC = np.asarray(rc.chi_pi_periodic, np.float32)


def atom37_to_torsion_angles(
    aatype: np.ndarray, atom37: np.ndarray, atom37_mask: np.ndarray
) -> dict[str, np.ndarray]:
    """7 torsion angles (pre-omega, phi, psi, chi1-4) as sin/cos, with masks
    and pi-periodic alternates (AF2 data transform semantics)."""
    aatype = np.clip(np.asarray(aatype, np.int64), 0, 20)
    n = aatype.shape[0]

    prev_pos = np.concatenate([np.zeros_like(atom37[:1]), atom37[:-1]], axis=0)
    prev_mask = np.concatenate(
        [np.zeros_like(atom37_mask[:1]), atom37_mask[:-1]], axis=0
    )

    a = rc.atom_order
    pre_omega_atoms = np.stack(
        [prev_pos[:, a["CA"]], prev_pos[:, a["C"]], atom37[:, a["N"]], atom37[:, a["CA"]]],
        axis=-2,
    )
    phi_atoms = np.stack(
        [prev_pos[:, a["C"]], atom37[:, a["N"]], atom37[:, a["CA"]], atom37[:, a["C"]]],
        axis=-2,
    )
    psi_atoms = np.stack(
        [atom37[:, a["N"]], atom37[:, a["CA"]], atom37[:, a["C"]], atom37[:, a["O"]]],
        axis=-2,
    )

    pre_omega_mask = np.prod(prev_mask[:, [a["CA"], a["C"]]], axis=-1) * np.prod(
        atom37_mask[:, [a["N"], a["CA"]]], axis=-1
    )
    phi_mask = prev_mask[:, a["C"]] * np.prod(
        atom37_mask[:, [a["N"], a["CA"], a["C"]]], axis=-1
    )
    psi_mask = np.prod(atom37_mask[:, [a["N"], a["CA"], a["C"], a["O"]]], axis=-1)

    chi_idx = _CHI_ATOM_IDX[aatype]  # [N, 4, 4]
    chi_atoms_pos = atom37[np.arange(n)[:, None, None], chi_idx]  # [N, 4, 4, 3]
    chi_atom_mask = atom37_mask[np.arange(n)[:, None, None], chi_idx]
    chi_mask = _CHI_MASK[aatype] * np.prod(chi_atom_mask, axis=-1)

    torsion_atoms = np.concatenate(
        [pre_omega_atoms[:, None], phi_atoms[:, None], psi_atoms[:, None], chi_atoms_pos],
        axis=1,
    )  # [N, 7, 4, 3]

    rots, trans = _gram_schmidt_frames(
        torsion_atoms[..., 1, :], torsion_atoms[..., 2, :], torsion_atoms[..., 0, :]
    )
    # Invert-apply the 4th atom: R^T (x - t).
    rel = np.einsum(
        "...ji,...j->...i", rots, torsion_atoms[..., 3, :] - trans
    )
    sin_cos = np.stack([rel[..., 2], rel[..., 1]], axis=-1)
    denom = np.sqrt(np.sum(sin_cos**2, axis=-1, keepdims=True) + 1e-8)
    sin_cos = sin_cos / denom
    # psi sign flip (AF2 convention).
    sin_cos = sin_cos * np.asarray([1, 1, -1, 1, 1, 1, 1], np.float32)[None, :, None]

    torsion_mask = np.concatenate(
        [pre_omega_mask[:, None], phi_mask[:, None], psi_mask[:, None], chi_mask],
        axis=1,
    )

    mirror = np.concatenate(
        [np.ones((n, 3)), 1.0 - 2.0 * _CHI_PI_PERIODIC[aatype]], axis=1
    )
    alt_sin_cos = sin_cos * mirror[..., None]

    return {
        "torsion_angles_sin_cos": sin_cos.astype(np.float32),
        "alt_torsion_angles_sin_cos": alt_sin_cos.astype(np.float32),
        "torsion_angles_mask": torsion_mask.astype(np.float32),
    }
