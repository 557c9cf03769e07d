"""Host-side featurization (numpy): atom37 -> rigid-group frames, backbone
frames, torsion angles and atom14 gathers, as the JAX package's
``data/transforms.py`` computes them.

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


def _build_rigidgroup_base_atom_idx() -> tuple[np.ndarray, np.ndarray]:
    """[21, 8, 3] atom37 indices of each rigid group's 3 base atoms and the
    [21, 8] group-exists mask. Groups: 0 backbone, 3 psi, 4-7 chi1-4 (1 and
    2, pre-omega and phi, carry no frame)."""
    chi_mask = np.asarray(rc.chi_angles_mask, np.float32)
    a = rc.atom_order
    base_idx = np.zeros((21, 8, 3), np.int64)
    group_exists = np.zeros((21, 8), np.float32)
    for r_i, r1 in enumerate(rc.restypes):
        resname = rc.restype_1to3[r1]
        base_idx[r_i, 0] = [a["C"], a["CA"], a["N"]]
        base_idx[r_i, 3] = [a["CA"], a["C"], a["O"]]
        group_exists[r_i, [0, 3]] = 1.0
        for chi_i in range(4):
            if chi_mask[r_i][chi_i]:
                atoms = rc.chi_angles_atoms[resname][chi_i]
                base_idx[r_i, 4 + chi_i] = [a[x] for x in atoms[1:]]
                group_exists[r_i, 4 + chi_i] = 1.0
    return base_idx, group_exists


_BASE_ATOM_IDX, _GROUP_EXISTS = _build_rigidgroup_base_atom_idx()


def atom37_to_frames(
    aatype: np.ndarray, atom37: np.ndarray, atom37_mask: np.ndarray
) -> dict[str, np.ndarray]:
    """Ground-truth rigid-group frames [N, 8, 4, 4] and their exists mask
    [N, 8] from atom37 coordinates (the ambiguous chi-swap frames are left
    out: backbone diffusion never reads them). Unknown residues have only
    the zero frame."""
    aatype = np.clip(np.asarray(aatype, np.int64), 0, 20)
    base_idx = _BASE_ATOM_IDX[aatype]  # [N, 8, 3]
    n = aatype.shape[0]
    gather = atom37[np.arange(n)[:, None, None], base_idx]  # [N, 8, 3, 3]
    gt_atoms_exist = np.prod(atom37_mask[np.arange(n)[:, None, None], base_idx], axis=-1)
    rots, trans = _gram_schmidt_frames(gather[..., 0, :], gather[..., 1, :], gather[..., 2, :])
    flip = np.eye(3, dtype=rots.dtype)  # backbone group: compose with diag(-1, 1, -1)
    flip[0, 0] = -1.0
    flip[2, 2] = -1.0
    rots[:, 0] = rots[:, 0] @ flip
    frames = np.zeros((n, 8, 4, 4), np.float32)
    frames[..., :3, :3] = rots
    frames[..., :3, 3] = trans
    frames[..., 3, 3] = 1.0
    exists = _GROUP_EXISTS[aatype] * gt_atoms_exist
    return {
        "rigidgroups_gt_frames": (frames * exists[..., None, None]).astype(np.float32),
        "rigidgroups_gt_exists": exists.astype(np.float32),
    }


def make_atom14_positions(
    aatype: np.ndarray, atom37: np.ndarray, atom37_mask: np.ndarray
) -> dict[str, np.ndarray]:
    """Gather atom37 -> atom14 positions, their exists mask and the index
    map (the ambiguous-atom alternative is left out)."""
    aatype = np.clip(np.asarray(aatype, np.int64), 0, 20)
    n = aatype.shape[0]
    a14_to_a37 = np.asarray(rc.restype_atom14_to_atom37)[aatype]  # [N, 14]
    a14_exists = np.asarray(rc.restype_atom14_exists)[aatype]
    gather = atom37[np.arange(n)[:, None], a14_to_a37]
    gather_mask = atom37_mask[np.arange(n)[:, None], a14_to_a37] * a14_exists
    return {
        "atom14_gt_positions": (gather * gather_mask[..., None]).astype(np.float32),
        "atom14_gt_exists": gather_mask.astype(np.float32),
        "residx_atom14_to_atom37": a14_to_a37.astype(np.int64),
    }


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
