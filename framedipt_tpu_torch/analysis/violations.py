"""Structural violation metrics (numpy), with AlphaFold2's formulas: the
inter-residue C-N bond length and CA-C-N angle losses (tolerance 12 standard
deviations) and the mean clash loss of non-bonded heavy atoms (1.5 A overlap
tolerance; the peptide bond's C-N and disulfide SG-SG pairs exempt)."""
from __future__ import annotations

import numpy as np

from framedipt_tpu_torch.data import constants as rc
from framedipt_tpu_torch.data.transforms import make_atom14_positions

_TOLERANCE_FACTOR = 12.0
_CLASH_OVERLAP_TOLERANCE = 1.5
_EPS = 1e-6


def _atom14_radii() -> np.ndarray:
    """[21, 14]: the van der Waals radius of each residue type's atom14 slots."""
    radii = np.zeros((21, 14))
    for r_i, r1 in enumerate(rc.restypes):
        for j, name in enumerate(rc.restype_name_to_atom14_names[rc.restype_1to3[r1]]):
            if name:
                radii[r_i, j] = rc.van_der_waals_radius[name[0]]
    return radii


def violation_metrics(atom37_pos: np.ndarray, atom37_mask: np.ndarray,
                      aatype: np.ndarray) -> dict[str, float]:
    """``bonds_c_n_loss_mean``, ``angles_ca_c_n_loss_mean`` and
    ``clashes_mean_loss`` of one chain of residues in order (0 for fewer
    than two residues)."""
    aatype = np.clip(np.asarray(aatype, np.int64), 0, 20)
    n = len(aatype)
    if n < 2:
        return {"bonds_c_n_loss_mean": 0.0, "angles_ca_c_n_loss_mean": 0.0,
                "clashes_mean_loss": 0.0}
    a = rc.atom_order
    this_ca = atom37_pos[:-1, a["CA"]]
    this_c = atom37_pos[:-1, a["C"]]
    next_n = atom37_pos[1:, a["N"]]
    this_c_mask = atom37_mask[:-1, a["C"]]
    this_ca_mask = atom37_mask[:-1, a["CA"]]
    next_n_mask = atom37_mask[1:, a["N"]]

    # C-N bond length, proline's own ideal length after it.
    c_n = np.linalg.norm(this_c - next_n, axis=-1)
    next_is_pro = (aatype[1:] == rc.restype_order["P"]).astype(np.float64)
    bond_len = np.asarray(rc.between_res_bond_length_c_n)
    bond_std = np.asarray(rc.between_res_bond_length_stddev_c_n)
    gt_len = (1.0 - next_is_pro) * bond_len[0] + next_is_pro * bond_len[1]
    gt_std = (1.0 - next_is_pro) * bond_std[0] + next_is_pro * bond_std[1]
    err = np.sqrt(_EPS + (c_n - gt_len) ** 2)
    loss = np.maximum(err - _TOLERANCE_FACTOR * gt_std, 0.0)
    mask = this_c_mask * next_n_mask
    bonds_c_n_loss = float(np.sum(mask * loss) / (np.sum(mask) + _EPS))

    # CA-C-N angle.
    def unit(v):
        return v / (np.linalg.norm(v, axis=-1, keepdims=True) + 1e-9)

    cos_angle = np.sum(unit(this_ca - this_c) * unit(next_n - this_c), axis=-1)
    gt_cos, gt_cos_std = rc.between_res_cos_angles_ca_c_n
    err = np.sqrt(_EPS + (cos_angle - gt_cos) ** 2)
    loss = np.maximum(err - _TOLERANCE_FACTOR * gt_cos_std, 0.0)
    mask = this_ca_mask * this_c_mask * next_n_mask
    angles_ca_c_n_loss = float(np.sum(mask * loss) / (np.sum(mask) + _EPS))

    # Clashes between atoms of different residues, each pair once.
    a14 = make_atom14_positions(aatype, atom37_pos, atom37_mask)
    flat_pos = a14["atom14_gt_positions"].reshape(-1, 3)
    mask14 = a14["atom14_gt_exists"]
    flat_mask = mask14.reshape(-1)
    flat_radius = (_atom14_radii()[aatype] * mask14).reshape(-1)
    res_idx = np.repeat(np.arange(n), 14)
    atom_idx = np.tile(np.arange(14), n)

    d = np.linalg.norm(flat_pos[:, None] - flat_pos[None, :], axis=-1) + 1e-10
    pair_mask = flat_mask[:, None] * flat_mask[None, :]
    pair_mask = pair_mask * (res_idx[:, None] < res_idx[None, :])
    # The peptide bond C(i)-N(i+1) (atom14 slots 2 and 0).
    c_n_bond = ((res_idx[:, None] + 1 == res_idx[None, :]) & (atom_idx[:, None] == 2)
                & (atom_idx[None, :] == 0))
    pair_mask = pair_mask * (1.0 - c_n_bond)
    # Disulfide SG-SG.
    sg_slot = rc.restype_name_to_atom14_names["CYS"].index("SG")
    is_sg = (np.repeat(aatype, 14) == rc.restype_order["C"]) & (atom_idx == sg_slot)
    pair_mask = pair_mask * (1.0 - (is_sg[:, None] & is_sg[None, :]))

    allowed = flat_radius[:, None] + flat_radius[None, :]
    clash_loss = np.maximum(allowed - _CLASH_OVERLAP_TOLERANCE - d, 0.0)
    clashes_mean = float(np.sum(pair_mask * clash_loss) / (np.sum(pair_mask) + _EPS))
    return {"bonds_c_n_loss_mean": bonds_c_n_loss, "angles_ca_c_n_loss_mean": angles_ca_c_n_loss,
            "clashes_mean_loss": clashes_mean}
