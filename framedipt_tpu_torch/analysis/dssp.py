"""Secondary structure (simplified Kabsch-Sander DSSP: H, E, C) and radius
of gyration, in numpy: the JAX package's ``analysis/dssp.py``. (H, G, I)
map to 'H', (E, B) to 'E', the rest to 'C'; Rg is mass-weighted, in
nanometers.
"""
from __future__ import annotations

import numpy as np

from framedipt_tpu_torch.data import constants as rc

# Kabsch-Sander H-bond electrostatic model.
_Q1Q2_F = 0.084 * 332.0
_HBOND_ENERGY_CUTOFF = -0.5
_ATOM_MASSES = {"C": 12.011, "N": 14.007, "O": 15.999, "S": 32.06}


def _hbond_energy_matrix(
    n: np.ndarray, ca: np.ndarray, c: np.ndarray, o: np.ndarray, exists: np.ndarray
) -> np.ndarray:
    """E[i, j]: H-bond energy donor NH(i) -> acceptor C=O(j)."""
    num = len(n)
    # Amide H: 1.01 A from N, opposite the bisector of (CA-N, C_prev-N).
    h = n.copy()
    prev_c = np.roll(c, 1, axis=0)
    d1 = n - prev_c
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True) + 1e-9
    d2 = n - ca
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True) + 1e-9
    bisector = d1 + d2
    bisector /= np.linalg.norm(bisector, axis=-1, keepdims=True) + 1e-9
    h = n + 1.01 * bisector
    h[0] = n[0]  # first residue has no previous C; no donor

    def dist(a, b):
        return np.linalg.norm(a[:, None] - b[None, :], axis=-1) + 1e-9

    e = _Q1Q2_F * (
        1.0 / dist(n, o) + 1.0 / dist(h, c) - 1.0 / dist(h, o) - 1.0 / dist(n, c)
    )
    # Mask: no self/neighbor bonds, first residue no donor, missing atoms.
    idx = np.arange(num)
    near = np.abs(idx[:, None] - idx[None, :]) < 2
    e[near] = 0.0
    e[0, :] = 0.0
    e[~exists.astype(bool), :] = 0.0
    e[:, ~exists.astype(bool)] = 0.0
    return e


def assign_secondary_structure(
    atom37_pos: np.ndarray, atom37_mask: np.ndarray
) -> np.ndarray:
    """Per-residue simplified SS labels ('H'/'E'/'C') from backbone atoms."""
    a = rc.atom_order
    n_xyz = atom37_pos[:, a["N"]]
    ca_xyz = atom37_pos[:, a["CA"]]
    c_xyz = atom37_pos[:, a["C"]]
    o_xyz = atom37_pos[:, a["O"]]
    exists = (
        atom37_mask[:, a["N"]]
        * atom37_mask[:, a["CA"]]
        * atom37_mask[:, a["C"]]
        * atom37_mask[:, a["O"]]
    )
    num = len(n_xyz)
    if num < 5:
        return np.full(num, "C")

    e = _hbond_energy_matrix(n_xyz, ca_xyz, c_xyz, o_xyz, exists)
    hbond = e < _HBOND_ENERGY_CUTOFF  # hbond[i, j]: NH(i) -> O=C(j)

    ss = np.full(num, "C", dtype="<U1")

    # n-turns: Hbond(i+n -> i).
    def turn(nlen):
        t = np.zeros(num, bool)
        for i in range(num - nlen):
            if hbond[i + nlen, i]:
                t[i] = True
        return t

    turn3, turn4, turn5 = turn(3), turn(4), turn(5)

    # Alpha helix: two consecutive 4-turns -> residues i+1..i+4.
    helix = np.zeros(num, bool)
    for i in range(1, num - 4):
        if turn4[i] and turn4[i - 1]:
            helix[i : i + 4] = True
    # 3-10 helix: two consecutive 3-turns.
    for i in range(1, num - 3):
        if turn3[i] and turn3[i - 1]:
            helix[i : i + 3] = True
    # Pi helix: two consecutive 5-turns.
    for i in range(1, num - 5):
        if turn5[i] and turn5[i - 1]:
            helix[i : i + 5] = True

    # Bridges (beta): Kabsch-Sander parallel/antiparallel patterns.
    bridge = np.zeros(num, bool)
    for i in range(1, num - 1):
        for j in range(i + 3, num - 1):
            parallel = (hbond[j, i - 1] and hbond[i + 1, j]) or (
                hbond[i, j - 1] and hbond[j + 1, i]
            )
            antiparallel = (hbond[j, i] and hbond[i, j]) or (
                hbond[j + 1, i - 1] and hbond[i + 1, j - 1]
            )
            if parallel or antiparallel:
                bridge[i] = True
                bridge[j] = True

    ss[bridge] = "E"
    ss[helix] = "H"  # helix takes precedence, as in DSSP ordering
    ss[~exists.astype(bool)] = "C"
    return ss


def ss_metrics_from_atom37(
    atom37_pos: np.ndarray, atom37_mask: np.ndarray
) -> dict[str, float]:
    ss = assign_secondary_structure(atom37_pos, atom37_mask)
    helix = float(np.mean(ss == "H"))
    strand = float(np.mean(ss == "E"))
    coil = float(np.mean(ss == "C"))
    return {
        "non_coil_percent": helix + strand,
        "coil_percent": coil,
        "helix_percent": helix,
        "strand_percent": strand,
        "radius_of_gyration": radius_of_gyration(atom37_pos, atom37_mask),
    }


def radius_of_gyration(atom37_pos: np.ndarray, atom37_mask: np.ndarray) -> float:
    """Mass-weighted Rg over present atoms, in nm (mdtraj convention)."""
    masses = np.asarray(
        [_ATOM_MASSES.get(name[0], 12.011) for name in rc.atom_types]
    )
    w = atom37_mask * masses[None, :]
    w_flat = w.reshape(-1)
    pos_flat = atom37_pos.reshape(-1, 3) * 0.1  # A -> nm
    total = w_flat.sum() + 1e-9
    com = (pos_flat * w_flat[:, None]).sum(axis=0) / total
    sq = np.sum((pos_flat - com) ** 2, axis=-1)
    return float(np.sqrt((w_flat * sq).sum() / total))
