"""Superposition of two structures through their sequence alignment.

The sequences are aligned globally (Needleman-Wunsch, identity scoring), the
residues matched in the alignment give the shared atoms, and the mobile
structure is superposed onto the target by the Kabsch fit of those atoms,
optionally leaving a region of the target out of the fit (a diffused loop,
so that the fit uses the fixed context only).
"""
from __future__ import annotations

import copy

import numpy as np

from framedipt_tpu_torch.analysis.metrics import rigid_transform_3d
from framedipt_tpu_torch.data import constants as rc
from framedipt_tpu_torch.data.protein import Protein


def needleman_wunsch(seq1: str, seq2: str, match: float = 2.0, mismatch: float = -1.0,
                     gap: float = -2.0) -> tuple[str, str]:
    """Global alignment; returns the two gapped sequences. Ties prefer the
    diagonal, then a gap in ``seq2``."""
    n, m = len(seq1), len(seq2)
    score = np.zeros((n + 1, m + 1))
    score[:, 0] = np.arange(n + 1) * gap
    score[0, :] = np.arange(m + 1) * gap
    ptr = np.zeros((n + 1, m + 1), np.int8)  # 0 diagonal, 1 up, 2 left
    codes2 = np.frombuffer(seq2.encode(), np.uint8)
    for i in range(1, n + 1):
        s_match = score[i - 1, :-1] + np.where(codes2 == ord(seq1[i - 1]), match, mismatch)
        for j in range(1, m + 1):
            diag = s_match[j - 1]
            up = score[i - 1, j] + gap
            left = score[i, j - 1] + gap
            best = max(diag, up, left)
            score[i, j] = best
            ptr[i, j] = 0 if best == diag else (1 if best == up else 2)
    a1, a2 = [], []
    i, j = n, m
    while i > 0 or j > 0:
        if i > 0 and j > 0 and ptr[i, j] == 0:
            a1.append(seq1[i - 1])
            a2.append(seq2[j - 1])
            i, j = i - 1, j - 1
        elif i > 0 and (j == 0 or ptr[i, j] == 1):
            a1.append(seq1[i - 1])
            a2.append("-")
            i -= 1
        else:
            a1.append("-")
            a2.append(seq2[j - 1])
            j -= 1
    return "".join(reversed(a1)), "".join(reversed(a2))


def get_shared_residues(prot1: Protein, prot2: Protein) -> tuple[np.ndarray, np.ndarray]:
    """The indices of the residues matched (neither a gap) in the alignment
    of the two sequences, in each structure."""
    a1, a2 = needleman_wunsch(rc.aatype_to_sequence(prot1.aatype),
                              rc.aatype_to_sequence(prot2.aatype))
    idx1, idx2 = [], []
    i1 = i2 = 0
    for c1, c2 in zip(a1, a2):
        if c1 != "-" and c2 != "-":
            idx1.append(i1)
            idx2.append(i2)
        i1 += c1 != "-"
        i2 += c2 != "-"
    return np.asarray(idx1, np.int64), np.asarray(idx2, np.int64)


def align(mobile: Protein, target: Protein, exclude_region: tuple[int, int] | None = None,
          atoms: tuple[str, ...] = ("CA",)) -> tuple[Protein, float]:
    """Superpose ``mobile`` onto ``target`` by the shared residues' ``atoms``
    present in both, leaving out of the fit the target's residues
    ``exclude_region`` (first, last; inclusive, target indices). Returns
    (a moved copy of mobile, the fit's RMSD). Raises ValueError with fewer
    than 3 shared atoms."""
    idx1, idx2 = get_shared_residues(mobile, target)
    if exclude_region is not None:
        s, e = exclude_region
        keep = (idx2 < s) | (idx2 > e)
        idx1, idx2 = idx1[keep], idx2[keep]
    atom_idx = [rc.atom_order[a] for a in atoms]
    shared = (mobile.atom_mask[idx1][:, atom_idx].astype(bool)
              & target.atom_mask[idx2][:, atom_idx].astype(bool))
    p1 = mobile.atom_positions[idx1][:, atom_idx][shared]
    p2 = target.atom_positions[idx2][:, atom_idx][shared]
    if len(p1) < 3:
        raise ValueError("fewer than 3 shared atoms for superposition")
    moved_pts, r, t, _ = rigid_transform_3d(p1, p2)
    rmsd = float(np.sqrt(np.mean(np.sum((moved_pts - p2) ** 2, axis=-1))))
    out = copy.deepcopy(mobile)
    out.atom_positions = (np.einsum("ij,raj->rai", r, mobile.atom_positions) + t) \
        * mobile.atom_mask[..., None]
    return out, rmsd
