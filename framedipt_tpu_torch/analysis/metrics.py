"""Structure comparison and plausibility metrics of sampled backbones
(numpy, on the host): the Kabsch superposition, aligned and direct RMSD,
the TM-score of two equal-length CA traces, CA-CA geometry checks, and
:func:`protein_metrics`, which gathers them with secondary structure and
the violation metrics for one prediction."""
from __future__ import annotations

import numpy as np

from framedipt_tpu_torch.data import constants as rc


def rigid_transform_3d(
    a: np.ndarray, b: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray, bool]:
    """Least-squares rigid transform mapping point set ``a`` onto ``b``
    ([N, 3] each), a reflection corrected. Returns (a transformed, R, t,
    whether a reflection was corrected)."""
    assert a.shape == b.shape
    centroid_a = a.mean(axis=0)
    centroid_b = b.mean(axis=0)
    h = (a - centroid_a).T @ (b - centroid_b)
    u, _, vt = np.linalg.svd(h)
    r = vt.T @ u.T
    reflection = False
    if np.linalg.det(r) < 0:
        vt[2, :] *= -1
        r = vt.T @ u.T
        reflection = True
    t = centroid_b - r @ centroid_a
    return (r @ a.T).T + t, r, t, reflection


def calc_aligned_rmsd(pos_1: np.ndarray, pos_2: np.ndarray) -> float:
    """Mean distance after superposing ``pos_1`` onto ``pos_2`` (the
    reference's "RMSD": the mean of the per-point norms, not their root mean
    square)."""
    aligned = rigid_transform_3d(pos_1, pos_2)[0]
    return float(np.mean(np.linalg.norm(aligned - pos_2, axis=-1)))


def calc_rmsd(pos_1: np.ndarray, pos_2: np.ndarray) -> float:
    """Root mean square distance without superposition."""
    return float(np.sqrt(np.mean(np.sum((pos_1 - pos_2) ** 2, axis=-1))))


def _tm_d0(n: int) -> float:
    if n <= 21:
        return 0.5
    return 1.24 * (n - 15) ** (1.0 / 3.0) - 1.8


def _tm_from_distances(d2: np.ndarray, d0: float, norm_len: int) -> float:
    return float(np.sum(1.0 / (1.0 + d2 / d0**2)) / norm_len)


def calc_tm_score(
    pos_1: np.ndarray,
    pos_2: np.ndarray,
    seq_1: str | None = None,
    seq_2: str | None = None,
) -> tuple[float, float]:
    """TM-score of two CA traces of equal length, residue i against
    residue i: seed fragments of the whole, half and quarter length,
    superpose each, keep the residues within max(d0, 3) A, superpose again
    until the set holds still, and score the best superposition with
    d0(L). Returns (TM normalised by the first length, by the second); the
    lengths are equal, so the two agree."""
    del seq_1, seq_2  # the correspondence is positional
    n = pos_1.shape[0]
    if n != pos_2.shape[0]:
        raise ValueError("calc_tm_score expects equal-length CA traces")
    if n < 3:
        return 0.0, 0.0
    d0 = max(_tm_d0(n), 0.5)

    best_tm = -1.0
    best_d2 = None
    frag_lens = sorted({n, max(4, n // 2), max(4, n // 4)}, reverse=True)
    for frag in frag_lens:
        for s in range(0, n - frag + 1, max(1, frag // 2)):
            sel = np.zeros(n, bool)
            sel[s : s + frag] = True
            for _ in range(20):
                if sel.sum() < 3:
                    break
                _, r, t, _ = rigid_transform_3d(pos_1[sel], pos_2[sel])
                d2 = np.sum(((r @ pos_1.T).T + t - pos_2) ** 2, axis=-1)
                tm = _tm_from_distances(d2, d0, n)
                if tm > best_tm:
                    best_tm = tm
                    best_d2 = d2
                new_sel = d2 < max(d0, 3.0) ** 2
                if new_sel.sum() < 3 or np.array_equal(new_sel, sel):
                    break
                sel = new_sel
    tm1 = _tm_from_distances(best_d2, max(_tm_d0(n), 0.5), n)
    return tm1, best_tm


def ca_ca_distance(ca_pos: np.ndarray, tol: float = 0.1) -> tuple[float, float]:
    """(mean |d - ideal| over consecutive CA-CA distances, fraction of them
    below ideal + tol)."""
    dists = np.linalg.norm(ca_pos - np.roll(ca_pos, 1, axis=0), axis=-1)[1:]
    dev = float(np.mean(np.abs(dists - rc.ca_ca)))
    valid = float(np.mean(dists < (rc.ca_ca + tol)))
    return dev, valid


def ca_ca_clashes(ca_pos: np.ndarray, tol: float = 1.5) -> tuple[float, float]:
    """(count, fraction) of CA pairs closer than tol."""
    d = np.linalg.norm(ca_pos[:, None] - ca_pos[None, :], axis=-1)
    inter = d[np.triu_indices(len(ca_pos), k=1)]
    clashes = inter < tol
    return float(clashes.sum()), float(clashes.mean())


def protein_metrics(*, pdb_path, atom37_pos: np.ndarray, gt_atom37_pos: np.ndarray,
                    gt_aatype: np.ndarray, diffuse_mask: np.ndarray) -> dict[str, float]:
    """The plausibility and accuracy metrics of one prediction: CA-CA
    deviation and validity, CA clashes, the TM-score of the diffused CA
    against the ground truth's, secondary structure and radius of gyration,
    and the violation metrics. An atom at the origin counts as missing.
    ``pdb_path`` is accepted for the reference's signature and not read."""
    from framedipt_tpu_torch.analysis import dssp as dssp_lib
    from framedipt_tpu_torch.analysis import violations as viol_lib

    del pdb_path
    atom37_mask = np.any(atom37_pos, axis=-1)
    bb_mask = np.any(atom37_mask, axis=-1)
    ss_metrics = dssp_lib.ss_metrics_from_atom37(atom37_pos[bb_mask], atom37_mask[bb_mask])

    ca_pos = atom37_pos[..., rc.CA_IDX, :][bb_mask]
    ca_dev, ca_valid = ca_ca_distance(ca_pos)
    num_clash, clash_pct = ca_ca_clashes(ca_pos)

    bb_diffuse_mask = (diffuse_mask * bb_mask).astype(bool)
    gt_ca = gt_atom37_pos[..., rc.CA_IDX, :][bb_diffuse_mask]
    pred_ca = atom37_pos[..., rc.CA_IDX, :][bb_diffuse_mask]
    _, tm = calc_tm_score(pred_ca, gt_ca)

    viol = viol_lib.violation_metrics(atom37_pos, atom37_mask.astype(np.float32), gt_aatype)
    out = {
        "ca_ca_bond_dev": ca_dev,
        "ca_ca_valid_percent": ca_valid,
        "ca_steric_clash_percent": clash_pct,
        "num_ca_steric_clashes": num_clash,
        "tm_score": tm,
        **ss_metrics,
        **viol,
    }
    return {k: float(np.mean(v)) for k, v in out.items()}
