"""Region-level evaluation metrics over Protein structures.

The port's copy of the JAX package's ``eval/metrics.py``, with the same
numpy arithmetic op for op and in the same dtypes (the SASA in float32), so
the numbers are equal to the bit: backbone RMSD over the diffusion regions
at model, chain and residue granularity as direct coordinate deltas (no
superposition: inpainting predictions share the fixed region's frame),
full-atom RMSD, phi/psi/omega dihedrals and their signed errors, and
SASA/RSA by Shrake-Rupley. ``average_metrics_for_middle_residues`` takes the
metric rows as a list of dicts (``eval.table``) where the JAX package takes a
DataFrame.
"""
from __future__ import annotations

import numpy as np

from framedipt_tpu_torch.data import constants as rc
from framedipt_tpu_torch.data.protein import Protein, int_to_chain_id
from framedipt_tpu_torch.eval import table

BACKBONE_ATOMS = ("N", "CA", "C", "O")
BACKBONE_IDX = tuple(rc.atom_order[a] for a in BACKBONE_ATOMS)
TCR_CHAINS = ("alpha", "beta")


# --------------------------------------------------------------------------
# Region extraction
# --------------------------------------------------------------------------


def _chain_residue_sel(prot: Protein, chain_letter: str) -> np.ndarray:
    """Boolean selector of residues in a chain, addressed by the letter the
    PDB writer assigned (sorted unique chain ints -> A, B, ...)."""
    sorted_ids = sorted(set(int(c) for c in prot.chain_index))
    letter_for = {cid: int_to_chain_id(i) for i, cid in enumerate(sorted_ids)}
    sel = np.asarray(
        [letter_for[int(c)] == chain_letter for c in prot.chain_index]
    )
    return sel


def get_region_backbone(
    prot: Protein, chain_letter: str, region: tuple[int, int]
) -> tuple[np.ndarray, np.ndarray]:
    """Backbone coords [L, 4, 3] + mask [L, 4] for residues
    region[0]..region[1] (inclusive, chain-local indices)."""
    sel = _chain_residue_sel(prot, chain_letter)
    idx = np.where(sel)[0]
    start, end = region
    idx = idx[start : end + 1]
    coords = prot.atom_positions[idx][:, BACKBONE_IDX, :]
    mask = prot.atom_mask[idx][:, BACKBONE_IDX]
    return coords, mask


# --------------------------------------------------------------------------
# RMSDs (direct deltas)
# --------------------------------------------------------------------------


def backbone_rmsd(
    prot_1: Protein,
    prot_2: Protein,
    chains: list[str],
    regions_1: list[tuple[int, int]],
    regions_2: list[tuple[int, int]],
) -> float:
    """Aggregate backbone RMSD over all diffusion regions."""
    deltas = []
    for ch, r1, r2 in zip(chains, regions_1, regions_2):
        c1, m1 = get_region_backbone(prot_1, ch, r1)
        c2, m2 = get_region_backbone(prot_2, ch, r2)
        m = (m1 * m2).astype(bool)
        deltas.append((c1 - c2)[m])
    d = np.concatenate(deltas, axis=0)
    return float(np.sqrt(np.sum(d**2) / len(d)))


def chain_backbone_rmsd(
    prot_1: Protein,
    prot_2: Protein,
    chains: list[str],
    regions_1: list[tuple[int, int]],
    regions_2: list[tuple[int, int]],
) -> dict[str, float]:
    out = {}
    for name, ch, r1, r2 in zip(TCR_CHAINS, chains, regions_1, regions_2):
        out[name] = backbone_rmsd(prot_1, prot_2, [ch], [r1], [r2])
    return out


def residue_backbone_rmsd(
    prot_1: Protein,
    prot_2: Protein,
    chains: list[str],
    regions_1: list[tuple[int, int]],
    regions_2: list[tuple[int, int]],
) -> dict[str, list[float]]:
    """Per-residue backbone RMSD within each region, keyed by chain role."""
    out = {}
    for name, ch, r1, r2 in zip(TCR_CHAINS, chains, regions_1, regions_2):
        c1, m1 = get_region_backbone(prot_1, ch, r1)
        c2, m2 = get_region_backbone(prot_2, ch, r2)
        m = m1 * m2
        per_res = np.sqrt(
            np.sum(((c1 - c2) ** 2).sum(-1) * m, axis=-1) / (m.sum(-1) + 1e-9)
        )
        out[name] = [float(x) for x in per_res]
    return out


def full_atom_rmsd(
    prot_1: Protein,
    prot_2: Protein,
    chains: list[str],
    regions_1: list[tuple[int, int]],
    regions_2: list[tuple[int, int]],
) -> float:
    """All-atom RMSD over the shared atom sets of the regions."""
    deltas = []
    for ch, r1, r2 in zip(chains, regions_1, regions_2):
        sel1 = np.where(_chain_residue_sel(prot_1, ch))[0][r1[0] : r1[1] + 1]
        sel2 = np.where(_chain_residue_sel(prot_2, ch))[0][r2[0] : r2[1] + 1]
        m = (prot_1.atom_mask[sel1] * prot_2.atom_mask[sel2]).astype(bool)
        deltas.append(
            (prot_1.atom_positions[sel1] - prot_2.atom_positions[sel2])[m]
        )
    d = np.concatenate(deltas, axis=0)
    return float(np.sqrt(np.sum(d**2) / len(d)))


# --------------------------------------------------------------------------
# Dihedrals
# --------------------------------------------------------------------------


def dihedral(p0, p1, p2, p3) -> np.ndarray:
    """Signed dihedral angle(s) in radians for points [..., 3]."""
    b0 = p0 - p1
    b1 = p2 - p1
    b2 = p3 - p2
    b1n = b1 / (np.linalg.norm(b1, axis=-1, keepdims=True) + 1e-9)
    v = b0 - np.sum(b0 * b1n, axis=-1, keepdims=True) * b1n
    w = b2 - np.sum(b2 * b1n, axis=-1, keepdims=True) * b1n
    x = np.sum(v * w, axis=-1)
    y = np.sum(np.cross(b1n, v) * w, axis=-1)
    return np.arctan2(y, x)


def backbone_dihedrals(
    prot: Protein, chain_letter: str, region: tuple[int, int] | None = None
) -> dict[str, np.ndarray]:
    """phi/psi/omega per residue of a chain (NaN where undefined)."""
    sel = np.where(_chain_residue_sel(prot, chain_letter))[0]
    pos = prot.atom_positions[sel]
    a = rc.atom_order
    n_xyz, ca, c = pos[:, a["N"]], pos[:, a["CA"]], pos[:, a["C"]]
    num = len(sel)
    phi = np.full(num, np.nan)
    psi = np.full(num, np.nan)
    omega = np.full(num, np.nan)
    if num > 1:
        phi[1:] = dihedral(c[:-1], n_xyz[1:], ca[1:], c[1:])
        psi[:-1] = dihedral(n_xyz[:-1], ca[:-1], c[:-1], n_xyz[1:])
        omega[1:] = dihedral(ca[:-1], c[:-1], n_xyz[1:], ca[1:])
    if region is not None:
        s, e = region
        phi, psi, omega = phi[s : e + 1], psi[s : e + 1], omega[s : e + 1]
    return {"phi": phi, "psi": psi, "omega": omega}


def angle_error(pred: np.ndarray, gt: np.ndarray, signed: bool = False) -> np.ndarray:
    """Periodic angle difference in radians, wrapped to (-pi, pi]."""
    diff = pred - gt
    wrapped = np.arctan2(np.sin(diff), np.cos(diff))
    return wrapped if signed else np.abs(wrapped)


# --------------------------------------------------------------------------
# SASA / RSA (Shrake-Rupley)
# --------------------------------------------------------------------------

# Max ASA per residue (Tien et al. 2013 *empirical* column), A^2, the table
# the RSA is normalized with.
MAX_ASA = {
    "A": 121.0, "R": 265.0, "N": 187.0, "D": 187.0, "C": 148.0,
    "Q": 214.0, "E": 214.0, "G": 97.0, "H": 216.0, "I": 195.0,
    "L": 191.0, "K": 230.0, "M": 203.0, "F": 228.0, "P": 154.0,
    "S": 143.0, "T": 163.0, "W": 264.0, "Y": 255.0, "V": 165.0,
}
# Theoretical column of the same paper (an ideal extended Gly-X-Gly
# tripeptide approaches these by construction).
MAX_ASA_THEORETICAL = {
    "A": 129.0, "R": 274.0, "N": 195.0, "D": 193.0, "C": 167.0,
    "Q": 225.0, "E": 223.0, "G": 104.0, "H": 224.0, "I": 197.0,
    "L": 201.0, "K": 236.0, "M": 224.0, "F": 240.0, "P": 159.0,
    "S": 155.0, "T": 172.0, "W": 285.0, "Y": 263.0, "V": 174.0,
}
_PROBE_RADIUS = 1.4


def _sphere_points(n: int = 100) -> np.ndarray:
    """Fibonacci sphere point distribution."""
    i = np.arange(n) + 0.5
    phi = np.arccos(1 - 2 * i / n)
    theta = np.pi * (1 + 5**0.5) * i
    return np.stack(
        [np.cos(theta) * np.sin(phi), np.sin(theta) * np.sin(phi), np.cos(phi)],
        axis=-1,
    )


def _atom_arrays(prot: Protein):
    """Flattened (coords, radii incl. probe, residue ids) of present atoms.

    Element inference: atom37 names start with their element letter for all
    backbone/sidechain heavy atoms in the AF2 atom37 vocabulary (N*, C*, O*,
    S[DG]) — there are no two-letter elements (SE of MSE is mapped to MET/SD
    upstream, data/mmcif.py), so the first character is exact, not heuristic.
    """
    mask = prot.atom_mask.astype(bool)
    coords = prot.atom_positions[mask]
    elem_per_type = np.asarray([t[0] for t in rc.atom_types])
    elements = np.broadcast_to(
        elem_per_type[None, :], prot.atom_mask.shape
    )[mask]
    res_ids = np.broadcast_to(
        np.arange(len(prot.aatype))[:, None], prot.atom_mask.shape
    )[mask]
    radii = np.asarray(
        [rc.van_der_waals_radius.get(e, 1.7) for e in elements]
    ) + _PROBE_RADIUS
    return coords, radii, res_ids


def shrake_rupley_sasa(
    prot: Protein, n_points: int = 100, chunk: int = 1024
) -> np.ndarray:
    """Per-residue solvent-accessible surface area (A^2).

    Vectorized Shrake-Rupley, memory-bounded: neighbour discovery and the
    test-sphere burial check both run in blocks of ~``chunk`` atoms, so no
    [A, A] matrix or full [nnz, P] burial tensor ever materializes (at a
    6.5k-atom TCR complex those would take ~600 MB of temporaries).
    """
    coords, radii, res_ids = _atom_arrays(prot)
    coords = (coords - coords.mean(axis=0)).astype(np.float32)
    radii = radii.astype(np.float32)
    sphere = _sphere_points(n_points).astype(np.float32)
    n_atoms = len(coords)

    # Pairwise neighbour test in row blocks: j can bury i's surface iff
    # |x_j - x_i| < r_i + r_j (r includes the probe). GEMM-form squared
    # distances (|x|^2 + |y|^2 - 2 x.y) — no [A, A, 3] temporary, and only
    # a [block, A] slab at a time.
    sq = np.sum(coords**2, axis=-1)
    rows_parts, cols_parts = [], []
    for s in range(0, n_atoms, chunk):
        e = min(s + chunk, n_atoms)
        d2 = sq[s:e, None] + sq[None, :] - 2.0 * (coords[s:e] @ coords.T)
        neigh = d2 < (radii[s:e, None] + radii[None, :]) ** 2
        neigh[np.arange(e - s), np.arange(s, e)] = False  # self
        r_b, c_b = np.nonzero(neigh)
        rows_parts.append(r_b + s)
        cols_parts.append(c_b)
    rows = np.concatenate(rows_parts) if rows_parts else np.zeros(0, np.int64)
    cols = np.concatenate(cols_parts) if cols_parts else np.zeros(0, np.int64)
    degree = np.bincount(rows, minlength=n_atoms)

    # Analytic burial test per neighbour pair. A surface point
    # p_k = x_i + r_i s_k of atom i is buried by neighbour j iff
    #   |p_k - x_j|^2 = r_i^2 + 2 r_i s_k.(x_i - x_j) + |x_i - x_j|^2 < r_j^2
    #   <=>  s_k . v_ij < (r_j^2 - r_i^2 - |v_ij|^2) / (2 r_i),
    # i.e. a [P,3]x[3,pairs] GEMM against a per-pair scalar threshold, then
    # a segmented OR over each atom's contiguous pair range (rows are
    # sorted by construction). Processed in atom-aligned pair chunks so the
    # burial slab stays ~pair_cap x P.
    starts = np.searchsorted(rows, np.arange(n_atoms + 1))
    buried_ik = np.zeros((n_atoms, n_points), bool)
    pair_cap = max(1, chunk) * 64  # ~64 neighbours/atom per slab
    a0 = 0
    while a0 < n_atoms:
        a1 = a0 + 1
        while a1 < n_atoms and starts[a1 + 1] - starts[a0] <= pair_cap:
            a1 += 1
        p0, p1 = starts[a0], starts[a1]
        if p1 > p0:
            r_sl, c_sl = rows[p0:p1], cols[p0:p1]
            v = coords[r_sl] - coords[c_sl]  # exact: no cancellation
            vsq = np.sum(v * v, axis=-1)
            thresh = (radii[c_sl] ** 2 - radii[r_sl] ** 2 - vsq) / (
                2.0 * radii[r_sl]
            )
            # s_k . v_ij as three outer products (K=3 GEMM is BLAS-hostile).
            dots = (
                v[:, 0, None] * sphere[None, :, 0]
                + v[:, 1, None] * sphere[None, :, 1]
                + v[:, 2, None] * sphere[None, :, 2]
            )  # [pairs, P]
            buried_pairs = dots < thresh[:, None]
            # Guard degree-0 atoms (reduceat misreads empty segments).
            padded = np.concatenate(
                [buried_pairs, np.zeros((1, n_points), bool)], axis=0
            )
            local = np.minimum(starts[a0:a1] - p0, padded.shape[0] - 1)
            buried_ik[a0:a1] = np.logical_or.reduceat(padded, local, axis=0)
        a0 = a1
    buried_ik[degree == 0] = False
    accessible_frac = 1.0 - buried_ik.mean(axis=1)
    areas = 4.0 * np.pi * radii**2 * accessible_frac

    per_res = np.zeros(len(prot.aatype))
    np.add.at(per_res, res_ids, areas)
    return per_res


def relative_sasa(prot: Protein, sasa: np.ndarray | None = None) -> np.ndarray:
    """RSA = SASA / max-ASA(restype); NaN for unknown residues."""
    if sasa is None:
        sasa = shrake_rupley_sasa(prot)
    out = np.full(len(sasa), np.nan)
    for i, aa in enumerate(prot.aatype):
        one = rc.restypes[aa] if 0 <= aa < 20 else None
        if one and one in MAX_ASA:
            out[i] = sasa[i] / MAX_ASA[one]
    return out


# --------------------------------------------------------------------------
# Metric registries
#
# Nested dicts are flattened with "_" and per-residue positions use the
# eval-index scheme {1..L-4, -4..-1}, so e.g. `bb_rmsd_alpha_-2` is the
# 2nd-to-last diffused residue of the alpha chain.
# --------------------------------------------------------------------------

DIHEDRAL_ANGLES = ("phi", "psi", "omega")


def convert_to_eval_idx(vals) -> dict[int, float]:
    """Sequence -> {-4..-1: tail values, 1..len-4: head values}."""
    if len(vals) <= 4:  # degenerate short region: head-indexed only
        return {i + 1: v for i, v in enumerate(vals)}
    val_dict = {}
    for idx in (-4, -3, -2, -1):
        val_dict[idx] = vals[idx]
    for i, val in enumerate(vals[:-4]):
        val_dict[i + 1] = val
    return val_dict


def flatten(obj, depth: int = -1, delim: str = "_", parent: str = ""):
    """Flatten nested dicts/lists into {joined_key: leaf}."""
    if depth == 0:
        return obj
    items = []
    if isinstance(obj, dict):
        for key, val in obj.items():
            new_key = f"{parent}{delim}{key}" if parent else str(key)
            items.extend(flatten(val, depth - 1, delim, new_key).items())
    elif isinstance(obj, (list, tuple)):
        for i, val in enumerate(obj):
            new_key = f"{parent}{delim}{i + 1}"
            items.extend(flatten(val, depth - 1, delim, new_key).items())
    else:
        items.append((parent, obj))
    return dict(items)


def average_metrics_for_middle_residues(
    rows: list[dict], metric: str
) -> dict[str, list[np.ndarray]]:
    """Regroup a flattened per-residue metric (``{metric}_{chain}_{idx}``
    columns of the metric rows) into the XTICKS layout: left positions 1-4,
    one nanmean-averaged middle bucket, right positions -4..-1, per chain.
    Feeds the grouped alpha/beta boxplots."""
    columns = table.columns(rows)
    out: dict[str, list[np.ndarray]] = {}
    for tcr_chain in ("alpha", "beta"):
        left = [f"{metric}_{tcr_chain}_{i}" for i in (1, 2, 3, 4)]
        right = [f"{metric}_{tcr_chain}_{i}" for i in (-4, -3, -2, -1)]
        middle = [
            c
            for c in columns
            if c.startswith(f"{metric}_{tcr_chain}_") and c not in left + right
        ]
        groups = [table.present(rows, c) if c in columns else np.array([]) for c in left]
        if middle:
            mid = np.nanmean(np.stack([table.column(rows, c) for c in middle], axis=1), axis=1)
            groups.append(mid[~np.isnan(mid)])
        else:
            groups.append(np.array([]))
        groups += [table.present(rows, c) if c in columns else np.array([]) for c in right]
        out[tcr_chain] = groups
    return out


# Memoize SASA per Protein instance: the 8 ASA/RSA registry metrics all
# derive from the same two Shrake-Rupley computations per (gt, sample) pair.
_SASA_CACHE: dict[int, tuple[Protein, np.ndarray]] = {}


def _cached_sasa(prot: Protein) -> np.ndarray:
    hit = _SASA_CACHE.get(id(prot))
    if hit is not None and hit[0] is prot:
        return hit[1]
    sasa = shrake_rupley_sasa(prot)
    if len(_SASA_CACHE) > 64:
        _SASA_CACHE.clear()
    _SASA_CACHE[id(prot)] = (prot, sasa)
    return sasa


def _region_sasa_rsa(prot: Protein, chains, regions):
    """{chain_role: asa list}, {chain_role: rsa list} over the regions."""
    sasa = _cached_sasa(prot)
    rsa = relative_sasa(prot, sasa)
    asas, rsas = {}, {}
    for role, ch, (s, e) in zip(TCR_CHAINS, chains, regions):
        idx = np.where(_chain_residue_sel(prot, ch))[0][s : e + 1]
        asas[role] = [float(x) for x in sasa[idx]]
        rsas[role] = [float(x) for x in rsa[idx]]
    return asas, rsas


def _residue_dict(per_chain: dict[str, list]) -> dict[str, dict[int, float]]:
    return {k: convert_to_eval_idx(v) for k, v in per_chain.items()}


# --- model-level -----------------------------------------------------------


def model_bb_rmsd(gt, sample, chains, regions_gt, regions_sample) -> float:
    return backbone_rmsd(gt, sample, chains, regions_gt, regions_sample)


def model_full_atom_rmsd(gt, sample, chains, regions_gt, regions_sample) -> float:
    return full_atom_rmsd(gt, sample, chains, regions_gt, regions_sample)


# --- chain-level -----------------------------------------------------------


def chain_bb_rmsd(gt, sample, chains, regions_gt, regions_sample):
    return chain_backbone_rmsd(gt, sample, chains, regions_gt, regions_sample)


# --- residue-level ---------------------------------------------------------


def residue_bb_rmsd(gt, sample, chains, regions_gt, regions_sample):
    return _residue_dict(
        residue_backbone_rmsd(gt, sample, chains, regions_gt, regions_sample)
    )


def _make_sasa_metric(which: str, kind: str):
    def fn(gt, sample, chains, regions_gt, regions_sample):
        if which in ("gt", "both"):
            gt_asa, gt_rsa = _region_sasa_rsa(gt, chains, regions_gt)
        if which in ("sample", "both"):
            s_asa, s_rsa = _region_sasa_rsa(sample, chains, regions_sample)
        if which == "gt":
            return _residue_dict(gt_asa if kind == "asa" else gt_rsa)
        if which == "sample":
            return _residue_dict(s_asa if kind == "asa" else s_rsa)
        g = gt_asa if kind.startswith("asa") else gt_rsa
        s = s_asa if kind.startswith("asa") else s_rsa
        err = {
            role: [
                (a - b) ** 2 if kind.endswith("square_error") else abs(a - b)
                for a, b in zip(g[role], s[role])
            ]
            for role in g
        }
        return _residue_dict(err)

    return fn


# --- residue-group (dihedral) level ---------------------------------------


def _region_dihedrals(prot, chains, regions):
    """{angle: {chain_role: {eval_idx: degrees}}} over diffused regions."""
    out: dict[str, dict[str, dict[int, float]]] = {a: {} for a in DIHEDRAL_ANGLES}
    for role, ch, region in zip(TCR_CHAINS, chains, regions):
        d = backbone_dihedrals(prot, ch, region)
        for angle in DIHEDRAL_ANGLES:
            vals = [float(np.degrees(v)) for v in d[angle]]
            out[angle][role] = convert_to_eval_idx(vals)
    return out


def group_signed_angle_error(gt, sample, chains, regions_gt, regions_sample):
    d_gt = _region_dihedrals(gt, chains, regions_gt)
    d_s = _region_dihedrals(sample, chains, regions_sample)
    out = {}
    for angle in DIHEDRAL_ANGLES:
        out[angle] = {}
        for role in d_gt[angle]:
            out[angle][role] = {
                idx: float(
                    np.degrees(
                        angle_error(
                            np.radians(d_s[angle][role][idx]),
                            np.radians(d_gt[angle][role][idx]),
                            signed=True,
                        )
                    )
                )
                for idx in d_gt[angle][role]
            }
    return out


def group_angle_error(gt, sample, chains, regions_gt, regions_sample):
    signed = group_signed_angle_error(gt, sample, chains, regions_gt, regions_sample)
    return {
        a: {c: {i: abs(v) for i, v in d.items()} for c, d in cd.items()}
        for a, cd in signed.items()
    }


def group_sample_angle(gt, sample, chains, regions_gt, regions_sample):
    return _region_dihedrals(sample, chains, regions_sample)


def group_gt_angle(gt, sample, chains, regions_gt, regions_sample):
    return _region_dihedrals(gt, chains, regions_gt)


MODEL_METRIC_NAME_TO_FN = {
    "bb_rmsd": model_bb_rmsd,
    "full_atom_rmsd": model_full_atom_rmsd,
}
CHAIN_METRIC_NAME_TO_FN = {"bb_rmsd": chain_bb_rmsd}
RESIDUE_METRIC_NAME_TO_FN = {
    "bb_rmsd": residue_bb_rmsd,
    "gt_asa": _make_sasa_metric("gt", "asa"),
    "sample_asa": _make_sasa_metric("sample", "asa"),
    "asa_abs_error": _make_sasa_metric("both", "asa_abs_error"),
    "asa_square_error": _make_sasa_metric("both", "asa_square_error"),
    "gt_rsa": _make_sasa_metric("gt", "rsa"),
    "sample_rsa": _make_sasa_metric("sample", "rsa"),
    "rsa_abs_error": _make_sasa_metric("both", "rsa_abs_error"),
    "rsa_square_error": _make_sasa_metric("both", "rsa_square_error"),
}
RESIDUE_GROUP_METRIC_NAME_TO_FN = {
    "angle_error": group_angle_error,
    "signed_angle_error": group_signed_angle_error,
    "sample": group_sample_angle,
    "gt": group_gt_angle,
}
METRIC_TYPES = {
    "model_metrics": MODEL_METRIC_NAME_TO_FN,
    "chain_metrics": CHAIN_METRIC_NAME_TO_FN,
    "residue_metrics": RESIDUE_METRIC_NAME_TO_FN,
    "residue_group_metrics": RESIDUE_GROUP_METRIC_NAME_TO_FN,
}

# Default metric selection, without full_atom_rmsd, which needs a full-atom
# reconstruction of the samples first.
DEFAULT_METRIC_CFG = {
    "model_metrics": ["bb_rmsd"],
    "chain_metrics": ["bb_rmsd"],
    "residue_metrics": ["bb_rmsd"],
    "residue_group_metrics": ["angle_error", "signed_angle_error", "sample", "gt"],
}
SASA_METRIC_NAMES = [
    "gt_asa", "sample_asa", "asa_abs_error", "asa_square_error",
    "gt_rsa", "sample_rsa", "rsa_abs_error", "rsa_square_error",
]
