"""TCR CDR-loop annotation and diffusion masks: the IMGT CDR limits and the
masks over the CDR loops of a complex's TCR chains (with the CDR3 flank
ablations). anarci numbers the chains when it imports; otherwise a
conserved-anchor heuristic does:

- the variable domain's 2nd conserved Cys (IMGT 104) and the J-region
  [FW]-G-X-G motif (IMGT 118) anchor CDR3 exactly;
- CDR1/CDR2 are located relative to the 1st conserved Cys (IMGT 23) and the
  conserved Trp (IMGT 41), approximately.
"""
from __future__ import annotations

import re

import numpy as np

from framedipt_tpu_torch.data import constants as rc
from framedipt_tpu_torch.data.protein import chain_id_to_int

CDR_RES_LIMITS: dict[str, tuple[int, int]] = {
    "CDR1": (27, 38),
    "CDR2": (56, 65),
    "CDR2.5": (81, 86),
    "CDR3": (105, 117),
}

try:  # pragma: no cover - depends on environment
    import anarci  # type: ignore

    HAVE_ANARCI = True
except ImportError:
    anarci = None
    HAVE_ANARCI = False


def _anarci_numbering(seq: str):
    numbering, _, _ = anarci.anarci([("seq1", seq)], scheme="imgt", output=False)
    if not numbering or numbering[0] is None:
        raise ValueError("anarci found no domain")
    return numbering[0][0][0]  # [( (imgt_idx, icode), aa ), ...]


_J_MOTIF = re.compile(r"[FW]G.G")


def _heuristic_anchors(seq: str) -> dict[str, int]:
    """Locate conserved V-domain anchors by sequence position (0-based).

    Returns {'cys23', 'trp41', 'cys104', 'j118'} positions. Raises
    ValueError when the anchors cannot be found.
    """
    n = len(seq)
    # 2nd conserved Cys (IMGT 104): search Cys positions in [80, 115] window
    # measured from domain start; TCR V-domains put Cys23 at ~20-25.
    cys_positions = [i for i, c in enumerate(seq) if c == "C"]
    if len(cys_positions) < 2:
        raise ValueError("fewer than two cysteines; not a V-domain")
    cys23 = next((i for i in cys_positions if 10 <= i <= 35), cys_positions[0])
    # The IMGT-104 Cys is 65-90 residues downstream of Cys23.
    cands = [i for i in cys_positions if 55 <= i - cys23 <= 95]
    if not cands:
        raise ValueError("no IMGT-104 cysteine candidate")
    # Prefer the candidate whose downstream has the J motif.
    cys104 = None
    j118 = None
    for c in cands:
        m = _J_MOTIF.search(seq[c + 4 : min(n, c + 30)])
        if m:
            cys104 = c
            j118 = c + 4 + m.start()
            break
    if cys104 is None:
        cys104 = cands[-1]
        m = _J_MOTIF.search(seq[cys104 + 4 :])
        if not m:
            raise ValueError("no J-region [FW]GxG motif after Cys104")
        j118 = cys104 + 4 + m.start()
    trp_window = seq[cys23 + 10 : cys23 + 25]
    w_off = trp_window.find("W")
    trp41 = cys23 + 10 + w_off if w_off >= 0 else cys23 + 18
    return {"cys23": cys23, "trp41": trp41, "cys104": cys104, "j118": j118}


def get_cdr_loop_bounds(seq: str, cdr_loop_id: str) -> tuple[int, int]:
    """(start, end) 0-based half-open bounds of a CDR loop in ``seq``.

    Uses anarci IMGT numbering when available, else conserved anchors.
    """
    if cdr_loop_id not in CDR_RES_LIMITS:
        raise ValueError(
            f"cdr_loop_id must be one of {list(CDR_RES_LIMITS)}, got {cdr_loop_id}"
        )
    if HAVE_ANARCI:
        numbered = _anarci_numbering(seq)
        llim, ulim = CDR_RES_LIMITS[cdr_loop_id]
        cdr = "".join(
            aa for (imgt, _), aa in numbered if llim <= imgt <= ulim
        ).replace("-", "").replace(" ", "")
        if not cdr:
            raise ValueError(f"empty {cdr_loop_id} from anarci numbering")
        start = seq.index(cdr)
        return start, start + len(cdr)

    anchors = _heuristic_anchors(seq)
    if cdr_loop_id == "CDR3":
        # IMGT 105..117 == strictly between Cys104 and J-Phe118.
        return anchors["cys104"] + 1, anchors["j118"]
    if cdr_loop_id == "CDR1":
        # IMGT 27-38 sits between Cys23 (+3) and Trp41 (-2) — approximate.
        return anchors["cys23"] + 4, anchors["trp41"] - 2
    if cdr_loop_id == "CDR2":
        # IMGT 56-65 starts ~15 residues after Trp41 — approximate.
        return anchors["trp41"] + 15, anchors["trp41"] + 25
    # CDR2.5 (IMGT 81-86).
    return anchors["trp41"] + 40, anchors["trp41"] + 46


def create_diffusion_mask(
    chain_indexes: np.ndarray,
    aatype: np.ndarray,
    tcr_chains: list[str],
    cdr_loops: list[str],
    shifted_region: str | None = None,
) -> np.ndarray:
    """Global diffusion mask over the concatenated complex, marking the
    requested CDR loops in the (re-lettered A, B, ...) TCR chains; with
    ``shifted_region`` "before" or "after", the CDR3 mask moves by its own
    length to the flank before or after the loop."""
    if any(c not in CDR_RES_LIMITS for c in cdr_loops):
        raise ValueError(f"CDR loops must be in {list(CDR_RES_LIMITS)}")
    if shifted_region is not None and shifted_region not in ("before", "after"):
        raise ValueError(f"shifted_region must be before/after, got {shifted_region}")

    mask = np.zeros_like(chain_indexes)
    sorted_chain_ids = [chr(ord("A") + i) for i in range(len(tcr_chains))]
    for i in range(len(tcr_chains)):
        cid = chain_id_to_int(sorted_chain_ids[i])
        chain_mask = (chain_indexes == cid).astype(bool)
        if not chain_mask.any():
            continue
        start_idx = int(np.where(chain_mask)[0][0])
        seq = rc.aatype_to_sequence(aatype[chain_mask])
        for loop in cdr_loops:
            s, e = get_cdr_loop_bounds(seq, loop)
            length = e - s
            if loop == "CDR3" and shifted_region == "before":
                s = s - length
            elif loop == "CDR3" and shifted_region == "after":
                s = s + length
            mask[start_idx + s : start_idx + s + length] = 1
    return mask

