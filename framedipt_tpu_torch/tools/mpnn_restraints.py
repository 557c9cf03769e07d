"""Reference-format MPNN restraint dicts -> dense model tensors.

Covers the protein_mpnn_run.py jsonl surface beyond --fixed_positions/
--bias_AA: ``--omit_AA_jsonl`` (per-position forbidden letters),
``--bias_by_res_jsonl`` (per-position per-letter logit bias),
``--tied_positions_jsonl`` (arbitrary tie groups, incl. the
[[positions],[betas]] weighted form of make_pos_neg_tied_positions_dict),
and ``--pssm_jsonl`` (+ the --pssm_threshold log-odds mask).

Dict shapes follow ``tied_featurize`` (protein_mpnn_utils.py:286-337):

- omit:  {chain: [[[1-based positions], "LETTERS"], ...]}
- bias_by_res: {chain: [[21 floats] x chain_len]}
- tied:  [{chain: [pos, ...]} | {chain: [[pos, ...], [beta, ...]]}, ...]
- pssm:  {chain: {"pssm_coef": [L], "pssm_bias": [[21] x L],
          "pssm_log_odds": [[21] x L]}}

The reference's jsonl files key these by pdb name first
({name: inner}, one json object per line); :func:`resolve_name` accepts
both that and the bare inner form so helper-script outputs load
unchanged. All builders return batch-1 numpy arrays in the concatenated
``featurize_chains`` coordinate frame (chains in file order); chains
absent from a dict get the neutral default, unknown chain letters fail
loud.
"""
from __future__ import annotations

import json
import pathlib
from typing import Any

import numpy as np

from framedipt_tpu_torch.model.mpnn import MPNN_ALPHABET
from framedipt_tpu_torch.tools.external import ToolUnavailable

VOCAB = len(MPNN_ALPHABET)
# tied_featurize's "no pssm" default: log-odds +10000 passes any
# reasonable threshold, coef 0 disables mixing (utils :300-302).
PSSM_LOG_ODDS_DEFAULT = 10000.0


def load_jsonl(path: str | pathlib.Path) -> Any:
    """Read a restraint file: plain JSON (possibly pretty-printed), or
    the reference's jsonl form — one json object per line, the LAST line
    winning (the runner's loop semantics, protein_mpnn_run.py:93-136)."""
    text = pathlib.Path(path).read_text()
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        pass
    obj = None
    for line in text.splitlines():
        if line.strip():
            obj = json.loads(line)
    if obj is None:
        raise ToolUnavailable(f"{path}: no json object found")
    return obj


def resolve_name(d: Any, name: str) -> Any:
    """Accept both {pdb_name: inner} (the helper-script format) and the
    bare inner dict/list."""
    if isinstance(d, dict) and name in d:
        return d[name]
    return d


def _offsets(letters: list[str], lens: list[int]) -> dict[str, int]:
    return dict(
        zip(letters, np.concatenate([[0], np.cumsum(lens)[:-1]]).tolist())
    )


def _check_chain(ltr: str, offsets: dict[str, int], what: str) -> int:
    if ltr not in offsets:
        raise ToolUnavailable(
            f"{what}: chain {ltr!r} not present (chains: {sorted(offsets)})"
        )
    return int(offsets[ltr])


def chain_m_pos_from_dict(
    fixed: dict[str, list[int]], letters: list[str], lens: list[int]
) -> np.ndarray:
    """--fixed_positions_jsonl: [1,L] mask, 0 where the native residue is
    kept (tied_featurize fixed_position_mask, utils :286-291)."""
    out = np.ones((1, sum(lens)), np.float32)
    offsets = _offsets(letters, lens)
    for ltr, pos_list in fixed.items():
        off = _check_chain(ltr, offsets, "fixed_positions")
        for pos in pos_list:
            out[0, off + int(pos) - 1] = 0.0
    return out


def omit_aa_mask_from_dict(
    omit: dict[str, list], letters: list[str], lens: list[int]
) -> np.ndarray:
    """--omit_AA_jsonl: [1,L,21] one-hot of letters forbidden at each
    position (utils :292-299). Entries are [[positions...], "LETTERS"]."""
    out = np.zeros((1, sum(lens), VOCAB), np.float32)
    offsets = _offsets(letters, lens)
    for ltr, items in omit.items():
        off = _check_chain(ltr, offsets, "omit_AA")
        for positions, aas in items:
            for pos in positions:
                for a in aas:
                    out[0, off + int(pos) - 1, MPNN_ALPHABET.index(a)] = 1.0
    return out


def bias_by_res_from_dict(
    bias: dict[str, list], letters: list[str], lens: list[int]
) -> np.ndarray:
    """--bias_by_res_jsonl: [1,L,21] additive logit bias
    (utils :311-315). Per-chain arrays must be [chain_len, 21]."""
    out = np.zeros((1, sum(lens), VOCAB), np.float32)
    offsets = _offsets(letters, lens)
    by_len = dict(zip(letters, lens))
    for ltr, rows in bias.items():
        off = _check_chain(ltr, offsets, "bias_by_res")
        arr = np.asarray(rows, np.float32)
        if arr.shape != (by_len[ltr], VOCAB):
            raise ToolUnavailable(
                f"bias_by_res chain {ltr!r}: shape {arr.shape} != "
                f"({by_len[ltr]}, {VOCAB})"
            )
        out[0, off : off + by_len[ltr]] = arr
    return out


def pssm_tensors_from_dict(
    pssm: dict[str, dict], letters: list[str], lens: list[int],
    threshold: float = 0.0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """--pssm_jsonl -> (coef [1,L], bias [1,L,21], log_odds_mask [1,L,21]).

    Defaults for chains without an entry match tied_featurize (coef 0,
    bias 0, log-odds +10000, utils :300-310); the mask is
    ``log_odds > threshold`` exactly as protein_mpnn_run.py:220.
    """
    length = sum(lens)
    coef = np.zeros((1, length), np.float32)
    bias = np.zeros((1, length, VOCAB), np.float32)
    log_odds = np.full((1, length, VOCAB), PSSM_LOG_ODDS_DEFAULT, np.float32)
    offsets = _offsets(letters, lens)
    by_len = dict(zip(letters, lens))
    for ltr, entry in pssm.items():
        if not entry:
            continue
        off = _check_chain(ltr, offsets, "pssm")
        ln = by_len[ltr]
        c = np.asarray(entry["pssm_coef"], np.float32)
        b = np.asarray(entry["pssm_bias"], np.float32)
        lo = np.asarray(entry["pssm_log_odds"], np.float32)
        if c.shape != (ln,) or b.shape != (ln, VOCAB) or lo.shape != (ln, VOCAB):
            raise ToolUnavailable(
                f"pssm chain {ltr!r}: shapes {c.shape}/{b.shape}/{lo.shape} "
                f"inconsistent with chain length {ln}"
            )
        coef[0, off : off + ln] = c
        bias[0, off : off + ln] = b
        log_odds[0, off : off + ln] = lo
    mask = (log_odds > float(threshold)).astype(np.float32)
    return coef, bias, mask


def tied_positions_from_list(
    tied: list[dict], letters: list[str], lens: list[int]
) -> tuple[tuple[tuple[int, ...], ...], np.ndarray]:
    """--tied_positions_jsonl -> (static tie groups in concatenated
    0-based coordinates, tied_beta [L]).

    Each list item is one group: {chain: [1-based positions]} ties those
    positions with weight 1; {chain: [[positions], [betas]]} is the
    weighted form (make_pos_neg_tied_positions_dict.py). Mirrors
    tied_featurize :320-337 including tied_beta scatter.
    """
    offsets = _offsets(letters, lens)
    tied_beta = np.ones((sum(lens),), np.float32)
    groups = []
    for item in tied:
        one: list[int] = []
        for ltr, v in item.items():
            off = _check_chain(ltr, offsets, "tied_positions")
            if v and isinstance(v[0], list):
                positions, betas = v[0], v[1]
                for pos, beta in zip(positions, betas):
                    idx = off + int(pos) - 1
                    one.append(idx)
                    tied_beta[idx] = float(beta)
            else:
                for pos in v:
                    one.append(off + int(pos) - 1)
        if one:
            groups.append(tuple(one))
    return tuple(groups), tied_beta
