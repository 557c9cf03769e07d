"""Feature assembly (numpy): parsed structures -> the raw per-structure
features the preprocessing pickles hold -> model features, inpainting
redaction masks, padding to a length bucket and length batching. The same
functions, and the same random draws, as the JAX package's
``data/features.py``.
"""
from __future__ import annotations

import numpy as np

from framedipt_tpu_torch.data import constants as rc
from framedipt_tpu_torch.data import transforms
from framedipt_tpu_torch.data.mmcif import MmcifChain, MmcifObject
from framedipt_tpu_torch.data.protein import chain_id_to_int

# Residue-index gap between chains when a complex is re-indexed.
CHAIN_RESIDUE_GAP = 200


def chain_to_features(
    chain: MmcifChain, center: bool = True, chain_int: int | None = None
) -> dict[str, np.ndarray]:
    """Per-chain raw features, optionally centred on the CA centroid.
    ``chain_int`` replaces the chain id (chains re-lettered in processing
    order)."""
    bb_mask = chain.atom_mask[:, rc.CA_IDX]
    positions = chain.atom_positions.copy()
    if center:
        bb_pos = positions[:, rc.CA_IDX]
        center_xyz = np.sum(bb_pos * bb_mask[:, None], axis=0) / (np.sum(bb_mask) + 1e-10)
        positions = (positions - center_xyz[None, None, :]) * chain.atom_mask[..., None]
    return {
        "aatype": chain.aatype,
        "atom_positions": positions,
        "atom_mask": chain.atom_mask,
        "residue_index": chain.residue_index,
        "b_factors": chain.b_factors,
        "bb_mask": bb_mask,
        "chain_index": np.full(
            len(chain.aatype),
            chain_id_to_int(chain.chain_id) if chain_int is None else chain_int,
            np.int64,
        ),
    }


def structure_to_features(
    mmcif_obj: MmcifObject, chain_ids: list[str] | None = None, center: bool = True,
) -> dict[str, np.ndarray]:
    """The selected chains (all, sorted by id, by default) concatenated into
    one feature dict, chain i re-lettered i, centred on the complex's CA
    centroid, with each chain's modeled region (leading and trailing unknown
    or CA-less residues trimmed) as global [min, max] indices."""
    selected = chain_ids or sorted(mmcif_obj.chains)
    feats_list = [
        chain_to_features(mmcif_obj.chains[cid], center=False, chain_int=i)
        for i, cid in enumerate(selected)
    ]
    feats = concat_np_features(feats_list, add_batch_dim=False)
    if center:
        bb_pos = feats["atom_positions"][:, rc.CA_IDX]
        bb_mask = feats["bb_mask"]
        center_xyz = np.sum(bb_pos * bb_mask[:, None], axis=0) / (np.sum(bb_mask) + 1e-10)
        feats["atom_positions"] = (
            feats["atom_positions"] - center_xyz[None, None, :]
        ) * feats["atom_mask"][..., None]
    min_idxs, max_idxs = [], []
    offset = 0
    for f in feats_list:
        n = len(f["aatype"])
        modeled = np.where((f["aatype"] != rc.unk_restype_index) & (f["bb_mask"] > 0))[0]
        if len(modeled) == 0:
            modeled = np.arange(n)
        min_idxs.append(offset + int(modeled.min()))
        max_idxs.append(offset + int(modeled.max()))
        offset += n
    feats["min_modeled_idxs"] = np.asarray(min_idxs, np.int64)
    feats["max_modeled_idxs"] = np.asarray(max_idxs, np.int64)
    return feats


def build_model_features(
    processed_feats: dict[str, np.ndarray],
    extract_single_chain: bool = False,
    rng: np.random.Generator | None = None,
    chain_max_len: int | None = None,
) -> dict[str, np.ndarray]:
    """Model features of one preprocessed structure: the modeled region of
    each chain (or of one chain drawn from ``rng``, with
    ``extract_single_chain``), cropped at a random start to
    ``chain_max_len``, then frames, torsions, atom14 and a per-chain 0-based
    residue index with :data:`CHAIN_RESIDUE_GAP` between chains. ``rng`` is
    drawn as the JAX package draws it: the chain, then each crop start.

    Only leading and trailing unknown residues are trimmed: an interior one
    (aatype 20) reaches ``atom37_to_torsion_angles``, which raises
    IndexError for it, as the JAX package's does (ROADMAP queue 3)."""
    chain_index = processed_feats["chain_index"]
    indexes = np.unique(chain_index, return_index=True)[1]
    unique_chains = [chain_index[i] for i in sorted(indexes)]
    min_idxs = processed_feats["min_modeled_idxs"]
    max_idxs = processed_feats["max_modeled_idxs"]
    core = {k: v for k, v in processed_feats.items()
            if k not in ("min_modeled_idxs", "max_modeled_idxs")}

    def slice_chain(lo, hi):
        # Global (concatenation-order) indices: a contiguous slice is the
        # chain's modeled region.
        idx = np.arange(lo, hi + 1)
        if chain_max_len is not None and len(idx) > chain_max_len:
            if rng is not None:
                start = int(rng.integers(len(idx) - chain_max_len + 1))
            else:
                start = np.random.randint(len(idx) - chain_max_len + 1)
            idx = idx[start : start + chain_max_len]
        return {k: v[idx] for k, v in core.items()}

    if extract_single_chain:
        pick = (int(rng.integers(len(unique_chains))) if rng is not None
                else np.random.randint(len(unique_chains)))
        parts = [slice_chain(min_idxs[pick], max_idxs[pick])]
    else:
        parts = [slice_chain(lo, hi) for lo, hi in zip(min_idxs, max_idxs)]
    feats = concat_np_features(parts, add_batch_dim=False)

    aatype = feats["aatype"]
    atom37 = feats["atom_positions"]
    mask37 = feats["atom_mask"]
    frames_out = transforms.atom37_to_frames(aatype, atom37, mask37)
    torsions = transforms.atom37_to_torsion_angles(aatype, atom37, mask37)
    atom14 = transforms.make_atom14_positions(aatype, atom37, mask37)

    chain_idx = feats["chain_index"]
    new_res_idx = np.zeros_like(feats["residue_index"])
    prev_len = 0
    for cid in np.unique(chain_idx):
        m = chain_idx == cid
        n = int(m.sum())
        new_res_idx[m] = prev_len + np.arange(n)
        prev_len += n + CHAIN_RESIDUE_GAP

    return {
        "aatype": aatype.astype(np.int64),
        "seq_idx": new_res_idx.astype(np.int64),
        "chain_idx": chain_idx.astype(np.int64),
        "residx_atom14_to_atom37": atom14["residx_atom14_to_atom37"],
        "residue_index": feats["residue_index"].astype(np.int64),
        "res_mask": feats["bb_mask"].astype(np.float32),
        "atom37_pos": atom37.astype(np.float32),
        "atom37_mask": mask37.astype(np.float32),
        "atom14_pos": atom14["atom14_gt_positions"],
        "rigidgroups_0": frames_out["rigidgroups_gt_frames"],
        "torsion_angles_sin_cos": torsions["torsion_angles_sin_cos"],
        "rigids_0": transforms.backbone_rigid_tensor7(aatype, atom37, mask37),
    }


def create_single_redacted_region(
    res_mask: np.ndarray,
    rng: np.random.Generator,
    redact_min_len: int | None,
    redact_max_len: int | None,
) -> np.ndarray:
    """One random contiguous diffused region (mask 1) inside the modeled
    span, its length clamped to the span."""
    if redact_min_len is None or redact_max_len is None:
        return np.ones_like(res_mask)
    modeled = np.where(res_mask != 0)[0]
    min_idx, max_idx = modeled[0], modeled[-1]
    redact_max = min(redact_max_len, max_idx - min_idx + 1)
    redact_min = min(redact_min_len, redact_max)
    length = rng.integers(low=redact_min, high=redact_max, endpoint=True)
    start = rng.integers(low=min_idx, high=max_idx + 1 - length, endpoint=True)
    mask = np.zeros_like(res_mask)
    mask[start : start + length] = 1
    return mask


def create_redacted_regions(
    chain_idx: np.ndarray,
    res_mask: np.ndarray,
    rng: np.random.Generator,
    redact_min_len: int,
    redact_max_len: int,
) -> np.ndarray:
    """One redacted region per chain, concatenated in chain order."""
    return np.concatenate([
        create_single_redacted_region(res_mask[chain_idx == cid], rng, redact_min_len,
                                      redact_max_len)
        for cid in np.unique(chain_idx)
    ])


def concat_np_features(
    dicts: list[dict[str, np.ndarray]], add_batch_dim: bool
) -> dict[str, np.ndarray]:
    out: dict[str, list] = {}
    for d in dicts:
        for k, v in d.items():
            out.setdefault(k, []).append(v[None] if add_batch_dim else v)
    return {k: np.concatenate(v, axis=0) for k, v in out.items()}


def pad_to(x: np.ndarray, max_len: int, pad_idx: int = 0) -> np.ndarray:
    """Zero-pad axis ``pad_idx`` to max_len."""
    seq_len = x.shape[pad_idx]
    if seq_len > max_len:
        raise ValueError(f"length {seq_len} > pad target {max_len}")
    widths = [(0, 0)] * x.ndim
    widths[pad_idx] = (0, max_len - seq_len)
    return np.pad(x, widths)


_UNPADDED_KEYS = ("t", "rot_score_scaling", "trans_score_scaling")


def pad_feats(
    feats: dict[str, np.ndarray], max_len: int
) -> dict[str, np.ndarray]:
    """Pad every per-residue feature to max_len."""
    return {
        k: pad_to(v, max_len) if k not in _UNPADDED_KEYS and np.ndim(v) >= 1 else v
        for k, v in feats.items()
    }


def length_bucket(
    n: int, buckets: tuple[int, ...] = (64, 128, 192, 256, 320, 384, 448, 512)
) -> int:
    """Smallest bucket >= n; lengths beyond the table round up to a multiple
    of 128. Requests of similar length then share tensor shapes."""
    for b in buckets:
        if n <= b:
            return b
    return ((n + 127) // 128) * 128


def length_batching(
    lengths: np.ndarray, max_squared_res: int = 1_000_000
) -> list[list[int]]:
    """Indices sorted by length, cut into batches of max_squared_res //
    (the batch's first length)^2 (at least 1)."""
    order = np.argsort(lengths)
    batches: list[list[int]] = []
    i = 0
    while i < len(order):
        max_len = lengths[order[i]]
        cap = max(1, int(max_squared_res // max(1, int(max_len)) ** 2))
        batches.append([int(j) for j in order[i : i + cap]])
        i += cap
    return batches
