"""Padding of per-residue features to a length bucket (numpy)."""
from __future__ import annotations

import numpy as np


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
