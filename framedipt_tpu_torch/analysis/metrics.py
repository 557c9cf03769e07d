"""Structural plausibility metrics of sampled backbones (numpy)."""
from __future__ import annotations

import numpy as np

from framedipt_tpu_torch.data import constants as rc


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
