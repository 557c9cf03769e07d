"""Most-likely-sample selection over N generated samples (the port's copy
of the JAX package's ``eval/selection.py``).

Given the diffusion-region backbone coordinates of all samples, pick or
synthesize representatives: the mean, the geometric median (Weiszfeld), the
Gaussian-KDE mode with sigma=30, and the real samples closest to the mean
and the median. Virtual (mean/median) structures are synthesized by
replacing the region coordinates in a template sample.
"""
from __future__ import annotations

import copy

import numpy as np

from framedipt_tpu_torch.data.protein import Protein

SAMPLE_SELECTION_STRATEGIES = (
    "mean",
    "median",
    "mode",
    "mean_closest",
    "median_closest",
)

KDE_SIGMA = 30.0


def geometric_median(
    x: np.ndarray, max_iter: int = 200, tol: float = 1e-6
) -> np.ndarray:
    """Weiszfeld's algorithm over flattened sample vectors [S, D]."""
    y = x.mean(axis=0)
    for _ in range(max_iter):
        d = np.linalg.norm(x - y, axis=-1)
        d = np.maximum(d, 1e-12)
        w = 1.0 / d
        y_new = (x * w[:, None]).sum(axis=0) / w.sum()
        if np.linalg.norm(y_new - y) < tol:
            return y_new
        y = y_new
    return y


def kde_mode_index(x: np.ndarray, sigma: float = KDE_SIGMA) -> int:
    """Index of the sample with maximum Gaussian-KDE density (sigma=30)."""
    d2 = np.sum((x[:, None, :] - x[None, :, :]) ** 2, axis=-1)
    dens = np.exp(-d2 / (2.0 * sigma**2)).sum(axis=-1)
    return int(np.argmax(dens))


def closest_index(x: np.ndarray, target: np.ndarray) -> int:
    return int(np.argmin(np.linalg.norm(x - target[None], axis=-1)))


def select_samples(
    region_coords: np.ndarray,
    strategies: tuple[str, ...] = SAMPLE_SELECTION_STRATEGIES,
) -> dict[str, dict]:
    """region_coords: [S, L, A, 3] diffusion-region backbone coords of S
    samples. Returns {strategy: {'coords': [L, A, 3], 'index': int | None}}
    — index is None for virtual (synthesized) structures."""
    s = region_coords.shape[0]
    flat = region_coords.reshape(s, -1)
    out: dict[str, dict] = {}
    mean_vec = flat.mean(axis=0)
    median_vec = geometric_median(flat)
    for strategy in strategies:
        if strategy == "mean":
            coords, idx = mean_vec, None
        elif strategy == "median":
            coords, idx = median_vec, None
        elif strategy == "mode":
            idx = kde_mode_index(flat)
            coords = flat[idx]
        elif strategy == "mean_closest":
            idx = closest_index(flat, mean_vec)
            coords = flat[idx]
        elif strategy == "median_closest":
            idx = closest_index(flat, median_vec)
            coords = flat[idx]
        else:
            raise ValueError(f"unknown strategy {strategy}")
        out[strategy] = {
            "coords": coords.reshape(region_coords.shape[1:]),
            "index": idx,
        }
    return out


def synthesize_protein(
    template: Protein,
    residue_sel: np.ndarray,
    atom_idx: tuple[int, ...],
    region_coords: np.ndarray,
) -> Protein:
    """Replace the selected residues' backbone coords in a template sample
    (virtual mean/median structures)."""
    prot = copy.deepcopy(template)
    pos = prot.atom_positions.copy()
    rows = np.where(residue_sel)[0]
    for k, row in enumerate(rows):
        for j, ai in enumerate(atom_idx):
            pos[row, ai] = region_coords[k, j]
    prot.atom_positions = pos
    return prot
