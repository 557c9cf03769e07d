"""IGSO(3) density: the truncated power series, its score, and the float64
lookup-table builder.

- ``expansion`` / ``score_ratio`` run the L=1000 truncated series on the
  device (the reference's default score path).
- ``*_np`` build the pdf/cdf/score-norm tables once in float64 numpy. The
  cache file name is a hash of the two grids, so the repository's prebuilt
  ``.igso3_cache/igso3_<hash>.npz`` serves the default 1000 x 1000 grid.
"""
from __future__ import annotations

import hashlib
import os
import pathlib

import numpy as np
import torch

TRUNCATION_LEVEL = 1000


def expansion(
    omega: torch.Tensor, eps: torch.Tensor, truncation: int = TRUNCATION_LEVEL
) -> torch.Tensor:
    """Truncated IGSO(3) characteristic series f(omega; eps); omega and eps
    broadcast over leading dims, the series dimension is reduced."""
    levels = torch.arange(truncation, dtype=omega.dtype, device=omega.device)
    o = omega[..., None]
    e = eps[..., None]
    p = (
        (2.0 * levels + 1.0)
        * torch.exp(-levels * (levels + 1.0) * e**2 / 2.0)
        * torch.sin(o * (levels + 0.5))
        / torch.sin(o / 2.0)
    )
    return torch.sum(p, dim=-1)


def score_ratio(
    exp_vals: torch.Tensor,
    omega: torch.Tensor,
    eps: torch.Tensor,
    truncation: int = TRUNCATION_LEVEL,
) -> torch.Tensor:
    """d/d omega log f(omega; eps) by the quotient rule, with the reference's
    +1e-4 regularizer in the denominator."""
    levels = torch.arange(truncation, dtype=omega.dtype, device=omega.device)
    o = omega[..., None]
    e = eps[..., None]
    hi = torch.sin(o * (levels + 0.5))
    dhi = (levels + 0.5) * torch.cos(o * (levels + 0.5))
    lo = torch.sin(o / 2.0)
    dlo = 0.5 * torch.cos(o / 2.0)
    dsigma = (
        (2.0 * levels + 1.0)
        * torch.exp(-levels * (levels + 1.0) * e**2 / 2.0)
        * (lo * dhi - hi * dlo)
        / lo**2
    )
    return torch.sum(dsigma, dim=-1) / (exp_vals + 1e-4)


def expansion_np(
    omega: np.ndarray, eps: float, truncation: int = TRUNCATION_LEVEL
) -> np.ndarray:
    levels = np.arange(truncation, dtype=np.float64)
    o = np.asarray(omega, np.float64)[..., None]
    p = (
        (2.0 * levels + 1.0)
        * np.exp(-levels * (levels + 1.0) * eps**2 / 2.0)
        * np.sin(o * (levels + 0.5))
        / np.sin(o / 2.0)
    )
    return p.sum(axis=-1)


def score_np(
    exp_vals: np.ndarray,
    omega: np.ndarray,
    eps: float,
    truncation: int = TRUNCATION_LEVEL,
) -> np.ndarray:
    levels = np.arange(truncation, dtype=np.float64)
    o = np.asarray(omega, np.float64)[..., None]
    hi = np.sin(o * (levels + 0.5))
    dhi = (levels + 0.5) * np.cos(o * (levels + 0.5))
    lo = np.sin(o / 2.0)
    dlo = 0.5 * np.cos(o / 2.0)
    dsigma = (
        (2.0 * levels + 1.0)
        * np.exp(-levels * (levels + 1.0) * eps**2 / 2.0)
        * (lo * dhi - hi * dlo)
        / lo**2
    ).sum(axis=-1)
    return dsigma / (exp_vals + 1e-4)


def marginal_density_np(exp_vals: np.ndarray, omega: np.ndarray) -> np.ndarray:
    """Marginal density of the rotation angle over [0, pi]."""
    return exp_vals * (1.0 - np.cos(omega)) / np.pi


_TABLE_KEYS = ("pdf", "cdf", "score_norms", "score_scaling")


def build_lookup_tables(
    discrete_sigma: np.ndarray,
    discrete_omega: np.ndarray,
    cache_dir: str | None = ".cache/",
) -> dict[str, np.ndarray]:
    """Build (or load from cache) the IGSO3 pdf/cdf/score-norm tables,
    float64 [num_sigma, num_omega] (score_scaling [num_sigma])."""
    num_omega = len(discrete_omega)
    cache_path = None
    if cache_dir is not None:
        h = hashlib.sha256()
        h.update(np.ascontiguousarray(discrete_sigma).tobytes())
        h.update(np.ascontiguousarray(discrete_omega).tobytes())
        fname = f"igso3_{h.hexdigest()[:16]}.npz"
        cache_path = pathlib.Path(cache_dir) / fname
        prebuilt = (
            pathlib.Path(__file__).resolve().parent.parent.parent
            / ".igso3_cache"
            / fname
        )
        for candidate in (cache_path, prebuilt):
            if candidate.exists():
                with np.load(candidate) as z:
                    return {k: z[k] for k in _TABLE_KEYS}

    exp_vals = np.stack([expansion_np(discrete_omega, s) for s in discrete_sigma])
    pdf = marginal_density_np(exp_vals, discrete_omega)
    cdf = pdf.cumsum(axis=-1) / num_omega * np.pi
    score_norms = np.stack(
        [score_np(exp_vals[i], discrete_omega, s) for i, s in enumerate(discrete_sigma)]
    )
    # E[||score||^2]^0.5 / sqrt(3) per sigma.
    score_scaling = np.sqrt(
        np.abs((score_norms**2 * pdf).sum(-1) / pdf.sum(-1))
    ) / np.sqrt(3.0)

    tables = {
        "pdf": pdf,
        "cdf": cdf,
        "score_norms": score_norms,
        "score_scaling": score_scaling,
    }
    if cache_path is not None:
        os.makedirs(cache_path.parent, exist_ok=True)
        tmp = cache_path.with_suffix(f".tmp{os.getpid()}.npz")
        np.savez_compressed(tmp, **tables)
        os.replace(tmp, cache_path)  # atomic across concurrent builders
    return tables
