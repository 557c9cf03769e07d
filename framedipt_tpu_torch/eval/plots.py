"""Plot helpers of the evaluation CLIs (the port's copy of the JAX package's
``eval/plots.py``), over numpy arrays and lists of row dicts.

At import time only numpy: the pure helpers (``middle_average``,
``_median_mad``, ``XTICKS``, ``median_sample_rows``) run on every
evaluation. matplotlib and seaborn are imported inside the plotting
functions; where they are missing, those log a warning and draw nothing.
"""
from __future__ import annotations

import pathlib

import numpy as np

from framedipt_tpu_torch.eval import table
from framedipt_tpu_torch.tools.log import get_logger

logger = get_logger()


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import seaborn as sns

    return plt, sns


def _unavailable() -> None:
    logger.warning("matplotlib unavailable; skipping plot")


def box_swarm_plot(
    rows: list[dict],
    x: str,
    y: str,
    out_path: pathlib.Path,
    title: str | None = None,
) -> pathlib.Path | None:
    """Boxes with the points swarmed over them, of column ``y`` of ``rows``
    grouped by column ``x``."""
    try:
        plt, sns = _mpl()
    except ImportError:
        _unavailable()
        return None
    xs = [r.get(x) for r in rows]
    ys = table.column(rows, y)
    fig, ax = plt.subplots(figsize=(max(6, 0.5 * len(set(xs))), 4))
    sns.boxplot(x=xs, y=ys, ax=ax, color="lightblue")
    sns.swarmplot(x=xs, y=ys, ax=ax, color="black", size=3)
    ax.set_xlabel(x)
    ax.set_ylabel(y)
    ax.tick_params(axis="x", rotation=90)
    if title:
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def pearson_scatter(
    xs: np.ndarray,
    ys: np.ndarray,
    out_path: pathlib.Path,
    xlabel: str = "x",
    ylabel: str = "y",
) -> tuple[pathlib.Path | None, float]:
    """Scatter with a regression line and the Pearson r over the pairs
    where neither value is NaN; returns (path or None, r)."""
    xs, ys = np.asarray(xs, np.float64), np.asarray(ys, np.float64)
    keep = ~(np.isnan(xs) | np.isnan(ys))
    xs, ys = xs[keep], ys[keep]
    if len(xs) < 2:
        return None, float("nan")
    r = float(np.corrcoef(xs, ys)[0, 1])
    try:
        plt, sns = _mpl()
    except ImportError:
        return None, r
    fig, ax = plt.subplots(figsize=(5, 5))
    sns.regplot(x=xs, y=ys, ax=ax, scatter_kws={"s": 12})
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.set_title(f"pearson r = {r:.3f} (n={len(xs)})")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path, r


def middle_average(values: np.ndarray, keep_each_side: int = 4) -> np.ndarray:
    """Collapse variable-length regions to fixed positions: first/last
    ``keep_each_side`` residues kept, middle averaged into one slot (the
    XTICKS 1-4, 5 (= middle), -4..-1 scheme)."""
    k = keep_each_side
    if len(values) <= 2 * k:
        return np.asarray(values)
    middle = np.mean(values[k:-k])
    return np.concatenate([values[:k], [middle], values[-k:]])


def per_position_line_plot(
    values_by_name: dict[str, np.ndarray],
    out_path: pathlib.Path,
    ylabel: str = "RMSD (A)",
) -> pathlib.Path | None:
    """One line a name of a metric by position in the diffused region."""
    try:
        plt, _ = _mpl()
    except ImportError:
        _unavailable()
        return None
    fig, ax = plt.subplots(figsize=(7, 4))
    for name, vals in values_by_name.items():
        ax.plot(np.arange(1, len(vals) + 1), vals, marker="o", label=name)
    ax.set_xlabel("position in diffused region")
    ax.set_ylabel(ylabel)
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


# xticks of the per-residue grouped plots: left 4, averaged middle ("5"),
# right 4.
XTICKS = [str(idx) for idx in (1, 2, 3, 4, 5, -4, -3, -2, -1)]


def _median_mad(metric_groups: list[np.ndarray]) -> tuple[float, float]:
    flat = np.concatenate([np.asarray(g, dtype=float) for g in metric_groups])
    flat = flat[np.isfinite(flat)]
    if not len(flat):
        return float("nan"), float("nan")
    med = float(np.median(flat))
    mad = float(np.median(np.abs(flat - med)))
    return med, mad


def grouped_alpha_beta_plot(
    metrics_alpha: list[np.ndarray],
    metrics_beta: list[np.ndarray],
    eval_output_path: pathlib.Path,
    legend: str,
    xticks: list[str],
) -> pathlib.Path | None:
    """Side-by-side alpha/beta boxplots. The title carries each chain's
    median and median absolute deviation; the file is
    ``{legend}_median_boxplot.png``."""
    xs_len = max(len(metrics_alpha), len(metrics_beta))
    if len(xticks) != xs_len:
        raise ValueError(
            f"xticks length must match chain metric count, "
            f"got {len(xticks)} != {xs_len}."
        )
    try:
        plt, _ = _mpl()
    except ImportError:
        _unavailable()
        return None

    fig, ax = plt.subplots(figsize=(8, 6))
    xs = np.arange(xs_len) + 1
    box_a = ax.boxplot(
        metrics_alpha, showfliers=False, patch_artist=True, widths=0.3,
        positions=xs[: len(metrics_alpha)] - 0.2,
    )
    box_b = ax.boxplot(
        metrics_beta, showfliers=False, patch_artist=True, widths=0.3,
        positions=xs[: len(metrics_beta)] + 0.2,
    )
    for patch in box_a["boxes"]:
        patch.set_facecolor("royalblue")
    for patch in box_b["boxes"]:
        patch.set_facecolor("orange")
    ax.legend([box_a["boxes"][0], box_b["boxes"][0]], ["alpha", "beta"])
    ax.set_xticks(xs)
    ax.set_xticklabels(xticks)
    med_a, mad_a = _median_mad(metrics_alpha)
    med_b, mad_b = _median_mad(metrics_beta)
    ax.set_title(
        f"{legend}\n"
        f"alpha Median {med_a:.2f}$\\pm${mad_a:.2f}\n"
        f"beta Median {med_b:.2f}$\\pm${mad_b:.2f}",
        fontsize=14,
    )
    fig.tight_layout()
    out = (
        pathlib.Path(eval_output_path)
        / f"{legend.lower().replace(' ', '_')}_median_boxplot.png"
    )
    fig.savefig(out, dpi=120)
    plt.close(fig)
    return out


def median_sample_rows(rows: list[dict], metric: str = "bb_rmsd") -> list[dict]:
    """One representative row per pdb_name, in sorted pdb_name order: the
    sample whose ``metric`` is closest to that pdb's median over its
    non-NaN values (ties -> first). Closest-to-median keeps one row per pdb
    for an even sample count too, where the median is the mean of the two
    middle values and matches no row."""
    by_pdb: dict = {}
    for i, row in enumerate(rows):
        by_pdb.setdefault(row["pdb_name"], []).append(i)
    values = table.column(rows, metric)
    out = []
    for pdb in sorted(by_pdb):
        idx = np.asarray(by_pdb[pdb])
        group = values[idx]
        out.append(rows[int(idx[np.nanargmin(np.abs(group - np.nanmedian(group)))])])
    return out


def best_sample_rows(rows: list[dict], metric: str = "bb_rmsd") -> list[dict]:
    """One row per pdb_name, in sorted pdb_name order: the sample with the
    lowest non-NaN ``metric`` (ties -> first)."""
    by_pdb: dict = {}
    for i, row in enumerate(rows):
        by_pdb.setdefault(row["pdb_name"], []).append(i)
    values = table.column(rows, metric)
    return [rows[int(np.asarray(idx)[np.nanargmin(values[idx])])]
            for pdb, idx in sorted(by_pdb.items())]


def two_models_scatter_plot(
    rows_metrics: list[dict],
    rows_esmfold: list[dict],
    eval_output_path: pathlib.Path,
    choice: str = "median",
) -> pathlib.Path | None:
    """Per-chain backbone RMSD of this model (the median or best sample of
    each pdb_name) against ESMFold's, joined on pdb_name, with the y = x
    diagonal; ``bb_rmsd_framedipt_esmfold_scatter.png``."""
    if choice == "median":
        chosen = median_sample_rows(rows_metrics)
    elif choice == "best":
        chosen = best_sample_rows(rows_metrics)
    else:
        raise ValueError(f"Choice need to be median or best, got {choice}.")
    pairs = [(row, other) for row in chosen for other in rows_esmfold
             if other["pdb_name"] == row["pdb_name"]]
    try:
        plt, _ = _mpl()
    except ImportError:
        _unavailable()
        return None
    xs = np.linspace(0, 10, 100)
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.plot(xs, xs, color="black", linestyle="dashed")
    for chain in ("alpha", "beta"):
        key = f"bb_rmsd_{chain}"
        ax.scatter(table.column([o for _, o in pairs], key),
                   table.column([r for r, _ in pairs], key), label=chain)
    ax.set_xlim([0, 10])
    ax.set_xlabel("ESMFold backbone RMSD", fontsize=14)
    ax.set_ylabel("FrameDiPT backbone RMSD", fontsize=14)
    ax.set_title("Backbone RMSD", fontsize=16)
    ax.legend(fontsize=12)
    fig.tight_layout()
    out = pathlib.Path(eval_output_path) / "bb_rmsd_framedipt_esmfold_scatter.png"
    fig.savefig(out, dpi=120)
    plt.close(fig)
    return out


def length_colored_scatter(
    xs: np.ndarray,
    ys: np.ndarray,
    lengths: np.ndarray,
    xlabel: str,
    ylabel: str,
    out_path: pathlib.Path,
) -> pathlib.Path | None:
    """Scatter coloured blue to red by sequence length, with a colour bar
    (the de novo novelty and helix/sheet composition plots)."""
    try:
        plt, _ = _mpl()
    except ImportError:
        _unavailable()
        return None
    import matplotlib.colors as mcolor

    lengths = np.asarray(lengths, dtype=float)
    lo, hi = float(np.min(lengths)), float(np.max(lengths))
    cmap = mcolor.LinearSegmentedColormap.from_list("redblue", ["b", "r"])
    fig, ax = plt.subplots(figsize=(8, 6))
    colors = cmap((lengths - lo) / ((hi - lo) or 1.0))
    ax.scatter(np.asarray(xs, float), np.asarray(ys, float), c=colors, alpha=0.8)
    fig.colorbar(plt.cm.ScalarMappable(norm=mcolor.Normalize(vmin=lo, vmax=hi), cmap=cmap), ax=ax)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return pathlib.Path(out_path)
