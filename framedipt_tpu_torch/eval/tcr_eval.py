"""TCR inpainting evaluation CLI over the batch inpainting CLI's output tree.

The port's copy of the JAX package's ``eval/tcr_eval.py``, on the host with
numpy only: walk an inference output directory (per-structure
``{pdb}_length_{L}`` dirs), parse ``diffusion_info.csv``, compute
backbone/full-atom/per-residue RMSDs and dihedral errors between each
sample and the ground truth over the diffused regions, aggregate per
sample-selection strategy (mean/median/mode/closest pickers), and write
``eval_metrics_all.csv``, ``eval_metrics_residue.csv`` and one
``eval_metrics_{strategy}.csv`` per strategy, the CSV text pandas writes
for the same rows (``eval.table``). Box/swarm plots and the RSA correlation
plot when matplotlib and seaborn import; otherwise a warning and no plot.

Usage:
    python -m framedipt_tpu_torch.eval.tcr_eval --prediction_dir=... \
        [--output_dir=...] [--no_plots] [--sasa] [--cdr_loop_index=1] [--legacy]
"""
from __future__ import annotations

import argparse
import csv
import pathlib

import numpy as np

from framedipt_tpu_torch.data.protein import Protein, from_pdb_string
from framedipt_tpu_torch.eval import metrics as eval_metrics
from framedipt_tpu_torch.eval import plots
from framedipt_tpu_torch.eval import selection as sel_lib
from framedipt_tpu_torch.eval import table
from framedipt_tpu_torch.eval.metrics import BACKBONE_IDX
from framedipt_tpu_torch.tools.log import get_logger

logger = get_logger()


def parse_diffusion_info(path: pathlib.Path, cdr_loop_index: int = 0) -> dict:
    """Parse diffusion_info.csv (tab-separated, a header and one row),
    selecting one CDR loop pair for multi-loop runs: with e.g. 3 loops per
    chain the columns hold [a1,a2,a3,b1,b2,b3]; pick loop ``cdr_loop_index``
    of each chain."""
    with open(path, newline="", encoding="utf-8") as f:
        row = next(csv.DictReader(f, delimiter="\t"))
    chains = str(row["chain"]).split(",")
    starts = [int(x) for x in str(row["start"]).split(",")]
    ends = [int(x) for x in str(row["end"]).split(",")]
    if len(chains) > 2:
        num_loops = len(chains) // 2
        sel = [cdr_loop_index, num_loops + cdr_loop_index]
        chains = [chains[i] for i in sel]
        starts = [starts[i] for i in sel]
        ends = [ends[i] for i in sel]
    return {
        "pdb_name": row["pdb_name"],
        "seq": row["seq"],
        "chains": chains,
        "regions": list(zip(starts, ends)),
    }


def _sample_pdbs(length_dir: pathlib.Path) -> list[pathlib.Path]:
    """Per-sample prediction paths, preferring the full-atom reconstruction
    ``sample_{i}_1_all_atom.pdb`` (cg2all's) where present."""
    indexed = []
    for sample_dir in length_dir.glob("sample_*"):
        try:
            idx = int(sample_dir.stem.split("_")[-1])
        except ValueError:
            continue
        all_atom = sample_dir / f"sample_{idx}_1_all_atom.pdb"
        backbone = sample_dir / f"sample_{idx}_1.pdb"
        if all_atom.exists():
            indexed.append((idx, all_atom))
        elif backbone.exists():
            indexed.append((idx, backbone))
    # Numeric order: lexicographic puts sample_10 before sample_2, which
    # would mislabel per-sample rows in >=10-sample runs.
    return [p for _, p in sorted(indexed)]


def sample_index(path: pathlib.Path) -> int:
    """The sample's own index, parsed from its ``sample_<k>`` directory.
    Row attribution must use this, not the enumerate position: a partially
    resumed run missing e.g. sample_0 would otherwise shift every later
    sample's metrics onto the wrong index."""
    return int(path.parent.stem.split("_")[-1])


def traverse_prediction_dir(
    prediction_dir: pathlib.Path,
    cdr_loop_index: int = 0,
    legacy_file_structure: bool = False,
):
    """Yield (length_dir, gt_pdb_path, info, [sample pdb paths]).

    ``legacy_file_structure`` reads the ground truth and diffusion_info.csv
    from ``sample_0/`` instead of the length-dir root (the older output
    layout).
    """
    for length_dir in sorted(prediction_dir.glob("*_length_*")):
        base = length_dir / "sample_0" if legacy_file_structure else length_dir
        info_path = base / "diffusion_info.csv"
        if not info_path.exists():
            continue
        info = parse_diffusion_info(info_path, cdr_loop_index=cdr_loop_index)
        gt_path = base / f"{info['pdb_name']}_1.pdb"
        if not gt_path.exists():
            continue
        samples = _sample_pdbs(length_dir)
        if samples:
            yield length_dir, gt_path, info, samples


def _region_residue_sel(
    prot: Protein, chains: list[str], regions: list[tuple[int, int]]
) -> np.ndarray:
    sel = np.zeros(len(prot.aatype), bool)
    for ch, (s, e) in zip(chains, regions):
        chain_sel = np.where(eval_metrics._chain_residue_sel(prot, ch))[0]
        sel[chain_sel[s : e + 1]] = True
    return sel


def compute_sasa_metrics(
    gt: Protein, pred: Protein, info: dict
) -> dict[str, float]:
    """Mean RSA over the diffused regions + RSA error vs ground truth.
    O(N^2) per structure: enable with --sasa."""
    sel = _region_residue_sel(pred, info["chains"], info["regions"])
    rsa_pred = eval_metrics.relative_sasa(pred)
    rsa_gt = eval_metrics.relative_sasa(gt)
    ok = sel & np.isfinite(rsa_pred) & np.isfinite(rsa_gt)
    if not ok.any():
        return {"rsa_mean": np.nan, "rsa_error": np.nan}
    return {
        "rsa_mean": float(np.mean(rsa_pred[ok])),
        "rsa_error": float(np.mean(np.abs(rsa_pred[ok] - rsa_gt[ok]))),
    }


def base_metric_columns(info: dict) -> dict:
    """The base columns of every row."""
    chains, regions = info["chains"], info["regions"]
    cols = {
        "pdb_name": info["pdb_name"],
        "structure_length": len(str(info["seq"])),
    }
    for role, ch, (s, e) in zip(("alpha", "beta"), chains, regions):
        cols[f"tcr_{role}_chain"] = ch
        cols[f"tcr_{role}_chain_start_idx"] = s
        cols[f"tcr_{role}_chain_end_idx"] = e
        cols[f"tcr_{role}_chain_diffused_length"] = e - s + 1
    return cols


def reference_metric_columns(
    gt: Protein, pred: Protein, info: dict, metric_cfg: dict
) -> dict:
    """Flattened registry metrics: `bb_rmsd`, `bb_rmsd_alpha`,
    `bb_rmsd_alpha_-2`, `signed_angle_error_psi_beta_1`, ..."""
    chains, regions = info["chains"], info["regions"]
    cols: dict = {}
    for metric_type, registry in eval_metrics.METRIC_TYPES.items():
        for name in metric_cfg.get(metric_type, []):
            val = registry[name](gt, pred, chains, regions, regions)
            cols.update(eval_metrics.flatten({name: val}))
    return cols


def compute_sample_metrics(
    gt: Protein, pred: Protein, info: dict
) -> dict[str, float]:
    chains, regions = info["chains"], info["regions"]
    out = {
        "backbone_rmsd": eval_metrics.backbone_rmsd(
            pred, gt, chains, regions, regions
        ),
        "full_atom_rmsd": eval_metrics.full_atom_rmsd(
            pred, gt, chains, regions, regions
        ),
    }
    per_chain = eval_metrics.chain_backbone_rmsd(pred, gt, chains, regions, regions)
    for k, v in per_chain.items():
        out[f"backbone_rmsd_{k}"] = v
    # Dihedral errors over each region.
    phi_err, psi_err, omega_err = [], [], []
    for ch, region in zip(chains, regions):
        d_gt = eval_metrics.backbone_dihedrals(gt, ch, region)
        d_pred = eval_metrics.backbone_dihedrals(pred, ch, region)
        for name, acc in (("phi", phi_err), ("psi", psi_err), ("omega", omega_err)):
            ok = np.isfinite(d_gt[name]) & np.isfinite(d_pred[name])
            if ok.any():
                acc.extend(
                    np.degrees(
                        eval_metrics.angle_error(d_pred[name][ok], d_gt[name][ok])
                    )
                )
    out["phi_error_deg"] = float(np.mean(phi_err)) if phi_err else np.nan
    out["psi_error_deg"] = float(np.mean(psi_err)) if psi_err else np.nan
    out["omega_error_deg"] = float(np.mean(omega_err)) if omega_err else np.nan
    return out


def run(
    prediction_dir: pathlib.Path,
    output_dir: pathlib.Path | None = None,
    make_plots: bool = True,
    with_sasa: bool = False,
    cdr_loop_index: int = 0,
    legacy_file_structure: bool = False,
) -> list[dict]:
    """Evaluate the tree under ``prediction_dir`` into ``output_dir``
    (``prediction_dir/evaluation`` by default); returns the rows of
    ``eval_metrics_all.csv``."""
    prediction_dir = pathlib.Path(prediction_dir)
    output_dir = pathlib.Path(output_dir or prediction_dir / "evaluation")
    output_dir.mkdir(parents=True, exist_ok=True)
    metric_cfg = {k: list(v) for k, v in eval_metrics.DEFAULT_METRIC_CFG.items()}
    if with_sasa:
        metric_cfg["residue_metrics"] += eval_metrics.SASA_METRIC_NAMES
    strategies = sel_lib.SAMPLE_SELECTION_STRATEGIES

    all_rows = []
    residue_rows = []
    strategy_rows: dict[str, list] = {s: [] for s in strategies}

    for length_dir, gt_path, info, sample_paths in traverse_prediction_dir(
        prediction_dir,
        cdr_loop_index=cdr_loop_index,
        legacy_file_structure=legacy_file_structure,
    ):
        gt = from_pdb_string(gt_path.read_text())
        preds = [from_pdb_string(p.read_text()) for p in sample_paths]
        pdb_name = info["pdb_name"]

        base_cols = base_metric_columns(info)
        for path, pred in zip(sample_paths, preds):
            i = sample_index(path)
            row = dict(base_cols)
            row.update({"sample_idx": i, "sample": i, "path": str(path)})
            row.update(compute_sample_metrics(gt, pred, info))
            row.update(reference_metric_columns(gt, pred, info, metric_cfg))
            if with_sasa:
                row.update(compute_sasa_metrics(gt, pred, info))
            all_rows.append(row)
            # Per-residue granularity with the middle-averaged position
            # scheme.
            per_res = eval_metrics.residue_backbone_rmsd(
                pred, gt, info["chains"], info["regions"], info["regions"]
            )
            for chain_role, values in per_res.items():
                collapsed = plots.middle_average(np.asarray(values))
                for pos, v in enumerate(collapsed):
                    residue_rows.append(
                        {
                            "pdb_name": pdb_name,
                            "sample": i,
                            "chain": chain_role,
                            "position": pos,
                            "backbone_rmsd": float(v),
                        }
                    )

        # Sample selection over diffusion-region backbone coords.
        sel_res = _region_residue_sel(preds[0], info["chains"], info["regions"])
        region_coords = np.stack(
            [p.atom_positions[sel_res][:, BACKBONE_IDX, :] for p in preds]
        )
        selections = sel_lib.select_samples(region_coords, strategies)
        for strategy, result in selections.items():
            if result["index"] is not None:
                chosen = preds[result["index"]]
                # Report the sample's DIRECTORY index, consistent with
                # eval_metrics_all.csv's sample_idx — the positional index
                # into preds diverges when a resumed run misses a sample.
                selected = sample_index(sample_paths[result["index"]])
            else:
                chosen = sel_lib.synthesize_protein(
                    preds[0], sel_res, BACKBONE_IDX, result["coords"]
                )
                selected = None
            row = dict(base_cols)
            row.update({"strategy": strategy, "selected_sample": selected})
            row.update(compute_sample_metrics(gt, chosen, info))
            row.update(reference_metric_columns(gt, chosen, info, metric_cfg))
            strategy_rows[strategy].append(row)
        logger.info(f"evaluated {pdb_name}: {len(preds)} samples")

    table.write_csv(all_rows, output_dir / "eval_metrics_all.csv")
    if residue_rows:
        table.write_csv(residue_rows, output_dir / "eval_metrics_residue.csv")
    for strategy, rows in strategy_rows.items():
        table.write_csv(rows, output_dir / f"eval_metrics_{strategy}.csv")

    if make_plots and all_rows:
        _plots(all_rows, output_dir)
    if with_sasa and all_rows:
        _rsa_correlation(all_rows, output_dir)
    return all_rows


def rsa_pairs(rows: list[dict]) -> tuple[np.ndarray, np.ndarray]:
    """(ground truth RSA, sample RSA) over every ``gt_rsa_*`` column with its
    ``sample_rsa_*`` column, column after column, NaN where a row lacks it."""
    names = table.columns(rows)
    pairs = [
        (col, "sample_rsa_" + col[len("gt_rsa_"):])
        for col in names
        if col.startswith("gt_rsa_") and "sample_rsa_" + col[len("gt_rsa_"):] in names
    ]
    if not pairs:
        return np.zeros(0), np.zeros(0)
    gt = np.concatenate([table.column(rows, g) for g, _ in pairs])
    sample = np.concatenate([table.column(rows, s) for _, s in pairs])
    return gt, sample


def _rsa_correlation(rows: list[dict], output_dir: pathlib.Path) -> None:
    """GT-vs-sample RSA scatter with its Pearson r, logged."""
    gt, sample = rsa_pairs(rows)
    if not len(gt):
        return
    path, r = plots.pearson_scatter(
        gt, sample, output_dir / "rsa_correlation.png", "gt_rsa", "sample_rsa"
    )
    logger.info(f"RSA gt-vs-sample pearson r = {r:.3f} ({path})")


def _plots(rows: list[dict], output_dir: pathlib.Path) -> None:
    try:
        plt, sns = plots._mpl()
    except ImportError:
        logger.warning("matplotlib/seaborn unavailable; skipping plots")
        return
    names = table.columns(rows)
    metrics = [
        c
        for c in ("backbone_rmsd", "full_atom_rmsd", "phi_error_deg", "psi_error_deg")
        if c in names
    ]
    pdb_names = [str(r["pdb_name"]) for r in rows]
    for metric in metrics:
        values = table.column(rows, metric)
        fig, ax = plt.subplots(figsize=(max(6, 0.5 * len(set(pdb_names))), 4))
        sns.boxplot(x=pdb_names, y=values, ax=ax, color="lightblue")
        sns.swarmplot(x=pdb_names, y=values, ax=ax, color="black", size=3)
        ax.set_xlabel("pdb_name")
        ax.set_ylabel(metric)
        ax.tick_params(axis="x", rotation=90)
        fig.tight_layout()
        fig.savefig(output_dir / f"{metric}_boxplot.png", dpi=120)
        plt.close(fig)
    _grouped_alpha_beta_plots(rows, output_dir)


# Legends of the per-residue grouped plots.
_GROUPED_METRIC_LEGENDS = {
    "bb_rmsd": "Backbone RMSD per residue",
    "signed_angle_error_phi": "Signed angle error phi",
    "signed_angle_error_psi": "Signed angle error psi",
    "signed_angle_error_omega": "Signed angle error omega",
}


def _grouped_alpha_beta_plots(rows: list[dict], output_dir: pathlib.Path) -> None:
    """Median sample per pdb_name, one grouped alpha/beta Backbone RMSD
    plot, then per-residue grouped plots over the XTICKS positions."""
    if not {"bb_rmsd", "bb_rmsd_alpha", "bb_rmsd_beta"} <= set(table.columns(rows)):
        return
    # Closest-to-median row per pdb (one row for an even sample count too).
    median_rows = plots.median_sample_rows(rows)
    plots.grouped_alpha_beta_plot(
        [table.present(median_rows, "bb_rmsd_alpha")],
        [table.present(median_rows, "bb_rmsd_beta")],
        output_dir,
        "Backbone RMSD",
        ["Backbone RMSD"],
    )
    for metric, legend in _GROUPED_METRIC_LEGENDS.items():
        groups = eval_metrics.average_metrics_for_middle_residues(median_rows, metric)
        if not any(len(g) for g in groups["alpha"] + groups["beta"]):
            continue
        plots.grouped_alpha_beta_plot(
            groups["alpha"], groups["beta"], output_dir, legend, plots.XTICKS
        )


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--prediction_dir", required=True)
    ap.add_argument("--output_dir", default=None)
    ap.add_argument("--no_plots", action="store_true")
    ap.add_argument("--sasa", action="store_true", help="compute ASA/RSA metrics")
    ap.add_argument(
        "--cdr_loop_index", type=int, default=0,
        help="which CDR loop to evaluate in multi-loop runs (0, 1 or 2)",
    )
    ap.add_argument(
        "--legacy", action="store_true",
        help="older output layout: gt pdb + diffusion_info.csv under sample_0/",
    )
    args = ap.parse_args()
    rows = run(
        pathlib.Path(args.prediction_dir),
        pathlib.Path(args.output_dir) if args.output_dir else None,
        make_plots=not args.no_plots,
        with_sasa=args.sasa,
        cdr_loop_index=args.cdr_loop_index,
        legacy_file_structure=args.legacy,
    )
    if rows:
        logger.info(
            f"evaluated {len({r['pdb_name'] for r in rows})} structures, "
            f"mean backbone RMSD {np.nanmean(table.column(rows, 'backbone_rmsd')):.3f} A"
        )


if __name__ == "__main__":
    main()
