"""cg2all full-atom evaluation CLI over the inpainting CLI's output tree.

The port's copy of the JAX package's ``eval/cg2all_eval.py``, on the host
with numpy only: each backbone sample is converted to a full-atom structure
by cg2all (``convert_cg2all`` on PATH), written beside it as
``sample_{i}_1_all_atom.pdb`` (where later evaluations pick it up), and
scored against the ground truth over the diffused regions: backbone and
full-atom RMSD, one row a sample in ``cg2all_eval.csv`` (the text pandas
writes for the same rows, ``eval.table``).

Usage:
    python -m framedipt_tpu_torch.eval.cg2all_eval --prediction_dir=... \
        [--output_dir=...] [--skip_convert]
"""
from __future__ import annotations

import argparse
import pathlib

import numpy as np

from framedipt_tpu_torch.data.protein import from_pdb_string
from framedipt_tpu_torch.eval import metrics as eval_metrics
from framedipt_tpu_torch.eval import table
from framedipt_tpu_torch.eval.tcr_eval import (
    base_metric_columns,
    sample_index,
    traverse_prediction_dir,
)
from framedipt_tpu_torch.tools.external import ToolUnavailable, run_cg2all
from framedipt_tpu_torch.tools.log import get_logger

logger = get_logger()


def run(
    prediction_dir: pathlib.Path,
    output_dir: pathlib.Path | None = None,
    skip_convert: bool = False,
) -> list[dict]:
    """Convert and score every sample under ``prediction_dir``; with
    ``skip_convert`` only samples already converted are scored. Without
    cg2all the rows so far are returned, after a warning, and no CSV is
    written. Returns the rows of ``cg2all_eval.csv``."""
    prediction_dir = pathlib.Path(prediction_dir)
    output_dir = pathlib.Path(output_dir or prediction_dir / "evaluation")
    output_dir.mkdir(parents=True, exist_ok=True)
    rows = []
    for _, gt_path, info, sample_paths in traverse_prediction_dir(prediction_dir):
        gt = from_pdb_string(gt_path.read_text())
        for sample_path in sample_paths:
            if sample_path.stem.endswith("_all_atom"):
                fa_path = sample_path  # the traversal took an existing conversion
            else:
                fa_path = sample_path.with_name(sample_path.stem + "_all_atom.pdb")
            if not fa_path.exists():
                if skip_convert:
                    continue
                try:
                    run_cg2all(sample_path, fa_path)
                except ToolUnavailable as e:
                    logger.warning(f"cg2all unavailable: {e}")
                    return rows
            pred = from_pdb_string(fa_path.read_text())
            chains, regions = info["chains"], info["regions"]
            row = dict(base_metric_columns(info))
            row.update({
                "sample_idx": sample_index(sample_path),
                "bb_rmsd": eval_metrics.backbone_rmsd(pred, gt, chains, regions, regions),
                "full_atom_rmsd": eval_metrics.full_atom_rmsd(pred, gt, chains, regions, regions),
            })
            rows.append(row)
    if rows:
        table.write_csv(rows, output_dir / "cg2all_eval.csv")
        logger.info(f"cg2all eval: {len(rows)} samples, mean full-atom RMSD "
                    f"{np.nanmean(table.column(rows, 'full_atom_rmsd')):.3f} A")
    return rows


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--prediction_dir", required=True)
    ap.add_argument("--output_dir", default=None)
    ap.add_argument("--skip_convert", action="store_true",
                    help="only evaluate already-converted sample_{i}_1_all_atom.pdb files "
                         "(never invoke cg2all)")
    args = ap.parse_args(argv)
    run(
        pathlib.Path(args.prediction_dir),
        pathlib.Path(args.output_dir) if args.output_dir else None,
        skip_convert=args.skip_convert,
    )


if __name__ == "__main__":
    main()
