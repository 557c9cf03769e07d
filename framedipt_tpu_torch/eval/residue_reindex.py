"""Re-number PDB residues contiguously per chain (the port's copy of the JAX
package's ``eval/residue_reindex.py``).

External predictors keep author numbering; the CLI's outputs use contiguous
1-based numbering per chain. Two modes:

- single file: rewrite one PDB so residue indices run 1..L per chain
  (HETATMs are dropped: the Protein parser never ingests them);
- directory: mirror a whole prediction tree, reindexing the ground-truth
  and every sample PDB and copying each diffusion_info.csv unchanged
  (``--legacy`` for the layout with both under ``sample_0/``).

Usage:
    python -m framedipt_tpu_torch.eval.residue_reindex --input=a.pdb --output=b.pdb
    python -m framedipt_tpu_torch.eval.residue_reindex \
        --input_dir=preds/ --output_dir=preds_reindexed/ [--legacy]
"""
from __future__ import annotations

import argparse
import pathlib
import shutil

import numpy as np

from framedipt_tpu_torch.data.protein import from_pdb_string, to_pdb


def reindex(pdb_text: str) -> str:
    prot = from_pdb_string(pdb_text)
    new_idx = np.zeros_like(prot.residue_index)
    for cid in np.unique(prot.chain_index):
        sel = prot.chain_index == cid
        new_idx[sel] = np.arange(1, sel.sum() + 1)
    prot.residue_index = new_idx
    return to_pdb(prot)


def reindex_prediction_dir(
    in_dir: pathlib.Path,
    out_dir: pathlib.Path,
    legacy_file_structure: bool = False,
) -> int:
    """Reindex every structure of a prediction tree into ``out_dir``.

    Returns the number of test cases (length dirs) processed.
    """
    from framedipt_tpu_torch.eval.tcr_eval import traverse_prediction_dir

    in_dir = pathlib.Path(in_dir)
    out_dir = pathlib.Path(out_dir)
    count = 0
    for length_dir, gt_path, _info, samples in traverse_prediction_dir(
        in_dir, legacy_file_structure=legacy_file_structure
    ):
        for pdb_path in [gt_path, *samples]:
            out_path = out_dir / pdb_path.relative_to(in_dir)
            out_path.parent.mkdir(parents=True, exist_ok=True)
            out_path.write_text(reindex(pdb_path.read_text()))
        info_base = (
            length_dir / "sample_0" if legacy_file_structure else length_dir
        )
        info_path = info_base / "diffusion_info.csv"
        out_info = out_dir / info_path.relative_to(in_dir)
        out_info.parent.mkdir(parents=True, exist_ok=True)
        # Indexing inside diffusion_info.csv is already contiguous per
        # chain: copied verbatim.
        shutil.copyfile(info_path, out_info)
        count += 1
    return count


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", help="single PDB to reindex")
    ap.add_argument("--output", help="output path for --input")
    ap.add_argument("--input_dir", help="prediction tree to reindex")
    ap.add_argument("--output_dir", help="output tree for --input_dir")
    ap.add_argument(
        "--legacy", action="store_true",
        help="gt pdb + diffusion_info.csv live under sample_0/",
    )
    args = ap.parse_args()
    if args.input_dir:
        if not args.output_dir:
            ap.error("--input_dir requires --output_dir")
        n = reindex_prediction_dir(
            pathlib.Path(args.input_dir),
            pathlib.Path(args.output_dir),
            legacy_file_structure=args.legacy,
        )
        print(f"reindexed {n} test cases into {args.output_dir}")
        return
    if not (args.input and args.output):
        ap.error("provide --input/--output or --input_dir/--output_dir")
    text = pathlib.Path(args.input).read_text()
    pathlib.Path(args.output).write_text(reindex(text))


if __name__ == "__main__":
    main()
