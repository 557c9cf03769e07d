"""Monomer .pdb preprocessing CLI.

Walks a directory of ``.pdb`` files (single chains or monomers), keeps those
whose length is within bounds and that have a modeled residue, writes each
as a pickle of numpy arrays at ``<output_dir>/<name[1:3]>/<name>.pkl``, and
writes ``metadata.csv`` (the text pandas writes for the same rows) with its
secondary-structure fractions and radius of gyration, in the layout of the
mmCIF pipeline (``data/pipeline.py``).

Usage:
    python -m framedipt_tpu_torch.data.process_pdb_files --pdb_dir=... \
        --output_dir=... [--max_len=512] [--min_len=60] [--device=cpu]
"""
from __future__ import annotations

import argparse
import pathlib
import pickle

import numpy as np

from framedipt_tpu_torch.analysis import dssp as dssp_lib
from framedipt_tpu_torch.data import constants as rc
from framedipt_tpu_torch.data.protein import from_pdb_string
from framedipt_tpu_torch.eval import table
from framedipt_tpu_torch.tools import errors
from framedipt_tpu_torch.tools.device import resolve_device
from framedipt_tpu_torch.tools.log import get_logger

logger = get_logger()


def process_pdb_file(
    path: pathlib.Path, output_dir: pathlib.Path,
    max_len: int = 512, min_len: int = 60,
) -> dict:
    """Write the structure at ``path`` as a pickle under ``output_dir`` and
    return its metadata row. Raises :class:`errors.LengthError` outside
    [min_len, max_len] and :class:`errors.DataError` without a modeled
    residue."""
    prot = from_pdb_string(path.read_text())
    n = len(prot.aatype)
    if n > max_len:
        raise errors.LengthError(f"{path.name}: {n} > {max_len}")
    if n < min_len:
        raise errors.LengthError(f"{path.name}: {n} < {min_len}")

    bb_mask = prot.atom_mask[:, rc.CA_IDX]
    modeled = np.where((prot.aatype != rc.unk_restype_index) & (bb_mask > 0))[0]
    if len(modeled) == 0:
        raise errors.DataError(f"{path.name}: no modeled residues")

    raw = {
        "aatype": prot.aatype,
        "atom_positions": prot.atom_positions,
        "atom_mask": prot.atom_mask,
        "residue_index": prot.residue_index,
        "b_factors": prot.b_factors,
        "bb_mask": bb_mask,
        "chain_index": prot.chain_index,
        "min_modeled_idxs": np.asarray([modeled.min()], np.int64),
        "max_modeled_idxs": np.asarray([modeled.max()], np.int64),
    }
    name = path.stem
    subdir = output_dir / (name[1:3] if len(name) >= 3 else "xx")
    subdir.mkdir(parents=True, exist_ok=True)
    pkl_path = subdir / f"{name}.pkl"
    with open(pkl_path, "wb") as f:
        pickle.dump(raw, f)

    ss = dssp_lib.assign_secondary_structure(prot.atom_positions, prot.atom_mask)
    return {
        "pdb_name": name,
        "processed_path": str(pkl_path),
        "raw_path": str(path),
        "num_chains": len(np.unique(prot.chain_index)),
        "seq_len": n,
        "modeled_seq_len": int(modeled.max() - modeled.min() + 1),
        "helix_percent": float(np.mean(ss == "H")),
        "strand_percent": float(np.mean(ss == "E")),
        "coil_percent": float(np.mean(ss == "C")),
        "radius_gyration": dssp_lib.radius_of_gyration(prot.atom_positions, prot.atom_mask),
    }


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--pdb_dir", required=True)
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--max_len", type=int, default=512)
    ap.add_argument("--min_len", type=int, default=60)
    args = ap.parse_args(argv)
    resolve_device(args.device)
    out = pathlib.Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    rows = []
    for path in sorted(pathlib.Path(args.pdb_dir).glob("*.pdb")):
        try:
            rows.append(process_pdb_file(path, out, args.max_len, args.min_len))
            logger.info(f"processed {path.name}")
        except errors.DataError as e:
            logger.info(f"skipped: {e}")
    table.write_csv(rows, out / "metadata.csv")
    logger.info(f"wrote {len(rows)} rows to {out / 'metadata.csv'}")


if __name__ == "__main__":
    main()
