"""Offline dataset preprocessing CLI.

Walks a directory of mmCIF files, parses each, applies the quality filters
(resolution, chains, length, secondary-structure composition, and the
radius-of-gyration quantile over the set), writes one pickle of raw
features per structure into 2-character hashed subdirectories, and writes
``metadata.csv`` with the ``csv`` module, in the JAX package's columns and
order. Serial and multiprocessing drivers.

Usage:
    python -m framedipt_tpu_torch.data.pipeline [--device=cpu] --cif_dir=... \
        --output_dir=... [--num_workers=8] [--max_len=512] [--min_len=60]

Like every entry point of the package it expects a CUDA device unless
``--device=cpu`` is given (the work itself runs on the host).
"""
from __future__ import annotations

import argparse
import csv
import dataclasses
import multiprocessing as mp
import pathlib
import pickle
import time

import numpy as np

from framedipt_tpu_torch.analysis import dssp as dssp_lib
from framedipt_tpu_torch.data import features as feature_lib
from framedipt_tpu_torch.data.mmcif import parse_mmcif
from framedipt_tpu_torch.tools import errors
from framedipt_tpu_torch.tools.config import FilteringConfig
from framedipt_tpu_torch.tools.device import resolve_device
from framedipt_tpu_torch.tools.log import get_logger

logger = get_logger()

METADATA_COLUMNS = (
    "pdb_name", "processed_path", "raw_path", "resolution", "num_chains", "seq_len",
    "modeled_seq_len", "helix_percent", "strand_percent", "coil_percent",
    "radius_gyration", "oligomeric_details",
)


@dataclasses.dataclass
class ProcessOptions:
    output_dir: pathlib.Path
    filtering: FilteringConfig
    max_resolution: float | None = 5.0
    first_assembly: bool = True
    # Selection for inference metadata: author chains, per-chain length
    # bounds, a chain-count cap, rejecting the invalid 0.0 resolution, and
    # skipping the secondary-structure filters.
    chains: list[str] | None = None
    chain_min_len: int | None = None
    chain_max_len: int | None = None
    max_num_chains: int | None = None
    check_valid_resolution: bool = False
    ss_filters: bool = True


def process_mmcif(path: pathlib.Path, opts: ProcessOptions) -> dict:
    """Parse and filter one structure, write its pickle, return its metadata
    row. Raises a :class:`errors.DataError` for a rejected structure."""
    pdb_name = path.stem[:4] if opts.first_assembly else path.stem
    mmcif_obj = parse_mmcif(path, file_id=pdb_name)

    res = mmcif_obj.header.resolution
    if opts.max_resolution is not None and res is not None and res > opts.max_resolution:
        raise errors.ResolutionError(f"{pdb_name}: resolution {res}")
    if opts.check_valid_resolution and (res is None or res == 0.0):
        raise errors.ResolutionError(f"{pdb_name}: invalid resolution {res}")

    if opts.chains is not None:
        missing = [c for c in opts.chains if c not in mmcif_obj.chains]
        if missing:
            raise errors.ChainError(f"{pdb_name}: missing chains {missing}")
    if opts.max_num_chains is not None and len(mmcif_obj.chains) > opts.max_num_chains:
        raise errors.ChainError(
            f"{pdb_name}: {len(mmcif_obj.chains)} chains > {opts.max_num_chains}"
        )
    if opts.chain_min_len is not None or opts.chain_max_len is not None:
        # Modeled chain length: the span from the first to the last known
        # residue.
        for cid in opts.chains or sorted(mmcif_obj.chains):
            known = np.where(mmcif_obj.chains[cid].aatype != 20)[0]
            if known.size == 0:
                raise errors.LengthError(f"{pdb_name}/{cid}: no modeled residues")
            modeled = int(known.max() - known.min() + 1)
            if opts.chain_max_len is not None and modeled > opts.chain_max_len:
                raise errors.LengthError(
                    f"{pdb_name}/{cid}: chain length {modeled} > {opts.chain_max_len}"
                )
            if opts.chain_min_len is not None and modeled < opts.chain_min_len:
                raise errors.LengthError(
                    f"{pdb_name}/{cid}: chain length {modeled} < {opts.chain_min_len}"
                )

    raw = feature_lib.structure_to_features(mmcif_obj, chain_ids=opts.chains)
    n_res = len(raw["aatype"])
    filt = opts.filtering
    if n_res > filt.max_len:
        raise errors.LengthError(f"{pdb_name}: length {n_res} > {filt.max_len}")
    if n_res < filt.min_len:
        raise errors.LengthError(f"{pdb_name}: length {n_res} < {filt.min_len}")

    num_chains = len(np.unique(raw["chain_index"]))
    oligomeric = mmcif_obj.header.oligomeric_details or ""
    if filt.allowed_oligomer and oligomeric not in filt.allowed_oligomer:
        raise errors.ChainError(f"{pdb_name}: oligomer '{oligomeric}' not allowed")

    bb = raw["bb_mask"].astype(bool)
    ss = dssp_lib.assign_secondary_structure(raw["atom_positions"][bb], raw["atom_mask"][bb])
    helix_percent = float(np.mean(ss == "H"))
    strand_percent = float(np.mean(ss == "E"))
    coil_percent = float(np.mean(ss == "C"))
    if opts.ss_filters:
        if helix_percent > filt.max_helix_percent:
            raise errors.SecondaryStructureError(f"{pdb_name}: helix {helix_percent:.2f}")
        if coil_percent > filt.max_loop_percent:
            raise errors.SecondaryStructureError(f"{pdb_name}: coil {coil_percent:.2f}")
        if strand_percent < filt.min_beta_percent:
            raise errors.SecondaryStructureError(f"{pdb_name}: beta {strand_percent:.2f}")
    rog = dssp_lib.radius_of_gyration(raw["atom_positions"][bb], raw["atom_mask"][bb])

    subdir = opts.output_dir / pdb_name[1:3]
    subdir.mkdir(parents=True, exist_ok=True)
    pkl_path = subdir / f"{pdb_name}.pkl"
    with open(pkl_path, "wb") as f:
        pickle.dump(raw, f)

    modeled_len = int(
        sum(hi - lo + 1 for lo, hi in zip(raw["min_modeled_idxs"], raw["max_modeled_idxs"]))
    )
    return {
        "pdb_name": pdb_name,
        "processed_path": str(pkl_path),
        "raw_path": str(path),
        "resolution": res if res is not None else 0.0,
        "num_chains": num_chains,
        "seq_len": n_res,
        "modeled_seq_len": modeled_len,
        "helix_percent": helix_percent,
        "strand_percent": strand_percent,
        "coil_percent": coil_percent,
        "radius_gyration": rog,
        "oligomeric_details": oligomeric,
    }


def _process_one(args) -> dict | None:
    path, opts = args
    t0 = time.time()
    try:
        row = process_mmcif(path, opts)
        logger.info(f"processed {path.name} in {time.time() - t0:.2f}s")
        return row
    except errors.DataError as e:
        logger.info(f"skipped {path.name}: {e}")
        return None
    except Exception as e:  # noqa: BLE001 - one bad file must not end the run
        logger.warning(f"failed {path.name}: {type(e).__name__}: {e}")
        return None


def process_serially(paths, opts: ProcessOptions) -> list[dict]:
    rows = [_process_one((p, opts)) for p in paths]
    return [r for r in rows if r is not None]


def process_parallel(paths, opts: ProcessOptions, num_workers: int) -> list[dict]:
    with mp.get_context("fork").Pool(num_workers) as pool:
        rows = pool.map(_process_one, [(p, opts) for p in paths])
    return [r for r in rows if r is not None]


def apply_rog_quantile(rows: list[dict], quantile: float) -> list[dict]:
    """Drop the structures whose radius of gyration is above the quantile."""
    if not rows or quantile >= 1.0:
        return rows
    cutoff = np.quantile(np.asarray([r["radius_gyration"] for r in rows]), quantile)
    return [r for r in rows if r["radius_gyration"] <= cutoff]


def write_metadata(rows: list[dict], path: pathlib.Path) -> None:
    """``metadata.csv``: a header of :data:`METADATA_COLUMNS` and one line a
    row (floats as Python writes them, as pandas does)."""
    with open(path, "w", newline="", encoding="utf-8") as f:
        writer = csv.DictWriter(f, fieldnames=METADATA_COLUMNS, lineterminator="\n")
        writer.writeheader()
        writer.writerows(rows)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cif_dir", required=True)
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--num_workers", type=int, default=1)
    ap.add_argument("--max_len", type=int, default=512)
    ap.add_argument("--min_len", type=int, default=60)
    ap.add_argument("--max_resolution", type=float, default=5.0)
    ap.add_argument("--rog_quantile", type=float, default=0.96)
    args = ap.parse_args(argv)
    resolve_device(args.device)

    cif_dir = pathlib.Path(args.cif_dir)
    paths = sorted(list(cif_dir.glob("*.cif")) + list(cif_dir.glob("*.cif.gz")))
    logger.info(f"found {len(paths)} mmCIF files in {cif_dir}")
    opts = ProcessOptions(
        output_dir=pathlib.Path(args.output_dir),
        filtering=FilteringConfig(
            max_len=args.max_len, min_len=args.min_len, rog_quantile=args.rog_quantile
        ),
        max_resolution=args.max_resolution,
    )
    opts.output_dir.mkdir(parents=True, exist_ok=True)
    if args.num_workers > 1:
        rows = process_parallel(paths, opts, args.num_workers)
    else:
        rows = process_serially(paths, opts)
    rows = apply_rog_quantile(rows, args.rog_quantile)
    meta_path = opts.output_dir / "metadata.csv"
    write_metadata(rows, meta_path)
    logger.info(f"wrote {len(rows)} rows to {meta_path}")


if __name__ == "__main__":
    main()
