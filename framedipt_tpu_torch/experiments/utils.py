"""Experiment helpers: the diffused regions per chain, the
``diffusion_info.csv`` file that evaluation reads, and a wall-clock timer."""
from __future__ import annotations

import csv
import pathlib
import time

import numpy as np


DIFFUSION_INFO_FIELDS = ("pdb_name", "seq", "chain", "start", "end")


def get_diffused_region_per_chain(
    diffused_mask: np.ndarray, chain_index: np.ndarray
) -> tuple[list[int], list[int], list[int]]:
    """Per-chain (chain, start, end) triples of the contiguous diffused
    regions, several per chain where there are; indices are chain-local and
    chains are renumbered 0..C-1 in sorted order."""
    diffused_mask = np.asarray(diffused_mask).astype(bool)
    chain_index = np.asarray(chain_index)
    chain_renumber = {c: i for i, c in enumerate(np.unique(chain_index))}

    chains, starts, ends = [], [], []
    for c in np.unique(chain_index[diffused_mask]):
        local_diffused = np.where(diffused_mask[chain_index == c])[0]
        gaps = np.where(np.diff(local_diffused) > 1)[0]
        region_starts = [0, *(gaps + 1)]
        region_ends = [*gaps, len(local_diffused) - 1]
        for s_i, e_i in zip(region_starts, region_ends):
            chains.append(chain_renumber[c])
            starts.append(int(local_diffused[s_i]))
            ends.append(int(local_diffused[e_i]))
    return chains, starts, ends


def save_diffusion_info(
    output_dir: pathlib.Path,
    pdb_name: str,
    seq: str,
    diffused_mask: np.ndarray,
    chain_index: np.ndarray,
) -> pathlib.Path:
    """Write ``diffusion_info.csv``: tab-separated, a header row and one row
    of (pdb_name, seq, chain letters, starts, ends), the lists
    comma-joined. Residues outside the 20 standard ones ("X" in ``seq``)
    are dropped before the regions are computed, so the indices count
    standard residues only."""
    if len(diffused_mask) != len(chain_index):
        raise ValueError(
            f"diffused_mask vs chain_index length mismatch: "
            f"{len(diffused_mask)} != {len(chain_index)}"
        )
    standard = np.asarray([c != "X" for c in seq])
    chains, starts, ends = get_diffused_region_per_chain(
        np.asarray(diffused_mask)[standard], np.asarray(chain_index)[standard]
    )
    row = (
        pdb_name,
        seq,
        ",".join(chr(ord("A") + c) for c in chains),
        ",".join(str(s) for s in starts),
        ",".join(str(e) for e in ends),
    )
    csv_path = pathlib.Path(output_dir) / "diffusion_info.csv"
    with open(csv_path, "w", newline="", encoding="utf-8") as f:
        writer = csv.writer(f, delimiter="\t", lineterminator="\n")
        writer.writerow(DIFFUSION_INFO_FIELDS)
        writer.writerow(row)
    return csv_path


class Timer:
    """Context-manager wall-clock timer; ``elapsed`` in seconds."""

    def __init__(self) -> None:
        self.elapsed = 0.0

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._start
        return False
