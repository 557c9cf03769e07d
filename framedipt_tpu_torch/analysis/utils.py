"""atom37 -> PDB writers with diffusion-region b-factor markers and
trajectory (multi-model) support, in pure Python."""
from __future__ import annotations

import os
import pathlib
import re

import numpy as np

from framedipt_tpu_torch.data.protein import Protein, prots_to_pdb, to_pdb

ATOM_MASK_EPS = 1e-7


def _as_protein(
    pos37: np.ndarray,
    aatype: np.ndarray | None,
    b_factors: np.ndarray | None,
    residue_index: np.ndarray | None,
    chain_index: np.ndarray | None,
) -> Protein:
    n = pos37.shape[0]
    atom_mask = (np.abs(pos37).sum(-1) > ATOM_MASK_EPS).astype(np.float64)
    return Protein(
        atom_positions=np.asarray(pos37, np.float64),
        aatype=np.zeros(n, np.int64) if aatype is None else np.asarray(aatype),
        atom_mask=atom_mask,
        residue_index=(
            np.arange(1, n + 1) if residue_index is None else np.asarray(residue_index)
        ),
        chain_index=(
            np.zeros(n, np.int64) if chain_index is None else np.asarray(chain_index)
        ),
        b_factors=(
            np.zeros((n, 37)) if b_factors is None else np.asarray(b_factors)
        ),
    )


def prot_pos_to_pdb(
    prot_pos: np.ndarray,
    aatype: np.ndarray | None = None,
    b_factors: np.ndarray | None = None,
    residue_index: np.ndarray | None = None,
    chain_index: np.ndarray | None = None,
) -> str:
    """PDB text of atom37 positions [N,37,3], or of a trajectory [T,N,37,3]
    as one MODEL per frame. Atoms at the origin are treated as absent."""
    pos = np.asarray(prot_pos)
    if pos.ndim == 3:
        return to_pdb(_as_protein(pos, aatype, b_factors, residue_index, chain_index))
    return prots_to_pdb(
        [
            _as_protein(frame, aatype, b_factors, residue_index, chain_index)
            for frame in pos
        ]
    )


def write_prot_to_pdb(
    prot_pos: np.ndarray,
    file_path: str | pathlib.Path,
    aatype: np.ndarray | None = None,
    overwrite: bool = False,
    no_indexing: bool = False,
    b_factors: np.ndarray | None = None,
    residue_index: np.ndarray | None = None,
    chain_index: np.ndarray | None = None,
) -> pathlib.Path:
    """Write atom37 positions ([N,37,3] or trajectory [T,N,37,3]) to PDB.

    Filename convention: ``{stem}_{k}.pdb`` where k is 1 + the largest
    existing index for that stem (auto-versioned outputs)."""
    file_path = pathlib.Path(file_path)
    if no_indexing:
        save_path = file_path if file_path.suffix == ".pdb" else file_path.with_suffix(".pdb")
    else:
        max_idx = 0
        if not overwrite:
            stem = file_path.stem.removesuffix(".pdb")
            file_dir = file_path.parent
            if file_dir.exists():
                for x in os.listdir(file_dir):
                    if stem in x:
                        m = re.findall(r"_(\d+).pdb", x)
                        if m:
                            max_idx = max(max_idx, int(m[0]))
        save_path = file_path.with_name(f"{file_path.stem}_{max_idx + 1}.pdb")

    save_path.parent.mkdir(parents=True, exist_ok=True)
    save_path.write_text(
        prot_pos_to_pdb(prot_pos, aatype, b_factors, residue_index, chain_index)
    )
    return save_path
