"""Chemical constant tables (AlphaFold2 conventions).

Loaded from ``chemical_tables.npz`` / ``chemical_names.json`` beside this
module: ideal residue geometry, atom37/atom14 orders, rigid-group frames.
The files are the same data the JAX package ships; this package keeps its own
copy so that it imports nothing of the JAX package.
"""
from __future__ import annotations

import functools
import json
import pathlib

import numpy as np

_DIR = pathlib.Path(__file__).resolve().parent


@functools.lru_cache(maxsize=1)
def _arrays() -> dict[str, np.ndarray]:
    with np.load(_DIR / "chemical_tables.npz") as z:
        return {k: z[k] for k in z.files}


@functools.lru_cache(maxsize=1)
def _names() -> dict:
    return json.loads((_DIR / "chemical_names.json").read_text())


def __getattr__(name: str):
    arrays = _arrays()
    if name in arrays:
        return arrays[name]
    names = _names()
    if name in names:
        return names[name]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


restypes: list[str] = _names()["restypes"]  # 20 one-letter codes
restype_order: dict[str, int] = {r: i for i, r in enumerate(restypes)}
restype_num: int = len(restypes)  # 20
unk_restype_index: int = _names()["unk_restype_index"]  # 20

atom_types: list[str] = _names()["atom_types"]  # 37 atom names
atom_order: dict[str, int] = {a: i for i, a in enumerate(atom_types)}
atom_type_num: int = len(atom_types)  # 37

restype_1to3: dict[str, str] = _names()["restype_1to3"]
restype_3to1: dict[str, str] = _names()["restype_3to1"]

CA_IDX = atom_order["CA"]


def aatype_to_sequence(aatype: np.ndarray) -> str:
    """One-letter sequence of aatype indices; anything outside the 20
    standard residues is "X"."""
    return "".join(
        restypes[i] if 0 <= i < restype_num else "X" for i in np.asarray(aatype)
    )
