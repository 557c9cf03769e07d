"""mmCIF parser.

Tokenizes the CIF grammar (loops, quoted values, semicolon text fields),
reads the header (resolution, method, release date, oligomeric state) and
the first model's protein chains as atom37 arrays keyed by author chain id.
The same parse as the JAX package's ``data/mmcif.py``. The categories come
from the native C++ parser where it builds (``parse_cif_categories``), else
from the pure-Python tokenizer here (``parse_cif_categories_py``), which
is its behavioural oracle.
"""
from __future__ import annotations

import dataclasses
import gzip
import pathlib
from typing import Iterator

import numpy as np

from framedipt_tpu_torch import native
from framedipt_tpu_torch.data import constants as rc
from framedipt_tpu_torch.tools.errors import MmcifParsingError

# Common non-standard residues and their standard parents (extended per file
# from _chem_comp.mon_nstd_parent_comp_id).
_MODIFIED_RESIDUES = {
    "MSE": "MET", "SEC": "CYS", "PYL": "LYS", "SEP": "SER", "TPO": "THR",
    "PTR": "TYR", "CSO": "CYS", "CSD": "CYS", "CSX": "CYS", "CME": "CYS",
    "OCS": "CYS", "SMC": "CYS", "KCX": "LYS", "MLY": "LYS", "M3L": "LYS",
    "ALY": "LYS", "LLP": "LYS", "HYP": "PRO", "PCA": "GLU", "CGU": "GLU",
    "FME": "MET", "MHO": "MET", "HIC": "HIS", "NEP": "HIS", "MLZ": "LYS",
    "AIB": "ALA", "DAL": "ALA", "SAR": "GLY",
}


def _chem_comp_parents(cats) -> dict[str, str]:
    """This file's modified-residue map from _chem_comp."""
    cc = cats.get("_chem_comp", {})
    out = {}
    for comp, parent in zip(cc.get("id", []), cc.get("mon_nstd_parent_comp_id", [])):
        parent = parent.strip().upper()
        if parent in ("?", ".", "") or "," in parent:
            continue
        if comp not in rc.restype_3to1 and parent in rc.restype_3to1:
            out[comp] = parent
    return out


def _tokenize(text: str) -> Iterator[str]:
    """CIF tokens: bare values, quoted strings, ;-delimited blocks and
    keywords (loop_, data_*, tags)."""
    lines = text.splitlines()
    i, n = 0, len(lines)
    while i < n:
        line = lines[i]
        if line.startswith(";"):
            block = [line[1:]]
            i += 1
            while i < n and not lines[i].startswith(";"):
                block.append(lines[i])
                i += 1
            i += 1  # the closing ';'
            yield "\n".join(block)
            continue
        pos, ln = 0, len(line)
        while pos < ln:
            c = line[pos]
            if c in " \t":
                pos += 1
                continue
            if c == "#":
                break
            if c in "'\"":
                # A quoted value ends at its quote followed by blank or EOL.
                end = pos + 1
                while end < ln:
                    if line[end] == c and (end + 1 == ln or line[end + 1] in " \t"):
                        break
                    end += 1
                yield line[pos + 1 : end]
                pos = end + 1
            else:
                end = pos
                while end < ln and line[end] not in " \t":
                    end += 1
                yield line[pos:end]
                pos = end
        i += 1


def parse_cif_categories_py(text: str) -> dict[str, dict[str, list[str]]]:
    """CIF text -> {category: {item: [values...]}} (loops and single rows)."""
    cats: dict[str, dict[str, list[str]]] = {}
    tokens = _tokenize(text)
    tok = next(tokens, None)
    while tok is not None:
        low = tok.lower()
        if low.startswith("data_") or low.startswith("global_"):
            tok = next(tokens, None)
            continue
        if low == "loop_":
            tags: list[str] = []
            tok = next(tokens, None)
            while tok is not None and tok.startswith("_"):
                tags.append(tok)
                tok = next(tokens, None)
            values: list[str] = []
            while tok is not None and not (
                tok.lower() in ("loop_", "stop_") or tok.startswith("_")
                or tok.lower().startswith("data_")
            ):
                values.append(tok)
                tok = next(tokens, None)
            if tags:
                ncol = len(tags)
                nrow = len(values) // ncol
                for ci, tag in enumerate(tags):
                    cat, _, item = tag.partition(".")
                    cats.setdefault(cat, {}).setdefault(item, []).extend(
                        values[ci::ncol][:nrow] if nrow else []
                    )
            continue
        if tok.startswith("_"):
            val = next(tokens, None)
            if val is None:
                break
            cat, _, item = tok.partition(".")
            cats.setdefault(cat, {}).setdefault(item, []).append(val)
            tok = next(tokens, None)
            continue
        tok = next(tokens, None)
    return cats


def parse_cif_categories(text: str) -> dict[str, dict[str, list[str]]]:
    """CIF text -> {category: {item: [values...]}}, through the native
    parser (``native/cif_tokenizer.cpp``, built at first use) where it
    loads, else :func:`parse_cif_categories_py`; the two give equal dicts."""
    cats = native.parse_cif_categories(text)
    return parse_cif_categories_py(text) if cats is None else cats


@dataclasses.dataclass
class MmcifHeader:
    resolution: float | None
    method: str | None
    release_date: str | None
    oligomeric_count: int | None
    oligomeric_details: str | None


@dataclasses.dataclass
class MmcifChain:
    chain_id: str  # author chain id
    aatype: np.ndarray  # [N]
    atom_positions: np.ndarray  # [N, 37, 3]
    atom_mask: np.ndarray  # [N, 37]
    residue_index: np.ndarray  # [N] author numbering
    b_factors: np.ndarray  # [N, 37]
    insertion_codes: list[str]

    @property
    def sequence(self) -> str:
        return "".join(rc.restypes[i] if 0 <= i < rc.restype_num else "X" for i in self.aatype)


@dataclasses.dataclass
class MmcifObject:
    file_id: str
    header: MmcifHeader
    chains: dict[str, MmcifChain]


def _get_first(cats, cat, item) -> str | None:
    vals = cats.get(cat, {}).get(item)
    if not vals:
        return None
    return None if vals[0] in ("?", ".") else vals[0]


def _parse_header(cats) -> MmcifHeader:
    resolution = None
    for cat, item in (
        ("_refine", "ls_d_res_high"),
        ("_em_3d_reconstruction", "resolution"),
        ("_reflns", "d_resolution_high"),
    ):
        v = _get_first(cats, cat, item)
        if v is not None:
            try:
                resolution = float(v)
                break
            except ValueError:
                continue
    dates = cats.get("_pdbx_audit_revision_history", {}).get("revision_date", [])
    dates = [d for d in dates if d not in ("?", ".")]
    oc = _get_first(cats, "_pdbx_struct_assembly", "oligomeric_count")
    return MmcifHeader(
        resolution=resolution,
        method=_get_first(cats, "_exptl", "method"),
        release_date=min(dates) if dates else None,
        oligomeric_count=int(oc) if oc and oc.isdigit() else None,
        oligomeric_details=_get_first(cats, "_pdbx_struct_assembly", "oligomeric_details"),
    )


def parse_mmcif(path: str | pathlib.Path, file_id: str | None = None) -> MmcifObject:
    """Parse an mmCIF file (``.cif`` or ``.cif.gz``) into per-chain atom37
    arrays: first model only, altloc '.' or 'A', protein residues only
    (modified residues mapped to their parents, other ATOM records to UNK)."""
    path = pathlib.Path(path)
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rt") as f:
        cats = parse_cif_categories(f.read())
    atom_site = cats.get("_atom_site")
    if not atom_site or "Cartn_x" not in atom_site:
        raise MmcifParsingError(f"no _atom_site records in {path}")
    mod_residues = {**_MODIFIED_RESIDUES, **_chem_comp_parents(cats)}

    def col(name, default=None):
        vals = atom_site.get(name)
        if vals is None:
            if default is None:
                raise MmcifParsingError(f"missing _atom_site.{name} in {path}")
            return [default] * len(atom_site["Cartn_x"])
        return vals

    group = col("group_PDB", "ATOM")
    atom_id = col("label_atom_id")
    alt_id = col("label_alt_id", ".")
    comp_id = col("label_comp_id")
    auth_asym = col("auth_asym_id") if "auth_asym_id" in atom_site else col("label_asym_id")
    auth_seq = col("auth_seq_id") if "auth_seq_id" in atom_site else col("label_seq_id")
    icode = col("pdbx_PDB_ins_code", "?")
    xs, ys, zs = col("Cartn_x"), col("Cartn_y"), col("Cartn_z")
    bs = col("B_iso_or_equiv", "0")
    model_num = col("pdbx_PDB_model_num", "1")

    first_model = model_num[0]
    chains: dict[str, dict] = {}
    for i in range(len(atom_id)):
        if model_num[i] != first_model or alt_id[i] not in (".", "A"):
            continue
        resname = mod_residues.get(comp_id[i], comp_id[i])
        if resname not in rc.restype_3to1:
            if group[i] == "ATOM" and resname != "UNK":
                resname = "UNK"
            elif resname != "UNK":
                continue
        name = atom_id[i]
        if name == "SE":  # selenium of MSE maps onto SD of MET
            name = "SD"
        if name not in rc.atom_order:
            continue
        residues = chains.setdefault(auth_asym[i], {})
        entry = residues.get((auth_seq[i], icode[i]))
        if entry is None:
            entry = {"resname": resname, "pos": np.zeros((37, 3)), "mask": np.zeros((37,)),
                     "b": np.zeros((37,))}
            residues[(auth_seq[i], icode[i])] = entry
        ai = rc.atom_order[name]
        entry["pos"][ai] = [float(xs[i]), float(ys[i]), float(zs[i])]
        entry["mask"][ai] = 1.0
        try:
            entry["b"][ai] = float(bs[i])
        except ValueError:
            pass

    parsed: dict[str, MmcifChain] = {}
    for cid, residues in chains.items():
        aatype, positions, masks, res_idx, bfs, icodes = [], [], [], [], [], []
        for (seq_id, ins), entry in residues.items():
            one = rc.restype_3to1.get(entry["resname"], "X")
            aatype.append(rc.restype_order.get(one, rc.unk_restype_index))
            positions.append(entry["pos"])
            masks.append(entry["mask"])
            try:
                res_idx.append(int(seq_id))
            except (TypeError, ValueError):
                res_idx.append(len(res_idx) + 1)
            bfs.append(entry["b"])
            icodes.append("" if ins in ("?", ".") else ins)
        if not aatype:
            continue
        parsed[cid] = MmcifChain(
            chain_id=cid,
            aatype=np.asarray(aatype, np.int64),
            atom_positions=np.asarray(positions, np.float64),
            atom_mask=np.asarray(masks, np.float64),
            residue_index=np.asarray(res_idx, np.int64),
            b_factors=np.asarray(bfs, np.float64),
            insertion_codes=icodes,
        )
    if not parsed:
        raise MmcifParsingError(f"no protein chains parsed from {path}")
    return MmcifObject(file_id=file_id or path.stem, header=_parse_header(cats), chains=parsed)
