"""Protein structure container + PDB text IO.

Same behaviour as the JAX package's ``data/protein.py`` (``Protein``,
``from_pdb_string``, ``to_pdb``, ``prots_to_pdb``, chain-id mapping,
``format_models_native``), kept as an own copy so the port imports nothing of
that package. ``to_pdb`` is the pure-Python writer; ``format_models_native``
formats whole trajectories in C++ (``native/pdb_writer.cpp``) to the same
bytes.
"""
from __future__ import annotations

import ctypes
import dataclasses
import io

import numpy as np

from framedipt_tpu_torch.data import constants as rc

PDB_CHAIN_IDS = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789"
PDB_MAX_CHAINS = len(PDB_CHAIN_IDS)


@dataclasses.dataclass
class Protein:
    """atom37-convention protein structure."""

    atom_positions: np.ndarray  # [N, 37, 3]
    aatype: np.ndarray  # [N] 0-20
    atom_mask: np.ndarray  # [N, 37]
    residue_index: np.ndarray  # [N] author numbering
    chain_index: np.ndarray  # [N] int chain ids
    b_factors: np.ndarray  # [N, 37]

    def __post_init__(self):
        if len(np.unique(self.chain_index)) > PDB_MAX_CHAINS:
            raise ValueError(
                f"Cannot handle more than {PDB_MAX_CHAINS} chains."
            )


def chain_id_to_int(chain_id: str) -> int:
    """Author chain id -> int, as a base-26 'spreadsheet column' name:
    'A'->0, 'Z'->25, 'AA'->26."""
    value = 0
    for c in chain_id.upper():
        if not ("A" <= c <= "Z"):
            return hash(chain_id) % 10_000 + PDB_MAX_CHAINS
        value = value * 26 + (ord(c) - ord("A") + 1)
    return value - 1


def int_to_chain_id(idx: int) -> str:
    """Inverse of chain_id_to_int for single-letter range, then AA, AB.."""
    idx = int(idx)
    out = ""
    idx += 1
    while idx > 0:
        idx, rem = divmod(idx - 1, 26)
        out = chr(ord("A") + rem) + out
    return out


def from_pdb_string(pdb_str: str, chain_ids: list[str] | None = None) -> Protein:
    """Parse ATOM records of (the first model of) a PDB file."""
    positions, masks, aatypes, res_indices, chain_indices, b_factors = (
        [], [], [], [], [], [],
    )
    cur_key = None  # (chain, resnum, icode)
    cur_pos = cur_mask = cur_b = None

    def flush():
        if cur_key is not None:
            positions.append(cur_pos)
            masks.append(cur_mask)
            b_factors.append(cur_b)

    in_model = True
    for line in io.StringIO(pdb_str):
        rec = line[:6]
        if rec == "ENDMDL":
            in_model = False  # only first model
        if not in_model or rec not in ("ATOM  ", "HETATM"):
            continue
        resname = line[17:20].strip()
        if resname not in rc.restype_3to1 and rec == "HETATM":
            continue
        chain_id = line[21]
        if chain_ids is not None and chain_id not in chain_ids:
            continue
        atom_name = line[12:16].strip()
        if atom_name not in rc.atom_order:
            continue
        altloc = line[16]
        if altloc not in (" ", "A"):
            continue
        resnum = int(line[22:26])
        icode = line[26]
        key = (chain_id, resnum, icode)
        if key != cur_key:
            flush()
            cur_key = key
            cur_pos = np.zeros((37, 3))
            cur_mask = np.zeros((37,))
            cur_b = np.zeros((37,))
            one = rc.restype_3to1.get(resname, "X")
            aatypes.append(rc.restype_order.get(one, rc.unk_restype_index))
            res_indices.append(resnum)
            chain_indices.append(chain_id_to_int(chain_id))
        ai = rc.atom_order[atom_name]
        cur_pos[ai] = [float(line[30:38]), float(line[38:46]), float(line[46:54])]
        cur_mask[ai] = 1.0
        try:
            cur_b[ai] = float(line[60:66])
        except ValueError:
            pass
    flush()

    return Protein(
        atom_positions=np.asarray(positions, np.float64),
        aatype=np.asarray(aatypes, np.int64),
        atom_mask=np.asarray(masks, np.float64),
        residue_index=np.asarray(res_indices, np.int64),
        chain_index=np.asarray(chain_indices, np.int64),
        b_factors=np.asarray(b_factors, np.float64),
    )


def _chain_letter(i: int, sorted_ids: list[int]) -> str:
    return PDB_CHAIN_IDS[sorted_ids.index(i) % PDB_MAX_CHAINS]


def to_pdb(prot: Protein, model: int = 1, add_end: bool = True) -> str:
    """Serialize to PDB text (one MODEL). Multi-model trajectories: call per
    model with add_end=False and join, then append 'END'."""
    lines: list[str] = [f"MODEL     {model:4d}"]
    atom_index = 1
    sorted_chains = sorted(set(int(c) for c in prot.chain_index))
    n = prot.aatype.shape[0]
    last_chain = None
    for i in range(n):
        chain_int = int(prot.chain_index[i])
        chain = _chain_letter(chain_int, sorted_chains)
        if last_chain is not None and chain != last_chain:
            lines.append(
                f"TER   {atom_index:>5}      "
                f"{_res3(prot.aatype[i - 1]):>3} {last_chain}"
                f"{int(prot.residue_index[i - 1]):>4}"
            )
            atom_index += 1
        last_chain = chain
        res3 = _res3(prot.aatype[i])
        for ai, atom_name in enumerate(rc.atom_types):
            if prot.atom_mask[i, ai] < 0.5:
                continue
            pos = prot.atom_positions[i, ai]
            b = prot.b_factors[i, ai]
            name = f" {atom_name:<3}" if len(atom_name) < 4 else atom_name
            element = atom_name[0]
            lines.append(
                f"ATOM  {atom_index:>5} {name}{'':1}{res3:>3} {chain}"
                f"{int(prot.residue_index[i]):>4}    "
                f"{pos[0]:>8.3f}{pos[1]:>8.3f}{pos[2]:>8.3f}"
                f"{1.0:>6.2f}{b:>6.2f}          {element:>2}"
            )
            atom_index += 1
    if n:
        lines.append(
            f"TER   {atom_index:>5}      {_res3(prot.aatype[-1]):>3} "
            f"{last_chain}{int(prot.residue_index[-1]):>4}"
        )
    lines.append("ENDMDL")
    if add_end:
        lines.append("END")
    return "\n".join(lines) + "\n"


def _res3(aatype: int) -> str:
    i = int(aatype)
    if 0 <= i < rc.restype_num:
        return rc.restype_1to3[rc.restypes[i]]
    return "UNK"


def prots_to_pdb(prots: list[Protein]) -> str:
    """Multi-model PDB (trajectory writer)."""
    parts = [to_pdb(p, model=i + 1, add_end=False) for i, p in enumerate(prots)]
    return "".join(parts) + "END\n"


def format_models_native(
    pos4: np.ndarray,  # [T, N, 37, 3]
    aatype: np.ndarray,
    residue_index: np.ndarray,
    chain_index: np.ndarray,
    b_factors: np.ndarray,  # [N, 37]
    start_model: int = 1,
) -> str | None:
    """All MODEL blocks of a trajectory (no END record) from the native
    writer, byte-equal to ``to_pdb(..., add_end=False)`` of each frame with
    its atoms present iff sum(|xyz|) > 1e-7; None when the library is not
    there (the callers then take ``to_pdb``). Raises ValueError for more than
    PDB_MAX_CHAINS chains, as ``Protein`` does."""
    from framedipt_tpu_torch import native

    sorted_chains = sorted(set(int(c) for c in chain_index))
    if len(sorted_chains) > PDB_MAX_CHAINS:
        raise ValueError(f"Cannot handle more than {PDB_MAX_CHAINS} chains.")
    lib = native.load_pdb_writer()
    if lib is None:
        return None
    pos4 = np.ascontiguousarray(pos4, np.float64)
    t, n = pos4.shape[0], pos4.shape[1]
    res3 = b"".join(_res3(int(a)).encode("ascii") for a in aatype)
    chains = bytes(ord(_chain_letter(int(c), sorted_chains)) for c in chain_index)
    resi = np.ascontiguousarray(residue_index, np.int64)
    bfac = np.ascontiguousarray(b_factors, np.float64)
    atom_fields = "".join(f" {a:<3}" if len(a) < 4 else a for a in rc.atom_types).encode("ascii")
    elem_fields = "".join(f"{a[0]:>2}" for a in rc.atom_types).encode("ascii")
    if resi.shape != (n,) or bfac.shape != (n, 37) or len(res3) != 3 * n or len(chains) != n:
        raise ValueError(f"format_models_native: per-residue inputs do not match N={n}")
    ptr = ctypes.c_void_p
    need = lib.fdt_pdb_models_bytes(pos4.ctypes.data, t, n, chains)
    while True:
        buf = ctypes.create_string_buffer(max(need, 1))
        got = lib.fdt_format_models(
            pos4.ctypes.data, t, n, res3, resi.ctypes.data, chains, bfac.ctypes.data,
            atom_fields, elem_fields, start_model, ptr(ctypes.addressof(buf)), need)
        if got <= need:
            return ctypes.string_at(buf, got).decode("ascii")
        need = got  # a field wider than its column: format again at the exact size
