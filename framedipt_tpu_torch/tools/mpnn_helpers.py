"""The CLI that writes ProteinMPNN's restraint jsonl files from PDBs.

    python -m framedipt_tpu_torch.tools.mpnn_helpers (--pdb_dir=DIR | --pdb_path=FILE) \
        --output_path=FILE <subcommand> [flags]

Each subcommand writes the format of one of the reference ProteinMPNN's
helper scripts, which ``tools/mpnn_design.py`` (``--*_jsonl``) reads:

- ``fixed-positions`` (make_fixed_positions_dict.py; ``--specify_non_fixed``
  lists the designed positions instead);
- ``tied-positions`` (make_tied_positions_dict.py: explicit lists or
  ``--homooligomer 1``; make_pos_neg_tied_positions_dict.py with
  ``--pos_neg_chain_list`` / ``--pos_neg_chain_betas``: [[pos], [beta]]
  groups);
- ``bias-aa`` (make_bias_AA.py);
- ``bias-per-res`` (make_bias_per_res_dict.py, with its chain, positions,
  letters and bias as flags);
- ``assign-chains`` (assign_fixed_chains.py);
- ``omit-aa`` (make_omit_AA.py, its position and letter groups as flags);
- ``pssm`` (make_pssm_dict.py: a .pssm file's log-odds permuted into the
  21-letter alphabet, bias = softmax(log_odds - X_mask 1e8, T));
- ``parse-chains`` (parse_multiple_chains.py: PDBs -> the parsed jsonl that
  ``mpnn_design --jsonl_path`` reads; a gap in a chain's numbering becomes
  '-' residues with NaN coordinates).

The structure-keyed subcommands read only the chain letters and lengths of
each PDB. Lists take the reference's grammar: space-separated within a
chain, comma-separated between chains ("1 2 4, 3 5").
"""
from __future__ import annotations

import argparse
import json
import pathlib

import numpy as np

from framedipt_tpu_torch.data import constants as rc
from framedipt_tpu_torch.data.protein import from_pdb_string, int_to_chain_id
from framedipt_tpu_torch.model.mpnn import MPNN_ALPHABET as ALPHABET


def chain_lengths_from_pdb(pdb_path: str | pathlib.Path) -> dict[str, int]:
    """PDB -> {chain letter: residue count}, in chain order."""
    prot = from_pdb_string(pathlib.Path(pdb_path).read_text())
    return {int_to_chain_id(int(cid)): int((prot.chain_index == cid).sum())
            for cid in sorted(np.unique(prot.chain_index))}


def parse_pdb_entry(pdb_path: str | pathlib.Path, ca_only: bool = False) -> dict:
    """PDB -> one entry of parse_multiple_chains.py's jsonl: ``seq_chain_{X}``
    strings, ``coords_chain_{X}`` dicts of per-atom [L, 3] lists (NaN where
    an atom is missing), ``name``, ``num_of_chains`` and ``seq``. A chain
    spans its smallest to its largest residue number, whatever their order
    in the file; a number with no residue becomes '-' with NaN
    coordinates."""
    atom_names = ("CA",) if ca_only else ("N", "CA", "C", "O")
    atom_idx = [rc.atom_order[a] for a in atom_names]
    prot = from_pdb_string(pathlib.Path(pdb_path).read_text())
    entry: dict = {}
    concat_seq = ""
    n_chains = 0
    for cid in sorted(np.unique(prot.chain_index)):
        ltr = int_to_chain_id(int(cid))
        sel = np.where(prot.chain_index == cid)[0]
        res_num = prot.residue_index[sel]
        first = int(res_num.min())
        length = int(res_num.max()) - first + 1
        xyz = np.full((length, len(atom_idx), 3), np.nan)
        seq_chars = ["-"] * length
        for row, num, aa in zip(sel, res_num, prot.aatype[sel]):
            j = int(num) - first
            seq_chars[j] = rc.restypes[aa] if aa < len(rc.restypes) else "X"
            coords = prot.atom_positions[row, atom_idx].copy()
            coords[~(prot.atom_mask[row, atom_idx] > 0.5)] = np.nan
            xyz[j] = coords
        seq = "".join(seq_chars)
        entry[f"seq_chain_{ltr}"] = seq
        entry[f"coords_chain_{ltr}"] = {
            f"{a}_chain_{ltr}": xyz[:, k, :].tolist() for k, a in enumerate(atom_names)
        }
        concat_seq += seq
        n_chains += 1
    entry["name"] = pathlib.Path(pdb_path).stem
    entry["num_of_chains"] = n_chains
    entry["seq"] = concat_seq
    return entry


def _pdbs(pdb_dir: str, pdb_path: str) -> list[pathlib.Path]:
    if bool(pdb_dir) == bool(pdb_path):
        raise SystemExit("give exactly one of --pdb_dir / --pdb_path")
    if pdb_path:
        return [pathlib.Path(pdb_path)]
    paths = sorted(pathlib.Path(pdb_dir).glob("*.pdb"))
    if not paths:
        raise SystemExit(f"no .pdb files under {pdb_dir}")
    return paths


def _split_positions(position_list: str) -> list[list[int]]:
    return [
        [int(p) for p in one.split()] for one in position_list.split(",")
    ]


def make_fixed_positions(
    chains: dict[str, int], chain_list: list[str],
    positions: list[list[int]], specify_non_fixed: bool = False,
) -> dict[str, list[int]]:
    """make_fixed_positions_dict.py:17-41 for one structure: listed
    chains get their positions fixed (others []); with specify_non_fixed
    the listed positions are the DESIGNED ones and everything else —
    including every position of unlisted chains — is fixed."""
    out: dict[str, list[int]] = {}
    if not specify_non_fixed:
        for ltr, pos in zip(chain_list, positions):
            out[ltr] = pos
        for ltr in chains:
            out.setdefault(ltr, [])
    else:
        for ltr, ln in chains.items():
            everything = list(range(1, ln + 1))
            if ltr in chain_list:
                designed = set(positions[chain_list.index(ltr)])
                out[ltr] = sorted(set(everything) - designed)
            else:
                out[ltr] = everything
    return out


def make_tied_positions(
    chains: dict[str, int],
    chain_list: list[str] | None = None,
    positions: list[list[int]] | None = None,
    homooligomer: bool = False,
    betas: dict[str, float] | None = None,
) -> list[dict]:
    """make_tied_positions_dict.py:16-43 / make_pos_neg_…:16-54 for one
    structure. Explicit mode ties positions[j][i] across chain_list;
    homooligomer mode ties residue i across ALL chains (first chain's
    length). ``betas`` switches to the weighted [[pos],[beta]] form
    (pos/neg design); chains missing from it get weight 1.0."""
    groups: list[dict] = []
    if homooligomer:
        letters = sorted(chains)
        length = chains[letters[0]]
        if any(chains[ltr] != length for ltr in letters):
            # upstream silently emits out-of-range ties here; fail loud
            raise SystemExit(
                f"homooligomer ties need equal-length chains, got {chains}"
            )
        for i in range(1, length + 1):
            if betas is None:
                groups.append({ltr: [i] for ltr in letters})
            else:
                groups.append({
                    ltr: [[i], [float(betas.get(ltr, 1.0))]]
                    for ltr in letters
                })
    else:
        if chain_list is None or positions is None:
            raise SystemExit("tied-positions needs --chain_list and --position_list, "
                             "or --homooligomer 1")
        for i in range(len(positions[0])):
            if betas is None:
                groups.append({
                    ltr: [positions[j][i]]
                    for j, ltr in enumerate(chain_list)
                })
            else:
                groups.append({
                    ltr: [[positions[j][i]], [float(betas.get(ltr, 1.0))]]
                    for j, ltr in enumerate(chain_list)
                })
    return groups


def make_bias_per_res(
    chains: dict[str, int], chain: str, positions: list[int],
    aa_list: list[str], bias: float,
) -> dict[str, list]:
    """Parameterized make_bias_per_res_dict.py: bias ``aa_list`` by
    ``bias`` at the given 1-based positions of ``chain``; every chain
    gets a full zero array (the consumer indexes all chains). A chain not
    in the structure or a position outside the chain is refused."""
    if chain not in chains:
        raise SystemExit(f"chain {chain!r} not in structure ({chains})")
    bad = [p for p in positions if not 1 <= p <= chains[chain]]
    if bad:
        raise SystemExit(f"bias-per-res positions {bad} out of range for chain {chain!r} "
                         f"(length {chains[chain]})")
    out = {}
    for ltr, ln in chains.items():
        arr = np.zeros((ln, len(ALPHABET)))
        if ltr == chain:
            for pos in positions:
                for aa in aa_list:
                    arr[pos - 1, ALPHABET.index(aa)] = bias
        out[ltr] = arr.tolist()
    return out


def make_omit_aa(
    chains: dict[str, int], chain: str,
    position_groups: list[list[int]], aa_groups: list[str],
) -> dict[str, list]:
    """Parameterized make_omit_AA.py: per-position forbidden-letter
    groups [[positions], "LETTERS"] on ``chain``; every other chain gets
    [] (the consumer, omit_aa_mask_from_dict, reads the same format the
    reference example emits — make_omit_AA.py:17-29)."""
    if len(position_groups) != len(aa_groups):
        raise SystemExit("--position_list groups != --AA_list groups")
    if chain not in chains:
        raise SystemExit(f"chain {chain!r} not in structure ({chains})")
    ln = chains[chain]
    for positions in position_groups:
        bad = [p for p in positions if not 1 <= p <= ln]
        if bad:
            raise SystemExit(
                f"omit-aa positions {bad} out of range for chain "
                f"{chain!r} (length {ln})"
            )
    out: dict[str, list] = {ltr: [] for ltr in chains}
    out[chain] = [
        [positions, aas]
        for positions, aas in zip(position_groups, aa_groups)
    ]
    return out


# make_pssm_dict.py's alphabets: .pssm columns arrive in the standard
# substitution-matrix residue order and are permuted into the MPNN
# 21-letter alphabet (X column left empty).
PSSM_INPUT_ALPHABET = "ARNDCQEGHILKMFPSTWYV"


def parse_pssm_file(path: str | pathlib.Path) -> np.ndarray:
    """make_pssm_dict.py:14-25's .pssm text parse: skip 2 header lines,
    drop each remaining line's first 4 characters, split the rest into
    floats -> [L, >=40] (cols 0:20 log-odds, 20:40 probabilities, both
    in PSSM_INPUT_ALPHABET order)."""
    lines = pathlib.Path(path).read_text().splitlines()[2:]
    rows = []
    for line in lines:
        if not line.strip():
            continue
        vals = [float(tok) for tok in line[4:].split()]
        if len(vals) < 40:
            raise SystemExit(
                f"{path}: pssm row has {len(vals)} columns, need >=40"
            )
        rows.append(vals[:40])
    if not rows:
        raise SystemExit(f"{path}: no pssm rows after the 2 header lines")
    return np.asarray(rows, np.float64)


def make_pssm_entry(
    pssm_rows: np.ndarray, length: int,
    coef: float = 1.0, temperature: float = 1.0,
) -> dict[str, list]:
    """One chain's pssm dict (make_pssm_dict.py:28-57): permute the 20
    input columns into the 21-letter MPNN alphabet, bias =
    softmax(log_odds - X_mask*1e8, T) so X gets ~0 probability, coef =
    ones * coef."""
    if len(pssm_rows) != length:
        raise SystemExit(
            f"pssm has {len(pssm_rows)} rows but chain has "
            f"{length} residues"
        )
    perm = np.zeros((20, len(ALPHABET)))
    for i, letter in enumerate(PSSM_INPUT_ALPHABET):
        perm[i, ALPHABET.index(letter)] = 1.0
    log_odds = pssm_rows[:, :20] @ perm
    x_mask = np.concatenate([np.zeros(20), np.ones(1)])
    z = (log_odds - x_mask[None, :] * 1e8) / temperature
    z -= z.max(axis=-1, keepdims=True)
    e = np.exp(z)
    bias = e / e.sum(axis=-1, keepdims=True)
    return {
        "pssm_coef": (np.ones(length) * coef).tolist(),
        "pssm_bias": bias.tolist(),
        "pssm_log_odds": log_odds.tolist(),
    }


def _write(path: str, obj: dict) -> None:
    pathlib.Path(path).write_text(json.dumps(obj) + "\n")
    print(path)


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(
        description="Generate MPNN restraint jsonl dicts from PDBs "
                    "(helper_scripts equivalents)"
    )
    p.add_argument("--pdb_dir", type=str, default="")
    p.add_argument("--pdb_path", type=str, default="")
    p.add_argument("--output_path", type=str, required=True)
    sub = p.add_subparsers(dest="cmd", required=True)

    fp = sub.add_parser("fixed-positions",
                        help="make_fixed_positions_dict equivalent")
    fp.add_argument("--chain_list", type=str, required=True,
                    help="space-separated chains, e.g. 'A B'")
    fp.add_argument("--position_list", type=str, required=True,
                    help="per-chain 1-based positions, e.g. '1 2 5, 3 4'")
    fp.add_argument("--specify_non_fixed", action="store_true")

    tp = sub.add_parser("tied-positions",
                        help="make_[pos_neg_]tied_positions_dict equivalent")
    tp.add_argument("--chain_list", type=str, default="")
    tp.add_argument("--position_list", type=str, default="")
    tp.add_argument("--homooligomer", type=int, default=0)
    tp.add_argument("--pos_neg_chain_list", type=str, default="",
                    help="chains for weighted ties, e.g. 'A B'")
    tp.add_argument("--pos_neg_chain_betas", type=str, default="",
                    help="weights per chain, e.g. '1.0 -0.5'")

    ba = sub.add_parser("bias-aa", help="make_bias_AA equivalent")
    ba.add_argument("--AA_list", type=str, required=True)
    ba.add_argument("--bias_list", type=str, required=True)

    br = sub.add_parser("bias-per-res",
                        help="make_bias_per_res_dict (parameterized)")
    br.add_argument("--chain", type=str, required=True)
    br.add_argument("--positions", type=str, required=True,
                    help="space-separated 1-based positions")
    br.add_argument("--AA_list", type=str, required=True)
    br.add_argument("--bias", type=float, required=True)

    ac = sub.add_parser("assign-chains",
                        help="assign_fixed_chains equivalent")
    ac.add_argument("--chain_list", type=str, required=True,
                    help="chains to design; the rest are fixed")

    oa = sub.add_parser("omit-aa",
                        help="make_omit_AA (parameterized): per-position "
                             "forbidden letters on one chain")
    oa.add_argument("--chain", type=str, required=True)
    oa.add_argument("--position_list", type=str, required=True,
                    help="1-based position groups, e.g. '1 2 3, 40 41'")
    oa.add_argument("--AA_list", type=str, required=True,
                    help="forbidden letters per group, e.g. 'GPL WC'")

    ps = sub.add_parser("pssm",
                        help="make_pssm_dict equivalent: .pssm file -> "
                             "--pssm_jsonl input")
    ps.add_argument("--pssm_path", type=str, required=True)
    ps.add_argument("--chains", type=str, default="",
                    help="chains the pssm applies to (default: all)")
    ps.add_argument("--coef", type=float, default=1.0,
                    help="pssm_coef value (attention weight 0..1)")
    ps.add_argument("--temperature", type=float, default=1.0,
                    help="softmax temperature for pssm_bias")

    pc = sub.add_parser("parse-chains",
                        help="parse_multiple_chains equivalent: PDBs -> "
                             "parsed jsonl dataset (--jsonl_path input "
                             "for mpnn_design)")
    pc.add_argument("--ca_only", action="store_true")

    args = p.parse_args(argv)

    if args.cmd == "parse-chains":  # one entry per line, not name-keyed
        lines = [
            json.dumps(parse_pdb_entry(pdb, ca_only=args.ca_only))
            for pdb in _pdbs(args.pdb_dir, args.pdb_path)
        ]
        pathlib.Path(args.output_path).write_text("\n".join(lines) + "\n")
        print(args.output_path)
        return

    if args.cmd == "bias-aa":  # structure-independent
        aas = args.AA_list.split()
        biases = [float(b) for b in args.bias_list.split()]
        if len(aas) != len(biases):
            raise SystemExit("--AA_list and --bias_list lengths differ")
        _write(args.output_path, dict(zip(aas, biases)))
        return

    my_dict: dict = {}
    for pdb in _pdbs(args.pdb_dir, args.pdb_path):
        chains = chain_lengths_from_pdb(pdb)
        name = pdb.stem
        if args.cmd == "fixed-positions":
            my_dict[name] = make_fixed_positions(
                chains, args.chain_list.split(),
                _split_positions(args.position_list),
                specify_non_fixed=args.specify_non_fixed,
            )
        elif args.cmd == "tied-positions":
            betas = None
            if args.pos_neg_chain_list:
                betas = dict(zip(
                    args.pos_neg_chain_list.split(),
                    [float(b) for b in args.pos_neg_chain_betas.split()],
                ))
            my_dict[name] = make_tied_positions(
                chains,
                chain_list=(args.chain_list.split() or None),
                positions=(
                    _split_positions(args.position_list)
                    if args.position_list else None
                ),
                homooligomer=bool(args.homooligomer),
                betas=betas,
            )
        elif args.cmd == "bias-per-res":
            my_dict[name] = make_bias_per_res(
                chains, args.chain, [int(x) for x in args.positions.split()],
                args.AA_list.split(), args.bias,
            )
        elif args.cmd == "omit-aa":
            my_dict[name] = make_omit_aa(
                chains, args.chain,
                _split_positions(args.position_list),
                args.AA_list.split(),
            )
        elif args.cmd == "pssm":
            rows = parse_pssm_file(args.pssm_path)
            apply_to = args.chains.split() or list(chains)
            my_dict[name] = {
                ltr: make_pssm_entry(
                    rows, chains[ltr],
                    coef=args.coef, temperature=args.temperature,
                )
                for ltr in apply_to
            }
        elif args.cmd == "assign-chains":
            designed = args.chain_list.split()
            fixed = [ltr for ltr in chains if ltr not in designed]
            my_dict[name] = (designed, fixed)
    _write(args.output_path, my_dict)


if __name__ == "__main__":
    main()
