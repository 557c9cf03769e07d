"""The port's restraint-jsonl CLI (framedipt_tpu_torch/tools/mpnn_helpers.py)
against the JAX package's (framedipt_tpu/tools/mpnn_helpers.py) on the CPU:
every subcommand's file equal, as text, to the JAX CLI's on PDBs written
from the fixture complexes (tests/data/cifs: five chains each) and on a
homodimer; then the deliberate divergences: a chain whose residue numbers
are not in increasing order (JAX takes the span from the first residue's
number and writes rows out of place), and a per-residue bias at a position
outside its chain (JAX writes the chain's last row)."""
import json
import pathlib

import numpy as np
import pytest

from framedipt_tpu.tools import mpnn_helpers as JH

from framedipt_tpu_torch.data import constants as rc
from framedipt_tpu_torch.data import features as feature_lib
from framedipt_tpu_torch.data.mmcif import parse_mmcif
from framedipt_tpu_torch.data.protein import Protein, from_pdb_string, to_pdb
from framedipt_tpu_torch.tools import mpnn_design as TD
from framedipt_tpu_torch.tools import mpnn_helpers as TH

CIF_DIR = pathlib.Path(__file__).parent / "data" / "cifs"


def _protein(raw: dict, keep: np.ndarray | None = None) -> Protein:
    keep = np.ones(len(raw["aatype"]), bool) if keep is None else keep
    return Protein(atom_positions=raw["atom_positions"][keep], atom_mask=raw["atom_mask"][keep],
                   aatype=raw["aatype"][keep], residue_index=raw["residue_index"][keep],
                   chain_index=raw["chain_index"][keep], b_factors=raw["b_factors"][keep])


@pytest.fixture(scope="module")
def pdbs(tmp_path_factory):
    """The fixture complexes as PDBs (chains A-E), and a homodimer of 1fyt's
    chain A (two copies 30 A apart)."""
    root = tmp_path_factory.mktemp("mpnn_helpers")
    complexes = root / "complexes"
    complexes.mkdir()
    for path in sorted(CIF_DIR.glob("*.cif")):
        raw = feature_lib.structure_to_features(parse_mmcif(path, file_id=path.stem[:4]))
        (complexes / f"{path.stem[:4]}.pdb").write_text(to_pdb(_protein(raw)))
        if path.stem.startswith("1fyt"):
            a = raw["chain_index"] == raw["chain_index"].min()
            mono = {k: raw[k][a] for k in raw if k not in ("min_modeled_idxs", "max_modeled_idxs")}
            dimer = {k: np.concatenate([v, v]) for k, v in mono.items()}
            dimer["chain_index"] = np.repeat([0, 1], a.sum())
            dimer["atom_positions"][a.sum():] += np.array([30.0, 0.0, 0.0])
            (root / "dimer.pdb").write_text(to_pdb(_protein(dimer)))
    pssm = root / "peptide.pssm"
    rng = np.random.default_rng(0)
    lines = ["header one", "header two"] + [
        f"{i + 1:3d} " + " ".join(f"{v:.3f}" for v in np.concatenate(
            [rng.normal(size=20), rng.dirichlet(np.ones(20))])) for i in range(13)]
    pssm.write_text("\n".join(lines) + "\n")
    return {"complexes": complexes, "dimer": root / "dimer.pdb", "pssm": pssm}


CASES = {
    "fixed": ["fixed-positions", "--chain_list", "A C", "--position_list", "1 2 5, 3 4"],
    "fixed_non_fixed": ["fixed-positions", "--chain_list", "D", "--position_list", "95 96 97",
                        "--specify_non_fixed"],
    "tied": ["tied-positions", "--chain_list", "A B", "--position_list", "1 2 3, 4 5 6"],
    "tied_pos_neg": ["tied-positions", "--chain_list", "D E", "--position_list", "10 11, 12 13",
                     "--pos_neg_chain_list", "D E", "--pos_neg_chain_betas", "1.0 -0.5"],
    "bias_aa": ["bias-aa", "--AA_list", "A C W", "--bias_list", "0.5 -1.0 2.0"],
    "bias_per_res": ["bias-per-res", "--chain", "A", "--positions", "1 3 10", "--AA_list", "G P",
                     "--bias", "-1.5"],
    "assign": ["assign-chains", "--chain_list", "D E"],
    "omit": ["omit-aa", "--chain", "B", "--position_list", "1 2 3, 40 41", "--AA_list", "GPL WC"],
    "parse": ["parse-chains"],
    "parse_ca": ["parse-chains", "--ca_only"],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_subcommand_writes_the_jax_clis_file(pdbs, tmp_path, case):
    args = ["--pdb_dir", str(pdbs["complexes"])]
    JH.main([*args, "--output_path", str(tmp_path / "jax.jsonl"), *CASES[case]])
    TH.main([*args, "--output_path", str(tmp_path / "port.jsonl"), *CASES[case]])
    assert (tmp_path / "port.jsonl").read_text() == (tmp_path / "jax.jsonl").read_text()


@pytest.mark.parametrize("extra", [[], ["--pos_neg_chain_list", "A B",
                                        "--pos_neg_chain_betas", "1.0 -0.5"]])
def test_homooligomer_ties_equal_jax(pdbs, tmp_path, extra):
    args = ["--pdb_path", str(pdbs["dimer"])]
    for pkg, out in ((JH, "jax.jsonl"), (TH, "port.jsonl")):
        pkg.main([*args, "--output_path", str(tmp_path / out), "tied-positions",
                  "--homooligomer", "1", *extra])
    got = (tmp_path / "port.jsonl").read_text()
    assert got == (tmp_path / "jax.jsonl").read_text()
    assert len(json.loads(got)["dimer"]) == 180


def test_pssm_equal_jax(pdbs, tmp_path):
    args = ["--pdb_path", str(pdbs["complexes"] / "1fyt.pdb")]
    flags = ["pssm", "--pssm_path", str(pdbs["pssm"]), "--chains", "C", "--coef", "0.7",
             "--temperature", "1.5"]
    JH.main([*args, "--output_path", str(tmp_path / "jax.jsonl"), *flags])
    TH.main([*args, "--output_path", str(tmp_path / "port.jsonl"), *flags])
    got = (tmp_path / "port.jsonl").read_text()
    assert got == (tmp_path / "jax.jsonl").read_text()
    entry = json.loads(got)["1fyt"]["C"]
    assert len(entry["pssm_coef"]) == 13
    np.testing.assert_allclose(np.asarray(entry["pssm_bias"]).sum(-1), 1.0, atol=1e-12)


def test_parsed_chains_drive_the_designer(pdbs, tmp_path):
    """The parse-chains file is the designer's ``--jsonl_path`` input: its
    chains come back as the PDB's, each spanning its residue numbers (a gap
    an X with masked coordinates)."""
    pdb = pdbs["complexes"] / "7t2d.pdb"
    TH.main(["--pdb_path", str(pdb), "--output_path", str(tmp_path / "parsed.jsonl"),
             "parse-chains"])
    entry = json.loads((tmp_path / "parsed.jsonl").read_text())
    name, letters, chains = TD.chains_from_parsed_entry(entry)
    prot = from_pdb_string(pdb.read_text())
    spans = [int(np.ptp(prot.residue_index[prot.chain_index == c])) + 1
             for c in np.unique(prot.chain_index)]
    assert name == "7t2d" and letters == list("ABCDE")
    assert [len(seq) for seq, _ in chains] == spans
    assert sum(np.isfinite(xyz).all(axis=(1, 2)).sum() for _, xyz in chains) == len(prot.aatype)


def test_numbering_out_of_order_diverges_from_jax(pdbs, tmp_path):
    """Chain A numbered 3, 4, 5, 1, 2, 6 in the file. JAX takes the span from
    the first and last residues' numbers (3..6, four rows) and writes
    residues 1 and 2 at negative indices, over the rows of 5 and 6; the
    port spans the smallest to the largest number (six rows, in number
    order)."""
    raw = feature_lib.structure_to_features(
        parse_mmcif(CIF_DIR / "1fyt-assembly1.cif", file_id="1fyt"))
    keep = np.zeros(len(raw["aatype"]), bool)
    keep[:6] = True
    prot = _protein(raw, keep)
    order = [2, 3, 4, 0, 1, 5]
    prot = Protein(atom_positions=prot.atom_positions[order], atom_mask=prot.atom_mask[order],
                   aatype=prot.aatype[order], residue_index=np.array([3, 4, 5, 1, 2, 6]),
                   chain_index=prot.chain_index[order], b_factors=prot.b_factors[order])
    pdb = tmp_path / "shuffled.pdb"
    pdb.write_text(to_pdb(prot))
    in_order = "".join(rc.restypes[a] for a in raw["aatype"][:6])
    got = TH.parse_pdb_entry(pdb)
    assert got["seq_chain_A"] == in_order
    ca = np.asarray(got["coords_chain_A"]["CA_chain_A"])
    np.testing.assert_allclose(ca, raw["atom_positions"][:6, 1], atol=1e-3)
    want = JH.parse_pdb_entry(pdb)
    assert len(want["seq_chain_A"]) == 4 and want["seq_chain_A"] != in_order[2:]


def test_bias_per_res_position_outside_the_chain_refused(pdbs, tmp_path):
    """Position 0 of chain C: JAX writes the bias into the chain's last row
    (index -1); the port refuses it, as both refuse an omit-aa position
    outside the chain."""
    args = ["--pdb_path", str(pdbs["complexes"] / "1fyt.pdb")]
    flags = ["bias-per-res", "--chain", "C", "--positions", "0", "--AA_list", "G", "--bias", "2"]
    JH.main([*args, "--output_path", str(tmp_path / "jax.jsonl"), *flags])
    rows = np.asarray(json.loads((tmp_path / "jax.jsonl").read_text())["1fyt"]["C"])
    assert rows[-1].max() == 2.0
    with pytest.raises(SystemExit, match="out of range"):
        TH.main([*args, "--output_path", str(tmp_path / "port.jsonl"), *flags])
    with pytest.raises(SystemExit, match="not in structure"):
        TH.main([*args, "--output_path", str(tmp_path / "port.jsonl"), "bias-per-res",
                 "--chain", "Z", "--positions", "1", "--AA_list", "G", "--bias", "2"])
