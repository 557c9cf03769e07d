"""The port's structure filters and metrics against the JAX package's on the
CPU (numpy on both sides): ``data/align.py`` (``needleman_wunsch``,
``get_shared_residues``, ``align`` with ``exclude_region``),
``data/filters.py``, ``analysis/violations.py:violation_metrics`` and
``analysis/metrics.py:protein_metrics``, within 1e-6, on chains of the
fixture complexes (tests/data/cifs) and on perturbed copies: a moved loop,
a clash, a broken bond, residues deleted and mutated."""
import copy
import pathlib

import numpy as np
import pytest

from framedipt_tpu.analysis import metrics as JM
from framedipt_tpu.analysis import violations as JV
from framedipt_tpu.data import align as JA
from framedipt_tpu.data import filters as JF
from framedipt_tpu.data.protein import Protein as JProtein

from framedipt_tpu_torch.analysis import metrics as TM
from framedipt_tpu_torch.analysis import violations as TV
from framedipt_tpu_torch.data import align as TA
from framedipt_tpu_torch.data import constants as rc
from framedipt_tpu_torch.data import features as feature_lib
from framedipt_tpu_torch.data import filters as TF
from framedipt_tpu_torch.data.mmcif import parse_mmcif
from framedipt_tpu_torch.data.protein import Protein

CIF_DIR = pathlib.Path(__file__).parent / "data" / "cifs"
TOL = 1e-6
LOOP = (95, 106)  # a loop of the TCR alpha chain, residues [95, 106)


@pytest.fixture(scope="module")
def chains() -> dict[str, Protein]:
    """1fyt's TCR alpha chain (D) and 7t2d's (D), as atom37 proteins."""
    out = {}
    for pdb in ("1fyt", "7t2d"):
        raw = feature_lib.structure_to_features(
            parse_mmcif(CIF_DIR / f"{pdb}-assembly1.cif", file_id=pdb))
        sel = raw["chain_index"] == np.unique(raw["chain_index"])[3]
        out[pdb] = Protein(atom_positions=raw["atom_positions"][sel],
                           atom_mask=raw["atom_mask"][sel], aatype=raw["aatype"][sel],
                           residue_index=raw["residue_index"][sel],
                           chain_index=raw["chain_index"][sel], b_factors=raw["b_factors"][sel])
    return out


def _jax(p: Protein) -> JProtein:
    return JProtein(atom_positions=p.atom_positions, aatype=p.aatype, atom_mask=p.atom_mask,
                    residue_index=p.residue_index, chain_index=p.chain_index,
                    b_factors=p.b_factors)


def _moved(p: Protein, rot_deg: float = 40.0, shift=(5.0, -3.0, 12.0)) -> Protein:
    a = np.deg2rad(rot_deg)
    r = np.array([[np.cos(a), -np.sin(a), 0.0], [np.sin(a), np.cos(a), 0.0], [0.0, 0.0, 1.0]])
    out = copy.deepcopy(p)
    out.atom_positions = (p.atom_positions @ r.T + np.array(shift)) * p.atom_mask[..., None]
    return out


def _perturbed(p: Protein) -> dict[str, np.ndarray]:
    """atom37 coordinates: as is, a loop moved 4 A, a residue pushed into
    its neighbour (a clash), the chain broken after residue 60 (the rest
    moved 2.5 A)."""
    pos = p.atom_positions * p.atom_mask[..., None]
    loop = pos.copy()
    loop[LOOP[0]:LOOP[1]] += np.array([4.0, 0.0, -1.0]) * p.atom_mask[LOOP[0]:LOOP[1], :, None]
    clash = pos.copy()
    clash[40] = (pos[40] + 0.8 * (pos[41, 1] - pos[40, 1])) * p.atom_mask[40][:, None]
    broken = pos.copy()
    broken[61:] += np.array([2.5, 0.0, 0.0]) * p.atom_mask[61:, :, None]
    return {"as_is": pos, "loop": loop, "clash": clash, "broken": broken}


def test_filters_equal_jax():
    for name in [*rc.atom_types, "H", "HA", "XX", ""]:
        assert (TF.is_backbone(name), TF.is_ca(name), TF.is_heavy(name)) == \
            (JF.is_backbone(name), JF.is_ca(name), JF.is_heavy(name)), name


def test_needleman_wunsch_and_shared_residues_equal_jax(chains):
    a, b = chains["1fyt"], chains["7t2d"]
    seq_a, seq_b = rc.aatype_to_sequence(a.aatype), rc.aatype_to_sequence(b.aatype)
    for s1, s2 in ((seq_a, seq_b), (seq_a[10:90], seq_a), ("", "ACD"), ("GAT", "GCAT")):
        assert TA.needleman_wunsch(s1, s2) == JA.needleman_wunsch(s1, s2)
    got = TA.get_shared_residues(a, b)
    want = JA.get_shared_residues(_jax(a), _jax(b))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert len(got[0]) > 150


@pytest.mark.parametrize("case", ["moved", "loop_excluded", "deleted_mutated", "other_tcr",
                                  "backbone_atoms"])
def test_align_equals_jax(chains, case):
    target = chains["1fyt"]
    kwargs = {}
    mobile = _moved(target)
    if case == "loop_excluded":
        mobile.atom_positions[LOOP[0]:LOOP[1]] += 3.0 * mobile.atom_mask[LOOP[0]:LOOP[1], :, None]
        kwargs = {"exclude_region": (LOOP[0], LOOP[1] - 1)}
    elif case == "deleted_mutated":
        keep = np.ones(len(target.aatype), bool)
        keep[[5, 6, 7, 120]] = False
        mobile = Protein(atom_positions=mobile.atom_positions[keep],
                         atom_mask=mobile.atom_mask[keep], aatype=mobile.aatype[keep].copy(),
                         residue_index=mobile.residue_index[keep],
                         chain_index=mobile.chain_index[keep], b_factors=mobile.b_factors[keep])
        mobile.aatype[[30, 31, 100]] = (mobile.aatype[[30, 31, 100]] + 3) % 20
    elif case == "other_tcr":
        mobile = _moved(chains["7t2d"], 100.0)
    elif case == "backbone_atoms":
        kwargs = {"atoms": ("N", "CA", "C", "O"), "exclude_region": (0, 20)}
    got, rmsd = TA.align(mobile, target, **kwargs)
    want, want_rmsd = JA.align(_jax(mobile), _jax(target), **kwargs)
    np.testing.assert_allclose(got.atom_positions, want.atom_positions, atol=TOL)
    np.testing.assert_allclose(rmsd, want_rmsd, atol=TOL)
    if case in ("moved", "backbone_atoms"):
        assert rmsd < 1e-3  # a rigid copy comes back onto the target
        np.testing.assert_allclose(got.atom_positions, target.atom_positions
                                   * target.atom_mask[..., None], atol=1e-3)


def test_align_refuses_fewer_than_three_shared_atoms(chains):
    target = chains["1fyt"]
    for pkg, prot in ((TA, target), (JA, _jax(target))):
        with pytest.raises(ValueError, match="fewer than 3"):
            pkg.align(prot, prot, exclude_region=(0, len(target.aatype) - 2))


@pytest.mark.parametrize("pdb", ["1fyt", "7t2d"])
def test_violation_metrics_equal_jax(chains, pdb):
    p = chains[pdb]
    results = {}
    for case, pos in _perturbed(p).items():
        got = TV.violation_metrics(pos, p.atom_mask, p.aatype)
        want = JV.violation_metrics(pos, p.atom_mask, p.aatype)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=TOL, err_msg=f"{case} {k}")
        results[case] = got
    assert results["clash"]["clashes_mean_loss"] > results["as_is"]["clashes_mean_loss"]
    assert results["broken"]["bonds_c_n_loss_mean"] > results["as_is"]["bonds_c_n_loss_mean"]
    one = TV.violation_metrics(p.atom_positions[:1], p.atom_mask[:1], p.aatype[:1])
    assert one == JV.violation_metrics(p.atom_positions[:1], p.atom_mask[:1], p.aatype[:1])


@pytest.mark.parametrize("pdb", ["1fyt", "7t2d"])
def test_protein_metrics_equal_jax(chains, pdb):
    p = chains[pdb]
    gt = p.atom_positions * p.atom_mask[..., None]
    diffuse = np.zeros(len(p.aatype))
    diffuse[LOOP[0]:LOOP[1]] = 1.0
    for case, pos in _perturbed(p).items():
        kwargs = dict(pdb_path=None, atom37_pos=pos, gt_atom37_pos=gt, gt_aatype=p.aatype,
                      diffuse_mask=diffuse)
        got, want = TM.protein_metrics(**kwargs), JM.protein_metrics(**kwargs)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=TOL, err_msg=f"{case} {k}")
        if case == "as_is":
            assert got["tm_score"] == pytest.approx(1.0)
