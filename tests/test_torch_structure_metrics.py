"""The port's structure comparison (framedipt_tpu_torch/analysis/metrics.py)
against the JAX package's (framedipt_tpu/analysis/metrics.py), numpy on
both sides: ``rigid_transform_3d`` (a reflection included),
``calc_aligned_rmsd``, ``calc_rmsd``, ``_tm_d0``, ``_tm_from_distances`` and
``calc_tm_score``, on random CA clouds (a moved, noised copy and an
unrelated cloud) and on CA traces of the fixture structures, within 1e-5."""
import pathlib

import numpy as np
import pytest

from framedipt_tpu.analysis import metrics as J

from framedipt_tpu_torch.analysis import metrics as T
from framedipt_tpu_torch.data import features as feature_lib
from framedipt_tpu_torch.data.mmcif import parse_mmcif

CIF_DIR = pathlib.Path(__file__).parent / "data" / "cifs"
TOL = 1e-5


def _rotation(rng) -> np.ndarray:
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))
    return q if np.linalg.det(q) > 0 else -q


def _pairs():
    """(label, pos_1, pos_2): random clouds and fixture chains."""
    rng = np.random.default_rng(0)
    out = []
    for n in (3, 21, 60):
        a = rng.normal(size=(n, 3)) * 10
        moved = a @ _rotation(rng).T + rng.normal(size=3) * 20 + rng.normal(size=(n, 3)) * 1.5
        out += [(f"moved {n}", moved, a), (f"unrelated {n}", rng.normal(size=(n, 3)) * 10, a),
                (f"mirror {n}", a * np.array([-1.0, 1.0, 1.0]), a)]
    cas = []
    for name in ("1fyt", "7t2d"):
        raw = feature_lib.structure_to_features(parse_mmcif(CIF_DIR / f"{name}-assembly1.cif"))
        first = raw["chain_index"] == raw["chain_index"][0]
        cas.append(raw["atom_positions"][first, 1].astype(np.float64))
    n = min(len(c) for c in cas)
    out.append(("1fyt vs 7t2d chain 1", cas[0][:n], cas[1][:n]))
    out.append(("1fyt chain 1 vs itself moved", cas[0] @ _rotation(rng).T + 5.0, cas[0]))
    return out


PAIRS = _pairs()


@pytest.mark.parametrize("label,pos_1,pos_2", PAIRS, ids=[p[0] for p in PAIRS])
def test_metrics_match_jax(label, pos_1, pos_2):
    got, want = T.rigid_transform_3d(pos_1, pos_2), J.rigid_transform_3d(pos_1, pos_2)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL)
    assert got[3] == want[3]
    assert T.calc_aligned_rmsd(pos_1, pos_2) == pytest.approx(
        J.calc_aligned_rmsd(pos_1, pos_2), abs=TOL)
    assert T.calc_rmsd(pos_1, pos_2) == pytest.approx(J.calc_rmsd(pos_1, pos_2), abs=TOL)
    np.testing.assert_allclose(T.calc_tm_score(pos_1, pos_2), J.calc_tm_score(pos_1, pos_2),
                               atol=TOL, rtol=0)
    if label.startswith("mirror"):
        assert got[3]  # a reflection was corrected
    if label.endswith("moved"):
        assert T.calc_tm_score(pos_1, pos_2)[0] == pytest.approx(1.0, abs=1e-9)
        assert T.calc_aligned_rmsd(pos_1, pos_2) < 1e-9


def test_tm_helpers_and_edges_match_jax():
    for n in (1, 21, 22, 100, 500):
        assert T._tm_d0(n) == J._tm_d0(n)
    d2 = np.random.default_rng(1).uniform(0, 50, size=40)
    assert T._tm_from_distances(d2, 3.2, 40) == pytest.approx(J._tm_from_distances(d2, 3.2, 40),
                                                              abs=TOL)
    two = np.zeros((2, 3))
    assert T.calc_tm_score(two, two) == J.calc_tm_score(two, two) == (0.0, 0.0)
    with pytest.raises(ValueError):
        T.calc_tm_score(np.zeros((4, 3)), np.zeros((5, 3)))
