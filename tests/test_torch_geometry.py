"""The port's geometry and host data modules against the JAX package.

Same numpy inputs through both; float32 functions within atol 1e-5."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from framedipt_tpu.data import features as j_features
from framedipt_tpu.data import protein as j_protein
from framedipt_tpu.data import transforms as j_transforms
from framedipt_tpu.geometry import frames as j_frames
from framedipt_tpu.geometry import quat as j_quat
from framedipt_tpu.geometry import so3 as j_so3
from framedipt_tpu.geometry.rigid import Rigid as JRigid

from framedipt_tpu_torch.analysis.utils import prot_pos_to_pdb, write_prot_to_pdb
from framedipt_tpu_torch.data import features as t_features
from framedipt_tpu_torch.data import protein as t_protein
from framedipt_tpu_torch.data import transforms as t_transforms
from framedipt_tpu_torch.geometry import frames as t_frames
from framedipt_tpu_torch.geometry import quat as t_quat
from framedipt_tpu_torch.geometry import so3 as t_so3
from framedipt_tpu_torch.geometry.rigid import Rigid as TRigid

from tests.unit.geom_helpers import nerf_backbone

ATOL = 1e-5


def _close(t_out, j_out, atol=ATOL):
    np.testing.assert_allclose(
        t_out.detach().numpy(), np.asarray(j_out), atol=atol, rtol=0
    )


def _rand_quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _rotvecs(rng, n):
    """Rotation vectors spanning tiny, ordinary and near-pi angles."""
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    angle = np.concatenate([
        rng.uniform(0, 1e-4, n // 4), rng.uniform(0.1, 2.5, n - n // 2),
        rng.uniform(3.0, 3.14, n // 4),
    ])
    return (axis * angle[:, None]).astype(np.float32)


T = torch.as_tensor


@pytest.mark.parametrize("fn", ["multiply", "multiply_by_vec", "invert", "normalize",
                                "to_rotmat", "to_rotvec", "from_rotvec"])
def test_quat_functions_match_jax(fn):
    rng = np.random.default_rng(0)
    q1, q2 = _rand_quats(rng, 64), _rand_quats(rng, 64) * 1.7
    v = _rotvecs(rng, 64)
    args = {
        "multiply": (q1, q2),
        "multiply_by_vec": (q1, v),
        "invert": (q1,),
        "normalize": (q2,),
        "to_rotmat": (q2,),
        "to_rotvec": (np.concatenate([q1, -q1[:8]]),),
        "from_rotvec": (v,),
    }[fn]
    _close(getattr(t_quat, fn)(*map(T, args)), getattr(j_quat, fn)(*map(jnp.asarray, args)))


def test_from_rotmat_all_pivots():
    rng = np.random.default_rng(1)
    mats = np.array(j_so3.exp(jnp.asarray(_rotvecs(rng, 128))))
    got = t_quat.from_rotmat(T(mats))
    want = j_quat.from_rotmat(jnp.asarray(mats))
    # q and -q are the same rotation; both sides pick the same sign.
    _close(got, want)


@pytest.mark.parametrize("fn", ["hat", "exp", "log", "compose_rotvec"])
def test_so3_functions_match_jax(fn):
    rng = np.random.default_rng(2)
    v1, v2 = _rotvecs(rng, 64), _rotvecs(rng, 64)
    if fn == "log":
        args = (np.array(j_so3.exp(jnp.asarray(v1))),)
    elif fn == "compose_rotvec":
        args = (v1, v2)
    else:
        args = (v1,)
    _close(getattr(t_so3, fn)(*map(T, args)), getattr(j_so3, fn)(*map(jnp.asarray, args)),
           atol=2e-5 if fn in ("log", "compose_rotvec") else ATOL)


def test_rigid_ops_match_jax():
    rng = np.random.default_rng(3)
    n = 32
    q, t = _rand_quats(rng, n), rng.normal(size=(n, 3)).astype(np.float32) * 5
    q2, t2 = _rand_quats(rng, n), rng.normal(size=(n, 3)).astype(np.float32) * 5
    pts = rng.normal(size=(n, 3)).astype(np.float32) * 4
    jr, tr = JRigid(jnp.asarray(q), jnp.asarray(t)), TRigid(T(q), T(t))
    jr2, tr2 = JRigid(jnp.asarray(q2), jnp.asarray(t2)), TRigid(T(q2), T(t2))
    _close(tr.apply(T(pts)), jr.apply(jnp.asarray(pts)))
    _close(tr.invert_apply(T(pts)), jr.invert_apply(jnp.asarray(pts)))
    _close(tr.compose(tr2).to_tensor7(), jr.compose(jr2).to_tensor7())
    _close(tr.invert().to_tensor7(), jr.invert().to_tensor7())
    _close(tr.rot_mats(), jr.rot_mats())


def test_compose_q_update_vec_masked_frames_unchanged():
    rng = np.random.default_rng(4)
    n = 24
    q, t = _rand_quats(rng, n), rng.normal(size=(n, 3)).astype(np.float32) * 5
    upd = rng.normal(size=(n, 6)).astype(np.float32) * 0.3
    mask = (rng.random((n, 1)) > 0.5).astype(np.float32)
    got = TRigid(T(q), T(t)).compose_q_update_vec(T(upd), update_mask=T(mask))
    want = JRigid(jnp.asarray(q), jnp.asarray(t)).compose_q_update_vec(
        jnp.asarray(upd), update_mask=jnp.asarray(mask)
    )
    _close(got.to_tensor7(), want.to_tensor7())
    fixed = mask[:, 0] == 0
    np.testing.assert_array_equal(got.trans.numpy()[fixed], t[fixed])


def test_from_3_points_matches_jax():
    atom37, _ = nerf_backbone(12)
    n, ca, c = (atom37[:, i].astype(np.float32) for i in (0, 1, 2))
    got = TRigid.from_3_points(T(n), T(ca), T(c))
    want = JRigid.from_3_points(jnp.asarray(n), jnp.asarray(ca), jnp.asarray(c))
    _close(got.to_tensor7(), want.to_tensor7())


def test_compute_backbone_matches_jax():
    """The inputs of tests/parity/test_transforms_parity.py
    (TestComputeBackbone), through both packages."""
    rng = np.random.default_rng(1)
    n = 16
    q = rng.normal(size=(1, n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    trans = rng.normal(size=(1, n, 3)).astype(np.float32) * 8
    psi = rng.normal(size=(1, n, 2)).astype(np.float32)
    psi /= np.linalg.norm(psi, axis=-1, keepdims=True)
    aatype = rng.integers(0, 20, size=(1, n))
    aatype[0, :2] = 20  # UNK maps to ALA geometry
    t7 = np.concatenate([q, trans], axis=-1)
    got = t_frames.compute_backbone(
        TRigid.from_tensor7(T(t7), normalize=True), T(psi), aatype=T(aatype)
    )
    want = j_frames.compute_backbone(
        JRigid.from_tensor7(jnp.asarray(t7), normalize=True), jnp.asarray(psi),
        aatype=jnp.asarray(aatype),
    )
    for g, w in zip(got, want):
        _close(g.to(torch.float32), jnp.asarray(w, jnp.float32))


def _helix_protein(n_res, rng):
    atom37, mask = nerf_backbone(n_res)
    aatype = rng.integers(0, 21, size=n_res)
    return atom37, mask, aatype


def test_backbone_frames_and_torsions_match_jax():
    rng = np.random.default_rng(5)
    atom37, mask, aatype = _helix_protein(20, rng)
    mask[3, 0] = 0.0  # a residue missing N has no backbone frame
    np.testing.assert_allclose(
        t_transforms.backbone_rigid_tensor7(aatype, atom37, mask),
        j_transforms.backbone_rigid_tensor7(aatype, atom37, mask), atol=1e-6,
    )
    # Both packages index the 20-row chi tables with aatype: UNK (20) raises.
    aatype = np.minimum(aatype, 19)
    got = t_transforms.atom37_to_torsion_angles(aatype, atom37, mask)
    want = j_transforms.atom37_to_torsion_angles(aatype, atom37, mask)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)


def test_pdb_round_trip_matches_jax(tmp_path):
    rng = np.random.default_rng(6)
    atom37, mask, aatype = _helix_protein(15, rng)
    chains = np.asarray([0] * 8 + [1] * 7)
    prot_kw = dict(atom_positions=atom37, atom_mask=mask, aatype=aatype,
                   residue_index=np.arange(1, 16), chain_index=chains,
                   b_factors=rng.uniform(0, 50, size=(15, 37)))
    text = t_protein.to_pdb(t_protein.Protein(**prot_kw))
    assert text == j_protein.to_pdb(j_protein.Protein(**prot_kw))
    got, want = t_protein.from_pdb_string(text), j_protein.from_pdb_string(text)
    for field in ("atom_positions", "aatype", "atom_mask", "residue_index", "chain_index",
                  "b_factors"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    assert [t_protein.int_to_chain_id(i) for i in (0, 25, 26)] == ["A", "Z", "AA"]

    from framedipt_tpu.analysis.utils import write_prot_to_pdb as j_write

    b = np.tile(np.linspace(0, 100, 15)[:, None], (1, 37))
    for pos in (atom37, np.stack([atom37, atom37 + 1.0])):
        p_t = write_prot_to_pdb(pos, tmp_path / "t" / "x", aatype=aatype, b_factors=b,
                                chain_index=chains)
        p_j = j_write(pos, tmp_path / "j" / "x", aatype=aatype, b_factors=b,
                      chain_index=chains)
        assert p_t.name == p_j.name == "x_1.pdb"
        assert p_t.read_text() == p_j.read_text()
        assert prot_pos_to_pdb(pos, aatype=aatype, b_factors=b, chain_index=chains) == \
            p_t.read_text()
        p_t.unlink()
        p_j.unlink()


def test_padding_matches_jax():
    rng = np.random.default_rng(7)
    feats = {"res_mask": np.ones(37, np.float32), "t": np.float32(0.5),
             "rigids_t": rng.normal(size=(37, 7)).astype(np.float32)}
    got, want = t_features.pad_feats(feats, 64), j_features.pad_feats(feats, 64)
    for k in feats:
        np.testing.assert_array_equal(got[k], want[k])
    for n in (1, 64, 65, 200, 512, 513, 1000):
        assert t_features.length_bucket(n) == j_features.length_bucket(n)
    with pytest.raises(ValueError):
        t_features.pad_to(np.zeros(70), 64)
