"""The port's EigenFold confidence score and the sampler's aux trajectories
against the JAX package: one forward noising step and the forward and
backward log-densities given the same noise, the whole score at num_t 4
with the JAX forward noise handed across, and ``sample(..., aux_traj=True)``
against ``build_inference_fn(aux_traj=True)`` at noise_scale 0, at a small
config with the same synthesized weights.

Tolerances: frames within 1e-4 (translations relative 1e-5); the
log-densities and the score within 1e-4 relative (the score sums a few
thousand float32 terms); the atom trajectories within 2e-3 A (the final
x0 prediction's atoms move most: 1.5e-3 A measured), the frames'
translations within 1e-3 A and rotation matrices within 1e-3 (7.4e-4
measured)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from framedipt_tpu.diffusion import SE3Diffuser as JSE3
from framedipt_tpu.geometry.rigid import Rigid as JRigid
from framedipt_tpu.model import ScoreNetwork as JNet
from framedipt_tpu.model.import_torch import convert_state_dict
from framedipt_tpu.sampling import build_inference_fn
from framedipt_tpu.sampling.confidence import logp_confidence_score as j_confidence

from framedipt_tpu_torch.diffusion import SE3Diffuser as TSE3
from framedipt_tpu_torch.diffusion.so3_diffuser import align_rotation_vectors
from framedipt_tpu_torch.geometry.rigid import Rigid as TRigid
from framedipt_tpu_torch.model import ScoreNetwork as TNet
from framedipt_tpu_torch.sampling import sample
from framedipt_tpu_torch.sampling.confidence import logp_confidence_score as t_confidence

from tests.parity import fixture_lib
from tests.test_torch_diffusion import _diffusers
from tests.test_torch_model import make_feats, tiny_configs
from tests.torch_threads import one_torch_thread  # noqa: F401


T = torch.as_tensor
REL = 1e-4


def _frames(seed, B=2, N=13):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, N, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q *= np.sign(q[..., :1])
    trans = (rng.normal(size=(B, N, 3)) * 8).astype(np.float32)
    mask = np.ones((B, N), np.float32)
    mask[:, :4] = 0.0
    return q, trans, mask


def _jax_forward_noise(key, shape):
    """The draws of the JAX SE(3) forward step from ``key``: rotations from
    the first split key, translations from the second."""
    k_rot, k_trans = jax.random.split(key)
    return np.array(jax.random.normal(k_rot, shape)), np.array(jax.random.normal(k_trans, shape))


def _same_rigid(got: TRigid, want: JRigid) -> None:
    np.testing.assert_allclose(got.trans.numpy(), np.asarray(want.trans), atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(got.rot_mats().numpy(), np.asarray(want.rot_mats()), atol=1e-4)


@pytest.fixture(scope="module")
def diffusers():
    return _diffusers()


@pytest.mark.parametrize("t", [0.5, 0.01])
def test_forward_step_and_log_probs_match_jax(diffusers, t):
    """The forward step given the JAX step's noise, then log p of that step
    forward and log p of its reverse under random scores."""
    jd, td = diffusers
    q, trans, mask = _frames(1)
    key = jax.random.PRNGKey(3)
    z_rot, z_trans = _jax_forward_noise(key, trans.shape)
    j_prev = JRigid(jnp.asarray(q), jnp.asarray(trans))
    t_prev = TRigid(T(q), T(trans))
    want = jd.forward(key, j_prev, jnp.float32(t), 0.01, diffuse_mask=jnp.asarray(mask))
    got = td.forward(t_prev, np.float32(t), 0.01, T(z_rot), T(z_trans), diffuse_mask=T(mask))
    _same_rigid(got, want)
    np.testing.assert_array_equal(got.trans.numpy()[:, :4], trans[:, :4])

    rng = np.random.default_rng(2)
    rot_score = rng.normal(size=trans.shape).astype(np.float32)
    trans_score = rng.normal(size=trans.shape).astype(np.float32)
    lp_f = (float(jd.log_prob_forward(want, j_prev, jnp.float32(t), 0.01, jnp.asarray(mask))),
            float(td.log_prob_forward(got, t_prev, np.float32(t), 0.01, T(mask))))
    lp_b = (float(jd.log_prob_backward(want, j_prev, jnp.asarray(trans_score),
                                       jnp.asarray(rot_score), jnp.float32(t), 0.01,
                                       jnp.asarray(mask))),
            float(td.log_prob_backward(got, t_prev, T(trans_score), T(rot_score), np.float32(t),
                                       0.01, T(mask))))
    for want_lp, got_lp in (lp_f, lp_b):
        assert np.isfinite(got_lp)
        assert abs(got_lp - want_lp) <= REL * max(1.0, abs(want_lp)), (got_lp, want_lp)


def test_align_rotation_vectors_flips_to_the_targets_hemisphere():
    rng = np.random.default_rng(5)
    v = rng.normal(size=(64, 3)).astype(np.float32)
    tgt = rng.normal(size=(64, 3)).astype(np.float32)
    out = align_rotation_vectors(T(v), T(tgt)).numpy()
    angle = np.linalg.norm(v, axis=-1)
    apart = np.sum(v * tgt, axis=-1) < 0
    np.testing.assert_allclose(np.linalg.norm(out, axis=-1),
                               np.where(apart, 2 * np.pi - angle, angle), rtol=1e-5)
    assert (np.sum(out * tgt, axis=-1) >= 0).all()


@pytest.fixture(scope="module")
def models():
    """(JAX model, params, diffuser; port model, diffuser; feats) at the
    small config with the same synthesized weights."""
    jc, tc = tiny_configs()
    td = TSE3(tc.diffuser, device="cpu")
    tnet = TNet(tc.model, td, inpainting=True)
    manifest = [(k, list(v.shape)) for k, v in tnet.state_dict().items()]
    sd = fixture_lib.synth_state_dict(manifest)
    tnet.load_state_dict({k: T(v) for k, v in sd.items()}, strict=True)
    jd = JSE3(jc.diffuser)
    jnet = JNet(jc.model, jd, inpainting=True)
    params = jax.tree_util.tree_map(
        jnp.asarray, convert_state_dict(sd, num_blocks=2, seq_tfmr_layers=1))
    feats = make_feats(11, B=1, N=24)
    feats["t"] = np.ones((1,), np.float32)
    feats["sc_ca_t"] = np.zeros_like(feats["sc_ca_t"])
    return jnet, params, jd, tnet.eval(), td, feats


def test_confidence_score_matches_jax(models):
    """num_t 4: three forward steps, each with the JAX score's draws (the
    split chain of its scan, then the SE(3) forward step's split)."""
    jnet, params, jd, tnet, td, feats = models
    num_t, min_t = 4, 0.01
    final = feats["rigids_t"]
    dmask = (1.0 - feats["fixed_mask"]) * feats["res_mask"]
    key = jax.random.PRNGKey(9)
    want = float(j_confidence(jnet, params, jd, {k: jnp.asarray(v) for k, v in feats.items()},
                              final, dmask, num_t=num_t, min_t=min_t, key=key))
    noise, k = [], key
    for _ in range(num_t - 1):
        k, k_fwd = jax.random.split(k)
        noise.append(tuple(T(z) for z in _jax_forward_noise(k_fwd, final[..., 4:].shape)))
    got = float(t_confidence(tnet, td, {k_: T(v) for k_, v in feats.items()}, T(final),
                             T(dmask), num_t=num_t, min_t=min_t, noise=noise))
    assert np.isfinite(got)
    assert abs(got - want) <= REL * abs(want), (got, want)
    # The generator's draws give a finite score too, and a displaced
    # prediction scores lower.
    gen_score = t_confidence(tnet, td, {k_: T(v) for k_, v in feats.items()}, T(final),
                             T(dmask[0]), num_t=num_t, min_t=min_t,
                             generator=torch.Generator().manual_seed(0))
    bad = final.copy()
    bad[..., 4:] += 500.0 * dmask[..., None]
    bad_score = t_confidence(tnet, td, {k_: T(v) for k_, v in feats.items()}, T(bad),
                             T(dmask), num_t=num_t, min_t=min_t,
                             generator=torch.Generator().manual_seed(0))
    assert np.isfinite(float(gen_score)) and float(bad_score) < float(gen_score)


def test_aux_trajectories_match_jax(models):
    jnet, params, jd, tnet, td, feats = models
    run = build_inference_fn(jnet, jd, num_t=5, min_t=0.01, noise_scale=0.0, inpainting=True,
                             aux_traj=True)
    want = run(params, {k: jnp.asarray(v) for k, v in feats.items()}, jax.random.PRNGKey(0))
    got = sample(tnet, td, {k: T(v) for k, v in feats.items()}, torch.Generator().manual_seed(0),
                 num_t=5, min_t=0.01, noise_scale=0.0, inpainting=True, aux_traj=True)
    shapes = {"prot_traj": (5, 1, 24, 37, 3), "rigid_0_traj": (5, 1, 24, 37, 3),
              "rigid_traj": (6, 1, 24, 7), "trans_traj": (5, 1, 24, 3)}
    for name, shape in shapes.items():
        assert got[name].shape == np.asarray(want[name]).shape == shape, name
    for name, atol in (("prot_traj", 2e-3), ("rigid_0_traj", 2e-3), ("trans_traj", 1e-3)):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), atol=atol,
                                   err_msg=name)
    # Frames: translations, and rotations as matrices (quaternion signs aside).
    got_r = TRigid.from_tensor7(got["rigid_traj"])
    want_r = JRigid.from_tensor7(jnp.asarray(want["rigid_traj"]))
    np.testing.assert_allclose(got_r.trans.numpy(), np.asarray(want_r.trans), atol=1e-3)
    np.testing.assert_allclose(got_r.rot_mats().numpy(), np.asarray(want_r.rot_mats()), atol=1e-3)
    np.testing.assert_array_equal(got["rigid_traj"][-1].numpy(), feats["rigids_t"])
    # The default outputs do not move with aux_traj.
    plain = sample(tnet, td, {k: T(v) for k, v in feats.items()},
                   torch.Generator().manual_seed(0), num_t=5, min_t=0.01, noise_scale=0.0,
                   inpainting=True)
    assert set(plain) == {"prot_traj", "psi_pred", "final_rigids"}
    for name in plain:
        torch.testing.assert_close(plain[name], got[name], rtol=0, atol=0)
