"""The port's forward marginals and score-matching losses against the JAX
package's, on the same inputs and the same noise.

Tolerances: float32 1e-4 absolute on values of order 1 (the rotation score
1e-3, as tests/unit/test_train.py holds the same identity: the IGSO(3)
series in float32 is noise-limited at small angles)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from framedipt_tpu.diffusion import SE3Diffuser as JSE3
from framedipt_tpu.geometry.rigid import Rigid as JRigid
from framedipt_tpu.tools.config import Config as JConfig
from framedipt_tpu.tools.config import SO3Config as JSO3Config
from framedipt_tpu.train.losses import score_matching_losses as j_losses
from framedipt_tpu.train.losses import t_stratified_metrics as j_strat

from framedipt_tpu_torch.diffusion import SE3Diffuser as TSE3
from framedipt_tpu_torch.geometry.rigid import Rigid as TRigid
from framedipt_tpu_torch.tools.config import Config as TConfig
from framedipt_tpu_torch.tools.config import SO3Config as TSO3Config
from framedipt_tpu_torch.train.losses import score_matching_losses as t_losses
from framedipt_tpu_torch.train.losses import t_stratified_metrics as t_strat


def diffusers():
    jc, tc = JConfig(), TConfig()
    jc.diffuser.so3 = JSO3Config(num_omega=50, num_sigma=20, cache_dir=None)
    tc.diffuser.so3 = TSO3Config(num_omega=50, num_sigma=20, cache_dir=None)
    return JSE3(jc.diffuser), TSE3(tc.diffuser, device="cpu")


def frames(seed, B=2, N=9):
    rng = np.random.default_rng(seed)
    qs = rng.normal(size=(B, N, 4)).astype(np.float32)
    qs /= np.linalg.norm(qs, axis=-1, keepdims=True)
    trans = (rng.normal(size=(B, N, 3)) * 5).astype(np.float32)
    mask = np.ones((B, N), np.float32)
    mask[:, :3] = 0.0  # fixed residues
    return np.concatenate([qs, trans], -1), mask


def jax_noise(jdiff, key, rigids7, t):
    """The randomness of the JAX batch draw (vmap over samples, one key
    each): per sample k_rot, k_trans = split(key_i); the IGSO3 rotation
    vectors from so3.sample(k_rot) and the translation noise from
    normal(k_trans)."""
    B, N = rigids7.shape[:2]
    rot, trans = [], []
    for k, t_i in zip(jax.random.split(key, B), t):
        k_rot, k_trans = jax.random.split(k)
        rot.append(np.array(jdiff.so3.sample(k_rot, jnp.asarray(t_i), N)))
        trans.append(np.array(jax.random.normal(k_trans, (N, 3))))
    return np.stack(rot), np.stack(trans)


def test_se3_forward_marginal_matches_jax_on_the_same_noise():
    """With the noise given, the port's se3 (and through it r3 and so3)
    forward marginal equals JAX's: frames, scores, scalings; masked
    residues keep their frames and get zero scores."""
    jdiff, tdiff = diffusers()
    r7, mask = frames(0)
    t = np.asarray([0.3, 0.85], np.float32)
    key = jax.random.PRNGKey(4)
    want = jax.vmap(lambda k, r, t_i, m: jdiff.forward_marginal(k, JRigid.from_tensor7(r), t_i, m))(
        jax.random.split(key, 2), jnp.asarray(r7), jnp.asarray(t), jnp.asarray(mask))
    rot, trans = jax_noise(jdiff, key, r7, t)
    got = tdiff.marginal_from_noise(TRigid.from_tensor7(torch.as_tensor(r7)), torch.as_tensor(t),
                                    torch.as_tensor(rot), torch.as_tensor(trans),
                                    torch.as_tensor(mask))
    np.testing.assert_allclose(got.rigids_t.trans.numpy(), np.asarray(want.rigids_t.trans), atol=1e-4)
    np.testing.assert_allclose(np.abs((got.rigids_t.qs.numpy() * np.asarray(want.rigids_t.qs)).sum(-1)),
                               1.0, atol=1e-5)
    np.testing.assert_allclose(got.trans_score.numpy(), np.asarray(want.trans_score), atol=1e-4)
    np.testing.assert_allclose(got.rot_score.numpy(), np.asarray(want.rot_score), atol=1e-3, rtol=1e-3)
    for name in ("trans_score_scaling", "rot_score_scaling"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-5)
    fixed = mask == 0
    np.testing.assert_array_equal(got.rigids_t.trans.numpy()[fixed], r7[..., 4:][fixed])
    assert (got.trans_score.numpy()[fixed] == 0).all() and (got.rot_score.numpy()[fixed] == 0).all()


@pytest.mark.parametrize("part", ["r3", "so3"])
def test_r3_so3_forward_marginal_match_jax_on_the_same_noise(part):
    jdiff, tdiff = diffusers()
    r7, mask = frames(1, B=1)
    key = jax.random.PRNGKey(6)
    t = 0.4
    if part == "r3":
        x0 = r7[0, :, 4:]
        want = jdiff.r3.forward_marginal(key, jnp.asarray(x0), jnp.asarray(t), jnp.asarray(mask[0]))
        z = np.array(jax.random.normal(key, x0.shape))
        got = tdiff.r3.marginal_from_noise(torch.as_tensor(x0), t, torch.as_tensor(z),
                                           torch.as_tensor(mask[0]))
        tol = dict(atol=1e-4)
    else:
        rot0 = np.array(jdiff.so3.sample(jax.random.PRNGKey(7), jnp.asarray(0.5), 9))
        want = jdiff.so3.forward_marginal(key, jnp.asarray(rot0), jnp.asarray(t))
        sampled = np.array(jdiff.so3.sample(key, jnp.asarray(t), 9))
        got = tdiff.so3.marginal_from_sample(torch.as_tensor(rot0), t, torch.as_tensor(sampled))
        tol = dict(atol=1e-3, rtol=1e-3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)


def test_forward_marginal_scores_agree_with_calc_scores():
    """Drawn with a generator: calc_trans_score / calc_rot_score of the
    sample equal the scores the marginal returns (the identity the recycle
    path relies on; tests/unit/test_train.py holds it in JAX)."""
    _, tdiff = diffusers()
    r7, mask = frames(2)
    t = torch.tensor([0.3, 0.8])
    gen = torch.Generator().manual_seed(5)
    marg = tdiff.forward_marginal(gen, TRigid.from_tensor7(torch.as_tensor(r7)), t,
                                  torch.as_tensor(mask))
    rt7 = marg.rigids_t.to_tensor7()
    r0 = torch.as_tensor(r7)
    diffused = torch.as_tensor(mask) > 0  # masked residues: zero scores by definition
    torch.testing.assert_close(tdiff.calc_trans_score(rt7[..., 4:], r0[..., 4:], t)[diffused],
                               marg.trans_score[diffused], atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(tdiff.calc_rot_score(rt7[..., :4], r0[..., :4], t)[diffused],
                               marg.rot_score[diffused], atol=1e-3, rtol=1e-3)
    fixed = ~diffused  # unchanged: the same translation, the same rotation (q or -q)
    torch.testing.assert_close(rt7[fixed][:, 4:], r0[fixed][:, 4:], atol=0, rtol=0)
    torch.testing.assert_close((rt7[fixed][:, :4] * r0[fixed][:, :4]).sum(-1).abs(),
                               torch.ones(int(fixed.sum())))


def _loss_inputs(seed):
    rng = np.random.default_rng(seed)
    B, N = 6, 8
    res = np.ones((B, N), np.float32)
    res[-1, -2:] = 0.0  # padding
    fixed = np.zeros((B, N), np.float32)
    fixed[:, :2] = 1.0
    # t on both sides of every threshold: 0.2 (rotation angle), 0.25
    # (auxiliary terms), 1.0 (x0 translation loss).
    t = np.asarray([0.1, 0.2, 0.21, 0.24, 0.26, 1.0], np.float32)

    def a(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    gt_atoms = np.cumsum(a(B, N, 14, 3, scale=1.5), axis=2)
    batch = {
        "t": t, "res_mask": res, "fixed_mask": fixed,
        "trans_score": a(B, N, 3), "rot_score": a(B, N, 3),
        "trans_score_scaling": np.abs(a(B)) + 0.5, "rot_score_scaling": np.abs(a(B)) + 0.5,
        "rigids_0": a(B, N, 7, scale=3.0), "atom14_gt": gt_atoms,
    }
    pred = {
        "trans_score": a(B, N, 3), "rot_score": a(B, N, 3), "rigids": a(B, N, 7, scale=3.0),
        "atom14": gt_atoms + a(B, N, 14, 3, scale=0.3),
    }
    return batch, pred


@pytest.mark.parametrize("separate_rot_loss", [True, False])
def test_score_matching_losses_match_jax(separate_rot_loss):
    batch, pred = _loss_inputs(3)
    jc, tc = JConfig(), TConfig()
    jc.experiment.separate_rot_loss = tc.experiment.separate_rot_loss = separate_rot_loss
    j_total, j_terms = j_losses({k: jnp.asarray(v) for k, v in pred.items()},
                                {k: jnp.asarray(v) for k, v in batch.items()}, jc.experiment)
    t_total, t_terms = t_losses({k: torch.as_tensor(v) for k, v in pred.items()},
                                {k: torch.as_tensor(v) for k, v in batch.items()}, tc.experiment)
    np.testing.assert_allclose(float(t_total), float(j_total), rtol=1e-5)
    assert set(t_terms) == set(j_terms)
    for k in j_terms:
        np.testing.assert_allclose(t_terms[k].numpy(), np.asarray(j_terms[k]), rtol=1e-5, atol=1e-6)
    per_ex = t_terms["per_example_loss"].numpy()
    assert np.all(per_ex > 0)


def test_t_stratified_metrics_match_jax():
    losses = np.asarray([1.0, 2.0, 3.0, 4.0, 5.0], np.float32)
    t = np.asarray([0.05, 0.3, 0.31, 0.99, 1.0], np.float32)
    assert t_strat(torch.as_tensor(losses), torch.as_tensor(t)) == j_strat(losses, t)
