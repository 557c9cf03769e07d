"""The port's diffusion modules against the JAX package: the float64 IGSO(3)
tables, sigma(t), t_to_idx, the score series, score scalings, and one SE(3)
reverse step given the same noise; sample_ref by its statistics."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from framedipt_tpu.diffusion import SE3Diffuser as JSE3
from framedipt_tpu.diffusion import igso3 as j_igso3
from framedipt_tpu.geometry.rigid import Rigid as JRigid
from framedipt_tpu.tools.config import DiffuserConfig as JDiffuserConfig
from framedipt_tpu.tools.config import SO3Config as JSO3Config

from framedipt_tpu_torch.diffusion import SE3Diffuser as TSE3
from framedipt_tpu_torch.diffusion import igso3 as t_igso3
from framedipt_tpu_torch.diffusion.so3_diffuser import interp
from framedipt_tpu_torch.geometry.rigid import Rigid as TRigid
from framedipt_tpu_torch.tools.config import DiffuserConfig as TDiffuserConfig
from framedipt_tpu_torch.tools.config import SO3Config as TSO3Config

T = torch.as_tensor


def _diffusers(num_omega=200, num_sigma=100):
    jc = JDiffuserConfig(so3=JSO3Config(num_omega=num_omega, num_sigma=num_sigma, cache_dir=None))
    tc = TDiffuserConfig(so3=TSO3Config(num_omega=num_omega, num_sigma=num_sigma, cache_dir=None))
    return JSE3(jc), TSE3(tc, device="cpu")


@pytest.fixture(scope="module")
def diffusers():
    return _diffusers()


def test_lookup_tables_equal_in_float64():
    sig = np.log(np.linspace(0.0, 1.0, 30) * np.exp(1.5) + (1 - np.linspace(0.0, 1.0, 30)) * np.exp(0.1))
    omega = np.linspace(0, np.pi, 61)[1:]
    got = t_igso3.build_lookup_tables(sig, omega, cache_dir=None)
    want = j_igso3.build_lookup_tables(sig, omega, cache_dir=None)
    for k in ("pdf", "cdf", "score_norms", "score_scaling"):
        assert got[k].dtype == np.float64
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_default_grid_reads_the_prebuilt_cache(tmp_path):
    """The default 1000 x 1000 grid hashes to the repository's prebuilt
    table, which both packages read identically."""
    conf = TSO3Config(cache_dir=str(tmp_path))
    omega = np.linspace(0, np.pi, conf.num_omega + 1)[1:]
    t = np.linspace(0.0, 1.0, conf.num_sigma)
    sig = np.log(t * np.exp(conf.max_sigma) + (1 - t) * np.exp(conf.min_sigma))
    got = t_igso3.build_lookup_tables(sig, omega, cache_dir=str(tmp_path))
    want = j_igso3.build_lookup_tables(sig, omega, cache_dir=str(tmp_path))
    assert not list(tmp_path.iterdir())  # served from the prebuilt file
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_sigma_schedule_and_t_to_idx(diffusers):
    jd, td = diffusers
    t = np.concatenate([np.linspace(0.0, 1.0, 101), np.random.default_rng(0).random(200)])
    t = t.astype(np.float32)
    for fn in ("sigma", "diffusion_coef"):
        np.testing.assert_allclose(
            getattr(td.so3, fn)(T(t)).numpy(), np.asarray(getattr(jd.so3, fn)(jnp.asarray(t))),
            rtol=1e-6, atol=1e-6, err_msg=fn,
        )
    np.testing.assert_array_equal(
        td.so3.t_to_idx(T(t)).numpy(), np.asarray(jd.so3.t_to_idx(jnp.asarray(t)))
    )


def test_score_scalings(diffusers):
    jd, td = diffusers
    for t in (0.01, 0.1, 0.37, 0.8, 1.0):
        t_rot, t_trans = td.score_scaling(t)
        j_rot, j_trans = jd.score_scaling(jnp.float32(t))
        np.testing.assert_allclose(t_rot.numpy(), np.asarray(j_rot), rtol=1e-6)
        np.testing.assert_allclose(t_trans.numpy(), np.asarray(j_trans), rtol=1e-6)


def test_score_series_and_rotation_score(diffusers):
    jd, td = diffusers
    rng = np.random.default_rng(1)
    omega = rng.uniform(0.01, 3.1, size=(4, 9)).astype(np.float32)
    eps = rng.uniform(0.1, 1.5, size=(4, 9)).astype(np.float32)
    e_t = t_igso3.expansion(T(omega), T(eps))
    e_j = j_igso3.expansion(jnp.asarray(omega), jnp.asarray(eps))
    # The series sums 1000 alternating terms in float32: where it nearly
    # cancels, the summation order shows at ~1e-5 absolute.
    np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), rtol=1e-4, atol=1e-4)
    # The ratio divides by the density: compare where it is not ~0 (there
    # both sides are float32 noise over noise).
    live = np.asarray(e_j) > 1e-2
    assert live.sum() > 20
    np.testing.assert_allclose(
        t_igso3.score_ratio(e_t, T(omega), T(eps)).numpy()[live],
        np.asarray(j_igso3.score_ratio(e_j, jnp.asarray(omega), jnp.asarray(eps)))[live],
        rtol=1e-4, atol=1e-5,
    )
    vec = rng.normal(size=(2, 9, 3)).astype(np.float32)
    vec[0, 0] = 0.0  # identity rotation delta of a fixed residue
    t = np.asarray([0.3, 0.9], np.float32)
    np.testing.assert_allclose(
        td.so3.score(T(vec), T(t)).numpy(), np.asarray(jd.so3.score(jnp.asarray(vec), jnp.asarray(t))),
        rtol=1e-4, atol=1e-5,
    )


def test_trans_score_and_x0(diffusers):
    jd, td = diffusers
    rng = np.random.default_rng(2)
    x_t, x_0 = (rng.normal(size=(2, 7, 3)).astype(np.float32) * 10 for _ in range(2))
    t = np.asarray([0.2, 0.7], np.float32)
    s_t = td.calc_trans_score(T(x_t), T(x_0), T(t)[:, None, None])
    s_j = jd.calc_trans_score(jnp.asarray(x_t), jnp.asarray(x_0), jnp.asarray(t)[:, None, None])
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        td.r3.calc_trans_0(s_t, T(x_t), T(t)).numpy(),
        np.asarray(jd.r3.calc_trans_0(s_j, jnp.asarray(x_t), jnp.asarray(t))),
        rtol=1e-5, atol=1e-4,
    )


def test_interp_matches_numpy():
    rng = np.random.default_rng(3)
    xp = np.sort(rng.random(50)).astype(np.float32)
    xp[10:14] = xp[10]  # flat run
    fp = np.cumsum(rng.random(50)).astype(np.float32)
    x = np.concatenate([rng.uniform(-0.2, 1.2, 300), xp]).astype(np.float32)
    np.testing.assert_allclose(
        interp(T(x), T(xp), T(fp)).numpy(),
        np.asarray(jnp.interp(jnp.asarray(x), jnp.asarray(xp), jnp.asarray(fp))),
        rtol=1e-6, atol=1e-6,
    )


@pytest.mark.parametrize("t", [0.9, 0.01 + 1e-3])
def test_se3_reverse_step_given_same_noise(diffusers, t):
    """The JAX reverse step draws its noise from split keys; the same draws
    go to the port, so both compute the same step."""
    jd, td = diffusers
    rng = np.random.default_rng(4)
    B, N = 2, 11
    q = rng.normal(size=(B, N, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q *= np.sign(q[..., :1])
    trans = rng.normal(size=(B, N, 3)).astype(np.float32) * 8
    rot_score = rng.normal(size=(B, N, 3)).astype(np.float32)
    trans_score = rng.normal(size=(B, N, 3)).astype(np.float32)
    mask = np.ones((B, N), np.float32)
    mask[:, :4] = 0.0
    key = jax.random.PRNGKey(7)
    k_rot, k_trans = jax.random.split(key)
    z_rot = np.asarray(jax.random.normal(k_rot, rot_score.shape))
    z_trans = np.asarray(jax.random.normal(k_trans, trans_score.shape))
    want = jd.reverse(
        key, JRigid(jnp.asarray(q), jnp.asarray(trans)), jnp.asarray(rot_score),
        jnp.asarray(trans_score), jnp.float32(t), 0.01, diffuse_mask=jnp.asarray(mask),
        noise_scale=0.5,
    )
    got = td.reverse(
        TRigid(T(q), T(trans)), T(rot_score), T(trans_score), np.float32(t), 0.01,
        T(z_rot), T(z_trans), diffuse_mask=T(mask), noise_scale=0.5,
    )
    np.testing.assert_allclose(got.trans.numpy(), np.asarray(want.trans), atol=1e-4, rtol=1e-5)
    # Compare rotations, not quaternion signs.
    np.testing.assert_allclose(
        got.rot_mats().numpy(), np.asarray(want.rot_mats()), atol=1e-5
    )
    np.testing.assert_array_equal(got.trans.numpy()[:, :4], trans[:, :4])


def test_sample_ref_statistics(diffusers):
    _, td = diffusers
    gen = torch.Generator().manual_seed(0)
    n = 4000
    impute = TRigid.identity((n,))
    impute = TRigid(impute.qs, torch.full((n, 3), 5.0))
    mask = torch.ones(n)
    mask[:100] = 0.0
    ref = td.sample_ref(gen, n, impute=impute, diffuse_mask=mask)
    trans = ref.trans.numpy()
    # Fixed rows keep the imputed frame; diffused translations ~ N(0, 1/scale^2).
    np.testing.assert_allclose(trans[:100], 5.0, atol=1e-5)
    np.testing.assert_allclose(ref.qs.numpy()[:100], np.tile([1, 0, 0, 0], (100, 1)), atol=1e-6)
    d = trans[100:] * td.r3.coordinate_scaling
    assert abs(d.mean()) < 0.05 and abs(d.std() - 1.0) < 0.05
    # Rotation angles at t=1 follow the IGSO3 marginal: compare the mean angle
    # with the inverse-CDF table's mean.
    angles = 2 * np.arccos(np.clip(np.abs(ref.qs.numpy()[100:, 0]), 0, 1))
    omega = td.so3.discrete_omega.numpy()
    cdf = td.so3._cdf[-1].numpy()
    pdf = np.diff(np.concatenate([[0.0], cdf]))
    expect = (omega * pdf).sum() / pdf.sum()
    assert abs(angles.mean() - expect) < 0.05
