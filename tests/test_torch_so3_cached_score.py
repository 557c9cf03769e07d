"""The port's SO3Diffuser.score against the JAX package's, with the truncated
series and with the score-norm table (``use_cached_score``), and a
checkpoint config's ``use_cached_score`` through ``merge_checkpoint_config``
to the diffuser; the merge names every key it drops."""
import logging

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from framedipt_tpu.diffusion import igso3 as j_igso3
from framedipt_tpu.diffusion.so3_diffuser import SO3Diffuser as JSO3Diffuser
from framedipt_tpu.tools.config import SO3Config as JSO3Config

from framedipt_tpu_torch.diffusion.so3_diffuser import SO3Diffuser as TSO3Diffuser
from framedipt_tpu_torch.tools.config import Config, merge_checkpoint_config
from framedipt_tpu_torch.tools.config import SO3Config as TSO3Config
from framedipt_tpu_torch.tools.log import get_logger
from tests.torch_threads import one_torch_thread  # noqa: F401


GRID = dict(num_omega=100, num_sigma=100, cache_dir=None)


@pytest.fixture(scope="module")
def diffusers():
    return {
        flag: (JSO3Diffuser(JSO3Config(use_cached_score=flag, **GRID)),
               TSO3Diffuser(TSO3Config(use_cached_score=flag, **GRID), device="cpu"))
        for flag in (False, True)
    }


def _rotvecs(rng, shape):
    """Rotation vectors with |omega| spread over (0, 3.4], past pi."""
    axis = rng.normal(size=shape + (3,))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    omega = rng.uniform(0.02, 3.4, size=shape + (1,))
    return (axis * omega).astype(np.float32)


def _series_is_noise(jd, vec, t):
    """Where the IGSO(3) density's float32 series is below 0.1, it sums
    1000 alternating terms to almost nothing, and the two frameworks'
    summation orders give different noise (up to 39x apart at t = 0.05,
    |omega| 2.9): a reference behaviour of the series, not of this port.
    Those inputs are held to be finite, the rest to 1e-5."""
    omega = jnp.linalg.norm(jnp.asarray(vec), axis=-1) + 1e-6
    sigma = jd.discrete_sigma[jd.t_to_idx(jnp.asarray(t))]
    while sigma.ndim < omega.ndim:
        sigma = sigma[..., None]
    return np.asarray(j_igso3.expansion(omega, jnp.broadcast_to(sigma, omega.shape))) < 0.1


def _assert_scores_match(jd, td, vec, t):
    """The table path is held everywhere: no input here lies within an ulp
    of a grid edge, where the two frameworks' norms could pick neighbouring
    buckets."""
    want = np.asarray(jd.score(jnp.asarray(vec), jnp.asarray(t)))
    got = td.score(torch.as_tensor(vec), torch.as_tensor(t)).numpy()
    assert np.isfinite(got).all()
    bad = ~np.isclose(got, want, rtol=1e-5, atol=1e-5).all(-1)
    if not td.use_cached_score:
        bad &= ~_series_is_noise(jd, vec, t)
    assert not bad.any(), (got[bad], want[bad])


@pytest.mark.parametrize("cached", [False, True], ids=["series", "table"])
@pytest.mark.parametrize("t", [0.05, 0.3, 0.7, 1.0])
def test_score_matches_jax_at_scalar_t(diffusers, cached, t):
    jd, td = diffusers[cached]
    vec = _rotvecs(np.random.default_rng(int(t * 100)), (6, 40))
    _assert_scores_match(jd, td, vec, np.float32(t))


@pytest.mark.parametrize("cached", [False, True], ids=["series", "table"])
def test_score_matches_jax_at_batched_t(diffusers, cached):
    jd, td = diffusers[cached]
    vec = _rotvecs(np.random.default_rng(7), (4, 50))
    _assert_scores_match(jd, td, vec, np.asarray([0.05, 0.3, 0.7, 1.0], np.float32))


def test_table_and_series_differ_past_pi(diffusers):
    """The two paths are different functions: past pi the table's last
    bucket and the series part ways, so the flag must reach the diffuser."""
    _, series = diffusers[False]
    _, table = diffusers[True]
    vec = torch.tensor([[3.3, 0.0, 0.0]])
    t = torch.tensor(0.3)
    assert not torch.allclose(series.score(vec, t), table.score(vec, t), rtol=1e-2)


def test_checkpoint_use_cached_score_reaches_the_diffuser(monkeypatch, caplog):
    monkeypatch.setattr(get_logger(), "propagate", True)
    ckpt_conf = {
        "diffuser": {"so3": {"use_cached_score": True, "num_omega": 100, "num_sigma": 100,
                             "seed": 3, "foo": 1}},
        "model": {"ipa": {"use_pallas_kernel": False, "pallas_emb_bwd_impl": "xla",
                          "num_blocks": 2}},
    }
    with caplog.at_level(logging.WARNING, logger="framedipt_tpu_torch"):
        merged = merge_checkpoint_config(Config(), ckpt_conf)
    assert merged.diffuser.so3.use_cached_score is True
    assert merged.model.ipa.num_blocks == 2
    dropped = sorted(r.getMessage() for r in caplog.records)
    assert len(dropped) == 2
    assert "diffuser.so3.foo " in dropped[0] and "diffuser.so3.seed " in dropped[1]
    assert not any("use_pallas_kernel" in m or "pallas_emb_bwd_impl" in m for m in dropped)
    merged.diffuser.so3.cache_dir = None
    td = TSO3Diffuser(merged.diffuser.so3, device="cpu")
    jd = JSO3Diffuser(JSO3Config(use_cached_score=True, **GRID))
    assert td.use_cached_score
    vec = _rotvecs(np.random.default_rng(11), (3, 30))
    _assert_scores_match(jd, td, vec, np.float32(0.4))
