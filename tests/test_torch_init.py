"""The port's initialization (``model/weights.py:init_state_dict``, the AF2
initializer zoo) against the JAX package's ``model.init``, tensor by tensor:
the same tensors exactly 0, the same exactly 1, the same IPA point-weight
constant at a tiny width, and each random tensor's standard deviation within
a few percent of JAX's at the full default widths (two blocks, one
transformer layer: depth does not change a tensor's initializer)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from framedipt_tpu.diffusion import SE3Diffuser as JSE3
from framedipt_tpu.model import ScoreNetwork as JNet
from framedipt_tpu.tools.config import Config as JConfig
from framedipt_tpu.tools.config import SO3Config as JSO3Config

from framedipt_tpu_torch.diffusion import SE3Diffuser as TSE3
from framedipt_tpu_torch.model import ScoreNetwork as TNet
from framedipt_tpu_torch.model.weights import (
    IPA_POINT_WEIGHTS_INIT,
    init_state_dict,
    params_from_jax,
)
from framedipt_tpu_torch.tools.config import Config as TConfig
from framedipt_tpu_torch.tools.config import SO3Config as TSO3Config

from tests.test_torch_model import make_feats, tiny_configs
from tests.torch_threads import one_torch_thread  # noqa: F401


def full_configs():
    jc, tc = JConfig(), TConfig()
    jc.diffuser.so3 = JSO3Config(num_omega=50, num_sigma=20, cache_dir=None)
    tc.diffuser.so3 = TSO3Config(num_omega=50, num_sigma=20, cache_dir=None)
    for cfg in (jc, tc):
        cfg.model.ipa.num_blocks, cfg.model.ipa.seq_tfmr_num_layers = 2, 1
    jc.model.ipa.use_pallas_kernel = jc.model.ipa.use_pallas_embedder = False
    return jc, tc


def both_inits(jc, tc, seed=0):
    """(JAX model.init as a port state_dict, the port's init_state_dict)."""
    jnet = JNet(jc.model, JSE3(jc.diffuser), inpainting=True)
    feats = {k: jnp.asarray(v) for k, v in make_feats(B=1, N=8).items()}
    params = jax.jit(jnet.init)(jax.random.PRNGKey(seed), feats)
    ipa = jc.model.ipa
    want = params_from_jax(params, num_blocks=ipa.num_blocks,
                           seq_tfmr_layers=ipa.seq_tfmr_num_layers)
    tnet = TNet(tc.model, TSE3(tc.diffuser, device="cpu"), inpainting=True)
    got = init_state_dict(tnet, torch.Generator().manual_seed(seed))
    tnet.load_state_dict(got, strict=True)
    return want, got


def constant_of(t):
    """The value of a constant tensor, or None."""
    flat = t.flatten()
    return float(flat[0]) if bool((flat == flat[0]).all()) else None


@pytest.fixture(scope="module")
def full_inits():
    return both_inits(*full_configs())


def test_zero_one_pattern_matches_jax_at_a_tiny_width():
    want, got = both_inits(*tiny_configs())
    assert got.keys() == want.keys()
    zeros, ones = [], []
    for name in want:
        assert got[name].shape == want[name].shape, name
        assert constant_of(got[name]) == constant_of(want[name]), name
        if constant_of(want[name]) == 0.0:
            zeros.append(name)
        elif constant_of(want[name]) == 1.0:
            ones.append(name)
    heads = [n for n in want if n.endswith("head_weights")]
    assert heads and all(constant_of(got[n]) == np.float32(IPA_POINT_WEIGHTS_INIT) for n in heads)
    # Every bias, the final layers and the unread tensors; the LayerNorm scales.
    assert (len(zeros), len(ones), len(want)) == (76, 11, 124)


def test_random_tensors_match_jax_spread_at_full_width(full_inits):
    want, got = full_inits
    checked = 0
    for name, w in want.items():
        if constant_of(w) is not None:
            assert constant_of(got[name]) == constant_of(w), name
            continue
        n = w.numel()
        sw, sg = float(w.std()), float(got[name].std())
        # Two independent draws: each sample std is off by ~1/sqrt(2n).
        assert abs(sg / sw - 1.0) < 0.02 + 3.0 / np.sqrt(n), (name, sg, sw)
        assert abs(float(got[name].mean())) < 4.0 * sw / np.sqrt(n), name
        # Truncated normals stop at 2 std, glorot's uniform at sqrt(3) std.
        assert float(got[name].abs().max()) <= 1.001 * float(w.abs().max()) + 0.05 * sw, name
        checked += 1
    assert checked == 35, checked


def test_init_is_a_function_of_the_seed():
    _, tc = tiny_configs()
    tnet = TNet(tc.model, TSE3(tc.diffuser, device="cpu"), inpainting=True)
    got, again, other = (init_state_dict(tnet, torch.Generator().manual_seed(seed))
                         for seed in (0, 0, 1))
    name = "score_model.trunk.edge_transition_0.trunk.0.weight"
    assert all(torch.equal(got[k], again[k]) for k in got)
    assert not torch.equal(got[name], other[name])
