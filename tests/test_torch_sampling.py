"""The port's reverse-SDE sampler against the JAX package's
``build_inference_fn``: a deterministic (noise_scale=0) 5-step trajectory at
a small config with damped synthesized weights, final CA-RMSD below 0.01 A."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from framedipt_tpu.diffusion import SE3Diffuser as JSE3
from framedipt_tpu.model import ScoreNetwork as JNet
from framedipt_tpu.model.import_torch import convert_state_dict
from framedipt_tpu.sampling import build_inference_fn

from framedipt_tpu_torch.diffusion import SE3Diffuser as TSE3
from framedipt_tpu_torch.model import ScoreNetwork as TNet
from framedipt_tpu_torch.sampling import sample

from tests.parity import fixture_lib
from tests.test_torch_model import make_feats, tiny_configs


def _ca_rmsd(a, b):
    return float(np.sqrt(np.mean(np.sum((a - b) ** 2, axis=-1))))


def jax_trajectory(self_conditioning):
    jc, tc = tiny_configs(self_conditioning)
    manifest = [(k, list(v.shape)) for k, v in
                TNet(tc.model, TSE3(tc.diffuser, device="cpu"), inpainting=True)
                .state_dict().items()]
    sd = fixture_lib.synth_state_dict(manifest)
    jd = JSE3(jc.diffuser)
    jnet = JNet(jc.model, jd, inpainting=True)
    params = convert_state_dict(sd, num_blocks=2, seq_tfmr_layers=1)
    feats = make_feats(11, B=1, N=24)
    feats["t"] = np.ones((1,), np.float32)
    feats["sc_ca_t"] = np.zeros_like(feats["sc_ca_t"])
    run = build_inference_fn(jnet, jd, num_t=5, min_t=0.01, noise_scale=0.0, inpainting=True,
                             embed_self_conditioning=self_conditioning)
    want = run(jax.tree_util.tree_map(jnp.asarray, params),
               {k: jnp.asarray(v) for k, v in feats.items()}, jax.random.PRNGKey(0))
    return tc, sd, feats, want


@pytest.mark.parametrize("self_conditioning", [False, True])
def test_deterministic_trajectory_matches_jax(self_conditioning):
    """With self-conditioning, an initial forward and the predicted CA fed
    back each step; without it, neither (as the JAX sampler)."""
    tc, sd, feats, want = jax_trajectory(self_conditioning)
    td = TSE3(tc.diffuser, device="cpu")
    tnet = TNet(tc.model, td, inpainting=True)
    tnet.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()}, strict=True)
    got = sample(tnet, td, {k: torch.as_tensor(v) for k, v in feats.items()},
                 torch.Generator().manual_seed(0), num_t=5, min_t=0.01, noise_scale=0.0,
                 inpainting=True)

    traj_j = np.asarray(want["prot_traj"])
    traj_t = got["prot_traj"].numpy()
    assert traj_t.shape == traj_j.shape == (5, 1, 24, 37, 3)
    assert _ca_rmsd(traj_t[0, 0, :, 1], traj_j[0, 0, :, 1]) < 0.01  # t = 0 frame
    for step in range(5):
        assert _ca_rmsd(traj_t[step, 0, :, 1], traj_j[step, 0, :, 1]) < 0.01, step
    np.testing.assert_allclose(got["psi_pred"].numpy(), np.asarray(want["psi_pred"]), atol=1e-3)
    # Fixed residues keep their input frames through the whole trajectory.
    fixed = (feats["fixed_mask"][0] > 0.5) & (feats["res_mask"][0] > 0.5)
    np.testing.assert_allclose(
        got["final_rigids"].numpy()[0, fixed, 4:], feats["rigids_t"][0, fixed, 4:], atol=1e-4
    )
