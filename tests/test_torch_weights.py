"""Weights of the port: the reference torch names (strict loads of the
recorded manifest and of reference .pth files), the inverse of the JAX
importer, and the port's own copy of the synthesized test weights."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from framedipt_tpu.diffusion import SE3Diffuser as JSE3
from framedipt_tpu.model import ScoreNetwork as JNet
from framedipt_tpu.model.import_torch import convert_state_dict

from framedipt_tpu_torch.diffusion import SE3Diffuser as TSE3
from framedipt_tpu_torch.model import ScoreNetwork as TNet
from framedipt_tpu_torch.model.weights import (
    load_reference_checkpoint,
    params_from_jax,
    synth_state_dict,
)
from framedipt_tpu_torch.tools.config import Config as TConfig

from tests.parity import fixture_lib
from tests.test_torch_model import make_feats, tiny_configs

UNREAD = ("linear_rbf", "torsion_pred.linear_3")


@pytest.fixture(scope="module")
def full_net():
    cfg = TConfig()
    return TNet(cfg.model, TSE3(cfg.diffuser, device="cpu"), inpainting=True)


def test_state_dict_names_are_the_recorded_manifest(full_net):
    """The default model's state_dict is exactly the reference manifest, so
    the published checkpoints and synth_state_dict load with strict=True."""
    manifest = fixture_lib.load_manifest(np.load(fixture_lib.FIXTURE))
    sd = full_net.state_dict()
    assert [(k, list(v.shape)) for k, v in sd.items()] == [(k, list(s)) for k, s in manifest]


def test_synth_state_dict_is_the_fixture_scheme(full_net):
    ours = synth_state_dict(full_net)
    theirs = fixture_lib.synth_state_dict([(k, list(v.shape)) for k, v in full_net.state_dict().items()])
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k].numpy(), theirs[k], err_msg=k)


@pytest.mark.parametrize("size", ["tiny", "full"])
def test_params_from_jax_inverts_convert_state_dict(size, full_net):
    if size == "tiny":
        _, tc = tiny_configs()
        net = TNet(tc.model, TSE3(tc.diffuser, device="cpu"), inpainting=True)
        blocks, layers = 2, 1
    else:
        net, blocks, layers = full_net, 4, 2
    sd = fixture_lib.synth_state_dict([(k, list(v.shape)) for k, v in net.state_dict().items()])
    back = params_from_jax(convert_state_dict(sd, num_blocks=blocks, seq_tfmr_layers=layers),
                           num_blocks=blocks, seq_tfmr_layers=layers)
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        if any(u in k for u in UNREAD):  # not in the JAX tree: zeros
            assert not back[k].any()
        else:
            np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    net.load_state_dict(back, strict=True)


def test_params_from_jax_takes_flax_initialized_params():
    """The flax tree as the JAX model initializes it (not via the importer)."""
    jc, tc = tiny_configs()
    feats = {k: jnp.asarray(v) for k, v in make_feats(B=1, N=8).items()}
    params = jax.jit(JNet(jc.model, JSE3(jc.diffuser), inpainting=True).init)(
        jax.random.PRNGKey(0), feats
    )
    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, params), num_blocks=2, seq_tfmr_layers=1)
    net = TNet(tc.model, TSE3(tc.diffuser, device="cpu"), inpainting=True)
    net.load_state_dict(sd, strict=True)
    w = params["params"]["score_model"]["ipa_1"]["linear_q"]["dense"]["kernel"]
    np.testing.assert_array_equal(
        net.score_model.trunk["ipa_1"].linear_q.weight.detach().numpy(), np.asarray(w).T
    )


def test_load_reference_checkpoint_strips_ddp_prefix(tmp_path):
    _, tc = tiny_configs()
    net = TNet(tc.model, TSE3(tc.diffuser, device="cpu"), inpainting=True)
    sd = synth_state_dict(net, seed=3)
    path = tmp_path / "ckpt.pth"
    torch.save({"model": {f"module.{k}": v for k, v in sd.items()},
                "conf": {"model": {"node_embed_size": 32}}, "step": 7}, path)
    loaded, conf = load_reference_checkpoint(str(path))
    assert conf == {"model": {"node_embed_size": 32}}
    net.load_state_dict(loaded, strict=True)
    for k, v in sd.items():
        assert torch.equal(net.state_dict()[k], v)
