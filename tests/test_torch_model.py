"""The port's Embedder, IPA, EdgeTransition and ScoreNetwork against the JAX
package, with the same weights (flax params -> ``params_from_jax``, and a
torch-layout state_dict -> ``convert_state_dict``), at a small config; and
one full-width forward against the recorded reference activations.

Outputs agree within 1e-4 relative on the scale max(1, |ref|) in float32;
bf16 modules within 5e-2."""
import functools
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from framedipt_tpu.diffusion import SE3Diffuser as JSE3
from framedipt_tpu.geometry.rigid import Rigid as JRigid
from framedipt_tpu.model import ScoreNetwork as JNet
from framedipt_tpu.model.embed import Embedder as JEmbedder
from framedipt_tpu.model.import_torch import convert_state_dict
from framedipt_tpu.model.ipa import EdgeTransition as JEdgeTransition
from framedipt_tpu.model.ipa import InvariantPointAttention as JIPA
from framedipt_tpu.tools.config import Config as JConfig
from framedipt_tpu.tools.config import SO3Config as JSO3Config

from framedipt_tpu_torch.diffusion import SE3Diffuser as TSE3
from framedipt_tpu_torch.geometry.rigid import Rigid as TRigid
from framedipt_tpu_torch.model import ScoreNetwork as TNet
from framedipt_tpu_torch.model.embed import Embedder as TEmbedder
from framedipt_tpu_torch.model.ipa import EdgeTransition as TEdgeTransition
from framedipt_tpu_torch.model.weights import params_from_jax
from framedipt_tpu_torch.tools.config import Config as TConfig
from framedipt_tpu_torch.tools.config import SO3Config as TSO3Config

from tests.parity import fixture_lib

TINY = {
    "node_embed_size": 32, "edge_embed_size": 16,
    "ipa.c_s": 32, "ipa.c_z": 16, "ipa.c_hidden": 16, "ipa.c_skip": 8, "ipa.no_heads": 2,
    "ipa.no_qk_points": 4, "ipa.no_v_points": 4, "ipa.num_blocks": 2,
    "ipa.seq_tfmr_num_layers": 1, "ipa.seq_tfmr_num_heads": 2,
}


def tiny_configs(self_conditioning: bool = True, dtype: str = "float32"):
    """(JAX Config, port Config) at the small test size. The JAX model runs
    its XLA formulation; the port's kernel wrappers take their plain versions
    for CPU tensors."""
    jc, tc = JConfig(), TConfig()
    jc.diffuser.so3 = JSO3Config(num_omega=50, num_sigma=20, cache_dir=None)
    tc.diffuser.so3 = TSO3Config(num_omega=50, num_sigma=20, cache_dir=None)
    for cfg in (jc, tc):
        cfg.model.compute_dtype = dtype
        cfg.model.embed.embed_self_conditioning = self_conditioning
        for key, value in TINY.items():
            node = cfg.model
            *parents, leaf = key.split(".")
            for p in parents:
                node = getattr(node, p)
            setattr(node, leaf, value)
    jc.model.ipa.use_pallas_kernel = jc.model.ipa.use_pallas_embedder = False
    return jc, tc


def make_feats(seed=0, B=2, N=22):
    rng = np.random.default_rng(seed)
    qs = rng.normal(size=(B, N, 4)).astype(np.float32)
    qs /= np.linalg.norm(qs, axis=-1, keepdims=True)
    fixed = np.ones((B, N), np.float32)
    fixed[:, 6:13] = 0.0
    res = np.ones((B, N), np.float32)
    res[B - 1, -4:] = 0.0  # padded tail of the last sample
    return {
        "res_mask": res, "fixed_mask": fixed,
        "seq_idx": np.tile(np.arange(N), (B, 1)),
        "t": np.asarray([0.8, 0.25], np.float32)[:B],
        "sc_ca_t": (rng.normal(size=(B, N, 3)) * 6).astype(np.float32),
        "rigids_t": np.concatenate(
            [qs, (rng.normal(size=(B, N, 3)) * 6).astype(np.float32)], axis=-1),
        "torsion_angles_sin_cos": rng.normal(size=(B, N, 7, 2)).astype(np.float32),
        "aatype": rng.integers(0, 20, size=(B, N)),
    }


def rel_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(1.0, float(np.abs(want).max())))


def perturbed(params, seed, scale=0.05, final_scale=1e-3):
    """Every leaf non-zero (the zero-initialized final layers too). The
    frame-update and psi heads stay damped: at full scale their feedback
    makes the trunk chaotic (tests/parity/fixture_lib.py), and jit and eager
    JAX then disagree with each other by O(1)."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = jax.tree_util.keystr(path)
        s = final_scale if ("bb_update" in name or "linear_final" in name) else scale
        return np.asarray(x) + s * rng.normal(size=x.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, params)


@pytest.fixture(scope="module")
def jax_params_and_models():
    """Flax-initialized, perturbed JAX params and both ScoreNetworks."""
    jc, tc = tiny_configs()
    jnet = JNet(jc.model, JSE3(jc.diffuser), inpainting=True)
    feats = make_feats()
    params = jax.jit(jnet.init)(jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in feats.items()})
    params = perturbed(params, 1)
    tnet = TNet(tc.model, TSE3(tc.diffuser, device="cpu"), inpainting=True)
    tnet.load_state_dict(params_from_jax(params, num_blocks=2, seq_tfmr_layers=1), strict=True)
    return jc, tc, params, jnet, tnet


@pytest.mark.parametrize("self_conditioning", [False, True])
def test_embedder_matches_jax(jax_params_and_models, self_conditioning):
    """Without self-conditioning the edge branch has no distogram: the
    edge-embedder wrapper gets zero distance bins."""
    _, _, params, _, _ = jax_params_and_models
    jc, tc = tiny_configs(self_conditioning)
    feats = make_feats(3)
    aatype = np.where(feats["fixed_mask"] > 0.5, feats["aatype"], 20)
    jemb = JEmbedder(jc.model, inpainting=True, dtype=jnp.float32)
    inputs = dict(
        seq_idx=jnp.asarray(feats["seq_idx"]), t=jnp.asarray(feats["t"]),
        fixed_mask=jnp.asarray(feats["fixed_mask"]),
        self_conditioning_ca=jnp.asarray(feats["sc_ca_t"]), aatype=jnp.asarray(aatype),
    )
    if self_conditioning:
        emb_params = params["params"]["embedding_layer"]
    else:
        emb_params = perturbed(jemb.init(jax.random.PRNGKey(2), **inputs), 3)["params"]
    node_j, edge_j = jemb.apply({"params": emb_params}, **inputs)
    mask = feats["res_mask"]
    edge_j = np.asarray(edge_j) * (mask[:, :, None] * mask[:, None, :])[..., None]

    sd = params_from_jax({"embedding_layer": emb_params,
                          "score_model": params["params"]["score_model"]},
                         num_blocks=2, seq_tfmr_layers=1)
    prefix = "embedding_layer."
    emb = TEmbedder(tc.model, inpainting=True, dtype=torch.float32)
    emb.load_state_dict({k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)},
                        strict=True)
    with torch.no_grad():
        node_t, edge_t = emb(
            torch.as_tensor(feats["seq_idx"]), torch.as_tensor(feats["t"]),
            torch.as_tensor(feats["fixed_mask"]), torch.as_tensor(feats["sc_ca_t"]),
            torch.as_tensor(aatype), torch.as_tensor(mask),
        )
    assert rel_err(node_t, node_j) < 1e-4
    assert rel_err(edge_t, edge_j) < 1e-4


@pytest.mark.parametrize("padded", [False, True])
def test_edge_transition_matches_jax(jax_params_and_models, padded):
    jc, _, params, _, tnet = jax_params_and_models
    rng = np.random.default_rng(4)
    B, N = 2, 19
    node = rng.normal(size=(B, N, 32)).astype(np.float32)
    edge = rng.normal(size=(B, N, N, 16)).astype(np.float32)
    mask = np.ones((B, N), np.float32)
    if padded:
        mask[:, -3:] = 0.0
    jet = JEdgeTransition(node_embed_size=32, edge_embed_out=16)
    want = jet.apply({"params": params["params"]["score_model"]["edge_transition_0"]},
                     jnp.asarray(node), jnp.asarray(edge), node_mask=jnp.asarray(mask))
    et = tnet.score_model.trunk["edge_transition_0"]
    with torch.no_grad():
        got = et(torch.as_tensor(node), torch.as_tensor(edge), torch.as_tensor(mask))
    assert rel_err(got, want) < 1e-4


def test_edge_transition_bf16_matches_jax(jax_params_and_models):
    _, _, params, _, _ = jax_params_and_models
    rng = np.random.default_rng(5)
    B, N = 1, 16
    node = rng.normal(size=(B, N, 32)).astype(np.float32)
    edge = rng.normal(size=(B, N, N, 16)).astype(np.float32)
    mask = np.ones((B, N), np.float32)
    p = params["params"]["score_model"]["edge_transition_0"]
    jet = JEdgeTransition(node_embed_size=32, edge_embed_out=16, dtype=jnp.bfloat16)
    want = jet.apply({"params": p}, jnp.asarray(node, jnp.bfloat16),
                     jnp.asarray(edge, jnp.bfloat16), node_mask=jnp.asarray(mask, jnp.bfloat16))
    et = TEdgeTransition(32, 16, 16, torch.bfloat16)
    sd = params_from_jax(params, num_blocks=2, seq_tfmr_layers=1)
    prefix = "score_model.trunk.edge_transition_0."
    et.load_state_dict({k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)})
    with torch.no_grad():
        got = et(torch.as_tensor(node).bfloat16(), torch.as_tensor(edge).bfloat16(),
                 torch.as_tensor(mask))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=5e-2, rtol=5e-2)


def test_ipa_matches_jax(jax_params_and_models):
    jc, _, params, _, tnet = jax_params_and_models
    rng = np.random.default_rng(6)
    B, N = 2, 17
    s = rng.normal(size=(B, N, 32)).astype(np.float32)
    z = rng.normal(size=(B, N, N, 16)).astype(np.float32)
    qs = rng.normal(size=(B, N, 4)).astype(np.float32)
    qs /= np.linalg.norm(qs, axis=-1, keepdims=True)
    tr = rng.normal(size=(B, N, 3)).astype(np.float32)
    mask = np.ones((B, N), np.float32)
    mask[1, -5:] = 0.0
    jipa = JIPA(jc.model.ipa)
    want = jipa.apply({"params": params["params"]["score_model"]["ipa_0"]}, jnp.asarray(s),
                      jnp.asarray(z), JRigid(jnp.asarray(qs), jnp.asarray(tr)), jnp.asarray(mask))
    with torch.no_grad():
        got = tnet.score_model.trunk["ipa_0"](
            torch.as_tensor(s), torch.as_tensor(z), TRigid(torch.as_tensor(qs), torch.as_tensor(tr)),
            torch.as_tensor(mask),
        )
    assert rel_err(got, want) < 1e-4


def _assert_outputs_close(got, want):
    for key in ("psi", "rot_score", "trans_score", "atom37", "rigids"):
        assert rel_err(got[key], want[key]) < 1e-4, key


@functools.cache
def _reference_forward(self_conditioning: bool):
    jc, tc = tiny_configs(self_conditioning)
    tnet = TNet(tc.model, TSE3(tc.diffuser, device="cpu"), inpainting=True)
    sd = fixture_lib.synth_state_dict([(k, list(v.shape)) for k, v in tnet.state_dict().items()])
    params = convert_state_dict(sd, num_blocks=2, seq_tfmr_layers=1)
    jnet = JNet(jc.model, JSE3(jc.diffuser), inpainting=True)
    feats = make_feats(7)
    want = jnet.apply(params, {k: jnp.asarray(v) for k, v in feats.items()})
    return tc, sd, params, feats, want


@pytest.fixture(scope="module")
def reference_forward():
    """A torch-layout state_dict (every tensor non-zero, final layers damped
    as tests/parity/fixture_lib.py does), its JAX params through
    convert_state_dict, and the JAX ScoreNetwork's output on a batch.

    The JAX forward runs op by op (not under jit): with the trunk's frame
    feedback, XLA's fused reassociation alone moves the JAX outputs by up to
    1e-4 at this damping, while the op-by-op forward is the same sequence of
    float32 operations the port runs."""
    return _reference_forward(True)


@pytest.mark.parametrize("self_conditioning", [False, True])
def test_score_network_matches_jax_from_torch_state_dict(self_conditioning):
    """A torch-layout state_dict goes two ways: into the port with
    strict=True, and through convert_state_dict into JAX; both agree. With
    and without the self-conditioning distogram (references as in the
    ``reference_forward`` fixture)."""
    tc, sd, _, feats, want = _reference_forward(self_conditioning)
    tnet = TNet(tc.model, TSE3(tc.diffuser, device="cpu"), inpainting=True)
    tnet.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = tnet({k: torch.as_tensor(v) for k, v in feats.items()})
    _assert_outputs_close(got, want)


def test_score_network_matches_jax_params_from_jax(reference_forward):
    """JAX params -> params_from_jax -> the port computes JAX's function."""
    tc, _, params, feats, want = reference_forward
    tnet = TNet(tc.model, TSE3(tc.diffuser, device="cpu"), inpainting=True)
    tnet.load_state_dict(params_from_jax(params, num_blocks=2, seq_tfmr_layers=1), strict=True)
    with torch.no_grad():
        got = tnet({k: torch.as_tensor(v) for k, v in feats.items()})
    _assert_outputs_close(got, want)


def test_full_width_forward_matches_recorded_reference():
    """Default config (4 blocks, c_s 256, edge width 128), N=128, weights
    synth_state_dict(param_manifest) loaded with strict=True, against the
    recorded reference activations at the tolerances of
    tests/parity/test_recorded_parity.py."""
    npz = np.load(fixture_lib.FIXTURE)
    manifest = fixture_lib.load_manifest(npz)
    cfg = TConfig()
    net = TNet(cfg.model, TSE3(cfg.diffuser, device="cpu"), inpainting=True)
    net.load_state_dict(
        {k: torch.as_tensor(v) for k, v in fixture_lib.synth_state_dict(manifest).items()},
        strict=True,
    )
    feats = {k[len("feat::"):]: torch.as_tensor(npz[k]) for k in npz.files if k.startswith("feat::")}
    with torch.no_grad():
        out = net(feats)
    for key, tol in (("psi", 1e-3), ("atom37", 5e-3), ("rot_score", 5e-3), ("trans_score", 5e-3)):
        assert rel_err(out[key], npz[f"out::{key}"]) < tol, key
    assert json.loads(str(npz["param_manifest"]))[0][0] in net.state_dict()
