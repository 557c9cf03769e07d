"""The port's ProteinMPNN (framedipt_tpu_torch/model/mpnn.py) against the
JAX package's (framedipt_tpu/model/mpnn.py) and against the recorded
reference ProteinMPNN (tests/parity/fixtures/recorded_mpnn_parity.npz and
recorded_mpnn_ca_parity.npz, weights synthesised from their manifests),
vanilla and CA-only, on the CPU:

- the neighbour lists equal JAX's (a padded row and exact ties included);
- the features and the encoder within 1e-5; the CA-only model's
  quaternion features, and the edge embeddings that mix them in, within
  1e-3: a quaternion component near 0 is 0.5 sqrt(|1 + Rxx - Ryy - Rzz|)
  of an argument near 0, which turns one ulp of the rotation product into
  ~3e-4 in any two implementations (at a residue's own neighbour slot,
  where the relative rotation is the identity, always);
- every log-probability variant and the scores within 2e-4 of JAX's and of
  the recording (the CA-only recording within the JAX test's 3e-2);
- the near-greedy sample (temperature 1e-4) equal to JAX's and the
  recording's, S and decoding order; the tied sample and the PSSM probs as
  recorded;
- at the default temperature 0.1 the sampled probs equal the softmax of the
  teacher-forced log-probabilities on the sample's own S and order;
- masks and omit: positions not designed keep S, X is never sampled;
- weights both ways: the JAX initialization -> ``mpnn_state_dict_from_jax``
  -> the port computes JAX's log-probabilities, and the port's state_dict
  -> ``convert_mpnn_state_dict`` gives back JAX's params.
"""
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from framedipt_tpu.model import mpnn as J

from framedipt_tpu_torch.model import mpnn as T
from framedipt_tpu_torch.model.weights import synth_value
from tests.torch_threads import one_torch_thread  # noqa: F401

FIXTURES = pathlib.Path(__file__).parent / "parity" / "fixtures"
LP_TOL = 2e-4

# The JAX references compiled whole: eager JAX compiles a program for every
# op it meets, which costs more than one compile of the function.
_static = {"static_argnames": ("cfg",)}
j_features = jax.jit(J.mpnn_features, **_static)
j_features_ca = jax.jit(J.mpnn_features_ca, **_static)
j_encode = jax.jit(J.mpnn_encode, **_static)
j_orientations = jax.jit(J._orientations_coarse)
j_log_probs = jax.jit(J.mpnn_log_probs, **_static)
j_unconditional = jax.jit(J.mpnn_unconditional_log_probs, **_static)


def _load(fixture: str, ca_only: bool):
    data = np.load(FIXTURES / fixture, allow_pickle=False)
    names = [str(n) for n in data["manifest_names"]]
    shapes = [tuple(int(x) for x in s.split(",")) for s in data["manifest_shapes"]]
    sd = {n: synth_value(n, shape, seed=int(data["seed"])) for n, shape in zip(names, shapes)}
    model = T.ProteinMPNN(T.MPNNConfig(k_neighbors=48, ca_only=ca_only))
    model.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()}, strict=True)
    params = jax.tree.map(jnp.asarray, J.convert_mpnn_state_dict(sd))
    cfg = J.MPNNConfig(k_neighbors=48, ca_only=ca_only)
    feats = {k.removeprefix("in_"): data[k] for k in data.files if k.startswith("in_")}
    return {"data": data, "model": model.eval(), "params": params, "cfg": cfg, "f": feats,
            "t": {k: torch.as_tensor(v) for k, v in feats.items()}}


@pytest.fixture(scope="module")
def vanilla():
    return _load("recorded_mpnn_parity.npz", ca_only=False)


@pytest.fixture(scope="module")
def ca_model():
    return _load("recorded_mpnn_ca_parity.npz", ca_only=True)


@pytest.fixture(scope="module")
def jax_samples(vanilla):
    """The JAX samples of the recorded fixture, one jit each: near-greedy
    and tied near-greedy."""
    d, p, cfg, f = vanilla["data"], vanilla["params"], vanilla["cfg"], vanilla["f"]
    args = (jnp.asarray(f["X"]),)
    rest = (jnp.asarray(f["S"]), jnp.asarray(f["chain_M"]), jnp.asarray(f["chain_encoding_all"]),
            jnp.asarray(f["residue_idx"]), jnp.asarray(f["mask"]), cfg)
    greedy = jax.jit(lambda key: J.mpnn_sample(
        p, key, *args, jnp.asarray(d["randn_smp"]), *rest, temperature=1e-4))(
        jax.random.PRNGKey(3))
    tied_pos = tuple(tuple(int(x) for x in row) for row in d["tied_pos"])
    tied = jax.jit(lambda key: J.mpnn_tied_sample(
        p, key, *args, jnp.asarray(d["randn_tied"]), *rest, tied_pos, temperature=1e-4))(
        jax.random.PRNGKey(6))
    return {k: {n: np.asarray(v) for n, v in out.items()}
            for k, out in (("greedy", greedy), ("tied", tied))}


def _jax_inputs(f):
    return (f["X"], f["mask"], f["residue_idx"], f["chain_encoding_all"])


def test_knn_equals_jax_with_padding_and_ties():
    rng = np.random.default_rng(0)
    ca = (rng.normal(size=(2, 20, 3)) * 5).astype(np.float32)
    # Row 0: residues 3 and 7 both at the same distance from residue 0 (a
    # mirror pair), residue 9 a copy of residue 4.
    ca[0, 7] = 2 * ca[0, 0] - ca[0, 3]
    ca[0, 9] = ca[0, 4]
    mask = np.ones((2, 20), np.float32)
    mask[1, 15:] = 0.0  # a padded tail: all its pairs tie at the row maximum
    for k in (6, 20):
        dj, ij = J._knn(jnp.asarray(ca), jnp.asarray(mask), k)
        dt, it = T._knn(torch.as_tensor(ca), torch.as_tensor(mask), k)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-6, atol=1e-6)
    # The ties are there: equal distances, the lower index first.
    row = dt.numpy()[1, 16]
    assert (row[:-1] <= row[1:]).all() and (np.diff(row) == 0).sum() >= 10


@pytest.mark.parametrize("which", ["vanilla", "ca_model"])
def test_features_and_encoder_match_jax(which, request):
    m = request.getfixturevalue(which)
    model, params, cfg, f, t = m["model"], m["params"], m["cfg"], m["f"], m["t"]
    x_j, mask, res_idx, chains = _jax_inputs(f)
    with torch.no_grad():
        if cfg.ca_only:
            ej, ij = j_features_ca(params["features"], x_j[:, :, 1], mask, res_idx, chains,
                                   cfg=cfg)
            et, it = T.mpnn_features_ca(model, t["X"][:, :, 1], t["mask"], t["residue_idx"],
                                        t["chain_encoding_all"])
        else:
            ej, ij = j_features(params["features"], x_j, mask, res_idx, chains, cfg=cfg)
            et, it = T.mpnn_features(model, t["X"], t["mask"], t["residue_idx"],
                                     t["chain_encoding_all"])
        hj = j_encode(params, x_j, mask, res_idx, chains, cfg=cfg)
        ht = T.mpnn_encode(model, t["X"], t["mask"], t["residue_idx"], t["chain_encoding_all"])
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(ht[2].numpy(), np.asarray(hj[2]))
    tol = 1e-5
    if cfg.ca_only:
        # The orientation features: directions within 1e-5, quaternions
        # within 1e-3; the edge embeddings mix the quaternions in.
        ad_j, o_j = j_orientations(x_j[:, :, 1], ij)
        ad_t, o_t = T._orientations_coarse(t["X"][:, :, 1], it)
        np.testing.assert_allclose(ad_t.numpy(), np.asarray(ad_j), atol=1e-5, rtol=0)
        np.testing.assert_allclose(o_t[..., :3].numpy(), np.asarray(o_j)[..., :3], atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(o_t[..., 3:].numpy(), np.asarray(o_j)[..., 3:], atol=1e-3,
                                   rtol=0)
        tol = 1e-3
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), atol=tol, rtol=0)
    np.testing.assert_allclose(ht[1].numpy(), np.asarray(hj[1]), atol=tol, rtol=0)
    np.testing.assert_allclose(ht[0].numpy(), np.asarray(hj[0]), atol=1e-5, rtol=0)


@pytest.mark.parametrize("order", ["randn", "fixed"])
def test_log_probs_and_scores(vanilla, order):
    d, model, params, cfg, f, t = (vanilla[k] for k in ("data", "model", "params", "cfg", "f", "t"))
    kw_j = ({"randn": jnp.asarray(d["randn_fwd"])} if order == "randn"
            else {"decoding_order": jnp.asarray(d["order_fixed"])})
    kw_t = {k: torch.as_tensor(np.array(v)) for k, v in kw_j.items()}
    lp_j = j_log_probs(params, f["X"], f["S"], f["mask"], f["chain_M"], f["residue_idx"],
                       f["chain_encoding_all"], cfg=cfg, **kw_j)
    with torch.no_grad():
        lp_t = T.mpnn_log_probs(model, t["X"], t["S"], t["mask"], t["chain_M"],
                                t["residue_idx"], t["chain_encoding_all"], **kw_t)
    want = d["log_probs_rand"] if order == "randn" else d["log_probs_fixed"]
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), atol=LP_TOL, rtol=LP_TOL)
    np.testing.assert_allclose(lp_t.numpy(), want, atol=LP_TOL, rtol=LP_TOL)
    if order == "randn":
        sc = T.mpnn_scores(t["S"], lp_t, t["mask"] * t["chain_M"]).numpy()
        np.testing.assert_allclose(sc, d["scores"], atol=LP_TOL)
        np.testing.assert_allclose(
            sc, np.asarray(J.mpnn_scores(f["S"], lp_j, f["mask"] * f["chain_M"])), atol=LP_TOL)


def test_unconditional_log_probs(vanilla):
    d, model, params, cfg, f, t = (vanilla[k] for k in ("data", "model", "params", "cfg", "f", "t"))
    lp_j = j_unconditional(params, *_jax_inputs(f), cfg=cfg)
    with torch.no_grad():
        lp_t = T.mpnn_unconditional_log_probs(model, t["X"], t["mask"], t["residue_idx"],
                                              t["chain_encoding_all"])
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), atol=LP_TOL, rtol=LP_TOL)
    np.testing.assert_allclose(lp_t.numpy(), d["log_probs_uncond"], atol=LP_TOL, rtol=LP_TOL)


@pytest.mark.parametrize("backbone_only", [False, True])
def test_conditional_log_probs(vanilla, backbone_only):
    d, model, t = vanilla["data"], vanilla["model"], vanilla["t"]
    with torch.no_grad():
        lp = T.mpnn_conditional_log_probs(
            model, t["X"], t["S"], t["mask"], t["chain_M"], t["residue_idx"],
            t["chain_encoding_all"], torch.as_tensor(d["randn_cond"]),
            backbone_only=backbone_only, chunk=8).numpy()
    want = d["log_probs_cond_bb" if backbone_only else "log_probs_cond"]
    np.testing.assert_allclose(lp, want, atol=LP_TOL, rtol=LP_TOL)
    assert np.all(lp[(vanilla["f"]["chain_M"] * vanilla["f"]["mask"]) == 0] == 0.0)


def test_ca_log_probs(ca_model):
    d, model, params, cfg, f, t = (ca_model[k] for k in ("data", "model", "params", "cfg", "f", "t"))
    lp_j = np.asarray(j_log_probs(params, f["X"], f["S"], f["mask"], f["chain_M"],
                                  f["residue_idx"], f["chain_encoding_all"], cfg=cfg,
                                  randn=jnp.asarray(d["randn_fwd"])))
    with torch.no_grad():
        lp_t = T.mpnn_log_probs(model, t["X"], t["S"], t["mask"], t["chain_M"], t["residue_idx"],
                                t["chain_encoding_all"],
                                randn=torch.as_tensor(d["randn_fwd"])).numpy()
    np.testing.assert_allclose(lp_t, lp_j, atol=LP_TOL, rtol=LP_TOL)
    # Against the recording at the JAX test's tolerance (see its docstring).
    np.testing.assert_allclose(lp_t, d["log_probs_rand"], atol=3e-2, rtol=1e-2)
    valid = f["mask"][0] > 0
    np.testing.assert_array_equal(lp_t[0, valid].argmax(-1),
                                  d["log_probs_rand"][0, valid].argmax(-1))


def _sample(m, randn, **kw):
    t = m["t"]
    return T.mpnn_sample(m["model"], torch.Generator().manual_seed(kw.pop("seed", 0)), t["X"],
                         torch.as_tensor(randn), t["S"], kw.pop("chain_M", t["chain_M"]),
                         t["chain_encoding_all"], t["residue_idx"], t["mask"], **kw)


@pytest.mark.parametrize("which", ["vanilla", "ca_model"])
def test_near_greedy_sample(which, request, jax_samples):
    m = request.getfixturevalue(which)
    d = m["data"]
    out = _sample(m, d["randn_smp"], temperature=1e-4)
    np.testing.assert_array_equal(out["decoding_order"].numpy(), d["sample_order"])
    np.testing.assert_array_equal(out["S"].numpy(), d["sample_S"])
    if which == "vanilla":
        np.testing.assert_array_equal(out["S"].numpy(), jax_samples["greedy"]["S"])
        np.testing.assert_array_equal(out["decoding_order"].numpy(),
                                      jax_samples["greedy"]["decoding_order"])


def test_tied_sample(vanilla, jax_samples):
    d, t = vanilla["data"], vanilla["t"]
    tied_pos = tuple(tuple(int(x) for x in row) for row in d["tied_pos"])
    out = T.mpnn_tied_sample(vanilla["model"], torch.Generator().manual_seed(6), t["X"],
                             torch.as_tensor(d["randn_tied"]), t["S"], t["chain_M"],
                             t["chain_encoding_all"], t["residue_idx"], t["mask"], tied_pos,
                             temperature=1e-4)
    got = {k: v.numpy() for k, v in out.items()}
    np.testing.assert_array_equal(got["decoding_order"], d["sample_tied_order"])
    np.testing.assert_array_equal(got["S"], d["sample_tied_S"])
    np.testing.assert_allclose(got["probs"], d["sample_tied_probs"], atol=LP_TOL, rtol=LP_TOL)
    for k in ("S", "decoding_order"):
        np.testing.assert_array_equal(got[k], jax_samples["tied"][k])
    np.testing.assert_allclose(got["probs"], jax_samples["tied"]["probs"], atol=LP_TOL,
                               rtol=LP_TOL)
    for a, b in tied_pos:
        assert got["S"][0, a] == got["S"][0, b]


def test_pssm_restrained_probs(vanilla):
    """Every position fixed but one, whose post-PSSM distribution (bias mix,
    then the log-odds renormalisation) is then deterministic."""
    d, f = vanilla["data"], vanilla["f"]
    pos = int(d["pssm_pos"])
    chain_m_pos = np.zeros_like(f["chain_M"])
    chain_m_pos[:, pos] = 1.0
    out = _sample(vanilla, d["randn_pssm"], seed=5, temperature=0.2,
                  chain_m_pos=torch.as_tensor(chain_m_pos),
                  pssm_coef=torch.as_tensor(d["pssm_coef"]),
                  pssm_bias=torch.as_tensor(d["pssm_bias"]), pssm_multi=0.7,
                  pssm_log_odds_mask=torch.as_tensor(d["pssm_log_odds_mask"]))
    probs, s = out["probs"].numpy(), out["S"].numpy()
    np.testing.assert_allclose(probs[:, pos], d["sample_pssm_probs"][:, pos], atol=LP_TOL,
                               rtol=LP_TOL)
    assert np.all(np.delete(probs, pos, axis=1) == 0.0)
    keep = np.arange(s.shape[1]) != pos
    np.testing.assert_array_equal(s[:, keep], f["S"][:, keep])


def test_default_temperature_probs_equal_teacher_forced(vanilla):
    """At temperature 0.1 the draws differ from JAX's (another generator),
    so the sample is held against the port's own teacher-forced pass on its
    S and decoding order: each designed row's probs are the softmax of
    log_probs / 0.1 with X omitted."""
    t = vanilla["t"]
    out = _sample(vanilla, np.random.default_rng(1).normal(size=t["S"].shape), temperature=0.1,
                  seed=11)
    with torch.no_grad():
        lp = T.mpnn_log_probs(vanilla["model"], t["X"], out["S"], t["mask"], t["chain_M"],
                              t["residue_idx"], t["chain_encoding_all"],
                              decoding_order=out["decoding_order"])
    logits = lp / 0.1
    logits[..., T.MPNN_ALPHABET.index("X")] -= 1e8
    want = torch.softmax(logits, dim=-1)
    designed = (t["chain_M"] * t["mask"]) > 0
    torch.testing.assert_close(out["probs"][designed], want[designed], atol=1e-5, rtol=1e-4)


def test_sample_respects_masks_and_omit(vanilla):
    d, f = vanilla["data"], vanilla["f"]
    chain_m = f["chain_M"].copy()
    chain_m[:, :10] = 0.0  # the first 10 positions visible
    out = _sample(vanilla, d["randn_smp"], seed=4, temperature=0.2,
                  chain_M=torch.as_tensor(chain_m))
    s, probs = out["S"].numpy(), out["probs"].numpy()
    eff = chain_m * f["mask"]
    fixed = eff == 0
    np.testing.assert_array_equal(s[fixed], f["S"][fixed])
    assert not np.any(s[eff > 0] == T.MPNN_ALPHABET.index("X"))
    assert np.all(probs[fixed] == 0)
    np.testing.assert_allclose(probs[eff > 0].sum(-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("ca_only", [False, True])
def test_weights_both_ways(vanilla, ca_only):
    """JAX's init_mpnn_params -> mpnn_state_dict_from_jax -> the port
    (strict) computes JAX's log-probabilities; the port's state_dict ->
    JAX's convert_mpnn_state_dict gives back JAX's params, leaf for leaf."""
    f, t = vanilla["f"], vanilla["t"]
    cfg = J.MPNNConfig(k_neighbors=48, ca_only=ca_only)
    params = J.init_mpnn_params(jax.random.PRNGKey(1), cfg)
    model = T.ProteinMPNN(T.MPNNConfig(k_neighbors=48, ca_only=ca_only))
    model.load_state_dict(T.mpnn_state_dict_from_jax(params), strict=True)
    randn = np.random.default_rng(2).normal(size=f["S"].shape).astype(np.float32)
    lp_j = np.asarray(j_log_probs(params, f["X"], f["S"], f["mask"], f["chain_M"],
                                  f["residue_idx"], f["chain_encoding_all"], cfg=cfg,
                                  randn=jnp.asarray(randn)))
    with torch.no_grad():
        lp_t = T.mpnn_log_probs(model, t["X"], t["S"], t["mask"], t["chain_M"],
                                t["residue_idx"], t["chain_encoding_all"],
                                randn=torch.as_tensor(randn)).numpy()
    np.testing.assert_allclose(lp_t, lp_j, atol=LP_TOL, rtol=LP_TOL)
    back = J.convert_mpnn_state_dict({k: v.numpy() for k, v in model.state_dict().items()})
    leaves, tree = jax.tree.flatten(params)
    back_leaves, back_tree = jax.tree.flatten(back)
    assert back_tree == tree
    for got, want in zip(back_leaves, leaves):
        np.testing.assert_array_equal(got, np.asarray(want))
    assert T.config_from_state_dict(model.state_dict()) == model.cfg
