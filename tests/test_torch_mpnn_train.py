"""ProteinMPNN training in the port (framedipt_tpu_torch/train/mpnn_train.py
and the training mode of framedipt_tpu_torch/model/mpnn.py) against the JAX
package's (framedipt_tpu/train/mpnn_train.py, framedipt_tpu/model/mpnn.py)
on the CPU, at hidden 32, one encoder and one decoder layer, 8 neighbours:

- the Noam schedule over counts 0-50, ``smoothed_loss`` and
  ``nll_and_accuracy`` within 1e-6;
- the train step's loss and every gradient, JAX's initialization through
  ``mpnn_state_dict_from_jax``, with JAX's decoding-order ``randn`` and
  backbone noise handed in and dropout 0, within 1e-5 of each gradient's
  max-abs (the JAX side ``jax.value_and_grad`` of ``mpnn_log_probs`` plus
  ``smoothed_loss``), and the whole step's metrics against JAX's step;
- the parameters after 1 and 3 Adam steps on the same gradients within 1e-6
  of optax's, with and without clipping;
- dropout: identity outside training and at rate 0, the same masks under
  one seed, the keep rate and the 1/keep scale;
- the initializer's distributions against JAX's;
- the eval step against JAX's;
- ``augment_eps`` 0 honoured (JAX's step replaces it with 0.2).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from framedipt_tpu.model import mpnn as J
from framedipt_tpu.train import mpnn_train as JT

from framedipt_tpu_torch.model import mpnn as T
from framedipt_tpu_torch.train import mpnn_train as TT
from tests.unit.mpnn_helpers import synth_structure
from tests.torch_threads import one_torch_thread  # noqa: F401

SMALL = dict(hidden_dim=32, num_encoder_layers=1, num_decoder_layers=1, k_neighbors=8)
GRAD_TOL = 1e-5
# Compiled whole: eager JAX compiles a program for every op it meets.
j_log_probs = jax.jit(J.mpnn_log_probs, static_argnames=("cfg",))


def _batch_np() -> dict[str, np.ndarray]:
    """B=2: the two-chain synthetic structure (53 residues, two missing),
    and a moved copy with its first chain not designed and its last six
    residues masked."""
    f = synth_structure()
    other = {k: v.copy() for k, v in f.items()}
    other["X"] = other["X"] @ np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                                       np.float32) + np.float32(3.0)
    other["chain_M"][0, :31] = 0.0
    other["mask"][0, -6:] = 0.0
    return {k: np.concatenate([f[k], other[k]]) for k in f}


def _torch(b: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v) for k, v in b.items()}


def _model(cfg: T.MPNNConfig, params) -> T.ProteinMPNN:
    model = T.ProteinMPNN(cfg)
    model.load_state_dict(T.mpnn_state_dict_from_jax(params), strict=True)
    return model


def _state(params, opt) -> JT.MPNNTrainState:
    """A JAX train state on a copy of ``params`` (the JAX step donates its
    state)."""
    params = jax.tree.map(jnp.array, params)
    return JT.MPNNTrainState(params, opt.init(params), jnp.zeros((), jnp.int32))


def _jax_args(b):
    return (b["X"], b["S"], b["mask"], b["chain_M"], b["residue_idx"], b["chain_encoding_all"])


def _grad_errors(model: T.ProteinMPNN, jax_grads) -> dict[str, float]:
    """Per parameter: max |port grad - JAX grad| over the JAX grad's max-abs."""
    want = T.mpnn_state_dict_from_jax(jax_grads)
    errs = {}
    for name, p in model.named_parameters():
        ref = want[name].numpy()
        errs[name] = float(np.abs(p.grad.numpy() - ref).max() / max(np.abs(ref).max(), 1e-30))
    return errs


@pytest.fixture(scope="module")
def setup():
    jcfg = J.MPNNConfig(**SMALL, augment_eps=0.2, dropout=0.0)
    tcfg = T.MPNNConfig(**SMALL, augment_eps=0.2, dropout=0.0)
    params = J.init_mpnn_params(jax.random.PRNGKey(0), jcfg)
    b = _batch_np()
    return {"jcfg": jcfg, "tcfg": tcfg, "params": params, "b": b, "jb": jax.tree.map(
        jnp.asarray, b)}


def test_noam_schedule_equals_jax():
    for d, factor, warmup in ((128, 2.0, 4000), (32, 1.5, 10)):
        want = JT.noam_schedule(d, factor, warmup)
        got = TT.noam_schedule(d, factor, warmup)
        for count in range(51):
            np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6)


def test_smoothed_loss_and_nll_accuracy_equal_jax():
    rng = np.random.default_rng(0)
    s = rng.integers(0, 21, (3, 17))
    logits = rng.normal(size=(3, 17, 21)).astype(np.float32)
    log_p = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
    mask = (rng.random((3, 17)) > 0.3).astype(np.float32)
    t = [torch.as_tensor(a) for a in (s, log_p, mask)]
    j = [jnp.asarray(a) for a in (s, log_p, mask)]
    for weight in (0.1, 0.0):
        np.testing.assert_allclose(float(TT.smoothed_loss(*t, weight)),
                                   float(JT.smoothed_loss(*j, weight)), rtol=1e-6, atol=1e-6)
    got, want = TT.nll_and_accuracy(*t), JT.nll_and_accuracy(*j)
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-6, atol=1e-6)


def test_train_step_loss_and_gradients_equal_jax(setup):
    """The port's step with JAX's randn and backbone noise handed in: its
    loss and every gradient (read before the update; no clipping) against
    ``jax.value_and_grad`` of ``mpnn_log_probs`` + ``smoothed_loss``."""
    jcfg, b, jb = setup["jcfg"], setup["b"], setup["jb"]
    k_noise, k_order = jax.random.split(jax.random.PRNGKey(11))
    randn = jax.random.normal(k_order, b["S"].shape)
    noise = jax.random.normal(k_noise, b["X"].shape)

    @jax.jit
    def loss_fn(params):
        lp = J.mpnn_log_probs(params, *_jax_args(jb), jcfg, randn=randn, key=k_noise)
        return JT.smoothed_loss(jb["S"], lp, jb["mask"] * jb["chain_M"])

    want_loss, want_grads = jax.value_and_grad(loss_fn)(setup["params"])
    model = _model(setup["tcfg"], setup["params"])
    trainer = TT.MPNNTrainer(model)
    m = trainer.step(_torch(b), torch.Generator().manual_seed(0),
                     randn=torch.as_tensor(np.asarray(randn)),
                     noise=torch.as_tensor(np.asarray(noise)))
    np.testing.assert_allclose(float(m["loss"]), float(want_loss), rtol=1e-5)
    errs = _grad_errors(model, want_grads)
    worst = max(errs, key=errs.get)
    assert errs[worst] < GRAD_TOL, (worst, errs[worst])
    assert m["lr"] == TT.noam_schedule(32)(0) and trainer.step_count == 1


def test_whole_step_equals_jax_step(setup):
    """JAX's whole train step (its key split into noise, order and dropout
    keys) against the port's with those draws: the metrics, and the
    parameters after the update within 1e-6."""
    jcfg, b, jb = setup["jcfg"], setup["b"], setup["jb"]
    key = jax.random.PRNGKey(5)
    k_noise, k_order, _ = jax.random.split(key, 3)
    opt = JT.make_mpnn_optimizer(jcfg)
    new_state, jm = JT.make_mpnn_train_step(jcfg, opt)(_state(setup["params"], opt), jb, key)

    model = _model(setup["tcfg"], setup["params"])
    tm = TT.MPNNTrainer(model).step(
        _torch(b), torch.Generator().manual_seed(0),
        randn=torch.as_tensor(np.asarray(jax.random.normal(k_order, b["S"].shape))),
        noise=torch.as_tensor(np.asarray(jax.random.normal(k_noise, b["X"].shape))))
    for k in ("loss", "nll", "accuracy", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    want = T.mpnn_state_dict_from_jax(new_state.params)
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=1e-6, err_msg=name)


@pytest.mark.parametrize("gradient_norm", [-1.0, 1.0])
def test_adam_steps_equal_optax(gradient_norm):
    """The port's optimizer and optax's on the same gradients, three steps at
    a Noam rate of ~1e-2 (warmup 10); with ``gradient_norm`` 1 every step
    clips (the random gradients' norm is ~100)."""
    rng = np.random.default_rng(1)
    shapes = {n: tuple(p.shape) for n, p in T.ProteinMPNN(T.MPNNConfig(**SMALL)).named_parameters()}
    p0 = {n: rng.normal(size=s).astype(np.float32) for n, s in shapes.items()}
    grads = [{n: rng.normal(size=s).astype(np.float32) for n, s in shapes.items()}
             for _ in range(3)]
    jopt = JT.make_mpnn_optimizer(J.MPNNConfig(**SMALL), warmup=10, gradient_norm=gradient_norm)
    jp = jax.tree.map(jnp.asarray, p0)
    jstate = jopt.init(jp)
    tp = {n: torch.nn.Parameter(torch.as_tensor(v.copy())) for n, v in p0.items()}
    topt = TT.make_mpnn_optimizer(list(tp.values()), gradient_norm)
    schedule = TT.noam_schedule(32, warmup=10)
    for count, g in enumerate(grads):
        updates, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, updates)
        for n, p in tp.items():
            p.grad = torch.as_tensor(g[n].copy())
        for group in topt.param_groups:
            group["lr"] = schedule(count)
        norm = topt.step()
        np.testing.assert_allclose(float(norm), float(optax.global_norm(g)), rtol=1e-6)
        if count in (0, 2):
            for n, p in tp.items():
                np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[n]), atol=1e-6,
                                           err_msg=f"{n} after {count + 1} steps")
    assert float(np.abs(np.asarray(jp["W_out.weight"]) - p0["W_out.weight"]).max()) > 1e-3


def test_dropout_semantics(setup):
    b = _torch(setup["b"])
    cfg = T.MPNNConfig(**SMALL, dropout=0.1)
    model = _model(cfg, setup["params"])
    args = (b["X"], b["S"], b["mask"], b["chain_M"], b["residue_idx"], b["chain_encoding_all"])
    randn = torch.randn(b["S"].shape, generator=torch.Generator().manual_seed(2))

    def lp(m, seed=None):
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        with torch.no_grad():
            return T.mpnn_log_probs(m, *args, randn=randn, dropout=gen)

    model.eval()
    base = lp(model)
    assert torch.equal(lp(model, 7), base)  # outside training: identity
    model.train()
    assert torch.equal(lp(model), base)  # no generator: identity
    dropped = lp(model, 7)
    assert not torch.allclose(dropped, base)
    assert torch.equal(lp(model, 7), dropped)  # the same masks under one seed
    assert not torch.allclose(lp(model, 8), dropped)
    model0 = _model(T.MPNNConfig(**SMALL, dropout=0.0), setup["params"]).train()
    assert torch.equal(lp(model0, 7), base)  # rate 0: identity

    x = torch.ones(200_000)
    y = T._dropout(x, 0.1, torch.Generator().manual_seed(3))
    kept = y != 0
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1.0 / 0.9))
    assert abs(float(kept.float().mean()) - 0.9) < 3e-3


@pytest.mark.parametrize("ca_only", [False, True])
def test_initializer_distributions_match_jax(ca_only):
    """Same names and shapes as JAX's init through ``mpnn_state_dict_from_jax``;
    matrices within the xavier bound with the uniform's std (a / sqrt 3)
    where they are large, biases 0, LayerNorm scales 1; a seed fixes it."""
    cfg = T.MPNNConfig(k_neighbors=16, ca_only=ca_only)
    got = T.init_mpnn_state_dict(cfg, seed=4)
    want = T.mpnn_state_dict_from_jax(J.init_mpnn_params(
        jax.random.PRNGKey(4), J.MPNNConfig(k_neighbors=16, ca_only=ca_only)))
    assert set(got) == set(want)
    T.ProteinMPNN(cfg).load_state_dict(got, strict=True)
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, name
        if name in ("features.node_embedding.weight", "W_v.weight"):
            continue  # vestigial in the CA-only models: JAX holds no such matrix
        if w.dim() == 2:
            a = np.sqrt(6.0 / sum(w.shape))
            assert float(g.abs().max()) <= a and float(w.abs().max()) <= a * (1 + 1e-6), name
            if w.numel() >= 4096:
                for t in (g, w):
                    np.testing.assert_allclose(float(t.std()), a / np.sqrt(3), rtol=0.05,
                                               err_msg=name)
                    assert abs(float(t.mean())) < 0.05 * a, name
        elif name.endswith(".weight"):
            assert torch.equal(g, torch.ones_like(g)), name
        else:
            assert torch.equal(g, torch.zeros_like(g)), name
    again = T.init_mpnn_state_dict(cfg, seed=4)
    assert all(torch.equal(again[n], got[n]) for n in got)
    assert not torch.equal(T.init_mpnn_state_dict(cfg, seed=5)["W_e.weight"], got["W_e.weight"])


def test_eval_step_equals_jax(setup):
    jcfg, b, jb = setup["jcfg"], setup["b"], setup["jb"]
    key = jax.random.PRNGKey(9)
    jm = JT.make_mpnn_eval_step(jcfg)(setup["params"], jb, key)
    model = _model(setup["tcfg"], setup["params"])
    tm = TT.MPNNTrainer(model).eval_step(
        _torch(b), torch.Generator().manual_seed(0),
        randn=torch.as_tensor(np.asarray(jax.random.normal(key, b["S"].shape))))
    np.testing.assert_allclose(float(tm["nll"]), float(jm["nll"]), rtol=1e-5)
    np.testing.assert_allclose(float(tm["accuracy"]), float(jm["accuracy"]), rtol=1e-6)
    assert not model.training


def test_backbone_noise_zero_is_honoured(setup):
    """``augment_eps`` 0 trains without noise: the port's step loss is the
    clean teacher-forced loss. JAX's step replaces 0 with 0.2, so its loss
    moves off the clean loss (a deliberate divergence)."""
    b, jb = setup["b"], setup["jb"]
    cfg0 = dict(SMALL, augment_eps=0.0, dropout=0.0)
    key = jax.random.PRNGKey(5)
    _, k_order, _ = jax.random.split(key, 3)
    randn = jax.random.normal(k_order, b["S"].shape)
    clean = JT.smoothed_loss(jb["S"], j_log_probs(
        setup["params"], *_jax_args(jb), cfg=J.MPNNConfig(**cfg0), randn=randn),
        jb["mask"] * jb["chain_M"])

    model = _model(T.MPNNConfig(**cfg0), setup["params"])
    m = TT.MPNNTrainer(model).step(_torch(b), torch.Generator().manual_seed(0),
                                   randn=torch.as_tensor(np.asarray(randn)))
    np.testing.assert_allclose(float(m["loss"]), float(clean), rtol=1e-5)

    jcfg0 = J.MPNNConfig(**cfg0)
    opt = JT.make_mpnn_optimizer(jcfg0)
    _, jm = JT.make_mpnn_train_step(jcfg0, opt)(_state(setup["params"], opt), jb, key)
    assert abs(float(jm["loss"]) - float(clean)) > 1e-4 * float(clean)
