"""The port's train step against the JAX package's, and the train step's
behaviour on the CPU.

The JAX step runs as tests/unit/test_train.py's kernel test runs it: the
pair MLP through its Pallas kernels (backward ``pallas_bwd_impl="pallas"``)
in interpret mode, the embedder through its Pallas forward with the XLA-twin
backward (``pallas_emb_bwd_impl="xla"``), two IPA blocks (one edge
transition), ``make_batch()``'s batch with fixed t, op by op (not under jit).
Its parameters are flax-initialized and perturbed (every leaf non-zero) and
carried to the port with ``params_from_jax``, which maps JAX's gradients
onto the port's parameter names too. The randomness is JAX's: the test
reproduces the forward-marginal draw from the JAX key and hands the same
noise to the port's diffuser, and picks keys and generator seeds so the
self-conditioning coin falls the same way in both.

Tolerance: each gradient within 1e-4 of its own max-abs (the trunk's frame
feedback carries float32 rounding of the two frameworks' different
operation orders into every gradient; measured worst ~2e-5), the loss and
the gradient norm 1e-5 relative, and the parameters after one Adam step
within 1e-5 absolute (Adam's first step moves each parameter by ~lr = 1e-3
whatever the gradient's size)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from framedipt_tpu.diffusion import SE3Diffuser as JSE3
from framedipt_tpu.model import ScoreNetwork as JNet
from framedipt_tpu.train import loop as jloop

from framedipt_tpu_torch.geometry.rigid import Rigid as TRigid
from framedipt_tpu_torch.model.ipa import InvariantPointAttention
from framedipt_tpu_torch.model.kernels import pair_mlp as t_pair
from framedipt_tpu_torch.model.weights import params_from_jax
from framedipt_tpu_torch.tools.config import check_emb_bwd_impl, load_config, merge_checkpoint_config
from framedipt_tpu_torch.train.loop import make_trainer

from tests.test_torch_losses import jax_noise
from tests.test_torch_model import perturbed, tiny_configs
from tests.unit.test_train import make_batch, tiny_cfg

T_FIXED = np.asarray([0.15, 0.6], np.float32)  # one sample under the aux-loss filters


def jax_config():
    cfg = tiny_cfg()
    ipa = cfg.model.ipa
    ipa.num_blocks = 2
    ipa.use_pallas_kernel, ipa.pallas_bwd_impl, ipa.pallas_interpret = True, "pallas", True
    ipa.pallas_tile_i, ipa.pallas_tile_j = 8, 128
    ipa.use_pallas_embedder, ipa.pallas_emb_bwd_impl = True, "xla"
    ipa.use_pallas_ipa = False
    return cfg


def port_config():
    _, tc = tiny_configs()
    tc.model.ipa.pallas_emb_bwd_impl = "xla"
    tc.experiment.learning_rate = 1e-3
    tc.experiment.inpainting = True
    return tc


def _grab_grads():
    """An optax transformation whose new state is the gradient itself."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g),
    )


def _key_with_coin(coin: bool) -> jax.Array:
    for seed in range(100):
        key = jax.random.PRNGKey(seed)
        if bool(jax.random.bernoulli(jax.random.split(key, 3)[1])) == coin:
            return key
    raise AssertionError("no key")


def _seed_with_coin(coin: bool) -> int:
    for seed in range(100):
        if bool(torch.rand((), generator=torch.Generator().manual_seed(seed)) < 0.5) == coin:
            return seed
    raise AssertionError("no seed")


@jax.jit
def adam_step(grads, params):
    """The gradients clipped as optax clips them, and the parameters after
    one step of the JAX package's make_optimizer (jit: eager optax compiles
    every operation per leaf shape)."""
    clipped, _ = optax.clip_by_global_norm(10.0).update(grads, None)
    opt = jloop.make_optimizer(port_config().experiment.learning_rate)
    updates, _ = opt.update(grads, opt.init(params), params)
    return clipped, optax.apply_updates(params, updates)


@pytest.fixture(scope="module")
def jax_reference():
    """Perturbed JAX params, the batch, and for each coin the JAX key, the
    noise of its draw, the loss, grad norm, gradients and the parameters
    after one make_optimizer step."""
    cfg = jax_config()
    diffuser = JSE3(cfg.diffuser)
    model = JNet(cfg.model, diffuser, inpainting=True)
    batch = dict(make_batch())
    batch["t"] = jnp.asarray(T_FIXED)
    with pltpu.force_tpu_interpret_mode():
        state = jloop.init_train_state(model, _grab_grads(), batch, jax.random.PRNGKey(0))
        params = jax.tree_util.tree_map(jnp.asarray, perturbed(state.params, 1))
        state = state._replace(params=params, opt_state=_grab_grads().init(params))
        step = jloop.build_train_step(model, diffuser, cfg, _grab_grads())
        runs = {}
        for coin in (False, True):
            key = _key_with_coin(coin)
            new, metrics = step(state, batch, key)
            grads = new.opt_state
            k_marg = jax.random.split(jax.random.split(key, 3)[0])[1]  # loss_fn, noise_batch
            noise = jax_noise(diffuser, k_marg, np.asarray(batch["rigids_0"]), T_FIXED)
            clipped, new_params = adam_step(grads, params)
            runs[coin] = dict(loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]),
                              grads=grads, clipped=clipped, new_params=new_params, noise=noise)
    return params, {k: np.array(v) for k, v in batch.items()}, runs


def port_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def port_step(params, batch, noise, coin):
    """One port train step from JAX's params on JAX's noise; returns the
    trainer and the metrics."""
    tr = make_trainer(port_config(), device="cpu",
                      state_dict=params_from_jax(params, num_blocks=2, seq_tfmr_layers=1))
    rot, trans = (torch.as_tensor(x) for x in noise)
    diffuser = tr.diffuser
    diffuser.forward_marginal = lambda gen, r0, t, mask: diffuser.marginal_from_noise(
        r0, t, rot, trans, mask)
    metrics = tr.step(port_batch(batch), torch.Generator().manual_seed(_seed_with_coin(coin)))
    assert metrics["self_conditioned"] == coin
    return tr, metrics


def _close(got, want, tol, name, floor=0.0):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max(initial=0.0)), floor)
    err = float(np.abs(np.asarray(got, np.float32) - want).max(initial=0.0))
    assert err <= tol * scale, f"{name}: max err {err} > {tol} * {scale}"


@pytest.mark.parametrize("coin", [False, True], ids=["sc_off", "sc_on"])
def test_train_step_matches_jax(jax_reference, coin):
    """Loss, gradient norm, every parameter gradient (after clipping, which
    the optimizer applies to .grad) and every parameter after one Adam
    step, with self-conditioning off and on."""
    params, batch, runs = jax_reference
    ref = runs[coin]
    tr, metrics = port_step(params, batch, ref["noise"], coin)
    np.testing.assert_allclose(float(metrics["loss"]), ref["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]), ref["grad_norm"], rtol=1e-5)
    want_grads = params_from_jax(ref["clipped"], num_blocks=2, seq_tfmr_layers=1)
    want_params = params_from_jax(ref["new_params"], num_blocks=2, seq_tfmr_layers=1)
    # The port's own (clipped) gradients through make_optimizer +
    # optax.apply_updates: the port's Adam step is optax's.
    start = params_from_jax(params, num_blocks=2, seq_tfmr_layers=1)
    named = dict(tr.model.named_parameters())
    trained = {n: p for n, p in named.items() if p.grad is not None}
    _, optax_params = adam_step({n: p.grad.numpy() for n, p in trained.items()},
                                {n: start[n].numpy() for n in trained})
    largest = max(float(g.abs().max()) for g in want_grads.values())
    for name, p in named.items():
        if name not in trained:  # never read by the forward (linear_rbf, linear_3)
            assert not want_grads[name].any(), name
            continue
        got, want = p.grad.numpy(), want_grads[name].numpy()
        # linear_b's bias cancels in the softmax: its gradient is 0 up to
        # float32 noise in both, so errors are measured on the scale of the
        # largest gradient too.
        floor = 1e-3 * largest
        _close(got, want, 1e-4, name, floor=floor)
        new = p.detach().numpy()
        np.testing.assert_allclose(new, np.asarray(optax_params[name]), atol=1e-7, err_msg=name)
        # Adam's first step is lr * g / (|g| + eps): insensitive to the
        # gradient's error except where the gradient itself is near 0.
        firm = np.abs(want) >= 1e-3 * max(np.abs(want).max(), floor)
        np.testing.assert_allclose(new[firm], want_params[name].numpy()[firm], atol=1e-5,
                                   err_msg=name)
    assert len(trained) == len(named) - 6


def test_every_parameter_jax_trains_gets_a_gradient(jax_reference):
    """Guard: after one port step, every parameter whose JAX gradient is
    non-zero has a non-zero .grad, so no gradient stops silently at a
    kernel's output."""
    params, batch, runs = jax_reference
    tr, _ = port_step(params, batch, runs[True]["noise"], True)
    want = params_from_jax(runs[True]["grads"], num_blocks=2, seq_tfmr_layers=1)
    for name, p in tr.model.named_parameters():
        if want[name].abs().max() > 0:
            assert p.grad is not None and p.grad.abs().max() > 0, name


def test_loss_decreases():
    """30 steps on one batch at lr 1e-3 (mirrors tests/unit/test_train.py)."""
    tr = make_trainer(port_config(), device="cpu")
    batch = port_batch({k: np.array(v) for k, v in make_batch().items()})
    gen = torch.Generator().manual_seed(2)
    losses = []
    for i in range(30):
        loss = float(tr.step(batch, gen)["loss"])
        assert np.isfinite(loss), f"loss diverged at step {i}"
        losses.append(loss)
    assert np.mean(losses[25:]) < np.mean(losses[:5]), losses


@pytest.mark.parametrize("mode", ["max", "next"])
def test_recycle_step_finite(mode):
    cfg = port_config()
    cfg.experiment.recycle.enabled = True
    cfg.experiment.recycle.mode = mode
    tr = make_trainer(cfg, device="cpu")
    batch = port_batch({k: np.array(v) for k, v in make_batch().items()})
    before = t_pair.pair_mlp_bwd.launches
    metrics = tr.step(batch, torch.Generator().manual_seed(7))
    assert np.isfinite(float(metrics["loss"])) and np.isfinite(float(metrics["grad_norm"]))
    assert t_pair.pair_mlp_bwd.launches == before  # the CPU takes the plain backward


def test_importance_weighting_keeps_raw_history():
    tr = make_trainer(port_config(), device="cpu")
    batch = port_batch({k: np.array(v) for k, v in make_batch().items()})
    batch["t"] = torch.tensor([0.2, 0.9])
    batch["loss_weight"] = torch.tensor([0.5, 2.0])
    m = tr.step(batch, torch.Generator().manual_seed(11))
    torch.testing.assert_close(m["per_example_loss"], m["raw_per_example_loss"] * batch["loss_weight"])
    torch.testing.assert_close(m["total_loss"], m["per_example_loss"].mean())


def test_backward_settings_are_checked():
    """The pair MLP's backward has no setting (its kernel on CUDA tensors,
    its plain version on CPU tensors): an override that names one, such as
    the JAX package's "xla" backward, is refused on every device. The
    embedder's backward kernel is not ported: "pallas" raises
    NotImplementedError naming the ROADMAP item, on every device."""
    with pytest.raises(KeyError, match="pallas_bwd_impl"):
        load_config(["model.ipa.pallas_bwd_impl=xla"])
    cfg = port_config()
    cfg.model.ipa.pallas_emb_bwd_impl = "pallas"
    with pytest.raises(NotImplementedError, match="ROADMAP queue 2 item 2"):
        check_emb_bwd_impl(cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 2 item 2"):
        make_trainer(cfg, device="cpu")
    cfg.model.ipa.pallas_emb_bwd_impl = "typo"
    with pytest.raises(ValueError, match="must be 'xla' or 'pallas'"):
        check_emb_bwd_impl(cfg)
    # A run setting, not the model's: a checkpoint's config does not set it,
    # and a JAX checkpoint's pair-MLP backward setting is ignored.
    merged = merge_checkpoint_config(port_config(), {"model": {"ipa": {
        "pallas_bwd_impl": "xla", "pallas_emb_bwd_impl": "pallas", "num_blocks": 3}}})
    assert merged.model.ipa.pallas_emb_bwd_impl == "xla"
    assert not hasattr(merged.model.ipa, "pallas_bwd_impl")
    assert merged.model.ipa.num_blocks == 3


def test_ipa_kernel_branch_refuses_gradients():
    """The IPA attention kernel is forward-only: its branch raises where
    autograd records, and runs under no_grad."""
    tr = make_trainer(port_config(), device="cpu")
    ipa = next(m for m in tr.model.modules() if isinstance(m, InvariantPointAttention))
    rng = np.random.default_rng(0)
    B, N = 1, 6
    s = torch.as_tensor(rng.normal(size=(B, N, 32)).astype(np.float32))
    z = torch.as_tensor(rng.normal(size=(B, N, N, 16)).astype(np.float32))
    rigids = TRigid(torch.tensor([[[1.0, 0, 0, 0]] * N]), torch.as_tensor(rng.normal(size=(B, N, 3)).astype(np.float32)))
    heads = ipa.project(s, rigids.rot_mats(), rigids.trans)
    with pytest.raises(RuntimeError, match="forward-only"):
        ipa.attend_kernel(*heads, z, torch.ones(B, N))
    with torch.no_grad():
        heads = ipa.project(s, rigids.rot_mats(), rigids.trans)
        ipa.attend_kernel(*heads, z, torch.ones(B, N))
