"""The port's train step against the JAX package's, and the train step's
behaviour on the CPU.

The JAX step runs as tests/unit/test_train.py's kernel test runs it: the
pair MLP through its Pallas kernels (backward ``pallas_bwd_impl="pallas"``)
in interpret mode, the embedder through its Pallas forward with, as the
port's step, either backward: its Pallas backward kernel in interpret mode
(``pallas_emb_bwd_impl="pallas"``, the default) or the XLA twin's VJP
("xla"); two IPA blocks (one edge transition), ``make_batch()``'s batch with
fixed t, op by op (not under jit), in child processes (``jax_reference``).
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
import pathlib
import subprocess
import sys
import time

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
from tests.torch_threads import one_torch_thread  # noqa: F401


REPO = pathlib.Path(__file__).resolve().parent.parent
T_FIXED = np.asarray([0.15, 0.6], np.float32)  # one sample under the aux-loss filters


def jax_config(emb_bwd_impl="xla"):
    cfg = tiny_cfg()
    ipa = cfg.model.ipa
    ipa.num_blocks = 2
    ipa.use_pallas_kernel, ipa.pallas_bwd_impl, ipa.pallas_interpret = True, "pallas", True
    ipa.pallas_tile_i, ipa.pallas_tile_j = 8, 128
    ipa.use_pallas_embedder, ipa.pallas_emb_bwd_impl = True, emb_bwd_impl
    ipa.use_pallas_ipa = False
    return cfg


def port_config(emb_bwd_impl="xla"):
    _, tc = tiny_configs()
    tc.model.ipa.pallas_emb_bwd_impl = emb_bwd_impl
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


def _flat(tree, prefix: str) -> dict[str, np.ndarray]:
    """A nested dict of arrays as {prefix/key/...: array}."""
    return {prefix + "/" + "/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _nested(flat: dict[str, np.ndarray], prefix: str) -> dict:
    """The inverse of :func:`_flat` for the keys under ``prefix``."""
    out: dict = {}
    for name, value in flat.items():
        if not name.startswith(prefix + "/"):
            continue
        *keys, last = name[len(prefix) + 1:].split("/")
        node = out
        for k in keys:
            node = node.setdefault(k, {})
        node[last] = value
    return out


def write_jax_reference(impl: str, path: str) -> None:
    """The JAX side of the train-step comparison for the embedder backward
    ``impl``, written to the .npz ``path``: perturbed JAX params, the batch,
    and for each coin the noise of the JAX key's draw, the loss, grad norm,
    gradients and the parameters after one make_optimizer step."""
    cfg = jax_config(impl)
    diffuser = JSE3(cfg.diffuser)
    model = JNet(cfg.model, diffuser, inpainting=True)
    batch = dict(make_batch())
    batch["t"] = jnp.asarray(T_FIXED)
    out = {f"batch/{k}": np.asarray(v) for k, v in batch.items()}
    with pltpu.force_tpu_interpret_mode():
        state = jloop.init_train_state(model, _grab_grads(), batch, jax.random.PRNGKey(0))
        params = jax.tree_util.tree_map(jnp.asarray, perturbed(state.params, 1))
        state = state._replace(params=params, opt_state=_grab_grads().init(params))
        step = jloop.build_train_step(model, diffuser, cfg, _grab_grads())
        out.update(_flat(params, "params"))
        for coin in (False, True):
            key = _key_with_coin(coin)
            new, metrics = step(state, batch, key)
            grads = new.opt_state
            k_marg = jax.random.split(jax.random.split(key, 3)[0])[1]  # loss_fn, noise_batch
            noise = jax_noise(diffuser, k_marg, np.asarray(batch["rigids_0"]), T_FIXED)
            clipped, new_params = adam_step(grads, params)
            run = f"run{int(coin)}"
            out.update({f"{run}/loss": np.asarray(metrics["loss"]),
                        f"{run}/grad_norm": np.asarray(metrics["grad_norm"]),
                        f"{run}/noise/rot": noise[0], f"{run}/noise/trans": noise[1]})
            for name, tree in (("grads", grads), ("clipped", clipped), ("new_params", new_params)):
                out.update(_flat(tree, f"{run}/{name}"))
    np.savez(path, **out)


# The JAX reference runs op by op with the Pallas kernels in interpret mode,
# whose callbacks dispatch JAX operations from another thread; with the CPU
# client's asynchronous dispatch on, that can deadlock with the main thread.
# So it runs in child processes that turn jax_cpu_enable_async_dispatch off
# before their CPU client is made (JAX reads the flag then; its environment
# variable is not read), pinned to the CPU as tests/conftest.py pins this
# process, each under a time limit of its own: one child a setting, both
# started when the module's first test starts, so they compute while the
# tests that need no reference run (the file's tests that take the
# reference come last). On an idle 8-core host a child takes ~150 s beside
# the other (the two in one process, one after the other: ~205 s); in the
# tier-1 run beside its other workers, ~400 s.
EMB_BWD_IMPLS = ("xla", "pallas")
_CHILD = """
import sys
import jax
jax.config.update("jax_cpu_enable_async_dispatch", False)
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_device", jax.devices("cpu")[0])
from tests.test_torch_train import write_jax_reference
for impl in sys.argv[2:]:
    write_jax_reference(impl, f"{sys.argv[1]}/{impl}.npz")
"""
REFERENCE_TIMEOUT_S = 600


@pytest.fixture(scope="module", autouse=True)
def jax_reference_children(tmp_path_factory):
    """{setting: (child process, its log, the time its limit ends)}: one
    child a setting writing :func:`write_jax_reference`'s file, started with
    the module's first test, its output to a log file (a pipe nobody reads
    until the end could fill and stop it). Any child still running when the
    module ends is killed."""
    out_dir = tmp_path_factory.mktemp("jax_reference")
    children = {}
    for impl in EMB_BWD_IMPLS:
        log = out_dir / f"{impl}.log"
        with open(log, "w") as f:
            proc = subprocess.Popen([sys.executable, "-c", _CHILD, str(out_dir), impl], cwd=REPO,
                                    stdout=f, stderr=subprocess.STDOUT)
        children[impl] = (proc, log, time.monotonic() + REFERENCE_TIMEOUT_S)
    yield out_dir, children
    for proc, _, _ in children.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


@pytest.fixture(scope="module", params=EMB_BWD_IMPLS, ids=lambda p: f"emb_bwd_{p}")
def jax_reference(request, jax_reference_children):
    """The embedder's backward setting, perturbed JAX params, the batch, and
    for each coin the noise of the JAX key's draw, the loss, grad norm,
    gradients and the parameters after one make_optimizer step, computed by
    :func:`write_jax_reference` in the setting's child process (waited for
    until its time limit, then killed)."""
    impl = request.param
    out_dir, children = jax_reference_children
    proc, log, deadline = children[impl]
    try:
        proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=30)
    assert proc.returncode == 0, f"the JAX reference ({impl}): rc {proc.returncode}\n" + (
        log.read_text()[-4000:])
    path = out_dir / f"{impl}.npz"
    assert path.exists(), "the JAX reference's child process failed"
    with np.load(path) as f:
        flat = dict(f)
    runs = {coin: dict(loss=float(flat[f"run{int(coin)}/loss"]),
                       grad_norm=float(flat[f"run{int(coin)}/grad_norm"]),
                       noise=(flat[f"run{int(coin)}/noise/rot"],
                              flat[f"run{int(coin)}/noise/trans"]),
                       **{name: _nested(flat, f"run{int(coin)}/{name}")
                          for name in ("grads", "clipped", "new_params")})
            for coin in (False, True)}
    return impl, _nested(flat, "params"), _nested(flat, "batch"), runs


def port_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def port_step(impl, params, batch, noise, coin):
    """One port train step from JAX's params on JAX's noise, with the
    embedder backward ``impl``; returns the trainer and the metrics."""
    tr = make_trainer(port_config(impl), device="cpu",
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
    embedder's backward takes "pallas" (the default: its kernel on CUDA
    tensors, the kernel's plain version on CPU tensors) or "xla"; anything
    else raises."""
    with pytest.raises(KeyError, match="pallas_bwd_impl"):
        load_config(["model.ipa.pallas_bwd_impl=xla"])
    assert load_config().model.ipa.pallas_emb_bwd_impl == "pallas"
    cfg = port_config("pallas")
    check_emb_bwd_impl(cfg)
    tr = make_trainer(cfg, device="cpu")
    batch = port_batch({k: np.array(v) for k, v in make_batch().items()})
    assert np.isfinite(float(tr.step(batch, torch.Generator().manual_seed(3))["loss"]))
    cfg.model.ipa.pallas_emb_bwd_impl = "typo"
    with pytest.raises(ValueError, match="must be 'xla' or 'pallas'"):
        check_emb_bwd_impl(cfg)
    with pytest.raises(ValueError, match="must be 'xla' or 'pallas'"):
        make_trainer(cfg, device="cpu")
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


# The tests that take the JAX reference, last: its children compute while the
# tests above run.


@pytest.mark.parametrize("coin", [False, True], ids=["sc_off", "sc_on"])
def test_train_step_matches_jax(jax_reference, coin):
    """Loss, gradient norm, every parameter gradient (after clipping, which
    the optimizer applies to .grad) and every parameter after one Adam
    step, with self-conditioning off and on, for each embedder backward
    (on the CPU "pallas" is the backward kernel's plain version)."""
    impl, params, batch, runs = jax_reference
    ref = runs[coin]
    tr, metrics = port_step(impl, params, batch, ref["noise"], coin)
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
    impl, params, batch, runs = jax_reference
    tr, _ = port_step(impl, params, batch, runs[True]["noise"], True)
    want = params_from_jax(runs[True]["grads"], num_blocks=2, seq_tfmr_layers=1)
    for name, p in tr.model.named_parameters():
        if want[name].abs().max() > 0:
            assert p.grad is not None and p.grad.abs().max() > 0, name
