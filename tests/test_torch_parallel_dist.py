"""The port's multi-process paths over gloo on the CPU, with the ranks as
child processes (``run_rank``), against the port in one process and
against the JAX package.

- The sequence-parallel sampler at sp=2, sp=4 and (dp=2, sp=2), at
  noise_scale 0 against JAX's single-device ``build_inference_fn`` (CA RMSD
  < 0.01 A at every step, psi 1e-3, as test_deterministic_trajectory_matches_jax
  holds the single-process port), at noise_scale 1 against the port's
  single-process sampler with the same generator (final_rigids 2e-5,
  prot_traj 2e-4, the JAX SP test's tolerances), N=24 and a ragged N=22
  (rows 6, 6, 6, 4 at sp=4); every rank's final frames bit-equal; the edge
  kernels' wrappers spied on: each rank launches them on its
  [B, ceil(N/sp), N, C] row block.
- The train step at dp=2 and at (dp=2, fsdp=2): loss and grad_norm (1e-5
  relative), the whole batch's per-example losses and t, and the parameters
  after 2 steps (1e-6) against the port's step on the whole batch in one
  process, which test_train_step_matches_jax holds against JAX. The entries
  whose gradient vanishes in exact arithmetic (the key biases and linear_b's
  bias: the softmax cancels them, :func:`_cancelled`) get float32 noise for a
  gradient, whose sign Adam follows with a step of lr whatever its size; they
  are left out of the parameter comparison.
- One dp=2 step's loss and grad_norm against JAX's step on a dp=2 virtual
  CPU mesh (as tests/unit/test_train.py:test_dp_mesh_sharded_step), with
  JAX's forward-marginal noise handed to the port, computed in a child
  process under a time limit, as tests/test_torch_train.py's reference is.
- A checkpoint written at world size 2 resumed in one process, and one
  written in one process resumed at world size 2: the model and optimizer
  state to the bit, and the next step's parameters equal the other side's.
- The training CLI's ``train()`` at world size 2 (dp=2 over the fixture
  complexes, batches of 2, an eval on every rank): rank 0 alone writes
  ``metrics.jsonl``, ``train_conf.json``, the eval PDBs and the checkpoint,
  and the logged losses and grad norms equal a one-process run's (1e-5).

The ranks meet through a ``file://`` rendezvous in the test's directory, run
torch on one thread each and are killed at a time limit of their own."""
import functools
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from framedipt_tpu_torch.diffusion import SE3Diffuser
from framedipt_tpu_torch.experiments.train import train
from framedipt_tpu_torch.model import ScoreNetwork
from framedipt_tpu_torch.model.kernels import edge_embedder as t_emb
from framedipt_tpu_torch.model.kernels import pair_mlp as t_pair
from framedipt_tpu_torch.model.weights import cancelled_entries
from framedipt_tpu_torch.parallel import init_distributed, make_mesh, make_sp_mesh
from framedipt_tpu_torch.sampling import sample
from framedipt_tpu_torch.tools.config import load_config, save_config
from framedipt_tpu_torch.train.checkpoints import (
    CKPT_FILE,
    full_state,
    load_checkpoint,
    load_state,
    save_checkpoint,
)
from framedipt_tpu_torch.train.loop import make_trainer
from tests.torch_threads import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent
NUM_T, MIN_T = 5, 0.01
RANK_TIMEOUT_S = 300
JAX_TIMEOUT_S = 600
STEP_SEEDS = {"resume_w2": 13, "resume_w1": 17}
# (name, dp, sp, feats, noise_scale) of each sampler run, by world size.
SAMPLER_RUNS = {
    2: [("sp2_n24_n0", 1, 2, "n24", 0.0), ("sp2_n24_n1", 1, 2, "n24", 1.0)],
    4: [("sp4_n24_n0", 1, 4, "n24", 0.0), ("sp4_n22_n0", 1, 4, "n22", 0.0),
        ("sp4_n22_n1", 1, 4, "n22", 1.0), ("dp2sp2_n24_n0", 2, 2, "n24", 0.0),
        ("dp2sp2_n22_n1", 2, 2, "n22", 1.0)],
}
TRAIN_MESH = {2: (2, 1), 4: (2, 2)}


# -- the ranks: torch and the port only -----------------------------------------


def _sampler_model(work: pathlib.Path):
    cfg = load_config(json_path=work / "config.json")
    model = ScoreNetwork(cfg.model, SE3Diffuser(cfg.diffuser, device="cpu"), inpainting=True)
    model.load_state_dict(torch.load(work / "sampler_sd.pt"), strict=True)
    return model


def _feats(work: pathlib.Path, name: str) -> dict[str, torch.Tensor]:
    with np.load(work / f"feats_{name}.npz") as f:
        return {k: torch.as_tensor(f[k]) for k in f.files}


def _sample(model, feats, noise_scale, mesh=None):
    return sample(model, model.diffuser, feats, torch.Generator().manual_seed(5), num_t=NUM_T,
                  min_t=MIN_T, noise_scale=noise_scale, inpainting=True, sp_mesh=mesh)


def _batch(work: pathlib.Path, name: str) -> dict[str, torch.Tensor]:
    with np.load(work / f"{name}.npz") as f:
        return {k: torch.as_tensor(f[k]) for k in f.files}


def _trainer(work: pathlib.Path, state_dict: str, mesh=None):
    cfg = load_config(json_path=work / "config.json")
    return make_trainer(cfg, device="cpu", state_dict=torch.load(work / state_dict), mesh=mesh)


def _train(tr, batch, steps: int) -> dict[str, np.ndarray]:
    """Losses, grad norms, the last step's per-example metrics and the
    clipped gradients of each step, as numpy."""
    gen = torch.Generator().manual_seed(2)
    out: dict[str, np.ndarray] = {}
    for i in range(steps):
        m = tr.step(batch, gen)
        out[f"loss{i}"], out[f"grad_norm{i}"] = float(m["loss"]), float(m["grad_norm"])
        for k in ("per_example_loss", "t"):
            out[f"{k}{i}"] = m[k].numpy()
    return out


def _params(tr) -> dict[str, np.ndarray]:
    """The whole model's parameters, copied (rank 0; none elsewhere)."""
    return {k: v.numpy().copy() for k, v in full_state(tr.model, tr.optimizer)[0].items()}


def _optim(optim_sd: dict) -> dict[str, np.ndarray]:
    """An optimizer state_dict's per-parameter state as flat numpy arrays
    (none for the empty dict of a rank other than 0)."""
    return {f"{i}/{k}": np.array(v) for i, state in optim_sd.get("state", {}).items()
            for k, v in state.items()}


def run_rank(rank: int, world: int, init_file: str, work: str) -> None:
    """One rank of the world-``world`` group: the sampler runs of
    SAMPLER_RUNS, the train steps, and (world 2) the checkpoints and the
    step against JAX's; writes ``rank<r>_w<world>.npz`` in ``work``."""
    work = pathlib.Path(work)
    init_distributed(f"file://{init_file}", world, rank, device="cpu", initialization_timeout=120)
    out: dict[str, np.ndarray] = {}
    shapes: dict[str, list] = {}

    # The edge kernels' wrappers, spied on: the shapes each rank launches.
    pair_mlp, edge_embedder = t_pair.pair_mlp, t_emb.edge_embedder
    current: list = []

    def pair_spy(*args):
        current.append(["pair", list(args[0].shape)])
        return pair_mlp(*args)

    def emb_spy(*args):
        current.append(["emb", list(args[0].shape), list(args[1].shape)])
        return edge_embedder(*args)

    t_pair.pair_mlp, t_emb.edge_embedder = pair_spy, emb_spy
    model = _sampler_model(work)
    for name, dp, sp_size, feats, noise in SAMPLER_RUNS[world]:
        current.clear()
        got = _sample(model, _feats(work, feats), noise, make_sp_mesh(sp_size, dp, "cpu"))
        shapes[name] = sorted({json.dumps(s) for s in current})
        out.update({f"{name}/{k}": v.numpy() for k, v in got.items()})
    t_pair.pair_mlp, t_emb.edge_embedder = pair_mlp, edge_embedder

    dp, fsdp = TRAIN_MESH[world]
    mesh = make_mesh(dp, fsdp, "cpu")
    tr = _trainer(work, "train_sd.pt", mesh)
    batch = _batch(work, "train_batch")
    out.update({f"train/{k}": v for k, v in _train(tr, batch, 2).items()})
    out.update({f"train/params/{k}": v for k, v in _params(tr).items()})
    out.update({f"train/optim/{k}": v for k, v in _optim(full_state(tr.model, tr.optimizer)[1]).items()})
    if world == 2:
        # World 2 -> 1: a checkpoint after the two steps, then one more step.
        save_checkpoint(work / "ckpt_w2", 2, tr.model, tr.optimizer, load_config(), keep=1)
        # Each rank its own directory, as without a shared file system: rank
        # 1's already holds step 2, rank 0's does not; rank 0's decides.
        own = work / f"ckpt_rank{rank}"
        if rank == 1:
            (own / "step_2").mkdir(parents=True)
            torch.save({}, own / "step_2" / CKPT_FILE)
        save_checkpoint(own, 2, tr.model, tr.optimizer, load_config(), keep=1)
        tr.step(batch, torch.Generator().manual_seed(STEP_SEEDS["resume_w2"]))
        out.update({f"resume_w2/{k}": v for k, v in _params(tr).items()})
        # World 1 -> 2: the one-process run's checkpoint, then one step.
        tr = _trainer(work, "train_sd.pt", make_mesh(dp, fsdp, "cpu"))
        load_state(tr.model, tr.optimizer, load_checkpoint(work / "ckpt_w1" / "step_2"))
        out.update({f"loaded_w1/{k}": v for k, v in
                    _optim(full_state(tr.model, tr.optimizer)[1]).items()})
        tr.step(batch, torch.Generator().manual_seed(STEP_SEEDS["resume_w1"]))
        out.update({f"resume_w1/{k}": v for k, v in _params(tr).items()})
        # JAX's dp=2 step: its parameters, batch and forward-marginal noise.
        tr = _trainer(work, "jax_sd.pt", make_mesh(dp, fsdp, "cpu"))
        noise = _batch(work, "jax_noise")
        diffuser = tr.diffuser
        diffuser.forward_marginal = lambda gen, r0, t, mask: diffuser.marginal_from_noise(
            r0, t, noise["rot"], noise["trans"], mask)
        m = tr.step(_batch(work, "jax_batch"),
                    torch.Generator().manual_seed(int(noise["coin_seed"])))
        out["jax/loss"], out["jax/grad_norm"] = float(m["loss"]), float(m["grad_norm"])
        out["jax/self_conditioned"] = m["self_conditioned"]
        # The training CLI, every rank.
        train(load_config(json_path=work / "cli_w2.json"), device="cpu")
    out["shapes"] = np.asarray(json.dumps(shapes))
    np.savez(work / f"rank{rank}_w{world}.npz", **out)
    dist.destroy_process_group()


_RANK = """
import sys
import torch
torch.set_num_threads(1)
from tests.test_torch_parallel_dist import run_rank
run_rank(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
"""


def start_ranks(world: int, work: pathlib.Path) -> list[subprocess.Popen]:
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    return [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), str(world), str(work / f"rendezvous_{world}"),
         str(work)], cwd=REPO, env=env, stdout=open(work / f"rank{r}_w{world}.log", "w"),
        stderr=subprocess.STDOUT) for r in range(world)]


def wait_ranks(procs: list[subprocess.Popen], work: pathlib.Path, world: int) -> None:
    """Wait for every rank under RANK_TIMEOUT_S; kill all of them at the limit."""
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for r, p in enumerate(procs):
        log = (work / f"rank{r}_w{world}.log").read_text()[-4000:]
        assert p.returncode == 0, f"rank {r} of {world}: rc {p.returncode}\n{log}"


# -- the references: JAX and the port in one process ----------------------------


def write_jax_dp_reference(path: str) -> None:
    """JAX's train step on a dp=2 virtual CPU mesh (XLA formulation, two IPA
    blocks, make_batch()'s batch with fixed t, jit, the self-conditioning
    coin on) from perturbed params: its loss and grad norm, the params, the
    batch and the forward-marginal noise of its key, to the .npz ``path``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    from framedipt_tpu.diffusion import SE3Diffuser as JSE3
    from framedipt_tpu.model import ScoreNetwork as JNet
    from framedipt_tpu.parallel import make_mesh as j_make_mesh
    from framedipt_tpu.parallel import shard_batch as j_shard_batch
    from framedipt_tpu.train import loop as jloop
    from tests.test_torch_losses import jax_noise
    from tests.test_torch_model import perturbed
    from tests.test_torch_train import T_FIXED, _flat, _key_with_coin
    from tests.unit.test_train import make_batch, tiny_cfg

    cfg = tiny_cfg()
    ipa = cfg.model.ipa
    ipa.num_blocks = 2
    ipa.use_pallas_kernel = ipa.use_pallas_embedder = ipa.use_pallas_ipa = False
    diffuser = JSE3(cfg.diffuser)
    model = JNet(cfg.model, diffuser, inpainting=True)
    batch = dict(make_batch())
    batch["t"] = jnp.asarray(T_FIXED)
    optimizer = jloop.make_optimizer(cfg.experiment.learning_rate)
    state = jloop.init_train_state(model, optimizer, batch, jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(jnp.asarray, perturbed(state.params, 1))
    state = state._replace(params=params, opt_state=optimizer.init(params))
    key = _key_with_coin(True)
    mesh = j_make_mesh(jax.devices("cpu")[:2], dp_size=2)
    step = jax.jit(jloop.build_train_step(model, diffuser, cfg, optimizer))
    with mesh:
        state = jax.device_put(state, NamedSharding(mesh, PartitionSpec()))
        sharded = j_shard_batch(mesh, batch)
        assert {s.data.shape for s in sharded["rigids_0"].addressable_shards} == {(1, 10, 7)}
        _, metrics = step(state, sharded, key)
    k_marg = jax.random.split(jax.random.split(key, 3)[0])[1]  # loss_fn, noise_batch
    rot, trans = jax_noise(diffuser, k_marg, np.asarray(batch["rigids_0"]), T_FIXED)
    np.savez(path, loss=np.asarray(metrics["loss"]), grad_norm=np.asarray(metrics["grad_norm"]),
             rot=rot, trans=trans, **_flat(params, "params"),
             **{f"batch/{k}": np.asarray(v) for k, v in batch.items()})


_JAX_CHILD = """
import sys
import jax
jax.config.update("jax_cpu_enable_async_dispatch", False)
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_device", jax.devices("cpu")[0])
from tests.test_torch_parallel_dist import write_jax_dp_reference
write_jax_dp_reference(sys.argv[1])
"""


def jax_trajectory(tc, state_dict, feats):
    """JAX's single-device sampler at noise_scale 0 with the same weights."""
    import jax
    import jax.numpy as jnp

    from framedipt_tpu.diffusion import SE3Diffuser as JSE3
    from framedipt_tpu.model import ScoreNetwork as JNet
    from framedipt_tpu.model.import_torch import convert_state_dict
    from framedipt_tpu.sampling import build_inference_fn
    from tests.test_torch_model import tiny_configs

    jc, _ = tiny_configs()
    jd = JSE3(jc.diffuser)
    run = build_inference_fn(JNet(jc.model, jd, inpainting=True), jd, num_t=NUM_T, min_t=MIN_T,
                             noise_scale=0.0, inpainting=True)
    params = convert_state_dict(state_dict, num_blocks=2, seq_tfmr_layers=1)
    out = run(jax.tree_util.tree_map(jnp.asarray, params),
              {k: jnp.asarray(v) for k, v in feats.items()}, jax.random.PRNGKey(0))
    return {k: np.asarray(v) for k, v in out.items()}


def _synth_weights(tc) -> dict[str, np.ndarray]:
    from tests.parity import fixture_lib

    manifest = [(k, list(v.shape)) for k, v in ScoreNetwork(
        tc.model, SE3Diffuser(tc.diffuser, device="cpu"), inpainting=True).state_dict().items()]
    return fixture_lib.synth_state_dict(manifest)


def _train_weights(tc) -> dict[str, torch.Tensor]:
    """The JAX package's initialization with every entry perturbed, as
    tests/test_torch_model.py:perturbed perturbs JAX's (the frame-update and
    psi heads damped), so no gradient is 0 but those that cancel."""
    from framedipt_tpu_torch.model.weights import init_state_dict

    model = ScoreNetwork(tc.model, SE3Diffuser(tc.diffuser, device="cpu"), inpainting=True)
    gen = torch.Generator().manual_seed(1)
    return {k: v + (1e-3 if "bb_update" in k or "linear_final" in k else 0.05)
            * torch.randn(v.shape, generator=gen)
            for k, v in init_state_dict(model, torch.Generator().manual_seed(0)).items()}


def _cli_config(work: pathlib.Path, data_dir: pathlib.Path, world: int):
    """The training CLI over the fixture complexes at the small width: one
    epoch of batches of 2 (no padding at world size 2), an eval at the last
    step, a log line a step."""
    from tests.test_torch_model import TINY

    overrides = [f"model.{k}={v}" for k, v in TINY.items()] + [f"{k}={v}" for k, v in (
        ("data.csv_path", data_dir / "metadata.csv"), ("data.single_chain", "true"),
        ("data.filtering.min_len", 10), ("data.filtering.max_len", 2000),
        ("data.filtering.chain_max_len", 40), ("data.num_eval_lengths", 1),
        ("data.samples_per_eval_length", 1), ("data.num_t", 3),
        ("experiment.num_epoch", 1), ("experiment.batch_size", 2), ("experiment.log_freq", 1),
        ("experiment.eval_freq", 2), ("experiment.inpainting", "true"),
        ("experiment.ckpt_dir", work / f"cli_ckpt_w{world}"),
        ("experiment.eval_dir", work / f"cli_eval_w{world}"),
        ("diffuser.so3.num_omega", 50), ("diffuser.so3.num_sigma", 20),
        ("diffuser.so3.cache_dir", "null"),
    )]
    return load_config(overrides)


def _sampler_feats(n: int) -> dict[str, np.ndarray]:
    from tests.test_torch_model import make_feats

    feats = make_feats(11, B=2, N=n)
    feats["t"] = np.ones((2,), np.float32)
    feats["sc_ca_t"] = np.zeros_like(feats["sc_ca_t"])
    return feats


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every rank's results (world 2 and world 4), the JAX references and
    the port's one-process runs."""
    from tests.test_torch_train import _nested, _seed_with_coin, port_config
    from tests.test_torch_train_cli import CIF_DIR
    from tests.unit.test_train import make_batch
    from framedipt_tpu_torch.data.pipeline import ProcessOptions, process_serially, write_metadata
    from framedipt_tpu_torch.model.weights import params_from_jax
    from framedipt_tpu_torch.tools.config import FilteringConfig

    work = tmp_path_factory.mktemp("parallel_dist")
    tc = port_config()
    save_config(tc, work / "config.json")
    weights = _synth_weights(tc)
    torch.save({k: torch.as_tensor(v) for k, v in weights.items()}, work / "sampler_sd.pt")
    feats = {name: _sampler_feats(n) for name, n in (("n24", 24), ("n22", 22))}
    for name, f in feats.items():
        np.savez(work / f"feats_{name}.npz", **f)
    torch.save(_train_weights(tc), work / "train_sd.pt")
    np.savez(work / "train_batch.npz", **{k: np.asarray(v) for k, v in make_batch(B=4).items()})

    # Its output to a file: a pipe that nobody reads while the port runs
    # below could fill and stop the child.
    jax_log = work / "jax_dp2.log"
    with open(jax_log, "w") as f:
        jax_child = subprocess.Popen([sys.executable, "-c", _JAX_CHILD, str(work / "jax_dp2.npz")],
                                     cwd=REPO, stdout=f, stderr=subprocess.STDOUT)
    jax_deadline = time.monotonic() + JAX_TIMEOUT_S
    try:
        world4 = start_ranks(4, work)
        # The port in one process meanwhile: the sampler, two steps, a
        # checkpoint, one more step.
        model = _sampler_model(work)
        single = {f"{feats_name}/{k}": v.numpy() for feats_name in {r[3] for w in SAMPLER_RUNS.values()
                                                                   for r in w if r[4] == 1.0}
                  for k, v in _sample(model, _feats(work, feats_name), 1.0).items()}
        tr = _trainer(work, "train_sd.pt")
        batch = _batch(work, "train_batch")
        gen = torch.Generator().manual_seed(2)
        single["train/metrics"] = [tr.step(batch, gen) for _ in range(2)]
        single["train/params"] = _params(tr)
        save_checkpoint(work / "ckpt_w1", 2, tr.model, tr.optimizer, load_config(), keep=1)
        tr.step(batch, torch.Generator().manual_seed(STEP_SEEDS["resume_w1"]))
        single["resume_w1"] = _params(tr)
        jax_traj = {name: jax_trajectory(tc, weights, f) for name, f in feats.items()}
        data_dir = work / "processed"
        write_metadata(process_serially(sorted(CIF_DIR.glob("*.cif")), ProcessOptions(
            output_dir=data_dir, filtering=FilteringConfig(max_len=2000, min_len=10,
                                                           chain_max_len=2000))),
            data_dir / "metadata.csv")
        save_config(_cli_config(work, data_dir, 2), work / "cli_w2.json")
        single["cli"] = train(_cli_config(work, data_dir, 1), device="cpu")
        wait_ranks(world4, work, 4)

        jax_child.wait(timeout=max(1.0, jax_deadline - time.monotonic()))
        assert jax_child.returncode == 0, jax_log.read_text()[-4000:]
    finally:
        if jax_child.poll() is None:
            jax_child.kill()
            jax_child.wait(timeout=30)
    with np.load(work / "jax_dp2.npz") as f:
        jref = dict(f)
    torch.save(params_from_jax(_nested(jref, "params"), num_blocks=2, seq_tfmr_layers=1),
               work / "jax_sd.pt")
    np.savez(work / "jax_batch.npz", **{k[len("batch/"):]: v for k, v in jref.items()
                                        if k.startswith("batch/")})
    np.savez(work / "jax_noise.npz", rot=jref["rot"], trans=jref["trans"],
             coin_seed=_seed_with_coin(True))
    wait_ranks(start_ranks(2, work), work, 2)

    # World 2 -> 1: resume the world-2 checkpoint here, one step.
    tr = _trainer(work, "train_sd.pt")
    load_state(tr.model, tr.optimizer, load_checkpoint(work / "ckpt_w2" / "step_2"))
    single["ckpt_w2_params"] = _params(tr)
    single["ckpt_w2_optim"] = _optim(tr.optimizer.state_dict())
    single["ckpt_w1_optim"] = _optim(load_checkpoint(work / "ckpt_w1" / "step_2")["optim"])
    tr.step(batch, torch.Generator().manual_seed(STEP_SEEDS["resume_w2"]))
    single["resume_w2"] = _params(tr)

    single["work"] = work
    ranks = {w: [dict(np.load(work / f"rank{r}_w{w}.npz")) for r in range(w)] for w in (2, 4)}
    return ranks, single, jax_traj, jref


def _ca_rmsd(a, b):
    return float(np.sqrt(np.mean(np.sum((a - b) ** 2, axis=-1))))


def _run_of(name):
    world = next(w for w, rs in SAMPLER_RUNS.items() for r in rs if r[0] == name)
    return world, next(r for r in SAMPLER_RUNS[world] if r[0] == name)


NOISELESS = [r[0] for w in SAMPLER_RUNS.values() for r in w if r[4] == 0.0]
NOISY = [r[0] for w in SAMPLER_RUNS.values() for r in w if r[4] == 1.0]


@pytest.mark.parametrize("name", NOISELESS)
def test_sp_sampler_matches_jax(runs, name):
    """noise_scale 0: every rank's trajectory against JAX's single-device
    sampler, each sample and step within 0.01 A CA RMSD, psi 1e-3."""
    ranks, _, jax_traj, _ = runs
    world, (_, _, _, feats, _) = _run_of(name)
    want = jax_traj[feats]
    for r, got in enumerate(ranks[world]):
        traj = got[f"{name}/prot_traj"]
        assert traj.shape == want["prot_traj"].shape
        for b in range(traj.shape[1]):
            for step in range(NUM_T):
                assert _ca_rmsd(traj[step, b, :, 1], want["prot_traj"][step, b, :, 1]) < 0.01, \
                    (r, b, step)
        np.testing.assert_allclose(got[f"{name}/psi_pred"], want["psi_pred"], atol=1e-3)


@pytest.mark.parametrize("name", NOISY)
def test_sp_sampler_matches_one_process(runs, name):
    """noise_scale 1, the same generator: every rank's trajectory against the
    port's single-process sampler's (the noise of the whole batch is drawn on
    every rank)."""
    ranks, single, _, _ = runs
    world, (_, _, _, feats, _) = _run_of(name)
    for got in ranks[world]:
        np.testing.assert_allclose(got[f"{name}/final_rigids"], single[f"{feats}/final_rigids"],
                                   atol=2e-5)
        np.testing.assert_allclose(got[f"{name}/prot_traj"], single[f"{feats}/prot_traj"],
                                   atol=2e-4)


@pytest.mark.parametrize("name", NOISELESS + NOISY)
def test_ranks_agree_to_the_bit(runs, name):
    ranks, _, _, _ = runs
    world, _ = _run_of(name)
    first = ranks[world][0]
    for got in ranks[world][1:]:
        for k in ("final_rigids", "prot_traj", "psi_pred"):
            np.testing.assert_array_equal(got[f"{name}/{k}"], first[f"{name}/{k}"])


@pytest.mark.parametrize("name", ["sp2_n24_n0", "sp4_n22_n0", "dp2sp2_n22_n1"])
def test_sp_kernels_run_on_row_blocks(runs, name):
    """The wrappers see each rank's [B, ceil(N/sp), N, C] row block (the
    embedder's g with ceil(N/sp) rows, h with N), B the rank's samples."""
    ranks, _, _, _ = runs
    world, (_, dp, sp_size, feats, _) = _run_of(name)
    n = int(feats[1:])
    rows, b = -(-n // sp_size), 2 // dp
    for got in ranks[world]:
        shapes = [json.loads(s) for s in json.loads(str(got["shapes"]))[name]]
        assert sorted(s[0] for s in shapes) == ["emb", "pair"], shapes
        for s in shapes:
            if s[0] == "pair":
                assert s[1] == [b, rows, n, 16], s
            else:
                assert s[1][:2] == [b, rows] and s[2][:2] == [b, n], s


@functools.cache
def _cancelled_masks() -> dict[str, np.ndarray]:
    from tests.test_torch_train import port_config

    tc = port_config()
    return cancelled_entries(
        ScoreNetwork(tc.model, SE3Diffuser(tc.diffuser, device="cpu"), inpainting=True))


def _cancelled(name: str, shape: tuple) -> np.ndarray:
    """The entries whose gradient vanishes in exact arithmetic
    (``model.weights.cancelled_entries``): the key biases of the IPA and of
    the sequence transformer, and linear_b's bias, each adding the same term
    to a whole softmax row. Their gradient is float32 noise, and Adam
    follows its sign with a step of lr."""
    return _cancelled_masks().get(name, np.zeros(shape, bool))


@pytest.mark.parametrize("world", [2, 4], ids=["dp2", "dp2_fsdp2"])
def test_train_step_matches_one_process(runs, world):
    ranks, single, _, _ = runs
    for i, m in enumerate(single["train/metrics"]):
        for got in ranks[world]:
            np.testing.assert_allclose(got[f"train/loss{i}"], float(m["loss"]), rtol=1e-5)
            np.testing.assert_allclose(got[f"train/grad_norm{i}"], float(m["grad_norm"]),
                                       rtol=1e-5)
            # The metrics are the whole batch's.
            np.testing.assert_allclose(got[f"train/per_example_loss{i}"],
                                       m["per_example_loss"].numpy(), rtol=1e-5, atol=1e-6)
            np.testing.assert_array_equal(got[f"train/t{i}"], m["t"].numpy())
    got = ranks[world][0]
    for name, want in single["train/params"].items():
        keep = ~_cancelled(name, want.shape)
        np.testing.assert_allclose(got[f"train/params/{name}"][keep], want[keep], atol=1e-6,
                                   err_msg=name)


def test_dp_step_matches_jax_mesh_step(runs):
    ranks, _, _, jref = runs
    for got in ranks[2]:
        assert bool(got["jax/self_conditioned"])
        np.testing.assert_allclose(got["jax/loss"], float(jref["loss"]), rtol=1e-5)
        np.testing.assert_allclose(got["jax/grad_norm"], float(jref["grad_norm"]), rtol=1e-5)


@pytest.mark.parametrize("direction", ["resume_w2", "resume_w1"],
                         ids=["world2_to_1", "world1_to_2"])
def test_checkpoint_resumes_at_another_world_size(runs, direction):
    """The resumed side holds the writer's whole model and optimizer state
    to the bit, and the step after it gives the other side's parameters
    (but where the gradient cancels, as above)."""
    ranks, single, _, _ = runs
    got = ranks[2][0]
    if direction == "resume_w2":
        # The world-2 checkpoint read in one process: the ranks' state.
        for name, want in single["ckpt_w2_params"].items():
            np.testing.assert_array_equal(want, got[f"train/params/{name}"], err_msg=name)
        loaded = single["ckpt_w2_optim"]
        assert loaded.keys() == {k[len("train/optim/"):] for k in got if k.startswith("train/optim/")}
        for k, v in loaded.items():
            np.testing.assert_array_equal(v, got[f"train/optim/{k}"], err_msg=k)
    else:
        # The one-process checkpoint loaded at world size 2 (loading gives the
        # parameters no step updated a state of zeros too).
        written = single["ckpt_w1_optim"]
        for k, v in written.items():
            np.testing.assert_array_equal(got[f"loaded_w1/{k}"], v, err_msg=k)
        for k in got:
            if k.startswith("loaded_w1/") and k[len("loaded_w1/"):] not in written \
                    and not k.endswith("/step"):
                assert not got[k].any(), k
    for name, want in single[direction].items():
        mask = ~_cancelled(name, want.shape)
        np.testing.assert_allclose(got[f"{direction}/{name}"][mask], want[mask], atol=1e-6,
                                   err_msg=name)


def test_rank0_decides_whether_a_checkpoint_is_written(runs):
    """Rank 1's directory already held step 2 and rank 0's did not: rank 0
    wrote it there, rank 1's stayed as it was, and neither rank hung."""
    _, single, _, _ = runs
    work = single["work"]
    written = load_checkpoint(work / "ckpt_rank0" / "step_2")
    assert written["step"] == 2
    np.testing.assert_array_equal(written["model"]["score_model.trunk.ipa_0.linear_b.weight"],
                                  load_checkpoint(work / "ckpt_w2" / "step_2")["model"][
                                      "score_model.trunk.ipa_0.linear_b.weight"])
    assert torch.load(work / "ckpt_rank1" / "step_2" / CKPT_FILE) == {}


def _metrics(run_dir: pathlib.Path) -> list[dict]:
    return [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]


def test_training_cli_at_world_size_two(runs):
    """Rank 0 writes each file once; the first step's logged loss and grad
    norm equal the one-process run's. (The epoch's last batch holds one
    example: world size 2 pads it with a copy, so from there the runs
    differ, as the JAX CLI's do at dp=2.)"""
    from framedipt_tpu_torch.model.weights import load_reference_checkpoint
    from framedipt_tpu_torch.train.checkpoints import latest_checkpoint

    _, single, _, _ = runs
    work = single["work"]
    run_dir = work / "cli_ckpt_w2" / "baseline"
    assert (run_dir / "train_conf.json").exists()
    rows = _metrics(run_dir)
    train_rows = [r for r in rows if "loss" in r]
    assert [r["step"] for r in train_rows] == [1, 2]  # one line a step: rank 0's
    eval_rows = [r for r in rows if "eval_ca_ca_deviation" in r]
    assert [r["step"] for r in eval_rows] == [2]
    assert all(np.isfinite(v) for r in rows for v in r.values() if isinstance(v, float))
    want = next(r for r in _metrics(single["cli"].ckpt_dir) if r["step"] == 1 and "loss" in r)
    np.testing.assert_allclose(train_rows[0]["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(train_rows[0]["grad_norm"], want["grad_norm"], rtol=1e-5)
    pdbs = sorted((work / "cli_eval_w2" / "baseline" / "step_2").glob("length_*/sample_*.pdb"))
    assert len(pdbs) == 1, pdbs
    ckpt = latest_checkpoint(run_dir)
    assert ckpt.name == "step_2" and not list(ckpt.glob("*.tmp*"))
    tc = _cli_config(work, work, 2)
    model = ScoreNetwork(tc.model, SE3Diffuser(tc.diffuser, device="cpu"), inpainting=True)
    model.load_state_dict(load_reference_checkpoint(ckpt / "checkpoint.pth")[0], strict=True)
