"""The port's training CLI against the JAX package's: the same batches from
the same metadata and seed (the init draw included), the same importance
draws, the same eval metrics; the prefetcher, the checkpoints; and a tiny
run on the CPU over the preprocessed fixture mmCIF files whose checkpoint
loads into the port's service and, through the JAX package's torch
importer, gives the JAX ScoreNetwork the port's forward (tolerance 1e-4 of
max(1, |reference|), as tests/test_torch_model.py)."""
import json
import pathlib
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from framedipt_tpu.diffusion import SE3Diffuser as JSE3
from framedipt_tpu.experiments.train import TrainDataset as JDataset
from framedipt_tpu.model import ScoreNetwork as JNet
from framedipt_tpu.model.import_torch import convert_state_dict, load_torch_checkpoint
from framedipt_tpu.tools.config import Config as JConfig
from framedipt_tpu.train import eval_sampling as j_eval
from framedipt_tpu.train.importance import TimestepImportanceSampler as JSampler

from framedipt_tpu_torch.data.pipeline import ProcessOptions, process_serially, write_metadata
from framedipt_tpu_torch.diffusion import SE3Diffuser as TSE3
from framedipt_tpu_torch.experiments.serve import InpaintingService
from framedipt_tpu_torch.experiments.train import TrainDataset as TDataset
from framedipt_tpu_torch.experiments.train import main, train
from framedipt_tpu_torch.model import ScoreNetwork as TNet
from framedipt_tpu_torch.model.weights import init_state_dict, load_reference_checkpoint
from framedipt_tpu_torch.tools.config import Config as TConfig
from framedipt_tpu_torch.tools.config import FilteringConfig, SO3Config
from framedipt_tpu_torch.train import eval_sampling as t_eval
from framedipt_tpu_torch.train.checkpoints import (
    CKPT_FILE,
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from framedipt_tpu_torch.train.importance import TimestepImportanceSampler as TSampler
from framedipt_tpu_torch.train.prefetch import prefetch

from tests.test_torch_model import TINY, _assert_outputs_close, make_feats, tiny_configs
from tests.unit.geom_helpers import nerf_backbone
from tests.torch_threads import one_torch_thread  # noqa: F401


CIF_DIR = pathlib.Path(__file__).resolve().parent / "data" / "cifs"


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("processed")
    rows = process_serially(sorted(CIF_DIR.glob("*.cif")), ProcessOptions(
        output_dir=out, filtering=FilteringConfig(max_len=2000, min_len=10, chain_max_len=2000)))
    assert len(rows) == 3
    write_metadata(rows, out / "metadata.csv")
    return out


def _data_cfg(cfg, data_dir, inpainting, single_chain, cluster_file=None):
    cfg.data.csv_path = str(data_dir / "metadata.csv")
    cfg.data.single_chain = single_chain
    cfg.data.cluster_file = cluster_file
    cfg.data.filtering.min_len = 10
    cfg.data.filtering.max_len = 2000
    cfg.data.filtering.chain_max_len = 120
    cfg.experiment.inpainting = inpainting
    cfg.experiment.max_squared_res = 200_000
    return cfg


@pytest.mark.parametrize("inpainting,single_chain,clusters", [
    (False, False, False), (True, True, False), (True, False, True),
])
def test_batches_match_jax(data_dir, tmp_path, inpainting, single_chain, clusters):
    """The init draw of two, then two epochs at batch size 3: the same
    batches, array for array, from the same metadata.csv and seed."""
    cluster_file = None
    if clusters:
        cluster_file = tmp_path / "clusters.tsv"
        cluster_file.write_text("pdb_name\tcluster\n1fyt\t7\n5ksa\t7\n")
        cluster_file = str(cluster_file)
    jd = JDataset(_data_cfg(JConfig(), data_dir, inpainting, single_chain, cluster_file),
                  np.random.default_rng(4))
    td = TDataset(_data_cfg(TConfig(), data_dir, inpainting, single_chain, cluster_file),
                  np.random.default_rng(4))
    if clusters:
        np.testing.assert_array_equal(td.sample_weights, jd.sample_weights)
    runs = [(2, 1), (3, 2)]  # (batch size, epochs): the init draw, then training
    for bs, epochs in runs:
        for _ in range(epochs):
            want, got = list(jd.batches(bs)), list(td.batches(bs))
            assert len(got) == len(want) > 0
            for g, w in zip(got, want):
                assert sorted(g) == sorted(w)
                for k in w:
                    np.testing.assert_array_equal(g[k], w[k], err_msg=k)
                    assert g[k].dtype == w[k].dtype, k
    assert jd.rng.integers(1 << 30) == td.rng.integers(1 << 30)


def test_importance_sampler_matches_jax():
    j, t = JSampler(num_bins=5, history_per_term=2), TSampler(num_bins=5, history_per_term=2)
    j_rng, t_rng = np.random.default_rng(1), np.random.default_rng(1)
    for step in range(12):
        (jt, jw), (tt, tw) = j.sample(j_rng, 4), t.sample(t_rng, 4)
        np.testing.assert_array_equal(tt, jt)
        np.testing.assert_array_equal(tw, jw)
        losses = np.random.default_rng(step).random(4)
        j.update(jt, losses)
        t.update(tt, losses)
        assert t.warmed_up == j.warmed_up
    assert t.warmed_up
    np.testing.assert_array_equal(t._weights(), j._weights())


def test_prefetch_reraises_and_closes():
    def source():
        yield 1
        yield 2
        raise KeyError("boom")

    it = prefetch(source(), size=1)
    try:
        assert next(it) == 1 and next(it) == 2
        with pytest.raises(KeyError, match="boom"):
            next(it)
    finally:
        it.close()
    assert not it._thread.is_alive()
    # Closing early stops a thread blocked on a full queue.
    endless = prefetch(iter(int, 1), size=1)
    try:
        assert next(endless) == 0
    finally:
        endless.close()
    assert not endless._thread.is_alive()


def test_checkpoints_prune_latest_and_idempotent(tmp_path):
    model = torch.nn.Linear(3, 2)
    opt = torch.optim.Adam(model.parameters())
    cfg = TConfig()
    assert latest_checkpoint(tmp_path / "none") is None
    for step in (5, 10, 20):
        save_checkpoint(tmp_path, step, model, opt, cfg, epoch=1, keep=2)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_10", "step_20"]
    assert latest_checkpoint(tmp_path).name == "step_20"
    mtime = (tmp_path / "step_20" / CKPT_FILE).stat().st_mtime_ns
    with torch.no_grad():
        model.weight.add_(1.0)
    save_checkpoint(tmp_path, 20, model, opt, cfg, keep=2)  # already written: left as is
    assert (tmp_path / "step_20" / CKPT_FILE).stat().st_mtime_ns == mtime
    payload = load_checkpoint(tmp_path / "step_20")
    assert sorted(payload) == ["conf", "epoch", "model", "optim", "step"]
    assert payload["step"] == 20 and payload["epoch"] == 1
    assert payload["conf"]["model"]["ipa"]["pallas_emb_bwd_impl"] == "pallas"
    assert not torch.equal(payload["model"]["weight"], model.weight)


def test_eval_metrics_match_jax(tmp_path):
    """Both packages' run_training_eval on the same sampled backbones (a
    stand-in sampler returns a helix): the same metric keys and values, the
    same PDB files."""
    jc, tc = tiny_configs()
    for cfg in (jc, tc):
        cfg.data.filtering.min_len, cfg.data.filtering.max_len = 20, 30
        cfg.data.num_eval_lengths, cfg.data.samples_per_eval_length = 2, 3
        cfg.experiment.eval_batch_size = 2
        cfg.experiment.inpainting = True
    assert t_eval.eval_lengths(tc) == j_eval.eval_lengths(jc) == [20, 30]
    atom37, mask = nerf_backbone(32)
    pos = (atom37 * mask[..., None]).astype(np.float32)
    seen = []

    def stand_in(feats, batch):
        seen.append(sorted(feats))
        return {"prot_traj": np.tile(pos[None, None], (1, batch, 1, 1, 1))}

    want = j_eval.run_training_eval(
        lambda params, feats, key: stand_in(feats, feats["res_mask"].shape[0]),
        JSE3(jc.diffuser), jc, None, 7, jax.random.PRNGKey(0), out_dir=tmp_path / "jax")
    got = t_eval.run_training_eval(
        lambda feats, gen: {"prot_traj": torch.as_tensor(stand_in(feats, feats["res_mask"].shape[0])["prot_traj"])},
        TSE3(tc.diffuser, device="cpu"), tc, 7, torch.Generator().manual_seed(0),
        out_dir=tmp_path / "port")
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    assert seen[0] == seen[-1]  # the same feature keys, aatype included
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*.pdb"))
    assert files == sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*.pdb"))
    assert len(files) == 6


def _tiny_train_cfg(data_dir, root, name="tiny"):
    _, cfg = tiny_configs()
    cfg.model.ipa.num_blocks = 1  # the JAX forward below runs op by op: fewer operations
    cfg.diffuser.so3 = SO3Config(num_omega=50, num_sigma=20, cache_dir=None)
    _data_cfg(cfg, data_dir, inpainting=True, single_chain=True)
    cfg.data.filtering.chain_max_len = 60
    cfg.data.num_eval_lengths, cfg.data.samples_per_eval_length, cfg.data.num_t = 1, 2, 3
    e = cfg.experiment
    e.batch_size, e.num_epoch, e.log_freq = 2, 2, 1
    e.ckpt_freq, e.early_ckpt_step, e.eval_freq, e.eval_batch_size = 2, 1, 3, 2
    e.learning_rate = 1e-4
    e.ckpt_dir, e.eval_dir, e.name = str(root / "ckpt"), str(root / "eval"), name
    e.seed = 3
    return cfg


@pytest.fixture(scope="module")
def tiny_run(data_dir, tmp_path_factory):
    """A tiny training run on the CPU: 3 single-chain examples, batch 2, two
    epochs (4 steps), checkpoints at 1 (early), 2 and 4, eval at 3."""
    root = tmp_path_factory.mktemp("run")
    cfg = _tiny_train_cfg(data_dir, root)
    return root, cfg, train(cfg, device="cpu")


def test_tiny_run_writes_metrics_checkpoint_and_eval(tiny_run):
    root, cfg, out = tiny_run
    assert out.step == out.steps_run == 4
    rows = [json.loads(x) for x in (out.ckpt_dir / "metrics.jsonl").read_text().splitlines()]
    train_rows = [r for r in rows if "loss" in r]
    assert [r["step"] for r in train_rows] == [1, 2, 3, 4]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in train_rows)
    eval_rows = [r for r in rows if "eval_ca_ca_deviation" in r]
    assert [r["step"] for r in eval_rows] == [3]
    want_keys = {f"eval_{k}" for k in ("ca_ca_deviation", "ca_ca_valid_percent",
                                       "ca_clash_percent", "non_coil_percent", "coil_percent",
                                       "helix_percent", "strand_percent", "radius_of_gyration")}
    assert set(eval_rows[0]) - {"step", "time"} == want_keys
    pdbs = sorted((root / "eval" / "tiny" / "step_3").rglob("*.pdb"))
    assert [p.parent.name for p in pdbs] == ["length_10", "length_10"]
    assert [p.name for p in (out.ckpt_dir).glob("step_*")] == ["step_4"]
    assert (out.ckpt_dir / "train_conf.json").exists()
    assert json.loads((out.ckpt_dir / "train_conf.json").read_text())["experiment"]["seed"] == 3


def test_train_without_a_resume_starts_from_the_zoo(data_dir, tmp_path):
    """A run with nothing to resume starts from the JAX package's
    initialization (the AF2 zoo drawn from experiment.seed), not from the
    test fixtures' weights: zero epochs return the initial model."""
    cfg = _tiny_train_cfg(data_dir, tmp_path, name="zoo")
    cfg.experiment.num_epoch = 0
    out = train(cfg, device="cpu")
    assert out.steps_run == 0
    want = init_state_dict(out.model, torch.Generator().manual_seed(cfg.experiment.seed))
    got = out.model.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert not got["score_model.trunk.bb_update_0.linear.weight"].any()


def test_resume_continues_past_the_saved_step(tiny_run, data_dir):
    root, _, first = tiny_run
    cfg = _tiny_train_cfg(data_dir, root)
    cfg.experiment.num_epoch = 3  # auto-resume from the run's own directory
    cfg.experiment.eval_freq = 1000
    out = train(cfg, device="cpu")
    assert out.step == first.step + 6 and out.steps_run == 6
    assert latest_checkpoint(out.ckpt_dir).name == f"step_{out.step}"


def test_use_ckpt_conf_wins_over_a_mismatched_width(tiny_run, data_dir, tmp_path):
    _, _, first = tiny_run
    cfg = _tiny_train_cfg(data_dir, tmp_path, name="warm")
    cfg.model.node_embed_size = cfg.model.ipa.c_s = 48  # cannot hold the saved weights
    cfg.experiment.num_epoch, cfg.experiment.eval_freq = 1, 1000
    cfg.experiment.resume_ckpt_dir = str(first.ckpt_dir)
    cfg.experiment.use_ckpt_conf = True
    out = train(cfg, device="cpu")
    assert cfg.model.node_embed_size == 32 and cfg.model.ipa.c_s == 32
    assert out.step > 4 and latest_checkpoint(tmp_path / "ckpt" / "warm") is not None


def test_checkpoint_serves_and_gives_jax_the_same_forward(tiny_run):
    """The run's checkpoint file: the port's loader and service take it
    (strict=True) and answer one inpainting request; the JAX package's
    importer turns it into JAX params whose ScoreNetwork (op by op) computes
    the port's forward."""
    _, _, out = tiny_run
    ckpt = latest_checkpoint(out.ckpt_dir) / CKPT_FILE
    sd, conf = load_reference_checkpoint(str(ckpt))
    assert conf["model"]["node_embed_size"] == 32

    service_cfg = TConfig()
    service_cfg.inference.weights_path = str(ckpt)
    service = InpaintingService(service_cfg, device="cpu")
    atom37, mask = nerf_backbone(24)
    from framedipt_tpu_torch.data.protein import Protein, from_pdb_string, to_pdb

    pdb = to_pdb(Protein(atom_positions=atom37 * mask[..., None], atom_mask=mask,
                         aatype=np.zeros(24, np.int64), residue_index=np.arange(1, 25),
                         chain_index=np.zeros(24, np.int64), b_factors=np.zeros((24, 37))))
    (reply,) = service.inpaint(pdb, chain="A", start=8, end=14, samples=1, num_t=2)
    got = from_pdb_string(reply)
    assert len(got.aatype) == 24 and np.isfinite(got.atom_positions).all()
    fixed = np.r_[0:8, 15:24]
    np.testing.assert_allclose(got.atom_positions[fixed, 1], atom37[fixed, 1], atol=1e-3)

    j_sd, j_conf = load_torch_checkpoint(str(ckpt))
    assert j_conf["model"]["ipa"]["c_s"] == 32
    params = convert_state_dict({k: np.asarray(v) for k, v in j_sd.items()},
                                num_blocks=1, seq_tfmr_layers=1)
    jc, tc = tiny_configs()
    jc.model.ipa.num_blocks = tc.model.ipa.num_blocks = 1
    jnet = JNet(jc.model, JSE3(jc.diffuser), inpainting=True)
    feats = make_feats(7)
    want = jnet.apply(params, {k: jnp.asarray(v) for k, v in feats.items()})
    tnet = TNet(tc.model, TSE3(tc.diffuser, device="cpu"), inpainting=True)
    tnet.load_state_dict(sd, strict=True)
    with torch.no_grad():
        port = tnet({k: torch.as_tensor(v) for k, v in feats.items()})
    _assert_outputs_close(port, want)


def test_cli_refuses_more_than_one_card_and_runs_on_the_cpu(data_dir, tmp_path):
    args = [f"{k}={v}" for k, v in (
        ("data.csv_path", data_dir / "metadata.csv"), ("data.single_chain", "true"),
        ("data.filtering.min_len", 10), ("data.filtering.max_len", 2000),
        ("data.filtering.chain_max_len", 40), ("experiment.num_epoch", 1),
        ("experiment.batch_size", 3), ("experiment.ckpt_dir", tmp_path / "c"),
        ("experiment.eval_freq", 1000), ("diffuser.so3.num_omega", 50),
        ("diffuser.so3.num_sigma", 20), ("diffuser.so3.cache_dir", "null"),
    )] + [f"model.{k}={v}" for k, v in TINY.items()]
    # Without torchrun the process runs alone: dp x fsdp above 1 is refused.
    with pytest.raises(ValueError, match="runs alone.*torchrun"):
        main(["--device=cpu", "experiment.dp_size=4"] + args)
    with pytest.raises(ValueError, match="runs alone.*torchrun"):
        main(["--device=cpu", "experiment.fsdp_size=2"] + args)
    main(["--device=cpu"] + args)
    assert latest_checkpoint(tmp_path / "c" / "baseline").name == "step_1"
    assert not [t for t in threading.enumerate() if "_worker" in t.name]  # prefetch closed
