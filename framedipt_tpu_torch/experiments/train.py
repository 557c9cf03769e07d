"""Training CLI: score matching over a preprocessed PDB dataset.

The JAX package's ``experiments/train.py`` on one CUDA device: Adam at the
configured learning rate, t ~ U(min_t, 1) per example (or importance
sampled), forward-marginal noising, the score-matching losses, batches of one
length bucket under the ``max_squared_res`` memory cap, inpainting redaction
masks, checkpoints every ``ckpt_freq`` steps and an early one, periodic
eval sampling and a JSONL metrics stream. Host randomness is one numpy
Generator seeded with ``experiment.seed``, drawn in the JAX package's order
(the init batch draw included); device randomness is one ``torch.Generator``
on the device seeded with ``experiment.seed + 1``.

Under ``torchrun`` it trains on a ``(dp, fsdp)`` mesh of one process per GPU
(``experiment.dp_size`` x ``experiment.fsdp_size`` = the number of
processes; ``parallel/mesh.py``): every rank builds the same batch from the
same host Generator, pads it by repeating examples to a multiple of the
ranks and keeps its own rows in the step; rank 0 alone logs and writes
``metrics.jsonl``, ``train_conf.json``, the eval PDBs and the checkpoints,
which hold the whole model and optimizer state, as a one-process run's do.

Usage:
    python -m framedipt_tpu_torch.experiments.train [--device=cpu] \
        [--config=conf.json] data.csv_path=.../metadata.csv [key=value ...]
    torchrun --nproc_per_node=K -m framedipt_tpu_torch.experiments.train \
        experiment.dp_size=K data.csv_path=... [key=value ...]
"""
from __future__ import annotations

import collections
import csv
import logging
import os
import pathlib
import pickle
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist

from framedipt_tpu_torch.data import features as feature_lib
from framedipt_tpu_torch.diffusion import SE3Diffuser
from framedipt_tpu_torch.model import ScoreNetwork
from framedipt_tpu_torch.model.kernels.build import build_all
from framedipt_tpu_torch.model.weights import init_state_dict
from framedipt_tpu_torch.parallel.mesh import (
    init_distributed,
    make_mesh,
    pad_batch,
    rank,
    shard_params,
    world_size,
)
from framedipt_tpu_torch.tools.config import (
    Config,
    check_emb_bwd_impl,
    load_config,
    merge_checkpoint_config,
    resolve_kernel_flags,
    save_config,
)
from framedipt_tpu_torch.tools.device import resolve_device, set_full_precision_matmul
from framedipt_tpu_torch.tools.log import get_logger
from framedipt_tpu_torch.tools.metrics_logger import MetricsLogger
from framedipt_tpu_torch.train.checkpoints import (
    latest_checkpoint,
    load_checkpoint,
    load_state,
    save_checkpoint,
)
from framedipt_tpu_torch.train.eval_sampling import build_eval_sampler, run_training_eval
from framedipt_tpu_torch.train.importance import TimestepImportanceSampler
from framedipt_tpu_torch.train.loop import build_train_step, make_optimizer
from framedipt_tpu_torch.train.losses import t_stratified_metrics
from framedipt_tpu_torch.train.prefetch import prefetch

logger = get_logger()

_BATCH_KEYS = ("rigids_0", "res_mask", "fixed_mask", "seq_idx", "torsion_angles_sin_cos", "aatype")


def _feats_nbytes(feats: dict) -> int:
    return sum(v.nbytes for v in feats.values() if isinstance(v, np.ndarray))


def read_metadata(path) -> list[dict[str, str]]:
    """The rows of a ``metadata.csv`` as dicts of strings."""
    with open(path, newline="", encoding="utf-8") as f:
        return list(csv.DictReader(f))


def read_clusters(path) -> dict[str, object]:
    """pdb_name -> cluster from a two-column file whose delimiter is sniffed
    from its first line; a first line naming "pdb" is a header. Clusters
    that all read as integers are integers."""
    with open(path, newline="", encoding="utf-8") as f:
        first = f.readline()
        dialect = csv.Sniffer().sniff(first)
        f.seek(0)
        rows = [r for r in csv.reader(f, dialect) if r]
    if "pdb" in first:
        rows = rows[1:]
    names = [r[0] for r in rows]
    clusters: list = [r[1] for r in rows]
    try:
        clusters = [int(c) for c in clusters]
    except ValueError:
        pass
    return dict(zip(names, clusters))


class TrainDataset:
    """Preprocessed pickles listed in ``metadata.csv``, featurized on first
    use (the random chain pick and crop then stay for the run, up to a
    byte-bounded LRU), with per-example redaction masks (inpainting),
    cluster-balanced sampling and batches of one length bucket."""

    def __init__(self, cfg: Config, rng: np.random.Generator) -> None:
        self.cfg = cfg
        self.rng = rng
        filt = cfg.data.filtering
        meta = [r for r in read_metadata(cfg.data.csv_path)
                if filt.min_len <= int(r["modeled_seq_len"]) <= filt.max_len]
        if filt.subset:
            meta = meta[: filt.subset]
        self.meta = meta
        logger.info(f"dataset: {len(self.meta)} structures after filters")
        self._cache: collections.OrderedDict[int, dict] = collections.OrderedDict()
        self._cache_bytes = 0
        self._cache_budget = 4 << 30

        # Cluster-balanced sampling: each example weighted 1 / its cluster's
        # size (1 for an example in no cluster).
        self.sample_weights = None
        if cfg.data.cluster_file:
            cluster_of = read_clusters(cfg.data.cluster_file)
            assigned = [cluster_of.get(r["pdb_name"]) for r in self.meta]
            sizes = collections.Counter(c for c in assigned if c is not None)
            w = np.asarray([1.0 / sizes[c] if c is not None else 1.0 for c in assigned])
            self.sample_weights = w / w.sum()
            logger.info(f"cluster sampling over {len(sizes)} clusters")

    def _features(self, idx: int) -> dict:
        if idx in self._cache:
            self._cache.move_to_end(idx)
            return self._cache[idx]
        with open(self.meta[idx]["processed_path"], "rb") as f:
            raw = pickle.load(f)
        feats = feature_lib.build_model_features(
            raw,
            extract_single_chain=self.cfg.data.single_chain,
            rng=self.rng,
            chain_max_len=self.cfg.data.filtering.chain_max_len,
        )
        self._cache[idx] = feats
        self._cache_bytes += _feats_nbytes(feats)
        while self._cache_bytes > self._cache_budget and len(self._cache) > 1:
            _, evicted = self._cache.popitem(last=False)
            self._cache_bytes -= _feats_nbytes(evicted)
        return feats

    def example(self, idx: int) -> dict:
        feats = dict(self._features(idx))
        if self.cfg.experiment.inpainting:
            red = self.cfg.data.redaction
            mask = feature_lib.create_redacted_regions(
                feats["chain_idx"], feats["res_mask"], self.rng,
                red.redact_min_len, red.redact_max_len,
            )
            feats["fixed_mask"] = (1 - mask).astype(np.float32)
        else:
            feats["fixed_mask"] = np.zeros_like(feats["res_mask"])
        return feats

    def batches(self, batch_size: int):
        """One epoch of stacked batches, each of one length bucket. Examples
        are featurized first and bucketed by their actual length, and a
        batch holds at most max_squared_res // bucket^2 examples."""
        n = len(self.meta)
        if self.sample_weights is not None:
            order = self.rng.choice(n, size=n, replace=True, p=self.sample_weights)
        else:
            order = self.rng.permutation(n)

        def cap(bucket_len: int) -> int:
            return max(1, min(batch_size, self.cfg.experiment.max_squared_res // bucket_len**2))

        def stack(group: list[dict], bucket_len: int) -> dict:
            feats = [feature_lib.pad_feats(f, bucket_len) for f in group]
            return {k: np.stack([f[k] for f in feats]) for k in _BATCH_KEYS}

        pending: dict[int, list[dict]] = {}
        for idx in order:
            feats = self.example(int(idx))
            b = feature_lib.length_bucket(int(feats["res_mask"].shape[0]))
            pending.setdefault(b, []).append(feats)
            if len(pending[b]) >= cap(b):
                yield stack(pending[b][: cap(b)], b)
                pending[b] = pending[b][cap(b) :]
        for b, group in pending.items():
            for i in range(0, len(group), cap(b)):
                yield stack(group[i : i + cap(b)], b)


def train(cfg: Config, device: str | torch.device | None = None) -> SimpleNamespace:
    """Train on ``device`` (CUDA unless asked otherwise). Resumes from
    ``experiment.resume_ckpt_dir``, or from the run's own checkpoint
    directory when it holds one; with ``use_ckpt_conf`` the checkpoint's
    model and diffuser sections replace ``cfg``'s (in place). Returns the
    run's summary: steps, checkpoint directory, the training loop's wall
    seconds and the seconds of them spent waiting for the input pipeline.
    In a process group (:func:`main` under ``torchrun``) every rank calls,
    with its own device."""
    check_emb_bwd_impl(cfg)
    dev = resolve_device(device)
    mesh = make_mesh(cfg.experiment.dp_size, cfg.experiment.fsdp_size, dev.type)
    ranks, main_rank = world_size(), rank() == 0
    if not main_rank:
        logger.setLevel(logging.WARNING)
    seed = cfg.experiment.seed
    rng = np.random.default_rng(seed)

    # A sweep job (FRAMEDIPT_JOB_NUM) gets its own run directory.
    run_name = cfg.experiment.name
    job_num = os.environ.get("FRAMEDIPT_JOB_NUM")
    if job_num is not None:
        run_name = f"{run_name}_job{job_num}" if run_name else f"job{job_num}"
    ckpt_dir = pathlib.Path(cfg.experiment.ckpt_dir) / run_name
    resume = cfg.experiment.resume_ckpt_dir or (
        str(ckpt_dir) if latest_checkpoint(ckpt_dir) else None
    )
    restored = None
    if resume and latest_checkpoint(resume):
        restored = load_checkpoint(latest_checkpoint(resume))
        if cfg.experiment.use_ckpt_conf:
            merged = merge_checkpoint_config(cfg, restored["conf"])
            cfg.model, cfg.diffuser = merged.model, merged.diffuser
            logger.info(f"use_ckpt_conf: model/diffuser config from {latest_checkpoint(resume)}")
    resolve_kernel_flags(cfg, dev)
    if dev.type == "cuda":
        set_full_precision_matmul()
        build_all()
    diffuser = SE3Diffuser(cfg.diffuser, device=dev)
    model = ScoreNetwork(cfg.model, diffuser, inpainting=cfg.experiment.inpainting)
    dataset = TrainDataset(cfg, rng)
    # The JAX package initializes its parameters on one batch of two: the
    # same draw keeps the host Generator's stream the same.
    next(iter(dataset.batches(2)))
    if restored is None:  # the JAX package's model.init: the AF2 initializer zoo
        model.load_state_dict(init_state_dict(model, torch.Generator().manual_seed(seed)),
                              strict=True)
    model.to(dev)
    wrapped = shard_params(mesh, model)
    optimizer = make_optimizer(model.parameters(), cfg.experiment.learning_rate)
    step = 0
    if restored is not None:
        load_state(model, optimizer, restored)
        step = int(restored["step"])
        logger.info(f"resumed from step {step}")
    del restored

    cfg.experiment.num_parameters = sum(p.numel() for p in model.parameters())
    logger.info(f"model parameters: {cfg.experiment.num_parameters:,}")
    if mesh is not None:
        logger.info(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))} over {ranks} processes")
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    if main_rank:
        save_config(cfg, ckpt_dir / "train_conf.json")

    train_step = build_train_step(wrapped, diffuser, cfg, optimizer, mesh)
    generator = torch.Generator(device=dev).manual_seed(seed + 1)
    mlogger = MetricsLogger(ckpt_dir) if main_rank else None
    importance = None
    if cfg.experiment.use_importance_sampling:
        importance = TimestepImportanceSampler(
            num_bins=cfg.experiment.num_bins,
            history_per_term=cfg.experiment.history_per_term,
            min_t=cfg.data.min_t,
        )
    exp = cfg.experiment
    eval_run = None  # built at the first eval step
    start_step = step
    wait_s = 0.0
    log_t0 = loop_t0 = time.perf_counter()
    try:
        for epoch in range(exp.num_epoch):
            with prefetch(dataset.batches(exp.batch_size), size=exp.prefetch_buffer) as batches:
                while True:
                    t_wait = time.perf_counter()
                    batch = next(batches, None)
                    wait_s += time.perf_counter() - t_wait
                    if batch is None:
                        break
                    # Every rank holds the whole batch and keeps its rows in the step.
                    batch = pad_batch(batch, ranks)
                    if importance is not None:
                        t_np, w_np = importance.sample(rng, batch["res_mask"].shape[0])
                        batch = {**batch, "t": t_np, "loss_weight": w_np}
                    metrics = train_step(
                        {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}, generator
                    )
                    if importance is not None:
                        importance.update(metrics["t"].cpu().numpy(),
                                          metrics["raw_per_example_loss"].cpu().numpy())
                    step += 1
                    if main_rank and (step % exp.log_freq == 0 or step == 1):
                        loss = float(metrics["loss"])
                        rate = exp.log_freq / max(time.perf_counter() - log_t0, 1e-9)
                        log_t0 = time.perf_counter()
                        strat = t_stratified_metrics(metrics["per_example_loss"], metrics["t"])
                        logger.info(f"epoch {epoch} step {step}: loss {loss:.4f} "
                                    f"({rate:.2f} steps/s) {strat}")
                        mlogger.log(step, {
                            "loss": loss, "steps_per_sec": rate,
                            "grad_norm": metrics["grad_norm"],
                            "trans_loss": metrics["trans_loss"], "rot_loss": metrics["rot_loss"],
                            **strat,
                        })
                    early = exp.early_ckpt and step == exp.early_ckpt_step
                    if step % exp.ckpt_freq == 0 or early:
                        save_checkpoint(ckpt_dir, step, model, optimizer, cfg, epoch=epoch)
                    if step % exp.eval_freq == 0:
                        if eval_run is None:
                            eval_run = build_eval_sampler(model, diffuser, cfg)
                        # Every rank samples: the generator stays in step, and
                        # an FSDP forward needs every rank.
                        evaluated = run_training_eval(
                            eval_run, diffuser, cfg, step, generator,
                            out_dir=pathlib.Path(exp.eval_dir) / run_name, write=main_rank,
                        )
                        if main_rank:
                            mlogger.log(step, evaluated)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        loop_s = time.perf_counter() - loop_t0
        save_checkpoint(ckpt_dir, step, model, optimizer, cfg)
    finally:
        if mlogger is not None:
            mlogger.close()
    return SimpleNamespace(step=step, steps_run=step - start_step, ckpt_dir=ckpt_dir,
                           loop_seconds=loop_s, input_wait_seconds=wait_s, model=model)


def main(argv: list[str] | None = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    device, json_path, overrides = None, None, []
    for arg in argv:
        if arg.startswith("--device="):
            device = arg.split("=", 1)[1]
        elif arg.startswith("--config="):
            json_path = arg.split("=", 1)[1]
        else:
            overrides.append(arg)
    cfg = load_config(overrides, json_path=json_path)
    if "WORLD_SIZE" not in os.environ:  # not started by torchrun
        train(cfg, device=device)
        return
    device = init_distributed(device=device)
    try:
        train(cfg, device=device)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
