"""ProteinMPNN training CLI over the preprocessed dataset.

    python -m framedipt_tpu_torch.experiments.train_mpnn \\
        --csv_path=processed/metadata.csv --output_dir=./mpnn_run \\
        [--num_steps=1000] [--batch_size=8] [--max_length=512] [--ca_only] [--device=cpu]

Trains the port's ProteinMPNN (``model/mpnn.py``, ``train/mpnn_train.py``) on
the structures that ``data/pipeline.py`` preprocessed (``metadata.csv`` and
its pickles): each structure becomes the model's multichain inputs, cropped
at random to ``--max_length``, padded into power-of-two length buckets from
64, ``--batch_size`` rows of one bucket a batch (a partial batch padded with
rows whose mask is 0). A share ``--holdout_frac`` of the structures is held
out and evaluated (no noise, no dropout) every ``--eval_freq`` steps.
``metrics.jsonl`` gets a row every ``--log_freq`` steps and one for each
evaluation; ``step_<N>.npz`` is written every ``--ckpt_freq`` steps and at
the end, then ``last.npz``: the reference state_dict names and ``num_edges``,
which ``tools/mpnn_design.load_mpnn_params`` reads.
``--previous_checkpoint`` starts from a checkpoint's weights (a fresh
optimizer) and refuses one whose config differs from the flags'. The split,
the crops and the order of the batches come from numpy's generator seeded
with ``--seed``; the model's initialization from ``--seed``, the step's
draws from ``--seed`` + 1. Runs on CUDA unless ``--device`` asks for another
device.
"""
from __future__ import annotations

import argparse
import csv
import json
import pathlib
import pickle
import time

import numpy as np
import torch

from framedipt_tpu_torch.data import constants as rc
from framedipt_tpu_torch.model import mpnn
from framedipt_tpu_torch.tools.device import (
    resolve_device,
    seeded_generator,
    set_full_precision_matmul,
)
from framedipt_tpu_torch.tools.log import get_logger
from framedipt_tpu_torch.train.mpnn_train import MPNNTrainer

logger = get_logger()

_BB37 = [rc.atom_order[a] for a in ("N", "CA", "C", "O")]


def structure_to_mpnn_features(raw: dict, ca_only: bool = False) -> dict[str, np.ndarray]:
    """A preprocessed pickle's features -> the model's inputs (batch of one):
    one chain a ``chain_index`` value, a residue whose backbone is missing
    (bb_mask 0) given NaN coordinates, which ``featurize_chains`` masks."""
    chains = []
    for cid in np.unique(raw["chain_index"]):
        m = raw["chain_index"] == cid
        seq = rc.aatype_to_sequence(raw["aatype"][m])
        xyz = raw["atom_positions"][m][:, _BB37].astype(np.float64)
        xyz[raw["bb_mask"][m] < 0.5] = np.nan
        chains.append((seq, xyz))
    feats = mpnn.featurize_chains(chains)
    if ca_only:
        feats["X"] = feats["X"][:, :, 1]
    return feats


def _pad_to(feats: dict, length: int) -> dict:
    out = {}
    for k, v in feats.items():
        widths = [(0, 0), (0, length - v.shape[1])] + [(0, 0)] * (v.ndim - 2)
        out[k] = np.pad(v, widths)
    return out


class MPNNDataset:
    """``metadata.csv`` and its pickles -> batches of one length bucket."""

    def __init__(self, csv_path: str | pathlib.Path, max_length: int, min_length: int,
                 ca_only: bool, holdout_frac: float, seed: int) -> None:
        with open(csv_path, newline="", encoding="utf-8") as f:
            rows = [r for r in csv.DictReader(f) if int(r["modeled_seq_len"]) >= min_length]
        self.paths = [r["processed_path"] for r in rows]
        self.max_length = max_length
        self.ca_only = ca_only
        rng = np.random.default_rng(seed)
        order = rng.permutation(len(self.paths))
        n_hold = max(1, int(holdout_frac * len(order))) if len(order) > 1 else 0
        self.valid_idx = list(order[:n_hold])
        self.train_idx = list(order[n_hold:]) or list(order)
        self.rng = rng
        self._cache: dict[int, dict] = {}
        logger.info(f"MPNN dataset: {len(self.train_idx)} train / "
                    f"{len(self.valid_idx)} valid structures")

    def _features(self, idx: int) -> dict:
        """A structure's inputs, cropped once (a random contiguous window
        of ``max_length`` residues) and kept."""
        if idx not in self._cache:
            with open(self.paths[idx], "rb") as f:
                raw = pickle.load(f)
            feats = structure_to_mpnn_features(raw, self.ca_only)
            length = feats["X"].shape[1]
            if length > self.max_length:
                start = int(self.rng.integers(0, length - self.max_length + 1))
                feats = {k: v[:, start:start + self.max_length] for k, v in feats.items()}
            self._cache[idx] = feats
        return self._cache[idx]

    @staticmethod
    def _bucket(length: int) -> int:
        b = 64
        while b < length:
            b *= 2
        return b

    def batches(self, idxs: list[int], batch_size: int, shuffle: bool = True):
        """Batches of ``batch_size`` structures of one bucket, in the
        (shuffled) order of ``idxs``; then each bucket's partial group,
        padded with rows whose every array is 0."""
        order = list(idxs)
        if shuffle:
            self.rng.shuffle(order)
        groups: dict[int, list[int]] = {}
        for i in order:
            b = self._bucket(self._features(i)["X"].shape[1])
            groups.setdefault(b, []).append(i)
            if len(groups[b]) == batch_size:
                yield self._stack(groups.pop(b), b)
        for b, group in groups.items():
            yield self._stack(group, b, batch_size)

    def _stack(self, group: list[int], bucket: int, batch_size: int | None = None) -> dict:
        rows = [_pad_to(self._features(i), bucket) for i in group]
        batch = {k: np.concatenate([r[k] for r in rows], axis=0) for k in rows[0]}
        if batch_size and len(group) < batch_size:
            pad = batch_size - len(group)
            for k, v in batch.items():
                batch[k] = np.concatenate([v, np.zeros((pad,) + v.shape[1:], v.dtype)], axis=0)
        return batch


def save_npz_checkpoint(path: pathlib.Path, model: mpnn.ProteinMPNN) -> None:
    """The model's state_dict (float32, the reference names) and
    ``num_edges`` in an ``.npz``."""
    sd = {k: v.detach().cpu().numpy().astype(np.float32) for k, v in model.state_dict().items()}
    np.savez(path, num_edges=np.int64(model.cfg.k_neighbors), **sd)


def _warm_start(model: mpnn.ProteinMPNN, path: str) -> None:
    """Load ``path``'s weights into ``model``; raise ValueError where the
    checkpoint's config (hidden width, layer counts, CA-only, neighbours)
    differs from the model's."""
    from framedipt_tpu_torch.tools.mpnn_design import load_mpnn_params

    loaded = load_mpnn_params(path, device="cpu")
    fields = ("hidden_dim", "num_encoder_layers", "num_decoder_layers", "ca_only", "k_neighbors")
    differ = {f: (getattr(loaded.cfg, f), getattr(model.cfg, f)) for f in fields
              if getattr(loaded.cfg, f) != getattr(model.cfg, f)}
    if differ:
        raise ValueError(f"--previous_checkpoint {path}: its config differs from the flags' "
                         f"(checkpoint, flags): {differ}")
    model.load_state_dict(loaded.state_dict(), strict=True)
    logger.info(f"warm-started from {path}")


def _to_device(batch: dict, device: torch.device) -> dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def train(args: argparse.Namespace) -> dict:
    """The training run; returns the last logged train row's metrics."""
    device = resolve_device(args.device)
    set_full_precision_matmul()
    out = pathlib.Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    cfg = mpnn.MPNNConfig(
        hidden_dim=args.hidden_dim, num_encoder_layers=args.num_layers,
        num_decoder_layers=args.num_layers, k_neighbors=args.k_neighbors,
        ca_only=args.ca_only, augment_eps=args.backbone_noise, dropout=args.dropout,
    )
    data = MPNNDataset(args.csv_path, args.max_length, args.min_length, args.ca_only,
                       args.holdout_frac, args.seed)
    model = mpnn.ProteinMPNN(cfg)
    model.load_state_dict(mpnn.init_mpnn_state_dict(cfg, args.seed), strict=True)
    if args.previous_checkpoint:
        _warm_start(model, args.previous_checkpoint)
    model.to(device)
    trainer = MPNNTrainer(model, gradient_norm=args.gradient_norm)
    generator = seeded_generator(device, args.seed + 1)

    step = 0
    t0 = time.time()
    last = {}
    with open(out / "metrics.jsonl", "a") as mf:
        while step < args.num_steps:
            for batch in data.batches(data.train_idx, args.batch_size):
                metrics = trainer.step(_to_device(batch, device), generator)
                step += 1
                if step % args.log_freq == 0 or step == args.num_steps:
                    last = {k: float(v) for k, v in metrics.items()}
                    row = {"step": step, "sec": round(time.time() - t0, 1), **last}
                    mf.write(json.dumps(row) + "\n")
                    mf.flush()
                    logger.info(f"step {step}: loss {last['loss']:.4f} nll {last['nll']:.3f} "
                                f"acc {last['accuracy']:.3f}")
                if args.eval_freq and step % args.eval_freq == 0 and data.valid_idx:
                    ev = _evaluate(data, trainer, args, device)
                    mf.write(json.dumps({"step": step, **ev}) + "\n")
                    mf.flush()
                    logger.info(f"eval @ {step}: nll {ev['eval_nll']:.3f} "
                                f"recovery {ev['eval_accuracy']:.3f}")
                if step % args.ckpt_freq == 0 or step == args.num_steps:
                    save_npz_checkpoint(out / f"step_{step}.npz", model)
                if step >= args.num_steps:
                    break
    save_npz_checkpoint(out / "last.npz", model)
    logger.info(f"done: {step} steps, checkpoints under {out}")
    return last


def _evaluate(data: MPNNDataset, trainer: MPNNTrainer, args: argparse.Namespace,
              device: torch.device) -> dict[str, float]:
    """The held-out structures' mean NLL and recovery over their batches,
    the decoding orders drawn from a generator seeded with ``--seed`` + 1
    anew for every evaluation."""
    generator = seeded_generator(device, args.seed + 1)
    nlls, accs = [], []
    for batch in data.batches(data.valid_idx, args.batch_size, shuffle=False):
        m = trainer.eval_step(_to_device(batch, device), generator)
        nlls.append(float(m["nll"]))
        accs.append(float(m["accuracy"]))
    return {"eval_nll": float(np.mean(nlls)), "eval_accuracy": float(np.mean(accs))}


def main(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--csv_path", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--num_steps", type=int, default=1000)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--max_length", type=int, default=512)
    p.add_argument("--min_length", type=int, default=10)
    p.add_argument("--hidden_dim", type=int, default=128)
    p.add_argument("--num_layers", type=int, default=3)
    p.add_argument("--k_neighbors", type=int, default=48)
    p.add_argument("--backbone_noise", type=float, default=0.2,
                   help="Backbone noise std in training; 0 trains without noise")
    p.add_argument("--dropout", type=float, default=0.1, help="Dropout; 0 turns it off")
    p.add_argument("--gradient_norm", type=float, default=-1.0,
                   help="Clip the gradients to this global norm; <= 0 clips nothing")
    p.add_argument("--previous_checkpoint", type=str, default="",
                   help="Warm start from this .npz or .pt (its config must equal the flags')")
    p.add_argument("--ca_only", action="store_true")
    p.add_argument("--holdout_frac", type=float, default=0.1)
    p.add_argument("--log_freq", type=int, default=10)
    p.add_argument("--eval_freq", type=int, default=100)
    p.add_argument("--ckpt_freq", type=int, default=500)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default=None,
                   help="Device to run on (default cuda; cpu runs on the CPU)")
    return train(p.parse_args(argv))


if __name__ == "__main__":
    main()
