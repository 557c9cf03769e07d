"""Periodic evaluation during training: unconditional backbones sampled with
the current weights at a few lengths, written as PDBs, and their structural
plausibility metrics (CA-CA bond deviation and validity, CA clashes,
secondary structure, radius of gyration) averaged, as the JAX package's
``train/eval_sampling.py`` computes them. Each length runs padded to its
bucket, ``eval_batch_size`` samples at a time, through the port's reverse
sampler with no trajectories kept.
"""
from __future__ import annotations

import functools
import pathlib
from typing import Callable

import numpy as np
import torch

from framedipt_tpu_torch.analysis import dssp as dssp_lib
from framedipt_tpu_torch.analysis import metrics as an_metrics
from framedipt_tpu_torch.analysis.utils import write_prot_to_pdb
from framedipt_tpu_torch.data.features import length_bucket
from framedipt_tpu_torch.diffusion.se3_diffuser import SE3Diffuser
from framedipt_tpu_torch.sampling import sample
from framedipt_tpu_torch.tools.config import Config
from framedipt_tpu_torch.tools.log import get_logger

logger = get_logger()


def eval_lengths(cfg: Config) -> list[int]:
    """``num_eval_lengths`` lengths evenly spaced over the training length
    filter's range."""
    lo = int(cfg.data.filtering.min_len)
    hi = int(min(cfg.data.filtering.max_len, cfg.data.filtering.chain_max_len))
    return sorted({int(x) for x in np.linspace(lo, hi, int(cfg.data.num_eval_lengths)).round()})


def build_eval_sampler(model: torch.nn.Module, diffuser: SE3Diffuser, cfg: Config) -> Callable:
    """``run(feats, generator) -> sampler output`` for periodic eval. An
    inpainting model embeds aatype, so its eval features carry an all-UNK
    aatype (:func:`unconditional_feats`) and the sampler keeps it."""
    return functools.partial(
        sample, model, diffuser, num_t=cfg.data.num_t, min_t=cfg.data.min_t,
        inpainting=cfg.experiment.inpainting,
    )


def unconditional_feats(
    diffuser: SE3Diffuser, generator: torch.Generator, length: int, batch: int, inpainting: bool
) -> dict[str, torch.Tensor]:
    """Stationary-init features for ``batch`` samples of ``length`` residues,
    padded to the length bucket (res_mask 0 beyond ``length``), on the
    diffuser's device."""
    padded = length_bucket(length)
    dev = diffuser.device
    rigids = torch.stack([
        diffuser.sample_ref(generator, n_samples=padded).to_tensor7() for _ in range(batch)
    ]).to(torch.float32)
    res_mask = torch.zeros((batch, padded), dtype=torch.float32, device=dev)
    res_mask[:, :length] = 1.0
    feats = {
        "rigids_t": rigids,
        "res_mask": res_mask,
        "fixed_mask": torch.zeros((batch, padded), dtype=torch.float32, device=dev),
        "seq_idx": torch.arange(padded, device=dev)[None].repeat(batch, 1),
        "sc_ca_t": torch.zeros((batch, padded, 3), dtype=torch.float32, device=dev),
        "torsion_angles_sin_cos": torch.zeros((batch, padded, 7, 2), dtype=torch.float32,
                                              device=dev),
    }
    if inpainting:
        # Everything is diffused: every residue is UNK (20).
        feats["aatype"] = torch.full((batch, padded), 20, dtype=torch.int64, device=dev)
    return feats


def run_training_eval(
    run: Callable,
    diffuser: SE3Diffuser,
    cfg: Config,
    step: int,
    generator: torch.Generator,
    out_dir: str | pathlib.Path | None = None,
    write: bool = True,
) -> dict[str, float]:
    """Sample ``samples_per_eval_length`` backbones at each eval length,
    write them under ``<out_dir>/step_<step>/length_<L>/`` (``out_dir``
    defaults to ``experiment.eval_dir``; the train loop passes
    ``eval_dir/<run name>``) and return the metrics averaged over all
    samples, each key prefixed ``eval_``. ``write=False`` samples and
    measures without writing (the ranks other than 0 of a distributed run,
    which sample too: an FSDP forward gathers every rank's parameters)."""
    out_root = pathlib.Path(out_dir if out_dir is not None else cfg.experiment.eval_dir)
    out_root = out_root / f"step_{step}"
    total = int(cfg.data.samples_per_eval_length)
    chunk = max(1, min(total, int(cfg.experiment.eval_batch_size)))
    rows: list[dict[str, float]] = []
    for length in eval_lengths(cfg):
        samples: list[np.ndarray] = []
        while len(samples) < total:
            feats = unconditional_feats(diffuser, generator, length, chunk,
                                        cfg.experiment.inpainting)
            out = run(feats, generator)
            # prot_traj starts at t = 0: index 0 is the final sample.
            atom37 = out["prot_traj"][0].float().cpu().numpy()[:, :length]
            samples.extend(atom37[: total - len(samples)])
        length_dir = out_root / f"length_{length}"
        if write:
            length_dir.mkdir(parents=True, exist_ok=True)
        for i, pos in enumerate(samples):
            mask37 = np.any(pos != 0.0, axis=-1)
            if write:
                write_prot_to_pdb(pos, length_dir / f"sample_{i}", no_indexing=False)
            ca = pos[:, 1]
            dev, valid = an_metrics.ca_ca_distance(ca)
            _, clash_frac = an_metrics.ca_ca_clashes(ca)
            rows.append({
                "ca_ca_deviation": dev,
                "ca_ca_valid_percent": valid,
                "ca_clash_percent": clash_frac,
                **dssp_lib.ss_metrics_from_atom37(pos, mask37),
            })
    agg = {f"eval_{k}": float(np.mean([r[k] for r in rows])) for k in rows[0]}
    if write:
        logger.info(f"eval step {step}: {agg}")
    return agg
