"""Training checkpoints in the reference layout: ``<ckpt_dir>/step_<N>/``
holding one ``torch.save`` file, ``checkpoint.pth``, of ``{model, conf,
optim, epoch, step}``: ``model`` the state_dict under the reference torch
names, ``conf`` the config as a plain dict, ``optim`` the optimizer's
state_dict. ``model/weights.py:load_reference_checkpoint`` reads the file,
and so does the JAX package's ``load_torch_checkpoint``.
"""
from __future__ import annotations

import os
import pathlib
import shutil

import torch

from framedipt_tpu_torch.tools.config import Config, to_dict
from framedipt_tpu_torch.tools.log import get_logger

CKPT_FILE = "checkpoint.pth"
logger = get_logger()


def _steps(ckpt_dir: pathlib.Path) -> list[pathlib.Path]:
    return sorted(
        (p for p in ckpt_dir.glob("step_*") if (p / CKPT_FILE).exists()),
        key=lambda p: int(p.name.split("_")[1]),
    )


def save_checkpoint(
    ckpt_dir: str | pathlib.Path,
    step: int,
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    cfg: Config,
    epoch: int = 0,
    keep: int = 1,
) -> pathlib.Path:
    """Write ``step_<step>/checkpoint.pth`` under ckpt_dir and prune older
    checkpoints to ``keep``. A step that is already written is left as it
    is (the final save after a run whose last step was a checkpoint step)."""
    ckpt_dir = pathlib.Path(ckpt_dir).resolve()
    path = ckpt_dir / f"step_{step}"
    if (path / CKPT_FILE).exists():
        return path
    path.mkdir(parents=True, exist_ok=True)
    payload = {
        "model": {k: v.detach().cpu() for k, v in model.state_dict().items()},
        "conf": to_dict(cfg),
        "optim": optimizer.state_dict(),
        "epoch": int(epoch),
        "step": int(step),
    }
    tmp = path / f"{CKPT_FILE}.tmp{os.getpid()}"
    torch.save(payload, tmp)
    os.replace(tmp, path / CKPT_FILE)
    for old in _steps(ckpt_dir)[:-keep]:
        shutil.rmtree(old, ignore_errors=True)
    logger.info(f"checkpoint saved: {path}")
    return path


def latest_checkpoint(ckpt_dir: str | pathlib.Path) -> pathlib.Path | None:
    """The newest ``step_<N>`` directory under ckpt_dir, or None."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def load_checkpoint(step_dir: str | pathlib.Path) -> dict:
    """The payload of a ``step_<N>`` directory, on the CPU. The file is a
    pickle: load only trusted checkpoints."""
    return torch.load(pathlib.Path(step_dir) / CKPT_FILE, map_location="cpu", weights_only=False)
