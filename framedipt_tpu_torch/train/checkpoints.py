"""Training checkpoints in the reference layout: ``<ckpt_dir>/step_<N>/``
holding one ``torch.save`` file, ``checkpoint.pth``, of ``{model, conf,
optim, epoch, step}``: ``model`` the state_dict under the reference torch
names, ``conf`` the config as a plain dict, ``optim`` the optimizer's
state_dict (its per-parameter state keyed by the parameter's index).
``model/weights.py:load_reference_checkpoint`` reads the file, and so does
the JAX package's ``load_torch_checkpoint``.

Under torch.distributed every rank calls :func:`save_checkpoint` and
:func:`load_state`: the model's and the optimizer's whole state are gathered
(``get_model_state_dict`` / ``get_optimizer_state_dict`` with
``full_state_dict``; the FSDP shards too) and rank 0 writes them in the same
layout, so a checkpoint resumes at any world size.
"""
from __future__ import annotations

import os
import pathlib
import shutil

import torch
import torch.distributed as dist

from framedipt_tpu_torch.parallel.mesh import rank
from framedipt_tpu_torch.tools.config import Config, to_dict
from framedipt_tpu_torch.tools.log import get_logger

CKPT_FILE = "checkpoint.pth"
logger = get_logger()


def _steps(ckpt_dir: pathlib.Path) -> list[pathlib.Path]:
    return sorted(
        (p for p in ckpt_dir.glob("step_*") if (p / CKPT_FILE).exists()),
        key=lambda p: int(p.name.split("_")[1]),
    )


def _param_names(model: torch.nn.Module, optimizer: torch.optim.Optimizer) -> list[str]:
    """The optimizer's parameters' names in its order (its indices)."""
    name_of = {id(p): n for n, p in model.named_parameters()}
    return [name_of[id(p)] for group in optimizer.param_groups for p in group["params"]]


def _by_index(optim: dict, names: list[str]) -> dict:
    """An optimizer state_dict keyed by parameter name -> keyed by index."""
    index = {n: i for i, n in enumerate(names)}
    return {"state": {index[n]: v for n, v in optim["state"].items()},
            "param_groups": [{**g, "params": [index[n] for n in g["params"]]}
                             for g in optim["param_groups"]]}


def _by_name(optim: dict, names: list[str]) -> dict:
    """The inverse of :func:`_by_index`."""
    return {"state": {names[i]: v for i, v in optim["state"].items()},
            "param_groups": [{**g, "params": [names[i] for i in g["params"]]}
                             for g in optim["param_groups"]]}


def full_state(model: torch.nn.Module, optimizer: torch.optim.Optimizer) -> tuple[dict, dict]:
    """(model state_dict, optimizer state_dict), whole, on the CPU, the
    optimizer's keyed by parameter index. Under torch.distributed every rank
    must call; the state is gathered to rank 0 (other ranks get empty
    dicts)."""
    if not dist.is_initialized():
        return ({k: v.detach().cpu() for k, v in model.state_dict().items()},
                optimizer.state_dict())
    # Imported here: a process outside a process group never pays for it.
    from torch.distributed.checkpoint.state_dict import (
        StateDictOptions,
        get_model_state_dict,
        get_optimizer_state_dict,
    )

    options = StateDictOptions(full_state_dict=True, cpu_offload=True)
    model_sd = get_model_state_dict(model, options=options)
    optim_sd = get_optimizer_state_dict(model, optimizer, options=options)
    if rank() != 0:
        return {}, {}
    return model_sd, _by_index(optim_sd, _param_names(model, optimizer))


def load_state(model: torch.nn.Module, optimizer: torch.optim.Optimizer, payload: dict) -> None:
    """Load a checkpoint's whole model and optimizer state (every rank
    under torch.distributed, after ``parallel.shard_params``: FSDP takes its
    shards of it)."""
    if not dist.is_initialized():
        model.load_state_dict(payload["model"], strict=True)
        optimizer.load_state_dict(payload["optim"])
        return
    from torch.distributed.checkpoint.state_dict import (
        StateDictOptions,
        set_model_state_dict,
        set_optimizer_state_dict,
    )

    set_model_state_dict(model, payload["model"],
                         options=StateDictOptions(full_state_dict=True, strict=True))
    # A parameter no step gave a gradient (kept for the reference layout) has
    # no optimizer state, in a one-process checkpoint too.
    set_optimizer_state_dict(model, optimizer,
                             _by_name(payload["optim"], _param_names(model, optimizer)),
                             options=StateDictOptions(full_state_dict=True, strict=False))


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
    is (the final save after a run whose last step was a checkpoint step).
    Under torch.distributed every rank calls (the state is gathered) and rank
    0 writes; the ranks leave together, so each finds what rank 0 wrote.
    Rank 0 alone looks for an earlier write and tells the others, so the
    ranks agree without a shared file system."""
    ckpt_dir = pathlib.Path(ckpt_dir).resolve()
    path = ckpt_dir / f"step_{step}"
    written = rank() == 0 and (path / CKPT_FILE).exists()
    if dist.is_initialized():
        flag = [written]
        dist.broadcast_object_list(flag, src=0)
        written = flag[0]
    if written:
        return path
    model_sd, optim_sd = full_state(model, optimizer)
    if rank() == 0:
        path.mkdir(parents=True, exist_ok=True)
        payload = {
            "model": model_sd,
            "conf": to_dict(cfg),
            "optim": optim_sd,
            "epoch": int(epoch),
            "step": int(step),
        }
        tmp = path / f"{CKPT_FILE}.tmp{os.getpid()}"
        torch.save(payload, tmp)
        os.replace(tmp, path / CKPT_FILE)
        for old in _steps(ckpt_dir)[:-keep]:
            shutil.rmtree(old, ignore_errors=True)
        logger.info(f"checkpoint saved: {path}")
    if dist.is_initialized():
        dist.barrier()
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
