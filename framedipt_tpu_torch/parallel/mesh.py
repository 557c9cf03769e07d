"""Process groups and device meshes for data-parallel and FSDP training.

The port of the JAX package's ``parallel/mesh.py`` with torch.distributed.
The port runs one process per GPU (``torchrun``): a ``(dp, fsdp)``
``DeviceMesh`` spans every process, the batch is split over its ranks
(:func:`shard_batch`), and the model is wrapped by :func:`shard_params`:
``DistributedDataParallel`` when ``fsdp`` is 1 (the JAX package replicates
there), else FSDP2's ``fully_shard`` on the 2-D mesh, which replicates over
``dp`` and shards over ``fsdp`` (HSDP). PyTorch has no GSPMD, so each
collective that XLA inserted is explicit: DDP's and FSDP's gradient
reductions, the gradient norm's all-reduce (``train/loop.py``) and the
metrics' all-gather.

Divergences from the JAX package:

- One process per GPU. A single JAX process may run on the leading slice of
  its devices; here dp x fsdp must equal the world size, except that a
  process started without ``torchrun`` runs alone when dp x fsdp is 1.
- Every rank of the mesh takes its own rows of the batch, the FSDP ranks
  too (FSDP is data parallel), so batches are padded to a multiple of
  dp x fsdp; the JAX package splits over dp and pads to dp.
- FSDP2 shards dim 0 of each parameter, where the JAX package shards its
  largest divisible axis. Either computes the same step.
- ``torchrun``'s environment (``env://``) in place of
  ``jax.distributed.initialize``.

The JAX package's ``batch_sharding`` and ``replicated_sharding`` name
``NamedSharding`` layouts; torch has no counterpart, so they have none here.
"""
from __future__ import annotations

import datetime
import os
from typing import TYPE_CHECKING, Any

import numpy as np
import torch
import torch.distributed as dist

from framedipt_tpu_torch.tools.device import resolve_device

if TYPE_CHECKING:
    from torch.distributed.device_mesh import DeviceMesh

DP_AXIS = "dp"
FSDP_AXIS = "fsdp"


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    initialization_timeout: int | None = None,
    device: str | torch.device | None = None,
    backend: str | None = None,
) -> torch.device:
    """Join the process group and return this rank's device (CUDA unless
    ``device`` asks for the CPU).

    With no address, size or rank, reads ``torchrun``'s environment
    (``env://``). Otherwise ``coordinator_address`` is ``host:port`` (TCP)
    or a URL (``tcp://``, ``file://``), with ``num_processes`` and
    ``process_id``. The backend is NCCL on CUDA and gloo on the CPU unless
    ``backend`` names one (gloo for several ranks on one GPU, which NCCL
    refuses). A CUDA rank takes ``cuda:{LOCAL_RANK % device count}``."""
    dev = resolve_device(device)
    kwargs: dict[str, Any] = {
        "backend": backend or ("nccl" if dev.type == "cuda" else "gloo"),
    }
    if initialization_timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=initialization_timeout)
    if coordinator_address is None and num_processes is None and process_id is None:
        kwargs["init_method"] = "env://"
    else:
        url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
        kwargs.update(init_method=url, world_size=num_processes, rank=process_id)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", process_id or 0))
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(**kwargs)
    return dev


def world_size() -> int:
    """The number of processes, 1 outside a process group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank, 0 outside a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def make_mesh(dp_size: int = -1, fsdp_size: int = 1, device_type: str = "cuda") -> DeviceMesh | None:
    """A ``(dp, fsdp)`` mesh over every process; dp_size -1 takes
    world_size // fsdp_size. dp x fsdp must equal the world size. A process
    outside a process group runs alone: dp x fsdp 1 gives None (no mesh),
    anything larger raises, naming ``torchrun``."""
    world = world_size()
    hint = "" if dist.is_initialized() else (
        "; this process runs alone: start one process per GPU with "
        "torchrun --nproc_per_node=<dp x fsdp>")
    if dp_size == -1:
        if world % fsdp_size:
            raise ValueError(f"{world} processes not divisible by fsdp={fsdp_size}{hint}")
        dp_size = world // fsdp_size
    if dp_size * fsdp_size != world:
        raise ValueError(f"dp({dp_size}) * fsdp({fsdp_size}) != world size ({world}){hint}")
    if not dist.is_initialized():
        return None
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (dp_size, fsdp_size), mesh_dim_names=(DP_AXIS, FSDP_AXIS))


def data_ranks(mesh: DeviceMesh | None) -> tuple[int, int]:
    """(this rank's block, the number of blocks) of the batch: every rank of
    the mesh takes its own rows, dp-major. (0, 1) without a mesh."""
    if mesh is None:
        return 0, 1
    dp, fsdp = mesh.get_coordinate()
    return dp * mesh.size(1) + fsdp, mesh.size()


def shard_batch(mesh: DeviceMesh | None, batch: Any) -> Any:
    """This rank's block of a global batch (a tensor, an array or a dict of
    them) along dim 0; the batch size must divide by the mesh's size. The
    batch itself without a mesh."""
    index, blocks = data_ranks(mesh)
    if blocks == 1:
        return batch
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v) for k, v in batch.items()}
    size = batch.shape[0]
    if size % blocks:
        raise ValueError(f"batch of {size} does not split over {blocks} ranks")
    rows = size // blocks
    return batch[index * rows:(index + 1) * rows]


def pad_batch(batch: dict[str, np.ndarray], multiple: int) -> dict[str, np.ndarray]:
    """A host batch padded along dim 0 to a multiple of ``multiple`` by
    repeating its examples in order (cycling when it holds fewer than the
    padding needs), as the JAX training CLI pads to dp."""
    size = next(iter(batch.values())).shape[0]
    if size % multiple == 0:
        return batch
    pad = np.resize(np.arange(size), multiple - size % multiple)
    return {k: np.concatenate([v, v[pad]]) for k, v in batch.items()}


def shard_params(mesh: DeviceMesh | None, model: torch.nn.Module) -> torch.nn.Module:
    """The module a train step calls: ``model`` itself without a mesh;
    ``DistributedDataParallel`` over every rank when fsdp is 1; else
    ``model`` after ``fully_shard`` on the 2-D mesh (replicated over dp,
    dim 0 of each parameter sharded over fsdp). Build the optimizer after
    this call: FSDP replaces the parameters with sharded ones."""
    if mesh is None:
        return model
    if mesh[FSDP_AXIS].size() == 1:
        dev = next(model.parameters()).device
        # Unused parameters (kept for the reference checkpoint layout) get no
        # gradient; DDP must be told or it waits for them.
        return torch.nn.parallel.DistributedDataParallel(
            model, device_ids=[dev] if dev.type == "cuda" else None,
            find_unused_parameters=True,
        )
    from torch.distributed.fsdp import fully_shard

    return fully_shard(model, mesh=mesh)


def all_gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0 in rank order."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=0)
