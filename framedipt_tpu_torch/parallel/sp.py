"""Sequence parallelism for inference: the N^2 edge stack split by rows.

The port of the JAX package's ``parallel/sp.py``. A ``(dp, sp)`` mesh puts
samples over ``dp`` and the rows of every [B, N, N, C] edge tensor over
``sp``: each rank holds the [B, ceil(N/sp), N, C] row block of its own rows
against every column, and launches the edge-embedder and pair-MLP kernels on
it (rows local, columns full). Every node-level tensor ([B, N, ...]) is
computed whole on every rank, from the same inputs by the same operations,
so the ranks agree to the bit. The one collective is :func:`gather_rows` of
each IPA block's output, four a forward at the default depth.

Where the JAX package annotates tensors for GSPMD (``constrain_edge``,
``constrain_rows``, ``constrain_attn``, ``constrain_replicated``) and lets
XLA partition, this module gives explicit helpers:

- :func:`row_range`: this rank's rows of N, ``ceil(N/sp)`` of them, the last
  rank's running past N when sp does not divide N. It stands for the row
  split of ``constrain_edge``.
- :func:`local_rows`: this rank's row block of a [B, N, ...] tensor
  (:func:`row_range`; :func:`row_block` names a block by its index),
  padded with zero rows to ``ceil(N/sp)``; a padded row's mask is 0, so
  the kernels write 0 there. It stands for
  ``constrain_rows`` and ``constrain_attn`` (the attention's query rows).
- :func:`gather_rows`: the row blocks of every rank along dim 1, all-gathered
  over ``sp``, padded rows dropped. It stands for ``constrain_replicated``.

Outside an active :func:`sp_context` each helper is the identity. The
context is thread-local and inference only: a helper raises while autograd
records. Divergence: the JAX package falls back to its XLA formulation when
sp does not divide N; the port has no plain path on the card, so it runs the
kernels on padded row blocks for every N.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import TYPE_CHECKING, Iterator

import torch
import torch.distributed as dist

from framedipt_tpu_torch.parallel.mesh import DP_AXIS, all_gather_rows, world_size

if TYPE_CHECKING:
    from torch.distributed.device_mesh import DeviceMesh

SP_AXIS = "sp"

_state = threading.local()


def make_sp_mesh(sp_size: int, dp_size: int = 1, device_type: str = "cuda") -> DeviceMesh | None:
    """A ``(dp, sp)`` mesh over every process: samples over ``dp``, edge
    rows over ``sp``. dp x sp must equal the world size; a process outside a
    process group runs alone (dp x sp 1 gives None)."""
    world = world_size()
    if dp_size * sp_size != world:
        raise ValueError(f"dp({dp_size}) * sp({sp_size}) != world size ({world})")
    if not dist.is_initialized():
        return None
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (dp_size, sp_size), mesh_dim_names=(DP_AXIS, SP_AXIS))


@contextlib.contextmanager
def sp_context(mesh: DeviceMesh | None) -> Iterator[None]:
    """Split the edge stack's rows over ``mesh``'s ``sp`` axis for model code
    run inside (None: no split)."""
    prev = getattr(_state, "mesh", None)
    _state.mesh = mesh
    try:
        yield
    finally:
        _state.mesh = prev


def active() -> DeviceMesh | None:
    """The active ``(dp, sp)`` mesh, or None."""
    return getattr(_state, "mesh", None)


def _split() -> tuple[int, int] | None:
    """(this rank's index on ``sp``, the size of ``sp``), or None outside a
    context. Raises where autograd records."""
    mesh = active()
    if mesh is None:
        return None
    if torch.is_grad_enabled():
        raise RuntimeError("sequence parallelism is inference only: run under torch.no_grad()")
    return mesh.get_local_rank(SP_AXIS), mesh.size(mesh.mesh_dim_names.index(SP_AXIS))


def _bounds(n: int, index: int, size: int) -> tuple[int, int]:
    """(start, stop) of block ``index`` of ``size`` over ``n`` rows."""
    rows = math.ceil(n / size)
    return index * rows, (index + 1) * rows


def row_range(n: int) -> tuple[int, int]:
    """(start, stop) of this rank's rows of ``n``: ``ceil(n / sp)`` rows, stop
    possibly past ``n``; (0, n) outside a context."""
    split = _split()
    return (0, n) if split is None else _bounds(n, *split)


def _rows(x: torch.Tensor, start: int, stop: int) -> torch.Tensor:
    """Rows start:stop of ``x`` [B, N, ...] along dim 1, zero rows past N."""
    n = x.shape[1]
    block = x[:, start:min(stop, n)]
    if stop > n:
        pad = x.new_zeros((x.shape[0], stop - max(start, n)) + tuple(x.shape[2:]))
        block = torch.cat([block, pad], dim=1)
    return block.contiguous()


def row_block(x: torch.Tensor, index: int, size: int) -> torch.Tensor:
    """Block ``index`` of ``size`` of ``x`` [B, N, ...] along dim 1:
    ``ceil(N / size)`` rows, zero rows past N."""
    return _rows(x, *_bounds(x.shape[1], index, size))


def local_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of ``x`` [B, N, ...] along dim 1 (:func:`row_range`,
    zero rows past N); ``x`` itself outside a context or at sp 1."""
    split = _split()
    if split is None or split[1] == 1:
        return x
    return _rows(x, *row_range(x.shape[1]))


def gather_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """Every rank's row block ``x`` [B, ceil(n/sp), ...] along dim 1 in rank
    order, cut to ``n`` rows; ``x`` itself outside a context."""
    if _split() is None:
        return x
    rows = all_gather_rows(x.movedim(1, 0), active().get_group(SP_AXIS))
    return rows[:n].movedim(0, 1).contiguous()
