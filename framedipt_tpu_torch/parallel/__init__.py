"""Multi-GPU parallelism: process groups, meshes, data/FSDP training and
sequence-parallel sampling."""

from framedipt_tpu_torch.parallel import sp
from framedipt_tpu_torch.parallel.mesh import (
    init_distributed,
    make_mesh,
    shard_batch,
    shard_params,
)
from framedipt_tpu_torch.parallel.sp import make_sp_mesh

__all__ = [
    "init_distributed",
    "make_mesh",
    "shard_batch",
    "shard_params",
    "make_sp_mesh",
    "sp",
]
