"""Kernel B of the float32 split backwards (``csrc/wgrad_wg.cuh``) alone:
a wrapper of its C entry and its plain version.

Both float32 split backwards (the pair MLP's, :func:`.pair_mlp.pair_mlp_bwd`,
and the edge embedder's, :func:`.edge_embedder.edge_embedder_bwd`) compute
their weight gradients G = A^T Bm over a chunk's pairs with this kernel,
launched from their own C entries. :func:`wgrad_f32` runs it alone on two
[P, .] arrays, for the tests and ``chip_smoke.py``; the model never calls
it. ``tests/test_torch_wgrad_wg.py`` mirrors the kernel's slice plan and
shared-memory layout.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from framedipt_tpu_torch.model.kernels.build import library

F32 = torch.float32
MAX_JOBS = 16  # 128 x 128 output tiles of one launch (kWgradMaxJobs)


def wgrad_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a^T b in float32 ([P, M], [P, N] -> [M, N])."""
    return torch.matmul(a.to(F32).t(), b.to(F32))


@functools.cache
def _kernel():
    """The C entry ``fdk_wgrad_f32`` of csrc/pair_mlp_bwd_wg.cu, built and
    bound at first use."""
    fn = library("pair_mlp_bwd_wg").fdk_wgrad_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    return fn


def wgrad_f32(a: torch.Tensor, b: torch.Tensor, slices: int = 8) -> torch.Tensor:
    """G = a^T b ([P, M] and [P, N] float32 -> [M, N]) by float32 kernel B
    alone, over ``slices`` K slices summed in slice order: M = 64 or a
    multiple of 128, N a multiple of 128, at most 16 tiles of 128 x 128.
    CPU tensors take :func:`wgrad_plain`; CUDA tensors launch the kernel or
    raise. Adds one to ``wgrad_f32.launches`` a launch."""
    if a.device.type == "cpu":
        return wgrad_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"wgrad_f32: unsupported device {a.device}")
    if a.dtype != F32 or b.dtype != F32 or a.dim() != 2 or b.dim() != 2:
        raise ValueError("wgrad_f32: a and b are 2-D float32")
    if b.device != a.device or a.shape[0] != b.shape[0] or a.shape[0] < 1:
        raise ValueError("wgrad_f32: a and b need the same rows, on one device")
    (P, M), N = a.shape, b.shape[1]
    tiles = (1 if M == 64 else M // 128) * (N // 128)
    if (M != 64 and M % 128) or M < 64 or N % 128 or N < 128 or tiles > MAX_JOBS:
        raise ValueError(f"wgrad_f32: unsupported widths M={M} N={N}")
    if slices < 1:
        raise ValueError("wgrad_f32: slices >= 1")
    a, b = a.contiguous(), b.contiguous()
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("wgrad_f32: a and b must be 16-byte aligned")
    wpart = torch.empty(slices * M * N, dtype=F32, device=a.device)
    out = torch.empty(M, N, dtype=F32, device=a.device)
    with torch.cuda.device(a.device):
        err = _kernel()(a.data_ptr(), M, b.data_ptr(), N, P, slices, wpart.data_ptr(),
                        out.data_ptr(), torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wgrad_f32 kernel launch failed: cudaError_t {err}")
    wgrad_f32.launches += 1
    return out


wgrad_f32.launches = 0
