"""Kernel B of the split backwards alone, in both dtypes: wrappers of its
C entries and its plain version.

Both split backwards (the pair MLP's, :func:`.pair_mlp.pair_mlp_bwd`, and
the edge embedder's, :func:`.edge_embedder.edge_embedder_bwd`) compute their
weight gradients G = A^T Bm over a chunk's pairs with kernel B, launched
from their own C entries: in float32 ``csrc/wgrad_wg.cuh``'s kernel, in
bf16 ``csrc/wgrad_bf16.cuh``'s. :func:`wgrad_f32` and :func:`wgrad_bf16` run
each alone on two [P, .] arrays, for the tests and ``chip_smoke.py``; the
model never calls them. ``tests/test_torch_wgrad_wg.py`` and
``tests/test_torch_wgrad_bf16.py`` mirror the kernels' slice plans and
shared-memory layouts.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from framedipt_tpu_torch.model.kernels.build import library

F32, BF16 = torch.float32, torch.bfloat16
MAX_JOBS = 16  # 128 x 128 output tiles of one launch (kWgradMaxJobs)


def wgrad_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a^T b in float32 ([P, M], [P, N] -> [M, N])."""
    return torch.matmul(a.to(F32).t(), b.to(F32))


def _bind(lib: str, entry: str):
    """C entry ``entry`` of kernel library ``lib`` (a, M, b, N, P, slices,
    wpart, out, stream -> cudaError_t), built and bound."""
    fn = getattr(library(lib), entry)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    return fn


@functools.cache
def _kernel():
    """The C entry ``fdk_wgrad_f32`` of csrc/pair_mlp_bwd_wg.cu, bound at
    first use."""
    return _bind("pair_mlp_bwd_wg", "fdk_wgrad_f32")


def _check(name: str, a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype,
           slices: int) -> tuple[torch.Tensor, torch.Tensor, int, int, int]:
    """a and b contiguous, with (P, M, N), once every check of a kernel B
    wrapper ``name`` on CUDA tensors of ``dtype`` passed; raises ValueError
    otherwise."""
    if a.dtype != dtype or b.dtype != dtype or a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"{name}: a and b are 2-D {str(dtype)[6:]}")
    if b.device != a.device or a.shape[0] != b.shape[0] or a.shape[0] < 1:
        raise ValueError(f"{name}: a and b need the same rows, on one device")
    (P, M), N = a.shape, b.shape[1]
    tiles = (1 if M == 64 else M // 128) * (N // 128)
    if (M != 64 and M % 128) or M < 64 or N % 128 or N < 128 or tiles > MAX_JOBS:
        raise ValueError(f"{name}: unsupported widths M={M} N={N}")
    if slices < 1:
        raise ValueError(f"{name}: slices >= 1")
    a, b = a.contiguous(), b.contiguous()
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError(f"{name}: a and b must be 16-byte aligned")
    return a, b, P, M, N


def _launch(kernel, a: torch.Tensor, b: torch.Tensor, P: int, M: int, N: int,
            slices: int) -> tuple[int, torch.Tensor]:
    """(the cudaError_t, the float32 [M, N] output) of one launch of C entry
    ``kernel``."""
    wpart = torch.empty(slices * M * N, dtype=F32, device=a.device)
    out = torch.empty(M, N, dtype=F32, device=a.device)
    with torch.cuda.device(a.device):
        err = kernel(a.data_ptr(), M, b.data_ptr(), N, P, slices, wpart.data_ptr(),
                     out.data_ptr(), torch.cuda.current_stream(a.device).cuda_stream)
    return err, out


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
    a, b, P, M, N = _check("wgrad_f32", a, b, F32, slices)
    err, out = _launch(_kernel(), a, b, P, M, N, slices)
    if err != 0:
        raise RuntimeError(f"wgrad_f32 kernel launch failed: cudaError_t {err}")
    wgrad_f32.launches += 1
    return out


wgrad_f32.launches = 0


@functools.cache
def _bf16_kernel():
    """The C entry ``fdk_wgrad_bf16`` of csrc/pair_mlp_bwd_wg_bf16.cu, bound
    at first use."""
    return _bind("pair_mlp_bwd_wg_bf16", "fdk_wgrad_bf16")


def wgrad_bf16(a: torch.Tensor, b: torch.Tensor, slices: int = 8) -> torch.Tensor:
    """G = a^T b ([P, M] and [P, N] bf16 -> [M, N] float32) by bf16 kernel
    B alone, over ``slices`` K slices summed in slice order: M = 64 or a
    multiple of 128, N a multiple of 128, at most 16 tiles of 128 x 128.
    CPU tensors take :func:`wgrad_plain`; CUDA tensors launch the kernel or
    raise. Adds one to ``wgrad_bf16.launches`` a launch."""
    if a.device.type == "cpu":
        return wgrad_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"wgrad_bf16: unsupported device {a.device}")
    a, b, P, M, N = _check("wgrad_bf16", a, b, BF16, slices)
    err, out = _launch(_bf16_kernel(), a, b, P, M, N, slices)
    if err != 0:
        raise RuntimeError(f"wgrad_bf16 kernel launch failed: cudaError_t {err}")
    wgrad_bf16.launches += 1
    return out


wgrad_bf16.launches = 0
