"""Build the CUDA kernels from ``csrc/`` with nvcc and load them with ctypes.

Each source is compiled by its own nvcc process (all started together) into
a shared library with a plain C interface, for ``sm_90a``. Libraries go to
``framedipt_tpu_torch/_build/`` under a name keyed by a hash of the sources
and flags, so a changed source is rebuilt and an unchanged one is reused.
Nothing is built or loaded at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

_PKG = pathlib.Path(__file__).resolve().parent.parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = {
    "edge_embedder": "edge_embedder.cu",
    "edge_embedder_bwd": "edge_embedder_bwd.cu",
    "edge_embedder_bwd_wg": "edge_embedder_bwd_wg.cu",
    "edge_embedder_wg": "edge_embedder_wg.cu",
    "ipa_attention": "ipa_attention.cu",
    "pair_mlp_bwd_wg": "pair_mlp_bwd_wg.cu",
    "pair_mlp_bwd_wg_bf16": "pair_mlp_bwd_wg_bf16.cu",
    "pair_mlp_wg": "pair_mlp_wg.cu",
    "pair_mlp_wg_bf16": "pair_mlp_wg_bf16.cu",
}
HEADERS = ("common.cuh", "mma.cuh", "tc_product.cuh", "edge_embedder_tc.cuh",
           "wgrad_wg.cuh", "wgrad_bf16.cuh", "wgmma_tma.cuh", "pair_mlp_wg.cuh", "pair_mlp_split.cuh",
           "edge_embedder_wg.cuh", "edge_embedder_split.cuh", "pair_mlp_wg_bf16.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_log: dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fname in (SOURCES[name],) + HEADERS:
        h.update((CSRC / fname).read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, dict]:
    """Compile every kernel library that is not built yet, one nvcc per
    source in parallel. Returns {name: {"path", "seconds", "log"}}; raises
    with nvcc's output if a build fails."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        todo = {n: _lib_path(n) for n in SOURCES if not _lib_path(n).exists()}
        procs = {}
        t0 = time.perf_counter()
        for name, path in todo.items():
            tmp = path.with_suffix(f".tmp{os.getpid()}.so")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
            procs[name] = (
                subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
                ),
                tmp,
                path,
            )
        failed = []
        for name, (proc, tmp, path) in procs.items():
            out, _ = proc.communicate()
            build_log[name] = {
                "path": str(path),
                "seconds": time.perf_counter() - t0,
                "log": out,
            }
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {SOURCES[name]}:\n{out}")
            else:
                os.replace(tmp, path)
        if failed:
            raise RuntimeError("\n".join(failed))
        return dict(build_log)


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    path = _lib_path(name)
    if not path.exists():
        build_all()
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(path))
        return _libs[name]
