"""Host-side C++ of the port, built at first use and bound with ctypes.

``pdb_writer.cpp`` formats trajectory PDB text (see its header). The
library is compiled by the host C++ compiler on ``PATH`` (``g++``, else
``c++``) into ``framedipt_tpu_torch/_build/`` under a name keyed by a hash of
the source and flags, written under a temporary name and renamed into place,
so processes that build at once never load a half-written file. Nothing is
built at import time.

:func:`load_pdb_writer` returns the loaded library, or None when it cannot
be built or loaded; it then logs one warning that names the compiler's
error, and the callers take the pure-Python writer.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

from framedipt_tpu_torch.tools.log import get_logger

_DIR = pathlib.Path(__file__).resolve().parent
BUILD_DIR = _DIR.parent / "_build"
PDB_WRITER_SOURCE = _DIR / "pdb_writer.cpp"
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()


def load_pdb_writer() -> ctypes.CDLL | None:
    """The PDB writer library (``fdt_pdb_models_bytes``,
    ``fdt_format_models``), built first if needed; None when it cannot be
    built or loaded, after one warning. Threads that ask at once wait for
    one build."""
    with _lock:
        return _load_pdb_writer()


@functools.cache
def _load_pdb_writer() -> ctypes.CDLL | None:
    try:
        cxx = shutil.which("g++") or shutil.which("c++")
        if cxx is None:
            raise RuntimeError("no host C++ compiler (g++ or c++) on PATH")
        source = PDB_WRITER_SOURCE
        h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
        h.update(source.read_bytes())
        path = BUILD_DIR / f"libpdb_writer_{h.hexdigest()[:16]}.so"
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".tmp{os.getpid()}.so")
            proc = subprocess.run([cxx, *CXX_FLAGS, str(source), "-o", str(tmp)],
                                  capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"{cxx} failed on {source.name}:\n{proc.stderr[-2000:]}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        get_logger().warning("native PDB writer unavailable, writing PDB text in Python: %s", e)
        return None
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.fdt_pdb_models_bytes.argtypes = (p, i64, i64, p)
    lib.fdt_pdb_models_bytes.restype = i64
    lib.fdt_format_models.argtypes = (p, i64, i64, p, p, p, p, p, p, i64, p, i64)
    lib.fdt_format_models.restype = i64
    return lib
