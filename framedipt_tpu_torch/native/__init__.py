"""Host-side C++ of the port, built at first use and bound with ctypes.

``pdb_writer.cpp`` formats trajectory PDB text and ``cif_tokenizer.cpp``
parses CIF text into its categories (see their headers). Each library is
compiled by the host C++ compiler on ``PATH`` (``g++``, else ``c++``) into
``framedipt_tpu_torch/_build/`` under a name keyed by a hash of the source
and flags, written under a temporary name and renamed into place, so
processes that build at once never load a half-written file. Nothing is
built at import time.

:func:`load_pdb_writer` and :func:`load_cif_tokenizer` return the loaded
library, or None when it cannot be built or loaded; each then logs one
warning that names the compiler's error, and the callers take the
pure-Python code. :func:`parse_cif_categories` runs the CIF parser.
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
CIF_TOKENIZER_SOURCE = _DIR / "cif_tokenizer.cpp"
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()


def _build_and_load(source: pathlib.Path, what: str, fallback: str) -> ctypes.CDLL | None:
    """The library of ``source``, built first if needed; None when it cannot
    be built or loaded, after one warning naming ``what``, the ``fallback``
    taken in Python and the error."""
    try:
        cxx = shutil.which("g++") or shutil.which("c++")
        if cxx is None:
            raise RuntimeError("no host C++ compiler (g++ or c++) on PATH")
        h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
        h.update(source.read_bytes())
        path = BUILD_DIR / f"lib{source.stem}_{h.hexdigest()[:16]}.so"
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".tmp{os.getpid()}.so")
            proc = subprocess.run([cxx, *CXX_FLAGS, str(source), "-o", str(tmp)],
                                  capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"{cxx} failed on {source.name}:\n{proc.stderr[-2000:]}")
            os.replace(tmp, path)
        return ctypes.CDLL(str(path))
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        get_logger().warning("%s unavailable, %s in Python: %s", what, fallback, e)
        return None


def load_pdb_writer() -> ctypes.CDLL | None:
    """The PDB writer library (``fdt_pdb_models_bytes``,
    ``fdt_format_models``), built first if needed; None when it cannot be
    built or loaded, after one warning. Threads that ask at once wait for
    one build."""
    with _lock:
        return _load_pdb_writer()


@functools.cache
def _load_pdb_writer() -> ctypes.CDLL | None:
    lib = _build_and_load(PDB_WRITER_SOURCE, "native PDB writer", "writing PDB text")
    if lib is None:
        return None
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.fdt_pdb_models_bytes.argtypes = (p, i64, i64, p)
    lib.fdt_pdb_models_bytes.restype = i64
    lib.fdt_format_models.argtypes = (p, i64, i64, p, p, p, p, p, p, i64, p, i64)
    lib.fdt_format_models.restype = i64
    return lib


def load_cif_tokenizer() -> ctypes.CDLL | None:
    """The CIF parser library (``fdt_cif_parse``, ``fdt_cif_take``,
    ``fdt_cif_free``), built first if needed; None when it cannot be built
    or loaded, after one warning."""
    with _lock:
        return _load_cif_tokenizer()


@functools.cache
def _load_cif_tokenizer() -> ctypes.CDLL | None:
    lib = _build_and_load(CIF_TOKENIZER_SOURCE, "native CIF tokenizer", "parsing CIF text")
    if lib is None:
        return None
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.fdt_cif_parse.argtypes = (ctypes.c_char_p, i64, p)
    lib.fdt_cif_parse.restype = p
    lib.fdt_cif_take.argtypes = (p, p, p, p)
    lib.fdt_cif_take.restype = None
    lib.fdt_cif_free.argtypes = (p,)
    lib.fdt_cif_free.restype = None
    return lib


def parse_cif_categories(text: str) -> dict[str, dict[str, list[str]]] | None:
    """``{category: {item: [values]}}`` of CIF ``text`` through the native
    parser, equal to ``data.mmcif.parse_cif_categories_py``; None when the
    library is unavailable or the text holds a NUL (the buffers it hands
    back are NUL-separated) or does not encode as UTF-8."""
    lib = load_cif_tokenizer()
    if lib is None or "\0" in text:
        return None
    try:
        data = text.encode("utf-8")
    except UnicodeEncodeError:
        return None
    sizes = (ctypes.c_int64 * 3)()
    handle = lib.fdt_cif_parse(data, len(data), sizes)
    if not handle:
        raise MemoryError("native CIF tokenizer: out of memory")
    ncol, name_bytes, value_bytes = sizes
    try:
        # One spare byte each: ctypes takes no empty buffer. Its NUL adds an
        # empty string at the end of each split, past every column.
        names, values = bytearray(name_bytes + 1), bytearray(value_bytes + 1)
        counts = (ctypes.c_int64 * (ncol + 1))()
    except MemoryError:
        lib.fdt_cif_free(handle)
        raise
    lib.fdt_cif_take(handle, (ctypes.c_char * len(names)).from_buffer(names),
                     (ctypes.c_char * len(values)).from_buffer(values), counts)
    name_list = names.decode("utf-8").split("\0")
    value_list = values.decode("utf-8").split("\0")
    cats: dict[str, dict[str, list[str]]] = {}
    start = 0
    for k in range(ncol):
        n = counts[k]
        cats.setdefault(name_list[2 * k], {})[name_list[2 * k + 1]] = value_list[start:start + n]
        start += n
    return cats
