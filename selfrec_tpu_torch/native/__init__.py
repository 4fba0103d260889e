"""Native (C++) host components, exposed over ctypes.

The shared library is compiled on first use with g++ (cached next to the
source by content hash) — no pybind11/setuptools step. Every native entry
point has a pure-Python fallback in the data layer, so the package works
without a toolchain.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from typing import List, Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "loader.cpp")
_lib = None
_lib_failed = False


class _GraphData(ctypes.Structure):
    _fields_ = [
        ("n_edges", ctypes.c_int64),
        ("src_ids", ctypes.POINTER(ctypes.c_int32)),
        ("dst_ids", ctypes.POINTER(ctypes.c_int32)),
        ("weights", ctypes.POINTER(ctypes.c_float)),
        ("n_src", ctypes.c_int64),
        ("n_dst", ctypes.c_int64),
        ("src_blob", ctypes.POINTER(ctypes.c_char)),
        ("src_offsets", ctypes.POINTER(ctypes.c_int64)),
        ("dst_blob", ctypes.POINTER(ctypes.c_char)),
        ("dst_offsets", ctypes.POINTER(ctypes.c_int64)),
        ("error", ctypes.c_char_p),
    ]


def _build_lib() -> Optional[str]:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    cache_dir = os.environ.get(
        "SELFREC_TPU_NATIVE_CACHE",
        os.path.join(tempfile.gettempdir(), "selfrec_tpu_torch_native"),
    )
    os.makedirs(cache_dir, exist_ok=True)
    so_path = os.path.join(cache_dir, f"loader_{digest}.so")
    if os.path.exists(so_path):
        return so_path
    tmp = so_path + f".tmp{os.getpid()}"
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, so_path)
        return so_path
    except (OSError, subprocess.SubprocessError):
        return None


def get_lib():
    """The loaded native library, or None if unavailable."""
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    if os.environ.get("SELFREC_TPU_NO_NATIVE"):
        _lib_failed = True
        return None
    so_path = _build_lib()
    if so_path is None:
        _lib_failed = True
        return None
    try:
        lib = ctypes.CDLL(so_path)
        lib.selfrec_load_graph.restype = ctypes.POINTER(_GraphData)
        lib.selfrec_load_graph.argtypes = [ctypes.c_char_p]
        lib.selfrec_free_graph.argtypes = [ctypes.POINTER(_GraphData)]
        _lib = lib
    except OSError:
        _lib_failed = True
    return _lib


def _unpack_names(blob, offsets, n) -> List[str]:
    total = offsets[n]
    raw = ctypes.string_at(blob, total)
    return [
        raw[offsets[i] : offsets[i + 1] - 1].decode("utf-8", "replace")
        for i in range(n)
    ]


def load_graph_mapped(
    path: str,
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, List[str], List[str]]]:
    """(src_ids, dst_ids, weights, src_names, dst_names) with FIRST-SEEN id
    assignment identical to the Python loader, or None if native is
    unavailable or parsing failed."""
    lib = get_lib()
    if lib is None:
        return None
    g = lib.selfrec_load_graph(path.encode())
    try:
        d = g.contents
        if d.error:
            return None
        n = d.n_edges
        src = np.ctypeslib.as_array(d.src_ids, shape=(n,)).copy()
        dst = np.ctypeslib.as_array(d.dst_ids, shape=(n,)).copy()
        w = np.ctypeslib.as_array(d.weights, shape=(n,)).copy()
        src_names = _unpack_names(d.src_blob, d.src_offsets, d.n_src)
        dst_names = _unpack_names(d.dst_blob, d.dst_offsets, d.n_dst)
        return src, dst, w, src_names, dst_names
    finally:
        lib.selfrec_free_graph(g)
