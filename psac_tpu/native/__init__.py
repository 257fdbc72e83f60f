"""ctypes bindings to the native sequential oracle (SA-IS + Kasai).

The shared library is built from ``sais.cpp`` on first use with g++ (no pip
deps) and is never committed. This is the framework's equivalent of the
reference's vendored libdivsufsort verification layer (SURVEY.md §2 L6) and
the sequential baseline for bench.py and chip_smoke.py.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_DIR, "libpsac_native.so")
_SRC = os.path.join(_DIR, "sais.cpp")
_lib = None


def _build() -> None:
    """Compile ``sais.cpp`` into a private temporary file next to the target
    and rename it into place: concurrent processes (test workers) each
    publish a complete library, and a half-written one is never loaded."""
    fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=_DIR)
    os.close(fd)
    try:
        subprocess.run(
            ["g++", "-O3", "-fPIC", "-shared", "-std=c++17", _SRC, "-o", tmp],
            check=True, capture_output=True,
        )
        os.replace(tmp, _SO)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
        _build()
    lib = ctypes.CDLL(_SO)
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.sais_u8.argtypes = [u8p, ctypes.c_int64, i64p]
    lib.sais_u8.restype = None
    lib.kasai_u8.argtypes = [u8p, ctypes.c_int64, i64p, i64p]
    lib.kasai_u8.restype = None
    _lib = lib
    return lib


def suffix_array(text: bytes | np.ndarray) -> np.ndarray:
    """SA-IS suffix array (native, O(n))."""
    t = np.frombuffer(text, dtype=np.uint8) if isinstance(text, (bytes, bytearray)) else np.ascontiguousarray(text, np.uint8)
    sa = np.empty(len(t), np.int64)
    if len(t):
        _load().sais_u8(t, len(t), sa)
    return sa


def lcp_array(text: bytes | np.ndarray, sa: np.ndarray) -> np.ndarray:
    """Kasai LCP from SA (native, O(n))."""
    t = np.frombuffer(text, dtype=np.uint8) if isinstance(text, (bytes, bytearray)) else np.ascontiguousarray(text, np.uint8)
    lcp = np.zeros(len(t), np.int64)
    if len(t):
        _load().kasai_u8(t, len(t), np.ascontiguousarray(sa, np.int64), lcp)
    return lcp
