"""ctypes bindings for the C++ SA-IS builder (csrc/host/sais.cpp).

Compiles the shared library on demand (g++) into the package build
directory (see _build.py).  Falls back gracefully when no compiler is available.
"""

from __future__ import annotations

import ctypes
import logging

import numpy as np

from .._build import host_library

logger = logging.getLogger(__name__)

_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    try:
        lib = host_library("sais", [])
        lib.sais_u8.restype = ctypes.c_int
        lib.sais_u8.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.c_int64,
        ]
        _lib = lib
    except Exception as e:  # no compiler / build failure: numpy fallback
        logger.warning("native SA-IS unavailable (%s); using numpy fallback", e)
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def suffix_array(text: np.ndarray) -> np.ndarray:
    lib = _load()
    if lib is None:
        raise RuntimeError("native SA-IS not available")
    text = np.ascontiguousarray(text, dtype=np.uint8)
    n = len(text)
    # n + 1 slots: the library appends a unique sentinel whose suffix lands
    # in slot 0; the real suffix array is the view [1:]
    sa = np.empty(n + 1, dtype=np.int64)
    ret = lib.sais_u8(
        text.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n,
        int(text.max()) + 1,
    )
    if ret != 0:
        raise RuntimeError(f"sais_u8 failed with code {ret}")
    return sa[1:]
