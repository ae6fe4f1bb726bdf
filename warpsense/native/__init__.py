"""Native (C++) runtime components, loaded via ctypes.

The compute path is JAX/XLA; this library is the host-side equivalent of
the reference's C++ runtime layer (queues, preprocessing, shift slab IO —
see native.cpp).  The .so is compiled on first use with g++ and cached
next to the source; every consumer has a pure-Python fallback, so the
framework works (slower) without a toolchain.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_SRC = Path(__file__).with_name("native.cpp")
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def _build(out: Path) -> bool:
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
           str(_SRC), "-o", str(out)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        return True
    except (subprocess.SubprocessError, FileNotFoundError):
        return False


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.ws_version.restype = ctypes.c_int
    lib.ws_ringbuf_create.restype = ctypes.c_void_p
    lib.ws_ringbuf_create.argtypes = [ctypes.c_size_t]
    lib.ws_ringbuf_destroy.argtypes = [ctypes.c_void_p]
    lib.ws_ringbuf_size.restype = ctypes.c_size_t
    lib.ws_ringbuf_size.argtypes = [ctypes.c_void_p]
    lib.ws_ringbuf_clear.argtypes = [ctypes.c_void_p]
    lib.ws_ringbuf_push.restype = ctypes.c_int
    lib.ws_ringbuf_push.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_size_t, ctypes.c_int,
                                    ctypes.c_double]
    lib.ws_ringbuf_pop.restype = ctypes.c_int
    lib.ws_ringbuf_pop.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_size_t,
                                   ctypes.POINTER(ctypes.c_size_t),
                                   ctypes.c_double]
    lib.ws_preprocess.restype = ctypes.c_int64
    lib.ws_preprocess.argtypes = [ctypes.POINTER(ctypes.c_float),
                                  ctypes.c_int64, ctypes.c_int32,
                                  ctypes.c_float,
                                  ctypes.POINTER(ctypes.c_int32),
                                  ctypes.c_int64]
    i16p = ctypes.POINTER(ctypes.c_int16)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.ws_ring_gather.argtypes = [i16p, i16p, i32p, i32p, i32p, i64p, i64p,
                                   u32p]
    lib.ws_ring_scatter.argtypes = [i16p, i16p, i32p, i32p, i32p, i64p, i64p,
                                    u32p]
    return lib


def load() -> ctypes.CDLL | None:
    """Load (building if needed) the native library; None when unavailable.
    Override with WARPSENSE_NO_NATIVE=1 to force the Python fallbacks."""
    global _lib, _tried
    if os.environ.get("WARPSENSE_NO_NATIVE"):
        return None
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:12]
        out = _SRC.with_name(f"_native_{tag}.so")
        if not out.exists() and not _build(out):
            return None
        try:
            _lib = _declare(ctypes.CDLL(str(out)))
        except OSError:
            return None
        return _lib
