"""ctypes bindings for the XTC decoder of the shared host C++ helpers
(`csrc/tmdnative.cpp` at the repository root; the port's prmtop reader
parses its floats with numpy).

The port's own loader of that source. The shared library is built with
g++ on first use into `torchmd_tpu_torch/_build/`, named by a hash of
the source and the flags (written to a temporary name and moved in
place, so concurrent processes never load a partial file). When the
source or a compiler is missing, or the build fails, `get_lib` returns
None and every caller decodes in Python instead (`io.xtc.read_xtc`):
this is host parsing, an accelerator of the readers, never a
requirement.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_LOCK = threading.Lock()
_LIB = None
_TRIED = False

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(_PKG_DIR), "csrc", "tmdnative.cpp")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")


def library_path() -> str:
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(SRC, "rb") as fh:
        digest.update(fh.read())
    return os.path.join(BUILD_DIR, f"libtmdnative_{digest.hexdigest()[:16]}.so")


def _build() -> str | None:
    if not os.path.exists(SRC):
        return None
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, SRC],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return None
    os.replace(tmp, out)
    return out


def get_lib():
    """Load (building if necessary) the native library, or None."""
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        so = _build()
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None
        lib.tmd_xtc_decode.restype = ctypes.c_long
        lib.tmd_xtc_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_long,
            ctypes.POINTER(ctypes.c_long),
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        _LIB = lib
        return _LIB


def available() -> bool:
    return get_lib() is not None


def xtc_decode(data: bytes):
    """Decode an XTC byte buffer. Returns (coords (natoms,3,nframes) A,
    box (3,nframes) A, steps, times) or None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    natoms = ctypes.c_long(0)
    nframes = lib.tmd_xtc_decode(data, len(data), ctypes.byref(natoms),
                                 None, None, None, None)
    if nframes < 0:
        raise ValueError(f"corrupt XTC stream (code {nframes})")
    if nframes == 0:
        return (np.zeros((0, 3, 0)), np.zeros((3, 0)),
                np.zeros(0, np.int32), np.zeros(0, np.float32))
    n = natoms.value
    coords = np.empty((nframes, n, 3), dtype=np.float64)
    box = np.empty((nframes, 3), dtype=np.float64)
    steps = np.empty(nframes, dtype=np.int32)
    times = np.empty(nframes, dtype=np.float32)
    ret = lib.tmd_xtc_decode(
        data, len(data), ctypes.byref(natoms),
        coords.ctypes.data_as(ctypes.c_void_p),
        box.ctypes.data_as(ctypes.c_void_p),
        steps.ctypes.data_as(ctypes.c_void_p),
        times.ctypes.data_as(ctypes.c_void_p),
    )
    if ret != nframes:
        raise ValueError("XTC decode inconsistency")
    return (np.transpose(coords, (1, 2, 0)), box.T, steps, times)
