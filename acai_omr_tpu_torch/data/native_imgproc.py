"""ctypes bindings for the native image-preprocessing kernel.

Loads native/libimgproc.so (built by native/Makefile) and exposes
antialiased bicubic resize for the host data pipeline. Falls back silently when the library isn't built — callers check
:func:`available` or use :mod:`.transforms`' PIL path.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

_LIB = None
_TRIED = False
_LOAD_LOCK = threading.Lock()


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    # lock: PrefetchLoader worker threads race the check-then-build-then-set
    # otherwise (two threads past the _TRIED check could kick off two
    # concurrent `make`s against a half-written .so); CDLL failures mean
    # "library unusable here" (wrong arch/libc) and must take the documented
    # silent PIL fallback, not crash the pipeline (round-5 review)
    with _LOAD_LOCK:
        if _TRIED:
            return _LIB
        so = Path(__file__).resolve().parents[2] / "native" / "libimgproc.so"
        try:
            if not so.exists():
                makefile = so.parent / "Makefile"
                if makefile.exists():
                    import subprocess
                    subprocess.run(["make", "-C", str(so.parent),
                                    "libimgproc.so"],
                                   capture_output=True, check=False)
            if so.exists():
                lib = ctypes.CDLL(str(so))
                fp = ctypes.POINTER(ctypes.c_float)
                lib.resize_bicubic.argtypes = [
                    fp, ctypes.c_int32, ctypes.c_int32,
                    fp, ctypes.c_int32, ctypes.c_int32]
                _LIB = lib
        except OSError:
            _LIB = None
        _TRIED = True
    return _LIB


def available() -> bool:
    return _load() is not None


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def resize_bicubic(img: np.ndarray, th: int, tw: int) -> np.ndarray:
    """(H, W) float32 -> (th, tw) float32, PIL-equivalent antialiased bicubic."""
    lib = _load()
    img = np.ascontiguousarray(img, dtype=np.float32)
    out = np.empty((th, tw), dtype=np.float32)
    lib.resize_bicubic(_fp(img), img.shape[0], img.shape[1], _fp(out), th, tw)
    return out

