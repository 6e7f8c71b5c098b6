"""ctypes bindings to the framework-free native library (native/).

``native/libaptd_native.so`` (tinyobj-style OBJ loading, PNG writing) has
a plain C interface and no framework dependency; this is the port's own
loader for it.  It follows the same rules as the JAX package's loader —
load the library if present, else try ``make`` once, else report it
unavailable — so both packages parse OBJ files the same way in the same
checkout.  Pure-Python fallbacks exist for every entry point.
"""
from __future__ import annotations

import ctypes
import functools
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libaptd_native.so")


@functools.lru_cache(maxsize=1)
def _load() -> Optional[ctypes.CDLL]:
    if not os.path.exists(_LIB_PATH):
        if os.environ.get("APTD_NO_NATIVE"):
            return None
        try:
            subprocess.run(["make", "-C", _NATIVE_DIR],
                           check=True, capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.aptd_obj_load.restype = ctypes.c_int
    lib.aptd_obj_load.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float))]
    lib.aptd_free.restype = None
    lib.aptd_free.argtypes = [ctypes.c_void_p]
    return lib


def available() -> bool:
    return _load() is not None


def load_obj(path: str, transform: Optional[np.ndarray] = None,
             recompute_normals: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """OBJ -> (vertices (F,3,3), normals (F,3,3)) world-space float32."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    if transform is None:
        transform = np.eye(4)
    t = np.ascontiguousarray(transform, np.float32)
    verts_p = ctypes.POINTER(ctypes.c_float)()
    norms_p = ctypes.POINTER(ctypes.c_float)()
    nf = lib.aptd_obj_load(
        path.encode(), t.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        int(recompute_normals), ctypes.byref(verts_p), ctypes.byref(norms_p))
    if nf < 0:
        raise FileNotFoundError(f"aptd_obj_load failed for {path}")
    try:
        verts = np.ctypeslib.as_array(verts_p, shape=(nf, 3, 3)).copy()
        norms = np.ctypeslib.as_array(norms_p, shape=(nf, 3, 3)).copy()
    finally:
        lib.aptd_free(verts_p)
        lib.aptd_free(norms_p)
    return verts, norms

