"""ctypes bindings to the framework-free native library (native/).

``native/libaptd_native.so`` (tinyobj-style OBJ loading, PNG writing) has
a plain C interface and no framework dependency; this is the port's own
loader for it, binding ``aptd_obj_load`` / ``aptd_free`` (``load_obj``)
and ``aptd_png_write`` (``write_png``).  It follows the same rules as the
JAX package's loader — load the library if present, else try ``make``
once, else report it unavailable — so both packages parse OBJ files the
same way in the same checkout.  Pure-Python fallbacks exist for every entry point.

Several processes may find the library missing at once (pytest-xdist
workers each import the loaders while collecting).  ``make`` writes its
target in place, so a process that loads the file while another is still
linking it gets a truncated ELF and reports the library unavailable.  This
loader therefore builds under an exclusive lock on the Makefile, into a
name of its own, and renames the finished library into place: it never
leaves a half-written library at the final path.
"""
from __future__ import annotations

import ctypes
import fcntl
import functools
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_LIB_NAME = "libaptd_native.so"


def _build(native_dir: str) -> None:
    """Build ``native_dir``'s library unless it exists: one process at a
    time (a lock on the Makefile), into a temporary name, then renamed."""
    lib_path = os.path.join(native_dir, _LIB_NAME)
    with open(os.path.join(native_dir, "Makefile"), "rb") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(lib_path):         # built while this one waited
            return
        tmp = f"{_LIB_NAME}.{os.getpid()}.tmp"
        tmp_path = os.path.join(native_dir, tmp)
        try:
            subprocess.run(["make", "-C", native_dir, f"TARGET={tmp}"],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp_path, lib_path)
        finally:
            if os.path.exists(tmp_path):
                os.remove(tmp_path)


@functools.lru_cache(maxsize=None)
def load_library(native_dir: str = _NATIVE_DIR) -> Optional[ctypes.CDLL]:
    """The native library of ``native_dir``, built first if missing; None
    when it cannot be built or loaded."""
    lib_path = os.path.join(native_dir, _LIB_NAME)
    if not os.path.exists(lib_path):
        if os.environ.get("APTD_NO_NATIVE"):
            return None
        try:
            _build(native_dir)
        except (OSError, subprocess.SubprocessError):
            return None
    try:
        lib = ctypes.CDLL(lib_path)
    except OSError:
        return None
    lib.aptd_obj_load.restype = ctypes.c_int
    lib.aptd_obj_load.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float))]
    lib.aptd_free.restype = None
    lib.aptd_free.argtypes = [ctypes.c_void_p]
    lib.aptd_png_write.restype = ctypes.c_int
    lib.aptd_png_write.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_ubyte),
                                   ctypes.c_int, ctypes.c_int, ctypes.c_int]
    return lib


def available() -> bool:
    return load_library() is not None


def load_obj(path: str, transform: Optional[np.ndarray] = None,
             recompute_normals: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """OBJ -> (vertices (F,3,3), normals (F,3,3)) world-space float32."""
    lib = load_library()
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


def write_png(path: str, arr: np.ndarray) -> None:
    """Write uint8 (H, W, 1|3|4) pixels as an 8-bit PNG through the native
    library: filter type 0 on every row, zlib level 6, the bytes of
    ``utils/imageio.py:encode_png``."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native library unavailable")
    arr = np.ascontiguousarray(arr, np.uint8)
    h, w, c = arr.shape
    rc = lib.aptd_png_write(path.encode(), arr.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
                            w, h, c)
    if rc != 0:
        raise OSError(f"aptd_png_write failed for {path}")
