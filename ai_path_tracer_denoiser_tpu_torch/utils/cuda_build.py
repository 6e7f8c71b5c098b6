"""Build-at-first-use for the package's CUDA C++ kernels (csrc/*.cu).

Each source compiles with ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, loaded with ctypes.  Libraries land in
``_build/`` beside this package (listed in .gitignore), named by a hash of
the source and flags, so an edited source rebuilds and an unchanged one
loads at once.  ``build_all`` starts one nvcc per source together, so the
whole set builds in the time of the slowest file.

A ``CudaKernel`` also carries its launch count: the wrapper adds one each
time it launches the kernel, and nowhere else, so a run can show that its
main path went through the kernel.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
# No --use_fast_math anywhere: the kernels keep IEEE division, sqrt and
# denormals, like the plain PyTorch versions they are held against.
BASE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


class CudaKernel:
    """One csrc/ source, its shared library and its launch count."""

    def __init__(self, name: str, source: str, extra_flags: Sequence[str] = (),
                 declare: Optional[Callable[[ctypes.CDLL], None]] = None,
                 headers: Sequence[str] = ()):
        self.name = name
        self.source = os.path.join(CSRC_DIR, source)
        # csrc/ headers the source includes: part of the library's hash
        self.headers = tuple(os.path.join(CSRC_DIR, h) for h in headers)
        self.flags = BASE_FLAGS + tuple(extra_flags)
        self._declare = declare
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()
        self.launches = 0
        self.build_log = ""
        self._fit: Dict[tuple, int] = {}

    def library_path(self) -> str:
        h = hashlib.sha1()
        for path in (self.source, *self.headers):
            with open(path, "rb") as f:
                h.update(f.read())
        h.update(" ".join(self.flags).encode())
        return os.path.join(BUILD_DIR, f"lib{self.name}-{h.hexdigest()[:12]}.so")

    def _command(self, out: str) -> List[str]:
        return [_nvcc(), *self.flags, "-Xptxas", "-v", "-o", out, self.source]

    def start_build(self) -> Optional[subprocess.Popen]:
        """Start nvcc for this source unless its library exists."""
        path = self.library_path()
        if os.path.exists(path):
            return None
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        proc = subprocess.Popen(self._command(tmp), stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        proc.tmp_path, proc.final_path = tmp, path
        return proc

    def finish_build(self, proc: Optional[subprocess.Popen]) -> None:
        if proc is None:
            return
        out, _ = proc.communicate()
        self.build_log = out
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.source}:\n{out}")
        os.replace(proc.tmp_path, proc.final_path)

    def lib(self) -> ctypes.CDLL:
        """The loaded library, built first if needed."""
        with self._lock:
            if self._lib is None:
                self.finish_build(self.start_build())
                lib = ctypes.CDLL(self.library_path())
                if self._declare is not None:
                    self._declare(lib)
                self._lib = lib
            return self._lib

    def blocks_per_sm(self, entry: str, device, *args: int) -> int:
        """Blocks that fit on one SM of ``device`` (the occupancy API), from
        the library's C function ``entry(*args, int* out)``; asked once per
        device and arguments."""
        import torch
        key = (entry, str(device), args)
        if key not in self._fit:
            out = ctypes.c_int(0)
            with torch.cuda.device(device):
                check(getattr(self.lib(), entry)(*args, ctypes.byref(out)),
                      f"{self.name} occupancy")
            self._fit[key] = out.value
        return self._fit[key]


def build_all(kernels: Sequence[CudaKernel]) -> None:
    """Build every kernel's library, one nvcc per source, all at once."""
    procs = [k.start_build() for k in kernels]
    for k, p in zip(kernels, procs):
        k.finish_build(p)
    for k in kernels:
        k.lib()


def check(rc: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def rebuilt(shipped: CudaKernel, source: str, name: str = "") -> CudaKernel:
    """Another version of ``shipped``'s source (the same C interface) at the
    path ``source``, built with ``shipped``'s flags, declarations and
    headers, named ``name`` (default: the file's stem)."""
    name = name or os.path.splitext(os.path.basename(source))[0]
    return CudaKernel(name, os.path.abspath(source), declare=shipped._declare,
                      headers=shipped.headers,
                      extra_flags=shipped.flags[len(BASE_FLAGS):] + (f"-I{CSRC_DIR}",))


def edited_build(shipped: CudaKernel, name: str,
                 edits: Sequence[Tuple[str, str]]) -> CudaKernel:
    """``shipped``'s source with text edits (each old text must occur
    exactly once), written into the build directory and built as
    ``rebuilt`` builds it."""
    with open(shipped.source) as f:
        text = f.read()
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"{name}: {old!r} occurs {text.count(old)} times")
        text = text.replace(old, new)
    path = os.path.join(BUILD_DIR, "variants", f"{name}.cu")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)
    return rebuilt(shipped, path, name)


@contextlib.contextmanager
def swapped(owner, attr: str, kernel: CudaKernel):
    """``owner.attr``, the build a wrapper launches, set to ``kernel``
    inside the block."""
    saved = getattr(owner, attr)
    setattr(owner, attr, kernel)
    try:
        yield
    finally:
        setattr(owner, attr, saved)
