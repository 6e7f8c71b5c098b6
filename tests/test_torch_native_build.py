"""The port's loader of the native library (utils/native.py) when the
library is missing, on a copy of native/ in a temporary directory.

Several processes that find the library missing at once (pytest-xdist
workers collecting the tests) must each end up with a loaded library: the
loader builds one at a time under a lock and renames the finished file
into place, so no process ever loads a half-written one.  A build that
fails leaves neither a library nor a temporary file behind.
"""
import pathlib
import shutil
import subprocess
import sys
import time

from ai_path_tracer_denoiser_tpu_torch.utils import native

REPO = pathlib.Path(__file__).resolve().parent.parent
LOADER = """
import sys, time
from ai_path_tracer_denoiser_tpu_torch.utils import native
while time.time() < float(sys.argv[2]):
    pass
print(native.load_library(sys.argv[1]) is not None)
"""


def copy_native(tmp_path):
    dst = tmp_path / "native"
    shutil.copytree(REPO / "native", dst, ignore=shutil.ignore_patterns("*.so", "*.tmp"))
    return dst


def test_concurrent_loaders_all_get_the_library(tmp_path):
    native_dir = copy_native(tmp_path)
    start = time.time() + 3.0                # every process past its imports
    procs = [subprocess.Popen([sys.executable, "-c", LOADER, str(native_dir), str(start)],
                              cwd=REPO, stdout=subprocess.PIPE, text=True)
             for _ in range(6)]
    outs = [p.communicate(timeout=600)[0].strip() for p in procs]
    assert outs == ["True"] * 6
    assert sorted(p.name for p in native_dir.iterdir()) == ["Makefile", native._LIB_NAME, "src"]


def test_failed_build_leaves_nothing_behind(tmp_path):
    native_dir = copy_native(tmp_path)
    (native_dir / "src" / "aptd_native.cpp").write_text("this is not C++\n")
    assert native.load_library(str(native_dir)) is None
    assert sorted(p.name for p in native_dir.iterdir()) == ["Makefile", "src"]
