"""What the harness may import: never JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
the reference nothing of the program."""
import ast
import os
import subprocess
import sys

from perfbench import common

BENCH = common.BENCH_DIR
PORT = "ai_path_tracer_denoiser_tpu_torch"


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def _sources(sub=""):
    base = os.path.join(BENCH, sub)
    for d, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_anywhere():
    for path in _sources():
        bad = _imports(path) & set(common.FORBIDDEN)
        assert not bad, f"{path} imports {bad}"


def test_top_level_names_are_compared_whole():
    assert PORT.startswith(common.FORBIDDEN[-1])
    sys.modules.setdefault(PORT + "_probe_only", object())
    try:
        assert common.forbidden_loaded() == [] or "ai_path_tracer_denoiser_tpu" in sys.modules
    finally:
        sys.modules.pop(PORT + "_probe_only", None)


def test_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        names = _imports(path)
        assert PORT not in names and "perfbench" not in names, (path, names)
        assert names <= {"__future__", "math", "os", "typing", "numpy", "torch"}, (path, names)


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r); import perfbench.run, perfbench.loops; "
            "from perfbench import common; common.loop_module('interactive'); "
            "common.loop_module('train'); import ai_path_tracer_denoiser_tpu_torch.models, "
            "ai_path_tracer_denoiser_tpu_torch.render, ai_path_tracer_denoiser_tpu_torch.train; "
            "print(common.forbidden_loaded())" % common.ROOT)
    env = dict(os.environ, PYTHONPATH=common.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
