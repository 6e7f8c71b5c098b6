"""The port's public interface against the JAX package's, on the CPU.

An AST walk of both packages' module top levels (functions, classes,
assignments) and of their ``__init__`` re-exports must leave only the
TPU-only names listed here; the environment levers the JAX package reads
must be read by the port too, except the ones listed as not ported.  The names added
for that parity are held to their JAX counterparts here (re-exports,
``orbit_path``, ``generate_camera_rays``) and next to their modules
(tests/test_torch_ops.py, test_torch_imageio.py, test_torch_mesh_kernels.py).
The levers read at import are checked in a subprocess with the variables
set, the ones read at each call in another.
"""
import ast
import os
import pathlib
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import torch

from ai_path_tracer_denoiser_tpu.config import RenderOptions as JRenderOptions
from ai_path_tracer_denoiser_tpu.render import wavefront as jwavefront
from ai_path_tracer_denoiser_tpu.scene import camera as jcamera
from ai_path_tracer_denoiser_tpu_torch.config import RenderOptions
from ai_path_tracer_denoiser_tpu_torch.render import wavefront
from ai_path_tracer_denoiser_tpu_torch.scene import camera, derive_camera, load_scene

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX_PKG = REPO / "ai_path_tracer_denoiser_tpu"
PORT_PKG = REPO / "ai_path_tracer_denoiser_tpu_torch"

# Module of the JAX package -> its counterpart in the port.
MODULE_MAP = {"render/pallas_backend.py": "render/cuda_backend.py"}
# JAX names the port has under another name, in the mapped module.
RENAMED = {("render/pallas_backend.py", "render_pallas"): "render_cuda"}
# TPU layout, tiling or XLA names with no counterpart on the card.
TPU_ONLY = {
    ("models/conv_kernel.py", "pack_chw"),         # the CHW / 128-lane layout
    ("models/conv_kernel.py", "pack_weights_chw"),
    ("models/conv_kernel.py", "unpack_chw"),
    ("models/conv_kernel.py", "TH2"),
    ("render/mesh_binned.py", "LANES"),            # the TPU kernel's lane tile
    ("render/mesh_kernel_v3.py", "PIPELINE"),      # its DMA lookahead depth
    ("ops/bvh.py", "MIN_PACKED_ROWS"),             # its copy engine's alignment
    ("utils/timers.py", "time_jitted"),            # XLA compile + run timing
    ("render/pallas_backend.py", "TILE_ROWS"),     # the TPU kernel's pixel tile
}
# JAX levers the port does not read, and why.
NOT_PORTED_LEVERS = {
    "APTD_NO_COMPILE_CACHE": "the XLA compile cache",
    "APTD_MK3_PIPELINE": "the TPU kernel's DMA lookahead depth",
    "APTD_BVH_CLUSTER": "the hierarchy kernels are compiled for 32 faces per "
                        "cluster (kCluster); any other value could only be refused",
    "APTD_CONV_IMPL": "every conv impl name takes the one conv kernel",
}


def _public_names(root: pathlib.Path):
    """{module path relative to ``root``: public top-level names}, with each
    ``__init__``'s re-exports counted as its names."""
    out = {}
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(root).as_posix()
        if rel.startswith("_build/"):
            continue
        names = set()
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                names.add(node.name)
            elif isinstance(node, ast.Assign):
                names.update(t.id for t in node.targets if isinstance(t, ast.Name))
            elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
                names.add(node.target.id)
            elif isinstance(node, ast.ImportFrom) and path.name == "__init__.py":
                names.update(a.asname or a.name for a in node.names)
        out[rel] = {n for n in names if not n.startswith("_")}
    return out


def test_the_port_lacks_only_the_tpu_only_names():
    jax_names, port_names = _public_names(JAX_PKG), _public_names(PORT_PKG)
    missing = set()
    for rel, names in jax_names.items():
        prel = MODULE_MAP.get(rel, rel)
        assert prel in port_names, f"no counterpart of {rel}"
        for name in names:
            want = RENAMED.get((rel, name), name)
            if want not in port_names[prel]:
                missing.add((rel, name))
    assert missing == TPU_ONLY


def _levers(root: pathlib.Path):
    pattern = re.compile(r"environ\.get\(\s*\"(APTD_[A-Z0-9_]+)\"")
    return {m for p in root.rglob("*.py") for m in pattern.findall(p.read_text())}


def test_the_port_reads_the_jax_environment_levers():
    jax_levers = _levers(JAX_PKG)
    assert {"APTD_BINNED_MIN_BINS", "APTD_BINNED_CA", "APTD_BINNED_LCAP"} <= jax_levers
    assert jax_levers - _levers(PORT_PKG) == set(NOT_PORTED_LEVERS)


def test_package_reexports_are_the_module_functions():
    import ai_path_tracer_denoiser_tpu_torch as pkg
    from ai_path_tracer_denoiser_tpu_torch import app, ops, render, utils
    from ai_path_tracer_denoiser_tpu_torch.app import cli
    from ai_path_tracer_denoiser_tpu_torch.ops import bsdf, intersect, rng
    from ai_path_tracer_denoiser_tpu_torch.render import motion_blur
    from ai_path_tracer_denoiser_tpu_torch.utils import metrics, timers
    assert pkg.config.RenderOptions is RenderOptions
    assert app.main is cli.main
    assert ops.seeded_engine is ops.make_seeded_engine is rng.make_seeded_engine
    assert ops.triangle_intersect is intersect.triangle_intersect
    assert ops.scatter_ray is bsdf.scatter_ray and ops.schlick is bsdf.schlick
    assert render.generate_camera_rays is wavefront.generate_camera_rays
    assert render.advance_geoms is motion_blur.advance_geoms
    assert utils.psnr is metrics.psnr and utils.PerformanceTimer is timers.PerformanceTimer


def test_orbit_path_matches_jax(cornell_scene):
    """Five cameras of a pan whose theta and zoom leave their ranges (so
    both clamps act), against the JAX generator's."""
    cam = load_scene(str(REPO / "scenes" / "cornell_box.txt"), device="cpu").camera
    kw = dict(dphi=0.05, dtheta=0.9, dzoom=-4.0)
    got = list(camera.orbit_path(cam, 5, **kw))
    want = list(jcamera.orbit_path(cornell_scene.camera, 5, **kw))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        for field in ("position", "view", "up", "right"):
            np.testing.assert_allclose(getattr(g, field).numpy(), np.asarray(getattr(w, field)),
                                       rtol=1e-6, atol=1e-6)


def test_generate_camera_rays_matches_jax(cornell_scene_small):
    """(N, 3) primary rays, antialiased, every pixel and a subset of pixels.
    XLA:CPU's fused multiply-adds and rsqrt move the last bits (ROADMAP C,
    "Render"), so the bar is 1e-6."""
    base = load_scene(str(REPO / "scenes" / "cornell_box.txt"), device="cpu")
    c = base.camera
    cam = derive_camera((64, 64), 45.0, c.position.numpy(), c.look_at.numpy(), c.up.numpy())
    ids = np.random.default_rng(3).permutation(64 * 64)[:500]
    for pixel_ids in (None, ids):
        want = jwavefront.generate_camera_rays(
            cornell_scene_small.camera, 3, JRenderOptions(),
            None if pixel_ids is None else jnp.asarray(pixel_ids, jnp.uint32))
        got = wavefront.generate_camera_rays(
            cam, 3, RenderOptions(), None if pixel_ids is None else torch.from_numpy(pixel_ids))
        for g, w in zip(got, want):
            assert tuple(g.shape) == np.asarray(w).shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


def _run(code: str, **env):
    full = dict(os.environ, JAX_PLATFORMS="cpu", APTD_NO_COMPILE_CACHE="1", **env)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=full,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok"), proc.stdout[-2000:]


SOUP = """
import numpy as np
def soup(f, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-2, 2, (f, 1, 3))
    verts = (centers + rng.uniform(-0.3, 0.3, (f, 3, 3))).astype(np.float32)
    norms = rng.normal(size=(f, 3, 3)).astype(np.float32)
    norms /= np.linalg.norm(norms, axis=-1, keepdims=True)
    return verts, norms, rng.integers(0, 5, f).astype(np.int32)
"""


def test_levers_read_at_import():
    """APTD_BINNED_CA and APTD_BINNED_CB, read when the modules are imported,
    as the JAX package reads them.  APTD_BVH_CLUSTER is not read: the port
    still builds cluster 32, and the JAX package's cluster-16 hierarchy,
    carried across, is refused by its kernel wrappers."""
    _run(SOUP + """
import torch
from ai_path_tracer_denoiser_tpu.ops import bvh as jbvh
from ai_path_tracer_denoiser_tpu.render import mesh_binned as jbinned
from ai_path_tracer_denoiser_tpu_torch.ops import bvh
from ai_path_tracer_denoiser_tpu_torch.ops.vec3 import Vec3
from ai_path_tracer_denoiser_tpu_torch.render import mesh_binned, mesh_kernel_v2p
assert (bvh.CLUSTER, jbvh.CLUSTER) == (32, 16)
assert (mesh_binned.C_A, mesh_binned.C_B) == (jbinned.C_A, jbinned.C_B) == (3, 5)
tb, _ = bvh.build_mesh_bvh(*soup(300))
jb, _ = jbvh.build_mesh_bvh(*soup(300))
assert (tb.cluster, tb.n_clusters_real) == (32, -(-300 // 32))
carried = bvh.bvh_from_numpy(*(np.asarray(getattr(jb, name)) for name in
                               ("faces_packed", "cluster_bounds", "super_bounds",
                                "hyper_bounds")), jb.num_faces, jb.cluster)
assert carried.cluster == 16
z = torch.zeros(8)
for fn in (mesh_kernel_v2p.mesh_intersect_bvh_v2p, mesh_binned.mesh_intersect_binned):
    try:
        fn(carried, Vec3(z, z, z), Vec3(z, z, z))
    except ValueError as e:
        assert "cluster=16" in str(e), e
    else:
        raise AssertionError(fn)
print("ok")
""", APTD_BVH_CLUSTER="16", APTD_BINNED_CA="3", APTD_BINNED_CB="5")


def test_levers_read_at_each_call():
    """APTD_BINNED_MIN_BINS moves the router's threshold as in the JAX
    package; APTD_BINNED_LCAP / LCAPB set the binned pipeline's packing
    prefixes (its two subscription launches) and change no bit."""
    _run(SOUP + """
import os, types
import torch
from ai_path_tracer_denoiser_tpu.ops import intersect as jintersect
from ai_path_tracer_denoiser_tpu_torch.ops import bvh, intersect
from ai_path_tracer_denoiser_tpu_torch.ops.vec3 import Vec3
from ai_path_tracer_denoiser_tpu_torch.render import mesh_binned, mesh_kernel_v2p
from ai_path_tracer_denoiser_tpu_torch.utils.timers import totals

mesh = types.SimpleNamespace(bvh=types.SimpleNamespace(n_supers_real=2))
for thresh, want in (("2", "binned"), ("3", "v2p")):
    os.environ["APTD_BINNED_MIN_BINS"] = thresh
    assert intersect.resolve_mesh_impl(mesh) == jintersect.resolve_mesh_impl(mesh) == want

tb, _ = bvh.build_mesh_bvh(*soup(4000))
assert tb.n_supers_real > mesh_binned.C_A
rng = np.random.default_rng(1)
n = 4096
o = Vec3(*torch.from_numpy(rng.uniform(-4, 4, (3, n)).astype(np.float32)))
d = rng.normal(size=(3, n)).astype(np.float32)
d = Vec3(*torch.from_numpy(d / np.linalg.norm(d, axis=0, keepdims=True)))
tc = torch.full((n,), float("-inf"))
tc[::4] = float("inf")
sizes, orig = [], mesh_binned._phase1
mesh_binned._phase1 = lambda po, *a: (sizes.append(po.x.shape[0]), orig(po, *a))[1]
want = mesh_kernel_v2p.mesh_intersect_bvh_v2p_plain(tb, o, d, tc)
for lcap, lcapb, expect in ((None, None, [1024, 1024]), ("3072", "2048", [3072, 2048])):
    for key, val in (("APTD_BINNED_LCAP", lcap), ("APTD_BINNED_LCAPB", lcapb)):
        if val is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = val
    sizes.clear()
    fast = totals().get("binned.fast", 0)
    got = mesh_binned.mesh_intersect_binned(tb, o, d, tc)
    assert sizes == expect and totals()["binned.fast"] == fast + 1, sizes
    assert torch.equal(got[0], want[0]) and torch.equal(got[3], want[3])
print("ok")
""")
