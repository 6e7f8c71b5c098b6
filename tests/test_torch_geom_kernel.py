"""The wavefront's analytic-geom query: the route rule, its counters, and
the geom kernel K10 (csrc/geom_intersect.cu) against its plain version.

``intersect_geoms_v`` launches K10 for rays on the card unless a gradient
has to reach the geoms' matrices or the rays; CPU rays and differentiable
renders take ``intersect_geoms_plain``.  The CPU tests hold the rule
(``geoms_route``, which takes the device and the requires-grad flags, so
that the card's case is tested here too), the counters ``geoms.kernel`` /
``geoms.plain`` and the refusal of CPU tensors by the kernel's wrapper.

The ``cuda``-marked tests need an NVIDIA GPU and skip elsewhere.  K10 is
built with -fmad=false and does its plain version's float32 operations in
order, so all five outputs are held equal to it bit for bit (float planes
compared as int32 bits, so a -0.0 must stay -0.0).  This file imports
neither JAX nor the JAX package, so on the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_geom_kernel.py -q
"""
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from ai_path_tracer_denoiser_tpu_torch.config import RenderOptions
from ai_path_tracer_denoiser_tpu_torch.ops import intersect as tintersect
from ai_path_tracer_denoiser_tpu_torch.ops.vec3 import Vec3
from ai_path_tracer_denoiser_tpu_torch.render import render_gbuffer_frame, wavefront
from ai_path_tracer_denoiser_tpu_torch.scene import derive_camera, load_scene
from ai_path_tracer_denoiser_tpu_torch.scene.structs import CUBE, SPHERE, Geoms, make_geoms
from ai_path_tracer_denoiser_tpu_torch.utils import timers

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parent.parent
RES = 64
KERNEL = tintersect.GEOM_KERNEL


@pytest.fixture(autouse=True)
def fresh_registry():
    timers.reset()
    yield
    timers.reset()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    return torch.device("cuda")


def _scene(name, device, depth=8, res=RES):
    scene = load_scene(str(REPO / "scenes" / name), device=device)
    c = scene.camera
    return dataclasses.replace(scene, trace_depth=depth, camera=derive_camera(
        (res, res), 45.0, c.position.numpy(), c.look_at.numpy(), c.up.numpy()))


def _camera_rays(scene):
    n = scene.camera.resolution[0] * scene.camera.resolution[1]
    ids = torch.arange(n, dtype=torch.int64, device=scene.device)
    return wavefront.generate_camera_rays_v(scene.camera, 1, RenderOptions(), ids)


def _hard_rays(device, n=4096, seed=2**31 + 11):
    """Rays over the cornell room: random origins and directions, with
    axis-parallel directions (zero components: IEEE inf in the slab
    test), zero and NaN directions, and origins inside the light's box and
    the sphere."""
    r = np.random.default_rng(seed)
    o = r.uniform((-6, -1, -6), (6, 11, 11), (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    k = n // 8
    d[np.arange(k), r.integers(0, 3, k)] = 0.0             # one axis zeroed
    d[k:2 * k, :2] = 0.0                                   # along z only
    d[2 * k:2 * k + 16] = 0.0                              # no direction
    d[2 * k + 16 + np.arange(16), r.integers(0, 3, 16)] = np.nan
    o[3 * k:4 * k] = (0.0, 10.0, 0.0) + r.uniform(-0.1, 0.1, (k, 3))   # in the light
    o[4 * k:5 * k] = (-1.0, 4.0, -1.0) + r.uniform(-0.5, 0.5, (k, 3))  # in the sphere
    o[5 * k:5 * k + 8] = (-1.0, 4.0, -1.0)                # at its centre
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return (Vec3(to(o[:, 0]), to(o[:, 1]), to(o[:, 2])),
            Vec3(to(d[:, 0]), to(d[:, 1]), to(d[:, 2])))


def _random_geoms(n, seed=5):
    r = np.random.default_rng(seed)
    return make_geoms([{"type": int(r.integers(0, 2)), "material_id": k % 7,
                        "translation": r.uniform((-4, 0, -4), (4, 10, 4)).tolist(),
                        "rotation": r.uniform(0, 90, 3).tolist(),
                        "scale": r.uniform(0.2, 2.0, 3).tolist()} for k in range(n)])


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _all_bits_equal(got, want):
    flat = lambda r: [r[0], *r[1], *r[2], r[3], r[4]]       # noqa: E731
    return all(a.shape == b.shape and a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))
               for a, b in zip(flat(got), flat(want)))


# ----------------------------------------------------------------- CPU --

GRAD_FLAGS = 9     # three matrices, six ray planes


@pytest.mark.parametrize("device,grad_enabled,requires,route", [
    ("cpu", False, [False] * GRAD_FLAGS, "plain"),
    (torch.device("cpu"), True, [True] * GRAD_FLAGS, "plain"),
    ("cuda", True, [False] * GRAD_FLAGS, "kernel"),
    (torch.device("cuda", 0), False, [False] * GRAD_FLAGS, "kernel"),
    ("cuda", False, [True] * GRAD_FLAGS, "kernel"),        # grad mode off: nothing to reach
    ("cuda", True, [True] + [False] * (GRAD_FLAGS - 1), "plain"),    # a matrix
    ("cuda:1", True, [False] * (GRAD_FLAGS - 1) + [True], "plain"),  # a ray plane
])
def test_route_rule(device, grad_enabled, requires, route):
    assert tintersect.geoms_route(device, grad_enabled, requires) == route


def test_the_route_is_asked_with_the_grad_mode_and_every_flag(monkeypatch):
    """``intersect_geoms_v`` hands ``geoms_route`` the rays' device, the grad
    mode and the requires-grad flags of the three matrices and six ray
    planes: a render whose matrices need a gradient would take the plain
    version on the card as well."""
    asked = []
    rule = tintersect.geoms_route
    monkeypatch.setattr(tintersect, "geoms_route",
                        lambda *a: (asked.append(a), rule(*a))[1])
    scene = _scene("cornell_box.txt", "cpu", res=8)
    o, d = _camera_rays(scene)
    moved = dataclasses.replace(scene.geoms,
                                transform=scene.geoms.transform.clone().requires_grad_(True))
    t, *_ = tintersect.intersect_geoms_v(moved, o, d)
    assert t.requires_grad
    with torch.no_grad():
        tintersect.intersect_geoms_v(moved, o, d)
    tintersect.intersect_geoms_v(scene.geoms, o, Vec3(*(c.requires_grad_(True) for c in d)))
    (dev0, on0, flags0), (_, on1, flags1), (_, on2, flags2) = asked
    assert dev0 == torch.device("cpu") and (on0, on1, on2) == (True, False, True)
    assert list(flags0) == [True] + [False] * 8 and list(flags1) == list(flags0)
    assert list(flags2) == [False] * 6 + [True] * 3
    assert [rule("cuda", on, f) for on, f in ((on0, flags0), (on1, flags1), (on2, flags2))] == [
        "plain", "kernel", "plain"]


def test_cpu_rays_take_the_plain_version_counted_once_per_call():
    scene = _scene("cornell_mesh_statue.txt", "cpu")
    o, d = _camera_rays(scene)
    launches = KERNEL.launches
    with timers.span("render.frame"):
        got = tintersect.intersect_geoms_v(scene.geoms, o, d)
        tintersect.intersect_geoms_v(scene.geoms, o, d)
    assert _all_bits_equal(got, tintersect.intersect_geoms_plain(scene.geoms, o, d))
    (rec,) = timers.records("render.frame")
    assert rec["counts"] == {"geoms.plain": 2, "sync.geom_materials": 2}
    # the plain version called alone is not a query of the route: not counted
    assert timers.totals()["geoms.plain"] == 2 and "geoms.kernel" not in timers.totals()
    assert KERNEL.launches == launches


def test_the_kernel_wrapper_refuses_cpu_rays():
    scene = _scene("cornell_box.txt", "cpu", res=8)
    o, d = _camera_rays(scene)
    launches = KERNEL.launches
    with pytest.raises(ValueError, match="CUDA"):
        tintersect.intersect_geoms_kernel(scene.geoms, o, d)
    assert KERNEL.launches == launches


@pytest.mark.parametrize("name", ["cornell_mesh_statue.txt", "cornell_box.txt"])
def test_a_cpu_frame_counts_one_plain_query_per_bounce(name, monkeypatch):
    calls = []
    isect = wavefront.intersect_scene_v
    monkeypatch.setattr(wavefront, "intersect_scene_v",
                        lambda *a, **k: (calls.append(1), isect(*a, **k))[1])
    scene = _scene(name, "cpu", depth=3, res=16)
    render_gbuffer_frame(scene, RenderOptions(backend="xla", stream_compaction=False))
    (rec,) = timers.records("render.frame")
    assert len(calls) == 3
    assert rec["counts"]["geoms.plain"] == 3 and "geoms.kernel" not in rec["counts"]


# ---------------------------------------------------------------- card --

@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cornell_mesh_statue.txt", "cornell_box.txt"])
def test_k10_equals_plain_on_camera_and_hard_rays_on_card(cuda_device, name):
    scene = _scene(name, cuda_device)
    for o, d in (_camera_rays(scene), _hard_rays(cuda_device)):
        launches = KERNEL.launches
        got = tintersect.intersect_geoms_kernel(scene.geoms, o, d)
        torch.cuda.synchronize()
        assert KERNEL.launches == launches + 1
        want = tintersect.intersect_geoms_plain(scene.geoms, o, d)
        assert _all_bits_equal(got, want)
        hit = torch.isfinite(want[0])
        assert 0 < int(hit.sum()) <= hit.numel()


@pytest.mark.cuda
def test_k10_ties_go_to_the_first_geom_on_card(cuda_device):
    """The cornell geoms twice over, the copies with other material ids:
    every hit is a tie, which the first copy wins."""
    g = _scene("cornell_box.txt", "cpu").geoms
    twice = Geoms(**{f.name: (torch.cat([getattr(g, f.name)] * 2) if f.name != "type_tuple"
                              else g.type_tuple * 2) for f in dataclasses.fields(g)})
    twice.material_id[g.count:] += 10
    twice = twice.to(cuda_device)
    o, d = _hard_rays(cuda_device)
    got = tintersect.intersect_geoms_kernel(twice, o, d)
    want = tintersect.intersect_geoms_plain(twice, o, d)
    assert _all_bits_equal(got, want)
    hit = torch.isfinite(got[0])
    assert bool(hit.any()) and bool((got[4][hit] < 10).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n_geoms", [0, 1, 63, 64, 65, 150])
def test_k10_any_number_of_geoms_on_card(cuda_device, n_geoms):
    """Zero geoms (every ray misses) and tables around and past the 64
    geoms a block stages at a time."""
    geoms = _random_geoms(n_geoms).to(cuda_device)
    if n_geoms:
        assert {SPHERE, CUBE} <= set(geoms.type_tuple) or n_geoms == 1
    o, d = _hard_rays(cuda_device, n=3000)
    got = tintersect.intersect_geoms_kernel(geoms, o, d)
    assert _all_bits_equal(got, tintersect.intersect_geoms_plain(geoms, o, d))
    if not n_geoms:
        assert bool(torch.isinf(got[0]).all()) and bool((got[4] == -1).all())
        assert not bool(got[3].any())


@pytest.mark.cuda
def test_k10_takes_strided_rays_and_keeps_their_shape_on_card(cuda_device):
    scene = _scene("cornell_box.txt", cuda_device)
    o, d = _hard_rays(cuda_device, n=2048)
    rows_o, rows_d = o.stack(), d.stack()                  # (N, 3): strided columns
    so, sd = Vec3.from_rows(rows_o), Vec3.from_rows(rows_d)
    assert not so.x.is_contiguous()
    got = tintersect.intersect_geoms_kernel(scene.geoms, so, sd)
    assert _all_bits_equal(got, tintersect.intersect_geoms_plain(scene.geoms, o, d))
    square = Vec3(*(c.view(32, 64) for c in o)), Vec3(*(c.view(32, 64) for c in d))
    t, p, n, out, mat = tintersect.intersect_geoms_kernel(scene.geoms, *square)
    assert t.shape == p.x.shape == n.z.shape == out.shape == mat.shape == (32, 64)
    assert torch.equal(_bits(t.reshape(-1)), _bits(got[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cornell_mesh_statue.txt", "crowded"])
def test_a_frame_on_the_kernel_route_equals_the_plain_route_on_card(cuda_device, name,
                                                                    monkeypatch, tmp_path):
    """A 64x64 frame of the plain wavefront (the statue: mesh over 64
    faces; the cornell box crowded past the megakernel's home) through K10
    and with the plain version forced: the G-buffer and radiance equal bit
    for bit, and K10 launched once per bounce."""
    if name == "crowded":
        from test_torch_render_k1 import crowded_cornell
        scene = _scene(crowded_cornell(tmp_path / "crowded.txt"), cuda_device)
    else:
        scene = _scene(name, cuda_device)
    opts = RenderOptions(stream_compaction=False)
    launches = KERNEL.launches
    _, gbuf_k, state_k = render_gbuffer_frame(scene, opts)
    (rec,) = timers.records("render.frame")
    assert rec["counts"]["geoms.kernel"] == scene.trace_depth
    assert "geoms.plain" not in rec["counts"] and "sync.geom_materials" not in rec["counts"]
    assert KERNEL.launches == launches + scene.trace_depth
    monkeypatch.setattr(tintersect, "geoms_route", lambda *a: "plain")
    _, gbuf_p, state_p = render_gbuffer_frame(scene, opts)
    assert timers.records("render.frame")[-1]["counts"]["geoms.plain"] == scene.trace_depth
    assert KERNEL.launches == launches + scene.trace_depth
    assert torch.equal(_bits(gbuf_k), _bits(gbuf_p))
    assert torch.equal(_bits(state_k.accum), _bits(state_p.accum))


@pytest.mark.cuda
def test_a_gradient_to_the_matrices_takes_the_plain_route_on_card(cuda_device):
    scene = _scene("cornell_box.txt", cuda_device, res=16)
    o, d = _camera_rays(scene)
    moved = dataclasses.replace(scene.geoms,
                                transform=scene.geoms.transform.clone().requires_grad_(True))
    launches = KERNEL.launches
    with timers.span("render.frame"):
        t, p, *_ = tintersect.intersect_geoms_v(moved, o, d)
        p.x.sum().backward()
    assert KERNEL.launches == launches
    assert timers.records("render.frame")[0]["counts"]["geoms.plain"] == 1
    assert moved.transform.grad is not None and bool(moved.transform.grad.abs().sum() > 0)
    with torch.no_grad():
        got = tintersect.intersect_geoms_v(moved, o, d)
    assert KERNEL.launches == launches + 1
    assert _all_bits_equal(got, tintersect.intersect_geoms_plain(scene.geoms, o, d))
