"""The port's scene loading and cameras against the JAX package.

Every scene file with at most 64 mesh faces loads to the same arrays and
without a hierarchy; a larger mesh loads with one (held against the JAX
package's in tests/test_torch_bvh.py), moves with its scene and renders.
"""
import dataclasses
import math
import pathlib

import numpy as np
import pytest
import torch

from ai_path_tracer_denoiser_tpu.scene import load_scene as jax_load_scene
from ai_path_tracer_denoiser_tpu.scene import camera as jcamera
from ai_path_tracer_denoiser_tpu_torch.config import RenderOptions
from ai_path_tracer_denoiser_tpu_torch.render import render
from ai_path_tracer_denoiser_tpu_torch.scene import camera, load_scene

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parent.parent
SMALL_MESH = ("cornell_mesh_gem.txt", "cornell_mesh_icosahedron.txt",
              "cornell_timing_1.txt", "cornell_timing_2.txt")
ANALYTIC = tuple(p.name for p in sorted((REPO / "scenes").glob("*.txt"))
                 if "MESH" not in p.read_text().replace("MESH blocks", ""))


def _cam_arrays(cam):
    return {f: np.asarray(getattr(cam, f)) for f in
            ("position", "look_at", "view", "up", "right", "fov", "pixel_length")}


@pytest.mark.parametrize("name", ANALYTIC + SMALL_MESH)
def test_scene_loads_like_jax(name):
    path = str(REPO / "scenes" / name)
    js = jax_load_scene(path)
    ts = load_scene(path, device="cpu")
    assert ts.device.type == "cpu"
    assert (ts.iterations, ts.trace_depth, ts.image_name) == (
        js.iterations, js.trace_depth, js.image_name)
    assert ts.geoms.type_tuple == js.geoms.type_tuple
    for f in ("type", "material_id", "translation", "rotation", "scale", "vel",
              "transform", "inverse_transform", "inv_transpose"):
        np.testing.assert_array_equal(getattr(ts.geoms, f).numpy(),
                                      np.asarray(getattr(js.geoms, f)), err_msg=f)
    for f in ("color", "specular_color", "has_reflective", "has_refractive",
              "index_of_refraction", "emittance"):
        np.testing.assert_array_equal(getattr(ts.materials, f).numpy(),
                                      np.asarray(getattr(js.materials, f)), err_msg=f)
    assert ts.mesh.num_faces == js.mesh.num_faces <= 64
    assert ts.mesh.bvh is None and js.mesh.bvh is None
    for f in ("vertices", "normals", "material_id", "valid", "aabb_lb", "aabb_ub"):
        np.testing.assert_array_equal(getattr(ts.mesh, f).numpy(),
                                      np.asarray(getattr(js.mesh, f)), err_msg=f)
    assert ts.camera.resolution == js.camera.resolution
    for f, a in _cam_arrays(ts.camera).items():
        np.testing.assert_array_equal(a, _cam_arrays(js.camera)[f], err_msg=f)


def test_bvh_sized_mesh_loads_with_hierarchy_and_renders():
    scene = load_scene(str(REPO / "scenes" / "cornell_mesh_icosphere.txt"),
                       device="cpu")
    bvh = scene.mesh.bvh
    assert scene.mesh.num_faces == 320 and bvh is not None
    assert (bvh.num_faces, bvh.n_clusters_real, bvh.n_supers_real,
            bvh.n_hypers_real) == (320, 10, 2, 1)
    assert bvh.faces_packed.shape == (512, 19)
    moved = scene.to("cpu")
    assert moved.mesh.bvh is not scene.mesh.bvh
    assert torch.equal(moved.mesh.bvh.super_bounds, bvh.super_bounds)
    c = scene.camera
    scene = dataclasses.replace(scene, camera=camera.derive_camera(
        (8, 8), 45.0, c.position.numpy(), c.look_at.numpy(), c.up.numpy()))
    image, gbuffer, state = render(scene, RenderOptions(), num_iterations=1)
    assert image.shape == (8, 8, 3) and torch.isfinite(gbuffer).all()
    assert state.iteration == 1 and (gbuffer[6] > 0).float().mean() > 0.5


@pytest.mark.parametrize("res", [(64, 64), (96, 48)])
def test_derive_and_orbit_camera(res):
    pos, look, up = (0.0, 5.0, 10.5), (0.0, 5.0, 0.0), (0.0, 1.0, 0.0)
    jc = jcamera.derive_camera(res, 45.0, pos, look, up)
    tc = camera.derive_camera(res, 45.0, pos, look, up)
    for f, a in _cam_arrays(tc).items():
        np.testing.assert_array_equal(a, _cam_arrays(jc)[f], err_msg=f)
    jp = jcamera.orbit_params_from_camera(jc)
    tp = camera.orbit_params_from_camera(tc)
    assert tp == jp
    for k in range(3):
        phi = jp[0] + 0.37 * k
        theta = min(jp[1] + 0.1 * k, math.pi - 1e-3)
        jo = jcamera.orbit_camera(jc, phi, theta, jp[2] * (1 + 0.1 * k))
        to = camera.orbit_camera(tc, phi, theta, jp[2] * (1 + 0.1 * k))
        for f, a in _cam_arrays(to).items():
            np.testing.assert_allclose(a, _cam_arrays(jo)[f], rtol=1e-6,
                                       atol=1e-6, err_msg=f)
