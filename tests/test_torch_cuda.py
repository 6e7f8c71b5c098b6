"""The port's CUDA kernels against their plain PyTorch versions.

The ``cuda``-marked tests need an NVIDIA GPU and skip elsewhere; this file
imports neither JAX nor the JAX package, so it also runs on a machine that
has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

The other tests check, on the CPU, that each wrapper takes its plain
version for CPU tensors without counting a launch.

Tolerances: the megakernel and its plain version do the same float32
operations in the same order (the kernel is built with -fmad=false), so
the G-buffer agrees to isclose(rtol 1e-5, atol 1e-5) on >= 99.9% of
pixels and the radiance to mean rel < 1e-3, PSNR >= 40 dB.  The conv
kernel sums the products in another order than the plain float32 matmuls:
float32 output within 1e-3 + 1e-3|p|, bfloat16 output within one bfloat16
rounding step (1e-2 + 1.6e-2|p|).  The three mesh kernels (BVH traversal,
bin subscription, pair intersection) are built with -fmad=false too and do
their plain versions' operations in order: every output equal bit for bit
(``torch.equal``, which takes -0.0 and +0.0 as equal).
"""
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from ai_path_tracer_denoiser_tpu_torch.config import RenderOptions
from ai_path_tracer_denoiser_tpu_torch.models import conv_kernel
from ai_path_tracer_denoiser_tpu_torch.ops.bvh import build_mesh_bvh
from ai_path_tracer_denoiser_tpu_torch.ops.vec3 import Vec3
from ai_path_tracer_denoiser_tpu_torch.render import (assemble_gbuffer, cuda_backend,
                                                      init_render_state, mesh_binned,
                                                      mesh_kernel_v2p, render)
from ai_path_tracer_denoiser_tpu_torch.scene import derive_camera, load_scene
from ai_path_tracer_denoiser_tpu_torch.utils.device import resolve_device

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parent.parent
RES = 64


def _scene(name, device, depth=8):
    scene = load_scene(str(REPO / "scenes" / name), device=device)
    c = scene.camera
    return dataclasses.replace(scene, trace_depth=depth, camera=derive_camera(
        (RES, RES), 45.0, c.position.numpy(), c.look_at.numpy(), c.up.numpy()))


def _conv_inputs(h, w, c, co, seed):
    r = np.random.default_rng(seed)
    x = torch.from_numpy(r.normal(size=(h, w, c)).astype(np.float32))
    wt = torch.from_numpy((r.normal(size=(3, 3, c, co))
                           * (2.0 / (9 * c)) ** 0.5).astype(np.float32))
    b = torch.from_numpy(r.normal(size=co).astype(np.float32) * 0.1)
    aff = {"s": torch.from_numpy(r.uniform(0.5, 2.0, co).astype(np.float32)),
           "t": torch.from_numpy(r.normal(size=co).astype(np.float32) * 0.1)}
    return x, wt, b, aff


def test_cpu_tensors_take_the_plain_versions():
    scene = _scene("cornell_box.txt", "cpu", depth=3)
    before = (cuda_backend.KERNEL.launches, conv_kernel.KERNEL.launches)
    state = cuda_backend.render_cuda(scene, RenderOptions(), 1)
    plain = cuda_backend.render_cuda_plain(scene, RenderOptions(), 1,
                                           init_render_state(scene))
    assert torch.equal(state.accum, plain.accum) and torch.equal(state.gbuf, plain.gbuf)
    x, wt, b, aff = _conv_inputs(8, 8, 5, 7, 0)
    y = conv_kernel.conv3x3_act_chw(x.bfloat16(), wt, b, 0.1, aff)
    assert y.dtype == torch.bfloat16 and y.shape == (8, 8, 7)
    torch.testing.assert_close(
        y, conv_kernel.conv3x3_act_plain(x.bfloat16(), wt, b, 0.1, aff))
    assert (cuda_backend.KERNEL.launches, conv_kernel.KERNEL.launches) == before


def _soup_bvh(n_faces, seed):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-3, 3, (n_faces, 1, 3)).repeat(3, axis=1).astype(np.float32)
    verts = base + rng.uniform(-0.4, 0.4, (n_faces, 3, 3)).astype(np.float32)
    normals = rng.normal(size=(n_faces, 3, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    return build_mesh_bvh(verts, normals, rng.integers(0, 5, n_faces).astype(np.int32))[0]


def _soup_rays(n, seed, bounds, device):
    """Rays with a cull distance each (some -inf, some +inf), among them
    0 * inf cases: zero direction components with the origin on a box face."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-6, 6, (3, n)).astype(np.float32)
    d = rng.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    d[0, ::17] = 0.0
    o[0, ::17] = float(bounds[0, 0])
    d[1, 1::29] = 0.0
    o[1, 1::29] = float(bounds[0, 4])
    tc = rng.uniform(0.5, 25.0, n).astype(np.float32)
    tc[::7] = -np.inf
    tc[3::11] = np.inf
    vec = lambda a: Vec3(*(torch.from_numpy(np.ascontiguousarray(c)).to(device) for c in a))
    return vec(o), vec(d), torch.from_numpy(tc).to(device)


def _all_equal(got, want):
    flat = lambda r: (r[0], *r[1], *r[2], r[3])
    return all(torch.equal(a, b) for a, b in zip(flat(got), flat(want)))


def test_mesh_wrappers_take_the_plain_versions_on_cpu():
    bvh = _soup_bvh(2048, 1)
    o, d, tc = _soup_rays(1024, 2, bvh.super_bounds, "cpu")
    kernels = (mesh_kernel_v2p.KERNEL, mesh_binned.PHASE1_KERNEL, mesh_binned.PAIR_KERNEL)
    before = [k.launches for k in kernels]
    got = mesh_kernel_v2p.mesh_intersect_bvh_v2p(bvh, o, d, tc)
    assert _all_equal(got, mesh_kernel_v2p.mesh_intersect_bvh_v2p_plain(bvh, o, d, tc))
    assert _all_equal(mesh_binned.mesh_intersect_binned(bvh, o, d, tc), got)
    assert [k.launches for k in kernels] == before
    with pytest.raises(ValueError, match="ray plane"):
        mesh_kernel_v2p.ray_planes(o, d, tc[:-1])
    with pytest.raises(ValueError, match="hierarchy table"):
        mesh_kernel_v2p.table_ptr(bvh.faces_packed[:, :18], 19, tc.device)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(None)
    assert resolve_device("cpu").type == "cpu"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cornell_box.txt", "cornell_mesh_icosahedron.txt"])
def test_megakernel_matches_plain_on_card(cuda_device, name):
    scene = _scene(name, cuda_device)
    opts = RenderOptions()
    plain = cuda_backend.render_cuda_plain(scene, opts, 2, init_render_state(scene))
    launches = cuda_backend.KERNEL.launches
    got = cuda_backend.render_cuda(scene, opts, 2)
    torch.cuda.synchronize()
    assert cuda_backend.KERNEL.launches == launches + 1
    gp = assemble_gbuffer(plain, (RES, RES), opts).cpu().numpy()
    gk = assemble_gbuffer(got, (RES, RES), opts).cpu().numpy()
    ok = np.isclose(gk[3:], gp[3:], rtol=1e-5, atol=1e-5).all(axis=0)
    assert ok.mean() >= 0.999, ok.mean()
    rel = abs(gk[:3].mean() - gp[:3].mean()) / gp[:3].mean()
    psnr = 10 * np.log10(max(gp[:3].max(), 1.0) ** 2
                         / max(float(((gk[:3] - gp[:3]) ** 2).mean()), 1e-30))
    assert rel < 1e-3 and psnr >= 40.0, (rel, psnr)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,c,co,affine", [(25, 25, 202, 101, False),
                                             (50, 50, 76, 101, True),
                                             (64, 48, 10, 32, False),
                                             (32, 32, 64, 3, False)])
def test_conv_kernel_matches_plain_on_card(cuda_device, h, w, c, co, affine):
    x, wt, b, aff = _conv_inputs(h, w, c, co, seed=c)
    xs = x.to(cuda_device, torch.bfloat16)
    ws = wt.to(cuda_device, torch.bfloat16)
    bs = b.to(cuda_device)
    affs = {k: v.to(cuda_device) for k, v in aff.items()} if affine else None
    for out_dtype, rtol, atol in (("float32", 1e-3, 1e-3), (None, 1.6e-2, 1e-2)):
        launches = conv_kernel.KERNEL.launches
        got = conv_kernel.conv3x3_act_chw(xs, ws, bs, 0.1, affs, out_dtype)
        want = conv_kernel.conv3x3_act_plain(xs, ws, bs, 0.1, affs, out_dtype)
        torch.cuda.synchronize()
        assert conv_kernel.KERNEL.launches == launches + 1
        assert got.dtype == want.dtype and got.shape == (h, w, co)
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(), rtol=rtol, atol=atol)
    with pytest.raises(ValueError):
        conv_kernel.conv3x3_act_chw(xs.float(), ws, bs, 0.1)


@pytest.mark.cuda
@pytest.mark.parametrize("n_faces", [300, 5000])
def test_mesh_kernels_match_plain_on_card(cuda_device, n_faces):
    bvh = _soup_bvh(n_faces, n_faces).to(cuda_device)
    o, d, tc = _soup_rays(8192, 3, bvh.super_bounds.cpu().numpy(), cuda_device)
    kb = bvh.n_supers_real
    launches = mesh_kernel_v2p.KERNEL.launches
    got = mesh_kernel_v2p.mesh_intersect_bvh_v2p(bvh, o, d, tc)
    torch.cuda.synchronize()
    assert mesh_kernel_v2p.KERNEL.launches == launches + 1
    want = mesh_kernel_v2p.mesh_intersect_bvh_v2p_plain(bvh, o, d, tc)
    assert _all_equal(got, want) and torch.isfinite(want[0]).sum() > 0
    for skip, c_out in ((0, min(12, kb)), (2, 3)):
        launches = mesh_binned.PHASE1_KERNEL.launches
        slots, counts = mesh_binned._phase1(o, d, tc, bvh.super_bounds, kb, skip, c_out)
        torch.cuda.synchronize()
        assert mesh_binned.PHASE1_KERNEL.launches == launches + 1
        p_slots, p_counts = mesh_binned._phase1_plain(o, d, tc, bvh.super_bounds, kb,
                                                      skip, c_out)
        assert torch.equal(slots, p_slots) and torch.equal(counts, p_counts)
    slots, _ = mesh_binned._phase1(o, d, tc, bvh.super_bounds, kb, 0, min(12, kb))
    key = slots.T.reshape(-1)
    perm = torch.sort(key, stable=True).indices
    rep = lambda c: c[:, None].expand(-1, slots.shape[0]).reshape(-1)[perm].contiguous()
    po, pd, key = Vec3(*map(rep, o)), Vec3(*map(rep, d)), key[perm].contiguous()
    launches = mesh_binned.PAIR_KERNEL.launches
    t_k, f_k = mesh_binned._pair_call(po, pd, key, bvh.faces_packed, kb)
    torch.cuda.synchronize()
    assert mesh_binned.PAIR_KERNEL.launches == launches + 1
    t_p, f_p = mesh_binned._pair_plain(po, pd, key, bvh.faces_packed, kb)
    assert torch.equal(t_k, t_p) and torch.equal(f_k, f_p) and (f_p >= 0).sum() > 0
    for caps in (dict(lcap=8192, lcapb=8192), dict(lcap=64, lcapb=64)):
        assert _all_equal(mesh_binned.mesh_intersect_binned(bvh, o, d, tc, **caps), want)


@pytest.mark.cuda
def test_mesh_scene_renders_through_the_kernels_on_card(cuda_device):
    scene = _scene("cornell_mesh_torus.txt", cuda_device, depth=4)
    want = render(scene, RenderOptions(mesh_bvh=False), num_iterations=2)[1]
    for impl, kernel in (("v2p", mesh_kernel_v2p.KERNEL), ("binned", mesh_binned.PAIR_KERNEL)):
        launches = kernel.launches
        got = render(scene, RenderOptions(mesh_kernel_impl=impl), num_iterations=2)[1]
        torch.cuda.synchronize()
        assert kernel.launches > launches
        assert torch.equal(got, want)
