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
rounding step (1e-2 + 1.6e-2|p|).  The mesh kernels (the three BVH
traversals, bin subscription, pair intersection) and the probe's scalar
visit kernel are built with -fmad=false too and do their plain versions'
operations in order: every output equal bit for bit (``torch.equal``, which
takes -0.0 and +0.0 as equal), and the two tile traversals' visit counts
equal to their plain walks' as integers.  The probe's tensor-core visit kernel is held
to |t_k - t_p| <= 1e-5 |t_p| + 1e-5 and equal face ids on all but 10 of 1024
rays, its TF32 mode against the plain version with TF32-rounded operands
and its 3xTF32 mode against the float32 one (tensor-core summation order;
a comparison next to its threshold may fall the other way).
"""
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from ai_path_tracer_denoiser_tpu_torch.config import ModelOptions, RenderOptions, TrainOptions
from ai_path_tracer_denoiser_tpu_torch.models import conv_kernel, layers
from ai_path_tracer_denoiser_tpu_torch.ops import intersect as tintersect
from ai_path_tracer_denoiser_tpu_torch.ops.bvh import build_mesh_bvh
from ai_path_tracer_denoiser_tpu_torch.ops.vec3 import Vec3
from ai_path_tracer_denoiser_tpu_torch.render import (assemble_gbuffer, cuda_backend,
                                                      init_render_state, mesh_binned,
                                                      mesh_kernel, mesh_kernel_v2p,
                                                      mesh_kernel_v3, render)
from ai_path_tracer_denoiser_tpu_torch.scene import derive_camera, load_scene
from ai_path_tracer_denoiser_tpu_torch.tools import mm_feasibility
from ai_path_tracer_denoiser_tpu_torch.utils.device import resolve_device
from test_torch_render_k1 import crowded_cornell

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
    # the row-band conv and the conv's autograd: plain versions too, no launch
    rows_before = conv_kernel.ROWS_KERNEL.launches
    y = conv_kernel.conv3x3_act(x.bfloat16(), wt, b, 0.1, aff)
    assert torch.equal(y, conv_kernel.conv3x3_act_rows_plain(x.bfloat16(), wt, b, 0.1, aff))
    xs = x[None].clone().requires_grad_(True)
    ws = wt.clone().requires_grad_(True)
    out = layers.Conv3x3Function.apply(xs, ws)
    g = torch.ones_like(out)
    out.backward(g)
    dx, dw = conv_kernel.conv3x3_backward_plain(x[None], wt, g)
    torch.testing.assert_close(xs.grad, dx, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(ws.grad, dw, rtol=1e-4, atol=1e-4)
    assert (conv_kernel.KERNEL.launches, conv_kernel.ROWS_KERNEL.launches) == (before[1],
                                                                               rows_before)


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


def test_experiment_wrappers_take_the_plain_versions_on_cpu():
    bvh = _soup_bvh(700, 1)
    o, d, tc = _soup_rays(1024, 2, bvh.super_bounds, "cpu")
    rays, faces, coeffs = mm_feasibility.probe_inputs(1, "cpu")
    kernels = (mesh_kernel.KERNEL, mesh_kernel_v3.KERNEL, mm_feasibility.VPU_KERNEL,
               mm_feasibility.MMA_KERNEL)
    before = [k.launches for k in kernels]
    want = mesh_kernel_v2p.mesh_intersect_bvh_v2p_plain(bvh, o, d, tc)
    assert _all_equal(mesh_kernel.mesh_intersect_bvh(bvh, o, d, tc, lanes=256), want)
    assert _all_equal(mesh_kernel_v3.mesh_intersect_bvh_v3(bvh, o, d, tc), want)
    assert torch.equal(mm_feasibility.visit_vpu(rays, faces, 64),
                       mm_feasibility.visit_vpu_plain(rays, faces))
    assert torch.equal(mm_feasibility.visit_mma(rays, coeffs, 64, highest=True),
                       mm_feasibility.visit_mma_plain(rays, coeffs))
    assert [k.launches for k in kernels] == before


def test_entry_points_default_to_the_card(tmp_path):
    """Rendering, training and loading default to the card and raise where
    there is none; none of them drops to the CPU on its own."""
    from ai_path_tracer_denoiser_tpu_torch.app.cli import main
    from ai_path_tracer_denoiser_tpu_torch.models import train_state_from_numpy
    from ai_path_tracer_denoiser_tpu_torch.train import (init_train_state, load_checkpoint,
                                                         load_device_dataset, save_checkpoint)
    small = ModelOptions(widths=(4, 4, 4, 4, 4))
    cpu_state = init_train_state(torch.Generator().manual_seed(0), small, device="cpu")
    ckpt = save_checkpoint(str(tmp_path), cpu_state, 0)
    np.save(tmp_path / "0_0_0_0000.npy", np.zeros((8, 8, 10), np.float32))
    np.save(tmp_path / "gt_0_0_0_0000.npy", np.zeros((8, 8, 3), np.float32))

    class OneFrame:
        def __len__(self):
            return 1

        def path_of(self, index, gt=False):
            return str(tmp_path / ("gt_0_0_0_0000.npy" if gt else "0_0_0_0000.npy"))

        def window_start(self, index):
            return 0

    calls = {
        "resolve_device": lambda: resolve_device(None),
        "init_train_state": lambda: init_train_state(torch.Generator().manual_seed(0), small),
        "load_checkpoint": lambda: load_checkpoint(ckpt),
        "train_state_from_numpy": lambda: train_state_from_numpy(
            {"w": np.zeros(2, np.float32)}, {}, None, 0, 1e-3),
        "load_device_dataset": lambda: load_device_dataset(OneFrame())[0],
        "cli datagen": lambda: main(["datagen", str(REPO / "scenes" / "cornell_box.txt"),
                                     "--res", "32", "--frames", "1", "--movs", "1",
                                     "--gt-spp", "1", "--out-dir", str(tmp_path / "d")]),
        "cli train": lambda: main(["train", "--data-dir", str(tmp_path / "d"), "--model-dir",
                                   str(tmp_path / "m"), "--log-dir", str(tmp_path / "l")]),
        "cli eval": lambda: main(["eval", "--data-dir", str(tmp_path / "d"), "--model", ckpt]),
        "cli bench": lambda: main(["bench", str(REPO / "scenes" / "cornell_box.txt"),
                                   "--res", "32", "--iters", "1"]),
        "probe": lambda: mm_feasibility.main(["--visits", "64"]),
    }
    if torch.cuda.is_available():
        assert calls["resolve_device"]().type == "cuda"
        state = calls["init_train_state"]()
        assert state.params["enc1"]["conv1"]["w"].device.type == "cuda"
        assert calls["load_checkpoint"]().params["enc1"]["conv1"]["w"].device.type == "cuda"
        assert calls["load_device_dataset"]().device.type == "cuda"
    else:
        for name, call in calls.items():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()
    assert resolve_device("cpu").type == "cpu"
    assert TrainOptions().bf16_compute


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


def _k1_pair(scene, opts, niter, state=None, pixel_offset=0, **launch):
    """K1 and its one-pixel-per-thread witness on the same inputs: the two
    results' (accum, gbuf)."""
    out = []
    for kernel in (cuda_backend.KERNEL, cuda_backend.WITNESS):
        st = state if state is not None else init_render_state(scene, opts)
        acc, gbuf = st.accum.clone(), st.gbuf.clone()
        floats, ints = cuda_backend.pack_scene(scene)
        cuda_backend.launch_megakernel(
            floats, ints, cuda_backend.camera_row(scene), acc, gbuf,
            counts=(scene.geoms.count, scene.materials.count, scene.mesh.num_faces),
            resolution=scene.camera.resolution, depth=scene.trace_depth,
            flags=cuda_backend._flags(opts), pixel_offset=pixel_offset,
            start=st.iteration, niter=niter, rng_offset=st.rng_offset, kernel=kernel,
            **(launch if kernel is cuda_backend.KERNEL else {}))
        out.append((acc, gbuf))
    torch.cuda.synchronize()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("name,niter,culling,tile", [
    ("cornell_box.txt", 1, True, False), ("cornell_box.txt", 4, True, False),
    ("cornell_mesh_icosahedron.txt", 2, True, False),
    ("cornell_mesh_icosahedron.txt", 2, False, False),
    ("cornell_box.txt", 3, True, True)])
def test_k1_equals_its_witness_on_card(cuda_device, name, niter, culling, tile):
    """The persistent kernel gives the one-pixel-per-thread witness's bits:
    whole frames, a mesh with the AABB gate on and off, and a tile of 1,001
    pixels (no multiple of 32) at a pixel offset, past iteration 1."""
    scene = _scene(name, cuda_device)
    opts = RenderOptions(ray_culling=culling)
    state, offset = None, 0
    if tile:
        full = init_render_state(scene, opts)
        state = dataclasses.replace(full, accum=full.accum[:, :1001].contiguous() + 0.25,
                                    gbuf=full.gbuf[:, :1001].contiguous(), iteration=1,
                                    rng_offset=7)
        offset = 1517
    (acc, gbuf), (w_acc, w_gbuf) = _k1_pair(scene, opts, niter, state, offset)
    assert torch.equal(acc, w_acc) and torch.equal(gbuf, w_gbuf)
    assert bool((acc > 0).any()) and bool((gbuf != 0).any()) == (not tile)


@pytest.mark.cuda
@pytest.mark.parametrize("threads,blocks_per_sm,chunk", [(32, 1, 1), (256, 0, 7),
                                                         (64, 2, 1000)])
def test_k1_launch_shapes_equal_the_witness_on_card(cuda_device, threads, blocks_per_sm,
                                                    chunk):
    scene = _scene("cornell_box.txt", cuda_device)
    (acc, gbuf), (w_acc, w_gbuf) = _k1_pair(scene, RenderOptions(), 2, threads=threads,
                                            blocks_per_sm=blocks_per_sm, chunk=chunk)
    assert torch.equal(acc, w_acc) and torch.equal(gbuf, w_gbuf)


@pytest.mark.cuda
def test_k1_calls_on_two_streams_equal_the_witness_on_card(cuda_device):
    scenes = [_scene("cornell_box.txt", cuda_device),
              _scene("cornell_mesh_icosahedron.txt", cuda_device)]
    opts = RenderOptions()
    want = [cuda_backend.render_cuda(sc, opts, 2, kernel=cuda_backend.WITNESS) for sc in scenes]
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    for _ in range(3):
        got_main = cuda_backend.render_cuda(scenes[0], opts, 2)
        with torch.cuda.stream(side):
            got_side = cuda_backend.render_cuda(scenes[1], opts, 2)
        torch.cuda.synchronize(cuda_device)
        for got, ref in ((got_main, want[0]), (got_side, want[1])):
            assert torch.equal(got.accum, ref.accum) and torch.equal(got.gbuf, ref.gbuf)


@pytest.mark.cuda
def test_k1_four_tiles_equal_the_frame_on_card(cuda_device):
    """The per-rank render of parallel/render_shard.py on one card: cornell in
    4 tiles through K1 at pixel offsets 0, N/4, N/2, 3N/4, concatenated, is
    the whole frame's render bit for bit."""
    from ai_path_tracer_denoiser_tpu_torch.parallel.render_shard import render_tile
    scene, opts = _scene("cornell_box.txt", cuda_device), RenderOptions()
    whole = cuda_backend.render_cuda(scene, opts, 2)
    before = cuda_backend.KERNEL.launches
    tiles = [render_tile(scene, opts, 2, i, 4) for i in range(4)]
    assert cuda_backend.KERNEL.launches - before == 4
    assert torch.equal(torch.cat([t.accum for t in tiles], 1), whole.accum)
    assert torch.equal(torch.cat([t.gbuf for t in tiles], 1), whole.gbuf)


@pytest.mark.cuda
def test_k1_counts_the_plain_segments_on_card(cuda_device):
    """The kernel's own count of segments traced is the plain bounce loop's
    (within 0.1%: a near-tie hit may end one path a bounce apart), and its
    lane-steps are at least the segments."""
    scene = _scene("cornell_box.txt", cuda_device)
    opts = RenderOptions()
    stats = torch.zeros(2, dtype=torch.int64, device=cuda_device)
    _k1_pair(scene, opts, 2, stats=stats)
    lane_steps, segments = stats.tolist()
    plain = int(cuda_backend.path_segments(scene, opts, 2).sum())
    assert abs(segments - plain) <= 1e-3 * plain
    assert segments <= lane_steps and lane_steps % 32 == 0


@pytest.mark.cuda
def test_launch_megakernel_raises_on_wrong_inputs_on_card(cuda_device):
    scene = _scene("cornell_box.txt", cuda_device)
    opts = RenderOptions()
    floats, ints = cuda_backend.pack_scene(scene)
    n = RES * RES
    good = dict(floats=floats, ints=ints, cam_row=cuda_backend.camera_row(scene),
                acc=torch.zeros((3, n), device=cuda_device),
                gbuf=torch.zeros((7, n), device=cuda_device))
    kw = dict(counts=(scene.geoms.count, scene.materials.count, scene.mesh.num_faces),
              resolution=scene.camera.resolution, depth=scene.trace_depth,
              flags=cuda_backend._flags(opts))
    cuda_backend.launch_megakernel(**good, **kw)
    bad = [("acc", torch.zeros((3, n), device=cuda_device, dtype=torch.float64)),
           ("acc", torch.zeros((4, n), device=cuda_device)),
           ("acc", torch.zeros((3, n))),
           ("gbuf", torch.zeros((7, n - 1), device=cuda_device)),
           ("gbuf", torch.zeros((n, 7), device=cuda_device).T),
           ("floats", floats[:-1]), ("floats", floats.cpu()), ("ints", ints.float()),
           ("cam_row", good["cam_row"][:13]), ("cam_row", good["cam_row"].astype(np.float64))]
    launches = cuda_backend.KERNEL.launches
    for name, value in bad:
        with pytest.raises(ValueError):
            cuda_backend.launch_megakernel(**{**good, name: value}, **kw)
    for extra in (dict(stats=torch.zeros(2, dtype=torch.int32, device=cuda_device)),
                  dict(pixel_offset=1), dict(niter=-1), dict(threads=48),
                  dict(counts=(scene.geoms.count + 1, scene.materials.count, 0))):
        with pytest.raises(ValueError):
            cuda_backend.launch_megakernel(**good, **{**kw, **extra})
    assert cuda_backend.KERNEL.launches == launches


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,c,co,affine", [(0, 25, 25, 202, 101, False),
                                               (0, 50, 50, 76, 101, True),
                                               (0, 64, 48, 10, 32, False),
                                               (0, 32, 32, 64, 3, False),
                                               (0, 37, 53, 43, 57, True),
                                               (0, 25, 25, 101, 202, False),
                                               (0, 800, 64, 64, 3, True),
                                               (4, 50, 50, 101, 202, True),
                                               (4, 16, 16, 3, 3, False)])
def test_conv_kernel_matches_plain_on_card(cuda_device, n, h, w, c, co, affine):
    """bfloat16 input through the tile kernel: unbatched and a batch of 4;
    odd and aligned channel counts, a width that is no multiple of the
    pixel tile, Co = 202 (the input gradient's widest) and Co = Cin = 3."""
    x, wt, b, aff = _conv_inputs(h, w, c, co, seed=c)
    if n:
        x = torch.stack([x.roll(i, 0) for i in range(n)])
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
        assert got.dtype == want.dtype and got.shape == (*x.shape[:-1], co)
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(), rtol=rtol, atol=atol)
    # the card packs the weights as pack_weights_sm90 lays them out
    n_cols = conv_kernel.conv_plan(max(n, 1), h, w, co).n_cols
    assert torch.equal(conv_kernel._packed_weights(ws.clone(), torch.bfloat16, ws.device, n_cols),
                       conv_kernel.pack_weights_sm90(ws, n_cols))
    # an input that does not start on a 16-byte boundary gives the same result
    xo = torch.empty(xs.numel() + 1, dtype=xs.dtype, device=cuda_device)[1:].view_as(xs)
    xo.copy_(xs)
    assert torch.equal(conv_kernel.conv3x3_act_chw(xo, ws, bs, 0.1, affs), got)
    with pytest.raises(ValueError):
        conv_kernel.conv3x3_act_chw(xs.half(), ws, bs, 0.1)


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,c,co,affine", [(0, 25, 25, 202, 101, False),
                                               (0, 50, 50, 101, 202, True),
                                               (0, 132, 130, 10, 32, True),
                                               (0, 200, 160, 64, 32, False),
                                               (0, 37, 53, 43, 57, True),
                                               (0, 800, 64, 64, 3, True),
                                               (0, 64, 64, 3, 3, False),
                                               (4, 50, 50, 57, 76, True),
                                               (3, 136, 136, 86, 32, False)])
def test_row_band_kernel_matches_plain_on_card(cuda_device, n, h, w, c, co, affine):
    """bfloat16 input through the row-band kernel, on the image and on the
    zero-bordered layout: odd and aligned channel counts, Co = 202, widths
    that are no multiple of the 64-pixel segment, 1-, 2- and 4-row bands, a
    batch; its weights packed on the card as pack_weights_sm90 lays them
    out."""
    x, wt, b, aff = _conv_inputs(h, w, c, co, seed=c + co)
    if n:
        x = torch.stack([x.roll(i, 0) for i in range(n)])
    xs = x.to(cuda_device, torch.bfloat16)
    ws = wt.to(cuda_device, torch.bfloat16)
    bs = b.to(cuda_device)
    affs = {k: v.to(cuda_device) for k, v in aff.items()} if affine else None
    want = conv_kernel.conv3x3_act_rows_plain(xs, ws, bs, 0.1, affs)
    launches = (conv_kernel.KERNEL.launches, conv_kernel.ROWS_KERNEL.launches)
    got = conv_kernel.conv3x3_act(xs, ws, bs, 0.1, affs)
    padded = conv_kernel.conv3x3_act(conv_kernel.conv_input_pad(xs).contiguous(), ws, bs, 0.1,
                                     affs, pre_padded=True, width=w)
    torch.cuda.synchronize()
    assert (conv_kernel.KERNEL.launches, conv_kernel.ROWS_KERNEL.launches) == (
        launches[0], launches[1] + 2)
    for y in (got, padded):
        assert y.dtype == torch.bfloat16 and y.shape == want.shape
        np.testing.assert_allclose(y.float().cpu().numpy(), want.float().cpu().numpy(),
                                   rtol=1.6e-2, atol=1e-2)
    n_cols = conv_kernel.rows_plan(max(n, 1), h, w, c, co).n_cols
    assert torch.equal(conv_kernel._packed_weights(ws.clone(), torch.bfloat16, ws.device, n_cols),
                       conv_kernel.pack_weights_sm90(ws, n_cols))
    # an input that does not start on a 16-byte boundary gives the same result
    xo = torch.empty(xs.numel() + 1, dtype=xs.dtype, device=cuda_device)[1:].view_as(xs)
    xo.copy_(xs)
    assert torch.equal(conv_kernel.conv3x3_act(xo, ws, bs, 0.1, affs), got)


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


def _bin_faces(n_bins, seed, tie_every=0):
    """A pair kernel's face table of ``n_bins`` bins (19 columns; only the
    vertices matter): each bin a cluster of 256 small triangles.  With
    ``tie_every`` (a divisor of 256), face r + 1 of a bin repeats face r for
    every r = 0 mod tie_every, so hits on it tie and the lower face must
    win."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-3, 3, (n_bins, 1, 1, 3))
    v = centers + rng.uniform(-0.6, 0.6, (n_bins, 256, 3, 3))
    if tie_every:
        v[:, 1::tie_every] = v[:, 0::tie_every]
    rows = np.zeros((n_bins * 256, 19), np.float32)
    rows[:, :9] = v.reshape(-1, 9)
    rows[:, 18] = rng.integers(0, 5, len(rows))
    return rows


def _pairs_aimed(rows, keys, seed, device):
    """Pair planes: each pair's ray aims, from outside, at a face of its bin
    (dead keys at any face)."""
    rng = np.random.default_rng(seed)
    n = len(keys)
    bins = np.where(keys < len(rows) // 256, keys, 0)
    faces = rows[:, :9].reshape(-1, 3, 3)
    target = np.einsum("nc,ncx->xn", rng.dirichlet(np.ones(3), n),
                       faces[bins * 256 + rng.integers(0, 256, n)])
    u = rng.normal(size=(3, n))
    o = (target + 8.0 * u / np.linalg.norm(u, axis=0)).astype(np.float32)
    d = target - o
    d = (d / np.linalg.norm(d, axis=0)).astype(np.float32)
    vec = lambda a: Vec3(*(torch.from_numpy(np.ascontiguousarray(c)).to(device) for c in a))
    return vec(o), vec(d), torch.from_numpy(keys.astype(np.int32)).to(device)


def _k6_equals_plain(o, d, key, faces, kb):
    launches = mesh_binned.PAIR_KERNEL.launches
    got = mesh_binned._pair_call(o, d, key, faces, kb)
    torch.cuda.synchronize()
    assert mesh_binned.PAIR_KERNEL.launches == launches + (key.shape[0] > 0)
    want = mesh_binned._pair_plain(o, d, key, faces, kb)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["straddle", "ties", "ragged", "unsorted", "n0", "n1"])
def test_k6_pair_layouts_match_plain_on_card(cuda_device, layout):
    # blocks own 128 or 256 consecutive pairs: runs of 1-200 pairs put
    # several bins in one block, some bins get none, a dead-key tail starts
    # inside a block; "ties" repeats every fourth face; "ragged" ends a
    # pair count off any block size; "unsorted" shuffles the keys
    rng = np.random.default_rng(21)
    kb = 24
    rows = _bin_faces(kb + 1, 22, tie_every=4 if layout == "ties" else 0)
    runs = rng.integers(1, 201, kb) * (rng.uniform(size=kb) > 0.2)
    keys = np.concatenate([np.repeat(np.arange(kb), runs),
                           np.full(1000 + 77, mesh_binned._DEADKEY), [kb, -3]])
    if layout == "ragged":
        keys = keys[:5 * 256 + 37]
    elif layout == "unsorted":
        keys = rng.permutation(keys)
    elif layout in ("n0", "n1"):
        keys = keys[:int(layout[1])]
    o, d, key = _pairs_aimed(rows, keys, 23, cuda_device)
    faces = torch.from_numpy(rows).to(cuda_device)
    t, f = _k6_equals_plain(o, d, key, faces, kb)
    real = (key >= 0) & (key < kb)
    assert not (f[~real] >= 0).any()
    if layout not in ("n0", "n1"):
        assert int((f >= 0).sum()) > int(real.sum()) // 2
    if layout == "ties":
        won = f[f >= 0].cpu().numpy() % 4
        assert (won == 0).sum() > 0 and not (won == 1).any()


@pytest.mark.cuda
def test_k6_fast_reciprocal_is_ieee_on_card(cuda_device):
    # every float in [2^-23, 2^126): the kernel's reciprocal equals 1.0f / a
    assert mesh_binned.rcp_fast_mismatches(cuda_device) == 0


@pytest.mark.cuda
def test_k6_redoes_pairs_with_huge_determinants_on_card(cuda_device):
    # faces scaled by 1e19 to 1e20 about their first corner: a front face's
    # a = e1 . (d x e2) reaches 2^126 or overflows, where the fast
    # reciprocal does not apply and the pair is tested again
    kb = 4
    rows = _bin_faces(kb, 41)
    v = rows[:, :9].reshape(-1, 3, 3)
    big = np.arange(len(v)) % 5 == 2
    scale = np.array([1e19, 4e19, 1e20], np.float32)[np.arange(big.sum()) % 3]
    v[big] = v[big, :1] + scale[:, None, None] * (v[big] - v[big, :1])
    rows[:, :9] = v.reshape(-1, 9)
    keys = np.repeat(np.arange(kb), 300)
    o, d, key = _pairs_aimed(rows, keys, 42, cuda_device)
    faces = torch.from_numpy(rows).to(cuda_device)
    t, f = _k6_equals_plain(o, d, key, faces, kb)
    assert int((f >= 0).sum()) > 100


@pytest.mark.cuda
def test_k6_calls_on_two_streams_match_plain_on_card(cuda_device):
    kb = 16
    rows = _bin_faces(kb, 31)
    faces = torch.from_numpy(rows).to(cuda_device)
    rng = np.random.default_rng(32)
    tables = [_pairs_aimed(rows, np.sort(rng.integers(0, kb, m)), seed, cuda_device)
              for m, seed in ((20000, 33), (9000, 34))]
    want = [mesh_binned._pair_plain(*tb, faces, kb) for tb in tables]
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    for _ in range(3):
        got_main = mesh_binned._pair_call(*tables[0], faces, kb)
        with torch.cuda.stream(side):
            got_side = mesh_binned._pair_call(*tables[1], faces, kb)
        torch.cuda.synchronize(cuda_device)
        for got, ref in ((got_main, want[0]), (got_side, want[1])):
            assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def _k5_rays(n, seed, device):
    """Rays for K5 in warps of 32: whole warps dead (t_cull = -inf), warps
    that mix finite and infinite inverse direction components (+0, -0 and
    subnormal below 2**-128), subnormal components with a finite huge
    inverse (near 2**-126), origins on box planes, NaN cull distances."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-6, 6, (3, n)).astype(np.float32)
    d = rng.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    d[0, 5::37] = 0.0
    d[1, 6::41] = -0.0
    d[2, 7::43] = np.float32(1e-40)
    d[0, 8::47] = np.float32(-1.1e-38)
    o[0, 5::37] = 1.0
    tc = rng.uniform(0.5, 25.0, n).astype(np.float32)
    tc[3::11] = np.inf
    tc[9::53] = np.nan
    warp = np.arange(n) // 32
    tc[warp % 5 == 2] = -np.inf                   # all-dead warps
    tc[(warp % 5 == 4) & (np.arange(n) % 3 == 0)] = -np.inf
    vec = lambda a: Vec3(*(torch.from_numpy(np.ascontiguousarray(c)).to(device) for c in a))
    return vec(o), vec(d), torch.from_numpy(tc).to(device)


def _synthetic_bounds(kb, seed, device):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-5, 5, (kb, 3))
    h = rng.uniform(0.1, 1.5, (kb, 3))
    rows = np.zeros((kb, 8), np.float32)
    rows[:, 0:3], rows[:, 3:6] = c - h, c + h
    rows[::7, 0] = 1.0                            # box planes through origins
    return torch.from_numpy(rows).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("kb,skip,c_out", [(1100, 0, 20), (1100, 7, 1), (320, 12, 20),
                                           (40, 3, 1)])
def test_k5_synthetic_bounds_match_plain_on_card(cuda_device, kb, skip, c_out):
    # kb = 1100 needs two staging chunks of 1024 rows
    bounds = _synthetic_bounds(kb, kb + skip, cuda_device)
    o, d, tc = _k5_rays(8192 + 45, 5, cuda_device)
    launches = mesh_binned.PHASE1_KERNEL.launches
    slots, counts = mesh_binned._phase1(o, d, tc, bounds, kb, skip, c_out)
    torch.cuda.synchronize()
    assert mesh_binned.PHASE1_KERNEL.launches == launches + 1
    p_slots, p_counts = mesh_binned._phase1_plain(o, d, tc, bounds, kb, skip, c_out)
    assert torch.equal(slots, p_slots) and torch.equal(counts, p_counts)
    assert int(counts.max()) > skip and (slots != mesh_binned._DEADKEY).any()
    assert not counts[~(tc > float("-inf"))].any()
    # a row with a NaN bound: the chunk leaves the NaN-free branch, same result
    bounds[kb // 2, 1] = float("nan")
    slots, counts = mesh_binned._phase1(o, d, tc, bounds, kb, skip, c_out)
    p_slots, p_counts = mesh_binned._phase1_plain(o, d, tc, bounds, kb, skip, c_out)
    assert torch.equal(slots, p_slots) and torch.equal(counts, p_counts)


@pytest.mark.cuda
def test_k5_and_k6_skip_empty_calls_on_card(cuda_device):
    bounds = _synthetic_bounds(40, 1, cuda_device)
    o, d, tc = _k5_rays(0, 2, cuda_device)
    launches = mesh_binned.PHASE1_KERNEL.launches
    slots, counts = mesh_binned._phase1(o, d, tc, bounds, 40, 0, 12)
    assert slots.shape == (12, 0) and counts.shape == (0,)
    assert mesh_binned.PHASE1_KERNEL.launches == launches


def _warp_rays(faces, n_warps, live, seed, device):
    """Warps of 32 rays.  In each warp the first ``live`` lanes aim, from
    nearby origins outside the soup, at points inside the faces of one
    cluster (a cluster of its own per warp), so that exactly ``live`` lanes
    are live in that cluster; the other lanes are dead (t_cull = -inf).
    ``faces``: (F, 3, 3) numpy, F a multiple of 32."""
    rng = np.random.default_rng(seed)
    n = 32 * n_warps
    o = np.empty((3, n), np.float32)
    target = np.empty((3, n))
    clusters = rng.permutation(len(faces) // 32)[:n_warps]
    for wi, c in enumerate(clusters):
        u = rng.normal(size=3)
        start = 9.0 * u / np.linalg.norm(u)
        lanes = slice(32 * wi, 32 * wi + 32)
        o[:, lanes] = (start[:, None] + rng.uniform(-0.2, 0.2, (3, 32))).astype(np.float32)
        picked = faces[32 * c + rng.integers(0, 32, 32)]
        target[:, lanes] = np.einsum("nc,ncx->xn", rng.dirichlet(np.ones(3), 32), picked)
    d = target - o
    d = (d / np.linalg.norm(d, axis=0, keepdims=True)).astype(np.float32)
    tc = np.full(n, -np.inf, np.float32)
    lane = np.arange(n) % 32
    tc[lane < live] = np.inf
    tc[(lane < live) & (lane % 3 == 1)] = rng.uniform(5.0, 12.0, n)[(lane < live) & (lane % 3 == 1)]
    vec = lambda a: Vec3(*(torch.from_numpy(np.ascontiguousarray(c)).to(device) for c in a))
    return vec(o), vec(d), torch.from_numpy(tc).to(device)


def _k4_equals_plain(bvh, o, d, tc):
    launches = mesh_kernel_v2p.KERNEL.launches
    got = mesh_kernel_v2p.mesh_intersect_bvh_v2p(bvh, o, d, tc)
    torch.cuda.synchronize()
    assert mesh_kernel_v2p.KERNEL.launches == launches + 1
    want = mesh_kernel_v2p.mesh_intersect_bvh_v2p_plain(bvh, o, d, tc)
    assert _all_equal(got, want)
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("live", ["1", "K_THR-1", "K_THR", "32"])
def test_k4_both_cluster_branches_match_plain_on_card(cuda_device, live):
    # k = popc(live mask) < K_THR: ray by ray over the 32 lanes; else lane by ray
    k = {"1": 1, "K_THR-1": mesh_kernel_v2p.K_THR - 1, "K_THR": mesh_kernel_v2p.K_THR,
         "32": 32}[live]
    bvh = _soup_bvh(4096, 9)
    faces = bvh.faces_packed[:4096, :9].numpy().reshape(-1, 3, 3)
    bvh = bvh.to(cuda_device)
    o, d, tc = _warp_rays(faces, 96, k, 4, cuda_device)
    want = _k4_equals_plain(bvh, o, d, tc)
    hits = torch.isfinite(want[0]).reshape(-1, 32)
    assert int(hits[:, :k].sum()) > 96 * k // 2 and not hits[:, k:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("live", [1, 32])
def test_k4_exact_ties_match_plain_on_card(cuda_device, live):
    # 128 faces in file order.  Cluster 2 repeats faces 0..30 of cluster 0
    # with other materials (ties across clusters); in cluster 0 face 5
    # repeats face 4 with another material (a tie inside one cluster).
    rng = np.random.default_rng(7)

    def blob(center):
        c = np.asarray(center) + rng.uniform(-0.3, 0.3, (32, 1, 3))
        return (c + rng.uniform(-0.15, 0.15, (32, 3, 3))).astype(np.float32)

    tri = [blob((0, 0, 0)), blob((0.3, 0, 0)), None, blob((0, 0.4, 0))]
    tri[0][5] = tri[0][4]
    tri[2] = tri[0].copy()
    tri[2][31] = np.array([[-5, -5, -5], [5, 5, 5], [5, 5, 5.001]], np.float32)
    tri = np.concatenate(tri)
    nrm = rng.normal(size=(128, 3, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    mats = rng.integers(0, 5, 128).astype(np.int32)
    mats[5] = (mats[4] + 1) % 5
    mats[64:95] = (mats[0:31] + 1) % 5
    bvh = build_mesh_bvh(tri, nrm, mats, reorder=False)[0].to(cuda_device)
    # every warp aims at cluster 0 (faces 0..31 of the first "cluster")
    o, d, tc = _warp_rays(np.concatenate([tri[:32]] * 256), 256, live, 5, cuda_device)
    want = _k4_equals_plain(bvh, o, d, tc)
    v4 = [Vec3(*(torch.tensor(float(c), device=cuda_device) for c in tri[4, k]))
          for k in range(3)]
    t4, _, _, hit4 = tintersect._triangle_t(*v4, o, d)
    assert int((hit4 & (t4 == want[0])).sum()) > 0    # faces 4 and 5 tie and win
    rest = build_mesh_bvh(tri[32:], nrm[32:], mats[32:], reorder=False)[0].to(cuda_device)
    other = mesh_kernel_v2p.mesh_intersect_bvh_v2p_plain(rest, o, d, tc)
    tied = torch.isfinite(want[0]) & (other[0] == want[0]) & (other[3] != want[3])
    assert int(tied.sum()) > 0                        # the smaller cluster index won


@pytest.mark.cuda
def test_k4_dead_lanes_nan_slabs_and_ragged_tail_match_plain_on_card(cuda_device):
    bvh = _soup_bvh(5000, 5000).to(cuda_device)
    o, d, tc = _soup_rays(8192 + 37, 8, bvh.super_bounds.cpu().numpy(), cuda_device)
    tc[:32] = float("-inf")                           # a warp with no live lane
    tc[40:8192:13] = float("nan")                     # NaN cull distances: no hit
    want = _k4_equals_plain(bvh, o, d, tc)
    assert not torch.isfinite(want[0][:32]).any() and not torch.isfinite(want[0][40:8192:13]).any()
    zero_d = (o.x == float(bvh.super_bounds[0, 0])) & (d.x == 0)   # 0 * inf slab planes
    assert int(zero_d.sum()) > 100


@pytest.mark.cuda
def test_k4_calls_in_a_row_reset_the_batch_counter(cuda_device):
    bvh = _soup_bvh(5000, 11).to(cuda_device)
    bounds = bvh.super_bounds.cpu().numpy()
    first = _soup_rays(8192 + 37, 12, bounds, cuda_device)
    second = _soup_rays(20000, 13, bounds, cuda_device)
    for rays in (first, second, first):
        _k4_equals_plain(bvh, *rays)
    again = [mesh_kernel_v2p.mesh_intersect_bvh_v2p(bvh, *first) for _ in range(2)]
    assert _all_equal(*again)


@pytest.mark.cuda
def test_k4_calls_on_two_streams_match_plain_on_card(cuda_device):
    # each stream has a batch counter of its own, so calls may overlap
    bvh = _soup_bvh(5000, 14).to(cuda_device)
    bounds = bvh.super_bounds.cpu().numpy()
    rays = [_soup_rays(20000, seed, bounds, cuda_device) for seed in (15, 16)]
    want = [mesh_kernel_v2p.mesh_intersect_bvh_v2p_plain(bvh, *r) for r in rays]
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    for _ in range(3):
        got_main = mesh_kernel_v2p.mesh_intersect_bvh_v2p(bvh, *rays[0])
        with torch.cuda.stream(side):
            got_side = mesh_kernel_v2p.mesh_intersect_bvh_v2p(bvh, *rays[1])
        torch.cuda.synchronize(cuda_device)
        assert _all_equal(got_main, want[0]) and _all_equal(got_side, want[1])


def _edge_on_soup(n_faces, seed, device):
    """``_soup_bvh``'s soup with every 13th face flattened into a plane
    x = const, and ``_soup_rays``'s rays (zero direction components with the
    origin on a box face, t_cull = -inf rays) with every 23rd ray lying in
    one of those planes, aimed at its face: edge-on, the determinant 0."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-3, 3, (n_faces, 1, 3)).repeat(3, axis=1).astype(np.float32)
    verts = base + rng.uniform(-0.4, 0.4, (n_faces, 3, 3)).astype(np.float32)
    flat_faces = np.arange(0, n_faces, 13)
    verts[flat_faces, :, 0] = verts[flat_faces, :1, 0]
    normals = rng.normal(size=(n_faces, 3, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    bvh = build_mesh_bvh(verts, normals, rng.integers(0, 5, n_faces).astype(np.int32))[0]
    n = 8192 + 37
    o, d, tc = _soup_rays(n, seed + 1, bvh.super_bounds.numpy(), "cpu")
    o, d = [np.stack([c.numpy() for c in v]) for v in (o, d)]
    lying = np.arange(5, n, 23)
    face = verts[flat_faces[lying % len(flat_faces)]]
    angle = rng.uniform(0, 2 * np.pi, len(lying))
    center = face.mean(axis=1)
    o[:, lying] = np.stack([face[:, 0, 0], center[:, 1] + 4 * np.cos(angle),
                            center[:, 2] + 4 * np.sin(angle)]).astype(np.float32)
    d[:, lying] = np.stack([np.zeros_like(angle), -np.cos(angle),
                            -np.sin(angle)]).astype(np.float32)
    vec = lambda a: Vec3(*(torch.from_numpy(np.ascontiguousarray(c)).to(device) for c in a))
    return bvh.to(device), vec(o), vec(d), tc.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("n_faces", [300, 5000])
def test_tile_and_front_to_back_traversals_match_plain_on_card(cuda_device, n_faces):
    # K7 at three tile sizes and K8 against the dense scan and their plain
    # walks, and each kernel's visits against its plain walk's on the same
    # rays (on the card)
    bvh, o, d, tc = _edge_on_soup(n_faces, n_faces, cuda_device)
    want = mesh_kernel_v2p.mesh_intersect_bvh_v2p_plain(bvh, o, d, tc)
    assert torch.isfinite(want[0]).sum() > 0
    assert not torch.isfinite(want[0][tc == float("-inf")]).any()
    calls = {
        **{f"v2@{lanes}": (mesh_kernel, lambda counter, lanes=lanes: mesh_kernel.mesh_intersect_bvh(
            bvh, o, d, tc, lanes, visit_counter=counter)) for lanes in (1024, 128, 640)},
        "v3": (mesh_kernel_v3, lambda counter: mesh_kernel_v3.mesh_intersect_bvh_v3(
            bvh, o, d, tc, visit_counter=counter))}
    plain = {f"v2@{lanes}": lambda counter, lanes=lanes: mesh_kernel.mesh_intersect_bvh_plain(
                 bvh, o, d, tc, lanes, visit_counter=counter) for lanes in (1024, 128, 640)}
    plain["v3"] = lambda counter: mesh_kernel_v3.mesh_intersect_bvh_v3_plain(
        bvh, o, d, tc, visit_counter=counter)
    for name, (module, call) in calls.items():
        counter, plain_counter = (torch.zeros(1, dtype=torch.int32, device=cuda_device)
                                  for _ in range(2))
        launches = module.KERNEL.launches
        got = call(counter)
        torch.cuda.synchronize()
        assert module.KERNEL.launches == launches + 1
        assert _all_equal(got, want), name
        assert _all_equal(plain[name](plain_counter), want), name
        visits = int(counter.item())
        assert visits == int(plain_counter.item()) and visits > 0, name


@pytest.mark.cuda
def test_tile_traversals_replay_in_a_cuda_graph_on_card(cuda_device):
    # K7 at 128 and 1024 lanes and K8 warmed up on a side stream, then
    # captured in one CUDA graph, as the timers use them: every replay equals
    # the launch on the main stream, output and visits
    bvh, o, d, tc = _edge_on_soup(300, 300, cuda_device)
    calls = {f"v2@{lanes}": lambda counter, lanes=lanes: mesh_kernel.mesh_intersect_bvh(
                 bvh, o, d, tc, lanes, visit_counter=counter) for lanes in (128, 1024)}
    calls["v3"] = lambda counter: mesh_kernel_v3.mesh_intersect_bvh_v3(
        bvh, o, d, tc, visit_counter=counter)
    counters = {name: torch.zeros(1, dtype=torch.int32, device=cuda_device) for name in calls}
    want = {name: call(counters[name]) for name, call in calls.items()}
    torch.cuda.synchronize()
    visits = {name: int(c.item()) for name, c in counters.items()}
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for name, call in calls.items():
            assert _all_equal(call(counters[name]), want[name]), name
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = {name: call(counters[name]) for name, call in calls.items()}
    for _ in range(3):
        for c in counters.values():
            c.fill_(-1)
        graph.replay()
        torch.cuda.synchronize()
        for name in calls:
            assert _all_equal(got[name], want[name]), name
            assert int(counters[name].item()) == visits[name] > 0, name


@pytest.mark.cuda
def test_visit_kernels_match_plain_on_card(cuda_device):
    rays, faces, coeffs = mm_feasibility.probe_inputs(0, cuda_device)
    launches = mm_feasibility.VPU_KERNEL.launches
    got = mm_feasibility.visit_vpu(rays, faces, 200)
    torch.cuda.synchronize()
    assert mm_feasibility.VPU_KERNEL.launches == launches + 1
    want = mm_feasibility.visit_vpu_plain(rays, faces)
    assert torch.equal(got, want) and (want[0] < 1e38).sum() > 500
    for highest, precision in ((False, "tf32"), (True, "float32")):
        launches = mm_feasibility.MMA_KERNEL.launches
        got = mm_feasibility.visit_mma(rays, coeffs, 200, highest)
        torch.cuda.synchronize()
        assert mm_feasibility.MMA_KERNEL.launches == launches + 1
        want = mm_feasibility.visit_mma_plain(rays, coeffs, precision=precision)
        bad = (got[0] - want[0]).abs() > 1e-5 * want[0].abs() + 1e-5
        assert int(bad.sum()) + int((got[1] != want[1]).sum()) <= 10
        assert (got[2:] == 0).all() and (want[0] < 1e38).sum() > 500
    with pytest.raises(ValueError, match="different devices"):
        mm_feasibility.visit_vpu(rays, faces.cpu(), 64)


@pytest.mark.cuda
@pytest.mark.parametrize("n_visits", [64, 200, 1000])
def test_k9a_split_over_the_card_equals_plain_on_card(cuda_device, n_visits):
    """Every split (one block, 7, the shipped S) gives the plain version's
    state bit for bit and runs every visit."""
    rays, faces, _ = mm_feasibility.probe_inputs(0, cuda_device)
    want = mm_feasibility.visit_vpu_plain(rays, faces, n_visits)
    counter = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    for splits in (1, 7, mm_feasibility.default_splits(cuda_device)):
        got = mm_feasibility.visit_vpu(rays, faces, n_visits, splits=splits,
                                       visit_counter=counter)
        torch.cuda.synchronize()
        assert torch.equal(got, want), splits
        assert int(counter) == n_visits


@pytest.mark.cuda
@pytest.mark.parametrize("highest", [False, True])
def test_k9b_split_over_the_card_is_bitwise_one_block_on_card(cuda_device, highest):
    """The tensor-core visit at 7 blocks and the shipped S equals one block
    bit for bit, meets the bar against its plain version and runs every
    visit."""
    rays, _, coeffs = mm_feasibility.probe_inputs(0, cuda_device)
    want = mm_feasibility.visit_mma_plain(rays, coeffs,
                                          precision="float32" if highest else "tf32")
    counter = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    for n_visits in (200, 1000):
        one = mm_feasibility.visit_mma(rays, coeffs, n_visits, highest, splits=1,
                                       visit_counter=counter)
        torch.cuda.synchronize()
        assert int(counter) == n_visits
        bad = (one[0] - want[0]).abs() > 1e-5 * want[0].abs() + 1e-5
        assert int(bad.sum()) + int((one[1] != want[1]).sum()) <= 10
        assert (one[2:] == 0).all() and (want[0] < 1e38).sum() > 500
        for splits in (7, mm_feasibility.default_splits(cuda_device, highest)):
            got = mm_feasibility.visit_mma(rays, coeffs, n_visits, highest, splits=splits,
                                           visit_counter=counter)
            torch.cuda.synchronize()
            assert torch.equal(got, one), (n_visits, splits)
            assert int(counter) == n_visits


@pytest.mark.cuda
def test_scene_past_the_kernel_home_renders_plain_on_card(cuda_device, tmp_path):
    """"auto" routes a scene whose packed size exceeds the megakernel's
    shared memory to the plain wavefront on the card (no launch), and a
    forced "pallas" raises the ineligible error."""
    scene = load_scene(crowded_cornell(tmp_path / "crowded.txt"), device=cuda_device)
    c = scene.camera
    scene = dataclasses.replace(scene, camera=derive_camera(
        (RES, RES), 45.0, c.position.numpy(), c.look_at.numpy(), c.up.numpy()))
    launches = cuda_backend.KERNEL.launches
    img, gbuf, _ = render(scene, RenderOptions(), num_iterations=1)
    want_img, want_gbuf, _ = render(scene, RenderOptions(backend="xla"), num_iterations=1)
    torch.cuda.synchronize()
    assert cuda_backend.KERNEL.launches == launches
    assert torch.equal(img, want_img) and torch.equal(gbuf, want_gbuf)
    with pytest.raises(ValueError, match="ineligible"):
        render(scene, RenderOptions(backend="pallas"), num_iterations=1)


@pytest.mark.cuda
def test_mesh_scene_renders_through_the_kernels_on_card(cuda_device):
    scene = _scene("cornell_mesh_torus.txt", cuda_device, depth=4)
    want = render(scene, RenderOptions(mesh_bvh=False), num_iterations=2)[1]
    for impl, kernel in (("v2p", mesh_kernel_v2p.KERNEL), ("binned", mesh_binned.PAIR_KERNEL),
                         ("v2", mesh_kernel.KERNEL), ("v3", mesh_kernel_v3.KERNEL)):
        launches = kernel.launches
        got = render(scene, RenderOptions(mesh_kernel_impl=impl), num_iterations=2)[1]
        torch.cuda.synchronize()
        assert kernel.launches > launches
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,c,co", [(0, 25, 25, 202, 101), (2, 37, 53, 43, 57),
                                        (4, 64, 64, 3, 32), (1, 13, 7, 5, 7)])
def test_conv_kernels_float32_batched_and_row_band_on_card(cuda_device, n, h, w, c, co):
    """The tile kernel with float32 input and a batch, and the row-band kernel
    in both dtypes and on a pre-padded input, against their plain versions."""
    x, wt, b, aff = _conv_inputs(h, w, c, co, seed=c)
    if n:
        x = torch.stack([x.roll(i, 0) for i in range(n)])
    b, wt = b.to(cuda_device), wt.to(cuda_device)
    aff = {k: v.to(cuda_device) for k, v in aff.items()}
    for dtype, rtol, atol in ((torch.float32, 1e-3, 1e-3), (torch.bfloat16, 1.6e-2, 1e-2)):
        xs = x.to(cuda_device, dtype)
        before = (conv_kernel.KERNEL.launches, conv_kernel.ROWS_KERNEL.launches)
        pairs = [(conv_kernel.conv3x3_act_chw(xs, wt, b, 0.1, aff),
                  conv_kernel.conv3x3_act_plain(xs, wt.to(dtype), b, 0.1, aff)),
                 (conv_kernel.conv3x3_act(xs, wt, b, 0.1, aff),
                  conv_kernel.conv3x3_act_rows_plain(xs, wt.to(dtype), b, 0.1, aff)),
                 (conv_kernel.conv3x3_act(conv_kernel.conv_input_pad(xs).contiguous(), wt, b,
                                          1.0, None, pre_padded=True, width=w),
                  conv_kernel.conv3x3_act_rows_plain(xs, wt.to(dtype), b, 1.0, None))]
        torch.cuda.synchronize()
        assert (conv_kernel.KERNEL.launches, conv_kernel.ROWS_KERNEL.launches) == (
            before[0] + 1, before[1] + 2)
        for got, want in pairs:
            assert got.dtype == dtype and got.shape == want.shape
            np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                                       rtol=rtol, atol=atol)
    with pytest.raises(ValueError):
        conv_kernel.conv3x3_act(xs.half(), wt, b, 0.1)
    with pytest.raises(ValueError):
        conv_kernel.conv3x3_act_chw(xs.transpose(-2, -3), wt, b, 0.1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_conv_autograd_runs_through_the_kernel_on_card(cuda_device, dtype):
    """Forward and dgrad launch the tile kernel (2 launches; 1 when x needs
    no gradient) and agree with the plain backward pass: float32 within
    1e-3 + 1e-3|p|, bfloat16 within one rounding step of the largest entry."""
    x, wt, _, _ = _conv_inputs(40, 24, 43, 57, seed=2)
    x = torch.stack([x, x.flip(0)]).to(cuda_device, dtype).requires_grad_(True)
    w = wt.to(cuda_device, dtype).requires_grad_(True)
    before = conv_kernel.KERNEL.launches
    y = layers.Conv3x3Function.apply(x, w)
    g = torch.randn(y.shape, device=cuda_device, generator=torch.Generator(cuda_device).manual_seed(0))
    dx, dw = torch.autograd.grad(y, (x, w), g)
    torch.cuda.synchronize()
    assert conv_kernel.KERNEL.launches == before + 2
    assert y.dtype == torch.float32 and dx.dtype == dtype and dw.dtype == dtype
    want_dx, want_dw = conv_kernel.conv3x3_backward_plain(x.detach(), w.detach(), g.to(dtype))
    rtol, atol = (1e-3, 1e-3) if dtype == torch.float32 else (1.6e-2, 1e-2)
    for got, want in ((dx, want_dx), (dw, want_dw)):
        scale = float(want.abs().max())
        np.testing.assert_allclose(got.float().cpu().numpy() / scale, want.cpu().numpy() / scale,
                                   rtol=rtol, atol=atol)
    before = conv_kernel.KERNEL.launches
    torch.autograd.grad(layers.Conv3x3Function.apply(x.detach(), w), (w,), g)
    assert conv_kernel.KERNEL.launches == before + 1


@pytest.mark.cuda
def test_broken_build_raises_on_card(cuda_device, tmp_path, monkeypatch):
    """A kernel that does not build raises from its wrapper on a CUDA
    tensor; the wrapper does not fall back to the plain version."""
    from ai_path_tracer_denoiser_tpu_torch.utils import cuda_build
    (tmp_path / "broken.cu").write_text("this is not CUDA C++\n")
    monkeypatch.setattr(cuda_build, "CSRC_DIR", str(tmp_path))
    broken = cuda_build.CudaKernel("broken", "broken.cu")
    monkeypatch.setattr(conv_kernel, "ROWS_KERNEL", broken)
    x, wt, b, _ = _conv_inputs(8, 8, 4, 4, seed=0)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        conv_kernel.conv3x3_act(x.to(cuda_device), wt, b, 0.1)
    assert broken.launches == 0


@pytest.mark.cuda
def test_train_step_on_card_matches_cpu(cuda_device):
    """One float32 train step at small widths on the card (every conv through
    the kernel forward and backward) against the same step on the CPU (plain
    versions): loss rtol 1e-4; 3 x 28 forward and 3 x 28 - 3 dgrad launches."""
    from ai_path_tracer_denoiser_tpu_torch.train import init_train_state, train_step
    mopt, topt = ModelOptions(widths=(8, 8, 8, 8, 8)), TrainOptions(bf16_compute=False)
    r = np.random.default_rng(0)
    x = torch.from_numpy(r.normal(size=(3, 2, 64, 64, 10)).astype(np.float32))
    y = torch.from_numpy((r.normal(size=(3, 2, 64, 64, 3)) * 0.1 + 0.5).astype(np.float32))
    losses = {}
    for dev in ("cpu", cuda_device):
        state = init_train_state(torch.Generator().manual_seed(0), mopt, topt, device=dev)
        before = conv_kernel.KERNEL.launches
        state, metrics = train_step(state, x.to(dev), y.to(dev), topt, mopt)
        losses[str(dev)] = float(metrics["total"])
        launched = conv_kernel.KERNEL.launches - before
        assert launched == (0 if dev == "cpu" else 3 * 28 + 3 * 28 - 3)
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)


@pytest.mark.cuda
def test_remat_step_and_recalibration_on_card(cuda_device):
    """A bfloat16 ``remat_frames`` step equals the plain step bit for bit
    (parameters, BatchNorm state, Adam moments, metrics) with K2's forward
    launched once more per conv; ``recalibrate_bn`` moves only the
    statistics, launches K2 per conv and frame and repeats bit for bit."""
    from ai_path_tracer_denoiser_tpu_torch.models.export import sorted_leaves
    from ai_path_tracer_denoiser_tpu_torch.train import (init_train_state, recalibrate_bn,
                                                         train_step)
    mopt = ModelOptions(widths=(8, 8, 8, 8, 8))
    r = np.random.default_rng(1)
    x = torch.from_numpy(r.normal(size=(3, 2, 64, 64, 10)).astype(np.float32))
    y = torch.from_numpy((r.normal(size=(3, 2, 64, 64, 3)) * 0.1 + 0.5).astype(np.float32))
    x, y = x.to(cuda_device, torch.bfloat16), y.to(cuda_device, torch.bfloat16)
    state = init_train_state(torch.Generator().manual_seed(0), mopt, TrainOptions(),
                             device=cuda_device)

    def same(a, b):
        return all(torch.equal(p, q) for (_, p), (_, q) in zip(sorted_leaves(a),
                                                               sorted_leaves(b)))

    out, launched = {}, {}
    for remat in (False, True):
        before = conv_kernel.KERNEL.launches
        out[remat] = train_step(state, x, y, TrainOptions(remat_frames=remat), mopt)
        launched[remat] = conv_kernel.KERNEL.launches - before
    (plain, mp), (rem, mr) = out[False], out[True]
    assert launched == {False: 3 * 28 + 3 * 28 - 3, True: 2 * 3 * 28 + 3 * 28 - 3}
    assert same(rem.params, plain.params) and same(rem.bn_state, plain.bn_state)
    assert same(rem.opt_state["mu"], plain.opt_state["mu"])
    assert same(rem.opt_state["nu"], plain.opt_state["nu"])
    assert all(torch.equal(mr[k], mp[k]) for k in mp)
    batches = [(x.float().cpu().numpy(), None)] * 3
    before = conv_kernel.KERNEL.launches
    recal = recalibrate_bn(plain, iter(batches), 2, TrainOptions(), mopt)
    assert conv_kernel.KERNEL.launches - before == 2 * 3 * 28
    assert recal.params is plain.params and not same(recal.bn_state, plain.bn_state)
    assert same(recalibrate_bn(plain, iter(batches), 2, TrainOptions(), mopt).bn_state,
                recal.bn_state)


@pytest.mark.cuda
def test_fit_feeds_the_card_from_host_batches(cuda_device):
    """The host loader path on the card: numpy batches go up through pinned
    memory one batch ahead (bfloat16 under bfloat16 compute), the state
    stays on the card and every conv launches the kernel."""
    from ai_path_tracer_denoiser_tpu_torch.train import fit, init_train_state
    mopt, topt = ModelOptions(widths=(8, 8, 8, 8, 8)), TrainOptions(checkpoint_every_epochs=1)
    state = init_train_state(torch.Generator().manual_seed(0), mopt, topt, device=cuda_device)
    r = np.random.default_rng(0)

    def data(epoch):
        for _ in range(3):
            yield (r.normal(size=(2, 1, 32, 32, 10)).astype(np.float32),
                   r.uniform(0, 1, (2, 1, 32, 32, 3)).astype(np.float32))

    before = conv_kernel.KERNEL.launches
    saved = []
    state = fit(state, data, topt, epochs=1, log_every=1, model_options=mopt,
                checkpoint_fn=lambda s, e: saved.append(e))
    torch.cuda.synchronize()
    assert state.step == 3 and saved == [0, "final"]
    assert state.params["enc1"]["conv1"]["w"].device.type == "cuda"
    assert conv_kernel.KERNEL.launches - before == 3 * (2 * 28 + 2 * 28 - 2)


def _stream_corpus(root, groups=4, frames=4, res=64):
    """(scene, 0, 0, frame) npy pairs from a numpy seed: ``groups`` groups."""
    rng = np.random.default_rng(0)
    (root / "input").mkdir(parents=True)
    (root / "gt").mkdir()
    for s in range(groups):
        for f in range(frames):
            name = f"{s:03d}_0_0_{f:04d}.npy"
            np.save(root / "input" / name, rng.random((res, res, 10)).astype(np.float32))
            np.save(root / "gt" / name, rng.random((res, res, 3)).astype(np.float32))
    return str(root / "input"), str(root / "gt")


def resident_replay(state, dataset, topt, mopt, shard_frames):
    """``fit_streamed``'s schedule (shard order, windows, crops) on the
    device-resident corpus: the same steps with no buffer swap and no side
    stream, the reference a streamed fit must equal bit for bit."""
    from types import SimpleNamespace

    from ai_path_tracer_denoiser_tpu_torch.models.export import sorted_leaves
    from ai_path_tracer_denoiser_tpu_torch.train import (device_data, load_device_dataset,
                                                         step_lr, stream_data)
    X, Y, starts = load_device_dataset(dataset, dtype=torch.bfloat16,
                                       device=sorted_leaves(state.params)[0][1].device)
    shards = stream_data.shard_plan(dataset, shard_frames)
    quiet = SimpleNamespace(step=lambda *a: None)
    for epoch in range(topt.epochs):
        state = dataclasses.replace(state, lr=float(step_lr(topt.lr, epoch, topt.lr_step_epochs,
                                                            topt.lr_gamma)))
        for _, items in stream_data._epoch_plan(shards, epoch):
            state, _ = device_data._train_windows(state, X, Y, starts, items, epoch, topt,
                                                  mopt, quiet, 1)
    return state


@pytest.mark.cuda
def test_fit_streamed_reuses_both_buffers_on_card(cuda_device, tmp_path, monkeypatch):
    """Four shards of one group through the two device buffers (each reused
    twice per epoch, two epochs), bfloat16: every window once per epoch,
    every step through the conv kernel, each shard's copy timed, the state
    bit for bit that of the same steps on the device-resident corpus
    (``resident_replay``); one shard equals ``fit_device_data`` on the
    card bit for bit."""
    from ai_path_tracer_denoiser_tpu_torch.data import SequenceDataset
    from ai_path_tracer_denoiser_tpu_torch.models.export import sorted_leaves
    from ai_path_tracer_denoiser_tpu_torch.train import (device_data, fit_device_data,
                                                         init_train_state, stream_data)
    ds = SequenceDataset(*_stream_corpus(tmp_path), None, sequence_length=3, crop=True,
                         crop_size=32)
    mopt = ModelOptions(widths=(8, 8, 8, 8, 8))
    topt = TrainOptions(batch_size=2, sequence_length=3, crop_size=32, epochs=2,
                        checkpoint_every_epochs=10)

    def state0():
        return init_train_state(torch.Generator().manual_seed(0), mopt, topt, device=cuda_device)

    def assert_equal(a, b):
        for tree in ("params", "bn_state"):
            for (path, la), (_, lb) in zip(sorted_leaves(getattr(a, tree)),
                                           sorted_leaves(getattr(b, tree))):
                assert torch.equal(la, lb), tree + "/" + "/".join(path)

    seen, orig = [], device_data.epoch_crops
    monkeypatch.setattr(device_data, "epoch_crops", lambda epoch, idxs, *a: seen.append(
        (epoch, [int(i) for i in idxs])) or orig(epoch, idxs, *a))
    timings = []
    before = conv_kernel.KERNEL.launches
    out = stream_data.fit_streamed(state0(), ds, topt, shard_frames=4, model_options=mopt,
                                   timings=timings)
    torch.cuda.synchronize()
    assert out.step == 16 and len(timings) == 8
    for epoch in (0, 1):
        assert sorted(i for e, idxs in seen if e == epoch for i in idxs) == list(range(16))
    assert conv_kernel.KERNEL.launches - before == 16 * (3 * 28 + 3 * 28 - 3)
    assert all(t["upload_ms"] > 0 and t["exposed_ms"] >= 0 and t["steps_ms"] > 0
               for t in timings)
    assert all(torch.isfinite(leaf).all() for _, leaf in sorted_leaves(out.params))
    monkeypatch.setattr(device_data, "epoch_crops", orig)
    assert_equal(out, resident_replay(state0(), ds, topt, mopt, 4))
    single = stream_data.fit_streamed(state0(), ds, topt, shard_frames=16, model_options=mopt)
    assert_equal(single, fit_device_data(state0(), ds, topt, model_options=mopt))


@pytest.mark.cuda
def test_interactive_emit_pipeline_on_card(cuda_device, tmp_path):
    """``interactive`` on the card at 64x64, 3 frames: each frame written
    one behind through the page-locked buffers equals the frame rendered
    and denoised synchronously on the card, bit for bit; one frame's
    dispatch makes no host sync (``set_sync_debug_mode("error")``)."""
    from ai_path_tracer_denoiser_tpu_torch.app.cli import _load_scene_scaled, main
    from ai_path_tracer_denoiser_tpu_torch.models import (apply_frame_fast_padded, init_hidden,
                                                          load_model, model_options_from_meta,
                                                          prepare_inference)
    from ai_path_tracer_denoiser_tpu_torch.render import render_gbuffer_frame
    from ai_path_tracer_denoiser_tpu_torch.scene.camera import (orbit_camera,
                                                                orbit_params_from_camera)
    model = str(REPO / "artifacts" / "denoiser_multiscene.npz")
    k1, k2 = cuda_backend.KERNEL.launches, conv_kernel.KERNEL.launches
    records = main(["interactive", str(REPO / "scenes" / "cornell_box.txt"), "--res", "64",
                    "--frames", "3", "--dphi", "0.1", "--model", model, "--save-arrays",
                    "--out-dir", str(tmp_path)])
    assert cuda_backend.KERNEL.launches - k1 == 3 and conv_kernel.KERNEL.launches - k2 == 84
    scene = _load_scene_scaled(str(REPO / "scenes" / "cornell_box.txt"), cuda_device, 64)
    params, bn, meta = load_model(model, device=cuda_device)
    mopts = model_options_from_meta(meta)
    folded = prepare_inference(params, bn, mopts)
    hidden = init_hidden(1, 64, 64, mopts, dtype=torch.bfloat16, device=cuda_device)
    phi, theta, zoom = orbit_params_from_camera(scene.camera)
    for frame, rec in enumerate(records):
        if frame:
            phi += 0.1
        fscene = dataclasses.replace(scene, camera=orbit_camera(scene.camera, phi, theta, zoom))
        _, gbuf, _ = render_gbuffer_frame(fscene)
        y, hidden = apply_frame_fast_padded(folded, gbuf.permute(1, 2, 0)[None], hidden, mopts)
        base = rec["path"][:-len(".png")]
        np.testing.assert_array_equal(np.load(base + "_gbuffer.npy"), gbuf.cpu().numpy())
        np.testing.assert_array_equal(np.load(base + "_denoised.npy"), y[0].cpu().numpy())
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, gbuf, _ = render_gbuffer_frame(scene)
        apply_frame_fast_padded(folded, gbuf.permute(1, 2, 0)[None], hidden, mopts)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_differentiable_render_launches_no_kernel_on_card(cuda_device):
    """A differentiable cornell iteration on the card runs the plain
    wavefront (no megakernel launch), meets the render bar against the
    CPU port's, and carries a camera and a geom gradient that agree with
    the CPU's to 1e-2 relative (a pixel whose primary hit flips between
    the two moves the summed depth gradient by about 1/4096)."""
    from ai_path_tracer_denoiser_tpu_torch.render import edge_grad
    from ai_path_tracer_denoiser_tpu_torch.render.wavefront import trace_iteration

    def run(scene):
        pos = scene.camera.position.clone().requires_grad_()
        delta = torch.zeros(3, device=scene.device, requires_grad=True)
        s = dataclasses.replace(scene, camera=dataclasses.replace(scene.camera, position=pos),
                                geoms=edge_grad.translate_geom(scene.geoms, 6, delta))
        st = trace_iteration(s, RenderOptions(), init_render_state(s), differentiable=True)
        loss = st.accum.mean() + st.gbuf[3].mean() + st.gbuf[0].mean()
        grads = torch.autograd.grad(loss, (pos, delta))
        return st, [g.cpu().numpy() for g in grads]

    launches = [k.launches for k in (cuda_backend.KERNEL, mesh_kernel_v2p.KERNEL)]
    card, card_grads = run(_scene("cornell_box.txt", cuda_device, depth=3))
    torch.cuda.synchronize()
    assert [k.launches for k in (cuda_backend.KERNEL, mesh_kernel_v2p.KERNEL)] == launches
    cpu, cpu_grads = run(_scene("cornell_box.txt", "cpu", depth=3))
    g_card = torch.cat([card.accum, card.gbuf]).detach().cpu().reshape(10, RES, RES).numpy()
    g_cpu = torch.cat([cpu.accum, cpu.gbuf]).detach().reshape(10, RES, RES).numpy()
    assert (np.isclose(g_card[3:], g_cpu[3:], rtol=1e-5, atol=1e-5).all(axis=0).mean()
            >= 0.998)
    rel = abs(g_card[:3].mean() - g_cpu[:3].mean()) / g_cpu[:3].mean()
    assert rel < 1e-3
    for gc, gp in zip(card_grads, cpu_grads):
        assert np.isfinite(gc).all() and np.abs(gc).max() > 0
        np.testing.assert_allclose(gc, gp, rtol=1e-2, atol=1e-4)


@pytest.mark.cuda
def test_translated_blob_through_k4_equals_the_dense_scan_on_card(cuda_device):
    """``translate_mesh`` moves the blob's hierarchy tables out of place, so
    K4's packed-face cache (keyed by the table) misses for them: K4 on the
    moved tables equals the dense scan of the moved mesh bit for bit, after
    a call on the unmoved tables has filled the cache."""
    from ai_path_tracer_denoiser_tpu_torch.render import edge_grad
    from ai_path_tracer_denoiser_tpu_torch.render.wavefront import generate_camera_rays_v

    scene = _scene("cornell_mesh_blob.txt", cuda_device)
    ids = torch.arange(RES * RES, device=cuda_device)
    o, d = generate_camera_rays_v(scene.camera, 1, RenderOptions(), ids)
    for delta in ((0.0, 0.0, 0.0), (0.37, -1.21, 0.58), (-0.2, 0.4, 0.0)):
        moved = edge_grad.translate_mesh(scene.mesh, torch.tensor(delta, device=cuda_device))
        launches = mesh_kernel_v2p.KERNEL.launches
        got = mesh_kernel_v2p.mesh_intersect_bvh_v2p(moved.bvh, o, d)
        want = tintersect.mesh_intersect_v(moved, o, d)
        torch.cuda.synchronize()
        assert mesh_kernel_v2p.KERNEL.launches == launches + 1
        assert torch.isfinite(want[0]).any()
        for a, b in zip((got[0], *got[1], *got[2], got[3]),
                        (want[0], *want[1], *want[2], want[3])):
            assert torch.equal(a, b), delta
