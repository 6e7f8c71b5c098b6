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
rounding step (1e-2 + 1.6e-2|p|).
"""
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from ai_path_tracer_denoiser_tpu_torch.config import RenderOptions
from ai_path_tracer_denoiser_tpu_torch.models import conv_kernel
from ai_path_tracer_denoiser_tpu_torch.render import (assemble_gbuffer, cuda_backend,
                                                      init_render_state)
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
