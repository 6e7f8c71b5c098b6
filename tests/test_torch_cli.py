"""The port's main path end to end on the CPU, frame by frame against the
JAX package's interactive pipeline.

``python -m ai_path_tracer_denoiser_tpu_torch.app interactive`` renders and
denoises 3 orbit frames of the Cornell box at 64x64 with the shipped model;
each frame's G-buffer and denoised image are held against JAX
``render_gbuffer_frame`` (backend "xla") and ``apply_frame_fast_padded``
(native convs) with the hidden state carried, at the tolerances of
tests/test_torch_render.py and tests/test_torch_models.py.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ai_path_tracer_denoiser_tpu.config import RenderOptions
from ai_path_tracer_denoiser_tpu.models import init_hidden, load_model, prepare_inference
from ai_path_tracer_denoiser_tpu.models.inference import apply_frame_fast_padded
from ai_path_tracer_denoiser_tpu.render import render_gbuffer_frame
from ai_path_tracer_denoiser_tpu.scene import load_scene
from ai_path_tracer_denoiser_tpu.scene.camera import (derive_camera, orbit_camera,
                                                      orbit_params_from_camera)
from ai_path_tracer_denoiser_tpu_torch.utils.imageio import read_png

REPO = pathlib.Path(__file__).resolve().parent.parent
RES, FRAMES, DPHI = 64, 3, 0.05
MODEL = REPO / "artifacts" / "denoiser_multiscene.npz"


def _jax_frames():
    scene = load_scene(str(REPO / "scenes" / "cornell_box.txt"))
    scene = dataclasses.replace(scene, camera=derive_camera(
        (RES, RES), float(scene.camera.fov[1]), np.asarray(scene.camera.position),
        np.asarray(scene.camera.look_at), np.asarray(scene.camera.up)))
    params, bn_state, _ = load_model(str(MODEL))
    folded = prepare_inference(params, bn_state)
    hidden = init_hidden(1, RES, RES, dtype=jnp.bfloat16)
    # jitted as the JAX CLI runs it (app/cli.py:cmd_interactive)
    denoise = jax.jit(lambda g, hd: apply_frame_fast_padded(
        folded, jnp.moveaxis(g, 0, -1)[None], hd, conv_impl="native"))
    phi, theta, zoom = orbit_params_from_camera(scene.camera)
    for frame in range(FRAMES):
        if frame:
            phi += DPHI
        fscene = dataclasses.replace(scene, camera=orbit_camera(
            scene.camera, phi, theta, zoom))
        _, gbuf, _ = render_gbuffer_frame(fscene, RenderOptions(backend="xla"))
        y, hidden = denoise(gbuf, hidden)
        yield np.asarray(gbuf), np.asarray(y[0])


def test_interactive_cli_matches_jax(tmp_path):
    out = tmp_path / "frames"
    cmd = [sys.executable, "-m", "ai_path_tracer_denoiser_tpu_torch.app",
           "interactive", "scenes/cornell_box.txt", "--device", "cpu",
           "--res", str(RES), "--frames", str(FRAMES), "--dphi", str(DPHI),
           "--model", str(MODEL), "--out-dir", str(out), "--save-arrays"]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    for frame, (jg, jy) in enumerate(_jax_frames()):
        base = out / f"frame_{frame:04d}"
        png = read_png(str(base) + ".png")
        assert png.shape == (RES, RES, 3)
        tg = np.load(str(base) + "_gbuffer.npy")
        ty = np.load(str(base) + "_denoised.npy")
        assert tg.shape == (10, RES, RES) and ty.shape == (RES, RES, 3)
        ok = np.isclose(tg[3:], jg[3:], rtol=1e-5, atol=1e-5).all(axis=0)
        assert ok.mean() >= 0.998, (frame, ok.mean())
        rel = abs(tg[:3].mean() - jg[:3].mean()) / jg[:3].mean()
        assert rel < 1e-3, (frame, rel)
        assert np.isfinite(ty).all()
        l2 = np.linalg.norm(ty - jy) / np.linalg.norm(jy)
        assert l2 < 2e-2, (frame, l2)
        np.testing.assert_array_equal(
            png, (np.clip(ty, 0, 1) * 255.0).astype(np.uint8))


@pytest.mark.parametrize("flag", ["--serve=8000", "--parity-denoise"])
def test_unported_options_raise(flag, tmp_path):
    from ai_path_tracer_denoiser_tpu_torch.app.cli import main
    with pytest.raises(NotImplementedError, match="not ported"):
        main(["interactive", "scenes/cornell_box.txt", "--device", "cpu",
              "--frames", "1", flag, "--out-dir", str(tmp_path)])


def test_cli_defaults_to_cuda():
    from ai_path_tracer_denoiser_tpu_torch.app.cli import build_parser
    args = build_parser().parse_args(["interactive", "scenes/cornell_box.txt"])
    assert args.device == "cuda"
