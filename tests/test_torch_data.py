"""The port's data path against the JAX package's, on the CPU: ``datagen``
with the port's renderer writes the stems and arrays the JAX ``datagen``
writes, the copied loader draws the same windows and crops, the u8 storage
regime and the image metrics are the same functions.

Tolerances: the 1-spp G-buffer as tests/test_torch_render.py (normals,
depth, albedo isclose(rtol 1e-5, atol 1e-5) on >= 99.8% of pixels; XLA's
CPU FMA contraction moves grazing sphere hits), the 1-spp radiance and the
4-spp ground truth by mean (rel < 2e-2: single paths may branch
differently).  Everything that is numpy in both packages is equal exactly.
"""
import dataclasses
import os
import pathlib

import numpy as np
import pytest
import torch

from ai_path_tracer_denoiser_tpu.config import RenderOptions as JaxRenderOptions
from ai_path_tracer_denoiser_tpu.data import datagen as jax_datagen
from ai_path_tracer_denoiser_tpu.data import dataset as jax_dataset
from ai_path_tracer_denoiser_tpu.scene import load_scene as jax_load_scene
from ai_path_tracer_denoiser_tpu.scene.camera import derive_camera as jax_derive_camera
from ai_path_tracer_denoiser_tpu.utils import metrics as jax_metrics
from ai_path_tracer_denoiser_tpu_torch.config import RenderOptions
from ai_path_tracer_denoiser_tpu_torch.data import datagen, dataset
from ai_path_tracer_denoiser_tpu_torch.scene import derive_camera, load_scene
from ai_path_tracer_denoiser_tpu_torch.utils import metrics

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parent.parent
SCENE = str(REPO / "scenes" / "cornell_box.txt")
RES = 32


def _jax_scene():
    scene = jax_load_scene(SCENE)
    cam = jax_derive_camera((RES, RES), 45.0, np.asarray(scene.camera.position),
                            np.asarray(scene.camera.look_at), np.asarray(scene.camera.up))
    return dataclasses.replace(scene, camera=cam)


def _torch_scene():
    scene = load_scene(SCENE, device="cpu")
    c = scene.camera
    return dataclasses.replace(scene, camera=derive_camera(
        (RES, RES), 45.0, c.position.numpy(), c.look_at.numpy(), c.up.numpy()))


def test_datagen_writes_what_the_jax_datagen_writes(tmp_path):
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    kw = dict(frames_per_scene=2, gt_spp=4, noise_seeds=2, movs=2, dphi=0.1, progress=False)
    jax_datagen.generate_training_data([_jax_scene()], jdir,
                                       options=JaxRenderOptions(backend="xla"), **kw)
    in_dir, gt_dir = datagen.generate_training_data([_torch_scene()], tdir,
                                                    options=RenderOptions(), **kw)
    assert in_dir == os.path.join(tdir, "input") and gt_dir == os.path.join(tdir, "gt")
    for sub in ("input", "gt"):
        names = sorted(os.listdir(os.path.join(jdir, sub)))
        assert sorted(os.listdir(os.path.join(tdir, sub))) == names and len(names) == 8
        assert names[0] == "000_0_0_0000.npy" and names[-1] == "000_1_1_0001.npy"
    for name in sorted(os.listdir(in_dir)):
        jx, tx = np.load(os.path.join(jdir, "input", name)), np.load(os.path.join(in_dir, name))
        jy, ty = np.load(os.path.join(jdir, "gt", name)), np.load(os.path.join(gt_dir, name))
        assert tx.shape == jx.shape == (RES, RES, 10) and tx.dtype == jx.dtype == np.float32
        assert ty.shape == jy.shape == (RES, RES, 3) and ty.dtype == jy.dtype == np.float32
        ok = np.isclose(tx[..., 3:], jx[..., 3:], rtol=1e-5, atol=1e-5).all(axis=-1)
        assert ok.mean() >= 0.998, (name, ok.mean())
        assert abs(tx[..., :3].mean() - jx[..., :3].mean()) < 2e-2 * jx[..., :3].mean() + 2e-2
        assert abs(ty.mean() - jy.mean()) < 2e-2 * jy.mean() + 1e-2, name
        assert 0.0 <= ty.min() and ty.max() <= 1.0 and tx[..., :3].max() <= 1.0
    # every variant carries a real G-buffer (the rng offset is not the iteration)
    for name in ("000_1_1_0001.npy", "000_0_1_0000.npy"):
        tx = np.load(os.path.join(in_dir, name))
        assert (tx[..., 6] > 0).mean() > 0.8 and np.abs(tx[..., 3:6]).max() > 0.5
    # noise seeds share one ground truth and draw different inputs
    np.testing.assert_array_equal(np.load(os.path.join(gt_dir, "000_0_0_0000.npy")),
                                  np.load(os.path.join(gt_dir, "000_0_1_0000.npy")))
    assert not np.array_equal(np.load(os.path.join(in_dir, "000_0_0_0000.npy"))[..., :3],
                              np.load(os.path.join(in_dir, "000_0_1_0000.npy"))[..., :3])


def test_datagen_resumes_and_widens_the_seed_axis(tmp_path, monkeypatch):
    calls = {"gt": 0, "input": 0}
    real_render = datagen.render

    def counting_render(s, options, num_iterations, **kw):
        calls["gt" if num_iterations > 1 else "input"] += 1
        return real_render(s, options, num_iterations=num_iterations, **kw)

    monkeypatch.setattr(datagen, "render", counting_render)
    out = str(tmp_path / "d")
    scene = _torch_scene()
    kw = dict(frames_per_scene=2, gt_spp=2, movs=1, quantize="u8", progress=False)
    datagen.generate_training_data([scene], out, noise_seeds=1, **kw)
    assert calls == {"gt": 2, "input": 2}
    gt0 = (tmp_path / "d" / "gt" / "000_0_0_0000.npy").read_bytes()
    calls.update(gt=0, input=0)
    datagen.generate_training_data([scene], out, noise_seeds=3, **kw)
    assert calls == {"gt": 0, "input": 4}       # no ground truth rendered again
    assert (tmp_path / "d" / "gt" / "000_0_0_0000.npy").read_bytes() == gt0
    assert np.load(tmp_path / "d" / "input" / "000_0_2_0001.npy").dtype == np.uint8
    with pytest.raises(ValueError, match="already holds"):
        datagen.generate_training_data([scene], out, frames_per_scene=2, gt_spp=2, movs=1,
                                       progress=False)
    with pytest.raises(ValueError, match="quantize"):
        datagen.generate_training_data([scene], str(tmp_path / "e"), quantize="u4")


def test_u8_regime_and_gbuffer_layout_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 9, 10)).astype(np.float32) * 2
    y = rng.uniform(-0.2, 1.2, (8, 9, 3)).astype(np.float32)
    np.testing.assert_array_equal(datagen.encode_u8_input(x), jax_datagen.encode_u8_input(x))
    np.testing.assert_array_equal(datagen.encode_u8_gt(y), jax_datagen.encode_u8_gt(y))
    u = datagen.encode_u8_input(x)
    np.testing.assert_array_equal(dataset.decode_u8_input(u), jax_dataset.decode_u8_input(u))
    np.testing.assert_array_equal(dataset.decode_u8_gt(u[..., :3]),
                                  jax_dataset.decode_u8_gt(u[..., :3]))
    g = rng.normal(size=(10, 5, 6)).astype(np.float32)
    np.testing.assert_array_equal(datagen._gbuffer_to_input(g), jax_datagen._gbuffer_to_input(g))
    assert datagen._gbuffer_to_input(g).shape == (5, 6, 10)


def _corpus(root, groups, res=64):
    inp, gt = os.path.join(root, "input"), os.path.join(root, "gt")
    os.makedirs(inp)
    os.makedirs(gt)
    rng = np.random.default_rng(0)
    for (s, mv, nz), frames in groups.items():
        for f in range(frames):
            stem = f"{s:03d}_{mv}_{nz}_{f:04d}.npy"
            np.save(os.path.join(inp, stem), rng.random((res, res, 10)).astype(np.float32))
            np.save(os.path.join(gt, stem), rng.random((res, res, 3)).astype(np.float32))
    return inp, gt


def test_loader_draws_the_jax_loaders_batches(tmp_path):
    inp, gt = _corpus(str(tmp_path), {(0, 0, 0): 9, (0, 1, 0): 7, (1, 0, 0): 8})
    jds = jax_dataset.SequenceDataset(inp, gt, None, crop=True, crop_size=32)
    tds = dataset.SequenceDataset(inp, gt, None, crop=True, crop_size=32)
    assert len(tds) == len(jds) == 24
    assert [tds.window_start(i) for i in range(24)] == [jds.window_start(i) for i in range(24)]
    # windows clamp at the end of their (scene, mov, noise) group
    assert tds.window_start(8) == 2 and tds.window_start(9) == 9 and tds.window_start(23) == 17
    for seed in (0, 3):
        jb = list(jax_dataset.sequence_batches(jds, batch_size=4, seed=seed, workers=0))
        tb = list(dataset.sequence_batches(tds, batch_size=4, seed=seed, workers=2))
        assert len(tb) == len(jb) == 6
        for (jx, jy), (tx, ty) in zip(jb, tb):
            assert tx.shape == (7, 4, 32, 32, 10) and ty.shape == (7, 4, 32, 32, 3)
            np.testing.assert_array_equal(tx, jx)
            np.testing.assert_array_equal(ty, jy)
    np.testing.assert_array_equal(dataset.find_max(inp, 1, 1, 0), jax_dataset.find_max(inp, 1, 1, 0))
    os.remove(os.path.join(inp, "000_0_0_0004.npy"))
    os.remove(os.path.join(gt, "000_0_0_0004.npy"))
    with pytest.raises(ValueError, match="gaps"):
        dataset.SequenceDataset(inp, gt, None)


def test_psnr_ssim_match_jax():
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 1, (2, 24, 24, 3))
    b = np.clip(a + rng.normal(size=a.shape) * 0.05, 0, 1)
    assert metrics.psnr(a, b) == jax_metrics.psnr(a, b)
    assert metrics.ssim(a, b) == jax_metrics.ssim(a, b)
    assert metrics.psnr(a, a) == float("inf") and abs(metrics.ssim(a, a) - 1.0) < 1e-12
