"""The port's scene randomizer, ``randomize`` and ``datagen --variants``
against the JAX package's, on the CPU.

The randomizer is numpy only in both packages: the same seed must give the
same scene text, character for character.  ``datagen --variants`` renders
the base scene and its variants through each package's renderer: the
stems are equal and the arrays meet the render bar of ROADMAP C (G-buffer
planes isclose(1e-5, 1e-5) on >= 99.8% of pixels).
"""
import os
import pathlib

import numpy as np
import pytest

from ai_path_tracer_denoiser_tpu.scene import randomizer as jax_randomizer
from ai_path_tracer_denoiser_tpu_torch.scene import parse_scene_text, randomize_scene_text
from ai_path_tracer_denoiser_tpu_torch.scene import randomizer

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("scene", ["template_random.txt", "cornell_box.txt"])
def test_generate_variants_gives_the_jax_text(scene, seed):
    template = (REPO / "scenes" / scene).read_text()
    got = list(randomizer.generate_variants(template, 3, seed))
    want = list(jax_randomizer.generate_variants(template, 3, seed))
    assert got == want and len(got) == 3
    assert got[0] != template and got[0] != got[1]
    rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
    assert randomize_scene_text(template, rng) == jax_randomizer.randomize_scene_text(
        template, jrng)
    # every variant parses
    scene_ = parse_scene_text(got[2], base_dir=str(REPO / "scenes"), device="cpu")
    assert scene_.geoms.count > 0


def test_randomize_cli_writes_the_jax_files(tmp_path):
    from ai_path_tracer_denoiser_tpu.app.cli import main as jax_main
    from ai_path_tracer_denoiser_tpu_torch.app.cli import main
    argv = ["randomize", "scenes/template_random.txt", "--count", "3", "--seed", "5"]
    jax_main(argv + ["--out-dir", str(tmp_path / "jax")])
    paths = main(argv + ["--out-dir", str(tmp_path / "torch")])
    assert [os.path.basename(p) for p in paths] == ["scene_1.txt", "scene_2.txt", "scene_3.txt"]
    assert sorted(os.listdir(tmp_path / "jax")) == sorted(os.listdir(tmp_path / "torch"))
    for p in paths:
        assert open(p).read() == (tmp_path / "jax" / os.path.basename(p)).read_text()


def test_datagen_variants_matches_the_jax_datagen(tmp_path):
    """``datagen --variants 1`` at 32x32, 2 frames, 4-spp truth, one pan."""
    from ai_path_tracer_denoiser_tpu.app.cli import main as jax_main
    from ai_path_tracer_denoiser_tpu_torch.app.cli import main
    argv = ["datagen", "scenes/cornell_box.txt", "--variants", "1", "--seed", "3",
            "--res", "32", "--frames", "2", "--gt-spp", "4", "--movs", "1",
            "--platform", "cpu"]
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jax_main(argv + ["--out-dir", str(jdir)])
    main(argv + ["--out-dir", str(tdir)])
    for sub in ("input", "gt"):
        names = sorted(os.listdir(jdir / sub))
        assert sorted(os.listdir(tdir / sub)) == names == [
            "000_0_0_0000.npy", "000_0_0_0001.npy", "001_0_0_0000.npy", "001_0_0_0001.npy"]
    for name in names:
        jx, tx = np.load(jdir / "input" / name), np.load(tdir / "input" / name)
        jy, ty = np.load(jdir / "gt" / name), np.load(tdir / "gt" / name)
        assert tx.shape == jx.shape == (32, 32, 10) and ty.shape == jy.shape == (32, 32, 3)
        ok = np.isclose(tx[..., 3:], jx[..., 3:], rtol=1e-5, atol=1e-5).all(axis=-1)
        assert ok.mean() >= 0.998, (name, ok.mean())
        assert abs(tx[..., :3].mean() - jx[..., :3].mean()) < 2e-2 * jx[..., :3].mean() + 2e-2
        assert abs(ty.mean() - jy.mean()) < 2e-2 * jy.mean() + 1e-2, name
    # the variant is another scene
    assert not np.array_equal(np.load(tdir / "input" / "000_0_0_0000.npy")[..., 6:],
                              np.load(tdir / "input" / "001_0_0_0000.npy")[..., 6:])
