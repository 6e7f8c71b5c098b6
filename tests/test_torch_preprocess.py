"""The port's PNG-directory importer (``data/preprocess.py``) and the
``preprocess`` command against the JAX package's, on the CPU.

The test writes the reference's five PNG directories with every row
filter (gray and RGB depth maps among them); both packages' ``.npy``
pairs must be equal, bit for bit.  Without cv2 and PIL both raise the
same ``ImportError``.
"""
import os
import sys

import numpy as np
import pytest

from ai_path_tracer_denoiser_tpu.data import preprocess as jax_preprocess
from ai_path_tracer_denoiser_tpu_torch.data import preprocess_png_dirs
from ai_path_tracer_denoiser_tpu_torch.data import preprocess
from test_torch_imageio import write_png

DIRS = ("RGB", "Depth", "Albedos", "Normals", "GroundTruth")


def _png_dirs(root, n=3, size=20, gray_depth=True):
    rng = np.random.default_rng(11)
    for d in DIRS:
        os.makedirs(os.path.join(root, d), exist_ok=True)
    for i in range(n):
        for j, d in enumerate(DIRS):
            img = rng.integers(0, 256, (size, size + 4, 3), dtype=np.uint8)
            img[3:9, 2:12] = img[3, 2]                       # flat patches
            gray = d == "Depth" and gray_depth
            write_png(os.path.join(root, d, f"frame_{i:03d}.png"),
                      img[..., :1] if gray else img, 0 if gray else 2,
                      (0, 1, 2, 3, 4)[j:] + (0, 1, 2, 3, 4)[:j])
    return [os.path.join(root, d) for d in DIRS]


@pytest.mark.parametrize("size", [16, 20])
@pytest.mark.parametrize("gray_depth", [True, False], ids=["gray_depth", "rgb_depth"])
def test_preprocess_writes_the_jax_arrays(tmp_path, size, gray_depth):
    rgb, depth, albedo, normal, gt = _png_dirs(str(tmp_path / "png"), gray_depth=gray_depth)
    want = jax_preprocess.preprocess_png_dirs(str(tmp_path / "jax"), rgb, depth, albedo,
                                              normal, gt, size)
    got = preprocess_png_dirs(str(tmp_path / "torch"), rgb, depth, albedo, normal, gt, size)
    assert got == (str(tmp_path / "torch" / "input"), str(tmp_path / "torch" / "gt"))
    for g, w in zip(got, want):
        names = sorted(os.listdir(w))
        assert sorted(os.listdir(g)) == names == [f"frame_{i:03d}.npy" for i in range(3)]
        for name in names:
            a, b = np.load(os.path.join(g, name)), np.load(os.path.join(w, name))
            assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
            assert a.shape == ((size, size, 10) if g.endswith("input") else (size, size, 3))
            np.testing.assert_array_equal(a, b)


def test_preprocess_cli_and_refusal_without_a_resizer(tmp_path, monkeypatch):
    from ai_path_tracer_denoiser_tpu_torch.app.cli import main
    rgb, depth, albedo, normal, gt = _png_dirs(str(tmp_path / "png"), n=2)
    out = main(["preprocess", "--root", str(tmp_path / "out"), "--rgb", rgb, "--depth", depth,
                "--albedo", albedo, "--normal", normal, "--gt", gt, "--size", "8"])
    assert np.load(os.path.join(out[0], "frame_001.npy")).shape == (8, 8, 10)
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    img = np.zeros((4, 4, 3), np.uint8)
    errors = []
    for module in (preprocess, jax_preprocess):
        with pytest.raises(ImportError) as info:
            module._resize(img, 2)
        errors.append((type(info.value), str(info.value)))
    assert errors[0] == errors[1]
