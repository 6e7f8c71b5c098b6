"""The port's ``read_png`` against the JAX package's, on the CPU.

A small PNG writer here emits every row with a chosen filter type (0-4:
None, Sub, Up, Average, Paeth, or a different one per row, as
stb_image_write picks them) in gray, gray+alpha, RGB and RGBA.  Both
packages' ``read_png`` must decode the file to equal arrays: the JAX one
through PIL's ``convert("RGB")`` (gray replicated, alpha dropped), the
port's with its own decoder.  The pixels are drawn from a numpy seed.
"""
import struct
import zlib

import numpy as np
import pytest

from ai_path_tracer_denoiser_tpu.utils.imageio import read_png as jax_read_png
from ai_path_tracer_denoiser_tpu.utils.imageio import save_png as jax_save_png
from ai_path_tracer_denoiser_tpu_torch.utils import imageio, native
from ai_path_tracer_denoiser_tpu_torch.utils.imageio import read_png

COLOR_TYPES = {"gray": (0, 1), "gray_alpha": (4, 2), "rgb": (2, 3), "rgba": (6, 4)}


def _chunk(tag, payload):
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)


def _filter_row(ftype, line, prev, bpp):
    out = bytearray([ftype])
    for i, v in enumerate(line):
        a = line[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[ftype]
        out.append((v - pred) & 0xFF)
    return bytes(out)


def write_png(path, img, color_type, filters):
    """uint8 (H, W, C) -> PNG with row y filtered by filters[y % len]."""
    h, w, c = img.shape
    rows, prev = b"", [0] * (w * c)
    for y in range(h):
        line = [int(v) for v in img[y].reshape(-1)]
        rows += _filter_row(filters[y % len(filters)], line, prev, c)
        prev = line
    header = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(rows, 6)) + _chunk(b"IEND", b""))


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)],
                         ids=["none", "sub", "up", "average", "paeth", "per_row"])
@pytest.mark.parametrize("kind", list(COLOR_TYPES))
def test_read_png_matches_jax(tmp_path, kind, filters):
    color_type, channels = COLOR_TYPES[kind]
    rng = np.random.default_rng(7 + channels)
    img = rng.integers(0, 256, size=(9, 13, channels), dtype=np.uint8)
    img[2:5, 3:9] = img[2, 3]                     # flat patches: small residuals
    path = str(tmp_path / f"{kind}.png")
    write_png(path, img, color_type, filters)
    got, want = read_png(path), jax_read_png(path)
    assert got.dtype == np.uint8 and got.shape == (9, 13, 3)
    np.testing.assert_array_equal(got, want)
    # and the pixels are the ones written, gray replicated, alpha dropped
    np.testing.assert_array_equal(got, np.repeat(img[..., :1], 3, -1)
                                  if channels <= 2 else img[..., :3])


def test_read_png_refuses_a_filter_type_that_does_not_exist(tmp_path):
    path = str(tmp_path / "bad.png")
    write_png(path, np.zeros((2, 3, 3), np.uint8), 2, (0,))
    data = open(path, "rb").read()
    raw = bytearray(zlib.decompress(data[data.index(b"IDAT") + 4:data.index(b"IEND") - 8]))
    raw[0] = 5
    header = struct.pack(">IIBBBBB", 3, 2, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(bytes(raw))) + _chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="filter 5"):
        read_png(path)


def _hdr_pixels(seed):
    """Seeded (H, W, 3) radiance with zeros, values under 1e-32, over 1."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (11, 7, 3)).astype(np.float32)
    img[0] = 0.0                                       # black row
    img[1, :, :] = 1e-33                               # below the RGBE threshold
    img[2, :3] = rng.uniform(1, 300, (3, 3))           # over 1
    img[3, 1] = [0.0, 5e-33, 2e-32]                    # one channel just over it
    img[4] = rng.uniform(0, 1e-5, (7, 3))              # tiny
    return img


@pytest.mark.parametrize("name", ["frame.hdr", "frame"])
@pytest.mark.parametrize("seed", [0, 1])
def test_save_hdr_writes_the_jax_bytes(tmp_path, name, seed):
    from ai_path_tracer_denoiser_tpu.utils.imageio import save_hdr as jax_save_hdr
    from ai_path_tracer_denoiser_tpu_torch.utils import save_hdr
    img = _hdr_pixels(seed)
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    want = jax_save_hdr(str(tmp_path / "jax" / name), img)
    got = save_hdr(str(tmp_path / "torch" / name), img)
    assert got.endswith("frame.hdr") and want.endswith("frame.hdr")
    data = open(got, "rb").read()
    assert data == open(want, "rb").read()
    assert data.startswith(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 11 +X 7\n")
    rgbe = np.frombuffer(data[-11 * 7 * 4:], np.uint8).reshape(11, 7, 4)
    assert (rgbe[0] == 0).all() and (rgbe[1] == 0).all() and rgbe[2, 0, 3] > 128


def decode_rgbe(path):
    """A flat RGBE .hdr -> (H, W, 3) float32, each mantissa taken at the
    middle of its step (Radiance's decode): within 2**-8 of each pixel's
    largest channel of what ``save_hdr`` was given."""
    data = open(path, "rb").read()
    head, _, rest = data.partition(b"\n\n")
    assert head.startswith(b"#?RADIANCE")
    dims, _, body = rest.partition(b"\n")
    _, h, _, w = dims.split()
    rgbe = np.frombuffer(body, np.uint8).reshape(int(h), int(w), 4).astype(np.float64)
    scale = np.where(rgbe[..., 3] > 0, np.ldexp(1.0, rgbe[..., 3].astype(int) - 136), 0.0)
    return ((rgbe[..., :3] + 0.5) * scale[..., None]).astype(np.float32)


def test_render_hdr_and_gbuffer_match_the_jax_cli(tmp_path):
    """``render --hdr --save-gbuffer`` at 32x32 through both CLIs: the HDR
    header equal, its pixel bytes equal where the two images are bitwise
    equal (radiance is, ROADMAP C), the G-buffer (10, H, W) within the
    render bar (isclose(1e-5, 1e-5) on >= 99.8% of pixels)."""
    from ai_path_tracer_denoiser_tpu.app.cli import main as jax_main
    from ai_path_tracer_denoiser_tpu_torch.app.cli import main
    argv = ["render", "scenes/cornell_box.txt", "--res", "32", "--spp", "2",
            "--hdr", "--save-gbuffer", "--platform", "cpu"]
    jax_main(argv + ["--out", str(tmp_path / "jax.png")])
    written = main(argv + ["--out", str(tmp_path / "torch.png")])
    assert written == {"png": str(tmp_path / "torch.png"), "hdr": str(tmp_path / "torch.hdr"),
                       "gbuffer": str(tmp_path / "torch_gbuffer.npy")}
    got, want = open(written["hdr"], "rb").read(), open(tmp_path / "jax.hdr", "rb").read()
    assert len(got) == len(want) and got[:-32 * 32 * 4] == want[:-32 * 32 * 4]
    img_t, img_j = decode_rgbe(written["hdr"]), decode_rgbe(str(tmp_path / "jax.hdr"))
    png_t, png_j = read_png(written["png"]), jax_read_png(str(tmp_path / "jax.png"))
    same = (png_t == png_j).all(axis=-1)
    assert same.mean() >= 0.99
    rgbe_t = np.frombuffer(got[-32 * 32 * 4:], np.uint8).reshape(32, 32, 4)
    rgbe_j = np.frombuffer(want[-32 * 32 * 4:], np.uint8).reshape(32, 32, 4)
    equal = (rgbe_t == rgbe_j).all(axis=-1)
    assert equal.mean() >= 0.99, equal.mean()
    # the HDR holds the displayed (un-mirrored) image to RGBE precision
    from ai_path_tracer_denoiser_tpu_torch.app.cli import _load_scene_scaled
    from ai_path_tracer_denoiser_tpu_torch.render import render
    image = render(_load_scene_scaled("scenes/cornell_box.txt", "cpu", 32), num_iterations=2)[0]
    image = image.flip(1).numpy()
    assert np.all(np.abs(img_t - image) <= 2 ** -8 * image.max(axis=-1, keepdims=True) + 1e-30)
    assert np.abs(img_j - img_t)[equal].max() == 0.0
    gt, gj = np.load(written["gbuffer"]), np.load(str(tmp_path / "jax_gbuffer.npy"))
    assert gt.shape == gj.shape == (10, 32, 32) and gt.dtype == np.float32
    ok = np.isclose(gt[3:], gj[3:], rtol=1e-5, atol=1e-5).all(axis=0)
    assert ok.mean() >= 0.998, ok.mean()
    np.testing.assert_array_equal(gt[:3], gj[:3])


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_native_write_png_and_save_png_decode_to_the_jax_file(tmp_path, channels):
    """The native writer (``utils/native.py:write_png``) and ``save_png``
    (``encode_png``) write files that decode to the pixels of the JAX
    package's ``save_png``, and the same bytes."""
    pixels = np.random.default_rng(channels).uniform(-20, 275, (19, 23, channels))
    want = jax_read_png(jax_save_png(str(tmp_path / "jax"), pixels))
    assert native.available()
    native_path = str(tmp_path / "native.png")
    native.write_png(native_path, np.clip(pixels, 0, 255).astype(np.uint8))
    python_path = imageio.save_png(str(tmp_path / "python"), pixels)
    for path in (native_path, python_path):
        np.testing.assert_array_equal(read_png(path), want)
        np.testing.assert_array_equal(jax_read_png(path), want)
    with open(native_path, "rb") as a, open(python_path, "rb") as b:
        assert a.read() == b.read()
