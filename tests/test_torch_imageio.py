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
