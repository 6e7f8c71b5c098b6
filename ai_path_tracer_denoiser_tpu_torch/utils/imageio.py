"""PNG writing and reading in numpy (counterpart of utils/imageio.py).

``save_png_scaled`` is image::savePNG_scaled (image.cpp:41-58): clamp to
[0, 1], scale by 255, write 8-bit.  The encoder is self-contained (stdlib
zlib, filter type 0 on every row); ``read_png`` decodes what it writes.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _png_chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def encode_png(rgb: np.ndarray) -> bytes:
    """uint8 (H, W, 1|3|4) -> PNG bytes."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3:
        raise ValueError(f"expected uint8 (H, W, C), got {rgb.dtype} {rgb.shape}")
    h, w, c = rgb.shape
    color_type = {1: 0, 3: 2, 4: 6}[c]
    header = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * c)],
                          axis=1)
    return (_SIGNATURE + _png_chunk(b"IHDR", header)
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


def save_png(path: str, pixels: np.ndarray) -> str:
    """Raw-cast save (image::savePNG, image.cpp:22-39), clipped to [0, 255]."""
    arr = np.clip(np.asarray(pixels), 0, 255).astype(np.uint8)
    if not path.endswith(".png"):
        path = path + ".png"
    with open(path, "wb") as f:
        f.write(encode_png(arr))
    return path


def save_png_scaled(path: str, pixels: np.ndarray) -> str:
    """clamp [0,1] then x255 (image::savePNG_scaled, image.cpp:41-58)."""
    arr = (np.clip(np.asarray(pixels, np.float32), 0.0, 1.0) * 255.0).astype(np.uint8)
    return save_png(path, arr)


def read_png(path: str) -> np.ndarray:
    """PNG written by ``save_png`` -> uint8 (H, W, C).

    Decodes 8-bit, non-interlaced images whose rows all use filter type 0,
    which is what this module writes; raises on anything else.
    """
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG")
    pos, idat = 8, b""
    w = h = channels = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            w, h, depth, color_type, _, _, interlace = struct.unpack(
                ">IIBBBBB", payload)
            if depth != 8 or interlace != 0:
                raise ValueError(f"{path}: unsupported PNG layout")
            channels = {0: 1, 2: 3, 4: 2, 6: 4}[color_type]
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
        pos += 12 + length
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        h, w * channels + 1)
    if rows[:, 0].any():
        raise ValueError(f"{path}: filtered rows are not supported")
    return rows[:, 1:].reshape(h, w, channels).copy()
