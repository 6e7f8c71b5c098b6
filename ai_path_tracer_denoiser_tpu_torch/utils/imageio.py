"""PNG and Radiance HDR writing, PNG reading, in numpy (counterpart of
utils/imageio.py).

``save_png_scaled`` is image::savePNG_scaled (image.cpp:41-58): clamp to
[0, 1], scale by 255, write 8-bit.  ``save_hdr`` is image::saveHDR
(image.cpp:60-64): flat RGBE scanlines.  The encoder is self-contained (stdlib
zlib, filter type 0 on every row).  ``read_png`` decodes any 8-bit
non-interlaced PNG (all five row filters; gray, gray+alpha, RGB, RGBA) and
returns RGB, as the JAX package's ``read_png`` does through PIL's
``convert("RGB")``.
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


def save_hdr(path: str, pixels: np.ndarray) -> str:
    """Radiance RGBE .hdr writer (image::saveHDR, image.cpp:60-64), flat
    (uncompressed) scanlines; ``.hdr`` is appended where the path lacks it."""
    img = np.asarray(pixels, np.float32)
    h, w, _ = img.shape
    if not path.endswith(".hdr"):
        path = path + ".hdr"
    maxc = img.max(axis=-1)
    exp = np.zeros((h, w), np.int32)
    mant = np.zeros((h, w), np.float64)
    nz = maxc > 1e-32
    mant[nz], exp[nz] = np.frexp(maxc[nz])
    scale = np.where(nz, mant * 256.0 / np.maximum(maxc, 1e-32), 0.0)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(img * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(nz, exp + 128, 0).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())
    return path


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the PNG row filters (None, Sub, Up, Average, Paeth) of the
    decompressed scanlines -> uint8 (H, W * bpp)."""
    rows = raw.reshape(h, w * bpp + 1)
    out = np.zeros((h, w * bpp), np.int32)
    prev = np.zeros(w * bpp, np.int32)
    for y in range(h):
        ftype, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 1:           # Sub: running sum per channel along the row
            cur = np.cumsum(line.reshape(w, bpp), axis=0).reshape(-1)
        elif ftype == 2:           # Up
            cur = line + prev
        elif ftype in (3, 4):      # Average, Paeth: pixel by pixel, channels at once
            cur = np.zeros(w * bpp, np.int32)
            left = np.zeros(bpp, np.int32)
            up_left = np.zeros(bpp, np.int32)
            for x in range(w):
                sl = slice(x * bpp, (x + 1) * bpp)
                up = prev[sl]
                pred = (left + up) // 2 if ftype == 3 else _paeth(left, up, up_left)
                left = (line[sl] + pred) & 0xFF
                cur[sl], up_left = left, up
        else:
            raise ValueError(f"PNG row filter {ftype} does not exist")
        prev = cur & 0xFF
        out[y] = prev
    return out.astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """8-bit non-interlaced PNG -> uint8 (H, W, 3).

    Any row filter; gray is replicated to three channels and alpha is
    dropped, as PIL's ``convert("RGB")`` does.  Raises on other bit depths,
    interlacing and palette images.
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
            if depth != 8 or interlace != 0 or color_type not in (0, 2, 4, 6):
                raise ValueError(f"{path}: unsupported PNG layout")
            channels = {0: 1, 2: 3, 4: 2, 6: 4}[color_type]
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
        pos += 12 + length
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    img = _unfilter(raw, h, w, channels).reshape(h, w, channels)
    if channels <= 2:                      # gray (+ alpha): replicate the gray
        return np.repeat(img[..., :1], 3, axis=-1)
    return img[..., :3].copy()
