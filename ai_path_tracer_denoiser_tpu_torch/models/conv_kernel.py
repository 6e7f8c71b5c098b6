"""Fused SAME conv3x3 + bias + LeakyReLU (+ affine) (counterpart of
models/conv_kernel.py).

``conv3x3_act_chw`` keeps the JAX entry point's name and arguments, with
the activation channels-last: x (H, W, C) -> (H, W, Co).  On the card it
launches csrc/conv3x3_act.cu (bfloat16 input, float32 accumulation); on
CPU tensors it runs ``conv3x3_act_plain``, the same function as nine
shifted float32 matrix products.  The kernel's design and what bounds it
are described at the top of its source.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from ..utils.cuda_build import CudaKernel, check
from .layers import leaky_relu


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.aptd_conv3x3_act.restype = i
    lib.aptd_conv3x3_act.argtypes = [p, p, p, p, p, p, i, i, i, i,
                                     ctypes.c_float, i, i, p]


KERNEL = CudaKernel("conv3x3_act", "conv3x3_act.cu", declare=_declare)


def _out_dtype(x: torch.Tensor, out_dtype) -> torch.dtype:
    if out_dtype is None:
        return x.dtype
    if isinstance(out_dtype, str):
        return getattr(torch, out_dtype)
    return out_dtype


def conv3x3_act_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                      slope: float, affine: Optional[dict] = None,
                      out_dtype=None) -> torch.Tensor:
    """The kernel's plain PyTorch version: x (H, W, C), w (3, 3, C, Co).

    Inputs are taken as float32 (bfloat16 products are exact in float32),
    the nine taps are (H*W, C) @ (C, Co) float32 products summed in
    float32, then bias, LeakyReLU(slope) and the optional x*s+t, rounded
    once to the output dtype.
    """
    h, wd, c = x.shape
    co = w.shape[-1]
    xp = F.pad(x.to(torch.float32), (0, 0, 1, 1, 1, 1))
    wf = w.to(torch.float32)
    acc = None
    for dy in range(3):
        for dx in range(3):
            part = xp[dy:dy + h, dx:dx + wd].reshape(h * wd, c) @ wf[dy, dx]
            acc = part if acc is None else acc + part
    y = acc.reshape(h, wd, co) + b.to(torch.float32)
    y = leaky_relu(y, slope)
    if affine is not None:
        y = y * affine["s"].to(torch.float32) + affine["t"].to(torch.float32)
    return y.to(_out_dtype(x, out_dtype))


def _vec(v: torch.Tensor, co: int, dev: torch.device) -> torch.Tensor:
    v = v.to(device=dev, dtype=torch.float32).contiguous()
    if v.shape != (co,):
        raise ValueError(f"expected a ({co},) vector, got {tuple(v.shape)}")
    return v


def conv3x3_act_chw(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    slope: float, affine: Optional[dict] = None,
                    out_dtype=None) -> torch.Tensor:
    """Fused SAME conv3x3 + bias + LeakyReLU [+ affine x*s+t].

    Args:
      x: (H, W, C) activation; on the card it must be contiguous bfloat16.
      w: (3, 3, C, Co) weights, used in x's dtype.
      b: (Co,) bias; affine: optional {"s": (Co,), "t": (Co,)} applied
        after the LeakyReLU (the folded bn2 of models/inference.py).
      out_dtype: output dtype (default x's), e.g. "float32".
    Returns (H, W, Co).
    """
    if x.device.type == "cpu":
        return conv3x3_act_plain(x, w, b, slope, affine, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"no conv kernel for device {x.device}")
    if x.dtype != torch.bfloat16 or x.dim() != 3 or not x.is_contiguous():
        raise ValueError("the conv kernel takes a contiguous (H, W, C) "
                         f"bfloat16 tensor, got {x.dtype} {tuple(x.shape)}")
    h, wd, c = x.shape
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, c):
        raise ValueError(f"weights {tuple(w.shape)} do not match {c} channels")
    co = w.shape[-1]
    dev = x.device
    wk = w.to(device=dev, dtype=torch.bfloat16).contiguous()
    bias = _vec(b, co, dev)
    if affine is not None:
        s, t = _vec(affine["s"], co, dev), _vec(affine["t"], co, dev)
    else:
        s = t = bias          # not read
    odt = _out_dtype(x, out_dtype)
    if odt not in (torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype {odt} not supported by the conv kernel")
    out = torch.empty((h, wd, co), dtype=odt, device=dev)
    lib = KERNEL.lib()
    with torch.cuda.device(dev):
        rc = lib.aptd_conv3x3_act(
            x.data_ptr(), wk.data_ptr(), bias.data_ptr(), s.data_ptr(),
            t.data_ptr(), out.data_ptr(), h, wd, c, co, float(slope),
            int(affine is not None), int(odt == torch.float32),
            torch.cuda.current_stream().cuda_stream)
    check(rc, "conv3x3_act kernel")
    KERNEL.launches += 1
    return out


def conv_work(h: int, w: int, c: int, co: int, out_bytes: int = 2):
    """(bytes, multiply-adds) one call needs: input, weights and output
    each moved once, 9*C*Co multiply-adds per output pixel."""
    n_bytes = h * w * c * 2 + 9 * c * co * 2 + 3 * co * 4 + h * w * co * out_bytes
    return n_bytes, h * w * 9 * c * co
