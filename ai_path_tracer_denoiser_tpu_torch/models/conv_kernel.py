"""Fused SAME conv3x3 + bias + LeakyReLU (+ affine) (counterpart of
models/conv_kernel.py).

Two kernels, as in the JAX package, with its entry points' names and
arguments and the activation channels-last:

* ``conv3x3_act_chw`` (impl "pallas2"): x (H, W, C) or (N, H, W, C) ->
  (..., Co).  On the card it launches csrc/conv3x3_act.cu, a 16x16 pixel
  tile x 32 output channels per block; bfloat16 or float32 input, float32
  accumulation, bfloat16 or float32 output.  Training uses it for the
  conv's forward pass and input gradient (models/layers.py).
* ``conv3x3_act`` (impl "pallas"): the row-band kernel
  csrc/conv3x3_rows.cu, which stages a band of rows once for all taps and
  all output channels and takes the weights packed by ``pack_weights``;
  optionally the input arrives zero-bordered (``conv_input_pad``).

On CPU tensors each wrapper runs its plain PyTorch version
(``conv3x3_act_plain``: nine shifted float32 matrix products;
``conv3x3_act_rows_plain``: the row operand times the packed weights, three
shifted slices added).  On a CUDA tensor a wrapper launches its kernel or
raises.  The kernels' designs and what bounds them are described at the top
of their sources.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..utils.cuda_build import CudaKernel, check

TH = 8                   # output rows per band of the row-band kernel


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.aptd_conv3x3_act.restype = i
    lib.aptd_conv3x3_act.argtypes = [p, p, p, p, p, p, i, i, i, i, i,
                                     ctypes.c_float, i, i, i, p]


def _declare_rows(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.aptd_conv3x3_rows.restype = i
    lib.aptd_conv3x3_rows.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i,
                                      ctypes.c_float, i, i, p]


KERNEL = CudaKernel("conv3x3_act", "conv3x3_act.cu", declare=_declare,
                    headers=("conv_mma.cuh",))
ROWS_KERNEL = CudaKernel("conv3x3_rows", "conv3x3_rows.cu",
                         declare=_declare_rows, headers=("conv_mma.cuh",))


def _out_dtype(x: torch.Tensor, out_dtype) -> torch.dtype:
    if out_dtype is None:
        return x.dtype
    if isinstance(out_dtype, str):
        return getattr(torch, out_dtype)
    return out_dtype


def _epilogue(acc: torch.Tensor, b, slope: float, affine) -> torch.Tensor:
    y = acc + b.to(torch.float32)
    y = torch.where(y >= 0, y, slope * y)
    if affine is not None:
        y = y * affine["s"].to(torch.float32) + affine["t"].to(torch.float32)
    return y


def conv3x3_act_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                      slope: float, affine: Optional[dict] = None,
                      out_dtype=None) -> torch.Tensor:
    """The tile kernel's plain PyTorch version: x (H, W, C) or
    (N, H, W, C), w (3, 3, C, Co).

    Inputs are taken as float32 (bfloat16 products are exact in float32),
    the nine taps are (N*H*W, C) @ (C, Co) float32 products summed in
    float32, then bias, LeakyReLU(slope) and the optional x*s+t, rounded
    once to the output dtype.
    """
    xb = x if x.dim() == 4 else x[None]
    n, h, wd, c = xb.shape
    co = w.shape[-1]
    xp = F.pad(xb.to(torch.float32), (0, 0, 1, 1, 1, 1))
    wf = w.to(torch.float32)
    acc = None
    for dy in range(3):
        for dx in range(3):
            part = xp[:, dy:dy + h, dx:dx + wd].reshape(n * h * wd, c) @ wf[dy, dx]
            acc = part if acc is None else acc + part
    y = _epilogue(acc.reshape(n, h, wd, co), b, slope, affine)
    y = y.to(_out_dtype(x, out_dtype))
    return y if x.dim() == 4 else y[0]


def _vec(v: torch.Tensor, co: int, dev: torch.device) -> torch.Tensor:
    v = v.to(device=dev, dtype=torch.float32).contiguous()
    if v.shape != (co,):
        raise ValueError(f"expected a ({co},) vector, got {tuple(v.shape)}")
    return v


def _epilogue_vectors(b, affine, co, dev):
    bias = _vec(b, co, dev)
    if affine is None:
        return bias, bias, bias          # scale and shift are not read
    return bias, _vec(affine["s"], co, dev), _vec(affine["t"], co, dev)


def _check_input(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"no conv kernel for device {x.device}")
    if (x.dtype not in (torch.bfloat16, torch.float32) or x.dim() not in (3, 4)
            or not x.is_contiguous()):
        raise ValueError(f"the {what} kernel takes a contiguous (H, W, C) or "
                         "(N, H, W, C) bfloat16 or float32 tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")


def conv3x3_act_chw(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    slope: float, affine: Optional[dict] = None,
                    out_dtype=None) -> torch.Tensor:
    """Fused SAME conv3x3 + bias + LeakyReLU [+ affine x*s+t].

    Args:
      x: (H, W, C) or (N, H, W, C) activation; on the card contiguous
        bfloat16 or float32.
      w: (3, 3, C, Co) weights, used in x's dtype.
      b: (Co,) bias; affine: optional {"s": (Co,), "t": (Co,)} applied
        after the LeakyReLU (the folded bn2 of models/inference.py).
      out_dtype: output dtype (default x's), e.g. "float32".
    Returns (H, W, Co) or (N, H, W, Co).
    """
    if x.device.type == "cpu":
        return conv3x3_act_plain(x, w, b, slope, affine, out_dtype)
    _check_input(x, "conv")
    n = x.shape[0] if x.dim() == 4 else 1
    h, wd, c = x.shape[-3:]
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, c):
        raise ValueError(f"weights {tuple(w.shape)} do not match {c} channels")
    co = w.shape[-1]
    dev = x.device
    wk = w.to(device=dev, dtype=x.dtype).contiguous()
    bias, s, t = _epilogue_vectors(b, affine, co, dev)
    odt = _out_dtype(x, out_dtype)
    if odt not in (torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype {odt} not supported by the conv kernel")
    out = torch.empty((*x.shape[:-1], co), dtype=odt, device=dev)
    lib = KERNEL.lib()
    with torch.cuda.device(dev):
        rc = lib.aptd_conv3x3_act(
            x.data_ptr(), wk.data_ptr(), bias.data_ptr(), s.data_ptr(),
            t.data_ptr(), out.data_ptr(), n, h, wd, c, co, float(slope),
            int(affine is not None), int(x.dtype == torch.float32),
            int(odt == torch.float32),
            torch.cuda.current_stream().cuda_stream)
    check(rc, "conv3x3_act kernel")
    KERNEL.launches += 1
    return out


# ---------------------------------------------------------------------------
# The row-band kernel (impl "pallas")
# ---------------------------------------------------------------------------

def pack_weights(w: torch.Tensor) -> torch.Tensor:
    """(3, 3, C, Co) conv weights -> (3C, 3Co) block layout.

    Wall[dy*C + c, dx*Co + o] = w[dy, dx, c, o].
    """
    _, _, c, co = w.shape
    return w.permute(0, 2, 1, 3).reshape(3 * c, 3 * co)


def conv_input_pad(x: torch.Tensor) -> torch.Tensor:
    """(..., H, W, C) -> zero-padded (..., H+2, Wp, C) (SAME halo), Wp = W + 2
    rounded up to a multiple of 8 as in the JAX package; the extra zero
    columns sit past x+dx = W+1 and never reach an output."""
    w2 = x.shape[-2] + 2
    wp = -(-w2 // 8) * 8
    return F.pad(x, (0, 0, 1, wp - w2 + 1, 1, 1))


def supported_height(h: int) -> bool:
    """Whether the JAX kernel takes this height (whole bands of TH rows).
    The CUDA kernel masks a ragged last band and takes any height."""
    return h % TH == 0


def _rows_geometry(x: torch.Tensor, pre_padded: bool, width: Optional[int]
                   ) -> Tuple[int, int]:
    if not pre_padded:
        return x.shape[-3], x.shape[-2]
    if width is None:
        raise ValueError("pre_padded input needs width= (the logical W)")
    if x.shape[-2] < width + 2:
        raise ValueError(f"padded width {x.shape[-2]} < {width} + 2")
    return x.shape[-3] - 2, width


def conv3x3_act_rows_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                           slope: float, affine: Optional[dict] = None,
                           pre_padded: bool = False,
                           width: Optional[int] = None) -> torch.Tensor:
    """The row-band kernel's plain PyTorch version, in that kernel's own
    decomposition: pad, build the (Wp, 3C) operand of every output row
    (three consecutive padded rows side by side), ONE float32 product with
    the packed (3C, 3Co) weights, then the dx alignment as three shifted
    slices added, bias, LeakyReLU, affine; rounded once to x's dtype."""
    xb = x if x.dim() == 4 else x[None]
    h, w_pix = _rows_geometry(xb, pre_padded, width)
    xp = xb if pre_padded else conv_input_pad(xb)
    xp = xp.to(torch.float32)
    co = w.shape[-1]
    rows = torch.cat([xp[:, 0:h], xp[:, 1:h + 1], xp[:, 2:h + 2]], dim=-1)
    z = rows @ pack_weights(w.to(torch.float32))            # (N, H, Wp, 3Co)
    acc = (z[:, :, 0:w_pix, 0:co] + z[:, :, 1:w_pix + 1, co:2 * co]
           + z[:, :, 2:w_pix + 2, 2 * co:3 * co])
    y = _epilogue(acc, b, slope, affine).to(x.dtype)
    return y if x.dim() == 4 else y[0]


def conv3x3_act(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                slope: float, affine: Optional[dict] = None,
                pre_padded: bool = False,
                width: Optional[int] = None) -> torch.Tensor:
    """Fused SAME conv3x3 + bias + LeakyReLU(slope) [+ affine x*s+t]
    through the row-band kernel.

    Args:
      x: (H, W, C) or (N, H, W, C) activation, or the ``conv_input_pad``
        layout (..., H+2, Wp, C) when ``pre_padded`` (then ``width`` = W).
      w: (3, 3, C, Co) weights, used in x's dtype; b: (Co,) bias.
      affine: optional {"s": (Co,), "t": (Co,)} applied after the LReLU.
    Returns (..., H, W, Co) in x's dtype.
    """
    if x.device.type == "cpu":
        return conv3x3_act_rows_plain(x, w, b, slope, affine, pre_padded, width)
    _check_input(x, "row-band conv")
    n = x.shape[0] if x.dim() == 4 else 1
    ha, wa, c = x.shape[-3:]
    h, w_pix = _rows_geometry(x, pre_padded, width)
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, c):
        raise ValueError(f"weights {tuple(w.shape)} do not match {c} channels")
    co = w.shape[-1]
    dev = x.device
    wall = pack_weights(w.to(device=dev, dtype=x.dtype)).contiguous()
    bias, s, t = _epilogue_vectors(b, affine, co, dev)
    out = torch.empty((*x.shape[:-3], h, w_pix, co), dtype=x.dtype, device=dev)
    lib = ROWS_KERNEL.lib()
    with torch.cuda.device(dev):
        rc = lib.aptd_conv3x3_rows(
            x.data_ptr(), wall.data_ptr(), bias.data_ptr(), s.data_ptr(),
            t.data_ptr(), out.data_ptr(), n, ha, wa, h, w_pix, c, co,
            int(pre_padded), float(slope), int(affine is not None),
            int(x.dtype == torch.float32),
            torch.cuda.current_stream().cuda_stream)
    check(rc, f"conv3x3_rows kernel ({c} input channels)")
    ROWS_KERNEL.launches += 1
    return out


# ---------------------------------------------------------------------------
# The conv's gradients, plain
# ---------------------------------------------------------------------------

def conv3x3_wgrad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dw[dy, dx, ci, co] = sum_{n,h,w} xpad[n, h+dy, w+dx, ci] g[n, h, w, co]:
    nine (rows, Ci)^T @ (rows, Co) contractions with float32 products and
    sums (bfloat16 operands are exact in float32).  Returns float32.

    Both operands are laid out once in the zero-bordered geometry
    (N, H+2, W+2, .) and flattened to rows.  A tap's shift (dy, dx) is then a
    row offset of (dy-1)*(W+2) + (dx-1), so each tap's operand is a
    contiguous slice of the padded x, not a copy; the rows the slices add
    beyond the image meet g's zero border and contribute nothing.
    """
    n, h, wd, ci = x.shape
    co = g.shape[-1]
    xp = F.pad(x.to(torch.float32), (0, 0, 1, 1, 1, 1)).reshape(-1, ci)
    gp = F.pad(g.to(torch.float32), (0, 0, 1, 1, 1, 1)).reshape(-1, co)
    row = wd + 2
    first = row + 1                       # the first interior row of the flat layout
    length = xp.shape[0] - 2 * first
    gc = gp[first:first + length]
    taps = []
    for dy in range(3):
        for dx in range(3):
            start = first + (dy - 1) * row + (dx - 1)
            taps.append(xp[start:start + length].T @ gc)
    return torch.stack(taps).reshape(3, 3, ci, co)


def conv3x3_backward_plain(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, dw) of y = conv3x3_same(x, w) for the output gradient g, written
    as the scatter of the forward pass and not as a second convolution:
    dxpad[n, h+dy, w+dx, :] += g[n, h, w, :] @ w[dy, dx].T.  x (N, H, W, Ci),
    w (3, 3, Ci, Co), g (N, H, W, Co); everything in float32."""
    n, h, wd, ci = x.shape
    gf, wf = g.to(torch.float32), w.to(torch.float32)
    dxp = torch.zeros((n, h + 2, wd + 2, ci), dtype=torch.float32, device=x.device)
    for dy in range(3):
        for dx in range(3):
            dxp[:, dy:dy + h, dx:dx + wd] += gf @ wf[dy, dx].T
    xp = F.pad(x.to(torch.float32), (0, 0, 1, 1, 1, 1))
    dw = torch.stack([torch.einsum("nhwc,nhwo->co", xp[:, dy:dy + h, dx:dx + wd], gf)
                      for dy in range(3) for dx in range(3)])
    return dxp[:, 1:h + 1, 1:wd + 1].contiguous(), dw.reshape(3, 3, ci, -1)


def conv_work(h: int, w: int, c: int, co: int, out_bytes: int = 2,
              n: int = 1, in_bytes: int = 2):
    """(bytes, multiply-adds) one call needs: input, weights and output
    each moved once, 9*C*Co multiply-adds per output pixel."""
    n_bytes = (n * h * w * c * in_bytes + 9 * c * co * in_bytes + 3 * co * 4
               + n * h * w * co * out_bytes)
    return n_bytes, n * h * w * 9 * c * co
