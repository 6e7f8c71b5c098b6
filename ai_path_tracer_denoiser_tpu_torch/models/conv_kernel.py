"""Fused SAME conv3x3 + bias + LeakyReLU (+ affine) (counterpart of
models/conv_kernel.py).

Two kernels, as in the JAX package, with its entry points' names and
arguments and the activation channels-last:

* ``conv3x3_act_chw`` (impl "pallas2"): x (H, W, C) or (N, H, W, C) ->
  (..., Co).  On the card it launches csrc/conv3x3_act.cu: for bfloat16
  input a Hopper kernel (asynchronous copies, wgmma) in which a block
  covers a tile of 64 or 128 pixels and every output channel, with the
  weights packed by ``pack_weights_sm90`` and the launch planned by
  ``conv_plan``; for float32 input a 16x16 pixel tile x 32 output channels
  per block in 3xTF32.  float32 accumulation, bfloat16 or float32 output.
  Training uses it for the conv's forward pass and input gradient
  (models/layers.py).
* ``conv3x3_act`` (impl "pallas"): the row-band kernel
  csrc/conv3x3_rows.cu: for bfloat16 input a Hopper kernel built from the
  tile kernel's pieces in which a block covers a band of output rows by a
  64-pixel segment and every output channel, a warpgroup's 64 pixels being
  a run of one output row, with the weights packed by ``pack_weights_sm90``
  and the launch planned by ``rows_plan``; for float32 input the 3xTF32
  kernel that takes the weights packed by ``pack_weights``.  Optionally the
  input arrives zero-bordered (``conv_input_pad``).

On CPU tensors each wrapper runs its plain PyTorch version
(``conv3x3_act_plain``: nine shifted float32 matrix products;
``conv3x3_act_packed_plain`` computes the same from the packed weights, as
the bfloat16 kernel reads them;
``conv3x3_act_rows_plain``: the row operand times the packed weights, three
shifted slices added).  On a CUDA tensor a wrapper launches its kernel or
raises.  The kernels' designs and what bounds them are described at the top
of their sources.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..utils.cuda_build import CudaKernel, check
from ..utils.derived_cache import DerivedCache

TH = 8                   # output rows per band of the JAX row-band kernel


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.aptd_conv3x3_act.restype = i
    lib.aptd_conv3x3_act.argtypes = [p, p, p, p, p, p, i, i, i, i, i,
                                     ctypes.c_float, i, i, i, i, i, i, i, p]
    lib.aptd_conv3x3_pack_weights.restype = i
    lib.aptd_conv3x3_pack_weights.argtypes = [p, p, i, i, i, p]


def _declare_rows(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.aptd_conv3x3_rows.restype = i
    lib.aptd_conv3x3_rows.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i,
                                      ctypes.c_float, i, i, i, i, i, p]


KERNEL = CudaKernel("conv3x3_act", "conv3x3_act.cu", declare=_declare,
                    headers=("conv_mma.cuh", "conv_sm90.cuh"))
ROWS_KERNEL = CudaKernel("conv3x3_rows", "conv3x3_rows.cu",
                         declare=_declare_rows, headers=("conv_mma.cuh", "conv_sm90.cuh"))


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


# ---------------------------------------------------------------------------
# The bfloat16 tile kernel's weight layout and launch plan
# ---------------------------------------------------------------------------

# Output-channel groups of 8 that the kernel is built for (csrc/conv3x3_act.cu)
BLOCK_GROUPS = (1, 2, 3, 4, 5, 6, 7, 8, 10, 11, 13, 15, 19, 26)
SMS = 132                # the H100's SMs: the least number of blocks a launch should have
# (width, height) of a block's pixel tile, for one and for two warpgroups
TILE_SHAPES = {1: ((8, 8), (16, 4), (32, 2)), 2: ((16, 8), (8, 16), (32, 4))}


class ConvPlan(NamedTuple):
    """How the bfloat16 tile kernel covers one call: ``nwg`` warpgroups per
    block on a ``tw`` x ``th`` pixel tile, ``nb`` groups of 8 output channels
    per block, ``groups`` blocks over the channels of a tile."""
    nwg: int
    tw: int
    th: int
    nb: int
    groups: int
    blocks: int

    @property
    def n_cols(self) -> int:
        """Output channels of the packed weights: groups * nb * 8 >= Co."""
        return self.groups * self.nb * 8


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=256)
def conv_plan(n: int, h: int, w: int, co: int) -> ConvPlan:
    """The launch of the bfloat16 tile kernel for an (n, h, w, .) -> co call.

    Images of 132 x 128 pixels or more take two-warpgroup blocks of 128
    pixels, smaller ones 64; of the tile shapes the one with the fewest
    tiles (then the smallest halo) wins.  A block covers all ceil(co/8)
    groups of 8 output channels, unless that leaves fewer than ``SMS``
    blocks: then the channels are dealt out to the fewest blocks per tile
    that reach ``SMS`` (or to one group per block).
    """
    nwg = 2 if h * w >= SMS * 128 else 1
    tw, th = min(TILE_SHAPES[nwg], key=lambda t: (_cdiv(w, t[0]) * _cdiv(h, t[1]),
                                                 (t[0] + 2) * (t[1] + 2)))
    tiles = n * _cdiv(w, tw) * _cdiv(h, th)
    need = _cdiv(co, 8)
    for groups in range(_cdiv(need, BLOCK_GROUPS[-1]), need + 1):
        nb = next(g for g in BLOCK_GROUPS if g >= _cdiv(need, groups))
        groups = _cdiv(need, nb)
        if tiles * groups >= SMS:
            break
    return ConvPlan(nwg, tw, th, nb, groups, tiles * groups)


def pack_weights_sm90(w: torch.Tensor, n_cols: Optional[int] = None) -> torch.Tensor:
    """(k, k, C, Co) conv weights -> (ceil(C/16), k*k, n_cols/8, 2, 8, 8).

    The bfloat16 tile kernels' B operand (k = 3: csrc/conv3x3_act.cu; k =
    5: csrc/conv5x5_act.cu): for each 16-channel chunk and tap t = k dy +
    dx, the 16 x n_cols slice in core matrices of 8 output x 8 input
    channels, input channels contiguous:
    packed[kc, t, j, h, r, c] = w[dy, dx, 16kc + 8h + c, 8j + r], zero past
    C and past Co.  ``n_cols`` (a multiple of 8, default Co rounded up to 8)
    is ``ConvPlan.n_cols``.
    """
    ks, _, c, co = w.shape
    n_cols = _cdiv(co, 8) * 8 if n_cols is None else n_cols
    if n_cols % 8 or n_cols < co:
        raise ValueError(f"n_cols={n_cols}: a multiple of 8, at least {co}")
    kc = _cdiv(c, 16)
    wp = F.pad(w, (0, n_cols - co, 0, 16 * kc - c))
    wp = wp.reshape(ks * ks, kc, 2, 8, n_cols // 8, 8)       # t, k, h, c, j, r
    return wp.permute(1, 0, 4, 2, 5, 3).contiguous()


# Packed weights of recent calls: the denoiser's 28 layers call with the
# same weight tensors every frame.
_PACKED = DerivedCache(64)


def _packed_weights(w: torch.Tensor, dtype: torch.dtype, dev: torch.device,
                    n_cols: int) -> torch.Tensor:
    """``pack_weights_sm90(w, n_cols)`` on the card, cached.  On a miss the
    card packs them in one launch of the packing kernel beside the tile
    conv kernel (csrc/conv3x3_act.cu:pack_weights_sm90)."""
    def pack():
        wd = w.detach().to(device=dev, dtype=dtype).contiguous()
        c, co = wd.shape[2:]
        wp = torch.empty((_cdiv(c, 16), 9, n_cols // 8, 2, 8, 8), dtype=dtype, device=dev)
        with torch.cuda.device(dev):
            rc = KERNEL.lib().aptd_conv3x3_pack_weights(
                wd.data_ptr(), wp.data_ptr(), c, co, n_cols,
                torch.cuda.current_stream().cuda_stream)
        check(rc, "conv3x3_act weight packing")
        return wp
    return _PACKED.get(w, (dtype, dev, n_cols), pack)


def unpack_weights_sm90(wp: torch.Tensor, c: int, co: int) -> torch.Tensor:
    """The inverse of ``pack_weights_sm90``: -> (3, 3, c, co)."""
    kc, _, nj = wp.shape[:3]
    w = wp.permute(1, 0, 3, 5, 2, 4).reshape(3, 3, 16 * kc, 8 * nj)
    return w[:, :, :c, :co]


def conv3x3_act_packed_plain(x: torch.Tensor, wp: torch.Tensor, b: torch.Tensor,
                             slope: float, affine: Optional[dict] = None,
                             out_dtype=None) -> torch.Tensor:
    """The conv computed from the packed weights as the bfloat16 tile kernel
    reads them: for each 16-channel chunk and tap, the shifted input's chunk
    (zero past C) times the chunk's 16 x n_cols B operand (float32 products
    and sums), then bias, LeakyReLU, affine on the first Co = len(b)
    channels, rounded once to the output dtype."""
    xb = x if x.dim() == 4 else x[None]
    n, h, wd, c = xb.shape
    kc, _, nj = wp.shape[:3]
    co = b.shape[0]
    xp = F.pad(xb.to(torch.float32), (0, 16 * kc - c, 1, 1, 1, 1))
    bmat = wp.to(torch.float32).permute(0, 1, 3, 5, 2, 4).reshape(kc, 9, 16, 8 * nj)
    acc = torch.zeros((n * h * wd, 8 * nj), dtype=torch.float32, device=x.device)
    for k in range(kc):
        for t in range(9):
            a = xp[:, t // 3:t // 3 + h, t % 3:t % 3 + wd, 16 * k:16 * k + 16]
            acc += a.reshape(-1, 16) @ bmat[k, t]
    y = _epilogue(acc[:, :co].reshape(n, h, wd, co), b, slope, affine)
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
    f32_in = x.dtype == torch.float32
    if f32_in:
        plan = None
        wk = w.to(device=dev, dtype=x.dtype).contiguous()
    else:
        plan = conv_plan(n, h, wd, co)
        wk = _packed_weights(w, x.dtype, dev, plan.n_cols)
        if x.data_ptr() % 16:            # the kernel's copies start on 16-byte boundaries
            x = x.clone()
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
            int(affine is not None), int(f32_in), int(odt == torch.float32),
            *((0, 0, 0, 0) if plan is None else
              (plan.tw, plan.nwg, plan.nb, plan.groups * plan.nb)),
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


# The bfloat16 row-band kernel's geometry (csrc/conv3x3_rows.cu)
ROWS_SEG = 64            # pixels of a band's segment: one warpgroup's M
RING_MAX = 3             # stages of its halo + weight ring
PIX_BYTES = 48           # a halo pixel's slot in shared memory
ROWS_FILL = 88           # blocks a launch should have: 2/3 of SMS


class RowsPlan(NamedTuple):
    """How the bfloat16 row-band kernel covers one call: blocks of two
    warpgroups, each on ``mt`` output rows of a 64-pixel segment (a band of
    ``th`` rows), ``nb`` groups of 8 output channels per block, ``groups``
    blocks over the channels of a band; ``smem`` bytes of dynamic shared
    memory per block."""
    mt: int
    nb: int
    groups: int
    blocks: int
    smem: int

    @property
    def th(self) -> int:
        return 2 * self.mt

    @property
    def n_cols(self) -> int:
        """Output channels of the packed weights: groups * nb * 8 >= Co."""
        return self.groups * self.nb * 8


@functools.lru_cache(maxsize=256)
def rows_plan(n: int, h: int, w: int, c: int, co: int) -> RowsPlan:
    """The launch of the bfloat16 row-band kernel for an (n, h, w, c) -> co
    call.

    A warpgroup takes two rows (a 4-row band, whose halo is read for 256
    outputs) where a block covers at most 32 output channels and the 4-row
    bands alone launch at least ``SMS`` blocks; otherwise one row.  A block
    covers all ceil(co/8) groups of 8 output channels unless that leaves
    fewer than ``ROWS_FILL`` blocks: then the channels are dealt out to the
    fewest blocks per band that reach it (or to one group per block).  Both
    rules and the threshold come from a sweep of launch plans over the
    frame's shapes on an H100 (csrc/conv3x3_rows.cu).
    """
    need = _cdiv(co, 8)
    segs = n * _cdiv(w, ROWS_SEG)
    mt = 2 if need <= 4 and segs * _cdiv(h, 4) >= SMS else 1
    bands = segs * _cdiv(h, 2 * mt)
    for groups in range(_cdiv(need, BLOCK_GROUPS[-1]), need + 1):
        nb = next(g for g in BLOCK_GROUPS if g >= _cdiv(need, groups))
        groups = _cdiv(need, nb)
        if bands * groups >= ROWS_FILL:
            break
    halo = (2 * mt + 2) * (ROWS_SEG + 2) * PIX_BYTES
    smem = min(_cdiv(c, 16), RING_MAX) * (halo + 9 * nb * 256) + (0 if c % 8 == 0 else halo)
    return RowsPlan(mt, nb, groups, bands * groups, smem)


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
    f32_in = x.dtype == torch.float32
    if f32_in:
        plan = None
        wk = _PACKED.get(w, ("rows", dev), lambda: pack_weights(
            w.detach().to(device=dev, dtype=x.dtype)).contiguous())
    else:
        plan = rows_plan(n, h, w_pix, c, co)
        wk = _packed_weights(w, x.dtype, dev, plan.n_cols)
        if x.data_ptr() % 16:            # the kernel's copies start on 16-byte boundaries
            x = x.clone()
    bias, s, t = _epilogue_vectors(b, affine, co, dev)
    out = torch.empty((*x.shape[:-3], h, w_pix, co), dtype=x.dtype, device=dev)
    lib = ROWS_KERNEL.lib()
    with torch.cuda.device(dev):
        rc = lib.aptd_conv3x3_rows(
            x.data_ptr(), wk.data_ptr(), bias.data_ptr(), s.data_ptr(),
            t.data_ptr(), out.data_ptr(), n, ha, wa, h, w_pix, c, co,
            int(pre_padded), float(slope), int(affine is not None), int(f32_in),
            *((0, 0, 0) if plan is None else (plan.mt, plan.nb, plan.groups * plan.nb)),
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


# ---------------------------------------------------------------------------
# The 5x5 tile kernel (K11, the kernel-predicting denoiser's convs)
# ---------------------------------------------------------------------------

def _declare5(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.aptd_conv5x5_act.restype = i
    lib.aptd_conv5x5_act.argtypes = [p, p, p, p, i, i, i, i, i, ctypes.c_float, i,
                                     i, i, i, i, p]


KERNEL5 = CudaKernel("conv5x5_act", "conv5x5_act.cu", declare=_declare5,
                     headers=("conv_sm90.cuh", "bulk_copy.cuh"))
# Output-channel groups of 8 that the 5x5 kernel is built for; its pixel
# tile (width, height): 256 pixels, two consumer warpgroups of two 64-pixel
# products, a tile row one 8-pixel core matrix; its two rings, of chunk
# halos ((TW + 4) x (TH + 4) pixels in two planes of 16 bytes a pixel) and
# of tap rows' weights (5 x 16 x 8 NB), with a full and an empty barrier of
# 8 bytes per stage, must fit in 227 KB
BLOCK_GROUPS5 = (1, 2, 4, 8, 13)
TILE5 = (8, 32)
HALO_STAGES5, W_STAGES5 = 3, 10
SMEM_MAX = 232448


def conv5_smem_bytes(nb: int) -> int:
    """K11's shared memory for ``nb`` channel groups a block."""
    tw, th = TILE5
    return (HALO_STAGES5 * (2 * (tw + 4) * (th + 4) * 16 + 16)
            + W_STAGES5 * (5 * nb * 256 + 16))


def conv5x5_act_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                      relu: bool, out_dtype=None) -> torch.Tensor:
    """K11's plain PyTorch version, in the order of ``conv3x3_act_plain``:
    x (N, H, W, C), w (5, 5, C, Co); the 25 taps are (N*H*W, C) @ (C, Co)
    float32 products summed in float32 (bfloat16 products are exact in
    float32), then bias and ReLU (or none), rounded once to the output
    dtype (default x's)."""
    n, h, wd, c = x.shape
    co = w.shape[-1]
    xp = F.pad(x.to(torch.float32), (0, 0, 2, 2, 2, 2))
    wf = w.to(torch.float32)
    acc = None
    for dy in range(5):
        for dx in range(5):
            part = xp[:, dy:dy + h, dx:dx + wd].reshape(n * h * wd, c) @ wf[dy, dx]
            acc = part if acc is None else acc + part
    y = _epilogue(acc.reshape(n, h, wd, co), b, 0.0 if relu else 1.0, None)
    return y.to(_out_dtype(x, out_dtype))


@functools.lru_cache(maxsize=256)
def conv5_plan(n: int, h: int, w: int, co: int) -> ConvPlan:
    """The launch of K11 for an (n, h, w, .) -> co call: 8 x 32 pixel
    tiles, and of the channel blocks the kernel takes (``nb`` groups of 8
    each, ceil(co / 8 / nb) blocks a tile) the one that leaves the card
    least short of ``SMS`` items, then computes the fewest padded channels,
    then is a multiple of 64 channels (an m64n64 product runs nearer the
    tensor cores' rate than an m64n104 one), then has the fewest
    blocks a tile.  ``blocks`` counts the (tile, channel block) items, which
    the kernel's persistent blocks, one an SM, walk."""
    tw, th = TILE5
    tiles = n * _cdiv(w, tw) * _cdiv(h, th)
    need = _cdiv(co, 8)

    def cost(nb):
        groups = _cdiv(need, nb)
        return max(0, SMS - tiles * groups), groups * nb, nb % 8 != 0, groups
    nb = min(BLOCK_GROUPS5, key=cost)
    groups = _cdiv(need, nb)
    return ConvPlan(2, tw, th, nb, groups, tiles * groups)


def _packed_weights5(w: torch.Tensor, dev: torch.device, n_cols: int) -> torch.Tensor:
    """``pack_weights_sm90(w, n_cols)`` for a (5, 5, C, Co) weight in
    bfloat16 on the card, cached per weight tensor."""
    return _PACKED.get(w, ("5x5", dev, n_cols), lambda: pack_weights_sm90(
        w.detach().to(device=dev, dtype=torch.bfloat16), n_cols))


def conv5x5_act(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, relu: bool,
                out_dtype=None) -> torch.Tensor:
    """Fused SAME conv5x5 + bias + ReLU (``relu``) or identity, through K11
    (csrc/conv5x5_act.cu) on the card, ``conv5x5_act_plain`` on the CPU.

    Args:
      x: (N, H, W, C) activation; on the card contiguous bfloat16 with C a
        multiple of 8 (keep activations padded with zero channels).
      w: (5, 5, C, Co) weights, used in bfloat16 and packed once per tensor;
        b: (Co,) bias.
      out_dtype: output dtype (default x's), bfloat16 or float32.
    Returns (N, H, W, Co).
    """
    if x.device.type == "cpu":
        return conv5x5_act_plain(x, w, b, relu, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"no conv kernel for device {x.device}")
    if (x.dtype != torch.bfloat16 or x.dim() != 4 or not x.is_contiguous()
            or x.shape[-1] % 8):
        raise ValueError("K11 takes a contiguous (N, H, W, C) bfloat16 tensor with C a "
                         f"multiple of 8, got {x.dtype} {tuple(x.shape)}")
    n, h, wd, c = x.shape
    if w.dim() != 4 or tuple(w.shape[:3]) != (5, 5, c):
        raise ValueError(f"weights {tuple(w.shape)} do not match {c} channels")
    co = w.shape[-1]
    dev = x.device
    plan = conv5_plan(n, h, wd, co)
    wk = _packed_weights5(w, dev, plan.n_cols)
    if x.data_ptr() % 16:                # the kernel's copies start on 16-byte boundaries
        x = x.clone()
    bias = _vec(b, co, dev)
    odt = _out_dtype(x, out_dtype)
    if odt not in (torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype {odt} not supported by K11")
    out = torch.empty((n, h, wd, co), dtype=odt, device=dev)
    with torch.cuda.device(dev):
        rc = KERNEL5.lib().aptd_conv5x5_act(
            x.data_ptr(), wk.data_ptr(), bias.data_ptr(), out.data_ptr(), n, h, wd, c, co,
            0.0 if relu else 1.0, int(odt == torch.float32), plan.tw, plan.th, plan.nb,
            plan.groups * plan.nb, torch.cuda.current_stream().cuda_stream)
    check(rc, f"conv5x5_act kernel ({c} -> {co} channels)")
    KERNEL5.launches += 1
    return out
