"""Plain reference of the kernel-predicting denoiser (KPCN), in float32.

Bako et al. 2017, "Kernel-Predicting Convolutional Networks for Denoising
Monte Carlo Renderings", ACM TOG 36(4): 9 convolutions 5x5 with SAME zero
padding, layers 1-8 100 wide with a ReLU, layer 9 k*k = 441 wide with
none; a softmax over each pixel's 441 outputs; the denoised pixel is the
softmax-weighted sum of the noisy radiance over the 21x21 window centred
on it, zero outside the image.  The input is the configuration's assembly
(30 channels): the G-buffer's 10 channels (radiance as log(1 + c), depth
over the frame's largest) and their forward differences in x and in y,
zero at the last column and row.

Convolutions are ``F.conv2d`` and the window is ``F.unfold``, with TF32
off inside ``no_tf32``.  ``quant="fp8"`` rounds each conv's input and
weight to float8 e4m3 with one scale per tensor (the control that a cell's
limits must refuse); ``quant="bf16"`` rounds them and the logits to
bfloat16, as the program does (a witness of what bfloat16 alone costs).
Imports nothing of the program.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


class no_tf32:
    """Float32 convs and products stay float32 on the card inside the
    block."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


def _q8(t: torch.Tensor) -> torch.Tensor:
    scale = t.abs().amax().clamp_min(1e-12) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _qbf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


QUANT = {"fp32": lambda t: t, "bf16": _qbf16, "fp8": _q8}


def _diff(f: torch.Tensor, dim: int) -> torch.Tensor:
    d = torch.zeros_like(f)
    n = f.shape[dim]
    d.narrow(dim, 0, n - 1).copy_(f.narrow(dim, 1, n - 1) - f.narrow(dim, 0, n - 1))
    return d


def features(gbuffer: torch.Tensor) -> torch.Tensor:
    """(10, H, W) G-buffer -> (1, 30, H, W) network input."""
    g = gbuffer.to(torch.float32)
    depth = g[6:7] / g[6].amax().clamp_min(1e-6)
    f = torch.cat([torch.log1p(torch.clamp(g[0:3], min=0.0)), g[3:6], depth, g[7:10]])
    return torch.cat([f, _diff(f, 2), _diff(f, 1)])[None]


def logits(params, x: torch.Tensor, quant: str = "fp32") -> torch.Tensor:
    """The nine convs: (1, 30, H, W) -> (1, k*k, H, W).  ``params``:
    {"conv<i>": {"w": (5, 5, Cin, Co), "b": (Co,)}}."""
    q = QUANT[quant]
    n = len(params)
    for i in range(1, n + 1):
        p = params[f"conv{i}"]
        x = F.conv2d(q(x), q(p["w"].permute(3, 2, 0, 1)), p["b"], padding=2)
        if i < n:
            x = torch.relu(x)
    return _qbf16(x) if quant == "bf16" else x


def weights(lg: torch.Tensor) -> torch.Tensor:
    """Softmax over each pixel's k*k logits (dim 1), float32."""
    return torch.softmax(lg.to(torch.float32), dim=1)


def apply(wgt: torch.Tensor, radiance: torch.Tensor, k: int, rows: int = 0) -> torch.Tensor:
    """(1, k*k, H, W) weights, (1, 3, H, W) radiance -> (1, 3, H, W): the
    weighted k x k window, from ``F.unfold`` of the zero-padded radiance,
    ``rows`` output rows at a time (0: all) so that the window's k*k-fold
    copy fits."""
    _, _, h, w = radiance.shape
    r = k // 2
    padded = F.pad(radiance.to(torch.float32), (r, r, r, r))
    rows = rows or h
    out = []
    for y0 in range(0, h, rows):
        y1 = min(h, y0 + rows)
        win = F.unfold(padded[:, :, y0:y1 + 2 * r], k).view(1, 3, k * k, y1 - y0, w)
        out.append((win * wgt[:, None, :, y0:y1]).sum(2))
    return torch.cat(out, 2)


def frame(params, gbuffer: torch.Tensor, k: int = 21, quant: str = "fp32", rows: int = 0):
    """Denoise one (10, H, W) G-buffer: (rgb (1, 3, H, W), weights (1, k*k,
    H, W)), float32."""
    wgt = weights(logits(params, features(gbuffer), quant))
    return apply(wgt, gbuffer[None, 0:3], k, rows), wgt
