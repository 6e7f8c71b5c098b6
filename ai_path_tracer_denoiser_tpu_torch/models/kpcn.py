"""The kernel-predicting denoiser (KPCN): Bako, Vogels, McWilliams, Meyer,
Novak, Harvill, Sen, DeRose and Rousselle, "Kernel-Predicting
Convolutional Networks for Denoising Monte Carlo Renderings", ACM TOG
36(4), SIGGRAPH 2017.

The network, as published: 9 convolutions 5x5 with SAME zero padding;
layers 1-8 have 100 output channels and a ReLU, layer 9 has k*k = 441 and
no activation.  Each pixel's 441 outputs are softmax-normalised, and the
denoised pixel is the weighted sum of the noisy radiance over the 21x21
window centred on it (zero outside the image).

Departures from the paper (also under ``assumed`` in
perfbench/configs/kpcn-cornell-800.json):

* One network over the combined radiance.  The paper trains one on the
  diffuse and one on the specular component; the G-buffer has no split.
* No per-pixel variances among the inputs: a 1-spp frame has none.
* The input assembly (``kpcn_features``, 30 channels): the G-buffer's 10
  channels, the radiance as log(1 + c) as on the paper's specular input
  and the depth divided by the frame's largest, and their forward
  differences in x and in y (the paper's gradients), zero at the last
  column and row.
* Weights drawn from a seed (``init_kpcn``): no trained KPCN exists here.

On the card (``apply_kpcn_frame``) the nine convs run through K11
(models/conv_kernel.py:conv5x5_act, csrc/conv5x5_act.cu) in bfloat16 with
float32 sums, the activations kept at 104 channels and the features at 32
(zero channels, met by zero weights) so that every pixel starts on a
16-byte boundary, the logits stored in bfloat16 at 448 channels; the
softmax and the weighted sum run in float32 in K12 (``kernel_apply``,
csrc/kernel_apply.cu).  On the CPU the same calls run the plain versions
(``conv5x5_act_plain``, ``kernel_apply_plain``).  Each conv counts
``kpcn.conv.kernel`` or ``kpcn.conv.plain`` and the apply
``kpcn.apply.kernel`` or ``kpcn.apply.plain`` (utils/timers.py).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..config import KPCNOptions
from ..utils.cuda_build import CudaKernel, check
from ..utils.derived_cache import DerivedCache
from ..utils.timers import count, span
from .conv_kernel import conv5x5_act

# He's scale for layers 1-8; layer 9's weights are drawn at this multiple
# of it, which puts the logits' standard deviation near 1 on the Cornell
# box's frames (at He's scale it is 0.54-0.62 over a pixel's 441 logits:
# the features' is 0.44, and a ReLU layer at He's scale keeps it).  Much
# larger logits make the softmax nearly one-hot, and a bfloat16 rounding
# then flips which tap wins; much smaller ones a plain box filter.
LOGIT_SCALE = 1.7
TAPS = 5               # each conv's taps a side: K11 is 5x5
IN_CHANNELS = 30       # kpcn_features' channels
IN_PAD = 32            # the features' channels on the card (30 + 2 zero)


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.aptd_kernel_apply.restype = i
    lib.aptd_kernel_apply.argtypes = [p, p, p, i, i, i, i, i, p]


APPLY_KERNEL = CudaKernel("kernel_apply", "kernel_apply.cu", extra_flags=("-fmad=false",),
                          declare=_declare)


def _up8(n: int) -> int:
    return -(-n // 8) * 8


def layer_shapes(opts: KPCNOptions):
    """(Cin, Co) of each conv, as published."""
    cs = [IN_CHANNELS] + [opts.width] * (opts.layers - 1) + [opts.kernel ** 2]
    return list(zip(cs[:-1], cs[1:]))


def init_kpcn(seed: int, opts: Optional[KPCNOptions] = None, device=None) -> Dict:
    """{"conv<i>": {"w": (5, 5, Cin, Co), "b": (Co,)}} float32, drawn on
    ``device`` from ``seed``: He-normal weights (the last layer's times
    ``LOGIT_SCALE``) and biases of 0.01 standard deviation."""
    opts = opts or KPCNOptions()
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & 0xFFFFFFFFFFFFFFFF)
    params = {}
    shapes = layer_shapes(opts)
    for i, (ci, co) in enumerate(shapes, 1):
        k = TAPS
        std = (2.0 / (k * k * ci)) ** 0.5 * (LOGIT_SCALE if i == len(shapes) else 1.0)
        w = torch.randn((k, k, ci, co), generator=g, device=device) * std
        b = torch.randn((co,), generator=g, device=device) * 0.01
        params[f"conv{i}"] = {"w": w, "b": b}
    return params


def _forward_diff(f: torch.Tensor, dim: int) -> torch.Tensor:
    d = torch.zeros_like(f)
    n = f.shape[dim]
    d.narrow(dim, 0, n - 1).copy_(f.narrow(dim, 1, n - 1) - f.narrow(dim, 0, n - 1))
    return d


def kpcn_features(gbuffer: torch.Tensor) -> torch.Tensor:
    """(10, H, W) G-buffer -> (1, H, W, 30) float32 network input: the 10
    channels (radiance as log(1 + max(c, 0)), depth over the frame's
    largest depth), then their forward differences in x, then in y."""
    g = gbuffer.to(torch.float32)
    depth = g[6:7] / g[6].amax().clamp_min(1e-6)
    f = torch.cat([g[0:3].clamp_min(0).log1p(), g[3:6], depth, g[7:10]])
    feat = torch.cat([f, _forward_diff(f, 2), _forward_diff(f, 1)])
    return feat.permute(1, 2, 0)[None]


def kernel_apply_plain(logits: torch.Tensor, radiance: torch.Tensor, k: int) -> torch.Tensor:
    """K12's plain version: logits (N, H, W, >= k*k), radiance (N, 3, H, W)
    -> (N, H, W, 3) float32: the softmax of each pixel's first k*k logits in
    float32, times the k x k window of radiance around it from ``F.unfold``
    (zero outside the image), summed."""
    n, h, w = logits.shape[:3]
    wgt = torch.softmax(logits[..., :k * k].to(torch.float32), dim=-1)
    win = F.unfold(radiance.to(torch.float32), k, padding=k // 2).view(n, 3, k * k, h, w)
    return torch.einsum("nhwt,ncthw->nhwc", wgt, win)


def kernel_apply(logits: torch.Tensor, radiance: torch.Tensor, k: int) -> torch.Tensor:
    """Softmax-weighted k x k window of radiance per pixel: K12 on the card
    (logits contiguous bfloat16, an even number of channels, at least k*k +
    1), ``kernel_apply_plain`` on the CPU.  Returns (N, H, W, 3) float32."""
    if logits.device.type == "cpu":
        count("kpcn.apply.plain")
        return kernel_apply_plain(logits, radiance, k)
    n, h, w, ldl = logits.shape
    if (logits.dtype != torch.bfloat16 or not logits.is_contiguous() or ldl % 2
            or ldl < k * k + (k * k) % 2):
        raise ValueError(f"K12 takes contiguous bfloat16 (N, H, W, L) logits with L even and "
                         f"> {k * k - 1}, got {logits.dtype} {tuple(logits.shape)}")
    rad = radiance.to(torch.float32).contiguous()
    if tuple(rad.shape) != (n, 3, h, w) or rad.device != logits.device:
        raise ValueError(f"radiance {tuple(rad.shape)} on {rad.device} for logits "
                         f"{tuple(logits.shape)} on {logits.device}")
    out = torch.empty((n, h, w, 3), dtype=torch.float32, device=logits.device)
    with torch.cuda.device(logits.device):
        rc = APPLY_KERNEL.lib().aptd_kernel_apply(
            logits.data_ptr(), rad.data_ptr(), out.data_ptr(), n, h, w, ldl, k,
            torch.cuda.current_stream().cuda_stream)
    check(rc, "kernel_apply kernel")
    APPLY_KERNEL.launches += 1
    count("kpcn.apply.kernel")
    return out


# The layers' weights and biases padded to the channels kept on the card,
# in bfloat16: made once per parameter tensor.
_PADDED = DerivedCache(64)


def _padded(t: torch.Tensor, cin: int, co: int) -> torch.Tensor:
    def pad():
        if t.dim() == 1:
            return F.pad(t.detach().to(torch.float32), (0, co - t.shape[0]))
        return F.pad(t.detach(), (0, co - t.shape[-1], 0, cin - t.shape[-2])).to(
            torch.bfloat16)
    return _PADDED.get(t, (cin, co), pad)


def kpcn_logits(params: Dict, gbuffer: torch.Tensor,
                opts: Optional[KPCNOptions] = None) -> torch.Tensor:
    """The nine convs on the features of ``gbuffer`` (10, H, W): (1, H, W,
    L) bfloat16 logits, the first k*k meaningful (L = k*k rounded up to 8;
    the rest zero)."""
    opts = opts or KPCNOptions()
    with span("denoise.kpcn.features"):
        x = F.pad(kpcn_features(gbuffer), (0, IN_PAD - IN_CHANNELS)).to(
            torch.bfloat16).contiguous()
    site = "kpcn.conv.plain" if x.device.type == "cpu" else "kpcn.conv.kernel"
    shapes = layer_shapes(opts)
    with span("denoise.kpcn.convs"):
        for i, (_, co) in enumerate(shapes, 1):
            with span(f"denoise.kpcn.conv{i}"):
                p = params[f"conv{i}"]
                co_pad = _up8(co)
                x = conv5x5_act(x, _padded(p["w"], x.shape[-1], co_pad),
                                _padded(p["b"], 0, co_pad), i < len(shapes))
                count(site)
    return x


def apply_kpcn_frame(params: Dict, gbuffer: torch.Tensor,
                     opts: Optional[KPCNOptions] = None, return_logits: bool = False):
    """Denoise one frame: ``gbuffer`` (10, H, W) as the renderer writes it
    -> (1, H, W, 3) float32, the layout ``apply_frame_fast_padded``
    returns.  With ``return_logits`` also the (1, H, W, L) bfloat16 logits
    the apply read."""
    opts = opts or KPCNOptions()
    with span("denoise.frame"):
        logits = kpcn_logits(params, gbuffer, opts)
        with span("denoise.kpcn.apply"):
            y = kernel_apply(logits, gbuffer[None, 0:3], opts.kernel)
    return (y, logits) if return_logits else y
