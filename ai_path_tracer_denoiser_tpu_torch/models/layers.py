"""Primitive NN layers on NHWC tensors (counterpart of models/layers.py).

LeakyReLU, 2x2 max pool, nearest 2x upsample and the initialisers, plus the
train graph's layers: ``conv2d`` (a 3x3 SAME conv whose forward pass and
input gradient both run through the fused conv kernel,
``Conv3x3Function``), ``batch_norm`` and ``group_norm`` written out as the
JAX package's formulas.  Parameters are plain dicts of tensors with HWIO
conv weights, as in the JAX package.
"""
from __future__ import annotations

import math

import torch

from . import conv_kernel


def conv_init(generator: torch.Generator, k: int, c_in: int, c_out: int):
    """Kaiming-normal fan_in (train.py:32-35): std = sqrt(2 / (k*k*c_in)),
    bias = 0.01.  HWIO weights."""
    std = (2.0 / (k * k * c_in)) ** 0.5
    w = torch.randn((k, k, c_in, c_out), generator=generator,
                    dtype=torch.float32) * std
    return {"w": w, "b": torch.full((c_out,), 0.01, dtype=torch.float32)}


def bn_init(c: int):
    return {"scale": torch.ones(c, dtype=torch.float32),
            "bias": torch.zeros(c, dtype=torch.float32)}


def bn_state_init(c: int):
    return {"mean": torch.zeros(c, dtype=torch.float32),
            "var": torch.ones(c, dtype=torch.float32)}


def leaky_relu(x: torch.Tensor, slope: float = 0.1) -> torch.Tensor:
    return torch.where(x >= 0, x, slope * x)


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, H/2, W/2, C), max over each 2x2 window."""
    n, h, w, c = x.shape
    return x.reshape(n, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, 2H, 2W, C), each pixel repeated 2x2."""
    n, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c)
    return x.reshape(n, h * 2, w * 2, c)


class Conv3x3Function(torch.autograd.Function):
    """Batched pure 3x3 SAME conv y = x * w through the fused conv kernel,
    with its gradients (counterpart of ``_conv3x3_pallas_nb``).

    Forward: the kernel with slope 1 (its LeakyReLU is the identity), zero
    bias and float32 output, so the caller adds the bias to the float32
    accumulator.  Backward: the input gradient is the same kernel on the
    output gradient, rounded to x's dtype, with the weights flipped in
    both spatial axes and their channel axes swapped; it comes back in x's
    dtype.  The weight gradient is nine plain contractions with float32
    sums (``conv_kernel.conv3x3_wgrad``), rounded to w's dtype.  x
    (N, H, W, Ci) and w (3, 3, Ci, Co) share one dtype, bfloat16 or
    float32.
    """

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        zero_bias = torch.zeros(w.shape[-1], dtype=torch.float32, device=x.device)
        return conv_kernel.conv3x3_act_chw(x.contiguous(), w, zero_bias, 1.0,
                                           out_dtype="float32")

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            wt = w.flip(0, 1).transpose(2, 3).to(x.dtype)
            zero_bias = torch.zeros(w.shape[2], dtype=torch.float32, device=x.device)
            dx = conv_kernel.conv3x3_act_chw(g, wt, zero_bias, 1.0)
        if ctx.needs_input_grad[1]:
            dw = conv_kernel.conv3x3_wgrad(x, g).to(w.dtype)
        return dx, dw


# The JAX package's lowerings of the train graph's conv.  The port has one:
# the conv kernel (its plain version on the CPU) with its autograd.
CONV2D_IMPLS = ("auto", "pallas2", "matmul", "native")


def conv2d(params, x: torch.Tensor, bf16: bool = False,
           impl: str = "auto") -> torch.Tensor:
    """3x3 SAME conv, NHWC/HWIO, float32 out; the bias is added in float32
    after the conv.

    With ``bf16`` x and w are rounded to bfloat16 first and the conv hands
    back its float32 accumulator.  Every ``impl`` name of the JAX package
    goes through ``Conv3x3Function`` (the conv kernel on the card, its
    plain version on the CPU), whatever the height.
    """
    if impl not in CONV2D_IMPLS:
        raise ValueError(f"conv impl {impl!r} not in {CONV2D_IMPLS}")
    w = params["w"]
    if tuple(w.shape[:2]) != (3, 3):
        raise ValueError(f"conv2d takes 3x3 weights, got {tuple(w.shape)}")
    dtype = torch.bfloat16 if bf16 else torch.float32
    return Conv3x3Function.apply(x.to(dtype), w.to(dtype)) + params["b"]


def batch_norm(params, state, x: torch.Tensor, train: bool,
               momentum: float = 0.1, eps: float = 1e-5):
    """BatchNorm over (N, H, W).  Returns (y, new_state).

    Written out as the JAX package's formula and not ``F.batch_norm``: in
    train mode the biased batch variance is E[x^2] - E[x]^2 in float32, the
    running estimates take the unbiased variance (torch's convention), and
    y = (x - mean) * rsqrt(var + eps) * scale + bias.  The running
    estimates carry no gradient.
    """
    x32 = x.to(torch.float32)
    if train:
        mean = x32.mean(dim=(0, 1, 2))
        var = x32.square().mean(dim=(0, 1, 2)) - mean.square()
        n = x32.shape[0] * x32.shape[1] * x32.shape[2]
        unbiased = var.detach() * (n / max(n - 1, 1))
        new_state = {
            "mean": (1 - momentum) * state["mean"] + momentum * mean.detach(),
            "var": (1 - momentum) * state["var"] + momentum * unbiased,
        }
    else:
        mean, var = state["mean"], state["var"]
        new_state = state
    y = (x32 - mean) * torch.rsqrt(var + eps) * params["scale"] + params["bias"]
    return y, new_state


def group_norm(params, x: torch.Tensor, groups: int = 8,
               eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over (H, W, C/groups) per sample, stateless; the group
    count is gcd(groups, C) so the reference's 43/57/76/101 widths and the
    3-channel output normalise too.  Variance as E[x^2] - E[x]^2."""
    n, h, w, c = x.shape
    g = math.gcd(groups, c)
    xg = x.to(torch.float32).reshape(n, h, w, g, c // g)
    mean = xg.mean(dim=(1, 2, 4), keepdim=True)
    var = xg.square().mean(dim=(1, 2, 4), keepdim=True) - mean.square()
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(n, h, w, c)
    return y * params["scale"] + params["bias"]
