"""Deployed denoiser: BatchNorm folded into the convs (counterpart of
models/inference.py).

At inference BatchNorm is a fixed per-channel affine, so bn1/bn3 of each
block fold backward into the conv before them; bn2 of the downsample
blocks follows a LeakyReLU (recurrent_autoencoder_model.py:31-32) and
stays an explicit affine in its conv's epilogue.  The folded network is 28
fused conv3x3 + bias + LeakyReLU (+ affine) calls per frame, each one
``conv3x3_act_chw`` (models/conv_kernel.py): the CUDA kernel on the card,
the plain version on the CPU.  Activations and hidden states are
``compute_dtype`` (bfloat16 by default) in NHWC.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..config import ModelOptions
from .conv_kernel import conv3x3_act_chw
from .layers import max_pool_2x2, upsample_nearest_2x

# The JAX package's conv lowerings.  In the port they are all one
# function: the CUDA kernel on the card, its plain version on the CPU.
CONV_IMPLS = ("auto", "pallas2", "pallas", "matmul", "native", "im2row")


def _fold_back(conv, bn, st, eps):
    """conv followed by BN -> single conv (per-output-channel rescale)."""
    g = bn["scale"] / torch.sqrt(st["var"] + eps)
    return {"w": conv["w"] * g, "b": (conv["b"] - st["mean"]) * g + bn["bias"]}


def _affine(bn, st, eps):
    """Eval-mode BN as a bare per-channel affine: x*s + t."""
    s = bn["scale"] / torch.sqrt(st["var"] + eps)
    return {"s": s, "t": bn["bias"] - st["mean"] * s}


def fold_batchnorm(params: Dict, bn_state: Dict,
                   options: Optional[ModelOptions] = None) -> Dict:
    """Absorb every BatchNorm into its neighbour conv; conv-only params.

    Only valid for ``norm == "batch"`` (fixed running statistics).
    """
    opts = options if options is not None else ModelOptions()
    if opts.norm != "batch":
        raise ValueError(f"cannot fold norm={opts.norm!r}; only BatchNorm's "
                         "fixed eval-mode statistics are foldable")
    eps = opts.bn_eps
    out = {}
    for i in range(1, 6):
        name = f"enc{i}"
        p, s = params[name], bn_state[name]
        out[name] = {
            "conv1": _fold_back(p["conv1"], p["bn1"], s["bn1"], eps),
            "conv2": dict(p["conv2"]),
            "affine2": _affine(p["bn2"], s["bn2"], eps),
            "conv3": _fold_back(p["conv3"], p["bn3"], s["bn3"], eps),
        }
    p, s = params["bottleneck"], bn_state["bottleneck"]
    out["bottleneck"] = {
        f"conv{j}": _fold_back(p[f"conv{j}"], p[f"bn{j}"], s[f"bn{j}"], eps)
        for j in (1, 2, 3)}
    for i in range(1, 6):
        name = f"dec{i}"
        p, s = params[name], bn_state[name]
        out[name] = {
            f"conv{j}": _fold_back(p[f"conv{j}"], p[f"bn{j}"], s[f"bn{j}"], eps)
            for j in (1, 2)}
    return out


def _conv_act(conv, x, slope, compute_dtype, impl: str = "auto",
              affine=None):
    """conv3x3 SAME + bias + LeakyReLU [+ affine x*s+t] on (N, H, W, C).

    Every sample goes through ``conv3x3_act_chw``: the kernel on CUDA
    tensors, the plain version on CPU ones, whatever the shape.
    """
    if impl not in CONV_IMPLS:
        raise ValueError(f"conv impl {impl!r} not in {CONV_IMPLS}")
    ys = [conv3x3_act_chw(x[i].to(compute_dtype).contiguous(), conv["w"],
                          conv["b"], slope, affine=affine)
          for i in range(x.shape[0])]
    return torch.stack(ys)


def apply_frame_fast(folded: Dict, x: torch.Tensor, hidden: Dict,
                     options: Optional[ModelOptions] = None,
                     compute_dtype=torch.bfloat16,
                     conv_impl: str = "auto") -> Tuple[torch.Tensor, Dict]:
    """One frame through the folded conv+LReLU network.

    x: (N, H, W, 10) G-buffer frame, H and W divisible by 32; ``hidden``
    from ``init_hidden`` (``compute_dtype``) or the previous frame.
    Returns (denoised (N, H, W, 3) float32, new hidden in compute_dtype).
    """
    opts = options if options is not None else ModelOptions()
    slope = opts.leaky_slope
    _, h, w, _ = x.shape
    if h % 32 or w % 32:
        raise ValueError(f"input {h}x{w} must be divisible by 32")

    def ca(p_, y_, aff=None):
        return _conv_act(p_, y_, slope, compute_dtype, conv_impl, affine=aff)

    new_hidden, skips = {}, []
    y = x.to(compute_dtype)
    for i in range(1, 6):
        p = folded[f"enc{i}"]
        out1 = ca(p["conv1"], y)
        hcat = torch.cat([out1, hidden[f"enc{i}"].to(compute_dtype)], dim=-1)
        # bn2's surviving affine rides conv2's epilogue
        out2 = ca(p["conv2"], hcat, aff=p["affine2"])
        out3 = ca(p["conv3"], out2)
        new_hidden[f"enc{i}"] = out3
        y = max_pool_2x2(out3)
        skips.append(y)

    p = folded["bottleneck"]
    out1 = ca(p["conv1"], y)
    hcat = torch.cat([out1, hidden["bottleneck"].to(compute_dtype)], dim=-1)
    out2 = ca(p["conv2"], hcat)
    y = ca(p["conv3"], out2)
    new_hidden["bottleneck"] = y

    for i in range(5, 0, -1):
        p = folded[f"dec{i}"]
        y = torch.cat([y, skips[i - 1]], dim=-1)
        y = upsample_nearest_2x(y)
        y = ca(p["conv1"], y)
        y = ca(p["conv2"], y)
    return y.to(torch.float32), new_hidden


def padded_resolution(h: int, w: int, multiple: int = 32) -> Tuple[int, int]:
    """Smallest (H, W) >= (h, w) divisible by ``multiple`` (5 pool stages)."""
    def up(v):
        return -(-v // multiple) * multiple
    return up(h), up(w)


def apply_frame_fast_padded(folded: Dict, x: torch.Tensor, hidden: Dict,
                            options: Optional[ModelOptions] = None,
                            compute_dtype=torch.bfloat16,
                            conv_impl: str = "auto") -> Tuple[torch.Tensor, Dict]:
    """``apply_frame_fast`` for any resolution: edge-replicate pad the
    bottom/right up to the next multiple of 32, denoise, crop back.
    ``hidden`` lives at the padded resolution."""
    _, h, w, _ = x.shape
    hp, wp = padded_resolution(h, w)
    if (hp, wp) != (h, w):
        rows = torch.arange(hp, device=x.device).clamp_max(h - 1)
        cols = torch.arange(wp, device=x.device).clamp_max(w - 1)
        x = x[:, rows][:, :, cols]
    y, hidden = apply_frame_fast(folded, x, hidden, options, compute_dtype,
                                 conv_impl)
    return y[:, :h, :w, :], hidden


def prepare_inference(params: Dict, bn_state: Dict,
                      options: Optional[ModelOptions] = None,
                      compute_dtype=torch.bfloat16,
                      pad_multiple: int = 0) -> Dict:
    """Fold BN and cast conv weights to the compute dtype (biases and
    affines stay float32 for the float32 epilogue).  One-time cost."""
    if pad_multiple:
        raise NotImplementedError("pad_channels is not ported yet "
                                  "(ROADMAP queue A)")
    folded = fold_batchnorm(params, bn_state, options)
    return {blk: {name: {k: (v.to(compute_dtype) if k == "w" else v)
                         for k, v in leaf.items()}
                  for name, leaf in layers.items()}
            for blk, layers in folded.items()}
