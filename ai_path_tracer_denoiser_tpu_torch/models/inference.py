"""Deployed denoiser: BatchNorm folded into the convs (counterpart of
models/inference.py).

At inference BatchNorm is a fixed per-channel affine, so bn1/bn3 of each
block fold backward into the conv before them; bn2 of the downsample
blocks follows a LeakyReLU (recurrent_autoencoder_model.py:31-32) and
stays an explicit affine in its conv's epilogue.  The folded network is 28
fused conv3x3 + bias + LeakyReLU (+ affine) calls per frame, each through
one of the two conv kernels of models/conv_kernel.py (``conv_impl``): the
CUDA kernel on the card, its plain version on the CPU.  Activations and
hidden states are ``compute_dtype`` (bfloat16 by default) in NHWC.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import dataclasses

import torch

from ..config import ModelOptions
from ..utils.timers import span
from .conv_kernel import conv3x3_act, conv3x3_act_chw
from .autoencoder import init_hidden
from .layers import max_pool_2x2, upsample_nearest_2x

# The JAX package's conv lowerings.  The port has two: "pallas" is the
# row-band kernel (``conv3x3_act``), every other name the tile kernel
# (``conv3x3_act_chw``, the JAX package's "pallas2" and its default on the
# accelerator); each is its CUDA kernel on the card and its plain version on
# the CPU.
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

    ``impl="pallas"`` goes through ``conv3x3_act`` (the row-band kernel),
    every other name through ``conv3x3_act_chw`` (the tile kernel): the
    kernel on CUDA tensors, its plain version on CPU ones, whatever the
    shape (both kernels take any height and a batch).
    """
    if impl not in CONV_IMPLS:
        raise ValueError(f"conv impl {impl!r} not in {CONV_IMPLS}")
    fn = conv3x3_act if impl == "pallas" else conv3x3_act_chw
    return fn(x.to(compute_dtype).contiguous(), conv["w"], conv["b"], slope,
              affine=affine)


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
        with span(f"denoise.enc{i}"):
            p = folded[f"enc{i}"]
            out1 = ca(p["conv1"], y)
            hcat = torch.cat([out1, hidden[f"enc{i}"].to(compute_dtype)], dim=-1)
            # bn2's surviving affine rides conv2's epilogue
            out2 = ca(p["conv2"], hcat, aff=p["affine2"])
            out3 = ca(p["conv3"], out2)
            new_hidden[f"enc{i}"] = out3
            y = max_pool_2x2(out3)
            skips.append(y)

    with span("denoise.bottleneck"):
        p = folded["bottleneck"]
        out1 = ca(p["conv1"], y)
        hcat = torch.cat([out1, hidden["bottleneck"].to(compute_dtype)], dim=-1)
        out2 = ca(p["conv2"], hcat)
        y = ca(p["conv3"], out2)
        new_hidden["bottleneck"] = y

    for i in range(5, 0, -1):
        with span(f"denoise.dec{i}"):
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


def edge_pad(x: torch.Tensor, hp: int, wp: int) -> torch.Tensor:
    """(N, H, W, C) -> (N, hp, wp, C), the bottom/right edge replicated."""
    _, h, w, _ = x.shape
    if (hp, wp) == (h, w):
        return x
    rows = torch.arange(hp, device=x.device).clamp_max(h - 1)
    cols = torch.arange(wp, device=x.device).clamp_max(w - 1)
    return x[:, rows][:, :, cols]


def apply_frame_fast_padded(folded: Dict, x: torch.Tensor, hidden: Dict,
                            options: Optional[ModelOptions] = None,
                            compute_dtype=torch.bfloat16,
                            conv_impl: str = "auto") -> Tuple[torch.Tensor, Dict]:
    """``apply_frame_fast`` for any resolution: edge-replicate pad the
    bottom/right up to the next multiple of 32, denoise, crop back.
    ``hidden`` lives at the padded resolution."""
    with span("denoise.frame"):
        _, h, w, _ = x.shape
        x = edge_pad(x, *padded_resolution(h, w))
        y, hidden = apply_frame_fast(folded, x, hidden, options, compute_dtype,
                                     conv_impl)
        return y[:, :h, :w, :], hidden


def apply_sequence_fast(folded: Dict, x_seq: torch.Tensor,
                        options: Optional[ModelOptions] = None,
                        compute_dtype=torch.bfloat16,
                        conv_impl: str = "auto") -> torch.Tensor:
    """``apply_frame_fast`` over a (T, N, H, W, 10) sequence, the hidden
    state starting at zero and carried across the frames."""
    _, n, h, w, _ = x_seq.shape
    widths = tuple(folded[f"enc{i}"]["conv1"]["w"].shape[-1]
                   for i in range(1, 6))
    base = options if options is not None else ModelOptions()
    opts = dataclasses.replace(base, widths=widths)
    hidden = init_hidden(n, h, w, opts, dtype=compute_dtype,
                         device=x_seq.device)
    ys = []
    for x in x_seq:
        y, hidden = apply_frame_fast(folded, x, hidden, opts, compute_dtype,
                                     conv_impl)
        ys.append(y)
    return torch.stack(ys)


def prepare_inference(params: Dict, bn_state: Dict,
                      options: Optional[ModelOptions] = None,
                      compute_dtype=torch.bfloat16,
                      pad_multiple: int = 0) -> Dict:
    """Fold BN and cast conv weights to the compute dtype (biases and
    affines stay float32 for the float32 epilogue).  One-time cost.
    ``pad_multiple`` > 0 also zero-pads the internal channel widths up to
    a multiple of it (``pad_channels``)."""
    folded = fold_batchnorm(params, bn_state, options)
    if pad_multiple:
        folded = pad_channels(folded, pad_multiple)
    return {blk: {name: {k: (v.to(compute_dtype) if k == "w" else v)
                         for k, v in leaf.items()}
                  for name, leaf in layers.items()}
            for blk, layers in folded.items()}


def _pad_conv(conv, segments, in_total: int, out_p: int, out_keep: int):
    """Re-pack a conv for padded channel layouts.

    ``segments``: [(src_lo, src_hi, dst_lo), ...], where the original input
    channels go in the padded input; every other row is zero.  Output
    channels grow to ``out_p`` with zero weights and zero bias, so they
    come out exactly zero through the LeakyReLU and add nothing downstream.
    """
    w = conv["w"]
    k0, k1, _, c_out = w.shape
    nw = w.new_zeros((k0, k1, in_total, out_p))
    for lo, hi, dst in segments:
        nw[:, :, dst:dst + (hi - lo), :c_out] = w[:, :, lo:hi, :]
    nb = conv["b"].new_zeros((out_p,))
    nb[:out_keep] = conv["b"][:out_keep]
    return {"w": nw, "b": nb}


def pad_channels(folded: Dict, multiple: int) -> Dict:
    """Zero-pad every internal channel width of a folded network up to a
    multiple of ``multiple``; the same function, exactly (padded lanes
    carry zeros: zero weights, zero bias, LReLU(0) = 0, affine pads s = 1,
    t = 0).  The network's input (10 channels) and output (3) keep their
    widths.  Through the tile conv kernel, multiple 8 turns the reference
    widths (32, 43, 57, 76, 101) into (32, 48, 64, 80, 104), whose inputs
    it reads in place (Cin % 8 == 0); the hidden state then has the padded
    widths.
    """
    def up(c):
        return -(-c // multiple) * multiple

    widths = [folded[f"enc{i}"]["conv1"]["w"].shape[-1] for i in range(1, 6)]
    wp = [up(c) for c in widths]
    out = {}
    prev_p = folded["enc1"]["conv1"]["w"].shape[2]     # network input: 10
    for i in range(1, 6):
        p = folded[f"enc{i}"]
        c, c_p = widths[i - 1], wp[i - 1]
        aff = p["affine2"]
        s = aff["s"].new_ones((c_p,))
        s[:c] = aff["s"]
        t = aff["t"].new_zeros((c_p,))
        t[:c] = aff["t"]
        out[f"enc{i}"] = {
            "conv1": _pad_conv(p["conv1"], [(0, p["conv1"]["w"].shape[2], 0)],
                               prev_p, c_p, c),
            "conv2": _pad_conv(p["conv2"], [(0, c, 0), (c, 2 * c, c_p)],
                               2 * c_p, c_p, c),
            "affine2": {"s": s, "t": t},
            "conv3": _pad_conv(p["conv3"], [(0, c, 0)], c_p, c_p, c),
        }
        prev_p = c_p
    c, c_p = widths[4], wp[4]
    p = folded["bottleneck"]
    out["bottleneck"] = {
        "conv1": _pad_conv(p["conv1"], [(0, c, 0)], c_p, c_p, c),
        "conv2": _pad_conv(p["conv2"], [(0, c, 0), (c, 2 * c, c_p)],
                           2 * c_p, c_p, c),
        "conv3": _pad_conv(p["conv3"], [(0, c, 0)], c_p, c_p, c),
    }
    dec_in = widths[::-1]                       # 101, 76, 57, 43, 32
    dec_in_p = wp[::-1]
    dec_out = widths[:4][::-1] + [folded["dec1"]["conv2"]["w"].shape[-1]]
    dec_out_p = wp[:4][::-1] + [dec_out[4]]     # the final 3 stay
    for j, i in enumerate(range(5, 0, -1)):
        p = folded[f"dec{i}"]
        ci, ci_p = dec_in[j], dec_in_p[j]
        co, co_p = dec_out[j], dec_out_p[j]
        out[f"dec{i}"] = {
            "conv1": _pad_conv(p["conv1"], [(0, ci, 0), (ci, 2 * ci, ci_p)],
                               2 * ci_p, co_p, co),
            "conv2": _pad_conv(p["conv2"], [(0, co, 0)], co_p, co_p, co),
        }
    return out
