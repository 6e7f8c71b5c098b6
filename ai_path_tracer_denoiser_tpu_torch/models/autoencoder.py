"""Recurrent denoising autoencoder: parameter tree and hidden state
(counterpart of models/autoencoder.py).

The 5-stage U-Net of recurrent_autoencoder_model.py:8-142 with per-stage
recurrent hidden states, channel plan 10 -> 32/43/57/76/101 -> ... -> 3.
``apply_frame`` / ``apply_sequence`` are the train graph (and the eval
graph of group-norm models and of ``interactive --parity-denoise``): every
conv goes through ``layers.conv2d``, i.e. the conv kernel with its
autograd; norms and LeakyReLUs are plain float32 tensor code.  Both take
the JAX package's collective arguments (process groups here):
``axis_name`` for data-parallel training, ``spatial_axis`` for a frame
whose rows are split over ranks (parallel/).  The deployed
forward pass with BatchNorm folded away is models/inference.py.

  encoder_i : conv -> norm -> LReLU; conv(cat(out1, hidden)) -> LReLU -> norm
              -> conv -> norm -> LReLU; hidden <- that output; 2x2 max pool
  bottleneck: the same with conv -> norm -> LReLU throughout
  decoder_i : nearest 2x upsample of cat(y, pooled encoder output) -> conv ->
              norm -> LReLU -> conv -> norm -> LReLU
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..config import ModelOptions
from .layers import (batch_norm, bn_init, bn_state_init, conv2d, conv_init,
                     group_norm, leaky_relu, max_pool_2x2, upsample_nearest_2x)


def _down_block_init(gen, c_in, c_out):
    return {
        "conv1": conv_init(gen, 3, c_in, c_out), "bn1": bn_init(c_out),
        "conv2": conv_init(gen, 3, 2 * c_out, c_out), "bn2": bn_init(c_out),
        "conv3": conv_init(gen, 3, c_out, c_out), "bn3": bn_init(c_out),
    }


def _down_block_state(c_out):
    return {"bn1": bn_state_init(c_out), "bn2": bn_state_init(c_out),
            "bn3": bn_state_init(c_out)}


def _up_block_init(gen, c_in, c_out):
    return {
        "conv1": conv_init(gen, 3, 2 * c_in, c_out), "bn1": bn_init(c_out),
        "conv2": conv_init(gen, 3, c_out, c_out), "bn2": bn_init(c_out),
    }


def _up_block_state(c_out):
    return {"bn1": bn_state_init(c_out), "bn2": bn_state_init(c_out)}


def init_autoencoder(generator: torch.Generator,
                     options: ModelOptions = ModelOptions()):
    """Returns (params, bn_state) as CPU float32 tensors, drawn from
    ``generator``.  Same tree and shapes as the JAX package's."""
    w = options.widths
    cs = [options.in_channels] + list(w)          # 10, 32, 43, 57, 76, 101
    params, state = {}, {}
    for i in range(5):
        params[f"enc{i + 1}"] = _down_block_init(generator, cs[i], cs[i + 1])
        state[f"enc{i + 1}"] = _down_block_state(cs[i + 1])
    params["bottleneck"] = _down_block_init(generator, w[4], w[4])
    state["bottleneck"] = _down_block_state(w[4])
    dec_out = list(w[:4][::-1]) + [options.out_channels]   # 76,57,43,32,3
    dec_in = list(w[::-1])                                  # 101,76,57,43,32
    for i in range(5):
        name = f"dec{5 - i}"
        params[name] = _up_block_init(generator, dec_in[i], dec_out[i])
        state[name] = _up_block_state(dec_out[i])
    return params, state


def init_hidden(batch: int, height: int, width: int,
                options: ModelOptions = ModelOptions(),
                dtype=torch.float32,
                device: Optional[torch.device] = None) -> Dict[str, torch.Tensor]:
    """Zero hidden states (recurrent_autoencoder_model.py:83-90), NHWC.

    Stage s lives at the input resolution of that stage: factors 1, 2, 4,
    8, 16 for enc1..5 and 32 for the bottleneck.
    """
    w = options.widths
    hidden = {}
    for i, f in enumerate([1, 2, 4, 8, 16]):
        hidden[f"enc{i + 1}"] = torch.zeros(
            (batch, height // f, width // f, w[i]), dtype=dtype, device=device)
    hidden["bottleneck"] = torch.zeros(
        (batch, height // 32, width // 32, w[4]), dtype=dtype, device=device)
    return hidden


def param_count(params) -> int:
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    return int(params.numel())


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------

def _norm(opts: ModelOptions, params, state, x, train, axis_name,
          spatial_axis):
    """BatchNorm (reference parity) or GroupNorm(8).  GroupNorm is stateless:
    the running statistics pass through untouched, so checkpoints keep one
    structure across both modes."""
    if opts.norm == "group":
        return group_norm(params, x, groups=8, eps=opts.bn_eps,
                          spatial_axis=spatial_axis), state
    return batch_norm(params, state, x, train, momentum=opts.bn_momentum,
                      eps=opts.bn_eps, axis_name=axis_name)


def _down_block(params, state, x, hidden, train, bf16, axis_name=None,
                spatial_axis=None, opts: ModelOptions = ModelOptions()):
    """Downsample RecurrentBlock forward (:64-70).  Returns (out, new_state)."""
    slope = opts.leaky_slope
    out1 = conv2d(params["conv1"], x, bf16, spatial_axis)
    out1, s1 = _norm(opts, params["bn1"], state["bn1"], out1, train, axis_name,
                     spatial_axis)
    out1 = leaky_relu(out1, slope)
    h = torch.cat([out1, hidden.to(out1.dtype)], dim=-1)
    out2 = conv2d(params["conv2"], h, bf16, spatial_axis)
    out2 = leaky_relu(out2, slope)                # LReLU before BN (:31-32)
    out2, s2 = _norm(opts, params["bn2"], state["bn2"], out2, train, axis_name,
                     spatial_axis)
    out2 = conv2d(params["conv3"], out2, bf16, spatial_axis)
    out2, s3 = _norm(opts, params["bn3"], state["bn3"], out2, train, axis_name,
                     spatial_axis)
    out2 = leaky_relu(out2, slope)
    return out2, {"bn1": s1, "bn2": s2, "bn3": s3}


def _bottleneck_block(params, state, x, hidden, train, bf16, axis_name=None,
                      spatial_axis=None, opts: ModelOptions = ModelOptions()):
    """Bottleneck forward (:75-81); layer2 order Conv->BN->LReLU (:55-62)."""
    slope = opts.leaky_slope
    out1 = conv2d(params["conv1"], x, bf16, spatial_axis)
    out1, s1 = _norm(opts, params["bn1"], state["bn1"], out1, train, axis_name,
                     spatial_axis)
    out1 = leaky_relu(out1, slope)
    h = torch.cat([out1, hidden.to(out1.dtype)], dim=-1)
    out2 = conv2d(params["conv2"], h, bf16, spatial_axis)
    out2, s2 = _norm(opts, params["bn2"], state["bn2"], out2, train, axis_name,
                     spatial_axis)
    out2 = leaky_relu(out2, slope)
    out2 = conv2d(params["conv3"], out2, bf16, spatial_axis)
    out2, s3 = _norm(opts, params["bn3"], state["bn3"], out2, train, axis_name,
                     spatial_axis)
    out2 = leaky_relu(out2, slope)
    return out2, {"bn1": s1, "bn2": s2, "bn3": s3}


def _up_block(params, state, x, train, bf16, axis_name=None, spatial_axis=None,
              opts: ModelOptions = ModelOptions()):
    """Upsample RecurrentBlock forward (:38-47, :72-73)."""
    slope = opts.leaky_slope
    x = upsample_nearest_2x(x)
    y = conv2d(params["conv1"], x, bf16, spatial_axis)
    y, s1 = _norm(opts, params["bn1"], state["bn1"], y, train, axis_name,
                  spatial_axis)
    y = leaky_relu(y, slope)
    y = conv2d(params["conv2"], y, bf16, spatial_axis)
    y, s2 = _norm(opts, params["bn2"], state["bn2"], y, train, axis_name,
                  spatial_axis)
    y = leaky_relu(y, slope)
    return y, {"bn1": s1, "bn2": s2}


def apply_frame(params, bn_state, x: torch.Tensor, hidden: Dict,
                train: bool = False, bf16: bool = False,
                axis_name=None, spatial_axis=None,
                options: Optional[ModelOptions] = None
                ) -> Tuple[torch.Tensor, Dict, Dict]:
    """One frame through the autoencoder (AutoEncoder.forward, :120-142).

    Args:
      x: (N, H, W, 10) G-buffer frame; H, W divisible by 32.
      hidden: dict from ``init_hidden`` (or the previous frame's output).
      axis_name: the data-parallel process group (BatchNorm statistics
        averaged over it), or None.
      spatial_axis: the process group over whose ranks the rows are split
        (halo convs, GroupNorm statistics averaged over it), or None; x and
        hidden are then this rank's rows.
      options: norm choice / leaky slope / bn eps+momentum; defaults to the
        reference configuration (BatchNorm, slope 0.1, eps 1e-5, momentum 0.1).
    Returns:
      (denoised (N, H, W, 3) float32, new_hidden, new_bn_state)
    """
    opts = options if options is not None else ModelOptions()
    _, h, w, _ = x.shape
    if h % 32 or w % 32:
        raise ValueError(
            f"input {h}x{w} must be divisible by 32 (5 pool/upsample stages, "
            "recurrent_autoencoder_model.py:98-117); pad or crop the frame")
    new_hidden, new_state, skips = {}, {}, []
    y = x
    for i in range(1, 6):
        name = f"enc{i}"
        out, new_state[name] = _down_block(
            params[name], bn_state[name], y, hidden[name], train, bf16,
            axis_name, spatial_axis, opts)
        new_hidden[name] = out
        y = max_pool_2x2(out)
        # the reference's skip tensors are the *pooled* encoder outputs
        # (:98-107, 136-140)
        skips.append(y)

    out, new_state["bottleneck"] = _bottleneck_block(
        params["bottleneck"], bn_state["bottleneck"], y, hidden["bottleneck"],
        train, bf16, axis_name, spatial_axis, opts)
    new_hidden["bottleneck"] = out
    y = out

    for i in range(5, 0, -1):
        name = f"dec{i}"
        y = torch.cat([y, skips[i - 1].to(y.dtype)], dim=-1)
        y, new_state[name] = _up_block(params[name], bn_state[name], y, train,
                                       bf16, axis_name, spatial_axis, opts)
    return y, new_hidden, new_state


def apply_sequence(params, bn_state, x_seq: torch.Tensor,
                   train: bool = False, bf16: bool = False,
                   axis_name=None, spatial_axis=None,
                   remat: bool = False,
                   options: Optional[ModelOptions] = None):
    """A whole temporal sequence, frame by frame (train.py:70-75 loop).

    Args:
      x_seq: (T, N, H, W, 10) time-major G-buffer sequence.
      remat: recompute each frame's activations in the backward pass
        (``torch.utils.checkpoint`` around the frame) instead of keeping
        every conv activation of all T frames alive.
    Returns:
      (outputs (T, N, H, W, 3), final_hidden, final_bn_state)

    Hidden states start at zero (j==0 re-init, :121-128) and persist
    across the frames; backpropagation runs through the whole sequence.
    Widths and channel counts come from the parameters themselves;
    ``options`` only carries the behaviour knobs (norm, slope, eps,
    momentum).
    """
    t, n, h, w, _ = x_seq.shape
    widths = tuple(params[f"enc{i}"]["conv1"]["w"].shape[-1] for i in range(1, 6))
    base = options if options is not None else ModelOptions()
    opts = dataclasses.replace(
        base, widths=widths, in_channels=x_seq.shape[-1],
        out_channels=params["dec1"]["conv2"]["w"].shape[-1])
    # The blocks emit float32 whatever the input dtype (bfloat16 stays
    # inside the conv), so the hidden carry is float32 too.
    hidden = init_hidden(n, h, w, opts, dtype=torch.float32, device=x_seq.device)

    def step(x, hidden, state):
        return apply_frame(params, state, x, hidden, train, bf16, axis_name,
                           spatial_axis, opts)

    ys = []
    for j in range(t):
        if remat:
            y, hidden, bn_state = checkpoint(step, x_seq[j], hidden, bn_state,
                                             use_reentrant=False)
        else:
            y, hidden, bn_state = step(x_seq[j], hidden, bn_state)
        ys.append(y)
    return torch.stack(ys), hidden, bn_state
