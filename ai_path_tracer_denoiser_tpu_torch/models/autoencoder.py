"""Recurrent denoising autoencoder: parameter tree and hidden state
(counterpart of models/autoencoder.py).

The 5-stage U-Net of recurrent_autoencoder_model.py:8-142 with per-stage
recurrent hidden states, channel plan 10 -> 32/43/57/76/101 -> ... -> 3.
This slice ports what inference needs: ``init_autoencoder`` (the random
model of the no-checkpoint path) and ``init_hidden``.  The train graph
``apply_frame`` and ``apply_sequence`` come with the training slice
(ROADMAP queue A); the deployed forward pass is models/inference.py.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..config import ModelOptions
from .layers import bn_init, bn_state_init, conv_init


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
