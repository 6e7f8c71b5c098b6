"""Primitive NN layers on NHWC tensors (counterpart of models/layers.py).

The pieces of the inference graph — LeakyReLU, 2x2 max pool, nearest 2x
upsample — plus the initialisers ``init_autoencoder`` uses.  Parameters
are plain dicts of tensors with HWIO conv weights, as in the JAX package.
The train graph's conv/BatchNorm/GroupNorm layers come with the training
slice (ROADMAP queue A).
"""
from __future__ import annotations

import torch


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
