"""The denoiser's parameters and BatchNorm state, drawn on the device from
the run's seed in a few large calls.  The same seed gives the same tree on
the same device, so the program and the reference each get their own copy
from the seed."""
from __future__ import annotations

import torch

from .reference.rdae import tree_spec


RECURRENT_SCALE = 0.25


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & 0xFFFFFFFFFFFFFFFF)
    return g


def make_params(seed: int, widths, device, c_in: int = 10, c_out: int = 3):
    """(params, bn_state) float32 trees: HWIO conv weights with He-normal
    scale, small biases, BatchNorm scales and shifts and running
    statistics spread around the identity (so that folding them is not a
    no-op).  The half of each recurrent conv that reads the hidden state is
    drawn at ``RECURRENT_SCALE`` of He's scale: the recurrence then
    contracts over frames, as a trained network's does; at He's scale some
    seeds grow frame over frame without bound and overflow bfloat16."""
    spec = tree_spec(widths, c_in, c_out)
    g = generator(seed, device)
    n_w = sum(9 * ci * co for *_, ci, co in spec)
    n_c = sum(co for *_, co in spec)
    normal = torch.randn(n_w + 4 * n_c, generator=g, device=device)
    uniform = torch.rand(2 * n_c, generator=g, device=device)
    params, bn = {}, {}
    iw, ic = 0, n_w
    iu = 0
    for block, conv, ci, co in spec:
        w = normal[iw:iw + 9 * ci * co].view(3, 3, ci, co) * (2.0 / (9 * ci)) ** 0.5
        if conv == "conv2" and not block.startswith("dec"):
            w = torch.cat([w[:, :, :co], RECURRENT_SCALE * w[:, :, co:]], dim=2)
        iw += 9 * ci * co
        b, beta, mean = (normal[ic + k * co:ic + (k + 1) * co] for k in range(3))
        ic += 4 * co
        scale = 0.8 + 0.4 * uniform[iu:iu + co]
        var = 0.8 + 0.45 * uniform[iu + co:iu + 2 * co]
        iu += 2 * co
        k = conv[-1]
        params.setdefault(block, {})[conv] = {"w": w.contiguous(), "b": 0.01 * b}
        params[block][f"bn{k}"] = {"scale": scale, "bias": 0.05 * beta}
        bn.setdefault(block, {})[f"bn{k}"] = {"mean": 0.05 * mean, "var": var}
    return params, bn
