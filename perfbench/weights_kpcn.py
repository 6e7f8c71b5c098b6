"""The kernel-predicting denoiser's parameters, drawn on the device from
the run's seed in one call.  The same seed gives the same weights on the
same device, so the program and the reference each get their own copy."""
from __future__ import annotations

import torch

from .weights import generator

# Layer 9 at this multiple of He's scale: its logits' standard deviation is
# then near 1 (0.54-0.62 at He's scale on Cornell frames; the config's
# ``assumed``), so the softmax is neither a box filter nor one-hot.
LOGIT_SCALE = 1.7


def make_params(seed: int, model, device):
    """{"conv<i>": {"w": (5, 5, Cin, Co), "b": (Co,)}} float32: He-normal
    weights (layer 9's times ``LOGIT_SCALE``), biases 0.01 normal."""
    k = model["conv"]
    cs = [model["in_channels"]] + [model["width"]] * (model["layers"] - 1) + [model["kernel"] ** 2]
    shapes = list(zip(cs[:-1], cs[1:]))
    normal = torch.randn(sum(k * k * ci * co + co for ci, co in shapes),
                         generator=generator(seed, device), device=device)
    params, at = {}, 0
    for i, (ci, co) in enumerate(shapes, 1):
        n = k * k * ci * co
        scale = (2.0 / (k * k * ci)) ** 0.5 * (LOGIT_SCALE if i == len(shapes) else 1.0)
        params[f"conv{i}"] = {"w": normal[at:at + n].view(k, k, ci, co) * scale,
                              "b": 0.01 * normal[at + n:at + n + co]}
        at += n + co
    return params
