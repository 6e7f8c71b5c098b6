"""Three-part denoiser loss: spatial L1 + gradient-domain HFEN + temporal L1
(counterpart of train/loss.py).

Port of loss.py:16-104 and the per-frame weighting of train.py:77-89, on
NHWC tensors.  The loss's own small convolutions (5x5 Gaussian, 3x3
Laplacian) are plain ``torch.nn.functional.conv2d`` calls, as they are
plain XLA convolutions outside any kernel in the JAX package.

Reference quirks preserved (they change the trained objective):
  * The LoG "depthwise" filter is built by repeating a (1,1,3,3) kernel over
    the *input-channel* axis without conv groups (loss.py:24-31), so the
    Laplacian is summed across RGB into a single channel.
  * HFEN max-normalizes each LoG response by its global max when nonzero
    (loss.py:73-77).  The max carries a gradient, spread evenly over ties
    (``amax``, as ``jnp.max``); where the max is zero the untaken x / max
    branch still turns the gradient of that tensor into NaN, in both
    packages.
  * The temporal stack's frame 0 is all zeros for both output and target
    (loss.py:86-93), contributing |0-0| to the temporal L1.
  * Gaussian kernel: 5x5, sigma=1.5, normalized to sum 1 (loss.py:33-65),
    applied depthwise per channel with no padding (the reference's
    nn.Conv2d has none), so the blurred maps shrink by 4 px before the LoG.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..utils.timers import host_read

# Gaussian-ramp frame weights val_j (train.py:77): exp(-(6-j)^2/8) rounded.
FRAME_RAMP = (0.011, 0.044, 0.135, 0.325, 0.607, 0.882, 1.0)

_LOG_KERNEL = ((0.0, 1.0, 0.0), (1.0, -4.0, 1.0), (0.0, 1.0, 0.0))


def l1_norm(output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean absolute error (loss.py:82-84)."""
    return (target - output).abs().mean()


def gaussian_kernel(kernel_size: int = 5, sigma: float = 1.5,
                    device=None) -> torch.Tensor:
    """2-D Gaussian, sum 1 (get_gaussian_kernel, loss.py:33-57)."""
    coords = torch.arange(kernel_size, dtype=torch.float32, device=device)
    yg, xg = torch.meshgrid(coords, coords, indexing="ij")
    mean = (kernel_size - 1) / 2.0
    var = sigma ** 2
    g = (1.0 / (2.0 * math.pi * var)) * torch.exp(
        -((xg - mean) ** 2 + (yg - mean) ** 2) / (2 * var))
    return g / g.sum()


def _depthwise_conv(x: torch.Tensor, k2d: torch.Tensor, padding: int) -> torch.Tensor:
    """Depthwise 2-D conv on NHWC with a shared (kh, kw) kernel."""
    c = x.shape[-1]
    kernel = k2d.to(x.dtype)[None, None].expand(c, 1, -1, -1)
    y = F.conv2d(x.permute(0, 3, 1, 2), kernel, padding=padding, groups=c)
    return y.permute(0, 2, 3, 1)


def log_filter(x: torch.Tensor) -> torch.Tensor:
    """Channel-summed Laplacian, SAME padding (LoG, loss.py:16-31).

    Input (N,H,W,C) -> output (N,H,W,1): the reference's repeated-weight
    conv2d sums the Laplacian over input channels.
    """
    c = x.shape[-1]
    with host_read("loss_kernel"):      # a copy from the host: waits for the queue
        k = torch.tensor(_LOG_KERNEL, dtype=x.dtype, device=x.device)
    kernel = k[None, None].expand(1, c, -1, -1)
    y = F.conv2d(x.permute(0, 3, 1, 2), kernel, padding=1)
    return y.permute(0, 2, 3, 1)


class _AllGather(torch.autograd.Function):
    """(k,) -> (ranks * k,): every rank's ``x`` in rank order.  Backward:
    the cotangents summed over the ranks (one all-reduce), of which each
    rank keeps its own slot: the transpose of ``lax.all_gather``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        k = g.numel() // dist.get_world_size(ctx.group)
        r = dist.get_rank(ctx.group)
        return g[r * k:(r + 1) * k], None


_all_gather = _AllGather.apply


def _max_normalize(x: torch.Tensor, axis_name=None) -> torch.Tensor:
    m = x.amax()
    if axis_name is not None:
        # a differentiable max over the ranks: gather every rank's max,
        # then reduce (the JAX package's pmax has no VJP, so it does the same)
        m = _all_gather(m.reshape(1), axis_name).amax()
    return torch.where(m != 0, x / m, x)


def hfen(output: torch.Tensor, target: torch.Tensor,
         axis_name=None) -> torch.Tensor:
    """High-frequency error norm (HFEN, loss.py:68-79).

    Gaussian(5, 1.5) depthwise with no padding, then channel-summed LoG,
    each max-normalized when its max is nonzero, then L1.  With
    ``axis_name`` (the data-parallel process group) the normalising max
    spans its ranks, so sharded training is single-device training.
    """
    g = gaussian_kernel(5, 1.5, device=output.device)
    grad_t = _max_normalize(log_filter(_depthwise_conv(target, g, 0)), axis_name)
    grad_o = _max_normalize(log_filter(_depthwise_conv(output, g, 0)), axis_name)
    return l1_norm(grad_o, grad_t)


def temporal_diff(seq: torch.Tensor) -> torch.Tensor:
    """Finite differences along the time axis, frame 0 zeroed.

    (T, ...) -> (T, ...): out[i] = seq[i] - seq[i-1], out[0] = 0
    (get_temporal_data, loss.py:86-93).
    """
    return torch.cat([torch.zeros_like(seq[:1]), seq[1:] - seq[:-1]], dim=0)


def frame_loss(output, t_output, target, t_target, axis_name=None):
    """(ls, lg, lt) for one frame (loss_func, loss.py:99-104)."""
    return (l1_norm(output, target), hfen(output, target, axis_name),
            l1_norm(t_output, t_target))


def sequence_loss(outputs: torch.Tensor, targets: torch.Tensor,
                  w_spatial: float = 0.8, w_gradient: float = 0.1,
                  w_temporal: float = 0.1,
                  frame_ramp: Tuple[float, ...] = FRAME_RAMP,
                  axis_name=None):
    """Total BPTT loss over a (T, N, H, W, 3) sequence (train.py:76-89).

    total = sum_j (ws + r_j)*ls_j + (wg + r_j)*lg_j + (wt + r_j)*lt_j

    Returns (total, dict of summed components).  Targets may arrive
    bfloat16; every term is computed in the outputs' dtype (float32).
    ``axis_name``: the data-parallel process group, for HFEN's max.
    """
    targets = targets.to(outputs.dtype)
    t_out = temporal_diff(outputs)
    t_tgt = temporal_diff(targets)
    t = outputs.shape[0]
    if len(frame_ramp) < t:
        raise ValueError("frame_ramp shorter than sequence")
    total = ls_sum = lg_sum = lt_sum = torch.zeros((), dtype=outputs.dtype,
                                                   device=outputs.device)
    for j in range(t):
        ls, lg, lt = frame_loss(outputs[j], t_out[j], targets[j], t_tgt[j],
                                axis_name)
        r = frame_ramp[j]
        total = total + (w_spatial + r) * ls + (w_gradient + r) * lg + (w_temporal + r) * lt
        ls_sum, lg_sum, lt_sum = ls_sum + ls, lg_sum + lg, lt_sum + lt
    return total, {"total": total, "l1": ls_sum, "hfen": lg_sum,
                   "temporal": lt_sum}
