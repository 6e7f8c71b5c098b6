"""Primitive NN layers on NHWC tensors (counterpart of models/layers.py).

LeakyReLU, 2x2 max pool, nearest 2x upsample and the initialisers, plus the
train graph's layers: ``conv2d`` (a 3x3 SAME conv whose forward pass and
input gradient both run through the fused conv kernel,
``Conv3x3Function``), ``batch_norm`` and ``group_norm`` written out as the
JAX package's formulas.  Parameters are plain dicts of tensors with HWIO
conv weights, as in the JAX package.

The collective arguments keep the JAX package's names and take a
``torch.distributed`` process group (``None``: no collective):
``axis_name`` is the data-parallel group whose ranks hold other sequences
of the batch (BatchNorm's statistics are averaged over it),
``spatial_axis`` the group whose ranks hold other rows of the frame (the
conv exchanges one-row halos with its neighbours, GroupNorm's statistics
are averaged over it).  Both collectives are differentiable.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

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


class _AllReduceMean(torch.autograd.Function):
    """Mean of ``x`` over the ranks of ``group``: a sum all-reduce divided
    by the group's size.  Its backward pass is the same mean of the
    cotangents (the transpose of ``lax.pmean`` under ``shard_map``), so
    BatchNorm sharded over the batch is large-batch BatchNorm, gradients
    included, once the caller averages the gradients too."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _mean_over(x, group)

    @staticmethod
    def backward(ctx, g):
        return _mean_over(g, ctx.group), None


def _mean_over(x: torch.Tensor, group) -> torch.Tensor:
    y = x.detach().clone().contiguous()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y / dist.get_world_size(group)


_all_reduce_mean = _AllReduceMean.apply


class _HaloExchangeRows(torch.autograd.Function):
    """(N, h, W, C) -> (N, h + 2 halo, W, C): ``halo`` rows from the rank
    above and from the rank below in ``group`` (zeros at the frame's top
    and bottom edges), as ``_halo_exchange_rows`` does with two ppermutes.
    The backward pass sends the halo rows' cotangents back where the rows
    came from and adds them to those boundary rows."""

    @staticmethod
    def forward(ctx, x, halo, group):
        ctx.halo, ctx.group = halo, group
        x = x.contiguous()
        above, below = _exchange(x[:, -halo:], x[:, :halo], group)
        return torch.cat([above, x, below], dim=1)

    @staticmethod
    def backward(ctx, g):
        halo = ctx.halo
        g = g.contiguous()
        from_above, from_below = _exchange(g[:, -halo:], g[:, :halo], ctx.group)
        dx = g[:, halo:-halo].clone()
        dx[:, :halo] += from_above
        dx[:, -halo:] += from_below
        return dx, None, None


def _exchange(to_next, to_prev, group):
    """Send ``to_next`` to the next rank of ``group`` and ``to_prev`` to the
    previous one; returns (what the previous rank sent on, what the next
    rank sent back), zeros where there is no such rank."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    to_next, to_prev = to_next.contiguous(), to_prev.contiguous()
    from_prev, from_next = torch.zeros_like(to_next), torch.zeros_like(to_prev)
    ops = []
    if r + 1 < n:
        peer = dist.get_global_rank(group, r + 1)
        ops += [dist.P2POp(dist.isend, to_next, peer, group),
                dist.P2POp(dist.irecv, from_next, peer, group)]
    if r > 0:
        peer = dist.get_global_rank(group, r - 1)
        ops += [dist.P2POp(dist.isend, to_prev, peer, group),
                dist.P2POp(dist.irecv, from_prev, peer, group)]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return from_prev, from_next


_halo_exchange_rows = _HaloExchangeRows.apply


# The JAX package's lowerings of the train graph's conv.  The port has one:
# the conv kernel (its plain version on the CPU) with its autograd.
CONV2D_IMPLS = ("auto", "pallas2", "matmul", "native")


def conv2d(params, x: torch.Tensor, bf16: bool = False,
           spatial_axis=None, impl: str = "auto") -> torch.Tensor:
    """3x3 SAME conv, NHWC/HWIO, float32 out; the bias is added in float32
    after the conv.

    With ``bf16`` x and w are rounded to bfloat16 first and the conv hands
    back its float32 accumulator.  Every ``impl`` name of the JAX package
    goes through ``Conv3x3Function`` (the conv kernel on the card, its
    plain version on the CPU), whatever the height.

    ``spatial_axis``: the group over whose ranks the frame's rows are split.
    One row from each neighbour extends x to h + 2 rows, the same conv runs
    on the extended tensor and its rows 1..h are kept: a SAME conv over the
    extended rows is the JAX package's halo conv, VALID in H.  That conv
    hands back bfloat16 under ``bf16``, so its output is rounded to
    bfloat16 here before the bias, as it is there.
    """
    if impl not in CONV2D_IMPLS:
        raise ValueError(f"conv impl {impl!r} not in {CONV2D_IMPLS}")
    w = params["w"]
    if tuple(w.shape[:2]) != (3, 3):
        raise ValueError(f"conv2d takes 3x3 weights, got {tuple(w.shape)}")
    dtype = torch.bfloat16 if bf16 else torch.float32
    x, w = x.to(dtype), w.to(dtype)
    if spatial_axis is None:
        return Conv3x3Function.apply(x, w) + params["b"]
    h = x.shape[1]
    y = Conv3x3Function.apply(_halo_exchange_rows(x, 1, spatial_axis), w)[:, 1:h + 1]
    if bf16:
        y = y.to(torch.bfloat16).to(torch.float32)
    return y + params["b"]


def batch_norm(params, state, x: torch.Tensor, train: bool,
               momentum: float = 0.1, eps: float = 1e-5,
               axis_name=None):
    """BatchNorm over (N, H, W).  Returns (y, new_state).

    Written out as the JAX package's formula and not ``F.batch_norm``: in
    train mode the biased batch variance is E[x^2] - E[x]^2 in float32, the
    running estimates take the unbiased variance (torch's convention), and
    y = (x - mean) * rsqrt(var + eps) * scale + bias.  The running
    estimates carry no gradient.  ``axis_name``: the data-parallel group;
    E[x] and E[x^2] are averaged over its ranks (one all-reduce) and the
    unbiased count spans them.
    """
    x32 = x.to(torch.float32)
    if train:
        mean = x32.mean(dim=(0, 1, 2))
        sqmean = x32.square().mean(dim=(0, 1, 2))
        n = x32.shape[0] * x32.shape[1] * x32.shape[2]
        if axis_name is not None:
            mean, sqmean = _all_reduce_mean(torch.stack([mean, sqmean]), axis_name).unbind()
            n = n * dist.get_world_size(axis_name)
        var = sqmean - mean.square()
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
               eps: float = 1e-5, spatial_axis=None) -> torch.Tensor:
    """GroupNorm over (H, W, C/groups) per sample, stateless; the group
    count is gcd(groups, C) so the reference's 43/57/76/101 widths and the
    3-channel output normalise too.  Variance as E[x^2] - E[x]^2.
    ``spatial_axis``: the group over whose ranks the rows are split; the
    statistics are averaged over it (one all-reduce)."""
    n, h, w, c = x.shape
    g = math.gcd(groups, c)
    xg = x.to(torch.float32).reshape(n, h, w, g, c // g)
    mean = xg.mean(dim=(1, 2, 4), keepdim=True)
    sqmean = xg.square().mean(dim=(1, 2, 4), keepdim=True)
    if spatial_axis is not None:
        mean, sqmean = _all_reduce_mean(torch.stack([mean, sqmean]), spatial_axis).unbind()
    var = sqmean - mean.square()
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(n, h, w, c)
    return y * params["scale"] + params["bias"]
