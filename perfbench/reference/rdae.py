"""Plain reference of the recurrent denoising autoencoder, in float32.

Chaitanya et al. 2017 as recurrent_autoencoder_model.py:93-117 states it:
five recurrent encoder stages (conv, BatchNorm, LeakyReLU 0.1; a conv over
the stage's output beside its hidden state; a third conv; a 2x2 max pool),
a recurrent bottleneck, five decoder stages that upsample the concatenation
of the path and the pooled encoder output, and the three-part loss (spatial
L1, HFEN, temporal L1) with the per-frame ramp.  Convolutions are
``F.conv2d`` with TF32 off; every BatchNorm is applied as it stands (no
folding).  ``quant="fp8"`` rounds each conv's input and weight to float8
e4m3 with one scale per tensor: the control that a cell's limits must
refuse; ``quant="bf16"`` rounds them to bfloat16, as the program does: a
second witness of what bfloat16 alone costs.  Imports nothing of the program.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import torch
import torch.nn.functional as F

SLOPE, EPS, MOMENTUM = 0.1, 1e-5, 0.1
FRAME_RAMP = (0.011, 0.044, 0.135, 0.325, 0.607, 0.882, 1.0)


def tree_spec(widths, c_in: int = 10, c_out: int = 3) -> List[Tuple[str, str, int, int]]:
    """(block, conv, Cin, Cout) of every conv, in the network's order."""
    w = list(widths)
    cs = [c_in] + w
    out = []
    for i in range(5):
        c = cs[i + 1]
        out += [(f"enc{i + 1}", "conv1", cs[i], c), (f"enc{i + 1}", "conv2", 2 * c, c),
                (f"enc{i + 1}", "conv3", c, c)]
    out += [("bottleneck", "conv1", w[4], w[4]), ("bottleneck", "conv2", 2 * w[4], w[4]),
            ("bottleneck", "conv3", w[4], w[4])]
    dec_in, dec_out = w[::-1], w[:4][::-1] + [c_out]
    for j, i in enumerate(range(5, 0, -1)):
        out += [(f"dec{i}", "conv1", 2 * dec_in[j], dec_out[j]),
                (f"dec{i}", "conv2", dec_out[j], dec_out[j])]
    return out


def _q8(t: torch.Tensor) -> torch.Tensor:
    """Per-tensor scaled float8 e4m3 rounding, gradient passed straight."""
    scale = t.detach().abs().amax().clamp_min(1e-12) / 448.0
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return t + (q - t).detach()


def _qbf16(t: torch.Tensor) -> torch.Tensor:
    """bfloat16 rounding, gradient passed straight."""
    return t + (t.detach().to(torch.bfloat16).to(torch.float32) - t.detach())


def _conv(p, x, quant):
    w = p["w"].permute(3, 2, 0, 1)
    if quant == "fp8":
        x, w = _q8(x), _q8(w)
    elif quant == "bf16":
        x, w = _qbf16(x), _qbf16(w)
    return F.conv2d(x, w, p["b"], padding=1)


def _lrelu(x):
    return torch.where(x >= 0, x, SLOPE * x)


def _bn(p, st, x, train):
    if train:
        mean = x.mean(dim=(0, 2, 3))
        var = x.square().mean(dim=(0, 2, 3)) - mean.square()
        n = x.shape[0] * x.shape[2] * x.shape[3]
        new = {"mean": (1 - MOMENTUM) * st["mean"] + MOMENTUM * mean.detach(),
               "var": (1 - MOMENTUM) * st["var"] + MOMENTUM * var.detach() * (n / (n - 1))}
    else:
        mean, var, new = st["mean"], st["var"], st
    shape = (1, -1, 1, 1)
    y = (x - mean.view(shape)) * torch.rsqrt(var.view(shape) + EPS)
    return y * p["scale"].view(shape) + p["bias"].view(shape), new


def frame(params, bn, x, hidden, train=False, quant="fp32"):
    """One frame, NCHW float32.  Returns (output, new hidden, new BN state)."""
    new_h, new_bn, skips = {}, {}, []
    y = x
    for name in [f"enc{i}" for i in range(1, 6)] + ["bottleneck"]:
        p, s = params[name], bn[name]
        o1, s1 = _bn(p["bn1"], s["bn1"], _conv(p["conv1"], y, quant), train)
        o1 = _lrelu(o1)
        o2 = _conv(p["conv2"], torch.cat([o1, hidden[name]], 1), quant)
        if name == "bottleneck":
            o2, s2 = _bn(p["bn2"], s["bn2"], o2, train)
            o2 = _lrelu(o2)
        else:
            o2, s2 = _bn(p["bn2"], s["bn2"], _lrelu(o2), train)
        o3, s3 = _bn(p["bn3"], s["bn3"], _conv(p["conv3"], o2, quant), train)
        o3 = _lrelu(o3)
        new_h[name], new_bn[name] = o3, {"bn1": s1, "bn2": s2, "bn3": s3}
        if name == "bottleneck":
            y = o3
        else:
            y = F.max_pool2d(o3, 2)
            skips.append(y)
    for i in range(5, 0, -1):
        p, s = params[f"dec{i}"], bn[f"dec{i}"]
        y = F.interpolate(torch.cat([y, skips[i - 1]], 1), scale_factor=2, mode="nearest")
        y, s1 = _bn(p["bn1"], s["bn1"], _conv(p["conv1"], y, quant), train)
        y, s2 = _bn(p["bn2"], s["bn2"], _conv(p["conv2"], _lrelu(y), quant), train)
        y = _lrelu(y)
        new_bn[f"dec{i}"] = {"bn1": s1, "bn2": s2}
    return y, new_h, new_bn


def zero_hidden(n, h, w, widths, device):
    out = {f"enc{i + 1}": torch.zeros(n, c, h >> i, w >> i, device=device)
           for i, c in enumerate(widths)}
    out["bottleneck"] = torch.zeros(n, widths[4], h >> 5, w >> 5, device=device)
    return out


def edge_pad(x: torch.Tensor, hp: int, wp: int) -> torch.Tensor:
    """NCHW, bottom and right edges replicated up to (hp, wp)."""
    return F.pad(x, (0, wp - x.shape[3], 0, hp - x.shape[2]), mode="replicate")


# ------------------------------------------------------------------ loss

def _gauss(device):
    c = torch.arange(5, dtype=torch.float32, device=device)
    yg, xg = torch.meshgrid(c, c, indexing="ij")
    g = torch.exp(-((xg - 2.0) ** 2 + (yg - 2.0) ** 2) / (2 * 1.5 ** 2)) / (2 * math.pi * 1.5 ** 2)
    return g / g.sum()


def _hfen(out, tgt):
    """Gaussian 5x5 (sigma 1.5, no padding, per channel), then the 3x3
    Laplacian summed over the channels, each max-normalised, then L1."""
    c = out.shape[1]
    g = _gauss(out.device)[None, None].expand(c, 1, 5, 5)
    lap = torch.tensor([[0.0, 1.0, 0.0], [1.0, -4.0, 1.0], [0.0, 1.0, 0.0]],
                       device=out.device)[None, None].expand(1, c, 3, 3)

    def resp(x):
        r = F.conv2d(F.conv2d(x, g, groups=c), lap, padding=1)
        m = r.amax()
        return torch.where(m != 0, r / m, r)

    return (resp(tgt) - resp(out)).abs().mean()


def sequence_loss(outs, tgts, ws=0.8, wg=0.1, wt=0.1, ramp=FRAME_RAMP):
    """sum_j (ws + r_j) L1_j + (wg + r_j) HFEN_j + (wt + r_j) temporal L1_j
    over (T, N, 3, H, W); the temporal difference of frame 0 is zero.
    Returns (total, the three terms each summed over the frames)."""
    total = outs.new_zeros(())
    parts = {"l1": 0.0, "hfen": 0.0, "temporal": 0.0}
    for j in range(outs.shape[0]):
        lt = (outs.new_zeros(()) if j == 0 else
              ((tgts[j] - tgts[j - 1]) - (outs[j] - outs[j - 1])).abs().mean())
        ls = (tgts[j] - outs[j]).abs().mean()
        lg = _hfen(outs[j], tgts[j])
        r = ramp[j]
        total = total + (ws + r) * ls + (wg + r) * lg + (wt + r) * lt
        for k, v in zip(parts, (ls, lg, lt)):
            parts[k] = parts[k] + v.detach()
    return total, parts


def leaves(tree, prefix=()):
    """[(path, leaf)] in sorted-key order."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    return [kv for k in sorted(tree) for kv in leaves(tree[k], prefix + (k,))]


def rebuild(tree, values):
    it = iter(values)

    def go(node):
        if not isinstance(node, dict):
            return next(it)
        return {k: go(node[k]) for k in sorted(node)}

    return go(tree)


def train_step(params, bn, opt, x, y, lr, widths, quant="fp32"):
    """One BPTT step over (T, N, 10, H, W) inputs and (T, N, 3, H, W)
    targets, then Adam (b1 0.9, b2 0.999, eps 1e-8 outside the root, bias
    corrected).  Returns (losses {total, l1, hfen, temporal}, gradient
    tree, params, bn, opt)."""
    flat = [v.detach().requires_grad_(True) for _, v in leaves(params)]
    p = rebuild(params, flat)
    t, n, _, h, w = x.shape
    hidden = zero_hidden(n, h, w, widths, x.device)
    outs = []
    for j in range(t):
        o, hidden, bn = frame(p, bn, x[j], hidden, train=True, quant=quant)
        outs.append(o)
    loss, parts = sequence_loss(torch.stack(outs), y)
    grads = torch.autograd.grad(loss, flat)
    count = opt["count"] + 1
    b1, b2 = 0.9, 0.999
    mu = [b1 * m + (1 - b1) * g for m, g in zip(opt["mu"], grads)]
    nu = [b2 * v + (1 - b2) * g * g for v, g in zip(opt["nu"], grads)]
    new = [q.detach() - lr * (m / (1 - b1 ** count)) /
           (torch.sqrt(v / (1 - b2 ** count)) + 1e-8)
           for q, m, v in zip(flat, mu, nu)]
    bn = {k: {kk: {s: t_.detach() for s, t_ in vv.items()} for kk, vv in v.items()}
          for k, v in bn.items()}
    return ({"total": loss.detach(), **parts}, rebuild(params, list(grads)),
            rebuild(params, new), bn, {"count": count, "mu": mu, "nu": nu})
