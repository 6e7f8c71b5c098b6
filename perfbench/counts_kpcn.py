"""Work of the kernel-predicting denoiser counted from its published shapes
alone (Cin 30 for layer 1, 100 wide, Co 441 for layer 9; never the padded
channels or tiles a kernel computes): its nine 5x5 convs' operations and
bytes, and the bytes of its per-pixel kernel apply.  Nothing here reads
the program."""
from __future__ import annotations

from typing import List, Tuple

from .counts import PEAKS


def kpcn_convs(h: int, w: int, model) -> List[Tuple[str, int, int, int, int]]:
    """(name, H, W, Cin, Cout) of the nine convs of one (h, w) frame."""
    cs = ([model["in_channels"]] + [model["width"]] * (model["layers"] - 1)
          + [model["kernel"] ** 2])
    return [(f"conv{i}", h, w, ci, co) for i, (ci, co) in enumerate(zip(cs[:-1], cs[1:]), 1)]


def conv_flops(convs, taps: int = 25) -> int:
    """2 * H * W * Cin * Cout * 25 summed: multiply and add of each tap."""
    return sum(2 * hh * ww * ci * co * taps for _, hh, ww, ci, co in convs)


def conv_bytes(convs, taps: int = 25, elem: int = 2) -> int:
    """Input, weights and output of each conv moved once, ``elem`` bytes
    an element (bfloat16: 2)."""
    return sum(elem * (hh * ww * ci + taps * ci * co + hh * ww * co)
               for _, hh, ww, ci, co in convs)


def conv_bound_s(convs, peaks=PEAKS) -> float:
    """Least time the card could take for the convs, each bound by its
    bytes or its operations, whichever is slower, summed."""
    return sum(max(conv_bytes([c]) / peaks["hbm_bytes_per_s"],
                   conv_flops([c]) / peaks["bf16_flops"]) for c in convs)


def apply_bytes(h: int, w: int, k: int) -> int:
    """Each pixel's k*k bfloat16 logits, its 3 float32 radiance values and
    its 3 float32 results, moved once."""
    return h * w * (2 * k * k + 4 * 3 + 4 * 3)


def apply_bound_s(h: int, w: int, k: int, peaks=PEAKS) -> float:
    """The apply's bytes over the card's memory bandwidth (its operations,
    k*k exponentials and 3 k*k multiply-adds a pixel, take less)."""
    return apply_bytes(h, w, k) / peaks["hbm_bytes_per_s"]
