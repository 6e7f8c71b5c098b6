"""Work counted from shapes alone: the denoiser's convolutions, their
operations and the bytes a roofline bound charges for them.  Nothing here
reads the program, so a change to how the program computes a layer leaves
the yardstick as it was."""
from __future__ import annotations

import json
import os
from typing import List, Tuple

from .reference.rdae import tree_spec

PEAKS = json.load(open(os.path.join(os.path.dirname(__file__), "peaks.json")))


def rdae_convs(h: int, w: int, widths, c_in: int = 10,
               c_out: int = 3) -> List[Tuple[str, int, int, int, int]]:
    """(name, H, W, Cin, Cout) of the 28 3x3 convs of one frame at the
    padded input size (h, w): encoder stage i at 1/2^(i-1), the bottleneck
    at 1/32, decoder stage i at the resolution of encoder stage i."""
    out = []
    for block, conv, ci, co in tree_spec(widths, c_in, c_out):
        if block == "bottleneck":
            f = 32
        else:
            f = 2 ** (int(block[3:]) - 1)
        out.append((f"{block}.{conv}", h // f, w // f, ci, co))
    return out


def conv_flops(convs) -> int:
    """2 * H * W * Cin * Cout * 9 summed: multiply and add of each tap."""
    return sum(2 * hh * ww * ci * co * 9 for _, hh, ww, ci, co in convs)


def conv_bytes(convs, elem: int = 2) -> int:
    """Input, weights and output of each conv moved once, ``elem`` bytes
    an element (bfloat16: 2)."""
    return sum(elem * (hh * ww * ci + 9 * ci * co + hh * ww * co)
               for _, hh, ww, ci, co in convs)


def bound_s(convs, peaks=PEAKS) -> float:
    """Least time the card could take for the convs, each bound by its
    bytes or its operations, whichever is slower, summed."""
    return sum(max(conv_bytes([c]) / peaks["hbm_bytes_per_s"],
                   conv_flops([c]) / peaks["bf16_flops"]) for c in convs)
