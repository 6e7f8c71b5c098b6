"""How far a campaign's eval window moves on the CPU when the conv's plain
version is changed: its nine taps summed in reverse order (no fault, only
float32 sum order), one tap dropped, and the taps transposed (two planted
faults).  Each is printed as rel L2 against the plain window, the measure
that ``chip_smoke.py``'s ``campaign_path`` holds the card's eval window
to, so the readings place that bar between sum-order noise and a fault.

    python -m ai_path_tracer_denoiser_tpu_torch.tools.eval_bar_probe \\
        --out runs/chip_smoke/campaign

``--out`` is a campaign's ``--out`` (its eval corpus under ``data/eval``);
``--artifact`` is the model, by default ``<out>/artifacts/denoiser_multiscene.npz``.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch
import torch.nn.functional as F

TAPS = [(dy, dx) for dy in range(3) for dx in range(3)]
# variant -> (input shift, weight tap) pairs summed in this order
VARIANTS = {
    "reversed_taps": [(t, t) for t in reversed(TAPS)],
    "dropped_tap": [(t, t) for t in TAPS[:-1]],
    "transposed_taps": [((dy, dx), (dx, dy)) for dy, dx in TAPS],
}


def conv_with(pairs):
    """``conv3x3_act_plain`` with its taps summed as ``pairs`` says."""
    from ..models import conv_kernel

    def conv(x, w, b, slope, affine=None, out_dtype=None):
        xb = x if x.dim() == 4 else x[None]
        n, h, wd, c = xb.shape
        xp = F.pad(xb.float(), (0, 0, 1, 1, 1, 1))
        acc = None
        for (dy, dx), (ky, kx) in pairs:
            part = xp[:, dy:dy + h, dx:dx + wd].reshape(n * h * wd, c) @ w[ky, kx].float()
            acc = part if acc is None else acc + part
        y = conv_kernel._epilogue(acc.reshape(n, h, wd, -1), b, slope, affine)
        y = y.to(conv_kernel._out_dtype(x, out_dtype))
        return y if x.dim() == 4 else y[0]
    return conv


def rel_l2(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", required=True, help="a campaign's --out directory")
    p.add_argument("--artifact", default=None)
    p.add_argument("--window", type=int, default=0, help="eval window index")
    args = p.parse_args(argv)
    from ..data import SequenceDataset
    from ..models import conv_kernel, load_model, model_options_from_meta
    from .train_pipeline import eval_window
    artifact = args.artifact or os.path.join(args.out, "artifacts", "denoiser_multiscene.npz")
    params, bn_state, meta = load_model(artifact, device="cpu")
    mopt = model_options_from_meta(meta)
    data = os.path.join(args.out, "data", "eval")
    x, _ = SequenceDataset(os.path.join(data, "input"), os.path.join(data, "gt"),
                           crop=False)[args.window]
    cpu = torch.device("cpu")
    base = eval_window(params, bn_state, mopt, x, cpu)
    plain = conv_kernel.conv3x3_act_plain
    readings, seconds = {}, {}
    for name, pairs in VARIANTS.items():
        conv_kernel.conv3x3_act_plain = conv_with(pairs)
        t0 = time.time()
        try:
            got = eval_window(params, bn_state, mopt, x, cpu)
        finally:
            conv_kernel.conv3x3_act_plain = plain
        seconds[name] = time.time() - t0
        readings[name] = rel_l2(got, base)
    print(json.dumps({"eval_bar_probe": {"artifact": artifact, "window": args.window,
                                         "shape": list(x.shape), "rel_l2_vs_plain": readings,
                                         "cpu_seconds": seconds}}))
    return readings


if __name__ == "__main__":
    main()
