"""``fit_streamed`` with shards of a realistic size: the host read, the
shard copy and the steps on the card.

Writes a float32 corpus of 800x800 frames in the datagen layout (values
drawn from ``--seed``) into ``--work-dir``, in groups of ``--group-frames``
frames, enough for ``--shards`` shards of ``--shard-gb`` GiB of bfloat16
buffer each; trains one epoch of ``fit_streamed`` on it (the reference
widths, bfloat16, batch 4, 128x128 crops, 7-frame windows, the shard
capacity from ``shard_gb``) after one warm-up step; prints one JSON line per
shard visit (host read s, copy ms, exposed ms, gap ms, step ms), then a
summary with the card's name and power limit; removes the corpus.

Run on an NVIDIA GPU:
    python -m ai_path_tracer_denoiser_tpu_torch.tools.stream_timing
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import time

import numpy as np
import torch

from ..config import ModelOptions, TrainOptions
from ..data import SequenceDataset
from ..models import conv_kernel
from ..models.export import sorted_leaves
from ..train import init_train_state, stream_data, train_step
from ..utils.cuda_build import build_all

RES = 800
BATCH, CROP, SEQ = 4, 128, 7


def write_corpus(root: str, groups: int, group_frames: int, seed: int) -> float:
    """``groups`` (scene, 0, 0) groups of float32 input / gt frames; returns
    the seconds it took."""
    t0 = time.time()
    rng = np.random.default_rng(seed)
    for sub in ("input", "gt"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for g in range(groups):
        for f in range(group_frames):
            name = f"{g:03d}_0_0_{f:04d}.npy"
            np.save(os.path.join(root, "input", name),
                    rng.random((RES, RES, 10), dtype=np.float32))
            np.save(os.path.join(root, "gt", name),
                    rng.random((RES, RES, 3), dtype=np.float32))
    return time.time() - t0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shard-gb", type=float, default=1.0)
    ap.add_argument("--shards", type=int, default=3)
    ap.add_argument("--group-frames", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--work-dir", default=os.path.join("runs", "stream_timing"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("stream_timing needs an NVIDIA GPU")
    dev = torch.device("cuda")
    frame_buffer_bytes = RES * RES * 13 * 2                       # bfloat16
    per_shard = int(args.shard_gb * 2 ** 30 / frame_buffer_bytes)
    groups = args.shards * (per_shard // args.group_frames)
    if groups < args.shards:
        raise SystemExit(f"a group of {args.group_frames} frames exceeds a shard "
                         f"of {per_shard}")
    disk = groups * args.group_frames * RES * RES * 13 * 4
    os.makedirs(args.work_dir, exist_ok=True)
    free = shutil.disk_usage(args.work_dir).free
    if free < 1.2 * disk:
        raise SystemExit(f"{disk / 1e9:.1f} GB corpus, {free / 1e9:.1f} GB free")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
    try:
        write_s = write_corpus(args.work_dir, groups, args.group_frames, args.seed)
        dataset = SequenceDataset(os.path.join(args.work_dir, "input"),
                                  os.path.join(args.work_dir, "gt"), crop=True,
                                  crop_size=CROP)
        mopt = ModelOptions()
        topt = TrainOptions(epochs=1, crop_size=CROP, batch_size=BATCH)
        build_all((conv_kernel.KERNEL,))
        # one warm-up step at the timed shapes (first calls, allocator)
        gen = torch.Generator().manual_seed(args.seed)
        x = torch.rand((SEQ, BATCH, CROP, CROP, 10), generator=gen).to(dev, torch.bfloat16)
        y = torch.rand((SEQ, BATCH, CROP, CROP, 3), generator=gen).to(dev, torch.bfloat16)
        train_step(init_train_state(gen, mopt, topt, device=dev), x, y, topt, mopt)
        del x, y
        torch.cuda.synchronize()
        state = init_train_state(torch.Generator().manual_seed(args.seed), mopt, topt,
                                 device=dev)
        timings = []
        t0 = time.time()
        state = stream_data.fit_streamed(state, dataset, topt, shard_gb=args.shard_gb,
                                         model_options=mopt, timings=timings,
                                         log_every=1000)
        torch.cuda.synchronize()
        fit_s = time.time() - t0
    finally:
        shutil.rmtree(args.work_dir, ignore_errors=True)
    finite = all(bool(torch.isfinite(leaf).all()) for _, leaf in sorted_leaves(state.params))
    for t in timings:
        t = dict(t, step_ms=t["steps_ms"] / t["steps"],
                 copy_gb_per_s=t["frames"] * frame_buffer_bytes / t["upload_ms"] / 1e6)
        print(json.dumps({"phase": "stream_timing_shard", **t}))
    later = timings[1:]
    print(json.dumps({
        "phase": "stream_timing", "card": smi, "shard_gib": args.shard_gb,
        "frames_per_shard": [t["frames"] for t in timings], "shards": len(timings),
        "corpus_gb_on_disk": disk / 1e9, "write_s": write_s, "fit_s": fit_s,
        "steps": sum(t["steps"] for t in timings), "params_finite": finite,
        "first_read_s": timings[0]["read_s"],
        "hidden_share_after_first": statistics.mean(
            max(0.0, 1.0 - t["exposed_ms"] / t["upload_ms"]) for t in later),
        "gap_ms_after_first": [t["gap_ms"] for t in later],
        "step_ms_per_shard": [t["steps_ms"] / t["steps"] for t in timings],
        "columns": "read_s: host read of the shard into page-locked memory (the "
                   "first shard's before any step, the others during the previous "
                   "shard's steps); upload_ms: its copy on the side stream; exposed_ms: "
                   "the compute stream waiting for that copy; gap_ms: the compute "
                   "stream from the previous shard's last step to this shard's first; "
                   "all CUDA events but read_s"}))
    if not finite:
        raise SystemExit("parameters not finite")


if __name__ == "__main__":
    main()
