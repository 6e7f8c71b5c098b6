"""Export a deployable artifact from the latest training checkpoint
(counterpart of the repository's tools/export_latest.py).

For campaigns cut short by the clock: the BatchNorm statistics are
recalibrated (forward only) on the checkpoint's weights and the artifact is
written without the training loop reaching its last epoch.

    python -m ai_path_tracer_denoiser_tpu_torch.tools.export_latest \\
        --model-dir runs/r3/models_r4 --data runs/r3/data/train \\
        --artifact denoiser_multiscene_r4.npz

The JAX tool's flags and meta, plus ``--artifacts-dir`` (default: the
repository's ``artifacts/``, where the JAX tool always writes) and
``--device`` (default ``cuda``).
"""
from __future__ import annotations

import argparse
import os

import torch

from ..utils.device import resolve_device
from .train_pipeline import REPO


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model-dir", required=True)
    ap.add_argument("--data", required=True)
    ap.add_argument("--artifact", default="denoiser_multiscene_r4.npz")
    ap.add_argument("--artifacts-dir", default=os.path.join(REPO, "artifacts"))
    ap.add_argument("--bn-recal", type=int, default=120)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--crop", type=int, default=256)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..config import ModelOptions, TrainOptions
    from ..data import SequenceDataset, sequence_batches
    from ..models.export import save_model
    from ..train import (checkpoint_epoch, init_train_state, latest_checkpoint,
                         load_checkpoint, recalibrate_bn)

    topt = TrainOptions(batch_size=args.batch, crop_size=args.crop,
                        remat_frames=args.batch >= 4)
    mopt = ModelOptions()
    state = init_train_state(torch.Generator().manual_seed(0), mopt, topt,
                             device=resolve_device(args.device))
    ckpt = latest_checkpoint(args.model_dir)
    if not ckpt:
        raise FileNotFoundError(f"no checkpoint in {args.model_dir}")
    state = load_checkpoint(ckpt, state)
    epoch = checkpoint_epoch(ckpt)
    print(f"loaded {ckpt} (resume epoch {epoch}, step {int(state.step)})")

    dataset = SequenceDataset(os.path.join(args.data, "input"),
                              os.path.join(args.data, "gt"),
                              crop=True, crop_size=args.crop)
    if args.bn_recal:
        print(f"recalibrating BN over {args.bn_recal} batches ...")
        state = recalibrate_bn(state, sequence_batches(dataset, batch_size=args.batch,
                                                       seed=10_007),
                               args.bn_recal, topt, mopt)
    os.makedirs(args.artifacts_dir, exist_ok=True)
    path = os.path.join(args.artifacts_dir, args.artifact)
    save_model(path, state.params, state.bn_state,
               meta={"trained_on": os.path.basename(args.data),
                     "epochs": (epoch - 1) if epoch else int(state.step),
                     "bn_recalibrated_batches": args.bn_recal},
               options=mopt)
    print(f"exported {path}")
    return path


if __name__ == "__main__":
    main()
