"""The training campaign, datagen -> train -> eval -> report, as one driver
(counterpart of the repository's tools/train_pipeline.py).

    python -m ai_path_tracer_denoiser_tpu_torch.tools.train_pipeline \\
        --out runs/campaign --batch 8 --epochs 60 --render-backend pallas_operand --resume

  1. datagen: randomized variants of scenes/template_random.txt (train seed
     42, eval seed 777) rendered at ``--res``: 1-spp G-buffers and high-spp
     truths, the eval pool unseen in training (one pan, one noise seed,
     ``max(14, frames // 3)`` frames, ``--gt-spp-eval`` truths).
     ``--render-backend pallas_operand`` (and ``pallas``) renders through the
     megakernel K1 (render/cuda_backend.py; both geometry modes run the same
     kernel), ``xla`` through the plain wavefront, ``auto`` as ``render``.
  2. train: 7-frame BPTT windows, Adam + StepLR, aligned crops, with
     ``remat_frames`` from batch 4 on; every conv's forward pass and input
     gradient (and under remat the recomputed forward) through the conv
     kernel K2.  Then the BatchNorm statistics are recalibrated over
     ``--bn-recal`` batches on the final weights and the model is exported.
  3. eval: one leading window per eval scene through the exported model
     (bfloat16, K2), nine metrics per scene into ``<out>/eval.json``.
  4. report: ``MODEL_CARD.md`` and, where matplotlib imports, the loss curve.

Every flag, default and stage rule is the JAX driver's, with two additions.
``--artifacts-dir`` (default: the repository's ``artifacts/``) is where the
model, the card, the curve and the GIF go; the JAX driver always writes the
repository's ``artifacts/``, so a real campaign here replaces the shipped
artifact as it does there, and a smoke run must pass another directory.
``--device`` (default ``cuda``; ``cpu`` runs the plain versions).  Where PIL
does not import, the eval strips are written as PNGs under ``<out>`` in
place of the GIF; where matplotlib does not import, the curve is not drawn.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..app.cli import _rescale
from ..utils.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _scenes(template_path: str, count: int, seed: int, device=None):
    """``count`` randomized variants of the template drawn from ``seed``."""
    from ..scene import parse_scene_text
    from ..scene.randomizer import generate_variants
    with open(template_path) as f:
        template = f.read()
    base_dir = os.path.dirname(os.path.abspath(template_path))
    return [parse_scene_text(text, base_dir=base_dir, device=device)
            for text in generate_variants(template, count, seed)]


def _log_dir(args) -> str:
    return os.path.join(args.out, args.models_subdir.replace("models", "logs")
                        if args.models_subdir != "models" else "logs")


def stage_datagen(args):
    from ..config import RenderOptions
    from ..data.datagen import generate_training_data
    if args.render_backend == "pallas_operand":
        opts = RenderOptions(backend="pallas", pallas_geometry="operand")
    else:
        opts = RenderOptions(backend=args.render_backend)
    device = resolve_device(args.device)
    template = os.path.join(REPO, "scenes", "template_random.txt")
    # the eval pool: unseen scenes, one pan, converged truth
    for split, count, seed, frames, movs, seeds, gt_spp in (
            ("train", args.train_scenes, 42, args.frames, args.movs,
             args.noise_seeds, args.gt_spp),
            ("eval", args.eval_scenes, 777, max(14, args.frames // 3), 1,
             1, args.gt_spp_eval)):
        out_dir = os.path.join(args.out, "data", split)
        if os.path.exists(os.path.join(out_dir, "input")):
            n = len(os.listdir(os.path.join(out_dir, "input")))
            if n >= count * frames * seeds * movs:
                print(f"[datagen] {split}: {n} frames already present, skip")
                continue
        scenes = [_rescale(s, args.res) for s in _scenes(template, count, seed, device)]
        t0 = time.time()
        generate_training_data(scenes, out_dir, frames_per_scene=frames,
                               gt_spp=gt_spp, movs=movs, noise_seeds=seeds,
                               options=opts, quantize=args.quantize or None,
                               progress=True)
        print(f"[datagen] {split}: {count} scenes x {movs} pans x {seeds} "
              f"seeds x {frames} frames in {time.time() - t0:.0f}s")


def stage_train(args):
    """Train (resuming as the JAX driver does), recalibrate BatchNorm, export;
    returns the exported state."""
    from ..config import ModelOptions, TrainOptions
    from ..data import SequenceDataset, sequence_batches
    from ..models.export import save_model
    from ..train import (MetricsLogger, checkpoint_epoch, fit, fit_device_data,
                         init_train_state, latest_checkpoint, load_checkpoint,
                         recalibrate_bn, save_checkpoint)
    device = resolve_device(args.device)
    topt = TrainOptions(epochs=args.epochs, batch_size=args.batch, crop_size=args.crop,
                        remat_frames=args.batch >= 4)
    mopt = ModelOptions.tpu_friendly() if args.tpu_friendly else ModelOptions()
    state = init_train_state(torch.Generator().manual_seed(0), mopt, topt, device=device)
    model_dir = os.path.join(args.out, args.models_subdir)
    resume_epoch = None
    if args.resume:
        ckpt = latest_checkpoint(model_dir)
        if ckpt:
            state = load_checkpoint(ckpt, state)
            resume_epoch = checkpoint_epoch(ckpt)
            print(f"[train] resumed {ckpt} at step {int(state.step)}, "
                  f"epoch {resume_epoch}")
    data = os.path.join(args.data_from or args.out, "data", "train")
    dataset = SequenceDataset(os.path.join(data, "input"), os.path.join(data, "gt"),
                              crop=True, crop_size=args.crop)
    steps_per_epoch = max(1, len(dataset) // args.batch)
    if resume_epoch is not None and resume_epoch >= 10 ** 9:
        # 'final': the checkpointed schedule completed; the epoch comes from
        # the step count, so a larger --epochs extends the run
        resume_epoch = int(state.step) // steps_per_epoch
        print(f"[train] 'final' checkpoint: resuming extension at epoch "
              f"{resume_epoch}")
    start_epoch = resume_epoch
    if start_epoch is None:
        start_epoch = int(state.step) // steps_per_epoch
        if int(state.step):
            print(f"[train] warning: checkpoint lacks an epoch record; "
                  f"inferred start epoch {start_epoch} from step count")
    print(f"[train] {len(dataset)} windows, batch {args.batch}, "
          f"epochs {start_epoch}..{args.epochs}, widths {mopt.widths}")
    logger = MetricsLogger(_log_dir(args))
    common = dict(epochs=args.epochs, logger=logger,
                  checkpoint_fn=lambda s, e: save_checkpoint(model_dir, s, e),
                  model_options=mopt, start_epoch=start_epoch)
    try:
        if args.stream_gb:
            from ..train.stream_data import fit_streamed
            state = fit_streamed(state, dataset, topt, shard_gb=args.stream_gb, **common)
        elif args.device_data:
            state = fit_device_data(state, dataset, topt, **common)
        else:
            state = fit(state, lambda epoch: sequence_batches(
                dataset, batch_size=args.batch, seed=epoch), topt, **common)
    finally:
        logger.close()
    if args.bn_recal > 0:
        # forward-only train-mode passes on the final weights: the running
        # statistics catch up with the batch statistics the network saw
        print(f"[train] recalibrating BN stats over {args.bn_recal} batches")
        state = recalibrate_bn(state, sequence_batches(dataset, batch_size=args.batch,
                                                       seed=10_007),
                               args.bn_recal, topt, mopt)
    os.makedirs(args.artifacts_dir, exist_ok=True)
    path = os.path.join(args.artifacts_dir, args.artifact)
    save_model(path, state.params, state.bn_state,
               meta={"trained_on": f"{args.train_scenes} randomized scenes "
                                   f"@{args.res}^2, gt {args.gt_spp}spp",
                     "epochs": args.epochs,
                     "bn_recalibrated_batches": args.bn_recal},
               options=mopt)
    print(f"[train] exported {path}")
    return state


def _hfen(pred: np.ndarray, gt: np.ndarray) -> float:
    """Channel-summed LoG HFEN (train/loss.py ``hfen``) of (T, H, W, 3) NHWC."""
    from ..train.loss import hfen
    return float(hfen(torch.from_numpy(np.ascontiguousarray(pred)),
                      torch.from_numpy(np.ascontiguousarray(gt))))


def eval_window(params, bn_state, mopt, x: np.ndarray, device) -> np.ndarray:
    """One (T, H, W, 10) window through the network in eval mode, bfloat16
    (K2 on the card), clipped to [0, 1] -> (T, H, W, 3) float32."""
    from ..models import apply_sequence
    with torch.no_grad():
        y, _, _ = apply_sequence(params, bn_state, torch.from_numpy(x).to(device)[:, None],
                                 train=False, bf16=True, options=mopt)
    return np.clip(y[:, 0].float().cpu().numpy(), 0, 1)


def stage_eval(args):
    """Per held-out scene, its leading window: the nine metrics into
    ``<out>/eval.json``; returns them."""
    from ..data import SequenceDataset
    from ..models import load_model, model_options_from_meta
    from ..utils import psnr, ssim
    device = resolve_device(args.device)
    params, bn_state, meta = load_model(os.path.join(args.artifacts_dir, args.artifact),
                                        device=device)
    mopt = model_options_from_meta(meta)
    data = os.path.join(args.out, "data", "eval")
    dataset = SequenceDataset(os.path.join(data, "input"), os.path.join(data, "gt"),
                              crop=False)
    per_scene, strips, seen = {}, [], set()
    for idx in range(len(dataset)):
        name = dataset.inputs[idx]
        scene_id = name.split("_")[0]
        frame = int(name.split("_")[3].split(".")[0])
        if frame != 0 or scene_id in seen:
            continue            # one leading window per scene
        seen.add(scene_id)
        x, y = dataset[idx]
        pred = eval_window(params, bn_state, mopt, x, device)
        noisy = x[..., 0:3]
        rec = {
            "mse_denoised": float(np.mean((pred - y) ** 2)),
            "mse_noisy": float(np.mean((noisy - y) ** 2)),
            "l1_denoised": float(np.mean(np.abs(pred - y))),
            "hfen_denoised": _hfen(pred, y),
            "temporal_mse": float(np.mean(
                (np.diff(pred, axis=0) - np.diff(y, axis=0)) ** 2)),
            "psnr_denoised": psnr(pred, y),
            "psnr_noisy": psnr(np.clip(noisy, 0, 1), y),
            "ssim_denoised": ssim(pred, y),
            "ssim_noisy": ssim(np.clip(noisy, 0, 1), y),
        }
        per_scene[scene_id] = rec
        strip = np.concatenate([noisy, pred, y], axis=2)   # (T, H, 3W, 3)
        strips.append((strip * 255).astype(np.uint8))
        print(f"[eval] scene {scene_id}: mse {rec['mse_denoised']:.5f} "
              f"(noisy {rec['mse_noisy']:.5f}, "
              f"{rec['mse_noisy'] / max(rec['mse_denoised'], 1e-12):.1f}x)")
    with open(os.path.join(args.out, "eval.json"), "w") as f:
        json.dump(per_scene, f, indent=2)
    _write_strips(args, [fr for s in strips for fr in s])
    return per_scene


def _write_strips(args, frames) -> None:
    """The [noisy | prediction | truth] frames as the GIF, or as PNGs under
    ``<out>`` where PIL does not import."""
    try:
        from PIL import Image
    except ImportError:
        from ..utils.imageio import save_png
        out_dir = os.path.join(args.out, args.prefix + "eval_unseen")
        os.makedirs(out_dir, exist_ok=True)
        for k, fr in enumerate(frames):
            save_png(os.path.join(out_dir, f"strip_{k:04d}"), fr)
        print(f"[eval] PIL unavailable; wrote {len(frames)} PNG strips to {out_dir}")
        return
    os.makedirs(args.artifacts_dir, exist_ok=True)
    images = [Image.fromarray(fr) for fr in frames]
    path = os.path.join(args.artifacts_dir, args.prefix + "eval_unseen.gif")
    images[0].save(path, save_all=True, append_images=images[1:], duration=160, loop=0)
    print(f"[eval] wrote {path}")


def _loss_curve(args) -> None:
    try:
        import matplotlib
    except ImportError:
        print("[report] matplotlib unavailable; loss curve not drawn")
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    steps, series = [], {"total": [], "L1": [], "HFEN": [], "temporal": []}
    with open(os.path.join(_log_dir(args), "metrics.jsonl")) as f:
        for line in f:
            r = json.loads(line)
            steps.append(r["step"])
            for label, key in (("total", "total"), ("L1", "l1"), ("HFEN", "hfen"),
                               ("temporal", "temporal")):
                series[label].append(r[key])
    fig, ax = plt.subplots(figsize=(8, 4.5))
    for label, vals in series.items():
        k = max(1, len(vals) // 400)
        sm = np.convolve(vals, np.ones(k) / k, mode="valid")
        ax.plot(steps[:len(sm)], sm, label=label, linewidth=1.2)
    ax.set_yscale("log")
    ax.set_xlabel("step")
    ax.set_ylabel("loss")
    ax.legend()
    ax.set_title("denoiser training (multi-scene)")
    fig.tight_layout()
    curve = os.path.join(args.artifacts_dir, args.prefix + "loss_curve.png")
    fig.savefig(curve, dpi=120)
    plt.close(fig)
    print(f"[report] wrote {curve}")


def stage_report(args, per_scene):
    """The loss curve (where matplotlib imports) and ``MODEL_CARD.md``: the
    JAX driver's text, table and means."""
    os.makedirs(args.artifacts_dir, exist_ok=True)
    _loss_curve(args)
    mses = [r["mse_denoised"] for r in per_scene.values()]
    noisy = [r["mse_noisy"] for r in per_scene.values()]
    card = os.path.join(args.artifacts_dir, args.prefix + "MODEL_CARD.md")
    with open(card, "w") as f:
        f.write(f"""# {args.artifact}

Recurrent denoising autoencoder trained end-to-end inside this framework
(no external data): `tools/train_pipeline.py`.

- **Data**: {args.train_scenes} randomized Cornell variants
  (scene/randomizer.py, reference create_scene.py distributions) at
  {args.res}^2, {args.frames} frames/scene x {args.movs} camera pans
  (the reference's "mov" axis, train.sh:13-30) x {args.noise_seeds}
  noise seeds, ground truth {args.gt_spp} spp, stored
  {"uint8 (the reference's 8-bit PNG regime)" if args.quantize else "float32"}.
  Held-out eval pool: {args.eval_scenes} unseen scenes (different
  randomizer seed), GT {args.gt_spp_eval} spp (>= the ~2000 spp quality
  knee, README.md:89).
- **Training**: {args.epochs} epochs, batch {args.batch} x 7-frame BPTT,
  256^2 aligned crops, Adam 1e-3 + StepLR(25, 0.2), bf16 conv compute.
- **Loss curves**: `artifacts/{args.prefix}loss_curve.png`; raw JSONL in the run dir.

## Held-out scene results (never seen in training)

| scene | MSE denoised | MSE noisy 1spp | improvement | PSNR (vs noisy) | SSIM (vs noisy) | L1 | HFEN | temporal MSE |
|---|---|---|---|---|---|---|---|---|
""")
        for sid, r in sorted(per_scene.items()):
            qual = (f"| {r['psnr_denoised']:.2f} dB ({r['psnr_noisy']:.2f}) "
                    f"| {r['ssim_denoised']:.4f} ({r['ssim_noisy']:.4f}) "
                    if "psnr_denoised" in r else "| | ")
            f.write(f"| {sid} | {r['mse_denoised']:.5f} | {r['mse_noisy']:.5f} "
                    f"| {r['mse_noisy'] / max(r['mse_denoised'], 1e-12):.1f}x "
                    f"{qual}"
                    f"| {r['l1_denoised']:.5f} | {r['hfen_denoised']:.4f} "
                    f"| {r['temporal_mse']:.6f} |\n")
        f.write(f"""| **mean** | **{np.mean(mses):.5f}** | **{np.mean(noisy):.5f}** """
                f"""| **{np.mean(noisy) / max(np.mean(mses), 1e-12):.1f}x** | | | | | |

Strips of [noisy input | prediction | ground truth] for every eval scene:
`artifacts/{args.prefix}eval_unseen.gif`.
""")
    print(f"[report] wrote {card}")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="runs/r2")
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--train-scenes", type=int, default=28)
    ap.add_argument("--eval-scenes", type=int, default=4)
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--noise-seeds", type=int, default=3)
    ap.add_argument("--movs", type=int, default=2,
                    help="camera pans per scene (the reference's 'mov' "
                         "axis, train.sh:13-30)")
    ap.add_argument("--gt-spp", type=int, default=800)
    ap.add_argument("--gt-spp-eval", type=int, default=2000,
                    help="converged GT spp for the held-out eval pool "
                         "(quality knee ~2000, README.md:89)")
    ap.add_argument("--quantize", default="u8", choices=("u8", ""),
                    help="npy storage regime: u8 = the reference's 8-bit "
                         "PNG data regime at 1/4 footprint; '' = float32")
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--crop", type=int, default=256)
    ap.add_argument("--tpu-friendly", action="store_true")
    ap.add_argument("--prefix", default="",
                    help="filename prefix for the artifacts (a second "
                         "widths variant keeps its own card/curves/gif)")
    ap.add_argument("--models-subdir", default="models",
                    help="checkpoint dir under --out (lets a second widths "
                         "variant train off the same datagen)")
    ap.add_argument("--artifact", default="denoiser_multiscene.npz")
    ap.add_argument("--artifacts-dir", default=os.path.join(REPO, "artifacts"),
                    help="where the model, card, curve and GIF are written "
                         "(default: the repository's artifacts/)")
    ap.add_argument("--render-backend", default="xla",
                    help="xla | pallas | pallas_operand | auto")
    ap.add_argument("--data-from", default=None,
                    help="train on another run's data/ directory (e.g. "
                         "A/B runs sharing one corpus)")
    ap.add_argument("--stream-gb", type=float, default=0.0,
                    help="host-streamed sharded corpus with this shard "
                         "budget in GiB (0 = off); overrides --device-data")
    ap.add_argument("--device-data", action="store_true",
                    help="upload the whole corpus to the card once and crop "
                         "there (no per-step host-to-device traffic)")
    ap.add_argument("--bn-recal", type=int, default=120,
                    help="forward-only batches to re-estimate BN running "
                         "stats before export (0 = off)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--stages", default="datagen,train,eval,report")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    stages = args.stages.split(",")
    if "datagen" in stages:
        stage_datagen(args)
    if "train" in stages:
        stage_train(args)
    per_scene = None
    if "eval" in stages:
        per_scene = stage_eval(args)
    if "report" in stages:
        if per_scene is None:
            with open(os.path.join(args.out, "eval.json")) as f:
                per_scene = json.load(f)
        stage_report(args, per_scene)


if __name__ == "__main__":
    main()
