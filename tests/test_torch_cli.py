"""The port's main path end to end on the CPU, frame by frame against the
JAX package's interactive pipeline.

``python -m ai_path_tracer_denoiser_tpu_torch.app interactive`` renders and
denoises 3 orbit frames of the Cornell box at 64x64 with the shipped model;
each frame's G-buffer and denoised image are held against JAX
``render_gbuffer_frame`` (backend "xla") and ``apply_frame_fast_padded``
(native convs) with the hidden state carried, at the tolerances of
tests/test_torch_render.py and tests/test_torch_models.py.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ai_path_tracer_denoiser_tpu.config import RenderOptions
from ai_path_tracer_denoiser_tpu.models import init_hidden, load_model, prepare_inference
from ai_path_tracer_denoiser_tpu.models.inference import apply_frame_fast_padded
from ai_path_tracer_denoiser_tpu.render import render_gbuffer_frame
from ai_path_tracer_denoiser_tpu.scene import load_scene
from ai_path_tracer_denoiser_tpu.scene.camera import (derive_camera, orbit_camera,
                                                      orbit_params_from_camera)
from ai_path_tracer_denoiser_tpu_torch.utils.imageio import read_png

REPO = pathlib.Path(__file__).resolve().parent.parent
RES, FRAMES, DPHI = 64, 3, 0.05
MODEL = REPO / "artifacts" / "denoiser_multiscene.npz"


def _jax_frames():
    scene = load_scene(str(REPO / "scenes" / "cornell_box.txt"))
    scene = dataclasses.replace(scene, camera=derive_camera(
        (RES, RES), float(scene.camera.fov[1]), np.asarray(scene.camera.position),
        np.asarray(scene.camera.look_at), np.asarray(scene.camera.up)))
    params, bn_state, _ = load_model(str(MODEL))
    folded = prepare_inference(params, bn_state)
    hidden = init_hidden(1, RES, RES, dtype=jnp.bfloat16)
    # jitted as the JAX CLI runs it (app/cli.py:cmd_interactive)
    denoise = jax.jit(lambda g, hd: apply_frame_fast_padded(
        folded, jnp.moveaxis(g, 0, -1)[None], hd, conv_impl="native"))
    phi, theta, zoom = orbit_params_from_camera(scene.camera)
    for frame in range(FRAMES):
        if frame:
            phi += DPHI
        fscene = dataclasses.replace(scene, camera=orbit_camera(
            scene.camera, phi, theta, zoom))
        _, gbuf, _ = render_gbuffer_frame(fscene, RenderOptions(backend="xla"))
        y, hidden = denoise(gbuf, hidden)
        yield np.asarray(gbuf), np.asarray(y[0])


def test_interactive_cli_matches_jax(tmp_path):
    out = tmp_path / "frames"
    cmd = [sys.executable, "-m", "ai_path_tracer_denoiser_tpu_torch.app",
           "interactive", "scenes/cornell_box.txt", "--device", "cpu",
           "--res", str(RES), "--frames", str(FRAMES), "--dphi", str(DPHI),
           "--model", str(MODEL), "--out-dir", str(out), "--save-arrays"]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    for frame, (jg, jy) in enumerate(_jax_frames()):
        base = out / f"frame_{frame:04d}"
        png = read_png(str(base) + ".png")
        assert png.shape == (RES, RES, 3)
        tg = np.load(str(base) + "_gbuffer.npy")
        ty = np.load(str(base) + "_denoised.npy")
        assert tg.shape == (10, RES, RES) and ty.shape == (RES, RES, 3)
        ok = np.isclose(tg[3:], jg[3:], rtol=1e-5, atol=1e-5).all(axis=0)
        assert ok.mean() >= 0.998, (frame, ok.mean())
        rel = abs(tg[:3].mean() - jg[:3].mean()) / jg[:3].mean()
        assert rel < 1e-3, (frame, rel)
        assert np.isfinite(ty).all()
        l2 = np.linalg.norm(ty - jy) / np.linalg.norm(jy)
        assert l2 < 2e-2, (frame, l2)
        np.testing.assert_array_equal(
            png, (np.clip(ty, 0, 1) * 255.0).astype(np.uint8))


@pytest.mark.parametrize("flag", [pytest.param("--serve", id="--serve=8000"),
                                  "--parity-denoise"])
def test_unported_options_raise(flag, tmp_path):
    """Both options are ported: ``--serve`` streams the frame it emits to a
    viewer on a free loopback port (PNG or JPEG, rounded to 8 bits with
    + 0.5); ``--parity-denoise`` runs the train graph in eval mode (held
    against the folded path below)."""
    from ai_path_tracer_denoiser_tpu_torch.app.cli import main
    from ai_path_tracer_denoiser_tpu_torch.utils import preview
    from test_torch_preview import free_port, serve_interactive
    argv = ["interactive", "scenes/cornell_box.txt", "--device", "cpu", "--res", "32",
            "--frames", "1", "--out-dir", str(tmp_path), flag]
    if flag == "--parity-denoise":
        assert main(argv)[0]["finite"]
        return
    records, part, pushed = serve_interactive(argv + [str(free_port()), "--save-arrays"])
    assert len(records) == 1 and records[0]["finite"] and len(pushed) == 1
    frame = np.clip(np.load(records[0]["path"][:-len(".png")] + "_denoised.npy"), 0, 1)
    np.testing.assert_array_equal(pushed[0], frame)
    assert part == preview._encode((frame * 255.0 + 0.5).astype(np.uint8))


@pytest.mark.parametrize("argv", [
    ["datagen", "scenes/cornell_box.txt", "--out-dir", "unused", "--variants", "2"],
    ["train", "--data-dir", "unused", "--data-parallel"]])
def test_unported_commands_raise(argv, tmp_path):
    """The two command lines that were refused once: ``train
    --data-parallel`` runs as a world of one (gloo, in this process) for one
    epoch over a 64x64 corpus of 7 frames on 32x32 crops, one sequence per
    step, its final checkpoint reloads to the state it returned, and it is
    ``train`` bit for bit (each collective sums one term and divides by 1);
    ``datagen --variants 2`` renders the scene and two randomized variants
    (32x32, 2 frames, 2-spp truth, one pan)."""
    from ai_path_tracer_denoiser_tpu_torch.app.cli import main
    if argv[0] == "train":
        from ai_path_tracer_denoiser_tpu_torch.models.export import sorted_leaves
        from ai_path_tracer_denoiser_tpu_torch.parallel.mesh import destroy
        from ai_path_tracer_denoiser_tpu_torch.train import load_checkpoint
        data, models = tmp_path / "data", tmp_path / "models"
        rng = np.random.default_rng(0)
        for sub, c in (("input", 10), ("gt", 3)):
            os.makedirs(data / sub)
            for f in range(7):
                np.save(data / sub / f"000_0_0_{f:04d}.npy",
                        rng.random((64, 64, c), dtype=np.float32))
        argv = [str(data) if a == "unused" else a for a in argv]
        try:
            state = main(argv + ["--device", "cpu", "--model-dir", str(models), "--log-dir",
                                 str(tmp_path / "logs"), "--epochs", "1", "--crop-size", "32"])
        finally:
            destroy()
        assert state.step == 7
        assert sorted(os.listdir(models)) == ["model_0.npz", "model_final.npz"]
        final = load_checkpoint(str(models / "model_final.npz"), device="cpu")
        assert final.step == 7
        for (_, a), (_, b) in zip(sorted_leaves(final.params), sorted_leaves(state.params)):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        single = main(argv[:-1] + ["--device", "cpu", "--model-dir", str(tmp_path / "single"),
                                   "--log-dir", str(tmp_path / "single_logs"), "--epochs", "1",
                                   "--crop-size", "32"])
        for tree in ("params", "bn_state"):
            for (_, a), (_, b) in zip(sorted_leaves(getattr(single, tree)),
                                      sorted_leaves(getattr(state, tree))):
                np.testing.assert_array_equal(a.numpy(), b.numpy())
        return
    out = str(tmp_path / "unused")
    argv = [out if a == "unused" else a for a in argv]
    in_dir, gt_dir = main(argv + ["--device", "cpu", "--res", "32", "--frames", "2",
                                  "--gt-spp", "2", "--movs", "1"])
    names = sorted(os.listdir(in_dir))
    assert names == sorted(os.listdir(gt_dir)) == [
        f"{s:03d}_0_0_{f:04d}.npy" for s in range(3) for f in range(2)]
    first = [np.load(os.path.join(in_dir, f"{s:03d}_0_0_0000.npy")) for s in range(3)]
    assert all(x.shape == (32, 32, 10) and np.isfinite(x).all() for x in first)
    assert not np.array_equal(first[0], first[1]) and not np.array_equal(first[1], first[2])


def test_train_data_parallel_refuses_device_data():
    """``--device-data`` keeps the corpus on one device: it is refused with
    ``--data-parallel`` before any process group starts."""
    import torch.distributed as dist

    from ai_path_tracer_denoiser_tpu_torch.app.cli import main
    with pytest.raises(ValueError, match="--device-data"):
        main(["train", "--data-dir", "unused", "--data-parallel", "--device-data",
              "--device", "cpu"])
    assert not dist.is_initialized()


def test_parity_denoise_equals_the_folded_path(tmp_path):
    """``interactive --parity-denoise`` (the train graph in eval mode,
    bfloat16 convs, float32 norms) against the BN-folded bfloat16 deployment
    path, with both conv impls, on the same 2 frames: relative L2 < 3e-2
    (the two graphs round to bfloat16 at different places)."""
    from ai_path_tracer_denoiser_tpu_torch.app.cli import main
    outs = {}
    for name, extra in (("folded", []), ("rows", ["--conv-impl", "pallas"]),
                        ("parity", ["--parity-denoise"])):
        recs = main(["interactive", "scenes/cornell_box.txt", "--device", "cpu",
                     "--res", "48", "--frames", "2", "--model", str(MODEL),
                     "--out-dir", str(tmp_path / name), "--save-arrays"] + extra)
        outs[name] = [np.load(r["path"][:-len(".png")] + "_denoised.npy") for r in recs]
        assert all(r["finite"] for r in recs)
        assert outs[name][0].shape == (48, 48, 3)        # padded to 64, cropped back
    for a, b, c in zip(outs["folded"], outs["parity"], outs["rows"]):
        assert np.linalg.norm(b - a) / np.linalg.norm(a) < 3e-2
        assert np.linalg.norm(c - a) / np.linalg.norm(a) < 2e-2


def test_train_export_eval_cli_on_cpu(tmp_path):
    """datagen -> train (host loader, then resumed with the corpus on the
    device) -> export -> eval -> interactive, through ``main`` on the CPU:
    32x32 crops of a 64x64 corpus, 7-frame windows, the reference widths."""
    from ai_path_tracer_denoiser_tpu.models import load_model as jax_load_model
    from ai_path_tracer_denoiser_tpu_torch.app.cli import main
    from ai_path_tracer_denoiser_tpu_torch.train import checkpoint_epoch, load_checkpoint
    data, models = str(tmp_path / "data"), str(tmp_path / "models")
    main(["datagen", "scenes/cornell_box.txt", "--platform", "cpu", "--res", "64",
          "--frames", "8", "--movs", "1", "--gt-spp", "2", "--out-dir", data])
    assert len(os.listdir(os.path.join(data, "input"))) == 8
    common = ["train", "--data-dir", data, "--model-dir", models, "--log-dir",
              str(tmp_path / "logs"), "--crop-size", "32", "--batch-size", "4",
              "--platform", "cpu", "--log-every", "1"]
    state = main(common + ["--epochs", "1"])
    assert state.step == 2 and state.params["enc1"]["conv1"]["w"].shape == (3, 3, 10, 32)
    assert sorted(os.listdir(models)) == ["model_0.npz", "model_final.npz"]
    assert checkpoint_epoch(os.path.join(models, "model_0.npz")) == 1
    with open(tmp_path / "logs" / "metrics.jsonl") as f:
        lines = [line for line in f]
    assert len(lines) == 2 and '"hfen"' in lines[0]
    # resume: 'final' extends from the step count; epoch 1 of 2 remains
    resumed = main(common + ["--epochs", "2", "--resume", "--device-data"])
    assert resumed.step == 4
    final = os.path.join(models, "model_final.npz")
    assert load_checkpoint(final, device="cpu").step == 4
    deploy = str(tmp_path / "deploy.npz")
    assert main(["export", final, "--out", deploy]) == deploy
    jp, _, meta = jax_load_model(deploy)
    assert meta == {"widths": [32, 43, 57, 76, 101], "norm": "batch"}
    np.testing.assert_array_equal(np.asarray(jp["dec1"]["conv2"]["w"]),
                                  resumed.params["dec1"]["conv2"]["w"].numpy())
    for model in (deploy, final):
        strips = main(["eval", "--data-dir", data, "--model", model, "--out-dir",
                       str(tmp_path / "eval"), "--max-sequences", "1", "--device", "cpu"])
        assert len(strips) == 7 and strips[0].shape == (64, 192, 3)
        assert strips[0].dtype == np.uint8
    assert any(n.endswith(".gif") or n.startswith("strip_")
               for n in os.listdir(tmp_path / "eval"))
    recs = main(["interactive", "scenes/cornell_box.txt", "--device", "cpu", "--res", "32",
                 "--frames", "1", "--model", deploy, "--out-dir", str(tmp_path / "frames")])
    assert recs[0]["finite"]


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of the port imports in an interpreter where ``jax``,
    ``optax`` and the JAX package cannot be imported at all."""
    code = """
import importlib, importlib.abc, pkgutil, sys
BLOCKED = ("jax", "jaxlib", "optax", "flax", "ai_path_tracer_denoiser_tpu")
for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked for this test: " + name)
sys.meta_path.insert(0, Block())
import ai_path_tracer_denoiser_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
assert len(names) > 30 and pkg.__name__ + ".train.trainer" in names, names
assert not any(n.split(".")[0] in BLOCKED for n in sys.modules)
print("imported", len(names))
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "imported" in proc.stdout


def test_interactive_cli_renders_bvh_mesh(tmp_path):
    """A mesh over 65 faces through the CLI on the CPU, with mesh flags."""
    from ai_path_tracer_denoiser_tpu_torch.app.cli import main
    records = main(["interactive", str(REPO / "scenes" / "cornell_mesh_icosphere.txt"),
                    "--device", "cpu", "--res", str(RES), "--frames", "2",
                    "--model", str(MODEL), "--out-dir", str(tmp_path),
                    "--save-arrays", "--mesh-sort-cells", "4",
                    "--mesh-kernel-impl", "v2p"])
    assert [r["frame"] for r in records] == [0, 1]
    for rec in records:
        assert rec["finite"]
        assert read_png(rec["path"]).shape == (RES, RES, 3)
        base = rec["path"][:-len(".png")]
        g = np.load(base + "_gbuffer.npy")
        assert g.shape == (10, RES, RES) and np.isfinite(g).all()
        assert (g[6] > 0).mean() > 0.5
        assert np.isfinite(np.load(base + "_denoised.npy")).all()


def test_cli_mesh_flags_reach_the_options():
    from ai_path_tracer_denoiser_tpu_torch.app.cli import (_render_options,
                                                           build_parser)
    args = build_parser().parse_args(
        ["render", "s.txt", "--no-mesh-octant-sort", "--mesh-sort-cells", "-8",
         "--mesh-kernel-lanes", "128", "--mesh-kernel-impl", "binned"])
    opts = _render_options(args)
    assert (opts.mesh_octant_sort, opts.mesh_sort_cells, opts.mesh_kernel_lanes,
            opts.mesh_kernel_impl, opts.mesh_bvh) == (False, -8, 128, "binned", True)
    defaults = _render_options(build_parser().parse_args(["render", "s.txt"]))
    assert (defaults.mesh_octant_sort, defaults.mesh_sort_cells,
            defaults.mesh_kernel_lanes, defaults.mesh_kernel_impl) == (
                True, 8, 1024, "auto")


def test_cli_defaults_to_cuda():
    from ai_path_tracer_denoiser_tpu_torch.app.cli import build_parser
    parser = build_parser()
    for argv in (["interactive", "scenes/cornell_box.txt"],
                 ["render", "scenes/cornell_box.txt"],
                 ["datagen", "scenes/cornell_box.txt", "--out-dir", "d"],
                 ["train", "--data-dir", "d"],
                 ["eval", "--data-dir", "d", "--model", "m.npz"]):
        assert parser.parse_args(argv).device == "cuda", argv
        assert parser.parse_args(argv + ["--platform", "cpu"]).device == "cpu"
    args = parser.parse_args(["train", "--data-dir", "d"])
    assert (args.epochs, args.lr, args.crop_size, args.batch_size) == (100, 1e-3, 256, 1)
    assert parser.parse_args(["interactive", "s.txt"]).conv_impl == "auto"


def test_bench_command_times_each_scene(tmp_path, capsys):
    """``bench`` (the JAX CLI's per-scene timing harness): a 2-iteration
    warm-up, then --iters iterations; one record per scene and a JSON line."""
    import json

    from ai_path_tracer_denoiser_tpu_torch.app.cli import main
    results = main(["bench", "scenes/cornell_box.txt", "scenes/cornell_mesh_icosphere.txt",
                    "--device", "cpu", "--res", "32", "--iters", "2",
                    "--mesh-kernel-impl", "v3", "--profile", str(tmp_path / "trace")])
    assert set(results) == {"cornell_box.txt", "cornell_mesh_icosphere.txt"}
    assert all(ms > 0 for ms in results.values())
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == results
    assert "2 iterations in" in lines[-2]
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0


@pytest.mark.parametrize("impl,extra", [("v2", ["--mesh-kernel-lanes", "128"]),
                                        ("v3", ["--no-mesh-octant-sort"]),
                                        ("v2p", ["--sort-material"])])
def test_interactive_traversal_flags_give_the_same_frames(tmp_path, impl, extra):
    from ai_path_tracer_denoiser_tpu_torch.app.cli import main

    def frames(name, flags):
        recs = main(["interactive", "scenes/cornell_mesh_icosphere.txt", "--device", "cpu",
                     "--res", "32", "--frames", "2", "--model", str(MODEL), "--save-arrays",
                     "--out-dir", str(tmp_path / name)] + flags)
        assert all(r["finite"] for r in recs)
        return [np.load(r["path"][:-len(".png")] + "_gbuffer.npy") for r in recs]

    want = frames("v2p", ["--mesh-kernel-impl", "v2p"])
    got = frames(impl, ["--mesh-kernel-impl", impl] + extra)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_wavefront_option_flags_reach_render_options():
    from ai_path_tracer_denoiser_tpu_torch.app.cli import (_render_options,
                                                           build_parser)
    parser = build_parser()
    for cmd in (["render", "s.txt"], ["bench", "a.txt", "b.txt"]):
        opts = _render_options(parser.parse_args(
            cmd + ["--sort-material", "--cache-first-bounce", "--no-antialias",
                   "--mesh-kernel-impl", "v3"]))
        assert (opts.sort_material, opts.cache_first_bounce, opts.antialias,
                opts.motion_blur, opts.mesh_kernel_impl) == (True, True, False, False, "v3")
    opts = _render_options(parser.parse_args(["interactive", "s.txt", "--motion-blur"]))
    assert opts.motion_blur and not opts.sort_material
    with pytest.raises(ValueError, match="incompatible with antialiasing"):
        _render_options(parser.parse_args(["render", "s.txt", "--cache-first-bounce"]))
    # any lane count is taken, as by the JAX CLI; "v2" checks it when it runs
    opts = _render_options(parser.parse_args(["render", "s.txt", "--mesh-kernel-lanes", "100"]))
    assert opts.mesh_kernel_lanes == 100
    bench = parser.parse_args(["bench", "a.txt", "b.txt"])
    assert bench.scenes == ["a.txt", "b.txt"] and bench.iters == 500 and bench.device == "cuda"


def test_timers_measure_on_the_cpu():
    import time

    from ai_path_tracer_denoiser_tpu_torch.utils.timers import PerformanceTimer, time_call
    timer = PerformanceTimer("cpu")
    timer.start_cpu()
    timer.start_device()
    time.sleep(0.02)
    assert timer.end_device() >= 15.0 and timer.end_cpu() >= 15.0
    assert timer.dev_elapsed_ms >= 15.0 and timer.cpu_elapsed_ms >= timer.dev_elapsed_ms - 1.0
    calls = []
    ms = time_call(lambda x: calls.append(x) or time.sleep(0.005), 7, warmup=2, iters=3,
                   device="cpu")
    assert calls == [7] * 5 and 4.0 <= ms < 200.0
