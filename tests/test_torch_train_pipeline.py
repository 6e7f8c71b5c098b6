"""The port's training campaign driver (tools/train_pipeline.py,
export_latest.py, compare_evals.py of the port's package) against the JAX
package's root tools of the same names, on the CPU.

The JAX tools are loaded from their files as they are; their ``REPO`` points
at a temporary repository (the real ``scenes/`` and an empty ``artifacts/``)
so that nothing of theirs lands in the checkout, and the port's driver gets
``--artifacts-dir`` for the same reason.  The campaign is cut to 64x64 frames
(the size the render bar below was set on; at 32x32 the same few grazing
pixels per frame are a larger share), 32x32 crops, one train and one eval
scene, 7 frames, 2-spp truth, batch 2 (3 steps per epoch), and widths
(8, 8, 8, 8, 8) where a stage builds a model.

Tolerances.  Scenes and cameras: equal.  Datagen: the 1-spp radiance bit
for bit; the G-buffer planes at the render bar, isclose(1e-5, 1e-5) on
>= 99.8% of pixels (ROADMAP C, "Render"), and within one level after each
package's uint8 encoding; the truths, which accumulate paths, at the
render bar for accumulated radiance (mean and PSNR).  ``recalibrate_bn``
from one carried-across state on the same batches: statistics to 1e-4 (the
BatchNorm bar of tests/test_torch_train.py).  Eval on one artifact (saved
by the JAX ``save_model``) and one corpus: MSE and L1 to rtol 2e-3 (bfloat16 convs),
PSNR within 0.02 dB.  ``MODEL_CARD.md`` and ``compare_evals``' output:
byte for byte.
"""
import argparse
import contextlib
import dataclasses
import functools
import importlib.util
import io
import json
import os
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

from ai_path_tracer_denoiser_tpu import config as jconfig
from ai_path_tracer_denoiser_tpu.data import datagen as jdatagen
from ai_path_tracer_denoiser_tpu.models import export as jexport
from ai_path_tracer_denoiser_tpu.train import trainer as jtrainer
from ai_path_tracer_denoiser_tpu_torch import config
from ai_path_tracer_denoiser_tpu_torch.data import SequenceDataset, datagen, sequence_batches
from ai_path_tracer_denoiser_tpu_torch.models import load_model, train_state_from_numpy
from ai_path_tracer_denoiser_tpu_torch.models.export import sorted_leaves
from ai_path_tracer_denoiser_tpu_torch.train import recalibrate_bn
from ai_path_tracer_denoiser_tpu_torch.tools import compare_evals, eval_bar_probe, export_latest
from ai_path_tracer_denoiser_tpu_torch.tools import train_pipeline as tp

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parent.parent
WIDTHS = (8, 8, 8, 8, 8)
CUT = dict(res=64, train_scenes=1, eval_scenes=1, frames=7, noise_seeds=1, movs=1,
           gt_spp=2, gt_spp_eval=2, quantize="", epochs=1, batch=2, crop=32, bn_recal=2)


def _load_jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"_jax_tool_{name}",
                                                  REPO / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_args(out, **kw):
    """The JAX driver's parsed defaults (its parser is built inside main)."""
    base = dict(out=str(out), res=512, train_scenes=28, eval_scenes=4, frames=48,
                noise_seeds=3, movs=2, gt_spp=800, gt_spp_eval=2000, quantize="u8",
                epochs=60, batch=4, crop=256, tpu_friendly=False, prefix="",
                models_subdir="models", artifact="denoiser_multiscene.npz",
                render_backend="xla", data_from=None, stream_gb=0.0, device_data=False,
                bn_recal=120, resume=False, stages="datagen,train,eval,report")
    base.update(CUT, **kw)
    return argparse.Namespace(**base)


def _port_args(out, art, *extra, **kw):
    cut = {**CUT, **kw}
    argv = ["--out", str(out), "--artifacts-dir", str(art), "--device", "cpu"]
    for key, val in cut.items():
        argv += [f"--{key.replace('_', '-')}", str(val)]
    return tp.build_parser().parse_args(argv + list(extra))


@pytest.fixture(scope="module")
def campaign(tmp_path_factory):
    """Both drivers' datagen, train (and a 'final'-sentinel resume), with the
    JAX tools' ``REPO`` at a temporary repository."""
    root = tmp_path_factory.mktemp("campaign")
    fake_repo = root / "repo"
    (fake_repo / "artifacts").mkdir(parents=True)
    (fake_repo / "scenes").symlink_to(REPO / "scenes")
    jtp = _load_jax_tool("train_pipeline")
    mp = pytest.MonkeyPatch()
    mp.setattr(jtp, "REPO", str(fake_repo))
    # small widths where a stage builds its model options
    mp.setattr(jconfig, "ModelOptions",
               functools.partial(jconfig.ModelOptions, widths=WIDTHS))
    mp.setattr(config, "ModelOptions", functools.partial(config.ModelOptions, widths=WIDTHS))
    out = {"jtp": jtp, "root": root, "art": fake_repo / "artifacts",
           "jargs": _jax_args(root / "jax"),
           "pargs": _port_args(root / "port", root / "port_art")}
    logs = io.StringIO()
    try:
        with contextlib.redirect_stdout(logs):
            jtp.stage_datagen(out["jargs"])
            tp.stage_datagen(out["pargs"])
            out["jstate1"] = jtp.stage_train(out["jargs"])
            out["pstate1"] = tp.stage_train(out["pargs"])
            out["jmeta1"] = jexport.load_model(str(out["art"] / "denoiser_multiscene.npz"))[2]
            # a completed run's 'final' checkpoint, resumed with more epochs
            for args in (out["jargs"], out["pargs"]):
                args.resume, args.epochs = True, 2
            out["jstate2"] = jtp.stage_train(out["jargs"])
            out["pstate2"] = tp.stage_train(out["pargs"])
    finally:
        mp.undo()
    out["log"] = logs.getvalue()
    return out


def _fields_equal(got, want):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(a, torch.Tensor):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f.name)
        elif not dataclasses.is_dataclass(b) and f.name != "bvh":
            assert a == b, f.name


def test_scenes_and_rescale_match_jax():
    jtp = _load_jax_tool("train_pipeline")
    template = str(REPO / "scenes" / "template_random.txt")
    want = [jtp._rescale(s, 32) for s in jtp._scenes(template, 3, 42)]
    got = [tp._rescale(s, 32) for s in tp._scenes(template, 3, 42, device="cpu")]
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for part in ("geoms", "materials", "camera"):
            _fields_equal(getattr(g, part), getattr(w, part))
        assert g.camera.resolution == (32, 32)


def _corpus(out, split):
    d = pathlib.Path(out) / "data" / split
    names = sorted(os.listdir(d / "input"))
    return names, [(np.load(d / "input" / n), np.load(d / "gt" / n)) for n in names]


@pytest.mark.parametrize("split", ["train", "eval"])
def test_datagen_stage_matches_jax(campaign, split):
    jnames, jpairs = _corpus(campaign["jargs"].out, split)
    pnames, ppairs = _corpus(campaign["pargs"].out, split)
    assert pnames == jnames and len(jnames) == (7 if split == "train" else 14)
    close = []
    for (px, py), (jx, jy) in zip(ppairs, jpairs):
        assert px.shape == jx.shape == (64, 64, 10) and px.dtype == jx.dtype == np.float32
        np.testing.assert_array_equal(px[..., :3], jx[..., :3])
        close.append(np.isclose(px[..., 3:], jx[..., 3:], rtol=1e-5, atol=1e-5).all(axis=-1))
        pu, ju = datagen.encode_u8_input(px), jdatagen.encode_u8_input(jx)
        assert np.abs(pu.astype(np.int16) - ju.astype(np.int16)).max() <= 1
        gu = datagen.encode_u8_gt(py).astype(np.int16) - jdatagen.encode_u8_gt(jy)
        assert (np.abs(gu) <= 1).mean() >= 0.999
    # over the split's pixels: grazing hits take 2-6 pixels of a 64x64 frame
    assert np.mean(close) >= 0.998, np.mean(close)
    # the truths accumulate paths, and a near-tie hit can send one down
    # another branch (one pixel of the eval split): the accumulated-radiance
    # bar of tests/test_torch_render.py, mean within 1e-3 and PSNR >= 40 dB
    got, want = np.stack([p[1] for p in ppairs]), np.stack([p[1] for p in jpairs])
    assert abs(got.mean() - want.mean()) < 1e-3 * want.mean()
    mse = float(((got - want) ** 2).mean())
    assert mse == 0 or 10 * np.log10(max(want.max(), 1.0) ** 2 / mse) >= 40.0


def test_datagen_stage_skips_a_present_corpus(campaign, capsys):
    tp.stage_datagen(campaign["pargs"])
    out = capsys.readouterr().out
    assert "[datagen] train: 7 frames already present, skip" in out
    assert "[datagen] eval: 14 frames already present, skip" in out


@pytest.mark.parametrize("bf16,tol", [(False, 1e-4), (True, 5e-2)], ids=["float32", "bfloat16"])
def test_recalibrate_bn_matches_jax(campaign, bf16, tol):
    """The first test of ``recalibrate_bn`` against JAX's: one state carried
    across, the same batches of the port's corpus, one batch short of the
    count asked (both stop when the batches end).  The statistics' bars are
    the train step's (tests/test_torch_train.py): 1e-4 in float32, 5e-2 in
    bfloat16, where every conv input is rounded and XLA's CPU conv rounds
    its output too.  Whole 64x64 frames: on 32x32 crops the 1x1 bottleneck's
    statistics are taken over 2 values each, which turns last-bit
    differences into 4.9e-4 there in float32 (every other leaf stays
    below 1e-4)."""
    jtopt = jconfig.TrainOptions(batch_size=2, crop_size=64, bf16_compute=bf16)
    topt = config.TrainOptions(batch_size=2, crop_size=64, bf16_compute=bf16)
    jmopt, mopt = jconfig.ModelOptions(widths=WIDTHS), config.ModelOptions(widths=WIDTHS)
    jstate = jtrainer.init_train_state(jax.random.PRNGKey(3), jmopt, jtopt)
    np_tree = functools.partial(jax.tree_util.tree_map, np.asarray)
    state = train_state_from_numpy(np_tree(jstate.params), np_tree(jstate.bn_state), None,
                                   0, 1e-3, device="cpu")
    data = pathlib.Path(campaign["pargs"].out) / "data" / "train"
    ds = SequenceDataset(str(data / "input"), str(data / "gt"), crop=True, crop_size=64)
    batches = list(sequence_batches(ds, batch_size=2, seed=10_007))
    assert len(batches) == 3
    want = jtrainer.recalibrate_bn(jstate, iter(batches), 4, jtopt, jmopt)
    got = recalibrate_bn(state, iter(batches), 4, topt, mopt)
    n_leaves = 0
    for (path, g), (_, w) in zip(sorted_leaves(got.bn_state),
                                 sorted_leaves(np_tree(want.bn_state))):
        np.testing.assert_allclose(g.numpy(), w, rtol=tol, atol=tol, err_msg=str(path))
        n_leaves += 1
    assert n_leaves > 30
    # only the statistics moved, and they did
    assert got.params is state.params
    assert not all(torch.equal(a, b) for (_, a), (_, b) in
                   zip(sorted_leaves(got.bn_state), sorted_leaves(state.bn_state)))


def test_train_stage_resumes_a_final_checkpoint_as_jax_does(campaign):
    """epochs 1, then --resume --epochs 2 from the 'final' checkpoint: both
    drivers derive epoch 1 from the step count and train one more epoch."""
    steps = 7 // 2
    assert int(campaign["jstate1"].step) == campaign["pstate1"].step == steps
    assert int(campaign["jstate2"].step) == campaign["pstate2"].step == 2 * steps
    log = campaign["log"]
    assert log.count("[train] 'final' checkpoint: resuming extension at epoch 1") == 2
    assert log.count(f"[train] 7 windows, batch 2, epochs 1..2, widths {WIDTHS}") == 2


def test_train_stage_exports_the_jax_meta_and_the_final_state(campaign):
    pmeta = load_model(os.path.join(campaign["pargs"].artifacts_dir,
                                    "denoiser_multiscene.npz"), device="cpu")[2]
    jmeta = jexport.load_model(str(campaign["art"] / "denoiser_multiscene.npz"))[2]
    assert pmeta == jmeta
    assert pmeta["epochs"] == 2 and pmeta["bn_recalibrated_batches"] == 2
    assert pmeta["trained_on"] == "1 randomized scenes @64^2, gt 2spp"
    assert campaign["jmeta1"]["epochs"] == 1
    params, bn_state, _ = load_model(os.path.join(campaign["pargs"].artifacts_dir,
                                                  "denoiser_multiscene.npz"), device="cpu")
    state = campaign["pstate2"]
    for tree, want in ((params, state.params), (bn_state, state.bn_state)):
        for (pa, a), (pb, b) in zip(sorted_leaves(tree), sorted_leaves(want)):
            assert pa == pb and torch.equal(a, b), pa


def test_export_latest_matches_jax(campaign, tmp_path):
    """The latest checkpoint, recalibrated and exported: the JAX tool's meta."""
    jel = _load_jax_tool("export_latest")
    fake_repo = campaign["root"] / "repo"
    data = os.path.join(campaign["pargs"].out, "data", "train")
    argv = ["--model-dir", os.path.join(campaign["pargs"].out, "models"), "--data", data,
            "--bn-recal", "2", "--batch", "2", "--crop", "32"]
    mp = pytest.MonkeyPatch()
    mp.setattr(jel, "REPO", str(fake_repo))
    mp.setattr(sys, "argv", ["export_latest.py"] + argv)
    mp.setattr(jconfig, "ModelOptions", functools.partial(jconfig.ModelOptions, widths=WIDTHS))
    mp.setattr(config, "ModelOptions", functools.partial(config.ModelOptions, widths=WIDTHS))
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            jel.main()
            path = export_latest.main(argv + ["--artifacts-dir", str(tmp_path),
                                              "--device", "cpu"])
    finally:
        mp.undo()
    jmeta = jexport.load_model(str(fake_repo / "artifacts" / "denoiser_multiscene_r4.npz"))[2]
    assert path == str(tmp_path / "denoiser_multiscene_r4.npz")
    meta = load_model(path, device="cpu")[2]
    # the latest checkpoint is the 'final' one, whose resume epoch is the
    # sentinel: both tools write it less one as the epoch count
    assert meta == jmeta and meta["epochs"] == 2 ** 30 - 1 and meta["trained_on"] == "train"


@pytest.fixture(scope="module")
def evals(campaign):
    """``stage_eval`` of both drivers on the JAX artifact and the JAX eval
    corpus."""
    jtp, jargs = campaign["jtp"], campaign["jargs"]
    pargs = _port_args(jargs.out, campaign["root"] / "eval_art")
    os.makedirs(pargs.artifacts_dir)
    artifact = campaign["art"] / "denoiser_multiscene.npz"
    os.link(artifact, os.path.join(pargs.artifacts_dir, "denoiser_multiscene.npz"))
    mp = pytest.MonkeyPatch()
    mp.setattr(jtp, "REPO", str(campaign["root"] / "repo"))
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            want = jtp.stage_eval(jargs)
            got = tp.stage_eval(pargs)
    finally:
        mp.undo()
    return want, got, pargs


def test_eval_stage_matches_jax(evals):
    want, got, pargs = evals
    assert sorted(got) == sorted(want) == ["000"]
    for sid, w in want.items():
        g = got[sid]
        assert sorted(g) == sorted(w) and len(g) == 9
        for key in ("mse_denoised", "l1_denoised"):
            np.testing.assert_allclose(g[key], w[key], rtol=2e-3, err_msg=key)
        assert abs(g["psnr_denoised"] - w["psnr_denoised"]) <= 0.02
        for key in ("mse_noisy", "psnr_noisy", "ssim_noisy"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-6, err_msg=key)
    with open(os.path.join(pargs.out, "eval.json")) as f:
        assert json.load(f) == got
    assert os.path.exists(os.path.join(pargs.artifacts_dir, "eval_unseen.gif"))


def test_eval_bar_probe_reads_faults_above_sum_order(evals, capsys):
    """The probe's variants of the plain conv on the eval window: a dropped
    tap and transposed taps move it more than the taps summed in reverse
    order (which, in this barely trained 8-wide network, is far from
    nothing: its BatchNorm amplifies float32 sum order), and the conv is
    restored after."""
    from ai_path_tracer_denoiser_tpu_torch.models import conv_kernel
    _, _, pargs = evals
    plain = conv_kernel.conv3x3_act_plain
    got = eval_bar_probe.main(["--out", pargs.out, "--artifact",
                               os.path.join(pargs.artifacts_dir, "denoiser_multiscene.npz")])
    assert conv_kernel.conv3x3_act_plain is plain
    assert json.loads(capsys.readouterr().out)["eval_bar_probe"]["rel_l2_vs_plain"] == got
    assert all(np.isfinite(v) for v in got.values()), got
    assert 2 * got["reversed_taps"] < min(got["dropped_tap"], got["transposed_taps"]), got


def test_report_stage_writes_the_jax_model_card(campaign, evals, tmp_path):
    want, _, _ = evals
    jtp = campaign["jtp"]
    pargs = _port_args(campaign["pargs"].out, tmp_path)
    mp = pytest.MonkeyPatch()
    mp.setattr(jtp, "REPO", str(campaign["root"] / "repo"))
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            jtp.stage_report(_jax_args(campaign["pargs"].out), want)
            tp.stage_report(pargs, want)
    finally:
        mp.undo()
    card = (tmp_path / "MODEL_CARD.md").read_bytes()
    assert card == (campaign["art"] / "MODEL_CARD.md").read_bytes()
    assert b"| **mean** |" in card and (tmp_path / "loss_curve.png").exists()


def test_compare_evals_prints_the_jax_lines(evals, tmp_path, capsys):
    want, got, _ = evals
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    a.write_text(json.dumps(want))
    b.write_text(json.dumps({k: dict(v, psnr_denoised=v["psnr_denoised"] + 1)
                             for k, v in got.items()}))
    jce = _load_jax_tool("compare_evals")
    mp = pytest.MonkeyPatch()
    mp.setattr(sys, "argv", ["compare_evals.py", str(a), str(b)])
    try:
        assert jce.main() == 0
    finally:
        mp.undo()
    jax_out = capsys.readouterr().out
    assert compare_evals.main([str(a), str(b)]) == 0
    assert capsys.readouterr().out == jax_out
    assert jax_out.rstrip().endswith("B beats A on 1/1 scenes -> B")
