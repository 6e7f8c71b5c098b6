"""The port's parallel/ against the JAX package's and against its own
single-process functions, on the CPU.

Multi-rank behaviour runs in gloo worlds on 127.0.0.1, spawned once per
world size for the whole file (tests/_torch_parallel_ranks.py: a world of
four for the meshes, the tile-sharded render over data = 4 and the denoiser
over spatial = 4; a world of two for the data-parallel step and
``train --data-parallel``); each test reads their results.  The JAX side
runs on the conftest's virtual CPU devices while the ranks work.  A world
of one runs in this process.

Tolerances.  The tile-sharded render is the port's ``render`` bit for bit
(the RNG draws by global pixel id); against the JAX package's
``render_sharded`` on cornell the radiance is equal bit for bit and the
G-buffer isclose(rtol 1e-5, atol 1e-5) on at least 99.8% of pixels
(tests/test_torch_render.py's bar: XLA:CPU rounds grazing sphere hits
differently).  The spatially sharded denoiser is held to the JAX package's
and to the port's ``apply_frame`` at the JAX test's bar (rtol 1e-4, atol
1e-5); with GroupNorm, whose statistics in eval mode come from the data and
are summed over the ranks in another order, atol 1e-4 (measured 2.4e-5 on
values up to 3.3).  The float32 halo conv is the whole conv's output bit for
bit; its input gradient and its weight gradient (four partial sums and an
all-reduce) agree to rtol 1e-5 with atol 1e-6 of the largest entry.  In
bfloat16 the halo conv rounds its output to bfloat16 before the bias, as the
JAX package's program says (its conv hands back bfloat16); XLA:CPU skips
that round trip by default (``xla_allow_excess_precision``), so the JAX
side is compiled with it off, and then the halo conv is the JAX package's
bit for bit and the frame agrees at rtol 1e-4, atol 1e-5.  The
data-parallel step's loss and metrics agree with the single-process step
and with the JAX package's data-parallel step to rtol 1e-5, and its
gradients to a global relative L2 < 0.01 (the JAX test's bar; see the
header of tests/test_torch_train.py on why whole-step gradients are loose).
A world of one is ``train_step`` bit for bit.
"""
import os
import queue
import socket
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import PartitionSpec as P

import _torch_parallel_ranks as ranks
from ai_path_tracer_denoiser_tpu.config import ModelOptions as JaxModelOptions
from ai_path_tracer_denoiser_tpu.config import RenderOptions as JaxRenderOptions
from ai_path_tracer_denoiser_tpu.config import TrainOptions as JaxTrainOptions
from ai_path_tracer_denoiser_tpu import parallel as jax_parallel
from ai_path_tracer_denoiser_tpu.models import autoencoder as jax_autoencoder
from ai_path_tracer_denoiser_tpu.models import init_autoencoder as jax_init_autoencoder
from ai_path_tracer_denoiser_tpu.models import layers as jax_layers
from ai_path_tracer_denoiser_tpu.parallel.dp import _shard_map
from ai_path_tracer_denoiser_tpu.train.trainer import loss_fn as jax_loss_fn
from ai_path_tracer_denoiser_tpu_torch.config import ModelOptions, TrainOptions
from ai_path_tracer_denoiser_tpu_torch.models import params_from_numpy
from ai_path_tracer_denoiser_tpu_torch.models.export import sorted_leaves
from ai_path_tracer_denoiser_tpu_torch.parallel import make_dp_train_step, make_mesh, shard_batch
from ai_path_tracer_denoiser_tpu_torch.parallel.mesh import destroy
from ai_path_tracer_denoiser_tpu_torch.train import TrainState, train_step, trainer
from test_torch_render import assert_gbuffer_close

torch.set_num_threads(2)
JSMALL = JaxModelOptions(widths=ranks.WIDTHS)
DEADLINE_S = 300
CORPUS_FRAMES = 7                   # one 7-frame window per frame: 3 steps over 2 ranks


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(world, params_np, bn_np, data_dir):
    results = mp.get_context("spawn").Queue()
    procs = mp.start_processes(ranks.run, args=(world, _free_port(), params_np, bn_np,
                                                data_dir, results),
                               nprocs=world, join=False, daemon=True, start_method="spawn")
    return procs, results


def _collect(procs, results, world):
    got, deadline = {}, time.time() + DEADLINE_S
    while len(got) < world:
        try:
            rank, out, err = results.get(timeout=1.0)
        except queue.Empty:
            if time.time() > deadline:
                for p in procs.processes:
                    p.kill()
                raise TimeoutError(f"world of {world}: ranks {sorted(got)} answered")
            procs.join(timeout=0)            # raises when a rank died
            continue
        assert err is None, f"rank {rank} of {world}:\n{err}"
        got[rank] = out
    while not procs.join(timeout=DEADLINE_S):
        pass
    return got


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _write_corpus(root):
    """A 64x64 corpus of CORPUS_FRAMES frames in datagen's layout."""
    rng = np.random.default_rng(7)
    for sub, c in (("input", 10), ("gt", 3)):
        os.makedirs(os.path.join(root, sub))
        for f in range(CORPUS_FRAMES):
            a = rng.random((64, 64, c), dtype=np.float32)
            np.save(os.path.join(root, sub, f"000_0_0_{f:04d}.npy"), a)


def _jax_references(cornell_scene_small, params, bn):
    """The JAX package's results on the ranks' inputs."""
    x, _, conv, bx, by = ranks.inputs()
    out = {}
    mesh = jax_parallel.make_mesh(data=4, spatial=1)
    img, gbuf, _ = jax_parallel.render_sharded(cornell_scene_small, JaxRenderOptions(), 2, mesh)
    out["cornell"] = {"image": np.asarray(img), "gbuffer": np.asarray(gbuf)}
    rows = jax_parallel.make_mesh(data=1, spatial=4)
    out["frame"] = np.asarray(jax_parallel.denoise_frame_spatial(params, bn, jnp.asarray(x),
                                                                 rows)[0])
    # bfloat16: denoise_frame_spatial's program and the halo conv alone,
    # compiled with the rounding to bfloat16 that the programs state
    rounded = {"xla_allow_excess_precision": False}
    stages = {k: P(None, "spatial") for k in ("enc1", "enc2", "enc3", "enc4", "enc5",
                                              "bottleneck")}
    frame = jax.jit(_shard_map(
        lambda p, b, xx, hd: jax_autoencoder.apply_frame(p, b, xx, hd, train=False, bf16=True,
                                                         spatial_axis="spatial")[0],
        mesh=rows, in_specs=(P(), P(), P(None, "spatial"), stages),
        out_specs=P(None, "spatial"), check_vma=False), compiler_options=rounded)
    out["frame_bf16"] = np.asarray(frame(params, bn, jnp.asarray(x), jax_autoencoder.init_hidden(
        *ranks.FRAME[:3], JSMALL)))
    halo = _shard_map(lambda p, xx: jax_layers.conv2d(p, xx, True, "spatial"),
                      mesh=rows, in_specs=(P(), P(None, "spatial")),
                      out_specs=P(None, "spatial"), check_vma=False)
    cp = ({"w": jnp.asarray(conv["w"]), "b": jnp.asarray(conv["b"])}, jnp.asarray(conv["x"]))
    out["conv_bf16"] = np.asarray(jax.jit(halo, compiler_options=rounded)(*cp))
    out["conv_bf16_default"] = np.asarray(jax.jit(halo)(*cp))
    # the data-parallel step's loss, metrics and averaged gradients
    topt = JaxTrainOptions(bf16_compute=False)
    grad_fn = jax.value_and_grad(jax_loss_fn, has_aux=True)

    def local(p, b, a, t):
        (_, (metrics, _)), g = grad_fn(p, b, a, t, topt, False, "data", JSMALL)
        return jax.lax.pmean(metrics, "data"), jax.lax.pmean(g, "data")

    dp = jax.jit(_shard_map(local, mesh=jax_parallel.make_mesh(data=2, spatial=1),
                            in_specs=(P(), P(), P(None, "data"), P(None, "data")),
                            out_specs=(P(), P()), check_vma=False))
    metrics, grads = dp(params, bn, jnp.asarray(bx), jnp.asarray(by))
    torch_grads = params_from_numpy(_np_tree(grads), _np_tree(bn), device="cpu")[0]
    out["dp"] = {"metrics": {k: float(v) for k, v in metrics.items()},
                 "grads": [leaf.numpy() for _, leaf in sorted_leaves(torch_grads)]}
    return out


@pytest.fixture(scope="module")
def results(cornell_scene_small, tmp_path_factory):
    """Both worlds' results and the JAX package's, computed at once."""
    params, bn = jax_init_autoencoder(jax.random.PRNGKey(0), JSMALL)
    params_np, bn_np = _np_tree(params), _np_tree(bn)
    corpus = str(tmp_path_factory.mktemp("dp_corpus"))
    _write_corpus(corpus)
    worlds = []
    try:
        worlds.append(_spawn(4, params_np, bn_np, corpus))
        worlds.append(_spawn(2, params_np, bn_np, corpus))
        jax_out = _jax_references(cornell_scene_small, params, bn)
        return {"four": _collect(*worlds[0], 4), "two": _collect(*worlds[1], 2),
                "jax": jax_out, "corpus": corpus}
    finally:                     # a failed world leaves no rank behind
        for procs, _ in worlds:
            for p in procs.processes:
                if p.is_alive():
                    p.kill()


def _rel_l2(a_leaves, b_leaves):
    a = np.concatenate([x.ravel() for x in a_leaves])
    b = np.concatenate([x.ravel() for x in b_leaves])
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------

def test_mesh_shapes(results):
    jmesh = jax_parallel.make_mesh(data=2, spatial=2)
    for rank, out in results["four"].items():
        mesh = out["mesh"]
        assert mesh["default"] == (4, 1)
        assert mesh["grid"] == (jmesh.shape["data"], jmesh.shape["spatial"]) == (2, 2)
        assert mesh["coords"] == (rank // 2, rank % 2)
        assert mesh["data_spec"] == "(Shard(dim=1), Replicate())"
        assert mesh["replicated"] == "(Replicate(), Replicate())"


# ---------------------------------------------------------------------------
# tile-sharded render
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scene", ["cornell", "icosphere", "cornell_cache"])
def test_render_sharded_bitwise_matches_render(results, scene):
    """data = 4 on every rank == the single-process render, bit for bit
    (with ``cache_first_bounce`` the cached depth-0 planes too)."""
    ref = results["four"][1 if scene == "icosphere" else 0][scene + "_ref"]
    assert (ref["gbuffer"][6] > 0).mean() > 0.5
    assert len(ref["cache"]) == (8 if scene == "cornell_cache" else 0)
    for out in results["four"].values():
        got = out[scene]
        assert got["iteration"] == 2 and got["segments"] == ref["segments"]
        np.testing.assert_array_equal(got["image"], ref["image"])
        np.testing.assert_array_equal(got["gbuffer"], ref["gbuffer"])
        for a, b in zip(got["cache"], ref["cache"], strict=True):
            np.testing.assert_array_equal(a, b)


def test_render_sharded_matches_jax(results):
    got, want = results["four"][0]["cornell"], results["jax"]["cornell"]
    assert got["gbuffer"].shape == want["gbuffer"].shape == (10, ranks.RES, ranks.RES)
    assert_gbuffer_close(got["gbuffer"], want["gbuffer"])
    np.testing.assert_array_equal(got["image"], want["image"])
    np.testing.assert_array_equal(got["gbuffer"][:3], want["gbuffer"][:3])


# ---------------------------------------------------------------------------
# row-sharded denoiser
# ---------------------------------------------------------------------------

def test_denoise_frame_spatial_matches_jax(results):
    want = results["jax"]["frame"]
    for out in results["four"].values():
        assert out["frame"]["y"].shape == want.shape == ranks.FRAME[:3] + (3,)
        np.testing.assert_allclose(out["frame"]["y"], want, rtol=1e-4, atol=1e-5)


def test_denoise_frame_spatial_matches_apply_frame(results):
    ref = results["four"][2]["frame_ref"]
    for out in results["four"].values():
        np.testing.assert_allclose(out["frame"]["y"], ref, rtol=1e-4, atol=1e-5)


def test_spatial_recurrence_carries_hidden(results):
    out = results["four"][0]["frame"]
    assert not np.allclose(out["y"], out["y_second"])
    local = ranks.FRAME[1] // 4
    assert out["hidden_shapes"]["enc1"] == (1, local, ranks.FRAME[2], ranks.WIDTHS[0])
    assert out["hidden_shapes"]["bottleneck"] == (1, local // 32, ranks.FRAME[2] // 32,
                                                  ranks.WIDTHS[4])


def test_spatial_sequence_matches_frame_loop(results):
    for out in results["four"].values():
        seq = out["frame"]["sequence"]
        assert seq.shape == (ranks.SEQUENCE,) + ranks.FRAME[:3] + (3,)
        np.testing.assert_allclose(seq, out["frame"]["loop"], rtol=1e-5, atol=1e-6)
        assert not np.allclose(seq[1], seq[0])


def test_spatial_group_norm_matches_single_device(results):
    ref = results["four"][2]["group_norm_ref"]
    for out in results["four"].values():
        np.testing.assert_allclose(out["group_norm"], ref, rtol=1e-4, atol=1e-4)


def test_spatial_bf16_rounds_as_jax(results):
    """bfloat16 through the halo convs == the JAX package's program; the
    port's unsharded forward pass, which keeps the conv's float32
    accumulator, is far from it (measured relative L2 9e-3)."""
    want = results["jax"]["frame_bf16"]
    for out in results["four"].values():
        np.testing.assert_allclose(out["frame"]["y_bf16"], want, rtol=1e-4, atol=1e-5)
    unrounded = results["four"][2]["frame_bf16_ref"]
    assert np.linalg.norm(unrounded - want) / np.linalg.norm(want) > 1e-3


def test_halo_conv_matches_whole_conv(results):
    """float32: the halo conv's output and both gradients (the halo's
    backward pass sends the halo rows' cotangents back) == the whole conv's."""
    ref = results["four"][3]["conv_ref"][False]
    for out in results["four"].values():
        np.testing.assert_array_equal(out["conv"][False]["y"], ref["y"])
        for key in ("dx", "dw"):
            np.testing.assert_allclose(out["conv"][False][key], ref[key], rtol=1e-5,
                                       atol=1e-6 * np.abs(ref[key]).max())


def test_halo_conv_bf16_rounds_as_jax(results):
    """bfloat16: the conv's output is rounded to bfloat16 before the bias, as
    the JAX package's halo conv states: equal to it bit for bit.  XLA:CPU's
    default compile of that conv keeps the float32 accumulator instead,
    which is what the port's unsharded conv hands back."""
    want = results["jax"]["conv_bf16"]
    for out in results["four"].values():
        np.testing.assert_array_equal(out["conv"][True]["y"], want)
    ref = results["four"][3]["conv_ref"][True]
    assert (ref["y"] == want).mean() < 0.01
    np.testing.assert_allclose(ref["y"], results["jax"]["conv_bf16_default"], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(results["four"][0]["conv"][True]["dw"], ref["dw"], rtol=2e-2,
                               atol=1e-2 * np.abs(ref["dw"]).max())


# ---------------------------------------------------------------------------
# data-parallel training
# ---------------------------------------------------------------------------

def test_dp_step_matches_single_process(results):
    ref = results["two"][0]["ref"]
    for out in results["two"].values():
        assert out["shard"] == (2, 1, 32, 32, 10)
        for k, v in ref["metrics"].items():
            np.testing.assert_allclose(out["metrics"][k], v, rtol=1e-5)
        assert _rel_l2(out["grads"], ref["grads"]) < 0.01
        for got, want in zip(out["bn"], ref["bn"]):
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_dp_step_matches_jax(results):
    want = results["jax"]["dp"]
    for out in results["two"].values():
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(out["metrics"][k], v, rtol=1e-5)
        assert _rel_l2(out["grads"], want["grads"]) < 0.01


def test_dp_step_keeps_the_state_replicated(results):
    """Adam on the averaged gradients moves every rank's parameters alike,
    and within 2.1 lr of the single-process step (Adam's first step is
    lr * sign(g), and a gradient at rounding noise may take either sign)."""
    a, b = results["two"][0], results["two"][1]
    assert a["step_metrics"] == a["metrics"] == b["step_metrics"]
    lr = TrainOptions().lr
    for x, y, single in zip(a["params"], b["params"], a["ref"]["params"]):
        np.testing.assert_array_equal(x, y)
        assert np.abs(x - single).max() <= 2.1 * lr


def test_train_data_parallel_cli_two_ranks(results):
    from ai_path_tracer_denoiser_tpu_torch.train import load_checkpoint
    a, b = results["two"][0]["cli"], results["two"][1]["cli"]
    assert a["step"] == b["step"] == CORPUS_FRAMES // 2
    for x, y in zip(a["params"], b["params"]):
        np.testing.assert_array_equal(x, y)
    models = os.path.join(results["corpus"], "models")
    assert sorted(os.listdir(models)) == ["model_0.npz", "model_final.npz"]
    final = load_checkpoint(os.path.join(models, "model_final.npz"), device="cpu")
    assert final.step == a["step"]
    for x, (_, y) in zip(a["params"], sorted_leaves(final.params)):
        np.testing.assert_array_equal(x, y.numpy())
    with open(os.path.join(results["corpus"], "logs", "metrics.jsonl")) as f:
        logged = [line for line in f]
    assert len(logged) == 1 and '"hfen"' in logged[0]          # step 0 of 3, rank 0 only


def test_world_of_one_dp_step_is_train_step():
    """A gloo world of one in this process: every collective sums one term
    and divides by 1, so the data-parallel step is ``train_step`` bit for bit."""
    topt, mopt = TrainOptions(bf16_compute=False), ModelOptions(widths=ranks.WIDTHS)
    params, bn = jax_init_autoencoder(jax.random.PRNGKey(1), JSMALL)
    tp, tb = params_from_numpy(_np_tree(params), _np_tree(bn), device="cpu")
    state = TrainState(params=tp, bn_state=tb, opt_state=trainer.init_opt_state(tp), step=0,
                       lr=topt.lr)
    *_, bx, by = ranks.inputs()
    want, want_m = train_step(state, torch.from_numpy(bx), torch.from_numpy(by), topt, mopt)
    try:
        mesh = make_mesh(device="cpu")
        xs, ys = shard_batch(bx, by, mesh)
        assert xs.shape == bx.shape
        got, got_m = make_dp_train_step(mesh, topt, mopt)(state, xs, ys)
    finally:
        destroy()
    assert got.step == want.step == 1
    assert all(torch.equal(got_m[k], want_m[k]) for k in want_m)
    for tree in ("params", "bn_state"):
        for (ka, a), (kb, b) in zip(sorted_leaves(getattr(got, tree)),
                                    sorted_leaves(getattr(want, tree))):
            assert ka == kb and torch.equal(a, b), ka
    for (_, a), (_, b) in zip(sorted_leaves(got.opt_state["nu"]),
                              sorted_leaves(want.opt_state["nu"])):
        assert torch.equal(a, b)
