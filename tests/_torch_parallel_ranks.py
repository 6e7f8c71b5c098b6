"""The rank programs of tests/test_torch_parallel.py.

Each rank of a gloo world on 127.0.0.1 joins it through the launcher's
environment variables (as under ``torchrun``), runs every case of its world
size and hands its results back as numpy arrays; the test process holds
them against the port's single-process functions and the JAX package.  The
single-process references are computed here too, spread over the ranks once
the collective cases are done.  This module imports torch and the port only.
"""
import dataclasses
import os
import pathlib
import sys
import traceback

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
RES = 64                            # render frames, as tests/test_torch_render.py
FRAME = (1, 128, 32, 10)            # the spatial denoiser's input (JAX test_parallel.py)
SEQUENCE = 3
CONV = (2, 64, 16, 6, 5)            # N, H, W, Ci, Co of the halo conv case
BATCH = ((2, 2, 32, 32, 10), (2, 2, 32, 32, 3))   # the data-parallel step's x, y
WIDTHS = (8, 8, 8, 8, 8)


def inputs():
    """The cases' inputs, drawn from numpy seeds (the test process draws the
    same for the JAX package)."""
    x = np.random.default_rng(0).normal(size=FRAME).astype(np.float32)
    frames = np.random.default_rng(2).normal(size=(SEQUENCE,) + FRAME).astype(np.float32)
    r = np.random.default_rng(4)
    n, h, w, ci, co = CONV
    conv = {"x": r.normal(size=(n, h, w, ci)).astype(np.float32),
            "w": (r.normal(size=(3, 3, ci, co)) * 0.3).astype(np.float32),
            "b": (r.normal(size=co) * 0.1).astype(np.float32)}
    bx = np.random.default_rng(0).normal(size=BATCH[0]).astype(np.float32)
    by = np.random.default_rng(1).normal(size=BATCH[1]).astype(np.float32)
    return x, frames, conv, bx, by


def run(rank, world, port, params_np, bn_np, data_dir, results):
    """Entry of one spawned rank: ``results`` gets (rank, dict, None) or
    (rank, None, traceback)."""
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    import torch
    torch.set_num_threads(1)
    from ai_path_tracer_denoiser_tpu_torch.parallel.mesh import destroy
    try:
        case = _world_of_four if world == 4 else _world_of_two
        results.put((rank, case(rank, params_np, bn_np, data_dir), None))
    except BaseException:
        results.put((rank, None, traceback.format_exc()))
    finally:
        destroy()


def _np(t):
    return t.detach().float().numpy().copy()


def _scene(name):
    from ai_path_tracer_denoiser_tpu_torch.scene import derive_camera, load_scene
    scene = load_scene(str(REPO / "scenes" / name), device="cpu")
    c = scene.camera
    return dataclasses.replace(scene, camera=derive_camera(
        (RES, RES), 45.0, c.position.numpy(), c.look_at.numpy(), c.up.numpy()))


def _render_result(img, gbuf, state):
    cache = []
    if state.cache is not None:
        t, point, normal, mat = state.cache
        cache = [_np(t), *(_np(c) for c in point), *(_np(c) for c in normal), _np(mat)]
    return {"image": _np(img), "gbuffer": _np(gbuf), "segments": state.segments,
            "iteration": state.iteration, "cache": cache}


def _world_of_four(rank, params_np, bn_np, data_dir):
    import torch
    import torch.distributed as dist
    from ai_path_tracer_denoiser_tpu_torch.config import ModelOptions, RenderOptions
    from ai_path_tracer_denoiser_tpu_torch.models import (apply_frame, init_hidden, layers,
                                                          params_from_numpy)
    from ai_path_tracer_denoiser_tpu_torch.parallel import (
        data_spec, denoise_frame_spatial, denoise_sequence_spatial, make_mesh,
        render_sharded, replicated)
    from ai_path_tracer_denoiser_tpu_torch.parallel.mesh import (all_gather_dim, axis_index,
                                                                 axis_size)
    from ai_path_tracer_denoiser_tpu_torch.render import render
    out = {}
    # meshes: the default, and (2, 2) with this rank's coordinates
    mesh = make_mesh(device="cpu")
    grid = make_mesh(data=2, spatial=2, device="cpu")
    out["mesh"] = {"default": (axis_size(mesh, "data"), axis_size(mesh, "spatial")),
                   "grid": (axis_size(grid, "data"), axis_size(grid, "spatial")),
                   "coords": (axis_index(grid, "data"), axis_index(grid, "spatial")),
                   "data_spec": repr(data_spec(grid, 1)), "replicated": repr(replicated(grid))}
    # tile-sharded render over data = 4: the megakernel's plain version on
    # cornell, the plain wavefront with the hierarchy on the icosphere
    # cornell with the first-bounce cache, whose planes are gathered too
    cornell = _scene("cornell_box.txt")
    scenes = {"cornell": (cornell, RenderOptions()),
              "icosphere": (_scene("cornell_mesh_icosphere.txt"), RenderOptions()),
              "cornell_cache": (cornell, RenderOptions(cache_first_bounce=True, antialias=False))}
    for name, (scene, opts) in scenes.items():
        out[name] = _render_result(*render_sharded(scene, opts, 2, mesh))
    # the denoiser with its rows over spatial = 4
    x, frames, conv, _, _ = inputs()
    params, bn = params_from_numpy(params_np, bn_np, device="cpu")
    rows = make_mesh(data=1, spatial=4, device="cpu")
    group = rows.get_group("spatial")
    y1, h1 = denoise_frame_spatial(params, bn, torch.from_numpy(x), rows)
    y2, _ = denoise_frame_spatial(params, bn, torch.from_numpy(x), rows, hidden=h1)
    yb, _ = denoise_frame_spatial(params, bn, torch.from_numpy(x), rows, bf16=True)
    seq = denoise_sequence_spatial(params, bn, torch.from_numpy(frames), rows)
    hidden, loop = None, []
    for t in range(SEQUENCE):
        y, hidden = denoise_frame_spatial(params, bn, torch.from_numpy(frames[t]), rows, hidden)
        loop.append(_np(y))
    out["frame"] = {"y": _np(y1), "y_second": _np(y2), "y_bf16": _np(yb), "sequence": _np(seq),
                    "loop": np.stack(loop),
                    "hidden_shapes": {k: tuple(v.shape) for k, v in h1.items()}}
    # GroupNorm's statistics over the rows (apply_frame with spatial_axis)
    gopts = ModelOptions(widths=WIDTHS, norm="group")
    local = FRAME[1] // 4
    xl = torch.from_numpy(x[:, rank * local:(rank + 1) * local].copy())
    with torch.no_grad():
        yg, _, _ = apply_frame(params, bn, xl, init_hidden(1, local, FRAME[2], gopts),
                               spatial_axis=group, options=gopts)
    out["group_norm"] = _np(all_gather_dim(yg, group, 1))
    # the halo conv alone, float32 and bfloat16, with its gradients
    h = CONV[1] // 4
    cp = {"w": torch.from_numpy(conv["w"]).requires_grad_(True), "b": torch.from_numpy(conv["b"])}
    xc = torch.from_numpy(conv["x"][:, rank * h:(rank + 1) * h].copy()).requires_grad_(True)
    out["conv"] = {}
    for bf16 in (False, True):
        y = layers.conv2d(cp, xc, bf16, spatial_axis=group)
        dx, dw = torch.autograd.grad(torch.sin(y).sum(), (xc, cp["w"]))
        dist.all_reduce(dw, group=group)
        out["conv"][bf16] = {"y": _np(all_gather_dim(y, group, 1)),
                             "dx": _np(all_gather_dim(dx, group, 1)), "dw": _np(dw)}
    # single-process references, one rank each
    if rank < 2:
        for name in (("cornell", "cornell_cache"), ("icosphere",))[rank]:
            out[name + "_ref"] = _render_result(*render(*scenes[name], 2))
    elif rank == 2:
        with torch.no_grad():
            hid = init_hidden(1, FRAME[1], FRAME[2], ModelOptions(widths=WIDTHS))
            out["frame_ref"] = _np(apply_frame(params, bn, torch.from_numpy(x), hid)[0])
            out["frame_bf16_ref"] = _np(apply_frame(params, bn, torch.from_numpy(x), hid,
                                                    bf16=True)[0])
            out["group_norm_ref"] = _np(apply_frame(params, bn, torch.from_numpy(x), hid,
                                                    options=gopts)[0])
    else:
        whole = torch.from_numpy(conv["x"]).requires_grad_(True)
        out["conv_ref"] = {}
        for bf16 in (False, True):
            y = layers.conv2d(cp, whole, bf16)
            dx, dw = torch.autograd.grad(torch.sin(y).sum(), (whole, cp["w"]))
            out["conv_ref"][bf16] = {"y": _np(y), "dx": _np(dx), "dw": _np(dw)}
    return out


def _world_of_two(rank, params_np, bn_np, data_dir):
    import torch
    from ai_path_tracer_denoiser_tpu_torch.app.cli import main
    from ai_path_tracer_denoiser_tpu_torch.config import ModelOptions, TrainOptions
    from ai_path_tracer_denoiser_tpu_torch.models import params_from_numpy
    from ai_path_tracer_denoiser_tpu_torch.models.export import sorted_leaves
    from ai_path_tracer_denoiser_tpu_torch.parallel import (make_dp_train_step, make_mesh,
                                                            shard_batch)
    from ai_path_tracer_denoiser_tpu_torch.train import TrainState, train_step, trainer

    def leaves(tree):
        return [_np(leaf) for _, leaf in sorted_leaves(tree)]

    topt, mopt = TrainOptions(bf16_compute=False), ModelOptions(widths=WIDTHS)
    params, bn = params_from_numpy(params_np, bn_np, device="cpu")
    state = TrainState(params=params, bn_state=bn, opt_state=trainer.init_opt_state(params),
                       step=0, lr=topt.lr)
    *_, bx, by = inputs()
    mesh = make_mesh(device="cpu")
    xs, ys = shard_batch(bx, by, mesh)
    metrics, new_bn, grads = trainer.loss_and_grads(state, xs, ys, topt, mopt,
                                                    axis_name=mesh.get_group("data"))
    stepped, step_metrics = make_dp_train_step(mesh, topt, mopt)(state, xs, ys)
    out = {"shard": tuple(xs.shape), "metrics": {k: float(v) for k, v in metrics.items()},
           "grads": leaves(grads), "bn": leaves(new_bn), "params": leaves(stepped.params),
           "step_metrics": {k: float(v) for k, v in step_metrics.items()}}
    # train --data-parallel through the command line (TensorBoard's writer
    # left out: importing it takes longer than the whole run)
    sys.modules["torch.utils.tensorboard"] = None
    final = main(["train", "--data-parallel", "--device", "cpu", "--data-dir", data_dir,
                  "--model-dir", os.path.join(data_dir, "models"),
                  "--log-dir", os.path.join(data_dir, "logs"), "--epochs", "1",
                  "--crop-size", "32"])
    out["cli"] = {"step": final.step, "params": leaves(final.params)}
    if rank == 0:
        whole_x, whole_y = torch.from_numpy(bx), torch.from_numpy(by)
        m, b, g = trainer.loss_and_grads(state, whole_x, whole_y, topt, mopt)
        single, _ = train_step(state, whole_x, whole_y, topt, mopt)
        out["ref"] = {"metrics": {k: float(v) for k, v in m.items()}, "grads": leaves(g),
                      "bn": leaves(b), "params": leaves(single.params)}
    return out
