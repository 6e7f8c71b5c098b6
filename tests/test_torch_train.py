"""The port's trainer against the JAX package's, on the CPU: one and three
train steps from the same carried-across state, Adam alone, checkpoints and
exported models in both directions, the epoch loops.

Tolerances.  Adam alone on identical gradients: rtol 1e-5 (the same float32
formula).  A whole train step in float32: the loss agrees to rtol 1e-5 and
the BatchNorm statistics to 1e-4, but a random-initialised recurrent network
of 33 batch norms amplifies last-bit differences of the forward pass about a
thousandfold in the gradient (a 1e-7 relative change of the parameters moves
single gradient leaves of the port itself by 1e-3 of their norm), so
gradient and moment leaves are held to 5e-2 of the leaf's norm and the whole
gradient to a cosine of 0.9999.  Conv biases that feed a BatchNorm have a
zero gradient up to rounding noise, and Adam's first steps move a
parameter by lr * sign(g): there the two packages may step in opposite
directions, so every parameter is held to 2.1 * lr per step and to 0.02 * lr
where its gradient is not noise.  In bfloat16 the rounding of every conv
input makes single leaves incomparable (the port's own gradient changes by
its whole norm under a 1e-7 change, and XLA's CPU conv rounds its output to
bfloat16 where the port keeps the float32 accumulator): over 3 frames the
loss is held to rtol 2e-3 and the statistics to 5e-2, and on a single frame,
without the recurrence, the whole gradient to a cosine of 0.9 (measured
0.96-0.98); the conv's own bfloat16 rounding points are held tightly in
tests/test_torch_layers.py.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ai_path_tracer_denoiser_tpu.config import ModelOptions as JaxModelOptions
from ai_path_tracer_denoiser_tpu.config import TrainOptions as JaxTrainOptions
from ai_path_tracer_denoiser_tpu.models import export as jax_export
from ai_path_tracer_denoiser_tpu.train import checkpoint as jax_ckpt
from ai_path_tracer_denoiser_tpu.train import trainer as jax_trainer
from ai_path_tracer_denoiser_tpu_torch.config import ModelOptions, TrainOptions
from ai_path_tracer_denoiser_tpu_torch.data import SequenceDataset, sequence_batches
from ai_path_tracer_denoiser_tpu_torch.models import (load_model, save_model,
                                                      train_state_from_numpy,
                                                      train_state_to_numpy)
from ai_path_tracer_denoiser_tpu_torch.models.export import (OPT_HEADER, sorted_leaves,
                                                             tree_from_leaves)
from ai_path_tracer_denoiser_tpu_torch.train import (checkpoint_epoch, fit, fit_device_data,
                                                     init_train_state, latest_checkpoint,
                                                     load_checkpoint, load_device_dataset,
                                                     recalibrate_bn, save_checkpoint, step_lr,
                                                     train_step)
from ai_path_tracer_denoiser_tpu_torch.train import device_data, trainer

torch.set_num_threads(2)
WIDTHS = (8, 8, 8, 8, 8)
JSMALL, SMALL = JaxModelOptions(widths=WIDTHS), ModelOptions(widths=WIDTHS)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(t=3, n=2, h=32, w=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(t, n, h, w, 10)).astype(np.float32)
    y = (rng.normal(size=(t, n, h, w, 3)) * 0.1 + 0.5).astype(np.float32)
    return x, y


def _carry(jstate):
    """The JAX train state as the port's, through ``train_state_from_numpy``."""
    return train_state_from_numpy(
        _np_tree(jstate.params), _np_tree(jstate.bn_state),
        [np.asarray(a) for a in jax.tree_util.tree_leaves(jstate.opt_state)],
        np.asarray(jstate.step), np.asarray(jstate.lr), device="cpu")


def _leaves(tree):
    return [np.asarray(leaf.detach().numpy() if isinstance(leaf, torch.Tensor) else leaf)
            for _, leaf in sorted_leaves(tree)]


def _cosine(a_leaves, b_leaves):
    a = np.concatenate([x.ravel() for x in a_leaves])
    b = np.concatenate([x.ravel() for x in b_leaves])
    return float(a @ b / np.linalg.norm(a) / np.linalg.norm(b))


def test_adam_update_matches_optax():
    rng = np.random.default_rng(0)
    params = {"b": {"w": rng.normal(size=(3, 4)).astype(np.float32)},
              "a": rng.normal(size=5).astype(np.float32)}
    opt = optax.inject_hyperparams(optax.adam)(learning_rate=1e-3)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = opt.init(jparams)
    tparams = {"b": {"w": torch.from_numpy(params["b"]["w"])}, "a": torch.from_numpy(params["a"])}
    tstate = trainer.init_opt_state(tparams)
    for step, lr in enumerate((1e-3, 1e-3, 2e-4)):
        grads = {"b": {"w": rng.normal(size=(3, 4)).astype(np.float32)},
                 "a": rng.normal(size=5).astype(np.float32) * 1e-3}
        jstate.hyperparams["learning_rate"] = jnp.asarray(lr, jnp.float32)
        updates, jstate = opt.update(jax.tree_util.tree_map(jnp.asarray, grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tgrads = {"b": {"w": torch.from_numpy(grads["b"]["w"])}, "a": torch.from_numpy(grads["a"])}
        new_params, tstate = trainer.adam_update(tparams, tgrads, tstate, lr)
        assert new_params["a"] is not tparams["a"]            # out of place
        tparams = new_params
        assert tstate["count"] == step + 1
        jl = [np.asarray(a) for a in jax.tree_util.tree_leaves(jstate)]
        for got, want in zip(_leaves(tparams), jax.tree_util.tree_leaves(jparams)):
            np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-7)
        for got, want in zip(_leaves(tstate["mu"]) + _leaves(tstate["nu"]), jl[OPT_HEADER:]):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-10)


def test_train_state_carries_across_in_jax_leaf_order():
    jstate = jax_trainer.init_train_state(jax.random.PRNGKey(0), JSMALL, JaxTrainOptions())
    x, y = _batch(t=2, n=1)
    jstate, _ = jax.jit(lambda s, a, b: jax_trainer.train_step(
        s, a, b, JaxTrainOptions(bf16_compute=False), model_options=JSMALL))(
            jstate, jnp.asarray(x), jnp.asarray(y))
    tstate = _carry(jstate)
    jleaves = [np.asarray(a) for a in jax.tree_util.tree_leaves(jstate.opt_state)]
    p = len(jax.tree_util.tree_leaves(jstate.params))
    assert len(jleaves) == OPT_HEADER + 2 * p and tstate.opt_state["count"] == 1
    assert tstate.step == 1 and abs(tstate.lr - 1e-3) < 1e-9
    # path by path: the port's sorted order is jax's flattening order
    jpaths = ["/".join(k.key for k in path)
              for path, _ in jax.tree_util.tree_flatten_with_path(jstate.params)[0]]
    assert ["/".join(path) for path, _ in sorted_leaves(tstate.params)] == jpaths
    params_np, bn_np, opt_np, step, lr = train_state_to_numpy(tstate)
    assert len(opt_np) == len(jleaves) and int(step) == 1
    for got, want in zip(opt_np, jleaves):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    for got, want in zip(_leaves(bn_np), jax.tree_util.tree_leaves(jstate.bn_state)):
        np.testing.assert_array_equal(got, np.asarray(want))
    with pytest.raises(ValueError, match="optimiser leaves"):
        train_state_from_numpy(params_np, bn_np, opt_np[:-1], 0, 1e-3, device="cpu")


def _jax_grads(jstate, x, y, jtopt):
    def f(p):
        return jax_trainer.loss_fn(p, jstate.bn_state, jnp.asarray(x), jnp.asarray(y), jtopt,
                                   jtopt.bf16_compute, None, JSMALL)
    (total, (metrics, new_bn)), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(jstate.params)
    return float(total), new_bn, grads


def test_train_step_matches_jax_float32():
    """Loss, every gradient leaf, BatchNorm statistics, every updated
    parameter and Adam moment after one step; three steps still agree."""
    jtopt, topt = JaxTrainOptions(bf16_compute=False), TrainOptions(bf16_compute=False)
    jstate = jax_trainer.init_train_state(jax.random.PRNGKey(0), JSMALL, jtopt)
    tstate = _carry(jstate)
    x, y = _batch()
    jtotal, jbn, jgrads = _jax_grads(jstate, x, y, jtopt)
    metrics, tbn, tgrads = trainer.loss_and_grads(tstate, torch.from_numpy(x),
                                                  torch.from_numpy(y), topt, SMALL)
    np.testing.assert_allclose(float(metrics["total"]), jtotal, rtol=1e-5)
    for got, want in zip(_leaves(tbn), jax.tree_util.tree_leaves(jbn)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)
    jg = [np.asarray(a) for a in jax.tree_util.tree_leaves(jgrads)]
    tg = _leaves(tgrads)
    noise = 1e-5 * max(np.abs(a).max() for a in jg)
    for (path, _), got, want in zip(sorted_leaves(tgrads), tg, jg):
        assert np.abs(got - want).max() <= 5e-2 * np.linalg.norm(want) + noise, "/".join(path)
    assert _cosine(tg, jg) > 0.9999

    jit_step = jax.jit(lambda s, a, b: jax_trainer.train_step(s, a, b, jtopt, model_options=JSMALL))
    lr = 1e-3
    for step in range(3):
        before = _leaves(tstate.params)
        jstate, jm = jit_step(jstate, jnp.asarray(x), jnp.asarray(y))
        tstate, tm = train_step(tstate, torch.from_numpy(x), torch.from_numpy(y), topt, SMALL)
        np.testing.assert_allclose(float(tm["total"]), float(jm["total"]), rtol=5e-3)
        assert tstate.step == step + 1 == int(jstate.step) == tstate.opt_state["count"]
        jp = [np.asarray(a) for a in jax.tree_util.tree_leaves(jstate.params)]
        for got, want, old in zip(_leaves(tstate.params), jp, before):
            assert np.abs(got - want).max() <= 2.1 * lr * (step + 1)
            assert np.abs(got - old).max() <= 1.01 * lr * 3.2     # Adam's bounded step
        if step == 0:
            jopt = [np.asarray(a) for a in jax.tree_util.tree_leaves(jstate.opt_state)]
            mu, nu = _leaves(tstate.opt_state["mu"]), _leaves(tstate.opt_state["nu"])
            for got, want, g in zip(mu, jopt[OPT_HEADER:OPT_HEADER + len(mu)], jg):
                assert np.abs(got - want).max() <= 0.1 * (5e-2 * np.linalg.norm(g) + noise)
            for got, want, g in zip(nu, jopt[OPT_HEADER + len(mu):], jg):
                np.testing.assert_allclose(got, want, rtol=0.2,
                                           atol=1e-3 * (0.1 * np.linalg.norm(g) + noise) ** 2 + 1e-12)
            # where the gradient is not rounding noise both packages take the same step
            for got, want, g in zip(_leaves(tstate.params), jp, jg):
                clear = np.abs(g) > 0.05 * np.abs(g).max()
                if np.abs(g).max() > 100 * noise and clear.any():
                    assert np.abs(got - want)[clear].max() <= 0.02 * lr
    # (after three steps the running variances of the 1x1 bottleneck, taken
    # over 2 values each, have drifted apart by up to 0.1: not compared)
    for got, want in zip(_leaves(tstate.bn_state), jax.tree_util.tree_leaves(jstate.bn_state)):
        assert got.shape == want.shape and np.isfinite(got).all()


def test_train_step_matches_jax_bfloat16():
    jtopt, topt = JaxTrainOptions(bf16_compute=True), TrainOptions(bf16_compute=True)
    jstate = jax_trainer.init_train_state(jax.random.PRNGKey(1), JSMALL, jtopt)
    tstate = _carry(jstate)
    x, y = _batch(seed=1)
    jtotal, jbn, jgrads = _jax_grads(jstate, x, y, jtopt)
    # inputs and targets arrive bfloat16, as the loaders ship them
    metrics, tbn, tgrads = trainer.loss_and_grads(
        tstate, torch.from_numpy(x).bfloat16(), torch.from_numpy(y), topt, SMALL)
    np.testing.assert_allclose(float(metrics["total"]), jtotal, rtol=2e-3)
    for got, want in zip(_leaves(tbn), jax.tree_util.tree_leaves(jbn)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=5e-2, atol=5e-2)
    assert all(np.isfinite(g).all() and g.dtype == np.float32 for g in _leaves(tgrads))
    x1, y1 = x[:1], y[:1]
    _, _, jgrads1 = _jax_grads(jstate, x1, y1, jtopt)
    _, _, tgrads1 = trainer.loss_and_grads(tstate, torch.from_numpy(x1).bfloat16(),
                                           torch.from_numpy(y1), topt, SMALL)
    assert _cosine(_leaves(tgrads1),
                   [np.asarray(a) for a in jax.tree_util.tree_leaves(jgrads1)]) > 0.9
    new_state, _ = train_step(tstate, torch.from_numpy(x).bfloat16(),
                              torch.from_numpy(y).bfloat16(), topt, SMALL)
    assert all(leaf.dtype == torch.float32 for _, leaf in sorted_leaves(new_state.params))


def test_zero_learning_rate_and_purity():
    topt = TrainOptions(bf16_compute=False)
    state = init_train_state(torch.Generator().manual_seed(0), SMALL, topt, device="cpu")
    before = [leaf.clone() for _, leaf in sorted_leaves(state.params)]
    x, y = _batch(t=2, n=1)
    frozen, _ = train_step(dataclasses.replace(state, lr=0.0), torch.from_numpy(x),
                           torch.from_numpy(y), topt, SMALL)
    moved, _ = train_step(state, torch.from_numpy(x), torch.from_numpy(y), topt, SMALL)
    n_moved = 0
    for (_, a), (_, b), (_, c), d in zip(sorted_leaves(frozen.params), sorted_leaves(moved.params),
                                         sorted_leaves(state.params), before):
        assert torch.equal(a, d) and torch.equal(c, d) and not a.requires_grad
        n_moved += not torch.equal(b, d)
    # (a leaf whose gradient is exactly zero stays: the norms after the 1x1
    # bottleneck of a single 32x32 sample see one value per channel)
    assert n_moved > 0.8 * len(before)
    assert state.step == 0 and state.opt_state["count"] == 0 and moved.step == 1


def test_checkpoints_cross_between_packages(tmp_path):
    """A JAX checkpoint resumes in the port; the port's resumes in JAX;
    ``next_epoch`` survives both ways, ``final`` included."""
    jtopt = JaxTrainOptions(bf16_compute=False)
    jstate = jax_trainer.init_train_state(jax.random.PRNGKey(0), JSMALL, jtopt)
    x, y = _batch(t=2, n=1)
    jit_step = jax.jit(lambda s, a, b: jax_trainer.train_step(s, a, b, jtopt, model_options=JSMALL))
    jstate, _ = jit_step(jstate, jnp.asarray(x), jnp.asarray(y))
    jpath = jax_ckpt.save_checkpoint(str(tmp_path / "jax"), jstate, 7)
    tstate = load_checkpoint(jpath, device="cpu")
    assert checkpoint_epoch(jpath) == 8 and tstate.step == 1 and tstate.opt_state["count"] == 1
    for got, want in zip(_leaves(tstate.params), jax.tree_util.tree_leaves(jstate.params)):
        np.testing.assert_array_equal(got, np.asarray(want))
    for got, want in zip(_leaves(tstate.opt_state["nu"]),
                         jax.tree_util.tree_leaves(jstate.opt_state.inner_state[0].nu)):
        np.testing.assert_array_equal(got, np.asarray(want))
    # one more step in each package from the checkpointed state
    jnext, jm = jit_step(jstate, jnp.asarray(x), jnp.asarray(y))
    tnext, tm = train_step(tstate, torch.from_numpy(x), torch.from_numpy(y),
                           TrainOptions(bf16_compute=False), SMALL)
    np.testing.assert_allclose(float(tm["total"]), float(jm["total"]), rtol=1e-4)
    # and back: the port's checkpoint in the JAX package
    tpath = save_checkpoint(str(tmp_path / "torch"), tnext, "final")
    assert os.path.basename(tpath) == "model_final.npz"
    assert jax_ckpt.checkpoint_epoch(tpath) == 2 ** 30 == checkpoint_epoch(tpath)
    with np.load(tpath) as a, np.load(jpath) as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(a[k].dtype == b[k].dtype and a[k].shape == b[k].shape for k in a.files)
    template = jax_trainer.init_train_state(jax.random.PRNGKey(1), JSMALL, jtopt)
    back = jax_ckpt.load_checkpoint(tpath, template)
    assert int(back.step) == 2 and int(back.opt_state.inner_state[0].count) == 2
    for got, want in zip(jax.tree_util.tree_leaves(back.params), _leaves(tnext.params)):
        np.testing.assert_array_equal(np.asarray(got), want)
    resumed, _ = jit_step(back, jnp.asarray(x), jnp.asarray(y))
    assert int(resumed.step) == 3 and np.isfinite(float(_["total"]))
    save_checkpoint(str(tmp_path / "torch"), tnext, 3)
    assert latest_checkpoint(str(tmp_path / "torch")) == tpath
    assert latest_checkpoint(str(tmp_path / "none")) is None


def test_exported_model_round_trips_both_ways(tmp_path):
    jstate = jax_trainer.init_train_state(jax.random.PRNGKey(2), JSMALL, JaxTrainOptions())
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "torch.npz")
    jax_export.save_model(jpath, jstate.params, jstate.bn_state, options=JSMALL)
    params, bn_state, meta = load_model(jpath, device="cpu")
    assert tuple(meta["widths"]) == WIDTHS and meta["norm"] == "batch"
    save_model(tpath, params, bn_state, options=ModelOptions(widths=WIDTHS, norm="group"))
    jp, js, jmeta = jax_export.load_model(tpath)
    assert jmeta == {"widths": list(WIDTHS), "norm": "group"}
    for got, want in zip(jax.tree_util.tree_leaves(jp), jax.tree_util.tree_leaves(jstate.params)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    for got, want in zip(jax.tree_util.tree_leaves(js), jax.tree_util.tree_leaves(jstate.bn_state)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    with np.load(jpath) as a, np.load(tpath) as b:
        assert sorted(a.files) == sorted(b.files)


def test_fit_samples_metrics_and_resumes_schedule():
    topt = TrainOptions(bf16_compute=False, checkpoint_every_epochs=1)
    state = init_train_state(torch.Generator().manual_seed(0), SMALL, topt, device="cpu")
    seen_epochs = []

    def data(epoch):
        seen_epochs.append(epoch)
        for seed in range(6):
            yield _batch(t=2, n=1, seed=100 * epoch + seed)

    class Cap:
        def __init__(self):
            self.steps = []

        def scalars(self, step, m):
            self.steps.append(step)
            assert set(m) >= {"total", "l1", "hfen", "temporal"}
            assert all(isinstance(v, float) for v in m.values())

    logger, ckpts = Cap(), []
    state = fit(state, data, topt, epochs=2, logger=logger, log_every=2,
                checkpoint_fn=lambda s, e: ckpts.append(e), model_options=SMALL)
    assert seen_epochs == [0, 1]
    # 6 steps/epoch, sampled at i=0,2,4 -> global steps 1,3,5 then 7,9,11
    assert logger.steps == [1, 3, 5, 7, 9, 11]
    assert ckpts == [0, 1, "final"] and state.step == 12
    topt2 = dataclasses.replace(topt, lr_step_epochs=1, lr_gamma=0.5)
    state2 = fit(state, data, topt2, epochs=3, logger=Cap(), model_options=SMALL,
                 start_epoch=2)
    np.testing.assert_allclose(state2.lr, 1e-3 * 0.25)
    assert seen_epochs == [0, 1, 2] and state2.step == 18
    assert step_lr(1e-3, 24) == 1e-3 and abs(step_lr(1e-3, 50) - 4e-5) < 1e-12


def _corpus(tmp_path, frames=12, res=64, dtype=np.float32):
    inp, gt = str(tmp_path / "input"), str(tmp_path / "gt")
    os.makedirs(inp)
    os.makedirs(gt)
    rng = np.random.default_rng(0)
    for f in range(frames):
        stem = f"0_0_0_{f:04d}.npy"
        a, b = rng.random((res, res, 10)), rng.random((res, res, 3))
        if dtype == np.uint8:
            a, b = a * 255, b * 255
        np.save(os.path.join(inp, stem), a.astype(dtype))
        np.save(os.path.join(gt, stem), b.astype(dtype))
    return inp, gt


def test_fit_device_data_draws_the_host_loaders_crops(tmp_path):
    inp, gt = _corpus(tmp_path)
    ds = SequenceDataset(inp, gt, None, crop=True, crop_size=32)
    X, Y, starts = load_device_dataset(ds, dtype=torch.float32, device="cpu")
    assert X.shape == (12, 64, 64, 10) and Y.shape == (12, 64, 64, 3)
    np.testing.assert_array_equal(X[3].numpy(), np.load(os.path.join(inp, "0_0_0_0003.npy")))
    epoch = 5
    host = list(sequence_batches(ds, batch_size=2, seed=epoch, workers=0))
    order = np.arange(len(ds))
    np.random.default_rng(epoch).shuffle(order)
    for b, (hx, hy) in enumerate(host):
        idxs = order[b * 2:(b + 1) * 2]
        cy, cx = device_data.epoch_crops(epoch, idxs, 64, 64, 32, 32)
        dx, dy = device_data._crop_batch(X, Y, starts[idxs].tolist(), cy, cx, 7, 32, 32)
        np.testing.assert_array_equal(dx.numpy(), hx)
        np.testing.assert_array_equal(dy.numpy(), hy)
    topt = TrainOptions(bf16_compute=False, batch_size=2, crop_size=32, checkpoint_every_epochs=1)
    state = init_train_state(torch.Generator().manual_seed(0), SMALL, topt, device="cpu")
    ckpts = []
    state = fit_device_data(state, ds, topt, epochs=1, checkpoint_fn=lambda s, e: ckpts.append(e),
                            model_options=SMALL, data=(X, Y, starts))
    assert state.step == 6 and ckpts == [0, "final"]


def test_device_dataset_decodes_u8_like_the_host_loader(tmp_path):
    inp, gt = _corpus(tmp_path, frames=7, res=32, dtype=np.uint8)
    ds = SequenceDataset(inp, gt, None)
    X, Y, starts = load_device_dataset(ds, dtype=torch.bfloat16, device="cpu")
    assert X.dtype == torch.uint8
    x, y = device_data._crop_batch(X, Y, [int(starts[0])], [0], [0], 7, 32, 32)
    x, y = device_data._decode_u8(x, y, torch.float32)
    hx, hy = ds[0]
    np.testing.assert_allclose(x[:, 0].numpy(), hx, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(y[:, 0].numpy(), hy, rtol=1e-6, atol=1e-6)
    np.save(os.path.join(inp, "0_0_0_0003.npy"), np.zeros((32, 32, 10), np.float32))
    with pytest.raises(ValueError, match="mixed-dtype"):
        load_device_dataset(SequenceDataset(inp, gt, None), device="cpu")


def test_recalibrate_bn_updates_stats_only():
    topt = TrainOptions(bf16_compute=False)
    state = init_train_state(torch.Generator().manual_seed(0), SMALL, topt, device="cpu")
    rng = np.random.default_rng(0)
    batches = [(rng.normal(size=(2, 1, 32, 32, 10)).astype(np.float32), None) for _ in range(3)]
    new = recalibrate_bn(state, batches, 2, topt, SMALL)
    for (_, a), (_, b) in zip(sorted_leaves(state.params), sorted_leaves(new.params)):
        assert a is b
    assert new.opt_state is state.opt_state
    assert any(not torch.equal(a, b) for (_, a), (_, b) in
               zip(sorted_leaves(state.bn_state), sorted_leaves(new.bn_state)))
    rebuilt = tree_from_leaves(state.bn_state, [leaf for _, leaf in sorted_leaves(state.bn_state)])
    assert list(rebuilt) == list(state.bn_state)
