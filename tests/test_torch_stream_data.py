"""The port's host-streamed sharded trainer (``train/stream_data.py``) on
the CPU, against the port's device-resident fit and the JAX package's
``fit_streamed``.

- ``group_ranges`` and ``shard_plan`` equal JAX's on one corpus;
- a single-shard streamed fit equals ``fit_device_data`` bit for bit
  (float32 and a u8 corpus);
- a multi-shard fit trains every window once per epoch;
- against JAX ``fit_streamed`` in float32 from a carried-across state: every
  step's batch equal bit for bit, and every step, taken by the port from
  JAX's state before it, held to the training bars of
  tests/test_torch_train.py (loss rtol 1e-5, gradient leaves 5e-2 of their
  norm, parameters 2.1 lr and 0.02 lr where the gradient is not noise);
  the two whole fits: the first loss to rtol 1e-5, later losses to 5e-3,
  every parameter to 2.1 lr per step.
"""
import numpy as np
import pytest
import torch

from ai_path_tracer_denoiser_tpu.data.dataset import SequenceDataset as JaxSequenceDataset
from ai_path_tracer_denoiser_tpu.train import stream_data as jax_stream
from ai_path_tracer_denoiser_tpu_torch.config import ModelOptions, TrainOptions
from ai_path_tracer_denoiser_tpu_torch.data import SequenceDataset
from ai_path_tracer_denoiser_tpu_torch.models.export import sorted_leaves
from ai_path_tracer_denoiser_tpu_torch.train import fit_device_data, init_train_state
from ai_path_tracer_denoiser_tpu_torch.train import device_data
from ai_path_tracer_denoiser_tpu_torch.train.stream_data import (fit_streamed, group_ranges,
                                                                 shard_plan)

torch.set_num_threads(2)
WIDTHS = (8, 8, 8, 8, 8)


def write_corpus(root, scenes=2, movs=1, seeds=2, frames=6, res=64, dtype=np.float32):
    """(scene, mov, noise, frame) npy pairs from a numpy seed."""
    rng = np.random.default_rng(0)
    (root / "input").mkdir(parents=True)
    (root / "gt").mkdir()
    for s in range(scenes):
        for mv in range(movs):
            for nz in range(seeds):
                for f in range(frames):
                    name = f"{s:03d}_{mv}_{nz}_{f:04d}.npy"
                    x, y = rng.random((res, res, 10)), rng.random((res, res, 3))
                    if dtype == np.uint8:
                        x, y = x * 255, y * 255
                    np.save(root / "input" / name, x.astype(dtype))
                    np.save(root / "gt" / name, y.astype(dtype))
    return str(root / "input"), str(root / "gt")


def _opts(**kw):
    topt = TrainOptions(batch_size=2, sequence_length=3, crop_size=32, bf16_compute=False,
                        epochs=1, checkpoint_every_epochs=10, **kw)
    return topt, ModelOptions(widths=WIDTHS)


def _state(topt, mopt):
    return init_train_state(torch.Generator().manual_seed(0), mopt, topt, device="cpu")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    inp, gt = write_corpus(tmp_path_factory.mktemp("stream"))
    return inp, gt


@pytest.mark.parametrize("max_frames", [6, 7, 12, 13, 24])
def test_group_ranges_and_shard_plan_equal_jax(corpus, max_frames):
    ds = SequenceDataset(*corpus, None, sequence_length=3)
    jds = JaxSequenceDataset(*corpus, None, sequence_length=3)
    assert group_ranges(ds) == jax_stream.group_ranges(jds) == [(0, 6), (6, 12), (12, 18),
                                                                (18, 24)]
    assert shard_plan(ds, max_frames) == jax_stream.shard_plan(jds, max_frames)
    with pytest.raises(ValueError, match="shard capacity"):
        shard_plan(ds, 5)


@pytest.mark.parametrize("dtype", [np.float32, np.uint8], ids=["float32", "u8"])
def test_single_shard_equals_fit_device_data(tmp_path, dtype):
    inp, gt = write_corpus(tmp_path, scenes=1, frames=5, dtype=dtype)
    ds = SequenceDataset(inp, gt, None, sequence_length=3, crop=True, crop_size=32)
    topt, mopt = _opts()
    a = fit_device_data(_state(topt, mopt), ds, topt, epochs=2, model_options=mopt)
    timings = []
    b = fit_streamed(_state(topt, mopt), ds, topt, epochs=2, model_options=mopt,
                     shard_frames=len(ds), timings=timings)
    assert a.step == b.step == 2 * (len(ds) // 2)
    for (pa, la), (pb, lb) in zip(sorted_leaves(a.params), sorted_leaves(b.params)):
        assert pa == pb and torch.equal(la, lb), pa
    for (_, la), (_, lb) in zip(sorted_leaves(a.bn_state), sorted_leaves(b.bn_state)):
        assert torch.equal(la, lb)
    assert [t["shard"] for t in timings] == [0, 0] and timings[0]["steps"] == len(ds) // 2


def test_multi_shard_trains_every_window_once(corpus, monkeypatch):
    """24 frames in 4 groups of 6, shards of one group: 3 steps per shard,
    every item once per epoch, the shard order reshuffled per epoch, the
    two buffers reused."""
    ds = SequenceDataset(*corpus, None, sequence_length=3, crop=True, crop_size=32)
    topt, mopt = _opts()
    seen = []
    orig = device_data.epoch_crops
    monkeypatch.setattr(device_data, "epoch_crops", lambda epoch, idxs, *a: seen.append(
        (epoch, [int(i) for i in idxs])) or orig(epoch, idxs, *a))
    timings, ckpts = [], []
    out = fit_streamed(_state(topt, mopt), ds, topt, epochs=2, model_options=mopt,
                       shard_frames=6, timings=timings,
                       checkpoint_fn=lambda s, e: ckpts.append(e))
    assert out.step == 2 * 12 and ckpts == [0, "final"]
    for epoch in (0, 1):
        items = sorted(i for e, idxs in seen if e == epoch for i in idxs)
        assert items == list(range(24)), epoch
        order = [t["shard"] for t in timings[4 * epoch:4 * epoch + 4]]
        assert order == [int(i) for i in np.random.default_rng(epoch).permutation(4)]
    # a shard's batches are its own items, in rng([epoch, shard]) order
    first = timings[0]["shard"]
    perm = np.random.default_rng([0, first]).permutation(6) + 6 * first
    assert [i for _, idxs in seen[:3] for i in idxs] == perm.tolist()
    assert all(np.isfinite(leaf.numpy()).all() for _, leaf in sorted_leaves(out.params))


def test_mixed_dtype_corpus_is_refused(tmp_path):
    inp, gt = write_corpus(tmp_path, scenes=1, seeds=2, frames=4)
    np.save(f"{inp}/000_0_1_0002.npy", np.zeros((64, 64, 10), np.uint8))
    ds = SequenceDataset(inp, gt, None, sequence_length=3, crop=True, crop_size=32)
    topt, mopt = _opts()
    with pytest.raises(ValueError, match="mixed-dtype"):
        fit_streamed(_state(topt, mopt), ds, topt, model_options=mopt, shard_frames=4)


def test_streamed_fit_meets_the_training_bars_against_jax(tmp_path, monkeypatch):
    """Two shards of one group each, 4 steps, float32: the JAX state
    carried across (``train_state_from_numpy``), both fits logging every
    step.  Each fit's train steps are recorded (JAX's through a debug
    callback inside its jitted step): the batches must be equal bit for
    bit, so both fits read the same windows from the same shard slots, and
    each of JAX's steps, retaken by the port from JAX's state before it, is
    held to the one-step bars of tests/test_torch_train.py."""
    import jax
    import jax.numpy as jnp

    from ai_path_tracer_denoiser_tpu.config import ModelOptions as JaxModelOptions
    from ai_path_tracer_denoiser_tpu.config import TrainOptions as JaxTrainOptions
    from ai_path_tracer_denoiser_tpu.train import trainer as jax_trainer
    from ai_path_tracer_denoiser_tpu_torch.models import train_state_from_numpy
    from ai_path_tracer_denoiser_tpu_torch.train import trainer
    topt, mopt = _opts()
    jtopt = JaxTrainOptions(batch_size=2, sequence_length=3, crop_size=32,
                            bf16_compute=False, epochs=1, checkpoint_every_epochs=10)
    jmopt = JaxModelOptions(widths=WIDTHS)
    jstate = jax_trainer.init_train_state(jax.random.PRNGKey(0), jmopt, jtopt)
    np_tree = lambda t: jax.tree_util.tree_map(np.array, t)   # noqa: E731

    def carry(js):
        return train_state_from_numpy(
            np_tree(js.params), np_tree(js.bn_state),
            [np.asarray(a) for a in jax.tree_util.tree_leaves(js.opt_state)],
            np.asarray(js.step), np.asarray(js.lr), device="cpu")

    class Losses:
        def __init__(self):
            self.total = {}

        def scalars(self, step, m):
            self.total[step] = float(m["total"])

    jsteps, tsteps = [], []
    jax_step, port_step = jax_stream.train_step, device_data.train_step

    def jax_spy(state, x, y, jt, model_options=None):
        jax.debug.callback(lambda *a: jsteps.append(np_tree(a)), state, x, y, ordered=True)
        return jax_step(state, x, y, jt, model_options=model_options)

    def port_spy(state, x, y, t, m):
        tsteps.append((x.numpy().copy(), y.numpy().copy()))
        return port_step(state, x, y, t, m)

    monkeypatch.setattr(jax_stream, "train_step", jax_spy)
    monkeypatch.setattr(device_data, "train_step", port_spy)
    jlog, tlog = Losses(), Losses()
    corpus = write_corpus(tmp_path, scenes=2, seeds=1, frames=4)
    jds = JaxSequenceDataset(*corpus, None, sequence_length=3, crop=True, crop_size=32)
    ds = SequenceDataset(*corpus, None, sequence_length=3, crop=True, crop_size=32)
    # 2 groups of 4 frames, shards of 4: 2 shards, 4 steps of batch 2
    jout = jax_stream.fit_streamed(jstate, jds, jtopt, epochs=1, shard_frames=4,
                                   logger=jlog, log_every=1, model_options=jmopt)
    tout = fit_streamed(carry(jstate), ds, topt, epochs=1, shard_frames=4, logger=tlog,
                        log_every=1, model_options=mopt)
    jax.effects_barrier()
    assert tout.step == int(jout.step) == 4 and len(jsteps) == len(tsteps) == 4
    assert sorted(tlog.total) == sorted(jlog.total) == [1, 2, 3, 4]
    np.testing.assert_allclose(tlog.total[1], jlog.total[1], rtol=1e-5)
    for k in tlog.total:
        np.testing.assert_allclose(tlog.total[k], jlog.total[k], rtol=5e-3)
    jp = [np.asarray(a) for a in jax.tree_util.tree_leaves(jout.params)]
    for (path, got), want in zip(sorted_leaves(tout.params), jp):
        assert np.abs(got.numpy() - want).max() <= 2.1 * topt.lr * 4, "/".join(path)

    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, bn, x, y: jax_trainer.loss_fn(p, bn, x, y, jtopt, False, None, jmopt),
        has_aux=True))
    afters = [s for s, _, _ in jsteps[1:]] + [np_tree(jout)]
    for k, ((before, jx, jy), (tx, ty), after) in enumerate(zip(jsteps, tsteps, afters)):
        np.testing.assert_array_equal(tx, jx, err_msg=f"step {k} inputs")
        np.testing.assert_array_equal(ty, jy, err_msg=f"step {k} targets")
        (jtotal, _), jgrads = grad_fn(before.params, before.bn_state, jnp.asarray(jx),
                                      jnp.asarray(jy))
        x, y = torch.from_numpy(jx), torch.from_numpy(jy)
        metrics, _, tgrads = trainer.loss_and_grads(carry(before), x, y, topt, mopt)
        np.testing.assert_allclose(float(metrics["total"]), float(jtotal), rtol=1e-5)
        jg = [np.asarray(a) for a in jax.tree_util.tree_leaves(jgrads)]
        noise = 1e-5 * max(np.abs(a).max() for a in jg)
        for (path, got), want in zip(sorted_leaves(tgrads), jg):
            assert np.abs(got.numpy() - want).max() <= 5e-2 * np.linalg.norm(want) + noise, \
                (k, "/".join(path))
        stepped, _ = port_step(carry(before), x, y, topt, mopt)
        lr = float(before.lr)
        jp = [np.asarray(a) for a in jax.tree_util.tree_leaves(after.params)]
        for (path, got), want, g in zip(sorted_leaves(stepped.params), jp, jg):
            got = got.numpy()
            assert np.abs(got - want).max() <= 2.1 * lr, (k, "/".join(path))
            # where the gradient is not rounding noise both packages take the same step
            clear = np.abs(g) > 0.05 * np.abs(g).max()
            if np.abs(g).max() > 100 * noise and clear.any():
                assert np.abs(got - want)[clear].max() <= 0.02 * lr, (k, "/".join(path))
