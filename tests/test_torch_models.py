"""The port's denoiser against the JAX package's.

The conv kernel's plain version is held against the JAX Pallas kernel
(``conv3x3_act_chw(interpret=True)``) in float32; the whole BN-folded
network, loaded from the shipped artifact through ``params_from_numpy``,
against JAX ``apply_frame_fast(conv_impl="native")`` over 3 frames with
the hidden state carried.

Tolerances: float32 convs differ only in summation order (rtol 1e-4,
atol 1e-5); the float32 network to max abs 1e-3; the bfloat16 network
rounds activations at other places than XLA does, so it is compared by
relative L2 error < 2e-2.
"""
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_path_tracer_denoiser_tpu.models import conv_kernel as jax_conv
from ai_path_tracer_denoiser_tpu.models import inference as jax_inf
from ai_path_tracer_denoiser_tpu.models import init_hidden as jax_init_hidden
from ai_path_tracer_denoiser_tpu.models import load_model as jax_load_model
from ai_path_tracer_denoiser_tpu_torch.config import ModelOptions
from ai_path_tracer_denoiser_tpu_torch.models import (
    apply_frame_fast, apply_frame_fast_padded, apply_sequence_fast, init_autoencoder,
    init_hidden, load_model, params_from_numpy, prepare_inference)
from ai_path_tracer_denoiser_tpu_torch.models import conv_kernel, inference
from ai_path_tracer_denoiser_tpu_torch.models.inference import _conv_act

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parent.parent
MODEL = str(REPO / "artifacts" / "denoiser_multiscene.npz")


def _conv_inputs(h, w, c, co, seed):
    r = np.random.default_rng(seed)
    x = r.normal(size=(h, w, c)).astype(np.float32)
    wt = (r.normal(size=(3, 3, c, co)) * (2.0 / (9 * c)) ** 0.5).astype(np.float32)
    b = r.normal(size=co).astype(np.float32) * 0.1
    aff = {"s": r.uniform(0.5, 2.0, co).astype(np.float32),
           "t": r.normal(size=co).astype(np.float32) * 0.1}
    return x, wt, b, aff


@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("h,w,c,co", [(16, 24, 10, 32), (8, 8, 202, 76),
                                      (16, 16, 64, 3)])
def test_plain_conv_matches_pallas_kernel_f32(h, w, c, co, affine):
    x, wt, b, aff = _conv_inputs(h, w, c, co, seed=h + c + co)
    aff = aff if affine else None
    want = np.asarray(jax_conv.conv3x3_act_chw(
        jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b), 0.1,
        affine=None if aff is None else {k: jnp.asarray(v) for k, v in aff.items()},
        interpret=True))
    got = conv_kernel.conv3x3_act_chw(
        torch.from_numpy(x), torch.from_numpy(wt), torch.from_numpy(b), 0.1,
        affine=None if aff is None else {k: torch.from_numpy(v) for k, v in aff.items()})
    assert got.dtype == torch.float32 and got.shape == (h, w, co)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_conv_act_bf16_matches_native():
    """bfloat16 in and out, float32 accumulation: at most one bfloat16
    rounding step apart from XLA's native conv."""
    x, wt, b, aff = _conv_inputs(32, 32, 43, 57, seed=3)
    jconv = {"w": jnp.asarray(wt).astype(jnp.bfloat16), "b": jnp.asarray(b)}
    want = jax_inf._conv_act(jconv, jnp.asarray(x)[None], 0.1, jnp.bfloat16,
                             impl="native",
                             affine={k: jnp.asarray(v) for k, v in aff.items()})
    want = np.asarray(want.astype(jnp.float32))[0]
    tconv = {"w": torch.from_numpy(wt).bfloat16(), "b": torch.from_numpy(b)}
    got = _conv_act(tconv, torch.from_numpy(x)[None], 0.1, torch.bfloat16,
                    impl="pallas", affine={k: torch.from_numpy(v) for k, v in aff.items()})
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got[0].float().numpy(), want, rtol=1.6e-2, atol=1e-2)
    with pytest.raises(ValueError):
        _conv_act(tconv, torch.from_numpy(x)[None], 0.1, torch.bfloat16, impl="nope")


def _frames(n, h, w, seed=0):
    """G-buffer-like NHWC frames: radiance, unit normals, depth, albedo."""
    r = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        rgb = r.gamma(0.5, 0.4, (1, h, w, 3))
        nrm = r.normal(size=(1, h, w, 3))
        nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
        depth = r.uniform(2, 20, (1, h, w, 1))
        alb = r.uniform(0, 1, (1, h, w, 3))
        out.append(np.concatenate([rgb, nrm, depth, alb], -1).astype(np.float32))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_denoiser_matches_jax_over_frames(dtype):
    jp, js, meta = jax_load_model(MODEL)
    mopts = ModelOptions(widths=tuple(meta["widths"]))
    tp, ts = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                               jax.tree_util.tree_map(np.asarray, js), device="cpu")
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jfold = jax_inf.prepare_inference(jp, js, compute_dtype=jdt)
    tfold = prepare_inference(tp, ts, mopts, compute_dtype=tdt)
    jh = jax_init_hidden(1, 64, 64, dtype=jdt)
    th = init_hidden(1, 64, 64, mopts, dtype=tdt)
    jax_frame = jax.jit(lambda x_, h_: jax_inf.apply_frame_fast(
        jfold, x_, h_, compute_dtype=jdt, conv_impl="native"))
    for x in _frames(3, 64, 64):
        jy, jh = jax_frame(jnp.asarray(x), jh)
        ty, th = apply_frame_fast(tfold, torch.from_numpy(x), th, mopts,
                                  compute_dtype=tdt)
        jy, ty = np.asarray(jy), ty.numpy()
        assert ty.shape == (1, 64, 64, 3) and np.isfinite(ty).all()
        if dtype == "float32":
            assert np.abs(ty - jy).max() < 1e-3
        else:
            rel = np.linalg.norm(ty - jy) / np.linalg.norm(jy)
            assert rel < 2e-2, rel
    for k in th:
        assert th[k].dtype == tdt and th[k].shape == tuple(jh[k].shape)


def test_load_model_and_padded_apply():
    params, bn_state, meta = load_model(MODEL, device="cpu")
    assert meta["norm"] == "batch"
    assert params["enc1"]["conv1"]["w"].shape == (3, 3, 10, 32)
    mopts = ModelOptions()
    folded = prepare_inference(params, bn_state, mopts)
    assert folded["enc2"]["conv1"]["w"].dtype == torch.bfloat16
    assert folded["enc2"]["affine2"]["s"].dtype == torch.float32
    x = torch.from_numpy(_frames(1, 40, 50)[0])
    hidden = init_hidden(1, 64, 64, mopts, dtype=torch.bfloat16)
    y, hidden = apply_frame_fast_padded(folded, x, hidden, mopts)
    assert y.shape == (1, 40, 50, 3) and torch.isfinite(y).all()
    assert hidden["enc1"].shape == (1, 64, 64, 32)
    # the same network with its channels padded to multiples of 16: the
    # bfloat16 bar of the whole network (relative L2 < 2e-2), padded
    # hidden lanes exactly zero
    padded = prepare_inference(params, bn_state, mopts, pad_multiple=16)
    assert padded["enc2"]["conv1"]["w"].shape == (3, 3, 32, 48)
    assert padded["dec1"]["conv1"]["w"].shape == (3, 3, 64, 3)       # 3 out stays
    pad_opts = ModelOptions(widths=(32, 48, 64, 80, 112))
    hp = init_hidden(1, 64, 64, pad_opts, dtype=torch.bfloat16)
    h0 = init_hidden(1, 64, 64, mopts, dtype=torch.bfloat16)
    for frame in _frames(2, 40, 50):
        yp, hp = apply_frame_fast_padded(padded, torch.from_numpy(frame), hp, pad_opts)
        y0, h0 = apply_frame_fast_padded(folded, torch.from_numpy(frame), h0, mopts)
        assert yp.shape == (1, 40, 50, 3) and torch.isfinite(yp).all()
        rel = float(torch.linalg.norm(yp - y0) / torch.linalg.norm(y0))
        assert rel < 2e-2, rel
        for k, c in zip(("enc2", "enc3", "enc4", "enc5"), (43, 57, 76, 101)):
            assert not hp[k][..., c:].any(), k


def test_random_init_tree_matches_jax_shapes():
    from ai_path_tracer_denoiser_tpu.models import init_autoencoder as jax_init
    jp, js = jax_init(jax.random.PRNGKey(0))
    tp, ts = init_autoencoder(torch.Generator().manual_seed(0))
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in flat_j:
        node = tp
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape
    assert set(ts) == set(js)



def test_conv_impl_names_route_to_the_two_kernels(monkeypatch):
    """"pallas" goes through ``conv3x3_act`` (the row-band kernel's wrapper),
    every other name through ``conv3x3_act_chw``, whatever the height."""
    seen = []
    for name in ("conv3x3_act", "conv3x3_act_chw"):
        orig = getattr(inference, name)
        monkeypatch.setattr(inference, name, lambda *a, _n=name, _o=orig, **k:
                            seen.append(_n) or _o(*a, **k))
    x, wt, b, _ = _conv_inputs(6, 10, 4, 5, seed=1)         # a height no band of 8 divides
    conv = {"w": torch.from_numpy(wt), "b": torch.from_numpy(b)}
    outs = {impl: _conv_act(conv, torch.from_numpy(x)[None], 0.1, torch.float32, impl=impl)
            for impl in inference.CONV_IMPLS}
    assert seen == ["conv3x3_act" if impl == "pallas" else "conv3x3_act_chw"
                    for impl in inference.CONV_IMPLS]
    for impl, y in outs.items():
        assert y.shape == (1, 6, 10, 5)
        np.testing.assert_allclose(y.numpy(), outs["auto"].numpy(), rtol=1e-4, atol=1e-5)


def test_whole_network_agrees_between_conv_impls_and_sequence_helper():
    params, bn_state, _ = load_model(MODEL, device="cpu")
    mopts = ModelOptions()
    folded = prepare_inference(params, bn_state, mopts, compute_dtype=torch.float32)
    frames = _frames(2, 32, 32, seed=4)
    x_seq = torch.from_numpy(np.stack(frames))                         # (T, 1, H, W, 10)
    ys = {impl: apply_sequence_fast(folded, x_seq, mopts, torch.float32, conv_impl=impl)
          for impl in ("pallas2", "pallas")}
    assert ys["pallas"].shape == (2, 1, 32, 32, 3)
    np.testing.assert_allclose(ys["pallas"].numpy(), ys["pallas2"].numpy(), rtol=1e-3, atol=1e-4)
    hidden = init_hidden(1, 32, 32, mopts, dtype=torch.float32)
    for t, x in enumerate(frames):
        y, hidden = apply_frame_fast(folded, torch.from_numpy(x), hidden, mopts,
                                     compute_dtype=torch.float32, conv_impl="pallas2")
        assert torch.equal(y, ys["pallas2"][t])


# The bfloat16 tile kernel reads its weights in the packed layout of
# ``pack_weights_sm90``: the conv computed from that layout
# (``conv3x3_act_packed_plain``) is held against the JAX Pallas kernel in
# interpret mode, float32, at the tolerance of the plain conv above; every
# padding case of input (to 16) and output channels (to 8) is covered.
@pytest.mark.parametrize("co", [3, 32, 101])
@pytest.mark.parametrize("c", [3, 10, 43, 202])
def test_packed_weights_conv_matches_pallas_kernel(c, co):
    h, w = 8, 6
    x, wt, b, aff = _conv_inputs(h, w, c, co, seed=3 * c + co)
    want = np.asarray(jax_conv.conv3x3_act_chw(
        jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b), 0.1,
        affine={k: jnp.asarray(v) for k, v in aff.items()}, interpret=True))
    tw = torch.from_numpy(wt)
    plan = conv_kernel.conv_plan(1, h, w, co)
    wp = conv_kernel.pack_weights_sm90(tw, plan.n_cols)
    assert wp.shape == (-(-c // 16), 9, plan.n_cols // 8, 2, 8, 8)
    assert torch.equal(conv_kernel.unpack_weights_sm90(wp, c, co), tw)
    # zero past C and past Co
    full = conv_kernel.unpack_weights_sm90(wp, 16 * wp.shape[0], plan.n_cols)
    assert not full[:, :, c:].any() and not full[:, :, :, co:].any()
    got = conv_kernel.conv3x3_act_packed_plain(
        torch.from_numpy(x), wp, torch.from_numpy(b), 0.1,
        affine={k: torch.from_numpy(v) for k, v in aff.items()})
    assert got.dtype == torch.float32 and got.shape == (h, w, co)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


FRAME_CONVS = [(800, 10, 32), (800, 64, 32), (800, 32, 32), (400, 32, 43), (400, 86, 43),
               (400, 43, 43), (200, 43, 57), (200, 114, 57), (200, 57, 57), (100, 57, 76),
               (100, 152, 76), (100, 76, 76), (50, 76, 101), (50, 202, 101), (50, 101, 101),
               (25, 101, 101), (25, 202, 101), (50, 202, 76), (50, 76, 76), (100, 152, 57),
               (100, 57, 57), (200, 114, 43), (200, 43, 43), (400, 86, 32), (400, 32, 32),
               (800, 64, 3), (800, 3, 3)]


@pytest.mark.parametrize("r,c,co", FRAME_CONVS)
def test_conv_plan_fills_the_card_and_reads_the_input_once(r, c, co):
    """Each of an 800x800 frame's conv shapes (forward, and its input
    gradient c <-> co) launches at least one block per SM; a block covers
    every output channel (N = Co rounded up to 8) unless the image is too
    small to fill the card with pixel tiles alone."""
    for cout in (co, c):
        plan = conv_kernel.conv_plan(1, r, r, cout)
        assert plan.blocks >= conv_kernel.SMS
        assert plan.tw * plan.th == 64 * plan.nwg
        assert plan.n_cols >= cout and plan.nb in conv_kernel.BLOCK_GROUPS
        tiles = plan.blocks // plan.groups
        if tiles >= conv_kernel.SMS:
            assert plan.groups == 1 and plan.n_cols == -(-cout // 8) * 8


@pytest.mark.parametrize("r,c,co", FRAME_CONVS)
def test_rows_plan_fills_the_card_and_fits_the_sm(r, c, co):
    """The row-band kernel's launch at each of an 800x800 frame's forward
    conv shapes: at least ``ROWS_FILL`` blocks; a block covers every output
    channel unless the bands alone are fewer; a band's two warpgroups run
    64-pixel rows (two rows each only up to 32 channels, where the 4-row
    bands fill the card); and the dynamic shared memory fits a block, two
    of them at 400x400 and 800x800."""
    plan = conv_kernel.rows_plan(1, r, r, c, co)
    assert plan.blocks >= conv_kernel.ROWS_FILL
    assert plan.nb in conv_kernel.BLOCK_GROUPS and plan.n_cols >= co
    assert plan.mt in (1, 2) and plan.th == 2 * plan.mt
    assert plan.mt == 1 or plan.nb <= 4
    assert plan.mt == 2 or co > 32
    bands = plan.blocks // plan.groups
    assert bands == -(-r // 64) * -(-r // plan.th)
    if bands >= conv_kernel.ROWS_FILL:
        assert plan.groups == 1 and plan.n_cols == -(-co // 8) * 8
    assert plan.smem <= 232448
    if r >= 400:                # the large layers: two blocks on an SM at least
        assert 2 * plan.smem <= 232448



@pytest.mark.parametrize("multiple", [8, 16])
def test_pad_channels_matches_jax_leaf_for_leaf(multiple):
    """``pad_channels`` on a network with odd widths folded by JAX and
    carried across: every padded leaf equal to JAX's, bit for bit.
    ``prepare_inference(pad_multiple=)`` on parameters carried across by
    ``params_from_numpy``: the same shapes and dtypes as JAX's, the values
    within the fold's last-bit difference (float32) rounded to bfloat16."""
    from ai_path_tracer_denoiser_tpu.config import ModelOptions as JaxModelOptions
    from ai_path_tracer_denoiser_tpu.models import init_autoencoder as jax_init
    widths = (5, 7, 9, 11, 13)
    # the JAX tree's shapes, filled from a numpy seed (running statistics
    # away from (0, 1), so the fold is not the identity)
    shapes = jax.eval_shape(lambda k: jax_init(k, JaxModelOptions(widths=widths)),
                            jax.random.PRNGKey(3))
    r = np.random.default_rng(3)
    jp, js = (jax.tree_util.tree_map(lambda a: jnp.asarray(
        r.uniform(lo, 2.0, a.shape).astype(np.float32)), tree)
        for lo, tree in ((-1.0, shapes[0]), (0.5, shapes[1])))
    folded = jax_inf.fold_batchnorm(jp, js)
    jpad = jax_inf.pad_channels(folded, multiple)
    tpad = inference.pad_channels(jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a)), folded), multiple)
    jleaves = jax.tree_util.tree_flatten_with_path(jpad)[0]
    assert len(jleaves) == sum(len(leaf) for blk in tpad.values() for leaf in blk.values())
    for path, want in jleaves:
        got = tpad[path[0].key][path[1].key][path[2].key]
        assert tuple(got.shape) == want.shape, path
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    up = -(-13 // multiple) * multiple
    assert tpad["enc5"]["conv2"]["w"].shape == (3, 3, 2 * up, up)
    assert tpad["dec1"]["conv2"]["w"].shape == (3, 3, 3, 3)
    mopts = ModelOptions(widths=widths)
    tp, ts = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                               jax.tree_util.tree_map(np.asarray, js), device="cpu")
    jprep = jax_inf.prepare_inference(jp, js, pad_multiple=multiple)
    tprep = prepare_inference(tp, ts, mopts, pad_multiple=multiple)
    for path, want in jax.tree_util.tree_flatten_with_path(jprep)[0]:
        got = tprep[path[0].key][path[1].key][path[2].key]
        bf16 = path[-1].key == "w"
        assert got.dtype == (torch.bfloat16 if bf16 else torch.float32)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=2 ** -8 if bf16 else 1e-6, atol=0)
