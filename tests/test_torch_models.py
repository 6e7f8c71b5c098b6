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
    apply_frame_fast, apply_frame_fast_padded, init_autoencoder, init_hidden,
    load_model, params_from_numpy, prepare_inference)
from ai_path_tracer_denoiser_tpu_torch.models import conv_kernel
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
    with pytest.raises(NotImplementedError):
        prepare_inference(params, bn_state, mopts, pad_multiple=16)


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

