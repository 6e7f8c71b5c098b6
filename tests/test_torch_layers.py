"""The port's train-graph layers against the JAX package's, on the CPU.

Inputs come from a numpy seed and go through both packages.  Where the JAX
function reaches a Pallas kernel it runs in interpret mode.

Tolerances: float32 convs differ only in summation order (rtol 1e-4, atol
1e-5, as tests/test_torch_models.py).  The conv's gradients under bfloat16
round at the same three places in both packages (the output gradient, the
input gradient, the weight gradient), so they agree to one bfloat16
rounding step (rtol 1.6e-2 of the value, atol 1e-2 of the tensor's largest
entry).  BatchNorm's variance is E[x^2] - E[x]^2 in float32 in both
packages, but the sums are taken in another order: atol 2e-5 on normalised
values.  The whole random-initialised network amplifies such last-bit
differences through its 33 norms and the recurrence (measured 4e-4 after 3
frames), so its train-mode outputs are held to atol 3e-3.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ai_path_tracer_denoiser_tpu.config import ModelOptions as JaxModelOptions
from ai_path_tracer_denoiser_tpu.models import autoencoder as jax_ae
from ai_path_tracer_denoiser_tpu.models import conv_kernel as jax_conv
from ai_path_tracer_denoiser_tpu.models import layers as jax_layers
from ai_path_tracer_denoiser_tpu_torch.config import ModelOptions
from ai_path_tracer_denoiser_tpu_torch.models import (apply_frame, apply_sequence,
                                                      conv_kernel, init_hidden, layers,
                                                      param_count, params_from_numpy)
from ai_path_tracer_denoiser_tpu_torch.models.export import sorted_leaves, tree_from_leaves

torch.set_num_threads(2)
SMALL = (8, 8, 8, 8, 8)


def _conv_inputs(h, w, c, co, seed, n=None):
    r = np.random.default_rng(seed)
    shape = (h, w, c) if n is None else (n, h, w, c)
    x = r.normal(size=shape).astype(np.float32)
    wt = (r.normal(size=(3, 3, c, co)) * (2.0 / (9 * c)) ** 0.5).astype(np.float32)
    b = r.normal(size=co).astype(np.float32) * 0.1
    aff = {"s": r.uniform(0.5, 2.0, co).astype(np.float32),
           "t": r.normal(size=co).astype(np.float32) * 0.1}
    return x, wt, b, aff


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree))


def _j(tree):
    if isinstance(tree, dict):
        return {k: _j(v) for k, v in tree.items()}
    return jnp.asarray(tree)


# ---------------------------------------------------------------------------
# The row-band conv kernel's plain version vs the Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("h,w,ci,co", [(16, 24, 10, 32), (32, 32, 64, 32), (16, 16, 32, 3)])
def test_rows_plain_matches_pallas_kernel_f32(h, w, ci, co, affine):
    x, wt, b, aff = _conv_inputs(h, w, ci, co, seed=h + ci + co)
    aff = aff if affine else None
    want = np.asarray(jax_conv.conv3x3_act(
        jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b), 0.1,
        affine=None if aff is None else _j(aff), interpret=True))
    got = conv_kernel.conv3x3_act(torch.from_numpy(x), torch.from_numpy(wt),
                                  torch.from_numpy(b), 0.1,
                                  affine=None if aff is None else _t(aff))
    assert got.dtype == torch.float32 and got.shape == (h, w, co)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    # the two plain versions are two decompositions of one function
    np.testing.assert_allclose(
        got.numpy(), conv_kernel.conv3x3_act_plain(
            torch.from_numpy(x), torch.from_numpy(wt), torch.from_numpy(b), 0.1,
            None if aff is None else _t(aff)).numpy(), rtol=1e-4, atol=1e-5)


def test_rows_pre_padded_and_packing_match_jax():
    x, wt, b, aff = _conv_inputs(16, 13, 4, 8, seed=5)
    jxp = jax_conv.conv_input_pad(jnp.asarray(x))
    txp = conv_kernel.conv_input_pad(torch.from_numpy(x))
    np.testing.assert_array_equal(txp.numpy(), np.asarray(jxp))
    assert txp.shape == (18, 16, 4)
    np.testing.assert_array_equal(conv_kernel.pack_weights(torch.from_numpy(wt)).numpy(),
                                  np.asarray(jax_conv.pack_weights(jnp.asarray(wt))))
    want = np.asarray(jax_conv.conv3x3_act(jxp, jnp.asarray(wt), jnp.asarray(b), 0.1,
                                           affine=_j(aff), interpret=True,
                                           pre_padded=True, width=13))
    got = conv_kernel.conv3x3_act(txp, torch.from_numpy(wt), torch.from_numpy(b), 0.1,
                                  affine=_t(aff), pre_padded=True, width=13)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    direct = conv_kernel.conv3x3_act(torch.from_numpy(x), torch.from_numpy(wt),
                                     torch.from_numpy(b), 0.1, affine=_t(aff))
    assert torch.equal(got, direct)
    for h in (832, 104, 52, 7):
        assert conv_kernel.supported_height(h) == jax_conv.supported_height(h)
    assert conv_kernel.TH == jax_conv.TH
    with pytest.raises(ValueError, match="width"):
        conv_kernel.conv3x3_act(txp, torch.from_numpy(wt), torch.from_numpy(b), 0.1,
                                pre_padded=True)


# The bfloat16 row-band kernel reads its weights in pack_weights_sm90's
# layout at the width rows_plan gives it: that packing unpacks to the
# weights, and the conv computed from it (conv3x3_act_packed_plain on the
# image, or on the interior of the zero-bordered layout) equals the JAX
# row-band kernel in interpret mode, on the image and on the pre-padded
# input, at the tolerance of the plain conv.
@pytest.mark.parametrize("h,w,ci,co", [(16, 24, 10, 32), (8, 13, 64, 3), (16, 16, 43, 57)])
def test_rows_packed_weights_match_pallas_kernel(h, w, ci, co):
    x, wt, b, aff = _conv_inputs(h, w, ci, co, seed=2 * ci + co)
    tw = torch.from_numpy(wt)
    plan = conv_kernel.rows_plan(1, h, w, ci, co)
    wp = conv_kernel.pack_weights_sm90(tw, plan.n_cols)
    assert plan.n_cols >= co and plan.n_cols % 8 == 0
    assert torch.equal(conv_kernel.unpack_weights_sm90(wp, ci, co), tw)
    jxp = jax_conv.conv_input_pad(jnp.asarray(x))
    txp = conv_kernel.conv_input_pad(torch.from_numpy(x))
    for jx, tx, padded in ((jnp.asarray(x), torch.from_numpy(x), False), (jxp, txp, True)):
        want = np.asarray(jax_conv.conv3x3_act(
            jx, jnp.asarray(wt), jnp.asarray(b), 0.1, affine=_j(aff), interpret=True,
            pre_padded=padded, width=w if padded else None))
        image = tx[1:h + 1, 1:w + 1] if padded else tx
        got = conv_kernel.conv3x3_act_packed_plain(image, wp, torch.from_numpy(b), 0.1,
                                                   affine=_t(aff))
        assert got.shape == (h, w, co)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_conv_wrappers_take_batches_and_bf16():
    x, wt, b, aff = _conv_inputs(8, 12, 6, 5, seed=9, n=3)
    xb = torch.from_numpy(x).bfloat16()
    for fn in (conv_kernel.conv3x3_act_chw, conv_kernel.conv3x3_act):
        whole = fn(xb, torch.from_numpy(wt), torch.from_numpy(b), 0.1, _t(aff))
        assert whole.dtype == torch.bfloat16 and whole.shape == (3, 8, 12, 5)
        for i in range(3):
            one = fn(xb[i], torch.from_numpy(wt), torch.from_numpy(b), 0.1, _t(aff))
            assert torch.equal(one, whole[i])
    y32 = conv_kernel.conv3x3_act_chw(xb, torch.from_numpy(wt), torch.from_numpy(b), 1.0,
                                      out_dtype="float32")
    assert y32.dtype == torch.float32


# ---------------------------------------------------------------------------
# The conv's autograd vs the JAX custom VJP
# ---------------------------------------------------------------------------

def _function_grads(x, wt, g, dtype):
    tx = torch.from_numpy(x).to(dtype).requires_grad_(True)
    tw = torch.from_numpy(wt).to(dtype).requires_grad_(True)
    y = layers.Conv3x3Function.apply(tx, tw)
    dx, dw = torch.autograd.grad(y, (tx, tw), torch.from_numpy(g))
    return y.detach(), dx, dw


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv3x3_function_matches_jax_custom_vjp(dtype):
    """Forward, dx and dw of ``Conv3x3Function`` against ``jax.vjp`` of
    ``_conv3x3_pallas_nb`` (the Pallas kernel in interpret mode, forward and
    dgrad), un-jitted at a tiny size."""
    x, wt, _, _ = _conv_inputs(8, 16, 5, 7, seed=11, n=2)
    g = np.random.default_rng(12).normal(size=(2, 8, 16, 7)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jy, vjp = jax.vjp(jax_layers._conv3x3_pallas_nb, jnp.asarray(x).astype(jdt),
                      jnp.asarray(wt).astype(jdt))
    jdx, jdw = vjp(jnp.asarray(g))
    ty, tdx, tdw = _function_grads(x, wt, g, tdt)
    assert ty.dtype == torch.float32 and tdx.dtype == tdt and tdw.dtype == tdt
    assert jy.dtype == jnp.float32 and jdx.dtype == jdt and jdw.dtype == jdt
    rtol = 1e-4 if dtype == "float32" else 1.6e-2
    for got, want in ((ty, jy), (tdx, jdx), (tdw, jdw)):
        want = np.asarray(want.astype(jnp.float32))
        atol = (1e-5 if dtype == "float32" else 1e-2) * max(1.0, np.abs(want).max())
        np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol, atol=atol)


def test_conv3x3_function_matches_library_autograd_and_plain_backward():
    x, wt, _, _ = _conv_inputs(12, 9, 6, 4, seed=13, n=2)
    g = np.random.default_rng(14).normal(size=(2, 12, 9, 4)).astype(np.float32)
    ty, tdx, tdw = _function_grads(x, wt, g, torch.float32)
    lx = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    lw = torch.from_numpy(wt).permute(3, 2, 0, 1).requires_grad_(True)
    ly = F.conv2d(lx, lw, padding=1)
    ldx, ldw = torch.autograd.grad(ly, (lx, lw), torch.from_numpy(g).permute(0, 3, 1, 2))
    np.testing.assert_allclose(ty.numpy(), ly.detach().permute(0, 2, 3, 1).numpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tdx.numpy(), ldx.permute(0, 2, 3, 1).numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tdw.numpy(), ldw.permute(2, 3, 1, 0).numpy(), rtol=1e-4, atol=1e-4)
    pdx, pdw = conv_kernel.conv3x3_backward_plain(torch.from_numpy(x), torch.from_numpy(wt),
                                                  torch.from_numpy(g))
    np.testing.assert_allclose(tdx.numpy(), pdx.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tdw.numpy(), pdw.numpy(), rtol=1e-4, atol=1e-4)


def test_conv3x3_function_skips_dgrad_without_input_grad(monkeypatch):
    calls = []
    orig = conv_kernel.conv3x3_act_chw
    monkeypatch.setattr(conv_kernel, "conv3x3_act_chw",
                        lambda *a, **k: calls.append(k.get("out_dtype")) or orig(*a, **k))
    x, wt, _, _ = _conv_inputs(8, 8, 3, 4, seed=15, n=1)
    tw = torch.from_numpy(wt).requires_grad_(True)
    y = layers.Conv3x3Function.apply(torch.from_numpy(x), tw)
    y.sum().backward()
    assert calls == ["float32"] and tw.grad.shape == (3, 3, 3, 4)
    tx = torch.from_numpy(x).requires_grad_(True)
    layers.Conv3x3Function.apply(tx, tw).sum().backward()
    assert calls == ["float32", "float32", None] and tx.grad.shape == tx.shape


@pytest.mark.parametrize("bf16", [False, True])
def test_conv2d_matches_jax(bf16, monkeypatch):
    """Value and gradients of conv2d (bias added in float32 after the conv)
    against the JAX conv2d through its custom VJP (APTD_CONV_IMPL=pallas2)."""
    monkeypatch.setenv("APTD_CONV_IMPL", "pallas2")
    x, wt, b, _ = _conv_inputs(8, 16, 5, 7, seed=16, n=2)

    def jloss(p, xx):
        return jnp.sum(jnp.sin(jax_layers.conv2d(p, xx, bf16=bf16)))

    jv, (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1))(
        {"w": jnp.asarray(wt), "b": jnp.asarray(b)}, jnp.asarray(x))
    tp = {"w": torch.from_numpy(wt).requires_grad_(True),
          "b": torch.from_numpy(b).requires_grad_(True)}
    tx = torch.from_numpy(x).requires_grad_(True)
    y = layers.conv2d(tp, tx, bf16=bf16, impl="pallas2")
    assert y.dtype == torch.float32
    tv = torch.sin(y).sum()
    tv.backward()
    tol = dict(rtol=1e-4, atol=1e-4) if not bf16 else dict(rtol=1.6e-2, atol=3e-2)
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-5 if not bf16 else 1e-3)
    np.testing.assert_allclose(tp["w"].grad.numpy(), np.asarray(jgp["w"]), **tol)
    np.testing.assert_allclose(tp["b"].grad.numpy(), np.asarray(jgp["b"]), **tol)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **tol)
    with pytest.raises(ValueError):
        layers.conv2d(tp, tx, impl="nope")


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def _norm_inputs(c, seed):
    r = np.random.default_rng(seed)
    x = (r.normal(size=(2, 6, 5, c)) * r.uniform(0.5, 2.0, c) + r.normal(size=c)).astype(np.float32)
    params = {"scale": r.uniform(0.5, 1.5, c).astype(np.float32),
              "bias": r.normal(size=c).astype(np.float32)}
    state = {"mean": r.normal(size=c).astype(np.float32),
             "var": r.uniform(0.5, 2.0, c).astype(np.float32)}
    return x, params, state


@pytest.mark.parametrize("train", [True, False])
def test_batch_norm_matches_jax(train):
    x, params, state = _norm_inputs(7, 20)
    jy, jstate = jax_layers.batch_norm(_j(params), _j(state), jnp.asarray(x), train)
    ty, tstate = layers.batch_norm(_t(params), _t(state), torch.from_numpy(x), train)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5, atol=2e-5)
    for k in ("mean", "var"):
        np.testing.assert_allclose(tstate[k].numpy(), np.asarray(jstate[k]), rtol=1e-5, atol=1e-6)
    if train:
        # torch's own BatchNorm agrees too (biased batch variance, unbiased running one)
        ref = torch.nn.BatchNorm2d(7, eps=1e-5, momentum=0.1)
        with torch.no_grad():
            ref.weight.copy_(torch.from_numpy(params["scale"]))
            ref.bias.copy_(torch.from_numpy(params["bias"]))
            ref.running_mean.copy_(torch.from_numpy(state["mean"]))
            ref.running_var.copy_(torch.from_numpy(state["var"]))
        ry = ref(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        np.testing.assert_allclose(ty.numpy(), ry.detach().numpy(), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(tstate["var"].numpy(), ref.running_var.numpy(), rtol=1e-4)
    else:
        assert tstate["mean"] is not None and torch.equal(tstate["mean"], _t(state)["mean"])


def test_batch_norm_gradient_matches_jax():
    x, params, state = _norm_inputs(5, 21)
    g = np.random.default_rng(22).normal(size=x.shape).astype(np.float32)

    def jf(p, xx):
        return jnp.sum(jax_layers.batch_norm(p, _j(state), xx, True)[0] * g)

    jgp, jgx = jax.grad(jf, argnums=(0, 1))(_j(params), jnp.asarray(x))
    tp = {k: v.requires_grad_(True) for k, v in _t(params).items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    (layers.batch_norm(tp, _t(state), tx, True)[0] * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-4, atol=1e-4)
    for k in tp:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jgp[k]), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("c", [8, 43, 3])
def test_group_norm_matches_jax(c):
    x, params, _ = _norm_inputs(c, 30 + c)
    jy = jax_layers.group_norm(_j(params), jnp.asarray(x), groups=8)
    ty = layers.group_norm(_t(params), torch.from_numpy(x), groups=8)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5, atol=2e-5)
    if c % 8 == 0:
        ref = F.group_norm(torch.from_numpy(x).permute(0, 3, 1, 2), math.gcd(8, c),
                           torch.from_numpy(params["scale"]), torch.from_numpy(params["bias"]))
        np.testing.assert_allclose(ty.numpy(), ref.permute(0, 2, 3, 1).numpy(),
                                   rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# The train graph as a whole
# ---------------------------------------------------------------------------

def _model(norm="batch", seed=0):
    jopts = JaxModelOptions(widths=SMALL, norm=norm)
    jp, js = jax_ae.init_autoencoder(jax.random.PRNGKey(seed), jopts)
    # running statistics away from their initial 0 / 1
    r = np.random.default_rng(seed)
    js = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a) + r.uniform(0.0, 0.3, a.shape).astype(np.float32)), js)
    tp, ts = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                               jax.tree_util.tree_map(np.asarray, js), device="cpu")
    return jopts, jp, js, ModelOptions(widths=SMALL, norm=norm), tp, ts


def test_apply_sequence_train_mode_matches_jax():
    jopts, jp, js, topts, tp, ts = _model()
    x = np.random.default_rng(1).normal(size=(3, 2, 32, 32, 10)).astype(np.float32)
    jy, jh, jbn = jax.jit(lambda p, s, xx: jax_ae.apply_sequence(
        p, s, xx, train=True, options=jopts))(jp, js, jnp.asarray(x))
    with torch.no_grad():
        ty, th, tbn = apply_sequence(tp, ts, torch.from_numpy(x), train=True, options=topts)
    assert ty.shape == (3, 2, 32, 32, 3) and ty.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=3e-3, rtol=0)
    for k in jh:
        assert th[k].dtype == torch.float32
        np.testing.assert_allclose(th[k].numpy(), np.asarray(jh[k]), atol=3e-3, rtol=0, err_msg=k)
    for (path, leaf), jleaf in zip(sorted_leaves(tbn), jax.tree_util.tree_leaves(jbn)):
        np.testing.assert_allclose(leaf.numpy(), np.asarray(jleaf), atol=1e-4, rtol=1e-4,
                                   err_msg="/".join(path))
    assert param_count(tp) == jax_ae.param_count(jp)


@pytest.mark.parametrize("norm", ["batch", "group"])
def test_apply_frame_eval_mode_matches_jax(norm):
    jopts, jp, js, topts, tp, ts = _model(norm, seed=2)
    r = np.random.default_rng(3)
    jh = jax_ae.init_hidden(1, 32, 64, jopts)
    th = init_hidden(1, 32, 64, topts, device="cpu")
    frame = jax.jit(lambda xx, hd: jax_ae.apply_frame(jp, js, xx, hd, train=False,
                                                      options=jopts))
    for _ in range(2):
        x = r.normal(size=(1, 32, 64, 10)).astype(np.float32)
        jy, jh, jbn = frame(jnp.asarray(x), jh)
        with torch.no_grad():
            ty, th, tbn = apply_frame(tp, ts, torch.from_numpy(x), th, train=False,
                                      options=topts)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-3, rtol=0)
    assert torch.equal(tbn["enc1"]["bn1"]["var"], ts["enc1"]["bn1"]["var"])
    with pytest.raises(ValueError, match="divisible by 32"):
        apply_frame(tp, ts, torch.zeros(1, 40, 64, 10), th, options=topts)


def test_remat_changes_no_gradient():
    _, _, _, topts, tp, ts = _model(seed=4)
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(2, 1, 32, 32, 10)).astype(np.float32))
    grads = []
    for remat in (False, True):
        leaves = [leaf.detach().requires_grad_(True) for _, leaf in sorted_leaves(tp)]
        ys, _, bn = apply_sequence(tree_from_leaves(tp, leaves), ts, x, train=True, remat=remat,
                                   options=topts)
        grads.append(torch.autograd.grad(ys.square().mean(), leaves))
    for a, b in zip(*grads):
        assert torch.equal(a, b)
