"""The port's loss against the JAX package's, term by term and as a whole,
values and gradients with respect to the outputs, on the CPU.

Tolerances: every term is a few float32 convolutions and means of the same
numpy inputs, summed in another order.  L1 and temporal terms: rtol 1e-6.
HFEN divides by the global max of a Laplacian of a blurred image, a small
number whose last-bit difference scales every element: values rtol 1e-4,
gradients rtol 2e-3 / atol 1e-6 (a gradient entry is about 1/N of the
value); the totals inherit HFEN's tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_path_tracer_denoiser_tpu.train import loss as jax_loss
from ai_path_tracer_denoiser_tpu_torch.train import loss

torch.set_num_threads(2)


def _seq(t=3, n=2, h=24, w=20, seed=0):
    r = np.random.default_rng(seed)
    out = r.uniform(0, 1, (t, n, h, w, 3)).astype(np.float32)
    tgt = np.clip(out + r.normal(size=out.shape) * 0.1, 0, 1).astype(np.float32)
    return out, tgt


def test_l1_gaussian_log_temporal_match_jax():
    out, tgt = _seq()
    np.testing.assert_allclose(float(loss.l1_norm(torch.from_numpy(out), torch.from_numpy(tgt))),
                               float(jax_loss.l1_norm(jnp.asarray(out), jnp.asarray(tgt))),
                               rtol=1e-6)
    np.testing.assert_allclose(loss.gaussian_kernel(5, 1.5).numpy(),
                               np.asarray(jax_loss.gaussian_kernel(5, 1.5)), rtol=1e-6)
    np.testing.assert_allclose(loss.log_filter(torch.from_numpy(out[0])).numpy(),
                               np.asarray(jax_loss.log_filter(jnp.asarray(out[0]))),
                               rtol=1e-5, atol=1e-5)
    assert loss.log_filter(torch.from_numpy(out[0])).shape == (2, 24, 20, 1)
    np.testing.assert_array_equal(loss.temporal_diff(torch.from_numpy(out)).numpy(),
                                  np.asarray(jax_loss.temporal_diff(jnp.asarray(out))))
    assert loss.FRAME_RAMP == jax_loss.FRAME_RAMP


def test_hfen_matches_jax_value_and_gradient():
    out, tgt = _seq(seed=1)
    jv, jg = jax.value_and_grad(jax_loss.hfen)(jnp.asarray(out[0]), jnp.asarray(tgt[0]))
    to = torch.from_numpy(out[0]).requires_grad_(True)
    tv = loss.hfen(to, torch.from_numpy(tgt[0]))
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-4)
    np.testing.assert_allclose(to.grad.numpy(), np.asarray(jg), rtol=2e-3, atol=1e-6)
    ls, lg, lt = loss.frame_loss(to.detach(), to.detach() * 0.5, torch.from_numpy(tgt[0]),
                                 torch.from_numpy(tgt[0]) * 0.5)
    jls, jlg, jlt = jax_loss.frame_loss(jnp.asarray(out[0]), jnp.asarray(out[0]) * 0.5,
                                        jnp.asarray(tgt[0]), jnp.asarray(tgt[0]) * 0.5)
    np.testing.assert_allclose([float(ls), float(lg), float(lt)],
                               [float(jls), float(jlg), float(jlt)], rtol=1e-4)


@pytest.mark.parametrize("case", ["random", "zero_target_frame", "bf16_targets"])
def test_sequence_loss_and_gradient_match_jax(case):
    """total, every summed component and d total / d outputs.  With an
    all-zero target frame every element of its LoG ties at the max 0: the
    normalisation takes its second branch in both packages and the gradient
    with respect to the outputs stays finite."""
    out, tgt = _seq(seed=2)
    if case == "zero_target_frame":
        tgt[1] = 0.0
    jt, tt = jnp.asarray(tgt), torch.from_numpy(tgt)
    if case == "bf16_targets":
        jt, tt = jt.astype(jnp.bfloat16), tt.bfloat16()
    (jv, jm), jg = jax.value_and_grad(
        lambda o: jax_loss.sequence_loss(o, jt), has_aux=True)(jnp.asarray(out))
    to = torch.from_numpy(out).requires_grad_(True)
    tv, tm = loss.sequence_loss(to, tt)
    tv.backward()
    assert tv.dtype == torch.float32
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-4)
    for k in ("total", "l1", "hfen", "temporal"):
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]), err_msg=k,
                                   rtol=1e-6 if k in ("l1", "temporal") else 1e-4)
    assert np.isfinite(np.asarray(jg)).all() and torch.isfinite(to.grad).all()
    np.testing.assert_allclose(to.grad.numpy(), np.asarray(jg), rtol=2e-3, atol=1e-6)


def test_zero_output_frame_gradient_is_nan_in_both():
    """An all-zero OUTPUT frame makes the untaken x / max branch 0 / 0 in the
    backward pass: ``jax.grad`` returns NaN for that frame and so does the
    port; the other frames' gradients stay finite and equal."""
    out, tgt = _seq(seed=3)
    out[1] = 0.0
    jg = np.asarray(jax.grad(lambda o: jax_loss.sequence_loss(o, jnp.asarray(tgt))[0])(
        jnp.asarray(out)))
    to = torch.from_numpy(out).requires_grad_(True)
    loss.sequence_loss(to, torch.from_numpy(tgt))[0].backward()
    tg = to.grad.numpy()
    np.testing.assert_array_equal(np.isnan(tg), np.isnan(jg))
    assert np.isnan(jg[1]).any() and np.isfinite(jg[0]).all()
    np.testing.assert_allclose(tg, jg, rtol=2e-3, atol=1e-6, equal_nan=True)


def test_sequence_loss_weights_and_ramp():
    out, tgt = _seq(t=2, seed=4)
    to, tt = torch.from_numpy(out), torch.from_numpy(tgt)
    total, m = loss.sequence_loss(to, tt, 0.5, 0.25, 0.125, frame_ramp=(0.0, 1.0))
    t_out, t_tgt = loss.temporal_diff(to), loss.temporal_diff(tt)
    want = 0.0
    for j, r in enumerate((0.0, 1.0)):
        ls, lg, lt = loss.frame_loss(to[j], t_out[j], tt[j], t_tgt[j])
        want = want + (0.5 + r) * ls + (0.25 + r) * lg + (0.125 + r) * lt
    np.testing.assert_allclose(float(total), float(want), rtol=1e-6)
    with pytest.raises(ValueError, match="frame_ramp"):
        loss.sequence_loss(to, tt, frame_ramp=(1.0,))
