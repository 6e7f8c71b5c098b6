"""The kernel-predicting denoiser (models/kpcn.py) against its plain float32
reference (tests/kpcn_reference.py, plain ``torch``, nothing of the port),
K11's launch plan and weight packing, K12's plain version, and
``interactive --denoiser kpcn``.

Weights are drawn by ``init_kpcn`` from a seed; G-buffers are made with
numpy from a seed (radiance as a 1-spp frame's: exponential, 30% of the
pixels dark).  The port computes in bfloat16 as on the card (activations,
weights and logits rounded to bfloat16, float32 sums), so the tolerances
below say which rounding each comparison allows.

The ``cuda``-marked tests need an NVIDIA GPU and skip elsewhere; they hold
K11 and K12 to their plain versions and the whole frame to the reference.
This file imports neither JAX nor the JAX package, so on the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kpcn.py -q
"""
import os
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ai_path_tracer_denoiser_tpu_torch.app import cli
from ai_path_tracer_denoiser_tpu_torch.config import KPCNOptions
from ai_path_tracer_denoiser_tpu_torch.models import conv_kernel as ck
from ai_path_tracer_denoiser_tpu_torch.models import kpcn
from ai_path_tracer_denoiser_tpu_torch.utils import timers

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import kpcn_reference as ref  # noqa: E402

torch.set_num_threads(2)
SMALL = KPCNOptions(width=16, kernel=5)      # 16 wide, a 5x5 kernel
PUBLISHED = KPCNOptions()                    # 100 wide, 21x21
CASES = [(SMALL, 32, 1), (PUBLISHED, 16, 2)]
# bfloat16 keeps 8 significant bits: one step is 2**-8 to 2**-7 of a value
# (2**-7 at the bottom of its binade), and one rounding is within half a
# step.  A float32 sum in another order may move a value across a rounding
# boundary, which stays within one step (2**-7 of the value).  Values near
# zero are held to the sums' own float32 error instead.
BF16_STEP = 2.0 ** -7


def gbuffer(h, w, seed):
    r = np.random.default_rng(seed)
    g = np.zeros((10, h, w), np.float32)
    g[0:3] = r.exponential(0.3, (3, h, w)) * (r.random((1, h, w)) < 0.7)
    n = r.normal(size=(3, h, w))
    g[3:6] = n / np.linalg.norm(n, axis=0)
    g[6] = r.uniform(2.0, 17.0, (h, w))
    g[7:10] = r.random((3, h, w))
    return torch.from_numpy(g)


def rel_l2(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.fixture(autouse=True)
def fresh_registry():
    timers.reset()
    yield
    timers.reset()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    return torch.device("cuda")


def test_published_widths_and_shapes():
    assert kpcn.layer_shapes(PUBLISHED) == [(30, 100)] + [(100, 100)] * 7 + [(100, 441)]
    p = kpcn.init_kpcn(7)
    assert [tuple(p[f"conv{i}"]["w"].shape) for i in (1, 2, 9)] == [
        (5, 5, 30, 100), (5, 5, 100, 100), (5, 5, 100, 441)]
    torch.testing.assert_close(kpcn.init_kpcn(7)["conv9"]["w"], p["conv9"]["w"], rtol=0, atol=0)


@pytest.mark.parametrize("opts,hw,seed", CASES)
def test_features_equal_the_reference(opts, hw, seed):
    g = gbuffer(hw, hw + 3, seed)
    got = kpcn.kpcn_features(g)
    assert got.shape == (1, hw, hw + 3, 30)
    # the same float32 operations in the same order
    torch.testing.assert_close(got.permute(0, 3, 1, 2), ref.features(g), rtol=0, atol=0)


@pytest.mark.parametrize("opts,hw,seed", CASES)
def test_each_conv_equals_the_reference(opts, hw, seed):
    """Each layer on the port's own bfloat16 input: the plain K11 (through
    the padded weights the card reads) against ``F.conv2d`` in float32 on
    the same bfloat16 operands, one bfloat16 rounding apart."""
    g = gbuffer(hw, hw, seed)
    p = kpcn.init_kpcn(seed, opts)
    x = F.pad(kpcn.kpcn_features(g), (0, kpcn.IN_PAD - 30)).to(torch.bfloat16)
    shapes = kpcn.layer_shapes(opts)
    for i, (ci, co) in enumerate(shapes, 1):
        w, b = p[f"conv{i}"]["w"], p[f"conv{i}"]["b"]
        co_pad = -(-co // 8) * 8
        got = ck.conv5x5_act(x, kpcn._padded(w, x.shape[-1], co_pad), kpcn._padded(b, 0, co_pad),
                             relu=i < len(shapes))
        assert got.dtype == torch.bfloat16 and got.shape[-1] == co_pad
        assert not got[..., co:].any()               # the padded channels stay zero
        want = F.conv2d(x[..., :ci].permute(0, 3, 1, 2).float(),
                        w.to(torch.bfloat16).float().permute(3, 2, 0, 1), b, padding=2)
        if i < len(shapes):
            want = torch.relu(want)
        want = want.permute(0, 2, 3, 1)
        torch.testing.assert_close(got[..., :co].float(), want, rtol=BF16_STEP,
                                   atol=1e-5 * float(want.abs().max()))
        x = got


@pytest.mark.parametrize("opts,hw,seed", CASES)
def test_weights_and_frame_against_the_reference(opts, hw, seed):
    """Softmax weights and frame: against the reference rounded as the
    program rounds (bfloat16 operands and logits), only float32 sum order
    differs, but it flips bfloat16 roundings that the next layers carry:
    measured 3e-4-5e-3 (weights) and 8e-5-8e-4 (frame) over three seeds.
    Against the float32 reference the program is as far as that witness
    (measured 4e-3-9e-3 and 1e-3-4e-3): at most 1.5 times its distance."""
    k = opts.kernel
    g = gbuffer(hw, hw, seed)
    p = kpcn.init_kpcn(seed, opts)
    y, lg = kpcn.apply_kpcn_frame(p, g, opts, return_logits=True)
    assert y.shape == (1, hw, hw, 3) and y.dtype == torch.float32
    assert lg.shape == (1, hw, hw, -(-k * k // 8) * 8) and lg.dtype == torch.bfloat16
    w_port = torch.softmax(lg[..., :k * k].float(), -1).permute(0, 3, 1, 2)
    y_ref, w_ref = ref.frame(p, g, k)
    y_wit, w_wit = ref.frame(p, g, k, quant="bf16")
    assert rel_l2(w_port, w_wit) < 0.015 and rel_l2(y.permute(0, 3, 1, 2), y_wit) < 0.004
    assert rel_l2(w_port, w_ref) < 1.5 * rel_l2(w_wit, w_ref)
    assert rel_l2(y.permute(0, 3, 1, 2), y_ref) < 1.5 * rel_l2(y_wit, y_ref)


def test_the_softmax_weights_sum_to_one():
    """A constant radiance comes back unchanged wherever the window lies
    inside the image (the weights sum to 1); at the border the window's
    zero padding takes its share."""
    k, hw = 21, 24
    lg = torch.randn((1, hw, hw, 448), generator=torch.Generator().manual_seed(3)) * 2
    y = kpcn.kernel_apply_plain(lg.to(torch.bfloat16), torch.full((1, 3, hw, hw), 0.7), k)
    inner = y[0, 10:hw - 10, 10:hw - 10]
    torch.testing.assert_close(inner, torch.full_like(inner, 0.7), rtol=1e-6, atol=0)
    assert float(y[0, 0, 0, 0]) < 0.7 * 0.5          # a corner sees a quarter of its window


@pytest.mark.parametrize("k", [1, 5, 21])
def test_plain_apply_equals_unfold_and_a_tap_loop(k):
    """The plain apply against the reference's ``F.unfold`` of the padded
    radiance, and against a loop over the taps' shifted windows (float32
    sums in other orders: 1e-6)."""
    n, h, w = 2, 9, 13
    gen = torch.Generator().manual_seed(k)
    lg = torch.randn((n, h, w, k * k + 1), generator=gen)
    rad = torch.rand((n, 3, h, w), generator=gen)
    got = kpcn.kernel_apply_plain(lg, rad, k)
    r = k // 2
    wgt = torch.softmax(lg[..., :k * k], -1)
    pad = F.pad(rad, (r, r, r, r))
    loop = sum(wgt[..., t, None] * pad[:, :, t // k:t // k + h, t % k:t % k + w].permute(0, 2, 3, 1)
               for t in range(k * k))
    torch.testing.assert_close(got, loop, rtol=1e-6, atol=1e-6)
    for i in range(n):
        want = ref.apply(wgt[i:i + 1].permute(0, 3, 1, 2), rad[i:i + 1], k, rows=4)
        torch.testing.assert_close(got[i:i + 1], want.permute(0, 2, 3, 1), rtol=1e-6, atol=1e-6)


def test_k11_packing_and_plan():
    """The 5x5 packing puts w[dy, dx, 16k + 8h + c, 8j + r] at
    [k, 5 dy + dx, j, h, r, c], zero past C and Co; each frame-sized plan
    fills the card and fits two stages in shared memory."""
    w = torch.randn(5, 5, 20, 13)
    wp = ck.pack_weights_sm90(w, 24)
    assert wp.shape == (2, 25, 3, 2, 8, 8)
    for k, t, j, h, r, c in [(0, 0, 0, 0, 0, 0), (1, 24, 1, 0, 4, 3), (0, 7, 1, 1, 2, 5)]:
        ci, o = 16 * k + 8 * h + c, 8 * j + r
        want = w[t // 5, t % 5, ci, o] if ci < 20 and o < 13 else 0.0
        assert float(wp[k, t, j, h, r, c]) == float(want)
    assert not wp[1, :, :, :, :, 4:].any() and not wp[:, :, 2, :, 5:].any()
    for co in (104, 448):
        plan = ck.conv5_plan(1, 800, 800, co)
        assert plan.blocks >= ck.SMS and plan.n_cols >= co and plan.nb in ck.BLOCK_GROUPS5
        assert ck.conv5_smem_bytes(plan.nb) <= ck.SMEM_MAX
    assert ck.conv5_plan(1, 800, 800, 104)[1:5] == (8, 32, 13, 1)
    assert ck.conv5_plan(1, 800, 800, 448)[1:5] == (8, 32, 8, 7)


# K11's calls: KPCN's at 800x800 and at the CPU tests' frames (published
# widths: 32 -> 104 -> 448; the small network: 16 wide, 25 logits padded
# to 32), and the card tests' shapes
K11_CALLS = [(1, 800, 800, 104), (1, 800, 800, 448), (1, 96, 80, 104), (1, 96, 80, 448),
             (1, 16, 16, 104), (1, 16, 16, 448), (1, 32, 32, 16), (1, 32, 32, 32),
             (1, 64, 64, 104), (1, 64, 64, 448), (1, 200, 168, 104), (2, 37, 23, 13),
             (1, 805, 797, 104)]


@pytest.mark.parametrize("n,h,w,co", K11_CALLS)
def test_k11_plan_fits_covers_and_fills(n, h, w, co):
    """Each plan's two stages fit in shared memory, its channel blocks
    cover every group of 8 output channels, and it gives the card ``SMS``
    items where the tiles and groups allow."""
    plan = ck.conv5_plan(n, h, w, co)
    tiles = n * -(-h // plan.th) * -(-w // plan.tw)
    need = -(-co // 8)
    assert plan.tw * plan.th == 256 and plan.nb in ck.BLOCK_GROUPS5
    assert ck.conv5_smem_bytes(plan.nb) <= ck.SMEM_MAX
    assert plan.n_cols >= co and (plan.groups - 1) * plan.nb < need
    assert plan.blocks == tiles * plan.groups >= min(ck.SMS, tiles * need)


@pytest.mark.parametrize("shape,plan", [
    ((1, 800, 800, 32), (2, 16, 8, 4, 1, 5000)), ((1, 800, 800, 101), (2, 16, 8, 13, 1, 5000)),
    ((1, 400, 400, 43), (2, 16, 8, 6, 1, 1250)), ((4, 256, 256, 57), (2, 16, 8, 8, 1, 2048)),
    ((1, 100, 100, 76), (1, 8, 8, 10, 1, 169)), ((1, 50, 50, 101), (1, 8, 8, 5, 3, 147)),
    ((1, 64, 64, 8), (1, 8, 8, 1, 1, 64)), ((2, 37, 23, 13), (1, 8, 8, 1, 2, 60))])
def test_k2_plan_is_its_own(shape, plan):
    """K2's plan (``conv_plan``) does not follow K11's: the RDAE's shapes
    keep their tiles and channel blocks."""
    assert tuple(ck.conv_plan(*shape)) == plan


def test_wrappers_count_the_plain_side_on_the_cpu():
    g = gbuffer(16, 16, 4)
    with timers.span("frame"):
        kpcn.apply_kpcn_frame(kpcn.init_kpcn(1, SMALL), g, SMALL)
    (rec,) = timers.records("frame")
    assert rec["counts"] == {"kpcn.conv.plain": 9, "kpcn.apply.plain": 1}
    assert {"denoise.frame", "denoise.kpcn.features", "denoise.kpcn.convs",
            "denoise.kpcn.conv1", "denoise.kpcn.conv9", "denoise.kpcn.apply"} <= set(rec["spans"])


def test_the_kernel_wrappers_refuse_what_they_do_not_take():
    with pytest.raises(ValueError):
        ck.conv5x5_act(torch.zeros(1, 4, 4, 8, device="meta"), torch.zeros(5, 5, 8, 8),
                       torch.zeros(8), relu=True)
    with pytest.raises(SystemExit):
        cli.main(["interactive", "scenes/cornell_box.txt", "--device", "cpu", "--res", "8",
                  "--frames", "1", "--denoiser", "kpcn", "--model", "x.npz",
                  "--out-dir", os.devnull])


def test_interactive_cli_denoises_with_kpcn(tmp_path):
    """``interactive --denoiser kpcn``: one 32x32 frame through
    ``apply_kpcn_frame``, with weights from seed 0 and no hidden state."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    recs = cli.main(["interactive", os.path.join(repo, "scenes", "cornell_box.txt"),
                     "--device", "cpu", "--res", "32", "--frames", "1", "--denoiser", "kpcn",
                     "--out-dir", str(tmp_path), "--save-arrays"])
    assert len(recs) == 1 and recs[0]["finite"]
    g = torch.from_numpy(np.load(tmp_path / "frame_0000_gbuffer.npy"))
    got = np.load(tmp_path / "frame_0000_denoised.npy")
    want = kpcn.apply_kpcn_frame(kpcn.init_kpcn(0), g)[0]
    np.testing.assert_array_equal(got, want.numpy())
    assert timers.totals()["kpcn.conv.plain"] == 18 and timers.totals()["kpcn.apply.plain"] == 2


# ------------------------------------------------------------------ card

@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,c,co,relu", [
    (1, 64, 64, 32, 104, True), (1, 64, 64, 104, 448, False), (1, 200, 168, 104, 104, True),
    (2, 37, 23, 8, 13, True), (1, 800, 800, 104, 104, True), (1, 800, 800, 32, 104, True),
    (1, 800, 800, 104, 448, False), (1, 805, 797, 104, 104, True)])
def test_k11_equals_its_plain_version_on_card(cuda_device, n, h, w, c, co, relu):
    """K11 and the plain version sum the same float32 products in another
    order, then round once to bfloat16: one bfloat16 step apart at most,
    and values near zero within the sums' float32 error."""
    gen = torch.Generator().manual_seed(h * w + co)
    x = torch.randn((n, h, w, c), generator=gen).to(torch.bfloat16)
    wt = torch.randn((5, 5, c, co), generator=gen) * (2.0 / (25 * c)) ** 0.5
    b = torch.randn(co, generator=gen) * 0.1
    got = ck.conv5x5_act(x.to(cuda_device), wt.to(torch.bfloat16).to(cuda_device),
                         b.to(cuda_device), relu)
    torch.cuda.synchronize()
    want = ck.conv5x5_act_plain(x, wt.to(torch.bfloat16), b, relu)
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=BF16_STEP,
                               atol=1e-4 * float(want.float().abs().max()))
    f32 = ck.conv5x5_act(x.to(cuda_device), wt.to(torch.bfloat16).to(cuda_device),
                         b.to(cuda_device), relu, out_dtype="float32")
    torch.testing.assert_close(f32.cpu(), ck.conv5x5_act_plain(x, wt.to(torch.bfloat16), b, relu,
                                                               out_dtype="float32"),
                               rtol=1e-5, atol=1e-5 * float(want.float().abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,k,ldl", [(1, 64, 64, 21, 448), (2, 35, 50, 5, 26),
                                         (1, 800, 800, 21, 448), (1, 17, 9, 1, 2)])
def test_k12_equals_its_plain_version_on_card(cuda_device, n, h, w, k, ldl):
    """K12 against the plain version: float32 exponentials and sums in
    another order (1e-5 of the value, 1e-6 of the radiance's scale)."""
    gen = torch.Generator().manual_seed(h + k)
    lg = (torch.randn((n, h, w, ldl), generator=gen) * 1.5).to(torch.bfloat16)
    rad = torch.rand((n, 3, h, w), generator=gen) * 4
    got = kpcn.kernel_apply(lg.to(cuda_device), rad.to(cuda_device), k)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.cpu(), kpcn.kernel_apply_plain(lg, rad, k), rtol=1e-5,
                               atol=4e-6)


@pytest.mark.cuda
def test_a_card_frame_meets_the_reference(cuda_device):
    """The whole frame at the published widths on the card: 9 K11 launches
    and 1 K12, within the CPU tests' bars of the reference."""
    g = gbuffer(96, 80, 5)
    p = kpcn.init_kpcn(5, PUBLISHED, cuda_device)
    launches = (ck.KERNEL5.launches, kpcn.APPLY_KERNEL.launches)
    y, lg = kpcn.apply_kpcn_frame(p, g.to(cuda_device), return_logits=True)
    torch.cuda.synchronize()
    assert (ck.KERNEL5.launches - launches[0], kpcn.APPLY_KERNEL.launches - launches[1]) == (9, 1)
    pc = {k: {n: t.cpu() for n, t in v.items()} for k, v in p.items()}
    y_ref, w_ref = ref.frame(pc, g, 21)
    y_wit, w_wit = ref.frame(pc, g, 21, quant="bf16")
    w_port = torch.softmax(lg[..., :441].float(), -1).permute(0, 3, 1, 2).cpu()
    assert rel_l2(w_port, w_wit) < 0.015 and rel_l2(y.permute(0, 3, 1, 2).cpu(), y_wit) < 0.004
    assert rel_l2(y.permute(0, 3, 1, 2).cpu(), y_ref) < 1.5 * rel_l2(y_wit, y_ref)
