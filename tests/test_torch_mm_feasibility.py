"""The visit-cost probe's two kernels' plain versions (K9a scalar visit, K9b
matrix-product visit) against the JAX kernels of
tools/exp_mm_feasibility.py, on the CPU.

The JAX tool is loaded by path; its kernel bodies (``build_vpu_kernel``,
``build_mxu_kernel``) run through ``pl.pallas_call(..., interpret=True)`` with
the tool's own specs and ``n_visits`` = 64, after which the state no longer
changes (a strict ``<`` over 64 repeating clusters).  Inputs are the tool's:
standard normal draws from numpy's generator.

Tolerances.  The random "faces" meet the rays at every angle, so winners sit
next to the tests' thresholds and their t = tn / den amplifies the last bit
(XLA:CPU contracts multiply-adds, PyTorch does not): the miss masks must
agree on all but 1% of the 1024 rays, and on the rays where both packages
pick the same face, t and the winner's point / normal / material agree to
rtol 1e-4, atol 1e-5 (scalar visit) and t to rtol 1e-3, atol 1e-5 (product
visit, whose numerator is a cancelled sum of ten products); such rays must
be at least 97% of all.  The TF32 plain version is held to its definition
(operands rounded to 10 mantissa bits) instead: JAX's DEFAULT precision is
plain float32 on the CPU.

The split schedule the kernels run on the card (contiguous visit ranges,
partial states merged in range order) is held to the sequential plain
version bit for bit.
"""
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from ai_path_tracer_denoiser_tpu_torch.tools import mm_feasibility as mf

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parent.parent
N_VISITS = 64


@pytest.fixture(scope="module")
def jax_tool():
    spec = importlib.util.spec_from_file_location(
        "exp_mm_feasibility", REPO / "tools" / "exp_mm_feasibility.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def inputs():
    return mf.probe_inputs(0, "cpu")


def jax_vpu(tool, rays, faces):
    return pl.pallas_call(
        tool.build_vpu_kernel(N_VISITS),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM), pl.BlockSpec(memory_space=pltpu.ANY)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((8, tool.LANES), jnp.float32),
        scratch_shapes=[pltpu.VMEM((8, tool.LANES), jnp.float32),
                        pltpu.VMEM((tool.CLUSTER, 128), jnp.float32),
                        pltpu.SemaphoreType.DMA(())],
        interpret=True)(jnp.asarray(rays.numpy()), jnp.asarray(faces.numpy()))


def jax_mxu(tool, rays, coeffs, precision):
    return pl.pallas_call(
        tool.build_mxu_kernel(N_VISITS, precision),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM), pl.BlockSpec(memory_space=pltpu.ANY)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((8, tool.LANES), jnp.float32),
        scratch_shapes=[pltpu.VMEM((8, tool.LANES), jnp.float32),
                        pltpu.VMEM((16, tool.LANES), jnp.float32),
                        pltpu.VMEM((128, tool.LANES), jnp.float32),
                        pltpu.VMEM((1, 16, 128), jnp.float32),
                        pltpu.SemaphoreType.DMA(())],
        interpret=True)(jnp.asarray(rays.numpy()), jnp.asarray(coeffs.numpy()))


def agreeing_rays(got, want, same_face):
    """Rays that hit in both packages with the same winner; checks the miss
    masks (<= 1% apart) and the share of such rays (>= 97%)."""
    hit_g, hit_w = got[0] < 1e38, want[0] < 1e38
    assert (hit_g != hit_w).mean() <= 0.01
    both = hit_g & hit_w & same_face
    assert both.sum() >= 0.97 * max((hit_g | hit_w).sum(), 1) and both.sum() > 500
    return both


def test_probe_constants_match_the_jax_tool(jax_tool):
    assert (mf.LANES, mf.CLUSTER, mf.N_VISITS) == (jax_tool.LANES, jax_tool.CLUSTER, 32768)
    rays, faces, coeffs = mf.probe_inputs(0, "cpu")
    assert rays.shape == (8, 1024) and faces.shape == (2048, 128)
    assert coeffs.shape == (64, 16, 128)


def test_scalar_visit_matches_jax_kernel(jax_tool, inputs):
    rays, faces, _ = inputs
    want = np.asarray(jax_vpu(jax_tool, rays, faces))
    launches = mf.VPU_KERNEL.launches
    got = mf.visit_vpu(rays, faces, N_VISITS).numpy()
    assert mf.VPU_KERNEL.launches == launches           # CPU tensors: the plain version
    assert got.shape == want.shape == (8, 1024)
    # the material row is the winner's column 18: equal where the same face won
    both = agreeing_rays(got, want, got[7] == want[7])
    np.testing.assert_allclose(got[:, both], want[:, both], rtol=1e-4, atol=1e-5)
    missed = ~(got[0] < 1e38)
    assert (got[0, missed] == np.float32(3e38)).all() and (got[1:, missed] == 0).all()


@pytest.mark.parametrize("precision", ["DEFAULT", "HIGHEST"])
def test_product_visit_matches_jax_kernel(jax_tool, inputs, precision):
    rays, _, coeffs = inputs
    want = np.asarray(jax_mxu(jax_tool, rays, coeffs, getattr(jax.lax.Precision, precision)))
    got = mf.visit_mma_plain(rays, coeffs, N_VISITS).numpy()
    assert got.shape == want.shape == (8, 1024) and (got[2:] == 0).all()
    both = agreeing_rays(got, want, got[1] == want[1])
    np.testing.assert_allclose(got[0, both], want[0, both], rtol=1e-3, atol=1e-5)
    assert got[1].min() >= 0 and got[1].max() < 2048 and (got[1] == np.round(got[1])).all()


def test_features_match_the_jax_kernel_rows(inputs):
    rays, _, _ = inputs
    f = mf.visit_features(rays).numpy()
    r = rays.numpy()
    np.testing.assert_array_equal(f[0:3], r[3:6])
    np.testing.assert_array_equal(f[6:9], r[0:3])
    np.testing.assert_allclose(f[3:6], np.cross(r[0:3].T, r[3:6].T).T, rtol=1e-5, atol=1e-6)
    assert (f[9] == 1).all() and (f[10:] == 0).all() and f.shape == (16, 1024)


def test_state_stops_changing_after_64_visits(inputs):
    rays, faces, coeffs = inputs
    assert torch.equal(mf.visit_vpu(rays, faces, 64), mf.visit_vpu(rays, faces, 32768))
    assert torch.equal(mf.visit_mma(rays, coeffs, 64, True), mf.visit_mma(rays, coeffs, 500, True))
    first = mf.visit_vpu_plain(rays, faces, 8)
    assert (first[0] < 1e38).sum() < (mf.visit_vpu_plain(rays, faces, 64)[0] < 1e38).sum()


def test_tf32_rounding_and_the_wrapper_precisions(inputs):
    rays, _, coeffs = inputs
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10, -1.0 - 2.0 ** -11, 3e38, 0.0])
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, -1.0 - 2.0 ** -10, 3e38, 0.0])
    got = mf.round_tf32(x)
    assert torch.equal(got[:4], want[:4]) and got[5] == 0
    assert (mf.round_tf32(coeffs).view(torch.int32) & 0x1FFF == 0).all()
    assert ((mf.round_tf32(coeffs) - coeffs).abs() <= coeffs.abs() * 2.0 ** -11).all()
    # CPU wrapper: highest -> float32, otherwise operands rounded to TF32
    assert torch.equal(mf.visit_mma(rays, coeffs, 64, True), mf.visit_mma_plain(rays, coeffs))
    tf32 = mf.visit_mma(rays, coeffs, 64, False)
    assert torch.equal(tf32, mf.visit_mma_plain(rays, coeffs, precision="tf32"))
    assert not torch.equal(tf32, mf.visit_mma_plain(rays, coeffs))
    with pytest.raises(ValueError):
        mf.visit_mma_plain(rays, coeffs, precision="bf16")


@pytest.mark.parametrize("bad", ["rays", "table", "dtype"])
def test_wrappers_reject_other_shapes(inputs, bad):
    rays, faces, coeffs = inputs
    if bad == "rays":
        rays = rays[:, :512]
    elif bad == "table":
        faces, coeffs = faces[:1024], coeffs[:32]
    else:
        rays = rays.double()
    with pytest.raises(ValueError, match="expected float32"):
        mf.visit_vpu(rays, faces, 64)
    with pytest.raises(ValueError, match="expected float32"):
        mf.visit_mma(rays, coeffs, 64)


@pytest.mark.parametrize("splits", [1, 2, 7, 264])
@pytest.mark.parametrize("n_visits", [64, 200, 1000, 5])
def test_split_schedule_equals_the_sequential_state(inputs, n_visits, splits):
    """The kernels' schedule (each block's visit range run from its first
    visit, the partial states merged in range order by a strict ``<``) is
    the sequential state bit for bit, with uneven and empty ranges."""
    rays, faces, coeffs = inputs
    ranges = mf.visit_ranges(n_visits, splits)
    assert len(ranges) == splits and ranges[0][0] == 0 and ranges[-1][1] == n_visits
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    sizes = [hi - lo for lo, hi in ranges]
    assert max(sizes) - min(sizes) <= 1 and (min(sizes) == 0) == (n_visits < splits)
    got = mf.split_visits_plain(mf.visit_vpu_plain, n_visits, splits, rays=rays, faces=faces)
    assert torch.equal(got, mf.visit_vpu_plain(rays, faces, n_visits))
    for precision in ("float32", "tf32"):
        got = mf.split_visits_plain(mf.visit_mma_plain, n_visits, splits, rays=rays,
                                    coeffs=coeffs, precision=precision)
        assert torch.equal(got, mf.visit_mma_plain(rays, coeffs, n_visits, precision))


def test_a_tie_across_ranges_keeps_the_earlier_winner(inputs):
    """Cluster 40 is cluster 10 again (another material; coefficient block
    40 is block 10): ranges [0, 32) and [32, 64) find the same t, and the
    merge keeps range 0's winner, as the sequential visits do; merged the
    other way round the later one would win."""
    rays, faces, coeffs = inputs
    faces, coeffs = faces.clone(), coeffs.clone()
    faces[40 * 32:41 * 32] = faces[10 * 32:11 * 32]
    faces[40 * 32:41 * 32, 18] += 1.0
    coeffs[40] = coeffs[10]
    for plain, kwargs, from_10 in (
            (mf.visit_vpu_plain, {"faces": faces},
             lambda st: torch.isin(st[7], faces[10 * 32:11 * 32, 18])),
            (mf.visit_mma_plain, {"coeffs": coeffs},
             lambda st: (st[1] >= 10 * 32) & (st[1] < 11 * 32))):
        want = plain(rays=rays, n_visits=64, **kwargs)
        parts = [plain(rays=rays, n_visits=hi - lo, start=lo, **kwargs)
                 for lo, hi in mf.visit_ranges(64, 2)]
        tied = parts[0][0] == parts[1][0]
        won = from_10(parts[0]) & tied & (parts[0][0] < 1e38)
        assert won.sum() > 0 and torch.equal(mf.merge_visit_states(parts), want)
        assert from_10(want)[won].all()
        assert not torch.equal(mf.merge_visit_states(parts[::-1])[:, won], want[:, won])


def test_visit_counter_on_the_cpu_is_the_plain_versions_count(inputs):
    rays, faces, coeffs = inputs
    counter = torch.full((1,), 7, dtype=torch.int32)
    mf.visit_vpu(rays, faces, 200, visit_counter=counter)
    assert int(counter) == 64
    mf.visit_mma(rays, coeffs, 20, True, visit_counter=counter)
    assert int(counter) == 20
    with pytest.raises(ValueError, match="visit_counter"):
        mf.visit_vpu(rays, faces, 64, visit_counter=torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="splits"):
        mf.visit_ranges(64, 0)


def test_sort_and_gather_benches_run_small():
    sort = mf.run_sort_bench("cpu", sizes=(20_000,))
    assert set(sort) == {"sort_keys_20000_ms", "sort_kv_20000_ms"}
    gather = mf.run_gather_bench("cpu", rows=4096, n_idx=10_000)
    assert set(gather) == {"gather_rows128_ms", "gather_rows19_ms", "gather_planes4_ms"}
    assert all(v > 0 for v in {**sort, **gather}.values())
    visit = mf.run_visit_bench("cpu", n_visits=64)
    assert visit["n_visits"] == 64 and visit["vpu_us_per_visit"] > 0
