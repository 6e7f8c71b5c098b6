"""The port's binned mesh pipeline (K5's and K6's functions and the whole)
on the CPU, against the JAX package and against the port's own dense scan.

The JAX side runs its Pallas kernels in interpret mode, as
tests/test_binned.py does; on CPU tensors the port's wrappers run the
kernels' plain versions.  Phase 1 emits integers (bin ids and counts) and
must agree exactly, 0 * inf rays included; the pair kernel's face ids must
agree exactly and its t within rtol 3e-6, atol 1e-6 (see
tests/test_torch_bvh.py for that bar and for the normals').

The JAX ``mesh_intersect_binned`` calls phase 1 with the unclamped slot
count on meshes of fewer than 12 bins, where it is not sound, so there the
port is held against its own dense scan instead: bit for bit, since both
are the same PyTorch arithmetic on the CPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_path_tracer_denoiser_tpu.render import mesh_binned as jbinned
from ai_path_tracer_denoiser_tpu_torch.ops import bvh as tbvh
from ai_path_tracer_denoiser_tpu_torch.render import mesh_binned, mesh_kernel_v2p
from ai_path_tracer_denoiser_tpu_torch.utils import timers
from test_torch_bvh import (RTOL, ATOL, _assert_close, _boundary_rays, assert_same_hits,
                            both_bvhs, cull_distances, jvec, rays, soup, tvec)

torch.set_num_threads(2)


def _cull(tc):
    return None if tc is None else torch.from_numpy(tc)


def assert_equals_scan(tb, o, d, tc, expect=None, **caps):
    """The binned pipeline equals the dense scan bit for bit (CPU)."""
    before = timers.totals()
    got = mesh_binned.mesh_intersect_binned(tb, tvec(o), tvec(d), _cull(tc), **caps)
    want = mesh_kernel_v2p.mesh_intersect_bvh_v2p_plain(tb, tvec(o), tvec(d), _cull(tc))
    assert torch.equal(got[0], want[0]) and torch.equal(got[3], want[3])
    for a, b in ((got[1], want[1]), (got[2], want[2])):
        for ca, cb in zip(a, b):
            assert torch.equal(ca, cb)
    if expect:
        key = "binned." + expect
        after = timers.totals()
        assert after.get(key, 0) == before.get(key, 0) + 1, after
    return got


def _zero_and_subnormal_directions(o, d):
    """Direction components that are -0 (1/d = -inf) or subnormal below
    2**-128, whose inverse overflows to +-inf.  XLA:CPU flushes subnormal
    operands to zero, so the JAX side takes 1/+-0 = +-inf there: the two
    agree.  Above 2**-128 the port's inverse (IEEE, on the CPU and on the
    card) is finite where the flushed one is infinite (ROADMAP C); the card
    tests hold the kernel to its plain version there."""
    d[0, 1::6] = -0.0
    d[1, 2::7] = np.float32(1e-40)
    d[2, ::9] = np.float32(-1.5e-39)
    sub = (np.abs(d) < np.finfo(np.float32).tiny) & (d != 0)
    assert sub.sum() > 1000 and (np.abs(d[sub]) < 2.0 ** -128).all()
    return o, d


@pytest.mark.parametrize("skip,rays_kind", [
    (0, "boundary"), (6, "boundary"), (0, "zero_subnormal"), (6, "zero_subnormal"),
    (0, "dead_tail"), (6, "dead_tail")],
    ids=["0", "6", "zero_subnormal-0", "zero_subnormal-6", "dead_tail-0", "dead_tail-6"])
def test_phase1_equals_jax_kernel(skip, rays_kind):
    """Boundary rays (0 * inf slabs); with -0 and subnormal direction
    components as well; and a packed prefix whose last 1,500 rays are dead
    (t_cull = -inf), as the pipeline hands them over."""
    jb, tb = both_bvhs(4096, seed=3)
    kb = jb.n_supers_real
    assert kb == 16
    n = 4096
    o, d = _boundary_rays(jb.super_bounds, n, seed=8)
    tc = cull_distances(n, seed=9, dead_every=7)
    tc[3::11] = np.inf
    if rays_kind == "zero_subnormal":
        o, d = _zero_and_subnormal_directions(o, d)
    elif rays_kind == "dead_tail":
        tc[n - 1500:] = -np.inf
    c_out = 6
    js, jc = jbinned._phase1(jvec(o), jvec(d), jnp.asarray(tc), jb.super_bounds,
                             kb, skip, c_out, interpret=True)
    launches = mesh_binned.PHASE1_KERNEL.launches
    ts, tcn = mesh_binned._phase1(tvec(o), tvec(d), torch.from_numpy(tc),
                                  tb.super_bounds, kb, skip, c_out)
    assert mesh_binned.PHASE1_KERNEL.launches == launches
    assert ts.dtype == tcn.dtype == torch.int32 and ts.shape == (c_out, n)
    np.testing.assert_array_equal(tcn.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert int(tcn.max()) > skip + c_out         # some rays overflow the slots
    assert (ts.numpy() == mesh_binned._DEADKEY).any()
    if rays_kind == "dead_tail":
        assert not tcn.numpy()[n - 1500:].any()


def _jax_pair_call(jb, o, d, key, kb):
    """The JAX pair kernel on a bin-sorted pair table, laid out as its
    ``_binned_core`` lays it out (1024-lane tiles, per-tile bin ranges)."""
    lanes = jbinned.LANES
    s_total = key.shape[0]
    n_tiles = -(-s_total // lanes)
    pad = n_tiles * lanes - s_total
    key_p = np.pad(key, (0, pad), constant_values=jbinned._DEADKEY)
    planes = [np.pad(c, (0, pad)) for c in (*o, *d)]
    krows = key_p.reshape(n_tiles, lanes)
    k_hi = np.where(krows < kb, krows, -1).max(axis=1)
    empty = k_hi < 0
    meta = np.stack([np.where(empty, 1, krows[:, 0]), np.where(empty, 0, k_hi)],
                    axis=1).astype(np.int32)
    mpad = -(-n_tiles // 8) * 8 - n_tiles
    meta = np.concatenate([meta, np.tile(np.array([[1, 0]], np.int32), (mpad, 1))])
    pairs = np.stack([*planes, key_p.astype(np.float32), np.zeros_like(planes[0])]
                     ).reshape(8, n_tiles, lanes).swapaxes(0, 1)
    out = jbinned._pair_call(jnp.asarray(meta), jnp.asarray(pairs), jb.faces_packed,
                             interpret=True)
    flat = np.asarray(out).swapaxes(0, 1).reshape(8, -1)
    return flat[0][:s_total], flat[1][:s_total].astype(np.int32)


def test_pair_call_equals_jax_kernel():
    jb, tb = both_bvhs(2048, seed=5)
    kb = tb.n_supers_real
    n = 1500
    o, d = rays(n, seed=3)
    tc = torch.from_numpy(cull_distances(n, seed=4))
    slots, counts = mesh_binned._phase1(tvec(o), tvec(d), tc, tb.super_bounds, kb, 0, kb)
    assert int(counts.max()) > 1
    key = slots.T.reshape(-1)                                # ray-major
    perm = torch.sort(key, stable=True).indices
    rep = lambda c: torch.from_numpy(c)[:, None].expand(n, kb).reshape(-1)[perm].contiguous()
    po, pd = [rep(c) for c in o], [rep(c) for c in d]
    key = key[perm].contiguous()
    launches = mesh_binned.PAIR_KERNEL.launches
    t_t, f_t = mesh_binned._pair_call(tvec([c.numpy() for c in po]),
                                      tvec([c.numpy() for c in pd]), key,
                                      tb.faces_packed, kb)
    assert mesh_binned.PAIR_KERNEL.launches == launches
    t_j, f_j = _jax_pair_call(jb, [c.numpy() for c in po], [c.numpy() for c in pd],
                              key.numpy(), kb)
    assert f_t.dtype == torch.int32
    np.testing.assert_array_equal(f_t.numpy(), f_j)
    hit = f_j >= 0
    assert hit.sum() > 50 and not np.isfinite(t_t.numpy()[~hit]).any()
    assert (f_t.numpy()[hit] // mesh_binned.BIN == key.numpy()[hit]).all()
    np.testing.assert_allclose(t_t.numpy()[hit], t_j[hit], rtol=RTOL, atol=ATOL)


def _pair_table(tb, layout, seed):
    """A bin-sorted pair table for the pair kernel's block layouts (its
    blocks hold 128 or 256 pairs): each pair's ray aims at a face of its
    bin from outside the soup, so most pairs hit.

    ``straddle``: runs of 1-60 pairs, so one block holds several bins;
    ``gaps``: only every third bin has pairs; ``single``: every bin one pair,
    between runs of other bins; ``dead_tail``: 300 real pairs, then 77 of the
    dead key (the tail starts inside a block)."""
    rng = np.random.default_rng(seed)
    kb = tb.n_supers_real
    if layout == "straddle":
        keys = np.repeat(np.arange(kb), rng.integers(1, 61, kb))
    elif layout == "gaps":
        keys = np.repeat(np.arange(0, kb, 3), rng.integers(20, 90, len(range(0, kb, 3))))
    elif layout == "single":
        runs = np.where(np.arange(kb) % 2 == 0, 1, rng.integers(30, 70, kb))
        keys = np.repeat(np.arange(kb), runs)
    else:
        keys = np.sort(rng.integers(0, kb, 300))
    n = keys.shape[0]
    faces = tb.faces_packed[:, :9].numpy().reshape(-1, 3, 3)
    target = np.einsum("nc,ncx->xn", rng.dirichlet(np.ones(3), n),
                       faces[keys * mesh_binned.BIN + rng.integers(0, mesh_binned.BIN, n)])
    u = rng.normal(size=(3, n))
    o = (target + 9.0 * u / np.linalg.norm(u, axis=0)).astype(np.float32)
    d = target - o
    d = (d / np.linalg.norm(d, axis=0)).astype(np.float32)
    if layout == "dead_tail":
        keys = np.concatenate([keys, np.full(77, mesh_binned._DEADKEY)])
        o = np.concatenate([o, o[:, :77]], axis=1)
        d = np.concatenate([d, d[:, :77]], axis=1)
    return o, d, keys.astype(np.int32)


@pytest.mark.parametrize("layout", ["straddle", "gaps", "single", "dead_tail"])
def test_pair_call_equals_jax_kernel_on_block_layouts(layout):
    jb, tb = both_bvhs(4096, seed=5)
    kb = tb.n_supers_real
    o, d, key = _pair_table(tb, layout, seed=11)
    launches = mesh_binned.PAIR_KERNEL.launches
    t_t, f_t = mesh_binned._pair_call(tvec(o), tvec(d), torch.from_numpy(key),
                                      tb.faces_packed, kb)
    assert mesh_binned.PAIR_KERNEL.launches == launches
    t_j, f_j = _jax_pair_call(jb, list(o), list(d), key, kb)
    np.testing.assert_array_equal(f_t.numpy(), f_j)
    hit = f_j >= 0
    real = key < kb
    assert hit.sum() > real.sum() // 2 and not hit[~real].any()
    assert not np.isfinite(t_t.numpy()[~hit]).any()
    assert (f_t.numpy()[hit] // mesh_binned.BIN == key[hit]).all()
    # Rays that aim at a face from any side include a few grazing hits (1/a
    # large), where XLA:CPU and PyTorch differ in the last bits of t by up
    # to 2e-5 relative: the bar of test_binned_matches_jax_binned, 0.5% of
    # the hits may miss it and then stay within 1e-4.
    _assert_close(t_t.numpy()[hit], t_j[hit], RTOL, ATOL, outliers=0.005)


@pytest.mark.parametrize("with_cull", [False, True])
def test_binned_matches_jax_binned(with_cull):
    """16 bins (>= C_A): the JAX fast path is sound, and with caps as wide
    as the batch both sides take it (the default caps, a quarter of the
    batch, would send these all-live rays to the fallback)."""
    jb, tb = both_bvhs(4096, seed=21)
    n = 4096
    o, d = rays(n, seed=2)
    tc = cull_distances(n, seed=4) if with_cull else None
    want = jbinned.mesh_intersect_binned(
        jb, jvec(o), jvec(d), None if tc is None else jnp.asarray(tc), interpret=True,
        lcap=n, lcapb=n)
    fast = timers.totals().get("binned.fast", 0)
    got = mesh_binned.mesh_intersect_binned(tb, tvec(o), tvec(d), _cull(tc),
                                            lcap=n, lcapb=n)
    assert timers.totals()["binned.fast"] == fast + 1
    # One grazing hit of these 517-714 (1/a large in the triangle test) is
    # ill-conditioned: XLA:CPU and PyTorch differ there by 6e-6 in t and
    # 5e-6 in the point.  So up to 0.5% of the hits may miss the bar, and
    # then stay within 1e-4; hit mask and material are exact throughout.
    assert_same_hits(got, want, outliers=0.005)


@pytest.mark.parametrize("n_faces,bins", [(12, 1), (300, 2), (2048, 8), (4096, 16)])
def test_binned_equals_dense_scan(n_faces, bins):
    v, n_, m = soup(n_faces, seed=n_faces)
    tb, _ = tbvh.build_mesh_bvh(v, n_, m)
    assert tb.n_supers_real == bins
    o, d = rays(4096, seed=2)
    got = assert_equals_scan(tb, o, d, None, expect="fast", lcap=4096, lcapb=4096)
    assert torch.isfinite(got[0]).sum() > 0
    assert_equals_scan(tb, o, d, None, expect="fallback")   # default caps: a quarter


@pytest.mark.parametrize("n_faces", [300, 2048])
def test_binned_equals_dense_scan_with_mostly_dead_lanes(n_faces):
    """80% of the lanes dead, on meshes of fewer bins than slots: the case
    in which an unclamped phase-1 slot count breaks the un-flattening."""
    v, n_, m = soup(n_faces, seed=7)
    tb, _ = tbvh.build_mesh_bvh(v, n_, m)
    n = 4096
    o, d = rays(n, seed=3)
    tc = np.random.default_rng(4).uniform(0.5, 20.0, n).astype(np.float32)
    tc[np.arange(n) % 5 != 0] = -np.inf
    got = assert_equals_scan(tb, o, d, tc, expect="fast")
    hits = torch.isfinite(got[0]).numpy()
    assert hits.sum() > 0 and not hits[np.arange(n) % 5 != 0].any()


@pytest.mark.parametrize("caps", [dict(lcap=64, lcapb=64), dict(lcap=4096, lcapb=1)])
def test_binned_falls_back_on_tiny_caps(caps):
    v, n_, m = soup(8192, seed=9)               # 32 bins: rays overflow 12 slots
    tb, _ = tbvh.build_mesh_bvh(v, n_, m)
    o, d = rays(2048, seed=5)
    assert_equals_scan(tb, o, d, None, expect="fallback", **caps)


def test_binned_all_lanes_dead():
    v, n_, m = soup(600, seed=11)
    tb, _ = tbvh.build_mesh_bvh(v, n_, m)
    o, d = rays(1024, seed=6)
    tc = np.full((1024,), -np.inf, np.float32)
    t, p, nrm, mat = assert_equals_scan(tb, o, d, tc, expect="fast")
    assert not torch.isfinite(t).any() and (mat == -1).all()


def test_default_caps_and_work_counts():
    assert mesh_binned.default_caps(640000) == (160768, 40960)
    assert mesh_binned.default_caps(100) == (1024, 1024)
    key = torch.tensor([0, 0, 3, mesh_binned._DEADKEY], dtype=torch.int32)
    assert mesh_binned.pair_work(key, 4, 1024) == (4 * (36 + 1024 * 19), 3 * 256)
    t_cull = torch.full((1000,), 5.0)
    t_cull[::4] = float("-inf")                   # dead rays need no slab test
    assert mesh_binned.phase1_work(t_cull, 20, 12) == (4 * (20000 + 160), 750 * 20)
