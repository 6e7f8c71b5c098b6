"""Binned (pair-packed) mesh intersection (counterpart of render/mesh_binned.py).

A ray is tested only against the bins (supers of ``BIN`` = 256 Morton-ordered
faces) whose box it enters before its cull distance, and the (ray, bin)
pairs are sorted by bin so that neighbouring pairs walk the same faces:

  1. **Subscribe** (kernel, csrc/mesh_binned_phase1.cu): rays with a cull
     distance above -inf are compacted to a prefix of ``lcap`` lanes; each
     slab-tests every bin and emits its live bin ids in ascending order into
     ``c_a`` slots.  Rays with more live bins than that are compacted again
     (at most ``lcapb``) and emit ``c_b`` more, skipping the first ``c_a``.
  2. **Pack**: both tiers flatten into one (bin, o, d) pair table, sorted by
     bin (one stable sort).
  3. **Intersect** (kernel, csrc/mesh_binned_pair.cu): each pair against its
     bin's 256 faces, first minimal row; (t, face id) come back, pairs
     return to slot order, slots min-reduce per ray with the scan's
     tie-break (earliest bin), and the winner's t, point, normal and
     material are computed from its face row with the scan's own
     ``_triangle_t``.

Every face test is the dense scan's arithmetic on the same float32 inputs, a
face that can win (t < t_cull) always subscribes its bin (widened boxes,
ops/bvh.py), and the merge is the scan's first-minimal-face rule, so the
result equals ``mesh_intersect_bvh_v2p``'s.

A batch with more live rays than ``lcap``, more overflow rays than ``lcapb``
or a ray in more than ``c_a + c_b`` bins goes to the per-ray traversal
(render/mesh_kernel_v2p.py) for the whole call: a Python branch on a value
read back from the device, one synchronisation per call (the host read
``sync.binned_fit``).  The counters ``binned.fast`` and ``binned.fallback``
(utils/timers.py) count how often each side ran.

Unlike the JAX function, phase 1 is called with the clamped slot count
``c_a`` (not ``C_A``) and the fit test uses ``c_a + c_b``, so meshes of
fewer than ``C_A`` bins are exact too.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import torch

from ..ops.bvh import CLUSTER, FANOUT, MeshBVH
from ..ops.intersect import _triangle_t
from ..ops.vec3 import Vec3
from ..utils.cuda_build import CudaKernel, check
from ..utils.timers import count, host_read
from .mesh_kernel_v2p import (EDGE_COLS, _check_bvh, _slab_live, mesh_intersect_bvh_v2p,
                              packed_edges, ray_planes, table_ptr)

BIN = FANOUT * CLUSTER          # faces per bin = one super (256)
# Slot counts: runtime arguments of the subscription kernel, so the JAX
# package's levers (read at import) reach the card as they are.
C_A = int(os.environ.get("APTD_BINNED_CA", "12"))   # slots for every ray
C_B = int(os.environ.get("APTD_BINNED_CB", "20"))   # extra slots for overflow rays
_GRANULE = 1024                 # the packing prefixes round up to this
_INF = float("inf")
_DEADKEY = 1 << 20              # sorts past every real bin id


def _declare_phase1(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.aptd_binned_phase1.restype = i
    lib.aptd_binned_phase1.argtypes = [p] * 7 + [i, p, i, i, i, p, p, p]


def _declare_pair(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.aptd_binned_pair.restype = i
    lib.aptd_binned_pair.argtypes = [p] * 7 + [i, p, i, p, p, p]
    lib.aptd_rcp_fast_mismatches.restype = i
    lib.aptd_rcp_fast_mismatches.argtypes = [p, p]


_HEADERS = ("mesh_common.cuh", "bulk_copy.cuh")
PHASE1_KERNEL = CudaKernel("mesh_binned_phase1", "mesh_binned_phase1.cu",
                           extra_flags=("-fmad=false",), declare=_declare_phase1,
                           headers=_HEADERS)
PAIR_KERNEL = CudaKernel("mesh_binned_pair", "mesh_binned_pair.cu",
                         extra_flags=("-fmad=false",), declare=_declare_pair,
                         headers=_HEADERS)


def rcp_fast_mismatches(device) -> int:
    """How many floats a in [2^-23, 2^126) the pair kernel's fast reciprocal
    gets other than the IEEE quotient 1.0f / a (every one is tried, on the
    card); the kernel's bit-for-bit claim needs 0."""
    out = torch.zeros((1,), dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        rc = PAIR_KERNEL.lib().aptd_rcp_fast_mismatches(
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    check(rc, "reciprocal check kernel")
    return int(out.item())


def _aligned_ptr(table: torch.Tensor, cols: int, device) -> int:
    """``table_ptr``, and the table must start on a 16-byte boundary: the
    kernels copy it into shared memory in 16-byte pieces."""
    ptr = table_ptr(table, cols, device)
    if ptr % 16:
        raise ValueError(f"table of {cols} columns at {ptr:#x}: not 16-byte aligned")
    return ptr


# ---------------------------------------------------------------------------
# Phase 1: bin subscription
# ---------------------------------------------------------------------------

def _phase1_plain(o: Vec3, d: Vec3, t_cull: torch.Tensor, bounds: torch.Tensor,
                  kb: int, skip: int, c_out: int, chunk: int = 1 << 16):
    """The subscription kernel's plain PyTorch version: a (kb, n) liveness
    matrix, its running count along the bins, and one select per slot."""
    n = t_cull.shape[0]
    dev = t_cull.device
    slots = torch.full((c_out, n), _DEADKEY, dtype=torch.int32, device=dev)
    counts = torch.zeros((n,), dtype=torch.int32, device=dev)
    bins = torch.arange(kb, dtype=torch.int32, device=dev)[:, None]
    for lo in range(0, n, chunk):
        s = slice(lo, min(lo + chunk, n))
        oc, dc = Vec3(*(c[s] for c in o)), Vec3(*(c[s] for c in d))
        inv = Vec3(1.0 / dc.x, 1.0 / dc.y, 1.0 / dc.z)
        live = _slab_live(bounds[:kb], oc, inv, t_cull[s])        # (kb, m)
        rank = torch.cumsum(live, dim=0, dtype=torch.int32) - 1  # among live
        counts[s] = live.sum(dim=0, dtype=torch.int32)
        for j in range(c_out):
            pick = live & (rank == skip + j)                     # <= 1 per ray
            slots[j, s] = torch.where(pick.any(dim=0),
                                      (pick * bins).sum(dim=0, dtype=torch.int32),
                                      _DEADKEY)
    return slots, counts


def _phase1(o: Vec3, d: Vec3, t_cull: torch.Tensor, bounds: torch.Tensor,
            kb: int, skip: int, c_out: int):
    """Live bins per ray: (slots (c_out, n) int32, counts (n,) int32).

    Slot j holds the ray's live bin number ``skip + j`` in ascending bin
    order, ``_DEADKEY`` when it has fewer; ``counts`` counts every live bin
    of the ``kb`` real ones.  CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise.
    """
    if t_cull.device.type == "cpu":
        return _phase1_plain(o, d, t_cull, bounds, kb, skip, c_out)
    dev = t_cull.device
    n = t_cull.shape[0]
    if not 0 < kb <= bounds.shape[0] or skip < 0 or c_out < 1:
        raise ValueError(f"phase 1: kb={kb} of {bounds.shape[0]} rows, "
                         f"skip={skip}, c_out={c_out}")
    planes = ray_planes(o, d, t_cull)
    bounds_ptr = _aligned_ptr(bounds, 8, dev)
    slots = torch.empty((c_out, n), dtype=torch.int32, device=dev)
    counts = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return slots, counts
    lib = PHASE1_KERNEL.lib()
    with torch.cuda.device(dev):
        rc = lib.aptd_binned_phase1(
            *(p.data_ptr() for p in planes), n, bounds_ptr, kb,
            skip, c_out, slots.data_ptr(), counts.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    check(rc, "binned phase-1 kernel")
    PHASE1_KERNEL.launches += 1
    return slots, counts


# ---------------------------------------------------------------------------
# Phase 3: the pair kernel
# ---------------------------------------------------------------------------

def _pair_plain(o: Vec3, d: Vec3, key: torch.Tensor, faces_packed: torch.Tensor,
                kb: int, rows_per_step: int = 32, chunk: int = 1 << 15):
    """The pair kernel's plain PyTorch version: gather each pair's face
    rows, ``rows_per_step`` at a time, and keep the first minimal hit."""
    n = key.shape[0]
    dev = key.device
    t_best = torch.full((n,), _INF, dtype=torch.float32, device=dev)
    f_best = torch.full((n,), -1, dtype=torch.int32, device=dev)
    steps = torch.arange(rows_per_step, device=dev)
    for lo in range(0, n, chunk):
        s = slice(lo, min(lo + chunk, n))
        k = key[s].long()
        real = (k >= 0) & (k < kb)
        base = torch.where(real, k, 0) * BIN
        o2 = Vec3(*(c[s, None] for c in o))
        d2 = Vec3(*(c[s, None] for c in d))
        t_c = torch.full((k.shape[0],), _INF, dtype=torch.float32, device=dev)
        f_c = torch.full((k.shape[0],), -1, dtype=torch.int64, device=dev)
        for r0 in range(0, BIN, rows_per_step):
            fid = base[:, None] + (r0 + steps)[None, :]          # (m, rows)
            rows = faces_packed[fid]                             # (m, rows, 19)
            v0, v1, v2 = (Vec3(rows[..., 3 * c], rows[..., 3 * c + 1],
                               rows[..., 3 * c + 2]) for c in range(3))
            t, _, _, hit = _triangle_t(v0, v1, v2, o2, d2)
            t = torch.where(hit & (t > 0.0) & real[:, None], t, _INF)
            t_r, j = torch.min(t, dim=1)                         # first minimal
            better = t_r < t_c               # strict: earlier rows keep ties
            t_c = torch.where(better, t_r, t_c)
            f_c = torch.where(better, base + r0 + j, f_c)
        t_best[s] = t_c
        f_best[s] = f_c.to(torch.int32)
    return t_best, f_best


def _pair_call(o: Vec3, d: Vec3, key: torch.Tensor, faces_packed: torch.Tensor,
               kb: int):
    """Each (o, d, key) pair against the 256 faces of bin ``key``:
    (t (n,) f32, face id (n,) int32), (+inf, -1) on a miss and for keys
    outside [0, kb).  CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise.  The kernel reads the faces from the packed
    (v0, e1, e2) table derived from ``faces_packed`` once per table."""
    if key.device.type == "cpu":
        return _pair_plain(o, d, key, faces_packed, kb)
    dev = key.device
    n = key.shape[0]
    if faces_packed.shape[0] < kb * BIN:
        raise ValueError(f"face table of {faces_packed.shape[0]} rows does "
                         f"not hold {kb} bins")
    planes = ray_planes(o, d, key)
    table_ptr(faces_packed, 19, dev)
    edges_ptr = _aligned_ptr(packed_edges(faces_packed), EDGE_COLS, dev)
    t_out = torch.empty((n,), dtype=torch.float32, device=dev)
    f_out = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return t_out, f_out
    lib = PAIR_KERNEL.lib()
    with torch.cuda.device(dev):
        rc = lib.aptd_binned_pair(
            *(p.data_ptr() for p in planes), n, edges_ptr,
            kb, t_out.data_ptr(), f_out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    check(rc, "binned pair kernel")
    PAIR_KERNEL.launches += 1
    return t_out, f_out


# ---------------------------------------------------------------------------
# Pipeline
# ---------------------------------------------------------------------------

def _sortN(key: torch.Tensor, *ops: torch.Tensor):
    """Stable sort by ``key`` that moves every operand with it."""
    perm = torch.sort(key, stable=True).indices
    return tuple(x[perm] for x in ops)


def _slot_min(t2: torch.Tensor, f2: torch.Tensor):
    """(m, c) slot results -> per-ray (t, face id); the earliest slot (the
    lowest bin) keeps ties."""
    tb, fb = t2[:, 0], f2[:, 0]
    for j in range(1, t2.shape[1]):
        better = t2[:, j] < tb
        tb = torch.where(better, t2[:, j], tb)
        fb = torch.where(better, f2[:, j], fb)
    return tb, fb


def _binned_core(bvh: MeshBVH, po: Vec3, pd: Vec3, ptc, pidx, slots_a, pcnt,
                 bounds, n: int, lcap: int, lcapb: int, c_a: int, c_b: int):
    """The packed pipeline on the pre-packed live prefix; the caller
    guarantees live <= lcap, overflow <= lcapb and counts <= c_a + c_b."""
    kb = bvh.n_supers_real
    dev = ptc.device

    if c_b > 0:
        # overflow rays (count > c_a): compact, subscribe again with skip
        over = pcnt > c_a
        pa = torch.arange(lcap, dtype=torch.int64, device=dev)
        opacked = _sortN((~over).to(torch.int32), *po, *pd, ptc, pa)
        bo = Vec3(*(x[:lcapb] for x in opacked[0:3]))
        bd = Vec3(*(x[:lcapb] for x in opacked[3:6]))
        btc = opacked[6][:lcapb]
        b_pa = opacked[7][:lcapb]                 # packed-prefix position
        slots_b, _ = _phase1(bo, bd, btc, bounds, kb, c_a, c_b)

    def tier(slots, to, td):
        # slots is (c, m): flatten ray-major, so slot position = r*c + j
        c, m = slots.shape
        rep = lambda x: x[:, None].expand(m, c).reshape(-1)
        return (slots.T.reshape(-1), *(rep(x) for x in to), *(rep(x) for x in td))

    flat = tier(slots_a, po, pd)
    if c_b > 0:
        flat = tuple(torch.cat([a, b]) for a, b in zip(flat, tier(slots_b, bo, bd)))
    s_total = flat[0].shape[0]

    # bin-major pair table; ``perm`` is each sorted pair's slot position
    perm = torch.sort(flat[0], stable=True).indices
    keys_s = flat[0][perm]
    srt = [x[perm] for x in flat[1:]]
    t_pair, f_pair = _pair_call(Vec3(*srt[0:3]), Vec3(*srt[3:6]), keys_s,
                                bvh.faces_packed, kb)

    # back to slot order (``perm`` is a permutation: a plain indexed store)
    t_u = torch.empty((s_total,), dtype=torch.float32, device=dev)
    f_u = torch.empty((s_total,), dtype=torch.int32, device=dev)
    t_u[perm] = t_pair
    f_u[perm] = f_pair

    na = lcap * c_a
    t_m, f_m = _slot_min(t_u[:na].reshape(lcap, c_a), f_u[:na].reshape(lcap, c_a))
    if c_b > 0:
        t_b, f_b = _slot_min(t_u[na:].reshape(lcapb, c_b),
                             f_u[na:].reshape(lcapb, c_b))
        # merge tier B into its tier-A positions; tier A's bins are earlier,
        # so A keeps ties.  ``b_pa`` is a prefix of a permutation (unique),
        # so the indexed stores are deterministic.
        tb_wins = t_b < t_m[b_pa]
        t_m = t_m.clone()
        f_m = f_m.clone()
        t_m[b_pa] = torch.where(tb_wins, t_b, t_m[b_pa])
        f_m[b_pa] = torch.where(tb_wins, f_b, f_m[b_pa])

    # the winner's values from its face row, by the scan's own arithmetic
    row = bvh.faces_packed[torch.clamp_min(f_m, 0).long()]       # (lcap, 19)
    col = lambda j: row[:, j]
    v0, v1, v2 = (Vec3(col(3 * c), col(3 * c + 1), col(3 * c + 2)) for c in range(3))
    n0, n1, n2 = (Vec3(col(9 + 3 * c), col(10 + 3 * c), col(11 + 3 * c))
                  for c in range(3))
    t_w, u, w, _ = _triangle_t(v0, v1, v2, po, pd)
    v = 1.0 - u - w
    # the traversal starts its running t at t_cull and never reports a hit at
    # or beyond it: the same strict rule here
    hitm = (f_m >= 0) & (t_m < ptc)

    def sel(a):
        return torch.where(hitm, a, 0.0)

    point = v0 * u + v1 * w + v2 * v
    normal = (n0 * v + n1 * u + n2 * w).normalized_safe()

    # restore input order: results for the packed prefix, misses elsewhere
    live_idx = pidx[:lcap]

    def full(x, fill, dtype=torch.float32):
        out = torch.full((n,), fill, dtype=dtype, device=dev)
        out[live_idx] = x.to(dtype)
        return out

    return (full(torch.where(hitm, t_w, _INF), _INF),
            Vec3(*(full(sel(c), 0.0) for c in point)),
            Vec3(*(full(sel(c), 0.0) for c in normal)),
            full(torch.where(hitm, row[:, 18], -1.0), -1, torch.int32))


def default_caps(n: int) -> Tuple[int, int]:
    """The packing prefixes a batch of ``n`` rays gets: a quarter of the
    batch for live rays, a sixteenth for overflow rays, rounded up to whole
    granules (the JAX package's sizing rule)."""
    up = lambda x: max(_GRANULE, -(-x // _GRANULE) * _GRANULE)
    return up(n // 4), up(n // 16)


def mesh_intersect_binned(bvh: MeshBVH, o: Vec3, d: Vec3,
                          t_cull: Optional[torch.Tensor] = None,
                          lanes: Optional[int] = None,
                          lcap: Optional[int] = None,
                          lcapb: Optional[int] = None,
                          ) -> Tuple[torch.Tensor, Vec3, Vec3, torch.Tensor]:
    """Closest mesh hit via pair binning; ``mesh_intersect_bvh_v2p``'s
    contract.

    ``lcap``/``lcapb``: packing prefixes (live rays / overflow rays); when
    absent, ``APTD_BINNED_LCAP`` / ``APTD_BINNED_LCAPB`` if set and not 0
    (read at each call, as in the JAX package), else ``default_caps``.  A
    batch that exceeds either, or a ray in more bins than the slots hold,
    sends the whole call to the per-ray traversal: right for any input,
    packed-fast for the batches the router sends here.  ``lanes`` is
    accepted for the signature and has no effect.
    """
    del lanes
    _check_bvh(bvh)
    n = o.x.shape[0]
    dev = o.x.device
    if t_cull is None:
        t_cull = torch.full((n,), _INF, dtype=torch.float32, device=dev)
    cap_a, cap_b = default_caps(n)
    if lcap is None:
        lcap = int(os.environ.get("APTD_BINNED_LCAP", "0")) or cap_a
    if lcapb is None:
        lcapb = int(os.environ.get("APTD_BINNED_LCAPB", "0")) or cap_b
    lcap = min(int(lcap), n)
    lcapb = min(int(lcapb), lcap)

    kb = bvh.n_supers_real
    bounds = bvh.super_bounds
    # Slot widths clamp to the bin count: a ray cannot be live in more bins
    # than exist, so a small mesh carries no slack and never overflows.
    c_a = min(C_A, kb)
    c_b = min(C_B, kb - c_a)

    # Pre-pack by the whole-mesh dead flag (t_cull == -inf: AABB miss or
    # inactive lane) before subscribing: phase 1 runs on the prefix only.
    dead0 = t_cull == -_INF
    pidx = torch.sort(dead0.to(torch.int32), stable=True).indices
    head = pidx[:lcap]
    po = Vec3(*(c[head] for c in o))
    pd = Vec3(*(c[head] for c in d))
    ptc = t_cull[head]

    slots_a, counts = _phase1(po, pd, ptc, bounds, kb, 0, c_a)
    live0 = n - dead0.sum()
    n_over = (counts > c_a).sum()
    most = counts.max() if lcap else counts.sum()
    fits = (live0 <= lcap) & (n_over <= lcapb) & (most <= c_a + c_b)
    with host_read("binned_fit"):
        fits = bool(fits)
    if fits:
        count("binned.fast")
        return _binned_core(bvh, po, pd, ptc, pidx, slots_a, counts, bounds,
                            n, lcap, lcapb, c_a, c_b)
    count("binned.fallback")
    return mesh_intersect_bvh_v2p(bvh, o, d, t_cull)


def pair_work(key: torch.Tensor, kb: int, table_rows: int):
    """(bytes, face tests) the pair kernel cannot avoid for this table: the
    seven input planes and two result planes once each, the face table once,
    and 256 face tests for every pair that names a real bin."""
    n = key.shape[0]
    live = int(((key >= 0) & (key < kb)).sum())
    return 4 * (9 * n + table_rows * 19), live * BIN


def phase1_work(t_cull: torch.Tensor, kb: int, c_out: int):
    """(bytes, slab tests) of one subscription call: seven planes in,
    ``c_out`` slot planes and the counts out, the bounds once; every live
    ray (t_cull above -inf) tests every bin, a dead one none."""
    n = t_cull.shape[0]
    live = int((t_cull > -_INF).sum())
    return 4 * (7 * n + (c_out + 1) * n + kb * 8), live * kb
