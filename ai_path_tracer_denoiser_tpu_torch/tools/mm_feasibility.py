"""Feasibility probes for a matrix-product mesh traversal (counterpart of
tools/exp_mm_feasibility.py).

Three questions, each answered with a measured number on the card:

  1. What does one cluster "visit" of a 1024-ray tile (fetch + 32 face
     tests + winner + state update) cost as scalar float32 arithmetic
     (``visit_vpu``, csrc/mm_visit_vpu.cu), and what as a (128 x 16) @
     (16 x 1024) product on the tensor cores (``visit_mma``,
     csrc/mm_visit_mma.cu; TF32, or 3xTF32 for float32 accuracy)?
  2. What does a sort cost at ray-cluster-pair scale (2, 5, 10 M int32 keys,
     keys alone and key-value): the price of inverting a binning?
  3. What does a winning-face row gather cost, (F, 128)[idx] and
     (F, 19)[idx] for 640k indices, against four plane gathers: the price of
     an exact-recompute pass?

Run:  python -m ai_path_tracer_denoiser_tpu_torch.tools.mm_feasibility
      (``--device cpu --visits 64`` runs the plain versions on the CPU).

A visit's update is a strict ``<`` over 64 repeating clusters, so the state
after any ``n_visits >= 64`` equals the state after 64: the plain versions
stop there, whatever ``n_visits`` is.

On the card both kernels run every one of the ``n_visits`` visits, split
over the card: block s of S runs the visits ``visit_ranges(n_visits, S)[s]``
for the whole tile into a partial state, and the S states are merged in
range order with a strict ``<`` (``merge_visit_states``), which gives the
sequential state bit for bit.  S is the SMs times the blocks that fit
(``default_splits``); ``splits=1`` is one block on one SM, the first
version's shape.  The blocks' shapes are constants of the sources, chosen
by ``tools/visit_sweep.py``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.intersect import _triangle_t
from ..ops.vec3 import Vec3
from ..utils.cuda_build import CudaKernel, check
from ..utils.device import resolve_device

LANES = 1024          # rays of the one tile
CLUSTER = 32          # faces per cluster
N_CLUSTERS = 64       # clusters (coefficient blocks) the visits cycle through
TABLE_COLS = 128      # floats per row of the probe's face table, 19 used
N_VISITS = 32768
MISS = 3e38
_FLT_EPS = 1.1920929e-07


def _declare_vpu(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.aptd_mm_visit_vpu.restype = i
    lib.aptd_mm_visit_vpu.argtypes = [p, p, i, i, p, p, p, p]
    lib.aptd_mm_visit_vpu_blocks_per_sm.restype = i
    lib.aptd_mm_visit_vpu_blocks_per_sm.argtypes = [p]


def _declare_mma(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.aptd_mm_visit_mma.restype = i
    lib.aptd_mm_visit_mma.argtypes = [p, p, i, i, i, p, p, p, p]
    lib.aptd_mm_visit_mma_blocks_per_sm.restype = i
    lib.aptd_mm_visit_mma_blocks_per_sm.argtypes = [i, p]


VPU_KERNEL = CudaKernel("mm_visit_vpu", "mm_visit_vpu.cu", extra_flags=("-fmad=false",),
                        declare=_declare_vpu, headers=("mesh_common.cuh",))
# -fmad=false: the feature rows o x d then equal the plain version's bit for
# bit, and the two differ only by the product's precision
MMA_KERNEL = CudaKernel("mm_visit_mma", "mm_visit_mma.cu", extra_flags=("-fmad=false",),
                        declare=_declare_mma, headers=("mesh_common.cuh",))


def visit_ranges(n_visits: int, splits: int) -> Sequence[Tuple[int, int]]:
    """The visits [lo, hi) that block s of ``splits`` runs, in block order:
    contiguous, covering 0 .. n_visits - 1 once; empty where n_visits <
    splits."""
    if splits < 1 or n_visits < 0:
        raise ValueError(f"splits {splits}, n_visits {n_visits}")
    return [(s * n_visits // splits, (s + 1) * n_visits // splits) for s in range(splits)]


def merge_visit_states(states: Sequence[torch.Tensor]) -> torch.Tensor:
    """Partial states of consecutive visit ranges, in range order, merged as
    the visits update the state: a later range replaces it only where its t
    (row 0) is strictly smaller, so a tie keeps the earlier range's winner."""
    out = states[0]
    for state in states[1:]:
        out = torch.where(state[0] < out[0], state, out)
    return out


def split_visits_plain(visit_plain, n_visits: int, splits: int, **kwargs) -> torch.Tensor:
    """The kernels' split schedule on the plain version ``visit_plain``
    (``visit_vpu_plain`` or ``visit_mma_plain``): each block's range run from
    its first visit, the states merged in range order."""
    return merge_visit_states([visit_plain(n_visits=hi - lo, start=lo, **kwargs)
                               for lo, hi in visit_ranges(n_visits, splits)])


def fit_per_sm(device: torch.device, highest: Optional[bool] = None) -> int:
    """Blocks that fit on one SM (the occupancy API): the scalar kernel for
    ``highest`` None, else the tensor-core kernel."""
    if highest is None:
        fit = VPU_KERNEL.blocks_per_sm("aptd_mm_visit_vpu_blocks_per_sm", device)
    else:
        fit = MMA_KERNEL.blocks_per_sm("aptd_mm_visit_mma_blocks_per_sm", device, int(highest))
    if fit < 1:
        raise RuntimeError("no block of the visit kernel fits on an SM")
    return fit


def default_splits(device: torch.device, highest: Optional[bool] = None) -> int:
    """S: the card's SMs times the blocks that fit on one."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms * fit_per_sm(device, highest)


def _splits(device, highest: Optional[bool], splits: Optional[int]) -> int:
    if splits is None:
        return default_splits(device, highest)
    if splits < 1:
        raise ValueError(f"splits {splits}")
    return int(splits)


def _counter(visit_counter: Optional[torch.Tensor], device) -> torch.Tensor:
    if visit_counter is None:
        return torch.zeros(1, dtype=torch.int32, device=device)
    if (visit_counter.dtype != torch.int32 or visit_counter.numel() != 1
            or visit_counter.device != device):
        raise ValueError("visit_counter: one int32 on the inputs' device")
    return visit_counter.zero_()


def _checked(name: str, t: torch.Tensor, shape) -> torch.Tensor:
    if t.dtype != torch.float32 or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected float32 {tuple(shape)}, got {t.dtype} "
                         f"{tuple(t.shape)}")
    return t.contiguous()


def _ray_vecs(rays: torch.Tensor):
    return Vec3(rays[0], rays[1], rays[2]), Vec3(rays[3], rays[4], rays[5])


def visit_vpu_plain(rays: torch.Tensor, faces: torch.Tensor,
                    n_visits: int = N_CLUSTERS, start: int = 0) -> torch.Tensor:
    """Plain PyTorch version of ``visit_vpu``: (8, 1024) state rows t, point,
    interpolated normal, material after the visits start, start + 1, ...,
    ``min(n_visits, 64)`` of them (visit k fetches cluster k % 64)."""
    o, d = _ray_vecs(rays)
    o2, d2 = (Vec3(*(c[None] for c in v)) for v in (o, d))
    state = torch.zeros((8, rays.shape[1]), dtype=torch.float32, device=rays.device)
    state[0] = MISS
    for k in range(start, start + min(n_visits, N_CLUSTERS)):
        c = k % N_CLUSTERS
        vb = faces[c * CLUSTER:(c + 1) * CLUSTER]

        def corner(c):
            return Vec3(*(vb[:, 3 * c + a, None] for a in range(3)))

        v0, v1, v2 = corner(0), corner(1), corner(2)
        t, u, w, hit = _triangle_t(v0, v1, v2, o2, d2)            # (32, 1024)
        t = torch.where(hit & (t > 0.0), t, MISS)
        t_c, j = torch.min(t, dim=0)
        jj = j[None]
        u, w = torch.gather(u, 0, jj)[0], torch.gather(w, 0, jj)[0]
        rows = vb[j]                                              # (1024, 128)

        def won(c):
            return Vec3(*(rows[:, 3 * c + a] for a in range(3)))

        v = 1.0 - u - w
        p = won(0) * u + won(1) * w + won(2) * v
        nrm = won(3) * v + won(4) * u + won(5) * w
        better = t_c < state[0]
        news = torch.stack([t_c, *p, *nrm, rows[:, 18]])
        state = torch.where(better, news, state)
    return state


def _card_inputs(rays: torch.Tensor, table: torch.Tensor, name: str) -> None:
    if table.device != rays.device:
        raise ValueError(f"rays and {name} lie on different devices")
    if table.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel copies 16-byte pieces; the data must be "
                         "16-byte aligned")


def visit_vpu(rays: torch.Tensor, faces: torch.Tensor, n_visits: int = N_VISITS, *,
              splits: Optional[int] = None,
              visit_counter: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``n_visits`` scalar-arithmetic cluster visits of one 1024-ray tile.
    ``rays``: (8, 1024) rows ox oy oz dx dy dz _ _; ``faces``: (2048, 128).
    CPU tensors take the plain version; CUDA tensors launch the kernel,
    split over ``splits`` blocks (default ``default_splits``).
    ``visit_counter`` (one int32), zeroed here, receives the visits
    performed: the kernel's count on the card, the plain version's
    ``min(n_visits, 64)`` on the CPU."""
    rays = _checked("rays", rays, (8, LANES))
    faces = _checked("faces", faces, (N_CLUSTERS * CLUSTER, TABLE_COLS))
    if rays.device.type == "cpu":
        if visit_counter is not None:
            _counter(visit_counter, rays.device).fill_(min(n_visits, N_CLUSTERS))
        return visit_vpu_plain(rays, faces, n_visits)
    _card_inputs(rays, faces, "faces")
    splits = _splits(rays.device, None, splits)
    counter = _counter(visit_counter, rays.device)
    partial = torch.empty((splits, 8, LANES), dtype=torch.float32, device=rays.device)
    out = torch.empty((8, LANES), dtype=torch.float32, device=rays.device)
    lib = VPU_KERNEL.lib()
    with torch.cuda.device(rays.device):
        rc = lib.aptd_mm_visit_vpu(rays.data_ptr(), faces.data_ptr(), int(n_visits), splits,
                                   partial.data_ptr(), counter.data_ptr(), out.data_ptr(),
                                   torch.cuda.current_stream().cuda_stream)
    check(rc, "scalar visit kernel")
    VPU_KERNEL.launches += 1
    return out


def visit_features(rays: torch.Tensor) -> torch.Tensor:
    """(16, 1024) feature tile [d, o x d, o, 1, 0 x 6] of the ray planes."""
    o, d = _ray_vecs(rays)
    m = o.cross(d)
    one = torch.ones_like(o.x)
    zero = torch.zeros_like(o.x)
    return torch.stack([*d, *m, *o, one] + [zero] * 6)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (10 mantissa bits, nearest, ties away
    from zero), as the tensor cores take their operands."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def visit_mma_plain(rays: torch.Tensor, coeffs: torch.Tensor, n_visits: int = N_CLUSTERS,
                    precision: str = "float32", start: int = 0) -> torch.Tensor:
    """Plain PyTorch version of ``visit_mma``: the product as a float32
    ``@``; (8, 1024) rows t, face id, six zero rows, after the visits start,
    start + 1, ..., ``min(n_visits, 64)`` of them (visit k takes block
    k % 64).  ``precision`` "tf32" rounds both operands to TF32 first, as
    the kernel does without ``highest``; "float32" is what its ``highest``
    mode keeps."""
    if precision not in ("float32", "tf32"):
        raise ValueError(f"precision={precision!r}")
    feats = visit_features(rays)
    if precision == "tf32":
        feats, coeffs = round_tf32(feats), round_tf32(coeffs)
    state = torch.zeros((8, rays.shape[1]), dtype=torch.float32, device=rays.device)
    state[0] = MISS
    state[1] = -1.0
    for k in range(start, start + min(n_visits, N_CLUSTERS)):
        c = k % N_CLUSTERS
        mm = coeffs[c].T @ feats                                  # (128, 1024)
        den, un, wn, tn = mm[0:32], mm[32:64], mm[64:96], mm[96:128]
        hit = ((den >= _FLT_EPS) & (un >= 0.0) & (un <= den) & (wn >= 0.0)
               & (un + wn <= den) & (tn >= 0.0))
        t = torch.where(hit, tn / den, MISS)
        t_c, j = torch.min(t, dim=0)
        better = t_c < state[0]
        state[0] = torch.where(better, t_c, state[0])
        state[1] = torch.where(better, (j + c * CLUSTER).to(torch.float32), state[1])
    return state


def visit_mma(rays: torch.Tensor, coeffs: torch.Tensor, n_visits: int = N_VISITS,
              highest: bool = False, *, splits: Optional[int] = None,
              visit_counter: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``n_visits`` matrix-product cluster visits of one 1024-ray tile.
    ``coeffs``: (64, 16, 128); ``highest``: 3xTF32 instead of one TF32
    product.  CPU tensors take the plain version at the matching
    precision; CUDA tensors launch the kernel.  ``splits`` and
    ``visit_counter`` as for ``visit_vpu``."""
    rays = _checked("rays", rays, (8, LANES))
    coeffs = _checked("coeffs", coeffs, (N_CLUSTERS, 16, 4 * CLUSTER))
    highest = bool(highest)
    if rays.device.type == "cpu":
        if visit_counter is not None:
            _counter(visit_counter, rays.device).fill_(min(n_visits, N_CLUSTERS))
        return visit_mma_plain(rays, coeffs, n_visits,
                               "float32" if highest else "tf32")
    _card_inputs(rays, coeffs, "coeffs")
    splits = _splits(rays.device, highest, splits)
    counter = _counter(visit_counter, rays.device)
    partial = torch.empty((splits, 2, LANES), dtype=torch.float32, device=rays.device)
    out = torch.empty((8, LANES), dtype=torch.float32, device=rays.device)
    lib = MMA_KERNEL.lib()
    with torch.cuda.device(rays.device):
        rc = lib.aptd_mm_visit_mma(rays.data_ptr(), coeffs.data_ptr(), int(n_visits),
                                   int(highest), splits, partial.data_ptr(),
                                   counter.data_ptr(), out.data_ptr(),
                                   torch.cuda.current_stream().cuda_stream)
    check(rc, "matrix-product visit kernel")
    MMA_KERNEL.launches += 1
    return out


def probe_inputs(seed: int, device):
    """(rays (8, 1024), faces (2048, 128), coeffs (64, 16, 128)): standard
    normal draws, as the JAX tool makes them."""
    rng = np.random.default_rng(seed)
    faces = rng.normal(size=(N_CLUSTERS * CLUSTER, TABLE_COLS)).astype(np.float32)
    coeffs = rng.normal(size=(N_CLUSTERS, 16, 4 * CLUSTER)).astype(np.float32)
    rays = rng.normal(size=(8, LANES)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (rays, faces, coeffs))


def timed(fn, *args, reps: int = 5) -> float:
    """Median seconds of ``fn(*args)`` after one warm-up call, the device
    drained before the clock is read."""
    def drain():
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    fn(*args)
    drain()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args)
        drain()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def run_visit_bench(device, n_visits: int = N_VISITS, seed: int = 0):
    rays, faces, coeffs = probe_inputs(seed, device)
    results = {"n_visits": n_visits}
    t_vpu = timed(visit_vpu, rays, faces, n_visits)
    results["vpu_us_per_visit"] = t_vpu / n_visits * 1e6
    print(f"[visit] scalar MT loop: {t_vpu * 1e3:.3f} ms total, "
          f"{t_vpu / n_visits * 1e6:.3f} us/visit")
    for name, highest in (("TF32", False), ("3xTF32", True)):
        t_mma = timed(visit_mma, rays, coeffs, n_visits, highest)
        results[f"mma_{name}_us_per_visit"] = t_mma / n_visits * 1e6
        print(f"[visit] tensor-core coeff loop ({name}): {t_mma * 1e3:.3f} ms total, "
              f"{t_mma / n_visits * 1e6:.3f} us/visit ({t_vpu / t_mma:.2f}x vs scalar)")
    return results


def run_sort_bench(device, sizes=(2_000_000, 5_000_000, 10_000_000), seed: int = 1):
    rng = np.random.default_rng(seed)
    results = {}
    for n in sizes:
        keys = torch.from_numpy(rng.integers(0, 4096, size=n).astype(np.int32)).to(device)
        t = timed(lambda k: torch.sort(k).values, keys)
        results[f"sort_keys_{n}_ms"] = t * 1e3
        print(f"[sort] torch.sort keys {n / 1e6:.0f}M int32: {t * 1e3:.2f} ms")
        # key-value: the permutation rides along, as lax.sort((k, iota)) returns it
        t = timed(torch.sort, keys)
        results[f"sort_kv_{n}_ms"] = t * 1e3
        print(f"[sort] torch.sort key-value {n / 1e6:.0f}M: {t * 1e3:.2f} ms")
    return results


def run_gather_bench(device, rows: int = 81920, n_idx: int = 640_000, seed: int = 2):
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.normal(size=(rows, 128)).astype(np.float32)).to(device)
    table19 = torch.from_numpy(rng.normal(size=(rows, 19)).astype(np.float32)).to(device)
    idx = torch.from_numpy(rng.integers(0, rows, size=n_idx).astype(np.int64)).to(device)
    planes = [torch.from_numpy(rng.normal(size=(rows,)).astype(np.float32)).to(device)
              for _ in range(4)]
    results = {}
    for name, fn in (("rows128", lambda: table[idx]), ("rows19", lambda: table19[idx]),
                     ("planes4", lambda: [p[idx] for p in planes])):
        results[f"gather_{name}_ms"] = timed(fn) * 1e3
    print(f"[gather] ({rows},128)[{n_idx}]: {results['gather_rows128_ms']:.2f} ms")
    print(f"[gather] ({rows},19)[{n_idx}]: {results['gather_rows19_ms']:.2f} ms")
    print(f"[gather] 4x ({rows},)[{n_idx}] plane gathers: "
          f"{results['gather_planes4_ms']:.2f} ms")
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m ai_path_tracer_denoiser_tpu_torch.tools.mm_feasibility",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--visits", type=int, default=N_VISITS)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    card = "cpu"
    if device.type == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout.strip().splitlines()[0]
    print("device:", device, "|", card)
    results = {"device": str(device), "card": card}
    results.update(run_visit_bench(device, args.visits, args.seed))
    results.update(run_sort_bench(device))
    results.update(run_gather_bench(device))
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
