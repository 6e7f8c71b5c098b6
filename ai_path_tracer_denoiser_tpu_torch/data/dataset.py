"""Training dataset: 7-frame temporal windows of npy G-buffer/GT pairs
(copy of data/dataset.py: numpy only, shared by the host and device loaders).

Equivalent of dataloader.py:17-65.  Filenames follow the reference scheme
``{scene}_{mov}_{noise}_{frame}.npy``; ``find_max`` builds the per-(scene,
mov, noise) max-frame table used to clamp windows at sequence ends
(dataloader.py:48-49).  Crops are crop_size-aligned random 256x256 squares
(dataloader.py:53-57).  Batches come out time-major (T, N, H, W, C) — the
layout ``apply_sequence`` walks over.
"""
from __future__ import annotations

import os
import re
from typing import Iterator, List, Optional, Tuple

import numpy as np

# {scene}_{mov}_{noise}_{frame}.<ext> — zero-padded (our datagen) or raw
# ints (the reference's train.sh output); anything else (README, .DS_Store,
# checkpoints) is ignored rather than crashing the scan.
_NAME_RE = re.compile(r"^(\d+)_(\d+)_(\d+)_(\d+)\.(\w+)$")


def _scan_frames(directory: str, ext: str = "npy"
                 ) -> Tuple[List[Tuple[int, int, int, int]], List[str]]:
    """List a frame directory in NUMERIC (scene, mov, noise, frame) order.

    Sorting parsed keys — not names — makes raw-int reference filenames
    ('0_0_0_10' < '0_0_0_2' lexicographically) window correctly too.
    """
    entries = []
    for name in os.listdir(directory):
        m = _NAME_RE.match(name)
        if m and (ext is None or m.group(5) == ext):
            entries.append((tuple(int(g) for g in m.groups()[:4]), name))
    entries.sort()
    return [k for k, _ in entries], [n for _, n in entries]


def find_max(directory: str, num_scenes: int, num_mov: int, num_noise: int
             ) -> np.ndarray:
    """Max frame index per (scene, mov, noise) (dataloader.py:17-23);
    scans any frame-named files (PNG dirs included, like the reference)."""
    m = np.zeros((num_scenes + 1, num_mov + 1, num_noise + 1))
    for (s, mv, nz, frame), _ in zip(*_scan_frames(directory, ext=None)):
        m[s, mv, nz] = max(m[s, mv, nz], frame)
    return m


def decode_u8_input(u: np.ndarray) -> np.ndarray:
    """uint8 (…, 10) G-buffer -> float32 (inverse of datagen.encode_u8_input:
    RGB/albedo /255, normals *2-1, depth *10 — the reference's
    preprocess.py:37-41 scalings)."""
    f = u.astype(np.float32) / 255.0
    f[..., 3:6] = f[..., 3:6] * 2.0 - 1.0
    f[..., 6:7] = f[..., 6:7] * 10.0
    return f


def decode_u8_gt(u: np.ndarray) -> np.ndarray:
    return u.astype(np.float32) / 255.0


class SequenceDataset:
    """Yields {image: (T,H,W,10), output: (T,H,W,3)} numpy windows.

    Frames stored as uint8 (datagen ``quantize="u8"`` — the reference's
    8-bit PNG data regime) are decoded to float32 transparently, after
    cropping."""

    def __init__(self, input_dir: str, gt_dir: str, m: Optional[np.ndarray] = None,
                 sequence_length: int = 7, crop: bool = False,
                 crop_size: int = 256, seed: int = 0,
                 cache_gb: Optional[float] = None):
        self.input_dir = input_dir
        self.gt_dir = gt_dir
        in_keys, self.inputs = _scan_frames(input_dir)
        out_keys, self.outputs = _scan_frames(gt_dir)
        assert in_keys == out_keys, (
            "input/gt frame sets differ (same {scene}_{mov}_{noise}_{frame} "
            "keys required in both directories)")
        self._keys = in_keys
        self.m = m     # kept for reference-API parity; superseded below
        self.T = sequence_length
        self.crop = crop
        self.crop_size = crop_size
        self.rng = np.random.default_rng(seed)
        import threading
        self._lock = threading.Lock()
        # In-memory frame cache.  A training step touches batch*T*2 files;
        # np.load per access makes the loader the bottleneck on small hosts.
        # Frames are cached on first touch up to ``cache_gb``, so from the
        # second epoch on a corpus that fits is pure array slicing.
        # Set cache_gb=0 to force mmap-only access; the default caps at half
        # of physical RAM so a dataset larger than the host can't exhaust it.
        self._cache: dict = {}
        self._cache_bytes = 0
        if cache_gb is None:
            try:
                phys = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
                cache_gb = min(48.0, 0.5 * phys / 2 ** 30)
            except (ValueError, OSError, AttributeError):
                cache_gb = 8.0
        self._cache_cap = int(cache_gb * 2 ** 30)
        # Per-(scene, mov, noise) frame range.  The reference clamps windows
        # with `start = m[...] - 6` (dataloader.py:48-49) — a *frame number*
        # used as a global file *position*, which is only correct for a
        # single-scene dataset; with many scenes its windows silently
        # straddle scene boundaries.  We keep its clamp semantics but do the
        # arithmetic in positions within the group, and validate up front
        # that every group is dense and long enough for a full window —
        # silent cross-scene windows are worse than a loud error.
        self._group_min: dict = {}
        self._group_max: dict = {}
        counts: dict = {}
        for (s, mv, nz, frame) in self._keys:
            key = (s, mv, nz)
            self._group_min[key] = min(self._group_min.get(key, frame), frame)
            self._group_max[key] = max(self._group_max.get(key, -1), frame)
            counts[key] = counts.get(key, 0) + 1
        for key, n in counts.items():
            span = self._group_max[key] - self._group_min[key] + 1
            if span != n:
                raise ValueError(
                    f"frame group {key} has gaps: frames "
                    f"{self._group_min[key]}..{self._group_max[key]} but "
                    f"only {n} files — temporal windows need consecutive "
                    "frames")
            if n < self.T:
                raise ValueError(
                    f"frame group {key} has {n} frames < sequence_length="
                    f"{self.T}; regenerate with more frames per scene")

    def __len__(self):
        return len(self.inputs)

    def path_of(self, index: int, gt: bool = False) -> str:
        """Path of frame ``index``'s npy file (input or ground truth)."""
        if gt:
            return os.path.join(self.gt_dir, self.outputs[index])
        return os.path.join(self.input_dir, self.inputs[index])

    def _frame(self, directory: str, name: str) -> np.ndarray:
        """A full frame array — RAM-cached up to cache_cap, else mmap."""
        key = (directory, name)
        arr = self._cache.get(key)
        if arr is not None:
            return arr
        path = os.path.join(directory, name)
        if self._cache_bytes < self._cache_cap:
            arr = np.load(path)
            with self._lock:
                if key not in self._cache:
                    self._cache[key] = arr
                    self._cache_bytes += arr.nbytes
            return arr
        return np.load(path, mmap_mode="r")

    def window_start(self, index: int) -> int:
        """Start POSITION of the T-frame window anchored at ``index``.

        Clamped at the end of the (scene, mov, noise) group (validated in
        __init__: groups are dense with >= T frames, so the whole window
        stays inside the group) — the reference's end-of-sequence clamp
        (dataloader.py:48-49) done in positions, not raw frame numbers.
        """
        s, mv, nz, frame = self._keys[index]
        key = (s, mv, nz)
        first, last = self._group_min[key], self._group_max[key]
        start_frame = min(frame, max(first, last - (self.T - 1)))
        return index - (frame - start_frame)

    def __getitem__(self, index: int,
                    rng: Optional[np.random.Generator] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
        start = self.window_start(index)
        # Crop offsets are drawn BEFORE loading and the files are memory-
        # mapped, so only the cropped window is ever read/copied.
        sl = (slice(None), slice(None))
        if self.crop:
            probe = self._frame(self.input_dir, self.inputs[start])
            h, w = probe.shape[:2]
            if rng is None:
                # Shared-generator fallback: draws depend on call order, so
                # under the prefetch pool callers should pass a per-item rng
                # (sequence_batches does) to keep crops run-reproducible.
                with self._lock:   # Generator is not thread-safe
                    rng = self.rng
                    cy = int(rng.integers(h // self.crop_size)) * self.crop_size
                    cx = int(rng.integers(w // self.crop_size)) * self.crop_size
            else:
                cy = int(rng.integers(h // self.crop_size)) * self.crop_size
                cx = int(rng.integers(w // self.crop_size)) * self.crop_size
            sl = (slice(cy, cy + self.crop_size), slice(cx, cx + self.crop_size))
        xs, ys = [], []
        for i in range(start, start + self.T):
            mx = self._frame(self.input_dir, self.inputs[i])
            my = self._frame(self.gt_dir, self.outputs[i])
            cx, cy_ = np.asarray(mx[sl]), np.asarray(my[sl])
            xs.append(decode_u8_input(cx) if cx.dtype == np.uint8
                      else cx.astype(np.float32))
            ys.append(decode_u8_gt(cy_) if cy_.dtype == np.uint8
                      else cy_.astype(np.float32))
        x = np.stack(xs)                      # (T, H, W, 10)
        y = np.stack(ys)                      # (T, H, W, 3)
        return x, y


def sequence_batches(dataset: SequenceDataset, batch_size: int = 1,
                     shuffle: bool = True, seed: int = 0,
                     drop_last: bool = True, prefetch: int = 2,
                     workers: int = 4) -> Iterator:
    """Batch iterator -> (inputs (T,N,H,W,10), targets (T,N,H,W,3)).

    Batches are assembled by a small thread pool and ``prefetch`` batches
    are kept in flight, overlapping host npy loads with device compute
    (np.load/memcpy release the GIL).  ``workers=0`` loads synchronously.
    """
    order = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    n_batches = len(order) // batch_size if drop_last else \
        -(-len(order) // batch_size)
    chunks = [order[i * batch_size:(i + 1) * batch_size]
              for i in range(n_batches)]

    def assemble(idxs):
        # Per-item RNG keyed on (seed, item): crop choices are identical
        # across runs regardless of thread scheduling in the prefetch pool,
        # and still vary per epoch (fit() passes seed=epoch).
        pairs = [dataset.__getitem__(
            int(i), rng=np.random.default_rng([seed, int(i)]))
            for i in idxs]
        return (np.stack([p[0] for p in pairs], axis=1),
                np.stack([p[1] for p in pairs], axis=1))

    if workers <= 0:
        for idxs in chunks:
            yield assemble(idxs)
        return

    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=workers) as pool:
        pending = []
        it = iter(chunks)
        for idxs in it:
            pending.append(pool.submit(assemble, idxs))
            if len(pending) > prefetch:
                break
        while pending:
            fut = pending.pop(0)
            nxt = next(it, None)
            if nxt is not None:
                pending.append(pool.submit(assemble, nxt))
            yield fut.result()
