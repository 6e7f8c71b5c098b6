"""Image quality metrics for evaluation reports: PSNR and SSIM (copy of
utils/metrics.py).

The reference reports eval quality only as side-by-side GIF strips
(test.py:36-55); the training campaign's model card additionally tables
PSNR/SSIM per held-out scene.  Pure numpy, host-side — these run once per
eval scene, not in any hot path.
"""
from __future__ import annotations

import numpy as np


def psnr(pred: np.ndarray, target: np.ndarray, data_range: float = 1.0
         ) -> float:
    """Peak signal-to-noise ratio in dB over the whole array."""
    mse = float(np.mean((np.asarray(pred, np.float64)
                         - np.asarray(target, np.float64)) ** 2))
    if mse == 0.0:
        return float("inf")
    return 10.0 * float(np.log10(data_range ** 2 / mse))


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    r = np.arange(size, dtype=np.float64) - (size - 1) / 2
    g = np.exp(-(r ** 2) / (2 * sigma ** 2))
    w = np.outer(g, g)
    return w / w.sum()


def _filter2(img: np.ndarray, win: np.ndarray) -> np.ndarray:
    """VALID 2-D correlation of (H, W) with the window, via stride tricks."""
    k = win.shape[0]
    h, w = img.shape
    s = np.lib.stride_tricks.sliding_window_view(img, (k, k))
    return np.einsum("ijkl,kl->ij", s, win, optimize=True)


def ssim(pred: np.ndarray, target: np.ndarray, data_range: float = 1.0
         ) -> float:
    """Mean structural similarity (Wang et al. 2004 constants: K1=0.01,
    K2=0.03, 11x11 Gaussian window sigma 1.5, VALID padding).

    Accepts (H, W), (H, W, C), or a leading batch/time axis; channels and
    leading axes are averaged.
    """
    pred = np.asarray(pred, np.float64)
    target = np.asarray(target, np.float64)
    if pred.ndim == 2:
        pred, target = pred[..., None], target[..., None]
    if pred.ndim == 4:                      # (T/N, H, W, C): average frames
        return float(np.mean([ssim(p, t, data_range)
                              for p, t in zip(pred, target)]))
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    win = _gaussian_window()
    vals = []
    for c in range(pred.shape[-1]):
        x, y = pred[..., c], target[..., c]
        mu_x, mu_y = _filter2(x, win), _filter2(y, win)
        mu_x2, mu_y2, mu_xy = mu_x ** 2, mu_y ** 2, mu_x * mu_y
        sx = _filter2(x * x, win) - mu_x2
        sy = _filter2(y * y, win) - mu_y2
        sxy = _filter2(x * y, win) - mu_xy
        m = ((2 * mu_xy + c1) * (2 * sxy + c2)
             / ((mu_x2 + mu_y2 + c1) * (sx + sy + c2)))
        vals.append(m.mean())
    return float(np.mean(vals))
