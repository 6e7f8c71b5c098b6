"""Device selection, kernel builds, image IO, native library."""
from .imageio import read_png, save_hdr, save_png, save_png_scaled  # noqa: F401
from .metrics import psnr, ssim  # noqa: F401
from .timers import PerformanceTimer  # noqa: F401
