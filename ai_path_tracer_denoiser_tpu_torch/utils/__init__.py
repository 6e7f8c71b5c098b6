"""Device selection, kernel builds, image IO, native library."""
from .imageio import read_png, save_hdr, save_png, save_png_scaled  # noqa: F401
