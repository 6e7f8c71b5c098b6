"""Command-line application of the port."""
from .cli import main  # noqa: F401
