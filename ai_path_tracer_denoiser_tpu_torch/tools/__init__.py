"""Measurement tools of the port, run as ``python -m <package>.tools.<name>``."""
