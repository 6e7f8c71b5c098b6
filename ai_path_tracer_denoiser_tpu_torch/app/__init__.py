"""Command-line application of the port."""
