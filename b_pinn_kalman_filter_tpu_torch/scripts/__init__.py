"""Command-line tools of the port, each run as ``python -m``."""
