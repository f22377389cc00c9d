"""Shared example bootstrap: the repository root on the import path, so
`acados_tpu_torch` imports from a checkout without installing it.

Each example takes `--device` (default "cuda", the card; "cpu" runs the
same code on the host) and exposes main(device=...).
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def device_arg(description: str) -> str:
    """The --device command-line option of an example."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda",
                    help='"cuda" (default) or "cpu"')
    return ap.parse_args().device
