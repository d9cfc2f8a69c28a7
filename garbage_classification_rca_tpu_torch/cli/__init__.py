"""CLI entry points of the port.

The CLIs run on CUDA. ``GC_RCA_PLATFORM=cpu`` (the JAX package's switch;
a ``:N`` device-count suffix is accepted and ignored) runs them on the CPU
instead; without it and without CUDA they raise.
"""

from __future__ import annotations

import os


def cli_device() -> str:
    plat = os.environ.get("GC_RCA_PLATFORM", "")
    return "cpu" if plat.partition(":")[0] == "cpu" else "cuda"
