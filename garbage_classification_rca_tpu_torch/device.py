"""Device selection shared by every entry point of the port."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """Return ``torch.device(device)``; CUDA is the default.

    Raises when CUDA is asked for and absent: the port never falls back to
    the CPU on its own — a caller who wants the CPU says so."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this machine; pass device='cpu' "
            "(or GC_RCA_PLATFORM=cpu for the CLI) to run on the CPU")
    return dev
