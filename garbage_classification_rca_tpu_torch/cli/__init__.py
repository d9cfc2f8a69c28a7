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


def resolve_model(getter, name: str):
    """Reference-style clean exit on an unknown model name (the reference
    prints 'Invalid Model: ...' and exits 1 instead of a traceback). A
    name the port does not run yet raises NotImplementedError."""
    try:
        return getter(name)
    except KeyError as e:
        print(f"Invalid Model: {name}")
        print(e.args[0])
        raise SystemExit(1)


def check_eval_flags(args) -> None:
    """Raise on what the unimodal eval CLIs do not run yet: they evaluate
    on one device, from a reference .pth."""
    todo = "is not ported to PyTorch yet (ROADMAP.md, queue 1, items 2 and 3)"
    if args.mesh_shape not in ("", "data:-1", "data:1"):
        raise NotImplementedError(
            f"--mesh_shape={args.mesh_shape} {todo}; the port evaluates on "
            "one device (no data, model or seq axis)")
    if os.environ.get("GC_RCA_MULTIHOST"):
        raise NotImplementedError(f"multi-host evaluation {todo}")
    if os.path.isdir(args.model_path):
        raise SystemExit("orbax checkpoint directories are not read by the "
                         "PyTorch port yet (ROADMAP.md); pass a reference "
                         ".pth")
