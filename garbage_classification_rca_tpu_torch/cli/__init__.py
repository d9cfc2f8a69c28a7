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
    prints 'Invalid Model: ...' and exits 1 instead of a traceback)."""
    try:
        return getter(name)
    except KeyError as e:
        print(f"Invalid Model: {name}")
        print(e.args[0])
        raise SystemExit(1)


def check_unported_flags(args) -> None:
    """Raise on the training flags whose paths the port does not have
    yet (shared by the five trainers): ``--fsdp``, meshes and multi-host
    runs (ROADMAP.md, queue 1 item 7), ``--wandb``."""
    todo = "is not ported to PyTorch yet (ROADMAP.md, queue 1 item 7)"
    if args.fsdp:
        raise NotImplementedError(f"--fsdp {todo}")
    if args.mesh_shape not in ("", "data:-1", "data:1"):
        raise NotImplementedError(f"--mesh_shape={args.mesh_shape} {todo}; "
                                  "the port trains on one device")
    if os.environ.get("GC_RCA_MULTIHOST"):
        raise NotImplementedError(f"multi-host training {todo}")
    if args.wandb:
        raise NotImplementedError(
            "--wandb is not ported to PyTorch yet (ROADMAP.md, queue 1); "
            "the port logs JSONL under runs/")


def load_unimodal_model(mdef, path: str, what: str, device):
    """The text or image model held by `path`, on `device` in eval mode: a
    BEST checkpoint of the port's trainers (built at the depth its meta
    records) or a reference ``.pth`` (through the model's converter;
    `what` names the flag in the error for a wrong architecture)."""
    from .. import NUM_CLASSES
    from ..checkpoint.torch_convert import (convert_checked,
                                            load_torch_state_dict)
    from ..train.engine import load_checkpoint

    payload = load_checkpoint(path)
    if payload is None:
        params, state = convert_checked(
            mdef.convert_torch, load_torch_state_dict(path), what,
            num_classes=NUM_CLASSES)
        return mdef.load_tree(params, state, num_classes=NUM_CLASSES,
                              device=device)
    return model_from_payload(mdef, payload, device)


def model_from_payload(mdef, payload, device):
    """The model of a BEST or RESUME file of the port's trainers, on
    `device` in eval mode: built at the depth its meta records (a model of
    a fixed depth records none), each tensor in the saved dtype."""
    from .. import NUM_CLASSES
    from ..train.engine import load_model_state

    sd = payload["state_dict"]
    kw = mdef.build_kwargs(k.split(".")[0] for k in sd)
    if mdef.depth is not None:
        kw["layers"] = payload["meta"]["layers"]
    model = mdef.build(NUM_CLASSES, **kw)
    load_model_state(model, sd)
    return model.to(device).eval()


def check_eval_flags(args, items: str = "items 1 to 3") -> None:
    """Raise on what the eval CLIs do not run yet: they evaluate on one
    device, from a reference .pth or a BEST checkpoint of the port's
    trainers. `items` names the ROADMAP queue 1 items that port the rest."""
    todo = f"is not ported to PyTorch yet (ROADMAP.md, queue 1, {items})"
    if args.mesh_shape not in ("", "data:-1", "data:1"):
        raise NotImplementedError(
            f"--mesh_shape={args.mesh_shape} {todo}; the port evaluates on "
            "one device (no data, model or seq axis)")
    if os.environ.get("GC_RCA_MULTIHOST"):
        raise NotImplementedError(f"multi-host evaluation {todo}")
    if os.path.isdir(args.model_path):
        raise SystemExit("orbax checkpoint directories are not read by the "
                         "PyTorch port yet (ROADMAP.md); pass a reference "
                         ".pth or a BEST checkpoint of the port's trainer")
