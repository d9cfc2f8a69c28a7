"""CLI entry points of the port.

The CLIs run on CUDA. ``GC_RCA_PLATFORM=cpu`` (the JAX package's switch;
a ``:N`` device-count suffix is accepted and ignored) runs them on the CPU
instead; without it and without CUDA they raise.

Every trainer and eval CLI runs over the data axis: one process per GPU
(``torchrun --nproc_per_node=N -m ...cli.<name> --mesh_shape=data:N``, or
the JAX package's ``GC_RCA_MULTIHOST`` variables), ``data:-1`` the world
size (``data_mesh``). The model axis (tensor parallelism of the OPT
tower) runs in the five BLIP-2 CLIs and ``cli.serve``, the seq axis
(sequence parallelism of DistilBERT) in ``cli.test_text``: ``--mesh_shape=
data:D,model:M`` over D x M ranks. The pipe axis (GPipe of the OPT
decoder) runs in ``cli.blip2_train`` and ``cli.blip2_test``:
``--mesh_shape=data:D,pipe:S`` over D x S ranks on one host. The expert
axis, and the model, seq or pipe axis anywhere else, raise (ROADMAP.md,
queue 1 item 7).
"""

from __future__ import annotations

import math
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


def check_mesh_axes(mesh_shape: str, allowed=()) -> None:
    """Raise on a ``--mesh_shape`` axis other than ``data`` and the
    `allowed` ones (``model`` in the BLIP-2 CLIs and ``cli.serve``,
    ``seq`` in ``cli.test_text``, ``pipe`` in ``cli.blip2_train`` and
    ``cli.blip2_test``): the expert axis is not ported yet."""
    other = [part.strip().partition(":")[0]
             for part in (mesh_shape or "data:-1").split(",")]
    other = [name for name in other
             if name != "data" and name not in allowed]
    if other:
        runs = ", ".join(("data",) + tuple(allowed))
        raise NotImplementedError(
            f"--mesh_shape={mesh_shape}: the {', '.join(other)} axis is not "
            "ported to PyTorch yet, or not for this CLI (ROADMAP.md, queue "
            f"1 item 7); here the port runs the {runs} axes")


def train_mesh(mesh_shape: str, batch_size: int, ft_batch: int,
               ft_epochs: int, n_devices: int):
    """The JAX package's train mesh arithmetic: the axes of `mesh_shape`
    over `n_devices`, the data axis shrunk to a divisor of every phase's
    train batch (the gcd of the phase batch sizes)."""
    from ..parallel.mesh import mesh_for_batch

    div = math.gcd(batch_size, ft_batch) if ft_epochs > 0 else batch_size
    return mesh_for_batch(mesh_shape, div, n_devices)


def data_mesh(args, *, train_batches=None, fsdp: bool = False,
              allowed=()):
    """This rank's ``DataMesh`` for a CLI run: forms the process group
    the environment describes (``--fsdp`` forms one of a single process
    when none is launched) and lays ``--mesh_shape``'s axes over it (the
    `allowed` axes beside data; ``data:-1`` takes what the others leave).
    Axes that do not multiply to the world size exit naming the torchrun
    command. `train_batches` = (batch_size, ft_batch, ft_epochs): where
    the JAX package would shrink the data axis to a divisor of the train
    batches, the port exits with its numbers instead of idling ranks."""
    from ..parallel.mesh import DATA_AXIS, parse_mesh_shape
    from ..parallel.multihost import (env_world_size, initialize_from_env,
                                      make_mesh)

    spec = args.mesh_shape or "data:-1"
    check_mesh_axes(spec, allowed)
    world = env_world_size()
    axes = parse_mesh_shape(spec, world)
    n = int(math.prod(axes.values()))
    if n != world:
        raise SystemExit(
            f"--mesh_shape={spec} asks for {n} ranks and this run has "
            f"{world}: the port runs one process per GPU; launch it with "
            f"`torchrun --nproc_per_node={n} -m "
            f"garbage_classification_rca_tpu_torch.cli.<name> "
            f"--mesh_shape={spec} ...`")
    data = axes.get(DATA_AXIS, 1)
    if train_batches is not None:
        shrunk = train_mesh(spec, *train_batches, world).get(DATA_AXIS, 1)
        if shrunk != data:
            raise SystemExit(
                f"mesh data axis {data} does not divide the train batch "
                f"sizes {train_batches[:2]}; the JAX package would use "
                f"data:{shrunk}. The port does not idle ranks: launch "
                f"`torchrun --nproc_per_node={world // data * shrunk}`, or "
                f"pick batch sizes that {data} divides")
    base = initialize_from_env(cli_device(), force_group=fsdp)
    return make_mesh(base, axes) if set(axes) != {DATA_AXIS} else base


def check_unported_flags(args, allowed=()) -> None:
    """Raise on the training flags whose paths the port does not have yet
    (shared by the five trainers): a ``--mesh_shape`` axis other than
    data and the `allowed` ones (ROADMAP.md, queue 1 item 7),
    ``--wandb``."""
    check_mesh_axes(args.mesh_shape, allowed)
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


def check_eval_flags(args, allowed=()) -> None:
    """Raise on what the eval CLIs do not run yet: a ``--mesh_shape`` axis
    other than data and the `allowed` ones (ROADMAP.md, queue 1 item 7),
    orbax checkpoint directories (they evaluate a reference .pth or a
    BEST checkpoint of the port's trainers)."""
    check_mesh_axes(args.mesh_shape, allowed)
    if os.path.isdir(args.model_path):
        raise SystemExit("orbax checkpoint directories are not read by the "
                         "PyTorch port yet (ROADMAP.md); pass a reference "
                         ".pth or a BEST checkpoint of the port's trainer")
