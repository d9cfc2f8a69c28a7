"""``--fsdp``: ZeRO-3-style sharding of the parameters and the optimizer
state over the data axis (the port of the JAX package's
``parallel/fsdp.py``), on ``torch.distributed.fsdp.fully_shard`` (FSDP2).

The placement rule is the JAX package's where FSDP2 allows it: each
parameter is sharded on its largest dim that the world size divides
(ties: the last such dim). JAX leaves a parameter under
``MIN_SHARD_ELEMENTS`` elements, or with no such dim, replicated; FSDP2
has no replicated placement beside sharded ones in one optimizer (a
foreach update refuses plain tensors beside DTensors), so the port shards
those on dim 0, unevenly where the world size does not divide it. That is
placement only: the numerics are the same. At world size 1 every
parameter is one shard, so that ``--fsdp`` runs FSDP2's code on one
device. The whole model is one FSDP2
unit: its parameters are gathered for a forward and again for the
backward. BatchNorm buffers stay replicated (every rank updates them with
the global statistics). FSDP2 averages the gradients over the ranks (a
sum with the premultiplied factor 1 is not a gloo operation); the train
step multiplies the world size back and divides by the global weight sum
(``train/loop.py``).

Checkpoints gather the full state: ``full_state_dict`` /
``full_optimizer_state`` walk the tensors one at a time (a collective
each), and rank 0 alone keeps them, on the CPU, so a BEST or RESUME file
written under ``--fsdp`` is the file of an unsharded run and loads in a
one-process run; ``load_optimizer_state`` shards such a file's optimizer
state onto the parameters it belongs to.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from .mesh import DataMesh

MIN_SHARD_ELEMENTS = 16384


def shard_dim(shape, axis_size: int,
              min_size: int = MIN_SHARD_ELEMENTS) -> Optional[int]:
    """The dim the JAX ``leaf_spec`` shards (None: replicated there), with
    every dim divisible at ``axis_size`` 1."""
    n = 1
    for d in shape:
        n *= int(d)
    if n < min_size:
        return None
    best = None
    for d, size in enumerate(shape):
        if size % axis_size == 0 and size >= (shape[best] if best is not None
                                              else 0):
            best = d
    return best


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def broadcast_model(model: torch.nn.Module) -> torch.nn.Module:
    """Every rank takes rank 0's parameters and buffers (those FSDP2 does
    not hold): the ranks start in step."""
    import torch.distributed as dist

    from .multihost import _via_host

    if not dist.is_initialized() or dist.get_world_size() == 1:
        return model
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            if _is_dtensor(t):
                continue
            if t.is_cuda and _via_host():
                host = t.detach().cpu()
                dist.broadcast(host, 0)
                t.copy_(host)
            else:
                dist.broadcast(t.data, 0)
    return model


def shard_model(model: torch.nn.Module, mesh: DataMesh) -> torch.nn.Module:
    """``fully_shard`` `model` in place over `mesh`'s ranks by the
    placement rule, rank 0's weights and buffers first broadcast."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    broadcast_model(model)
    dmesh = init_device_mesh(mesh.device.type, (mesh.world,))
    fully_shard(model, mesh=dmesh,
                shard_placement_fn=lambda p: Shard(
                    shard_dim(p.shape, mesh.world) or 0))
    return model


def param_placer(mesh: Optional[DataMesh], use_fsdp: bool
                 ) -> Callable[[torch.nn.Module], torch.nn.Module]:
    """The placement a train CLI applies to its model: FSDP2-sharded with
    ``--fsdp``, else replicated (rank 0's weights broadcast when the run
    has several ranks)."""
    if use_fsdp:
        if mesh is None or mesh.backend is None:
            raise ValueError("--fsdp needs a process group "
                             "(parallel.multihost.initialize_from_env)")
        return lambda model: shard_model(model, mesh)
    if mesh is not None and mesh.distributed:
        return broadcast_model
    return lambda model: model


def _full(t: torch.Tensor, primary: bool) -> Optional[torch.Tensor]:
    if _is_dtensor(t):
        t = t.full_tensor()
    return t.detach().cpu() if primary else None


def full_state_dict(model: torch.nn.Module, primary: bool = True
                    ) -> Optional[Dict[str, torch.Tensor]]:
    """The model's state dict with whole tensors, on the CPU, on the
    primary rank (None elsewhere); collective when FSDP2 holds some of
    them. `primary` must be rank 0's answer."""
    out = {}
    for k, v in model.state_dict().items():
        full = _full(v, primary)
        if primary:
            out[k] = full
    return out if primary else None


def full_optimizer_state(optimizer: torch.optim.Optimizer,
                         primary: bool = True) -> Optional[Dict]:
    """``optimizer.state_dict()`` with whole tensors on the CPU, on the
    primary rank (None elsewhere); collective under FSDP2."""
    sd = optimizer.state_dict()
    state = {}
    for pid, st in sd["state"].items():
        row = {}
        for name, v in st.items():
            row[name] = _full(v, primary) if torch.is_tensor(v) else v
        state[pid] = row
    if not primary:
        return None
    return {"state": state, "param_groups": sd["param_groups"]}


def load_optimizer_state(optimizer: torch.optim.Optimizer, sd: Dict) -> None:
    """Load a state dict of whole tensors (``full_optimizer_state``'s, or a
    one-process run's) into `optimizer`, each state tensor of a sharded
    parameter sharded as its parameter is."""
    from torch.distributed.tensor import distribute_tensor

    params = [p for g in optimizer.param_groups for p in g["params"]]
    state = {}
    for pid, st in sd["state"].items():
        p = params[int(pid)]
        row = {}
        for name, v in st.items():
            if _is_dtensor(p) and torch.is_tensor(v) \
                    and tuple(v.shape) == tuple(p.shape):
                v = distribute_tensor(v.to(p.device_mesh.device_type),
                                      p.device_mesh, p.placements)
            row[name] = v
        state[pid] = row
    optimizer.load_state_dict({"state": state,
                               "param_groups": sd["param_groups"]})
