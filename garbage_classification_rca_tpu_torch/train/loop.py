"""The gradient-accumulating train step (the port of the JAX package's
``train/loop.py::make_train_step``).

One step takes a ``[acc, B, ...]`` stack of microbatches (device tensors)
and a ``core.Key``:
  * each microbatch runs forward in train mode (BN on batch statistics,
    its running stats carried from one microbatch to the next) and
    backward; its gradients are weighted by its CE denominator ``w_sum``
    and summed in fp32 in the parameters' ``.grad``, then divided by the
    total — the mean-reduction gradient of the whole effective batch,
    padded microbatches (valid = 0, weight 0) included;
  * every parameter gets its gradient, frozen ones too (phase 1 freezes
    the towers in the optimizer only, as the JAX step does), so
    ``grad_norm`` covers all of them;
  * the optimizer updates in place; ``param_norm`` is taken after it.
Nothing here synchronises with the device: the returned scalars are
device tensors.

Data parallelism (a ``DataMesh`` of N ranks): each rank runs its rows of
every microbatch under ``core.batch_shard`` (global BatchNorm statistics
and random draws), and after the last microbatch one coalesced all-reduce
sums the gradients, each microbatch's ``loss * w_sum`` and ``w_sum`` over
the ranks; the division is by the GLOBAL weight sum, so the step is the
one-device step of the global batch whatever the class weights and
``valid`` of each rank's rows (DDP's mean over ranks is not). Parameters
that ``parallel/fsdp.py`` shards are reduce-scattered by FSDP2 on the
last microbatch only (FSDP2 averages; the step multiplies the world size
back); the norms are the global ones.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import torch

from ..nn.core import Key, batch_shard
from .loss import cross_entropy_loss_and_weight


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def global_norm(tensors, mesh=None) -> torch.Tensor:
    """fp32 L2 norm over a list of tensors: one ``torch._foreach_norm``,
    accumulated in fp64 (the CPU's fp32 norm drifts by 1e-3 over a 23M
    element embedding table). Tensors sharded by FSDP2 (DTensors) count
    their squares on every rank, summed over `mesh`'s ranks."""
    sharded = [t for t in tensors if _is_dtensor(t)]
    if not sharded:
        norms = torch._foreach_norm(tensors, 2, dtype=torch.float64)
        return torch.linalg.vector_norm(torch.stack(norms)).float()
    from ..parallel.multihost import all_reduce_sum_

    plain = [t for t in tensors if not _is_dtensor(t)]
    local = [t.to_local() for t in sharded]
    sq = torch.stack([n * n for n in torch._foreach_norm(
        local, 2, dtype=torch.float64)]).sum()
    all_reduce_sum_([sq.reshape(1)])
    if plain:
        sq = sq + torch.stack([n * n for n in torch._foreach_norm(
            plain, 2, dtype=torch.float64)]).sum().to(sq.device)
    return torch.sqrt(sq).float()


def head_only_mask(model: torch.nn.Module, head_keys=("head",)
                   ) -> Dict[str, bool]:
    """Trainable mask over ``named_parameters()``: True only for the
    parameters under a top-level child named in `head_keys` (transfer
    learning: the backbone frozen, the replaced head trains)."""
    return {n: n.split(".")[0] in head_keys
            for n, _ in model.named_parameters()}


def all_trainable_mask(model: torch.nn.Module) -> Dict[str, bool]:
    return {n: True for n, _ in model.named_parameters()}


def make_train_step(model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer, *,
                    batch_to_inputs: Callable,
                    forward: Optional[Callable] = None,
                    class_weights: Optional[torch.Tensor] = None,
                    label_smoothing: float = 0.0, mesh=None):
    """``batch_to_inputs(mb, key)`` builds the tuple of the model's
    positional inputs from one microbatch dict (augmentation and
    normalisation on the device): ``(input_ids, attention_mask, images)``
    for the fusion model, ``(input_ids, attention_mask)`` for a text
    classifier, ``(images,)`` for an image model. The model is called as
    ``model(*inputs, train=True, key=k)``; `forward` replaces that callable
    (the model with a CLI's flags bound) while the parameters stay
    `model`'s. `mesh`: the ``DataMesh`` of a data-parallel run (each
    stack holds this rank's rows). Returns ``step(stack, key) ->
    (loss, per-microbatch losses [acc], {"grad_norm", "param_norm"})``,
    the global values on every rank."""
    params = [p for p in model.parameters()]
    forward = forward or model
    dp = mesh is not None and mesh.distributed
    fsdp = hasattr(model, "set_requires_gradient_sync")
    plain = [p for p in params if not _is_dtensor(p)]

    def step(stack: Dict[str, torch.Tensor], key: Key):
        acc = stack["label"].shape[0]
        for p in params:
            p.grad = None
        losses, sums, weights = [], [], []
        with batch_shard(mesh) if dp else contextlib.nullcontext():
            for m, mkey in enumerate(key.split(acc)):
                mb = {k: v[m] for k, v in stack.items()}
                k_in, k_model = mkey.split(2)
                if fsdp:
                    model.set_requires_gradient_sync(m == acc - 1)
                with torch.enable_grad():
                    logits = forward(*batch_to_inputs(mb, k_in), train=True,
                                     key=k_model)
                    loss, w_sum = cross_entropy_loss_and_weight(
                        logits, mb["label"], class_weights, label_smoothing,
                        mb.get("valid"))
                    (loss * w_sum).backward()
                losses.append(loss.detach())
                sums.append(losses[-1] * w_sum)
                weights.append(w_sum)
        with torch.no_grad():
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            losses = torch.stack(losses)
            if dp:
                from ..parallel.multihost import all_reduce_sum_

                sums, weights = torch.stack(sums), torch.stack(weights)
                all_reduce_sum_([p.grad for p in plain] + [sums, weights])
                losses = sums / torch.clamp(weights, min=1e-30)
            loss_sum, w_total = sums[0], weights[0]
            for m in range(1, acc):
                loss_sum, w_total = loss_sum + sums[m], w_total + weights[m]
            w_total = torch.clamp(w_total, min=1e-30)
            grads = [p.grad for p in params]
            local = [g.to_local() if _is_dtensor(g) else g for g in grads]
            if fsdp and mesh.world > 1:
                # FSDP2 averaged the sharded gradients over the ranks
                torch._foreach_mul_([loc for g, loc in zip(grads, local)
                                     if _is_dtensor(g)], float(mesh.world))
            torch._foreach_div_(local, w_total)
            grad_norm = global_norm(grads, mesh)
        optimizer.step()
        with torch.no_grad():
            param_norm = global_norm(params, mesh)
        return (loss_sum / w_total, losses,
                {"grad_norm": grad_norm, "param_norm": param_norm})

    return step
