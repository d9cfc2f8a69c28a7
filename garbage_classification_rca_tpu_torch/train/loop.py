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
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..nn.core import Key
from .loss import cross_entropy_loss_and_weight


def global_norm(tensors) -> torch.Tensor:
    """fp32 L2 norm over a list of tensors: one ``torch._foreach_norm``,
    accumulated in fp64 (the CPU's fp32 norm drifts by 1e-3 over a 23M
    element embedding table)."""
    norms = torch._foreach_norm(tensors, 2, dtype=torch.float64)
    return torch.linalg.vector_norm(torch.stack(norms)).float()


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
                    label_smoothing: float = 0.0):
    """``batch_to_inputs(mb, key)`` builds the tuple of the model's
    positional inputs from one microbatch dict (augmentation and
    normalisation on the device): ``(input_ids, attention_mask, images)``
    for the fusion model, ``(input_ids, attention_mask)`` for a text
    classifier, ``(images,)`` for an image model. The model is called as
    ``model(*inputs, train=True, key=k)``; `forward` replaces that callable
    (the model with a CLI's flags bound) while the parameters stay
    `model`'s. Returns ``step(stack, key) ->
    (loss, per-microbatch losses [acc], {"grad_norm", "param_norm"})``."""
    params = [p for p in model.parameters()]
    forward = forward or model

    def step(stack: Dict[str, torch.Tensor], key: Key):
        acc = stack["label"].shape[0]
        for p in params:
            p.grad = None
        loss_sum = w_total = None
        losses = []
        for m, mkey in enumerate(key.split(acc)):
            mb = {k: v[m] for k, v in stack.items()}
            k_in, k_model = mkey.split(2)
            with torch.enable_grad():
                logits = forward(*batch_to_inputs(mb, k_in), train=True,
                                 key=k_model)
                loss, w_sum = cross_entropy_loss_and_weight(
                    logits, mb["label"], class_weights, label_smoothing,
                    mb.get("valid"))
                (loss * w_sum).backward()
            loss = loss.detach()
            losses.append(loss)
            loss_sum = loss * w_sum if loss_sum is None \
                else loss_sum + loss * w_sum
            w_total = w_sum if w_total is None else w_total + w_sum
        w_total = torch.clamp(w_total, min=1e-30)
        with torch.no_grad():
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            grads = [p.grad for p in params]
            torch._foreach_div_(grads, w_total)
            grad_norm = global_norm(grads)
        optimizer.step()
        with torch.no_grad():
            param_norm = global_norm(params)
        return (loss_sum / w_total, torch.stack(losses),
                {"grad_norm": grad_norm, "param_norm": param_norm})

    return step
