"""dtype policy helpers (the port's own copy of the JAX package's
``utils/dtype.py`` policy)."""

from __future__ import annotations

import torch

from ..config import torch_compute_dtype


def resolve_param_dtype(args, default: str) -> torch.dtype:
    """--param_dtype -> the storage dtype of the weights, falling back to
    the calling path's policy when the flag is left empty (eval CLIs pass
    args.compute_dtype: weights stored at compute precision; train CLIs
    pass "float32": fp32 master weights for the optimizer)."""
    return torch_compute_dtype(args.param_dtype or default)


def cast_for_training(args, model: torch.nn.Module, resumed: bool) -> None:
    """The train CLIs' parameter storage, in place: fp32 master weights
    unless --param_dtype overrides. A full resume with the flag left
    empty keeps the dtype of the checkpoint it loaded, as the JAX
    package's ``cast_for_training`` does: casting there would change the
    run's precision mid-training and break the bit-identical
    continuation. Buffers (BatchNorm's running statistics) stay as they
    are: fp32, the JAX package's state."""
    if resumed and not args.param_dtype:
        return
    dtype = resolve_param_dtype(args, "float32")
    with torch.no_grad():
        for p in model.parameters():
            if p.is_floating_point() and p.dtype != dtype:
                p.data = p.data.to(dtype)
