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
