"""Attention units of the MM-RCA fusion block — the plain PyTorch path.

  * ``self_attention``: single-head QKV attention over "patches" (a feature
    vector reshaped to [B, N, D]), scale 1/sqrt(d_kq), then LayerNorm ->
    ReLU.
  * ``reverse_cross_attention``: Q from one modality, K/V from the other;
    with ``reverse`` the mixing weights are (1 - A) / (N - 1) (rows still
    sum to 1). Square attention only.

The softmax runs in fp32 whatever the compute dtype. These functions are
the plain version of the fused kernel in ``kernels/rca_fused.py``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..nn import core


class AttentionUnit(nn.Module):
    """q/k/v projections + the output LayerNorm of one attention unit."""

    def __init__(self, d_in_q: int, d_in_kv: int, d_kq: int, d_v: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.q = core.Linear(d_in_q, d_kq, generator=generator)
        self.k = core.Linear(d_in_kv, d_kq, generator=generator)
        self.v = core.Linear(d_in_kv, d_v, generator=generator)
        self.norm = core.LayerNorm(d_v)


def _softmax_scaled(scores: torch.Tensor, d_kq: int) -> torch.Tensor:
    return torch.softmax(scores.float() / math.sqrt(d_kq), dim=-1)


def self_attention(p: AttentionUnit, x: torch.Tensor) -> torch.Tensor:
    """[B, N, D_in] -> [B, N, D_v]."""
    q, k, v = p.q(x), p.k(x), p.v(x)
    w = _softmax_scaled(q @ k.transpose(-1, -2), q.shape[-1]).to(v.dtype)
    return torch.relu(p.norm(w @ v))


def reverse_cross_attention(p: AttentionUnit, x_q: torch.Tensor,
                            x_kv: torch.Tensor, reverse: bool) -> torch.Tensor:
    """x_q: [B, N, Dq] queries, x_kv: [B, N, Dkv] keys/values."""
    if x_q.shape[1] != x_kv.shape[1]:
        raise ValueError(
            f"RCA requires square attention, got N_q={x_q.shape[1]} "
            f"N_kv={x_kv.shape[1]}")
    q, k, v = p.q(x_q), p.k(x_kv), p.v(x_kv)
    w = _softmax_scaled(q @ k.transpose(-1, -2), q.shape[-1])
    if reverse:
        w = (1.0 - w) / (w.shape[-1] - 1)
    return torch.relu(p.norm(w.to(v.dtype) @ v))
