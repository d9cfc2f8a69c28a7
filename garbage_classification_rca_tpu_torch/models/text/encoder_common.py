"""Shared pieces of the BERT-family text encoders: the post-norm
transformer layer and the HF-checkpoint helpers.

The layer's attention takes the raw [B, L] key mask. In eval it goes
through ``kernels/mha_fused.mha``; in train mode through
``kernels/mha_fused.mha_flash_train`` (the forward that saves the
logsumexp and the flash backward), as the JAX package's train path does.
Each is the hand-written CUDA kernel on the card and its plain version on
the CPU.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ...kernels.mha_fused import mha, mha_flash_train
from ...nn import core


class PostNormLayer(nn.Module):
    def __init__(self, hidden: int, ffn: int, ln_eps: float, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.q = core.Linear(hidden, hidden, generator=g)
        self.k = core.Linear(hidden, hidden, generator=g)
        self.v = core.Linear(hidden, hidden, generator=g)
        self.out = core.Linear(hidden, hidden, generator=g)
        self.ln_att = core.LayerNorm(hidden, ln_eps)
        self.fc1 = core.Linear(hidden, ffn, generator=g)
        self.fc2 = core.Linear(ffn, hidden, generator=g)
        self.ln_ffn = core.LayerNorm(hidden, ln_eps)


def postnorm_layer(p: PostNormLayer, x: torch.Tensor, mask: torch.Tensor,
                   heads: int, *, train: bool = False) -> torch.Tensor:
    """MHA -> add & LayerNorm -> GELU FFN -> add & LayerNorm."""
    attention = mha_flash_train if train else mha
    att = attention(p.q(x), p.k(x), p.v(x), heads=heads, mask=mask)
    x = p.ln_att(x + p.out(att))
    h = p.fc2(core.gelu(p.fc1(x)))
    return p.ln_ffn(x + h)


def lin(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    """HF Linear -> the JAX tree layout ([out, in] -> [in, out])."""
    return {"w": np.asarray(sd[prefix + ".weight"]).T,
            "b": np.asarray(sd[prefix + ".bias"])}


def ln_(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    return {"scale": np.asarray(sd[prefix + ".weight"]),
            "bias": np.asarray(sd[prefix + ".bias"])}


def strip_prefix(sd: Dict[str, np.ndarray], *candidates: str
                 ) -> Dict[str, np.ndarray]:
    """Drop a wrapping prefix ('model.', 'text_model.', ...) if present."""
    for pre in candidates:
        if any(k.startswith(pre) for k in sd):
            return {k[len(pre):]: v for k, v in sd.items()
                    if k.startswith(pre)}
    return sd
