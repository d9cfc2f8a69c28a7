"""Inference-time BatchNorm folding for any model built of conv+BN pairs
(``models/image/efficientnet_common.ConvBN``).

w' = w * gamma/sqrt(var+eps) per out-channel; b' = beta + (b - mean) * that,
computed in fp32 and stored in the conv weight's dtype — the JAX package's
``nn/fold.py`` formula. Folding is done in place and drops the BN module:
the folded model is for evaluation only."""

from __future__ import annotations

import torch
from torch import nn


def fold_batchnorm(model: nn.Module, eps: float) -> nn.Module:
    for m in model.modules():
        bn = getattr(m, "bn", None)
        conv = getattr(m, "conv", None)
        if bn is None or conv is None:
            continue
        with torch.no_grad():
            mean = bn.mean.float()
            scale = bn.scale.float() * torch.rsqrt(bn.var.float() + eps)
            w = conv.w.float() * scale[:, None, None, None]
            b0 = conv.b.float() if conv.b is not None else 0.0
            b = bn.bias.float() + (b0 - mean) * scale
            dt = conv.w.dtype
            conv.w = nn.Parameter(w.to(dt))
            conv.b = nn.Parameter(b.to(dt))
        m.bn = None
    return model
