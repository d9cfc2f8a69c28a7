"""Symmetric int8 quantization: per-row for the KV cache, per output
channel for weight-only int8 linears.

The port of the JAX package's ``ops/quant.py``.

* ``quantize_rows`` / ``dequantize``: per slot (per layer, per row)
  absmax over the hidden dim, scale = absmax / 127 (1 on an all-zero row,
  whose values quantize to exact zeros), an fp32 scale [..., 1] beside the
  int8 values. Rounding is half to even, as ``torch.round`` and
  ``jnp.round`` both do.
* ``quantize_linear`` / ``quantize_opt_weights``: the six matmul weights of
  every OPT layer to int8 with an fp32 scale per output channel
  (``w_scale`` [1, out], the JAX tree's shape); ``nn.core.Linear`` applies
  it after the product. Embeddings (also the tied lm head), the position
  table, LayerNorms, biases and LoRA adapters stay as they are.
"""

from __future__ import annotations

import torch
from torch import nn

OPT_LAYER_LINEARS = ("q", "k", "v", "out", "fc1", "fc2")


def quantize_rows(x: torch.Tensor, dim: int = -1):
    """x [..., H] -> (q int8 of x's shape, scale fp32 with `dim` of size
    1)."""
    xf = x.float()
    amax = xf.abs().amax(dim=dim, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    return torch.round(xf / scale).to(torch.int8), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """The inverse of ``quantize_rows`` (up to the rounding)."""
    return (q.float() * scale).to(dtype)


@torch.no_grad()
def quantize_linear(lin) -> None:
    """Weight-only int8 for one ``nn.core.Linear``, in place: ``w``
    [out, in] becomes int8 with a per-output-channel absmax scale, the
    fp32 buffer ``w_scale`` [1, out]; the bias stays as it is."""
    w = lin.w.float()
    amax = w.abs().amax(dim=1)[None, :]                      # [1, out]
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.round(w / scale.t()).to(torch.int8)
    lin.w = nn.Parameter(q, requires_grad=False)
    lin.register_buffer("w_scale", scale)


def quantize_opt_weights(opt):
    """Weight-only int8 for every layer of a ``models.vlm.opt.OPTDecoder``
    (q, k, v, out, fc1, fc2), in place; returns it. Every OPT entry point
    (prefill, decode_step, decode_chunk, generate, the server) then runs
    on it unchanged, through ``nn.core.Linear``."""
    for layer in opt.layers:
        for name in OPT_LAYER_LINEARS:
            quantize_linear(getattr(layer, name))
    return opt
