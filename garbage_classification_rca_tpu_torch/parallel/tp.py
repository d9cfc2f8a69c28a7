"""Tensor parallelism of the OPT tower over the mesh's ``model`` axis.

The port of the JAX package's ``parallel/tp.py``. JAX states Megatron's
layout as a PartitionSpec tree and lets XLA place the collectives; the
port runs one process a rank, so ``shard_opt_`` slices a whole decoder in
place to this rank's share and the layer body (``models/vlm/opt.py``)
runs the collectives itself:

  * q, k, v and fc1 are column-parallel: each rank holds the rows of the
    port's ``w`` [out, in] (JAX's ``P(None, "model")`` on its [in, out]),
    of ``b`` and of the int8 ``w_scale`` [1, out] that make its heads'
    (its FFN block's) outputs;
  * out and fc2 are row-parallel: each rank holds the columns of ``w``
    that read its heads (its FFN block); ``b`` and ``w_scale`` stay whole
    and are applied once, after the all-reduce of the partial products
    (``row_linear``: sum, then scale, then bias, the JAX ``linear`` order);
  * the embeddings, the LayerNorms and the tied lm head stay whole, so
    the hidden state between the layers, the logits and every token drawn
    from them are the same on every rank; EVA, the Q-Former and the
    projection stay whole too (``cli/blip2_common.place_blip2``);
  * the LoRA adapters stay whole on every rank (the JAX server's "LoRA
    stays replicated"); a rank adds the columns of ``b`` [r, out] that
    belong to its heads.

Training (the LoRA trainer under ``model:M``) needs Megatron's two
operators: ``copy_to_model`` (*f*: the identity forward, an all-reduce of
the gradient backward) on the input of every column-parallel product, and
``reduce_from_model`` (*g*: the all-reduce forward, the identity backward)
after every row-parallel one. The adapters' gradients are then partial on
each rank (``a``'s) or nonzero only in its columns (``b``'s); the trainer
sums them over the model group (``cli/blip2_common.make_accum_step``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from .mesh import MODEL_AXIS

COLUMN_PARALLEL = ("q", "k", "v", "fc1")
ROW_PARALLEL = ("out", "fc2")


@dataclasses.dataclass(frozen=True)
class ModelShard:
    """A rank's place on the model axis: `size` ranks, this one `rank`,
    their process group (None: the world)."""

    size: int
    rank: int
    group: Any = dataclasses.field(default=None, compare=False)

    def cols(self, n: int) -> slice:
        """This rank's block of `n` columns (heads, FFN units)."""
        w = n // self.size
        return slice(self.rank * w, (self.rank + 1) * w)


def model_shard(mesh) -> ModelShard:
    return ModelShard(mesh.size(MODEL_AXIS), mesh.coord(MODEL_AXIS),
                      mesh.group(MODEL_AXIS))


def _sum_over(x: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    """x summed over the model group, in fp32 (a bf16 partial sum keeps
    its product's rounding, not a second one)."""
    from .multihost import all_reduce_sum_

    acc = x.float().contiguous()
    all_reduce_sum_([acc], group=shard.group)
    return acc.to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_over(g, ctx.shard), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        return _sum_over(x, shard)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    """Megatron's *f*: `x` as it is; its gradient summed over the model
    group (a column-parallel product's input gradient is partial)."""
    if not torch.is_grad_enabled() or not x.requires_grad:
        return x
    return _CopyToModel.apply(x, shard)


def reduce_from_model(x: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    """Megatron's *g*: the partial products summed over the model group;
    the gradient passes as it is."""
    return _ReduceFromModel.apply(x, shard)


def row_linear(lin, x: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    """A row-parallel ``nn.core.Linear`` on this rank's input columns:
    the partial product, summed over the model group, then the int8 scale
    and the bias, once."""
    y = reduce_from_model(F.linear(x, lin.w.to(x.dtype)), shard)
    scale = lin._buffers.get("w_scale")
    if scale is not None:
        y = y * scale.to(x.dtype)
    return y if lin.b is None else y + lin.b.to(x.dtype)


def _slice_param(t: torch.Tensor, dim: int, sl: slice) -> nn.Parameter:
    part = t.narrow(dim, sl.start, sl.stop - sl.start).clone()
    return nn.Parameter(part, requires_grad=t.requires_grad)


@torch.no_grad()
def shard_opt_(decoder, mesh):
    """Slice a whole ``models.vlm.opt.OPTDecoder`` in place to this rank's
    share of `mesh`'s model axis (the module docstring's layout) and mark
    each layer with its ``ModelShard``; quantize (``ops/quant.py``)
    before, so that ``w_scale`` is sliced with its weight. A model axis of
    one rank changes nothing. Returns the decoder."""
    shard = model_shard(mesh)
    if shard.size == 1:
        return decoder
    cfg = decoder.cfg
    if cfg.heads % shard.size or cfg.ffn % shard.size:
        raise ValueError(f"model:{shard.size} must divide the OPT tower's "
                         f"{cfg.heads} heads and {cfg.ffn} FFN units")
    for layer in decoder.layers:
        if layer.tp is not None:
            raise ValueError("the OPT tower is sharded already")
        for name in COLUMN_PARALLEL:
            lin = getattr(layer, name)
            cols = shard.cols(lin.w.shape[0])
            lin.w = _slice_param(lin.w, 0, cols)
            if lin.b is not None:
                lin.b = _slice_param(lin.b, 0, cols)
            if "w_scale" in lin._buffers:
                lin.register_buffer("w_scale", lin.w_scale[:, cols].clone())
        for name in ROW_PARALLEL:
            lin = getattr(layer, name)
            lin.w = _slice_param(lin.w, 1, shard.cols(lin.w.shape[1]))
        layer.tp = shard
    return decoder

