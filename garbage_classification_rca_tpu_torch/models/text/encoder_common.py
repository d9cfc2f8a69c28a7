"""Shared pieces of the BERT-family text encoders: the post-norm
transformer layer and the HF-checkpoint helpers.

The layer takes the raw [B, L] key mask. Its route is a pure function of
the call's shape, dtype and flags, mirroring the JAX ``postnorm_layer``:
  * eval with ``fused_blocks=True`` and a shape the fused pair takes
    (``transformer_block.blocks_fit``): the two fused block kernels,
    ``postnorm_attn_block`` + ``postnorm_mlp_block``, on the layer's
    weights packed input-major once (``PostNormLayer.packed``);
  * eval otherwise (the fusion tower passes ``fused_blocks=False``; a
    sequence over 224 tokens does not fit): ``core.Linear``s around the
    ``kernels/mha_fused.mha`` attention kernel;
  * train: the same with ``mha_flash_train`` (the forward that saves the
    logsumexp and the flash backward), or, when an active ``HFDropout``
    drops the softmax weights (``--hf_internal_dropout``),
    ``mha_flash_train_dropout``.
Each kernel is the hand-written CUDA kernel on the card and its plain
version on the CPU.

HF-internal dropout sites of a layer, in the HF forward's call order:
the attention probabilities (``attn_p``), the attention output before the
residual (``attn_out_p``: BERT / RoBERTa; DistilBERT has no such site),
the FFN output before the residual (``hidden_p``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from ...kernels import transformer_block
from ...kernels.mha_fused import (mha, mha_flash_train,
                                  mha_flash_train_dropout)
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
        self._packed = transformer_block.PackedWeights()

    def packed(self):
        """The layer's weights as the fused blocks take them: (attention
        arguments, MLP arguments) after x and the mask. Built at first use
        and again only when a parameter changed (a load, a cast, a move)."""
        lins = (self.q, self.k, self.v, self.out, self.fc1, self.fc2)
        lns = (self.ln_att, self.ln_ffn)

        def build():
            wqkv = torch.cat([self.q.w, self.k.w, self.v.w], 0).t().contiguous()
            bqkv = torch.cat([self.q.b, self.k.b, self.v.b]).float()
            attn = (wqkv, bqkv, self.out.w.t().contiguous(),
                    self.out.b.float(), self.ln_att.scale.float(),
                    self.ln_att.bias.float())
            mlp = (self.fc1.w.t().contiguous(), self.fc1.b.float(),
                   self.fc2.w.t().contiguous(), self.fc2.b.float(),
                   self.ln_ffn.scale.float(), self.ln_ffn.bias.float())
            return attn, mlp

        return self._packed.get(
            [t for m in lins for t in (m.w, m.b)]
            + [t for m in lns for t in (m.scale, m.bias)], build)


def takes_fused_blocks(p: PostNormLayer, x: torch.Tensor, heads: int, *,
                       train: bool, fused_blocks: bool) -> bool:
    """The routing rule of ``postnorm_layer``."""
    b, n, d = x.shape
    return (fused_blocks and not train and p.q.w.dtype == x.dtype
            and transformer_block.blocks_fit(n, d, p.fc1.w.shape[0], heads,
                                             x.dtype))


def multi_head_attention(q, k, v, mask, heads: int, *, train: bool = False,
                         drop=None, attn_p: float = 0.0) -> torch.Tensor:
    """[B, L, D] x3 + int32 [B, L] key mask -> [B, L, D].

    Eval: the ``mha`` kernel. Train: ``mha_flash_train``; with an active
    `drop` (``core.HFDropout`` or anything with its interface) and
    ``attn_p > 0``, ``mha_flash_train_dropout`` on the site's key, which
    consumes the site whether or not the dropout pair takes the shape: a
    misfit on CPU tensors goes through the plain graph with the site's
    mask, on CUDA tensors it raises."""
    if not train:
        return mha(q, k, v, heads=heads, mask=mask)
    if drop is None or attn_p <= 0.0 or not drop.active:
        # no site is consumed, as HFDropout.__call__ consumes none
        return mha_flash_train(q, k, v, heads=heads, mask=mask)
    return mha_flash_train_dropout(q, k, v, heads=heads, mask=mask,
                                   key=drop.site_key(attn_p), p=attn_p)


def postnorm_layer(p: PostNormLayer, x: torch.Tensor, mask: torch.Tensor,
                   heads: int, *, train: bool = False, drop=None,
                   attn_p: float = 0.0, attn_out_p: float = 0.0,
                   hidden_p: float = 0.0,
                   fused_blocks: bool = True) -> torch.Tensor:
    """MHA -> add & LayerNorm -> GELU FFN -> add & LayerNorm. `drop`: an
    optional ``core.HFDropout`` with the three sites' probabilities."""
    if takes_fused_blocks(p, x, heads, train=train,
                          fused_blocks=fused_blocks):
        attn, mlp = p.packed()
        h = transformer_block.postnorm_attn_block(
            x, mask, *attn, heads=heads, eps=p.ln_att.eps)
        return transformer_block.postnorm_mlp_block(
            h, *mlp, eps=p.ln_ffn.eps, act="gelu")
    att = multi_head_attention(p.q(x), p.k(x), p.v(x), mask, heads,
                               train=train, drop=drop, attn_p=attn_p)
    out = p.out(att)
    if drop is not None:
        out = drop(out, attn_out_p)
    x = p.ln_att(x + out)
    h = p.fc2(core.gelu(p.fc1(x)))
    if drop is not None:
        h = drop(h, hidden_p)
    return p.ln_ffn(x + h)


class TextClassifier(nn.Module):
    """A BERT-family encoder + ``Linear(hidden, n_classes)`` on the CLS
    token — the JAX modules' ``apply``. The tree layout is ``{"encoder":
    ..., "head": ...}``."""

    def __init__(self, encoder: nn.Module, encode: Callable, hidden: int,
                 num_classes: int = 4, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.encoder = encoder
        self.encode = encode
        self.head = core.Linear(hidden, num_classes, generator=generator)

    def forward(self, input_ids, attention_mask, *, train: bool = False,
                key: Optional[core.Key] = None, drop_ratio: float = 0.6,
                hf_internal_dropout: bool = False):
        """int32 [B, L] ids and mask -> logits [B, n_classes].

        Train mode with a `key` drops the pooled feature with
        ``drop_ratio``. With ``hf_internal_dropout`` the key is split
        first: one half makes the encoder's ``HFDropout``, the other draws
        the head dropout; without the flag the key is used unsplit, so a
        flag-off run draws what it drew before the flag existed."""
        drop = None
        if hf_internal_dropout and train and key is not None:
            key, k_int = key.split(2)
            drop = core.HFDropout(k_int)
        pooled = self.encode(self.encoder, input_ids, attention_mask,
                             train=train, drop=drop)[:, 0]
        if train and key is not None:
            pooled = core.dropout(pooled, drop_ratio,
                                  key.generator(pooled.device))
        return self.head(pooled)


def convert_classifier(sd: Dict[str, np.ndarray], convert_encoder: Callable,
                       num_classes: int = 4):
    """Reference text-classifier .pth (encoder under ``model.`` or the HF
    name, head under ``out.``) -> (params, state) in the JAX tree layout.
    A checkpoint without the head gives the encoder only."""
    params = {"encoder": convert_encoder(sd)}
    if "out.weight" in sd:
        head = lin(sd, "out")
        if head["w"].shape[1] != num_classes:
            raise ValueError("head class-count mismatch")
        params["head"] = head
    return params, {}


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
