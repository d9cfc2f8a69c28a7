"""BLIP-2 Q-Former, the image-grounded feature extractor.

The port of the JAX package's ``models/vlm/qformer.py``. 32 learned query
tokens attend to the frozen vision states:
BERT-style self-attention every layer, cross-attention to the image
embeddings every ``cross_frequency`` layers (2 for blip2-opt-2.7b), the
query FFN (``intermediate_query`` / ``output_query``); post-norm, LayerNorm
eps 1e-12. With an active ``nn.core.HFDropout`` (``--hf_internal_dropout``)
the HF model's train-mode sites run, in the JAX package's order: the
embeddings' output after its LayerNorm, then per layer the self-attention
weights and output, the cross-attention weights and output, the FFN
output (p = 0.1 each).

The attention is the JAX package's own einsum attention (it calls no
kernel there either): scores summed in fp32 from the activations' values,
softmax in fp32, weights cast back to v's dtype for the PV product. No
hand-written kernel runs here.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ...nn import core
from ..text.encoder_common import lin, ln_

LN_EPS = 1e-12
# Salesforce/blip2-opt-2.7b's qformer config: hidden_dropout_prob and
# attention_probs_dropout_prob, active only with an HFDropout
HIDDEN_DROPOUT = 0.1
ATTN_DROPOUT = 0.1


@dataclass(frozen=True)
class QFormerConfig:
    layers: int = 12
    hidden: int = 768
    heads: int = 12
    ffn: int = 3072
    n_query: int = 32
    cross_frequency: int = 2
    vision_hidden: int = 1408


class Attention(nn.Module):
    """HF Blip2QFormer{Self,Cross}Attention + SelfOutput."""

    def __init__(self, d: int, d_kv: int):
        super().__init__()
        self.q = core.Linear(d, d)
        self.k = core.Linear(d_kv, d)
        self.v = core.Linear(d_kv, d)
        self.out = core.Linear(d, d)
        self.ln = core.LayerNorm(d, LN_EPS)

    def forward(self, x_q, x_kv, heads: int, drop=None):
        b, nq, d = x_q.shape
        nk, hd = x_kv.shape[1], d // heads
        q = self.q(x_q).reshape(b, nq, heads, hd).transpose(1, 2)
        k = self.k(x_kv).reshape(b, nk, heads, hd).transpose(1, 2)
        v = self.v(x_kv).reshape(b, nk, heads, hd).transpose(1, 2)
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
            / math.sqrt(hd)
        w = torch.softmax(scores, dim=-1).to(v.dtype)
        if drop is not None:
            w = drop(w, ATTN_DROPOUT)
        att = self.out(torch.matmul(w, v).transpose(1, 2).reshape(b, nq, d))
        if drop is not None:
            att = drop(att, HIDDEN_DROPOUT)
        return self.ln(x_q + att)


class QFormerLayer(nn.Module):
    def __init__(self, cfg: QFormerConfig, cross: bool):
        super().__init__()
        d = cfg.hidden
        self.att = Attention(d, d)
        self.cross = Attention(d, cfg.vision_hidden) if cross else None
        self.fc1_q = core.Linear(d, cfg.ffn)
        self.fc2_q = core.Linear(cfg.ffn, d)
        self.ln_ffn_q = core.LayerNorm(d, LN_EPS)


class QFormer(nn.Module):
    """The tree of the JAX ``qformer.init``."""

    def __init__(self, cfg: QFormerConfig):
        super().__init__()
        self.cfg = cfg
        self.query_tokens = nn.Parameter(torch.zeros(cfg.n_query,
                                                     cfg.hidden))
        self.ln_emb = core.LayerNorm(cfg.hidden, LN_EPS)
        self.layers = nn.ModuleList(
            QFormerLayer(cfg, i % cfg.cross_frequency == 0)
            for i in range(cfg.layers))

    def forward(self, image_embeds: torch.Tensor, drop=None
                ) -> torch.Tensor:
        """image_embeds [B, 257, vision_hidden] -> query outputs
        [B, n_query, hidden]; `drop`: an optional ``HFDropout``."""
        cfg = self.cfg
        h = self.query_tokens.to(image_embeds.dtype).expand(
            image_embeds.shape[0], -1, -1)
        h = self.ln_emb(h)
        if drop is not None:
            h = drop(h, HIDDEN_DROPOUT)
        for lp in self.layers:
            h = lp.att(h, h, cfg.heads, drop)
            if lp.cross is not None:
                h = lp.cross(h, image_embeds, cfg.heads, drop)
            ff = lp.fc2_q(core.gelu(lp.fc1_q(h)))
            if drop is not None:
                ff = drop(ff, HIDDEN_DROPOUT)
            h = lp.ln_ffn_q(h + ff)
        return h


def _attn_c(sd, pre):
    return {"q": lin(sd, pre + "attention.query"),
            "k": lin(sd, pre + "attention.key"),
            "v": lin(sd, pre + "attention.value"),
            "out": lin(sd, pre + "output.dense"),
            "ln": ln_(sd, pre + "output.LayerNorm")}


def convert_torch(sd, cfg: QFormerConfig, query_tokens):
    """HF keys under ``qformer.*`` (prefix-stripped) + the top-level
    ``query_tokens`` tensor [1, 32, 768] -> the JAX tree layout."""
    params = {
        "query_tokens": np.asarray(query_tokens).reshape(cfg.n_query,
                                                         cfg.hidden),
        "ln_emb": ln_(sd, "layernorm"),
        "layers": [],
    }
    for i in range(cfg.layers):
        pre = f"encoder.layer.{i}."
        layer = {
            "att": _attn_c(sd, pre + "attention."),
            "fc1_q": lin(sd, pre + "intermediate_query.dense"),
            "fc2_q": lin(sd, pre + "output_query.dense"),
            "ln_ffn_q": ln_(sd, pre + "output_query.LayerNorm"),
        }
        if i % cfg.cross_frequency == 0:
            layer["cross"] = _attn_c(sd, pre + "crossattention.")
        params["layers"].append(layer)
    return params
