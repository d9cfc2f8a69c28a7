"""DistilBERT encoder + CLS classifier head: word + position embeddings
-> LayerNorm (eps 1e-12) -> post-norm layers (12 heads, GELU FFN 3072);
the classifier pools the CLS token into ``Linear(768, n_classes)``.

``encode`` runs as many layers as the model holds; ``convert_encoder``
reads as many as the HF checkpoint holds, into the JAX tree layout
(``convert_torch`` adds the head's ``out.{weight,bias}``).
"""

from __future__ import annotations

import re
from typing import Optional

import torch
from torch import nn

from ...nn import core
from ..registry import ModelDef
from .encoder_common import (PostNormLayer, TextClassifier, convert_classifier,
                             lin, ln_, postnorm_layer, strip_prefix)

HIDDEN = 768
LAYERS = 6
HEADS = 12
FFN = 3072
VOCAB = 30522
MAX_POS = 512
LN_EPS = 1e-12
# HF distilbert-base-uncased config: dropout / attention_dropout, active in
# the reference's train-mode towers (--hf_internal_dropout reproduces them)
DROPOUT = 0.1
ATTN_DROPOUT = 0.1


class DistilBertEncoder(nn.Module):
    def __init__(self, layers: int = LAYERS, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.word_emb = core.Embedding(VOCAB, HIDDEN, generator=generator)
        self.pos_emb = core.Embedding(MAX_POS, HIDDEN, generator=generator)
        self.ln_emb = core.LayerNorm(HIDDEN, LN_EPS)
        self.layers = nn.ModuleList(
            PostNormLayer(HIDDEN, FFN, LN_EPS, generator=generator)
            for _ in range(layers))


def encode(model: DistilBertEncoder, input_ids: torch.Tensor,
           attention_mask: torch.Tensor, *, train: bool = False,
           drop: Optional[core.HFDropout] = None,
           fused_blocks: bool = True, output_hidden_states: bool = False):
    """-> last_hidden_state [B, L, 768], or (it, [embeddings LayerNorm
    output, every layer's output]) with ``output_hidden_states`` (the
    hierarchical fusion head taps entries 2 and 4). `attention_mask` is
    int32 [B, L].
    ``train`` routes attention through the training kernels. `drop`: an
    optional ``core.HFDropout`` reproducing HF DistilBERT's internal
    train-mode dropout: embeddings output, attention probabilities, FFN
    output (the HF model has no attention-output site).
    ``fused_blocks=False`` (the fusion tower) keeps the eval layers off
    the fused block kernels."""
    pos = torch.arange(input_ids.shape[1], device=input_ids.device)
    h = model.word_emb(input_ids) + model.pos_emb(pos)[None]
    h = model.ln_emb(h)
    if drop is not None:
        h = drop(h, DROPOUT)
    hiddens = [h]
    for lp in model.layers:
        h = postnorm_layer(lp, h, attention_mask, HEADS, train=train,
                           drop=drop, attn_p=ATTN_DROPOUT, hidden_p=DROPOUT,
                           fused_blocks=fused_blocks)
        hiddens.append(h)
    return (h, hiddens) if output_hidden_states else h


def convert_encoder(sd) -> dict:
    """HF DistilBertModel state dict (optionally under a ``distilbert.`` /
    ``model.`` / ``text_model.`` prefix) -> the JAX tree layout."""
    sd = strip_prefix(sd, "distilbert.", "model.", "text_model.")
    n_layers = len({m.group(1) for k in sd
                    for m in [re.match(r"transformer\.layer\.(\d+)\.", k)]
                    if m})
    p = {
        "word_emb": {"w": sd["embeddings.word_embeddings.weight"]},
        "pos_emb": {"w": sd["embeddings.position_embeddings.weight"]},
        "ln_emb": ln_(sd, "embeddings.LayerNorm"),
        "layers": [],
    }
    for i in range(n_layers):
        pre = f"transformer.layer.{i}."
        p["layers"].append({
            "q": lin(sd, pre + "attention.q_lin"),
            "k": lin(sd, pre + "attention.k_lin"),
            "v": lin(sd, pre + "attention.v_lin"),
            "out": lin(sd, pre + "attention.out_lin"),
            "ln_att": ln_(sd, pre + "sa_layer_norm"),
            "fc1": lin(sd, pre + "ffn.lin1"),
            "fc2": lin(sd, pre + "ffn.lin2"),
            "ln_ffn": ln_(sd, pre + "output_layer_norm"),
        })
    return p


def model_def(name: str = "distilbert") -> ModelDef:
    def build(num_classes: int = 4, *, layers: int = LAYERS, generator=None):
        return TextClassifier(DistilBertEncoder(layers, generator=generator),
                              encode, HIDDEN, num_classes,
                              generator=generator)

    return ModelDef(
        name=name, build=build,
        convert_torch=lambda sd, num_classes=4: convert_classifier(
            sd, convert_encoder, num_classes))
