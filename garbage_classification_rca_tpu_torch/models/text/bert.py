"""BERT-base encoder + CLS classifier head.

The port of the JAX package's ``models/text/bert.py``: word + position +
token-type (row 0: every token is type 0) embeddings -> LayerNorm (eps
1e-12) -> 12 post-norm layers (12 heads, GELU FFN 3072); the classifier
pools ``hidden_state[:, 0]`` directly — the HF pooler exists in
checkpoints and is read and dropped. ``encode`` can also return every
hidden state (the hierarchical fusion head taps layers 2 and 4).

RoBERTa shares the encoder module with its own table sizes
(``models/text/roberta.py``).
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
LAYERS = 12
HEADS = 12
FFN = 3072
VOCAB = 30522
MAX_POS = 512
TYPE_VOCAB = 2
LN_EPS = 1e-12
# HF bert-base-uncased config: hidden_dropout_prob /
# attention_probs_dropout_prob (RoBERTa-base has the same two)
HIDDEN_DROPOUT = 0.1
ATTN_DROPOUT = 0.1


class BertEncoder(nn.Module):
    def __init__(self, layers: int = LAYERS, *, vocab: int = VOCAB,
                 max_pos: int = MAX_POS, type_vocab: int = TYPE_VOCAB,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.word_emb = core.Embedding(vocab, HIDDEN, generator=generator)
        self.pos_emb = core.Embedding(max_pos, HIDDEN, generator=generator)
        self.type_emb = core.Embedding(type_vocab, HIDDEN,
                                       generator=generator)
        self.ln_emb = core.LayerNorm(HIDDEN, LN_EPS)
        self.layers = nn.ModuleList(
            PostNormLayer(HIDDEN, FFN, LN_EPS, generator=generator)
            for _ in range(layers))


def run_layers(model: BertEncoder, h, attention_mask, *, train, fused_blocks,
               drop=None, output_hidden_states=False):
    """LayerNorm of the summed embeddings, then the post-norm layers.
    `drop`: an optional ``core.HFDropout`` — HF BERT's internal sites:
    embeddings output, attention probabilities, attention output
    (BertSelfOutput), FFN output (BertOutput)."""
    h = model.ln_emb(h)
    if drop is not None:
        h = drop(h, HIDDEN_DROPOUT)
    hiddens = [h]
    for lp in model.layers:
        h = postnorm_layer(lp, h, attention_mask, HEADS, train=train,
                           drop=drop, attn_p=ATTN_DROPOUT,
                           attn_out_p=HIDDEN_DROPOUT,
                           hidden_p=HIDDEN_DROPOUT,
                           fused_blocks=fused_blocks)
        hiddens.append(h)
    return (h, hiddens) if output_hidden_states else h


def encode(model: BertEncoder, input_ids: torch.Tensor,
           attention_mask: torch.Tensor, *,
           output_hidden_states: bool = False, train: bool = False,
           drop: Optional[core.HFDropout] = None,
           fused_blocks: bool = True):
    """-> last_hidden_state [B, L, 768], or (it, [embeddings output, every
    layer's output]) with ``output_hidden_states``. `attention_mask` is
    int32 [B, L]."""
    pos = torch.arange(input_ids.shape[1], device=input_ids.device)
    h = model.word_emb(input_ids) + model.pos_emb(pos)[None]
    h = h + model.type_emb.w[0][None, None, :]       # token_type_ids = 0
    return run_layers(model, h, attention_mask, train=train, drop=drop,
                      fused_blocks=fused_blocks,
                      output_hidden_states=output_hidden_states)


def convert_encoder(sd) -> dict:
    """HF BertModel state dict (optionally under ``bert.`` / ``model.`` /
    ``text_model.``) -> the JAX tree layout, as many layers as it holds.
    The pooler's keys are left out: the classifier pools the raw CLS
    hidden state."""
    sd = strip_prefix(sd, "bert.", "model.", "text_model.")
    n_layers = len({m.group(1) for k in sd
                    for m in [re.match(r"encoder\.layer\.(\d+)\.", k)] if m})
    p = {
        "word_emb": {"w": sd["embeddings.word_embeddings.weight"]},
        "pos_emb": {"w": sd["embeddings.position_embeddings.weight"]},
        "type_emb": {"w": sd["embeddings.token_type_embeddings.weight"]},
        "ln_emb": ln_(sd, "embeddings.LayerNorm"),
        "layers": [],
    }
    for i in range(n_layers):
        pre = f"encoder.layer.{i}."
        p["layers"].append({
            "q": lin(sd, pre + "attention.self.query"),
            "k": lin(sd, pre + "attention.self.key"),
            "v": lin(sd, pre + "attention.self.value"),
            "out": lin(sd, pre + "attention.output.dense"),
            "ln_att": ln_(sd, pre + "attention.output.LayerNorm"),
            "fc1": lin(sd, pre + "intermediate.dense"),
            "fc2": lin(sd, pre + "output.dense"),
            "ln_ffn": ln_(sd, pre + "output.LayerNorm"),
        })
    return p


def model_def(name: str = "bert") -> ModelDef:
    def build(num_classes: int = 4, *, layers: int = LAYERS, generator=None):
        return TextClassifier(BertEncoder(layers, generator=generator),
                              encode, HIDDEN, num_classes,
                              generator=generator)

    return ModelDef(
        name=name, build=build,
        convert_torch=lambda sd, num_classes=4: convert_classifier(
            sd, convert_encoder, num_classes))
