"""RoBERTa-base encoder + CLS classifier head (on ``<s>``).

The port of the JAX package's ``models/text/roberta.py``. Same block math
as BERT; the differences:
  * position ids are offset past padding_idx = 1 and computed from the
    attention mask (HF create_position_ids_from_input_ids):
    ``pos = cumsum(mask) * mask + 1``;
  * vocab 50265, 514 positions, one token type.
"""

from __future__ import annotations

import torch

from ..registry import ModelDef
from . import bert as _bert
from .encoder_common import (TextClassifier, convert_classifier,
                             strip_prefix)

HIDDEN = 768
LAYERS = 12
VOCAB = 50265
MAX_POS = 514
PAD_IDX = 1


def encode(model: _bert.BertEncoder, input_ids: torch.Tensor,
           attention_mask: torch.Tensor, *, train: bool = False, drop=None,
           fused_blocks: bool = True) -> torch.Tensor:
    """-> last_hidden_state [B, L, 768]. `attention_mask` is int32 [B, L].
    `drop`: an optional ``core.HFDropout``, at BERT's sites."""
    mask = attention_mask.to(torch.int32)
    pos_ids = torch.cumsum(mask, dim=1, dtype=torch.int32) * mask + PAD_IDX
    h = model.word_emb(input_ids) + model.pos_emb(pos_ids)
    h = h + model.type_emb.w[0][None, None, :]
    return _bert.run_layers(model, h, attention_mask, train=train, drop=drop,
                            fused_blocks=fused_blocks)


def convert_encoder(sd) -> dict:
    """HF RobertaModel state dict -> the JAX tree layout (the intra-layer
    layout is BERT's)."""
    return _bert.convert_encoder(
        strip_prefix(sd, "roberta.", "model.", "text_model."))


def model_def(name: str = "roberta") -> ModelDef:
    def build(num_classes: int = 4, *, layers: int = LAYERS, generator=None):
        enc = _bert.BertEncoder(layers, vocab=VOCAB, max_pos=MAX_POS,
                                type_vocab=1, generator=generator)
        return TextClassifier(enc, encode, HIDDEN, num_classes,
                              generator=generator)

    return ModelDef(
        name=name, build=build,
        convert_torch=lambda sd, num_classes=4: convert_classifier(
            sd, convert_encoder, num_classes))
