"""BART-large encoder-decoder and its sequence-classification head.

The port of the JAX package's ``models/text/bart.py``: post-norm
layers (d 1024, 16 heads, exact-GELU FFN 4096), 12 encoder + 12 decoder
layers, learned positions with BART's +2 offset, ``layernorm_embedding`` on
both stacks, no embedding scaling. The decoder reads
``shift_tokens_right(input_ids)`` under a causal mask only (no decoder
padding mask) and cross-attends over the encoder's padding mask. The
classifier pools the decoder state at the last eos (= 2) of ``input_ids``
into dense -> tanh -> out_proj.

The attention is the JAX package's own einsum attention (it never calls
the ``mha`` kernel): scores summed in fp32 from the activations' values,
the additive bias ``(1 - mask) * finfo(float32).min`` built and added in
fp32, the softmax cast back to v's dtype. No hand-written kernel runs
here; every product is a PyTorch matmul, as every one is plain XLA there.

Train mode takes an optional ``core.HFDropout`` (``--hf_internal_dropout``):
the HF model's own p = 0.1 sites, in its call order — each stack's
embeddings, and in every layer the attention probabilities and the
out-projection of each attention (self, then cross in the decoder), then
the FFN after its activation and after fc2. ``BartClassifier`` in train
mode drops its head's input and hidden at ``drop_ratio``.

The fusion models use ``BartModel`` (``encode_decoder``) as a text tower;
``cli.test_text`` / ``cli.main_text --text_model=bart`` run
``BartClassifier``.
"""

from __future__ import annotations

import math
import re
from typing import Optional

import numpy as np
import torch
from torch import nn

from ...nn import core
from ..registry import ModelDef
from .encoder_common import lin, ln_, strip_prefix

HIDDEN = 1024
LAYERS = 12
HEADS = 16
FFN = 4096
VOCAB = 50265
MAX_POS = 1024
POS_OFFSET = 2
LN_EPS = 1e-5
PAD_ID = 1
EOS_ID = 2
START_ID = 2
NEG = float(np.finfo(np.float32).min)
# facebook/bart-large's config: dropout / attention_dropout /
# activation_dropout, active in the reference's train-mode towers
# (--hf_internal_dropout reproduces them)
DROPOUT = 0.1
ATTN_DROPOUT = 0.1
ACT_DROPOUT = 0.1


class Attention(nn.Module):
    def __init__(self, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.q = core.Linear(HIDDEN, HIDDEN, generator=g)
        self.k = core.Linear(HIDDEN, HIDDEN, generator=g)
        self.v = core.Linear(HIDDEN, HIDDEN, generator=g)
        self.out = core.Linear(HIDDEN, HIDDEN, generator=g)


class EncoderLayer(nn.Module):
    def __init__(self, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.self = Attention(generator=g)
        self.ln_self = core.LayerNorm(HIDDEN, LN_EPS)
        self.fc1 = core.Linear(HIDDEN, FFN, generator=g)
        self.fc2 = core.Linear(FFN, HIDDEN, generator=g)
        self.ln_final = core.LayerNorm(HIDDEN, LN_EPS)


class DecoderLayer(EncoderLayer):
    def __init__(self, *, generator: Optional[torch.Generator] = None):
        super().__init__(generator=generator)
        self.cross = Attention(generator=generator)
        self.ln_cross = core.LayerNorm(HIDDEN, LN_EPS)


class BartModel(nn.Module):
    """The bare BartModel (the fusion towers' tower). `layers` encoder and
    as many decoder layers; `vocab` defaults to the module's VOCAB."""

    def __init__(self, layers: int = LAYERS, *, vocab: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.shared = core.Embedding(vocab or VOCAB, HIDDEN, generator=g)
        self.enc_pos = core.Embedding(MAX_POS + POS_OFFSET, HIDDEN,
                                      generator=g)
        self.dec_pos = core.Embedding(MAX_POS + POS_OFFSET, HIDDEN,
                                      generator=g)
        self.enc_ln_emb = core.LayerNorm(HIDDEN, LN_EPS)
        self.dec_ln_emb = core.LayerNorm(HIDDEN, LN_EPS)
        self.enc_layers = nn.ModuleList(EncoderLayer(generator=g)
                                        for _ in range(layers))
        self.dec_layers = nn.ModuleList(DecoderLayer(generator=g)
                                        for _ in range(layers))


class BartClassifier(BartModel):
    """BartForSequenceClassification: the tree of the JAX ``bart.init``
    (``head_dense``, ``head_out`` beside the model's entries)."""

    def __init__(self, layers: int = LAYERS, num_classes: int = 4, *,
                 vocab: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(layers, vocab=vocab, generator=generator)
        self.head_dense = core.Linear(HIDDEN, HIDDEN, generator=generator)
        self.head_out = core.Linear(HIDDEN, num_classes, generator=generator)

    def forward(self, input_ids, attention_mask, *, train: bool = False,
                key: Optional[core.Key] = None, drop_ratio: float = 0.6,
                hf_internal_dropout: bool = False):
        """int32 [B, L] ids and mask -> logits [B, n_classes].

        HF's classification head: dropout -> dense -> tanh -> dropout ->
        out_proj, both dropouts at ``drop_ratio`` in train mode with a
        `key`. The key derives as the JAX ``apply``'s rng does: with
        ``hf_internal_dropout`` it is split first and its second half makes
        the model's ``HFDropout``; the (remaining) key then splits in two,
        one for each head site."""
        drop = None
        if hf_internal_dropout and train and key is not None:
            key, k_int = key.split(2)
            drop = core.HFDropout(k_int)
        pooled = eos_pooled(self, input_ids, attention_mask, drop=drop)
        k1, k2 = key.split(2) if train and key is not None else (None, None)
        h = core.dropout(pooled, drop_ratio, _gen(k1, pooled))
        h = torch.tanh(self.head_dense(h))
        h = core.dropout(h, drop_ratio, _gen(k2, h))
        return self.head_out(h)


def _gen(key: Optional[core.Key], x: torch.Tensor):
    return None if key is None else key.generator(x.device)


def _attn(p: Attention, x_q, x_kv, bias, drop=None):
    b, lq, d = x_q.shape
    lk, hd = x_kv.shape[1], d // HEADS
    q = p.q(x_q).reshape(b, lq, HEADS, hd).transpose(1, 2)
    k = p.k(x_kv).reshape(b, lk, HEADS, hd).transpose(1, 2)
    v = p.v(x_kv).reshape(b, lk, HEADS, hd).transpose(1, 2)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
        / math.sqrt(hd)
    w = torch.softmax(scores + bias, dim=-1).to(v.dtype)
    if drop is not None:                  # the attention probabilities
        w = drop(w, ATTN_DROPOUT)
    out = p.out(torch.matmul(w, v).transpose(1, 2).reshape(b, lq, d))
    return out if drop is None else drop(out, DROPOUT)


def _ffn(p: EncoderLayer, x, drop=None):
    """fc1 -> gelu -> activation dropout -> fc2 -> dropout."""
    h = core.gelu(p.fc1(x))
    if drop is not None:
        h = drop(h, ACT_DROPOUT)
    h = p.fc2(h)
    return h if drop is None else drop(h, DROPOUT)


def _enc_layer(p: EncoderLayer, x, bias, drop=None):
    x = p.ln_self(x + _attn(p.self, x, x, bias, drop))
    return p.ln_final(x + _ffn(p, x, drop))


def _dec_layer(p: DecoderLayer, x, enc, self_bias, cross_bias, drop=None):
    x = p.ln_self(x + _attn(p.self, x, x, self_bias, drop))
    x = p.ln_cross(x + _attn(p.cross, x, enc, cross_bias, drop))
    return p.ln_final(x + _ffn(p, x, drop))


def shift_tokens_right(input_ids: torch.Tensor) -> torch.Tensor:
    shifted = torch.roll(input_ids, 1, dims=1)
    shifted[:, 0] = START_ID
    return shifted


def encode_decoder(model: BartModel, input_ids: torch.Tensor,
                   attention_mask: torch.Tensor,
                   drop: Optional[core.HFDropout] = None) -> torch.Tensor:
    """BartModel forward -> the decoder's last hidden state [B, L, 1024].
    `attention_mask` is int32 [B, L]; `drop`: an optional
    ``core.HFDropout`` for the model's own dropout sites (train mode)."""
    n = input_ids.shape[1]
    h = model.shared(input_ids) \
        + model.enc_pos.w[POS_OFFSET:POS_OFFSET + n][None]
    h = model.enc_ln_emb(h)
    if drop is not None:
        h = drop(h, DROPOUT)
    enc_bias = ((1.0 - attention_mask.float()) * NEG)[:, None, None, :]
    for lp in model.enc_layers:
        h = _enc_layer(lp, h, enc_bias, drop)

    d = model.shared(shift_tokens_right(input_ids)) \
        + model.dec_pos.w[POS_OFFSET:POS_OFFSET + n][None]
    d = model.dec_ln_emb(d)
    if drop is not None:
        d = drop(d, DROPOUT)
    causal = torch.ones((n, n), device=input_ids.device).tril()
    self_bias = ((1.0 - causal) * NEG)[None, None]
    for lp in model.dec_layers:
        d = _dec_layer(lp, d, h, self_bias, enc_bias, drop)
    return d


def eos_pooled(model: BartModel, input_ids, attention_mask, drop=None):
    """The decoder's hidden state at the LAST eos of each row of
    input_ids (position 0 where a row has none)."""
    h = encode_decoder(model, input_ids, attention_mask, drop)
    pos = torch.arange(input_ids.shape[1], device=input_ids.device)
    last = torch.where(input_ids == EOS_ID, pos, -1).amax(dim=1).clamp(0)
    return h[torch.arange(h.shape[0], device=h.device), last]


def _attn_c(sd, pre):
    return {"q": lin(sd, pre + ".q_proj"), "k": lin(sd, pre + ".k_proj"),
            "v": lin(sd, pre + ".v_proj"), "out": lin(sd, pre + ".out_proj")}


def convert_torch(sd, num_classes: int = 4):
    """A BartForSequenceClassification (``model.*`` +
    ``classification_head.*``) or bare BartModel state dict (optionally
    under ``text_model.``) -> (params, state) in the JAX tree layout, as
    many layers as it holds. The tied ``{encoder,decoder}.embed_tokens``
    copies of ``shared`` are left unread."""
    params = {}
    if "classification_head.dense.weight" in sd:
        params["head_dense"] = lin(sd, "classification_head.dense")
        params["head_out"] = lin(sd, "classification_head.out_proj")
        if params["head_out"]["w"].shape[1] != num_classes:
            raise ValueError("head class-count mismatch")
    sd = strip_prefix(sd, "model.", "text_model.")
    n_layers = len({m.group(1) for k in sd
                    for m in [re.match(r"encoder\.layers\.(\d+)\.", k)] if m})
    params.update({
        "shared": {"w": np.asarray(sd["shared.weight"])},
        "enc_pos": {"w": np.asarray(sd["encoder.embed_positions.weight"])},
        "dec_pos": {"w": np.asarray(sd["decoder.embed_positions.weight"])},
        "enc_ln_emb": ln_(sd, "encoder.layernorm_embedding"),
        "dec_ln_emb": ln_(sd, "decoder.layernorm_embedding"),
        "enc_layers": [], "dec_layers": [],
    })
    for i in range(n_layers):
        pre = f"encoder.layers.{i}."
        params["enc_layers"].append({
            "self": _attn_c(sd, pre + "self_attn"),
            "ln_self": ln_(sd, pre + "self_attn_layer_norm"),
            "fc1": lin(sd, pre + "fc1"), "fc2": lin(sd, pre + "fc2"),
            "ln_final": ln_(sd, pre + "final_layer_norm"),
        })
        pre = f"decoder.layers.{i}."
        params["dec_layers"].append({
            "self": _attn_c(sd, pre + "self_attn"),
            "ln_self": ln_(sd, pre + "self_attn_layer_norm"),
            "cross": _attn_c(sd, pre + "encoder_attn"),
            "ln_cross": ln_(sd, pre + "encoder_attn_layer_norm"),
            "fc1": lin(sd, pre + "fc1"), "fc2": lin(sd, pre + "fc2"),
            "ln_final": ln_(sd, pre + "final_layer_norm"),
        })
    return params, {}


def model_def(name: str = "bart") -> ModelDef:
    def build(num_classes: int = 4, *, layers: int = LAYERS, generator=None):
        return BartClassifier(layers, num_classes, generator=generator)

    return ModelDef(name=name, build=build, convert_torch=convert_torch,
                    depth=lambda params: len(params["enc_layers"]))
