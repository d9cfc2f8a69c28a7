"""MobileBERT (uncased) and its classification head.

The port of the JAX package's ``models/text/mobilebert.py`` (the
reference's ``MobileBertForSequenceClassification``
'google/mobilebert-uncased' with its classifier replaced by
Linear(512, n)):
  * trigram input embeddings: ``cat(shift-left, self, shift-right)`` of the
    128-d word embeddings, zero-padded whatever the mask, then
    Linear(384 -> 512), the position embeddings and token type 0's row;
  * NoNorm (``x * scale + bias`` in the activation's dtype) wherever BERT
    has a LayerNorm;
  * 24 bottleneck layers: query and key from one shared 512 -> 128
    bottleneck, value from the raw 512 hidden, the attention's residual
    to the other bottleneck (``bn_in``); 4 heads of 32; three stacked ReLU
    FFNs (128 -> 512 -> 128) after the attention, then ``intermediate`` /
    ``out_dense`` and a 128 -> 512 output bottleneck with a residual to
    the 512 stream;
  * the classifier pools token 0, through the pooler's dense + tanh only
    where the checkpoint has one (``classifier_activation``;
    google/mobilebert-uncased ships none), then Linear(512, n).

The attention is the JAX module's own einsum attention (no kernel of
``kernels/`` runs here, as none does there): fp32 scores divided by
sqrt(32) after the product, the additive key bias ``(1 - mask) *
finfo(float32).min`` added in fp32, the softmax cast back to v's dtype.

Train mode: the head drops its pooled feature at ``drop_ratio``, 0.0 by
default (the JAX ``apply``'s). With ``hf_internal_dropout`` the key is
split first and its second half makes the model's ``HFDropout``, whose
only sites are the attention probabilities (p = 0.1; the uncased
config's hidden dropout is 0.0): one a layer.
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
from .encoder_common import lin, strip_prefix

HIDDEN = 512
EMB = 128
INTRA = 128          # intra_bottleneck_size (the true hidden size)
LAYERS = 24
HEADS = 4
FFN = 512
N_FFN = 3            # the extra FFNs (num_feedforward_networks = 4)
VOCAB = 30522
MAX_POS = 512
NEG = float(np.finfo(np.float32).min)
ATTN_DROPOUT = 0.1


class NoNorm(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))

    def forward(self, x):
        return x * self.scale.to(x.dtype) + self.bias.to(x.dtype)


class Attention(nn.Module):
    def __init__(self, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.q = core.Linear(INTRA, INTRA, generator=g)
        self.k = core.Linear(INTRA, INTRA, generator=g)
        self.v = core.Linear(HIDDEN, INTRA, generator=g)
        self.out = core.Linear(INTRA, INTRA, generator=g)
        self.out_norm = NoNorm(INTRA)


class FeedForward(nn.Module):
    def __init__(self, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc1 = core.Linear(INTRA, FFN, generator=generator)
        self.fc2 = core.Linear(FFN, INTRA, generator=generator)
        self.norm = NoNorm(INTRA)


class Layer(nn.Module):
    def __init__(self, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.bn_in = core.Linear(HIDDEN, INTRA, generator=g)
        self.bn_in_norm = NoNorm(INTRA)
        self.bn_att = core.Linear(HIDDEN, INTRA, generator=g)
        self.bn_att_norm = NoNorm(INTRA)
        self.att = Attention(generator=g)
        self.ffn = nn.ModuleList(FeedForward(generator=g)
                                 for _ in range(N_FFN))
        self.intermediate = core.Linear(INTRA, FFN, generator=g)
        self.out_dense = core.Linear(FFN, INTRA, generator=g)
        self.out_norm = NoNorm(INTRA)
        self.bn_out = core.Linear(INTRA, HIDDEN, generator=g)
        self.bn_out_norm = NoNorm(HIDDEN)


class MobileBertClassifier(nn.Module):
    """The tree of the JAX ``mobilebert.init`` (+ ``pooler`` when the
    checkpoint has one)."""

    def __init__(self, layers: int = LAYERS, num_classes: int = 4, *,
                 pooler: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.word_emb = core.Embedding(VOCAB, EMB, generator=g)
        self.emb_transform = core.Linear(3 * EMB, HIDDEN, generator=g)
        self.pos_emb = core.Embedding(MAX_POS, HIDDEN, generator=g)
        self.type_emb = core.Embedding(2, HIDDEN, generator=g)
        self.emb_norm = NoNorm(HIDDEN)
        self.layers = nn.ModuleList(Layer(generator=g) for _ in range(layers))
        self.pooler = (core.Linear(HIDDEN, HIDDEN, generator=g) if pooler
                       else None)
        self.classifier = core.Linear(HIDDEN, num_classes, generator=g)

    def forward(self, input_ids, attention_mask, *, train: bool = False,
                key: Optional[core.Key] = None, drop_ratio: float = 0.0,
                hf_internal_dropout: bool = False):
        """int32 [B, L] ids and mask -> logits [B, n_classes]. The key
        derives as the JAX ``apply``'s rng: with ``hf_internal_dropout``,
        ``key, k_int = key.split(2)`` and k_int makes the model's
        ``HFDropout``; the (remaining) key draws the head dropout."""
        drop = None
        if hf_internal_dropout and train and key is not None:
            key, k_int = key.split(2)
            drop = core.HFDropout(k_int)
        pooled = encode(self, input_ids, attention_mask, drop)[:, 0]
        if self.pooler is not None:
            pooled = torch.tanh(self.pooler(pooled))
        if train and key is not None:
            pooled = core.dropout(pooled, drop_ratio,
                                  key.generator(pooled.device))
        return self.classifier(pooled)


def _self_attention(p: Attention, shared_qk, hidden, layer_input, bias,
                    drop=None):
    q, k, v = p.q(shared_qk), p.k(shared_qk), p.v(hidden)
    b, n, d = q.shape
    hd = d // HEADS
    q, k, v = (t.reshape(b, n, HEADS, hd).transpose(1, 2)
               for t in (q, k, v))
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
        / math.sqrt(hd)
    w = torch.softmax(scores + bias, dim=-1).to(v.dtype)
    if drop is not None:                  # the attention probabilities
        w = drop(w, ATTN_DROPOUT)
    att = torch.matmul(w, v).transpose(1, 2).reshape(b, n, d)
    return p.out_norm(p.out(att) + layer_input)


def _layer(p: Layer, hidden, bias, drop=None):
    bottleneck = p.bn_in_norm(p.bn_in(hidden))
    shared_qk = p.bn_att_norm(p.bn_att(hidden))
    att = _self_attention(p.att, shared_qk, hidden, bottleneck, bias, drop)
    for f in p.ffn:
        att = f.norm(f.fc2(torch.relu(f.fc1(att))) + att)
    out = p.out_norm(p.out_dense(torch.relu(p.intermediate(att))) + att)
    return p.bn_out_norm(p.bn_out(out) + hidden)


def encode(model: MobileBertClassifier, input_ids: torch.Tensor,
           attention_mask: torch.Tensor,
           drop: Optional[core.HFDropout] = None) -> torch.Tensor:
    """-> the last hidden state [B, L, 512]. `attention_mask` is int32
    [B, L]."""
    emb = model.word_emb(input_ids)                          # [B, L, 128]
    left = torch.nn.functional.pad(emb[:, 1:], (0, 0, 0, 1))
    right = torch.nn.functional.pad(emb[:, :-1], (0, 0, 1, 0))
    h = model.emb_transform(torch.cat([left, emb, right], dim=2))
    pos = torch.arange(input_ids.shape[1], device=input_ids.device)
    h = h + model.pos_emb(pos)[None]
    h = model.emb_norm(h + model.type_emb.w[0][None, None])
    bias = ((1.0 - attention_mask.float()) * NEG)[:, None, None, :]
    for lp in model.layers:
        h = _layer(lp, h, bias, drop)
    return h


def _nonorm_c(sd, pre):
    return {"scale": np.asarray(sd[pre + ".weight"]),
            "bias": np.asarray(sd[pre + ".bias"])}


def convert_torch(sd, num_classes: int = 4, n_layers: Optional[int] = None):
    """A reference MobileBERT classifier state dict (``mobilebert.*``,
    ``classifier.*``, optionally under the wrapper's ``model.``) or a bare
    MobileBertModel one -> (params, state) in the JAX tree layout;
    `n_layers` layers, by default as many as it holds. The pooler's dense
    comes along where the checkpoint has one."""
    sd = strip_prefix(sd, "model.")
    classifier = pooler = None
    if "classifier.weight" in sd:
        classifier = lin(sd, "classifier")
        if classifier["w"].shape[1] != num_classes:
            raise ValueError("classifier class-count mismatch")
    for pre in ("mobilebert.pooler.dense", "pooler.dense"):
        if pre + ".weight" in sd:
            pooler = lin(sd, pre)
            break
    sd = strip_prefix(sd, "mobilebert.")
    if n_layers is None:
        n_layers = len({m.group(1) for k in sd
                        for m in [re.match(r"encoder\.layer\.(\d+)\.", k)]
                        if m})
    params = {
        "word_emb": {"w": np.asarray(sd["embeddings.word_embeddings.weight"])},
        "emb_transform": lin(sd, "embeddings.embedding_transformation"),
        "pos_emb": {"w": np.asarray(
            sd["embeddings.position_embeddings.weight"])},
        "type_emb": {"w": np.asarray(
            sd["embeddings.token_type_embeddings.weight"])},
        "emb_norm": _nonorm_c(sd, "embeddings.LayerNorm"),
        "layers": [],
    }
    for i in range(n_layers):
        pre = f"encoder.layer.{i}."
        params["layers"].append({
            "bn_in": lin(sd, pre + "bottleneck.input.dense"),
            "bn_in_norm": _nonorm_c(sd, pre + "bottleneck.input.LayerNorm"),
            "bn_att": lin(sd, pre + "bottleneck.attention.dense"),
            "bn_att_norm": _nonorm_c(
                sd, pre + "bottleneck.attention.LayerNorm"),
            "att": {"q": lin(sd, pre + "attention.self.query"),
                    "k": lin(sd, pre + "attention.self.key"),
                    "v": lin(sd, pre + "attention.self.value"),
                    "out": lin(sd, pre + "attention.output.dense"),
                    "out_norm": _nonorm_c(
                        sd, pre + "attention.output.LayerNorm")},
            "ffn": [{"fc1": lin(sd, pre + f"ffn.{j}.intermediate.dense"),
                     "fc2": lin(sd, pre + f"ffn.{j}.output.dense"),
                     "norm": _nonorm_c(
                         sd, pre + f"ffn.{j}.output.LayerNorm")}
                    for j in range(N_FFN)],
            "intermediate": lin(sd, pre + "intermediate.dense"),
            "out_dense": lin(sd, pre + "output.dense"),
            "out_norm": _nonorm_c(sd, pre + "output.LayerNorm"),
            "bn_out": lin(sd, pre + "output.bottleneck.dense"),
            "bn_out_norm": _nonorm_c(
                sd, pre + "output.bottleneck.LayerNorm"),
        })
    if classifier is not None:
        params["classifier"] = classifier
    if pooler is not None:
        params["pooler"] = pooler
    return params, {}


def model_def(name: str = "mobilebert") -> ModelDef:
    def build(num_classes: int = 4, *, layers: int = LAYERS,
              pooler: bool = False, generator=None):
        return MobileBertClassifier(layers, num_classes, pooler=pooler,
                                    generator=generator)

    return ModelDef(name=name, build=build, convert_torch=convert_torch,
                    options=lambda names: {"pooler": "pooler" in names})
