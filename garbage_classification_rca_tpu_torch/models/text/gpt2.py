"""GPT-2 (small) causal decoder and its sequence-classification head.

The port of the JAX package's ``models/text/gpt2.py`` (the reference's
``GPT2ForSequenceClassification`` 'gpt2' with its ``score`` replaced by a
bias-free Linear(768, n) and pad = eos): pre-norm blocks (``ln_1`` ->
attention -> residual, ``ln_2`` -> MLP -> residual), a final ``ln_f``,
the tanh-approximate GELU (``gelu_new``) in the MLP. HF's Conv1D weights
are already ``[in, out]``, the JAX tree's Linear layout, so the converter
copies them as they are.

The attention is the JAX module's own einsum attention (no kernel of
``kernels/`` runs here, as none does there): scores summed in fp32 from
the activations' values and divided by sqrt(64) after the product, the
additive bias ``(1 - causal * pad) * finfo(float32).min`` built and added
in fp32 (a row whose keys are all padded spreads its weights uniformly,
with no NaN), the softmax cast back to v's dtype.

The classifier pools the final hidden state at ``(input_ids != PAD_ID)
.sum(-1) - 1``, clipped to [0, L - 1]: counted from the ids, not the
mask, so a row that begins and ends with eos (= pad) pools before its
last word. GPT-2 has no dropout on its pooled feature. Train mode takes
an optional ``core.HFDropout`` (``--hf_internal_dropout``) on the key
folded with 0x4F02: HF's p = 0.1 sites, the embeddings, then in every
layer the attention probabilities, the attention ``c_proj`` output and
the MLP ``c_proj`` output.
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
from .encoder_common import ln_, strip_prefix

HIDDEN = 768
LAYERS = 12
HEADS = 12
FFN = 3072
VOCAB = 50257
MAX_POS = 1024
LN_EPS = 1e-5
PAD_ID = 50256          # eos (the reference pads with it)
NEG = float(np.finfo(np.float32).min)
# HF gpt2 config: embd_pdrop / attn_pdrop / resid_pdrop
EMBD_PDROP = 0.1
ATTN_PDROP = 0.1
RESID_PDROP = 0.1
DROPOUT_FOLD = 0x4F02   # the HF sites' key: fold_in(key, DROPOUT_FOLD)


class Block(nn.Module):
    def __init__(self, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.ln_1 = core.LayerNorm(HIDDEN, LN_EPS)
        self.c_attn = core.Linear(HIDDEN, 3 * HIDDEN, generator=g)
        self.c_proj = core.Linear(HIDDEN, HIDDEN, generator=g)
        self.ln_2 = core.LayerNorm(HIDDEN, LN_EPS)
        self.mlp_fc = core.Linear(HIDDEN, FFN, generator=g)
        self.mlp_proj = core.Linear(FFN, HIDDEN, generator=g)


class GPT2Classifier(nn.Module):
    """The tree of the JAX ``gpt2.init``: ``wte``, ``wpe``, ``ln_f``,
    ``layers`` and the bias-free ``score``."""

    def __init__(self, layers: int = LAYERS, num_classes: int = 4, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.wte = core.Embedding(VOCAB, HIDDEN, generator=g)
        self.wpe = core.Embedding(MAX_POS, HIDDEN, generator=g)
        self.ln_f = core.LayerNorm(HIDDEN, LN_EPS)
        self.layers = nn.ModuleList(Block(generator=g) for _ in range(layers))
        self.score = core.Linear(HIDDEN, num_classes, bias=False, generator=g)

    def forward(self, input_ids, attention_mask, *, train: bool = False,
                key: Optional[core.Key] = None, drop_ratio: float = 0.0,
                hf_internal_dropout: bool = False):
        """int32 [B, L] ids and mask -> logits [B, n_classes].
        `drop_ratio` is taken for the text classifiers' common interface
        and read by nothing: GPT-2's head has no dropout. With
        ``hf_internal_dropout`` in train mode with a `key`, the model's own
        sites draw on ``key.fold_in(DROPOUT_FOLD)``."""
        drop = None
        if hf_internal_dropout and train and key is not None:
            drop = core.HFDropout(key.fold_in(DROPOUT_FOLD))
        return self.score(pooled_feature(self, input_ids, attention_mask,
                                         drop))


def _block(p: Block, x, bias, drop=None):
    b, n, d = x.shape
    hd = d // HEADS
    q, k, v = (t.reshape(b, n, HEADS, hd).transpose(1, 2)
               for t in p.c_attn(p.ln_1(x)).split(d, dim=-1))
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
        / math.sqrt(hd)
    w = torch.softmax(scores + bias, dim=-1).to(v.dtype)
    if drop is not None:                  # the attention probabilities
        w = drop(w, ATTN_PDROP)
    att = p.c_proj(torch.matmul(w, v).transpose(1, 2).reshape(b, n, d))
    if drop is not None:
        att = drop(att, RESID_PDROP)
    x = x + att
    h = p.mlp_proj(core.gelu_tanh(p.mlp_fc(p.ln_2(x))))
    if drop is not None:
        h = drop(h, RESID_PDROP)
    return x + h


def encode(model: GPT2Classifier, input_ids: torch.Tensor,
           attention_mask: torch.Tensor,
           drop: Optional[core.HFDropout] = None) -> torch.Tensor:
    """-> the last hidden state [B, L, 768] after ``ln_f``.
    `attention_mask` is int32 [B, L]."""
    n = input_ids.shape[1]
    pos = torch.arange(n, device=input_ids.device)
    h = model.wte(input_ids) + model.wpe(pos)[None]
    if drop is not None:
        h = drop(h, EMBD_PDROP)
    causal = torch.ones((n, n), device=input_ids.device).tril()[None, None]
    pad = attention_mask.float()[:, None, None, :]
    bias = (1.0 - causal * pad) * NEG
    for lp in model.layers:
        h = _block(lp, h, bias, drop)
    return model.ln_f(h)


def pooled_feature(model: GPT2Classifier, input_ids, attention_mask,
                   drop=None) -> torch.Tensor:
    """The hidden state at the last non-pad token, counted from the ids
    (HF sequence classification)."""
    h = encode(model, input_ids, attention_mask, drop)
    last = ((input_ids != PAD_ID).sum(-1) - 1).clamp(0, h.shape[1] - 1)
    return h[torch.arange(h.shape[0], device=h.device), last]


def _conv1d(sd, prefix):
    """HF Conv1D stores its weight [in, out]: no transpose."""
    return {"w": np.asarray(sd[prefix + ".weight"]),
            "b": np.asarray(sd[prefix + ".bias"])}


def convert_torch(sd, num_classes: int = 4):
    """A reference GPT-2 classifier state dict (``transformer.*`` and
    ``score.weight``, optionally under the wrapper's ``model.``) -> (params,
    state) in the JAX tree layout, as many layers as it holds; ``score``
    as [768, n]."""
    sd = strip_prefix(sd, "model.")
    score = None
    if "score.weight" in sd:
        w = np.asarray(sd["score.weight"]).T
        if w.shape[1] != num_classes:
            raise ValueError("score head class-count mismatch")
        score = {"w": w}
    sd = strip_prefix(sd, "transformer.")
    n_layers = len({m.group(1) for k in sd
                    for m in [re.match(r"h\.(\d+)\.", k)] if m})
    params = {
        "wte": {"w": np.asarray(sd["wte.weight"])},
        "wpe": {"w": np.asarray(sd["wpe.weight"])},
        "ln_f": ln_(sd, "ln_f"),
        "layers": [],
    }
    for i in range(n_layers):
        pre = f"h.{i}."
        params["layers"].append({
            "ln_1": ln_(sd, pre + "ln_1"),
            "c_attn": _conv1d(sd, pre + "attn.c_attn"),
            "c_proj": _conv1d(sd, pre + "attn.c_proj"),
            "ln_2": ln_(sd, pre + "ln_2"),
            "mlp_fc": _conv1d(sd, pre + "mlp.c_fc"),
            "mlp_proj": _conv1d(sd, pre + "mlp.c_proj"),
        })
    if score is not None:
        params["score"] = score
    return params, {}


def model_def(name: str = "gpt2") -> ModelDef:
    def build(num_classes: int = 4, *, layers: int = LAYERS, generator=None):
        return GPT2Classifier(layers, num_classes, generator=generator)

    return ModelDef(name=name, build=build, convert_torch=convert_torch)
