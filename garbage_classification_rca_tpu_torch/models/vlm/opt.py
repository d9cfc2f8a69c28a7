"""OPT decoder (facebook/opt-2.7b geometry) for the BLIP-2 language model.

The port of the eval part of the JAX package's ``models/vlm/opt.py``:
learned positional embeddings with the OPT +2 offset, computed from the
attention mask (position = number of valid predecessors + 2), pre-LN
decoder layers, ReLU MLP, ``final_layer_norm``, the lm head tied to
``embed_tokens``. BLIP-2 prepends its 32 projected query embeddings to
the text embeddings; ``decode_hidden`` takes the built embeddings and the
combined [B, L] mask.

Each layer's attention is the ``mha`` kernel (K2) with ``causal=True`` and
the int32 key mask, at head dim 80 on the card (2560 / 32 heads). Its
masks follow ``mha_reference``: a pad key scores -1e30 and a key past the
diagonal is set to -1e30, so a row without an attendable key spreads its
weights over all N keys, as the JAX package's graph does with its
``finfo(float32).min`` bias; such rows are pad positions that no valid
query reads. LoRA adapters add ``(h @ a) @ b * scale`` to the q and k
projections (peft's ``q_proj`` / ``k_proj`` targets).

Not ported yet (ROADMAP.md, queue 1 items 5 and 6): the train branch (the
flash pair at head dim 80), the KV caches, ``generate``,
``speculative_generate`` and int8 weights.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn

from ...kernels.mha_fused import mha
from ...nn import core
from ..text.encoder_common import lin, ln_


@dataclass(frozen=True)
class OPTConfig:
    layers: int = 32
    hidden: int = 2560
    heads: int = 32
    ffn: int = 10240
    vocab: int = 50272
    max_pos: int = 2048
    ln_eps: float = 1e-5
    pos_offset: int = 2


class OPTLayer(nn.Module):
    def __init__(self, cfg: OPTConfig):
        super().__init__()
        d = cfg.hidden
        self.ln1 = core.LayerNorm(d, cfg.ln_eps)
        self.q = core.Linear(d, d)
        self.k = core.Linear(d, d)
        self.v = core.Linear(d, d)
        self.out = core.Linear(d, d)
        self.ln2 = core.LayerNorm(d, cfg.ln_eps)
        self.fc1 = core.Linear(d, cfg.ffn)
        self.fc2 = core.Linear(cfg.ffn, d)


class OPTDecoder(nn.Module):
    """The tree of the JAX ``opt.init``."""

    def __init__(self, cfg: OPTConfig):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = core.Embedding(cfg.vocab, cfg.hidden)
        self.embed_positions = core.Embedding(cfg.max_pos + cfg.pos_offset,
                                              cfg.hidden)
        self.final_ln = core.LayerNorm(cfg.hidden, cfg.ln_eps)
        self.layers = nn.ModuleList(OPTLayer(cfg) for _ in range(cfg.layers))


class LoraPair(nn.Module):
    """One projection's adapter in the JAX layout: a [in, r], b [r, out]."""

    def __init__(self, d_in: int, r: int, d_out: int):
        super().__init__()
        self.a = nn.Parameter(torch.zeros(d_in, r))
        self.b = nn.Parameter(torch.zeros(r, d_out))

    def forward(self, x):
        return (x @ self.a.to(x.dtype)) @ self.b.to(x.dtype)


class Lora(nn.ModuleDict):
    """The JAX package's str-keyed adapter tree: {"0": {"q": .., "k": ..},
    ...}, one entry per OPT layer."""

    def __init__(self, cfg: OPTConfig, r: int):
        d = cfg.hidden
        super().__init__({str(i): nn.ModuleDict(
            {name: LoraPair(d, r, d) for name in ("q", "k")})
            for i in range(cfg.layers)})


def _layer(p: OPTLayer, x, mask, cfg: OPTConfig, lora, lora_scale: float):
    """One pre-LN decoder layer, eval."""
    h = p.ln1(x)
    q, k = p.q(h), p.k(h)
    if lora is not None:
        q = q + lora.q(h) * lora_scale
        k = k + lora.k(h) * lora_scale
    att = mha(q, k, p.v(h), heads=cfg.heads, mask=mask, causal=True)
    x = x + p.out(att)
    return x + p.fc2(core.relu(p.fc1(p.ln2(x))))


def prompt_prologue(model: OPTDecoder, inputs_embeds, attention_mask):
    """OPT's learned-position add, HF's cumsum convention (position =
    #valid predecessors + offset, clipped to the table). Returns
    (h [B, L, H], mask int32 [B, L])."""
    cfg = model.cfg
    mask = attention_mask.to(torch.int32)
    positions = torch.cumsum(mask, dim=1) * mask - 1 + cfg.pos_offset
    positions = positions.clamp(0, cfg.max_pos + cfg.pos_offset - 1)
    h = inputs_embeds + model.embed_positions(positions).to(
        inputs_embeds.dtype)
    return h, mask


def decode_hidden(model: OPTDecoder, inputs_embeds, attention_mask,
                  lora: Optional[Lora] = None,
                  lora_scale: float = 1.0) -> torch.Tensor:
    """inputs_embeds [B, L, H] + mask [B, L] -> final hidden [B, L, H]
    (post final_layer_norm; ``lm_head`` projects it)."""
    h, mask = prompt_prologue(model, inputs_embeds, attention_mask)
    for i, lp in enumerate(model.layers):
        h = _layer(lp, h, mask, model.cfg,
                   None if lora is None else lora[str(i)], lora_scale)
    return model.final_ln(h)


def lm_head(model: OPTDecoder, h: torch.Tensor) -> torch.Tensor:
    """Hidden -> vocab logits (tied input embeddings). [B, L, H] or
    gathered [B, H]."""
    return h @ model.embed_tokens.w.to(h.dtype).t()


def embed_tokens(model: OPTDecoder, input_ids: torch.Tensor) -> torch.Tensor:
    return model.embed_tokens(input_ids)


def convert_torch(sd, cfg: OPTConfig):
    """HF keys under ``language_model.model.decoder.*`` (prefix-stripped)
    -> the JAX tree layout."""
    params = {
        "embed_tokens": {"w": np.asarray(sd["embed_tokens.weight"])},
        "embed_positions": {"w": np.asarray(sd["embed_positions.weight"])},
        "final_ln": ln_(sd, "final_layer_norm"),
        "layers": [],
    }
    for i in range(cfg.layers):
        pre = f"layers.{i}."
        params["layers"].append({
            "ln1": ln_(sd, pre + "self_attn_layer_norm"),
            "q": lin(sd, pre + "self_attn.q_proj"),
            "k": lin(sd, pre + "self_attn.k_proj"),
            "v": lin(sd, pre + "self_attn.v_proj"),
            "out": lin(sd, pre + "self_attn.out_proj"),
            "ln2": ln_(sd, pre + "final_layer_norm"),
            "fc1": lin(sd, pre + "fc1"),
            "fc2": lin(sd, pre + "fc2"),
        })
    return params
