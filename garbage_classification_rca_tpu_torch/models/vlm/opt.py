"""OPT decoder (facebook/opt-2.7b geometry) for the BLIP-2 language model.

The port of the eval and train parts of the JAX package's
``models/vlm/opt.py``:
learned positional embeddings with the OPT +2 offset, computed from the
attention mask (position = number of valid predecessors + 2), pre-LN
decoder layers, ReLU MLP, ``final_layer_norm``, the lm head tied to
``embed_tokens``. BLIP-2 prepends its 32 projected query embeddings to
the text embeddings; ``decode_hidden`` takes the built embeddings and the
combined [B, L] mask.

Each layer's attention is, in eval, the ``mha`` kernel (K2) with
``causal=True`` and the int32 key mask, at head dim 80 on the card (2560 /
32 heads); in training (``train=True``: BLIP-2's LoRA fine-tuning) the
flash pair ``mha_flash_train`` (K4a forward + lse, K4b backward) at the
same head dim and masks. The masks follow ``mha_reference``: a pad key
scores -1e30 and a key past the diagonal is set to -1e30, so a row without
an attendable key spreads its weights over all N keys, as the JAX
package's graph does with its ``finfo(float32).min`` bias; such rows are
pad positions that no valid query reads. LoRA adapters add ``(h @ a) @ b *
scale`` to the q and k projections (peft's ``q_proj`` / ``k_proj``
targets).

With an active ``nn.core.HFDropout`` (``--hf_internal_dropout``) the train
branch runs HF's OPT sites in the JAX package's order: peft's
lora_dropout (0.05) on the adapter input of q, then of k; the attention
weights (``attention_dropout``, 0.0 for opt-2.7b, so it consumes no site
and the flash pair runs without dropout; a nonzero value is refused); the
attention output and the FFN output before their residuals (``dropout``,
0.1). ``shifted_ce`` is the CausalLM objective, on ``token_ce``, which
BLIP-2's ``lm_loss`` reads at its gathered positions.

Not ported yet (ROADMAP.md, queue 1 item 6): the KV caches, ``generate``,
``speculative_generate`` and int8 weights.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn

from ...kernels.mha_fused import mha, mha_flash_train
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
    # facebook/opt-2.7b: dropout 0.1, attention_dropout 0.0, applied only
    # with an active HFDropout (--hf_internal_dropout)
    dropout: float = 0.1
    attention_dropout: float = 0.0


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


def _dropped(drop, x, p: float):
    return x if drop is None else drop(x, p)


def _layer(p: OPTLayer, x, mask, cfg: OPTConfig, lora, lora_scale: float,
           train: bool = False, drop=None, lora_p: float = 0.0):
    """One pre-LN decoder layer: eval on K2, train (`train`) on the flash
    pair, with the HF dropout sites of an active `drop`."""
    h = p.ln1(x)
    q, k = p.q(h), p.k(h)
    if lora is not None:
        q = q + lora.q(_dropped(drop, h, lora_p)) * lora_scale
        k = k + lora.k(_dropped(drop, h, lora_p)) * lora_scale
    v = p.v(h)
    if not train:
        att = mha(q, k, v, heads=cfg.heads, mask=mask, causal=True)
    else:
        # the attention-weight site takes no key at opt-2.7b's p = 0.0
        if drop is not None and drop.site_key(
                cfg.attention_dropout) is not None:
            raise NotImplementedError(
                "OPT attention_dropout > 0: no configuration drops OPT's "
                "attention weights, and the flash pair at head dim 80 has "
                "no dropout variant")
        att = mha_flash_train(q, k, v, heads=cfg.heads, mask=mask,
                              causal=True)
    x = x + _dropped(drop, p.out(att), cfg.dropout)
    h = p.fc2(core.relu(p.fc1(p.ln2(x))))
    return x + _dropped(drop, h, cfg.dropout)


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
                  lora: Optional[Lora] = None, lora_scale: float = 1.0,
                  train: bool = False, drop=None,
                  lora_p: float = 0.0) -> torch.Tensor:
    """inputs_embeds [B, L, H] + mask [B, L] -> final hidden [B, L, H]
    (post final_layer_norm; ``lm_head`` projects it). `train`: the flash
    pair's attention, differentiable; `drop` / `lora_p`: the dropout sites
    (no embeddings site: HF's OPTDecoder has none)."""
    h, mask = prompt_prologue(model, inputs_embeds, attention_mask)
    for i, lp in enumerate(model.layers):
        h = _layer(lp, h, mask, model.cfg,
                   None if lora is None else lora[str(i)], lora_scale,
                   train=train, drop=drop, lora_p=lora_p)
    return model.final_ln(h)


def lm_head(model: OPTDecoder, h: torch.Tensor) -> torch.Tensor:
    """Hidden -> vocab logits (tied input embeddings). [B, L, H] or
    gathered [B, H]."""
    return h @ model.embed_tokens.w.to(h.dtype).t()


def token_ce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean CE of logits [M, V] at targets [M] (fp32 log-softmax; 0 when
    M = 0)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    picked = logp.gather(-1, targets.long()[:, None])
    return -picked.sum() / max(targets.shape[0], 1)


def shifted_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Shifted next-token CE, HF CausalLM semantics: logits [B, L, V]
    predict labels[:, 1:]; label -100 is ignored; the mean over the rest
    (``token_ce``; 0 when nothing counts)."""
    target = labels[:, 1:]
    keep = target != -100
    return token_ce(logits[:, :-1][keep], target[keep])


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
