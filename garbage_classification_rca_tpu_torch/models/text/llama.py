"""Llama causal LM (the paraphraser behind ``GC_RCA_LLM_PATH``).

The JAX package paraphrases through transformers' ``LlamaForCausalLM``
(``data/synonymize.make_hf_llm_fn``); the card's machine has no
transformers, so the port has its own, computed as transformers computes
it in fp32:

* RMSNorm: ``w * (x * rsqrt(mean(x^2) + eps))`` over fp32 values;
* RoPE with ``rope_theta`` and, with ``rope_scaling`` of type ``llama3``,
  the frequencies scaled by ``factor`` past ``original_max_position_
  embeddings / low_freq_factor`` wavelengths and blended between the two
  bounds; the angles ``position * inv_freq`` in fp32, ``rotate_half``;
* grouped-query attention (``kv_heads`` <= ``heads``, K / V repeated),
  ``scaled_dot_product_attention`` at ``head_dim ** -0.5`` with the
  additive bias ``finfo.min`` on masked keys (causal, the left padding),
  so that a row of pads only spreads its weights, with no NaN;
* a SwiGLU MLP ``down(silu(gate(x)) * up(x))``, no biases;
* ``tie_word_embeddings``: the head reads the embedding table;
* a KV cache of ``prompt + max_new`` positions, written in place;
* position ids from the left-padded mask, as transformers'
  ``prepare_inputs_for_generation`` makes them: ``cumsum(mask) - 1``,
  1 on pads, and the count of real tokens so far while decoding;
* the head on the last position only while generating.

No kernel of ``kernels/`` runs here: the products are library GEMMs and
the attention is PyTorch's SDPA, as transformers runs them. The module
tree mirrors transformers' (``model.layers.N.self_attn.q_proj``, ...), so
``from_hf_state_dict`` maps a ``model.safetensors`` state dict by
renaming ``weight`` to the port's ``w``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...nn import core

NEG = float(np.finfo(np.float32).min)
INIT_STD = 0.02             # transformers' initializer_range


@dataclass(frozen=True)
class LlamaConfig:
    """The widths of ``meta-llama/Llama-3.1-8B-Instruct``'s ``config.json``
    by default (8.03 B parameters)."""

    vocab: int = 128256
    hidden: int = 4096
    layers: int = 32
    heads: int = 32
    kv_heads: int = 8
    ffn: int = 14336
    head_dim: Optional[int] = None
    rms_eps: float = 1e-5
    rope_theta: float = 500000.0
    rope_scaling: Optional[Dict] = field(default_factory=lambda: {
        "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
        "high_freq_factor": 4.0, "original_max_position_embeddings": 8192})
    tie_word_embeddings: bool = False
    max_positions: int = 131072

    @property
    def dim(self) -> int:
        return self.head_dim or self.hidden // self.heads

    @classmethod
    def from_hf(cls, config: Dict) -> "LlamaConfig":
        """From a transformers ``config.json`` of a ``llama`` model."""
        if config.get("model_type", "llama") != "llama":
            raise ValueError(f"not a Llama config: {config['model_type']}")
        if config.get("hidden_act", "silu") != "silu" or \
                config.get("attention_bias") or config.get("mlp_bias"):
            raise ValueError("the port's Llama has a SiLU MLP and no biases")
        scaling = config.get("rope_scaling")
        if scaling is not None:
            kind = scaling.get("rope_type", scaling.get("type"))
            if kind not in ("llama3", "default"):
                raise ValueError(f"rope_scaling {kind} is not read")
            if kind == "default":
                scaling = None
        return cls(vocab=config["vocab_size"], hidden=config["hidden_size"],
                   layers=config["num_hidden_layers"],
                   heads=config["num_attention_heads"],
                   kv_heads=config.get("num_key_value_heads",
                                       config["num_attention_heads"]),
                   ffn=config["intermediate_size"],
                   head_dim=config.get("head_dim"),
                   rms_eps=config.get("rms_norm_eps", 1e-6),
                   rope_theta=config.get("rope_theta", 10000.0),
                   rope_scaling=scaling,
                   tie_word_embeddings=config.get("tie_word_embeddings",
                                                  False),
                   max_positions=config.get("max_position_embeddings",
                                            2048))

    def params(self) -> int:
        d, kv = self.dim, self.kv_heads * self.dim
        layer = (self.hidden * (self.heads * d) * 2 + self.hidden * kv * 2
                 + 3 * self.hidden * self.ffn + 2 * self.hidden)
        head = 0 if self.tie_word_embeddings else self.vocab * self.hidden
        return self.vocab * self.hidden + self.layers * layer + \
            self.hidden + head


def rope_inv_freq(cfg: LlamaConfig) -> torch.Tensor:
    """fp32 [dim / 2]: transformers' default and ``llama3`` frequencies."""
    d = cfg.dim
    inv = 1.0 / (cfg.rope_theta ** (
        torch.arange(0, d, 2, dtype=torch.int64).float() / d))
    s = cfg.rope_scaling
    if s is None:
        return inv
    factor, lo, hi = s["factor"], s["low_freq_factor"], s["high_freq_factor"]
    old = s["original_max_position_embeddings"]
    lo_wave, hi_wave = old / lo, old / hi
    wave = 2 * math.pi / inv
    scaled = torch.where(wave > lo_wave, inv / factor, inv)
    smooth = (old / wave - lo) / (hi - lo)
    smoothed = (1 - smooth) * scaled / factor + smooth * scaled
    medium = ~(wave < hi_wave) * ~(wave > lo_wave)
    return torch.where(medium, smoothed, scaled)


def _rotate_half(x):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat((-x2, x1), dim=-1)


class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float):
        super().__init__()
        self.eps = eps
        self.w = nn.Parameter(torch.ones(d))

    def forward(self, x):
        h = x.float()
        h = h * torch.rsqrt(h.pow(2).mean(-1, keepdim=True) + self.eps)
        return self.w * h.to(x.dtype)


class Attention(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        d, h = cfg.hidden, cfg.dim
        self.cfg = cfg
        self.q_proj = core.Linear(d, cfg.heads * h, bias=False)
        self.k_proj = core.Linear(d, cfg.kv_heads * h, bias=False)
        self.v_proj = core.Linear(d, cfg.kv_heads * h, bias=False)
        self.o_proj = core.Linear(cfg.heads * h, d, bias=False)

    def forward(self, x, cos, sin, bias, cache=None, layer=0, at=0):
        b, n, _ = x.shape
        c = self.cfg
        q = self.q_proj(x).view(b, n, c.heads, c.dim).transpose(1, 2)
        k = self.k_proj(x).view(b, n, c.kv_heads, c.dim).transpose(1, 2)
        v = self.v_proj(x).view(b, n, c.kv_heads, c.dim).transpose(1, 2)
        cos, sin = cos[:, None], sin[:, None]
        q = q * cos + _rotate_half(q) * sin
        k = k * cos + _rotate_half(k) * sin
        if cache is not None:
            cache.k[layer][:, :, at:at + n] = k
            cache.v[layer][:, :, at:at + n] = v
            k = cache.k[layer][:, :, :at + n]
            v = cache.v[layer][:, :, :at + n]
        rep = c.heads // c.kv_heads
        if rep > 1:
            k = k.repeat_interleave(rep, dim=1)
            v = v.repeat_interleave(rep, dim=1)
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=bias,
                                           scale=c.dim ** -0.5)
        return self.o_proj(o.transpose(1, 2).reshape(b, n, c.heads * c.dim))


class MLP(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.gate_proj = core.Linear(cfg.hidden, cfg.ffn, bias=False)
        self.up_proj = core.Linear(cfg.hidden, cfg.ffn, bias=False)
        self.down_proj = core.Linear(cfg.ffn, cfg.hidden, bias=False)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.self_attn = Attention(cfg)
        self.mlp = MLP(cfg)
        self.input_layernorm = RMSNorm(cfg.hidden, cfg.rms_eps)
        self.post_attention_layernorm = RMSNorm(cfg.hidden, cfg.rms_eps)


class LlamaModel(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.embed_tokens = core.Embedding(cfg.vocab, cfg.hidden)
        self.layers = nn.ModuleList(DecoderLayer(cfg)
                                    for _ in range(cfg.layers))
        self.norm = RMSNorm(cfg.hidden, cfg.rms_eps)


@dataclass
class KVCache:
    """Per layer K / V [B, kv_heads, T, dim], written in place; `mask`
    [B, T] the keys' attention mask (left pads 0), `length` the positions
    filled, `last_pos` [B] each row's last position id."""

    k: List[torch.Tensor]
    v: List[torch.Tensor]
    mask: torch.Tensor
    length: int
    last_pos: torch.Tensor


class LlamaForCausalLM(nn.Module):
    """transformers' ``LlamaForCausalLM``: ``model`` (embeddings, layers,
    final norm) and ``lm_head`` (absent when the embeddings are tied)."""

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        self.model = LlamaModel(cfg)
        self.lm_head = (None if cfg.tie_word_embeddings
                        else core.Linear(cfg.hidden, cfg.vocab, bias=False))
        self.register_buffer("inv_freq", rope_inv_freq(cfg),
                             persistent=False)

    # -- building ----------------------------------------------------------

    @classmethod
    def empty(cls, cfg: LlamaConfig, device) -> "LlamaForCausalLM":
        """The model on `device`, its tensors allocated there and not
        filled (built on the meta device: nothing is drawn on the host)."""
        with torch.device("meta"):
            model = cls(cfg)
        model = model.to_empty(device=device)
        model.inv_freq = rope_inv_freq(cfg).to(device)
        return model.requires_grad_(False).eval()

    def init_(self, seed: int) -> "LlamaForCausalLM":
        """transformers' initialisation, drawn on the model's device from
        `seed`: every product and embedding weight N(0, INIT_STD), norms
        1."""
        g = torch.Generator(device=self.inv_freq.device)
        g.manual_seed(seed)
        with torch.no_grad():
            for name, p in self.named_parameters():
                if isinstance(self.get_submodule(name.rsplit(".", 1)[0]),
                              RMSNorm):
                    p.fill_(1.0)
                else:
                    p.normal_(0.0, INIT_STD, generator=g)
        return self

    def hf_state_dict(self) -> Dict[str, torch.Tensor]:
        """The state dict under transformers' names."""
        return {k[:-1] + "weight" if k.endswith(".w") else k: v
                for k, v in self.state_dict().items()}

    def load_hf_state_dict(self, sd: Dict[str, torch.Tensor]) -> None:
        """Load transformers' names (``model.layers.N.self_attn.q_proj.
        weight``, ...) into the model, each tensor copied straight into
        its parameter (cast to its dtype and device, so that nothing else
        of its size is held); a tied checkpoint may omit
        ``lm_head.weight``. Every tensor must fit."""
        own = self.state_dict()
        mapped = {}
        for k, v in sd.items():
            name = k[:-len("weight")] + "w" if k.endswith(".weight") else k
            if name == "lm_head.w" and self.lm_head is None:
                continue
            if name not in own or own[name].shape != v.shape:
                raise ValueError(f"{k} {tuple(v.shape)} does not fit the "
                                 "model")
            mapped[name] = v
        missing = set(own) - set(mapped)
        if missing:
            raise ValueError(f"the checkpoint lacks {sorted(missing)[:5]}")
        with torch.no_grad():
            for name, v in mapped.items():
                own[name].copy_(v)

    @classmethod
    def from_hf_state_dict(cls, cfg: LlamaConfig, sd,
                           device) -> "LlamaForCausalLM":
        """The model in fp32 on `device`, as ``from_pretrained`` builds
        it, filled from the state dict `sd` of transformers' names."""
        model = cls.empty(cfg, device)
        model.load_hf_state_dict(sd)
        return model

    # -- running -----------------------------------------------------------

    def _rope(self, pos):
        freqs = pos[..., None].float() * self.inv_freq[None, None, :]
        emb = torch.cat((freqs, freqs), dim=-1)
        return emb.cos(), emb.sin()

    def _bias(self, mask_keys, n, at):
        """[B, 1, n, T] additive bias: key j is seen by query i (at
        position ``at + i`` of the cache) when j <= at + i and its mask is
        1."""
        t = mask_keys.shape[1]
        dev = mask_keys.device
        causal = (torch.arange(t, device=dev)[None, :]
                  <= (at + torch.arange(n, device=dev))[:, None])
        seen = causal[None] & (mask_keys[:, None, :] != 0)
        return torch.where(seen, 0.0, NEG)[:, None]

    def _run(self, ids, pos, bias, cache=None, at=0, keep=None):
        x = self.model.embed_tokens(ids)
        cos, sin = self._rope(pos)
        for i, layer in enumerate(self.model.layers):
            x = x + layer.self_attn(layer.input_layernorm(x), cos, sin,
                                    bias, cache, i, at)
            x = x + layer.mlp(layer.post_attention_layernorm(x))
        if keep is not None:
            x = x[:, keep]
        x = self.model.norm(x)
        head = (self.model.embed_tokens.w if self.lm_head is None
                else self.lm_head.w)
        return F.linear(x, head)

    @staticmethod
    def positions(mask: torch.Tensor) -> torch.Tensor:
        """transformers' position ids of a left-padded mask."""
        pos = mask.long().cumsum(-1) - 1
        return pos.masked_fill(mask == 0, 1)

    def forward(self, ids, mask, keep: Optional[slice] = None):
        """Logits [B, N, V] of every position, or of the positions `keep`
        slices (no cache)."""
        bias = self._bias(mask, ids.shape[1], 0)
        return self._run(ids, self.positions(mask), bias, keep=keep)

    def prefill(self, ids, mask, max_new: int):
        """The prompt through every layer into a new cache of
        ``N + max_new`` positions -> (fp32 logits [B, V] of its last
        position, cache)."""
        b, n = ids.shape
        c = self.cfg
        dtype = self.model.embed_tokens.w.dtype
        shape = (b, c.kv_heads, n + max_new, c.dim)
        cache = KVCache(
            k=[torch.empty(shape, dtype=dtype, device=ids.device)
               for _ in range(c.layers)],
            v=[torch.empty(shape, dtype=dtype, device=ids.device)
               for _ in range(c.layers)],
            mask=torch.zeros(b, n + max_new, dtype=torch.long,
                             device=ids.device),
            length=n, last_pos=None)
        cache.mask[:, :n] = mask
        pos = self.positions(mask)
        cache.last_pos = pos[:, -1]
        logits = self._run(ids, pos, self._bias(mask, n, 0), cache, 0,
                           keep=slice(-1, None))
        return logits[:, 0].float(), cache

    def decode_step(self, tokens, cache: KVCache):
        """One new token a row [B] at position ``cache.length`` ->
        fp32 logits [B, V]; the cache grows by one."""
        at = cache.length
        cache.mask[:, at] = 1
        cache.last_pos = cache.last_pos + 1
        bias = self._bias(cache.mask[:, :at + 1], 1, at)
        logits = self._run(tokens[:, None], cache.last_pos[:, None], bias,
                           cache, at)
        cache.length = at + 1
        return logits[:, 0].float()


def generate(model: LlamaForCausalLM, ids, mask, *, max_new_tokens: int,
             warp, eos_id: int, pad_id: int,
             generator: torch.Generator) -> torch.Tensor:
    """transformers' sampling loop (``generate(do_sample=True)``): the
    prompt [B, N] and its mask, then up to `max_new_tokens` draws, each
    ``multinomial(softmax(warp(logits)), 1, generator)``; a row that has
    drawn `eos_id` gets `pad_id` from then on, and the loop stops when
    every row has. -> ids [B, N + steps]."""
    logits, cache = model.prefill(ids, mask, max_new_tokens)
    out = [ids]
    unfinished = torch.ones(ids.shape[0], dtype=torch.long,
                            device=ids.device)
    for step in range(max_new_tokens):
        probs = F.softmax(warp(logits), dim=-1)
        nxt = torch.multinomial(probs, 1, generator=generator).squeeze(1)
        nxt = nxt * unfinished + pad_id * (1 - unfinished)
        out.append(nxt[:, None])
        unfinished = unfinished & (nxt != eos_id).long()
        if step + 1 == max_new_tokens or not bool(unfinished.any()):
            break
        logits = model.decode_step(nxt, cache)
    return torch.cat(out, 1)
