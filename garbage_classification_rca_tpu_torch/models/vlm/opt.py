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

Generation (the JAX package's KV-cache half): ``prefill`` runs the prompt
through ``_layer``'s eval body (K2 on the card, causal with the key mask)
and fills per-layer K / V caches [layers, B, L + new, H], in the
activation dtype or int8 with per-slot scales (``ops/quant.py``);
``decode_step`` appends one token per row at its own write slot and
learned position, ``decode_chunk`` C tokens per row (the speculative
verifier); ``generate`` is the greedy or sampled token loop, and
``speculative_generate`` the greedy draft-and-verify loop whose output
equals ``generate``'s. The decode steps attend one query (or a chunk)
over the cache with einsums, fp32 scores and the ``finfo(float32).min``
bias, as the JAX package's decode does outside any Pallas kernel; they
update the caches in place. The token loops are Python loops of device
work: ``generate`` reads nothing back per step, ``speculative_generate``
one flag per round.

Tensor parallelism (``parallel/tp.py``): on a decoder that ``shard_opt_``
sliced over the mesh's model axis, each layer (``OPTLayer.tp``) runs its
``heads / M`` local heads (K2 and the flash pair at ``D = hidden / M``),
its FFN block, the all-reduce after the row-parallel out and fc2 products
(bias and int8 scale once, after it), the adapters' columns of its heads,
and, under autograd, Megatron's *f* on the inputs of q / k / v and fc1.
The KV caches hold the local heads: [layers, B, T, hidden / M]
(``kv_width``). The hidden state between the layers is whole on every
rank.

Pipeline parallelism (``parallel/pp.py``): a stage's decoder holds its
contiguous run of layers in a ``StageLayers``, keyed by their global
index; the stage runs them through ``_layer``, ``layer_prefill`` and
``cache_layer``, the bodies the whole decoder runs.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...kernels.mha_fused import mha, mha_flash_train
from ...nn import core
from ...ops import quant
from ...ops import sampling as smp
from ...parallel.tp import copy_to_model, row_linear
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
    # the layer's ``parallel.tp.ModelShard`` once ``shard_opt_`` sliced it
    tp = None

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


class StageLayers(nn.ModuleDict):
    """A pipeline stage's decoder layers (``parallel/pp.py``): a contiguous
    run of the whole decoder's, keyed by their global index, so that the
    state dict names them as the whole decoder's does. The whole-decoder
    functions walk ``enumerate(model.layers)``; a stage refuses the walk."""

    def __iter__(self):
        raise TypeError("a pipeline stage holds its own layers only: run it "
                        "through parallel/pp.py")


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


def _layer_lora(lora: Optional[Lora], i: int):
    return None if lora is None else lora[str(i)]


def _heads(p: OPTLayer, cfg: OPTConfig) -> int:
    """The heads layer `p` runs: all, or its share of the model axis."""
    return cfg.heads if p.tp is None else cfg.heads // p.tp.size


def kv_width(model: OPTDecoder) -> int:
    """The K / V width a cache holds: hidden, or hidden / M under
    tensor parallelism."""
    return model.layers[0].k.w.shape[0]


def _col_input(p: OPTLayer, h):
    return h if p.tp is None else copy_to_model(h, p.tp)


def _row(p: OPTLayer, lin, x):
    return lin(x) if p.tp is None else row_linear(lin, x, p.tp)


def _adapter(p: OPTLayer, pair: LoraPair, x):
    """`pair`'s update of x: its whole ``b``, or the columns of this
    rank's heads."""
    if p.tp is None:
        return pair(x)
    b = pair.b[:, p.tp.cols(pair.b.shape[1])]
    return (x @ pair.a.to(x.dtype)) @ b.to(x.dtype)


def _qkv(p: OPTLayer, h, lora, lora_scale: float, drop=None,
         lora_p: float = 0.0):
    """q, k (with the adapters: peft's lora_dropout on each input in turn)
    and v of the normed hidden `h`."""
    h = _col_input(p, h)
    q, k = p.q(h), p.k(h)
    if lora is not None:
        q = q + _adapter(p, lora.q, _dropped(drop, h, lora_p)) * lora_scale
        k = k + _adapter(p, lora.k, _dropped(drop, h, lora_p)) * lora_scale
    return q, k, p.v(h)


def _mlp(p: OPTLayer, x):
    """The residual MLP's update of x."""
    return _row(p, p.fc2, core.relu(p.fc1(_col_input(p, p.ln2(x)))))


def _layer(p: OPTLayer, x, mask, cfg: OPTConfig, lora, lora_scale: float,
           train: bool = False, drop=None, lora_p: float = 0.0,
           return_kv: bool = False):
    """One pre-LN decoder layer: eval on K2, train (`train`) on the flash
    pair, with the HF dropout sites of an active `drop`. `return_kv`: also
    the layer's K / V projections [B, N, H] (``layer_prefill``: the
    serving prefill runs this same body)."""
    q, k, v = _qkv(p, p.ln1(x), lora, lora_scale, drop, lora_p)
    heads = _heads(p, cfg)
    if not train:
        att = mha(q, k, v, heads=heads, mask=mask, causal=True)
    else:
        # the attention-weight site takes no key at opt-2.7b's p = 0.0
        if drop is not None and drop.site_key(
                cfg.attention_dropout) is not None:
            raise NotImplementedError(
                "OPT attention_dropout > 0: no configuration drops OPT's "
                "attention weights, and the flash pair at head dim 80 has "
                "no dropout variant")
        att = mha_flash_train(q, k, v, heads=heads, mask=mask, causal=True)
    x = x + _dropped(drop, _row(p, p.out, att), cfg.dropout)
    x = x + _dropped(drop, _mlp(p, x), cfg.dropout)
    return (x, k, v) if return_kv else x


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
        h = _layer(lp, h, mask, model.cfg, _layer_lora(lora, i), lora_scale,
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


# ---------------------------------------------------------------------------
# KV-cached generation
# ---------------------------------------------------------------------------


def _bias(attn_mask: torch.Tensor) -> torch.Tensor:
    """int [..., T] slot mask -> the fp32 additive bias (finfo.min where
    masked), as the JAX decode writes it."""
    return (1.0 - attn_mask.float()) * torch.finfo(torch.float32).min


def layer_prefill(p: OPTLayer, h, mask, cfg: OPTConfig, lora=None,
                  lora_scale: float = 1.0):
    """One decoder layer over the whole prompt -> (h, k, v): ``_layer``'s
    eval body (K2 on the card), its K / V projections for the cache."""
    return _layer(p, h, mask, cfg, lora, lora_scale, return_kv=True)


def prefill(model: OPTDecoder, inputs_embeds, attention_mask,
            max_new_tokens: int, lora: Optional[Lora] = None,
            lora_scale: float = 1.0, cache_dtype: Optional[str] = None):
    """The prompt forward that fills the caches. Returns (hidden [B, L, H]
    post final-LN, caches): {"k", "v": [layers, B, L + max_new_tokens,
    H]}, the prompt's K / V at [0, L) (pad rows too: decode masks them),
    zeros after; with ``cache_dtype="int8"`` int8 values and fp32
    "k_scale" / "v_scale" [layers, B, T, 1] (scale 1 on the zero slots)."""
    if cache_dtype not in (None, "int8"):
        raise ValueError(f"unknown cache_dtype {cache_dtype!r} "
                         "(None or 'int8')")
    cfg = model.cfg
    h, mask = prompt_prologue(model, inputs_embeds, attention_mask)
    b, l, _ = h.shape
    caches = new_caches((len(model.layers), b, l + max_new_tokens,
                         kv_width(model)), h.dtype, h.device, cache_dtype)
    for i, lp in enumerate(model.layers):
        h, k, v = layer_prefill(lp, h, mask, cfg, _layer_lora(lora, i),
                                lora_scale)
        fill_prompt(caches, i, k, v)
    return model.final_ln(h), caches


def new_caches(shape, dtype, device, cache_dtype: Optional[str] = None):
    """Zero K / V caches of `shape` (layers first, the width last) in
    `dtype`, or int8 with fp32 "k_scale" / "v_scale" (scale 1)."""
    q8 = cache_dtype == "int8"
    caches = {n: torch.zeros(shape, dtype=torch.int8 if q8 else dtype,
                             device=device) for n in ("k", "v")}
    if q8:
        for n in ("k_scale", "v_scale"):
            caches[n] = torch.ones(tuple(shape[:-1]) + (1,),
                                   dtype=torch.float32, device=device)
    return caches


def fill_prompt(caches, i: int, k, v) -> None:
    """Layer i's prompt K / V [B, L, H] into the cache slots [0, L)."""
    l = k.shape[1]
    for n, x in (("k", k), ("v", v)):
        if n + "_scale" in caches:
            caches[n][i, :, :l], caches[n + "_scale"][i, :, :l] = \
                quant.quantize_rows(x)
        else:
            caches[n][i, :, :l] = x


def _write(caches, i: int, name: str, rows, slots, x):
    """Scatter K or V rows `x` of layer i into the cache at (rows, slots):
    int8 values + scales for a quantized cache. Returns the layer's cache
    in x's dtype (dequantized on read for int8)."""
    if name + "_scale" in caches:
        xq, xs = quant.quantize_rows(x)
        caches[name][i, rows, slots] = xq
        caches[name + "_scale"][i, rows, slots] = xs
        return quant.dequantize(caches[name][i], caches[name + "_scale"][i],
                                x.dtype)
    caches[name][i, rows, slots] = x.to(caches[name].dtype)
    return caches[name][i]


def _attend(q, kd, vd, bias, heads: int):
    """q [B, C, D] over the cache kd / vd [B, T, D] with the additive
    bias [B, C, T]: fp32 scores, softmax, weights in v's dtype."""
    b, c, d = q.shape
    hd = d // heads
    qh = q.reshape(b, c, heads, hd).float()
    kh = kd.reshape(b, -1, heads, hd)
    vh = vd.reshape(b, -1, heads, hd)
    scores = torch.einsum("bnhd,bmhd->bhnm", qh, kh.float()) / math.sqrt(hd)
    w = torch.softmax(scores + bias[:, None], dim=-1).to(vh.dtype)
    return torch.einsum("bhnm,bmhd->bnhd", w, vh).reshape(b, c, d)


def _chunk_layers(model: OPTDecoder, caches, h, rows, slots, bias, lora,
                  lora_scale: float):
    """The decoder over h [B, C, H] whose K / V land at (rows, slots)
    [B, C]; the residual MLP after each layer's cache attention."""
    for i, lp in enumerate(model.layers):
        h = cache_layer(lp, model.cfg, caches, i, h, rows, slots, bias,
                        _layer_lora(lora, i), lora_scale)
    return model.final_ln(h), caches


def cache_layer(p: OPTLayer, cfg: OPTConfig, caches, i: int, h, rows, slots,
                bias, lora, lora_scale: float):
    """One decoder layer over h [B, C, H] at the cache's layer i: its K / V
    written at (rows, slots), the attention over the cache, the residual
    MLP."""
    q, k, v = _qkv(p, p.ln1(h), lora, lora_scale)
    kd = _write(caches, i, "k", rows, slots, k)
    vd = _write(caches, i, "v", rows, slots, v)
    h = h + _row(p, p.out, _attend(q, kd, vd, bias, _heads(p, cfg)))
    return h + _mlp(p, h)


def _positions(model: OPTDecoder, positions: torch.Tensor) -> torch.Tensor:
    """The learned-position rows; an id past the table is clamped, as the
    JAX gather clamps it (a server lane left idle keeps counting)."""
    cfg = model.cfg
    return model.embed_positions(
        positions.long().clamp(0, cfg.max_pos + cfg.pos_offset - 1))


def decode_step(model: OPTDecoder, caches, tok_emb, write_index, positions,
                attn_mask, lora: Optional[Lora] = None,
                lora_scale: float = 1.0):
    """One token per row: tok_emb [B, H], write_index [B] (the row's slot
    for this token's K / V), positions [B] (learned-position ids), attn_mask
    [B, T] (every slot the token may attend to: the valid prompt, the
    tokens so far and itself). Updates `caches` in place; returns (hidden
    [B, H] post final-LN, caches)."""
    t = caches["k"].shape[2]
    rows = torch.arange(tok_emb.shape[0], device=tok_emb.device)
    slots = write_index.long().clamp(0, t - 1)
    h = tok_emb + _positions(model, positions).to(tok_emb.dtype)
    h, caches = _chunk_layers(model, caches, h[:, None], rows[:, None],
                              slots[:, None], _bias(attn_mask)[:, None],
                              lora, lora_scale)
    return h[:, 0], caches


def decode_chunk(model: OPTDecoder, caches, tok_embs, write_base, positions,
                 attn_mask, lora: Optional[Lora] = None,
                 lora_scale: float = 1.0):
    """C tokens a row at ragged offsets: tok_embs [B, C, H], whose K / V land
    at slots write_base .. write_base + C - 1 [B]; positions [B, C];
    attn_mask [B, C, T] (the chunk's own causality included). Updates
    `caches` in place; returns (hidden [B, C, H] post final-LN, caches).
    Feeding the same tokens one by one through ``decode_step`` gives the
    same hidden states and cache rows."""
    b, c, _ = tok_embs.shape
    t = caches["k"].shape[2]
    rows = torch.arange(b, device=tok_embs.device)[:, None].expand(b, c)
    # a block that would run past the cache starts earlier, as JAX's
    # dynamic_update_slice clamps it
    base = write_base.long().clamp(0, t - c)
    slots = base[:, None] + torch.arange(c, device=tok_embs.device)[None]
    h = tok_embs + _positions(model, positions).to(tok_embs.dtype)
    return _chunk_layers(model, caches, h, rows, slots, _bias(attn_mask),
                         lora, lora_scale)


def last_hidden(h: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """h [B, L, H] at each row's last valid position (either pad side)."""
    pos = torch.arange(1, mask.shape[1] + 1, device=mask.device,
                       dtype=torch.int32)
    last = torch.argmax(mask * pos[None, :], dim=1)
    return h[torch.arange(h.shape[0], device=h.device), last]


def _argmax(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits.float(), dim=-1).to(torch.int32)


@torch.no_grad()
def generate(model: OPTDecoder, inputs_embeds, attention_mask,
             max_new_tokens: int, eos_id: int = 2,
             lora: Optional[Lora] = None, lora_scale: float = 1.0,
             sampler: Optional[smp.SamplerConfig] = None, rng=None,
             cache_dtype: Optional[str] = None):
    """KV-cache generation over built input embeddings [B, L, H] and their
    mask [B, L] (left- or right-padded). Greedy by default; a `sampler`
    with a temperature draws from `rng` (an ``nn.core.Key``):
    ``rng.fold_in(0)`` for the first token, ``fold_in(t + 1)`` after step t.

    Returns (tokens int32 [B, max_new_tokens], valid bool [B,
    max_new_tokens]): a row's EOS is its last valid entry, ``valid`` is
    False strictly after it (the row keeps decoding)."""
    sampler = smp.GREEDY if sampler is None else sampler
    if sampler.temperature is not None and rng is None:
        raise ValueError("sampling (temperature set) requires rng")
    cfg = model.cfg
    mask = attention_mask.to(torch.int32)
    b, l = mask.shape
    dev = mask.device
    h, caches = prefill(model, inputs_embeds, mask, max_new_tokens,
                        lora=lora, lora_scale=lora_scale,
                        cache_dtype=cache_dtype)
    n_valid = mask.sum(dim=1)

    def draw(step, hh):
        key = None if rng is None else rng.fold_in(step)
        return smp.sample_tokens(key, lm_head(model, hh), sampler)

    tok = draw(0, last_hidden(h, mask))
    base_mask = F.pad(mask, (0, max_new_tokens))
    slot_ids = torch.arange(l + max_new_tokens, device=dev)[None, :]
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    toks, valid = [], []
    for t in range(max_new_tokens):
        toks.append(tok)
        valid.append(~done)
        done = done | (tok == eos_id)
        if t == max_new_tokens - 1:
            break                       # the next token would be unused
        attn = base_mask | ((slot_ids >= l) & (slot_ids <= l + t)).to(
            torch.int32)
        emb = embed_tokens(model, tok).to(inputs_embeds.dtype)
        hh, caches = decode_step(
            model, caches, emb, torch.full((b,), l + t, device=dev),
            n_valid + t + cfg.pos_offset, attn, lora=lora,
            lora_scale=lora_scale)
        tok = draw(t + 1, hh)
    return torch.stack(toks, dim=1), torch.stack(valid, dim=1)


@torch.no_grad()
def speculative_generate(model: OPTDecoder, draft: OPTDecoder,
                         inputs_embeds, draft_embeds, attention_mask,
                         max_new_tokens: int, draft_k: int = 4,
                         eos_id: int = 2, lora: Optional[Lora] = None,
                         lora_scale: float = 1.0):
    """Greedy speculative decoding: the `draft` OPT proposes `draft_k`
    tokens a round, the target checks the block in one ``decode_chunk``,
    and each row accepts the prefix the target agrees with plus the
    target's next token (ragged per row, through per-row cache offsets).
    Every accepted token is the target's argmax after the accepted prefix,
    so (tokens, valid) equal ``generate``'s greedy output, the tails after
    EOS too. `draft_embeds`: the draft's embedding of the same prompt (same
    mask). One host read a round (whether any row still runs)."""
    dcfg = draft.cfg
    mask = attention_mask.to(torch.int32)
    b, l = mask.shape
    n, k = max_new_tokens, draft_k
    dev = mask.device
    rows = torch.arange(b, device=dev)
    # k - 1 slots of headroom: the last round's block may reach l + n + k - 2
    h, tc = prefill(model, inputs_embeds, mask, n + k, lora=lora,
                    lora_scale=lora_scale)
    _, dc = prefill(draft, draft_embeds, mask, n + k)
    n_valid = mask.sum(dim=1)
    tok = _argmax(lm_head(model, last_hidden(h, mask)))
    base_mask = F.pad(mask, (0, n + k))                        # [B, T]
    slots = torch.arange(l + n + k, device=dev)
    out_t = torch.zeros((b, n), dtype=torch.int32, device=dev)
    out_v = torch.zeros((b, n), dtype=torch.bool, device=dev)
    out_t[:, 0] = tok
    out_v[:, 0] = True
    n_gen = torch.ones(b, dtype=torch.long, device=dev)
    done = tok == eos_id
    offs = torch.arange(k, device=dev)
    while bool((n_gen < n).any()):
        # the draft: feed tok, then each of its own proposals
        cur, inputs = tok, []
        for j in range(k):
            base = l + n_gen - 1 + j
            attn = base_mask | ((slots[None] >= l)
                                & (slots[None] <= base[:, None])).to(
                                    torch.int32)
            hh, dc = decode_step(
                draft, dc, embed_tokens(draft, cur).to(draft_embeds.dtype),
                base, n_valid + n_gen - 1 + j + dcfg.pos_offset, attn)
            inputs.append(cur)
            cur = _argmax(lm_head(draft, hh))
        inputs = torch.stack(inputs, dim=1)                    # [B, k]
        # the target checks the whole block in one chunked forward
        write_base = l + n_gen - 1
        pos = (n_valid + n_gen - 1 + model.cfg.pos_offset)[:, None] \
            + offs[None]
        upto = (write_base[:, None] + offs[None])[:, :, None]  # [B, k, 1]
        attn = base_mask[:, None, :] | ((slots[None, None] >= l)
                                        & (slots[None, None] <= upto)).to(
                                            torch.int32)
        hh, tc = decode_chunk(
            model, tc, embed_tokens(model, inputs).to(inputs_embeds.dtype),
            write_base, pos, attn, lora=lora, lora_scale=lora_scale)
        g = _argmax(lm_head(model, hh))                        # G_1 .. G_k
        # accept the matched prefix and the target's next token
        match = (inputs[:, 1:] == g[:, :-1]).to(torch.int32)
        n_acc = 1 + torch.cumprod(match, dim=1).sum(dim=1)
        eff = torch.minimum(n_acc, n - n_gen)      # 0 for finished rows
        for j in range(k):
            accept = j < eff
            posj = (n_gen + j).clamp(0, n - 1)
            out_t[rows, posj] = torch.where(accept, g[:, j],
                                            out_t[rows, posj])
            out_v[rows, posj] = torch.where(accept, ~done,
                                            out_v[rows, posj])
            done = torch.where(accept, done | (g[:, j] == eos_id), done)
        tok = torch.where(eff > 0, g[rows, (eff - 1).clamp(0, k - 1)], tok)
        n_gen = n_gen + eff
    return out_t, out_v


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
