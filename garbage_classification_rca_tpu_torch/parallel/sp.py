"""Sequence parallelism of the DistilBERT encoder over the mesh's ``seq``
axis.

The port of the JAX package's ``parallel/sp.py`` (Megatron-SP, the
all-gather flavour): each rank of a seq group holds ``L / S`` tokens of
its batch rows, and the per-token work (embeddings, LayerNorms, the
projections and the FFN) runs on them alone. Each rank embeds its block
with its positions (``rank * L / S`` onwards), the key mask and, in every
layer, K and V are all-gathered over the seq group, and attention runs
the rank's queries against all the keys with fp32 scores, as the JAX
shard body does (library ops on both sides: no Pallas kernel, no
hand-written one). The batch shards over the data axis as well where the
mesh has one: the caller passes the rank's data rows. Eval only (the
reference freezes its text towers).
"""

from __future__ import annotations

import math

import torch

from ..nn import core
from .mesh import SEQ_AXIS
from .multihost import all_gather_dim, broadcast_


def _mha_local_q_global_kv(q, kg, vg, bias, heads: int):
    """The local query block q [B, Ln, D] against the gathered kg / vg
    [B, L, D] with the additive bias [B, 1, 1, L]: fp32 scores, softmax,
    weights in v's dtype."""
    b, ln, d = q.shape
    hd = d // heads
    qh = q.reshape(b, ln, heads, hd).float()
    kh = kg.reshape(b, -1, heads, hd).float()
    vh = vg.reshape(b, -1, heads, hd)
    scores = torch.einsum("bnhd,bmhd->bhnm", qh, kh) / math.sqrt(hd)
    w = torch.softmax(scores + bias, dim=-1).to(vh.dtype)
    return torch.einsum("bhnm,bmhd->bnhd", w, vh).reshape(b, ln, d)


def _attention_bias(mask: torch.Tensor) -> torch.Tensor:
    """int [B, L] key mask -> the additive [B, 1, 1, L] fp32 bias
    (finfo.min at padding), the JAX ``attention_bias``."""
    return ((1.0 - mask.float())
            * torch.finfo(torch.float32).min)[:, None, None, :]


def postnorm_encode_sp(encoder, input_ids, attention_mask, mesh, *,
                       heads: int, ln_eps: float, act=core.gelu,
                       gather: bool = True) -> torch.Tensor:
    """The sequence-parallel forward of a DistilBERT-layout post-norm
    encoder (``word_emb`` / ``pos_emb`` / ``ln_emb`` / ``layers`` of
    ``PostNormLayer``) on this rank's rows `input_ids` / `attention_mask`
    [B, L]: the rank runs its ``L / S`` tokens of them. Returns the whole
    last hidden state [B, L, H] (all-gathered over the seq group), or
    with ``gather=False`` the rank's token block [B, L / S, H]. L must
    divide over the seq axis (ValueError, the JAX message)."""
    l = input_ids.shape[1]
    n_seq = mesh.size(SEQ_AXIS)
    if l % n_seq != 0:
        raise ValueError(
            f"sequence length {l} does not divide over seq:{n_seq}; pad "
            "to a multiple (tokenizers already pad to max_length)")
    ln_local = l // n_seq
    i = mesh.coord(SEQ_AXIS)
    ids = input_ids[:, i * ln_local:(i + 1) * ln_local]
    mask = attention_mask[:, i * ln_local:(i + 1) * ln_local]
    pos = i * ln_local + torch.arange(ln_local, device=ids.device)
    h = encoder.word_emb(ids) + encoder.pos_emb(pos)[None]
    h = core.layernorm(h, encoder.ln_emb.scale, encoder.ln_emb.bias, ln_eps)
    bias = _attention_bias(all_gather_dim(mask, 1, mesh, SEQ_AXIS))
    for p in encoder.layers:
        kg = all_gather_dim(p.k(h), 1, mesh, SEQ_AXIS)
        vg = all_gather_dim(p.v(h), 1, mesh, SEQ_AXIS)
        att = _mha_local_q_global_kv(p.q(h), kg, vg, bias, heads)
        h = core.layernorm(h + p.out(att), p.ln_att.scale, p.ln_att.bias,
                           ln_eps)
        h = core.layernorm(h + p.fc2(act(p.fc1(h))), p.ln_ffn.scale,
                           p.ln_ffn.bias, ln_eps)
    return all_gather_dim(h, 1, mesh, SEQ_AXIS) if gather else h


def distilbert_encode_sp(encoder, input_ids, attention_mask, mesh,
                         gather: bool = True) -> torch.Tensor:
    """DistilBERT's ``encode`` (``models/text/distilbert.py``) under SP."""
    from ..models.text import distilbert as db

    return postnorm_encode_sp(encoder, input_ids, attention_mask, mesh,
                              heads=db.HEADS, ln_eps=db.LN_EPS,
                              gather=gather)


def distilbert_classify_sp(model, input_ids, attention_mask,
                           mesh) -> torch.Tensor:
    """Eval logits of the DistilBERT classifier (a ``TextClassifier``:
    CLS pool + head) under SP, the twin of ``model(ids, mask)``: the CLS
    row lives on seq rank 0 and is broadcast over the seq group before
    the head, so every rank returns the same logits."""
    h = distilbert_encode_sp(model.encoder, input_ids, attention_mask, mesh,
                             gather=False)
    cls = h[:, 0].contiguous()
    if mesh.size(SEQ_AXIS) > 1:
        broadcast_(cls, mesh.group(SEQ_AXIS), src=mesh.root(SEQ_AXIS))
    return model.head(cls)
