"""BLIP-2 assembly: vision -> Q-Former -> projection -> OPT, with LoRA on
the OPT q / k projections.

The port of the JAX package's ``models/vlm/blip2.py``:
  * ``next_token_logits``: the reference's ``generate(max_new_tokens=1)``
    eval as one forward -> the logits after each row's last valid prompt
    token (left- or right-padded), gathered BEFORE the 50272-wide lm head;
  * ``qformer_cls_feature``: ``last_hidden_state[:, 0, :]`` of the
    Q-Former, the feature of the Linear(768, 4) classifier;
  * ``lm_loss``: the LoRA trainer's loss (reference blip_2_training.py:
    280-293), the shifted next-token CE over the text segment, -100
    labels ignored; with an ``HFDropout`` the Q-Former's and OPT's HF
    train-mode sites and peft's lora_dropout run. EVA, the Q-Former and
    the projection run without autograd (their weights are frozen), so
    the graph starts at OPT, as XLA prunes the JAX package's gradient with
    respect to the adapters; the lm head runs only at the positions whose
    shifted label counts;
  * ``prompt_embeds`` / ``generate``: the serving prompt (the 32
    projected query embeddings, then the text embeddings, with an
    always-valid query mask) and the multi-token KV-cache generation over
    it (``opt.generate``: greedy, sampled, int8 cache);
  * ``convert_torch``: an HF ``Blip2ForConditionalGeneration`` state dict,
    plain or peft-wrapped (``base_model.model.`` prefixes, ``.base_layer``
    names, ``lora_A`` / ``lora_B``), into the JAX package's trees.

``Blip2Model`` holds the four towers, and, where asked, the adapters
(``lora``, B = 0 at init as peft's) and the Q-Former ``classifier``; its
tree is the JAX ``blip2.init`` tree plus those two, so
``checkpoint/from_jax.load_blip2_tree`` fills it from the JAX package's
``(params, lora, trainable)``. ``cast_`` follows the JAX package's dtype
policy: matmul weights, embeddings and adapters are cast to the compute
dtype (the JAX code casts them at each use), LayerNorm parameters and the
classifier stay fp32 (the JAX code reads them in fp32).

On the card the model runs K2 71 times a forward: 39 in the EVA tower
(head dim 88), 32 in the OPT decoder (head dim 80, causal + key mask);
``qformer_cls_feature`` runs the EVA tower's 39. ``lm_loss`` runs K2 39
times (EVA), K4a 32 times and, in its backward, K4b 32 times (OPT, head
dim 80).
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ...checkpoint.torch_convert import subdict
from ...nn import core
from ..text.encoder_common import lin
from . import blip2_vision as vision
from . import opt as opt_mod
from . import qformer as qf


@dataclass(frozen=True)
class Blip2Config:
    vision: vision.VisionConfig = field(default_factory=vision.VisionConfig)
    qformer: qf.QFormerConfig = field(default_factory=qf.QFormerConfig)
    opt: opt_mod.OPTConfig = field(default_factory=opt_mod.OPTConfig)
    lora_r: int = 32
    lora_alpha: int = 8
    lora_dropout: float = 0.05      # train-time only, with an HFDropout

    @property
    def lora_scale(self) -> float:
        return self.lora_alpha / self.lora_r


class Blip2Model(nn.Module):
    """vision / qformer / projection / opt, the adapters when `lora`, the
    Linear(hidden, num_classes) head when `classifier`."""

    def __init__(self, cfg: Blip2Config, *, lora: bool = True,
                 classifier: bool = False, num_classes: int = 4):
        super().__init__()
        self.cfg = cfg
        self.vision = vision.VisionTower(cfg.vision)
        self.qformer = qf.QFormer(cfg.qformer)
        self.projection = core.Linear(cfg.qformer.hidden, cfg.opt.hidden)
        self.opt = opt_mod.OPTDecoder(cfg.opt)
        self.lora = opt_mod.Lora(cfg.opt, cfg.lora_r) if lora else None
        self.classifier = (core.Linear(cfg.qformer.hidden, num_classes)
                           if classifier else None)

    @torch.no_grad()
    def cast_(self, dtype: torch.dtype, keep_fp32=()) -> "Blip2Model":
        """Cast every parameter but the LayerNorms', the classifier's and
        those of the child modules named in `keep_fp32` (the trainer's fp32
        adapters: ``("lora",)``) to `dtype`, in place."""
        keep = {id(t) for m in self.modules()
                if isinstance(m, core.LayerNorm) for t in m.parameters()}
        for name in ("classifier",) + tuple(keep_fp32):
            if getattr(self, name) is not None:
                keep |= {id(t) for t in getattr(self, name).parameters()}
        for t in self.parameters():
            # int8 weights (ops/quant.py) stay int8
            if id(t) not in keep and t.is_floating_point():
                t.data = t.data.to(dtype)
        return self


def build_model(cfg: Blip2Config, device, *, lora: bool = True,
                classifier: bool = False) -> Blip2Model:
    """An fp32 eval model on `device` with uninitialised weights, built on
    the meta device (nothing is drawn on the host). ``init_`` /
    ``init_lora_`` / ``init_classifier_`` or
    ``checkpoint/from_jax.load_blip2_tree`` fill it."""
    with torch.device("meta"):
        model = Blip2Model(cfg, lora=lora, classifier=classifier)
    return model.to_empty(device=device).requires_grad_(False).eval()


def _generator(t: torch.Tensor, seed: int) -> torch.Generator:
    return torch.Generator(device=t.device).manual_seed(int(seed))


@torch.no_grad()
def init_(model: Blip2Model, seed: int) -> Blip2Model:
    """Random towers (vision, qformer, projection, opt) from `seed`, drawn
    on the model's device in parameter order: N(0, 0.02) for every weight,
    bias and embedding, LayerNorms at (1, 0)."""
    towers = (model.vision, model.qformer, model.projection, model.opt)
    g = _generator(model.projection.w, seed)
    for m in towers:
        for sub in m.modules():
            if isinstance(sub, core.LayerNorm):
                sub.scale.fill_(1.0)
                sub.bias.zero_()
            else:
                for t in sub.parameters(recurse=False):
                    t.normal_(0.0, 0.02, generator=g)
    return model


@torch.no_grad()
def init_lora_(lora: opt_mod.Lora, seed: int, *, b_std: float = 0.0):
    """The JAX ``init_lora``'s distributions from `seed`: a N(0, 1 / r),
    b N(0, b_std); b_std 0 gives peft's B = 0, adapters that start as the
    identity."""
    for pair in lora.modules():
        if isinstance(pair, opt_mod.LoraPair):
            g = _generator(pair.a, seed)
            pair.a.normal_(0.0, 1.0 / math.sqrt(pair.a.shape[1]),
                           generator=g)
            if b_std:
                pair.b.normal_(0.0, b_std, generator=g)
            else:
                pair.b.zero_()
            seed += 1
    return lora


@torch.no_grad()
def init_classifier_(clf: core.Linear, seed: int):
    """torch.nn.Linear's init U(+-1/sqrt(fan_in)) from `seed`."""
    g = _generator(clf.w, seed)
    bound = 1.0 / math.sqrt(clf.w.shape[1])
    for t in (clf.w, clf.b):
        t.uniform_(-bound, bound, generator=g)
    return clf


def query_features(model: Blip2Model, pixel_values, drop=None
                   ) -> torch.Tensor:
    """NHWC CLIP-normalized images -> Q-Former outputs [B, 32, 768].
    `drop`: an optional ``HFDropout`` for the Q-Former's train-mode sites
    (the EVA tower has none: its attention_dropout is 0.0)."""
    return model.qformer(model.vision(pixel_values), drop)


def qformer_cls_feature(model: Blip2Model, pixel_values, drop=None
                        ) -> torch.Tensor:
    return query_features(model, pixel_values, drop)[:, 0]


def prompt_embeds(model: Blip2Model, pixel_values, input_ids,
                  attention_mask, drop=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The OPT prompt: 32 projected query embeddings before the text
    embeddings, and the mask with the queries always valid. Returns
    (embeds [B, 32 + L, H], mask [B, 32 + L]) for ``opt.generate`` or the
    ``serving.engine.GenerationServer``. `drop`: the Q-Former's sites."""
    q_emb = model.projection(query_features(model, pixel_values, drop))
    t_emb = opt_mod.embed_tokens(model.opt, input_ids).to(q_emb.dtype)
    q_mask = torch.ones(q_emb.shape[:2], dtype=attention_mask.dtype,
                        device=attention_mask.device)
    return (torch.cat([q_emb, t_emb], dim=1),
            torch.cat([q_mask, attention_mask], dim=1))


def _lm_hidden(model: Blip2Model, pixel_values, input_ids, attention_mask,
               train: bool = False, drop=None) -> torch.Tensor:
    """-> OPT final hidden [B, 32 + L, H] over the combined sequence.
    `train`: the frozen towers before OPT run without autograd and OPT's
    attention is the differentiable flash pair."""
    with torch.no_grad() if train else contextlib.nullcontext():
        embeds, mask = prompt_embeds(model, pixel_values, input_ids,
                                     attention_mask, drop)
    return opt_mod.decode_hidden(model.opt, embeds, mask, lora=model.lora,
                                 lora_scale=model.cfg.lora_scale,
                                 train=train, drop=drop,
                                 lora_p=model.cfg.lora_dropout)


def lm_loss(model: Blip2Model, pixel_values, input_ids, attention_mask,
            labels, drop=None) -> torch.Tensor:
    """HF ``Blip2ForConditionalGeneration``'s loss: the next-token CE over
    the text segment of [32 query tokens, input_ids], labels [B, L] with
    -100 where nothing counts (``opt.shifted_ce``'s value, through its
    ``token_ce``). `drop`: an optional ``HFDropout``
    (``--hf_internal_dropout``). The lm head runs on the counted positions
    alone; the mean divides by their number (at least 1)."""
    h = _lm_hidden(model, pixel_values, input_ids, attention_mask,
                   train=True, drop=drop)
    target = labels[:, 1:]
    keep = target != -100
    h = h[:, model.cfg.qformer.n_query:-1][keep]          # [M, H]
    return opt_mod.token_ce(opt_mod.lm_head(model.opt, h), target[keep])


def _last_valid_index(mask: torch.Tensor) -> torch.Tensor:
    """Index of each row's LAST mask == 1 position, for left- or
    right-padded rows (0 for a row without one)."""
    m = mask.to(torch.int32)
    pos = torch.arange(1, m.shape[1] + 1, device=m.device, dtype=torch.int32)
    return torch.argmax(m * pos[None, :], dim=1)


def next_token_logits(model: Blip2Model, pixel_values, input_ids,
                      attention_mask) -> torch.Tensor:
    """Logits [B, vocab] of the token after each row's last valid prompt
    token (1-token greedy decode)."""
    h = _lm_hidden(model, pixel_values, input_ids, attention_mask)
    last = model.cfg.qformer.n_query + _last_valid_index(attention_mask)
    h_last = h[torch.arange(h.shape[0], device=h.device), last]
    return opt_mod.lm_head(model.opt, h_last)


@torch.no_grad()
def generate(model: Blip2Model, pixel_values, input_ids, attention_mask,
             max_new_tokens: int = 8, eos_id: int = 2, sampler=None,
             rng=None, cache_dtype=None):
    """Multi-token generation with the model's adapters: ``prompt_embeds``,
    then ``opt.generate`` (greedy by default; `sampler` + `rng` sample;
    ``cache_dtype="int8"`` quantizes the cache). Returns (tokens int32
    [B, max_new_tokens], valid bool), ``valid`` False strictly after each
    row's EOS."""
    embeds, mask = prompt_embeds(model, pixel_values, input_ids,
                                 attention_mask)
    return opt_mod.generate(model.opt, embeds, mask, max_new_tokens,
                            eos_id=eos_id, lora=model.lora,
                            lora_scale=model.cfg.lora_scale,
                            sampler=sampler, rng=rng,
                            cache_dtype=cache_dtype)


# ---------------------------------------------------------------------------
# HF checkpoint conversion
# ---------------------------------------------------------------------------


def convert_torch(sd, cfg: Blip2Config) -> Tuple[Dict, Optional[Dict]]:
    """A ``Blip2ForConditionalGeneration`` state dict (plain or
    peft-wrapped) -> (params, lora) in the JAX trees' layout; lora is None
    when the file holds no adapters. A state dict that records its reads
    (``view`` / ``child``, as the JAX package's ``TrackingDict``) sees
    every read, through the peft renames too."""
    lora = _extract_lora(sd)
    keymap = {k.replace("base_model.model.", "")
               .replace(".base_layer", ""): k
              for k in sd if "lora_" not in k}
    sd = (sd.view(keymap) if hasattr(sd, "view")
          else {nk: sd[ok] for nk, ok in keymap.items()})
    params = {
        "vision": vision.convert_torch(subdict(sd, "vision_model."),
                                       cfg.vision),
        "qformer": qf.convert_torch(subdict(sd, "qformer."), cfg.qformer,
                                    sd["query_tokens"]),
        "projection": lin(sd, "language_projection"),
        "opt": opt_mod.convert_torch(
            subdict(sd, "language_model.model.decoder."), cfg.opt),
    }
    # HF ties OPT's lm_head to embed_tokens; the state dict may carry the
    # duplicate key, whose content is embed_tokens'
    if "language_model.lm_head.weight" in sd:
        sd["language_model.lm_head.weight"]
    return params, lora


def _extract_lora(sd) -> Optional[Dict]:
    """peft's ``...decoder.layers.{i}.self_attn.{q,k}_proj.lora_{A,B}
    .default.weight`` (lora_A [r, in], lora_B [out, r]) -> {"i": {"q":
    {"a": [in, r], "b": [r, out]}, "k": ...}}."""
    lora: Dict = {}
    for k in list(sd):
        if "lora_A" not in k and "lora_B" not in k:
            continue
        v = np.asarray(sd[k])
        parts = k.split(".")
        li = str(int(parts[parts.index("layers") + 1]))
        proj = "q" if "q_proj" in k else "k"
        ab = "a" if "lora_A" in k else "b"
        lora.setdefault(li, {}).setdefault(proj, {})[ab] = v.T
    return lora or None
