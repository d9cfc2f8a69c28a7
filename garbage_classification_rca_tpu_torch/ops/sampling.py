"""Token sampling for the generate and serving paths: temperature, top-k,
top-p.

The port of the JAX package's ``ops/sampling.py``. The filters follow HF's
logits processors (TemperatureLogitsWarper, TopKLogitsWarper,
TopPLogitsWarper, in that order):

* temperature: logits / T before any filtering;
* top_k: keep the k highest logits (0 disables; k is clamped to the
  vocabulary);
* top_p: over one descending sort, keep the smallest prefix whose softmax
  mass is > p, i.e. remove where ``cumsum(probs) - probs > p``; every logit
  tied with the smallest kept one is kept too;
* removed positions get -inf.

``sample_tokens`` is an argmax when greedy, else a categorical draw over
the survivors by the Gumbel-max trick, from the ``torch.Generator`` of an
``nn.core.Key``. The draws are not JAX's (threefry): the port keeps the
JAX key structure instead (``fold_in(rng, uid)`` per request, then
``fold_in(·, t)`` per step), so that a server row reproduces its
standalone ``generate``.

``warp_logits_hf`` is the paraphraser's (``data/synonymize``): transformers'
own warpers in their own order and arithmetic, whose top-p differs from
``filter_logits``'s at ties and at the boundary (an ascending sort,
removing where the cumulative mass is <= 1 - p).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class SamplerConfig:
    """Greedy when ``temperature is None`` (the default everywhere: the
    reference's BLIP-2 eval); otherwise HF do_sample semantics."""
    temperature: Optional[float] = None
    top_k: int = 0
    top_p: float = 1.0


GREEDY = SamplerConfig()


def filter_logits(logits: torch.Tensor, cfg: SamplerConfig) -> torch.Tensor:
    """Temperature, then top-k, then top-p. logits [..., V] fp32 -> the
    filtered logits, -inf at the removed ids."""
    if cfg.temperature is not None:
        logits = logits / max(cfg.temperature, 1e-6)
    top_k = min(int(cfg.top_k), logits.shape[-1]) if cfg.top_k else 0
    if top_k <= 0 and cfg.top_p >= 1.0:
        return logits
    neg = torch.tensor(float("-inf"), dtype=logits.dtype,
                       device=logits.device)
    # one descending sort serves both filters
    sorted_lg = torch.sort(logits, dim=-1, descending=True).values
    if top_k > 0:
        kth = sorted_lg[..., top_k - 1:top_k]
        logits = torch.where(logits < kth, neg, logits)
        # removed entries sort to the tail: masking the sorted copy equals
        # sorting the filtered logits
        sorted_lg = torch.where(sorted_lg < kth, neg, sorted_lg)
    if cfg.top_p < 1.0:
        probs = torch.softmax(sorted_lg, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep_sorted = (cum - probs) <= cfg.top_p
        # the smallest kept logit; ties at it are all kept
        thresh = torch.where(keep_sorted, sorted_lg,
                             torch.full_like(sorted_lg, float("inf"))
                             ).amin(dim=-1, keepdim=True)
        logits = torch.where(logits < thresh, neg, logits)
    return logits


def gumbel_argmax(logits: torch.Tensor, generator: torch.Generator
                  ) -> torch.Tensor:
    """A categorical draw per row of logits [B, V] (-inf = never): the
    argmax of logits plus Gumbel noise from `generator`."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    g = -torch.log(-torch.log(u.clamp_min(tiny)))
    return torch.argmax(logits + g, dim=-1)


def sample_tokens(key, logits: torch.Tensor, cfg: SamplerConfig
                  ) -> torch.Tensor:
    """One token per row. logits [B, V] -> int32 [B]: the argmax when
    greedy (`key` unused, may be None), else a draw over the
    ``filter_logits`` survivors from ``key.generator``."""
    logits = logits.float()
    if cfg.temperature is None:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    return gumbel_argmax(filter_logits(logits, cfg),
                         key.generator(logits.device)).to(torch.int32)


def warp_logits_hf(scores: torch.Tensor, temperature: float = 1.0,
                   top_k: int = 0, top_p: float = 1.0) -> torch.Tensor:
    """transformers' ``do_sample`` warpers over fp32 scores [B, V], as its
    ``generate`` applies them (``min_tokens_to_keep`` 1):
    TemperatureLogitsWarper (``scores / T``, when T != 1),
    TopKLogitsWarper (below the k-th largest -> -inf), TopPLogitsWarper
    (sort ascending, remove where the cumulative softmax is <= 1 - p,
    never the largest)."""
    neg = float("-inf")
    if temperature != 1.0:
        scores = scores / temperature
    if top_k:
        k = min(int(top_k), scores.shape[-1])
        kth = torch.topk(scores, k)[0][..., -1, None]
        scores = scores.masked_fill(scores < kth, neg)
    if top_p < 1.0:
        sorted_logits, sorted_idx = torch.sort(scores, descending=False)
        cum = sorted_logits.softmax(dim=-1).cumsum(dim=-1)
        remove = cum <= (1 - top_p)
        remove[..., -1:] = False
        scores = scores.masked_fill(remove.scatter(1, sorted_idx, remove),
                                    neg)
    return scores
