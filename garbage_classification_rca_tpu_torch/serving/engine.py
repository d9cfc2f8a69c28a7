"""Continuous batching for the OPT / BLIP-2 serving path.

The port of the JAX package's ``serving/engine.py``. ``opt.generate``
serves static batches: every row prefills together and the batch ends with
its slowest row. ``GenerationServer`` keeps a fixed grid of ``slots``
lanes, with KV caches [layers, slots, max_prompt + max_new, H] on the
device (H / M, the local heads, on a decoder that ``parallel/tp.py``
sliced over M ranks: every rank runs the same schedule, the caller
feeding each the same requests in the same order):

  * ``_refill``: a prefill at the fixed batch of ``slots`` prompts (padded
    to ``max_prompt``; the free slots' requests, the last one repeated)
    through ``opt.prefill`` (K2 on the card, the int8 cache where asked),
    then each real row's caches, first token and lane state written into
    its slot. The repeated rows are not written anywhere: an index_put
    with repeated indices has no defined result on CUDA.
  * ``_decode``: ``steps_per_sync`` one-token steps of every lane at once
    (``opt.decode_step``) with per-lane progress: each lane has its own
    write slot, learned position and attention extent. The fed tokens come
    back to the host once a sync; the host retires a slot whose request fed
    its EOS or reached its own ``max_new``, and refills it from the queue.

Contract: for any arrival order, queue depth and slot count, a request's
(tokens, valid) equal ``opt.generate`` on that request alone, padded on
the right to ``max_prompt``: greedy, sampled with ``rng.fold_in(uid)``
(then ``fold_in(0)`` for the first token and ``fold_in(n + 1)`` after the
n-th step, as ``generate`` folds its key) and with the int8 cache. A slot's
new occupant never attends its predecessor's K / V: the refill overwrites
every slot of the lane, and the lane's extent only unmasks generation
slots it has written. Rows are bit-identical only where the library's
products give a row the same bits at every batch size (tests measure it).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..models.vlm import opt as opt_mod
from ..nn.core import Key
from ..ops import sampling as smp


@dataclass
class ServedRequest:
    """Host-side bookkeeping of one request. ``t_submit`` / ``t_first`` /
    ``t_done``: host clock at submission, when its first token reached the
    host, and at retirement."""
    uid: int
    embeds: torch.Tensor        # [max_prompt, H], padded, the server dtype
    mask: np.ndarray            # [max_prompt] int32
    max_new: int = 0            # this request's budget (<= the server's)
    tokens: List[int] = field(default_factory=list)
    valid: List[bool] = field(default_factory=list)
    done: bool = False          # EOS fed
    finished: bool = False      # retired from its slot
    t_submit: float = 0.0
    t_first: Optional[float] = None
    t_done: Optional[float] = None


class GenerationServer:
    """Continuous-batching greedy or sampled generation over ``slots``
    lanes of an ``opt.OPTDecoder``, on the model's device.

    `lora` / `lora_scale` / `cache_dtype`: as in ``opt.generate``. Prompts
    of any padding side are padded on the right to ``max_prompt``; each
    request gets up to its own ``max_new`` tokens. `rng` (an
    ``nn.core.Key``, default ``Key(0)``) seeds sampling: request uid i
    draws from ``rng.fold_in(i)``."""

    def __init__(self, model: opt_mod.OPTDecoder, *, slots: int,
                 max_prompt: int, max_new: int, eos_id: int = 2,
                 lora: Optional[opt_mod.Lora] = None,
                 lora_scale: float = 1.0,
                 sampler: Optional[smp.SamplerConfig] = None,
                 rng: Optional[Key] = None,
                 cache_dtype: Optional[str] = None,
                 steps_per_sync: int = 1):
        if sampler is not None and sampler.temperature is not None \
                and rng is None:
            raise ValueError("sampling (temperature set) requires rng")
        if slots < 1 or max_prompt < 1 or max_new < 1 \
                or steps_per_sync < 1:
            raise ValueError("slots, max_prompt, max_new and steps_per_sync "
                             "must be positive")
        if cache_dtype not in (None, "int8"):
            raise ValueError(f"unknown cache_dtype {cache_dtype!r} "
                             "(None or 'int8')")
        self.model, self.cfg, self.lora = model, model.cfg, lora
        self.lora_scale = lora_scale
        self.slots, self.max_prompt, self.max_new = slots, max_prompt, max_new
        self.eos_id, self.sampler = eos_id, sampler or smp.GREEDY
        self.cache_dtype, self.steps_per_sync = cache_dtype, steps_per_sync
        self.rng = Key(0) if rng is None else rng
        self.t_cache = max_prompt + max_new

        self.queue: deque = deque()
        self.requests: Dict[int, ServedRequest] = {}
        self.slot_req: List[Optional[int]] = [None] * slots
        self._next_uid = 0

        emb = model.embed_tokens.w
        dev, self._emb_dtype = emb.device, emb.dtype
        self.device = dev
        shape = (len(model.layers), slots, self.t_cache,
                 opt_mod.kv_width(model))
        q8 = cache_dtype == "int8"
        self.caches = {n: torch.zeros(shape, device=dev, dtype=(
            torch.int8 if q8 else emb.dtype)) for n in ("k", "v")}
        if q8:
            for n in ("k_scale", "v_scale"):
                self.caches[n] = torch.ones(shape[:-1] + (1,), device=dev)
        self.tok = torch.zeros(slots, dtype=torch.int32, device=dev)
        self.n_fed = torch.zeros(slots, dtype=torch.long, device=dev)
        self.n_valid = torch.zeros(slots, dtype=torch.long, device=dev)
        self.base_mask = torch.zeros((slots, self.t_cache),
                                     dtype=torch.int32, device=dev)
        self._slot_ids = torch.arange(self.t_cache, device=dev)[None, :]
        # host mirrors for the sampled draws' keys
        self._lane_key: List[Key] = [self.rng] * slots
        self._n_fed_host = np.zeros(slots, np.int64)

    # ---- device work -------------------------------------------------------

    def _draw(self, logits: torch.Tensor, lanes, steps) -> torch.Tensor:
        """The next token of each row of logits [R, V]: row r is lane
        lanes[r] at its step steps[r] (the key's fold_in)."""
        if self.sampler.temperature is None:
            return smp.sample_tokens(None, logits, self.sampler)
        return torch.cat([smp.sample_tokens(
            self._lane_key[ln].fold_in(int(st)), logits[r:r + 1],
            self.sampler) for r, (ln, st) in enumerate(zip(lanes, steps))])

    @torch.no_grad()
    def _refill(self):
        """Prefill every refillable slot from the queue in one fixed-batch
        prefill; write each real row into its slot."""
        free = [s for s in range(self.slots) if self.slot_req[s] is None]
        if not free or not self.queue:
            return
        take = [self.queue.popleft()
                for _ in range(min(len(free), len(self.queue)))]
        n = len(take)
        batch = take + [take[-1]] * (self.slots - n)
        embeds = torch.stack([r.embeds.to(self.device) for r in batch])
        masks = torch.from_numpy(np.stack([r.mask for r in batch])).to(
            self.device)
        h, rows = opt_mod.prefill(self.model, embeds, masks, self.max_new,
                                  lora=self.lora, lora_scale=self.lora_scale,
                                  cache_dtype=self.cache_dtype)
        logits = opt_mod.lm_head(self.model,
                                 opt_mod.last_hidden(h[:n], masks[:n]))
        lanes = free[:n]
        for r, ln in zip(take, lanes):
            self._lane_key[ln] = self.rng.fold_in(r.uid)
            self._n_fed_host[ln] = 0
        tok0 = self._draw(logits, lanes, [0] * n)
        idx = torch.tensor(lanes, dtype=torch.long, device=self.device)
        for name, c in self.caches.items():
            c[:, idx] = rows[name][:, :n]
        self.tok[idx] = tok0
        self.n_fed[idx] = 0
        self.n_valid[idx] = masks[:n].sum(dim=1).long()
        self.base_mask[idx] = F.pad(masks[:n], (0, self.max_new))
        for r, ln in zip(take, lanes):
            self.slot_req[ln] = r.uid

    @torch.no_grad()
    def _decode(self, n_steps: int) -> np.ndarray:
        """n_steps one-token steps of every lane; returns the fed tokens
        [n_steps, lanes] (the one host read of a sync)."""
        fed = []
        lanes = range(self.slots)
        for _ in range(n_steps):
            write = (self.max_prompt + self.n_fed).clamp(max=self.t_cache - 1)
            pos = self.n_valid + self.n_fed + self.cfg.pos_offset
            attn = self.base_mask | (
                (self._slot_ids >= self.max_prompt)
                & (self._slot_ids <= self.max_prompt
                   + self.n_fed[:, None])).to(torch.int32)
            emb = opt_mod.embed_tokens(self.model, self.tok).to(
                self._emb_dtype)
            h, self.caches = opt_mod.decode_step(
                self.model, self.caches, emb, write, pos, attn,
                lora=self.lora, lora_scale=self.lora_scale)
            nxt = self._draw(opt_mod.lm_head(self.model, h), lanes,
                             self._n_fed_host + 1)
            fed.append(self.tok)
            self.tok = nxt
            self.n_fed = self.n_fed + 1
            self._n_fed_host += 1
        return torch.stack(fed).cpu().numpy()

    # ---- host scheduler ----------------------------------------------------

    def submit(self, inputs_embeds, attention_mask,
               max_new: Optional[int] = None) -> int:
        """Queue one request: inputs_embeds [L, H] (or [1, L, H]), numpy or
        a tensor on any device, and attention_mask [L], L <= max_prompt,
        any padding side. `max_new` caps this request's tokens (default
        and upper bound: the server's). Raises ValueError here, before the
        request is queued, on a wrong width, length, mask or budget.
        Returns the uid."""
        e = (inputs_embeds if isinstance(inputs_embeds, torch.Tensor)
             else torch.from_numpy(np.asarray(inputs_embeds)))
        m = (attention_mask.cpu().numpy()
             if isinstance(attention_mask, torch.Tensor)
             else np.asarray(attention_mask))
        if e.dim() == 3:
            e, m = e[0], m.reshape(-1)
        if e.dim() != 2:
            raise ValueError(f"prompt embeddings must be [L, H], got "
                             f"{tuple(e.shape)}")
        l, h = e.shape
        if h != self.cfg.hidden:
            raise ValueError(f"prompt hidden dim {h} != cfg.hidden "
                             f"{self.cfg.hidden}")
        if l > self.max_prompt:
            raise ValueError(f"prompt length {l} > max_prompt "
                             f"{self.max_prompt}")
        if m.shape != (l,):
            raise ValueError(f"attention_mask shape {m.shape} != ({l},)")
        if max_new is None:
            max_new = self.max_new
        if not 1 <= max_new <= self.max_new:
            raise ValueError(f"max_new {max_new} not in [1, {self.max_new}]")
        # the dtype is pinned now: a refill stacks its requests into one
        # batch, so a request's numerics must not hang on its neighbours'
        e = F.pad(e.to(self._emb_dtype), (0, 0, 0, self.max_prompt - l))
        m = np.pad(m.astype(np.int32), (0, self.max_prompt - l))
        uid = self._next_uid
        self._next_uid += 1
        req = ServedRequest(uid, e, m, max_new, t_submit=time.perf_counter())
        self.requests[uid] = req
        self.queue.append(req)
        return uid

    def step(self) -> List[ServedRequest]:
        """One scheduler round: refill free slots, run ``steps_per_sync``
        decode steps, record the fed tokens, retire finished slots.
        Returns the requests that finished in this round."""
        self._refill()
        if all(r is None for r in self.slot_req):
            return []
        fed = self._decode(self.steps_per_sync)
        now = time.perf_counter()
        finished = []
        for slot, uid in enumerate(self.slot_req):
            if uid is None:
                continue
            req = self.requests[uid]
            for s in range(fed.shape[0]):
                if len(req.tokens) >= req.max_new or req.done:
                    break                      # past the retirement point
                t = int(fed[s, slot])
                req.tokens.append(t)
                req.valid.append(True)
                if req.t_first is None:
                    req.t_first = now
                if t == self.eos_id:
                    req.done = True
            if req.done or len(req.tokens) >= req.max_new:
                req.finished, req.t_done = True, now
                self.slot_req[slot] = None
                finished.append(req)
        return finished

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.slot_req)

    def drain(self) -> List[ServedRequest]:
        out = []
        while self.has_work:
            out.extend(self.step())
        return out

    def run(self, requests) -> Dict[int, ServedRequest]:
        """Submit [(embeds, mask), ...], then drain. Returns uid ->
        ServedRequest (uids in submission order)."""
        for e, m in requests:
            self.submit(e, m)
        self.drain()
        return self.requests
