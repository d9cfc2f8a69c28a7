"""Pipeline parallelism (GPipe) of the OPT decoder over the mesh's pipe axis.

The port of the JAX package's ``parallel/pp.py``. JAX drives S devices
from one process: each scans its [1, L/S] slice of stage-stacked layers
inside ``shard_map`` and the activations hop stage to stage by
``ppermute``, one tick at a time. The port runs one process a stage over
``torch.distributed``, so:

  * a stage holds its L/S contiguous decoder layers, the others freed
    (``stage_layers_``: the JAX ``stack_pipeline_params`` and the CLIs'
    dropped replicated copy), keyed by their global index
    (``models.vlm.opt.StageLayers``), and the adapters of those layers
    (``stage_lora_``, with the JAX ``stack_pipeline_lora`` checks: an
    adapter for every layer, one structure); ``gather_pipeline_lora``
    brings every stage's adapters back in the per-layer form
    (``unstack_pipeline_lora``: the BEST file's);
  * activations hop between neighbouring stages by point-to-point send
    and receive (``multihost.ring_step``; host-staged under gloo);
  * ``pp_decode_hidden``: the GPipe forward of M microbatches. Stage 0
    runs the prologue (the learned positions) once on the whole batch and
    splits it; stage s runs microbatch m after stage s - 1 sent it; the
    last stage applies ``final_ln`` to the M outputs put back together.
    The output lives on the last stage (None on the others);
  * ``pp_lm_loss`` / ``pp_blip2_lm_loss``: one CE over the whole batch on
    the last stage (not a mean of microbatch means), broadcast over the
    pipe. Under autograd the loss's backward is the explicit GPipe
    backward: the last stage's CE gives each microbatch's output gradient,
    each stage runs autograd on its stored microbatch graphs in reverse
    order and sends their input gradients to the stage before; every
    gradient lands on the stage that owns its tensor. ``remat`` recomputes
    each layer in the backward (``torch.utils.checkpoint``; the JAX
    ``jax.checkpoint`` on the layer body). The trainer steps it through
    ``cli/blip2_common.make_accum_step`` unchanged
    (``cli/blip2_train.make_pp_lora_train_step``);
  * ``pp_generate``: greedy KV-cache generation on the JAX ring schedule,
    lockstep ticks that each end in one ring step: a prefill of 2S - 1
    ticks (the last stage draws each microbatch's first token and sends
    its embedding round to stage 0), then the decode ring, one token of
    one microbatch a stage a tick.

A data axis composes: a rank holds its rows of the global batch
(``DataMesh.local_rows``: a contiguous block, where JAX shards each
microbatch's rows over the axis; every row's result is the same) and the
pipe groups of the data ranks run independently; a loss is the rank's
rows' (the trainer weighs the ranks by their counted tokens,
``cli/blip2_common.make_accum_step``). The divisibility checks and their
messages are JAX's, on the global batch.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..models.vlm import opt as opt_mod
from ..models.vlm.opt import _layer_lora
from .mesh import DATA_AXIS, PIPE_AXIS
from .multihost import (broadcast_from_, gather_objects, ring_step,
                        wait_all)


def stage_layer_ids(n_layers: int, n_stages: int, stage: int) -> range:
    """The global indices of the layers stage `stage` holds."""
    if n_layers % n_stages != 0:
        raise ValueError(f"{n_layers} layers not divisible by {n_stages} "
                         "stages")
    per = n_layers // n_stages
    return range(stage * per, (stage + 1) * per)


def stage_items(decoder) -> list:
    """[(global index, layer)] of a stage's decoder, in order."""
    return [(int(k), m) for k, m in decoder.layers.items()]


@torch.no_grad()
def stage_layers_(decoder, n_stages: int, stage: int):
    """Keep stage `stage`'s layers of a whole ``OPTDecoder`` and free the
    others, in place. Returns the decoder."""
    if isinstance(decoder.layers, opt_mod.StageLayers):
        raise ValueError("the decoder is a pipeline stage already")
    ids = stage_layer_ids(len(decoder.layers), n_stages, stage)
    decoder.layers = opt_mod.StageLayers(
        {str(i): decoder.layers[i] for i in ids})
    return decoder


def _structure(pair: nn.Module):
    return [(k, tuple(v.shape)) for k, v in pair.state_dict().items()]


def check_pipeline_lora(lora, n_layers: int) -> None:
    """The JAX ``stack_pipeline_lora`` checks: an adapter for every layer,
    each of layer 0's structure."""
    missing = [i for i in range(n_layers) if str(i) not in lora]
    if missing:
        raise ValueError(
            f"pipelined LoRA needs an adapter for every layer; missing "
            f"string keys {missing[:4]}{'...' if len(missing) > 4 else ''} "
            "(sparse adapters only run on the dp/tp paths)")
    want = _structure(lora["0"])
    for i in range(1, n_layers):
        got = _structure(lora[str(i)])
        if got != want:
            raise ValueError(
                f"pipelined LoRA needs a uniform adapter structure; layer "
                f"{i} has {got} but layer 0 has {want} (per-layer "
                "structures only run on the dp/tp paths)")


@torch.no_grad()
def stage_lora_(lora, n_layers: int, n_stages: int, stage: int):
    """Keep stage `stage`'s adapters of a whole ``opt.Lora``, keyed by
    their global index, in place (after ``check_pipeline_lora``). Returns
    the adapters."""
    check_pipeline_lora(lora, n_layers)
    keep = {str(i) for i in stage_layer_ids(n_layers, n_stages, stage)}
    for key in [k for k in lora.keys() if k not in keep]:
        del lora[key]
    return lora


def gather_pipeline_state(lora, optimizer, mesh):
    """(every stage's adapters merged into one state dict, keyed by their
    global index; [each stage's optimizer state dict]) on every rank of
    the pipe group, on the CPU: a pipe run's RESUME payload, which
    resumes at the same pipe size only. `optimizer` None: ([], the
    adapters)."""
    from .fsdp import full_optimizer_state, full_state_dict

    mine = (full_state_dict(lora),
            None if optimizer is None else full_optimizer_state(optimizer))
    merged, opts = {}, []
    for sd, opt_sd in gather_objects(mine, mesh, PIPE_AXIS):
        merged.update(sd)
        opts.append(opt_sd)
    return merged, opts


def gather_pipeline_lora(lora, mesh) -> nn.ModuleDict:
    """Every stage's adapters in the per-layer form of a whole
    ``opt.Lora`` ({"0": {"q", "k"}, ...}, on the CPU in their dtype) on
    every rank of the pipe group: a BEST file's, which any mesh reads."""
    merged, _ = gather_pipeline_state(lora, None, mesh)
    out = nn.ModuleDict()
    for layer in sorted({int(k.split(".")[0]) for k in merged}):
        pre = f"{layer}."
        names = sorted({k.split(".")[1] for k in merged if k.startswith(pre)},
                       key=("q", "k").index)
        pairs = nn.ModuleDict()
        for name in names:
            a, b = merged[f"{pre}{name}.a"], merged[f"{pre}{name}.b"]
            pair = opt_mod.LoraPair(a.shape[0], a.shape[1], b.shape[1])
            pair.to(a.dtype).load_state_dict({"a": a, "b": b})
            pairs[name] = pair
        out[str(layer)] = pairs
    return out


# ---------------------------------------------------------------------------
# the GPipe forward and backward
# ---------------------------------------------------------------------------


def _place(mesh):
    """(stages, this rank's stage) of the pipe axis."""
    return mesh.size(PIPE_AXIS), mesh.coord(PIPE_AXIS)


def _act_dtype(decoder, inputs_embeds) -> torch.dtype:
    """The dtype the stages exchange: the embeddings' (the BLIP-2 prompt's
    compute dtype); stage 0's inputs must be in it."""
    dtype = decoder.embed_tokens.w.dtype
    if inputs_embeds is not None and inputs_embeds.dtype != dtype:
        raise ValueError(f"inputs_embeds in {inputs_embeds.dtype}, the "
                         f"decoder's embeddings in {dtype}: the stages "
                         "exchange activations in one dtype")
    return dtype


def _check_split(b_local: int, m: int, mesh) -> int:
    """The microbatch's local rows; the JAX checks on the global batch."""
    n_dp = mesh.size(DATA_AXIS)
    b = b_local * n_dp
    if b % m != 0:
        raise ValueError(f"batch {b} not divisible by {m} microbatches")
    if (b // m) % n_dp != 0:
        raise ValueError(f"microbatch size {b // m} not divisible by "
                         f"data-axis size {n_dp}")
    return b_local // m


class _GPipe:
    """One GPipe forward of this rank's stage over M microbatches: their
    inputs and outputs, with their graphs when autograd records them
    (``backward`` then runs the stage's share of the GPipe backward)."""

    def __init__(self, decoder, inputs_embeds, attention_mask, mesh, m: int,
                 *, train: bool, lora, lora_scale: float, remat: bool):
        from torch.utils.checkpoint import checkpoint

        self.mesh, self.decoder = mesh, decoder
        self.n_stages, self.stage = _place(mesh)
        cfg = decoder.cfg
        mask = attention_mask.to(torch.int32)
        b, n = mask.shape
        mb = _check_split(b, m, mesh)
        dtype = _act_dtype(decoder, inputs_embeds)
        grad = torch.is_grad_enabled()
        # stage 0's prologue, whose graph (the learned positions, in a full
        # fine-tune) the microbatches share: cut at each microbatch and run
        # backward once
        self.prologue = None
        if self.stage == 0:
            h, _ = opt_mod.prompt_prologue(decoder, inputs_embeds, mask)
            if grad and h.requires_grad:
                self.prologue = h
        items = stage_items(decoder)
        self.ins: List[torch.Tensor] = []
        self.outs: List[torch.Tensor] = []
        pending: list = []
        for j in range(m):
            rows = slice(j * mb, (j + 1) * mb)
            if self.stage == 0:
                x = h[rows]
                if self.prologue is not None:
                    x = x.detach().requires_grad_()
            else:
                x = ring_step(mesh, PIPE_AXIS, recv_like=(
                    (mb, n, cfg.hidden), dtype, mask.device))
                x.requires_grad_(grad)
            y = x
            for i, lp in items:
                args = (lp, y, mask[rows], cfg, _layer_lora(lora, i),
                        lora_scale, train)
                y = (checkpoint(opt_mod._layer, *args, use_reentrant=False)
                     if remat and grad else opt_mod._layer(*args))
            if not self.last:
                ring_step(mesh, PIPE_AXIS, send=y, pending=pending)
            self.ins.append(x)
            self.outs.append(y)
        wait_all(pending)

    @property
    def last(self) -> bool:
        return self.stage == self.n_stages - 1

    def hidden(self) -> Optional[torch.Tensor]:
        """The final hidden [B, L, H] (post final_ln) on the last stage;
        None on the others."""
        if not self.last:
            return None
        return self.decoder.final_ln(torch.cat(self.outs))

    def backward(self, head_grad) -> None:
        """The stage's GPipe backward: `head_grad()` -> the gradient of
        the put-together outputs (the last stage's loss head), else each
        output's from the next stage; then the microbatches in reverse
        order, each input gradient sent to the stage before."""
        mesh = self.mesh
        if self.last:
            gys = list(head_grad().split([y.shape[0] for y in self.outs]))
        pending: list = []
        for j in reversed(range(len(self.outs))):
            y = self.outs[j]
            g = gys[j] if self.last else ring_step(
                mesh, PIPE_AXIS, recv_like=y, shift=-1)
            if y.requires_grad:
                torch.autograd.backward(y, g)
            if self.stage > 0:
                x = self.ins[j]
                ring_step(mesh, PIPE_AXIS, send=(
                    torch.zeros_like(x) if x.grad is None else x.grad),
                    shift=-1, pending=pending)
        wait_all(pending)
        if self.prologue is not None:
            torch.autograd.backward(self.prologue, torch.cat([
                torch.zeros_like(x) if x.grad is None else x.grad
                for x in self.ins]))
        self.ins, self.outs, self.prologue = [], [], None


class _PipeLoss(torch.autograd.Function):
    """The pipe's loss on every stage: its value in the forward; its
    backward runs the stage's GPipe backward with the upstream gradient
    (a data-parallel trainer's weight)."""

    @staticmethod
    def forward(ctx, anchor, value, backward):
        ctx.backward = backward
        return value.clone()

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            ctx.backward(g)
        return None, None, None


def pp_decode_hidden(decoder, inputs_embeds, attention_mask, mesh,
                     n_microbatches: int, train: bool = False, lora=None,
                     lora_scale: float = 1.0, remat: bool = False):
    """The pipelined twin of ``opt.decode_hidden``: inputs_embeds [B, L,
    H] (read on stage 0; None elsewhere), attention_mask [B, L] (every
    stage), this rank's rows; B times the data axis divisible by M and
    the microbatch by the data axis. Returns the final hidden [B, L, H] on
    the last stage, None on the others. `train`: the flash pair (K4a /
    K4b) instead of K2; `remat`: each layer recomputed in the backward."""
    run = _GPipe(decoder, inputs_embeds, attention_mask, mesh,
                 n_microbatches, train=train, lora=lora,
                 lora_scale=lora_scale, remat=remat)
    return run.hidden()


def pp_decode(decoder, inputs_embeds, attention_mask, mesh,
              n_microbatches: int, lora=None, lora_scale: float = 1.0):
    """The pipelined twin of ``opt.decode``: tied-embedding logits on the
    last stage, None on the others."""
    h = pp_decode_hidden(decoder, inputs_embeds, attention_mask, mesh,
                         n_microbatches, lora=lora, lora_scale=lora_scale)
    return None if h is None else opt_mod.lm_head(decoder, h)


def pp_lm_loss(decoder, inputs_embeds, attention_mask, labels, mesh,
               n_microbatches: int, lora=None, lora_scale: float = 1.0,
               remat: bool = False, n_query: int = 0) -> torch.Tensor:
    """The causal-LM CE through the pipelined forward, ``opt.shifted_ce``
    over the whole batch: labels [B, L - n_query] align with the sequence
    after its first `n_query` positions (BLIP-2's query segment; 0: the
    whole sequence), -100 where nothing counts; the lm head runs at the
    counted positions only (``blip2.lm_loss``'s form). Returns the fp32
    loss of this rank's rows on every stage; under autograd (when a
    trained tensor takes part) its backward is the GPipe backward, the
    gradients landing on the stage that owns each tensor."""
    run = _GPipe(decoder, inputs_embeds, attention_mask, mesh,
                 n_microbatches, train=True, lora=lora, lora_scale=lora_scale,
                 remat=remat)
    target = labels[:, 1:]
    keep = target != -100

    def ce(h):
        h = decoder.final_ln(h)[:, n_query:-1][keep]
        return opt_mod.token_ce(opt_mod.lm_head(decoder, h), target[keep])

    if run.last:
        with torch.no_grad():
            value = ce(torch.cat(run.outs)).float()
    else:
        value = torch.zeros((), dtype=torch.float32, device=labels.device)
    broadcast_from_(value, mesh, PIPE_AXIS)
    if not torch.is_grad_enabled():
        return value

    def backward(g):
        def head_grad():
            h = torch.cat([y.detach() for y in run.outs]).requires_grad_()
            torch.autograd.backward(ce(h), g)
            return h.grad
        run.backward(head_grad)

    anchor = torch.zeros((), device=value.device, requires_grad=True)
    return _PipeLoss.apply(anchor, value, backward)


def _prompt(model, pixel_values, input_ids, attention_mask, mesh):
    """(embeds on stage 0, else None; mask [B, n_query + L]): the BLIP-2
    prompt, the frozen towers run on stage 0 only."""
    from ..models.vlm import blip2

    if mesh.coord(PIPE_AXIS) == 0:
        with torch.no_grad():
            return blip2.prompt_embeds(model, pixel_values, input_ids,
                                       attention_mask)
    nq = model.cfg.qformer.n_query
    return None, torch.cat([attention_mask.new_ones(
        (attention_mask.shape[0], nq)), attention_mask], dim=1)


def pp_blip2_lm_loss(model, pixel_values, input_ids, attention_mask, labels,
                     mesh, n_microbatches: int,
                     remat: bool = False) -> torch.Tensor:
    """The pipelined twin of ``blip2.lm_loss``: EVA, the Q-Former and the
    projection (whole on every rank, run on stage 0), the query
    embeddings before the text, the decoder's stages with their adapters,
    the shifted CE over the text segment (``pp_lm_loss``)."""
    embeds, mask = _prompt(model, pixel_values, input_ids, attention_mask,
                           mesh)
    return pp_lm_loss(model.opt, embeds, mask, labels, mesh, n_microbatches,
                      lora=model.lora, lora_scale=model.cfg.lora_scale,
                      remat=remat, n_query=model.cfg.qformer.n_query)


def pp_blip2_next_token_logits(model, pixel_values, input_ids,
                               attention_mask, mesh, n_microbatches: int):
    """The pipelined twin of ``blip2.next_token_logits``: the logits [B,
    vocab] after each row's last valid prompt token on the last stage,
    None on the others."""
    from ..models.vlm.blip2 import _last_valid_index

    embeds, mask = _prompt(model, pixel_values, input_ids, attention_mask,
                           mesh)
    h = pp_decode_hidden(model.opt, embeds, mask, mesh, n_microbatches,
                         lora=model.lora, lora_scale=model.cfg.lora_scale)
    if h is None:
        return None
    last = model.cfg.qformer.n_query + _last_valid_index(attention_mask)
    return opt_mod.lm_head(
        model.opt, h[torch.arange(h.shape[0], device=h.device), last])


# ---------------------------------------------------------------------------
# generation on the ring
# ---------------------------------------------------------------------------


@torch.no_grad()
def pp_generate(decoder, inputs_embeds, attention_mask, mesh,
                max_new_tokens: int, eos_id: int = 2,
                cache_dtype: Optional[str] = None, lora=None,
                lora_scale: float = 1.0):
    """Pipelined greedy KV-cache generation, the JAX ``pp_generate``'s
    ring schedule: the batch (this rank's rows; inputs_embeds on stage 0)
    splits into S microbatches, one a stage; each stage holds K / V caches
    [L/S, S, mb, T, H] for its layers and every microbatch (int8 with
    per-slot scales under ``cache_dtype="int8"``, ``opt.new_caches``).

    Lockstep ticks, each ending in one ``ring_step`` (a stage's output to
    the next, the last stage's token embedding round to stage 0; with S =
    2 both ranks send and receive in the same step). Prefill, 2S - 1
    ticks: stage s runs microbatch t - s through ``layer_prefill``, the
    last stage draws its first token. Decode ring: stage s runs phase t -
    s, microbatch phase % S at token phase // S, through ``cache_layer``
    at the token's slot and learned position; the last stage draws the
    next token. Token N - 1's forward, whose result no one reads, is not
    run (as ``opt.generate`` skips it): (N - 1) S + S - 1 ticks.

    Returns (tokens int32 [B, N], valid bool [B, N]) on every stage of
    the pipe, ``opt.generate``'s contract: each row's EOS is its last
    valid entry."""
    if cache_dtype not in (None, "int8"):
        raise ValueError(f"unknown cache_dtype {cache_dtype!r} "
                         "(None or 'int8')")
    n_stages, s = _place(mesh)
    cfg = decoder.cfg
    mask = attention_mask.to(torch.int32)
    b, lp = mask.shape
    n_dp = mesh.size(DATA_AXIS)
    gb = b * n_dp
    if gb % n_stages != 0:
        raise ValueError(f"batch {gb} not divisible by {n_stages} pipeline "
                         "microbatches (pp_generate uses one microbatch "
                         "per stage)")
    if (gb // n_stages) % n_dp != 0:
        raise ValueError(f"microbatch size {gb // n_stages} not divisible "
                         f"by data-axis size {n_dp}")
    mb = b // n_stages
    n_new = max_new_tokens
    rounds = n_new - 1
    dtype = _act_dtype(decoder, inputs_embeds)
    dev = mask.device
    d = cfg.hidden
    items = stage_items(decoder)
    caches = opt_mod.new_caches(
        (len(items), n_stages, mb, lp + n_new, items[0][1].k.w.shape[0]),
        dtype, dev, cache_dtype)
    if s == 0:
        h, _ = opt_mod.prompt_prologue(decoder, inputs_embeds, mask)
    n_valid = mask.sum(dim=1)
    base_mask = F.pad(mask, (0, n_new))
    slot_ids = torch.arange(lp + n_new, device=dev)
    rows = torch.arange(mb, device=dev)
    last = s == n_stages - 1
    prev = (s - 1) % n_stages

    def part(x, mi):
        return x[mi * mb:(mi + 1) * mb]

    def cache(mi):
        return {k: c[:, mi] for k, c in caches.items()}

    def draw(hh):
        tok = opt_mod._argmax(opt_mod.lm_head(decoder, hh))
        return tok, opt_mod.embed_tokens(decoder, tok).to(dtype)

    tok: list = [None] * n_stages
    done = [torch.zeros(mb, dtype=torch.bool, device=dev)
            for _ in range(n_stages)]
    out_t = torch.zeros((n_stages, mb, n_new), dtype=torch.int32, device=dev)
    out_v = torch.zeros((n_stages, mb, n_new), dtype=torch.bool, device=dev)
    buf: list = [None] * n_stages

    # prefill: ticks 0 .. 2S - 2
    wire = None
    for t in range(2 * n_stages - 1):
        mi, out = t - s, None
        if 0 <= mi < n_stages:
            x = part(h, mi) if s == 0 else wire
            cv = cache(mi)
            for j, (i, lyr) in enumerate(items):
                x, k, v = opt_mod.layer_prefill(lyr, x, part(mask, mi), cfg,
                                                _layer_lora(lora, i),
                                                lora_scale)
                opt_mod.fill_prompt(cv, j, k, v)
            if last:
                hl = opt_mod.last_hidden(decoder.final_ln(x), part(mask, mi))
                tok[mi], out = draw(hl)
            else:
                out = x
        p_mi = t - prev
        like = None
        if 0 <= p_mi < n_stages:
            like = ((mb, d), dtype, dev) if s == 0 else ((mb, lp, d), dtype,
                                                         dev)
        wire = ring_step(mesh, PIPE_AXIS, send=out, recv_like=like)
        if s == 0 and like is not None:
            buf[p_mi] = wire

    # the decode ring: ticks 0 .. (N - 1) S + S - 2
    wire = None
    for t in range(rounds * n_stages + n_stages - 1):
        phase, out = t - s, None
        if 0 <= phase < rounds * n_stages:
            mi, ti = phase % n_stages, phase // n_stages
            x = wire if s > 0 or ti > 0 else buf[mi]
            if s == 0:
                x = x + opt_mod._positions(
                    decoder, part(n_valid, mi) + ti + cfg.pos_offset
                ).to(dtype)
            slot = lp + ti
            attn = part(base_mask, mi) | (
                (slot_ids >= lp) & (slot_ids <= slot)).to(torch.int32)[None]
            bias = opt_mod._bias(attn)[:, None]
            slots = torch.full((mb, 1), slot, device=dev)
            cv = cache(mi)
            hh = x[:, None]
            for j, (i, lyr) in enumerate(items):
                hh = opt_mod.cache_layer(lyr, cfg, cv, j, hh, rows[:, None],
                                         slots, bias, _layer_lora(lora, i),
                                         lora_scale)
            if last:
                nxt, emb = draw(decoder.final_ln(hh)[:, 0])
                cur = tok[mi]
                out_t[mi, :, ti] = cur
                out_v[mi, :, ti] = ~done[mi]
                done[mi] = done[mi] | (cur == eos_id)
                tok[mi] = nxt
                out = emb if ti + 1 < rounds else None
            else:
                out = hh[:, 0]
        p_phase = t - prev
        like = None
        if 0 <= p_phase < rounds * n_stages and (
                prev != n_stages - 1 or p_phase // n_stages + 1 < rounds):
            like = ((mb, d), dtype, dev)
        wire = ring_step(mesh, PIPE_AXIS, send=out, recv_like=like)

    if last:
        for mi in range(n_stages):
            out_t[mi, :, n_new - 1] = tok[mi]
            out_v[mi, :, n_new - 1] = ~done[mi]
    valid = out_v.to(torch.int32)
    broadcast_from_(out_t, mesh, PIPE_AXIS)
    broadcast_from_(valid, mesh, PIPE_AXIS)
    return out_t.reshape(b, n_new), valid.reshape(b, n_new).bool()


def pp_blip2_generate(model, pixel_values, input_ids, attention_mask, mesh,
                      max_new_tokens: int, eos_id: int = 2,
                      cache_dtype: Optional[str] = None):
    """The pipelined twin of ``blip2.generate`` (greedy): the prompt on
    stage 0, then ``pp_generate`` with the stage's adapters. (tokens,
    valid) on every stage."""
    embeds, mask = _prompt(model, pixel_values, input_ids, attention_mask,
                           mesh)
    return pp_generate(model.opt, embeds, mask, mesh, max_new_tokens,
                       eos_id=eos_id, cache_dtype=cache_dtype,
                       lora=model.lora, lora_scale=model.cfg.lora_scale)
