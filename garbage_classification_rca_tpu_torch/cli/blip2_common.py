"""Shared plumbing of the BLIP-2 / Q-Former CLIs.

The port of the single-process part of the JAX package's
``cli/blip2_common.py``: builds the model from an HF
``Blip2ForConditionalGeneration`` state dict (``--model_path``, plain or
peft-wrapped), from random weights (``--seed``) or, for the adapters, from
a BEST file of ``cli.blip2_train``; makes the host batches
(CLIP-preprocessed uint8 images, prompts left-padded to 100 tokens,
answer-word label tokens; reference blip_2_training.py:47-107); runs the
eval loop; and gives both trainers their input stream
(``vlm_train_stream``: shuffled windows of ``acc_steps`` microbatches) and
their grad-accumulating optimizer step (``make_accum_step``), and the
full resume both share (``VlmResume``: ``--resume_from=.../RESUME``).
Each runs over the data axis of a ``DataMesh`` too: a rank decodes its
rows of every global batch, the step's loss is the global microbatch's
and the eval gathers the predictions (``vlm_multihost_mesh_check``
refuses what stays one-process). Over the model axis ``place_blip2``
slices the OPT tower Megatron-style (``parallel/tp.py``); the ranks of a
model group hold the same rows, and the LoRA step sums the adapters'
gradients over that group as well. Over the pipe axis ``setup_pipeline``
keeps a stage's decoder layers and adapters (``parallel/pp.py``; the
towers stay whole), after ``check_pipe_flags`` refused what the JAX CLIs
refuse on a pipe mesh.

``GC_RCA_TINY_BLIP2=1`` swaps the full ``Salesforce/blip2-opt-2.7b``
geometry for the JAX package's tiny test configuration (CPU drives only:
its head dims, 16, are not the kernels').
"""

from __future__ import annotations

import itertools
import math
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..data.images import CLIP_MEAN, CLIP_STD, blip_preprocess_image
from ..data.manifest import Manifest
from ..data.tokenizer import BaseTokenizer, get_tokenizer, resolve_vocab_dir
from ..eval.harness import run_eval
from ..models.vlm import blip2
from ..models.vlm.prompts import (FOLDER_TO_ANSWER, MAX_PROMPT_TOKENS,
                                  build_prompt, prompt_text_from_path)
from ..nn.core import batch_shard
from ..parallel.fsdp import load_optimizer_state
from ..train.engine import PhaseResult, load_model_state, maybe_load_resume

def normalize_clip(x_uint8: torch.Tensor, dtype=torch.bfloat16):
    """uint8 NHWC -> CLIP-normalized NHWC in `dtype`: ``x * (1 / (255
    std)) + (-mean / std)`` in fp32 (the JAX package's formula)."""
    scale = torch.from_numpy((1.0 / (255.0 * CLIP_STD)).astype(np.float32))
    shift = torch.from_numpy((-CLIP_MEAN / CLIP_STD).astype(np.float32))
    dev = x_uint8.device
    return (x_uint8.float() * scale.to(dev) + shift.to(dev)).to(dtype)


def left_pad(ids: List[int], max_len: int, pad_id: int
             ) -> Tuple[List[int], List[int]]:
    """BLIP-2 prompts are LEFT-padded to 100 (blip_2_training.py:66)."""
    ids = ids[-max_len:]
    pad = max_len - len(ids)
    return [pad_id] * pad + ids, [0] * pad + [1] * len(ids)


class Blip2Batcher:
    """Host batches: CLIP-preprocessed uint8 images + left-padded prompt
    tokens + answer-word label tokens + class labels."""

    def __init__(self, manifest: Manifest, tokenizer: BaseTokenizer,
                 workers: int = 8, label_token_len: int = 4):
        import concurrent.futures as cf

        self.m = manifest
        self.tok = tokenizer
        self.label_token_len = label_token_len
        self.pool = cf.ThreadPoolExecutor(max_workers=workers)
        # one label-token sequence per class (fixed, computed once)
        self.answer_token_ids = {}
        for folder, word in FOLDER_TO_ANSWER.items():
            ids, _ = self.tok.encode_one(word, label_token_len)
            self.answer_token_ids[folder] = ids

    def close(self):
        self.pool.shutdown(wait=False)

    def make_batch(self, indices, batch_size) -> Dict[str, np.ndarray]:
        n = len(indices)
        padded = np.concatenate([indices, np.zeros(batch_size - n, np.int64)]) \
            if n < batch_size else indices
        samples = [self.m.samples[i] for i in padded]
        imgs = list(self.pool.map(
            lambda s: blip_preprocess_image(s.image_path), samples))
        ids_rows, mask_rows, lab_rows = [], [], []
        pad_id = self.tok.pad_id
        for s in samples:
            prompt = build_prompt(prompt_text_from_path(s.image_path))
            pids, _ = self.tok.encode_one(prompt, MAX_PROMPT_TOKENS)
            ids, mask = left_pad(pids, MAX_PROMPT_TOKENS, pad_id)
            folder = self.m.classes[s.label]
            lab = self.answer_token_ids[folder][:self.label_token_len]
            lab = lab + [pad_id] * (self.label_token_len - len(lab))
            ids_rows.append(ids)
            mask_rows.append(mask)
            lab_rows.append(lab)
        return {
            "image": np.stack(imgs).astype(np.uint8),
            "input_ids": np.asarray(ids_rows, np.int32),
            "attention_mask": np.asarray(mask_rows, np.int32),
            "label_tokens": np.asarray(lab_rows, np.int32),
            "label": np.asarray([s.label for s in samples], np.int32),
            "valid": np.asarray([1] * n + [0] * (batch_size - n), np.int32),
        }

    def iter_batches(self, batch_size: int, *, shuffle=False, seed=0,
                     rows=None):
        """Batches of the plan; `rows`: only these rows of each global
        batch (``data.pipeline.local_plan``)."""
        from ..data.pipeline import batch_indices, local_plan

        for plan in batch_indices(len(self.m), batch_size, shuffle=shuffle,
                                  seed=seed):
            if rows is None:
                yield self.make_batch(plan, batch_size)
            else:
                yield self.make_batch(local_plan(plan, rows), len(rows))


def tiny_blip2_config() -> blip2.Blip2Config:
    """The JAX package's reduced geometry for hermetic CPU drives
    (GC_RCA_TINY_BLIP2=1): same code paths, ~1000x fewer FLOPs."""
    from ..models.vlm import blip2_vision, opt as opt_mod, qformer as qf

    return blip2.Blip2Config(
        vision=blip2_vision.VisionConfig(layers=2, hidden=64, heads=4,
                                         ffn=128, patch=14, image_size=224),
        qformer=qf.QFormerConfig(layers=2, hidden=32, heads=4, ffn=64,
                                 n_query=8, cross_frequency=2,
                                 vision_hidden=64),
        opt=opt_mod.OPTConfig(layers=2, hidden=64, heads=4, ffn=128,
                              vocab=50272, max_pos=256),
        lora_r=4, lora_alpha=8)


def blip2_config() -> blip2.Blip2Config:
    """blip2-opt-2.7b, or the tiny geometry under GC_RCA_TINY_BLIP2."""
    if os.environ.get("GC_RCA_TINY_BLIP2"):
        return tiny_blip2_config()
    return blip2.Blip2Config()


def build_blip2(args, device, compute_dtype, *, with_lora: bool = True,
                classifier: bool = False, train: bool = False):
    """-> (cfg, model, tokenizer). Loads ``--model_path`` when it is an HF /
    peft state dict (with its adapters when it holds them), else draws
    random towers from ``--seed``, held at bf16 precision as the JAX
    package inits them in bf16; a BEST file of ``cli.blip2_train`` as
    ``--model_path`` gives the adapters over the random towers (the JAX
    CLI's BEST directory: ``build_blip2`` as for no file, then the
    adapters restored). With `with_lora` and no adapters in the file, the
    adapters are drawn from ``--seed + 1`` with B = 0; the classifier,
    when asked, from ``--seed + 2`` (``cli.qformer_test`` loads
    ``--classifier_weights`` over it). The weights end in `compute_dtype`,
    the LayerNorms and the classifier in fp32 (``Blip2Model.cast_``), and
    with `train` the adapters too (the LoRA trainer's fp32 master
    weights, as the JAX trainer keeps them)."""
    from ..checkpoint.from_jax import load_blip2_tree
    from ..train.engine import load_checkpoint

    cfg = blip2_config()
    tok = get_tokenizer("opt", vocab_dir=resolve_vocab_dir(args))
    model = blip2.build_model(cfg, device, lora=with_lora,
                              classifier=classifier)
    keep = ("lora",) if train and with_lora else ()
    lora, path = None, args.model_path
    is_file = bool(path) and os.path.isfile(path)
    best = load_checkpoint(path) if is_file else None
    if is_file and best is None:
        from ..checkpoint.torch_convert import load_torch_state_dict

        params, lora = blip2.convert_torch(load_torch_state_dict(path), cfg)
        lora = lora if with_lora else None
        load_blip2_tree(model, params, lora)
    else:
        # the BEST file's fp32 adapters are read as they are
        blip2.init_(model, args.seed).cast_(
            torch.bfloat16, ("lora",) if best is not None else keep)
    if with_lora and lora is None:
        blip2.init_lora_(model.lora, args.seed + 1)
    if with_lora and best is not None:
        model.lora.load_state_dict(best["state_dict"])
    if classifier:
        blip2.init_classifier_(model.classifier, args.seed + 2)
    return cfg, model.cast_(compute_dtype, keep), tok


def sampler_from_args(args):
    """The ``ops.sampling.SamplerConfig`` of ``--gen_temperature`` /
    ``--gen_top_k`` / ``--gen_top_p``; None (greedy) at temperature 0."""
    if args.gen_temperature <= 0:
        return None
    from ..ops.sampling import SamplerConfig

    return SamplerConfig(temperature=args.gen_temperature,
                         top_k=args.gen_top_k, top_p=args.gen_top_p)


def class_logits_from_next_token(next_logits: torch.Tensor,
                                 answer_first_tokens: torch.Tensor
                                 ) -> torch.Tensor:
    """Constrained 1-token decode: each answer word's first-token logit
    (the argmax over the 4 bins equals the reference's generate +
    find_closest_string when the decoded token is one of them)."""
    return next_logits[:, answer_first_tokens]


def place_blip2(model, mesh):
    """BLIP-2 on `mesh` (the JAX ``place_blip2_params``): the OPT tower
    sliced over the model axis when it has more than one rank
    (``parallel/tp.shard_opt_``: q / k / v / fc1 column-, out / fc2
    row-parallel); vision, Q-Former, projection, adapters and classifier
    whole on every rank. Quantize the tower before
    (``ops/quant.quantize_opt_weights``), as the JAX CLIs do. Returns the
    model."""
    from ..parallel.tp import shard_opt_

    shard_opt_(model.opt, mesh)
    return model


def check_pipe_flags(args) -> int:
    """The pipe axis's refusals, made before any rank starts (the JAX
    CLIs' guards, with their words): a model axis beside it, a pipe size
    that does not divide the OPT layers, ``--hf_internal_dropout``, and
    for ``--max_new_tokens > 1`` ``--gen_temperature`` and
    ``--int8_weights``; and the JAX package's rule that a pipe mesh runs
    in one process, which the port reads as one host: a launch across
    hosts (the JAX package's ``GC_RCA_MULTIHOST`` variables, or a
    torchrun of several nodes) exits. Returns the pipe size."""
    from ..parallel.mesh import PIPE_AXIS, parse_mesh_shape
    from ..parallel.multihost import env_world_size

    axes = parse_mesh_shape(args.mesh_shape or "data:-1", env_world_size())
    n_pipe = axes.get(PIPE_AXIS, 1)
    if n_pipe <= 1:
        return 1
    env = os.environ
    if env.get("GC_RCA_MULTIHOST", "") in ("1", "true") or int(
            env.get("LOCAL_WORLD_SIZE") or env_world_size()) \
            < env_world_size():
        raise SystemExit(
            "--mesh_shape with a pipe axis is single-process only; "
            "multi-host (GC_RCA_MULTIHOST) VLM runs support data / "
            "data,model meshes")
    if axes.get("model", 1) > 1:
        raise SystemExit("--mesh_shape: combine pipe with data only "
                         "(model-axis TP of a stage-sharded decoder "
                         "is not supported)")
    layers = blip2_config().opt.layers
    if layers % n_pipe:
        raise SystemExit(f"--mesh_shape pipe:{n_pipe} must divide the "
                         f"{layers}-layer OPT decoder")
    if getattr(args, "hf_internal_dropout", False):
        raise SystemExit("--hf_internal_dropout is not supported on a pipe "
                         "mesh (the GPipe loss path is deterministic); "
                         "use a data/data,model mesh")
    if getattr(args, "max_new_tokens", 1) > 1:
        if args.gen_temperature > 0:
            raise SystemExit("--gen_temperature: sampled decode is "
                             "not supported on pipe meshes (use a "
                             "data/model mesh)")
        if args.int8_weights:
            raise SystemExit("--int8_weights: weight-only int8 is "
                             "not supported on pipe meshes (use a "
                             "data/model mesh; --kv_cache_dtype=int8 "
                             "works on both)")
    return n_pipe


def setup_pipeline(model, mesh):
    """A BLIP-2 model on a pipe mesh (the JAX ``setup_pipeline``): the
    OPT decoder cut to this rank's stage, its L/S contiguous layers kept
    and the others freed, the adapters likewise (keyed by their global
    index); vision, Q-Former and projection whole. Returns the model."""
    from ..parallel import pp
    from ..parallel.mesh import PIPE_AXIS

    n, stage = mesh.size(PIPE_AXIS), mesh.coord(PIPE_AXIS)
    layers = model.cfg.opt.layers
    pp.stage_layers_(model.opt, n, stage)
    if model.lora is not None:
        pp.stage_lora_(model.lora, layers, n, stage)
    return model


def vlm_multihost_mesh_check(mesh, args) -> None:
    """What stays one-process (the JAX package's
    ``vlm_multihost_mesh_check`` and its CLI guards): multi-token
    generation in ``cli.blip2_test`` over a data axis of several ranks
    (the JAX rule is for multi-host data sharding; ``data:1,model:M``
    generates, and so does a pipe mesh with its data axis: JAX runs pipe
    meshes in one process); ``--fsdp`` (the JAX VLM trainers do not
    shard their weights either)."""
    if getattr(args, "fsdp", False):
        raise NotImplementedError(
            "--fsdp shards the engine trainers' weights (main_both, "
            "main_text, main_image); the VLM trainers keep theirs whole, as "
            "the JAX package's do")
    if mesh.size("data") > 1 and mesh.size("pipe") == 1 \
            and getattr(args, "max_new_tokens", 1) > 1:
        raise SystemExit("--max_new_tokens > 1 runs on one data rank, as in "
                         "the JAX package; use --mesh_shape=data:1,model:M "
                         "or drop torchrun")


def vlm_eval(step, batcher: Blip2Batcher, batch_size: int, device,
             prefetch_depth: int = 2, mesh=None):
    """The VLM eval loop: ``step(batch) -> (preds, masked correct count)``
    over every batch of the test set; accuracy over the real dataset size
    (not the reference's hard-coded 2000). Returns (acc %, labels, preds,
    stats), padding rows masked out; with a `mesh` of several ranks each
    evaluates its rows and every rank gets the whole result."""
    return run_eval(step, batcher, batch_size, device,
                    keys=("image", "input_ids", "attention_mask", "label",
                          "valid"), prefetch_depth=prefetch_depth, mesh=mesh)


def iter_accum_windows(batcher, batch_size: int, acc_steps: int, *,
                       shuffle: bool = False, seed: int = 0, rows=None):
    """Stacked [W, ...] host windows of microbatches: W == acc_steps, and
    one trailing partial window (the JAX ``iter_accum_windows``). `rows`:
    a rank's rows of each global batch."""
    stack = []
    share = {} if rows is None else {"rows": rows}
    for batch in batcher.iter_batches(batch_size, shuffle=shuffle,
                                      seed=seed, **share):
        stack.append(batch)
        if len(stack) == acc_steps:
            yield {k: np.stack([b[k] for b in stack]) for k in stack[0]}
            stack = []
    if stack:
        yield {k: np.stack([b[k] for b in stack]) for k in stack[0]}


def vlm_train_stream(batcher, batch_size: int, acc_steps: int, device, *,
                     seed: int, prefetch_depth: int = 2, skip: int = 0,
                     epoch: int = 0, mesh=None):
    """The trainers' input stream: ``iter_accum_windows`` shuffled with
    `seed`, moved to `device` ahead of use. `skip`: the windows of `epoch`
    a mid-epoch RESUME has done, dropped from the host stream (the same
    again for the same seed); more than the epoch holds is a stale RESUME,
    a ``SystemExit`` with the JAX trainers' words. With a `mesh` of
    several ranks a rank's windows hold its rows of the global plan; the
    trailing window stays partial, as in one process (the JAX multi-host
    stream pads it with valid = 0 microbatches instead, which changes only
    that window's logged loss)."""
    from ..data.pipeline import to_device

    rows = (mesh.local_rows(batch_size)
            if mesh is not None and mesh.distributed else None)
    host = iter_accum_windows(batcher, batch_size, acc_steps, shuffle=True,
                              seed=seed, rows=rows)
    if skip:
        n_windows = math.ceil(math.ceil(len(batcher.m) / batch_size)
                              / acc_steps)
        if skip > n_windows:
            raise SystemExit(
                f"RESUME step {skip} > {n_windows} optimizer "
                f"windows in epoch {epoch} — stale RESUME dir or "
                "changed --batch_size/dataset? Delete the RESUME "
                "directory to start the epoch over.")
        host = itertools.islice(host, skip, None)
    return to_device(host, device, depth=prefetch_depth)


@dataclass
class VlmResume:
    """Where a VLM trainer starts: from scratch, or from the RESUME file
    ``--resume_from`` names (the JAX trainers' full resume). ``epoch`` is
    the first epoch to run, ``step`` the windows of it already done (a
    mid-epoch save), ``losses`` their losses, ``key`` the key's seed to
    carry on with (None: the trainer's own)."""

    epoch: int = 0
    step: int = 0
    losses: List[float] = field(default_factory=list)
    best: PhaseResult = field(
        default_factory=lambda: PhaseResult(0.0, 0, None))
    key: Optional[int] = None

    @classmethod
    def load(cls, path: str, trainable: torch.nn.Module,
             optimizer: torch.optim.Optimizer, mesh=None) -> "VlmResume":
        """Restore `trainable` (the adapters or the classifier) and
        `optimizer` from the RESUME file `path` names; a start from
        scratch when `path` names none. With a `mesh` the ranks must agree
        on the file (``engine.check_resume_agreement``). A pipe run's file
        (meta ``pipe``: its stages' adapters merged, each stage's
        optimizer state) resumes at the same pipe size only, each stage
        taking its own; the JAX trainer's words refuse the others."""
        from ..train.engine import check_resume_agreement

        payload = maybe_load_resume(path)
        n_pipe = 1 if mesh is None else mesh.size("pipe")
        if payload is not None:
            saved = int(payload["meta"].get("pipe", 1))
            if n_pipe > 1 and saved == 1:
                raise SystemExit(
                    "--resume_from payload is per-layer (saved by a dp/tp "
                    "run); resume with the same --mesh_shape")
            if n_pipe == 1 and saved > 1:
                raise SystemExit(
                    "--resume_from payload is stage-stacked (saved by a "
                    "pipe:N run); resume with the same --mesh_shape")
            if saved != n_pipe:
                raise SystemExit(
                    f"--resume_from was saved with pipe:{saved}; resume "
                    f"with the same mesh (got pipe:{n_pipe})")
        if mesh is not None:
            check_resume_agreement(payload, mesh)
        if payload is None:
            return cls()
        state, opt_state = payload["state_dict"], payload["optimizer"]
        if n_pipe > 1:
            mine = trainable.state_dict()
            state = {k: v for k, v in state.items() if k in mine}
            opt_state = opt_state["stages"][mesh.coord("pipe")]
        load_model_state(trainable, state)
        load_optimizer_state(optimizer, opt_state)
        m = payload["meta"]
        step = int(m.get("step") or 0)
        print(f"Full-resume from {path} (epoch={m['epoch']}"
              + (f" step {step}" if step else "") + ")")
        return cls(epoch=int(m["epoch"]) + (0 if step else 1), step=step,
                   losses=[float(l) for l in m.get("losses") or ()],
                   best=PhaseResult(float(m["best_val_acc"]),
                                    int(m["best_epoch"]),
                                    m["best_path"] or None),
                   key=int(m["key"]))

    def skip(self, epoch: int) -> int:
        return self.step if epoch == self.epoch else 0

    def epoch_losses(self, epoch: int) -> list:
        """The losses `epoch` starts with: the saved ones on re-entry."""
        return list(self.losses) if self.skip(epoch) else []


def make_accum_step(loss_fn, optimizer: torch.optim.Optimizer,
                    acc_steps: int, with_key: bool = False, mesh=None,
                    model_partial: bool = False):
    """The grad-accumulating optimizer step of both VLM trainers (the JAX
    ``make_accum_step``; they differ only in the loss).

    ``loss_fn(microbatch)``, or ``loss_fn(microbatch, key)`` with
    `with_key`, gives (scalar mean loss whose graph reaches the
    optimizer's parameters, its denominator: the counted tokens or the
    summed class weights). With a `mesh` of several ranks each microbatch
    holds this rank's rows: the denominators are all-reduced before the
    backward, which runs on ``loss * weight / global weight`` (the ranks'
    sum is the global microbatch's mean), under ``core.batch_shard``, and
    the gradients are all-reduced once after the window, over the data
    axis, and with `model_partial` (the LoRA adapters of a tower sliced
    over the model axis: each rank's gradients hold its heads' share)
    over the model axis as well. Returns
    ``step(window, key=None) -> mean loss`` over a
    window of W <= acc_steps microbatches (a leading axis on every entry):
    each microbatch's backward adds its gradient into the fp32 sums held
    in ``.grad``, the sums are divided by `acc_steps` (a trailing partial
    window too: reference blip_2_training.py:274-293 steps every acc_steps
    batches with loss / acc_steps), and the optimizer steps once. A
    parameter no gradient reached gets zeros, as the JAX tree does.
    Microbatch i draws its dropout from ``key.fold_in(i)``."""
    from ..parallel.multihost import all_reduce_sum_

    params = [p for g in optimizer.param_groups for p in g["params"]]
    dp = mesh is not None and mesh.size("data") > 1
    tp = model_partial and mesh is not None and mesh.size("model") > 1

    def step(window, key=None):
        w = window["valid"].shape[0]
        for p in params:
            p.grad = None
        loss_sum = None
        for i in range(w):
            mb = {k: v[i] for k, v in window.items()}
            # also under a caller's no_grad
            with torch.enable_grad(), batch_shard(mesh):
                loss, weight = loss_fn(mb, key.fold_in(i)) if with_key \
                    else loss_fn(mb)
                if dp:
                    tot = torch.stack([loss.detach().float() * weight,
                                       weight.float()])
                    all_reduce_sum_([tot], group=mesh.group("data"))
                    glob = torch.clamp(tot[1], min=1e-30)
                    (loss * (weight / glob)).backward()
                    loss = tot[0] / glob
                else:
                    loss.backward()
            loss = loss.detach().float()
            loss_sum = loss if loss_sum is None else loss_sum + loss
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if dp:
            all_reduce_sum_([p.grad for p in params],
                            group=mesh.group("data"))
        if tp:
            all_reduce_sum_([p.grad for p in params],
                            group=mesh.group("model"))
        for p in params:
            p.grad.div_(acc_steps)
        optimizer.step()
        return loss_sum / w

    return step
