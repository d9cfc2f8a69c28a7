"""BLIP-2 LoRA fine-tuning CLI.

``python -m garbage_classification_rca_tpu_torch.cli.blip2_train
  --dataset_folder_name=<base with _Train / _Val> [--model_path=<HF .pth>]
  [--batch_size=16] [--epochs=N] [--hf_internal_dropout]``

The port of the JAX package's ``cli/blip2_train.py`` (reference
blip_2_training.py:176-311), on one device:
  * the knowledge prompt of each image, left-padded to 100 tokens, and the
    answer word's 4 label tokens after it (N = 32 + 100 + 4 = 136 in OPT);
  * LoRA r = 32, alpha = 8 on OPT's q / k projections: only the fp32
    adapters train, EVA ViT-g, the Q-Former, the projection and OPT stay
    frozen;
  * the loss is the shifted next-token CE over the text segment, -100 on
    the prompt, on pad label tokens and on rows with valid = 0
    (``_assemble_lm_batch``, ``models.vlm.blip2.lm_loss``);
  * AdamW(lr 5e-4, eps 1e-5, weight decay 0.01), stepping every 8
    microbatches of ``--batch_size`` (``blip2_common.make_accum_step``);
  * after each epoch the validation accuracy of the 1-token constrained
    decode (``make_eval_step``), a JSONL row under ``runs/``, and the
    adapters saved as a BEST file (``model_weights/blip2_lora/``, the
    adapters alone, as the JAX trainer saves only the trained leaves)
    when the accuracy improves; ``cli.blip2_test --model_path=<BEST>``
    reads it;
  * ``model_weights/blip2_lora/RESUME`` after each epoch and every
    ``--resume_every_steps`` windows: the adapters, AdamW's state, the
    key, epoch, step, the epoch's losses so far and the best;
    ``--resume_from=.../RESUME`` continues from it bit for bit, past the
    completed windows of a mid-epoch save (``--model_path`` stays the HF
    base checkpoint);
  * ``--hf_internal_dropout``: the Q-Former's p = 0.1 sites, OPT's p = 0.1
    sites on the attention and FFN outputs and peft's lora_dropout 0.05,
    with a key per microbatch folded from the window's.

On the card each microbatch runs K2 39 times (EVA, head dim 88), K4a 32
times and K4b 32 times (OPT, head dim 80, causal with the key mask). Runs
on CUDA; ``GC_RCA_PLATFORM=cpu`` runs it on the CPU; over N GPUs with
``torchrun --nproc_per_node=N --mesh_shape=data:N`` (``--batch_size`` the
global microbatch), and with the OPT tower sliced over a model axis
(``--mesh_shape=data:D,model:M`` over D x M ranks, ``parallel/tp.py``):
K4a / K4b run each rank's 32 / M heads, the adapters stay whole on every
rank and their gradients are summed over the model group.

``--mesh_shape=data:D,pipe:S`` over D x S ranks on one host GPipe-trains
the adapters (``parallel/pp.py``): each rank holds one stage's 32 / S
layers and their adapters, EVA, the Q-Former and the projection run on
stage 0, each microbatch splits into ``pick_pp_microbatches`` pipeline
microbatches (K4a / K4b at their rows, the layers recomputed in the
backward), the loss is logged on every rank. RESUME holds each stage's
adapters and AdamW state and resumes at the same pipe size; BEST is
gathered into the per-layer form, which ``cli.blip2_test`` reads at any
mesh. ``--hf_internal_dropout`` is refused on a pipe mesh, as in the JAX
CLI. Not ported yet (``cli.check_unported_flags`` raises): the expert
axis and ``--wandb``; ``--fsdp`` raises, as the JAX trainer does not
shard the VLM either.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..config import args_parser, torch_compute_dtype
from ..data.manifest import build_manifest
from ..models.vlm import blip2
from ..nn.core import HFDropout, Key
from ..train.engine import (MetricsLogger, PhaseResult, save_best,
                            save_train_state)
from . import check_unported_flags, data_mesh
from .blip2_common import (Blip2Batcher, VlmResume, build_blip2,
                           check_pipe_flags, class_logits_from_next_token,
                           make_accum_step, normalize_clip, place_blip2,
                           setup_pipeline, vlm_eval,
                           vlm_multihost_mesh_check, vlm_train_stream)

TRAIN_SUFFIX = "_Train"
VAL_SUFFIX = "_Val"
BLIP2_LR = 5e-4          # reference blip_2_training.py:228
BLIP2_ACC = 8            # reference :229
PAD_ID = 1               # OPT's pad token


def _assemble_lm_batch(mb, compute_dtype):
    """Microbatch dict of device tensors -> (pixels, ids, mask, labels) of
    the LM CE: ids are the prompt then the label tokens; the labels are
    -100 on the prompt, on pad label tokens and on rows with valid = 0
    (the batch padding of a tail microbatch)."""
    x = normalize_clip(mb["image"], compute_dtype)
    lt = mb["label_tokens"]
    pad = lt == PAD_ID
    if "valid" in mb:
        pad = pad | (mb["valid"][:, None] == 0)
    labels = torch.where(pad, -100, lt)
    ids = torch.cat([mb["input_ids"], lt], 1)
    mask = torch.cat([mb["attention_mask"],
                      (lt != PAD_ID).to(mb["attention_mask"].dtype)], 1)
    full_labels = torch.cat([torch.full_like(mb["input_ids"], -100),
                             labels], 1)
    return x, ids, mask, full_labels


def blip2_adamw(params) -> torch.optim.AdamW:
    """Reference ``torch.optim.AdamW(lr=5e-4, eps=1e-05)`` with torch's
    default weight decay 0.01 (the JAX trainer spells all three out)."""
    return torch.optim.AdamW(params, lr=BLIP2_LR, betas=(0.9, 0.999),
                             eps=1e-5, weight_decay=0.01, foreach=True)


def make_lora_train_step(model, acc_steps: int = BLIP2_ACC,
                         compute_dtype=torch.bfloat16,
                         hf_internal_dropout: bool = False, mesh=None):
    """-> (optimizer, ``step(window, key) -> mean loss``): the adapters of
    `model` (fp32) train, everything else stays frozen; one AdamW step a
    window of microbatches (``make_accum_step``). With
    `hf_internal_dropout` microbatch i draws its dropout sites from
    ``key.fold_in(i)``; without it the key is not read. `mesh`: a
    run's ``DataMesh``: the data axis, and the model axis of a tower that
    ``place_blip2`` sliced (the adapters' gradients summed over it)."""
    model.requires_grad_(False)
    model.lora.requires_grad_(True)
    opt = blip2_adamw(model.lora.parameters())

    def loss_fn(mb, key=None):
        x, ids, mask, labels = _assemble_lm_batch(mb, compute_dtype)
        drop = HFDropout(key) if key is not None else None
        return (blip2.lm_loss(model, x, ids, mask, labels, drop=drop),
                (labels[:, 1:] != -100).sum())

    return opt, make_accum_step(loss_fn, opt, acc_steps,
                                with_key=hf_internal_dropout, mesh=mesh,
                                model_partial=True)


def make_eval_step(model, answer_first_tokens, compute_dtype=torch.bfloat16):
    """``step(batch of device tensors) -> (preds int32 [B], masked correct
    count)``: next-token logits at each row's last valid prompt token,
    argmax over the four answer words' first tokens."""
    aft = torch.as_tensor(np.asarray(answer_first_tokens), dtype=torch.long)

    def step(batch):
        x = normalize_clip(batch["image"], compute_dtype)
        next_logits = blip2.next_token_logits(
            model, x, batch["input_ids"], batch["attention_mask"])
        cls_logits = class_logits_from_next_token(
            next_logits.float(), aft.to(next_logits.device))
        preds = cls_logits.argmax(dim=-1).to(torch.int32)
        correct = ((preds == batch["label"]) * batch["valid"]).sum()
        return preds, correct

    return step


def pick_pp_microbatches(batch_size: int, mesh) -> int:
    """The JAX rule: the largest pipeline microbatch count M <= 4x the
    pipe-axis size with batch % M == 0 and (batch / M) % data-axis == 0
    (the GPipe bubble M / (M + S - 1) shrinks with M; past 4S each
    microbatch only gets smaller)."""
    s, d = mesh.size("pipe"), mesh.size("data")
    for m in range(min(batch_size, 4 * s), 0, -1):
        if batch_size % m == 0 and (batch_size // m) % d == 0:
            return m
    return 1


def make_pp_lora_train_step(model, mesh, n_microbatches: int,
                            acc_steps: int = BLIP2_ACC,
                            compute_dtype=torch.bfloat16, remat: bool = True):
    """The GPipe twin of ``make_lora_train_step`` on a model that
    ``setup_pipeline`` cut to this rank's stage: the stage's adapters
    train (AdamW over them alone), the same window of ``acc_steps``
    microbatches and label semantics; each microbatch's loss is
    ``pp.pp_blip2_lm_loss`` over `n_microbatches` pipeline microbatches,
    whose backward is the GPipe backward."""
    from ..parallel import pp

    model.requires_grad_(False)
    model.lora.requires_grad_(True)
    opt = blip2_adamw(model.lora.parameters())

    def loss_fn(mb):
        x, ids, mask, labels = _assemble_lm_batch(mb, compute_dtype)
        return (pp.pp_blip2_lm_loss(model, x, ids, mask, labels, mesh,
                                    n_microbatches, remat=remat),
                (labels[:, 1:] != -100).sum())

    return opt, make_accum_step(loss_fn, opt, acc_steps, mesh=mesh)


def make_pp_eval_step(model, answer_first_tokens, mesh, n_microbatches: int,
                      compute_dtype=torch.bfloat16):
    """The pipelined twin of ``make_eval_step``: the answer words' logits
    on the last stage, broadcast over the pipe, so that every rank
    returns the same (preds, masked correct count)."""
    from ..parallel import pp
    from ..parallel.multihost import broadcast_from_

    aft = torch.as_tensor(np.asarray(answer_first_tokens), dtype=torch.long)

    def step(batch):
        x = normalize_clip(batch["image"], compute_dtype)
        logits = pp.pp_blip2_next_token_logits(
            model, x, batch["input_ids"], batch["attention_mask"], mesh,
            n_microbatches)
        cls_logits = torch.zeros((x.shape[0], len(aft)), dtype=torch.float32,
                                 device=x.device)
        if logits is not None:
            cls_logits = class_logits_from_next_token(
                logits.float(), aft.to(logits.device))
        broadcast_from_(cls_logits, mesh, "pipe")
        preds = cls_logits.argmax(dim=-1).to(torch.int32)
        correct = ((preds == batch["label"]) * batch["valid"]).sum()
        return preds, correct

    return step


def answer_first_token_table(batcher: Blip2Batcher, classes) -> np.ndarray:
    """First answer-word token id per class index (sorted-folder order)."""
    return np.asarray([batcher.answer_token_ids[c][1]
                       if len(batcher.answer_token_ids[c]) > 1
                       else batcher.answer_token_ids[c][0]
                       for c in classes], np.int32)


def main(argv=None):
    args = args_parser(argv)
    check_unported_flags(args, allowed=("model", "pipe"))
    n_pipe = check_pipe_flags(args)
    mesh = data_mesh(args, train_batches=(args.batch_size, args.batch_size, 0),
                     allowed=("model", "pipe"))
    vlm_multihost_mesh_check(mesh, args)
    device = mesh.device
    dtype = torch_compute_dtype(args.compute_dtype)
    cfg, model, tok = build_blip2(args, device, dtype, train=True)
    train_m = build_manifest(args.dataset_folder_name + TRAIN_SUFFIX)
    val_m = build_manifest((args.dataset_folder_name_val or
                            args.dataset_folder_name) + VAL_SUFFIX)
    print(f"train {len(train_m)} / val {len(val_m)}")
    train_b = Blip2Batcher(train_m, tok, workers=args.data_workers)
    val_b = Blip2Batcher(val_m, tok, workers=args.data_workers)
    aft = answer_first_token_table(train_b, train_m.classes)
    if n_pipe > 1:
        setup_pipeline(model, mesh)
        n_micro = pick_pp_microbatches(args.batch_size, mesh)
        print(f"GPipe over pipe:{n_pipe}, {n_micro} pipeline microbatches")
        opt, step = make_pp_lora_train_step(model, mesh, n_micro,
                                            compute_dtype=dtype)
        eval_step = make_pp_eval_step(model, aft, mesh, n_micro, dtype)
    else:
        place_blip2(model, mesh)
        opt, step = make_lora_train_step(
            model, compute_dtype=dtype,
            hf_internal_dropout=args.hf_internal_dropout, mesh=mesh)
        eval_step = make_eval_step(model, aft, dtype)
    logger = MetricsLogger(args.name or "blip2_lora")
    # the key is carried, split once a window, so RESUME saves it
    start = VlmResume.load(args.resume_from, model.lora, opt, mesh)
    best = start.best
    key = Key(args.seed if start.key is None else start.key)

    def save(**kw):
        extra = {}
        if n_pipe > 1:
            from ..parallel.pp import gather_pipeline_state

            state, stages = gather_pipeline_state(model.lora, opt, mesh)
            extra = {"state": state, "opt_state": {"stages": stages},
                     "extra_meta": {"pipe": n_pipe}}
        save_train_state(model=model.lora, optimizer=opt,
                         model_name="blip2_lora", phase_name="train",
                         scheduler=None, layers=cfg.opt.layers, **extra, **kw)

    try:
        for epoch in range(start.epoch, args.epochs):
            t0 = time.time()
            skip = start.skip(epoch)
            losses = start.epoch_losses(epoch)
            for done, window in enumerate(vlm_train_stream(
                    train_b, args.batch_size, BLIP2_ACC, device,
                    seed=args.seed + epoch, prefetch_depth=args.prefetch_depth,
                    skip=skip, epoch=epoch, mesh=mesh), skip + 1):
                key, step_key = key.split(2)
                losses.append(step(window, step_key))
                if args.resume_every_steps and \
                        done % args.resume_every_steps == 0:
                    save(key=key, epoch=epoch, best=best, step=done,
                         losses=losses)
            losses = [float(l) for l in losses]
            val_acc = vlm_eval(eval_step, val_b, args.batch_size, device,
                               prefetch_depth=args.prefetch_depth,
                               mesh=mesh)[0]
            logger.log({"epoch": epoch, "avg_loss": float(np.mean(losses)),
                        "val_acc": val_acc,
                        "epoch_time_seconds": time.time() - t0})
            print(f"epoch {epoch}: loss={np.mean(losses):.4f} "
                  f"val_acc={val_acc:.2f}")
            if val_acc > best.best_val_acc:
                if n_pipe > 1:
                    from ..parallel.pp import gather_pipeline_lora

                    adapters = gather_pipeline_lora(model.lora, mesh)
                else:
                    adapters = model.lora
                best = PhaseResult(val_acc, epoch, save_best(
                    adapters, model_name="blip2_lora", epoch=epoch,
                    val_acc=val_acc, args=args, fine_tuning=False,
                    layers=cfg.opt.layers))
            save(key=key, epoch=epoch, best=best)
    finally:
        train_b.close()
        val_b.close()
    print(f"best val acc {best.best_val_acc:.2f} @ epoch {best.best_epoch}")
    return best


if __name__ == "__main__":
    main()
