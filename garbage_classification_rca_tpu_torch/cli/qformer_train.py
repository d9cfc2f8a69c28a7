"""Q-Former classifier training CLI.

``python -m garbage_classification_rca_tpu_torch.cli.qformer_train
  --dataset_folder_name=<base with _Train / _Val> [--model_path=<HF .pth>]
  [--batch_size=16] [--epochs=N] [--hf_internal_dropout]``

The port of the JAX package's ``cli/qformer_train.py`` (reference
q_former_training.py:189-332): the frozen BLIP-2 backbone,
the Linear(768, 4) classifier on the Q-Former's first query output (read
in fp32), CE on the class ids over the valid rows, AdamW(lr 5e-4, eps
1e-5, weight decay 0.01) every 8 microbatches of ``--batch_size``
(``blip2_common.make_accum_step``). Only the classifier trains: the
reference's peft adapters sit on OPT, which this loss never reaches. After
each epoch the validation accuracy, a JSONL row under ``runs/``, and the
classifier saved as a BEST file (``model_weights/qformer_classifier/``)
when the accuracy improves; ``cli.qformer_test --classifier_weights=<BEST>``
reads it. ``--hf_internal_dropout`` runs the Q-Former's p = 0.1 sites,
with a key a window folded from ``--seed``, the epoch and the window.
``model_weights/qformer_classifier/RESUME`` is written after each epoch
and every ``--resume_every_steps`` windows (the classifier, AdamW's
state, epoch, step, the epoch's losses so far, the best);
``--resume_from=.../RESUME`` continues from it bit for bit: the window
keys are derived, not carried, so a mid-epoch resume draws the same.

On the card each microbatch runs K2 39 times (EVA, head dim 88). Runs on
CUDA; ``GC_RCA_PLATFORM=cpu`` runs it on the CPU; over N GPUs with
``torchrun --nproc_per_node=N --mesh_shape=data:N``; a model axis
(``data:D,model:M``) slices the OPT tower as the JAX trainer places it,
and the classifier and the Q-Former run whole on every rank. Not ported
yet (``cli.check_unported_flags`` raises): the pipe axis and ``--wandb``;
``--fsdp`` raises, as the JAX trainer does not shard either.
"""

from __future__ import annotations

import functools
import time

import numpy as np
import torch

from ..config import args_parser, torch_compute_dtype
from ..data.manifest import build_manifest
from ..models.vlm import blip2
from ..nn.core import HFDropout, Key
from ..train.engine import (MetricsLogger, PhaseResult, save_best,
                            save_train_state)
from ..train.loss import cross_entropy_loss_and_weight
from . import check_unported_flags, data_mesh
from .blip2_common import (Blip2Batcher, VlmResume, build_blip2,
                           make_accum_step, normalize_clip, place_blip2,
                           vlm_eval,
                           vlm_multihost_mesh_check, vlm_train_stream)
from .blip2_train import blip2_adamw

TRAIN_SUFFIX = "_Train"
VAL_SUFFIX = "_Val"
QF_ACC = 8               # reference q_former_training.py:241


def make_steps(model, acc_steps: int = QF_ACC, compute_dtype=torch.bfloat16,
               hf_internal_dropout: bool = False, mesh=None):
    """-> (optimizer, ``train_step(window, key) -> mean loss``,
    ``eval_step(batch) -> (preds, masked correct count)``): the
    classifier of `model` trains, the backbone stays frozen and runs
    without autograd. The reference's AdamW (q_former_training.py:243) is
    the LoRA trainer's."""
    model.requires_grad_(False)
    model.classifier.requires_grad_(True)
    opt = blip2_adamw(model.classifier.parameters())

    def loss_fn(mb, key=None):
        x = normalize_clip(mb["image"], compute_dtype)
        with torch.no_grad():
            feat = blip2.qformer_cls_feature(
                model, x, HFDropout(key) if key is not None else None)
        return cross_entropy_loss_and_weight(
            model.classifier(feat.float()), mb["label"], valid=mb["valid"])

    return opt, make_accum_step(loss_fn, opt, acc_steps,
                                with_key=hf_internal_dropout, mesh=mesh), \
        make_eval_step(model, compute_dtype)


def make_eval_step(model, compute_dtype=torch.bfloat16):
    """``step(batch of device tensors) -> (preds int32 [B], masked correct
    count)``; `model` carries its ``classifier``."""
    def step(batch):
        x = normalize_clip(batch["image"], compute_dtype)
        feat = blip2.qformer_cls_feature(model, x).float()
        preds = model.classifier(feat).argmax(dim=-1).to(torch.int32)
        correct = ((preds == batch["label"]) * batch["valid"]).sum()
        return preds, correct

    return step


def main(argv=None):
    args = args_parser(argv)
    check_unported_flags(args, allowed=("model",))
    mesh = data_mesh(args, train_batches=(args.batch_size, args.batch_size, 0),
                     allowed=("model",))
    vlm_multihost_mesh_check(mesh, args)
    device = mesh.device
    dtype = torch_compute_dtype(args.compute_dtype)
    _, model, tok = build_blip2(args, device, dtype, with_lora=False,
                                classifier=True)
    place_blip2(model, mesh)
    train_m = build_manifest(args.dataset_folder_name + TRAIN_SUFFIX)
    val_m = build_manifest((args.dataset_folder_name_val or
                            args.dataset_folder_name) + VAL_SUFFIX)
    train_b = Blip2Batcher(train_m, tok, workers=args.data_workers)
    val_b = Blip2Batcher(val_m, tok, workers=args.data_workers)
    opt, train_step, eval_step = make_steps(
        model, compute_dtype=dtype,
        hf_internal_dropout=args.hf_internal_dropout, mesh=mesh)
    logger = MetricsLogger(args.name or "qformer_cls")
    start = VlmResume.load(args.resume_from, model.classifier, opt, mesh)
    best = start.best
    # RESUME records the seed's key, as the JAX trainer's does
    save = functools.partial(
        save_train_state, model=model.classifier, optimizer=opt,
        model_name="qformer_classifier", phase_name="train", scheduler=None,
        layers=0, key=Key(args.seed))
    try:
        for epoch in range(start.epoch, args.epochs):
            t0 = time.time()
            skip = start.skip(epoch)
            losses = start.epoch_losses(epoch)
            for w, window in enumerate(vlm_train_stream(
                    train_b, args.batch_size, QF_ACC, device,
                    seed=args.seed + epoch, prefetch_depth=args.prefetch_depth,
                    skip=skip, epoch=epoch, mesh=mesh), skip):
                # the window's key, derived rather than carried (the JAX
                # trainer's fold_in(fold_in(seed, epoch), window))
                losses.append(train_step(
                    window, Key(args.seed).fold_in(epoch).fold_in(w)))
                if args.resume_every_steps and \
                        (w + 1) % args.resume_every_steps == 0:
                    save(epoch=epoch, best=best, step=w + 1, losses=losses)
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
                best = PhaseResult(val_acc, epoch, save_best(
                    model.classifier, model_name="qformer_classifier",
                    epoch=epoch, val_acc=val_acc, args=args,
                    fine_tuning=False, layers=0))
            save(epoch=epoch, best=best)
    finally:
        train_b.close()
        val_b.close()
    print(f"best val acc {best.best_val_acc:.2f} @ epoch {best.best_epoch}")
    return best


if __name__ == "__main__":
    main()
