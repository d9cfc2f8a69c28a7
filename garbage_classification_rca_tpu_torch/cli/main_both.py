"""Multimodal training CLI — every late-fusion strategy on every tower the
JAX package trains it on.

``python -m garbage_classification_rca_tpu_torch.cli.main_both
  --late_fusion=MM_RCA --reverse --text_model=distilbert
  --dataset_folder_name=<base> [flags]``
reads ``<base>_Train`` and ``<base>_Val``, and runs the two phases of the
JAX package's ``cli/main_both.py``: the heads with both towers frozen (in
the optimizer only: every gradient is computed) for ``--epochs``, then
everything at lr / ``--fraction_lr`` with ReduceLROnPlateau (factor 0.4)
for ``--ft_epochs``. Each epoch logs a JSONL row under ``runs/`` with the
val accuracy of both modalities and of each alone, and writes a BEST
checkpoint under ``model_weights/`` when val accuracy improves (the
port's ``cli.test_both`` loads it), and after every epoch (and every
``--resume_every_steps`` optimizer windows) the full training state in
``model_weights/<late_fusion>_<text_model>/RESUME``, from which
``--model_path=.../RESUME`` continues a killed run. ``--late_fusion``:
gated, classic, normalized and clip on DistilBERT, BERT and BART-large;
hierarchical, bimodal and MM_RCA on DistilBERT and BERT (the other pairs
raise the JAX package's ValueError). ``clip`` validates at exactly
``--batch_size`` (its head is a Linear of that width), every other
strategy at ``--eval_batch_size`` (32 by default).

Same flags as the JAX CLI; fp32 master weights (``--param_dtype``
overrides) and images in ``--compute_dtype``. The model is trained
unfolded; val evals run in eval mode under no_grad. Runs on CUDA;
``GC_RCA_PLATFORM=cpu`` runs it on the CPU, and ``GC_RCA_MM_IMAGE_SIZE``
shrinks the 480x480 input for small drives. ``--hf_internal_dropout``
switches on the text tower's own p = 0.1 dropout sites (on DistilBERT /
BERT the dropout attention kernels). Flags of paths not ported yet raise
NotImplementedError: --wandb, --fsdp, --mesh_shape other than one device
and multi-host runs.
"""

from __future__ import annotations

import os

import torch

from ..config import LATE_FUSION_STRATEGIES, MULTIMODAL_IMAGE_SIZE, \
    args_parser, torch_compute_dtype
from ..data.augment import augment_batch
from ..data.images import normalize_on_device
from ..data.manifest import build_manifest
from ..data.pipeline import ImageTextBatcher
from ..data.tokenizer import DEFAULT_SEQ_LEN, get_tokenizer, resolve_vocab_dir
from ..device import resolve_device
from ..eval.harness import run_eval
from ..eval.report import classification_report_dict
from ..models.fusion.multimodal import (FusionModel, build_fusion_model,
                                        check_config)
from ..train.engine import (BATCH_KEYS, MetricsLogger, ResumePlan,
                            load_model_state, run_phase)
from ..train.loop import make_train_step
from ..train.optim import PlateauScheduler, make_optimizer
from ..utils.dtype import cast_for_training
from . import check_unported_flags, cli_device, test_both
from .test_both import fusion_config_from_args

TRAIN_SUFFIX = "_Train"
VAL_SUFFIX = "_Val"
# phase-1 trainable parameters: everything except the two towers
TOWER_KEYS = ("text", "image")


def _image_size():
    """480x480; GC_RCA_MM_IMAGE_SIZE overrides for small drives."""
    env = os.environ.get("GC_RCA_MM_IMAGE_SIZE")
    return (int(env), int(env)) if env else MULTIMODAL_IMAGE_SIZE


def fusion_head_mask(model: torch.nn.Module):
    return {n: n.split(".")[0] not in TOWER_KEYS
            for n, _ in model.named_parameters()}


def load_model(args, cfg, device, resume=None) -> FusionModel:
    """fp32 (or --param_dtype) model on `device`: from a RESUME payload
    (in its own dtype unless --param_dtype is given), from --model_path (a
    BEST checkpoint of this trainer or a reference all-heads .pth), or
    random from --seed."""
    if resume is not None:
        model = FusionModel(cfg, text_layers=resume["meta"]["layers"])
        load_model_state(model, resume["state_dict"])
        model.to(device).eval()
    elif args.model_path:
        model = test_both.load_model(args.model_path, cfg, device)
        print(f"Warm-started from {args.model_path}")
    else:
        model = build_fusion_model(
            cfg, device=device,
            generator=torch.Generator().manual_seed(args.seed))
    cast_for_training(args, model, resume is not None)
    return model


def main(argv=None):
    args = args_parser(argv)
    if args.opt not in ("sgd", "adamw"):
        print("Invalid optimizer!")   # reference wording, main_image.py:536
        raise SystemExit(1)
    if args.late_fusion not in LATE_FUSION_STRATEGIES:
        print("Wrong late fusion strategy: ", args.late_fusion)
        raise SystemExit(1)
    cfg = fusion_config_from_args(args)
    check_config(cfg)
    check_unported_flags(args)
    device = resolve_device(cli_device())
    dtype = torch_compute_dtype(args.compute_dtype)

    train_manifest = build_manifest(args.dataset_folder_name + TRAIN_SUFFIX,
                                    extended_desc=args.extended_desc_train)
    val_manifest = build_manifest((args.dataset_folder_name_val or
                                   args.dataset_folder_name) + VAL_SUFFIX,
                                  extended_desc=args.extended_desc_val)
    print(f"Len of train set: {len(train_manifest)}")
    print(f"Len of val set: {len(val_manifest)}")
    class_weights = (torch.tensor(train_manifest.class_weights(),
                                  dtype=torch.float32, device=device)
                     if args.balance_weights else None)
    tok = get_tokenizer(args.text_model, vocab_dir=resolve_vocab_dir(args))
    seq_len = args.seq_len or DEFAULT_SEQ_LEN
    train_batcher = ImageTextBatcher(
        train_manifest, _image_size(), tokenizer=tok, seq_len=seq_len,
        extended_desc=args.extended_desc_train is not None,
        workers=args.data_workers)
    val_batcher = ImageTextBatcher(
        val_manifest, _image_size(), tokenizer=tok, seq_len=seq_len,
        extended_desc=args.extended_desc_val is not None,
        workers=args.data_workers)
    plan = ResumePlan(args.model_path)
    model = load_model(args, cfg, device, plan.resume)

    def batch_to_inputs(mb, key):
        x = mb["image"]
        if args.prob_aug > 0:
            x = augment_batch(x, args.prob_aug, key.generator(x.device))
        return (mb["input_ids"], mb["attention_mask"],
                normalize_on_device(x, dtype=dtype))

    def make_step(lr, trainable=None):
        opt = make_optimizer(args.opt, model.named_parameters(), lr,
                             args.reg, trainable)
        return opt, make_train_step(model, opt,
                                    batch_to_inputs=batch_to_inputs,
                                    class_weights=class_weights,
                                    label_smoothing=args.label_smoothing)

    # the CLIP head is a Linear of width --batch_size: it validates at
    # exactly that batch (the padded tail keeps the pad hack from firing)
    eval_bs = (cfg.batch_size if cfg.strategy == "clip" else
               max(1, min(args.eval_batch_size or 32, len(val_manifest))))

    def mode_eval(model, remove_image=False, remove_text=False,
                  with_report=False):
        step = test_both.make_both_eval_step(model, dtype,
                                             remove_image=remove_image,
                                             remove_text=remove_text)
        acc, labels, preds, _ = run_eval(step, val_batcher, eval_bs, device,
                                         keys=BATCH_KEYS, progress=False,
                                         prefetch_depth=args.prefetch_depth)
        if with_report:
            return acc, classification_report_dict(labels, preds)
        return acc

    extra_evals = {
        "val_acc_image_only": lambda m: mode_eval(m, remove_text=True),
        "val_acc_text_only": lambda m: mode_eval(m, remove_image=True),
    }
    model_name = f"{args.late_fusion}_{args.text_model}"
    logger = MetricsLogger(args.name or f"both_{model_name}")
    common = dict(model=model, eval_fn=lambda m: mode_eval(
        m, with_report=True), batcher=train_batcher, args=args,
        model_name=model_name, logger=logger, device=device,
        balanced_sampler=args.balanced_sampler, extra_evals=extra_evals,
        keep_top_k=3, save_resume=True, resume=plan)

    opt, step = make_step(args.lr, fusion_head_mask(model))
    best = run_phase(phase_name="train", epochs=args.epochs, optimizer=opt,
                     train_step=step, batch_size=args.batch_size,
                     acc_steps=args.acc_steps, **common)
    if args.ft_epochs > 0:
        ft_lr = args.lr / args.fraction_lr
        opt, step = make_step(ft_lr)
        best = run_phase(phase_name="fine_tune", epochs=args.ft_epochs,
                         optimizer=opt, train_step=step,
                         batch_size=args.batch_size_FT,
                         acc_steps=args.acc_steps_FT,
                         scheduler=PlateauScheduler(ft_lr, factor=0.4),
                         best=best, fine_tuning=True, **common)
    train_batcher.close()
    val_batcher.close()
    print(f"Best epoch: {best.best_epoch}, best val acc: "
          f"{best.best_val_acc:.5f}")
    return best


if __name__ == "__main__":
    main()
