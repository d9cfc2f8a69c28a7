"""Image-model training CLI.

``python -m garbage_classification_rca_tpu_torch.cli.main_image
  --image_model=transformer_B16 --dataset_folder_name=<base> [flags]``
reads ``<base>_Train`` and ``<base>_Val`` class folders and runs the two
phases of the JAX package's ``cli/main_image.py``: ``--epochs`` on the
head only with ``--tl`` (frozen in the optimizer: every gradient is
computed), else on everything; then everything at lr / ``--fraction_lr``
with ReduceLROnPlateau (factor 0.2) for ``--ft_epochs``. Batch sizes
default to the arch's (``config.IMAGE_ARCHS``). Train-time augmentation
runs on the device inside the step (``data/augment.py``) at ``--prob_aug``.
Each epoch evaluates the val set, logs a JSONL row under ``runs/`` and
writes a BEST checkpoint under ``model_weights/<image_model>/`` when val
accuracy improves (the port's ``cli.test_image`` loads it).

Same flags as the JAX CLI. Images in ``--compute_dtype`` over fp32 master
weights (``--param_dtype`` overrides). ``--model_path`` warm-starts from a
torchvision-layout ``.pth`` or a BEST checkpoint of this trainer; pointed
at ``model_weights/<image_model>/RESUME``, which both phases write after
every epoch (and every ``--resume_every_steps`` optimizer windows), it
continues the killed run where it stopped. Image models: every name of
``config.IMAGE_ARCHS``: transformer_B16 and transformer_L16 (their
attention trains through the flash pair ``mha_flash_train``) and the 12
conv backbones (cuDNN convolutions; BatchNorm on batch statistics, its
running statistics fp32; the val eval runs the unfolded model on them).
Runs on CUDA; ``GC_RCA_PLATFORM=cpu`` runs it on the CPU. Not ported yet
(NotImplementedError): ``--calculate_dataset_stats``, --wandb, --fsdp,
--mesh_shape other than one device, multi-host runs.
"""

from __future__ import annotations

import torch

from .. import NUM_CLASSES
from ..config import IMAGE_ARCHS, args_parser, torch_compute_dtype
from ..data.augment import augment_batch
from ..data.images import normalize_on_device
from ..data.manifest import build_manifest
from ..data.pipeline import ImageTextBatcher
from ..device import resolve_device
from ..eval.harness import run_image_eval
from ..eval.report import classification_report_dict
from ..models.registry import get_image_model
from ..train.engine import MetricsLogger, ResumePlan, run_phase
from ..train.loop import all_trainable_mask, head_only_mask, make_train_step
from ..train.optim import PlateauScheduler, make_optimizer
from ..utils.dtype import cast_for_training
from . import (check_unported_flags, cli_device, load_unimodal_model,
               model_from_payload, resolve_model)

TRAIN_SUFFIX = "_Train"
VAL_SUFFIX = "_Val"
IMAGE_KEYS = ("image", "label", "valid")

# head subtrees that stay trainable in phase 1: exactly the replaced
# classifier Linear per arch
HEAD_KEYS = {
    "mb": ("fc2",),
    "default": ("classifier", "fc", "head"),
}


def head_keys_for(arch: str):
    return HEAD_KEYS.get(arch, HEAD_KEYS["default"])


def main(argv=None):
    args = args_parser(argv)
    if args.opt not in ("sgd", "adamw"):
        print("Invalid optimizer!")   # reference wording, main_image.py:536
        raise SystemExit(1)
    if args.hf_internal_dropout:
        # the flag reproduces HF-*text*-encoder-internal dropout; the image
        # towers have no such sites, so accepting it here would be a silent
        # no-op
        raise SystemExit(
            "--hf_internal_dropout has no effect on image-only training "
            "(it reproduces the HF text/VLM encoders' internal train-mode "
            "dropout) — it is consumed by main_text/main_both/blip2_train/"
            "qformer_train only. Remove the flag.")
    mdef = resolve_model(get_image_model, args.image_model)
    check_unported_flags(args)
    if args.calculate_dataset_stats:
        raise NotImplementedError(
            "--calculate_dataset_stats is not ported to PyTorch yet: it "
            "needs cli/calculate_mean_std.py (ROADMAP.md, queue 1 item 8)")
    spec = IMAGE_ARCHS[args.image_model]
    batch_size = args.batch_size or spec.train_batch
    ft_batch = args.batch_size_FT or spec.ft_batch
    device = resolve_device(cli_device())
    dtype = torch_compute_dtype(args.compute_dtype)

    train_manifest = build_manifest(args.dataset_folder_name + TRAIN_SUFFIX,
                                    extended_desc=args.extended_desc_train)
    val_manifest = build_manifest((args.dataset_folder_name_val or
                                   args.dataset_folder_name) + VAL_SUFFIX,
                                  extended_desc=args.extended_desc_val)
    print(f"Len of train set: {len(train_manifest)}")
    print(f"Len of val set: {len(val_manifest)}")
    print(f"Class weights: {train_manifest.class_weights()}")
    class_weights = (torch.tensor(train_manifest.class_weights(),
                                  dtype=torch.float32, device=device)
                     if args.balance_weights else None)

    plan = ResumePlan(args.model_path)
    if plan.resume is not None:
        # full resume: the model here; optimizer, scheduler, epoch and key
        # in run_phase
        model = model_from_payload(mdef, plan.resume, device)
    elif args.model_path:
        model = load_unimodal_model(
            mdef, args.model_path, f"--image_model={args.image_model}",
            device)
        print(f"Warm-started from {args.model_path}")
    else:
        model = mdef.build(NUM_CLASSES, generator=torch.Generator()
                           .manual_seed(args.seed)).to(device).eval()
    # fp32 master weights unless --param_dtype overrides; a full resume
    # keeps the checkpoint's dtype when the flag is left empty
    cast_for_training(args, model, plan.resume is not None)

    train_batcher = ImageTextBatcher(train_manifest, spec.input_size,
                                     workers=args.data_workers)
    val_batcher = ImageTextBatcher(val_manifest, spec.input_size,
                                   workers=args.data_workers)

    def batch_to_inputs(mb, key):
        x = mb["image"]
        if args.prob_aug > 0:
            x = augment_batch(x, args.prob_aug, key.generator(x.device))
        return (normalize_on_device(x, dtype=dtype),)

    def make_step(mask, lr):
        opt = make_optimizer(args.opt, model.named_parameters(), lr,
                             args.reg, mask)
        return opt, make_train_step(model, opt,
                                    batch_to_inputs=batch_to_inputs,
                                    class_weights=class_weights,
                                    label_smoothing=args.label_smoothing)

    eval_bs = max(1, min(args.eval_batch_size or spec.eval_batch,
                         len(val_manifest)))

    def eval_fn(model):
        acc, labels, preds, _ = run_image_eval(
            model, val_batcher, eval_bs, device, dtype, progress=False,
            prefetch_depth=args.prefetch_depth)
        return acc, classification_report_dict(labels, preds)

    logger = MetricsLogger(args.name or f"image_{args.image_model}")
    common = dict(model=model, eval_fn=eval_fn, batcher=train_batcher,
                  args=args, model_name=args.image_model, logger=logger,
                  device=device, balanced_sampler=args.balanced_sampler,
                  keep_top_k=3, keys=IMAGE_KEYS, save_resume=True,
                  resume=plan, layers=None if mdef.depth else 0)

    # phase 1: frozen backbone iff --tl
    mask = head_only_mask(model, head_keys_for(args.image_model)) \
        if args.tl else all_trainable_mask(model)
    opt, step = make_step(mask, args.lr)
    best = run_phase(phase_name="train", epochs=args.epochs, optimizer=opt,
                     train_step=step, batch_size=batch_size,
                     acc_steps=args.acc_steps, **common)
    # phase 2: everything at lr / fraction_lr with plateau scheduling
    if args.ft_epochs > 0:
        ft_lr = args.lr / args.fraction_lr
        opt, step = make_step(all_trainable_mask(model), ft_lr)
        best = run_phase(phase_name="fine_tune", epochs=args.ft_epochs,
                         optimizer=opt, train_step=step, batch_size=ft_batch,
                         acc_steps=args.acc_steps_FT,
                         scheduler=PlateauScheduler(ft_lr, factor=0.2),
                         best=best, fine_tuning=True, **common)
    train_batcher.close()
    val_batcher.close()
    print(f"Best epoch: {best.best_epoch}, best val acc: "
          f"{best.best_val_acc:.5f}")
    return best


if __name__ == "__main__":
    main()
