"""Multimodal test-set evaluation CLI — the seven late-fusion strategies.

``python -m garbage_classification_rca_tpu_torch.cli.test_both
  --late_fusion=MM_RCA --reverse --text_model=distilbert
  --model_path=<ckpt.pth> --dataset_folder_name=<test-root>``
builds the fusion model of ``--late_fusion`` (gated by default; the
DistilBERT, BERT or BART-large tower of ``--text_model``), loads the
reference all-heads checkpoint (or a BEST checkpoint written by the
port's ``cli.main_both``), folds
the image tower's BatchNorm (eps 1e-3), casts the weights to the compute
dtype, evaluates with eval=True, and writes the confusion PNG + report CSV
under ``test_set_reports/<late_fusion>/``. ``clip`` evaluates at exactly
``--batch_size`` (its head is a Linear of that width; the padded tail
batch keeps the pad hack from firing), every other strategy at
``--eval_batch_size`` (128 by default). Same flags as the JAX package's
``cli/test_both.py``; one device (the mesh / multi-host branches and
orbax directories raise: not ported yet). Runs on CUDA; ``GC_RCA_PLATFORM=cpu`` runs it on the CPU.
"""

from __future__ import annotations

import os
import sys

import torch

from ..checkpoint.torch_convert import load_torch_state_dict
from ..config import (LATE_FUSION_STRATEGIES, MULTIMODAL_EVAL_BATCH,
                      MULTIMODAL_IMAGE_SIZE, args_parser, torch_compute_dtype)
from ..data.images import normalize_on_device
from ..data.manifest import build_manifest
from ..data.pipeline import ImageTextBatcher
from ..data.tokenizer import DEFAULT_SEQ_LEN, get_tokenizer, resolve_vocab_dir
from ..device import resolve_device
from ..eval.harness import run_eval
from ..eval.report import generate_report_and_image
from ..models.fusion.multimodal import (FusionConfig, FusionModel,
                                        check_config, convert_torch,
                                        load_fusion_model)
from ..nn.fold import fold_batchnorm
from ..train.engine import load_checkpoint
from . import check_eval_flags, cli_device

BASE_PATH = "./test_set_reports"


def fusion_config_from_args(args) -> FusionConfig:
    return FusionConfig(
        strategy=args.late_fusion,
        text_model_name=args.text_model,
        drop_ratio=args.model_dropout,
        image_or_text_dropout_chance=args.image_text_dropout,
        img_prob_dropout=args.image_prob_dropout,
        num_neurons_fc=args.num_neurons_FC,
        batch_size=args.batch_size,
        reverse=args.reverse,
        features_only=args.features_only,
        cross_attention_only=args.cross_attention_only,
        hf_internal_dropout=args.hf_internal_dropout,
    )


def make_both_eval_step(model, compute_dtype, *, remove_image=False,
                        remove_text=False):
    def step(batch):
        x = normalize_on_device(batch["image"], dtype=compute_dtype)
        logits = model(batch["input_ids"], batch["attention_mask"], x,
                       remove_image=remove_image, remove_text=remove_text)
        preds = logits.float().argmax(dim=-1).to(torch.int32)
        correct = ((preds == batch["label"]) * batch["valid"]).sum()
        return preds, correct

    return step


def run_multimodal_eval(model, batcher, batch_size, device,
                        compute_dtype=torch.bfloat16, progress=True,
                        prefetch_depth=2):
    step = make_both_eval_step(model, compute_dtype)
    return run_eval(step, batcher, batch_size, device,
                    keys=("image", "input_ids", "attention_mask", "label",
                          "valid"), progress=progress,
                    prefetch_depth=prefetch_depth)


def load_model(path: str, cfg: FusionConfig, device) -> FusionModel:
    """The unfolded model held by a BEST checkpoint of the port's trainer
    or by a reference all-heads .pth, on `device`."""
    payload = load_checkpoint(path)
    if payload is None:
        params, state = convert_torch(load_torch_state_dict(path), cfg)
        return load_fusion_model(params, state, cfg, device=device)
    meta = payload["meta"]      # "text_layers": files of earlier versions
    model = FusionModel(cfg, text_layers=meta.get("layers")
                        or meta["text_layers"])
    model.load_state_dict(payload["state_dict"])
    return model.to(device).eval()


def evaluate(args):
    """Build the model the flags name, load its weights, fold BN, and
    evaluate the test folder: (acc %, labels, preds, stats)."""
    if args.late_fusion not in LATE_FUSION_STRATEGIES:
        print("Wrong late fusion strategy: ", args.late_fusion)
        raise SystemExit(1)
    cfg = fusion_config_from_args(args)
    check_config(cfg)
    check_eval_flags(args)
    device = resolve_device(cli_device())
    model = load_model(args.model_path, cfg, device)
    fold_batchnorm(model.image, 1e-3)   # EffNetV2 bn eps
    model.to(torch_compute_dtype(args.param_dtype or args.compute_dtype))

    manifest = build_manifest(args.dataset_folder_name,
                              extended_desc=args.extended_desc_val)
    print(f"Num of test images: {len(manifest)}")
    tok = get_tokenizer(args.text_model, vocab_dir=resolve_vocab_dir(args))
    if cfg.strategy == "clip":
        batch_size = cfg.batch_size
    else:
        batch_size = max(1, min(args.eval_batch_size
                                or MULTIMODAL_EVAL_BATCH, len(manifest)))
    batcher = ImageTextBatcher(
        manifest, MULTIMODAL_IMAGE_SIZE, tokenizer=tok,
        seq_len=args.seq_len or DEFAULT_SEQ_LEN,
        extended_desc=args.extended_desc_val is not None,
        workers=args.data_workers)
    try:
        return run_multimodal_eval(
            model, batcher, batch_size, device,
            torch_compute_dtype(args.compute_dtype),
            prefetch_depth=args.prefetch_depth)
    finally:
        batcher.close()


def main(argv=None):
    args = args_parser(argv)
    if args.model_path == "":
        print("Please provide test model path")
        sys.exit(0)   # exit code 0 is reference-faithful
    acc, labels, preds, stats = evaluate(args)
    tag = args.late_fusion
    print(f"\nsamples checked for test: {stats['n']}")
    print(f"eval throughput: {stats['samples_per_s']:.1f} samples/s")
    report = generate_report_and_image(
        labels, preds, acc, os.path.join(BASE_PATH, tag), tag, kind="both")
    print(f"Test accuracy: {acc:.2f} %")
    print("Test Report:")
    print(report)
    return acc


if __name__ == "__main__":
    main()
