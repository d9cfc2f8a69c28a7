"""BLIP-2 test-set evaluation CLI.

``python -m garbage_classification_rca_tpu_torch.cli.blip2_test
  --model_path=<HF Blip2ForConditionalGeneration .pth, plain or
  peft-wrapped; or a BEST file of cli.blip2_train: its adapters over the
  towers drawn from --seed, as with no file>
  --dataset_folder_name=<test-root> [--eval_batch_size=16]``

Parity with reference blip_2_test_set.py:222-266 through the JAX
package's ``cli/blip2_test.py``: rebuild BLIP-2 + LoRA, load the
checkpoint (dict or {'model_state_dict': ...} wrapper), run the 1-token
constrained decode over the test folder (left-padded 100-token knowledge
prompts; EVA ViT-g, Q-Former, OPT-2.7B with K2 on the card), write the
report under ``test_set_reports/blip2/``. Accuracy divides by the real
dataset size, not the reference's hard-coded 2000.

Runs on CUDA; ``GC_RCA_PLATFORM=cpu`` runs it on the CPU, and
``GC_RCA_TINY_BLIP2=1`` swaps in the tiny test geometry. Not ported yet:
``--max_new_tokens`` > 1, ``--gen_temperature``, ``--int8_weights`` and
``--kv_cache_dtype`` (the generate / serving path, ROADMAP.md queue 1
item 6), meshes, multi-host runs (item 7) and the JAX package's orbax
adapter directories.
"""

from __future__ import annotations

import os

from ..config import args_parser, torch_compute_dtype
from ..data.manifest import build_manifest
from ..device import resolve_device
from ..eval.report import generate_report_and_image
from . import check_eval_flags, cli_device
from .blip2_common import (Blip2Batcher, build_blip2, clamp_eval_batch,
                           vlm_eval)
from .blip2_train import answer_first_token_table, make_eval_step

BASE_PATH = "./test_set_reports"


def check_vlm_flags(args) -> None:
    """Raise on the flags of the paths the port does not run yet."""
    todo = ("is not ported to PyTorch yet (ROADMAP.md, queue 1 item 6: "
            "generate and serving); the port runs the 1-token decode")
    if args.max_new_tokens > 1:
        raise NotImplementedError(f"--max_new_tokens={args.max_new_tokens} "
                                  f"{todo}")
    if args.gen_temperature > 0:
        raise NotImplementedError(f"--gen_temperature {todo}")
    if args.int8_weights:
        raise NotImplementedError(f"--int8_weights {todo}")
    if args.kv_cache_dtype:
        raise NotImplementedError(f"--kv_cache_dtype {todo}")
    check_eval_flags(args, items="item 7")


def evaluate(args):
    """(acc %, labels, preds, stats) of the test folder."""
    check_vlm_flags(args)
    device = resolve_device(cli_device())
    dtype = torch_compute_dtype(args.compute_dtype)
    _, model, tok = build_blip2(args, device, dtype)
    m = build_manifest(args.dataset_folder_name)
    print(f"Num of test images: {len(m)}")
    b = Blip2Batcher(m, tok, workers=args.data_workers)
    try:
        step = make_eval_step(model, answer_first_token_table(b, m.classes),
                              dtype)
        return vlm_eval(step, b, clamp_eval_batch(
            args.eval_batch_size or 16, len(m)), device,
            prefetch_depth=args.prefetch_depth)
    finally:
        b.close()


def main(argv=None):
    args = args_parser(argv)
    acc, labels, preds, _ = evaluate(args)
    report = generate_report_and_image(
        labels, preds, acc, os.path.join(BASE_PATH, "blip2"), "blip2",
        kind="blip2")
    print(f"Test accuracy: {acc:.2f} %")
    print(report)
    return acc


if __name__ == "__main__":
    main()
