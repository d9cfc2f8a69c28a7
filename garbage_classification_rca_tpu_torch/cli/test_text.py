"""Text-model test-set evaluation CLI.

``python -m garbage_classification_rca_tpu_torch.cli.test_text
  --text_model=distilbert --model_path=<ckpt.pth or a BEST file of
  the port's cli.main_text>
  --dataset_folder_name=<test-root>``
Text comes from the filename stems (or the --extended_desc_val captions
CSV), tokenized on the host; the encoder + head forward runs on the device
(the fused post-norm block kernels where the shape fits; BART-large,
GPT-2 and MobileBERT run no hand-written kernel). The weights are cast to
``--param_dtype``, or ``--compute_dtype`` when it is empty, and the model
computes in their dtype, as in the JAX CLI. Reports land
under ``test_set_reports/<text_model>/``. Same flags as the JAX package's
``cli/test_text.py``; over N GPUs with ``torchrun --nproc_per_node=N
--mesh_shape=data:N`` (rank 0 writes the report); a ``seq`` axis
(``--mesh_shape=seq:S`` or ``data:D,seq:S`` over D x S ranks) runs
DistilBERT sequence-parallel (``parallel/sp.py``), and any other
``--text_model`` exits 1 with the JAX CLI's message. Orbax checkpoint
directories are not read. Runs on CUDA; ``GC_RCA_PLATFORM=cpu`` runs it on the
CPU. Text models: distilbert, bert, roberta, bart, gpt2, mobilebert (or
mobile_bert), each at its ``config.TEXT_ARCHS`` eval batch.
"""

from __future__ import annotations

import os
import sys

import torch

from ..config import TEXT_ARCHS, args_parser
from ..data.manifest import build_manifest
from ..data.pipeline import ImageTextBatcher
from ..data.tokenizer import DEFAULT_SEQ_LEN, get_tokenizer, resolve_vocab_dir
from ..eval.harness import run_eval
from ..eval.report import generate_report_and_image
from ..models.registry import get_text_model
from ..parallel.mesh import SEQ_AXIS, clamp_eval_batch
from ..parallel.multihost import is_primary
from ..utils.dtype import resolve_param_dtype
from . import (check_eval_flags, data_mesh, load_unimodal_model,
               resolve_model)

BASE_PATH = "./test_set_reports"


def make_text_eval_step(model, mesh=None, *, text_model: str = ""):
    """``model(input_ids, attention_mask) -> logits`` -> (preds, masked
    correct count). A `mesh` with a seq axis of more than one rank routes
    DistilBERT through the sequence-parallel encoder
    (``parallel/sp.distilbert_classify_sp``); another text model prints
    the JAX CLI's message and exits 1."""
    forward = model
    if mesh is not None and mesh.size(SEQ_AXIS) > 1:
        if text_model != "distilbert":
            print(f"--mesh_shape with a seq axis supports only "
                  f"distilbert (got {text_model}); see parallel/sp.py")
            raise SystemExit(1)
        from ..parallel.sp import distilbert_classify_sp

        def forward(ids, mask):
            return distilbert_classify_sp(model, ids, mask, mesh)

    def step(batch):
        logits = forward(batch["input_ids"], batch["attention_mask"])
        preds = logits.float().argmax(dim=-1).to(torch.int32)
        correct = ((preds == batch["label"]) * batch["valid"]).sum()
        return preds, correct

    return step


def evaluate(args):
    """Build the model the flags name, load its weights and evaluate the
    test folder: (acc %, labels, preds, stats)."""
    mdef = resolve_model(get_text_model, args.text_model)
    check_eval_flags(args, allowed=("seq",))
    mesh = data_mesh(args, allowed=("seq",))
    device = mesh.device
    model = load_unimodal_model(mdef, args.model_path,
                                f"--text_model={args.text_model}", device)
    model.to(resolve_param_dtype(args, args.compute_dtype))
    step = (make_text_eval_step(model, mesh, text_model=args.text_model)
            if mesh.size(SEQ_AXIS) > 1 else make_text_eval_step(model))

    manifest = build_manifest(args.dataset_folder_name,
                              extended_desc=args.extended_desc_val)
    print(f"Num of test samples: {len(manifest)}")
    tok = get_tokenizer(args.text_model, vocab_dir=resolve_vocab_dir(args))
    batch_size = clamp_eval_batch(
        args.eval_batch_size or TEXT_ARCHS[args.text_model].eval_batch,
        len(manifest), mesh)
    batcher = ImageTextBatcher(
        manifest, (0, 0), tokenizer=tok,
        seq_len=args.seq_len or DEFAULT_SEQ_LEN,
        extended_desc=args.extended_desc_val is not None,
        workers=args.data_workers, with_images=False)
    try:
        return run_eval(
            step, batcher, batch_size, device,
            keys=("input_ids", "attention_mask", "label", "valid"),
            prefetch_depth=args.prefetch_depth, mesh=mesh)
    finally:
        batcher.close()


def main(argv=None):
    args = args_parser(argv)
    if args.model_path == "":
        print("Please provide test model path")
        sys.exit(0)   # exit code 0 is reference-faithful
    acc, labels, preds, stats = evaluate(args)
    if not is_primary():
        return acc
    print(f"\nsamples checked for test: {stats['n']}")
    print(f"eval throughput: {stats['samples_per_s']:.1f} samples/s")
    report = generate_report_and_image(
        labels, preds, acc, os.path.join(BASE_PATH, args.text_model),
        args.text_model, kind="text")
    print(f"Test accuracy: {acc:.2f} %")
    print("Test Report:")
    print(report)
    return acc


if __name__ == "__main__":
    main()
