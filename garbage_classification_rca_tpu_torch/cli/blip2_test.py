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

``--max_new_tokens=N`` > 1 runs the serving path instead: KV-cache
generation of N tokens (``blip2.generate``; greedy, or sampled with
``--gen_temperature`` / ``--gen_top_k`` / ``--gen_top_p``, batch i drawing
from ``Key(--gen_seed).fold_in(i)``; ``--kv_cache_dtype=int8``;
``--int8_weights``: weight-only int8 on the OPT tower, the adapters on top
in the compute dtype), each row's valid tokens decoded and mapped to an
answer word by the reference's ``find_closest_string``.

Runs on CUDA; ``GC_RCA_PLATFORM=cpu`` runs it on the CPU, and
``GC_RCA_TINY_BLIP2=1`` swaps in the tiny test geometry. The 1-token
path runs over N GPUs with ``torchrun --nproc_per_node=N
--mesh_shape=data:N`` (rank 0 writes the report). Both paths run with the
OPT tower sliced over a model axis (``--mesh_shape=data:1,model:M`` over M
ranks, ``parallel/tp.py``; data:D,model:M for the 1-token path): every
rank computes the same logits and draws the same tokens, rank 0 writes
the report. Generation over a data axis of several ranks exits, as the
JAX CLI's multi-host rule.

``--mesh_shape=data:D,pipe:S`` over D x S ranks on one host evaluates
through a GPipe-staged decoder (``parallel/pp.py``; a BEST file from any
mesh): the batch rounds up to a multiple of S x D, the 1-token path runs
``make_pp_eval_step`` (the last stage's answer logits broadcast over the
pipe), ``--max_new_tokens > 1`` the ring-scheduled ``pp_generate``
(greedy; ``--kv_cache_dtype=int8`` too; ``--gen_temperature`` and
``--int8_weights`` exit, as in the JAX CLI); every rank gets the whole
result. Not ported yet: the expert axis (ROADMAP.md queue 1 item 7) and
the JAX package's orbax adapter directories.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..config import args_parser, torch_compute_dtype
from ..data.manifest import build_manifest
from ..eval.report import generate_report_and_image
from ..models.vlm import blip2
from ..models.vlm.prompts import (ANSWER_TO_CLASS_IDX, ANSWER_WORDS,
                                  find_closest_string)
from ..nn.core import Key
from ..parallel.mesh import clamp_eval_batch
from ..parallel.multihost import is_primary
from . import check_eval_flags, data_mesh
from .blip2_common import (Blip2Batcher, build_blip2, check_pipe_flags,
                           normalize_clip, place_blip2, sampler_from_args,
                           setup_pipeline, vlm_eval, vlm_multihost_mesh_check)
from .blip2_train import (answer_first_token_table, make_eval_step,
                          make_pp_eval_step, pick_pp_microbatches)

BASE_PATH = "./test_set_reports"


def make_generate_step(model, tok, args, compute_dtype, mesh=None):
    """``step(batch) -> (preds int32 [B], masked correct count)`` of the
    serving path: ``--max_new_tokens`` tokens a row, the valid ones decoded
    and mapped to an answer word by ``find_closest_string``. A `mesh`
    with a pipe axis generates on the pipeline's ring (greedy)."""
    sampler = sampler_from_args(args)
    cache_dtype = args.kv_cache_dtype or None
    base_rng = Key(args.gen_seed)
    batch_idx = 0

    def step(batch):
        nonlocal batch_idx
        rng = base_rng.fold_in(batch_idx)
        batch_idx += 1
        x = normalize_clip(batch["image"], compute_dtype)
        if mesh is not None and mesh.size("pipe") > 1:
            from ..parallel.pp import pp_blip2_generate

            toks, valid = pp_blip2_generate(
                model, x, batch["input_ids"], batch["attention_mask"], mesh,
                args.max_new_tokens, cache_dtype=cache_dtype)
        else:
            toks, valid = blip2.generate(
                model, x, batch["input_ids"], batch["attention_mask"],
                max_new_tokens=args.max_new_tokens, sampler=sampler,
                rng=rng, cache_dtype=cache_dtype)
        toks, valid = toks.cpu().numpy(), valid.cpu().numpy()
        preds = np.asarray([ANSWER_TO_CLASS_IDX[find_closest_string(
            tok.decode(toks[r][valid[r]]), ANSWER_WORDS)]
            for r in range(toks.shape[0])], np.int32)
        preds = torch.from_numpy(preds).to(batch["label"].device)
        correct = ((preds == batch["label"]) * batch["valid"]).sum()
        return preds, correct

    return step


def evaluate(args):
    """(acc %, labels, preds, stats) of the test folder."""
    check_eval_flags(args, allowed=("model", "pipe"))
    n_pipe = check_pipe_flags(args)
    mesh = data_mesh(args, allowed=("model", "pipe"))
    vlm_multihost_mesh_check(mesh, args)
    device = mesh.device
    dtype = torch_compute_dtype(args.compute_dtype)
    _, model, tok = build_blip2(args, device, dtype)
    if n_pipe > 1:
        setup_pipeline(model, mesh)
    else:
        if args.max_new_tokens > 1 and args.int8_weights:
            from ..ops.quant import quantize_opt_weights

            quantize_opt_weights(model.opt)
        place_blip2(model, mesh)
    m = build_manifest(args.dataset_folder_name)
    print(f"Num of test images: {len(m)}")
    b = Blip2Batcher(m, tok, workers=args.data_workers)
    bs = clamp_eval_batch(args.eval_batch_size or 16, len(m), mesh)
    if n_pipe > 1:
        # pp_generate runs one microbatch a stage, each split over the data
        # axis: the batch rounds up to a multiple of pipe x data (the tail
        # padding is masked by `valid`)
        unit = n_pipe * mesh.size("data")
        bs = -(-bs // unit) * unit
    try:
        if args.max_new_tokens > 1:
            step = make_generate_step(model, tok, args, dtype, mesh)
        elif n_pipe > 1:
            step = make_pp_eval_step(
                model, answer_first_token_table(b, m.classes), mesh,
                pick_pp_microbatches(bs, mesh), dtype)
        else:
            step = make_eval_step(model, answer_first_token_table(
                b, m.classes), dtype)
        return vlm_eval(step, b, bs, device,
                        prefetch_depth=args.prefetch_depth, mesh=mesh)
    finally:
        b.close()


def main(argv=None):
    args = args_parser(argv)
    acc, labels, preds, _ = evaluate(args)
    if not is_primary():
        return acc
    report = generate_report_and_image(
        labels, preds, acc, os.path.join(BASE_PATH, "blip2"), "blip2",
        kind="blip2")
    print(f"Test accuracy: {acc:.2f} %")
    print(report)
    return acc


if __name__ == "__main__":
    main()
