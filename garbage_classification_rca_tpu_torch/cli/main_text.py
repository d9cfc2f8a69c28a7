"""Text-model training CLI.

``python -m garbage_classification_rca_tpu_torch.cli.main_text
  --text_model=distilbert --dataset_folder_name=<base> [flags]``
reads ``<base>_Train`` and ``<base>_Val`` (text from the filename stems or
the captions CSV) and runs the two phases of the JAX package's
``cli/main_text.py``: ``--epochs`` on the head only with ``--tl`` (frozen
in the optimizer: every gradient is computed), else on everything; then
everything at lr / ``--fraction_lr`` with ReduceLROnPlateau (factor 0.4)
for ``--ft_epochs``. Each epoch evaluates the val set with ``cli.test_text``'s
step, logs a JSONL row under ``runs/`` and writes a BEST checkpoint under
``model_weights/<text_model>/`` when val accuracy improves (the port's
``cli.test_text`` loads it).

Same flags as the JAX CLI. fp32 compute on fp32 master weights
(``--param_dtype`` overrides: a text model computes in the dtype of its
weights). ``--hf_internal_dropout`` keeps the HF tower's own p = 0.1
dropout active while training, as the reference's train-mode towers have
it; its attention-probabilities site runs in the dropout flash-attention
kernels. ``--use_synonyms`` swaps words through the rule table at
``--prob_aug_text`` per batch, or, with ``GC_RCA_LLM_PATH`` naming a local
transformers Llama directory, paraphrases through it on the trainer's
device (``data/synonymize.make_hf_llm_fn``, its draws seeded from
``--seed``). ``--model_path`` warm-starts from a
reference-layout classifier ``.pth`` or a BEST checkpoint of this trainer;
pointed at ``model_weights/<text_model>/RESUME``, which both phases write
after every epoch (and every ``--resume_every_steps`` optimizer windows),
it continues the killed run where it stopped (the synonymizer's host
random stream is not saved, as in the JAX package: with
``--use_synonyms`` a resumed run draws other swaps).
Text models: distilbert, bert, roberta, bart, gpt2, mobilebert (phase 1
with ``--tl`` trains the Linear the reference replaces: BART's
``head_out``, GPT-2's ``score``, MobileBERT's ``classifier``; under the
reference spelling ``mobile_bert`` none, as in the JAX CLI). The head
drops its input at the model's own default ratio. Runs on CUDA;
``GC_RCA_PLATFORM=cpu`` runs it on the CPU. Not ported yet
(NotImplementedError): --wandb, --fsdp, --mesh_shape other than one
device, multi-host runs.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from .. import NUM_CLASSES
from ..config import TEXT_ARCHS, args_parser
from ..data.manifest import build_manifest
from ..data.pipeline import ImageTextBatcher
from ..data.synonymize import Synonymizer, make_hf_llm_fn
from ..data.tokenizer import DEFAULT_SEQ_LEN, get_tokenizer, resolve_vocab_dir
from ..device import resolve_device
from ..eval.harness import run_eval
from ..eval.report import classification_report_dict
from ..models.registry import get_text_model
from ..train.engine import MetricsLogger, ResumePlan, run_phase
from ..train.loop import all_trainable_mask, head_only_mask, make_train_step
from ..train.optim import PlateauScheduler, make_optimizer
from ..utils.dtype import cast_for_training
from . import (check_unported_flags, cli_device, load_unimodal_model,
               model_from_payload, resolve_model)
from .test_text import make_text_eval_step

TRAIN_SUFFIX = "_Train"
VAL_SUFFIX = "_Val"
TEXT_KEYS = ("input_ids", "attention_mask", "label", "valid")

# exactly the replaced Linear per tower (the reference freezes the rest).
# The reference spelling "mobile_bert" falls back to ("head",), as in the
# JAX CLI: with --tl its phase 1 then trains no parameter.
HEAD_KEYS_BY_MODEL = {
    "bart": ("head_out",),
    "gpt2": ("score",),
    "mobilebert": ("classifier",),
}
HEAD_KEYS_DEFAULT = ("head",)


def head_keys_for(model: str):
    return HEAD_KEYS_BY_MODEL.get(model, HEAD_KEYS_DEFAULT)


def train_forward(model, hf_internal_dropout: bool):
    """The model as the trainer calls it: the head's dropout at the
    model's own default ratio (0.6 for DistilBERT, BERT, RoBERTa and BART,
    none for GPT-2, 0.0 for MobileBERT; the JAX trainer passes none
    either, nor reads --model_dropout), the HF-internal sites on with the
    flag."""
    return functools.partial(model, hf_internal_dropout=hf_internal_dropout)


class SynonymBatcher(ImageTextBatcher):
    """Applies host-side synonym augmentation before tokenizing (the
    augmented text is tokenized again)."""

    def __init__(self, *a, synonymizer=None, prob=0.0, seed=0, **kw):
        super().__init__(*a, **kw)
        self.syn = synonymizer
        self.prob = prob
        self.rng = np.random.default_rng(seed)

    def make_batch(self, indices, batch_size):
        batch = super().make_batch(indices, batch_size)
        if self.syn is not None and self.rng.random() < self.prob:
            n = len(indices)
            texts = [self.syn.augment(
                self.m.samples[i].effective_text(self.extended))
                for i in indices]
            texts += [""] * (batch_size - n)
            enc = self.tokenizer.encode_batch(texts, self.seq_len)
            batch["input_ids"] = enc.input_ids
            batch["attention_mask"] = enc.attention_mask
        return batch


def main(argv=None):
    args = args_parser(argv)
    if args.opt not in ("sgd", "adamw"):
        print("Invalid optimizer!")   # reference wording, main_image.py:536
        raise SystemExit(1)
    mdef = resolve_model(get_text_model, args.text_model)
    check_unported_flags(args)
    spec = TEXT_ARCHS[args.text_model]
    device = resolve_device(cli_device())

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
    syn = None
    if args.use_synonyms:
        # the reference's Llama paraphraser when local weights are given
        llm_path = os.environ.get("GC_RCA_LLM_PATH")
        if llm_path:
            syn = Synonymizer(seed=args.seed, llm_fn=make_hf_llm_fn(
                llm_path, seed=args.seed, device=device))
            print(f"Synonymizer: HF LLM backend from {llm_path}")
        else:
            syn = Synonymizer(seed=args.seed)
            print("Synonymizer: rule-table backend (set GC_RCA_LLM_PATH "
                  "to local Llama weights for the reference LLM backend)")
    seq_len = args.seq_len or DEFAULT_SEQ_LEN
    train_batcher = SynonymBatcher(
        train_manifest, (0, 0), tokenizer=tok, seq_len=seq_len,
        extended_desc=args.extended_desc_train is not None,
        workers=args.data_workers, with_images=False,
        synonymizer=syn, prob=args.prob_aug_text, seed=args.seed)
    val_batcher = ImageTextBatcher(
        val_manifest, (0, 0), tokenizer=tok, seq_len=seq_len,
        extended_desc=args.extended_desc_val is not None,
        workers=args.data_workers, with_images=False)

    plan = ResumePlan(args.model_path)
    if plan.resume is not None:
        model = model_from_payload(mdef, plan.resume, device)
    elif args.model_path:
        model = load_unimodal_model(mdef, args.model_path,
                                    f"--text_model={args.text_model}", device)
        print(f"Warm-started from {args.model_path}")
    else:
        model = mdef.build(NUM_CLASSES, generator=torch.Generator()
                           .manual_seed(args.seed)).to(device).eval()
    # fp32 master weights unless --param_dtype overrides; a full resume
    # keeps the checkpoint's dtype when the flag is left empty
    cast_for_training(args, model, plan.resume is not None)
    forward = train_forward(model, args.hf_internal_dropout)

    def batch_to_inputs(mb, key):
        return (mb["input_ids"], mb["attention_mask"])

    def make_step(mask, lr):
        opt = make_optimizer(args.opt, model.named_parameters(), lr,
                             args.reg, mask)
        return opt, make_train_step(model, opt, forward=forward,
                                    batch_to_inputs=batch_to_inputs,
                                    class_weights=class_weights,
                                    label_smoothing=args.label_smoothing)

    eval_bs = max(1, min(args.eval_batch_size or spec.eval_batch,
                         len(val_manifest)))

    def eval_fn(model):
        acc, labels, preds, _ = run_eval(
            make_text_eval_step(model), val_batcher, eval_bs, device,
            keys=TEXT_KEYS, progress=False,
            prefetch_depth=args.prefetch_depth)
        return acc, classification_report_dict(labels, preds)

    logger = MetricsLogger(args.name or f"text_{args.text_model}")
    common = dict(model=model, eval_fn=eval_fn, batcher=train_batcher,
                  args=args, model_name=args.text_model, logger=logger,
                  device=device, balanced_sampler=args.balanced_sampler,
                  keep_top_k=3, keys=TEXT_KEYS, save_resume=True,
                  resume=plan)

    mask = head_only_mask(model, head_keys_for(args.text_model)) \
        if args.tl else all_trainable_mask(model)
    opt, step = make_step(mask, args.lr)
    best = run_phase(phase_name="train", epochs=args.epochs, optimizer=opt,
                     train_step=step, batch_size=args.batch_size,
                     acc_steps=args.acc_steps, **common)
    if args.ft_epochs > 0:
        ft_lr = args.lr / args.fraction_lr
        opt, step = make_step(all_trainable_mask(model), ft_lr)
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
