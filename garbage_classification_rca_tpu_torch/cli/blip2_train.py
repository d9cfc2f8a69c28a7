"""BLIP-2 LoRA fine-tuning CLI: the eval step only, so far.

The port of the JAX package's ``cli/blip2_train.py`` holds what the eval
CLI shares with it: ``make_eval_step`` (the 1-token constrained decode:
next-token logits at each row's last valid prompt token, argmax over the
four answer words' first tokens) and ``answer_first_token_table``. The
trainer itself (LoRA r=32 on OPT q / k, AdamW, accumulation 8; its
attention backward is the flash pair at head dim 80) is not ported yet:
``main`` raises (ROADMAP.md, queue 1 item 5).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import args_parser
from ..models.vlm import blip2
from .blip2_common import (Blip2Batcher, class_logits_from_next_token,
                           normalize_clip)


def make_eval_step(model, answer_first_tokens, compute_dtype=torch.bfloat16):
    """``step(batch of device tensors) -> (preds int32 [B], masked correct
    count)``."""
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


def answer_first_token_table(batcher: Blip2Batcher, classes) -> np.ndarray:
    """First answer-word token id per class index (sorted-folder order)."""
    return np.asarray([batcher.answer_token_ids[c][1]
                       if len(batcher.answer_token_ids[c]) > 1
                       else batcher.answer_token_ids[c][0]
                       for c in classes], np.int32)


def main(argv=None):
    args_parser(argv)
    raise NotImplementedError(
        "BLIP-2 LoRA training is not ported to PyTorch yet (ROADMAP.md, "
        "queue 1 item 5: the flash pair at head dim 80); "
        "cli.blip2_test evaluates")


if __name__ == "__main__":
    main()
