"""Q-Former classifier training CLI: the eval step only, so far.

The port of the JAX package's ``cli/qformer_train.py`` holds the eval
step the test CLI shares with it: the Q-Former's first query output
(``qformer_cls_feature``, in fp32) into the Linear(768, 4) classifier,
argmax. The trainer (the classifier alone trains, the backbone frozen) is
not ported yet: ``main`` raises (ROADMAP.md, queue 1 item 5).
"""

from __future__ import annotations

import torch

from ..config import args_parser
from ..models.vlm import blip2
from .blip2_common import normalize_clip


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
    args_parser(argv)
    raise NotImplementedError(
        "Q-Former classifier training is not ported to PyTorch yet "
        "(ROADMAP.md, queue 1 item 5); cli.qformer_test evaluates")


if __name__ == "__main__":
    main()
