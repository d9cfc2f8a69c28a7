"""Classification loss — torch.nn.CrossEntropyLoss parity (the port of the
JAX package's ``train/loss.py``).

  * per sample: l_i = (1 - eps) * (-w_{y_i} log p_{y_i})
                      + (eps / C) * sum_c (-w_c log p_c)
  * the mean divides by sum_i w_{y_i} (not by N) when class weights are
    given;
  * ``valid`` (0/1 tail padding) masks samples out of numerator and
    denominator; a fully masked batch returns (0, 0), not NaN, so that the
    gradient-accumulating step can weight microbatches by the denominator.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def cross_entropy_loss_and_weight(
        logits: torch.Tensor, labels: torch.Tensor,
        class_weights: Optional[torch.Tensor] = None,
        label_smoothing: float = 0.0,
        valid: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean CE over the batch (fp32) and its denominator sum_i w_{y_i}."""
    logits = logits.float()
    logp = torch.log_softmax(logits, dim=-1)
    c = logits.shape[-1]
    onehot = torch.nn.functional.one_hot(labels.long(), c).float()
    w_per_class = (torch.ones(c, device=logits.device)
                   if class_weights is None else class_weights.float())
    w_label = (onehot * w_per_class).sum(-1)
    nll = -(onehot * logp).sum(-1) * w_label
    if label_smoothing > 0.0:
        smooth = -(logp * w_per_class).sum(-1)
        per_sample = (1.0 - label_smoothing) * nll \
            + (label_smoothing / c) * smooth
    else:
        per_sample = nll
    if valid is not None:
        vm = valid.float()
        per_sample = per_sample * vm
        w_label = w_label * vm
    w_sum = w_label.sum()
    return per_sample.sum() / torch.clamp(w_sum, min=1e-30), w_sum
