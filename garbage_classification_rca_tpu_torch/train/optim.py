"""Optimizers and learning-rate scheduling (the port of the JAX package's
``train/optim.py``).

``make_optimizer`` builds torch's own optimizers, which compute the same
updates as the JAX package's optax chains:
  * ``sgd``: ``torch.optim.SGD(weight_decay=reg)`` — the decay folds into
    the gradient, ``w -= lr * (g + reg * w)`` (optax ``add_decayed_weights``
    then ``sgd``);
  * ``adamw``: ``torch.optim.AdamW`` with optax ``adamw``'s constants (b1
    0.9, b2 0.999, eps 1e-8 outside the square root, bias-corrected
    moments, decoupled decay);
  * a trainable mask: frozen parameters are left out of the parameter
    group, so they get no update, no decay and no moments (optax
    ``multi_transform`` with ``set_to_zero``).
Both run their per-tensor updates as ``torch._foreach`` ops.
``PlateauScheduler`` is a copy of the JAX package's host-side
ReduceLROnPlateau.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Optional, Tuple

import torch


def make_optimizer(opt: str, named_params: Iterable[Tuple[str,
                                                         torch.Tensor]],
                   lr: float, reg: float,
                   trainable: Optional[Dict[str, bool]] = None
                   ) -> torch.optim.Optimizer:
    """``opt`` in {'sgd', 'adamw'} over named parameters; ``trainable``
    maps a name to False to freeze it (default: all trainable)."""
    params = [p for n, p in named_params
              if trainable is None or trainable.get(n, True)]
    if not params:
        # everything frozen: a step updates nothing, as the JAX trainer's
        # all-"freeze" multi_transform does (torch refuses an empty list,
        # not an empty group)
        params = [{"params": []}]
    if opt == "sgd":
        return torch.optim.SGD(params, lr=lr, weight_decay=reg, foreach=True)
    if opt == "adamw":
        return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=reg, foreach=True)
    raise ValueError(f"Invalid optimizer: {opt}")


def set_learning_rate(opt: torch.optim.Optimizer,
                      lr: float) -> torch.optim.Optimizer:
    for group in opt.param_groups:
        group["lr"] = float(lr)
    return opt


def get_learning_rate(opt: torch.optim.Optimizer) -> float:
    return opt.param_groups[0]["lr"]


class PlateauScheduler:
    """torch ReduceLROnPlateau parity (mode='max', factor, patience=10,
    threshold=1e-4 rel) — host-side, feeds set_learning_rate."""

    def __init__(self, lr: float, factor: float = 0.2, patience: int = 10,
                 threshold: float = 1e-4, min_lr: float = 0.0):
        self.lr = lr
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.best = -math.inf
        self.num_bad = 0

    def state_dict(self) -> dict:
        return {"lr": self.lr, "best": self.best, "num_bad": self.num_bad}

    def load_state_dict(self, d: dict) -> None:
        self.lr = float(d["lr"])
        self.best = float(d["best"])
        self.num_bad = int(d["num_bad"])

    def step(self, metric: float) -> float:
        """Feed the epoch's val metric; returns the (possibly reduced) lr."""
        if metric > self.best * (1.0 + self.threshold) if self.best > 0 \
                else metric > self.best + self.threshold:
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.num_bad = 0
        return self.lr
