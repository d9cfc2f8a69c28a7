"""Two-phase training engine (the port of the JAX package's
``train/engine.py``, the part the three trainers run).

Phase 1 trains the heads with the rest frozen (the unimodal trainers: only
with ``--tl``) for ``--epochs``; phase 2
unfreezes everything at lr / ``--fraction_lr`` for ``--ft_epochs`` with
ReduceLROnPlateau on val accuracy. Each epoch: the host batches grouped
into ``[acc, B, ...]`` stacks (the trailing stack padded with valid = 0
microbatches), one train step per stack, the val evals, a JSONL metrics
row, and a BEST checkpoint when val accuracy improves.

Seeds follow the JAX engine: the data order of epoch e is
``seed * 77 + e``, the balanced sampler's ``seed * 1000 + e``; the step
keys split from ``Key(seed)`` once per step. Checkpoints are
``torch.save`` files of the model's ``state_dict`` plus meta, under the
JAX package's BEST names. Not ported (the CLI raises on the flags that
ask for them): the RESUME checkpoint and mid-epoch resume, multi-host
input, wandb.
"""

from __future__ import annotations

import json
import math
import os
import re
import time
import zipfile
from dataclasses import dataclass
from datetime import datetime
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from ..config import RunConfig
from ..data.pipeline import to_device
from ..data.sampler import imbalanced_sample_order
from ..nn.core import Key
from .optim import PlateauScheduler, get_learning_rate, set_learning_rate

CHECKPOINT_FORMAT = "garbage_classification_rca_tpu_torch/1"
BATCH_KEYS = ("image", "input_ids", "attention_mask", "label", "valid")


class MetricsLogger:
    """JSONL metrics sink, one row per epoch under ``runs/``."""

    def __init__(self, run_name: str):
        os.makedirs("runs", exist_ok=True)
        ts = datetime.now().strftime("%Y_%m_%d_%H_%M_%S")
        self.path = os.path.join("runs", f"{run_name}_{ts}.jsonl")

    def log(self, metrics: Dict):
        with open(self.path, "a") as f:
            f.write(json.dumps(metrics) + "\n")


def stacked_batches(batcher, batch_size: int, acc_steps: int, *, seed: int,
                    order=None, keys=BATCH_KEYS
                    ) -> Iterable[Dict[str, np.ndarray]]:
    """Group the host stream into [acc, B, ...] stacks."""
    acc = max(acc_steps, 1)
    buf: List[Dict] = []
    for b in batcher.iter_batches(batch_size, shuffle=order is None,
                                  seed=seed, order=order):
        buf.append({k: v for k, v in b.items() if k in keys})
        if len(buf) == acc:
            yield {k: np.stack([x[k] for x in buf]) for k in buf[0]}
            buf = []
    if buf:
        # pad the trailing stack by repeating the last microbatch with
        # valid=0 so gradients are exact
        pad = dict(buf[-1])
        pad["valid"] = np.zeros_like(pad["valid"])
        while len(buf) < acc:
            buf.append(pad)
        yield {k: np.stack([x[k] for x in buf]) for k in buf[0]}


def save_best(model: torch.nn.Module, *, model_name: str, epoch: int,
              val_acc: float, args: RunConfig, fine_tuning: bool,
              keep_top_k: int = 0, layers: Optional[int] = None) -> str:
    """A BEST checkpoint under the JAX package's name
    (``model_weights/<model>/BEST_model_..._VAL_ACC_<acc>_<time>``): one
    ``torch.save`` file holding the state_dict (on the CPU) and meta.
    `layers`: the depth to record for a module without transformer layers
    of its own (the VLM trainers' adapters and classifier; default
    ``model_depth``)."""
    base = os.path.join("model_weights", model_name)
    os.makedirs(base, exist_ok=True)
    if fine_tuning:
        name = (f"BEST_model_{model_name}_FT_EPOCH_{epoch + 1}_LR_{args.lr}"
                f"_Reg_{args.reg}_Opt_{args.opt}_FractionLR_{args.fraction_lr}"
                f"_VAL_ACC_{val_acc:.5f}_")
    else:
        name = (f"BEST_model_{model_name}_epoch_{epoch + 1}_LR_{args.lr}"
                f"_Reg_{args.reg}_Opt_{args.opt}_VAL_ACC_{val_acc:.5f}_")
    name += datetime.now().strftime("%Y_%m_%d_%H_%M_%S")
    path = os.path.abspath(os.path.join(base, name))
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    meta = {"epoch": epoch, "val_acc": val_acc, "fine_tuning": fine_tuning,
            "layers": model_depth(model) if layers is None else layers}
    torch.save({"format": CHECKPOINT_FORMAT, "state_dict": state,
                "meta": meta}, path)
    print(f"Saving weights to {path}")
    if keep_top_k:
        _prune_best(base, keep_top_k, protect=name)
    return path


def model_depth(model: torch.nn.Module) -> int:
    """How many transformer layers the model holds (the fusion model's
    text tower, a text classifier's encoder, ViT; BART: per stack): what a
    BEST checkpoint records so that a model of the same depth can be built
    to load it."""
    for holder in (getattr(model, "text", None),
                   getattr(model, "encoder", None), model):
        for name in ("layers", "enc_layers"):
            if holder is not None and hasattr(holder, name):
                return len(getattr(holder, name))
    raise ValueError(f"{type(model).__name__} holds no transformer layers")


def load_checkpoint(path: str) -> Optional[Dict]:
    """The payload of a ``save_best`` file, or None when `path` holds
    something else (e.g. a reference .pth state dict). The tensors are
    mapped, not read, so that telling a multi-GiB reference .pth from a
    BEST file costs its header; a file not in torch's zip format is not
    a ``save_best`` one."""
    if not zipfile.is_zipfile(path):
        return None
    obj = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    if isinstance(obj, dict) and obj.get("format") == CHECKPOINT_FORMAT:
        return obj
    return None


def _prune_best(base: str, keep_top_k: int, protect: str = "") -> None:
    """Keep only the k best BEST_* checkpoints of a model dir; the one just
    saved (`protect`) is never deleted."""
    if keep_top_k <= 0:
        return
    entries = []
    for name in os.listdir(base):
        m = re.search(r"VAL_ACC_([0-9.]+)_", name)
        if name.startswith("BEST_") and m and name != protect:
            entries.append((float(m.group(1)), name))
    entries.sort(reverse=True)
    keep = keep_top_k - (1 if protect else 0)
    for _, name in entries[max(keep, 0):]:
        os.remove(os.path.join(base, name))


@dataclass
class PhaseResult:
    best_val_acc: float
    best_epoch: int
    best_path: Optional[str]


def run_phase(*, phase_name: str, epochs: int, model: torch.nn.Module,
              optimizer: torch.optim.Optimizer, train_step: Callable,
              eval_fn: Callable, batcher, batch_size: int, acc_steps: int,
              args: RunConfig, model_name: str, logger: MetricsLogger, device,
              scheduler: Optional[PlateauScheduler] = None,
              best: Optional[PhaseResult] = None,
              balanced_sampler: bool = False,
              extra_evals: Optional[Dict[str, Callable]] = None,
              fine_tuning: bool = False, keep_top_k: int = 0,
              keys=BATCH_KEYS) -> PhaseResult:
    """One training phase; the model is updated in place. ``eval_fn(model)
    -> (val_acc, report)``; each ``extra_evals`` entry ``fn(model) ->
    acc`` adds a metric. `keys`: the batch entries the step reads."""
    best = best or PhaseResult(0.0, 0, None)
    key = Key(args.seed)
    n_batches = math.ceil(len(batcher.m) / batch_size)
    for epoch in range(epochs):
        t0 = time.time()
        order = None
        if balanced_sampler:
            order = imbalanced_sample_order(batcher.m,
                                            seed=args.seed * 1000 + epoch)
        host = stacked_batches(batcher, batch_size, acc_steps,
                               seed=args.seed * 77 + epoch, order=order,
                               keys=keys)
        losses, grad_norms, param_norm = [], [], None
        for bi, stack in enumerate(to_device(host, device,
                                             depth=args.prefetch_depth)):
            key, step_key = key.split(2)
            loss, _, norms = train_step(stack, step_key)
            losses.append(loss)
            grad_norms.append(norms["grad_norm"])
            param_norm = norms["param_norm"]
            print(f"Batches {bi * max(acc_steps, 1)}/{n_batches} "
                  f"on epoch {epoch}", end="\r")
        losses = [float(l) for l in losses]
        train_time = time.time() - t0

        metrics = {"phase": phase_name, "epoch": epoch,
                   "epoch_time_seconds": train_time,
                   "avg_loss": float(np.mean(losses)) if losses else 0.0,
                   "max_loss": float(np.max(losses)) if losses else 0.0,
                   "min_loss": float(np.min(losses)) if losses else 0.0,
                   "lr": get_learning_rate(optimizer)}
        if grad_norms:
            gns = [float(g) for g in grad_norms]
            metrics["grad_norm_mean"] = float(np.mean(gns))
            metrics["grad_norm_last"] = gns[-1]
            metrics["param_global_norm"] = float(param_norm)
        val_acc, val_report = eval_fn(model)
        metrics["val_acc"] = val_acc
        for cls, rep in (val_report or {}).items():
            if isinstance(rep, dict) and "precision" in rep:
                metrics[f"precision_{cls}"] = rep["precision"]
        for name, fn in (extra_evals or {}).items():
            metrics[name] = fn(model)
        logger.log(metrics)
        print(f"\n[{phase_name}] epoch {epoch}: val_acc={val_acc:.3f} "
              f"avg_loss={metrics['avg_loss']:.4f} "
              f"({train_time:.1f}s, lr={metrics['lr']:.2e})")

        if val_acc > best.best_val_acc:
            best = PhaseResult(val_acc, epoch, save_best(
                model, model_name=model_name, epoch=epoch, val_acc=val_acc,
                args=args, fine_tuning=fine_tuning, keep_top_k=keep_top_k))
        if scheduler is not None:
            set_learning_rate(optimizer, scheduler.step(val_acc))
    return best
