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
JAX package's BEST names. With ``save_resume`` a phase also writes the
full training state to ``model_weights/<model>/RESUME`` after every epoch
(and every ``--resume_every_steps`` optimizer windows): the model with
its BatchNorm buffers, the optimizer, the plateau scheduler, the epoch,
step, best and key, so that ``--model_path=.../RESUME`` continues a killed
run bit for bit. Not ported (the CLI raises on the flags that ask for
them): multi-host input, wandb.
"""

from __future__ import annotations

import functools
import itertools
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
RESUME_FORMAT = "garbage_classification_rca_tpu_torch/resume/1"
RESUME_NAME = "RESUME"
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
    of its own (the VLM trainers' adapters and classifier, 0 for the conv
    backbones; default ``model_depth``)."""
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
    meta = {"epoch": epoch, "val_acc": val_acc, "fine_tuning": fine_tuning,
            "layers": model_depth(model) if layers is None else layers}
    torch.save({"format": CHECKPOINT_FORMAT,
                "state_dict": _cpu_state(model), "meta": meta}, path)
    print(f"Saving weights to {path}")
    if keep_top_k:
        _prune_best(base, keep_top_k, protect=name)
    return path


def _cpu_state(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in model.state_dict().items()}


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


def _cpu(obj):
    """`obj` with every tensor in it moved to the CPU."""
    if torch.is_tensor(obj):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_cpu(v) for v in obj)
    return obj


def save_train_state(*, model: torch.nn.Module,
                     optimizer: torch.optim.Optimizer, model_name: str,
                     key: Key, epoch: int, phase_name: str,
                     scheduler: Optional[PlateauScheduler],
                     best: PhaseResult, step: int = 0, losses=None,
                     grad_norms=None, param_norm=None,
                     layers: Optional[int] = None) -> str:
    """The full training state in ``model_weights/<model>/RESUME``, one
    ``torch.save`` file: the model's state dict (BatchNorm buffers
    included) and the optimizer's, both on the CPU, and meta: the plateau
    scheduler, phase, epoch, step, best, the key and the model's depth
    (`layers`, as ``save_best`` records it).
    ``step > 0`` marks a mid-epoch save: `step` optimizer windows of
    `epoch` are done, and the epoch's losses, grad norms and param norm so
    far ride along, so that the resumed epoch logs the same row. The file
    is written to ``RESUME.tmp`` and swapped in; the one it replaces waits
    as ``RESUME.prev`` until then, so a kill at any point leaves one
    whole file."""
    base = os.path.join("model_weights", model_name)
    os.makedirs(base, exist_ok=True)
    path = os.path.abspath(os.path.join(base, RESUME_NAME))
    meta = {"phase_name": phase_name, "epoch": epoch, "step": int(step),
            "key": key.seed,
            "scheduler": scheduler.state_dict() if scheduler else None,
            "best_val_acc": best.best_val_acc,
            "best_epoch": best.best_epoch,
            "best_path": best.best_path or "",
            "layers": model_depth(model) if layers is None else layers}
    if step:
        meta["losses"] = [float(l) for l in losses or ()]
        meta["grad_norms"] = [float(g) for g in grad_norms or ()]
        meta["param_norm"] = (None if param_norm is None
                              else float(param_norm))
    tmp, prev = path + ".tmp", path + ".prev"
    torch.save({"format": RESUME_FORMAT, "state_dict": _cpu_state(model),
                "optimizer": _cpu(optimizer.state_dict()), "meta": meta},
               tmp)
    if os.path.exists(path):
        os.replace(path, prev)
    os.replace(tmp, path)
    if os.path.exists(prev):
        os.remove(prev)
    return path


def maybe_load_resume(model_path: str) -> Optional[Dict]:
    """The payload of a ``save_train_state`` file when `model_path` names
    one by its basename ``RESUME``, else None. When ``RESUME`` is missing
    (a kill inside the swap) its ``RESUME.prev`` is read instead."""
    if not model_path or \
            os.path.basename(os.path.normpath(model_path)) != RESUME_NAME:
        return None
    path = os.path.normpath(model_path)
    if not os.path.isfile(path):
        if not os.path.isfile(path + ".prev"):
            return None
        print(f"{path} is missing but {path}.prev exists (an interrupted "
              "checkpoint swap): resuming from it")
        path += ".prev"
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(payload, dict) or \
            payload.get("format") != RESUME_FORMAT:
        raise SystemExit(f"{path} is not a RESUME file of the port's "
                         "trainers")
    return payload


def load_model_state(model: torch.nn.Module, state_dict) -> None:
    """Load a saved state dict into `model`, each floating tensor taking
    the saved dtype (a bf16 run resumes in bf16) and keeping the model's
    memory format (``channels_last`` for the conv towers)."""
    with torch.no_grad():
        for name, t in itertools.chain(model.named_parameters(),
                                       model.named_buffers()):
            saved = state_dict.get(name)
            if saved is not None and saved.is_floating_point() \
                    and saved.dtype != t.dtype:
                t.data = t.data.to(saved.dtype)
    model.load_state_dict(state_dict)


PHASES = ("train", "fine_tune")


class ResumePlan:
    """The two-phase plumbing of a full resume (the JAX package's): the
    payload of ``--model_path=.../RESUME`` (``maybe_load_resume``; None
    when the path names no RESUME file), the phase it continues and the
    best it carries. ``run_phase`` reads it: a phase before the saved one
    is skipped, the saved one continues, a later one starts fresh."""

    def __init__(self, model_path: str):
        self.resume = maybe_load_resume(model_path)
        if self.resume is not None:
            m = self.resume["meta"]
            print(f"Full-resume from {model_path} "
                  f"(phase={m['phase_name']} epoch={m['epoch']})")

    def skips(self, phase_name: str) -> bool:
        return (self.resume is not None
                and PHASES.index(self.resume["meta"]["phase_name"])
                > PHASES.index(phase_name))

    def initial_best(self) -> PhaseResult:
        m = self.resume["meta"]
        return PhaseResult(float(m["best_val_acc"]), int(m["best_epoch"]),
                           m["best_path"] or None)

    def for_phase(self, phase_name: str) -> Optional[Dict]:
        if self.resume is not None and \
                self.resume["meta"]["phase_name"] == phase_name:
            return self.resume
        return None


def run_phase(*, phase_name: str, epochs: int, model: torch.nn.Module,
              optimizer: torch.optim.Optimizer, train_step: Callable,
              eval_fn: Callable, batcher, batch_size: int, acc_steps: int,
              args: RunConfig, model_name: str, logger: MetricsLogger, device,
              scheduler: Optional[PlateauScheduler] = None,
              best: Optional[PhaseResult] = None,
              balanced_sampler: bool = False,
              extra_evals: Optional[Dict[str, Callable]] = None,
              fine_tuning: bool = False, keep_top_k: int = 0,
              keys=BATCH_KEYS, save_resume: bool = False,
              resume: Optional[ResumePlan] = None,
              layers: Optional[int] = None) -> PhaseResult:
    """One training phase; the model is updated in place. ``eval_fn(model)
    -> (val_acc, report)``; each ``extra_evals`` entry ``fn(model) ->
    acc`` adds a metric. `keys`: the batch entries the step reads.
    `layers`: the depth the BEST and RESUME files record (``save_best``).

    ``save_resume`` writes RESUME after every epoch, after the val eval,
    the BEST file and the scheduler's step (and, with
    ``--resume_every_steps``, after every that many optimizer windows).
    `resume` (its model state already loaded by the caller) skips this
    phase when it saved a later one, returning its best. When it saved
    this one, the run continues: the optimizer's state, the key, best and
    scheduler are restored, and the run goes on after the saved epoch,
    or, from a mid-epoch save, in the same epoch past its completed
    windows, which are dropped from the host stream before they reach the
    device."""
    if resume is not None and resume.skips(phase_name):
        print(f"Resume targets {resume.resume['meta']['phase_name']} "
              f"phase; skipping {phase_name}")
        return resume.initial_best()
    best = best or PhaseResult(0.0, 0, None)
    key = Key(args.seed)
    start_epoch = start_step = 0
    payload = resume.for_phase(phase_name) if resume is not None else None
    meta = None
    if payload is not None:
        meta = payload["meta"]
        start_step = int(meta.get("step") or 0)
        start_epoch = int(meta["epoch"]) + (0 if start_step else 1)
        key = Key(meta["key"])
        best = resume.initial_best()
        optimizer.load_state_dict(payload["optimizer"])
        if scheduler is not None and meta["scheduler"]:
            scheduler.load_state_dict(meta["scheduler"])
            set_learning_rate(optimizer, scheduler.lr)
        print(f"[{phase_name}] resuming at epoch {start_epoch}"
              + (f" step {start_step}" if start_step else "")
              + f" (best={best.best_val_acc:.3f})")
    n_batches = math.ceil(len(batcher.m) / batch_size)
    n_windows = math.ceil(n_batches / max(acc_steps, 1))
    resume_every = max(int(args.resume_every_steps or 0), 0)
    save = functools.partial(
        save_train_state, model=model, optimizer=optimizer,
        model_name=model_name, phase_name=phase_name, scheduler=scheduler,
        layers=layers)
    for epoch in range(start_epoch, epochs):
        t0 = time.time()
        order = None
        if balanced_sampler:
            order = imbalanced_sample_order(batcher.m,
                                            seed=args.seed * 1000 + epoch)
        host = stacked_batches(batcher, batch_size, acc_steps,
                               seed=args.seed * 77 + epoch, order=order,
                               keys=keys)
        losses, grad_norms, param_norm = [], [], None
        skip = 0
        if epoch == start_epoch and start_step:
            # a mid-epoch resume: the epoch's stream is the same again
            # (seed, epoch, order), so its completed windows are dropped
            # and its metrics so far restored. skip == n_windows is the
            # save at the epoch's last window; more can only come from a
            # stale file or another batch geometry
            skip = start_step
            if skip > n_windows:
                raise SystemExit(
                    f"RESUME step {skip} > {n_windows} optimizer windows "
                    f"in epoch {epoch} ({n_batches} batches / acc_steps="
                    f"{max(acc_steps, 1)}): a stale RESUME file, or a "
                    "changed --batch_size / --acc_steps / dataset? Delete "
                    "the RESUME file to start the epoch over.")
            losses = list(meta.get("losses") or [])
            grad_norms = list(meta.get("grad_norms") or [])
            param_norm = meta.get("param_norm")
            host = itertools.islice(host, skip, None)
        for bi, stack in enumerate(to_device(host, device,
                                             depth=args.prefetch_depth)):
            key, step_key = key.split(2)
            loss, _, norms = train_step(stack, step_key)
            losses.append(loss)
            grad_norms.append(norms["grad_norm"])
            param_norm = norms["param_norm"]
            done = skip + bi + 1
            if save_resume and resume_every and done % resume_every == 0:
                save(key=key, epoch=epoch, best=best, step=done,
                     losses=losses, grad_norms=grad_norms,
                     param_norm=param_norm)
            print(f"Batches {(done - 1) * max(acc_steps, 1)}/{n_batches} "
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
                args=args, fine_tuning=fine_tuning, keep_top_k=keep_top_k,
                layers=layers))
        if scheduler is not None:
            set_learning_rate(optimizer, scheduler.step(val_acc))
        if save_resume:
            save(key=key, epoch=epoch, best=best)
    return best
