"""Evaluation loop: host batches -> device -> step -> predictions.

The port of the JAX package's ``eval/harness.py``: ``run_eval`` with the
same return value ``(acc %, labels, preds, stats)`` and the same stats
keys, and the image-only step (``make_eval_step`` / ``run_image_eval``:
normalize on the device -> model -> argmax + masked correct count).
Batches reach the device through pinned memory with non_blocking copies
(``data/pipeline.to_device``); the step runs under ``inference_mode``.
With a data-parallel ``DataMesh`` each rank evaluates its rows of every
batch and the predictions are gathered in the one-process order
(``parallel/multihost.run_eval_multiprocess``).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from ..data.images import normalize_on_device
from ..data.pipeline import to_device


def make_eval_step(model, compute_dtype=torch.bfloat16):
    """The eval step of an image model: ``model(ImageNet-normalized NHWC
    images) -> logits``."""
    def step(batch):
        x = normalize_on_device(batch["image"], dtype=compute_dtype)
        preds = model(x).float().argmax(dim=-1).to(torch.int32)
        correct = ((preds == batch["label"]) * batch["valid"]).sum()
        return preds, correct

    return step


def run_eval(step: Callable, batcher, batch_size: int, device,
             keys: Tuple[str, ...] = ("image", "label", "valid"),
             progress: bool = True, prefetch_depth: int = 2, mesh=None
             ) -> Tuple[float, np.ndarray, np.ndarray, Dict]:
    """Full-dataset eval. ``step(batch) -> (preds, correct)`` takes a dict
    of device tensors; returns (acc %, labels, preds, timing stats). With
    a `mesh` of several ranks every rank returns the whole result;
    `batch_size` is the global batch, which the world size divides."""
    if mesh is not None and mesh.distributed:
        from ..parallel.multihost import run_eval_multiprocess

        return run_eval_multiprocess(step, batcher, batch_size, mesh,
                                     keys=keys, progress=progress,
                                     prefetch_depth=prefetch_depth)
    n_total = len(batcher.m)
    all_preds, all_labels = [], []
    correct = 0
    step_times = []
    keep = set(keys)
    t0 = time.perf_counter()
    host_iter = ({k: v for k, v in b.items() if k in keep}
                 for b in batcher.iter_batches(batch_size, shuffle=False))
    for i, batch in enumerate(to_device(host_iter, device,
                                        depth=prefetch_depth)):
        ts = time.perf_counter()
        with torch.inference_mode():
            preds, c = step(batch)
        preds_np = preds.cpu().numpy()
        correct += int(c)
        step_times.append(time.perf_counter() - ts)
        valid = batch["valid"].cpu().numpy().astype(bool)
        all_preds.append(preds_np[valid])
        all_labels.append(batch["label"].cpu().numpy()[valid])
        if progress:
            print(f"Test batches {i}/{(n_total + batch_size - 1) // batch_size} ",
                  end="\r")
    wall = time.perf_counter() - t0
    labels = np.concatenate(all_labels)
    preds = np.concatenate(all_preds)
    acc = 100.0 * correct / n_total
    # per-step wall includes the prediction readback (a device sync);
    # pipeline_samples_per_s is the end-to-end number a user sees
    stats = {
        "wall_s": wall,
        "pipeline_samples_per_s": n_total / wall if wall > 0 else 0.0,
        "samples_per_s": n_total / wall if wall > 0 else 0.0,
        "p50_step_s": float(np.percentile(step_times, 50)) if step_times else 0.0,
        "p50_includes_host_readback": True,
        "n": n_total,
    }
    return acc, labels, preds, stats


def run_image_eval(model, batcher, batch_size: int, device,
                   compute_dtype=torch.bfloat16, progress: bool = True,
                   prefetch_depth: int = 2, mesh=None
                   ) -> Tuple[float, np.ndarray, np.ndarray, Dict]:
    """Full-dataset image eval. Returns (acc %, labels, preds, stats)."""
    return run_eval(make_eval_step(model, compute_dtype), batcher,
                    batch_size, device,
                    keys=("image", "label", "valid"), progress=progress,
                    prefetch_depth=prefetch_depth, mesh=mesh)
