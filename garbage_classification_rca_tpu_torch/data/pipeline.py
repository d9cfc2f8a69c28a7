"""Batched host -> device input pipeline.

The port's own copy of the JAX package's ``data/pipeline.py``:
  * a thread pool decoding/resizing images into fixed-shape uint8 arrays
    (PIL decode + ``pad_to_aspect_ratio`` + cv2 ``resize_linear``; threads,
    since PIL/cv2 release the GIL in their C cores),
  * fixed-shape batches: the dataset tail is padded to the full batch and
    masked downstream by ``valid``,
  * ``to_device``: pinned host memory and non_blocking copies, a few
    batches ahead, so the copy of the next batch overlaps the current step.

Batch dict layout:
  image: uint8 [B, H, W, 3]       (normalized on the device; left out
                                   with ``with_images=False``, text eval)
  input_ids / attention_mask: int32 [B, L]   (when text is requested)
  label: int32 [B]
  valid: int32 [B]  (1 = real sample, 0 = tail padding)
"""

from __future__ import annotations

import concurrent.futures as cf
import queue
import threading
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from .images import load_rgb, pad_to_aspect_ratio, resize_linear
from .manifest import Manifest
from .tokenizer import BaseTokenizer


def batch_indices(n: int, batch_size: int, *, shuffle: bool,
                  seed: int = 0, order: Optional[np.ndarray] = None
                  ) -> List[np.ndarray]:
    """Batch plan over ``order`` (default: 0..n-1), shuffled with `seed`
    when asked; the tail batch is padded later with valid=0."""
    idx = np.arange(n) if order is None else np.asarray(order)
    if shuffle:
        idx = np.random.default_rng(seed).permutation(idx)
    return [idx[start:start + batch_size]
            for start in range(0, len(idx), batch_size)]


class _ProducerError:
    """Carries a producer-thread exception across the queue so the
    consumer raises instead of silently ending the epoch early."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class ImageTextBatcher:
    """Decodes batches of (image, text, label) on host threads."""

    def __init__(self, manifest: Manifest, image_size: Tuple[int, int],
                 tokenizer: Optional[BaseTokenizer] = None,
                 seq_len: int = 64, extended_desc: bool = False,
                 workers: int = 8, with_images: bool = True):
        self.m = manifest
        self.image_size = image_size
        self.tokenizer = tokenizer
        self.seq_len = seq_len
        self.extended = extended_desc
        self.with_images = with_images
        self.pool = (cf.ThreadPoolExecutor(max_workers=workers)
                     if with_images else None)

    def close(self):
        if self.pool:
            self.pool.shutdown(wait=False)

    def make_batch(self, indices: np.ndarray,
                   batch_size: int) -> Dict[str, np.ndarray]:
        n = len(indices)
        padded = np.concatenate([indices, np.zeros(batch_size - n, np.int64)]) \
            if n < batch_size else indices
        samples = [self.m.samples[i] for i in padded]
        batch: Dict[str, np.ndarray] = {
            "label": np.asarray([s.label for s in samples], np.int32),
            "valid": np.asarray([1] * n + [0] * (batch_size - n), np.int32),
        }
        if self.with_images:
            h, w = self.image_size
            raw = list(self.pool.map(lambda s: load_rgb(s.image_path),
                                     samples))
            out = np.stack([resize_linear(pad_to_aspect_ratio(im, w / h), h,
                                          w) for im in raw])
            batch["image"] = out.astype(np.uint8, copy=False)
        if self.tokenizer is not None:
            texts = [s.effective_text(self.extended) for s in samples]
            enc = self.tokenizer.encode_batch(texts, self.seq_len)
            batch["input_ids"] = enc.input_ids
            batch["attention_mask"] = enc.attention_mask
        return batch

    def iter_batches(self, batch_size: int, *, shuffle: bool = False,
                     seed: int = 0, order: Optional[np.ndarray] = None,
                     prefetch: int = 2) -> Iterator[Dict[str, np.ndarray]]:
        """Yield fixed-shape batches, preparing `prefetch` batches ahead on a
        background thread. ``order``: the sample indices to batch (the
        balanced sampler's draw); default all samples once."""
        plans = batch_indices(len(self.m), batch_size, shuffle=shuffle,
                              seed=seed, order=order)
        q: "queue.Queue" = queue.Queue(maxsize=max(prefetch, 1))
        stop = threading.Event()

        def put_polling(item) -> bool:
            # bounded puts that watch the stop event, so an abandoned
            # consumer does not pin this thread and its batches
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    pass
            return False

        def producer():
            end: object = None
            try:
                for plan in plans:
                    if stop.is_set():
                        return
                    put_polling(self.make_batch(plan, batch_size))
            except BaseException as e:  # noqa: BLE001 — surfaced below
                # a decode error must FAIL the epoch, not truncate it
                end = _ProducerError(e)
            finally:
                if not put_polling(end):
                    try:
                        q.put_nowait(end)
                    except queue.Full:
                        pass

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, _ProducerError):
                    raise RuntimeError(
                        "input pipeline failed while decoding a batch"
                    ) from item.exc
                yield item
        finally:
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass


def to_device(host_iter, device, depth: int = 2):
    """Move host batches (dicts of numpy arrays) to `device` ahead of
    consumption. On CUDA the arrays go through pinned host memory with
    non_blocking copies, so up to `depth` upcoming copies overlap the
    current step; depth <= 0 turns the lookahead off."""
    import torch

    device = torch.device(device)
    pin = device.type == "cuda"

    def put(b):
        out = {}
        for k, a in b.items():
            t = torch.from_numpy(np.ascontiguousarray(a))
            if pin:
                t = t.pin_memory()
            out[k] = t.to(device, non_blocking=pin)
        return out

    return lookahead(map(put, host_iter), depth)


def lookahead(it, depth: int = 2):
    """Pull-ahead buffer: materialize up to ``depth`` upcoming items while
    the caller consumes the current one; depth <= 0 passes through."""
    if depth <= 0:
        yield from it
        return
    buf: List = []
    it = iter(it)
    try:
        for _ in range(depth):
            buf.append(next(it))
    except StopIteration:
        pass
    while buf:
        nxt = buf.pop(0)
        try:
            buf.append(next(it))
        except StopIteration:
            pass
        yield nxt
