"""Host-side image decode + geometry; device-side normalization.

The port's own copy of the JAX package's ``data/images.py`` host path:
  * host: JPEG decode (PIL), pad-to-aspect-ratio (np.pad), INTER_LINEAR
    resize (cv2) -> fixed-shape uint8 [H, W, 3]; uint8 keeps the
    host-to-device copy 4x smaller than fp32;
  * device: ``(x/255 - mean)/std`` as one torch op on the batch's device;
  * the BLIP-2 host path: PIL bicubic to 224 x 224 uint8
    (``blip_preprocess_image``), CLIP statistics.

Geometry parity with the reference eval pipeline (PadToAR -> Resize ->
Normalize), including the quirks of its pad transform (see
``pad_to_aspect_ratio``). PIL and cv2 are imported lazily.
"""

from __future__ import annotations

import numpy as np


def load_rgb(path: str) -> np.ndarray:
    """Decode to uint8 RGB HWC."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def pad_to_aspect_ratio(img: np.ndarray, aspect_ratio: float) -> np.ndarray:
    """Zero-pad to `aspect_ratio`, reproducing the reference's
    keep_aspect_ratio transform exactly — including its quirks. It compares
    H/W (shape[0]/shape[1]) against the target, but its local names
    width/height are swapped, so the pad AMOUNT mixes axes while the padded
    AXIS follows the branch:

      * H/W < target ("increase width"):  pad WIDTH by int(target*W) - H
      * H/W > target ("increase height"): pad HEIGHT by int(H/target) - W

    both sides padded by int(pad/2) (an odd pad loses one pixel — kept).
    (40,80)@AR1 -> (40,120), (80,40)@AR1 -> (120,40), (33,47)@AR1 -> (33,61)."""
    h, w = img.shape[0], img.shape[1]
    current = h / w
    if current == aspect_ratio:
        return img
    if current < aspect_ratio:
        pad = int(aspect_ratio * w) - h
        half = int(pad / 2)
        return np.pad(img, ((0, 0), (half, half), (0, 0)), mode="constant")
    pad = int(h / aspect_ratio) - w
    half = int(pad / 2)
    return np.pad(img, ((half, half), (0, 0), (0, 0)), mode="constant")


def resize_linear(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """cv2 INTER_LINEAR resize (A.Resize parity)."""
    import cv2

    return cv2.resize(img, (width, height), interpolation=cv2.INTER_LINEAR)


# ImageNet stats — the reference's default normalization
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

# OpenAI-CLIP stats — HF BlipImageProcessor defaults (BLIP-2 pipelines)
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def blip_preprocess_image(path: str, size: int = 224) -> np.ndarray:
    """HF BlipImageProcessor host path: PIL bicubic resize to (size, size),
    uint8 out (the CLIP normalization runs on the device). PIL's bicubic
    scales its filter to the reduction factor, as HF's processors do."""
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB").resize((size, size), Image.BICUBIC)
        return np.asarray(im)


def normalize_on_device(x_uint8, mean=None, std=None, dtype=None):
    """uint8 NHWC tensor -> normalized float NHWC on the same device:
    ``x * (1 / (255 std)) + (-mean / std)`` in fp32, then cast to `dtype`
    (A.Normalize parity, the JAX package's scale/shift formula)."""
    import torch

    mean = IMAGENET_MEAN if mean is None else np.asarray(mean, np.float32)
    std = IMAGENET_STD if std is None else np.asarray(std, np.float32)
    scale = torch.from_numpy((1.0 / (255.0 * std)).astype(np.float32))
    shift = torch.from_numpy((-mean / std).astype(np.float32))
    y = x_uint8.float() * scale.to(x_uint8.device) + shift.to(x_uint8.device)
    return y.to(dtype) if dtype is not None else y
