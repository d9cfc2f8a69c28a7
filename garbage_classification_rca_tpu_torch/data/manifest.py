"""Dataset manifest: folder walk + filename-derived text.

Capability parity with the reference ``CustomImageTextFolder``
(CVPR_code/CustomImageTextFolder.py):

  * class = folder name, sorted -> index (reference :130-142),
  * text = preprocessed filename stem — lowercase, ``_``->space, digits and
    non-letter symbols stripped (reference ``pre_process_text`` :29-42),
  * optional long description looked up from a captions CSV keyed by
    ``class_dir/file.jpg`` (reference :81-112, consumed via
    ``--extended_desc_*``),
  * per-class sample lists kept for class-weight math (reference :94-126).

Unlike the reference (which tokenizes inside ``__getitem__`` per sample),
the manifest is a plain host-side index; tokenization and image decode
happen in the batched pipeline so the device sees fixed-shape arrays only.
"""

from __future__ import annotations

import csv
import os
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif",
                  ".tiff", ".webp")

_DIGITS = re.compile(r"[0-9]")
_NON_ALPHA = re.compile(r"[^a-zA-Z ]+")


def pre_process_text(text: str) -> str:
    """Filename stem -> text (reference CustomImageTextFolder.py:29-42)."""
    text = text.lower().replace("_", " ")
    text = _DIGITS.sub("", text)
    text = _NON_ALPHA.sub("", text)
    return text.strip()


def find_classes(directory: str) -> Tuple[List[str], Dict[str, int]]:
    """Sorted subdirectory names -> class indices (reference :130-142)."""
    classes = sorted(e.name for e in os.scandir(directory) if e.is_dir())
    if not classes:
        raise FileNotFoundError(f"Couldn't find any class folder in {directory}.")
    return classes, {c: i for i, c in enumerate(classes)}


@dataclass(frozen=True)
class Sample:
    image_path: str
    text: str
    label: int
    long_text: str = ""

    def effective_text(self, extended: bool) -> str:
        return self.long_text if (extended and self.long_text) else self.text


@dataclass
class Manifest:
    root: str
    classes: List[str]
    class_to_idx: Dict[str, int]
    samples: List[Sample]
    per_class: List[List[Sample]] = field(default_factory=list)

    def __len__(self):
        return len(self.samples)

    def class_counts(self) -> List[int]:
        return [len(c) for c in self.per_class]

    def class_weights(self) -> List[float]:
        """total / (C * count_c) — reference main_image.py:65-82."""
        counts = self.class_counts()
        total = float(sum(counts))
        c = len(counts)
        return [total / (c * n) for n in counts]

    def labels(self) -> List[int]:
        return [s.label for s in self.samples]


def _load_captions_csv(path: str) -> Dict[str, str]:
    """captions CSV 'filename,description' keyed by class_dir/file.jpg
    (reference CustomImageTextFolder.py:81-112, produced by
    llama_caption.py)."""
    lookup: Dict[str, str] = {}
    with open(path, newline="", encoding="utf-8") as f:
        reader = csv.DictReader(f)
        if reader.fieldnames is None or "filename" not in reader.fieldnames \
                or "description" not in reader.fieldnames:
            raise ValueError(
                f"captions CSV {path} must have 'filename,description' header")
        for row in reader:
            lookup[row["filename"]] = row["description"] or ""
    return lookup


def build_manifest(root: str, extended_desc: Optional[str] = None) -> Manifest:
    root = os.path.expanduser(root)
    classes, class_to_idx = find_classes(root)
    lookup = _load_captions_csv(extended_desc) if extended_desc else None

    samples: List[Sample] = []
    per_class: List[List[Sample]] = [[] for _ in classes]
    available = set()
    for cls in classes:
        idx = class_to_idx[cls]
        cls_dir = os.path.join(root, cls)
        for dirpath, _, fnames in sorted(os.walk(cls_dir, followlinks=True)):
            for fname in sorted(fnames):
                if not fname.lower().endswith(IMG_EXTENSIONS):
                    continue
                path = os.path.join(dirpath, fname)
                text = pre_process_text(Path(path).stem)
                long_text = ""
                if lookup is not None:
                    # keyed class/file.jpg (CustomImageTextFolder.py:81-112)
                    # — the CLASS dir, not the immediate parent: images in
                    # nested subfolders would otherwise silently miss
                    # their captions
                    key = os.path.join(cls, fname)
                    long_text = lookup.get(key, "") or ""
                s = Sample(path, text, idx, long_text)
                samples.append(s)
                per_class[idx].append(s)
                available.add(cls)

    empty = set(classes) - available
    if empty:
        raise FileNotFoundError(
            f"Found no valid file for the classes {', '.join(sorted(empty))}. "
            f"Supported extensions are: {', '.join(IMG_EXTENSIONS)}")
    return Manifest(root, classes, class_to_idx, samples, per_class)
