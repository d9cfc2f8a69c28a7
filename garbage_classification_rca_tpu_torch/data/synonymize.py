"""Text synonym augmentation (host-side, train-only).

The port's own copy of the JAX package's ``data/synonymize.py``: swap up to
3 words of the short garbage description with synonyms from a curated
domain table, with a deterministic RNG, gated per batch at
``--prob_aug_text`` by the text trainer. The reference paraphrases with
Llama-3.1-8B-Instruct; that backend (``make_hf_llm_fn``) is not ported yet
and raises.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

# compact domain table for the Calgary garbage-text vocabulary
SYNONYMS = {
    "bottle": ["flask", "container", "vial"],
    "can": ["tin", "canister"],
    "cup": ["mug", "beaker"],
    "box": ["carton", "crate", "case"],
    "bag": ["sack", "pouch"],
    "paper": ["sheet", "page"],
    "newspaper": ["paper", "gazette"],
    "plastic": ["polymer"],
    "glass": ["crystal"],
    "metal": ["steel", "alloy"],
    "food": ["meal", "leftovers"],
    "peel": ["skin", "rind"],
    "battery": ["cell", "powercell"],
    "phone": ["handset", "mobile"],
    "old": ["used", "worn"],
    "broken": ["damaged", "cracked"],
    "empty": ["hollow", "drained"],
    "small": ["little", "tiny"],
    "large": ["big", "huge"],
    "water": ["drinking"],
    "coffee": ["espresso"],
    "waste": ["trash", "refuse"],
    "container": ["receptacle", "holder"],
    "wrapper": ["wrapping", "foil"],
    "jar": ["pot", "vessel"],
    "lid": ["cap", "cover"],
    "toy": ["plaything"],
    "clothes": ["garments", "apparel"],
    "shoe": ["sneaker", "boot"],
}

MAX_SWAPS = 3  # reference contract: swap <= 3 words


class Synonymizer:
    def __init__(self, seed: int = 0,
                 llm_fn: Optional[Callable[[str], str]] = None):
        self.rng = np.random.default_rng(seed)
        self.llm_fn = llm_fn

    def augment(self, text: str) -> str:
        if self.llm_fn is not None:
            return self.llm_fn(text)
        words = text.split()
        swappable = [i for i, w in enumerate(words) if w.lower() in SYNONYMS]
        if not swappable:
            return text
        self.rng.shuffle(swappable)
        for i in swappable[:MAX_SWAPS]:
            options = SYNONYMS[words[i].lower()]
            words[i] = options[int(self.rng.integers(len(options)))]
        return " ".join(words)


def make_hf_llm_fn(model_path: str = None, **kw):
    """The reference's LLM paraphraser backend (``GC_RCA_LLM_PATH``)."""
    raise NotImplementedError(
        "the Llama paraphraser backend (GC_RCA_LLM_PATH) is not ported to "
        "PyTorch yet (ROADMAP.md, queue 1 item 4); the JAX package runs it, "
        "and the port's --use_synonyms runs the rule table")
