"""Class balancing: the imbalanced (re)sampler (the port's copy of the JAX
package's ``data/sampler.py``).

Per-sample weight 1 / class_count, sampled WITH replacement to the
dataset length (reference imbalanced_sampler/imbalanced.py:9-69), wired
via --balanced_sampler. Class weights for the loss live on the Manifest.
"""

from __future__ import annotations

import numpy as np

from .manifest import Manifest


def imbalanced_sample_order(manifest: Manifest, seed: int,
                            num_samples: int | None = None) -> np.ndarray:
    labels = np.asarray(manifest.labels())
    counts = np.bincount(labels, minlength=len(manifest.classes))
    weights = 1.0 / counts[labels]
    p = weights / weights.sum()
    rng = np.random.default_rng(seed)
    n = num_samples or len(labels)
    return rng.choice(len(labels), size=n, replace=True, p=p)
