"""Evaluation report artifacts — reference-compatible CSV + PNG.

Mirrors calculate_test_accuracy_image.py:103-131: a torchmetrics-style
confusion matrix rendered as a seaborn heatmap PNG, and an sklearn
``classification_report(output_dict=True)`` dumped through
``pd.DataFrame.from_dict(...).to_csv(index=True)``. Filenames match the
reference patterns so downstream thesis tooling keeps working:

  conf_matrix_image_model_{model}_test_set_acc_{acc:.2f}.png
  image_model_{model}_report_test_set_acc_{acc:.2f}.csv

(and the text/both variants, reference calculate_test_accuracy_text.py /
_both.py use the same shape with different prefixes).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Sequence

import numpy as np

from .. import CLASS_DISPLAY_NAMES


def confusion_matrix(labels: np.ndarray, preds: np.ndarray,
                     num_classes: int = 4) -> np.ndarray:
    """Rows = true class, cols = predicted (torchmetrics ConfusionMatrix
    convention used at calculate_test_accuracy_image.py:104)."""
    m = np.zeros((num_classes, num_classes), np.int64)
    np.add.at(m, (labels.astype(np.int64), preds.astype(np.int64)), 1)
    return m


def classification_report_dict(labels, preds,
                               target_names: Sequence[str] = CLASS_DISPLAY_NAMES):
    """sklearn ``classification_report(output_dict=True, zero_division=0)``
    over the labels 0..C-1, computed with numpy (the train CLI logs it on
    machines without sklearn): per class precision, recall, f1-score =
    2 tp / (true + pred) and support, then accuracy and the macro and
    support-weighted averages — sklearn's formulas, all as Python floats."""
    y = np.asarray(labels).astype(np.int64)
    p = np.asarray(preds).astype(np.int64)
    cm = confusion_matrix(y, p, len(target_names)).astype(np.float64)
    tp, true, pred = np.diag(cm), cm.sum(1), cm.sum(0)

    def div(a, b):
        return np.divide(a, b, out=np.zeros_like(a), where=b != 0)

    scores = {"precision": div(tp, pred), "recall": div(tp, true),
              "f1-score": div(2.0 * tp, true + pred)}
    out = {name: {**{k: float(v[c]) for k, v in scores.items()},
                  "support": float(true[c])}
           for c, name in enumerate(target_names)}
    out["accuracy"] = float(np.mean(y == p)) if len(y) else 0.0
    total = float(true.sum())
    out["macro avg"] = {**{k: float(np.average(v)) for k, v in
                           scores.items()}, "support": total}
    out["weighted avg"] = {**{k: float(np.average(v, weights=true))
                              if total else 0.0 for k, v in scores.items()},
                           "support": total}
    return out


def generate_report_and_image(labels: np.ndarray, preds: np.ndarray,
                              test_acc: float, out_dir: str, model_tag: str,
                              kind: str = "image") -> dict:
    """Write the confusion-matrix PNG + report CSV; returns the report dict.

    kind: 'image' | 'text' | 'both' — matches the reference filename
    prefixes per test script.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import pandas as pd
    import seaborn as sn

    Path(out_dir).mkdir(parents=True, exist_ok=True)
    conf = confusion_matrix(labels, preds, len(CLASS_DISPLAY_NAMES))
    df_cm = pd.DataFrame(conf, index=list(CLASS_DISPLAY_NAMES),
                         columns=list(CLASS_DISPLAY_NAMES))
    plt.rcParams.update({"font.size": 16})
    plt.figure(figsize=(10, 5))
    sn.heatmap(df_cm, annot=True, cmap="viridis", fmt="g")
    png = os.path.join(
        out_dir, f"conf_matrix_{kind}_model_{model_tag}_test_set_acc_{test_acc:.2f}.png")
    plt.savefig(png)
    plt.close()

    report = classification_report_dict(labels, preds)
    csv = os.path.join(
        out_dir, f"{kind}_model_{model_tag}_report_test_set_acc_{test_acc:.2f}.csv")
    pd.DataFrame.from_dict(report).to_csv(csv, index=True)
    return report
