"""Evaluation report artifacts — reference-compatible CSV + PNG.

Mirrors calculate_test_accuracy_image.py:103-131: a torchmetrics-style
confusion matrix rendered as a seaborn heatmap PNG, and an sklearn
``classification_report(output_dict=True)`` as
``pd.DataFrame.from_dict(...).to_csv(index=True)`` writes it (here with the
standard library's ``csv``, byte for byte, so the report needs neither
pandas nor sklearn; the PNG needs matplotlib and seaborn and is skipped,
with a printed line, where they are missing). Filenames match the
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


def write_report_csv(report: dict, path: str) -> None:
    """``pd.DataFrame.from_dict(report).to_csv(path, index=True)`` with the
    standard library, byte for byte: one column per key of `report` (a
    scalar such as "accuracy" repeated down its column), one row per metric
    in the order the metrics first appear, floats as ``repr``."""
    import csv

    cols = list(report)
    rows = []
    for v in report.values():
        if isinstance(v, dict):
            rows += [k for k in v if k not in rows]

    def cell(v, row):
        if isinstance(v, dict):
            v = v.get(row)
        return "" if v is None else repr(float(v))

    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow([""] + cols)
        for r in rows:
            w.writerow([r] + [cell(report[c], r) for c in cols])


def draw_confusion_png(conf: np.ndarray, png: str) -> bool:
    """The reference's seaborn heatmap of the confusion matrix, where
    matplotlib and seaborn import; otherwise one line on stdout saying the
    PNG was not drawn and why. Returns whether it was drawn."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        import seaborn as sn
    except ImportError as e:
        print(f"report: confusion PNG not drawn ({png}): {e}", flush=True)
        return False
    plt.rcParams.update({"font.size": 16})
    plt.figure(figsize=(10, 5))
    names = list(CLASS_DISPLAY_NAMES)
    sn.heatmap(conf, annot=True, cmap="viridis", fmt="g", xticklabels=names,
               yticklabels=names)
    plt.savefig(png)
    plt.close()
    return True


def generate_report_and_image(labels: np.ndarray, preds: np.ndarray,
                              test_acc: float, out_dir: str, model_tag: str,
                              kind: str = "image") -> dict:
    """Write the confusion-matrix PNG + report CSV; returns the report dict.

    kind: 'image' | 'text' | 'both' — matches the reference filename
    prefixes per test script. The CSV needs the standard library only; the
    PNG needs matplotlib and seaborn (``draw_confusion_png``).
    """
    Path(out_dir).mkdir(parents=True, exist_ok=True)
    conf = confusion_matrix(labels, preds, len(CLASS_DISPLAY_NAMES))
    draw_confusion_png(conf, os.path.join(
        out_dir, f"conf_matrix_{kind}_model_{model_tag}_test_set_acc_{test_acc:.2f}.png"))
    report = classification_report_dict(labels, preds)
    csv = os.path.join(
        out_dir, f"{kind}_model_{model_tag}_report_test_set_acc_{test_acc:.2f}.csv")
    write_report_csv(report, csv)
    return report
