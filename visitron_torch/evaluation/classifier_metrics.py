"""Question-asking classifier metrics: accuracy, F1, balanced accuracy, MCC
(visitron_tpu/evaluation/classifier_metrics.py).

Self-contained numpy implementations of the sklearn calls used by the
reference classifier agent (tasks/viewpoint_select/classifier/agent.py:596-603),
so the metric path has no sklearn dependency in the hot loop.
"""

from __future__ import annotations

import numpy as np


def binary_classification_metrics(y_true, y_pred) -> dict[str, float]:
    y_true = np.asarray(y_true).astype(np.int64).ravel()
    y_pred = np.asarray(y_pred).astype(np.int64).ravel()
    assert y_true.shape == y_pred.shape
    tp = float(np.sum((y_true == 1) & (y_pred == 1)))
    tn = float(np.sum((y_true == 0) & (y_pred == 0)))
    fp = float(np.sum((y_true == 0) & (y_pred == 1)))
    fn = float(np.sum((y_true == 1) & (y_pred == 0)))
    n = tp + tn + fp + fn
    accuracy = (tp + tn) / n if n else 0.0
    precision = tp / (tp + fp) if (tp + fp) else 0.0
    recall = tp / (tp + fn) if (tp + fn) else 0.0
    f1 = 2 * precision * recall / (precision + recall) if (precision + recall) else 0.0
    tnr = tn / (tn + fp) if (tn + fp) else 0.0
    balanced_accuracy = 0.5 * (recall + tnr)
    denom = np.sqrt((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
    mcc = (tp * tn - fp * fn) / denom if denom else 0.0
    return {
        "accuracy": accuracy,
        "precision": precision,
        "recall": recall,
        "f1": f1,
        "balanced_accuracy": balanced_accuracy,
        "mcc": float(mcc),
    }
