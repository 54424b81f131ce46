"""Classification metrics for the test-split evaluation.

Port of artgraph_tpu/metrics/classification.py: accuracy, top-k accuracy,
balanced accuracy, per-class and averaged precision/recall/F1 and the
confusion matrix, with scikit-learn's definitions (zero_division=0), in
numpy over the host copies of the predictions.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def accuracy(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    return float(np.mean(np.asarray(y_true) == np.asarray(y_pred)))


def top_k_accuracy(y_true: np.ndarray, scores: np.ndarray, k: int = 2) -> float:
    """Fraction of rows whose true label is among the top-k scored classes."""
    topk = np.argsort(-scores, axis=-1)[:, :k]
    return float(np.mean(np.any(topk == np.asarray(y_true)[:, None], axis=1)))


def confusion_matrix(y_true: np.ndarray, y_pred: np.ndarray,
                     num_classes: int) -> np.ndarray:
    """[C, C] matrix with rows = true class, cols = predicted class."""
    y_true = np.asarray(y_true, dtype=np.int64)
    y_pred = np.asarray(y_pred, dtype=np.int64)
    cm = np.zeros((num_classes, num_classes), dtype=np.int64)
    np.add.at(cm, (y_true, y_pred), 1)
    return cm


def balanced_accuracy(y_true: np.ndarray, y_pred: np.ndarray,
                      num_classes: int) -> float:
    """Mean per-class recall over classes present in y_true (sklearn semantics)."""
    cm = confusion_matrix(y_true, y_pred, num_classes)
    support = cm.sum(axis=1)
    present = support > 0
    recalls = np.zeros(num_classes, dtype=np.float64)
    recalls[present] = np.diag(cm)[present] / support[present]
    return float(recalls[present].mean())


def precision_recall_f1(y_true: np.ndarray, y_pred: np.ndarray,
                        num_classes: int) -> Dict[str, np.ndarray]:
    """Per-class precision/recall/F1 plus macro and weighted averages.

    Zero-division cases yield 0.0 (sklearn's zero_division=0 default).
    """
    cm = confusion_matrix(y_true, y_pred, num_classes)
    tp = np.diag(cm).astype(np.float64)
    pred_count = cm.sum(axis=0).astype(np.float64)
    support = cm.sum(axis=1).astype(np.float64)

    precision = np.divide(tp, pred_count, out=np.zeros_like(tp), where=pred_count > 0)
    recall = np.divide(tp, support, out=np.zeros_like(tp), where=support > 0)
    denom = precision + recall
    f1 = np.divide(2 * precision * recall, denom,
                   out=np.zeros_like(tp), where=denom > 0)

    total = max(support.sum(), 1.0)
    return {
        "precision": precision,
        "recall": recall,
        "f1": f1,
        "support": support,
        "macro-precision": float(precision.mean()),
        "macro-recall": float(recall.mean()),
        "macro-f1": float(f1.mean()),
        "weighted-precision": float((precision * support).sum() / total),
        "weighted-recall": float((recall * support).sum() / total),
        "weighted-f1": float((f1 * support).sum() / total),
    }


def summarize(y_true: np.ndarray, scores: np.ndarray, num_classes: int,
              class_names: Optional[list] = None) -> Dict[str, object]:
    """Full evaluation summary for one task from raw logits/scores [N, C]."""
    y_pred = np.argmax(scores, axis=-1)
    prf = precision_recall_f1(y_true, y_pred, num_classes)
    return {
        "accuracy": accuracy(y_true, y_pred),
        "top-2-accuracy": top_k_accuracy(y_true, scores, k=2),
        "balanced-accuracy": balanced_accuracy(y_true, y_pred, num_classes),
        "macro-f1": prf["macro-f1"],
        "macro-precision": prf["macro-precision"],
        "macro-recall": prf["macro-recall"],
        "weighted-f1": prf["weighted-f1"],
        "weighted-precision": prf["weighted-precision"],
        "weighted-recall": prf["weighted-recall"],
        "per_class": prf,
        "confusion_matrix": confusion_matrix(y_true, y_pred, num_classes),
        "y_true": np.asarray(y_true),
        "y_pred": y_pred,
        "class_names": class_names,
    }
