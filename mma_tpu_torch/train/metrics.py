"""Evaluation metrics, on tensors or numpy arrays.

The same surface as the JAX package's ``mma_tpu/train/metrics.py``: the
metric the reference uses (``node_classification/utils.py:132-136``
accuracy; inline L1/MAE in ``graph_regression/mma.py:156,181``) and its
(dead, but inventoried) ``metrics.py`` grab-bag: argmax accuracy, SBM
class-balanced accuracy, binary/weighted F1.
"""

from __future__ import annotations

import numpy as np
import torch


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def _argmax_np(logits) -> np.ndarray:
    return _tensor(logits).argmax(dim=-1).cpu().numpy()


def accuracy(logits, labels) -> torch.Tensor:
    """Argmax accuracy (utils.py:132-136 / metrics.py:20-27), 0-d float32."""
    logits, labels = _tensor(logits), _tensor(labels)
    preds = logits.argmax(dim=-1)
    return (preds == labels.to(preds.device)).float().mean()


def mae(scores, targets) -> torch.Tensor:
    """Mean absolute error (metrics.py:14-17)."""
    return (_tensor(scores) - _tensor(targets)).abs().mean()


def accuracy_tu(logits, labels) -> torch.Tensor:
    """TU-benchmark argmax accuracy (metrics.py:20-27) — same computation
    as :func:`accuracy`, kept under the reference's name for coverage."""
    return accuracy(logits, labels)


def accuracy_sbm(logits, labels) -> float:
    """Class-balanced accuracy over present classes (metrics.py:38-55)."""
    preds = _argmax_np(logits)
    labels = _tensor(labels).cpu().numpy()
    accs = []
    for c in np.unique(labels):
        sel = labels == c
        accs.append(float((preds[sel] == c).mean()))
    return float(np.mean(accs)) * 100.0


def _f1(preds, labels, average: str) -> float:
    preds = np.asarray(preds)
    labels = np.asarray(labels)
    classes = np.unique(np.concatenate([labels, preds]))
    f1s, weights = [], []
    for c in classes:
        tp = float(((preds == c) & (labels == c)).sum())
        fp = float(((preds == c) & (labels != c)).sum())
        fn = float(((preds != c) & (labels == c)).sum())
        denom = 2 * tp + fp + fn
        f1s.append(0.0 if denom == 0 else 2 * tp / denom)
        weights.append(float((labels == c).sum()))
    if average == "binary":
        # F1 of the positive class (class 1), sklearn 'binary' semantics
        # (metrics.py:58-63).
        idx = list(classes).index(1) if 1 in classes else None
        return 0.0 if idx is None else f1s[idx]
    if average == "weighted":
        w = np.asarray(weights)
        return float((np.asarray(f1s) * w).sum() / max(w.sum(), 1.0))
    return float(np.mean(f1s))


def binary_f1_score(logits, labels) -> float:
    return _f1(_argmax_np(logits), _tensor(labels).cpu().numpy(), "binary")


def weighted_f1_score(logits, labels) -> float:
    return _f1(_argmax_np(logits), _tensor(labels).cpu().numpy(), "weighted")
