"""Evaluation metrics in pure numpy (the port's copy of
``adamml_tpu/utils/metrics.py``).

Replaces the reference's torch top-k (reference utils/utils.py:42-56) and the
torchnet ClassErrorMeter / mAPMeter pair (reference utils/utils.py:58-86) with
dependency-free implementations. mAP follows torchnet's mAPMeter: per-class
average precision over the sample ranking, averaged over classes.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def _as_np(x) -> np.ndarray:
    return np.asarray(x)


def accuracy(output, target, topk: Sequence[int] = (1, 5)) -> list:
    """Top-k accuracy in percent (reference utils/utils.py:42-56).

    output: (N, C) logits; target: (N,) int labels.
    """
    output = _as_np(output)
    target = _as_np(target).reshape(-1)
    maxk = max(topk)
    n = target.shape[0]
    # indices of top-maxk classes, best first
    pred = np.argsort(-output, axis=1)[:, :maxk]  # (N, maxk)
    correct = pred == target[:, None]  # (N, maxk)
    res = []
    for k in topk:
        res.append(100.0 * float(correct[:, :k].sum()) / max(1, n))
    return res


def average_precision(scores: np.ndarray, labels: np.ndarray) -> float:
    """AP for one class: mean of precision@i over positive ranks
    (torchnet mAPMeter semantics used at reference utils/utils.py:83-86)."""
    order = np.argsort(-scores, kind="stable")
    labels = labels[order].astype(np.float64)
    n_pos = labels.sum()
    if n_pos == 0:
        return 0.0
    cumsum = np.cumsum(labels)
    ranks = np.arange(1, labels.shape[0] + 1, dtype=np.float64)
    precision_at_pos = (cumsum / ranks) * labels
    return float(precision_at_pos.sum() / n_pos)


def mean_average_precision(probs, gt) -> float:
    """mAP over classes; probs (N, C), gt (N, C) multi-hot."""
    probs = _as_np(probs)
    gt = _as_np(gt)
    aps = [average_precision(probs[:, c], gt[:, c]) for c in range(probs.shape[1])]
    return float(np.mean(aps))


def _softmax(x: np.ndarray) -> np.ndarray:
    x = x - x.max(axis=1, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=1, keepdims=True)


def actnet_acc(logits, test_y, topk=None, have_softmaxed: bool = False
               ) -> Tuple[list, float]:
    """Top-k accuracies + mAP over the full (gathered) eval matrix
    (reference utils/utils.py:58-86).

    Single-label targets -> top-k from logits and mAP against one-hot gt.
    Multi-label (2-D) targets -> acc zeros, mAP against the given gt.
    """
    logits = _as_np(logits)
    test_y = _as_np(test_y)
    num_classes = logits.shape[1]
    topk = [1, min(5, num_classes)] if topk is None else list(topk)
    single_label = test_y.ndim == 1
    probs = logits if have_softmaxed else _softmax(logits)
    if single_label:
        acc = accuracy(logits, test_y, topk=topk)
        gt = np.zeros_like(logits)
        gt[np.arange(gt.shape[0]), test_y.astype(int)] = 1.0
    else:
        acc = [0.0] * len(topk)
        gt = test_y
    ap = mean_average_precision(probs, gt) * 100.0
    return acc, ap
