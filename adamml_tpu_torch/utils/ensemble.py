"""Offline prediction-ensemble scoring (``adamml_tpu/utils/ensemble.py``;
--pred_files / --pred_weights / --after_softmax, reference opts.py:123-127).

The reference defines these flags but never consumes them in either
training script; here they do what their names promise: load one or more
saved eval logits matrices (the val_*.npy artifacts written by `-e`),
optionally softmax each, combine with per-file weights, and score
top-1/top-5/mAP against the val list's labels (the metric stack of live
eval, utils/metrics.actnet_acc).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .metrics import _softmax, actnet_acc


def ensemble_score(pred_files: Sequence[str],
                   labels: np.ndarray,
                   pred_weights: Optional[Sequence[float]] = None,
                   after_softmax: bool = False) -> dict:
    """Returns {"top1", "top5", "mAP", "scores"} for the weighted ensemble.

    pred_files: paths to (N, K) .npy logits matrices, all over the same N
    samples in val-list order (the order `-e` writes them in).
    pred_weights: one weight per file (default: all 1.0).
    after_softmax: combine softmax probabilities instead of raw logits.
    """
    if not pred_files:
        raise ValueError("pred_files is empty")
    weights = ([1.0] * len(pred_files) if pred_weights is None
               else list(pred_weights))
    if len(weights) != len(pred_files):
        raise ValueError(
            f"{len(pred_files)} pred_files but {len(weights)} pred_weights")
    total = None
    for path, w in zip(pred_files, weights):
        scores = np.load(path)
        if scores.ndim != 2:
            raise ValueError(f"{path}: expected (N, K) matrix, "
                             f"got shape {scores.shape}")
        if scores.shape[0] != len(labels):
            raise ValueError(
                f"{path}: {scores.shape[0]} rows but {len(labels)} labels")
        if after_softmax:
            scores = _softmax(scores.astype(np.float64))
        contrib = w * scores
        total = contrib if total is None else total + contrib
    # with after_softmax the ensemble is already a probability matrix:
    # actnet_acc must not softmax it a second time
    (top1, top5), mAP = actnet_acc(total, labels,
                                   have_softmaxed=after_softmax)
    return {"top1": top1, "top5": top5, "mAP": mAP, "scores": total}
