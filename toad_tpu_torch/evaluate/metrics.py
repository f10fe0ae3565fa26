"""Metrics primitives (the port's own copy of :mod:`toad_tpu.evaluate.metrics`, numpy only): ROC-AUC (binary / OVR macro / micro), top-k, per-class
accuracy — numpy-native, no sklearn dependency.

Semantics match what the reference gets from sklearn (cross-checked against
sklearn in ``tests/test_metrics.py``):

- binary AUC equals trapezoidal ROC AUC; we compute it as the tie-corrected
  Mann-Whitney U statistic (identical value, one O(n log n) sort instead of
  a curve build) — reference call sites ``core_utils_mtl_concat.py:318-333``;
- macro OVR: per-class one-vs-rest AUC, ``nan`` for classes absent from the
  labels, then nanmean (reference ``:322-331``);
- micro OVR: ravel the one-hot labels/probs over *present* classes, then
  binary AUC (reference ``eval_utils_mtl_concat.py:147-153``);
- top-k accuracy (reference ``eval_utils_mtl_concat.py:49-63``);
- :class:`AccuracyLogger` per-class counts (reference
  ``core_utils_mtl_concat.py:13-42``).
"""

from __future__ import annotations

import numpy as np


def binary_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """ROC AUC for binary labels via tie-corrected rank statistic.

    Returns nan when only one class is present (callers decide the sentinel;
    the reference uses -1 in eval, see ``eval_utils_mtl_concat.py:131-132``).
    """
    labels = np.asarray(labels).astype(bool)
    scores = np.asarray(scores, dtype=np.float64)
    n_pos = int(labels.sum())
    n_neg = labels.size - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(scores, kind="mergesort")
    sorted_scores = scores[order]
    # average ranks for ties (1-based)
    ranks = np.empty(scores.size, dtype=np.float64)
    i = 0
    while i < scores.size:
        j = i
        while j + 1 < scores.size and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks[order[i : j + 1]] = 0.5 * (i + j) + 1.0
        i = j + 1
    rank_sum_pos = ranks[labels].sum()
    u = rank_sum_pos - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


def ovr_aucs(labels: np.ndarray, probs: np.ndarray, n_classes: int) -> np.ndarray:
    """Per-class one-vs-rest AUCs; nan where the class never appears."""
    labels = np.asarray(labels).astype(np.int64)
    out = np.full(n_classes, np.nan)
    for c in range(n_classes):
        if np.any(labels == c):
            out[c] = binary_auc(labels == c, probs[:, c])
    return out


def macro_ovr_auc(labels: np.ndarray, probs: np.ndarray, n_classes: int) -> float:
    return float(np.nanmean(ovr_aucs(labels, probs, n_classes)))


def micro_ovr_auc(labels: np.ndarray, probs: np.ndarray, n_classes: int) -> float:
    labels = np.asarray(labels).astype(np.int64)
    onehot = np.eye(n_classes, dtype=bool)[labels]
    valid = np.any(onehot, axis=0)
    return binary_auc(onehot[:, valid].ravel(), probs[:, valid].ravel())


def topk_accuracy(probs: np.ndarray, labels: np.ndarray, ks=(1, 3, 5)) -> dict[int, float]:
    """Fraction of samples whose true label is in the top-k predictions."""
    labels = np.asarray(labels).astype(np.int64)
    maxk = min(max(ks), probs.shape[1])
    topk = np.argsort(-probs, axis=1, kind="stable")[:, :maxk]
    hits = topk == labels[:, None]
    return {k: float(hits[:, : min(k, maxk)].any(axis=1).mean()) for k in ks}


def error_rate(preds: np.ndarray, labels: np.ndarray) -> float:
    """1 - accuracy (reference ``calculate_error``, ``utils/utils.py:135-138``)."""
    preds = np.asarray(preds)
    labels = np.asarray(labels)
    return float(1.0 - (preds == labels).mean())


def bootstrap_cis(
    labels: np.ndarray,
    probs: np.ndarray,
    site_labels: np.ndarray,
    site_scores: np.ndarray,
    *,
    preds: np.ndarray | None = None,
    n_boot: int = 1000,
    seed: int = 1,
    alpha: float = 0.05,
    micro_average: bool = False,
) -> dict[str, dict[str, float]]:
    """Nonparametric percentile-bootstrap confidence intervals over slides
    for the headline metrics (cls AUC/acc/top-3, site AUC).

    The TOAD paper reports 95% CIs for its AUCs but the reference repo
    computes none (point estimates only, ``eval_utils_mtl_concat.py:
    119-160``). Slides are resampled with replacement ``n_boot`` times.
    Vanished-class semantics per metric: the macro cls AUC nanmeans over the
    classes PRESENT in each draw (the :func:`macro_ovr_auc` estimand — such
    draws still count, with ``n_valid == n_boot``); the binary/micro cls AUC
    and the site AUC are undefined when a side vanishes, and those draws ARE
    excluded via nan-aware percentiles (``n_valid`` reports how many
    remained). ``cls_top3_acc`` is emitted only for ``n_classes > 3``
    (below that, top-3 is the constant 1.0 and the summary's top-3 column
    is NaN — a degenerate CI would contradict it).
    """
    labels = np.asarray(labels).astype(np.int64)
    probs = np.asarray(probs, np.float64)
    site_labels = np.asarray(site_labels).astype(np.int64)
    site_scores = np.asarray(site_scores, np.float64)
    n, n_classes = probs.shape
    preds = probs.argmax(1) if preds is None else np.asarray(preds).astype(np.int64)

    if n_classes == 2:
        def cls_auc_fn(y, p):
            return binary_auc(y, p[:, 1])
    elif micro_average:
        def cls_auc_fn(y, p):
            return micro_ovr_auc(y, p, n_classes)
    else:
        def cls_auc_fn(y, p):
            return macro_ovr_auc(y, p, n_classes)

    rng = np.random.RandomState(seed)
    with_top3 = n_classes > 3
    names = ("cls_auc", "cls_acc") + (("cls_top3_acc",) if with_top3 else ()) + ("site_auc",)
    draws = {k: np.empty(n_boot) for k in names}
    for b in range(n_boot):
        idx = rng.randint(0, n, n)
        y, p = labels[idx], probs[idx]
        draws["cls_auc"][b] = cls_auc_fn(y, p)
        draws["cls_acc"][b] = float((preds[idx] == y).mean())
        if with_top3:
            draws["cls_top3_acc"][b] = topk_accuracy(p, y, ks=(3,))[3]
        draws["site_auc"][b] = binary_auc(site_labels[idx], site_scores[idx])

    lo_q, hi_q = 100 * alpha / 2, 100 * (1 - alpha / 2)
    out: dict[str, dict[str, float]] = {}
    for k, v in draws.items():
        valid = int(np.isfinite(v).sum())
        out[k] = {
            "mean": float(np.nanmean(v)) if valid else float("nan"),
            "lo": float(np.nanpercentile(v, lo_q)) if valid else float("nan"),
            "hi": float(np.nanpercentile(v, hi_q)) if valid else float("nan"),
            "n_boot": n_boot,
            "n_valid": valid,
        }
    return out


class AccuracyLogger:
    """Per-class correct/count tallies (true-positive rate per class)."""

    def __init__(self, n_classes: int):
        self.n_classes = n_classes
        self.count = np.zeros(n_classes, dtype=np.int64)
        self.correct = np.zeros(n_classes, dtype=np.int64)

    def log(self, y_hat, y) -> None:
        y = int(y)
        self.count[y] += 1
        self.correct[y] += int(int(y_hat) == y)

    def log_batch(self, y_hats: np.ndarray, ys: np.ndarray, mask: np.ndarray | None = None) -> None:
        y_hats = np.asarray(y_hats).ravel()
        ys = np.asarray(ys).ravel()
        if mask is not None:
            keep = np.asarray(mask).ravel() > 0
            y_hats, ys = y_hats[keep], ys[keep]
        np.add.at(self.count, ys, 1)
        np.add.at(self.correct, ys, (y_hats == ys).astype(np.int64))

    def get_summary(self, c: int):
        count = int(self.count[c])
        correct = int(self.correct[c])
        acc = None if count == 0 else correct / count
        return acc, correct, count
