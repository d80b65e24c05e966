"""Multiclass classification metrics from confusion sufficient statistics.

Computes everything ``MulticlassClassificationEvaluator`` supports from
per-class true-positive / false-positive / label counts plus an accumulated
log-loss sum — tiny, mergeable across shards (semantics follow Spark's
Scala ``MulticlassMetrics``; reference analog:
``spark_rapids_ml/metrics/MulticlassMetrics.py``).

The statistics live in aligned numpy arrays keyed by a sorted class vector
(not per-class dicts): ``from_predictions`` is one ``np.unique`` + three
``bincount`` calls over the shard, and every aggregate is a vectorized
reduction.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np


def log_loss(labels: np.ndarray, probs: np.ndarray, eps: float) -> float:
    """Sum of -log(p[label]) with probabilities clamped at ``eps``.

    Validation semantics follow Spark's logLoss contract (same checks the
    reference performs, ``MulticlassMetrics.py:24-31``): labels within the
    class range, probabilities within [0, 1]. Labels are read as class
    indices via int truncation; integrality itself is not checked (nor
    does the reference check it).
    """
    n_classes = probs.shape[1]
    if np.any(labels < 0) or np.any(labels > n_classes - 1):
        raise ValueError(
            f"log_loss: label out of range — every label must lie in "
            f"[0, {n_classes - 1}] for {n_classes}-column probabilities"
        )
    if np.any(probs < 0) or np.any(probs > 1.0):
        raise ValueError(
            "log_loss: probability out of range — every entry of probs "
            "must lie in [0.0, 1.0]"
        )
    p = probs[np.arange(probs.shape[0]), labels.astype(np.int32)]
    return float(-np.log(np.maximum(p, eps)).sum())


class MulticlassMetrics:
    """Metrics for multiclass classification (confusion-count based)."""

    SUPPORTED_MULTI_CLASS_METRIC_NAMES = [
        "f1",
        "accuracy",
        "weightedPrecision",
        "weightedRecall",
        "weightedTruePositiveRate",
        "weightedFalsePositiveRate",
        "weightedFMeasure",
        "truePositiveRateByLabel",
        "falsePositiveRateByLabel",
        "precisionByLabel",
        "recallByLabel",
        "fMeasureByLabel",
        "hammingLoss",
        "logLoss",
    ]

    def __init__(
        self,
        classes: Optional[np.ndarray] = None,
        tp: Optional[np.ndarray] = None,
        fp: Optional[np.ndarray] = None,
        label_counts: Optional[np.ndarray] = None,
        n_rows: int = 0,
        log_loss_sum: float = -1.0,
    ) -> None:
        self._classes = (
            np.asarray(classes, np.float64) if classes is not None else np.empty(0)
        )
        z = np.zeros_like(self._classes)
        self._tp = np.asarray(tp, np.float64) if tp is not None else z.copy()
        self._fp = np.asarray(fp, np.float64) if fp is not None else z.copy()
        self._label_counts = (
            np.asarray(label_counts, np.float64) if label_counts is not None else z.copy()
        )
        self._n_rows = int(n_rows)
        self._log_loss_sum = float(log_loss_sum)

    @classmethod
    def from_predictions(
        cls,
        labels: np.ndarray,
        predictions: np.ndarray,
        probs: Optional[np.ndarray] = None,
        eps: float = 1.0e-15,
    ) -> "MulticlassMetrics":
        """Build the sufficient statistics from a (shard of) predictions —
        fully vectorized: one unique-encode plus three bincounts."""
        labels = np.asarray(labels, np.float64)
        predictions = np.asarray(predictions, np.float64)
        n = labels.shape[0]
        classes, codes = np.unique(
            np.concatenate([labels, predictions]), return_inverse=True
        )
        lab_c, pred_c = codes[:n], codes[n:]
        k = len(classes)
        hit = lab_c == pred_c
        tp = np.bincount(lab_c[hit], minlength=k).astype(np.float64)
        fp = np.bincount(pred_c[~hit], minlength=k).astype(np.float64)
        label_counts = np.bincount(lab_c, minlength=k).astype(np.float64)
        ll = log_loss(labels, probs, eps) if probs is not None else -1.0
        return cls(classes, tp, fp, label_counts, n, ll)

    def merge(self, other: "MulticlassMetrics") -> "MulticlassMetrics":
        """Merge two shards' sufficient statistics (class-vector union)."""
        classes = np.union1d(self._classes, other._classes)

        def _scatter(m: "MulticlassMetrics", arr: np.ndarray) -> np.ndarray:
            out = np.zeros(len(classes))
            out[np.searchsorted(classes, m._classes)] = arr
            return out

        ll = (
            self._log_loss_sum + other._log_loss_sum
            if self._log_loss_sum >= 0 and other._log_loss_sum >= 0
            else -1.0
        )
        return MulticlassMetrics(
            classes,
            _scatter(self, self._tp) + _scatter(other, other._tp),
            _scatter(self, self._fp) + _scatter(other, other._fp),
            _scatter(self, self._label_counts) + _scatter(other, other._label_counts),
            self._n_rows + other._n_rows,
            ll,
        )

    # -- vectorized per-class pieces ---------------------------------------
    @staticmethod
    def _safe_div(num: np.ndarray, den: np.ndarray) -> np.ndarray:
        return np.divide(num, den, out=np.zeros_like(np.asarray(num, np.float64)),
                         where=np.asarray(den) != 0)

    def _precision_vec(self) -> np.ndarray:
        return self._safe_div(self._tp, self._tp + self._fp)

    def _recall_vec(self) -> np.ndarray:
        return self._safe_div(self._tp, self._label_counts)

    def _fmeasure_vec(self, beta: float = 1.0) -> np.ndarray:
        p, r = self._precision_vec(), self._recall_vec()
        b2 = beta * beta
        return self._safe_div((1 + b2) * p * r, b2 * p + r)

    def _fpr_vec(self) -> np.ndarray:
        return self._safe_div(self._fp, self._n_rows - self._label_counts)

    def _at(self, vec: np.ndarray, label: float) -> float:
        i = np.searchsorted(self._classes, float(label))
        if i < len(self._classes) and self._classes[i] == float(label):
            return float(vec[i])
        return 0.0

    def _weighted(self, vec: np.ndarray) -> float:
        return float((vec * self._label_counts).sum() / self._n_rows)

    # -- aggregates ---------------------------------------------------------
    def accuracy(self) -> float:
        return float(self._tp.sum() / self._n_rows)

    def hamming_loss(self) -> float:
        return float(self._fp.sum() / self._n_rows)

    def weighted_fmeasure(self, beta: float = 1.0) -> float:
        return self._weighted(self._fmeasure_vec(beta))

    def weighted_precision(self) -> float:
        return self._weighted(self._precision_vec())

    def weighted_recall(self) -> float:
        return self._weighted(self._recall_vec())

    def weighted_false_positive_rate(self) -> float:
        return self._weighted(self._fpr_vec())

    def false_positive_rate(self, label: float) -> float:
        return self._at(self._fpr_vec(), label)

    def log_loss(self) -> float:
        return self._log_loss_sum / self._n_rows

    def evaluate(self, evaluator: Any) -> float:
        """Compute the metric an evaluator asks for."""
        name = evaluator.getMetricName()
        if name == "f1":
            return self.weighted_fmeasure()
        if name == "accuracy":
            return self.accuracy()
        if name == "weightedPrecision":
            return self.weighted_precision()
        if name in ("weightedRecall", "weightedTruePositiveRate"):
            return self.weighted_recall()
        if name == "weightedFalsePositiveRate":
            return self.weighted_false_positive_rate()
        if name == "weightedFMeasure":
            return self.weighted_fmeasure(evaluator.getBeta())
        if name in ("truePositiveRateByLabel", "recallByLabel"):
            return self._at(self._recall_vec(), evaluator.getMetricLabel())
        if name == "falsePositiveRateByLabel":
            return self.false_positive_rate(evaluator.getMetricLabel())
        if name == "precisionByLabel":
            return self._at(self._precision_vec(), evaluator.getMetricLabel())
        if name == "fMeasureByLabel":
            return self._at(
                self._fmeasure_vec(evaluator.getBeta()), evaluator.getMetricLabel()
            )
        if name == "hammingLoss":
            return self.hamming_loss()
        if name == "logLoss":
            return self.log_loss()
        raise ValueError(f"Unsupported metric name, found {name}")
