"""Regression metrics from mergeable moment vectors.

Everything ``RegressionEvaluator`` supports (rmse/mse/r2/mae/var, Spark
semantics) computes from four length-3 moment vectors over the series
``[label, residual, prediction]``:

    mean = 1/N · Σ x        m2n = Σ (x − mean)²  (centered)
    m2   = Σ x²             l1  = Σ |x|

Two shards merge exactly with the Chan et al. parallel-variance update —
the same sufficient-statistics contract as the reference's
``RegressionMetrics``/``_SummarizerBuffer``
(``spark_rapids_ml/metrics/RegressionMetrics.py``,
itself a port of Spark's Scala ``SummarizerBuffer``), held here as
vectorized numpy state rather than per-series Python lists.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np


class RegressionMetrics:
    """Mergeable regression metrics over [label, residual, prediction]."""

    def __init__(
        self,
        n: int,
        mean: np.ndarray,
        m2n: np.ndarray,
        m2: np.ndarray,
        l1: np.ndarray,
    ) -> None:
        self._n = int(n)
        self._mean = np.asarray(mean, np.float64)
        self._m2n = np.asarray(m2n, np.float64)
        self._m2 = np.asarray(m2, np.float64)
        self._l1 = np.asarray(l1, np.float64)

    @classmethod
    def from_predictions(
        cls, labels: np.ndarray, predictions: np.ndarray
    ) -> "RegressionMetrics":
        """Build the moment vectors from a (shard of) predictions — one
        stacked (3, n) pass."""
        y = np.asarray(labels, np.float64)
        p = np.asarray(predictions, np.float64)
        s = np.stack([y, y - p, p])  # (3, n)
        mean = s.mean(axis=1)
        return cls(
            n=y.shape[0],
            mean=mean,
            m2n=((s - mean[:, None]) ** 2).sum(axis=1),
            m2=(s * s).sum(axis=1),
            l1=np.abs(s).sum(axis=1),
        )

    def merge(self, other: "RegressionMetrics") -> "RegressionMetrics":
        """Exact shard merge (Chan et al. parallel variance, weights = 1)."""
        na, nb = self._n, other._n
        n = na + nb
        if n == 0:
            return RegressionMetrics(0, self._mean, self._m2n, self._m2, self._l1)
        delta = other._mean - self._mean
        return RegressionMetrics(
            n=n,
            mean=self._mean + delta * (nb / n),
            m2n=self._m2n + other._m2n + delta * delta * (na * nb / n),
            m2=self._m2 + other._m2,
            l1=self._l1 + other._l1,
        )

    # series indices: 0 = label, 1 = residual, 2 = prediction
    @property
    def mean_squared_error(self) -> float:
        if self._n == 0:
            raise ZeroDivisionError("metrics undefined on an empty dataset")
        return float(self._m2[1] / self._n)

    @property
    def root_mean_squared_error(self) -> float:
        return math.sqrt(self.mean_squared_error)

    @property
    def mean_absolute_error(self) -> float:
        return float(self._l1[1] / self._n)

    def _variance(self) -> np.ndarray:
        """Unbiased sample variance per series (Spark semantics; unit
        weights make the correction denominator n − 1)."""
        denom = self._n - 1
        if denom > 0:
            return np.maximum(self._m2n / denom, 0.0)
        return np.zeros_like(self._m2n)

    def r2(self, through_origin: bool) -> float:
        # fail loudly on degenerate denominators (constant labels / n<=1):
        # a silent nan would make every model-selection comparison False
        ss_err = self._m2[1]
        if through_origin:
            if self._m2[0] == 0.0:
                raise ZeroDivisionError("r2 undefined: sum of squared labels is 0")
            return float(1 - ss_err / self._m2[0])
        ss_tot = self._variance()[0] * (self._n - 1)
        if ss_tot == 0.0:
            raise ZeroDivisionError("r2 undefined: label variance is 0")
        return float(1 - ss_err / ss_tot)

    @property
    def explained_variance(self) -> float:
        # Spark's SS_reg / N with SS_reg = Σŷ² + ȳ²·N − 2·ȳ·mean(ŷ)·N
        ss_reg = (
            self._m2[2]
            + self._mean[0] ** 2 * self._n
            - 2 * self._mean[0] * self._mean[2] * self._n
        )
        return float(ss_reg / self._n)

    def evaluate(self, evaluator: Any) -> float:
        name = evaluator.getMetricName()
        if name == "rmse":
            return self.root_mean_squared_error
        if name == "mse":
            return self.mean_squared_error
        if name == "r2":
            return self.r2(evaluator.getThroughOrigin())
        if name == "mae":
            return self.mean_absolute_error
        if name == "var":
            return self.explained_variance
        raise ValueError(f"Unsupported metric name, found {name}")
