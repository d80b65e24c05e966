"""Spark-free evaluators — API-compatible with ``pyspark.ml.evaluation``
(a copy of ``spark_rapids_ml_tpu/evaluation.py``, which imports no JAX).

The reference consumes Spark's evaluators (``RegressionEvaluator``,
``MulticlassClassificationEvaluator``, ``BinaryClassificationEvaluator``)
inside its single-pass CrossValidator (reference ``tuning.py:91-148`` and
the ``_transformEvaluate`` mixins). This framework is Spark-free, so the
same evaluator surface is provided here: params (labelCol/predictionCol/
metricName/...), ``evaluate(dataset) -> float`` and ``isLargerBetter()``.

``evaluate`` computes from materialized prediction columns; the heavy path
(CV) goes through the models' ``_transformEvaluate`` which computes all
models' metrics in one device pass and only hands the tiny sufficient
statistics to these metric objects.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from .data.dataframe import DataFrame
from .metrics import MulticlassMetrics, RegressionMetrics
from .params import Params, TypeConverters, _mk


class Evaluator(Params):
    """Base evaluator (``pyspark.ml.evaluation.Evaluator`` contract)."""

    def evaluate(self, dataset: DataFrame) -> float:
        raise NotImplementedError

    def isLargerBetter(self) -> bool:
        return True

    def _set_params(self, **kwargs: Any) -> "Evaluator":
        for name, value in kwargs.items():
            if not self.hasParam(name):
                raise ValueError(f"Unknown param {name!r} for {type(self).__name__}")
            self._set(**{name: value})
        return self

    def setLabelCol(self, value: str) -> "Evaluator":
        self._set(labelCol=value)
        return self

    def setPredictionCol(self, value: str) -> "Evaluator":
        self._set(predictionCol=value)
        return self

    def setMetricName(self, value: str) -> "Evaluator":
        self._set(metricName=value)
        return self

    def getMetricName(self) -> str:
        return self.getOrDefault("metricName")

    def getLabelCol(self) -> str:
        return self.getOrDefault("labelCol")

    def getPredictionCol(self) -> str:
        return self.getOrDefault("predictionCol")


class RegressionEvaluator(Evaluator):
    """Drop-in for ``pyspark.ml.evaluation.RegressionEvaluator``."""

    labelCol = _mk("labelCol", "label column", TypeConverters.toString)
    predictionCol = _mk("predictionCol", "prediction column", TypeConverters.toString)
    metricName = _mk("metricName", "rmse|mse|r2|mae|var", TypeConverters.toString)
    throughOrigin = _mk(
        "throughOrigin", "r2 through the origin", TypeConverters.toBoolean
    )

    def __init__(self, **kwargs: Any) -> None:
        super().__init__()
        self._setDefault(
            labelCol="label",
            predictionCol="prediction",
            metricName="rmse",
            throughOrigin=False,
        )
        self._set_params(**kwargs)

    def getThroughOrigin(self) -> bool:
        return self.getOrDefault("throughOrigin")

    def isLargerBetter(self) -> bool:
        return self.getMetricName() in ("r2", "var")

    def evaluate(self, dataset: DataFrame) -> float:
        y = np.asarray(dataset.column(self.getLabelCol()), dtype=np.float64)
        p = np.asarray(dataset.column(self.getPredictionCol()), dtype=np.float64)
        return RegressionMetrics.from_predictions(y, p).evaluate(self)


class MulticlassClassificationEvaluator(Evaluator):
    """Drop-in for ``pyspark.ml.evaluation.MulticlassClassificationEvaluator``."""

    labelCol = _mk("labelCol", "label column", TypeConverters.toString)
    predictionCol = _mk("predictionCol", "prediction column", TypeConverters.toString)
    probabilityCol = _mk("probabilityCol", "probability column (logLoss)", TypeConverters.toString)
    metricName = _mk(
        "metricName",
        "|".join(MulticlassMetrics.SUPPORTED_MULTI_CLASS_METRIC_NAMES),
        TypeConverters.toString,
    )
    metricLabel = _mk("metricLabel", "class for byLabel metrics", TypeConverters.toFloat)
    beta = _mk("beta", "beta for F-measure", TypeConverters.toFloat)
    eps = _mk("eps", "log-loss probability clamp", TypeConverters.toFloat)

    def __init__(self, **kwargs: Any) -> None:
        super().__init__()
        self._setDefault(
            labelCol="label",
            predictionCol="prediction",
            probabilityCol="probability",
            metricName="f1",
            metricLabel=0.0,
            beta=1.0,
            eps=1.0e-15,
        )
        self._set_params(**kwargs)

    def getMetricLabel(self) -> float:
        return self.getOrDefault("metricLabel")

    def getBeta(self) -> float:
        return self.getOrDefault("beta")

    def getEps(self) -> float:
        return self.getOrDefault("eps")

    def getProbabilityCol(self) -> str:
        return self.getOrDefault("probabilityCol")

    def isLargerBetter(self) -> bool:
        return self.getMetricName() not in (
            "weightedFalsePositiveRate",
            "falsePositiveRateByLabel",
            "hammingLoss",
            "logLoss",
        )

    def evaluate(self, dataset: DataFrame) -> float:
        y = np.asarray(dataset.column(self.getLabelCol()), dtype=np.float64)
        p = np.asarray(dataset.column(self.getPredictionCol()), dtype=np.float64)
        probs = None
        if self.getMetricName() == "logLoss":
            if self.getProbabilityCol() not in dataset:
                raise ValueError(
                    f"logLoss requires probability column "
                    f"{self.getProbabilityCol()!r}; dataset has {dataset.columns}"
                )
            probs = np.asarray(dataset.column(self.getProbabilityCol()), dtype=np.float64)
        m = MulticlassMetrics.from_predictions(y, p, probs, self.getEps())
        return m.evaluate(self)


class BinaryClassificationEvaluator(Evaluator):
    """Drop-in for ``pyspark.ml.evaluation.BinaryClassificationEvaluator``.

    Computes the exact (trapezoidal) ROC/PR area rather than Spark's
    ``numBins`` down-sampled approximation — ``numBins`` is accepted for API
    compatibility.
    """

    labelCol = _mk("labelCol", "label column", TypeConverters.toString)
    rawPredictionCol = _mk(
        "rawPredictionCol", "raw prediction / score column", TypeConverters.toString
    )
    metricName = _mk("metricName", "areaUnderROC|areaUnderPR", TypeConverters.toString)
    numBins = _mk("numBins", "curve down-sampling bins (unused; exact)", TypeConverters.toInt)

    def __init__(self, **kwargs: Any) -> None:
        super().__init__()
        self._setDefault(
            labelCol="label",
            rawPredictionCol="rawPrediction",
            metricName="areaUnderROC",
            numBins=1000,
        )
        self._set_params(**kwargs)

    def getRawPredictionCol(self) -> str:
        return self.getOrDefault("rawPredictionCol")

    def setRawPredictionCol(self, value: str) -> "BinaryClassificationEvaluator":
        self._set(rawPredictionCol=value)
        return self

    def evaluate(self, dataset: DataFrame) -> float:
        y = np.asarray(dataset.column(self.getLabelCol()), dtype=np.float64)
        raw = np.asarray(dataset.column(self.getRawPredictionCol()))
        score = raw[:, 1] if raw.ndim == 2 else raw.astype(np.float64)
        return self._area(y, np.asarray(score, dtype=np.float64))

    def _area(self, y: np.ndarray, score: np.ndarray) -> float:
        order = np.argsort(-score, kind="stable")
        y_sorted = y[order]
        score_sorted = score[order]
        tps = np.cumsum(y_sorted)
        fps = np.cumsum(1.0 - y_sorted)
        # collapse ties: keep the last point of each distinct score
        distinct = np.nonzero(np.diff(score_sorted))[0]
        idx = np.concatenate([distinct, [len(y_sorted) - 1]])
        tps, fps = tps[idx], fps[idx]
        P = tps[-1] if len(tps) else 0.0
        N = fps[-1] if len(fps) else 0.0
        if self.getMetricName() == "areaUnderROC":
            tpr = np.concatenate([[0.0], tps / max(P, 1e-300)])
            fpr = np.concatenate([[0.0], fps / max(N, 1e-300)])
            return float(np.trapezoid(tpr, fpr))
        elif self.getMetricName() == "areaUnderPR":
            precision = tps / np.maximum(tps + fps, 1e-300)
            recall = tps / max(P, 1e-300)
            precision = np.concatenate([[1.0], precision])
            recall = np.concatenate([[0.0], recall])
            return float(np.trapezoid(precision, recall))
        raise ValueError(f"Unsupported metric name, found {self.getMetricName()}")


def prediction_agreement(live: np.ndarray, shadow: np.ndarray) -> float:
    """Shadow-vs-live agreement score for canary evaluation
    (``serving/lifecycle.py``): how well a candidate version's outputs
    reproduce the currently-served version's on the SAME mirrored
    requests, treating the live outputs as the label column.

    Integral-valued outputs on both sides (class predictions, cluster
    ids) score as ``MulticlassClassificationEvaluator`` accuracy;
    anything continuous scores as ``RegressionEvaluator`` r2. Both are
    larger-better with 1.0 = perfect agreement, so one
    ``TPUML_CANARY_MIN_SCORE`` threshold covers every family. A
    constant live column degenerates r2 — scored as exact-match
    fraction instead (agreement against a constant is just equality).
    """
    y = np.asarray(live, dtype=np.float64).ravel()
    p = np.asarray(shadow, dtype=np.float64).ravel()
    if y.shape != p.shape:
        raise ValueError(
            f"live/shadow prediction shapes differ: {y.shape} vs {p.shape}"
        )
    if y.size == 0:
        raise ValueError("prediction_agreement needs at least one pair")
    df = DataFrame({"label": y, "prediction": p})
    if np.array_equal(y, np.rint(y)) and np.array_equal(p, np.rint(p)):
        return float(
            MulticlassClassificationEvaluator(metricName="accuracy")
            .evaluate(df)
        )
    if np.ptp(y) == 0.0:
        return float(np.mean(y == p))
    return float(RegressionEvaluator(metricName="r2").evaluate(df))
