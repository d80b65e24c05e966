"""Hyper-parameter tuning of the port (counterpart of
``spark_rapids_ml_tpu/tuning.py``): ``ParamGridBuilder`` and the
single-pass ``CrossValidator``.

Where the estimator supports it (``_supportsTransformEvaluate``), a fold
fits **every** param map in one data pass (``fitMultiple``), stacks the
models into one (the model class's ``_combine``) and evaluates them all in
**one** transform pass (``_transformEvaluate``); otherwise it fits and
evaluates one param map at a time. The folds are the JAX package's
(``data.dataframe.kfold``) and run on a thread pool of
``min(parallelism, numFolds)`` threads.

Differences from the JAX package, by design:

* ``TPUML_CV_FAILFAST`` is the module constant :data:`CV_FAILFAST`;
* there is no gang branch: this is the JAX CV at ``TPUML_GANG_FIT=off``,
  its default;
* the ``cv.fold`` span and the ``cv_failed_fits`` counter are not ported.

The CV has no device of its own: each fit and transform runs where the
estimator runs (``cuda:0`` unless it was given ``device="cpu"``).
"""

from __future__ import annotations

import itertools
import json
import os
import threading
from multiprocessing.pool import ThreadPool
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .core import _Reader, _TpuEstimator, _TpuModel
from .data.dataframe import DataFrame, kfold
from .evaluation import Evaluator
from .params import Param, Params, TypeConverters, _mk
from .utils.logging import get_logger

# True (the reference's semantics): a failed fit or evaluation of any fold
# and param map aborts the search. False: a failed combination is recorded
# as the worst metric (±inf) and the search goes on.
CV_FAILFAST = True

# Serializes the device work of the fold threads (each fold's fits and its
# evaluation pass), as in the JAX package. Fold selection, ``_combine`` and
# the metrics run outside it. It also keeps module-level state of a fit,
# such as ``ops.streaming``'s ingest report, to one fit at a time.
_FOLD_DEVICE_LOCK = threading.Lock()


class ParamGridBuilder:
    """Drop-in for ``pyspark.ml.tuning.ParamGridBuilder``."""

    def __init__(self) -> None:
        self._param_grid: Dict[Param, List[Any]] = {}

    def addGrid(self, param: Param, values: Sequence[Any]) -> "ParamGridBuilder":
        if not isinstance(param, Param):
            raise TypeError("param must be an instance of Param")
        self._param_grid[param] = list(values)
        return self

    def baseOn(self, *args: Any) -> "ParamGridBuilder":
        if isinstance(args[0], dict):
            self.baseOn(*args[0].items())
            return self
        for param, value in args:
            self.addGrid(param, [value])
        return self

    def build(self) -> List[Dict[Param, Any]]:
        keys = list(self._param_grid.keys())
        grid_values = [self._param_grid[k] for k in keys]
        return [dict(zip(keys, combo)) for combo in itertools.product(*grid_values)]


class _CrossValidatorParams(Params):
    numFolds = _mk("numFolds", "number of folds (>= 2)", TypeConverters.toInt)
    seed = _mk("seed", "random seed for fold assignment", TypeConverters.toInt)
    parallelism = _mk("parallelism", "thread-pool width over folds", TypeConverters.toInt)
    collectSubModels = _mk(
        "collectSubModels", "keep all sub-models on the CV model", TypeConverters.toBoolean
    )

    def __init__(self) -> None:
        super().__init__()
        self._setDefault(numFolds=3, seed=0, parallelism=1, collectSubModels=False)

    def getNumFolds(self) -> int:
        return self.getOrDefault("numFolds")

    def getSeed(self) -> int:
        return self.getOrDefault("seed")

    def getParallelism(self) -> int:
        return self.getOrDefault("parallelism")


class CrossValidator(_CrossValidatorParams):
    """Drop-in for ``pyspark.ml.tuning.CrossValidator`` with the single-pass
    fold evaluation."""

    def __init__(
        self,
        estimator: Optional[_TpuEstimator] = None,
        estimatorParamMaps: Optional[List[Dict[Param, Any]]] = None,
        evaluator: Optional[Evaluator] = None,
        numFolds: int = 3,
        seed: int = 0,
        parallelism: int = 1,
        **kwargs: Any,
    ) -> None:
        super().__init__()
        self._est = estimator
        self._epm = estimatorParamMaps
        self._eva = evaluator
        self._set(numFolds=numFolds, seed=seed, parallelism=parallelism)
        for name, value in kwargs.items():
            if not self.hasParam(name):
                raise ValueError(f"Unknown param {name!r} for CrossValidator")
            self._set(**{name: value})
        self.logger = get_logger(type(self))

    # -- component accessors (pyspark API) ---------------------------------
    def setEstimator(self, value: _TpuEstimator) -> "CrossValidator":
        self._est = value
        return self

    def getEstimator(self) -> _TpuEstimator:
        return self._est

    def setEstimatorParamMaps(self, value: List[Dict[Param, Any]]) -> "CrossValidator":
        self._epm = value
        return self

    def getEstimatorParamMaps(self) -> List[Dict[Param, Any]]:
        return self._epm

    def setEvaluator(self, value: Evaluator) -> "CrossValidator":
        self._eva = value
        return self

    def getEvaluator(self) -> Evaluator:
        return self._eva

    def setNumFolds(self, value: int) -> "CrossValidator":
        self._set(numFolds=value)
        return self

    def setParallelism(self, value: int) -> "CrossValidator":
        self._set(parallelism=value)
        return self

    def setSeed(self, value: int) -> "CrossValidator":
        self._set(seed=value)
        return self

    def setCollectSubModels(self, value: bool) -> "CrossValidator":
        self._set(collectSubModels=value)
        return self

    # -- fit ---------------------------------------------------------------
    def fit(self, dataset: DataFrame) -> "CrossValidatorModel":
        est, epm, eva = self._est, self._epm, self._eva
        if est is None or epm is None or eva is None:
            raise ValueError("estimator, estimatorParamMaps and evaluator must be set")
        n_folds = self.getNumFolds()
        if n_folds < 2:
            raise ValueError("numFolds must be >= 2")
        single_pass = est._supportsTransformEvaluate(eva)
        folds = kfold(dataset, n_folds, self.getSeed())
        collect_sub = bool(self.getOrDefault("collectSubModels"))
        failfast = CV_FAILFAST
        # tolerant mode: a failed combination can never win the argmax /
        # argmin, and shows as ±inf in avgMetrics
        worst = -np.inf if eva.isLargerBetter() else np.inf

        def run_fold(i: int) -> Tuple[np.ndarray, Optional[List[_TpuModel]]]:
            train, validation = folds[i]
            if single_pass:
                try:
                    with _FOLD_DEVICE_LOCK:
                        # one data pass fits every param map
                        models: List[_TpuModel] = [m for _, m in est.fitMultiple(train, epm)]
                    combined = type(models[0])._combine(models)
                    with _FOLD_DEVICE_LOCK:
                        # one evaluation pass for every candidate
                        vals = combined._transformEvaluate(validation, eva)
                    return np.asarray(vals, dtype=np.float64), models if collect_sub else None
                except Exception:
                    if failfast:
                        raise
                    # the single-pass fit is all or nothing: the per-map loop
                    # below records only the failing combinations
                    self.logger.exception(
                        "fold %d: single-pass fit failed; retrying per param map (CV_FAILFAST=False)", i
                    )
            vals, sub = [], []
            for j, pm in enumerate(epm):
                try:
                    with _FOLD_DEVICE_LOCK:
                        model = est.fit(train, pm)
                        transformed = model.transform(validation)
                    vals.append(eva.evaluate(transformed))
                except Exception:
                    if failfast:
                        raise
                    self.logger.exception(
                        "fold %d param map %d: fit/evaluate failed; recording the worst metric "
                        "(CV_FAILFAST=False)", i, j,
                    )
                    vals.append(worst)
                    model = None
                if collect_sub:
                    sub.append(model)
            return np.asarray(vals, dtype=np.float64), sub if collect_sub else None

        par = max(1, self.getParallelism())
        if par > 1:
            with ThreadPool(processes=min(par, n_folds)) as pool:
                fold_results = pool.map(run_fold, range(n_folds))
        else:
            fold_results = [run_fold(i) for i in range(n_folds)]
        metrics = np.stack([m for m, _ in fold_results])
        sub_models = [s for _, s in fold_results] if collect_sub else None

        avg = np.mean(metrics, axis=0)
        best_idx = int(np.argmax(avg) if eva.isLargerBetter() else np.argmin(avg))
        if not np.isfinite(avg[best_idx]):
            raise RuntimeError(
                "CrossValidator: every param map failed in tolerant mode "
                "(CV_FAILFAST=False) — no finite metric to select a best "
                "model from"
            )
        self.logger.info("CrossValidator: best param map %d with avg metric %.6f", best_idx, avg[best_idx])
        best_model = est.fit(dataset, epm[best_idx])
        cv_model = CrossValidatorModel(
            bestModel=best_model, avgMetrics=list(avg), stdMetrics=list(np.std(metrics, axis=0))
        )
        cv_model.subModels = sub_models
        cv_model._est, cv_model._epm, cv_model._eva = est, epm, eva
        return cv_model


class CrossValidatorModel(_CrossValidatorParams):
    """Fitted CV model wrapping the best model (pyspark API surface)."""

    def __init__(
        self,
        bestModel: Optional[_TpuModel] = None,
        avgMetrics: Optional[List[float]] = None,
        stdMetrics: Optional[List[float]] = None,
    ) -> None:
        super().__init__()
        self.bestModel = bestModel
        self.avgMetrics = avgMetrics or []
        self.stdMetrics = stdMetrics or []
        self.subModels: Optional[List[Optional[List[_TpuModel]]]] = None

    def transform(self, dataset: DataFrame) -> DataFrame:
        return self.bestModel.transform(dataset)

    # -- persistence: the best model plus a metrics file --------------------
    def save(self, path: str) -> None:
        self.bestModel.save(path)
        with open(os.path.join(path, "cv_metadata.json"), "w") as f:
            json.dump({"avgMetrics": self.avgMetrics, "stdMetrics": self.stdMetrics}, f)

    @classmethod
    def load(cls, path: str) -> "CrossValidatorModel":
        best = _Reader(_TpuModel).load(path)
        avg, std = [], []
        meta_path = os.path.join(path, "cv_metadata.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                m = json.load(f)
            avg, std = m.get("avgMetrics", []), m.get("stdMetrics", [])
        return cls(bestModel=best, avgMetrics=avg, stdMetrics=std)
