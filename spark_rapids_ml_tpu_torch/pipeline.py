"""Pipeline and OneVsRest of the port (counterpart of
``spark_rapids_ml_tpu/pipeline.py``), the pyspark.ml meta-algorithms:

* ``Pipeline(stages=[...])`` fits its estimator stages in order, feeding
  each the running transform of the stages before it; transformer stages
  (already-fitted models) pass through. ``PipelineModel.transform`` chains
  every fitted stage.
* ``OneVsRest(classifier=...)`` fits one binary model per class (label k
  mapped to 1.0, the rest to 0.0) and predicts the class of the largest
  raw score.

Neither has a device of its own: each stage fits and transforms where its
estimator or model runs (``cuda:0`` unless it was given ``device="cpu"``).
A saved ``PipelineModel`` (``pipeline.json`` and ``stage_%03d/``) or
``OneVsRestModel`` (``ovr.json`` and ``model_%03d/``) has the JAX package's
layout, and either package's directories load here; a loaded stage runs on
``cuda:0`` until given another device (``setDevice``), as a loaded model
does.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .core import _Reader, _TpuEstimator, _TpuModel
from .data.dataframe import DataFrame


def _is_transformer(stage: Any) -> bool:
    return hasattr(stage, "transform") and not hasattr(stage, "fit")


class Pipeline:
    """Drop-in for ``pyspark.ml.Pipeline``."""

    def __init__(self, stages: Optional[Sequence[Any]] = None) -> None:
        self._stages: List[Any] = list(stages or [])

    def setStages(self, stages: Sequence[Any]) -> "Pipeline":
        self._stages = list(stages)
        return self

    def getStages(self) -> List[Any]:
        return list(self._stages)

    def fit(self, dataset: DataFrame) -> "PipelineModel":
        df = dataset
        fitted: List[Any] = []
        for i, stage in enumerate(self._stages):
            if _is_transformer(stage):
                model: Any = stage
            elif hasattr(stage, "fit"):
                model = stage.fit(df)
            else:
                raise TypeError(
                    f"Pipeline stage {i} ({type(stage).__name__}) is neither "
                    "an estimator nor a transformer"
                )
            fitted.append(model)
            if i + 1 < len(self._stages):
                df = model.transform(df)
        return PipelineModel(fitted)


class PipelineModel:
    """Chain of fitted stages (drop-in for ``pyspark.ml.PipelineModel``)."""

    def __init__(self, stages: Sequence[Any]) -> None:
        self.stages: List[Any] = list(stages)

    def transform(self, dataset: DataFrame) -> DataFrame:
        df = dataset
        for stage in self.stages:
            df = stage.transform(df)
        return df

    # -- persistence: one subdirectory per stage ---------------------------
    def save(self, path: str) -> None:
        if os.path.exists(path):
            raise FileExistsError(f"Path {path} exists; use write().overwrite()")
        self._save(path)

    def _save(self, path: str) -> None:
        os.makedirs(path)
        with open(os.path.join(path, "pipeline.json"), "w") as f:
            json.dump({"numStages": len(self.stages)}, f)
        for i, stage in enumerate(self.stages):
            stage.save(os.path.join(path, f"stage_{i:03d}"))

    def write(self) -> "_PipelineWriter":
        return _PipelineWriter(self)

    @classmethod
    def load(cls, path: str) -> "PipelineModel":
        with open(os.path.join(path, "pipeline.json")) as f:
            n = json.load(f)["numStages"]
        return cls([_Reader(_TpuModel).load(os.path.join(path, f"stage_{i:03d}")) for i in range(n)])


class _PipelineWriter:
    def __init__(self, model: PipelineModel) -> None:
        self._model = model
        self._overwrite = False

    def overwrite(self) -> "_PipelineWriter":
        self._overwrite = True
        return self

    def save(self, path: str) -> None:
        if os.path.exists(path):
            if not self._overwrite:
                raise FileExistsError(f"Path {path} exists; use write().overwrite()")
            shutil.rmtree(path)
        self._model._save(path)


class OneVsRest:
    """Drop-in for ``pyspark.ml.classification.OneVsRest``: reduce a
    multiclass problem to one binary classifier per class."""

    def __init__(
        self,
        classifier: Optional[_TpuEstimator] = None,
        *,
        labelCol: str = "label",
        featuresCol: str = "features",
        predictionCol: str = "prediction",
        rawPredictionCol: str = "rawPrediction",
    ) -> None:
        self._classifier = classifier
        self._labelCol = labelCol
        self._featuresCol = featuresCol
        self._predictionCol = predictionCol
        self._rawPredictionCol = rawPredictionCol

    def setClassifier(self, value: _TpuEstimator) -> "OneVsRest":
        self._classifier = value
        return self

    def fit(self, dataset: DataFrame) -> "OneVsRestModel":
        if self._classifier is None:
            raise ValueError("classifier must be set")
        y = np.asarray(dataset.column(self._labelCol), dtype=np.float64)
        if np.any(y < 0) or np.any(y != np.floor(y)):
            raise RuntimeError(
                "Labels MUST be non-negative integers, got values outside that set"
            )
        n_classes = max(int(y.max()) + 1, 2)
        models: List[_TpuModel] = []
        for k in range(n_classes):
            binary = dataset.withColumn("_ovr_label", (y == k).astype(np.float64))
            est = self._classifier.copy()
            self._classifier._copy_tpu_params(est)
            est._set_params(labelCol="_ovr_label", featuresCol=self._featuresCol)
            models.append(est.fit(binary))
        return OneVsRestModel(
            models,
            labelCol=self._labelCol,
            featuresCol=self._featuresCol,
            predictionCol=self._predictionCol,
            rawPredictionCol=self._rawPredictionCol,
        )


class OneVsRestModel:
    """Prediction = argmax over the per-class binary models' scores."""

    def __init__(
        self,
        models: Sequence[_TpuModel],
        *,
        labelCol: str = "label",
        featuresCol: str = "features",
        predictionCol: str = "prediction",
        rawPredictionCol: str = "rawPrediction",
    ) -> None:
        self.models: List[_TpuModel] = list(models)
        self._labelCol = labelCol
        self._featuresCol = featuresCol
        self._predictionCol = predictionCol
        self._rawPredictionCol = rawPredictionCol

    @property
    def numClasses(self) -> int:
        return len(self.models)

    def transform(self, dataset: DataFrame) -> DataFrame:
        scores: List[np.ndarray] = []
        for m in self.models:
            raw = np.asarray(m.transform(dataset).column(m.getOrDefault("rawPredictionCol")))
            # a binary raw prediction is (n, 2) [-s, s]; the class score is s
            scores.append(raw[:, 1] if raw.ndim == 2 else raw)
        raw = np.stack(scores, axis=1)  # (n, k)
        pred = np.argmax(raw, axis=1).astype(np.float64)
        out = dataset.withColumn(self._rawPredictionCol, raw)
        return out.withColumn(self._predictionCol, pred)

    # -- persistence --------------------------------------------------------
    def save(self, path: str) -> None:
        if os.path.exists(path):
            raise FileExistsError(f"Path {path} exists")
        os.makedirs(path)
        meta: Dict[str, Any] = {
            "numModels": len(self.models),
            "labelCol": self._labelCol,
            "featuresCol": self._featuresCol,
            "predictionCol": self._predictionCol,
            "rawPredictionCol": self._rawPredictionCol,
        }
        with open(os.path.join(path, "ovr.json"), "w") as f:
            json.dump(meta, f)
        for i, m in enumerate(self.models):
            m.save(os.path.join(path, f"model_{i:03d}"))

    @classmethod
    def load(cls, path: str) -> "OneVsRestModel":
        with open(os.path.join(path, "ovr.json")) as f:
            meta = json.load(f)
        models = [_Reader(_TpuModel).load(os.path.join(path, f"model_{i:03d}")) for i in range(meta["numModels"])]
        return cls(
            models,
            labelCol=meta["labelCol"],
            featuresCol=meta["featuresCol"],
            predictionCol=meta["predictionCol"],
            rawPredictionCol=meta["rawPredictionCol"],
        )
