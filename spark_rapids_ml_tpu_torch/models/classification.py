"""LogisticRegression of the port (counterpart of the logistic half of
``spark_rapids_ml_tpu/models/classification.py``).

Fit is the L-BFGS/OWL-QN of ``ops/logreg_kernels.py``; each objective
evaluation is one pass over X through kernel K3. Binomial and multinomial
fits, the Spark model surface (``coefficients``/``coefficientMatrix``,
``intercept``/``interceptVector``) and the prediction, probability and
raw-prediction columns follow the JAX package.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..core import FitFunc, FitInputs, _TpuEstimatorSupervised, _TpuModel
from ..data.dataframe import DataFrame
from ..ops.logreg_kernels import logreg_fit, logreg_predict
from ..parallel.mesh import global_label_summary
from ..params import (
    HasElasticNetParam,
    HasEnableSparseDataOptim,
    HasFeaturesCol,
    HasFeaturesCols,
    HasFitIntercept,
    HasLabelCol,
    HasMaxIter,
    HasPredictionCol,
    HasProbabilityCol,
    HasRawPredictionCol,
    HasRegParam,
    HasStandardization,
    HasTol,
    TypeConverters,
    _mk,
)
from ..utils.platform import resolve_device


def _resolve_objective_dtype(params: Dict[str, Any]) -> str:
    """Validated objective dtype (default float32; bfloat16 is accepted
    by the JAX package and not ported yet)."""
    v = str(params.get("objective_dtype") or "float32")
    if v not in ("float32", "bfloat16"):
        raise ValueError(f"objective_dtype must be float32|bfloat16, got {v!r}")
    return v


class LogisticRegressionClass:
    @classmethod
    def _param_mapping(cls) -> Dict[str, Optional[str]]:
        return {
            "maxIter": "max_iter",
            "regParam": "C",
            "elasticNetParam": "l1_ratio",
            "tol": "tol",
            "fitIntercept": "fit_intercept",
            "threshold": None,
            "thresholds": None,
            "standardization": "standardization",
            "weightCol": None,
            "aggregationDepth": None,
            "family": "",
            "lowerBoundsOnCoefficients": None,
            "upperBoundsOnCoefficients": None,
            "lowerBoundsOnIntercepts": None,
            "upperBoundsOnIntercepts": None,
            "maxBlockSizeInMB": None,
        }

    @classmethod
    def _param_value_mapping(cls) -> Dict[str, Callable[[Any], Any]]:
        # Spark regParam -> inverse-regularization C; C=0 encodes "no penalty"
        def _c(x: float) -> float:
            if x > 0.0:
                return 1.0 / x
            if x == 0.0:
                return 0.0
            raise ValueError(f"regParam must be >= 0, got {x}")

        return {"C": _c}

    @classmethod
    def _get_tpu_params_default(cls) -> Dict[str, Any]:
        return {
            "fit_intercept": True,
            "standardization": True,
            "C": 0.0,
            "l1_ratio": 0.0,
            "max_iter": 100,
            "tol": 1e-6,
            "objective_dtype": None,
        }


class _LogisticRegressionParams(
    HasFeaturesCol,
    HasFeaturesCols,
    HasLabelCol,
    HasPredictionCol,
    HasProbabilityCol,
    HasRawPredictionCol,
    HasMaxIter,
    HasTol,
    HasRegParam,
    HasElasticNetParam,
    HasFitIntercept,
    HasStandardization,
    HasEnableSparseDataOptim,
):
    family = _mk(
        "family", "binomial | multinomial | auto (auto-detected)", TypeConverters.toString
    )
    threshold = _mk("threshold", "binary prediction threshold (unsupported)", TypeConverters.toFloat)
    thresholds = _mk("thresholds", "per-class thresholds (unsupported)", TypeConverters.toListFloat)
    weightCol = _mk("weightCol", "weight column (unsupported)", TypeConverters.toString)
    aggregationDepth = _mk("aggregationDepth", "tree aggregate depth (unsupported)", TypeConverters.toInt)
    maxBlockSizeInMB = _mk("maxBlockSizeInMB", "block size hint (unsupported)", TypeConverters.toFloat)

    def __init__(self) -> None:
        super().__init__()
        self._setDefault(
            maxIter=100,
            regParam=0.0,
            elasticNetParam=0.0,
            tol=1e-6,
            family="auto",
        )

    def getFamily(self) -> str:
        return self.getOrDefault("family")


class LogisticRegression(
    LogisticRegressionClass, _TpuEstimatorSupervised, _LogisticRegressionParams
):
    """``LogisticRegression(regParam=0.01).fit(df)`` — drop-in for
    ``pyspark.ml.classification.LogisticRegression``. Labels must be
    non-negative integers."""

    def __init__(self, **kwargs: Any) -> None:
        _TpuEstimatorSupervised.__init__(self)
        _LogisticRegressionParams.__init__(self)
        self._set_params(**kwargs)

    def setMaxIter(self, value: int) -> "LogisticRegression":
        self._set_params(maxIter=value)
        return self

    def setRegParam(self, value: float) -> "LogisticRegression":
        self._set_params(regParam=value)
        return self

    def setElasticNetParam(self, value: float) -> "LogisticRegression":
        self._set_params(elasticNetParam=value)
        return self

    def setTol(self, value: float) -> "LogisticRegression":
        self._set_params(tol=value)
        return self

    def setFitIntercept(self, value: bool) -> "LogisticRegression":
        self._set_params(fitIntercept=value)
        return self

    def setStandardization(self, value: bool) -> "LogisticRegression":
        self._set_params(standardization=value)
        return self

    def setProbabilityCol(self, value: str) -> "LogisticRegression":
        self._set_params(probabilityCol=value)
        return self

    def setRawPredictionCol(self, value: str) -> "LogisticRegression":
        self._set_params(rawPredictionCol=value)
        return self

    def _get_fit_func(self, dataset: DataFrame) -> FitFunc:
        # the class count is read from the labels on the host, once
        label_col = self.getOrDefault("labelCol")
        ls = global_label_summary(np.asarray(dataset.column(label_col)))
        if ls["total"] == 0:
            raise ValueError("Labels column is empty")
        if ls["y_min"] < 0 or not ls["all_int"]:
            raise RuntimeError(
                "Labels MUST be non-negative integers, got values outside that set"
            )
        # Spark semantics: numClasses = max(label) + 1
        n_classes = max(int(ls["y_max"]) + 1, 2)
        single_label = ls["all_same"]
        single_label_val = ls["first"]

        def _fit(inputs: FitInputs, params: Dict[str, Any]) -> Dict[str, Any]:
            multinomial = n_classes > 2
            fit_intercept = bool(params["fit_intercept"])

            if single_label and n_classes == 2 and fit_intercept:
                # single-label degenerate case: all-0 or all-1 labels
                return {
                    "coef_": np.zeros((1, inputs.n_features)),
                    "intercept_": np.asarray(
                        [np.inf if single_label_val == 1.0 else -np.inf]
                    ),
                    "n_classes": n_classes,
                    "multinomial": False,
                    "n_iter": 0,
                    "objective": 0.0,
                }

            c = float(params["C"])
            reg = 1.0 / c if c > 0.0 else 0.0
            l1_ratio = float(params["l1_ratio"])
            out = logreg_fit(
                inputs.X,
                inputs.mask,
                inputs.y,
                n_classes=n_classes,
                multinomial=multinomial,
                fit_intercept=fit_intercept,
                standardization=bool(params["standardization"]),
                l1=reg * l1_ratio,
                l2=reg * (1.0 - l1_ratio),
                use_l1=reg * l1_ratio > 0.0,
                max_iter=int(params["max_iter"]),
                tol=float(params["tol"]),
                objective_dtype=_resolve_objective_dtype(params),
            )
            return {
                "coef_": out["coef_"].detach().cpu().numpy(),
                "intercept_": out["intercept_"].detach().cpu().numpy(),
                "n_classes": n_classes,
                "multinomial": multinomial,
                "n_iter": int(out["n_iter"]),
                "objective": float(out["objective"]),
            }

        return _fit

    def _create_model(self, result: Dict[str, Any]) -> "LogisticRegressionModel":
        return LogisticRegressionModel(**result)


class LogisticRegressionModel(
    LogisticRegressionClass, _TpuModel, _LogisticRegressionParams
):
    def __init__(self, **attrs: Any) -> None:
        _TpuModel.__init__(self, **attrs)
        _LogisticRegressionParams.__init__(self)

    # -- attribute surface (Spark model API) -------------------------------
    @property
    def coef_(self) -> np.ndarray:
        return np.asarray(self._model_attributes["coef_"])

    @property
    def intercept_(self) -> np.ndarray:
        return np.asarray(self._model_attributes["intercept_"])

    @property
    def numClasses(self) -> int:
        return int(self._model_attributes["n_classes"])

    @property
    def numFeatures(self) -> int:
        return int(self.coef_.shape[-1])

    @property
    def _multinomial(self) -> bool:
        v = self._model_attributes["multinomial"]
        if isinstance(v, str):  # JSON round-trip through persistence
            return v == "True"
        return bool(np.asarray(v))

    @property
    def coefficients(self) -> np.ndarray:
        """Binary-model coefficient vector (Spark raises for multinomial)."""
        if self._multinomial:
            raise RuntimeError(
                "Multinomial model: use coefficientMatrix instead of coefficients"
            )
        return self.coef_.reshape(-1)

    @property
    def intercept(self) -> float:
        if self._multinomial:
            raise RuntimeError(
                "Multinomial model: use interceptVector instead of intercept"
            )
        return float(self.intercept_.reshape(-1)[0])

    @property
    def coefficientMatrix(self) -> np.ndarray:
        return np.atleast_2d(self.coef_)

    @property
    def interceptVector(self) -> np.ndarray:
        return np.atleast_1d(self.intercept_)

    @property
    def classes_(self) -> np.ndarray:
        return np.arange(self.numClasses, dtype=np.float64)

    @property
    def hasSummary(self) -> bool:
        return False

    @property
    def n_iter_(self) -> int:
        return int(self._model_attributes.get("n_iter", 0))

    # -- transform ---------------------------------------------------------
    def _get_transform_func(
        self, dataset: Optional[DataFrame] = None
    ) -> Callable[[np.ndarray], Dict[str, np.ndarray]]:
        pred_col = self.getOrDefault("predictionCol")
        prob_col = self.getOrDefault("probabilityCol")
        raw_col = self.getOrDefault("rawPredictionCol")
        device = resolve_device(self._device)
        return self._memoized_transform_fn(
            ("logreg", pred_col, prob_col, raw_col, str(device)),
            lambda: self._build_transform_fn(pred_col, prob_col, raw_col, device),
        )

    def _build_transform_fn(
        self, pred_col: str, prob_col: str, raw_col: str, device: torch.device
    ) -> Callable[[np.ndarray], Dict[str, np.ndarray]]:
        b_np = np.atleast_1d(self.intercept_)
        multinomial = self._multinomial
        if not np.all(np.isfinite(b_np)):
            # degenerate single-label model: ±inf intercept would poison the
            # product; emit constant predictions directly
            const_pred = 1.0 if b_np.reshape(-1)[0] > 0 else 0.0

            def _const(Xb: np.ndarray) -> Dict[str, np.ndarray]:
                n = Xb.shape[0]
                pred = np.full((n,), const_pred, dtype=Xb.dtype)
                prob = np.zeros((n, 2), dtype=Xb.dtype)
                prob[:, int(const_pred)] = 1.0
                raw = np.zeros((n, 2), dtype=Xb.dtype)
                raw[:, int(const_pred)] = np.inf
                raw[:, 1 - int(const_pred)] = -np.inf
                return {pred_col: pred, prob_col: prob, raw_col: raw}

            return _const

        coef = torch.tensor(np.atleast_2d(self.coef_), dtype=torch.float32, device=device)
        b = torch.tensor(b_np, dtype=torch.float32, device=device)

        def _fn(Xb: np.ndarray) -> Dict[str, np.ndarray]:
            pred, prob, raw = logreg_predict(
                torch.from_numpy(Xb).to(device), coef, b, multinomial=multinomial
            )
            return {
                pred_col: pred.cpu().numpy(),
                prob_col: prob.cpu().numpy(),
                raw_col: raw.cpu().numpy(),
            }

        return _fn
