"""LogisticRegression of the port (counterpart of the logistic half of
``spark_rapids_ml_tpu/models/classification.py``).

Fit is the L-BFGS/OWL-QN of ``ops/logreg_kernels.py``; each objective
evaluation is one pass over X through kernel K3. A streamed fit
(``streaming=True``, a parquet scan, the sparse opt-in, or a matrix past
the card's threshold) runs ``ops.streaming.streamed_logreg_fit`` instead:
the host L-BFGS/OWL-QN, each evaluation a chunked pass through K3, and the
labels read in a host pass of their own. Binomial and multinomial
fits, the Spark model surface (``coefficients``/``coefficientMatrix``,
``intercept``/``interceptVector``) and the prediction, probability and
raw-prediction columns follow the JAX package.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import FitFunc, FitInputs, StreamFitFunc, StreamInputs, _TpuEstimatorSupervised, _TpuModel
from ..data.dataframe import DataFrame
from ..ops.logreg_kernels import logreg_fit, logreg_fit_batched, logreg_link, logreg_predict
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
from ..utils.logging import get_logger
from ..utils.platform import resolve_device


def _resolve_objective_dtype(params: Dict[str, Any]) -> str:
    """Validated objective dtype: float32 (the default) or bfloat16 (X
    placed in bf16, K3's bf16 instances on the card)."""
    v = str(params.get("objective_dtype") or "float32")
    if v not in ("float32", "bfloat16"):
        raise ValueError(f"objective_dtype must be float32|bfloat16, got {v!r}")
    return v


def _n_classes(ls: Dict[str, Any]) -> int:
    """The class count of a label summary (``global_label_summary``,
    ``streamed_label_stats``): Spark's max(label) + 1, at least 2. Raises
    where a label is negative or not an integer."""
    if ls["y_min"] < 0 or not ls["all_int"]:
        raise RuntimeError(
            "Labels MUST be non-negative integers, got values outside that set"
        )
    return max(int(ls["y_max"]) + 1, 2)


def _single_label_result(first: float, n_features: int) -> Dict[str, Any]:
    """The model of all-0 or all-1 binomial labels with an intercept: zero
    coefficients and an infinite intercept (reference
    ``classification.py:1119-1132``)."""
    return {
        "coef_": np.zeros((1, n_features)),
        "intercept_": np.asarray([np.inf if first == 1.0 else -np.inf]),
        "n_classes": 2,
        "multinomial": False,
        "n_iter": 0,
        "objective": 0.0,
    }


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

    def _enable_fit_multiple_in_single_pass(self) -> bool:
        """One data copy (or one label pass and one moments pass, where
        the fit streams) for every param map of a ``fitMultiple``, as in
        the JAX package."""
        return True

    def _supportsTransformEvaluate(self, evaluator: Any) -> bool:
        from ..evaluation import MulticlassClassificationEvaluator

        return isinstance(evaluator, MulticlassClassificationEvaluator)

    def _x_placement_dtype(self) -> Optional[torch.dtype]:
        """bf16 objective reads start at placement: X goes to the card in
        bf16 (never converted inside ``logreg_fit``, which would hold the
        f32 and the bf16 copy at once). Read from the ESTIMATOR-level
        setting, as in the JAX package: the param maps of a ``fitMultiple``
        share one placed X, so a map asking float32 over a bf16-placed X
        still reads bf16 (solver state is f32 either way). Core narrows
        only a float32 X, so a float64 fit is never rounded."""
        if _resolve_objective_dtype(self._tpu_params) == "bfloat16":
            return torch.bfloat16
        return None

    def _get_fit_func(self, dataset: DataFrame) -> FitFunc:
        # the class count is read from the labels on the host, once
        label_col = self.getOrDefault("labelCol")
        ls = global_label_summary(np.asarray(dataset.column(label_col)))
        if ls["total"] == 0:
            raise ValueError("Labels column is empty")
        n_classes = _n_classes(ls)

        def _fit(inputs: FitInputs, params: Dict[str, Any]) -> Dict[str, Any]:
            multinomial = n_classes > 2
            fit_intercept = bool(params["fit_intercept"])

            if ls["all_same"] and n_classes == 2 and fit_intercept:
                return _single_label_result(ls["first"], inputs.n_features)

            l1, l2 = self._gang_reg_pair(params)
            out = logreg_fit(
                inputs.X,
                inputs.mask,
                inputs.y,
                n_classes=n_classes,
                multinomial=multinomial,
                fit_intercept=fit_intercept,
                standardization=bool(params["standardization"]),
                l1=l1,
                l2=l2,
                use_l1=l1 > 0.0,
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

    # ---- gang fits ---------------------------------------------------------
    @staticmethod
    def _gang_reg_pair(ps: Dict[str, Any]) -> Tuple[float, float]:
        """(l1, l2) strengths from the stored C / l1_ratio: a solo fit's, a
        streamed fit's and a gang lane's."""
        c = float(ps["C"])
        reg = 1.0 / c if c > 0.0 else 0.0
        l1_ratio = float(ps["l1_ratio"])
        return reg * l1_ratio, reg * (1.0 - l1_ratio)

    def _gang_fit_groups(self, param_sets: List[Dict[str, Any]]) -> List[Tuple[Any, List[int]]]:
        # l1 / l2 / tol ride (B,) lane tensors; the rest splits buckets.
        # l1 > 0 too: OWL-QN's sign fix and orthant projection are no
        # identities at l1 = 0, so plain and OWL-QN lanes solve apart
        groups: Dict[Tuple[Any, ...], List[int]] = {}
        for i, ps in enumerate(param_sets):
            l1, _ = self._gang_reg_pair(ps)
            key = (
                bool(ps["fit_intercept"]),
                bool(ps["standardization"]),
                l1 > 0.0,
                int(ps["max_iter"]),
                _resolve_objective_dtype(ps),
            )
            groups.setdefault(key, []).append(i)
        return list(groups.items())

    def _gang_fit_supports_folds(self) -> bool:
        return True

    def _gang_lane_bytes(self, inputs: FitInputs) -> float:
        # the (n, B, K) logits and their backward twin: about four such
        # temporaries live a lane through an evaluation
        return 16.0 * float(inputs.X.shape[0]) * float(getattr(self, "_gang_k_eff", 1))

    def _get_gang_fit_func(self, dataset: DataFrame) -> Optional[Callable[..., List[Dict[str, Any]]]]:
        """One static bucket in one :func:`logreg_fit_batched`; None for
        labels the gang leaves to the solo fit (empty, negative or not
        integer: its error; all one label: its degenerate model)."""
        ls = global_label_summary(np.asarray(dataset.column(self.getOrDefault("labelCol"))))
        if ls["total"] == 0 or ls["y_min"] < 0 or not ls["all_int"] or ls["all_same"]:
            return None
        n_classes = _n_classes(ls)
        multinomial = n_classes > 2
        self._gang_k_eff = n_classes if multinomial else 1

        def _gang_fit(
            inputs: FitInputs,
            group_ps: List[Dict[str, Any]],
            *,
            fold_id: Optional[torch.Tensor] = None,
            lane_fold: Optional[List[int]] = None,
            n_folds: int = 0,
        ) -> List[Dict[str, Any]]:
            ps0 = group_ps[0]
            pairs = [self._gang_reg_pair(ps) for ps in group_ps]
            out = logreg_fit_batched(
                inputs.X,
                inputs.mask,
                inputs.y,
                n_classes=n_classes,
                multinomial=multinomial,
                fit_intercept=bool(ps0["fit_intercept"]),
                standardization=bool(ps0["standardization"]),
                l1=[l1 for l1, _ in pairs],
                l2=[l2 for _, l2 in pairs],
                use_l1=pairs[0][0] > 0.0,
                max_iter=int(ps0["max_iter"]),
                tol=[float(ps["tol"]) for ps in group_ps],
                objective_dtype=_resolve_objective_dtype(ps0),
                fold_id=fold_id,
                lane_fold=lane_fold,
                n_folds=int(n_folds),
            )
            coef = out["coef_"].detach().cpu().numpy()
            intercept = out["intercept_"].detach().cpu().numpy()
            n_iter = out["n_iter"].cpu().numpy()
            objective = out["objective"].cpu().numpy()
            return [
                {
                    "coef_": coef[b],
                    "intercept_": intercept[b],
                    "n_classes": n_classes,
                    "multinomial": multinomial,
                    "n_iter": int(n_iter[b]),
                    "objective": float(objective[b]),
                }
                for b in range(len(group_ps))
            ]

        return _gang_fit

    def _get_streaming_fit_func(self, dataset: DataFrame) -> StreamFitFunc:
        """Out-of-core fit: the labels in one host pass, the feature
        moments (and variance) in one or two passes, then the host
        L-BFGS/OWL-QN whose every evaluation is one chunked pass through K3.
        Every param map of a ``fitMultiple`` shares the label statistics
        and the moments. With ``runtime.checkpoint.CKPT_DIR`` set, the
        solver checkpoints after each iteration and a refit resumes."""
        from ..ops.streaming import streamed_label_stats, streamed_logreg_fit
        from ..runtime.checkpoint import FitCheckpointer

        label_cache: Dict[str, Any] = {}
        moments: Dict[str, Any] = {}

        def _fit(inputs: StreamInputs, params: Dict[str, Any]) -> Dict[str, Any]:
            if not label_cache:
                label_cache.update(streamed_label_stats(inputs.source, inputs.chunk_rows))
            ls = label_cache
            n_classes = _n_classes(ls)
            multinomial = n_classes > 2
            fit_intercept = bool(params["fit_intercept"])
            if ls["all_same"] and n_classes == 2 and fit_intercept:
                return _single_label_result(ls["first"], inputs.n_features)
            l1, l2 = self._gang_reg_pair(params)
            if _resolve_objective_dtype(params) != "float32":
                get_logger(type(self)).warning(
                    "objective_dtype=bfloat16 applies to the resident fit "
                    "only; the streaming fit reads chunks at wire dtype"
                )
            # checkpoint identity, the JAX package's key for key: the
            # L-BFGS walk is determined by the objective config and the
            # data, whose shape stands in for a digest (a content pass
            # would cost a full extra read)
            ckpt = FitCheckpointer.from_settings(
                "logreg",
                {
                    "n_classes": n_classes,
                    "multinomial": multinomial,
                    "fit_intercept": fit_intercept,
                    "standardization": bool(params["standardization"]),
                    "l1": l1,
                    "l2": l2,
                    "max_iter": int(params["max_iter"]),
                    "tol": float(params["tol"]),
                    "n_rows": int(inputs.n_rows),
                    "d": int(inputs.n_features),
                },
            )
            out = streamed_logreg_fit(
                inputs.source, inputs.device, inputs.chunk_rows, inputs.dtype,
                n_classes=n_classes,
                multinomial=multinomial,
                fit_intercept=fit_intercept,
                standardization=bool(params["standardization"]),
                l1=l1,
                l2=l2,
                max_iter=int(params["max_iter"]),
                tol=float(params["tol"]),
                moments=moments,
                checkpointer=ckpt if ckpt.enabled else None,
            )
            return {
                "coef_": out["coef_"],
                "intercept_": out["intercept_"],
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
        if not self._is_multi_model and not np.all(np.isfinite(b_np)):
            # degenerate single-label model: ±inf intercept would poison the
            # product; emit constant predictions directly (a combined model
            # keeps its per-model columns: zero coefficients and an infinite
            # intercept give that sub-model's constant scores)
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

        if self._is_multi_model:
            return self._multi_transform_fn(pred_col, prob_col, raw_col, device)

        coef = torch.tensor(np.atleast_2d(self.coef_), device=device)
        b = torch.tensor(b_np, device=device)

        def _fn(Xb: np.ndarray) -> Dict[str, np.ndarray]:
            # in the batch's dtype: a float64 batch gives float64 columns, as
            # in the JAX package
            xb = torch.from_numpy(Xb).to(device)
            pred, prob, raw = logreg_predict(xb, coef.to(xb.dtype), b.to(xb.dtype), multinomial=multinomial)
            return {
                pred_col: pred.cpu().numpy(),
                prob_col: prob.cpu().numpy(),
                raw_col: raw.cpu().numpy(),
            }

        return _fn

    def _multi_transform_fn(
        self, pred_col: str, prob_col: str, raw_col: str, device: torch.device
    ) -> Callable[[np.ndarray], Dict[str, np.ndarray]]:
        """The combined model's transform: coef_ (m, K, d) -> prediction (n,
        m), probability (n, m, K), rawPrediction (n, m, K), the scores of
        all m models as one product of the batch with the stacked (m·K, d)
        coefficients, in the batch's dtype."""
        m, K, d = self.coef_.shape
        coef = torch.tensor(self.coef_.reshape(m * K, d), device=device)
        b = torch.tensor(np.atleast_2d(self.intercept_).reshape(m * K), device=device)
        multinomial = self._multinomial

        def _fn(Xb: np.ndarray) -> Dict[str, np.ndarray]:
            xb = torch.from_numpy(Xb).to(device)
            scores = (xb @ coef.to(xb.dtype).T + b.to(xb.dtype)).reshape(-1, m, K)
            pred, prob, raw = logreg_link(scores, multinomial=multinomial)
            return {
                pred_col: pred.cpu().numpy(),
                prob_col: prob.cpu().numpy(),
                raw_col: raw.cpu().numpy(),
            }

        return _fn

    # -- multi-model support (CV single pass) ------------------------------
    @classmethod
    def _combine(cls, models: List["LogisticRegressionModel"]) -> "LogisticRegressionModel":
        """Stack models for a single-pass evaluation of every model: coef_
        (m, K, d), intercept_ (m, K)."""
        coefs = np.stack([np.atleast_2d(m.coef_) for m in models])
        intercepts = np.stack([np.atleast_1d(m.intercept_) for m in models])
        combined = cls(
            coef_=coefs,
            intercept_=intercepts,
            n_classes=models[0].numClasses,
            multinomial=models[0]._multinomial,
            n_iter=0,
            objective=0.0,
        )
        models[0]._copyValues(combined)
        models[0]._copy_tpu_params(combined)
        return combined

    @property
    def _is_multi_model(self) -> bool:
        return self.coef_.ndim == 3

    def _transformEvaluate(self, dataset: DataFrame, evaluator: Any) -> List[float]:
        """One transform pass for every model, then each model's metric from
        its confusion (and, for ``logLoss``, its probabilities)."""
        from ..core import _features, _resolve_feature_matrix
        from ..evaluation import MulticlassClassificationEvaluator
        from ..metrics import MulticlassMetrics

        if not isinstance(evaluator, MulticlassClassificationEvaluator):
            raise NotImplementedError(f"Evaluator {type(evaluator).__name__} is not supported")
        X = _features(self, _resolve_feature_matrix(self, dataset))
        out = self._apply_batched(self._get_transform_func(dataset), X)
        preds = out[self.getOrDefault("predictionCol")]
        probs = out[self.getOrDefault("probabilityCol")]
        y = np.asarray(dataset.column(evaluator.getLabelCol()), dtype=np.float64)
        need_probs = evaluator.getMetricName() == "logLoss"
        if preds.ndim == 1:
            preds, probs = preds[:, None], probs[:, None, :]
        return [
            MulticlassMetrics.from_predictions(
                y, preds[:, j], probs[:, j, :] if need_probs else None, evaluator.getEps()
            ).evaluate(evaluator)
            for j in range(preds.shape[1])
        ]
