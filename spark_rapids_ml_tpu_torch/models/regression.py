"""LinearRegression of the port (counterpart of
``spark_rapids_ml_tpu/models/regression.py``).

Fit: one pass of sufficient statistics (``ops.linreg_kernels``, the Gram
through kernel K1), then a solver on the d×d system: l1 = 0 is a Cholesky
solve (OLS and ridge, with Spark's penalty on standardized coefficients),
l1 > 0 is FISTA (the elastic net and lasso). ``fitMultiple`` fits every
param map from one copy of the data and one pass of statistics a
``fitIntercept`` value; the streamed fit (out of core) takes the
statistics from two passes of ``ops.streaming.streamed_suffstats``, once
a ``fitIntercept`` value too. With ``core.GANG_FIT`` on, a resident
``fitMultiple`` solves the FISTA maps of a bucket in one batched FISTA
(``solve_elasticnet_batched``) over statistics of its own, once a
``fitIntercept`` value; its Cholesky maps (l1 = 0) take the loop.
``_combine`` stacks models so that one transform pass scores them all.
Transform is ``X @ w + b`` (``X @ Wᵀ + b`` for a combined model) in f32 on
the model's device, a plain product.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import FitFunc, FitInputs, StreamFitFunc, StreamInputs, _TpuEstimatorSupervised, _TpuModel
from ..data.dataframe import DataFrame
from ..ops.linalg import shifted_gram
from ..ops.linreg_kernels import (
    linreg_suffstats,
    linreg_suffstats_chunked,
    solve_elasticnet,
    solve_elasticnet_batched,
    solve_normal,
)
from ..params import (
    HasElasticNetParam,
    HasFeaturesCol,
    HasFeaturesCols,
    HasFitIntercept,
    HasLabelCol,
    HasMaxIter,
    HasPredictionCol,
    HasRegParam,
    HasStandardization,
    HasTol,
    HasWeightCol,
    TypeConverters,
    _mk,
)
from ..utils.platform import resolve_device

# key of the fit's provenance in a fit's result (not a model attribute)
_FIT_REPORT = "_fit_report"


class LinearRegressionClass:
    @classmethod
    def _param_mapping(cls) -> Dict[str, Optional[str]]:
        return {
            "regParam": "alpha",
            "elasticNetParam": "l1_ratio",
            "maxIter": "max_iter",
            "tol": "tol",
            "fitIntercept": "fit_intercept",
            "standardization": "standardization",
            "solver": "solver",
            "loss": "loss",
            "aggregationDepth": "",
            "epsilon": "",
            "maxBlockSizeInMB": "",
            # weightCol is read by the data plane (weighted moments): no
            # backend mapping
        }

    @classmethod
    def _param_value_mapping(cls) -> Dict[str, Callable[[Any], Any]]:
        def _loss(v: str) -> str:
            if v != "squaredError":
                raise ValueError(f"Only squaredError loss is supported, got {v!r}")
            return v

        def _solver(v: str) -> str:
            if v not in ("auto", "normal", "l-bfgs"):
                raise ValueError(f"Unsupported solver {v!r}")
            return v

        return {"loss": _loss, "solver": _solver}

    @classmethod
    def _get_tpu_params_default(cls) -> Dict[str, Any]:
        return {
            "alpha": 0.0,
            "l1_ratio": 0.0,
            "max_iter": 100,
            "tol": 1e-6,
            "fit_intercept": True,
            "standardization": True,
            "solver": "auto",
            "loss": "squaredError",
        }


class _LinearRegressionParams(
    HasFeaturesCol,
    HasFeaturesCols,
    HasLabelCol,
    HasPredictionCol,
    HasMaxIter,
    HasTol,
    HasRegParam,
    HasElasticNetParam,
    HasFitIntercept,
    HasStandardization,
    HasWeightCol,
):
    solver = _mk("solver", "solver: auto | normal | l-bfgs", TypeConverters.toString)
    loss = _mk("loss", "loss function (squaredError)", TypeConverters.toString)
    aggregationDepth = _mk("aggregationDepth", "tree aggregate depth (ignored)", TypeConverters.toInt)
    epsilon = _mk("epsilon", "huber epsilon (ignored)", TypeConverters.toFloat)
    maxBlockSizeInMB = _mk("maxBlockSizeInMB", "block size hint (ignored)", TypeConverters.toFloat)

    def __init__(self) -> None:
        super().__init__()
        self._setDefault(
            maxIter=100, regParam=0.0, elasticNetParam=0.0, tol=1e-6,
            solver="auto", loss="squaredError", aggregationDepth=2, epsilon=1.35,
        )

    def getSolver(self) -> str:
        return self.getOrDefault("solver")


class LinearRegression(LinearRegressionClass, _TpuEstimatorSupervised, _LinearRegressionParams):
    """``LinearRegression(regParam=1e-5).fit(df)`` — drop-in for
    ``pyspark.ml.regression.LinearRegression``."""

    def __init__(self, **kwargs: Any) -> None:
        _TpuEstimatorSupervised.__init__(self)
        _LinearRegressionParams.__init__(self)
        self._set_params(**kwargs)

    def setMaxIter(self, value: int) -> "LinearRegression":
        self._set_params(maxIter=value)
        return self

    def setRegParam(self, value: float) -> "LinearRegression":
        self._set_params(regParam=value)
        return self

    def setElasticNetParam(self, value: float) -> "LinearRegression":
        self._set_params(elasticNetParam=value)
        return self

    def setStandardization(self, value: bool) -> "LinearRegression":
        self._set_params(standardization=value)
        return self

    def setFitIntercept(self, value: bool) -> "LinearRegression":
        self._set_params(fitIntercept=value)
        return self

    def _enable_fit_multiple_in_single_pass(self) -> bool:
        return True

    def _supportsTransformEvaluate(self, evaluator: Any) -> bool:
        from ..evaluation import RegressionEvaluator

        return isinstance(evaluator, RegressionEvaluator)

    @staticmethod
    def _solve_from_stats(stats: Dict[str, torch.Tensor], params: Dict[str, Any]) -> Dict[str, Any]:
        """Solver dispatch on precomputed sufficient statistics."""
        alpha = float(params["alpha"])
        l1_ratio = float(params["l1_ratio"])
        standardization = bool(params["standardization"])
        l1 = alpha * l1_ratio
        l2 = alpha * (1.0 - l1_ratio)
        if l1 == 0.0:
            beta, intercept = solve_normal(stats, l2, standardization=standardization)
            n_iter = 1
        else:
            beta, intercept, n_iter = solve_elasticnet(
                stats, l1, l2, standardization=standardization,
                max_iter=int(params["max_iter"]), tol=float(params["tol"]),
            )
        return {
            "coefficients": beta.cpu().numpy(),
            "intercept": float(intercept),
            "n_iter": int(n_iter),
        }

    def _chunk_rows(self, n_rows: int, n_dp: int) -> int:
        # the JAX package's chunk rule: it sets the rows μ̂ is taken from
        return self._equal_chunk_rows(n_rows, n_dp, 65_536)

    @staticmethod
    def _resident_stats(
        stats_cache: Dict[bool, Dict[str, torch.Tensor]], inputs: FitInputs, fit_intercept: bool
    ) -> bool:
        """Fill ``stats_cache[fit_intercept]`` from one pass over the rows on
        the device (the Gram through K1) unless it holds them; True where it
        did."""
        if fit_intercept in stats_cache:
            return True
        csize = inputs.csize
        if csize > 1 and inputs.X.shape[0] % csize == 0:
            stats = linreg_suffstats_chunked(
                inputs.X, inputs.mask, inputs.y, inputs.weight, csize=csize,
                fit_intercept=fit_intercept,
            )
        else:
            stats = linreg_suffstats(
                inputs.X, inputs.mask, inputs.y, inputs.weight, fit_intercept=fit_intercept
            )
        stats_cache[fit_intercept] = stats
        if inputs.device.type == "cuda":
            torch.cuda.synchronize(inputs.device)
        return False

    def _get_fit_func(self, dataset: DataFrame) -> FitFunc:
        # one pass of statistics per fit_intercept value, shared by every
        # param map of one fitMultiple
        stats_cache: Dict[bool, Dict[str, torch.Tensor]] = {}

        def _fit(inputs: FitInputs, params: Dict[str, Any]) -> Dict[str, Any]:
            fit_intercept = bool(params["fit_intercept"])
            launches0 = shifted_gram.launches
            t0 = time.perf_counter()
            cached = self._resident_stats(stats_cache, inputs, fit_intercept)
            t1 = time.perf_counter()
            result = self._solve_from_stats(stats_cache[fit_intercept], params)
            t2 = time.perf_counter()
            result[_FIT_REPORT] = {
                "suffstats_s": t1 - t0,
                "stats_cached": cached,
                "solve_s": t2 - t1,
                "n_iter": result["n_iter"],
                "shifted_gram_launches": shifted_gram.launches - launches0,
            }
            return result

        return _fit

    # ---- gang fits ---------------------------------------------------------
    def _gang_fit_groups(self, param_sets: List[Dict[str, Any]]) -> Optional[List[Tuple[Any, List[int]]]]:
        # the FISTA lanes alone: an l1 = 0 lane is one Cholesky solve on
        # the shared statistics, nothing to batch, and takes the loop
        groups: Dict[Tuple[Any, ...], List[int]] = {}
        for i, ps in enumerate(param_sets):
            if float(ps["alpha"]) * float(ps["l1_ratio"]) == 0.0:
                continue
            key = (bool(ps["fit_intercept"]), bool(ps["standardization"]), int(ps["max_iter"]))
            groups.setdefault(key, []).append(i)
        return list(groups.items()) or None

    def _gang_lane_bytes(self, inputs: FitInputs) -> float:
        # FISTA's state is O(d) a lane over the shared d×d system
        return 32.0 * float(inputs.n_features)

    def _get_gang_fit_func(self, dataset: DataFrame) -> Callable[..., List[Dict[str, Any]]]:
        """One bucket of FISTA lanes in one :func:`solve_elasticnet_batched`
        on statistics of its own (one pass through K1 a ``fit_intercept``
        value, apart from the loop's, as in the JAX package). Each lane's
        result carries the solo fit's report keys."""
        stats_cache: Dict[bool, Dict[str, torch.Tensor]] = {}

        def _gang_fit(inputs: FitInputs, group_ps: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
            ps0 = group_ps[0]
            fit_intercept = bool(ps0["fit_intercept"])
            launches0 = shifted_gram.launches
            t0 = time.perf_counter()
            cached = self._resident_stats(stats_cache, inputs, fit_intercept)
            t1 = time.perf_counter()
            beta, intercept, it = solve_elasticnet_batched(
                stats_cache[fit_intercept],
                [float(ps["alpha"]) * float(ps["l1_ratio"]) for ps in group_ps],
                [float(ps["alpha"]) * (1.0 - float(ps["l1_ratio"])) for ps in group_ps],
                standardization=bool(ps0["standardization"]),
                max_iter=int(ps0["max_iter"]),
                tol=[float(ps["tol"]) for ps in group_ps],
            )
            beta_h, intercept_h, it_h = beta.cpu().numpy(), intercept.cpu().numpy(), it.cpu().numpy()
            t2 = time.perf_counter()
            report = {
                "suffstats_s": t1 - t0,
                "stats_cached": cached,
                "solve_s": t2 - t1,
                "shifted_gram_launches": shifted_gram.launches - launches0,
            }
            return [
                {
                    "coefficients": beta_h[b],
                    "intercept": float(intercept_h[b]),
                    "n_iter": int(it_h[b]),
                    _FIT_REPORT: {**report, "n_iter": int(it_h[b])},
                }
                for b in range(len(group_ps))
            ]

        return _gang_fit

    def _get_streaming_fit_func(self, dataset: DataFrame) -> StreamFitFunc:
        """Out-of-core fit: the statistics (Gram, Xᵀy, moments) accumulate
        over two streamed passes, once a ``fit_intercept`` value; every
        solver and param map of a ``fitMultiple`` reuses them with no
        further pass over the data."""
        from ..ops.streaming import streamed_suffstats

        stats_cache: Dict[bool, Dict[str, torch.Tensor]] = {}

        def _fit(inputs: StreamInputs, params: Dict[str, Any]) -> Dict[str, Any]:
            fit_intercept = bool(params["fit_intercept"])
            launches0 = shifted_gram.launches
            t0 = time.perf_counter()
            cached = fit_intercept in stats_cache
            if not cached:
                stats_cache[fit_intercept] = streamed_suffstats(
                    inputs.source, inputs.device, inputs.chunk_rows, inputs.dtype,
                    with_y=True, fit_intercept=fit_intercept,
                )
            t1 = time.perf_counter()
            result = self._solve_from_stats(stats_cache[fit_intercept], params)
            t2 = time.perf_counter()
            result[_FIT_REPORT] = {
                "suffstats_s": t1 - t0,
                "stats_cached": cached,
                "solve_s": t2 - t1,
                "n_iter": result["n_iter"],
                "shifted_gram_launches": shifted_gram.launches - launches0,
            }
            return result

        return _fit

    def _create_model(self, result: Dict[str, Any]) -> "LinearRegressionModel":
        report = result.pop(_FIT_REPORT, None)
        model = LinearRegressionModel(**result)
        if report is not None:
            # fit provenance (not persisted): where the fit's time went
            model._fit_report = report
        return model


class LinearRegressionModel(LinearRegressionClass, _TpuModel, _LinearRegressionParams):
    def __init__(self, **attrs: Any) -> None:
        _TpuModel.__init__(self, **attrs)
        _LinearRegressionParams.__init__(self)

    @property
    def coefficients(self) -> np.ndarray:
        """(d,) for a single model; (m, d) for a combined multi-model."""
        return np.asarray(self._model_attributes["coefficients"])

    @property
    def intercept(self) -> Any:
        return self._model_attributes["intercept"]

    @property
    def numFeatures(self) -> int:
        return int(np.atleast_2d(self.coefficients).shape[1])

    @property
    def hasSummary(self) -> bool:
        return False

    def predict(self, vector: Any) -> float:
        x = np.asarray(vector, dtype=np.float64).ravel()
        return float(x @ np.asarray(self.coefficients).ravel() + float(self.intercept))

    @classmethod
    def _combine(cls, models: List["LinearRegressionModel"]) -> "LinearRegressionModel":
        """Stack models for single-pass multi-model evaluation."""
        coefs = np.stack([np.atleast_1d(np.asarray(m.coefficients)) for m in models])
        intercepts = np.asarray([float(m.intercept) for m in models])
        combined = cls(coefficients=coefs, intercept=intercepts, n_iter=0)
        models[0]._copyValues(combined)
        models[0]._copy_tpu_params(combined)
        return combined

    @property
    def _is_multi_model(self) -> bool:
        return np.asarray(self._model_attributes["coefficients"]).ndim == 2

    def _transformEvaluate(self, dataset: DataFrame, evaluator: Any) -> List[float]:
        """One transform pass computes every model's predictions; each
        model's metric comes from its moment buffers."""
        from ..core import _features, _resolve_feature_matrix
        from ..evaluation import RegressionEvaluator
        from ..metrics import RegressionMetrics

        if not isinstance(evaluator, RegressionEvaluator):
            raise NotImplementedError(f"Evaluator {type(evaluator).__name__} is not supported")
        X = _features(self, _resolve_feature_matrix(self, dataset))
        preds = self._apply_batched(self._get_transform_func(dataset), X)[self.getOrDefault("predictionCol")]
        y = np.asarray(dataset.column(evaluator.getLabelCol()), dtype=np.float64)
        P = preds[:, None] if preds.ndim == 1 else preds  # (n, m)
        return [RegressionMetrics.from_predictions(y, P[:, j]).evaluate(evaluator) for j in range(P.shape[1])]

    def _get_transform_func(
        self, dataset: Optional[DataFrame] = None
    ) -> Callable[[np.ndarray], Dict[str, np.ndarray]]:
        pred_col = self.getOrDefault("predictionCol")
        device = resolve_device(self._device)

        def _build() -> Callable[[np.ndarray], Dict[str, np.ndarray]]:
            coef = torch.tensor(self.coefficients, device=device)
            b = torch.tensor(np.asarray(self.intercept, dtype=np.float64), device=device)
            # (d,) -> X @ w + b; (m, d) -> X @ Wᵀ + b
            W = coef if coef.ndim == 1 else coef.T.contiguous()

            def _fn(Xb: np.ndarray) -> Dict[str, np.ndarray]:
                # in the batch's dtype: a float64 batch gives float64
                # predictions, as in the JAX package
                xb = torch.from_numpy(Xb).to(device)
                return {pred_col: (xb @ W.to(xb.dtype) + b.to(xb.dtype)).cpu().numpy()}

            return _fn

        return self._memoized_transform_fn(("linreg", pred_col, str(device)), _build)
