"""PCA of the port (counterpart of ``spark_rapids_ml_tpu/models/feature.py``).

Fit: the chunked covariance of ``ops.linalg.mean_and_cov_chunked`` (one
pass over X through kernel K1), then ``eigh`` of the d×d covariance and
the deterministic sign flip. Transform is Spark's ``X @ pc`` with no mean
removal — a plain product outside any kernel.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..core import FitFunc, FitInputs, _TpuEstimator, _TpuModel
from ..data.dataframe import DataFrame
from ..ops.linalg import mean_and_cov_chunked, topk_eigh
from ..params import (
    HasFeaturesCol,
    HasFeaturesCols,
    HasInputCol,
    HasOutputCol,
    TypeConverters,
    _mk,
)
from ..utils.platform import resolve_device


class PCAClass:
    @classmethod
    def _param_mapping(cls) -> Dict[str, Optional[str]]:
        return {"k": "n_components"}

    @classmethod
    def _param_value_mapping(cls) -> Dict[str, Callable[[Any], Any]]:
        return {}

    @classmethod
    def _get_tpu_params_default(cls) -> Dict[str, Any]:
        return {"n_components": None, "whiten": False}


class _PCAParams(HasInputCol, HasOutputCol, HasFeaturesCol, HasFeaturesCols):
    k = _mk("k", "number of principal components", TypeConverters.toInt)

    def __init__(self) -> None:
        super().__init__()
        self._setDefault(outputCol="pca_features")

    def getK(self) -> int:
        return self.getOrDefault("k")


def _pca_from_cov(mean: torch.Tensor, cov: torch.Tensor, n: torch.Tensor, k: int):
    """Finalize PCA from (mean, covariance, count)."""
    evals, evecs = topk_eigh(cov, k)
    evals = torch.clamp(evals, min=0.0)
    total_var = torch.trace(cov)
    # singular values of the centered matrix: sqrt(λ·(n-1))
    singular_values = torch.sqrt(evals * (n - 1.0))
    return {
        "mean": mean,
        "components": evecs.T,            # (k, d)
        "explained_variance": evals,
        "explained_variance_ratio": evals / total_var,
        "singular_values": singular_values,
    }


def _pca_fit_kernel(X: torch.Tensor, mask: torch.Tensor, k: int, csize: int):
    """Resident fit: the chunked one-pass covariance, then the eigensolve."""
    mean, cov, n = mean_and_cov_chunked(X, mask, csize)
    return _pca_from_cov(mean, cov, n, k)


class PCA(PCAClass, _TpuEstimator, _PCAParams):
    """``PCA(k=3).fit(df)`` — drop-in for ``pyspark.ml.feature.PCA``."""

    def __init__(self, **kwargs: Any) -> None:
        _TpuEstimator.__init__(self)
        _PCAParams.__init__(self)
        self._set_params(**kwargs)

    def setK(self, value: int) -> "PCA":
        self._set_params(k=value)
        return self

    def setInputCol(self, value: str) -> "PCA":
        self._set_params(inputCol=value)
        return self

    def setOutputCol(self, value: str) -> "PCA":
        self._set_params(outputCol=value)
        return self

    def _chunk_rows(self, n_rows: int, n_dp: int) -> int:
        # the JAX package's chunk rule: 64k-row chunks, equal pieces (it
        # sets the stride of the mean estimate, so both packages shift by
        # the same μ̂)
        return self._equal_chunk_rows(n_rows, n_dp, 65_536)

    def _get_fit_func(self, dataset: DataFrame) -> FitFunc:
        def _fit(inputs: FitInputs, params: Dict[str, Any]) -> Dict[str, Any]:
            k = int(params.get("n_components") or self.getK())
            if k > inputs.n_features:
                raise ValueError(
                    f"k={k} must be <= number of features {inputs.n_features}"
                )
            out = _pca_fit_kernel(inputs.X, inputs.mask, k, inputs.csize)
            return {key: v.cpu().numpy() for key, v in out.items()}

        return _fit

    def _create_model(self, result: Dict[str, Any]) -> "PCAModel":
        return PCAModel(**result)


class PCAModel(PCAClass, _TpuModel, _PCAParams):
    def __init__(self, **attrs: Any) -> None:
        _TpuModel.__init__(self, **attrs)
        _PCAParams.__init__(self)

    # -- attribute surface (reference model attrs + Spark names) -----------
    @property
    def mean_(self) -> np.ndarray:
        return np.asarray(self._model_attributes["mean"])

    @property
    def components_(self) -> np.ndarray:
        return np.asarray(self._model_attributes["components"])

    @property
    def explained_variance_(self) -> np.ndarray:
        return np.asarray(self._model_attributes["explained_variance"])

    @property
    def explained_variance_ratio_(self) -> np.ndarray:
        return np.asarray(self._model_attributes["explained_variance_ratio"])

    @property
    def singular_values_(self) -> np.ndarray:
        return np.asarray(self._model_attributes["singular_values"])

    @property
    def pc(self) -> np.ndarray:
        """Spark-style principal-components matrix, shape (d, k)."""
        return self.components_.T

    @property
    def explainedVariance(self) -> np.ndarray:
        return self.explained_variance_ratio_

    def setInputCol(self, value: str) -> "PCAModel":
        self._set_params(inputCol=value)
        return self

    def setOutputCol(self, value: str) -> "PCAModel":
        self._set_params(outputCol=value)
        return self

    # -- transform ---------------------------------------------------------
    def _get_transform_func(
        self, dataset: Optional[DataFrame] = None
    ) -> Callable[[np.ndarray], Dict[str, np.ndarray]]:
        out_col = self.getOrDefault("outputCol")
        device = resolve_device(self._device)

        def _build() -> Callable[[np.ndarray], Dict[str, np.ndarray]]:
            components = torch.tensor(self.components_, dtype=torch.float32, device=device)

            def _fn(Xb: np.ndarray) -> Dict[str, np.ndarray]:
                # Spark semantics: no mean removal
                xb = torch.from_numpy(Xb).to(device)
                return {out_col: (xb @ components.T).cpu().numpy()}

            return _fn

        return self._memoized_transform_fn(("pca", out_col, str(device)), _build)
