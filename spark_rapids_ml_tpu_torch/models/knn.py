"""Exact NearestNeighbors of the port (counterpart of the exact part of
``spark_rapids_ml_tpu/models/knn.py``).

Contract as in the JAX package:
* ``fit(item_df)`` only captures the item DataFrame (no compute at fit);
* ``kneighbors(query_df)`` -> ``(item_df_withid, query_df_withid, knn_df)``
  with knn_df columns ``(query_<id>, indices, distances)`` sorted by query
  id; euclidean distances, float32;
* ``exactNearestNeighborsJoin(query_df, distCol)`` explodes the result
  into one row per (item, query) pair, item and query columns flattened to
  ``item_<col>`` / ``query_<col>``;
* no persistence: ``write``/``read`` raise.

The search is one pass of kernel K4 over all items on one card
(``ops.knn_kernels.knn_search``). Multi-process searches and
``ApproximateNearestNeighbors`` are not ported yet.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..core import _resolve_features_f32, _TpuEstimator, _TpuModel
from ..data.dataframe import DataFrame
from ..ops.knn_kernels import knn_search
from ..params import Params, TypeConverters, _mk
from ..utils.platform import resolve_device

_DEFAULT_ID_COL = "unique_id"


class NearestNeighborsClass:
    @classmethod
    def _param_mapping(cls) -> Dict[str, Optional[str]]:
        return {"k": "n_neighbors"}

    @classmethod
    def _param_value_mapping(cls) -> Dict[str, Callable[[Any], Any]]:
        return {}

    @classmethod
    def _get_tpu_params_default(cls) -> Dict[str, Any]:
        return {"n_neighbors": 5}


class _NearestNeighborsParams(Params):
    k = _mk("k", "number of nearest neighbors", TypeConverters.toInt)
    inputCol = _mk("inputCol", "features column (vector/array)", TypeConverters.toString)
    inputCols = _mk("inputCols", "scalar feature columns", TypeConverters.toListString)
    idCol = _mk("idCol", "row id column", TypeConverters.toString)

    def __init__(self) -> None:
        super().__init__()
        self._setDefault(k=5, inputCol="features")

    def getK(self) -> int:
        # _tpu_params is authoritative: users may set either the Spark name
        # ``k`` (synced there by _set_params) or the backend name
        # ``n_neighbors`` (stored only there)
        if getattr(self, "_tpu_params", None) and "n_neighbors" in self._tpu_params:
            return int(self._tpu_params["n_neighbors"])
        return self.getOrDefault("k")

    def setK(self, value: int) -> "_NearestNeighborsParams":
        self._set_params(k=value)  # type: ignore[attr-defined]
        return self

    def setInputCol(self, value: Union[str, List[str]]) -> "_NearestNeighborsParams":
        if isinstance(value, (list, tuple)):
            self._set(inputCols=list(value))
        else:
            self._set(inputCol=value)
        return self

    def setInputCols(self, value: List[str]) -> "_NearestNeighborsParams":
        self._set(inputCols=value)
        return self

    def setIdCol(self, value: str) -> "_NearestNeighborsParams":
        self._set(idCol=value)
        return self

    def getIdCol(self) -> str:
        return self.getOrDefault("idCol") if self.isDefined("idCol") else _DEFAULT_ID_COL

    def _ensureIdCol(self, df: DataFrame) -> DataFrame:
        """Add a monotonically increasing id column when the user did not
        set one."""
        if self.isDefined("idCol"):
            id_col = self.getOrDefault("idCol")
            if id_col not in df:
                raise ValueError(f"idCol {id_col!r} not in DataFrame columns {df.columns}")
            return df
        if _DEFAULT_ID_COL in df:
            return df
        return df.withColumn(_DEFAULT_ID_COL, np.arange(df.count(), dtype=np.int64))


class NearestNeighbors(NearestNeighborsClass, _TpuEstimator, _NearestNeighborsParams):
    """``NearestNeighbors(k=3).fit(item_df).kneighbors(query_df)``: exact
    brute-force kNN."""

    def __init__(self, **kwargs: Any) -> None:
        _TpuEstimator.__init__(self)
        _NearestNeighborsParams.__init__(self)
        if kwargs.pop("float32_inputs", True) is False:
            self.logger.warning("This estimator does not support double precision inputs; ignoring")
        self._set_params(**kwargs)

    def fit(self, dataset: DataFrame, params: Optional[Dict[Any, Any]] = None) -> "NearestNeighborsModel":
        if params:  # a copy with ``params`` set, fitted by this method
            return super().fit(dataset, params)
        model = NearestNeighborsModel(item_df=self._ensureIdCol(dataset))
        self._copyValues(model)
        self._copy_tpu_params(model)
        return model

    def _get_fit_func(self, dataset: DataFrame):  # pragma: no cover
        raise NotImplementedError("NearestNeighbors overrides fit directly")

    def _create_model(self, result: Dict[str, Any]):  # pragma: no cover
        raise NotImplementedError("NearestNeighbors overrides fit directly")

    def write(self) -> Any:
        raise NotImplementedError(
            "NearestNeighbors does not support saving/loading, just re-create the estimator."
        )

    @classmethod
    def read(cls) -> Any:
        raise NotImplementedError(
            "NearestNeighbors does not support saving/loading, just re-create the estimator."
        )


class NearestNeighborsModel(NearestNeighborsClass, _TpuModel, _NearestNeighborsParams):
    """Holds the item DataFrame; ``kneighbors`` runs the search."""

    def __init__(self, item_df: DataFrame, **attrs: Any) -> None:
        _TpuModel.__init__(self, **attrs)
        _NearestNeighborsParams.__init__(self)
        self._item_df_withid = item_df

    def kneighbors(self, query_df: DataFrame) -> Tuple[DataFrame, DataFrame, DataFrame]:
        if self.num_workers != 1:
            raise NotImplementedError(
                f"num_workers={self.num_workers}: multi-GPU searches are not ported yet"
            )
        device = resolve_device(self._device)
        k = self.getK()
        item_df = self._item_df_withid
        n_items = item_df.count()
        if k > n_items:
            raise ValueError(f"k={k} must be <= number of item rows {n_items}")
        query_df_withid = self._ensureIdCol(query_df)
        Xi = _resolve_features_f32(self, item_df)
        Xq = _resolve_features_f32(self, query_df_withid)
        if Xi.shape[1] != Xq.shape[1]:
            raise ValueError(f"item/query dims differ: {Xi.shape[1]} vs {Xq.shape[1]}")
        Xi_d = torch.from_numpy(Xi).to(device)
        d2, idx = knn_search(
            torch.from_numpy(Xq).to(device), Xi_d,
            torch.ones(n_items, device=device),
            torch.arange(n_items, dtype=torch.int32, device=device), k,
        )
        item_ids = np.asarray(item_df.column(self.getIdCol()))
        knn_df = self._knn_result_df(query_df_withid, d2.cpu().numpy(), idx.cpu().numpy(), item_ids)
        return item_df, query_df_withid, knn_df

    def exactNearestNeighborsJoin(self, query_df: DataFrame, distCol: str = "distCol") -> DataFrame:
        id_col = self.getIdCol()
        item_df_withid, query_df_withid, knn_df = self.kneighbors(query_df)
        k = self.getK()
        query_ids = np.asarray(knn_df.column(f"query_{id_col}"))
        flat_item = np.asarray(knn_df.column("indices")).reshape(-1)
        flat_dist = np.asarray(knn_df.column("distances")).reshape(-1)
        flat_query = np.repeat(query_ids, k)

        # join full item/query rows back by id
        def _positions(ids: np.ndarray, values: np.ndarray) -> np.ndarray:
            order = np.argsort(ids, kind="stable")
            return order[np.searchsorted(ids[order], values)]

        item_rows = _positions(np.asarray(item_df_withid.column(id_col)), flat_item)
        query_rows = _positions(np.asarray(query_df_withid.column(id_col)), flat_query)
        drop_generated = not self.isDefined("idCol")
        data: Dict[str, Any] = {}
        for prefix, df, rows in (("item", item_df_withid, item_rows), ("query", query_df_withid, query_rows)):
            for c in df.columns:
                if not (drop_generated and c == _DEFAULT_ID_COL):
                    data[f"{prefix}_{c}"] = np.asarray(df.column(c))[rows]
        data[distCol] = flat_dist
        return DataFrame(data)

    def _knn_result_df(
        self, query_df_withid: DataFrame, d2: np.ndarray, idx: np.ndarray, item_ids: np.ndarray
    ) -> DataFrame:
        """The ``(query_<id>, indices, distances)`` frame from squared
        distances and item positions, sorted by query id."""
        id_col = self.getIdCol()
        distances = np.sqrt(np.maximum(d2, 0.0)).astype(np.float32)
        indices = item_ids[np.clip(idx, 0, len(item_ids) - 1)]
        query_ids = np.asarray(query_df_withid.column(id_col))
        order = np.argsort(query_ids, kind="stable")
        return DataFrame(
            {
                f"query_{id_col}": query_ids[order],
                "indices": indices[order],
                "distances": distances[order],
            }
        )

    # -- unsupported surfaces, as in the JAX package ----------------------
    def transform(self, dataset: DataFrame) -> DataFrame:
        raise NotImplementedError(
            "NearestNeighborsModel does not provide transform; use kneighbors instead."
        )

    def _get_transform_func(self, dataset: Optional[DataFrame] = None):  # pragma: no cover
        raise NotImplementedError("use kneighbors")

    def write(self) -> Any:
        raise NotImplementedError(
            "NearestNeighborsModel does not support saving/loading, just re-fit the estimator to re-create a model."
        )

    @classmethod
    def read(cls) -> Any:
        raise NotImplementedError(
            "NearestNeighborsModel does not support saving/loading, just re-fit the estimator to re-create a model."
        )
