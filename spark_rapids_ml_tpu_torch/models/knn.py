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
(``ops.knn_kernels.knn_search``). ``ApproximateNearestNeighbors`` (IVF-Flat,
``ops.ivf_kernels``) answers through the same result frames; from
``ivf_kernels.ANN_GATE_ROWS`` items on a feasible shape it builds a coarse
quantizer (Lloyd through kernel K2) and scans the probed lists, below
that it answers through the exact search. Multi-process searches are not
ported yet.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..core import _resolve_features_f32, _TpuEstimator, _TpuModel
from ..data.dataframe import DataFrame
from ..ops import ivf_kernels
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


# ==========================================================================
# Approximate nearest neighbors (IVF-Flat)
# ==========================================================================

_ANN_ALGO_KEYS = frozenset(("nlist", "nprobe", "seed"))


def _algo_params_conv(value: Any) -> Optional[Dict[str, int]]:
    """``algoParams`` converter: None or a {nlist, nprobe, seed} -> int
    mapping. Unknown keys raise rather than silently doing nothing."""
    if value is None:
        return None
    if not isinstance(value, dict):
        raise TypeError(f"algoParams must be a dict or None, got {type(value).__name__}")
    unknown = set(value) - _ANN_ALGO_KEYS
    if unknown:
        raise ValueError(f"algoParams keys {sorted(unknown)} not supported; accepted: {sorted(_ANN_ALGO_KEYS)}")
    return {k: int(v) for k, v in value.items()}


class ApproximateNearestNeighborsClass(NearestNeighborsClass):
    @classmethod
    def _param_mapping(cls) -> Dict[str, Optional[str]]:
        return {"k": "n_neighbors", "algorithm": "algorithm", "algoParams": "algoParams"}

    @classmethod
    def _get_tpu_params_default(cls) -> Dict[str, Any]:
        return {"n_neighbors": 5, "algorithm": "ivfflat", "algoParams": None}


class _ApproximateNearestNeighborsParams(_NearestNeighborsParams):
    algorithm = _mk("algorithm", "ANN algorithm (only ivfflat is supported)", TypeConverters.toString)
    algoParams = _mk(
        "algoParams", "algorithm tuning dict: nlist, nprobe, seed (unset keys fall back to heuristics)",
        _algo_params_conv,
    )

    def __init__(self) -> None:
        super().__init__()
        self._setDefault(algorithm="ivfflat")

    def getAlgorithm(self) -> str:
        return self.getOrDefault("algorithm")

    def setAlgorithm(self, value: str) -> "_ApproximateNearestNeighborsParams":
        self._set_params(algorithm=value)  # type: ignore[attr-defined]
        return self

    def getAlgoParams(self) -> Optional[Dict[str, int]]:
        return self.getOrDefault("algoParams") if self.isDefined("algoParams") and self.isSet("algoParams") else None

    def setAlgoParams(self, value: Optional[Dict[str, int]]) -> "_ApproximateNearestNeighborsParams":
        self._set_params(algoParams=value)  # type: ignore[attr-defined]
        return self

    def _check_algorithm(self) -> None:
        algo = self.getAlgorithm()
        if algo != "ivfflat":
            raise ValueError(
                f"algorithm={algo!r} is not supported; only 'ivfflat' is "
                "(the reference's cagra/ivfpq backends have no engine here)"
            )

    def _resolved_algo_params(self, n_items: int) -> Tuple[int, int, int]:
        """Validated ``(nlist, nprobe, seed)`` for an ``n_items`` index:
        ``algoParams`` wins over the sqrt(n) heuristics. Raises
        ``ValueError`` on out-of-domain values."""
        ap = self.getAlgoParams() or {}
        nlist, nprobe = ivf_kernels.resolve_ann_params(n_items, nlist=ap.get("nlist"), nprobe=ap.get("nprobe"))
        return nlist, nprobe, int(ap.get("seed", 0))


class ApproximateNearestNeighbors(ApproximateNearestNeighborsClass, _TpuEstimator, _ApproximateNearestNeighborsParams):
    """``ApproximateNearestNeighbors(k=3, algorithm="ivfflat", algoParams=
    {"nlist": 64, "nprobe": 8}).fit(item_df)``: IVF-Flat approximate kNN.
    ``kneighbors`` output has the exact estimator's shape and semantics;
    below ``ivf_kernels.ANN_GATE_ROWS`` items the model answers with the
    exact search (and the answer is then exact)."""

    def __init__(self, **kwargs: Any) -> None:
        _TpuEstimator.__init__(self)
        _ApproximateNearestNeighborsParams.__init__(self)
        if kwargs.pop("float32_inputs", True) is False:
            self.logger.warning("This estimator does not support double precision inputs; ignoring")
        self._set_params(**kwargs)

    def fit(self, dataset: DataFrame, params: Optional[Dict[Any, Any]] = None) -> "ApproximateNearestNeighborsModel":
        if params:  # a copy with ``params`` set, fitted by this method
            return super().fit(dataset, params)
        # fail fast on a bad algorithm / algoParams, before any query
        self._check_algorithm()
        _algo_params_conv(self.getAlgoParams())
        model = ApproximateNearestNeighborsModel(item_df=self._ensureIdCol(dataset))
        self._copyValues(model)
        self._copy_tpu_params(model)
        return model

    def _get_fit_func(self, dataset: DataFrame):  # pragma: no cover
        raise NotImplementedError("ApproximateNearestNeighbors overrides fit directly")

    def _create_model(self, result: Dict[str, Any]):  # pragma: no cover
        raise NotImplementedError("ApproximateNearestNeighbors overrides fit directly")

    def write(self) -> Any:
        raise NotImplementedError(
            "ApproximateNearestNeighbors does not support saving/loading, just re-create the estimator."
        )

    @classmethod
    def read(cls) -> Any:
        raise NotImplementedError(
            "ApproximateNearestNeighbors does not support saving/loading, just re-create the estimator."
        )


class ApproximateNearestNeighborsModel(
    ApproximateNearestNeighborsClass, NearestNeighborsModel, _ApproximateNearestNeighborsParams
):
    """``kneighbors`` runs the IVF-Flat probe search (``ops.ivf_kernels``)
    against an index built on first use and cached on the model; below the
    row gate, or on an infeasible shape, the exact search of the parent
    answers. ``_ann_report``: the engine, nlist, nprobe and, for the IVF
    engine, the build and search seconds."""

    def __init__(self, item_df: DataFrame, **attrs: Any) -> None:
        _TpuModel.__init__(self, **attrs)
        _ApproximateNearestNeighborsParams.__init__(self)
        self._item_df_withid = item_df

    def _ivf_index(self, Xi: np.ndarray, nlist: int, seed: int, device: torch.device) -> ivf_kernels.IvfIndex:
        """Build-once index cache, keyed by what changes the layout (the
        item set is frozen at fit)."""
        cache = getattr(self, "_ivf_index_cache", None)
        if cache is None:
            cache = self._ivf_index_cache = {}
        key = (nlist, seed, Xi.shape[0], str(device))
        if key not in cache:
            cache[key] = ivf_kernels.build_ivf_index(Xi, nlist=nlist, seed=seed, device=device)
        return cache[key]

    def kneighbors(self, query_df: DataFrame) -> Tuple[DataFrame, DataFrame, DataFrame]:
        self._check_algorithm()
        if self.num_workers != 1:
            raise NotImplementedError(f"num_workers={self.num_workers}: multi-GPU searches are not ported yet")
        k = self.getK()
        item_df = self._item_df_withid
        n_items = item_df.count()
        if k > n_items:
            raise ValueError(f"k={k} must be <= number of item rows {n_items}")
        # resolve and validate FIRST: a bad nlist/nprobe raises even where
        # the gate routes this call to the exact search
        nlist, nprobe, seed = self._resolved_algo_params(n_items)
        gated = n_items >= ivf_kernels.ANN_GATE_ROWS
        if not (gated and ivf_kernels.ivf_feasible(n_items, k, nlist, nprobe)):
            if gated:
                self.logger.warning(
                    "ivfflat infeasible for shape (n_items=%d, k=%d, nlist=%d, nprobe=%d); "
                    "answering with the exact search", n_items, k, nlist, nprobe,
                )
            out = super().kneighbors(query_df)
            self._ann_report = {"engine": "exact", "nlist": nlist, "nprobe": nprobe}
            return out

        device = resolve_device(self._device)
        query_df_withid = self._ensureIdCol(query_df)
        Xi = _resolve_features_f32(self, item_df)
        Xq = _resolve_features_f32(self, query_df_withid)
        if Xi.shape[1] != Xq.shape[1]:
            raise ValueError(f"item/query dims differ: {Xi.shape[1]} vs {Xq.shape[1]}")
        ids_arr = np.asarray(item_df.column(self.getIdCol()))
        t0 = time.perf_counter()
        index = self._ivf_index(Xi, nlist, seed, device)
        if device.type == "cuda":  # the build's device work inside its seconds
            torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        d2, idx = ivf_kernels.ivf_search(torch.from_numpy(Xq).to(device), index, k=k, nprobe=nprobe)
        d2, idx = d2.cpu().numpy(), idx.cpu().numpy()
        t2 = time.perf_counter()
        knn_df = self._knn_result_df(query_df_withid, d2, idx, ids_arr)
        self._ann_report = {
            "engine": "ivf", "nlist": nlist, "nprobe": nprobe,
            "build_seconds": round(t1 - t0, 4), "search_seconds": round(t2 - t1, 4),
        }
        return item_df, query_df_withid, knn_df

    def approxSimilarityJoin(self, query_df: DataFrame, distCol: str = "distCol") -> DataFrame:
        """One row per (item, query) pair of the approximate result: the
        exact estimator's join semantics over this model's kneighbors."""
        return self.exactNearestNeighborsJoin(query_df, distCol)
