"""Core estimator/model framework of the port (counterpart of
``spark_rapids_ml_tpu/core.py``).

The subclass contract is the JAX package's, with the "tpu" dropped from the
hook names:

  JAX package                         this port
  ---------------------------------   ---------------------------------
  ``_get_tpu_fit_func``               ``_get_fit_func``
  ``_get_tpu_transform_func``         ``_get_transform_func``
  ``_pre_process_data``               ``_pre_process_data``
  ``fitMultiple``                     ``fitMultiple`` (one pass where
                                      ``_enable_fit_multiple_in_single_pass``)
  ``_Writer`` / ``_Reader``           same on-disk format

  ``_get_tpu_streaming_fit_func``     ``_get_streaming_fit_func``

``_pre_process_data`` copies the design matrix onto one torch device
(``cuda:0`` unless the estimator was given ``device=``) as a padded tensor
plus a row-validity mask, with the labels and the ``weightCol`` weights in
the same row layout; the fit function is plain PyTorch over those tensors,
calling the port's CUDA kernels on the card.

An estimator with a streaming fit function (PCA, LinearRegression) fits
out of core instead when ``_should_stream`` says so: ``streaming=True``, a
parquet scan whose columns are on disk, an explicit sparse opt-in, or a
design matrix larger than ``_default_stream_threshold_bytes``.
``_pre_process_stream`` then hands the fit a ``StreamInputs`` around a
chunk source (``data.chunks``), and the card holds a few chunks, never the
dataset. A model's ``transform`` over a parquet scan streams it the same
way. ``tuning.CrossValidator`` evaluates a fold in one pass where the
estimator says so (``_supportsTransformEvaluate``): ``fitMultiple``, the
model class's ``_combine``, then one ``_transformEvaluate``. Gang dispatch
and telemetry spans are not ported yet.

Float64 (``float32_inputs=False`` on float64 data, the JAX package's
``_target_dtype``) places the rows, labels and weights in f64 and streams
f64 chunks; each fit then takes its kernels' float64 routes, chosen by
dtype before any kernel wrapper. An estimator or model that computes in
float32 only overrides ``_compute_dtype`` (UMAP coerces, forests and GBT
refuse). ``_TpuModel.cpu()`` / ``to_sklearn()`` export a fitted model
(``export``).

Persistence writes ``metadata.json``, ``model.npz`` and
``attributes.json`` exactly as the JAX package does, so either package's
saved models load in the port; a JAX class name is mapped onto the port's
class through a table and its module is never imported.
"""

from __future__ import annotations

import importlib
import json
import os
import shutil
from abc import abstractmethod
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .data.dataframe import AugmentedScanFrame, DataFrame, ParquetScanFrame, _is_sparse
from .params import HasLabelCol, HasWeightCol, Params, _TpuParams
from .parallel.mesh import _torch_dtype, shard_aligned, shard_rows
from .utils.logging import get_logger
from .utils.platform import resolve_device

_PKG = __name__.rsplit(".", 1)[0]

# JAX package class -> port class, for loading what the JAX package saved
_JAX_CLASSES = {
    f"spark_rapids_ml_tpu.models.{mod}.{name}": f"{_PKG}.models.{mod}.{name}"
    for mod, name in (
        ("feature", "PCA"),
        ("feature", "PCAModel"),
        ("clustering", "KMeans"),
        ("clustering", "KMeansModel"),
        ("classification", "LogisticRegression"),
        ("classification", "LogisticRegressionModel"),
        ("regression", "LinearRegression"),
        ("regression", "LinearRegressionModel"),
        ("umap", "UMAP"),
        ("umap", "UMAPModel"),
        ("tree", "RandomForestClassifier"),
        ("tree", "RandomForestClassificationModel"),
        ("tree", "RandomForestRegressor"),
        ("tree", "RandomForestRegressionModel"),
        ("tree", "GBTClassifier"),
        ("tree", "GBTClassificationModel"),
        ("tree", "GBTRegressor"),
        ("tree", "GBTRegressionModel"),
    )
}


def _resolve_feature_matrix(obj: "_TpuParams", dataset: DataFrame) -> np.ndarray:
    """The feature columns of ``dataset`` as one dense matrix (a sparse
    column is densified whole; a streamed fit densifies it a chunk at a
    time instead)."""
    input_col, input_cols = obj._get_input_columns()
    if input_cols is not None:
        mats = [np.asarray(dataset.column(c)).reshape(-1, 1) for c in input_cols]
        return np.concatenate(mats, axis=1)
    col = dataset.column(input_col)
    if _is_sparse(col):
        return np.asarray(col.todense())
    X = np.asarray(col)
    if X.ndim != 2:
        raise ValueError(f"Features column {input_col!r} must be a 2-D vector column")
    return X


def _target_dtype(obj: "_TpuParams", X: Optional[np.ndarray]) -> type:
    """The dtype a fit or transform computes in (the JAX package's
    ``_target_dtype``): float32, unless ``float32_inputs=False`` and ``X`` is
    float64."""
    if not obj._float32_inputs and X is not None and X.dtype == np.float64:
        return np.float64
    return np.float32


def _features(obj: Any, X: np.ndarray) -> np.ndarray:
    """Features as one contiguous matrix in the dtype ``obj`` computes in
    (:func:`_target_dtype`, through the class's ``_compute_dtype``)."""
    return np.ascontiguousarray(X, dtype=obj._compute_dtype(_target_dtype(obj, X)))


def _resolve_features_f32(obj: "_TpuParams", dataset: DataFrame) -> np.ndarray:
    """Features as one dense contiguous float32 matrix, whatever
    ``float32_inputs`` says: kNN and UMAP compute in float32 only."""
    return np.ascontiguousarray(_resolve_feature_matrix(obj, dataset), dtype=np.float32)


@dataclass
class FitInputs:
    """Everything a fit function needs: the device design matrix + metadata."""

    X: torch.Tensor                      # (N_pad, d) on ``device``
    mask: torch.Tensor                   # (N_pad,) 1.0 valid / 0.0 padding
    device: torch.device
    n_rows: int                          # true (unpadded) row count
    n_features: int
    y: Optional[torch.Tensor] = None     # (N_pad,) labels, padded with 0
    weight: Optional[torch.Tensor] = None  # (N_pad,) row weights, padded with 0
    dtype: torch.dtype = torch.float32
    csize: int = 1                       # row-chunk size (rows pad to it)


# fit function: (inputs, params_dict) -> dict of named numpy arrays/scalars
FitFunc = Callable[[FitInputs, Dict[str, Any]], Dict[str, Any]]


@dataclass
class StreamInputs:
    """Inputs of a streamed fit: a re-iterable chunk source instead of
    tensors on the card. The card holds a few chunks and the fit's state,
    never the dataset."""

    source: Any                          # data.chunks.ChunkSource
    device: torch.device
    n_rows: int
    n_features: int
    dtype: torch.dtype = torch.float32
    chunk_rows: int = 1 << 16


# streaming fit function: (stream_inputs, params_dict) -> named arrays
StreamFitFunc = Callable[[StreamInputs, Dict[str, Any]], Dict[str, Any]]


def _default_stream_threshold_bytes(device: torch.device) -> int:
    """Design-matrix bytes above which a fit streams instead of copying the
    matrix onto the card: 60% of the card's memory (the matrix must leave
    room for the fit's temporaries), or 8 GiB on the CPU."""
    if device.type == "cuda":
        _, total = torch.cuda.mem_get_info(device)
        return int(0.6 * total)
    return 8 << 30


class _TpuEstimator(Params, _TpuParams):
    """Abstract estimator (the JAX package's ``_TpuEstimator``)."""

    def __init__(self) -> None:
        super().__init__()
        self._init_tpu_params()
        self.logger = get_logger(type(self))

    # ---- subclass hooks --------------------------------------------------
    @abstractmethod
    def _get_fit_func(self, dataset: DataFrame) -> FitFunc:
        ...

    @abstractmethod
    def _create_model(self, result: Dict[str, Any]) -> "_TpuModel":
        ...

    def _require_label(self) -> bool:
        return isinstance(self, HasLabelCol)

    def _compute_dtype(self, dtype: type) -> type:
        """The dtype this estimator fits in, given the one the data plane
        chose (float32 or float64); estimators that fit in float32 only
        coerce or refuse float64 here."""
        return dtype

    def _supportsTransformEvaluate(self, evaluator: Any) -> bool:
        """True when this estimator's models evaluate every param map of a
        CV fold in one pass (``_TpuModel._combine`` and
        ``_transformEvaluate``) under ``evaluator``."""
        return False

    def _enable_fit_multiple_in_single_pass(self) -> bool:
        """True when one fit function may serve every param map of a
        ``fitMultiple`` over one copy of the data."""
        return False

    def _get_streaming_fit_func(self, dataset: DataFrame) -> Optional[StreamFitFunc]:
        """Chunked out-of-core fit, or None where the algorithm needs the
        matrix on the card. Engaged by :meth:`_should_stream`."""
        return None

    def _resolved_weight_col(self) -> Optional[str]:
        """The explicitly set weight column, or None."""
        if (
            isinstance(self, HasWeightCol)
            and self.hasParam("weightCol")
            and self.isSet("weightCol")
            and self.getOrDefault("weightCol") is not None
        ):
            return self.getOrDefault("weightCol")
        return None

    # ---- streaming decision / data plane --------------------------------
    def _should_stream(self, dataset: DataFrame) -> bool:
        if self._streaming is not None:
            return bool(self._streaming)
        input_col, input_cols = self._get_input_columns()
        if isinstance(dataset, ParquetScanFrame) and not dataset.is_materialized():
            # only on-disk columns stream: a column a prior transform
            # appended in memory (AugmentedScanFrame) takes the resident path
            if input_cols is not None:
                return False
            needed = [input_col]
            if self._require_label():
                needed.append(self.getOrDefault("labelCol"))
            wcol = self._resolved_weight_col()
            if wcol is not None:
                needed.append(wcol)
            return all(dataset.has_disk_column(c) for c in needed)
        if input_cols is not None:
            n_features = len(input_cols)
        else:
            col = dataset.column(input_col)
            if (
                _is_sparse(col)
                and self.hasParam("enable_sparse_data_optim")
                and self.isDefined("enable_sparse_data_optim")
                and self.getOrDefault("enable_sparse_data_optim") is True
            ):
                # the explicit sparse opt-in: the matrix must never be
                # densified whole, so CSR chunks are densified one by one
                return True
            n_features = int(col.shape[1]) if col.ndim == 2 or _is_sparse(col) else 1
        itemsize = 4 if self._float32_inputs else 8
        est_bytes = dataset.count() * n_features * itemsize
        return est_bytes > _default_stream_threshold_bytes(resolve_device(self._device))

    def _pre_process_stream(self, dataset: DataFrame) -> StreamInputs:
        """A chunk source over ``dataset``: the scan's parquet files, CSR
        rows densified a chunk at a time, or the in-memory rows."""
        from .data.chunks import ArrayChunkSource, CSRChunkSource, auto_chunk_rows

        device = resolve_device(self._device)
        if self.num_workers != 1:
            raise NotImplementedError(
                f"num_workers={self.num_workers}: multi-GPU fits are not ported yet"
            )
        label_col = self.getOrDefault("labelCol") if self._require_label() else None
        weight_col = self._resolved_weight_col()
        input_col, input_cols = self._get_input_columns()
        if (
            isinstance(dataset, ParquetScanFrame)
            and not dataset.is_materialized()
            and all(dataset.has_disk_column(c) for c in (input_col, label_col, weight_col) if c is not None)
        ):
            if input_cols is not None:
                raise ValueError(
                    "a streamed fit over a parquet scan needs a single vector "
                    "features column (featuresCols is resident-only)"
                )
            source = dataset.chunk_source(features_col=input_col, label_col=label_col, weight_col=weight_col)
            dtype = np.float32 if self._float32_inputs else np.float64
        else:
            # a column that lives only in memory (a prior streamed
            # transform's output, maybe shadowing a disk column) is read
            # through dataset.column()
            y = None if label_col is None else np.asarray(dataset.column(label_col))
            if weight_col is not None and weight_col not in dataset:
                raise ValueError(
                    f"weightCol {weight_col!r} not found in dataset columns {dataset.columns}"
                )
            w = None if weight_col is None else np.asarray(dataset.column(weight_col))
            col = dataset.column(input_col) if input_cols is None else None
            if col is not None and _is_sparse(col):
                source = CSRChunkSource(col, y, w)
                dtype = np.float32 if self._float32_inputs else np.float64
            else:
                X = _resolve_feature_matrix(self, dataset)
                source = ArrayChunkSource(X, y, w)
                dtype = _target_dtype(self, X)
        dtype = self._compute_dtype(dtype)
        chunk_rows = self._stream_chunk_rows or auto_chunk_rows(source.n_features, np.dtype(dtype).itemsize, 1)
        return StreamInputs(
            source=source,
            device=device,
            n_rows=int(source.n_rows),
            n_features=int(source.n_features),
            dtype=_torch_dtype(dtype),
            chunk_rows=int(chunk_rows),
        )

    # ---- data plane ------------------------------------------------------
    def _chunk_rows(self, n_rows: int, n_dp: int) -> int:
        """Row-chunk size; subclasses with chunked passes override (rows
        are padded to a multiple of it)."""
        return 1

    @staticmethod
    def _equal_chunk_rows(n_rows: int, n_dp: int, cap: int) -> int:
        """Smallest chunk <= cap that divides each device's shard into equal
        pieces: bounds padding to < n_chunks rows/device (vs up to cap-1)."""
        per_dev = max(1, -(-n_rows // n_dp))
        n_chunks = -(-per_dev // cap)
        return -(-per_dev // n_chunks)

    def _pre_process_data(self, dataset: DataFrame) -> FitInputs:
        device = resolve_device(self._device)
        if self.num_workers != 1:
            raise NotImplementedError(
                f"num_workers={self.num_workers}: multi-GPU fits are not ported yet"
            )
        X = _features(self, _resolve_feature_matrix(self, dataset))
        n_rows, n_features = X.shape
        csize = self._chunk_rows(int(n_rows), 1)
        Xd, maskd = shard_rows(X, device, csize)
        y = w = None
        if self._require_label():
            label_col = self.getOrDefault("labelCol")
            y_host = np.asarray(dataset.column(label_col), dtype=X.dtype)
            y = shard_aligned(y_host, device, Xd.shape[0])
        wcol = self._resolved_weight_col()
        if wcol is not None:
            if wcol not in dataset:
                raise ValueError(
                    f"weightCol {wcol!r} not found in dataset columns {dataset.columns}"
                )
            w_host = np.asarray(dataset.column(wcol), dtype=X.dtype)
            w = shard_aligned(w_host, device, Xd.shape[0])
        return FitInputs(
            X=Xd,
            mask=maskd,
            device=device,
            n_rows=int(n_rows),
            n_features=int(n_features),
            y=y,
            weight=w,
            dtype=Xd.dtype,
            csize=csize,
        )

    # ---- fit -------------------------------------------------------------
    def fit(self, dataset: DataFrame, params: Optional[Dict[Any, Any]] = None) -> "_TpuModel":
        if params:
            return self._with_params(params).fit(dataset)
        return self._fit_lanes(dataset, None)[0]

    def fitMultiple(
        self, dataset: DataFrame, paramMaps: Sequence[Dict[Any, Any]]
    ) -> Iterator[Tuple[int, "_TpuModel"]]:
        """Every param map from one copy of the data where the estimator
        enables it (``_enable_fit_multiple_in_single_pass``): one
        ``_pre_process_data``, one fit function, one call of it per param
        map. Otherwise one whole ``fit`` per param map."""
        if self._enable_fit_multiple_in_single_pass():
            models = self._fit_lanes(dataset, list(paramMaps))
        else:
            models = [self.fit(dataset, pm) for pm in paramMaps]
        return _FitMultipleIterator(models)

    def _with_params(self, params: Dict[Any, Any]) -> "_TpuEstimator":
        """A copy of this estimator with ``params`` (Param or name -> value) set."""
        est = self.copy()
        self._copy_tpu_params(est)
        est._set_params(**{p.name if hasattr(p, "name") else p: v for p, v in params.items()})
        return est

    def _fit_lanes(
        self, dataset: DataFrame, paramMaps: Optional[List[Dict[Any, Any]]]
    ) -> List["_TpuModel"]:
        """One model per param map (``None``: this estimator's own params)
        over one ``_pre_process_data`` (or ``_pre_process_stream``, where
        the fit streams) and one fit function."""
        from .ops.streaming import last_ingest_report, reset_ingest_report

        self._apply_verbosity()
        stream_func = self._get_streaming_fit_func(dataset)
        streaming = stream_func is not None and self._should_stream(dataset)
        if streaming:
            self.logger.info("Streamed fit (out-of-core chunked ingest).")
            inputs: Any = self._pre_process_stream(dataset)
            fit_func: Any = stream_func
            reset_ingest_report()
        else:
            inputs = self._pre_process_data(dataset)
            fit_func = self._get_fit_func(dataset)
        estimators = [self] if paramMaps is None else [self._with_params(pm) for pm in paramMaps]
        models = []
        for est in estimators:
            model = est._create_model(fit_func(inputs, dict(est._tpu_params)))
            est._copyValues(model)
            est._copy_tpu_params(model)
            if streaming:
                # the ingest pipeline's depths and pace over the fit's passes
                model._ingest_report = last_ingest_report()
            models.append(model)
        return models

    # ---- persistence -----------------------------------------------------
    def write(self) -> "_Writer":
        return _Writer(self)

    def save(self, path: str) -> None:
        self.write().save(path)

    @classmethod
    def read(cls) -> "_Reader":
        return _Reader(cls)

    @classmethod
    def load(cls, path: str) -> "_TpuEstimator":
        return cls.read().load(path)

    def _get_model_attributes(self) -> Optional[Dict[str, Any]]:
        return None


class _FitMultipleIterator:
    """Thread-safe (index, model) iterator."""

    def __init__(self, models: List["_TpuModel"]):
        import threading

        self._models = models
        self._index = 0
        self._lock = threading.Lock()

    def __iter__(self) -> "_FitMultipleIterator":
        return self

    def __next__(self) -> Tuple[int, "_TpuModel"]:
        with self._lock:
            i = self._index
            if i >= len(self._models):
                raise StopIteration
            self._index += 1
        return i, self._models[i]


class _TpuEstimatorSupervised(_TpuEstimator, HasLabelCol):
    """Adds label handling."""

    def _require_label(self) -> bool:
        return True


class _TpuModel(Params, _TpuParams):
    """Abstract fitted model (the JAX package's ``_TpuModel``)."""

    # the ingest report of a streamed fit (ops.streaming.last_ingest_report);
    # {} for resident fits and loaded models
    _ingest_report: Dict[str, Any] = {}

    def __init__(self, **model_attributes: Any) -> None:
        super().__init__()
        self._init_tpu_params()
        self._model_attributes = model_attributes
        self.logger = get_logger(type(self))

    def _get_model_attributes(self) -> Dict[str, Any]:
        return self._model_attributes

    def _compute_dtype(self, dtype: type) -> type:
        """The dtype this model transforms in, given the one the data plane
        chose (float32 or float64); models that compute in float32 only
        coerce or refuse float64 here."""
        return dtype

    def cpu(self) -> "_TpuModel":
        """The model itself: the reference converts to a Spark JVM model
        (its ``feature.py:365-379``), but without Spark the model already
        transforms on the CPU (``device="cpu"``). :meth:`to_sklearn` exports
        a fitted scikit-learn estimator for serving outside this package."""
        return self

    def to_sklearn(self) -> Any:
        """A fitted scikit-learn estimator whose ``predict`` / ``transform``
        reproduces this model's transform (:mod:`..export`; sklearn is
        imported here, not with the package)."""
        from .export import to_sklearn

        return to_sklearn(self)

    # ---- transform -------------------------------------------------------
    @abstractmethod
    def _get_transform_func(
        self, dataset: Optional[DataFrame] = None
    ) -> Callable[[np.ndarray], Dict[str, np.ndarray]]:
        """Return fn: host feature batch (n, d) -> dict of output columns
        (host numpy); core handles batching and column wiring."""
        ...

    def _memoized_transform_fn(
        self,
        key: Tuple[Any, ...],
        build: Callable[[], Callable[[np.ndarray], Dict[str, np.ndarray]]],
    ) -> Callable[[np.ndarray], Dict[str, np.ndarray]]:
        """Cache a transform closure (and the device copies of the model
        it holds) on the model, keyed by everything it hoisted."""
        cache = getattr(self, "_transform_fn_cache", None)
        if cache is None:
            cache = self._transform_fn_cache = {}
        fn = cache.get(key)
        if fn is None:
            fn = cache[key] = build()
        return fn

    def transform(self, dataset: DataFrame) -> DataFrame:
        """Append prediction/output columns; rows go through the device in
        batches of :meth:`_transform_batch_rows`. A parquet scan whose
        features column is on disk is streamed, never materialized: the
        result is an :class:`AugmentedScanFrame` holding the output columns
        in memory."""
        self._apply_verbosity()
        if isinstance(dataset, ParquetScanFrame) and not dataset.is_materialized():
            input_col, input_cols = self._get_input_columns()
            if input_cols is None and dataset.has_disk_column(input_col):
                out_columns = self._apply_streamed(self._get_transform_func(dataset), dataset, input_col)
                return AugmentedScanFrame(dataset, out_columns)
        X = _features(self, _resolve_feature_matrix(self, dataset))
        out_columns = self._apply_batched(self._get_transform_func(dataset), X)
        out = dataset
        for name, col in out_columns.items():
            out = out.withColumn(name, col)
        return out

    def _transform_batch_rows(self) -> int:
        return 1 << 17  # 131072 rows/batch keeps device memory bounded

    def _apply_batched(
        self,
        fn: Callable[[np.ndarray], Dict[str, np.ndarray]],
        X: np.ndarray,
    ) -> Dict[str, np.ndarray]:
        n = X.shape[0]
        bs = self._transform_batch_rows()
        chunks: Dict[str, List[np.ndarray]] = {}
        for lo in range(0, max(n, 1), bs):
            for k, v in fn(X[lo : lo + bs]).items():
                chunks.setdefault(k, []).append(np.asarray(v))
        return {k: np.concatenate(v, axis=0) for k, v in chunks.items()}

    def _apply_streamed(
        self,
        fn: Callable[[np.ndarray], Dict[str, np.ndarray]],
        scan: ParquetScanFrame,
        input_col: str,
    ) -> Dict[str, np.ndarray]:
        """``fn`` over the scan's features, one chunk of
        :meth:`_transform_batch_rows` rows at a time: the host holds the
        output columns, never the feature matrix. The chunks are float64
        where ``float32_inputs=False``, as in the JAX package."""
        dtype = self._compute_dtype(np.float32 if self._float32_inputs else np.float64)
        source = scan.chunk_source(features_col=input_col)
        chunks: Dict[str, List[np.ndarray]] = {}
        for chunk in source.iter_chunks(self._transform_batch_rows(), dtype=dtype):
            # writeable too: a parquet chunk may be a read-only arrow view
            Xb = np.require(chunk.X[: chunk.n_valid], dtype, ["C", "W"])
            for k, v in fn(Xb).items():
                chunks.setdefault(k, []).append(np.asarray(v)[: chunk.n_valid])
        return {k: np.concatenate(v, axis=0) for k, v in chunks.items()}

    # ---- multi-model support (CV single pass) ----------------------------
    @classmethod
    def _combine(cls, models: List["_TpuModel"]) -> "_TpuModel":
        raise NotImplementedError(f"{cls.__name__} does not support _combine")

    def _transformEvaluate(self, dataset: DataFrame, evaluator: Any) -> List[float]:
        raise NotImplementedError(
            f"{type(self).__name__} does not support _transformEvaluate"
        )

    # ---- persistence -----------------------------------------------------
    def write(self) -> "_Writer":
        return _Writer(self)

    def save(self, path: str) -> None:
        self.write().save(path)

    @classmethod
    def read(cls) -> "_Reader":
        return _Reader(cls)

    @classmethod
    def load(cls, path: str) -> "_TpuModel":
        return cls.read().load(path)


# ---------------------------------------------------------------------------
# Persistence: metadata JSON + npz arrays, the JAX package's format.
# ---------------------------------------------------------------------------


class _Writer:
    def __init__(self, instance: Union[_TpuEstimator, _TpuModel]):
        self._instance = instance
        self._overwrite = False

    def overwrite(self) -> "_Writer":
        self._overwrite = True
        return self

    def save(self, path: str) -> None:
        inst = self._instance
        if os.path.exists(path):
            if self._overwrite:
                shutil.rmtree(path)
            else:
                raise FileExistsError(f"Path {path} exists; use write().overwrite()")
        os.makedirs(path)
        params = {}
        for p in inst.params:
            if inst.isSet(p):
                v = inst.getOrDefault(p)
                params[p.name] = v if _json_ok(v) else str(v)
        defaults = {}
        for p in inst.params:
            if inst.hasDefault(p):
                v = inst._defaultParamMap[p]
                defaults[p.name] = v if _json_ok(v) else str(v)
        meta = {
            "class": f"{type(inst).__module__}.{type(inst).__name__}",
            "uid": inst.uid,
            "paramMap": params,
            "defaultParamMap": defaults,
            "tpuParams": {k: v for k, v in inst._tpu_params.items() if _json_ok(v)},
            "numWorkers": inst._num_workers,
            "float32Inputs": inst._float32_inputs,
            "streaming": inst._streaming,
            "streamChunkRows": inst._stream_chunk_rows,
        }
        with open(os.path.join(path, "metadata.json"), "w") as f:
            json.dump(meta, f, indent=2, default=str)
        attrs = inst._get_model_attributes()
        if attrs is not None:
            arrays = {}
            scalars = {}
            for k, v in attrs.items():
                a = np.asarray(v)
                if a.dtype == object:
                    scalars[k] = v
                elif a.ndim == 0 and _json_ok(v):
                    scalars[k] = v if not isinstance(v, np.generic) else v.item()
                else:
                    arrays[k] = a
            if arrays:
                np.savez(os.path.join(path, "model.npz"), **arrays)
            with open(os.path.join(path, "attributes.json"), "w") as f:
                json.dump(scalars, f, indent=2, default=str)


def resolve_class(name: str) -> type:
    """The port's class for a saved ``metadata.json["class"]``: the port's
    own names import directly; the JAX package's go through
    ``_JAX_CLASSES`` (its module is never imported)."""
    if not name.startswith(_PKG + "."):
        if name not in _JAX_CLASSES:
            raise ValueError(f"cannot load {name!r}: no ported class for it")
        name = _JAX_CLASSES[name]
    module_name, cls_name = name.rsplit(".", 1)
    return getattr(importlib.import_module(module_name), cls_name)


class _Reader:
    def __init__(self, cls: type):
        self._cls = cls

    def load(self, path: str) -> Any:
        with open(os.path.join(path, "metadata.json")) as f:
            meta = json.load(f)
        cls = resolve_class(meta["class"])
        attrs: Dict[str, Any] = {}
        npz_path = os.path.join(path, "model.npz")
        if os.path.exists(npz_path):
            with np.load(npz_path, allow_pickle=False) as z:
                attrs.update({k: z[k] for k in z.files})
        attrs_json = os.path.join(path, "attributes.json")
        if os.path.exists(attrs_json):
            with open(attrs_json) as f:
                attrs.update(json.load(f))
        inst = cls(**attrs) if issubclass(cls, _TpuModel) else cls()
        for name, v in meta.get("paramMap", {}).items():
            if inst.hasParam(name):
                inst._set(**{name: v})
        inst._tpu_params.update(meta.get("tpuParams", {}))
        inst._num_workers = meta.get("numWorkers")
        inst._float32_inputs = meta.get("float32Inputs", True)
        inst._streaming = meta.get("streaming")
        inst._stream_chunk_rows = meta.get("streamChunkRows")
        return inst


def _json_ok(v: Any) -> bool:
    try:
        json.dumps(v)
        return True
    except (TypeError, ValueError):
        return False
