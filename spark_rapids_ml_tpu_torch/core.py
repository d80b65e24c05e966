"""Core estimator/model framework of the port (counterpart of
``spark_rapids_ml_tpu/core.py``).

The subclass contract is the JAX package's, with the "tpu" dropped from the
hook names:

  JAX package                         this port
  ---------------------------------   ---------------------------------
  ``_get_tpu_fit_func``               ``_get_fit_func``
  ``_get_tpu_transform_func``         ``_get_transform_func``
  ``_pre_process_data``               ``_pre_process_data``
  ``fitMultiple``                     a plain loop over ``fit``
  ``_Writer`` / ``_Reader``           same on-disk format

``_pre_process_data`` copies the design matrix onto one torch device
(``cuda:0`` unless the estimator was given ``device=``) as a padded tensor
plus a row-validity mask; the fit function is plain PyTorch over those
tensors, calling the port's CUDA kernels on the card. Gang dispatch, the
streamed out-of-core decision and telemetry spans are not ported yet.

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

from .data.dataframe import DataFrame, _is_sparse
from .params import HasLabelCol, Params, _TpuParams
from .parallel.mesh import shard_aligned, shard_rows
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
        ("umap", "UMAP"),
        ("umap", "UMAPModel"),
        ("tree", "RandomForestClassifier"),
        ("tree", "RandomForestClassificationModel"),
        ("tree", "RandomForestRegressor"),
        ("tree", "RandomForestRegressionModel"),
    )
}


def _resolve_feature_matrix(obj: "_TpuParams", dataset: DataFrame) -> np.ndarray:
    """The feature columns of ``dataset`` as one dense matrix (a sparse
    column is densified: the port has no sparse path yet)."""
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


def _f32_features(obj: "_TpuParams", X: np.ndarray) -> np.ndarray:
    """Features as contiguous float32; float64 inputs
    (``float32_inputs=False``) are not ported yet."""
    if not obj._float32_inputs and X.dtype == np.float64:
        raise NotImplementedError(
            "float64 inputs (float32_inputs=False) are not ported yet"
        )
    return np.ascontiguousarray(X, dtype=np.float32)


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
    dtype: torch.dtype = torch.float32
    csize: int = 1                       # row-chunk size (rows pad to it)


# fit function: (inputs, params_dict) -> dict of named numpy arrays/scalars
FitFunc = Callable[[FitInputs, Dict[str, Any]], Dict[str, Any]]


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
        X = _f32_features(self, _resolve_feature_matrix(self, dataset))
        n_rows, n_features = X.shape
        csize = self._chunk_rows(int(n_rows), 1)
        Xd, maskd = shard_rows(X, device, csize)
        y = None
        if self._require_label():
            label_col = self.getOrDefault("labelCol")
            y_host = np.asarray(dataset.column(label_col), dtype=np.float32)
            y = shard_aligned(y_host, device, Xd.shape[0])
        return FitInputs(
            X=Xd,
            mask=maskd,
            device=device,
            n_rows=int(n_rows),
            n_features=int(n_features),
            y=y,
            csize=csize,
        )

    # ---- fit -------------------------------------------------------------
    def fit(self, dataset: DataFrame, params: Optional[Dict[Any, Any]] = None) -> "_TpuModel":
        if params:
            est = self.copy()
            self._copy_tpu_params(est)
            kw = {p.name if hasattr(p, "name") else p: v for p, v in params.items()}
            est._set_params(**kw)
            return est.fit(dataset)
        self._apply_verbosity()
        inputs = self._pre_process_data(dataset)
        result = self._get_fit_func(dataset)(inputs, dict(self._tpu_params))
        model = self._create_model(result)
        self._copyValues(model)
        self._copy_tpu_params(model)
        return model

    def fitMultiple(
        self, dataset: DataFrame, paramMaps: Sequence[Dict[Any, Any]]
    ) -> Iterator[Tuple[int, "_TpuModel"]]:
        """One fit per param map (the JAX package's single-pass variant,
        which reuses the resident design matrix, is not ported yet)."""
        return _FitMultipleIterator([self.fit(dataset, pm) for pm in paramMaps])

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

    def __init__(self, **model_attributes: Any) -> None:
        super().__init__()
        self._init_tpu_params()
        self._model_attributes = model_attributes
        self.logger = get_logger(type(self))

    def _get_model_attributes(self) -> Dict[str, Any]:
        return self._model_attributes

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
        batches of :meth:`_transform_batch_rows`."""
        self._apply_verbosity()
        X = _f32_features(self, _resolve_feature_matrix(self, dataset))
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
