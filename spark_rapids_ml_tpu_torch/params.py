"""Parameter system of the PyTorch/CUDA port (a copy of
``spark_rapids_ml_tpu/params.py``, which the port may not import).

Provides two things:

1. A standalone, pyspark-ml-compatible ``Param``/``Params`` machinery (the
   reference builds on ``pyspark.ml.param.Params``; we are Spark-free, so we
   re-implement the same user-facing contract: typed params with defaults,
   ``getOrDefault``/``set``/``isSet``, ``extractParamMap``, ``copy(extra)``,
   and the shared mixins such as ``HasFeaturesCol``).

2. The framework-level mapping layer between user-facing (Spark ML style)
   params and backend ("tpu") kwargs, mirroring the reference's
   ``_CumlClass`` / ``_CumlParams`` design
   (spark-rapids-ml ``python/src/spark_rapids_ml/params.py:88-169`` and
   ``:172-375``):

   * ``_param_mapping()``: Spark-param -> backend-param; a value of ``""``
     means "accepted but silently ignored", ``None`` means "not supported,
     raise on set" (reference semantics at ``params.py:96-124``).
   * ``_param_value_mapping()``: per-param value translation lambdas
     (reference ``params.py:126-160``).
   * ``_TpuParams.tpu_params`` mirrors ``_CumlParams.cuml_params``: the dict
     of backend kwargs kept in sync with the user-facing params.

The backend here is PyTorch on one CUDA card (or the CPU when asked):
``tpu_params`` keeps the JAX package's name so a saved model's
``tpuParams`` reads the same in both packages; they are the kwargs handed to
the fit/transform functions.
"""

from __future__ import annotations

import copy as _copy
from typing import Any, Callable, Dict, List, Optional, TypeVar, Union

from .utils.logging import get_logger

P = TypeVar("P", bound="Params")


class Param:
    """A typed parameter with self-contained documentation.

    API-compatible subset of ``pyspark.ml.param.Param``.
    """

    def __init__(
        self,
        parent: Any,
        name: str,
        doc: str,
        typeConverter: Optional[Callable[[Any], Any]] = None,
    ):
        self.parent = parent
        self.name = name
        self.doc = doc
        self.typeConverter = typeConverter or (lambda x: x)

    def _copy_new_parent(self, parent: Any) -> "Param":
        p = Param(parent, self.name, self.doc, self.typeConverter)
        return p

    def __repr__(self) -> str:
        return f"{self.__class__.__name__}(name={self.name!r})"

    def __hash__(self) -> int:
        return hash((id(self.parent), self.name))

    def __eq__(self, other: Any) -> bool:
        return (
            isinstance(other, Param)
            and self.parent is other.parent
            and self.name == other.name
        )


class TypeConverters:
    """Value converters matching ``pyspark.ml.param.TypeConverters`` names."""

    @staticmethod
    def toInt(value: Any) -> int:
        if isinstance(value, bool):
            raise TypeError(f"Could not convert {value} to int")
        return int(value)

    @staticmethod
    def toFloat(value: Any) -> float:
        if isinstance(value, bool):
            raise TypeError(f"Could not convert {value} to float")
        return float(value)

    @staticmethod
    def toBoolean(value: Any) -> bool:
        if not isinstance(value, (bool, int)):
            raise TypeError(f"Could not convert {value} to bool")
        return bool(value)

    @staticmethod
    def toString(value: Any) -> str:
        return str(value)

    @staticmethod
    def toList(value: Any) -> list:
        return list(value)

    @staticmethod
    def toListString(value: Any) -> List[str]:
        return [str(v) for v in value]

    @staticmethod
    def toListFloat(value: Any) -> List[float]:
        return [float(v) for v in value]

    @staticmethod
    def toListInt(value: Any) -> List[int]:
        return [int(v) for v in value]

    @staticmethod
    def toVector(value: Any) -> Any:
        import numpy as np

        return np.asarray(value, dtype=float)

    @staticmethod
    def identity(value: Any) -> Any:
        return value


class Params:
    """Base class holding params, user-supplied values, and defaults.

    Mirrors the ``pyspark.ml.param.Params`` contract the reference's user
    code depends on (``fit``-time param maps, ``copy(extra)``,
    ``extractParamMap``). Class-level ``Param`` declarations are cloned per
    instance in ``__init__`` so ``param.parent`` identifies the instance.
    """

    def __init__(self) -> None:
        self._paramMap: Dict[Param, Any] = {}
        self._defaultParamMap: Dict[Param, Any] = {}
        # clone class-level Param declarations so each instance owns its params
        for name in dir(type(self)):
            attr = getattr(type(self), name, None)
            if isinstance(attr, Param):
                setattr(self, name, attr._copy_new_parent(self))

    # -- introspection -----------------------------------------------------
    @property
    def params(self) -> List[Param]:
        return sorted(
            [v for v in self.__dict__.values() if isinstance(v, Param)],
            key=lambda p: p.name,
        )

    def hasParam(self, paramName: str) -> bool:
        return isinstance(self.__dict__.get(paramName), Param)

    def getParam(self, paramName: str) -> Param:
        attr = self.__dict__.get(paramName)
        if not isinstance(attr, Param):
            raise ValueError(f"Cannot find param with name {paramName!r}.")
        return attr

    def _resolveParam(self, param: Union[str, Param]) -> Param:
        if isinstance(param, Param):
            return self.getParam(param.name)
        return self.getParam(param)

    # -- get/set -----------------------------------------------------------
    def isSet(self, param: Union[str, Param]) -> bool:
        return self._resolveParam(param) in self._paramMap

    def hasDefault(self, param: Union[str, Param]) -> bool:
        return self._resolveParam(param) in self._defaultParamMap

    def isDefined(self, param: Union[str, Param]) -> bool:
        return self.isSet(param) or self.hasDefault(param)

    def get(self, param: Union[str, Param], default: Any = None) -> Any:
        p = self._resolveParam(param)
        if p in self._paramMap:
            return self._paramMap[p]
        return default

    def getOrDefault(self, param: Union[str, Param]) -> Any:
        p = self._resolveParam(param)
        if p in self._paramMap:
            return self._paramMap[p]
        if p in self._defaultParamMap:
            return self._defaultParamMap[p]
        raise KeyError(f"Param {p.name!r} is not set and has no default")

    def set(self, param: Union[str, Param], value: Any) -> "Params":
        p = self._resolveParam(param)
        self._paramMap[p] = p.typeConverter(value)
        return self

    def _set(self, **kwargs: Any) -> "Params":
        for name, value in kwargs.items():
            p = self.getParam(name)
            if value is not None:
                value = p.typeConverter(value)
            self._paramMap[p] = value
        return self

    def _setDefault(self, **kwargs: Any) -> "Params":
        for name, value in kwargs.items():
            p = self.getParam(name)
            self._defaultParamMap[p] = value
        return self

    def clear(self, param: Union[str, Param]) -> None:
        p = self._resolveParam(param)
        self._paramMap.pop(p, None)

    def extractParamMap(self, extra: Optional[Dict[Param, Any]] = None) -> Dict[Param, Any]:
        pm = dict(self._defaultParamMap)
        pm.update(self._paramMap)
        if extra:
            pm.update(extra)
        return pm

    def explainParam(self, param: Union[str, Param]) -> str:
        p = self._resolveParam(param)
        cur = "undefined"
        if self.isSet(p):
            cur = f"current: {self.getOrDefault(p)}"
        elif self.hasDefault(p):
            cur = f"default: {self._defaultParamMap[p]}"
        return f"{p.name}: {p.doc} ({cur})"

    def explainParams(self) -> str:
        return "\n".join(self.explainParam(p) for p in self.params)

    # -- copy --------------------------------------------------------------
    def copy(self: P, extra: Optional[Dict[Param, Any]] = None) -> P:
        that = _copy.copy(self)
        # re-clone params so parent points at the copy
        Params.__init__(that)
        for p, v in self._paramMap.items():
            that._paramMap[that.getParam(p.name)] = v
        for p, v in self._defaultParamMap.items():
            that._defaultParamMap[that.getParam(p.name)] = v
        if extra:
            for p, v in extra.items():
                that._paramMap[that.getParam(p.name)] = v
        # a shallow instance copy must not share mutable backend-param state
        if isinstance(self, _TpuParams) and hasattr(self, "_tpu_params"):
            self._copy_tpu_params(that)  # type: ignore[arg-type]
        return that

    def _copyValues(self, to: "Params", extra: Optional[Dict[Param, Any]] = None) -> "Params":
        for p, v in self._paramMap.items():
            if to.hasParam(p.name):
                to._paramMap[to.getParam(p.name)] = v
        if extra:
            for p, v in extra.items():
                if to.hasParam(p.name):
                    to._paramMap[to.getParam(p.name)] = v
        return to

    # generic spark-style uid
    @property
    def uid(self) -> str:
        if not hasattr(self, "_uid"):
            import uuid

            self._uid = f"{type(self).__name__}_{uuid.uuid4().hex[:12]}"
        return self._uid


# ---------------------------------------------------------------------------
# Shared mixins (subset of pyspark.ml.param.shared used by the reference)
# ---------------------------------------------------------------------------


def _mk(name: str, doc: str, conv: Callable[[Any], Any]) -> Param:
    return Param(None, name, doc, conv)


class HasFeaturesCol(Params):
    featuresCol = _mk("featuresCol", "features column name", TypeConverters.toString)

    def __init__(self) -> None:
        super().__init__()
        self._setDefault(featuresCol="features")

    def getFeaturesCol(self) -> str:
        return self.getOrDefault("featuresCol")


class HasFeaturesCols(Params):
    """Param for a list of scalar feature columns, mirroring the reference's
    ``HasFeaturesCols`` (spark-rapids-ml ``python/src/spark_rapids_ml/params.py:66-85``)."""

    featuresCols = _mk(
        "featuresCols",
        "list of scalar feature column names (alternative to featuresCol)",
        TypeConverters.toListString,
    )

    def getFeaturesCols(self) -> List[str]:
        return self.getOrDefault("featuresCols")

    def setFeaturesCols(self, value: List[str]) -> "HasFeaturesCols":
        self._set(featuresCols=value)
        return self


class HasLabelCol(Params):
    labelCol = _mk("labelCol", "label column name", TypeConverters.toString)

    def __init__(self) -> None:
        super().__init__()
        self._setDefault(labelCol="label")

    def getLabelCol(self) -> str:
        return self.getOrDefault("labelCol")


class HasPredictionCol(Params):
    predictionCol = _mk("predictionCol", "prediction column name", TypeConverters.toString)

    def __init__(self) -> None:
        super().__init__()
        self._setDefault(predictionCol="prediction")

    def getPredictionCol(self) -> str:
        return self.getOrDefault("predictionCol")


class HasProbabilityCol(Params):
    probabilityCol = _mk("probabilityCol", "class probability column name", TypeConverters.toString)

    def __init__(self) -> None:
        super().__init__()
        self._setDefault(probabilityCol="probability")

    def getProbabilityCol(self) -> str:
        return self.getOrDefault("probabilityCol")


class HasRawPredictionCol(Params):
    rawPredictionCol = _mk(
        "rawPredictionCol", "raw prediction (confidence) column name", TypeConverters.toString
    )

    def __init__(self) -> None:
        super().__init__()
        self._setDefault(rawPredictionCol="rawPrediction")

    def getRawPredictionCol(self) -> str:
        return self.getOrDefault("rawPredictionCol")


class HasOutputCol(Params):
    outputCol = _mk("outputCol", "output column name", TypeConverters.toString)

    def getOutputCol(self) -> str:
        return self.getOrDefault("outputCol")


class HasInputCol(Params):
    inputCol = _mk("inputCol", "input column name", TypeConverters.toString)

    def getInputCol(self) -> str:
        return self.getOrDefault("inputCol")


class HasMaxIter(Params):
    maxIter = _mk("maxIter", "max number of iterations (>= 0)", TypeConverters.toInt)

    def getMaxIter(self) -> int:
        return self.getOrDefault("maxIter")


class HasTol(Params):
    tol = _mk("tol", "convergence tolerance for iterative algorithms (>= 0)", TypeConverters.toFloat)

    def getTol(self) -> float:
        return self.getOrDefault("tol")


class HasRegParam(Params):
    regParam = _mk("regParam", "regularization parameter (>= 0)", TypeConverters.toFloat)

    def getRegParam(self) -> float:
        return self.getOrDefault("regParam")


class HasElasticNetParam(Params):
    elasticNetParam = _mk(
        "elasticNetParam",
        "ElasticNet mixing: 0 = L2, 1 = L1",
        TypeConverters.toFloat,
    )

    def getElasticNetParam(self) -> float:
        return self.getOrDefault("elasticNetParam")


class HasFitIntercept(Params):
    fitIntercept = _mk("fitIntercept", "whether to fit an intercept term", TypeConverters.toBoolean)

    def __init__(self) -> None:
        super().__init__()
        self._setDefault(fitIntercept=True)

    def getFitIntercept(self) -> bool:
        return self.getOrDefault("fitIntercept")


class HasStandardization(Params):
    standardization = _mk(
        "standardization", "whether to standardize features before fitting", TypeConverters.toBoolean
    )

    def __init__(self) -> None:
        super().__init__()
        self._setDefault(standardization=True)

    def getStandardization(self) -> bool:
        return self.getOrDefault("standardization")


class HasSeed(Params):
    seed = _mk("seed", "random seed", TypeConverters.toInt)

    def __init__(self) -> None:
        super().__init__()
        self._setDefault(seed=0)

    def getSeed(self) -> int:
        return self.getOrDefault("seed")


class HasWeightCol(Params):
    weightCol = _mk("weightCol", "weight column name", TypeConverters.toString)

    def getWeightCol(self) -> str:
        return self.getOrDefault("weightCol")


class HasEnableSparseDataOptim(Params):
    """Mirror of the reference's sparse-input opt-in
    (spark-rapids-ml ``python/src/spark_rapids_ml/params.py:42-63``)."""

    enable_sparse_data_optim = _mk(
        "enable_sparse_data_optim",
        "None: auto by input type; True: force CSR ingestion; False: force dense",
        TypeConverters.identity,
    )

    def __init__(self) -> None:
        super().__init__()
        self._setDefault(enable_sparse_data_optim=None)

    def getEnableSparseDataOptim(self) -> Optional[bool]:
        return self.getOrDefault("enable_sparse_data_optim")


# ---------------------------------------------------------------------------
# Framework mapping layer (reference _CumlClass/_CumlParams analog)
# ---------------------------------------------------------------------------


class _TpuClass:
    """Per-algorithm param translation tables.

    Same contract as the reference's ``_CumlClass``
    (spark-rapids-ml ``python/src/spark_rapids_ml/params.py:88-169``):
    subclasses declare how Spark-style params translate to backend kwargs.
    """

    @classmethod
    def _param_mapping(cls) -> Dict[str, Optional[str]]:
        """Spark param name -> backend param name.

        ``""``  -> accepted but ignored (warn once).
        ``None`` -> unsupported: raise ``ValueError`` when user sets it.
        """
        return {}

    @classmethod
    def _param_value_mapping(cls) -> Dict[str, Callable[[Any], Any]]:
        """Backend param name -> value translation fn; the fn may raise
        ``ValueError`` for unsupported values."""
        return {}

    @classmethod
    def _get_tpu_params_default(cls) -> Dict[str, Any]:
        """Default backend kwargs (reference ``_get_cuml_params_default``)."""
        return {}


class _TpuParams(_TpuClass):
    """Mixin syncing user-facing params into ``tpu_params``.

    Mirrors ``_CumlParams`` (spark-rapids-ml ``python/src/spark_rapids_ml/params.py:172-375``):
    ``num_workers`` (model-parallel worker count = #devices participating),
    ``float32_inputs`` coercion flag, ``_set_params`` routing, and input
    column resolution.
    """

    _tpu_params: Dict[str, Any]
    _num_workers: Optional[int] = None
    _float32_inputs: bool = True
    # streaming (out-of-core) fit: True = force, False = never, None = auto
    # (engaged for lazy parquet scans or datasets above the device threshold)
    _streaming: Optional[bool] = None
    _stream_chunk_rows: Optional[int] = None
    # torch device the fit/transform runs on; None = cuda:0 (see
    # utils.platform.resolve_device — the CPU only when asked for)
    _device: Optional[str] = None
    # verbosity is per-instance; the level is applied to the (shared
    # per-class) logger at fit/transform time so instances don't clobber
    # each other at construction
    _verbose: Optional[bool] = None

    def _apply_verbosity(self) -> None:
        """Apply this instance's ``verbose`` setting to the shared
        per-class logger for the duration of its operations."""
        import logging as _logging

        if self._verbose is not None:
            get_logger(
                type(self),
                _logging.DEBUG if self._verbose else _logging.INFO,
            )

    def _init_tpu_params(self) -> None:
        self._tpu_params = dict(self._get_tpu_params_default())

    @property
    def tpu_params(self) -> Dict[str, Any]:
        return self._tpu_params

    @property
    def num_workers(self) -> int:
        if self._num_workers is not None:
            return self._num_workers
        return self._infer_num_workers()

    @num_workers.setter
    def num_workers(self, value: int) -> None:
        if value < 1:
            raise ValueError("num_workers must be >= 1")
        self._num_workers = value

    def _infer_num_workers(self) -> int:
        """Default worker count: one card (multi-GPU data parallelism is
        not ported yet)."""
        return 1

    def _set_params(self: Any, **kwargs: Any) -> Any:
        """Route Spark-style kwargs into params + tpu_params.

        Implements the reference's semantics
        (spark-rapids-ml ``python/src/spark_rapids_ml/params.py:261-308``):
        mapped -> sync both sides; ""-mapped -> ignore with warning;
        None-mapped -> raise; unknown -> raise.
        """
        logger = get_logger(type(self))
        mapping = self._param_mapping()
        value_mapping = self._param_value_mapping()
        for name, value in kwargs.items():
            if name == "num_workers":
                if value is not None:  # None = use all local devices
                    self.num_workers = int(value)
                continue
            if name == "float32_inputs":
                self._float32_inputs = bool(value)
                continue
            if name == "streaming":
                self._streaming = None if value is None else bool(value)
                continue
            if name == "stream_chunk_rows":
                self._stream_chunk_rows = None if value is None else int(value)
                continue
            if name == "device":
                self._device = None if value is None else str(value)
                continue
            if name == "verbose":
                # framework kwarg like the reference's cuML verbosity
                # forwarding (``core.py:385-408``); applied at
                # fit/transform time (debug = phase timings etc.)
                self._verbose = None if value is None else bool(value)
                continue
            if self.hasParam(name):
                self._set(**{name: value})
                if name in mapping:
                    backend_name = mapping[name]
                    if backend_name is None:
                        raise ValueError(
                            f"Param {name!r} is not supported by the torch backend."
                        )
                    elif backend_name == "":
                        logger.warning(
                            "Param %r is accepted for API compatibility but ignored "
                            "by the torch backend.",
                            name,
                        )
                    else:
                        mapped_value = value
                        if backend_name in value_mapping:
                            mapped_value = value_mapping[backend_name](value)
                        self._tpu_params[backend_name] = mapped_value
            elif name in self._tpu_params:
                # direct backend param
                mapped_value = value
                if name in value_mapping:
                    mapped_value = value_mapping[name](value)
                self._tpu_params[name] = mapped_value
            else:
                raise ValueError(f"Unknown param {name!r} for {type(self).__name__}")
        return self

    def _copy_tpu_params(self, to: "_TpuParams") -> "_TpuParams":
        to._tpu_params = dict(self._tpu_params)
        to._num_workers = self._num_workers
        to._float32_inputs = self._float32_inputs
        to._streaming = self._streaming
        to._stream_chunk_rows = self._stream_chunk_rows
        to._device = self._device
        return to

    def setDevice(self: Any, value: Optional[str]) -> Any:
        """Torch device for fit/transform (``"cuda:0"``, ``"cpu"``, ...)."""
        self._set_params(device=value)
        return self

    # -- input column resolution ------------------------------------------
    def _get_input_columns(self) -> tuple:
        """Resolve (single_col_or_None, multi_cols_or_None), reference
        ``params.py:342-375``.

        Order is significant: explicitly *set* params win over defaults
        (``featuresCol`` has a default, so a bare ``isDefined`` check would
        shadow an explicitly set ``inputCol``)."""
        input_col: Optional[str] = None
        input_cols: Optional[List[str]] = None
        if self.hasParam("featuresCols") and self.isSet("featuresCols"):
            input_cols = self.getOrDefault("featuresCols")
        elif self.hasParam("inputCols") and self.isSet("inputCols"):
            input_cols = self.getOrDefault("inputCols")
        elif self.hasParam("featuresCol") and self.isSet("featuresCol"):
            input_col = self.getOrDefault("featuresCol")
        elif self.hasParam("inputCol") and self.isSet("inputCol"):
            input_col = self.getOrDefault("inputCol")
        elif self.hasParam("featuresCol") and self.isDefined("featuresCol"):
            input_col = self.getOrDefault("featuresCol")
        elif self.hasParam("inputCol") and self.isDefined("inputCol"):
            input_col = self.getOrDefault("inputCol")
        if input_col is None and input_cols is None:
            raise ValueError("Please set inputCol/featuresCol or featuresCols")
        return input_col, input_cols

    def setFeaturesCol(self: Any, value: Union[str, List[str]]) -> Any:
        if isinstance(value, str):
            self._set_params(featuresCol=value)
        else:
            self._set_params(featuresCols=value)
        return self

    def setPredictionCol(self: Any, value: str) -> Any:
        self._set_params(predictionCol=value)
        return self

    def setLabelCol(self: Any, value: str) -> Any:
        self._set_params(labelCol=value)
        return self

