"""RandomForest of the port (counterpart of the forest half of
``spark_rapids_ml_tpu/models/tree.py``).

``RandomForestClassifier`` / ``RandomForestRegressor`` fit through
``ops/tree_kernels.build_forest`` on one device: quantize (host quantile
edges, device compare-count), then level-wise histogram trees carried by
kernels K5 (or K6 at wide feature widths). The models transform through
the packed-forest engine (hop 2 in kernel K9) when they carry their bin
tables and their depth is at most 14, else through the raw-threshold
descent (deeper forests, and JAX-saved models without bin tables). Param
mapping, defaults, the model surface (``featureImportances``, ``trees``,
``totalNumNodes``, ``predict``/``predictProbability``/``predictRaw``) and
the saved attributes, ``packed_*`` included, are the JAX package's.

A port fit and a JAX fit with the same ``seed`` grow different forests:
the port draws its bootstrap weights and feature subsets from
``torch.Generator``s (``ops.tree_kernels.TorchDraws``). Without
randomness (``bootstrap=False``, ``featureSubsetStrategy="all"``) the two
packages grow the same trees.
"""

from __future__ import annotations

import math
import time
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch

from ..core import FitFunc, FitInputs, _TpuEstimatorSupervised, _TpuModel
from ..data.dataframe import DataFrame
from ..ops.tree_kernels import (
    ForestConfig,
    PackedForest,
    TorchDraws,
    binize,
    build_forest,
    make_bin_edges,
    next_pow2,
    pack_forest,
    rf_classify,
    rf_classify_packed,
    rf_regress,
    rf_regress_packed,
)
from ..parallel.mesh import global_label_summary
from ..params import (
    HasFeaturesCol,
    HasFeaturesCols,
    HasLabelCol,
    HasPredictionCol,
    HasProbabilityCol,
    HasRawPredictionCol,
    HasSeed,
    TypeConverters,
    _mk,
)
from ..utils.platform import resolve_device

_MAX_SUPPORTED_DEPTH = 18  # full binary layout: 2^(d+1)-1 nodes per tree
# deepest forest the packed layout holds (k2 <= 6 below k1 <= 8)
_MAX_PACKED_DEPTH = 14
# key of the fit-stage seconds in a fit's result (not a model attribute)
_FIT_REPORT = "_fit_report"


def _str_or_numerical(value: str) -> Union[str, float, int]:
    """Parse featureSubsetStrategy strings that encode numbers."""
    try:
        return int(value)
    except ValueError:
        pass
    try:
        return float(value)
    except ValueError:
        pass
    return value


class _RandomForestClass:
    @classmethod
    def _param_mapping(cls) -> Dict[str, Optional[str]]:
        return {
            "maxBins": "n_bins",
            "maxDepth": "max_depth",
            "numTrees": "n_estimators",
            "impurity": "split_criterion",
            "featureSubsetStrategy": "max_features",
            "bootstrap": "bootstrap",
            "seed": "random_state",
            "minInstancesPerNode": "min_samples_leaf",
            "minInfoGain": "min_impurity_decrease",
            "maxMemoryInMB": "",
            "cacheNodeIds": "",
            "checkpointInterval": "",
            "subsamplingRate": "",
            "minWeightFractionPerNode": "",
            "weightCol": None,
            "leafCol": None,
        }

    @classmethod
    def _param_value_mapping(cls) -> Dict[str, Callable[[Any], Any]]:
        def _tree_mapping(v: Any) -> Union[None, str, float, int]:
            if isinstance(v, (int, float)):
                return v
            maybe = _str_or_numerical(str(v))
            if isinstance(maybe, (int, float)):
                return maybe
            mapping: Dict[str, Union[str, float]] = {
                "onethird": 1.0 / 3.0,
                "all": 1.0,
                "auto": "auto",
                "sqrt": "sqrt",
                "log2": "log2",
            }
            if maybe not in mapping:
                raise ValueError(f"Unsupported featureSubsetStrategy: {v!r}")
            return mapping[maybe]

        return {"max_features": _tree_mapping}

    @classmethod
    def _get_tpu_params_default(cls) -> Dict[str, Any]:
        return {
            "n_estimators": 100,
            "max_depth": 16,
            "n_bins": 128,
            "max_features": "auto",
            "bootstrap": True,
            "min_samples_leaf": 1,
            "min_samples_split": 2,
            "min_impurity_decrease": 0.0,
            "random_state": None,
        }


class _RandomForestParams(
    HasFeaturesCol, HasFeaturesCols, HasLabelCol, HasPredictionCol, HasSeed
):
    numTrees = _mk("numTrees", "number of trees", TypeConverters.toInt)
    maxDepth = _mk("maxDepth", "maximum tree depth", TypeConverters.toInt)
    maxBins = _mk("maxBins", "max histogram bins per feature", TypeConverters.toInt)
    impurity = _mk("impurity", "split criterion", TypeConverters.toString)
    featureSubsetStrategy = _mk(
        "featureSubsetStrategy",
        "features considered per split: auto|all|sqrt|log2|onethird|fraction|n",
        TypeConverters.toString,
    )
    bootstrap = _mk("bootstrap", "bootstrap-sample rows per tree", TypeConverters.toBoolean)
    minInstancesPerNode = _mk(
        "minInstancesPerNode", "min rows per child node", TypeConverters.toInt
    )
    minInfoGain = _mk("minInfoGain", "min gain for a split", TypeConverters.toFloat)
    subsamplingRate = _mk("subsamplingRate", "row subsample rate (ignored)", TypeConverters.toFloat)
    maxMemoryInMB = _mk("maxMemoryInMB", "memory hint (ignored)", TypeConverters.toInt)
    cacheNodeIds = _mk("cacheNodeIds", "node-id caching (ignored)", TypeConverters.toBoolean)
    checkpointInterval = _mk("checkpointInterval", "checkpointing (ignored)", TypeConverters.toInt)
    minWeightFractionPerNode = _mk(
        "minWeightFractionPerNode", "min weight fraction (ignored)", TypeConverters.toFloat
    )
    # unsupported (raise on set): the exactness of integer stats that the
    # classification histograms rely on holds for bootstrap counts, not
    # for real-valued row weights
    weightCol = _mk("weightCol", "weight column (unsupported)", TypeConverters.toString)
    leafCol = _mk("leafCol", "leaf index column (unsupported)", TypeConverters.toString)

    def __init__(self) -> None:
        super().__init__()
        self._setDefault(
            numTrees=20,
            maxDepth=5,
            maxBins=32,
            featureSubsetStrategy="auto",
            bootstrap=True,
            minInstancesPerNode=1,
            minInfoGain=0.0,
            subsamplingRate=1.0,
            seed=0,
        )

    def getNumTrees(self) -> int:
        return self.getOrDefault("numTrees")

    def getMaxDepth(self) -> int:
        return self.getOrDefault("maxDepth")

    def getMaxBins(self) -> int:
        return self.getOrDefault("maxBins")

    def getImpurity(self) -> str:
        return self.getOrDefault("impurity")

    def getFeatureSubsetStrategy(self) -> str:
        return self.getOrDefault("featureSubsetStrategy")


def _resolve_k_features(
    max_features: Union[str, float, int], d: int, is_classification: bool
) -> int:
    """Per-node feature-sample count ('auto' follows Spark: sqrt for
    classification, 1/3 for regression)."""
    if max_features == "auto":
        k = math.ceil(math.sqrt(d)) if is_classification else math.ceil(d / 3.0)
    elif max_features == "sqrt":
        k = math.ceil(math.sqrt(d))
    elif max_features == "log2":
        k = math.ceil(math.log2(max(d, 2)))
    elif isinstance(max_features, int):
        k = max_features
    elif isinstance(max_features, float):
        k = math.ceil(max_features * d)
    else:
        raise ValueError(f"Unsupported max_features: {max_features!r}")
    return max(1, min(int(k), d))


def _seconds_since(t0: float, device: torch.device) -> float:
    """Host seconds since ``t0``, after the device's queued work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0


def _quantize_features(inputs: FitInputs, n_bins: int, d_pad: int, seed: int, algo: str,
                       report: Dict[str, float]):
    """Host quantile sketch -> device binize. Strided sample of the VALID
    rows (unbiased under any row order, padding never enters it). Features
    must be finite: binize routes NaN to bin 0, so a non-finite sample
    value rejects the fit. Adds the two stages' seconds to ``report``."""
    t0 = time.perf_counter()
    step = max(1, inputs.n_rows // 131072)
    valid_pos = torch.nonzero(inputs.mask > 0)[:, 0]
    sample = inputs.X[valid_pos[::step]].cpu().numpy()
    if not np.isfinite(sample).all():
        raise ValueError(
            f"{algo} features contain NaN/Inf; clean or impute before fit "
            "(binize would route non-finite values to bin 0)"
        )
    edges_np = make_bin_edges(sample, n_bins, seed=seed)
    t1 = time.perf_counter()
    bins = binize(inputs.X, torch.from_numpy(edges_np).to(inputs.device), d_pad=d_pad)
    report["sketch_seconds"] = t1 - t0
    report["binize_seconds"] = _seconds_since(t1, inputs.device)
    return edges_np, bins


class _RandomForestEstimator(_RandomForestClass, _TpuEstimatorSupervised, _RandomForestParams):
    """Shared fit machinery."""

    _is_classification = False
    _default_impurity = "variance"

    def __init__(self, **kwargs: Any) -> None:
        _TpuEstimatorSupervised.__init__(self)
        _RandomForestParams.__init__(self)
        self._setDefault(impurity=self._default_impurity)
        self._set_params(**kwargs)

    def setNumTrees(self, value: int) -> "_RandomForestEstimator":
        self._set_params(numTrees=value)
        return self

    def setMaxDepth(self, value: int) -> "_RandomForestEstimator":
        self._set_params(maxDepth=value)
        return self

    def setMaxBins(self, value: int) -> "_RandomForestEstimator":
        self._set_params(maxBins=value)
        return self

    def setImpurity(self, value: str) -> "_RandomForestEstimator":
        self._set_params(impurity=value)
        return self

    def setFeatureSubsetStrategy(self, value: str) -> "_RandomForestEstimator":
        self._set_params(featureSubsetStrategy=value)
        return self

    def setSeed(self, value: int) -> "_RandomForestEstimator":
        self._set_params(seed=value)
        return self

    # -- label handling ----------------------------------------------------
    def _process_labels(self, y_host: np.ndarray) -> int:
        """n_stats (classifier: validates integer labels, returns n_classes;
        regressor: 3 moment slots)."""
        raise NotImplementedError

    def _label_stats(self, y: torch.Tensor, n_stats: int) -> torch.Tensor:
        """Per-row sufficient-stat vectors (n, S) from labels."""
        raise NotImplementedError

    def _impurity_name(self, params: Dict[str, Any]) -> str:
        raise NotImplementedError

    # -- fit ---------------------------------------------------------------
    def _get_fit_func(self, dataset: DataFrame) -> FitFunc:
        label_col = self.getOrDefault("labelCol")
        n_stats = self._process_labels(np.asarray(dataset.column(label_col)))
        is_classification = self._is_classification

        def _fit(inputs: FitInputs, params: Dict[str, Any]) -> Dict[str, Any]:
            max_depth = int(params["max_depth"])
            if max_depth > _MAX_SUPPORTED_DEPTH:
                raise ValueError(
                    f"maxDepth={max_depth} exceeds supported depth "
                    f"{_MAX_SUPPORTED_DEPTH} (full binary node layout)"
                )
            n_trees = int(params["n_estimators"])
            if n_trees < 1:
                raise ValueError("numTrees must be >= 1")
            n_bins = int(min(params["n_bins"], max(2, inputs.n_rows)))
            if n_bins > 256:
                # uint8 bin storage; quantile histograms gain nothing past 256
                self.logger.warning("maxBins=%d clamped to 256", n_bins)
                n_bins = 256
            d = inputs.n_features
            d_pad = next_pow2(d)
            seed = int(params.get("random_state") or 0)

            report: Dict[str, float] = {}
            edges_np, bins = _quantize_features(inputs, n_bins, d_pad, seed, "RandomForest", report)
            stats = self._label_stats(inputs.y, n_stats)
            cfg = ForestConfig(
                max_depth=max_depth,
                n_bins=n_bins,
                n_features=d,
                n_stats=n_stats,
                impurity=self._impurity_name(params),
                k_features=_resolve_k_features(params["max_features"], d, is_classification),
                min_samples_leaf=int(params["min_samples_leaf"]),
                min_info_gain=float(params.get("min_impurity_decrease", 0.0) or 0.0),
                min_samples_split=int(params.get("min_samples_split", 2)),
                bootstrap=bool(params["bootstrap"]),
            )
            t0 = time.perf_counter()
            draws = TorchDraws(seed)
            out = build_forest(bins, inputs.mask, stats, cfg=cfg, n_trees=n_trees, draws=draws)
            report["grow_seconds"] = time.perf_counter() - t0
            report["draws_seconds"] = draws.seconds
            feat, thr_bin = out["feature"], out["threshold_bin"]
            # bin thresholds -> raw feature-space values (x >= thr -> right)
            thr = np.where(
                feat >= 0,
                edges_np[np.clip(feat, 0, d - 1), np.clip(thr_bin, 0, n_bins - 2)],
                0.0,
            ).astype(np.float32)
            return {
                "features": feat.astype(np.int32),
                "thresholds": thr,
                "leaf_stats": out["leaf_stats"].astype(np.float32),
                "gains": out["gain"].astype(np.float32),
                "n_classes": n_stats if is_classification else 0,
                "num_features": d,
                # bin-space tables: x >= edges[f, b] <=> bin(x) > b, the
                # training-side routing rule, so the packed engine's
                # transform matches the raw thresholds
                "threshold_bins": thr_bin.astype(np.int32),
                "bin_edges": edges_np.astype(np.float32),
                _FIT_REPORT: report,
            }

        return _fit


def _model_with_report(cls: type, result: Dict[str, Any]) -> "_RandomForestModel":
    """The fitted model, with the fit's stage seconds as ``_fit_report``
    (provenance, not persisted: where the fit's wall clock went;
    ``grow_seconds`` includes ``draws_seconds``, the host RNG)."""
    report = result.pop(_FIT_REPORT)
    model = cls(**result)
    model._fit_report = report
    return model


class _ForestModelBase(_TpuModel):
    """Shared fitted-forest surface: node tables, structure, and the
    transform engine ("packed" when the model carries its bin tables and
    its depth is at most 14, else "legacy", the raw-threshold descent)."""

    # -- forest structure --------------------------------------------------
    @property
    def _features_arr(self) -> np.ndarray:
        return np.asarray(self._model_attributes["features"])

    @property
    def _thresholds_arr(self) -> np.ndarray:
        return np.asarray(self._model_attributes["thresholds"])

    @property
    def _leaf_stats_arr(self) -> np.ndarray:
        return np.asarray(self._model_attributes["leaf_stats"])

    @property
    def _gains_arr(self) -> np.ndarray:
        return np.asarray(self._model_attributes["gains"])

    @property
    def _max_depth_built(self) -> int:
        m = self._features_arr.shape[1]
        return int(math.log2(m + 1)) - 1

    def _resolve_transform_engine(self) -> str:
        ma = self._model_attributes
        has_bins = ma.get("threshold_bins") is not None and ma.get("bin_edges") is not None
        return "packed" if has_bins and self._max_depth_built <= _MAX_PACKED_DEPTH else "legacy"

    def _ensure_packed(self) -> PackedForest:
        """The packed layout, computed once per model and kept in the
        model's attributes (so it is saved, and a reload never packs
        again)."""
        pf = getattr(self, "_packed_cache", None)
        if pf is not None:
            return pf
        ma = self._model_attributes
        if ma.get("packed_feat1") is not None and ma.get("packed_meta") is not None:
            meta = np.asarray(ma["packed_meta"]).astype(np.int64)
            pf = PackedForest(
                feat1=np.asarray(ma["packed_feat1"], dtype=np.int32),
                thr1=np.asarray(ma["packed_thr1"], dtype=np.int32),
                feat2=np.asarray(ma["packed_feat2"], dtype=np.int32),
                thr2=np.asarray(ma["packed_thr2"], dtype=np.int32),
                n_trees=int(meta[0]), k1=int(meta[1]), k2=int(meta[2]),
                max_depth=int(meta[3]),
            )
        else:
            pf = pack_forest(
                self._features_arr, np.asarray(ma["threshold_bins"]), max_depth=self._max_depth_built
            )
            ma["packed_feat1"] = pf.feat1
            ma["packed_thr1"] = pf.thr1
            ma["packed_feat2"] = pf.feat2
            ma["packed_thr2"] = pf.thr2
            ma["packed_meta"] = np.asarray(
                [pf.n_trees, pf.k1, pf.k2, pf.max_depth], dtype=np.int32
            )
        self._packed_cache = pf
        return pf

    def _packed_operands(self, device: torch.device):
        """Device copies of the packed tables and a per-batch quantizer
        (the edges moved once)."""
        pf = self._ensure_packed()
        tables = [torch.from_numpy(a).to(device) for a in (pf.feat1, pf.thr1, pf.feat2, pf.thr2)]
        edges = torch.from_numpy(np.asarray(self._model_attributes["bin_edges"], dtype=np.float32)).to(device)
        d_pad = -(-edges.shape[0] // 4) * 4  # word-packing alignment

        def binz(Xb: np.ndarray) -> torch.Tensor:
            return binize(torch.from_numpy(Xb).to(device), edges, d_pad=d_pad)

        return pf, tables, binz

    def _get_transform_func(
        self, dataset: Optional[DataFrame] = None
    ) -> Callable[[np.ndarray], Dict[str, np.ndarray]]:
        device = resolve_device(self._device)
        engine = self._resolve_transform_engine()
        return self._memoized_transform_fn(
            ("forest", engine, tuple(self._out_cols()), str(device)),
            lambda: getattr(self, f"_{engine}_transform_fn")(device),
        )

    def _out_cols(self) -> List[str]:
        return [self.getOrDefault("predictionCol")]

    def _packed_transform_fn(self, device: torch.device):
        raise NotImplementedError

    def _legacy_transform_fn(self, device: torch.device):
        raise NotImplementedError

    @property
    def numFeatures(self) -> int:
        return int(self._model_attributes["num_features"])

    def getNumTrees(self) -> int:
        # the fitted tree count, NOT a ``numTrees`` property: that name is
        # the Param
        return int(self._features_arr.shape[0])

    @property
    def treeWeights(self) -> List[float]:
        return [1.0] * self.getNumTrees()

    @property
    def totalNumNodes(self) -> int:
        # every split adds two children to the initial root
        return int(self.getNumTrees() + 2 * (self._features_arr >= 0).sum())

    def _leaf_counts(self) -> np.ndarray:
        """(T, M) row counts behind every node."""
        ls = self._leaf_stats_arr
        if int(self._model_attributes["n_classes"]) > 0:
            return ls.sum(axis=2)
        return ls[:, :, 0]

    @property
    def featureImportances(self) -> np.ndarray:
        """Gain-weighted importances, Spark semantics: per-tree importance of
        feature f = sum over f's split nodes of gain * node row count;
        normalized per tree, averaged, normalized to sum 1."""
        feat, gains = self._features_arr, self._gains_arr
        counts = self._leaf_counts()
        d = self.numFeatures
        total = np.zeros(d)
        for t in range(feat.shape[0]):
            split = feat[t] >= 0
            contrib = np.zeros(d)
            np.add.at(contrib, feat[t][split], (gains[t] * counts[t])[split])
            s = contrib.sum()
            if s > 0:
                total += contrib / s
        s = total.sum()
        return total / s if s > 0 else total

    @property
    def trees(self) -> List[Dict[str, Any]]:
        """Per-tree nested-dict export."""
        out = []
        feat, thr = self._features_arr, self._thresholds_arr
        leaf = self._leaf_stats_arr
        for t in range(feat.shape[0]):
            def build(i: int) -> Dict[str, Any]:
                if feat[t, i] < 0:
                    return {"leaf_value": leaf[t, i].tolist()}
                return {
                    "split_feature": int(feat[t, i]),
                    "threshold": float(thr[t, i]),
                    "left_child": build(2 * i + 1),
                    "right_child": build(2 * i + 2),
                }

            out.append(build(0))
        return out

    def toDebugString(self) -> str:
        return (
            f"{type(self).__name__} with {self.getNumTrees()} trees, "
            f"{self.totalNumNodes} nodes, depth<={self._max_depth_built}"
        )


class _RandomForestModel(_RandomForestClass, _ForestModelBase, _RandomForestParams):
    """Shared model surface."""

    def __init__(self, **attrs: Any) -> None:
        _ForestModelBase.__init__(self, **attrs)
        _RandomForestParams.__init__(self)

    def predict(self, vector: Any) -> float:
        x = np.asarray(vector, dtype=np.float32).reshape(1, -1)
        return float(self._get_transform_func()(x)[self.getOrDefault("predictionCol")][0])


# ---------------------------------------------------------------------------
# classifier
# ---------------------------------------------------------------------------


class RandomForestClassifier(_RandomForestEstimator, HasProbabilityCol, HasRawPredictionCol):
    """``RandomForestClassifier(numTrees=50, maxDepth=13).fit(df)`` — drop-in
    for ``pyspark.ml.classification.RandomForestClassifier``."""

    _is_classification = True
    _default_impurity = "gini"

    # accepted so Spark code constructs unchanged; setting it raises
    thresholds = _mk(
        "thresholds", "per-class vote thresholds (unsupported)", TypeConverters.toListFloat,
    )

    @classmethod
    def _param_mapping(cls) -> Dict[str, Optional[str]]:
        m = dict(super()._param_mapping())
        m["thresholds"] = None
        return m

    @classmethod
    def _param_value_mapping(cls) -> Dict[str, Callable[[Any], Any]]:
        m = dict(super()._param_value_mapping())

        def _crit(v: str) -> str:
            if v not in ("gini", "entropy"):
                raise ValueError(f"Unsupported impurity for classification: {v!r}")
            return v

        m["split_criterion"] = _crit
        return m

    def _process_labels(self, y_host: np.ndarray) -> int:
        ls = global_label_summary(y_host)
        if ls["total"] == 0:
            raise ValueError("Labels column is empty")
        if ls["y_min"] < 0 or not ls["all_int"]:
            raise RuntimeError("Labels MUST be non-negative integers")
        return max(int(ls["y_max"]) + 1, 2)

    def _label_stats(self, y: torch.Tensor, n_stats: int) -> torch.Tensor:
        return torch.nn.functional.one_hot(y.long(), n_stats).to(torch.float32)

    def _impurity_name(self, params: Dict[str, Any]) -> str:
        return str(params.get("split_criterion", "gini"))

    def _create_model(self, result: Dict[str, Any]) -> "RandomForestClassificationModel":
        return _model_with_report(RandomForestClassificationModel, result)


class RandomForestClassificationModel(
    _RandomForestModel, HasProbabilityCol, HasRawPredictionCol
):
    @property
    def numClasses(self) -> int:
        return int(self._model_attributes["n_classes"])

    @property
    def classes_(self) -> np.ndarray:
        return np.arange(self.numClasses, dtype=np.float64)

    def _leaf_probs(self) -> np.ndarray:
        ls = self._leaf_stats_arr
        tot = np.maximum(ls.sum(axis=2, keepdims=True), 1e-12)
        return (ls / tot).astype(np.float32)

    def _out_cols(self) -> List[str]:
        return [
            self.getOrDefault("predictionCol"),
            self.getOrDefault("probabilityCol"),
            self.getOrDefault("rawPredictionCol"),
        ]

    def _packed_transform_fn(self, device: torch.device) -> Callable[[np.ndarray], Dict[str, np.ndarray]]:
        pred_col, prob_col, raw_col = self._out_cols()
        pf, (feat1, thr1, feat2, thr2), binz = self._packed_operands(device)
        leafp = torch.from_numpy(self._leaf_probs()).to(device)

        def _fn(Xb: np.ndarray) -> Dict[str, np.ndarray]:
            pred, prob, raw = rf_classify_packed(
                binz(Xb), feat1, thr1, feat2, thr2, leafp, k1=pf.k1, k2=pf.k2
            )
            return {pred_col: pred.cpu().numpy(), prob_col: prob.cpu().numpy(), raw_col: raw.cpu().numpy()}

        return _fn

    def _legacy_transform_fn(self, device: torch.device) -> Callable[[np.ndarray], Dict[str, np.ndarray]]:
        pred_col, prob_col, raw_col = self._out_cols()
        feat = torch.from_numpy(self._features_arr.astype(np.int64)).to(device)
        thr = torch.from_numpy(self._thresholds_arr.astype(np.float32)).to(device)
        leafp = torch.from_numpy(self._leaf_probs()).to(device)
        depth = self._max_depth_built

        def _fn(Xb: np.ndarray) -> Dict[str, np.ndarray]:
            pred, prob, raw = rf_classify(torch.from_numpy(Xb).to(device), feat, thr, leafp, max_depth=depth)
            return {pred_col: pred.cpu().numpy(), prob_col: prob.cpu().numpy(), raw_col: raw.cpu().numpy()}

        return _fn

    def predictProbability(self, vector: Any) -> np.ndarray:
        x = np.asarray(vector, dtype=np.float32).reshape(1, -1)
        return self._get_transform_func()(x)[self.getOrDefault("probabilityCol")][0]

    def predictRaw(self, vector: Any) -> np.ndarray:
        x = np.asarray(vector, dtype=np.float32).reshape(1, -1)
        return self._get_transform_func()(x)[self.getOrDefault("rawPredictionCol")][0]


# ---------------------------------------------------------------------------
# regressor
# ---------------------------------------------------------------------------


class RandomForestRegressor(_RandomForestEstimator):
    """``RandomForestRegressor(numTrees=30, maxDepth=6).fit(df)`` — drop-in
    for ``pyspark.ml.regression.RandomForestRegressor``."""

    _is_classification = False
    _default_impurity = "variance"

    @classmethod
    def _param_value_mapping(cls) -> Dict[str, Callable[[Any], Any]]:
        m = dict(super()._param_value_mapping())

        def _crit(v: str) -> str:
            if v != "variance":
                raise ValueError(f"Unsupported impurity for regression: {v!r}")
            return v

        m["split_criterion"] = _crit
        return m

    def _process_labels(self, y_host: np.ndarray) -> int:
        if global_label_summary(y_host)["total"] == 0:
            raise ValueError("Labels column is empty")
        return 3  # (weight, w*y, w*y^2)

    def _label_stats(self, y: torch.Tensor, n_stats: int) -> torch.Tensor:
        yf = y.to(torch.float32)
        return torch.stack([torch.ones_like(yf), yf, yf * yf], dim=1)

    def _impurity_name(self, params: Dict[str, Any]) -> str:
        return "variance"

    def _create_model(self, result: Dict[str, Any]) -> "RandomForestRegressionModel":
        return _model_with_report(RandomForestRegressionModel, result)


class RandomForestRegressionModel(_RandomForestModel):
    def _leaf_means(self) -> np.ndarray:
        ls = self._leaf_stats_arr
        return (ls[:, :, 1] / np.maximum(ls[:, :, 0], 1e-12)).astype(np.float32)

    def _packed_transform_fn(self, device: torch.device) -> Callable[[np.ndarray], Dict[str, np.ndarray]]:
        (pred_col,) = self._out_cols()
        pf, (feat1, thr1, feat2, thr2), binz = self._packed_operands(device)
        leafv = torch.from_numpy(self._leaf_means()).to(device)

        def _fn(Xb: np.ndarray) -> Dict[str, np.ndarray]:
            pred = rf_regress_packed(binz(Xb), feat1, thr1, feat2, thr2, leafv, k1=pf.k1, k2=pf.k2)
            return {pred_col: pred.cpu().numpy().astype(Xb.dtype)}

        return _fn

    def _legacy_transform_fn(self, device: torch.device) -> Callable[[np.ndarray], Dict[str, np.ndarray]]:
        (pred_col,) = self._out_cols()
        feat = torch.from_numpy(self._features_arr.astype(np.int64)).to(device)
        thr = torch.from_numpy(self._thresholds_arr.astype(np.float32)).to(device)
        leafv = torch.from_numpy(self._leaf_means()).to(device)
        depth = self._max_depth_built

        def _fn(Xb: np.ndarray) -> Dict[str, np.ndarray]:
            pred = rf_regress(torch.from_numpy(Xb).to(device), feat, thr, leafv, max_depth=depth)
            return {pred_col: pred.cpu().numpy()}

        return _fn
