"""RandomForest and gradient-boosted trees of the port (counterpart of
``spark_rapids_ml_tpu/models/tree.py``).

``RandomForestClassifier`` / ``RandomForestRegressor`` fit through
``ops/tree_kernels.build_forest`` on one device: quantize (host quantile
edges, device compare-count), then level-wise histogram trees carried by
kernels K5 (or K6 at wide feature widths). ``GBTClassifier`` /
``GBTRegressor`` quantize the same way and grow each boosting round's
trees through the same builder (``ops/gbt_kernels.gbt_round``).

Every model transforms through one engine chain, packed > bins > legacy
(``_resolve_transform_engine``): the packed-forest engine (one launch of
kernel K9 a batch: both hops and the leaf-payload sum) when the model
carries its bin tables and its depth is at most 14; the
two-hop bins engine (hop 2's feature bins gathered by kernel K8) on
request (``engine="bins"``), with the packed engine's results bit for
bit; else the raw-threshold descent (deeper forests, and JAX-saved models
without bin tables). Param mapping, defaults, the model surface
(``featureImportances``, ``trees``, ``totalNumNodes``,
``predict``/``predictProbability``/``predictRaw``) and the saved
attributes, ``packed_*`` included, are the JAX package's.

A GBT fit checkpoints its boosting loop where ``runtime.checkpoint.
CKPT_DIR`` is set (the margins and the committed trees every ``CKPT_EVERY``
rounds) and a refit of the same identity resumes there; each round is a
``gbt:round`` fault site (``runtime.faults``) and yields to the fit
scheduler after it (``runtime.scheduler.preempt_point``). The draws are a
function of the absolute tree index, so a resumed fit grows the trees of
the uninterrupted one. :data:`GBT_ROUND_LOG_EVERY` logs the training loss
every that many rounds; :data:`RF_CHECK_FINITE` screens every transform
batch for NaN/Inf.

A port fit and a JAX fit with the same ``seed`` grow different forests
when they draw: the port draws its bootstrap weights and feature subsets
from ``torch.Generator``s (``ops.tree_kernels.TorchDraws``). Without
randomness (``bootstrap=False``, ``featureSubsetStrategy="all"``; GBT's
default) the two packages grow the same trees.
"""

from __future__ import annotations

import math
import time
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch

from ..core import FitFunc, FitInputs, _TpuEstimatorSupervised, _TpuModel, _features, _resolve_feature_matrix
from ..data.dataframe import DataFrame
from ..ops.gbt_kernels import GBTConfig, gbt_loss, gbt_round
from ..ops.tree_kernels import (
    ForestConfig,
    PackedForest,
    TorchDraws,
    binize,
    build_forest,
    forest_apply,
    make_bin_edges,
    next_pow2,
    pack_forest,
    packed_node_tables,
    rf_classify,
    rf_classify_bins,
    rf_classify_packed,
    rf_eval_bins,
    rf_eval_packed,
    rf_regress,
    rf_regress_bins,
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
from ..runtime import counters
from ..runtime.checkpoint import FitCheckpointer, array_digest
from ..runtime.faults import fault_site
from ..runtime.scheduler import preempt_point
from ..utils.platform import resolve_device

# the JAX package's TPUML_RF_CHECK_FINITE: screen every forest/GBT
# transform batch for NaN/Inf (a host pass a batch; binize sends NaN to
# bin 0 otherwise)
RF_CHECK_FINITE = False
# the JAX package's TPUML_GBT_ROUND_LOG_EVERY: log the GBT training loss
# every that many rounds (0: never; each is a reduction and a host read)
GBT_ROUND_LOG_EVERY = 0

_MAX_SUPPORTED_DEPTH = 18  # full binary layout: 2^(d+1)-1 nodes per tree
# deepest forest the packed layout holds (k2 <= 6 below k1 <= 8)
_MAX_PACKED_DEPTH = 14
# transform-engine modes of ``_resolve_transform_engine``
_ENGINE_MODES = ("auto", "packed", "bins", "legacy")
# key of the fit-stage seconds in a fit's result (not a model attribute)
_FIT_REPORT = "_fit_report"
# the tree tables of a GBT round (and of its checkpoint)
_GBT_TABLES = ("feature", "threshold_bin", "leaf_stats", "gain", "values")


class _Float32Only:
    """Forests and GBT bin and compare in float32 (K5, K6 and K9 take uint8
    bins): a float64 fit or transform (``float32_inputs=False`` on float64
    data) raises until ROADMAP queue 1 item 3a-ii ports it."""

    def _compute_dtype(self, dtype: type) -> type:
        if np.dtype(dtype) == np.float64:
            raise NotImplementedError(
                "RandomForest and GBT take float32 inputs only: float64 inputs "
                "(float32_inputs=False) are ROADMAP queue 1 item 3a-ii"
            )
        return dtype


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


class _RandomForestEstimator(_RandomForestClass, _Float32Only, _TpuEstimatorSupervised, _RandomForestParams):
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

    def _enable_fit_multiple_in_single_pass(self) -> bool:
        """One ``_pre_process_data`` for every param map of a
        ``fitMultiple``; each map's fit still runs its own quantile sketch,
        as in the JAX package."""
        return True

    def _supportsTransformEvaluate(self, evaluator: Any) -> bool:
        from ..evaluation import MulticlassClassificationEvaluator, RegressionEvaluator

        if self._is_classification:
            return isinstance(evaluator, MulticlassClassificationEvaluator)
        return isinstance(evaluator, RegressionEvaluator)

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


class _ForestModelBase(_Float32Only, _TpuModel):
    """Shared fitted-forest surface of RandomForest and GBT models: node
    tables, structure, and the transform engine chain (packed > bins >
    legacy). Subclasses supply each engine's closure around their per-node
    payload (leaf vote distributions or means, margin contributions)."""

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

    def _resolve_transform_engine(self, mode: Optional[str] = None) -> str:
        """packed > bins > legacy under ``mode`` (None or "auto", "packed",
        "bins", "legacy"; the JAX package's ``TPUML_RF_APPLY`` values, given
        as an argument). The packed and bins engines need the model's bin
        tables and a depth of at most 14; "legacy" forces the raw-threshold
        descent, "bins" the two-hop bins engine. K9 takes every forest the
        bins engine takes, so "auto" and "packed" pick the packed engine."""
        mode = mode or "auto"
        if mode not in _ENGINE_MODES:
            raise ValueError(f"unknown transform engine {mode!r}: one of {_ENGINE_MODES}")
        ma = self._model_attributes
        has_bins = ma.get("threshold_bins") is not None and ma.get("bin_edges") is not None
        if mode == "legacy" or not has_bins or self._max_depth_built > _MAX_PACKED_DEPTH:
            return "legacy"
        return "bins" if mode == "bins" else "packed"

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

    def _binizer(self, device: torch.device) -> Callable[[np.ndarray], torch.Tensor]:
        """Per-batch quantizer (the edges moved once), rows padded with bin
        0 to a multiple of 4 features (word packing). With
        :data:`RF_CHECK_FINITE` on, a batch holding NaN or Inf raises (the
        finite-input contract; binize sends NaN to bin 0)."""
        edges = torch.from_numpy(np.asarray(self._model_attributes["bin_edges"], dtype=np.float32)).to(device)
        d_pad = -(-edges.shape[0] // 4) * 4

        def binz(Xb: np.ndarray) -> torch.Tensor:
            # read a batch at a time, so the setting holds for a model
            # whose transform closure is already cached
            if RF_CHECK_FINITE and not np.isfinite(np.asarray(Xb)).all():
                raise ValueError(
                    "RandomForest transform batch contains NaN/Inf "
                    "(finite-input contract, models.tree.RF_CHECK_FINITE=True)"
                )
            return binize(torch.from_numpy(Xb).to(device), edges, d_pad=d_pad)

        return binz

    def _packed_operands(self, device: torch.device):
        """The packed tables as K9's node words on the device and a
        per-batch quantizer."""
        pf = self._ensure_packed()
        return pf, packed_node_tables(pf, device), self._binizer(device)

    def _bins_operands(self, device: torch.device):
        """Device copies of the heap tables (features, bin thresholds) and a
        per-batch quantizer."""
        feat = torch.from_numpy(self._features_arr.astype(np.int32)).to(device)
        thrb = torch.from_numpy(np.asarray(self._model_attributes["threshold_bins"], dtype=np.int32)).to(device)
        return feat, thrb, self._binizer(device)

    def _get_transform_func(
        self, dataset: Optional[DataFrame] = None, engine: Optional[str] = None
    ) -> Callable[[np.ndarray], Dict[str, np.ndarray]]:
        """The transform closure of ``engine`` (resolved as a
        ``_resolve_transform_engine`` mode; None: the default chain)."""
        device = resolve_device(self._device)
        engine = self._resolve_transform_engine(engine)
        return self._memoized_transform_fn(
            ("forest", engine, tuple(self._out_cols()), str(device)),
            lambda: getattr(self, f"_{engine}_transform_fn")(device),
        )

    def _out_cols(self) -> List[str]:
        return [self.getOrDefault("predictionCol")]

    def _packed_transform_fn(self, device: torch.device):
        raise NotImplementedError

    def _bins_transform_fn(self, device: torch.device):
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

    # -- multi-model support (CV single pass) ------------------------------
    @classmethod
    def _combine(cls, models: List["_ForestModelBase"]) -> "_ForestModelBase":
        """Forests are ragged across param maps (numTrees, maxDepth), so the
        combined model is a copy of the first that keeps the sub-model list
        and evaluates each against one feature extraction."""
        combined = models[0].copy()
        combined._cv_models = list(models)
        return combined

    def _eval_models(self) -> List["_ForestModelBase"]:
        return getattr(self, "_cv_models", None) or [self]


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
        pf, (nodes1, nodes2), binz = self._packed_operands(device)
        leafp = torch.from_numpy(self._leaf_probs()).to(device)

        def _fn(Xb: np.ndarray) -> Dict[str, np.ndarray]:
            pred, prob, raw = rf_classify_packed(binz(Xb), nodes1, nodes2, leafp, k1=pf.k1, k2=pf.k2)
            return {pred_col: pred.cpu().numpy(), prob_col: prob.cpu().numpy(), raw_col: raw.cpu().numpy()}

        return _fn

    def _bins_transform_fn(self, device: torch.device) -> Callable[[np.ndarray], Dict[str, np.ndarray]]:
        pred_col, prob_col, raw_col = self._out_cols()
        feat, thrb, binz = self._bins_operands(device)
        leafp = torch.from_numpy(self._leaf_probs()).to(device)
        depth = self._max_depth_built

        def _fn(Xb: np.ndarray) -> Dict[str, np.ndarray]:
            pred, prob, raw = rf_classify_bins(binz(Xb), feat, thrb, leafp, max_depth=depth)
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

    def _transformEvaluate(self, dataset: DataFrame, evaluator: Any) -> List[float]:
        """One feature extraction, then one transform a sub-model (one K9
        launch a batch on the card) and its metric."""
        from ..evaluation import MulticlassClassificationEvaluator
        from ..metrics import MulticlassMetrics

        if not isinstance(evaluator, MulticlassClassificationEvaluator):
            raise NotImplementedError(f"Evaluator {type(evaluator).__name__} is not supported")
        X = _features(self, _resolve_feature_matrix(self, dataset))
        y = np.asarray(dataset.column(evaluator.getLabelCol()), dtype=np.float64)
        need_probs = evaluator.getMetricName() == "logLoss"
        results = []
        for m in self._eval_models():
            out = m._apply_batched(m._get_transform_func(dataset), X)
            results.append(
                MulticlassMetrics.from_predictions(
                    y,
                    out[m.getOrDefault("predictionCol")],
                    out[m.getOrDefault("probabilityCol")] if need_probs else None,
                    evaluator.getEps(),
                ).evaluate(evaluator)
            )
        return results


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
        pf, (nodes1, nodes2), binz = self._packed_operands(device)
        leafv = torch.from_numpy(self._leaf_means()).to(device)

        def _fn(Xb: np.ndarray) -> Dict[str, np.ndarray]:
            pred = rf_regress_packed(binz(Xb), nodes1, nodes2, leafv, k1=pf.k1, k2=pf.k2)
            return {pred_col: pred.cpu().numpy().astype(Xb.dtype)}

        return _fn

    def _bins_transform_fn(self, device: torch.device) -> Callable[[np.ndarray], Dict[str, np.ndarray]]:
        (pred_col,) = self._out_cols()
        feat, thrb, binz = self._bins_operands(device)
        leafv = torch.from_numpy(self._leaf_means()).to(device)
        depth = self._max_depth_built

        def _fn(Xb: np.ndarray) -> Dict[str, np.ndarray]:
            pred = rf_regress_bins(binz(Xb), feat, thrb, leafv, max_depth=depth)
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

    def _transformEvaluate(self, dataset: DataFrame, evaluator: Any) -> List[float]:
        """One feature extraction, then one transform a sub-model (one K9
        launch a batch on the card) and its metric."""
        from ..evaluation import RegressionEvaluator
        from ..metrics import RegressionMetrics

        if not isinstance(evaluator, RegressionEvaluator):
            raise NotImplementedError(f"Evaluator {type(evaluator).__name__} is not supported")
        X = _features(self, _resolve_feature_matrix(self, dataset))
        y = np.asarray(dataset.column(evaluator.getLabelCol()), dtype=np.float64)
        return [
            RegressionMetrics.from_predictions(
                y, m._apply_batched(m._get_transform_func(dataset), X)[m.getOrDefault("predictionCol")]
            ).evaluate(evaluator)
            for m in self._eval_models()
        ]


# ---------------------------------------------------------------------------
# gradient-boosted trees
# ---------------------------------------------------------------------------
#
# Spark ML drop-ins for GBTClassifier / GBTRegressor on the same histogram
# builder: each boosting round grows its trees as one tree batch
# (``ops/gbt_kernels.gbt_round``), and fitted models reuse the forest
# transform engines with margin-contribution leaf payloads.


class _GBTClass:
    _default_loss = "squared"

    @classmethod
    def _param_mapping(cls) -> Dict[str, Optional[str]]:
        return {
            "maxIter": "n_estimators",
            "maxDepth": "max_depth",
            "maxBins": "n_bins",
            "stepSize": "learning_rate",
            "lossType": "loss",
            "featureSubsetStrategy": "max_features",
            "minInstancesPerNode": "min_samples_leaf",
            "minInfoGain": "min_impurity_decrease",
            "seed": "random_state",
            "impurity": "",          # Spark GBT impurity is fixed variance
            "maxMemoryInMB": "",
            "cacheNodeIds": "",
            "checkpointInterval": "",
            "subsamplingRate": "",
            "minWeightFractionPerNode": "",
            "validationTol": "",
            "validationIndicatorCol": None,
            "weightCol": None,
            "leafCol": None,
        }

    @classmethod
    def _param_value_mapping(cls) -> Dict[str, Callable[[Any], Any]]:
        return {"max_features": _RandomForestClass._param_value_mapping()["max_features"]}

    @classmethod
    def _get_tpu_params_default(cls) -> Dict[str, Any]:
        # Spark GBT defaults: maxIter=20, maxDepth=5, maxBins=32,
        # stepSize=0.1, featureSubsetStrategy="all"
        return {
            "n_estimators": 20,
            "max_depth": 5,
            "n_bins": 32,
            "learning_rate": 0.1,
            "max_features": 1.0,
            "min_samples_leaf": 1,
            "min_impurity_decrease": 0.0,
            "random_state": None,
            "loss": cls._default_loss,
        }


class _GBTParams(HasFeaturesCol, HasFeaturesCols, HasLabelCol, HasPredictionCol, HasSeed):
    maxIter = _mk("maxIter", "number of boosting rounds", TypeConverters.toInt)
    maxDepth = _mk("maxDepth", "maximum tree depth", TypeConverters.toInt)
    maxBins = _mk("maxBins", "max histogram bins per feature", TypeConverters.toInt)
    stepSize = _mk("stepSize", "learning rate (shrinkage)", TypeConverters.toFloat)
    lossType = _mk("lossType", "loss function", TypeConverters.toString)
    impurity = _mk("impurity", "split criterion (fixed: variance)", TypeConverters.toString)
    featureSubsetStrategy = _mk(
        "featureSubsetStrategy",
        "features considered per split: all|auto|sqrt|log2|onethird|fraction|n",
        TypeConverters.toString,
    )
    minInstancesPerNode = _mk("minInstancesPerNode", "min rows per child node", TypeConverters.toInt)
    minInfoGain = _mk("minInfoGain", "min gain for a split", TypeConverters.toFloat)
    subsamplingRate = _mk("subsamplingRate", "row subsample rate (ignored)", TypeConverters.toFloat)
    maxMemoryInMB = _mk("maxMemoryInMB", "memory hint (ignored)", TypeConverters.toInt)
    cacheNodeIds = _mk("cacheNodeIds", "node-id caching (ignored)", TypeConverters.toBoolean)
    checkpointInterval = _mk("checkpointInterval", "checkpointing (ignored)", TypeConverters.toInt)
    minWeightFractionPerNode = _mk(
        "minWeightFractionPerNode", "min weight fraction (ignored)", TypeConverters.toFloat
    )
    validationTol = _mk("validationTol", "early-stop tolerance (ignored)", TypeConverters.toFloat)
    validationIndicatorCol = _mk(
        "validationIndicatorCol", "validation split column (unsupported)", TypeConverters.toString
    )
    weightCol = _mk("weightCol", "weight column (unsupported)", TypeConverters.toString)
    leafCol = _mk("leafCol", "leaf index column (unsupported)", TypeConverters.toString)

    def __init__(self) -> None:
        super().__init__()
        self._setDefault(
            maxIter=20,
            maxDepth=5,
            maxBins=32,
            stepSize=0.1,
            featureSubsetStrategy="all",
            minInstancesPerNode=1,
            minInfoGain=0.0,
            subsamplingRate=1.0,
            seed=0,
        )

    def getMaxIter(self) -> int:
        return self.getOrDefault("maxIter")

    def getMaxDepth(self) -> int:
        return self.getOrDefault("maxDepth")

    def getMaxBins(self) -> int:
        return self.getOrDefault("maxBins")

    def getStepSize(self) -> float:
        return self.getOrDefault("stepSize")

    def getLossType(self) -> str:
        return self.getOrDefault("lossType")

    def getFeatureSubsetStrategy(self) -> str:
        return self.getOrDefault("featureSubsetStrategy")


def _init_margin(loss: str, y: np.ndarray, n_classes: int) -> np.ndarray:
    """F0, the constant margin minimizing the bare loss (sklearn's
    conventions: the mean, the log-odds, the log-priors)."""
    yv = y.astype(np.float64)
    if loss == "squared":
        return np.array([yv.mean()], dtype=np.float32)
    if loss == "logistic":
        p1 = float(np.clip(yv.mean(), 1e-6, 1.0 - 1e-6))
        return np.array([np.log(p1 / (1.0 - p1))], dtype=np.float32)
    prior = np.bincount(yv.astype(np.int64), minlength=n_classes) / max(1, len(yv))
    return np.log(np.clip(prior, 1e-6, None)).astype(np.float32)


class _GBTEstimator(_GBTClass, _Float32Only, _TpuEstimatorSupervised, _GBTParams):
    """Shared boosting fit: quantize once, then sequential rounds of
    ``gbt_round``, each one tree batch on the current gradient field with
    the margins advanced on the device."""

    _is_classification = False

    def __init__(self, **kwargs: Any) -> None:
        _TpuEstimatorSupervised.__init__(self)
        _GBTParams.__init__(self)
        self._setDefault(lossType=self._default_loss)
        self._set_params(**kwargs)

    def setMaxIter(self, value: int) -> "_GBTEstimator":
        self._set_params(maxIter=value)
        return self

    def setMaxDepth(self, value: int) -> "_GBTEstimator":
        self._set_params(maxDepth=value)
        return self

    def setMaxBins(self, value: int) -> "_GBTEstimator":
        self._set_params(maxBins=value)
        return self

    def setStepSize(self, value: float) -> "_GBTEstimator":
        self._set_params(stepSize=value)
        return self

    def setLossType(self, value: str) -> "_GBTEstimator":
        self._set_params(lossType=value)
        return self

    def setFeatureSubsetStrategy(self, value: str) -> "_GBTEstimator":
        self._set_params(featureSubsetStrategy=value)
        return self

    def setSeed(self, value: int) -> "_GBTEstimator":
        self._set_params(seed=value)
        return self

    # -- subclass hooks ----------------------------------------------------
    def _process_labels(self, y_host: np.ndarray) -> int:
        """Validate labels; the classifier returns n_classes, the regressor 0."""
        raise NotImplementedError

    def _check_loss(self, loss: str) -> None:
        raise NotImplementedError

    # -- fit ---------------------------------------------------------------
    def _get_fit_func(self, dataset: DataFrame) -> FitFunc:
        y_host = np.asarray(dataset.column(self.getOrDefault("labelCol")))
        n_classes = self._process_labels(y_host)
        is_classification = self._is_classification

        def _fit(inputs: FitInputs, params: Dict[str, Any]) -> Dict[str, Any]:
            t0 = time.perf_counter()
            max_depth = int(params["max_depth"])
            if max_depth > _MAX_SUPPORTED_DEPTH:
                raise ValueError(
                    f"maxDepth={max_depth} exceeds supported depth "
                    f"{_MAX_SUPPORTED_DEPTH} (full binary node layout)"
                )
            n_rounds = int(params["n_estimators"])
            if n_rounds < 1:
                raise ValueError("maxIter must be >= 1")
            lr = float(params["learning_rate"])
            self._check_loss(str(params["loss"]))
            n_bins = int(min(params["n_bins"], max(2, inputs.n_rows)))
            if n_bins > 256:
                self.logger.warning("maxBins=%d clamped to 256", n_bins)
                n_bins = 256
            d = inputs.n_features
            d_pad = next_pow2(d)
            seed = int(params.get("random_state") or 0)

            report: Dict[str, float] = {}
            edges_np, bins = _quantize_features(inputs, n_bins, d_pad, seed, "GBT", report)
            # Spark's GBTClassifier is binary; K > 2 classes extend it
            # sklearn-style (one tree per class per round, softmax gradients)
            if not is_classification:
                loss, n_out, n_v = "squared", 1, 1
            elif n_classes == 2:
                loss, n_out, n_v = "logistic", 1, 1
            else:
                loss, n_out, n_v = "multinomial", n_classes, n_classes
            init = _init_margin(loss, y_host, n_classes)
            cfg = GBTConfig(
                loss=loss,
                n_out=n_out,
                learning_rate=lr,
                tree=ForestConfig(
                    max_depth=max_depth,
                    n_bins=n_bins,
                    n_features=d,
                    n_stats=3 if loss == "squared" else 4,
                    impurity="variance",
                    k_features=_resolve_k_features(params["max_features"], d, is_classification),
                    min_samples_leaf=int(params["min_samples_leaf"]),
                    min_info_gain=float(params.get("min_impurity_decrease", 0.0) or 0.0),
                    min_samples_split=int(params.get("min_samples_split", 2)),
                    bootstrap=False,
                ),
            )
            margins = torch.from_numpy(init).to(inputs.device).expand(bins.shape[0], n_v).contiguous()
            draws = TorchDraws(seed)
            log_every = int(GBT_ROUND_LOG_EVERY)
            # checkpoint/resume over the boosting loop, with the JAX
            # package's identity: the draws are a function of the absolute
            # tree index and the f32 margins round-trip through .npz bit
            # for bit, so a resumed fit grows the uninterrupted fit's trees
            # (the identity is built only where checkpointing is on)
            ckpt = FitCheckpointer.from_settings("gbt", lambda: {
                "loss": loss, "n_rounds": n_rounds, "lr": lr, "max_depth": max_depth, "n_bins": n_bins,
                "d": d, "n_rows": inputs.n_rows, "seed": seed,
                "edges": array_digest(edges_np), "init": array_digest(init),
            })

            t_quant = time.perf_counter()
            outs: List[Dict[str, torch.Tensor]] = []
            r0 = 0
            resumed = ckpt.load() if ckpt.enabled else None
            if resumed is not None:
                r0, saved, _ = resumed
                margins = torch.from_numpy(saved["margins"]).to(inputs.device)
                # the committed trees ride as one entry ahead of the new rounds'
                outs.append({k: torch.from_numpy(saved[k]).to(inputs.device) for k in _GBT_TABLES})
                counters.bump("resumed_fits")
                counters.note("resumed_from", r0)
                self.logger.info("GBT resume: restored %d/%d committed rounds", r0, n_rounds)
            for r in range(r0, n_rounds):
                fault_site("gbt:round")
                out = gbt_round(
                    bins, inputs.mask, inputs.y, margins, cfg=cfg,
                    trees=[r * n_out + j for j in range(n_out)], draws=draws,
                )
                margins = out.pop("margins")
                outs.append(out)
                if ckpt.enabled:
                    def _snapshot() -> Dict[str, np.ndarray]:
                        return {"margins": margins.cpu().numpy(),
                                **{k: torch.cat([o[k] for o in outs]).cpu().numpy() for k in _GBT_TABLES}}

                    if (r + 1) % ckpt.every == 0:
                        ckpt.save(r + 1, _snapshot())
                    preempt_point(ckpt, r + 1, _snapshot)
                if log_every and (r + 1) % log_every == 0:
                    lv = float(gbt_loss(inputs.y, margins, inputs.mask, loss=loss))
                    self.logger.info("GBT round %d/%d: train %s loss %.6f", r + 1, n_rounds, loss, lv)
            # one host copy per table after the loop: the rounds depend on
            # each other through the margins, not through these copies
            tables = {k: torch.cat([o[k] for o in outs]).cpu().numpy() for k in _GBT_TABLES}
            ckpt.clear()
            t_boost = time.perf_counter()
            feat = tables["feature"].astype(np.int32)
            thr_bin = tables["threshold_bin"].astype(np.int32)
            thr = np.where(
                feat >= 0,
                edges_np[np.clip(feat, 0, d - 1), np.clip(thr_bin, 0, n_bins - 2)],
                0.0,
            ).astype(np.float32)
            report.update({
                "quantize_seconds": t_quant - t0,
                "boost_seconds": t_boost - t_quant,
                "rounds": n_rounds,
                "trees": int(feat.shape[0]),
                "seconds_per_round": (t_boost - t_quant) / n_rounds,
                "draws_seconds": draws.seconds,
            })
            return {
                "features": feat,
                "thresholds": thr,
                "threshold_bins": thr_bin,
                "bin_edges": edges_np.astype(np.float32),
                "leaf_stats": tables["leaf_stats"].astype(np.float32),
                "gains": tables["gain"].astype(np.float32),
                # the lr-scaled margin contributions that advanced the
                # training margins, as computed on the device
                "leaf_values": tables["values"].astype(np.float32),
                "init_margin": init,
                "n_classes": n_classes if is_classification else 0,
                "num_features": d,
                "learning_rate": lr,
                "n_rounds": n_rounds,
                "loss": loss,
                _FIT_REPORT: report,
            }

        return _fit


class _GBTModel(_GBTClass, _ForestModelBase, _GBTParams):
    """Shared fitted-GBT surface: the forest transform engines with margin
    contributions summed over trees as the payload."""

    def __init__(self, **attrs: Any) -> None:
        _ForestModelBase.__init__(self, **attrs)
        _GBTParams.__init__(self)

    @property
    def _leaf_values_arr(self) -> np.ndarray:
        return np.asarray(self._model_attributes["leaf_values"])

    @property
    def _init_margin_arr(self) -> np.ndarray:
        return np.asarray(self._model_attributes["init_margin"], dtype=np.float32).reshape(-1)

    def getNumRounds(self) -> int:
        return int(self._model_attributes["n_rounds"])

    def _leaf_counts(self) -> np.ndarray:
        # GBT stats are (w, r, r^2[, h]): slot 0 is the row count for every
        # loss (the forest base sums class slots when n_classes > 0)
        return self._leaf_stats_arr[:, :, 0]

    def _payload_values(self) -> np.ndarray:
        """(T, M, V) per-node margin contributions: multiclass trees are
        rounds-major, tree t adding to class t % K; binary and regression
        heads have one column."""
        lv = self._leaf_values_arr.astype(np.float32)
        K = int(self._model_attributes.get("n_classes") or 0)
        if K > 2:
            T, M = lv.shape
            out = np.zeros((T, M, K), dtype=np.float32)
            out[np.arange(T)[:, None], np.arange(M)[None, :], (np.arange(T) % K)[:, None]] = lv
            return out
        return lv[:, :, None]

    def _margins_from_eval(self, summed: torch.Tensor) -> np.ndarray:
        return summed.cpu().numpy() + self._init_margin_arr[None, :]

    def _margin_outputs(self, marg: np.ndarray, x_dtype: np.dtype) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    # -- the three engines (payload: margin contributions) -----------------
    def _packed_transform_fn(self, device: torch.device) -> Callable[[np.ndarray], Dict[str, np.ndarray]]:
        pf, (nodes1, nodes2), binz = self._packed_operands(device)
        vals = torch.from_numpy(self._payload_values()).to(device)

        def _fn(Xb: np.ndarray) -> Dict[str, np.ndarray]:
            s = rf_eval_packed(binz(Xb), nodes1, nodes2, vals, k1=pf.k1, k2=pf.k2)
            return self._margin_outputs(self._margins_from_eval(s), np.dtype(Xb.dtype))

        return _fn

    def _bins_transform_fn(self, device: torch.device) -> Callable[[np.ndarray], Dict[str, np.ndarray]]:
        feat, thrb, binz = self._bins_operands(device)
        vals = torch.from_numpy(self._payload_values()).to(device)
        depth = self._max_depth_built

        def _fn(Xb: np.ndarray) -> Dict[str, np.ndarray]:
            s = rf_eval_bins(binz(Xb), feat, thrb, vals, max_depth=depth)
            return self._margin_outputs(self._margins_from_eval(s), np.dtype(Xb.dtype))

        return _fn

    def _legacy_transform_fn(self, device: torch.device) -> Callable[[np.ndarray], Dict[str, np.ndarray]]:
        feat = torch.from_numpy(self._features_arr.astype(np.int64)).to(device)
        thr = torch.from_numpy(self._thresholds_arr.astype(np.float32)).to(device)
        vals = torch.from_numpy(self._payload_values()).to(device)
        depth = self._max_depth_built

        def _fn(Xb: np.ndarray) -> Dict[str, np.ndarray]:
            leaf = forest_apply(torch.from_numpy(Xb).to(device), feat, thr, max_depth=depth)   # (T, n)
            s = vals[0][leaf[0]]
            for t in range(1, leaf.shape[0]):
                s = s + vals[t][leaf[t]]
            return self._margin_outputs(self._margins_from_eval(s), np.dtype(Xb.dtype))

        return _fn

    def predict(self, vector: Any) -> float:
        x = np.asarray(vector, dtype=np.float32).reshape(1, -1)
        return float(self._get_transform_func()(x)[self.getOrDefault("predictionCol")][0])


class GBTClassifier(_GBTEstimator, HasProbabilityCol, HasRawPredictionCol):
    """``GBTClassifier(maxIter=20, maxDepth=5).fit(df)`` — drop-in for
    ``pyspark.ml.classification.GBTClassifier``. Binary labels use the
    logistic loss (Spark's); more than two classes extend it to softmax
    boosting, one tree per class per round."""

    _is_classification = True
    _default_loss = "logistic"

    def _process_labels(self, y_host: np.ndarray) -> int:
        ls = global_label_summary(y_host)
        if ls["total"] == 0:
            raise ValueError("Labels column is empty")
        if ls["y_min"] < 0 or not ls["all_int"]:
            raise RuntimeError("Labels MUST be non-negative integers")
        return max(int(ls["y_max"]) + 1, 2)

    def _check_loss(self, loss: str) -> None:
        if loss != "logistic":
            raise ValueError(f"Unsupported lossType for GBTClassifier: {loss!r} (only 'logistic')")

    def _create_model(self, result: Dict[str, Any]) -> "GBTClassificationModel":
        return _model_with_report(GBTClassificationModel, result)


class GBTClassificationModel(_GBTModel, HasProbabilityCol, HasRawPredictionCol):
    @property
    def numClasses(self) -> int:
        return int(self._model_attributes["n_classes"])

    @property
    def classes_(self) -> np.ndarray:
        return np.arange(self.numClasses, dtype=np.float64)

    def _out_cols(self) -> List[str]:
        return [
            self.getOrDefault("predictionCol"),
            self.getOrDefault("probabilityCol"),
            self.getOrDefault("rawPredictionCol"),
        ]

    def _margin_outputs(self, marg: np.ndarray, x_dtype: np.dtype) -> Dict[str, np.ndarray]:
        """Spark's columns from the margins, on the host in f64 as the JAX
        package computes them."""
        pred_col, prob_col, raw_col = self._out_cols()
        if self.numClasses == 2:
            m = marg[:, 0].astype(np.float64)
            p1 = 1.0 / (1.0 + np.exp(-m))
            prob = np.stack([1.0 - p1, p1], axis=1)
            raw = np.stack([-m, m], axis=1)
            pred = (p1 > 0.5).astype(x_dtype)
        else:
            raw = marg.astype(np.float64)
            e = np.exp(raw - raw.max(axis=1, keepdims=True))
            prob = e / e.sum(axis=1, keepdims=True)
            pred = raw.argmax(axis=1).astype(x_dtype)
        return {pred_col: pred, prob_col: prob.astype(np.float32), raw_col: raw.astype(np.float32)}

    def predictProbability(self, vector: Any) -> np.ndarray:
        x = np.asarray(vector, dtype=np.float32).reshape(1, -1)
        return self._get_transform_func()(x)[self.getOrDefault("probabilityCol")][0]

    def predictRaw(self, vector: Any) -> np.ndarray:
        x = np.asarray(vector, dtype=np.float32).reshape(1, -1)
        return self._get_transform_func()(x)[self.getOrDefault("rawPredictionCol")][0]


class GBTRegressor(_GBTEstimator):
    """``GBTRegressor(maxIter=20, maxDepth=5).fit(df)`` — drop-in for
    ``pyspark.ml.regression.GBTRegressor`` (squared-error loss)."""

    _is_classification = False
    _default_loss = "squared"

    def _process_labels(self, y_host: np.ndarray) -> int:
        if global_label_summary(y_host)["total"] == 0:
            raise ValueError("Labels column is empty")
        return 0

    def _check_loss(self, loss: str) -> None:
        if loss == "absolute":
            raise ValueError(
                "lossType='absolute' is not supported (leaf values come from "
                "closed-form Newton steps; use 'squared')"
            )
        if loss != "squared":
            raise ValueError(f"Unsupported lossType for GBTRegressor: {loss!r} (only 'squared')")

    def _create_model(self, result: Dict[str, Any]) -> "GBTRegressionModel":
        return _model_with_report(GBTRegressionModel, result)


class GBTRegressionModel(_GBTModel):
    def _margin_outputs(self, marg: np.ndarray, x_dtype: np.dtype) -> Dict[str, np.ndarray]:
        (pred_col,) = self._out_cols()
        return {pred_col: marg[:, 0].astype(x_dtype)}
