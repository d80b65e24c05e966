"""UMAP of the port (counterpart of ``spark_rapids_ml_tpu/models/umap.py``).

Fit runs on one device, optionally on a ``sample_fraction`` subsample:
kNN graph → fuzzy simplicial set (host scipy, + the supervised
intersection when ``labelCol`` is set) → spectral or random init →
negative-sampling SGD over CSR-padded rows (kernel K10 each epoch,
``ops.umap_kernels.umap_sgd``). The model holds the embedding and the raw
training rows; transform embeds new points by membership-weighted
neighbour averaging, refined by the same SGD against the frozen training
embedding.

The graph engine is chosen as in the JAX package
(``ops.ivf_kernels.select_graph_engine``): the exact graph (kernel K4,
``ops.knn_kernels.knn_search`` of the rows against themselves) below
``ivf_kernels.ANN_GATE_ROWS`` (131,072) rows, the IVF-Flat graph (a coarse
quantizer trained through kernel K2, then the probe scan) from there on a
feasible shape; ``ivf_kernels.UMAP_GRAPH`` pins either. The transform's
kNN takes the same engine against an index of the training rows built
once a model. Telemetry: the fit's root span ``UMAP.fit`` with its
``umap.fit.graph`` / ``.init`` / ``.sgd`` stages, and ``umap.ivf_build``
(``nlist=``) around the transform index's one build; the fit's
``runtime.counters`` delta is the model's ``_resilience_report``.
Checkpoint/resume and fault sites are not ported.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..core import _resolve_features_f32, _TpuEstimator, _TpuModel
from ..data.dataframe import DataFrame
from ..ops import ivf_kernels
from ..ops.knn_kernels import knn_search
from ..ops.umap_kernels import (
    build_row_adjacency,
    categorical_simplicial_set_intersection,
    default_n_epochs,
    find_ab_params,
    fuzzy_simplicial_set,
    membership_strengths,
    smooth_knn_dist,
    spectral_init,
    umap_sgd,
)
from ..params import HasFeaturesCol, HasFeaturesCols, HasLabelCol, HasOutputCol, TypeConverters, _mk
from ..runtime import counters, telemetry
from ..utils.platform import resolve_device
from ..utils.profiling import StageTimer


def knn_brute(X: torch.Tensor, Xq: torch.Tensor, *, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN of ``Xq`` among the rows of ``X``: ``(dists (nq, k)
    ascending euclidean, indices (nq, k) int32)``, ties to the lower
    index."""
    n = X.shape[0]
    d2, idx = knn_search(
        Xq, X, torch.ones(n, device=X.device), torch.arange(n, dtype=torch.int32, device=X.device), k
    )
    return torch.sqrt(d2), idx


def drop_self_column(
    dists: torch.Tensor, idx: torch.Tensor, *, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Remove the self entry from a (n, k+1) self-kNN result: drop the
    FIRST column holding the row's own index, else the last column (with
    duplicate rows, self may sit anywhere in its tie run)."""
    n = idx.shape[0]
    self_mask = idx == torch.arange(n, dtype=idx.dtype, device=idx.device)[:, None]
    drop_col = torch.where(self_mask.any(dim=1), self_mask.to(torch.int32).argmax(dim=1), k)
    # column j of the output reads input column j, shifted past the dropped one
    cols = torch.arange(k, device=idx.device)[None, :]
    src = cols + (cols >= drop_col[:, None]).long()
    return dists.gather(1, src), idx.gather(1, src)


class UMAPClass:
    @classmethod
    def _param_mapping(cls) -> Dict[str, Optional[str]]:
        # all params are dedicated, names identical on both sides
        return {
            name: name
            for name in (
                "n_neighbors", "n_components", "metric", "n_epochs",
                "learning_rate", "init", "min_dist", "spread",
                "set_op_mix_ratio", "local_connectivity", "repulsion_strength",
                "negative_sample_rate", "transform_queue_size", "a", "b",
                "random_state",
            )
        }

    @classmethod
    def _param_value_mapping(cls) -> Dict[str, Callable[[Any], Any]]:
        def _metric(v: str) -> str:
            if v != "euclidean":
                raise ValueError(f"Only the euclidean metric is supported, got {v!r}")
            return v

        def _init(v: str) -> str:
            if v not in ("spectral", "random"):
                raise ValueError(f"Unsupported init: {v!r}")
            return v

        return {"metric": _metric, "init": _init}

    @classmethod
    def _get_tpu_params_default(cls) -> Dict[str, Any]:
        return {
            "n_neighbors": 15,
            "n_components": 2,
            "metric": "euclidean",
            "n_epochs": None,
            "learning_rate": 1.0,
            "init": "spectral",
            "min_dist": 0.1,
            "spread": 1.0,
            "set_op_mix_ratio": 1.0,
            "local_connectivity": 1.0,
            "repulsion_strength": 1.0,
            "negative_sample_rate": 5,
            "transform_queue_size": 4.0,
            "a": None,
            "b": None,
            "random_state": None,
        }


class _UMAPParams(HasFeaturesCol, HasFeaturesCols, HasLabelCol, HasOutputCol):
    n_neighbors = _mk("n_neighbors", "local neighborhood size", TypeConverters.toFloat)
    n_components = _mk("n_components", "embedding dimension", TypeConverters.toInt)
    metric = _mk("metric", "distance metric (euclidean)", TypeConverters.toString)
    n_epochs = _mk("n_epochs", "optimization epochs", TypeConverters.toInt)
    learning_rate = _mk("learning_rate", "initial SGD alpha", TypeConverters.toFloat)
    init = _mk("init", "embedding init: spectral | random", TypeConverters.toString)
    min_dist = _mk("min_dist", "min embedded point spacing", TypeConverters.toFloat)
    spread = _mk("spread", "embedded cluster scale", TypeConverters.toFloat)
    set_op_mix_ratio = _mk("set_op_mix_ratio", "union/intersection mix", TypeConverters.toFloat)
    local_connectivity = _mk("local_connectivity", "assumed local connectivity", TypeConverters.toFloat)
    repulsion_strength = _mk("repulsion_strength", "negative-sample gamma", TypeConverters.toFloat)
    negative_sample_rate = _mk("negative_sample_rate", "negatives per positive", TypeConverters.toInt)
    transform_queue_size = _mk("transform_queue_size", "transform search factor (ignored: search is exact)", TypeConverters.toFloat)
    a = _mk("a", "curve param a (None: from min_dist/spread)", TypeConverters.toFloat)
    b = _mk("b", "curve param b (None: from min_dist/spread)", TypeConverters.toFloat)
    random_state = _mk("random_state", "random seed", TypeConverters.toInt)
    sample_fraction = _mk("sample_fraction", "fit subsample fraction", TypeConverters.toFloat)

    def __init__(self) -> None:
        super().__init__()
        self._setDefault(
            n_neighbors=15.0,
            n_components=2,
            metric="euclidean",
            learning_rate=1.0,
            init="spectral",
            min_dist=0.1,
            spread=1.0,
            set_op_mix_ratio=1.0,
            local_connectivity=1.0,
            repulsion_strength=1.0,
            negative_sample_rate=5,
            transform_queue_size=4.0,
            sample_fraction=1.0,
            outputCol="embedding",
        )

    def getNNeighbors(self) -> float:
        return self.getOrDefault("n_neighbors")

    def setNNeighbors(self, value: float) -> "_UMAPParams":
        self._set_params(n_neighbors=value)  # type: ignore[attr-defined]
        return self

    def getNComponents(self) -> int:
        return self.getOrDefault("n_components")

    def setNComponents(self, value: int) -> "_UMAPParams":
        self._set_params(n_components=value)  # type: ignore[attr-defined]
        return self

    def getSampleFraction(self) -> float:
        return self.getOrDefault("sample_fraction")

    def setSampleFraction(self, value: float) -> "_UMAPParams":
        self._set_params(sample_fraction=value)  # type: ignore[attr-defined]
        return self

    def setOutputCol(self, value: str) -> "_UMAPParams":
        self._set(outputCol=value)
        return self

    def setFeaturesCol(self, value: Union[str, List[str]]) -> "_UMAPParams":
        if isinstance(value, (list, tuple)):
            self._set(featuresCols=list(value))
        else:
            self._set(featuresCol=value)
        return self


class UMAP(UMAPClass, _TpuEstimator, _UMAPParams):
    """``UMAP(n_components=2).fit(df)``: unsupervised (or, with
    ``labelCol``, supervised) manifold embedding."""

    def __init__(self, **kwargs: Any) -> None:
        _TpuEstimator.__init__(self)
        _UMAPParams.__init__(self)
        self._set_params(**kwargs)

    def fit(self, dataset: DataFrame, params: Optional[Dict[Any, Any]] = None) -> "UMAPModel":
        if params:  # a copy with ``params`` set, fitted by this method
            return super().fit(dataset, params)
        if self.num_workers != 1:
            raise NotImplementedError(
                f"num_workers={self.num_workers}: multi-GPU fits are not ported yet"
            )
        self._apply_verbosity()
        # UMAP bypasses the core fit loop, so it opens the fit's root span
        # itself (the name shape of core's ``<Est>.fit``)
        with telemetry.span("UMAP.fit"):
            return self._fit_umap(dataset)

    def _fit_umap(self, dataset: DataFrame) -> "UMAPModel":
        device = resolve_device(self._device)
        res_base = counters.snapshot()
        tp = self._tpu_params
        seed = int(tp.get("random_state") or 0)
        frac = float(self.getSampleFraction())
        df = dataset if frac >= 1.0 else dataset.sample(frac, seed=seed)
        X = _resolve_features_f32(self, df)
        y_labels: Optional[np.ndarray] = None
        if self.isDefined("labelCol") and self.isSet("labelCol"):
            label_col = self.getOrDefault("labelCol")
            if label_col not in df:
                raise ValueError(f"labelCol {label_col!r} not found in dataset columns {df.columns}")
            y_labels = np.asarray(df.column(label_col)).astype(np.int64)
        n = X.shape[0]
        k = int(tp.get("n_neighbors", 15))
        if k >= n:
            raise ValueError(f"n_neighbors={k} must be < number of rows {n}")

        # stage split (graph / init / sgd); each stage ends in a host read,
        # so the device work is inside its own stage
        timer = StageTimer("umap.fit")
        with timer.stage("graph"):
            # 1) kNN graph: fetch k+1 (the self entry is dropped) through the
            # engine the dispatch picks: the exact search or the IVF index
            graph_engine = ivf_kernels.select_graph_engine(n, k + 1)
            ann_nlist = ann_nprobe = None
            Xd = torch.from_numpy(X).to(device)
            if graph_engine == "ivf":
                ann_nlist, ann_nprobe = ivf_kernels.resolve_ann_params(n)
                ivf_index = ivf_kernels.build_ivf_index(X, nlist=ann_nlist, seed=seed, device=device)
                d2, idx = ivf_kernels.ivf_search(Xd, ivf_index, k=k + 1, nprobe=ann_nprobe)
                dists = torch.sqrt(torch.clamp(d2, min=0.0))
                del ivf_index, d2
            else:
                dists, idx = knn_brute(Xd, Xd, k=k + 1)
            knn_d, knn_i = drop_self_column(dists, idx, k=k)
            # 2) fuzzy simplicial set (+ categorical intersection when supervised)
            heads, tails, weights = fuzzy_simplicial_set(
                knn_i.cpu().numpy(), knn_d,
                float(tp.get("local_connectivity", 1.0)), float(tp.get("set_op_mix_ratio", 1.0)),
                device=device,
            )
            if y_labels is not None:
                heads, tails, weights = categorical_simplicial_set_intersection(heads, tails, weights, y_labels, n)
            del Xd, dists, idx, knn_d, knn_i

        with timer.stage("init"):
            # 3) curve params + init
            a, b = tp.get("a"), tp.get("b")
            if a is None or b is None:
                a, b = find_ab_params(float(tp.get("spread", 1.0)), float(tp.get("min_dist", 0.1)))
            n_comp = int(tp.get("n_components", 2))
            if tp.get("init", "spectral") == "spectral":
                emb0 = spectral_init(heads, tails, weights, n, n_comp, seed)
            else:
                emb0 = np.random.default_rng(seed).uniform(-10, 10, size=(n, n_comp)).astype(np.float32)

        with timer.stage("sgd"):
            # 4) SGD over CSR-padded rows of K = 24 slots; small fits pad rows
            # to 256 rather than 4096
            row_heads, tails_pad, p_pad = build_row_adjacency(
                heads, tails, weights, n, K=24, row_bucket=4096 if n >= 4096 else 256
            )
            n_epochs = int(tp.get("n_epochs") or default_n_epochs(n))
            gen = torch.Generator(device=device)
            gen.manual_seed(seed)
            emb_d = torch.from_numpy(emb0).to(device)
            emb = umap_sgd(
                emb_d, emb_d,
                torch.from_numpy(row_heads).to(device), torch.from_numpy(tails_pad).to(device),
                torch.from_numpy(p_pad).to(device), gen,
                n_epochs=n_epochs, a=float(a), b=float(b),
                gamma=float(tp.get("repulsion_strength", 1.0)),
                initial_alpha=float(tp.get("learning_rate", 1.0)),
                negative_sample_rate=int(tp.get("negative_sample_rate", 5)),
                self_table=True,
            ).cpu().numpy()
        stages = dict(timer.totals)
        timer.log_summary(self.logger)

        model = UMAPModel(embedding_=emb, raw_data_=X, a=float(a), b=float(b))
        self._copyValues(model)
        self._copy_tpu_params(model)
        model._resilience_report = counters.delta_since(res_base)
        if model._resilience_report:
            self.logger.info("resilience events during fit: %s", model._resilience_report)
        # fit provenance (not persisted): where the fit's wall clock went
        model._fit_report = {
            "graph_seconds": stages["graph"],
            "init_seconds": stages["init"],
            "sgd_seconds": stages["sgd"],
            "epoch_ms": stages["sgd"] / max(n_epochs, 1) * 1e3,
            "sgd_engine": "cuda" if device.type == "cuda" else "plain",
            "graph_engine": graph_engine,
            "rows": int(tails_pad.shape[0]),
            "n_epochs": n_epochs,
        }
        if graph_engine == "ivf":  # the index's parameters, to rebuild it
            model._fit_report["ann_nlist"] = ann_nlist
            model._fit_report["ann_nprobe"] = ann_nprobe
        return model

    def _get_fit_func(self, dataset: DataFrame):  # pragma: no cover
        raise NotImplementedError("UMAP overrides fit directly")

    def _create_model(self, result: Dict[str, Any]):  # pragma: no cover
        raise NotImplementedError("UMAP overrides fit directly")


class UMAPModel(UMAPClass, _TpuModel, _UMAPParams):
    """Holds (embedding, raw data); transform embeds new points against the
    frozen training embedding."""

    def __init__(self, **attrs: Any) -> None:
        _TpuModel.__init__(self, **attrs)
        _UMAPParams.__init__(self)

    def _compute_dtype(self, dtype: type) -> type:
        """float32 whatever ``float32_inputs`` says: UMAP computes in float32
        (K4, K10), as in the JAX package."""
        return np.float32

    @property
    def embedding_(self) -> np.ndarray:
        return np.asarray(self._model_attributes["embedding_"])

    @property
    def embedding(self) -> List[List[float]]:
        return self.embedding_.tolist()

    @property
    def raw_data_(self) -> np.ndarray:
        return np.asarray(self._model_attributes["raw_data_"])

    def _transform_settings(self) -> Dict[str, Any]:
        tp = self._tpu_params
        n_train = int(self.raw_data_.shape[0])
        n_epochs = int(tp.get("n_epochs") or default_n_epochs(n_train))
        return {
            "k": min(int(tp.get("n_neighbors", 15)), n_train),
            "a": float(self._model_attributes["a"]),
            "b": float(self._model_attributes["b"]),
            "seed": int(tp.get("random_state") or 0),
            "refine": max(n_epochs // 3, 10),
            "lc": float(tp.get("local_connectivity", 1.0)),
            "gamma": float(tp.get("repulsion_strength", 1.0)),
            "neg": int(tp.get("negative_sample_rate", 5)),
            "alpha": float(tp.get("learning_rate", 1.0)),
        }

    def _transform_ivf_index(self, k: int, device: torch.device) -> Optional[Tuple[ivf_kernels.IvfIndex, int]]:
        """The IVF index over the frozen training rows for the transform's
        kNN, built once a (nlist, nprobe, seed, mode, device): ``(index,
        nprobe)``, or None where the dispatch picks the exact search."""
        n_train = int(self.raw_data_.shape[0])
        if ivf_kernels.select_graph_engine(n_train, k) != "ivf":
            return None
        nlist, nprobe = ivf_kernels.resolve_ann_params(n_train)
        seed = int(self._tpu_params.get("random_state") or 0)
        cache = getattr(self, "_ivf_index_cache", None)
        if cache is None:
            cache = self._ivf_index_cache = {}
        key = (nlist, nprobe, seed, ivf_kernels.resolve_umap_graph(), str(device))
        if key not in cache:
            # one span a build: its count stays 1 across transforms
            with telemetry.span("umap.ivf_build", nlist=nlist):
                cache[key] = ivf_kernels.build_ivf_index(self.raw_data_, nlist=nlist, seed=seed, device=device)
        return cache[key], nprobe

    @staticmethod
    def _transform_init(
        Xb: torch.Tensor, train_X: torch.Tensor, train_emb: torch.Tensor, k: int, lc: float,
        ivf: Optional[Tuple[ivf_kernels.IvfIndex, int]] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(emb0, idx, w)`` of a query batch: its kNN among the training
        rows (the exact search, or the IVF search of ``ivf = (index,
        nprobe)``), their membership weights, and the weight-averaged
        training embedding it starts from."""
        if ivf is None:
            dists, idx = knn_brute(train_X, Xb, k=k)
        else:
            d2, idx = ivf_kernels.ivf_search(Xb, ivf[0], k=k, nprobe=ivf[1])
            dists = torch.sqrt(torch.clamp(d2, min=0.0))
        rho, sigma = smooth_knn_dist(dists, lc)
        w = membership_strengths(dists, rho, sigma)
        wn = w / torch.clamp(w.sum(dim=1, keepdim=True), min=1e-12)
        return torch.einsum("qk,qkc->qc", wn, train_emb[idx.long()]), idx, w

    def _get_transform_func(
        self, dataset: Optional[DataFrame] = None
    ) -> Callable[[np.ndarray], Dict[str, np.ndarray]]:
        out_col = self.getOrDefault("outputCol")
        device = resolve_device(self._device)
        st = self._transform_settings()

        def _build() -> Callable[[np.ndarray], Dict[str, np.ndarray]]:
            # the frozen training rows and embedding go to the device once
            train_X = torch.from_numpy(np.ascontiguousarray(self.raw_data_, dtype=np.float32)).to(device)
            train_emb = torch.from_numpy(np.ascontiguousarray(self.embedding_, dtype=np.float32)).to(device)

            def _fn(Xb: np.ndarray) -> Dict[str, np.ndarray]:
                nq = Xb.shape[0]
                # the same engine dispatch as the fit, resolved a batch; the
                # index of the frozen training rows is built once
                ivf = self._transform_ivf_index(st["k"], device)
                emb0, idx, w = self._transform_init(
                    torch.from_numpy(Xb).to(device), train_X, train_emb, st["k"], st["lc"], ivf
                )
                # query q's rows are exactly its k membership edges: one
                # CSR row per query, refined against the frozen table
                gen = torch.Generator(device=device)
                gen.manual_seed(st["seed"])
                emb = umap_sgd(
                    emb0, train_emb, torch.arange(nq, device=device), idx.contiguous(),
                    (w / torch.clamp(w.max(), min=1e-12)).contiguous(), gen,
                    n_epochs=st["refine"], a=st["a"], b=st["b"], gamma=st["gamma"],
                    initial_alpha=st["alpha"], negative_sample_rate=st["neg"], self_table=False,
                )
                self._transform_report = {
                    "refine_epochs": st["refine"], "graph_engine": "exact" if ivf is None else "ivf"}
                return {out_col: emb.cpu().numpy()}

            return _fn

        return self._memoized_transform_fn(("umap", out_col, str(device), *st.values()), _build)
