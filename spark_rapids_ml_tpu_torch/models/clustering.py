"""KMeans of the port (counterpart of
``spark_rapids_ml_tpu/models/clustering.py``).

Fit: k-means|| seeding (device passes for the min distances and the
candidate weights, the small weighted k-means++ on the host), then Lloyd
(``ops.kmeans_kernels.kmeans_lloyd``) through kernel K2. The seeding draws
from a host ``np.random.Generator`` in the JAX package's exact order, so
with the same seed both packages draw the same numbers. There is no lane
padding of the features on the GPU (the JAX package pads to 128 on a TPU).

A streamed fit (``streaming=True``, a parquet scan, or a matrix above the
stream threshold) runs the same seeding over chunked passes and Lloyd as
one chunked pass an iteration (``ops.streaming.streamed_kmeans_lloyd``),
K2 on every chunk. Both fits time the seeding by part in the model's
``_fit_report``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from ..core import FitFunc, FitInputs, StreamFitFunc, StreamInputs, _TpuEstimator, _TpuModel
from ..data.dataframe import DataFrame
from ..parallel.mesh import _np_dtype
from ..ops.kmeans_kernels import count_closest, kmeans_lloyd, min_sq_dists, pairwise_sq_dists
from ..params import (
    HasFeaturesCol,
    HasFeaturesCols,
    HasMaxIter,
    HasPredictionCol,
    HasSeed,
    HasTol,
    HasWeightCol,
    TypeConverters,
    _mk,
)
from ..utils.platform import resolve_device

_CHUNK = 4096

# key of the fit's provenance in a fit's result (not a model attribute)
_FIT_REPORT = "_fit_report"


class _SeedTimes:
    """Wall seconds of the seeding's parts by name (``part``), the calls of
    each, and the k-means|| candidate count. Reads the host clock only: it
    draws nothing and waits for nothing."""

    def __init__(self) -> None:
        self.seconds: Dict[str, float] = {}
        self.calls: Dict[str, int] = {}
        self.candidates = 0

    @contextlib.contextmanager
    def part(self, name: str) -> Iterator[None]:
        t = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t
            self.calls[name] = self.calls.get(name, 0) + 1


class KMeansClass:
    @classmethod
    def _param_mapping(cls) -> Dict[str, Optional[str]]:
        return {
            "k": "n_clusters",
            "initMode": "init",
            "initSteps": "init_steps",
            "maxIter": "max_iter",
            "seed": "random_state",
            "tol": "tol",
            "distanceMeasure": "distance_measure",
            "weightCol": None,
            "solver": "",
            "maxBlockSizeInMB": "",
        }

    @classmethod
    def _param_value_mapping(cls) -> Dict[str, Callable[[Any], Any]]:
        def _check_init(v: str) -> str:
            if v not in ("k-means||", "random"):
                raise ValueError(f"Unsupported initMode: {v!r}")
            return v

        def _check_dist(v: str) -> str:
            if v != "euclidean":
                raise ValueError(
                    f"Only euclidean distance is supported, got {v!r}"
                )
            return v

        return {"init": _check_init, "distance_measure": _check_dist}

    @classmethod
    def _get_tpu_params_default(cls) -> Dict[str, Any]:
        return {
            "n_clusters": 2,
            "init": "k-means||",
            "init_steps": 2,
            "max_iter": 20,
            "tol": 1e-4,
            "random_state": 1,
            "oversampling_factor": 2.0,
            "distance_measure": "euclidean",
            "matmul_dtype": None,
        }


class _KMeansParams(
    HasFeaturesCol, HasFeaturesCols, HasPredictionCol, HasMaxIter, HasTol, HasSeed, HasWeightCol
):
    k = _mk("k", "number of clusters", TypeConverters.toInt)
    initMode = _mk("initMode", "init algorithm: k-means|| or random", TypeConverters.toString)
    initSteps = _mk("initSteps", "k-means|| init steps", TypeConverters.toInt)
    distanceMeasure = _mk("distanceMeasure", "distance measure", TypeConverters.toString)
    # accepted-but-ignored Spark >= 3.4 params (""-mapped)
    solver = _mk("solver", "optimization solver (ignored)", TypeConverters.toString)
    maxBlockSizeInMB = _mk(
        "maxBlockSizeInMB", "block size hint (ignored)", TypeConverters.toFloat
    )

    def __init__(self) -> None:
        super().__init__()
        self._setDefault(
            k=2, initMode="k-means||", initSteps=2, maxIter=20, tol=1e-4,
            distanceMeasure="euclidean",
        )

    def getK(self) -> int:
        return self.getOrDefault("k")

    def getInitMode(self) -> str:
        return self.getOrDefault("initMode")


class KMeans(KMeansClass, _TpuEstimator, _KMeansParams):
    """``KMeans(k=1000, maxIter=30).fit(df)`` — drop-in for
    ``pyspark.ml.clustering.KMeans``."""

    def __init__(self, **kwargs: Any) -> None:
        _TpuEstimator.__init__(self)
        _KMeansParams.__init__(self)
        self._set_params(**kwargs)

    def setK(self, value: int) -> "KMeans":
        self._set_params(k=value)
        return self

    def setMaxIter(self, value: int) -> "KMeans":
        self._set_params(maxIter=value)
        return self

    def setTol(self, value: float) -> "KMeans":
        self._set_params(tol=value)
        return self

    def setSeed(self, value: int) -> "KMeans":
        self._set_params(seed=value)
        return self

    def setInitMode(self, value: str) -> "KMeans":
        self._set_params(initMode=value)
        return self

    def _chunk_rows(self, n_rows: int, n_dp: int) -> int:
        return self._equal_chunk_rows(n_rows, n_dp, _CHUNK)

    @staticmethod
    def _check_matmul_dtype(params: Dict[str, Any]) -> None:
        """bf16 Lloyd operands are not ported yet; validated before any
        seeding work."""
        mm = params.get("matmul_dtype")
        if mm is not None and str(mm) not in ("float32", "bfloat16"):
            raise ValueError(f"matmul_dtype must be float32|bfloat16, got {mm!r}")
        if str(mm) == "bfloat16":
            raise NotImplementedError("matmul_dtype=bfloat16 is not ported yet")

    # ---- seeding ---------------------------------------------------------
    # The rng consumption sequence is the JAX package's, draw for draw: the
    # same seed yields the same uniforms and choices in both packages. The
    # "owner" dict keeps the JAX package's seeding interface (one owner
    # spanning all rows on one device).

    @staticmethod
    def _rng_slice(
        rng: np.random.Generator, n_rows: int, offset: int, n_local: int
    ) -> np.ndarray:
        """Lockstep uniforms for [0, n_rows), keeping only [offset,
        offset + n_local)."""
        if offset:
            rng.random(offset)
        r = rng.random(n_local)
        rest = n_rows - offset - n_local
        if rest:
            rng.random(rest)
        return r

    @staticmethod
    def _gather_global(owner: Dict[str, Any], idx: np.ndarray, times: _SeedTimes) -> np.ndarray:
        """Rows for sorted global indices (timed as ``gather``)."""
        with times.part("gather"):
            idx = np.sort(np.asarray(idx, np.int64))
            off, nl = owner["offset"], owner["n_local"]
            mine = idx[(idx >= off) & (idx < off + nl)] - off
            return owner["assemble"](owner["gather_local"](mine))

    @staticmethod
    def _seed_random(
        n_rows: int, k: int, rng: np.random.Generator, owner: Dict[str, Any], times: _SeedTimes
    ) -> np.ndarray:
        with times.part("draws"):
            idx = rng.choice(n_rows, size=k, replace=n_rows < k)
        return KMeans._gather_global(owner, idx, times)

    @staticmethod
    def _seed_scalable_kmeanspp(
        n_rows: int,
        k: int,
        steps: int,
        oversample: float,
        rng: np.random.Generator,
        owner: Dict[str, Any],
        times: Optional[_SeedTimes] = None,
    ) -> np.ndarray:
        """k-means|| (Bahmani et al.): sample ~l=oversample*k candidates per
        round with prob l*d²/Σd², then reduce candidates to k centres with
        weighted k-means++ on host (the candidate set is small). ``times`` (a
        fresh one where None) gets the seconds of the gathers, the min-distance passes
        (``min_d2``, with their host fold), the host draws and selection
        (``draws``), the candidate-count pass (``count``) and the weighted
        k-means++ (``kmeanspp``), and the candidate count."""
        times = _SeedTimes() if times is None else times
        l = max(int(oversample * k), 1)
        off, nl = owner["offset"], owner["n_local"]
        with times.part("draws"):
            first = int(rng.integers(0, n_rows))
        cands = KMeans._gather_global(owner, np.asarray([first]), times)
        with times.part("min_d2"):
            local_d2 = np.asarray(owner["min_d2_vs"](cands), np.float64)
        for _ in range(steps):
            with times.part("draws"):
                total = float(owner["reduce_sum"](float(local_d2.sum())))
                if total <= 0:
                    break
                r = KMeans._rng_slice(rng, n_rows, off, nl)
                sel = np.nonzero(r < np.minimum(l * local_d2 / total, 1.0))[0]
            with times.part("gather"):
                new = owner["assemble"](owner["gather_local"](sel))
            if len(new) == 0:
                continue
            cands = np.concatenate([cands, new], axis=0)
            with times.part("min_d2"):
                local_d2 = np.minimum(
                    local_d2, np.asarray(owner["min_d2_vs"](new), np.float64)
                )
        times.candidates = len(cands)
        if len(cands) < k:
            # not enough candidates — top up with random rows
            extra = KMeans._seed_random(n_rows, k - len(cands), rng, owner, times)
            return np.concatenate([cands, extra], axis=0)
        if len(cands) == k:
            return cands
        with times.part("count"):
            weights = np.asarray(owner["count_closest"](cands), np.float64)
        with times.part("kmeanspp"):
            return _weighted_kmeanspp(cands.astype(np.float64), weights, k, rng)

    def _resident_owner(self, inputs: FitInputs) -> Dict[str, Any]:
        """Owner of all rows: valid rows are the first ``n_rows`` (padding
        sits at the end on one device)."""
        n = inputs.n_rows

        def gather_local(idx: np.ndarray) -> np.ndarray:
            if len(idx) == 0:
                return np.empty((0, inputs.n_features), _np_dtype(inputs.dtype))
            sel = torch.as_tensor(idx, dtype=torch.int64, device=inputs.device)
            return inputs.X.index_select(0, sel).cpu().numpy()

        def as_centers(cands: np.ndarray) -> torch.Tensor:
            return torch.as_tensor(cands, dtype=inputs.dtype, device=inputs.device)

        def min_d2_vs(cands: np.ndarray) -> np.ndarray:
            d2 = min_sq_dists(inputs.X, inputs.mask, as_centers(cands), csize=inputs.csize)
            return d2[:n].cpu().numpy().astype(np.float64)

        def count_closest_fn(cands: np.ndarray) -> np.ndarray:
            return count_closest(inputs.X, inputs.mask, as_centers(cands)).cpu().numpy()

        return {
            "offset": 0,
            "n_local": n,
            "gather_local": gather_local,
            "assemble": lambda rows: rows,
            "min_d2_vs": min_d2_vs,
            "reduce_sum": lambda x: x,
            "count_closest": count_closest_fn,
        }

    def _stream_owner(self, inputs: StreamInputs) -> Dict[str, Any]:
        """Owner of all rows of a chunk source on one process: each seeding
        step is one chunked pass (``ops.streaming``); the host keeps the
        min distances (8 bytes a row), never the rows. The JAX package's
        process offset, ragged allgather and cross-process sums are the
        identity and 0 on one process."""
        from ..ops.streaming import streamed_count_closest, streamed_min_sq_dists_update, streamed_rows_at

        src, dev, rows, dt = inputs.source, inputs.device, inputs.chunk_rows, inputs.dtype
        return {
            "offset": 0,
            "n_local": int(src.n_rows),
            "gather_local": lambda idx: streamed_rows_at(src, rows, idx, dt),
            "assemble": lambda rows_: rows_,
            "min_d2_vs": lambda cands: streamed_min_sq_dists_update(src, dev, rows, dt, cands),
            "reduce_sum": lambda x: x,
            "count_closest": lambda cands: streamed_count_closest(src, dev, rows, dt, cands),
        }

    # ---- fit -------------------------------------------------------------
    def _fit_centres(
        self, params: Dict[str, Any], n_rows: int, owner: Dict[str, Any], lloyd: Callable[..., tuple]
    ) -> Dict[str, Any]:
        """The fit both paths share: the checks, the seeding over ``owner``,
        then ``lloyd(centers0, max_iter=, tol=, shifts=)`` -> ``(centers,
        cost, n_iter)``. The result carries the
        fit's ``_fit_report``: the init mode, the seeding's seconds
        (``seed_s``) and its parts' (``seed_parts_s``: gathers, min-distance
        and candidate-count passes, host draws and selection, weighted
        k-means++) and calls (``seed_calls``), the candidate count, the
        Lloyd loop's seconds with its final cost pass (``lloyd_s``), the
        iterations and each iteration's largest squared centre shift."""
        k = int(params["n_clusters"])
        if k > n_rows:
            raise ValueError(f"k={k} must be <= number of rows {n_rows}")
        self._check_matmul_dtype(params)
        rng = np.random.default_rng(int(params.get("random_state") or 0))
        times = _SeedTimes()
        init = str(params.get("init"))
        t0 = time.perf_counter()
        if init == "random":
            centers0 = self._seed_random(n_rows, k, rng, owner, times)
        else:
            centers0 = self._seed_scalable_kmeanspp(
                n_rows, k, int(params.get("init_steps", 2)),
                float(params.get("oversampling_factor", 2.0)), rng, owner, times,
            )
        t1 = time.perf_counter()
        shifts: List[float] = []
        centers, cost, n_iter = lloyd(
            centers0, max_iter=int(params["max_iter"]), tol=float(params["tol"]), shifts=shifts
        )
        t2 = time.perf_counter()
        return {
            "cluster_centers": np.asarray(centers),
            "training_cost": float(cost),
            "n_iter": int(n_iter),
            _FIT_REPORT: {
                "init": init,
                "seed_s": t1 - t0,
                "seed_parts_s": dict(times.seconds),
                "seed_calls": dict(times.calls),
                "seed_candidates": times.candidates,
                "lloyd_s": t2 - t1,
                "n_iter": int(n_iter),
                "shifts": shifts,
            },
        }

    def _get_fit_func(self, dataset: DataFrame) -> FitFunc:
        def _fit(inputs: FitInputs, params: Dict[str, Any]) -> Dict[str, Any]:
            def lloyd(centers0: np.ndarray, **kw: Any) -> tuple:
                C0 = torch.as_tensor(centers0, dtype=inputs.dtype, device=inputs.device)
                centers, cost, n_iter = kmeans_lloyd(inputs.X, inputs.mask, C0, **kw)
                return centers.cpu().numpy(), cost, n_iter

            return self._fit_centres(params, inputs.n_rows, self._resident_owner(inputs), lloyd)

        return _fit

    def _get_streaming_fit_func(self, dataset: DataFrame) -> StreamFitFunc:
        """Out-of-core fit: the seeding and every Lloyd iteration are
        chunked passes (``ops.streaming``); the card holds a few chunks and
        the k x d state, the host the min distances of k-means|| (8 bytes a
        row), never the rows. One seed draws the same numbers as the
        resident fit. With ``runtime.checkpoint.CKPT_DIR`` set, Lloyd
        checkpoints after each iteration and a refit resumes: it reruns
        the seeding, which is deterministic, and the digest of its seeds in
        the identity proves the walk being resumed is this one."""
        from ..ops.streaming import streamed_kmeans_lloyd
        from ..runtime.checkpoint import FitCheckpointer, array_digest

        def _fit(inputs: StreamInputs, params: Dict[str, Any]) -> Dict[str, Any]:
            def lloyd(centers0: np.ndarray, **kw: Any) -> tuple:
                # checkpoint identity, the JAX package's key for key
                # ("matmul_dtype": its None, the f32 Lloyd; bf16 raises here)
                ckpt = FitCheckpointer.from_settings(
                    "kmeans",
                    {
                        "k": int(params["n_clusters"]),
                        "d": int(inputs.source.n_features),
                        "n_rows": int(inputs.n_rows),
                        "max_iter": int(params["max_iter"]),
                        "tol": float(params["tol"]),
                        "seed": int(params.get("random_state") or 0),
                        "init": str(params.get("init")),
                        "matmul_dtype": str(None),
                        "centers0": array_digest(centers0),
                    },
                )
                return streamed_kmeans_lloyd(inputs.source, inputs.device, inputs.chunk_rows, inputs.dtype,
                                             np.asarray(centers0), checkpointer=ckpt if ckpt.enabled else None,
                                             **kw)

            return self._fit_centres(params, inputs.n_rows, self._stream_owner(inputs), lloyd)

        return _fit

    def _create_model(self, result: Dict[str, Any]) -> "KMeansModel":
        report = result.pop(_FIT_REPORT, None)
        model = KMeansModel(**result)
        if report is not None:
            # fit provenance (not persisted): where the fit's time went
            model._fit_report = report
        return model


class KMeansModel(KMeansClass, _TpuModel, _KMeansParams):
    def __init__(self, **attrs: Any) -> None:
        _TpuModel.__init__(self, **attrs)
        _KMeansParams.__init__(self)

    @property
    def cluster_centers_(self) -> np.ndarray:
        return np.asarray(self._model_attributes["cluster_centers"])

    def clusterCenters(self) -> List[np.ndarray]:
        return list(self.cluster_centers_)

    @property
    def trainingCost(self) -> float:
        """Sum of squared distances to closest centre (Spark
        ``summary.trainingCost`` analog)."""
        return float(self._model_attributes["training_cost"])

    @property
    def numIter(self) -> int:
        return int(self._model_attributes["n_iter"])

    def predict(self, vector: Any) -> int:
        """Single-vector predict through the transform function, in the
        model's input dtype (float64 under ``float32_inputs=False``)."""
        pred_col = self.getOrDefault("predictionCol")
        dtype = np.float32 if self._float32_inputs else np.float64
        out = self._get_transform_func()(np.asarray(vector, dtype=dtype).reshape(1, -1))
        return int(out[pred_col][0])

    def _get_transform_func(
        self, dataset: Optional[DataFrame] = None
    ) -> Callable[[np.ndarray], Dict[str, np.ndarray]]:
        pred_col = self.getOrDefault("predictionCol")
        device = resolve_device(self._device)

        def _build() -> Callable[[np.ndarray], Dict[str, np.ndarray]]:
            centers = torch.tensor(self.cluster_centers_, device=device)

            def _fn(Xb: np.ndarray) -> Dict[str, np.ndarray]:
                # the centres in the batch's dtype, as the JAX package casts them
                xb = torch.from_numpy(Xb).to(device)
                d2 = pairwise_sq_dists(xb, centers.to(xb.dtype))
                return {pred_col: torch.argmin(d2, dim=1).to(torch.int32).cpu().numpy()}

            return _fn

        return self._memoized_transform_fn(("kmeans", pred_col, str(device)), _build)


def _weighted_kmeanspp(
    cands: np.ndarray, weights: np.ndarray, k: int, rng: np.random.Generator
) -> np.ndarray:
    """Weighted k-means++ over the (small) k-means|| candidate set."""
    m = len(cands)
    w = np.maximum(weights, 1e-12)
    centers = np.empty((k, cands.shape[1]), dtype=cands.dtype)
    first = rng.choice(m, p=w / w.sum())
    centers[0] = cands[first]
    min_d2 = ((cands - centers[0]) ** 2).sum(axis=1)
    for i in range(1, k):
        p = w * min_d2
        tot = p.sum()
        if tot <= 0:
            # all remaining candidates coincide with chosen centers
            centers[i:] = cands[rng.choice(m, size=k - i)]
            break
        centers[i] = cands[rng.choice(m, p=p / tot)]
        d2 = ((cands - centers[i]) ** 2).sum(axis=1)
        min_d2 = np.minimum(min_d2, d2)
    return centers
