"""KMeans of the port (counterpart of
``spark_rapids_ml_tpu/models/clustering.py``).

Fit: k-means|| seeding (device passes for the min distances and the
candidate weights, the small weighted k-means++ on the host), then Lloyd
(``ops.kmeans_kernels.kmeans_lloyd``) through kernel K2. The seeding draws
from a host ``np.random.Generator`` in the JAX package's exact order, so
with the same seed both packages draw the same numbers. There is no lane
padding of the features on the GPU (the JAX package pads to 128 on a TPU).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..core import FitFunc, FitInputs, _TpuEstimator, _TpuModel
from ..data.dataframe import DataFrame
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
    def _gather_global(owner: Dict[str, Any], idx: np.ndarray) -> np.ndarray:
        """Rows for sorted global indices."""
        idx = np.sort(np.asarray(idx, np.int64))
        off, nl = owner["offset"], owner["n_local"]
        mine = idx[(idx >= off) & (idx < off + nl)] - off
        return owner["assemble"](owner["gather_local"](mine))

    @staticmethod
    def _seed_random(
        n_rows: int, k: int, rng: np.random.Generator, owner: Dict[str, Any]
    ) -> np.ndarray:
        idx = rng.choice(n_rows, size=k, replace=n_rows < k)
        return KMeans._gather_global(owner, idx)

    @staticmethod
    def _seed_scalable_kmeanspp(
        n_rows: int,
        k: int,
        steps: int,
        oversample: float,
        rng: np.random.Generator,
        owner: Dict[str, Any],
    ) -> np.ndarray:
        """k-means|| (Bahmani et al.): sample ~l=oversample*k candidates per
        round with prob l*d²/Σd², then reduce candidates to k centres with
        weighted k-means++ on host (the candidate set is small)."""
        l = max(int(oversample * k), 1)
        off, nl = owner["offset"], owner["n_local"]
        first = int(rng.integers(0, n_rows))
        cands = KMeans._gather_global(owner, np.asarray([first]))
        local_d2 = np.asarray(owner["min_d2_vs"](cands), np.float64)
        for _ in range(steps):
            total = float(owner["reduce_sum"](float(local_d2.sum())))
            if total <= 0:
                break
            r = KMeans._rng_slice(rng, n_rows, off, nl)
            sel = np.nonzero(r < np.minimum(l * local_d2 / total, 1.0))[0]
            new = owner["assemble"](owner["gather_local"](sel))
            if len(new) == 0:
                continue
            cands = np.concatenate([cands, new], axis=0)
            local_d2 = np.minimum(
                local_d2, np.asarray(owner["min_d2_vs"](new), np.float64)
            )
        if len(cands) < k:
            # not enough candidates — top up with random rows
            extra = KMeans._seed_random(n_rows, k - len(cands), rng, owner)
            return np.concatenate([cands, extra], axis=0)
        if len(cands) == k:
            return cands
        weights = np.asarray(owner["count_closest"](cands), np.float64)
        return _weighted_kmeanspp(cands.astype(np.float64), weights, k, rng)

    def _resident_owner(self, inputs: FitInputs) -> Dict[str, Any]:
        """Owner of all rows: valid rows are the first ``n_rows`` (padding
        sits at the end on one device)."""
        n = inputs.n_rows

        def gather_local(idx: np.ndarray) -> np.ndarray:
            if len(idx) == 0:
                return np.empty((0, inputs.n_features), np.float32)
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

    # ---- fit -------------------------------------------------------------
    def _get_fit_func(self, dataset: DataFrame) -> FitFunc:
        def _fit(inputs: FitInputs, params: Dict[str, Any]) -> Dict[str, Any]:
            k = int(params["n_clusters"])
            if k > inputs.n_rows:
                raise ValueError(f"k={k} must be <= number of rows {inputs.n_rows}")
            self._check_matmul_dtype(params)
            rng = np.random.default_rng(int(params.get("random_state") or 0))
            owner = self._resident_owner(inputs)
            if params.get("init") == "random":
                centers0 = self._seed_random(inputs.n_rows, k, rng, owner)
            else:
                centers0 = self._seed_scalable_kmeanspp(
                    inputs.n_rows, k, int(params.get("init_steps", 2)),
                    float(params.get("oversampling_factor", 2.0)), rng, owner,
                )
            centers, cost, n_iter = kmeans_lloyd(
                inputs.X,
                inputs.mask,
                torch.as_tensor(centers0, dtype=inputs.dtype, device=inputs.device),
                max_iter=int(params["max_iter"]),
                tol=float(params["tol"]),
            )
            return {
                "cluster_centers": centers.cpu().numpy(),
                "training_cost": float(cost),
                "n_iter": int(n_iter),
            }

        return _fit

    def _create_model(self, result: Dict[str, Any]) -> "KMeansModel":
        return KMeansModel(**result)


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
        """Single-vector predict through the transform function."""
        pred_col = self.getOrDefault("predictionCol")
        out = self._get_transform_func()(np.asarray(vector, dtype=np.float32).reshape(1, -1))
        return int(out[pred_col][0])

    def _get_transform_func(
        self, dataset: Optional[DataFrame] = None
    ) -> Callable[[np.ndarray], Dict[str, np.ndarray]]:
        pred_col = self.getOrDefault("predictionCol")
        device = resolve_device(self._device)

        def _build() -> Callable[[np.ndarray], Dict[str, np.ndarray]]:
            centers = torch.tensor(self.cluster_centers_, dtype=torch.float32, device=device)
            c_sq = (centers * centers).sum(dim=1)

            def _fn(Xb: np.ndarray) -> Dict[str, np.ndarray]:
                d2 = pairwise_sq_dists(torch.from_numpy(Xb).to(device), centers, c_sq)
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
