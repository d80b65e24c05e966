"""Fitted-model export to scikit-learn (counterpart of
``spark_rapids_ml_tpu/export.py``; the exporters are the same, line for
line, and read the port's models).

The reference's ``cpu()`` turns a fitted model into a stock Spark JVM model
that serves with the GPU gone (PCA at the reference's
``feature.py:365-379``, forests through ``tree.py:510-555``). Without Spark
the serving target is scikit-learn: each exporter builds a fitted sklearn
estimator whose ``predict`` / ``transform`` reproduces the port's transform
on the same inputs, so a model trained on the card outlives it (pickle it,
serve it wherever sklearn runs). sklearn is imported inside each exporter,
never when the port is imported.

Semantics
---------
* PCA follows Spark (no centring in ``transform``): the exported
  ``sklearn.decomposition.PCA`` gets ``mean_ = 0`` so that its ``transform``
  equals the port's; the fitted mean is kept as ``tpu_mean_``.
* Forest splits differ at equality: the port routes ``x >= thr`` right,
  sklearn routes ``x <= thr`` left. Exported thresholds are
  ``nextafter(thr, -inf)`` in float32, so both predicates agree for every
  float32 input.
* sklearn ≥ 1.4 keeps classifier tree values as per-node fractions, so the
  exported values are normalized class distributions, matching Spark's
  per-tree-normalized vote.
"""

from __future__ import annotations

from typing import Any, List

import numpy as np

__all__ = [
    "pca_to_sklearn",
    "kmeans_to_sklearn",
    "linear_regression_to_sklearn",
    "logistic_regression_to_sklearn",
    "random_forest_to_sklearn",
    "random_forest_packed",
    "to_sklearn",
]


def pca_to_sklearn(model: Any):
    """``PCAModel`` -> fitted ``sklearn.decomposition.PCA``."""
    from sklearn.decomposition import PCA

    comps = np.asarray(model.components_, dtype=np.float64)
    k, d = comps.shape
    out = PCA(n_components=k)
    out.components_ = comps
    out.explained_variance_ = np.asarray(model.explained_variance_, np.float64)
    out.explained_variance_ratio_ = np.asarray(
        model.explained_variance_ratio_, np.float64
    )
    out.singular_values_ = np.asarray(model.singular_values_, np.float64)
    # Spark-convention transform does not center; sklearn's subtracts mean_.
    out.mean_ = np.zeros(d, dtype=np.float64)
    out.tpu_mean_ = np.asarray(model.mean_, np.float64)
    out.n_components_ = k
    out.n_features_in_ = d
    out.n_samples_ = max(int(getattr(model, "n_rows_fit_", 0) or 0), k)
    out.noise_variance_ = 0.0
    out.whiten = False
    return out


def kmeans_to_sklearn(model: Any):
    """``KMeansModel`` -> fitted ``sklearn.cluster.KMeans``."""
    from sklearn.cluster import KMeans

    centers = np.asarray(model.cluster_centers_, dtype=np.float64)
    k, d = centers.shape
    out = KMeans(n_clusters=k, n_init=1)
    out.cluster_centers_ = centers
    out.n_features_in_ = d
    out.inertia_ = float(model.trainingCost)
    out.n_iter_ = int(model.numIter)
    out.labels_ = np.zeros(0, dtype=np.int32)
    out._n_threads = 1
    return out


def linear_regression_to_sklearn(model: Any):
    """``LinearRegressionModel`` -> fitted ``sklearn.linear_model.LinearRegression``."""
    from sklearn.linear_model import LinearRegression

    coef = np.asarray(model.coefficients, dtype=np.float64).ravel()
    out = LinearRegression()
    out.coef_ = coef
    out.intercept_ = float(model.intercept)
    out.n_features_in_ = coef.shape[0]
    out.rank_ = coef.shape[0]
    return out


def logistic_regression_to_sklearn(model: Any):
    """``LogisticRegressionModel`` -> fitted ``sklearn.linear_model.LogisticRegression``.

    Binary models export the (1, d) sigmoid parameterization sklearn uses.
    A softmax-parameterized 2-class fit (``family='multinomial'``) is
    collapsed exactly: ``sigmoid(w1-w0, b1-b0)`` equals the 2-way softmax.
    """
    from sklearn.linear_model import LogisticRegression

    coef = np.atleast_2d(np.asarray(model.coef_, dtype=np.float64))
    intercept = np.atleast_1d(np.asarray(model.intercept_, dtype=np.float64))
    n_classes = int(model.numClasses)
    if n_classes == 2 and coef.shape[0] == 2:
        coef = (coef[1] - coef[0])[None, :]
        intercept = np.asarray([intercept[1] - intercept[0]])
    out = LogisticRegression()
    out.coef_ = coef
    out.intercept_ = intercept
    out.classes_ = np.arange(n_classes, dtype=np.float64)
    out.n_features_in_ = coef.shape[1]
    out.n_iter_ = np.asarray([int(getattr(model, "n_iter_", 0))])
    return out


def _compact_tree(
    feat: np.ndarray,       # (M,) int32, heap layout, -1 = leaf
    thr: np.ndarray,        # (M,) float32 raw thresholds (x >= thr -> right)
    counts: np.ndarray,     # (M,) rows behind each node
    values: np.ndarray,     # (M, V) per-node output values (already final)
    impurity: np.ndarray,   # (M,)
    max_depth: int,
    n_features: int,
):
    """Heap-layout node arrays -> a fitted ``sklearn.tree._tree.Tree``.

    Walks the reachable nodes in preorder (sklearn's native layout),
    re-indexing heap children ``2i+1 / 2i+2`` to compact ids.
    """
    from sklearn.tree._tree import NODE_DTYPE, Tree

    order: List[int] = []      # heap index per compact node
    stack = [0]
    while stack:
        i = stack.pop()
        order.append(i)
        if feat[i] >= 0:
            # preorder: left first (LIFO stack -> push right first)
            stack.append(2 * i + 2)
            stack.append(2 * i + 1)
    compact = {h: c for c, h in enumerate(order)}
    n_nodes = len(order)
    V = values.shape[1]

    nodes = np.zeros(n_nodes, dtype=NODE_DTYPE)
    vals = np.zeros((n_nodes, 1, V), dtype=np.float64)
    for c, h in enumerate(order):
        is_split = feat[h] >= 0
        nodes[c]["left_child"] = compact[2 * h + 1] if is_split else -1
        nodes[c]["right_child"] = compact[2 * h + 2] if is_split else -1
        nodes[c]["feature"] = int(feat[h]) if is_split else -2
        # ours: left iff x < thr (f32); sklearn: left iff x <= t. The
        # largest f32 strictly below thr makes the predicates identical
        # for every f32 input.
        nodes[c]["threshold"] = (
            float(np.nextafter(np.float32(thr[h]), np.float32(-np.inf)))
            if is_split
            else -2.0
        )
        nodes[c]["impurity"] = float(impurity[h])
        nodes[c]["n_node_samples"] = int(round(float(counts[h])))
        nodes[c]["weighted_n_node_samples"] = float(counts[h])
        if "missing_go_to_left" in nodes.dtype.names:  # sklearn >= 1.3
            nodes[c]["missing_go_to_left"] = 0
        vals[c, 0, :] = values[h]

    tree = Tree(n_features, np.asarray([V], dtype=np.intp), 1)
    tree.__setstate__(
        {
            "max_depth": int(max_depth),
            "node_count": n_nodes,
            "nodes": nodes,
            "values": vals,
        }
    )
    return tree


def random_forest_to_sklearn(model: Any):
    """``RandomForest{Classification,Regression}Model`` -> fitted sklearn forest."""
    from sklearn.ensemble import RandomForestClassifier, RandomForestRegressor
    from sklearn.tree import DecisionTreeClassifier, DecisionTreeRegressor

    feat = model._features_arr          # (T, M)
    thr = model._thresholds_arr         # (T, M)
    ls = model._leaf_stats_arr          # (T, M, S)
    depth = model._max_depth_built
    d = model.numFeatures
    n_classes = int(model._model_attributes["n_classes"])
    is_cls = n_classes > 0
    T = feat.shape[0]

    if is_cls:
        counts = ls.sum(axis=2)                                       # (T, M)
        tot = np.maximum(counts, 1e-12)[:, :, None]
        values = (ls / tot).astype(np.float64)                        # fractions
        p = ls / tot
        try:
            criterion = model.getOrDefault("impurity")
        except Exception:
            criterion = "gini"
        if criterion == "entropy":
            with np.errstate(divide="ignore", invalid="ignore"):
                impurity = -np.where(p > 0, p * np.log2(p), 0.0).sum(axis=2)
        else:
            impurity = 1.0 - (p * p).sum(axis=2)                      # gini
        forest = RandomForestClassifier(
            n_estimators=T, max_depth=depth, criterion=criterion
        )
        forest.classes_ = np.arange(n_classes, dtype=np.float64)
        forest.n_classes_ = n_classes
        mk = lambda: DecisionTreeClassifier(  # noqa: E731
            max_depth=depth, criterion=criterion
        )
        V = n_classes
    else:
        counts = ls[:, :, 0]
        safe = np.maximum(counts, 1e-12)
        mean = ls[:, :, 1] / safe
        values = mean[:, :, None].astype(np.float64)
        impurity = np.maximum(ls[:, :, 2] / safe - mean * mean, 0.0)  # variance
        forest = RandomForestRegressor(n_estimators=T, max_depth=depth)
        mk = lambda: DecisionTreeRegressor(max_depth=depth)  # noqa: E731
        V = 1

    estimators = []
    for t in range(T):
        est = mk()
        est.tree_ = _compact_tree(
            feat[t], thr[t], counts[t], values[t], impurity[t], depth, d
        )
        est.n_features_in_ = d
        est.n_outputs_ = 1
        if is_cls:
            est.classes_ = forest.classes_
            est.n_classes_ = n_classes
        estimators.append(est)

    forest.estimators_ = estimators
    forest.estimator_ = mk()
    forest.n_features_in_ = d
    forest.n_outputs_ = 1
    return forest


def random_forest_packed(model: Any) -> dict:
    """The packed layout of a fitted forest (``ops.rf_kernels.pack_forest``),
    as plain numpy: the tables the packed transform engine (kernel K9)
    walks, breadth-first interleaved, padded to whole tree groups, split
    into two hops at ``k1``. It is packed at most once a model (kept in its
    attributes and saved with it). Keys:

    * ``feat1`` / ``thr1``: ``(T_pad, 2^k1 - 1)`` int32 hop-1 heap levels
      (feature id / bin threshold; ``feat < 0`` marks leaves);
    * ``feat2`` / ``thr2``: ``(T_pad * 2^k1, 64)`` int32 hop-2 subtrees, one
      64-lane row per hop-1 exit (``(0, 64)`` where hop 1 reaches every
      leaf);
    * ``meta``: ``{"n_trees", "k1", "k2", "max_depth"}``; ``n_trees`` is the
      real tree count, rows of ``feat1`` beyond it are all-leaf padding.
    """
    from .models.tree import _RandomForestModel

    if not isinstance(model, _RandomForestModel):
        raise TypeError(f"expected a RandomForest model, got {type(model).__name__}")
    if model._model_attributes.get("threshold_bins") is None:
        raise ValueError(
            "model predates bin-space tables (pre-round-5 save); "
            "re-fit to obtain the packed layout"
        )
    pf = model._ensure_packed()
    return {
        "feat1": np.asarray(pf.feat1),
        "thr1": np.asarray(pf.thr1),
        "feat2": np.asarray(pf.feat2),
        "thr2": np.asarray(pf.thr2),
        "meta": {
            "n_trees": pf.n_trees,
            "k1": pf.k1,
            "k2": pf.k2,
            "max_depth": pf.max_depth,
        },
    }


def to_sklearn(model: Any):
    """Dispatch a fitted model to its sklearn exporter by family."""
    from .models.classification import LogisticRegressionModel
    from .models.clustering import KMeansModel
    from .models.feature import PCAModel
    from .models.regression import LinearRegressionModel
    from .models.tree import _RandomForestModel

    if isinstance(model, PCAModel):
        return pca_to_sklearn(model)
    if isinstance(model, KMeansModel):
        return kmeans_to_sklearn(model)
    if isinstance(model, LinearRegressionModel):
        return linear_regression_to_sklearn(model)
    if isinstance(model, LogisticRegressionModel):
        return logistic_regression_to_sklearn(model)
    if isinstance(model, _RandomForestModel):
        return random_forest_to_sklearn(model)
    raise TypeError(f"no sklearn exporter for {type(model).__name__}")
