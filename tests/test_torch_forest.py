"""The port's RandomForest slice held against the JAX package on the CPU:
the tree-batched builder (fed the JAX package's own random draws) against
the sequential ``_build_tree`` on the compact Pallas route, the estimators
end to end, the raw-threshold engine of deep forests, and persistence.

Exactness: classification stats are integer counts, and so are the
variance stats of integer labels, so histograms, splits and leaf stats are
equal whatever the summation order. Gains are compared at rtol 1e-6 where
the JAX package computes them in a compiled program: XLA's fusion rounds
the impurity arithmetic differently (the eager builder's gains are equal).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import spark_rapids_ml_tpu.ops.rf_pallas as rfp
import spark_rapids_ml_tpu.ops.tree_kernels as tk
from spark_rapids_ml_tpu.classification import RandomForestClassifier as JRFC
from spark_rapids_ml_tpu.data import DataFrame as JDataFrame
from spark_rapids_ml_tpu.regression import RandomForestRegressor as JRFR
from spark_rapids_ml_tpu_torch import DataFrame as TDataFrame
from spark_rapids_ml_tpu_torch import RandomForestClassifier, RandomForestRegressor, interop
from spark_rapids_ml_tpu_torch.classification import RandomForestClassificationModel
from spark_rapids_ml_tpu_torch.ops import tree_kernels as pt


class JaxDraws:
    """The draws of the JAX package's ``_build_tree(key)``: Poisson(1)
    counts from ``kb`` and per-level uniforms from ``fold_in(kf, level)``,
    ``kb, kf = split(key)``."""

    def __init__(self, keys):
        self.kk = [jax.random.split(k) for k in keys]

    def bootstrap(self, t, n):
        return np.asarray(jax.random.poisson(self.kk[t][0], 1.0, (n,))).astype(np.float32)

    def feature_uniforms(self, t, level, n_nodes, n_features):
        return np.asarray(jax.random.uniform(jax.random.fold_in(self.kk[t][1], level), (n_nodes, n_features)))


def _data(seed=0, n=600, d=16, nb=32):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    edges = tk.make_bin_edges(X, nb)
    bins = np.asarray(tk.binize(jnp.asarray(X), jnp.asarray(edges), d_pad=tk.next_pow2(d)))
    y = (X[:, 0] + 0.5 * X[:, 3] > 0).astype(np.int64)
    cls = np.eye(2, dtype=np.float32)[y]
    # integer labels 0..9 driven by two features: exact variance stats
    yi = np.clip(np.round(2 * X[:, 1] + X[:, 2] + 4.5), 0, 9).astype(np.float32)
    reg = np.stack([np.ones_like(yi), yi, yi * yi], 1).astype(np.float32)
    return bins, cls, reg


@pytest.mark.parametrize(
    "impurity,d,k,bootstrap,fused",
    [
        ("gini", 16, 16, True, False),     # no subset
        ("gini", 128, 11, True, False),    # subset, k_pad = 16 with 5 sentinels
        ("gini", 128, 11, False, True),    # K6: fused selection
        ("variance", 16, 4, True, False),  # integer labels
    ],
)
def test_builder_matches_build_tree(monkeypatch, impurity, d, k, bootstrap, fused):
    # the JAX builder runs eagerly here (its arithmetic is then the port's
    # op for op): each new shape compiles, so the variance case (S = 3)
    # stays one level shallower
    monkeypatch.setattr(rfp, "FORCE_INTERPRET", True)
    if fused:
        monkeypatch.setattr(tk, "_SEL_MIN_DPAD", 0)
        monkeypatch.setattr(pt, "_SEL_MIN_DPAD", 0)
    calls = []
    route = pt.node_hist_sel_batched if fused else pt.node_hist_batched
    monkeypatch.setattr(
        pt, route.__name__, lambda *a, **kw: calls.append(1) or route(*a, **kw)
    )
    bins, cls, reg = _data(d=d)
    stats = cls if impurity == "gini" else reg
    n = bins.shape[0]
    valid = np.ones(n, np.float32)
    valid[-40:] = 0.0  # padding rows: weight 0, logical-row draws
    base = dict(max_depth=4 if impurity == "gini" else 3, n_bins=32, n_features=d, n_stats=stats.shape[1], impurity=impurity,
                k_features=k, min_samples_leaf=1, min_info_gain=0.0, min_samples_split=2,
                bootstrap=bootstrap)
    keys = jax.random.split(jax.random.PRNGKey(7), 2)
    ref = [tk._build_tree(jnp.asarray(bins), jnp.asarray(stats), jnp.asarray(valid), kk,
                          tk.ForestConfig(hist_strategy="compact", **base)) for kk in keys]
    got = pt._build_trees_batched(torch.from_numpy(bins), torch.from_numpy(stats), torch.from_numpy(valid),
                                  [0, 1], JaxDraws(keys), pt.ForestConfig(**base))
    assert calls, "the port's kernel route never ran"
    for t, r in enumerate(ref):
        for field in ("feature", "threshold_bin", "leaf_stats"):
            np.testing.assert_array_equal(got[field][t].numpy(), np.asarray(r[field]), err_msg=f"tree {t} {field}")
        np.testing.assert_allclose(got["gain"][t].numpy(), np.asarray(r["gain"]), rtol=1e-6)
    assert (got["feature"] >= 0).sum() > 8


def test_builder_scatter_route_matches_compact(monkeypatch):
    """A level past the compact route's tile bound takes the plain
    scatter: the same trees."""
    bins, cls, _ = _data(d=16)
    cfg = pt.ForestConfig(max_depth=5, n_bins=32, n_features=16, n_stats=2, impurity="gini", k_features=5,
                          min_samples_leaf=2, min_info_gain=0.0, min_samples_split=2, bootstrap=True)
    args = (torch.from_numpy(bins), torch.from_numpy(cls), torch.ones(bins.shape[0]), [0, 1, 2], pt.TorchDraws(3), cfg)
    a = pt._build_trees_batched(*args)
    monkeypatch.setattr(pt, "_COMPACT_TILE_MAX", 0)
    monkeypatch.setattr(pt, "_hist_compact_batched", lambda *x, **kw: pytest.fail("compact route taken"))
    b = pt._build_trees_batched(*args)
    for f in ("feature", "threshold_bin", "leaf_stats", "gain"):
        np.testing.assert_array_equal(a[f].numpy(), b[f].numpy(), err_msg=f)


def test_torch_draws_do_not_depend_on_batching():
    bins, cls, _ = _data(d=16)
    cfg = pt.ForestConfig(max_depth=4, n_bins=32, n_features=16, n_stats=2, impurity="gini", k_features=4,
                          min_samples_leaf=1, min_info_gain=0.0, min_samples_split=2, bootstrap=True)
    args = (torch.from_numpy(bins), torch.from_numpy(cls), torch.ones(bins.shape[0]))
    whole = pt._build_trees_batched(*args, [0, 1, 2], pt.TorchDraws(11), cfg)
    one = pt._build_trees_batched(*args, [1], pt.TorchDraws(11), cfg)
    for f in ("feature", "threshold_bin", "leaf_stats", "gain"):
        np.testing.assert_array_equal(whole[f][1].numpy(), one[f][0].numpy())
    other = pt._build_trees_batched(*args, [1], pt.TorchDraws(12), cfg)
    assert not np.array_equal(other["feature"].numpy(), one["feature"].numpy())


def _cls_frame(seed=0, n=700, d=12):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = ((X[:, 0] + 0.6 * X[:, 3] + 0.3 * rng.normal(size=n)) > 0).astype(np.float32)
    y[X[:, 5] > 1.2] = 2.0
    return X, y


def _hold_fits(jm, tm):
    for k in ("features", "threshold_bins", "thresholds", "leaf_stats", "bin_edges"):
        np.testing.assert_array_equal(np.asarray(tm._model_attributes[k]), np.asarray(jm._model_attributes[k]),
                                      err_msg=k)
    # the JAX package's gains come out of a compiled program whose fused
    # arithmetic rounds differently; variance impurities (s2/n - mean^2)
    # cancel, so a small gain carries the rounding of its node's second
    # moment: held to 1e-5 of the largest gain besides rtol 1e-6
    ref = np.asarray(jm._model_attributes["gains"])
    np.testing.assert_allclose(tm._model_attributes["gains"], ref, rtol=1e-6, atol=1e-5 * np.abs(ref).max())
    assert tm._model_attributes["n_classes"] == jm._model_attributes["n_classes"]
    assert tm._model_attributes["num_features"] == jm._model_attributes["num_features"]


def test_classifier_matches_jax_end_to_end(monkeypatch, tmp_path):
    """No randomness (no bootstrap, all features): the same forest, and
    transform equal to the JAX package's packed engine (Pallas traversal
    in interpret mode); a JAX-saved model (with its packed tables) loads
    into the port and transforms the same; a port-saved model round-trips."""
    monkeypatch.setattr(rfp, "FORCE_INTERPRET", True)
    monkeypatch.setenv("TPUML_RF_APPLY", "packed")
    X, y = _cls_frame()
    kw = dict(numTrees=3, maxDepth=8, maxBins=32, bootstrap=False, featureSubsetStrategy="all", seed=5)
    try:
        jm = JRFC(num_workers=1, **kw).fit(JDataFrame({"features": X, "label": y}))
        jout = jm.transform(JDataFrame({"features": X}))
        path = str(tmp_path / "jax_rf")
        jm.write().save(path)
    finally:
        jax.clear_caches()
    tm = RandomForestClassifier(device="cpu", **kw).fit(TDataFrame({"features": X, "label": y}))
    _hold_fits(jm, tm)
    assert tm._resolve_transform_engine() == "packed" and tm._ensure_packed().k2 == 1
    tout = tm.transform(TDataFrame({"features": X}))
    cols = ("prediction", "probability", "rawPrediction")
    for c in cols:
        np.testing.assert_array_equal(tout.column(c), np.asarray(jout.column(c)), err_msg=c)
    assert (tout.column("prediction") == y).mean() > 0.9

    lm = interop.load_jax_model(path, device="cpu")
    assert isinstance(lm, RandomForestClassificationModel)
    assert lm._model_attributes.get("packed_feat1") is not None
    for c in cols:
        np.testing.assert_array_equal(lm.transform(TDataFrame({"features": X})).column(c),
                                      np.asarray(jout.column(c)), err_msg=c)

    ppath = str(tmp_path / "port_rf")
    tm.write().save(ppath)
    rm = RandomForestClassificationModel.load(ppath)
    rm.setDevice("cpu")
    monkeypatch.setattr(pt, "pack_forest", lambda *a, **k: pytest.fail("a saved model packed again"))
    for c in cols:
        np.testing.assert_array_equal(rm.transform(TDataFrame({"features": X})).column(c), tout.column(c))
    x0 = X[3]
    assert rm.predict(x0) == tout.column("prediction")[3]
    np.testing.assert_array_equal(rm.predictProbability(x0), tout.column("probability")[3])
    np.testing.assert_array_equal(rm.predictRaw(x0), tout.column("rawPrediction")[3])
    np.testing.assert_allclose(rm.featureImportances, tm.featureImportances)
    assert rm.totalNumNodes == tm.totalNumNodes and len(rm.trees) == 3


def test_regressor_matches_jax_end_to_end(monkeypatch):
    """Integer labels driven by two features: exact variance stats, the
    same forest and the same packed-engine predictions."""
    monkeypatch.setattr(rfp, "FORCE_INTERPRET", True)
    monkeypatch.setenv("TPUML_RF_APPLY", "packed")
    rng = np.random.default_rng(2)
    X = rng.normal(size=(600, 8)).astype(np.float32)
    y = (np.where(X[:, 0] > 0.3, 6, 1) + np.where(X[:, 2] > -0.5, 3, 0)).astype(np.float32)
    kw = dict(numTrees=2, maxDepth=8, maxBins=32, bootstrap=False, featureSubsetStrategy="all", seed=1)
    try:
        jm = JRFR(num_workers=1, **kw).fit(JDataFrame({"features": X, "label": y}))
        jp = np.asarray(jm.transform(JDataFrame({"features": X})).column("prediction"))
    finally:
        jax.clear_caches()
    tm = RandomForestRegressor(device="cpu", **kw).fit(TDataFrame({"features": X, "label": y}))
    _hold_fits(jm, tm)
    tp = tm.transform(TDataFrame({"features": X})).column("prediction")
    np.testing.assert_array_equal(tp, jp)
    assert np.abs(tp - y).max() < 1e-5


def test_deep_forest_raw_threshold_engine():
    """A depth-15 forest (past the packed layout) without bin tables, as a
    JAX model carries it, transforms through the raw-threshold descent:
    equal to the JAX package's ``rf_classify`` / ``rf_regress``."""
    rng = np.random.default_rng(15)
    T, depth, d, n = 3, 15, 6, 400
    M = pt.max_nodes(depth)
    # full to depth 15, a tenth of the nodes below level 6 turned into
    # early leaves (and their subtrees with them)
    feat = rng.integers(0, d, size=(T, M)).astype(np.int32)
    early = rng.random((T, M)) < 0.1
    for i in range(M):
        if i >= (1 << depth) - 1 or (i >= 63 and early[:, i].any()):
            feat[early[:, i] | (i >= (1 << depth) - 1), i] = -1
        if i > 0:
            feat[feat[:, (i - 1) // 2] < 0, i] = -1
    thr = rng.normal(size=(T, M)).astype(np.float32)
    leaf = rng.integers(0, 20, size=(T, M, 3)).astype(np.float32)
    X = rng.normal(size=(n, d)).astype(np.float32)
    attrs = {"features": feat, "thresholds": thr, "leaf_stats": leaf, "gains": np.zeros((T, M), np.float32),
             "n_classes": 3, "num_features": d}
    tm = interop.from_jax_attributes("RandomForestClassificationModel", attrs, device="cpu")
    assert tm._resolve_transform_engine() == "legacy"
    out = tm.transform(TDataFrame({"features": X}))
    leafp = (leaf / np.maximum(leaf.sum(2, keepdims=True), 1e-12)).astype(np.float32)
    jpred, jprob, jraw = tk.rf_classify(jnp.asarray(X), jnp.asarray(feat), jnp.asarray(thr), jnp.asarray(leafp),
                                        max_depth=depth)
    leaves = tk.forest_apply(jnp.asarray(X), jnp.asarray(feat), jnp.asarray(thr), max_depth=depth)
    assert int(np.asarray(leaves).max()) >= (1 << 14) - 1, "no row reached depth 14"
    np.testing.assert_array_equal(out.column("rawPrediction"), np.asarray(jraw))
    np.testing.assert_array_equal(out.column("probability"), np.asarray(jprob))
    np.testing.assert_array_equal(out.column("prediction"), np.asarray(jpred))

    rattrs = dict(attrs, n_classes=0)
    rm = interop.from_jax_attributes("RandomForestRegressionModel", rattrs, device="cpu")
    means = (leaf[:, :, 1] / np.maximum(leaf[:, :, 0], 1e-12)).astype(np.float32)
    jr = np.asarray(tk.rf_regress(jnp.asarray(X), jnp.asarray(feat), jnp.asarray(thr), jnp.asarray(means),
                                  max_depth=depth))
    np.testing.assert_array_equal(rm.transform(TDataFrame({"features": X})).column("prediction"), jr)


def test_fit_surface_and_errors():
    X, y = _cls_frame(n=300)
    df = TDataFrame({"features": X, "label": y})
    m = RandomForestClassifier(numTrees=4, maxDepth=3, seed=2, device="cpu").fit(df)
    assert m.getNumTrees() == 4 and m.numClasses == 3 and m.numFeatures == 12
    assert abs(m.featureImportances.sum() - 1.0) < 1e-6
    Xbad = X.copy()
    Xbad[3, 2] = np.nan
    with pytest.raises(ValueError, match="NaN/Inf"):
        RandomForestClassifier(numTrees=2, maxDepth=3, device="cpu").fit(TDataFrame({"features": Xbad, "label": y}))
    with pytest.raises(RuntimeError, match="non-negative integers"):
        RandomForestClassifier(numTrees=2, device="cpu").fit(TDataFrame({"features": X, "label": y - 0.5}))
    with pytest.raises(ValueError, match="not supported"):
        RandomForestClassifier(weightCol="w")
    with pytest.raises(ValueError, match="Unsupported impurity"):
        RandomForestRegressor(impurity="gini")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            RandomForestRegressor(numTrees=2).fit(TDataFrame({"features": X, "label": y}))
