"""The port's gradient-boosted trees held against the JAX package on the
CPU: one boosting round (``gbt_round``), the estimators end to end, a
JAX-saved model carried into the port, and the estimator surface.

Tolerances. Split decisions (``feature``, ``threshold_bin``) must be
equal. Stats and values are real-valued f32 sums that the two packages
add in different orders (the port in row order, the JAX package through
its compiled scatter), and XLA's fused arithmetic rounds the leaf
division and the margin update in other places. Two f32 sums of n terms
in different orders differ by about u·√n of their absolute terms (u =
2^-24, a random walk of roundings), and each round feeds the next through
the margins: so stats, values and margins are held to 4·u·√n per round,
relative to each entry plus the largest entry of its stat slot (a node's
gradient sum cancels, at the root of a fresh round to ~0, so its error is
set by its terms, not by its value). Transformed columns of one fitted
model through the port's engines and the JAX package's bins engine are
integer leaf lookups and the same f32 sums in the same order: equal bit
for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import spark_rapids_ml_tpu.ops.gbt_kernels as jgbt
import spark_rapids_ml_tpu.ops.rf_pallas as rfp
import spark_rapids_ml_tpu.ops.tree_kernels as tk
from spark_rapids_ml_tpu.classification import GBTClassifier as JGBTC
from spark_rapids_ml_tpu.data import DataFrame as JDataFrame
from spark_rapids_ml_tpu.parallel.mesh import make_mesh
from spark_rapids_ml_tpu.regression import GBTRegressor as JGBTR
from spark_rapids_ml_tpu_torch import DataFrame as TDataFrame
from spark_rapids_ml_tpu_torch import GBTClassifier, GBTRegressor, interop
from spark_rapids_ml_tpu_torch.classification import GBTClassificationModel
from spark_rapids_ml_tpu_torch.ops import gbt_kernels as pgbt
from spark_rapids_ml_tpu_torch.ops import tree_kernels as pt
from spark_rapids_ml_tpu_torch.regression import GBTRegressionModel


def _rtol(n, rounds):
    return 4 * 2.0 ** -24 * np.sqrt(n) * rounds


def _close(got, ref, rtol):
    """|got - ref| < rtol·(|ref| + the largest |entry| of ref's stat slot:
    the last axis of a (trees, nodes, slots) table, else the whole array)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = np.abs(ref).max(axis=(0, 1)) if ref.ndim == 3 else np.abs(ref).max()
    np.testing.assert_array_less(np.abs(got - ref), rtol * (np.abs(ref) + scale) + 1e-30)


def _data(kind, seed=0, n=2000, d=16):
    """Features and labels with decisive splits: a noisy hyperplane
    (binary), the argmax of three noisy linear scores (3 classes), steps
    plus a slope (regression)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    if kind == "logistic":
        y = (1.6 * X[:, 0] - 1.1 * X[:, 3] + 0.3 * rng.normal(size=n)) > 0
    elif kind == "multinomial":
        y = (X @ rng.normal(size=(d, 3)) + 0.3 * rng.gumbel(size=(n, 3))).argmax(1)
    else:
        y = 3.0 * (X[:, 0] > 0) + 2.0 * (X[:, 1] > 0.5) - 1.5 * (X[:, 2] < -0.3) + X[:, 3] + 0.1 * rng.normal(size=n)
    return X, y.astype(np.float32)


@pytest.mark.parametrize("loss,n_out", [("squared", 1), ("logistic", 1), ("multinomial", 3)])
def test_gbt_round_matches_jax(loss, n_out):
    """One round from the same bins, margins and labels: the same trees,
    the same stats, values and new margins (4·u·√n), and the same loss."""
    X, y = _data(loss, n=1500)
    n, d = X.shape
    edges = tk.make_bin_edges(X, 32)
    bins = np.array(tk.binize(jnp.asarray(X), jnp.asarray(edges), d_pad=d))
    mask = np.ones(n, np.float32)
    mask[-40:] = 0.0                      # padding rows: no weight, no margin change
    marg = (0.5 * np.random.default_rng(1).normal(size=(n, n_out))).astype(np.float32)
    tree = dict(max_depth=4, n_bins=32, n_features=d, n_stats=3 if loss == "squared" else 4,
                impurity="variance", k_features=d, min_samples_leaf=1, min_info_gain=0.0,
                min_samples_split=2, bootstrap=False)
    jcfg = jgbt.GBTConfig(loss=loss, n_out=n_out, learning_rate=0.3, tree=tk.ForestConfig(**tree))
    mesh = make_mesh(1)
    ref = jgbt.gbt_round(jnp.asarray(bins), jnp.asarray(mask), jnp.asarray(y), jnp.asarray(marg),
                         jax.random.PRNGKey(0), mesh=mesh, cfg=jcfg)
    cfg = pgbt.GBTConfig(loss=loss, n_out=n_out, learning_rate=0.3, tree=pt.ForestConfig(**tree))
    tb, tm, ty, tmarg = (torch.from_numpy(a) for a in (bins, mask, y, marg))
    got = pgbt.gbt_round(tb, tm, ty, tmarg, cfg=cfg, trees=list(range(n_out)), draws=pt.TorchDraws(0))
    for k in ("feature", "threshold_bin"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    assert (got["feature"] >= 0).sum() >= 10 * n_out
    for k in ("leaf_stats", "values", "gain", "margins"):
        _close(got[k].numpy(), ref[k], _rtol(n, 1))
    np.testing.assert_array_equal(got["margins"][-40:].numpy(), marg[-40:])
    for m in (tmarg, got["margins"]):
        lt = float(pgbt.gbt_loss(ty, m, tm, loss=loss))
        lj = float(jgbt.gbt_loss(jnp.asarray(y), jnp.asarray(m.numpy()), jnp.asarray(mask), mesh=mesh, loss=loss))
        assert abs(lt - lj) <= _rtol(n, 1) * abs(lj)
    assert float(pgbt.gbt_loss(ty, got["margins"], tm, loss=loss)) < float(pgbt.gbt_loss(ty, tmarg, tm, loss=loss))


@pytest.mark.parametrize("loss", ["logistic", "multinomial", "squared"])
def test_estimators_match_jax(loss):
    """Both packages fit the same data (maxIter 5, maxDepth 4, all
    features: no draws): equal tables, leaf values and margins within
    4·u·√n per round, equal predictions."""
    X, y = _data(loss)
    kw = dict(maxIter=5, maxDepth=4, seed=1)
    JEst, TEst = (JGBTR, GBTRegressor) if loss == "squared" else (JGBTC, GBTClassifier)
    jm = JEst(num_workers=1, **kw).fit(JDataFrame({"features": X, "label": y}))
    tm = TEst(device="cpu", **kw).fit(TDataFrame({"features": X, "label": y}))
    ja, ta = jm._model_attributes, tm._model_attributes
    for k in ("features", "threshold_bins", "thresholds", "bin_edges", "init_margin"):
        np.testing.assert_array_equal(ta[k], np.asarray(ja[k]), err_msg=k)
    for k in ("n_classes", "num_features", "n_rounds", "loss", "learning_rate"):
        assert ta[k] == ja[k], k
    tol = _rtol(X.shape[0], 5)
    for k in ("leaf_values", "leaf_stats", "gains"):
        _close(ta[k], ja[k], tol)
    jout = jm.transform(JDataFrame({"features": X}))
    tout = tm.transform(TDataFrame({"features": X}))
    np.testing.assert_array_equal(tout.column("prediction"), np.asarray(jout.column("prediction")))
    margin = "prediction" if loss == "squared" else "rawPrediction"
    _close(tout.column(margin), jout.column(margin), tol)
    if loss == "squared":
        assert 1 - ((tout.column("prediction") - y) ** 2).mean() / y.var() > 0.5
    else:
        assert (tout.column("prediction") == y).mean() > 0.75
        np.testing.assert_allclose(tout.column("probability").sum(1), 1.0, atol=1e-6)
    assert tm.getNumTrees() == 5 * (3 if loss == "multinomial" else 1)


def test_cross_load_jax_saved_gbt(monkeypatch, tmp_path):
    """A JAX-fitted depth-8 GBT (hop 2 runs) carried into the port gives the
    JAX bins engine's columns bit for bit through the port's packed and
    bins engines: a 3-class classifier saved to disk (with its ``packed_*``
    tables, made by one packed transform), a regressor in memory."""
    monkeypatch.setattr(rfp, "FORCE_INTERPRET", True)
    X, y = _data("multinomial", n=600)
    Xr, yr = _data("squared", n=600)
    cols = ("prediction", "probability", "rawPrediction")
    try:
        jm = JGBTC(num_workers=1, maxIter=3, maxDepth=8, seed=2).fit(JDataFrame({"features": X, "label": y}))
        jm._apply_batched(jm._get_tpu_transform_func(engine="packed"), X)
        jbins = jm._apply_batched(jm._get_tpu_transform_func(engine="bins"), X)
        path = str(tmp_path / "jax_gbt")
        jm.write().save(path)
        jr = JGBTR(num_workers=1, maxIter=3, maxDepth=9, seed=2).fit(JDataFrame({"features": Xr, "label": yr}))
        jrbins = jr._apply_batched(jr._get_tpu_transform_func(engine="bins"), Xr)
        jr_params = {p.name: jr.getOrDefault(p) for p in jr.params if jr.isSet(p)}
    finally:
        jax.clear_caches()

    lm = interop.load_jax_model(path, device="cpu")
    assert isinstance(lm, GBTClassificationModel) and lm.numClasses == 3 and lm.getNumTrees() == 9
    assert lm._model_attributes.get("packed_feat1") is not None and lm._ensure_packed().k2 == 1
    out = lm.transform(TDataFrame({"features": X}))
    bins = lm._apply_batched(lm._get_transform_func(engine="bins"), X)
    for c in cols:
        np.testing.assert_array_equal(out.column(c), np.asarray(jbins[c]), err_msg=c)
        np.testing.assert_array_equal(bins[c], np.asarray(jbins[c]), err_msg=c)

    rm = interop.from_jax_attributes("GBTRegressionModel", jr._get_model_attributes(), jr_params, device="cpu")
    assert isinstance(rm, GBTRegressionModel) and rm.getMaxDepth() == 9
    for engine in ("packed", "bins"):
        got = rm._apply_batched(rm._get_transform_func(engine=engine), Xr)["prediction"]
        np.testing.assert_array_equal(got, np.asarray(jrbins["prediction"]), err_msg=engine)


def test_save_load_round_trip(monkeypatch, tmp_path):
    X, y = _data("logistic", n=500)
    df = TDataFrame({"features": X, "label": y})
    m = GBTClassifier(maxIter=4, maxDepth=8, seed=3, device="cpu").fit(df)
    out = m.transform(df)
    path = str(tmp_path / "gbt")
    m.write().save(path)
    lm = GBTClassificationModel.load(path).setDevice("cpu")
    monkeypatch.setattr(pt, "pack_forest", lambda *a, **k: pytest.fail("a saved model packed again"))
    for c in ("prediction", "probability", "rawPrediction"):
        np.testing.assert_array_equal(lm.transform(df).column(c), out.column(c))
    assert lm.getNumRounds() == 4 and lm.getNumTrees() == 4 and lm.numClasses == 2
    x0 = X[5]
    assert lm.predict(x0) == out.column("prediction")[5]
    np.testing.assert_array_equal(lm.predictProbability(x0), out.column("probability")[5])
    np.testing.assert_array_equal(lm.predictRaw(x0), out.column("rawPrediction")[5])
    np.testing.assert_allclose(lm.featureImportances, m.featureImportances)
    assert lm.totalNumNodes == m.totalNumNodes

    Xr, yr = _data("squared", n=500)
    dfr = TDataFrame({"features": Xr, "label": yr})
    r = GBTRegressor(maxIter=3, maxDepth=3, seed=1, device="cpu").fit(dfr)
    r.write().save(str(tmp_path / "gbtr"))
    lr = GBTRegressionModel.load(str(tmp_path / "gbtr")).setDevice("cpu")
    np.testing.assert_array_equal(lr.transform(dfr).column("prediction"), r.transform(dfr).column("prediction"))


def test_param_surface_and_errors():
    est = GBTClassifier()
    assert (est.getMaxIter(), est.getMaxDepth(), est.getMaxBins()) == (20, 5, 32)
    assert est.getStepSize() == pytest.approx(0.1)
    assert est.getLossType() == "logistic" and GBTRegressor().getLossType() == "squared"
    assert est.getFeatureSubsetStrategy() == "all"
    assert est.tpu_params["n_estimators"] == 20 and est.tpu_params["max_features"] == 1.0
    est2 = GBTRegressor().setMaxIter(4).setMaxDepth(3).setStepSize(0.2).setSeed(9).setFeatureSubsetStrategy("sqrt")
    assert est2.tpu_params["n_estimators"] == 4 and est2.tpu_params["learning_rate"] == pytest.approx(0.2)
    assert est2.tpu_params["max_features"] == "sqrt" and est2.tpu_params["random_state"] == 9

    X, y = _data("squared", n=200)
    df = TDataFrame({"features": X, "label": y})
    with pytest.raises(ValueError, match="absolute"):
        GBTRegressor(maxIter=2, lossType="absolute", device="cpu").fit(df)
    Xc, yc = _data("logistic", n=200)
    dfc = TDataFrame({"features": Xc, "label": yc})
    with pytest.raises(ValueError, match="lossType"):
        GBTClassifier(maxIter=2, lossType="squared", device="cpu").fit(dfc)
    with pytest.raises(RuntimeError, match="integers"):
        GBTClassifier(maxIter=2, device="cpu").fit(TDataFrame({"features": Xc, "label": np.linspace(0, 1, 200)}))
    with pytest.raises(ValueError, match="not supported"):
        GBTClassifier(weightCol="w")
    with pytest.raises(ValueError, match="not supported"):
        GBTRegressor(validationIndicatorCol="v")

    m = GBTRegressor(maxIter=3, maxDepth=2, seed=1, device="cpu").fit(df)
    rep = m._fit_report
    assert rep["rounds"] == 3 and rep["trees"] == 3 and rep["quantize_seconds"] > 0 and rep["boost_seconds"] > 0
    assert {"sketch_seconds", "binize_seconds", "seconds_per_round", "draws_seconds"} <= set(rep)
    assert "_fit_report" not in m._model_attributes
    imp = m.featureImportances
    assert imp.shape == (16,) and imp.sum() == pytest.approx(1.0, abs=1e-6) and imp[:4].sum() > 0.9


def test_feature_subset_draws():
    """With a feature subset the draws come from ``TorchDraws`` at tree id
    round · n_out + j: a fit is repeatable, the seed moves it, and each
    round's trees are those ``gbt_round`` grows from the same margins."""
    X, y = _data("multinomial", n=400)
    df = TDataFrame({"features": X, "label": y})
    kw = dict(maxIter=2, maxDepth=3, featureSubsetStrategy="sqrt", device="cpu")
    a = GBTClassifier(seed=4, **kw).fit(df)._model_attributes
    b = GBTClassifier(seed=4, **kw).fit(df)._model_attributes
    c = GBTClassifier(seed=5, **kw).fit(df)._model_attributes
    np.testing.assert_array_equal(a["features"], b["features"])
    assert not np.array_equal(a["features"], c["features"])
    cfg = pgbt.GBTConfig(loss="multinomial", n_out=3, learning_rate=0.1, tree=pt.ForestConfig(
        max_depth=3, n_bins=32, n_features=16, n_stats=4, impurity="variance", k_features=4,
        min_samples_leaf=1, min_info_gain=0.0, min_samples_split=2, bootstrap=False))
    bins = pt.binize(torch.from_numpy(X), torch.from_numpy(a["bin_edges"]), d_pad=16)
    marg = torch.from_numpy(a["init_margin"]).expand(400, 3).contiguous()
    draws = pt.TorchDraws(4)
    for r in range(2):
        out = pgbt.gbt_round(bins, torch.ones(400), torch.from_numpy(y), marg, cfg=cfg,
                             trees=[3 * r + j for j in range(3)], draws=draws)
        np.testing.assert_array_equal(out["feature"].numpy(), a["features"][3 * r:3 * r + 3])
        marg = out["margins"]
