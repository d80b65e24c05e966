"""Port parity: ``kfold``, the multi-model hooks and the single-pass
``CrossValidator`` (``spark_rapids_ml_tpu_torch``'s ``tuning.py``,
``data/dataframe.py``, the models' ``_combine`` / ``_transformEvaluate``)
against the JAX package on the CPU.

The port runs with ``device="cpu"`` (kernels K1, K3, K5 and K9 take their
plain versions), the JAX side with ``num_workers=1``; both get the same
numpy-seeded rows. The folds are one numpy draw in both packages, so they
are equal bit for bit. The f64 CVs hold ``avgMetrics`` / ``stdMetrics`` at
rtol 1e-9 (LinearRegression: closed-form solves in f64) or equal
(LogisticRegression accuracies: counts of equal predictions). The forests
grow the same trees without randomness (``bootstrap=False``,
``featureSubsetStrategy="all"``), so their metrics are equal.
"""

import numpy as np
import pytest

import jax

from spark_rapids_ml_tpu.classification import LogisticRegression as JLogReg
from spark_rapids_ml_tpu.classification import LogisticRegressionModel as JLogRegModel
from spark_rapids_ml_tpu.classification import RandomForestClassifier as JRFC
from spark_rapids_ml_tpu.data import DataFrame as JDataFrame
from spark_rapids_ml_tpu.data.dataframe import kfold as jkfold
from spark_rapids_ml_tpu.data.dataframe import kfold_ids as jkfold_ids
from spark_rapids_ml_tpu.evaluation import MulticlassClassificationEvaluator as JMCE
from spark_rapids_ml_tpu.evaluation import RegressionEvaluator as JRE
from spark_rapids_ml_tpu.regression import LinearRegression as JLinReg
from spark_rapids_ml_tpu.regression import RandomForestRegressor as JRFR
from spark_rapids_ml_tpu.tuning import CrossValidator as JCV
from spark_rapids_ml_tpu.tuning import ParamGridBuilder as JPGB
from spark_rapids_ml_tpu_torch import DataFrame as TDataFrame
from spark_rapids_ml_tpu_torch import tuning
from spark_rapids_ml_tpu_torch.classification import LogisticRegression as TLogReg
from spark_rapids_ml_tpu_torch.classification import LogisticRegressionModel as TLogRegModel
from spark_rapids_ml_tpu_torch.classification import RandomForestClassifier as TRFC
from spark_rapids_ml_tpu_torch.core import _TpuEstimator, _TpuModel
from spark_rapids_ml_tpu_torch.data.dataframe import kfold as tkfold
from spark_rapids_ml_tpu_torch.data.dataframe import kfold_ids as tkfold_ids
from spark_rapids_ml_tpu_torch.evaluation import MulticlassClassificationEvaluator as TMCE
from spark_rapids_ml_tpu_torch.evaluation import RegressionEvaluator as TRE
from spark_rapids_ml_tpu_torch.regression import LinearRegression as TLinReg
from spark_rapids_ml_tpu_torch.regression import RandomForestRegressor as TRFR
from spark_rapids_ml_tpu_torch.tuning import CrossValidator as TCV
from spark_rapids_ml_tpu_torch.tuning import CrossValidatorModel as TCVModel
from spark_rapids_ml_tpu_torch.tuning import ParamGridBuilder as TPGB

CLOSED = dict(rtol=1e-9, atol=0)


def _reg_cols(n=300, d=6, seed=8):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    w = rng.normal(size=d)
    return {"features": X, "label": X @ w + 1.0 + 0.5 * rng.normal(size=n)}


def _cls_cols(n=300, d=4, seed=11):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    y = (X[:, 0] - X[:, 2] + 0.5 * rng.normal(size=n) > 0.2).astype(np.float64)
    return {"features": X, "label": y}


def _frames(cols):
    return JDataFrame(dict(cols)), TDataFrame(dict(cols))


def _grid(grid, est, **values):
    for name, vals in values.items():
        grid.addGrid(est.getParam(name), vals)
    return grid.build()


def _cv_pair(jest, test, grid_values, jeva, teva, **kw):
    """The same CV in both packages: JAX (estimator, grid) and port's."""
    jcv = JCV(estimator=jest, estimatorParamMaps=_grid(JPGB(), jest, **grid_values), evaluator=jeva, **kw)
    tcv = TCV(estimator=test, estimatorParamMaps=_grid(TPGB(), test, **grid_values), evaluator=teva, **kw)
    return jcv, tcv


# ---------------------------------------------------------------------------
# folds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,n_folds,seed", [(97, 3, 0), (300, 5, 7), (1, 2, 3)])
def test_kfold_matches_jax(n, n_folds, seed):
    ids = tkfold_ids(n, n_folds, seed)
    assert ids.dtype == np.int8
    np.testing.assert_array_equal(ids, jkfold_ids(n, n_folds, seed))
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 3))
    cols = {"features": X, "label": np.arange(n, dtype=np.float64)}
    jf, tf = jkfold(JDataFrame(dict(cols)), n_folds, seed), tkfold(TDataFrame(dict(cols)), n_folds, seed)
    assert len(tf) == n_folds
    for (jt, jv), (tt, tv) in zip(jf, tf):
        for j, t in ((jt, tt), (jv, tv)):
            np.testing.assert_array_equal(t.column("features"), j.column("features"))
            np.testing.assert_array_equal(t.column("label"), j.column("label"))
        assert tt.count() + tv.count() == n


# ---------------------------------------------------------------------------
# the hooks' defaults
# ---------------------------------------------------------------------------


def test_hook_defaults_and_supports():
    assert _TpuEstimator._supportsTransformEvaluate(TLinReg(), TMCE()) is False
    for est, eva, want in ((TLinReg(), TRE(), True), (TLinReg(), TMCE(), False),
                           (TLogReg(), TMCE(), True), (TLogReg(), TRE(), False),
                           (TRFC(), TMCE(), True), (TRFC(), TRE(), False),
                           (TRFR(), TRE(), True), (TRFR(), TMCE(), False)):
        assert est._supportsTransformEvaluate(eva) is want, (type(est).__name__, type(eva).__name__)
    for est in (TLogReg(), TRFC(), TRFR(), TLinReg()):
        assert est._enable_fit_multiple_in_single_pass()

    class _Bare(_TpuModel):
        def _get_transform_func(self, dataset=None):
            return lambda X: {}

    with pytest.raises(NotImplementedError, match="_Bare does not support _combine"):
        _Bare._combine([_Bare()])
    with pytest.raises(NotImplementedError, match="_Bare does not support _transformEvaluate"):
        _Bare()._transformEvaluate(TDataFrame({"features": np.zeros((2, 2))}), TRE())


def test_param_grid_builder_matches_jax():
    jest, test = JLinReg(), TLinReg()
    j = (JPGB().addGrid(jest.getParam("regParam"), [0.0, 0.1])
         .addGrid(jest.getParam("elasticNetParam"), [0.0, 0.5, 1.0]).baseOn({jest.getParam("maxIter"): 7}).build())
    t = (TPGB().addGrid(test.getParam("regParam"), [0.0, 0.1])
         .addGrid(test.getParam("elasticNetParam"), [0.0, 0.5, 1.0]).baseOn({test.getParam("maxIter"): 7}).build())
    assert len(t) == 6 and all(len(pm) == 3 for pm in t)
    assert [{p.name: v for p, v in pm.items()} for pm in t] == [{p.name: v for p, v in pm.items()} for pm in j]
    with pytest.raises(TypeError, match="instance of Param"):
        TPGB().addGrid("regParam", [0.1])


# ---------------------------------------------------------------------------
# CrossValidator against the JAX package
# ---------------------------------------------------------------------------


def _no_single_pass(est):
    est._supportsTransformEvaluate = lambda e: False
    return est


def test_cv_linreg_f64_matches_jax():
    """The port's single pass against the JAX package's f64 per-map loop at
    rtol 1e-9. The JAX single pass evaluates outside its scoped x64, so its
    combined model's predictions come back in f32: it is held at 1e-6."""
    jdf, tdf = _frames(_reg_cols(n=400, seed=10))
    grid = {"regParam": [0.0, 0.01, 100.0], "elasticNetParam": [0.0, 0.5]}
    jcv, tcv = _cv_pair(JLinReg(float32_inputs=False, num_workers=1), TLinReg(float32_inputs=False, device="cpu"),
                        grid, JRE(metricName="rmse"), TRE(metricName="rmse"), numFolds=3, seed=1)
    jloop, _ = _cv_pair(_no_single_pass(JLinReg(float32_inputs=False, num_workers=1)), TLinReg(), grid,
                        JRE(metricName="rmse"), TRE(), numFolds=3, seed=1)
    jm, tm, jl = jcv.fit(jdf), tcv.fit(tdf), jloop.fit(jdf)
    np.testing.assert_allclose(tm.avgMetrics, jl.avgMetrics, **CLOSED)
    np.testing.assert_allclose(tm.stdMetrics, jl.stdMetrics, **CLOSED)
    np.testing.assert_allclose(tm.avgMetrics, jm.avgMetrics, rtol=1e-6)
    assert int(np.argmin(tm.avgMetrics)) == int(np.argmin(jm.avgMetrics)) == int(np.argmin(jl.avgMetrics))
    assert np.argmin(tm.avgMetrics) not in (4, 5)  # regParam 100 loses
    assert TRE(metricName="r2").evaluate(tm.transform(tdf)) > 0.9
    np.testing.assert_allclose(tm.transform(tdf).column("prediction"),
                               np.asarray(jm.transform(jdf).column("prediction")), **CLOSED)


def test_cv_logreg_f64_matches_jax():
    jdf, tdf = _frames(_cls_cols())
    jcv, tcv = _cv_pair(JLogReg(float32_inputs=False, num_workers=1), TLogReg(float32_inputs=False, device="cpu"),
                        {"regParam": [0.01, 1.0], "elasticNetParam": [0.0, 0.5]},
                        JMCE(metricName="accuracy"), TMCE(metricName="accuracy"), seed=3)
    jm, tm = jcv.fit(jdf), tcv.fit(tdf)
    np.testing.assert_array_equal(tm.avgMetrics, jm.avgMetrics)
    np.testing.assert_array_equal(tm.stdMetrics, jm.stdMetrics)
    np.testing.assert_array_equal(tm.transform(tdf).column("prediction"),
                                  np.asarray(jm.transform(jdf).column("prediction")))


def test_cv_single_pass_matches_fallback():
    """The single pass (fitMultiple, _combine, _transformEvaluate) against
    the per-param-map loop, in the port and against the JAX loop."""
    cols = _cls_cols()
    tdf = TDataFrame(dict(cols))
    grid = {"regParam": [0.01, 1.0]}
    teva = TMCE(metricName="accuracy")
    calls = []

    class _Spy(TLogRegModel):
        @classmethod
        def _combine(cls, models):
            calls.append(len(models))
            return TLogRegModel._combine(models)

    est = TLogReg(float32_inputs=False, device="cpu")
    est._create_model = lambda result: _Spy(**result)
    fast = TCV(estimator=est, estimatorParamMaps=_grid(TPGB(), est, **grid), evaluator=teva, seed=3).fit(tdf)
    assert calls == [2, 2, 2]  # one combined model a fold
    slow_est = _no_single_pass(TLogReg(float32_inputs=False, device="cpu"))
    slow = TCV(estimator=slow_est, estimatorParamMaps=_grid(TPGB(), slow_est, **grid), evaluator=teva,
               seed=3).fit(tdf)
    np.testing.assert_allclose(fast.avgMetrics, slow.avgMetrics, atol=1e-12)
    jest = _no_single_pass(JLogReg(float32_inputs=False, num_workers=1))
    jslow = JCV(estimator=jest, estimatorParamMaps=_grid(JPGB(), jest, **grid), evaluator=JMCE(metricName="accuracy"),
                seed=3).fit(JDataFrame(dict(cols)))
    np.testing.assert_array_equal(fast.avgMetrics, jslow.avgMetrics)


def test_cv_parallel_folds_match_serial():
    tdf = TDataFrame(_reg_cols(n=200, seed=12))
    est = TLinReg(float32_inputs=False, device="cpu")
    grid = _grid(TPGB(), est, regParam=[0.0, 0.1])
    serial = TCV(estimator=est, estimatorParamMaps=grid, evaluator=TRE(), seed=2, parallelism=1).fit(tdf)
    parallel = TCV(estimator=est, estimatorParamMaps=grid, evaluator=TRE(), seed=2, parallelism=3).fit(tdf)
    np.testing.assert_array_equal(serial.avgMetrics, parallel.avgMetrics)
    np.testing.assert_array_equal(serial.stdMetrics, parallel.stdMetrics)
    other = TCV(estimator=est, estimatorParamMaps=grid, evaluator=TRE(), seed=5, parallelism=3).fit(tdf)
    assert not np.array_equal(other.avgMetrics, serial.avgMetrics)  # another fold draw


def test_cv_collect_sub_models():
    tdf = TDataFrame(_reg_cols(n=120, seed=14))
    est = TLinReg(float32_inputs=False, device="cpu")
    grid = _grid(TPGB(), est, regParam=[0.0, 0.1])
    cv = TCV(estimator=est, estimatorParamMaps=grid, evaluator=TRE(), collectSubModels=True)
    cvm = cv.fit(tdf)
    assert cvm.subModels is not None and len(cvm.subModels) == 3 and all(len(s) == 2 for s in cvm.subModels)
    # each fold's sub-models are that fold's fits of the two maps
    (train, _), *_ = tkfold(tdf, 3, 0)
    for j, pm in enumerate(grid):
        np.testing.assert_allclose(cvm.subModels[0][j].coefficients, est.fit(train, pm).coefficients, **CLOSED)
    assert TCV(estimator=est, estimatorParamMaps=grid, evaluator=TRE()).fit(tdf).subModels is None
    assert TCV(estimator=est, estimatorParamMaps=grid, evaluator=TRE()).setCollectSubModels(True).fit(
        tdf).subModels is not None


def test_cv_model_persistence_and_jax_saved(tmp_path):
    cols = _reg_cols(n=150, seed=13)
    jdf, tdf = _frames(cols)
    jcv, tcv = _cv_pair(JLinReg(float32_inputs=False, num_workers=1), TLinReg(float32_inputs=False, device="cpu"),
                        {"regParam": [0.0, 0.1]}, JRE(metricName="rmse"), TRE(metricName="rmse"))
    tm = tcv.fit(tdf)
    path = str(tmp_path / "cv")
    tm.save(path)
    loaded = TCVModel.load(path)
    loaded.bestModel.setDevice("cpu")
    np.testing.assert_array_equal(loaded.avgMetrics, tm.avgMetrics)
    np.testing.assert_array_equal(loaded.stdMetrics, tm.stdMetrics)
    np.testing.assert_array_equal(loaded.transform(tdf)["prediction"], tm.transform(tdf)["prediction"])
    jm = jcv.fit(jdf)
    jpath = str(tmp_path / "jax_cv")
    jm.save(jpath)
    jl = TCVModel.load(jpath)
    jl.bestModel.setDevice("cpu")
    assert type(jl.bestModel).__module__.startswith("spark_rapids_ml_tpu_torch.")
    np.testing.assert_allclose(jl.avgMetrics, jm.avgMetrics, rtol=0)
    np.testing.assert_allclose(jl.transform(tdf)["prediction"], np.asarray(jm.transform(jdf)["prediction"]),
                               **CLOSED)


def _flaky(base):
    class Flaky(base):
        POISON = 12345.0

        def _supportsTransformEvaluate(self, eva):
            return False  # the per-param-map loop

        def fit(self, dataset, params=None):
            if params and any(v == self.POISON for v in params.values()):
                raise RuntimeError("injected fit failure (poison combo)")
            return super().fit(dataset, params)

    return Flaky


def test_cv_failfast_and_tolerant_mode(monkeypatch):
    """The JAX package's tolerant mode (TPUML_CV_FAILFAST=0) is the port's
    CV_FAILFAST = False: the poison combination records +inf (rmse), and
    the other metrics equal the JAX package's."""
    rng = np.random.default_rng(8)
    X = rng.normal(size=(240, 5))
    cols = {"features": X, "label": X @ rng.normal(size=5) + 0.1 * rng.normal(size=240)}
    jdf, tdf = _frames(cols)
    JF, TF = _flaky(JLinReg), _flaky(TLinReg)
    jcv, tcv = _cv_pair(JF(float32_inputs=False, num_workers=1), TF(float32_inputs=False, device="cpu"),
                        {"regParam": [0.0, 0.01, TF.POISON]}, JRE(metricName="rmse"), TRE(metricName="rmse"),
                        numFolds=3, seed=1)
    assert tuning.CV_FAILFAST is True
    with pytest.raises(RuntimeError, match="poison"):
        tcv.fit(tdf)
    monkeypatch.setattr(tuning, "CV_FAILFAST", False)
    monkeypatch.setenv("TPUML_CV_FAILFAST", "0")
    tm, jm = tcv.fit(tdf), jcv.fit(jdf)
    assert tm.avgMetrics[2] == np.inf and jm.avgMetrics[2] == np.inf
    np.testing.assert_allclose(tm.avgMetrics[:2], jm.avgMetrics[:2], **CLOSED)
    assert TRE(metricName="r2").evaluate(tm.transform(tdf)) > 0.9
    all_bad = TCV(estimator=tcv.getEstimator(), estimatorParamMaps=tcv.getEstimatorParamMaps()[2:],
                  evaluator=TRE(metricName="rmse"))
    with pytest.raises(RuntimeError, match="every param map failed"):
        all_bad.fit(tdf)


# ---------------------------------------------------------------------------
# LogisticRegression's combined model against the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_classes", [2, 3])
def test_logreg_combined_transform_matches_jax(n_classes):
    """The combined model's columns: each sub-model's column against that
    JAX model's own f64 transform at 1e-12, and against the JAX combined
    model, whose pass runs outside the JAX package's scoped x64 (f32
    scores), at 1e-6."""
    rng = np.random.default_rng(9)
    X = rng.normal(size=(200, 4))
    y = np.clip(np.round(X[:, 0] + X[:, 1] + (n_classes - 1) / 2), 0, n_classes - 1) if n_classes > 2 else (
        X[:, 0] + X[:, 1] + 0.5 * rng.normal(size=200) > 0).astype(np.float64)
    jdf, tdf = _frames({"features": X, "label": y})
    jms = [JLogReg(float32_inputs=False, num_workers=1, regParam=r).fit(jdf) for r in (0.01, 100.0)]
    tms = [TLogReg(float32_inputs=False, device="cpu", regParam=r).fit(tdf) for r in (0.01, 100.0)]
    K = max(n_classes, 2)
    assert TLogRegModel._combine(tms).coef_.shape == (2, 1 if n_classes == 2 else n_classes, 4)
    # the JAX models' coefficients in the port: the transforms alone are compared
    tc = TLogRegModel._combine([TLogRegModel(**dict(m._model_attributes)) for m in jms])
    tc._device, tc._float32_inputs = "cpu", False
    assert tc._is_multi_model
    tout, jout = tc.transform(tdf), JLogRegModel._combine(jms).transform(jdf)
    for c, shape in (("prediction", (200, 2)), ("probability", (200, 2, K)), ("rawPrediction", (200, 2, K))):
        assert tout.column(c).shape == shape and tout.column(c).dtype == np.float64
        for j, jm in enumerate(jms):
            np.testing.assert_allclose(tout.column(c)[:, j], np.asarray(jm.transform(jdf).column(c)),
                                       rtol=1e-12, atol=1e-14, err_msg=f"{c} model {j}")
        np.testing.assert_allclose(tout.column(c), np.asarray(jout.column(c)), rtol=1e-6, atol=1e-6, err_msg=c)
    for metric in ("accuracy", "f1", "logLoss"):
        eva = TMCE(metricName=metric)
        tv = tc._transformEvaluate(tdf, eva)
        want = [JMCE(metricName=metric).evaluate(jm.transform(jdf)) for jm in jms]
        np.testing.assert_allclose(tv, want, rtol=1e-12, err_msg=metric)
        # the port's fits: each value is its sub-model's own evaluation
        np.testing.assert_allclose(TLogRegModel._combine(tms)._transformEvaluate(tdf, eva),
                                   [eva.evaluate(m.transform(tdf)) for m in tms], rtol=1e-12, err_msg=metric)
    ll = tc._transformEvaluate(tdf, TMCE(metricName="logLoss"))
    assert ll[0] < ll[1]
    with pytest.raises(NotImplementedError, match="RegressionEvaluator"):
        tc._transformEvaluate(tdf, TRE())


def test_combined_degenerate_model_keeps_multi_shape():
    """A fold whose training split has one label gives an infinite-intercept
    sub-model (the JAX package's, entry for entry); the combined model
    still gives per-model columns, as the JAX package's does."""
    rng = np.random.default_rng(15)
    X = rng.normal(size=(60, 3))
    y = (X[:, 0] > 0).astype(np.float64)
    jdf, tdf = _frames({"features": X, "label": y})
    tms = [TLogReg(float32_inputs=False, device="cpu").fit(TDataFrame({"features": X, "label": lab}))
           for lab in (y, np.ones(60))]
    jms = [JLogReg(float32_inputs=False, num_workers=1).fit(JDataFrame({"features": X, "label": lab}))
           for lab in (y, np.ones(60))]
    assert np.isposinf(tms[1].intercept) and not tms[1].coef_.any()
    np.testing.assert_array_equal(tms[1].coef_, np.asarray(jms[1].coef_))
    np.testing.assert_array_equal(tms[1].intercept_, np.asarray(jms[1].intercept_))
    combined = TLogRegModel._combine(tms)
    out = combined.transform(tdf)
    assert out["prediction"].shape == (60, 2) and out["rawPrediction"].shape == (60, 2, 2)
    assert (out["prediction"][:, 1] == 1.0).all()
    assert np.isposinf(out["rawPrediction"][:, 1, 1]).all() and (out["probability"][:, 1, 1] == 1.0).all()
    np.testing.assert_array_equal(out["prediction"][:, 0], tms[0].transform(tdf)["prediction"])
    # the JAX models in the port's combined model against the JAX combined model
    tc = TLogRegModel._combine([TLogRegModel(**dict(m._model_attributes)) for m in jms])
    tc._device, tc._float32_inputs = "cpu", False
    tout, jout = tc.transform(tdf), JLogRegModel._combine(jms).transform(jdf)
    for c in ("prediction", "probability", "rawPrediction"):
        np.testing.assert_allclose(tout[c], np.asarray(jout[c]), rtol=1e-6, atol=1e-6, err_msg=c)
    vals = combined._transformEvaluate(tdf, TMCE(metricName="accuracy"))
    assert len(vals) == 2 and vals[0] > vals[1]
    # a single degenerate model keeps its constant path
    assert tms[1].transform(tdf)["prediction"].shape == (60,)


# ---------------------------------------------------------------------------
# the forests
# ---------------------------------------------------------------------------


def _forest_cols(kind, n=300, d=5, seed=2):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    if kind == "classifier":
        y = (X[:, 0] + 0.5 * X[:, 3] + 0.3 * rng.normal(size=n) > 0).astype(np.float64)
    else:
        # integer labels: exact variance statistics in both packages
        y = (np.where(X[:, 0] > 0.3, 6, 1) + np.where(X[:, 2] > -0.5, 3, 0)).astype(np.float64)
    return {"features": X, "label": y}


@pytest.mark.parametrize("kind", ["classifier", "regressor"])
def test_forest_cv_matches_jax(kind):
    """CV's single pass for the forests: the JAX package's and the port's,
    growing the same trees, give the same metrics and the same best model."""
    jdf, tdf = _frames(_forest_cols(kind))
    kw = dict(numTrees=3, maxBins=16, bootstrap=False, featureSubsetStrategy="all", seed=1)
    JE, TE = (JRFC, TRFC) if kind == "classifier" else (JRFR, TRFR)
    jeva, teva = (JMCE(metricName="accuracy"), TMCE(metricName="accuracy")) if kind == "classifier" else (
        JRE(metricName="rmse"), TRE(metricName="rmse"))
    test = TE(device="cpu", **kw)
    assert test._supportsTransformEvaluate(teva)
    jcv, tcv = _cv_pair(JE(num_workers=1, **kw), test, {"maxDepth": [2, 4]}, jeva, teva, numFolds=2, seed=2)
    try:
        jm = jcv.fit(jdf)
    finally:
        jax.clear_caches()
    tm = tcv.fit(tdf)
    np.testing.assert_allclose(tm.avgMetrics, jm.avgMetrics, rtol=1e-12)
    np.testing.assert_allclose(tm.stdMetrics, jm.stdMetrics, rtol=1e-12, atol=1e-15)
    np.testing.assert_array_equal(tm.transform(tdf).column("prediction"),
                                  np.asarray(jm.transform(jdf).column("prediction")))
    if kind == "classifier":
        assert max(tm.avgMetrics) > 0.7


@pytest.mark.parametrize("kind", ["classifier", "regressor"])
def test_forest_combine_evaluates_each_submodel(kind, monkeypatch):
    """The combined forest keeps its sub-models, extracts the features once
    and gives each sub-model's own metric, in one fitMultiple pass."""
    from spark_rapids_ml_tpu_torch import core

    tdf = TDataFrame(_forest_cols(kind, seed=4))
    TE = TRFC if kind == "classifier" else TRFR
    est = TE(seed=0, device="cpu", featureSubsetStrategy="all")
    pre = []
    real_pre = core._TpuEstimator._pre_process_data
    monkeypatch.setattr(core._TpuEstimator, "_pre_process_data", lambda self, ds: pre.append(1) or real_pre(self, ds))
    maps = [{"maxDepth": 8, "numTrees": 6}, {"maxDepth": 1, "numTrees": 2}]
    models = [m for _, m in sorted(est.fitMultiple(tdf, maps), key=lambda t: t[0])]
    assert len(pre) == 1  # one copy of the rows for both maps
    assert [m.getNumTrees() for m in models] == [6, 2]
    combined = type(models[0])._combine(models)
    assert combined._eval_models() == models and models[0]._eval_models() == [models[0]]
    eva = TMCE(metricName="accuracy") if kind == "classifier" else TRE(metricName="rmse")
    extracted = []
    real_features = core._features
    monkeypatch.setattr("spark_rapids_ml_tpu_torch.models.tree._features",
                        lambda obj, X: extracted.append(1) or real_features(obj, X))
    vals = combined._transformEvaluate(tdf, eva)
    assert len(extracted) == 1
    assert vals == [eva.evaluate(m.transform(tdf)) for m in models]
    assert (vals[0] > vals[1]) if kind == "classifier" else (vals[0] < vals[1])
    other = TMCE() if kind == "regressor" else TRE()
    with pytest.raises(NotImplementedError, match="not supported"):
        combined._transformEvaluate(tdf, other)
