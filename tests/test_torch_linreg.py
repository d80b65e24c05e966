"""Port parity: LinearRegression (``spark_rapids_ml_tpu_torch``'s
``ops/linreg_kernels.py``, ``models/regression.py``, the copied
``evaluation.py`` and ``metrics/``) against the JAX package on the CPU.

The JAX side runs with ``num_workers=1`` on f32 data; the port with
``device="cpu"``, where kernel K1 takes its plain version. Inputs come from
seeded numpy generators at small sizes. Both packages compute in f32 with
different summation orders, so values agree to a small multiple of f32
rounding amplified by the system's conditioning (tolerances per check).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_ml_tpu.data import DataFrame as JDataFrame
from spark_rapids_ml_tpu.evaluation import MulticlassClassificationEvaluator as JMCE
from spark_rapids_ml_tpu.evaluation import RegressionEvaluator as JRE
from spark_rapids_ml_tpu.ops import linreg_kernels as jlk
from spark_rapids_ml_tpu.parallel.mesh import make_mesh
from spark_rapids_ml_tpu.parallel.mesh import shard_aligned as jshard_aligned
from spark_rapids_ml_tpu.parallel.mesh import shard_rows as jshard_rows
from spark_rapids_ml_tpu.regression import LinearRegression as JLinReg
from spark_rapids_ml_tpu.regression import LinearRegressionModel as JLinRegModel
from spark_rapids_ml_tpu_torch import DataFrame as TDataFrame
from spark_rapids_ml_tpu_torch.evaluation import MulticlassClassificationEvaluator as TMCE
from spark_rapids_ml_tpu_torch.evaluation import RegressionEvaluator as TRE
from spark_rapids_ml_tpu_torch.ops import linreg_kernels as tlk
from spark_rapids_ml_tpu_torch.parallel.mesh import shard_aligned as tshard_aligned
from spark_rapids_ml_tpu_torch.parallel.mesh import shard_rows as tshard_rows
from spark_rapids_ml_tpu_torch.regression import LinearRegression as TLinReg
from spark_rapids_ml_tpu_torch.regression import LinearRegressionModel as TLinRegModel

CPU = torch.device("cpu")


def _reg_data(n=2000, d=24, seed=0, offset=0.0, noise=0.3):
    """Features of unequal scales, labels from a random plane plus noise,
    and row weights uniform in [0.1, 2]."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)) * rng.uniform(0.5, 3.0, size=d) + offset
    beta = rng.normal(size=d)
    y = (X - offset) @ beta + 2.5 + noise * rng.normal(size=n)
    w = rng.uniform(0.1, 2.0, size=n)
    return X.astype(np.float32), y.astype(np.float32), w.astype(np.float32)


def _frames(cols):
    return JDataFrame(dict(cols)), TDataFrame(dict(cols))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# ---------------------------------------------------------------------------
# sufficient statistics
# ---------------------------------------------------------------------------


def _f64_oracle(X, y, mask, w, fit_intercept):
    X64, y64 = X.astype(np.float64), y.astype(np.float64)
    wv = mask.astype(np.float64) * (w if w is not None else 1.0)
    W = wv.sum()
    mean_all = (X64 * wv[:, None]).sum(0) / W
    mx = mean_all if fit_intercept else np.zeros(X.shape[1])
    my = (y64 * wv).sum() / W if fit_intercept else 0.0
    Xc = (X64 - mx) * np.sqrt(wv)[:, None]
    yc = (y64 - my) * np.sqrt(wv)
    return {
        "n": W, "mean_x": mx, "mean_y": my, "G": Xc.T @ Xc, "Xy": Xc.T @ yc,
        "yy": (yc * yc).sum(), "var": ((X64 - mean_all) ** 2 * wv[:, None]).sum(0) / W,
    }


@pytest.mark.parametrize("fit_intercept", [True, False])
@pytest.mark.parametrize("weighted", [True, False])
def test_suffstats_chunked_matches_jax_and_f64(fit_intercept, weighted):
    # the JAX test's regime: |μ| = 1e4 >> σ, where a product taken before
    # the shift (Xᵀv - μ̂·Σv) or the E[x²] - μ² variance cancels in f32;
    # 29 padding rows; the same csize on both sides, so both take μ̂ from
    # the same leading rows
    n, d, csize = 3 * 16 * 8, 5, 16
    rng = np.random.default_rng(0)
    X = (rng.normal(size=(n, d)) + 1e4).astype(np.float32)
    y = (X @ rng.normal(size=d) * 1e-4 + rng.normal(size=n)).astype(np.float32)
    n_valid = n - 29
    w = rng.uniform(0.5, 2.0, size=n).astype(np.float32) if weighted else None

    mesh = make_mesh(1)
    Xj, mj = jshard_rows(X[:n_valid], mesh, csize)
    yj = jshard_aligned(y[:n_valid], mesh, Xj.shape[0])
    wj = jshard_aligned(w[:n_valid], mesh, Xj.shape[0]) if weighted else None
    js = jlk.linreg_suffstats_chunked(
        Xj, mj, yj, wj, mesh=mesh, csize=csize, fit_intercept=fit_intercept, weighted=weighted
    )
    Xt, mt = tshard_rows(X[:n_valid], CPU, csize)
    yt = tshard_aligned(y[:n_valid], CPU, Xt.shape[0])
    wt = tshard_aligned(w[:n_valid], CPU, Xt.shape[0]) if weighted else None
    assert Xt.shape == Xj.shape
    ts = tlk.linreg_suffstats_chunked(Xt, mt, yt, wt, csize=csize, fit_intercept=fit_intercept)

    mask = np.asarray(mj)
    oracle = _f64_oracle(np.asarray(Xj), np.asarray(yj), mask, np.asarray(wj) if weighted else None,
                         fit_intercept)
    for k, ref in oracle.items():
        scale = max(np.abs(np.asarray(ref)).max(), 1e-12)
        # the JAX test's bands: uncentred G/Xy/yy at μ = 1e4 are large f32 sums
        tol = 5e-5 if (fit_intercept or k in ("n", "mean_x", "mean_y", "var")) else 5e-4
        got_t = ts[k].numpy().astype(np.float64)
        got_j = np.asarray(js[k], np.float64)
        assert np.abs(got_t - ref).max() / scale < tol, ("port", k)
        assert np.abs(got_j - ref).max() / scale < tol, ("jax", k)
        assert np.abs(got_t - got_j).max() / scale < tol, ("port vs jax", k)


@pytest.mark.parametrize("fit_intercept", [True, False])
def test_suffstats_fused_matches_jax(fit_intercept):
    X, y, w = _reg_data(n=300, d=8, seed=3, offset=2.0)
    m = (np.arange(300) < 280).astype(np.float32)
    js = jlk.linreg_suffstats(jnp.asarray(X), jnp.asarray(m), jnp.asarray(y), jnp.asarray(w),
                              fit_intercept=fit_intercept)
    ts = tlk.linreg_suffstats(torch.from_numpy(X), torch.from_numpy(m), torch.from_numpy(y),
                              torch.from_numpy(w), fit_intercept=fit_intercept)
    for k in ts:
        # O(1)-scaled data, both centred before the products: f32 rounding
        assert _rel(ts[k].numpy(), js[k]) < 2e-5, k


def test_plain_pass_in_row_chunks_matches_one_chunk(monkeypatch):
    # the plain pass at chunks of 37 rows (ragged last chunk) against one chunk
    X, y, w = _reg_data(n=640, d=12, seed=4, offset=5.0)
    args = [torch.from_numpy(a) for a in (X, np.ones(640, np.float32), y, w)]
    whole = tlk.linreg_suffstats_chunked(*args, csize=64, fit_intercept=False)
    monkeypatch.setattr(tlk, "_PASS_ELEMS", 37 * 12)
    assert tlk._pass_rows(12) == 37
    parts = tlk.linreg_suffstats_chunked(*args, csize=64, fit_intercept=False)
    for k in whole:
        assert _rel(parts[k].numpy(), whole[k].numpy()) < 1e-5, k


# ---------------------------------------------------------------------------
# solvers
# ---------------------------------------------------------------------------


def _stats_pair(seed=5, d=16):
    X, y, w = _reg_data(n=1500, d=d, seed=seed, offset=1.0)
    ts = tlk.linreg_suffstats(torch.from_numpy(X), torch.ones(1500), torch.from_numpy(y), torch.from_numpy(w))
    # the same f32 numbers on both sides
    js = {k: jnp.asarray(v.numpy()) for k, v in ts.items()}
    return ts, js


@pytest.mark.parametrize("l2,standardization", [(0.0, True), (0.0, False), (0.1, True), (0.1, False)])
def test_solve_normal_matches_jax(l2, standardization):
    ts, js = _stats_pair()
    bt, it_ = tlk.solve_normal(ts, l2, standardization=standardization)
    bj, ij = jlk.solve_normal(js, jnp.asarray(l2, jnp.float32), standardization=standardization)
    # a well-conditioned 16x16 Cholesky in f32 on both sides
    assert _rel(bt.numpy(), bj) < 1e-5
    assert abs(float(it_) - float(ij)) < 1e-5 * max(abs(float(ij)), 1.0)


@pytest.mark.parametrize("l1,l2,standardization,max_iter",
                         [(0.05, 0.05, True, 100), (0.1, 0.0, True, 100), (0.05, 0.02, False, 100),
                          (0.05, 0.05, True, 7)])
def test_solve_elasticnet_matches_jax(l1, l2, standardization, max_iter):
    ts, js = _stats_pair()
    bt, it_, nt = tlk.solve_elasticnet(ts, l1, l2, standardization=standardization, max_iter=max_iter, tol=1e-6)
    bj, ij, nj = jlk.solve_elasticnet(js, jnp.asarray(l1, jnp.float32), jnp.asarray(l2, jnp.float32),
                                      standardization=standardization, max_iter=max_iter, tol=1e-6)
    assert nt == int(nj)
    # the same FISTA iterates up to f32 rounding of a 16x16 product
    assert _rel(bt.numpy(), bj) < 1e-4
    assert abs(float(it_) - float(ij)) < 1e-4 * max(abs(float(ij)), 1.0)


# ---------------------------------------------------------------------------
# the estimator
# ---------------------------------------------------------------------------

_CONFIGS = {
    "ols": {},
    "ridge": {"regParam": 0.1},
    "ridge_unstandardized": {"regParam": 0.1, "standardization": False},
    "elastic_net": {"regParam": 0.05, "elasticNetParam": 0.5},
    "lasso": {"regParam": 0.05, "elasticNetParam": 1.0},
    "weighted": {"weightCol": "w", "regParam": 0.01},
    "no_intercept": {"fitIntercept": False, "regParam": 0.01},
    "reference_elastic_net": {"regParam": 1e-5, "elasticNetParam": 0.5},
}


@pytest.mark.parametrize("config", sorted(_CONFIGS))
def test_estimator_matches_jax(config):
    X, y, w = _reg_data(n=3000, d=32, seed=6, offset=3.0)
    jdf, tdf = _frames({"features": X, "label": y, "w": w})
    kw = _CONFIGS[config]
    jm = JLinReg(num_workers=1, **kw).fit(jdf)
    tm = TLinReg(device="cpu", **kw).fit(tdf)
    # f32 statistics in two summation orders through a well-conditioned
    # solve (and, for l1 > 0, the same number of FISTA steps)
    assert _rel(tm.coefficients, jm.coefficients) < 1e-4
    assert abs(tm.intercept - jm.intercept) < 1e-4 * max(abs(jm.intercept), 1.0)
    assert tm._model_attributes["n_iter"] == jm._model_attributes["n_iter"]
    assert tm.numFeatures == 32 and tm.hasSummary is False
    pt = np.asarray(tm.transform(tdf).column("prediction"))
    pj = np.asarray(jm.transform(jdf).column("prediction"))
    assert pt.shape == (3000,)
    assert np.abs(pt - pj).max() < 1e-4 * np.abs(pj).max()
    assert tm.predict(X[0]) == pytest.approx(float(pt[0]), rel=1e-5, abs=1e-5)


def test_collinear_features_no_nan():
    rng = np.random.default_rng(9)
    X = rng.normal(size=(200, 4))
    X = np.concatenate([X, X[:, :1]], axis=1)  # an exact duplicate column
    y = X[:, 0] + 0.1 * rng.normal(size=200)
    tdf = TDataFrame({"features": X.astype(np.float32), "label": y.astype(np.float32)})
    model = TLinReg(device="cpu").fit(tdf)
    assert np.isfinite(model.coefficients).all()
    pred = X @ model.coefficients + model.intercept
    assert np.sqrt(((pred - y) ** 2).mean()) < 0.2


def test_lasso_negated_feature_no_nan():
    # a feature and its exact negation: an all-ones power-iteration start
    # is orthogonal to the top eigenvector (the cos start is not)
    rng = np.random.default_rng(21)
    x = rng.normal(size=(200, 1))
    X = np.concatenate([x, -x], axis=1).astype(np.float32)
    y = (x[:, 0] + 0.05 * rng.normal(size=200)).astype(np.float32)
    model = TLinReg(regParam=0.5, elasticNetParam=1.0, standardization=False, device="cpu").fit(
        TDataFrame({"features": X, "label": y}))
    assert np.isfinite(model.coefficients).all()


@pytest.mark.parametrize("case", ["missing_weight_col", "huber_loss", "float64_inputs"])
def test_linreg_refusals(case):
    X, y, _ = _reg_data(n=50, d=3)
    tdf = TDataFrame({"features": X, "label": y})
    if case == "missing_weight_col":
        with pytest.raises(ValueError, match="weightCol"):
            TLinReg(weightCol="nope", device="cpu").fit(tdf)
    elif case == "huber_loss":
        with pytest.raises(ValueError, match="squaredError"):
            TLinReg(loss="huber", device="cpu")
    else:
        # float64 inputs are no longer refused: the f64 fit (K1's float64
        # route) matches the JAX package's float32_inputs=False fit
        cols = {"features": X.astype(np.float64), "label": y.astype(np.float64)}
        tm = TLinReg(float32_inputs=False, device="cpu").fit(TDataFrame(cols))
        jm = JLinReg(float32_inputs=False, num_workers=1).fit(JDataFrame(cols))
        assert tm.coefficients.dtype == np.asarray(jm.coefficients).dtype == np.float64
        np.testing.assert_allclose(tm.coefficients, np.asarray(jm.coefficients), rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(tm.intercept, float(jm.intercept), rtol=1e-10, atol=1e-12)


def test_fit_multiple_makes_one_pass(monkeypatch):
    from spark_rapids_ml_tpu_torch import core
    from spark_rapids_ml_tpu_torch.ops import linalg as tlinalg

    calls = {"gram": 0, "copy": 0}

    def gram(*a):
        calls["gram"] += 1
        return tlinalg.shifted_gram(*a)

    shard_rows = core.shard_rows

    def copy(*a, **k):
        calls["copy"] += 1
        return shard_rows(*a, **k)

    monkeypatch.setattr(tlk, "shifted_gram", gram)
    monkeypatch.setattr(core, "shard_rows", copy)
    X, y, _ = _reg_data(n=1200, d=10, seed=8)
    tdf = TDataFrame({"features": X, "label": y})
    est = TLinReg(device="cpu")
    grid = [{"regParam": 0.0}, {"regParam": 1e-2, "elasticNetParam": 0.5}, {"regParam": 1e-2}]
    models = dict(est.fitMultiple(tdf, grid))
    assert calls == {"gram": 1, "copy": 1}
    assert [models[i]._fit_report["stats_cached"] for i in range(3)] == [False, True, True]
    for i, pm in enumerate(grid):
        single = TLinReg(device="cpu", **pm).fit(tdf)
        # the same statistics through the same solver: equal bit for bit
        np.testing.assert_array_equal(models[i].coefficients, single.coefficients)
        assert models[i].intercept == single.intercept
        assert models[i].getOrDefault("regParam") == pm["regParam"]
    # a fitIntercept=False map needs a second pass, still over one copy
    calls.update(gram=0, copy=0)
    dict(est.fitMultiple(tdf, [{"fitIntercept": True}, {"fitIntercept": False}]))
    assert calls == {"gram": 2, "copy": 1}


def test_multi_model_evaluation_matches_jax():
    X, y, _ = _reg_data(n=1000, d=12, seed=10)
    jdf, tdf = _frames({"features": X, "label": y})
    grid = [{"regParam": 0.0}, {"regParam": 0.1}, {"regParam": 0.05, "elasticNetParam": 0.5}]
    jms = [m for _, m in sorted(JLinReg(num_workers=1).fitMultiple(jdf, grid))]
    tms = [m for _, m in sorted(TLinReg(device="cpu").fitMultiple(tdf, grid), key=lambda t: t[0])]
    jc, tc = JLinRegModel._combine(jms), TLinRegModel._combine(tms)
    assert tc._is_multi_model and tc.coefficients.shape == (3, 12)
    assert _rel(tc.coefficients, jc.coefficients) < 1e-4
    pt = np.asarray(tc.transform(tdf).column("prediction"))
    pj = np.asarray(jc.transform(jdf).column("prediction"))
    assert pt.shape == (1000, 3)
    assert np.abs(pt - pj).max() < 1e-4 * np.abs(pj).max()
    for metric in ("rmse", "r2", "mae"):
        et = tc._transformEvaluate(tdf, TRE(metricName=metric))
        ej = jc._transformEvaluate(jdf, JRE(metricName=metric))
        np.testing.assert_allclose(et, ej, rtol=1e-4)
    assert TLinReg()._supportsTransformEvaluate(TRE()) and not TLinReg()._supportsTransformEvaluate(TMCE())


@pytest.mark.parametrize("metric", ["rmse", "mse", "r2", "mae", "var"])
def test_regression_evaluator_matches_jax(metric):
    rng = np.random.default_rng(12)
    y = rng.normal(size=500)
    p = y + 0.3 * rng.normal(size=500)
    jdf, tdf = _frames({"label": y, "prediction": p})
    assert TRE(metricName=metric).evaluate(tdf) == JRE(metricName=metric).evaluate(jdf)
    assert TRE(metricName=metric).isLargerBetter() == JRE(metricName=metric).isLargerBetter()


@pytest.mark.parametrize("metric", ["f1", "accuracy", "weightedPrecision", "weightedRecall", "logLoss"])
def test_multiclass_evaluator_matches_jax(metric):
    rng = np.random.default_rng(13)
    y = rng.integers(0, 4, size=400).astype(np.float64)
    prob = rng.dirichlet(np.ones(4), size=400)
    pred = prob.argmax(axis=1).astype(np.float64)
    jdf, tdf = _frames({"label": y, "prediction": pred, "probability": prob})
    assert TMCE(metricName=metric).evaluate(tdf) == JMCE(metricName=metric).evaluate(jdf)


def test_save_load_round_trip(tmp_path):
    X, y, _ = _reg_data(n=300, d=6, seed=14)
    tdf = TDataFrame({"features": X, "label": y})
    m = TLinReg(regParam=0.1, device="cpu").fit(tdf)
    m.write().save(str(tmp_path / "lr"))
    m2 = TLinRegModel.load(str(tmp_path / "lr")).setDevice("cpu")
    np.testing.assert_array_equal(m2.coefficients, m.coefficients)
    assert m2.intercept == m.intercept and m2.getOrDefault("regParam") == 0.1
    np.testing.assert_array_equal(m2.transform(tdf).column("prediction"), m.transform(tdf).column("prediction"))


def test_entry_point_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    X, y, _ = _reg_data(n=50, d=3)
    tdf = TDataFrame({"features": X, "label": y})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TLinReg().fit(tdf)
    model = TLinReg(device="cpu").fit(tdf)
    model.setDevice(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.transform(tdf)
