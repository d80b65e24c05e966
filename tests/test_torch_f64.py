"""Port parity: float64 inputs (``float32_inputs=False``) through the
resident and streamed PCA, KMeans, LogisticRegression and LinearRegression
of ``spark_rapids_ml_tpu_torch`` against the JAX package's
``float32_inputs=False`` fits on the CPU.

The JAX package runs f64 end to end under a scoped x64, and its three
main-path Pallas kernels refuse f64 by dtype and leave it to XLA. The port
routes f64 by dtype the same way, before any kernel wrapper: the Gram pass
to ``ops.linalg.shifted_gram_scan``, the Lloyd pass to
``ops.kmeans_kernels.chunk_stats_xla``, the logistic objective to
``ops.logreg_kernels.data_loss_xla`` (autograd). Both sides run ``num_workers
=1`` on the same seeded numpy data.

Tolerances:

* closed forms (PCA's covariance and eigenpairs, OLS / ridge through
  Cholesky): rtol 1e-10 (atol 1e-12 on entries near zero);
* iterative fits: LogisticRegression atol 1e-4 (the JAX package's f64
  tests, ``tests/test_logistic_regression.py``), KMeans centres atol 1e-6
  with equal predictions (``tests/test_kmeans.py``), the elastic net's FISTA
  rtol 1e-8 (both run the same steps in f64);
* every output's dtype equals the JAX package's.

The JAX package's streamed f64 fits are not f64 throughout: its staging
thread runs outside the scoped x64, so each chunk reaches the card rounded
to f32 (JAX warns that float64 "will be truncated to dtype float32"), and
its label and feature means come back at f32 precision. The port's
streamed f64 fit ships f64 chunks, so it is held at the closed-form
tolerance against the port's and the JAX package's resident f64 fits, and
against the JAX package's streamed fit at the f32 streamed path's
tolerances (PCA rtol 2e-4 / atol 2e-5, LinearRegression rtol 5e-3 / atol
5e-4, as in ``tests/test_torch_wire.py``).
"""

import numpy as np
import pytest

from spark_rapids_ml_tpu.classification import LogisticRegression as JLogReg
from spark_rapids_ml_tpu.clustering import KMeans as JKMeans
from spark_rapids_ml_tpu.data import DataFrame as JDataFrame
from spark_rapids_ml_tpu.feature import PCA as JPCA
from spark_rapids_ml_tpu.regression import LinearRegression as JLinReg
from spark_rapids_ml_tpu_torch import DataFrame as TDataFrame
from spark_rapids_ml_tpu_torch import interop
from spark_rapids_ml_tpu_torch.classification import LogisticRegression as TLogReg
from spark_rapids_ml_tpu_torch.clustering import KMeans as TKMeans
from spark_rapids_ml_tpu_torch.feature import PCA as TPCA
from spark_rapids_ml_tpu_torch.feature import PCAModel as TPCAModel
from spark_rapids_ml_tpu_torch.ops import kmeans_kernels as tkk
from spark_rapids_ml_tpu_torch.ops import linalg as tlinalg
from spark_rapids_ml_tpu_torch.ops import linreg_kernels as tlrk
from spark_rapids_ml_tpu_torch.ops import logreg_kernels as tlk
from spark_rapids_ml_tpu_torch.ops import streaming as st
from spark_rapids_ml_tpu_torch.regression import LinearRegression as TLinReg

CLOSED = dict(rtol=1e-10, atol=1e-12)


def _data(n=600, d=8, seed=0, offset=3.0):
    """f64 features of unequal scales off the origin, a regression label,
    a binomial label, a 3-class label and row weights."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)) * rng.uniform(0.5, 3.0, size=d) + offset
    Xc = X - offset
    y = Xc @ rng.normal(size=d) + 2.5 + 0.3 * rng.normal(size=n)
    yb = (Xc @ rng.normal(size=d) * 0.5 + rng.logistic(size=n) > 0).astype(np.float64)
    y3 = np.argmax(Xc @ rng.normal(size=(d, 3)) * 0.5 + rng.gumbel(size=(n, 3)), axis=1).astype(np.float64)
    w = rng.uniform(0.1, 2.0, size=n)
    return {"features": X, "label": y, "yb": yb, "y3": y3, "w": w}


def _blobs(n=500, d=6, k=5, seed=1):
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(k, d)) * 6.0
    return centres[rng.integers(0, k, size=n)] + rng.normal(size=(n, d))


def _frames(cols):
    return JDataFrame(dict(cols)), TDataFrame(dict(cols))


def _assert_dtypes(tm, jm, tout=None, jout=None):
    """The fitted arrays and the output columns have the JAX package's dtypes."""
    for k, v in jm._model_attributes.items():
        if isinstance(v, np.ndarray) and k in tm._model_attributes:
            assert np.asarray(tm._model_attributes[k]).dtype == v.dtype, k
    if tout is not None:
        for c in jout.columns:
            if c not in ("features",):
                assert np.asarray(tout.column(c)).dtype == np.asarray(jout.column(c)).dtype, c


# ---------------------------------------------------------------------------
# resident fits against the JAX package's float32_inputs=False fits
# ---------------------------------------------------------------------------


def test_pca_f64_matches_jax():
    cols = {"features": _data()["features"]}
    jdf, tdf = _frames(cols)
    jm = JPCA(k=3, num_workers=1, float32_inputs=False).fit(jdf)
    tm = TPCA(k=3, device="cpu", float32_inputs=False).fit(tdf)
    for name in ("mean_", "components_", "explained_variance_", "explained_variance_ratio_", "singular_values_"):
        np.testing.assert_allclose(getattr(tm, name), np.asarray(getattr(jm, name)), err_msg=name, **CLOSED)
    tout, jout = tm.transform(tdf), jm.transform(jdf)
    np.testing.assert_allclose(tout.column("pca_features"), np.asarray(jout.column("pca_features")), **CLOSED)
    _assert_dtypes(tm, jm, tout, jout)
    assert tout.column("pca_features").dtype == np.float64


@pytest.mark.parametrize("init", ["random", "k-means||"])
def test_kmeans_f64_matches_jax(init):
    cols = {"features": _blobs()}
    jdf, tdf = _frames(cols)
    kw = dict(k=5, maxIter=10, seed=3, initMode=init, float32_inputs=False)
    jm = JKMeans(num_workers=1, **kw).fit(jdf)
    tm = TKMeans(device="cpu", **kw).fit(tdf)
    np.testing.assert_allclose(tm.cluster_centers_, np.asarray(jm.cluster_centers_), atol=1e-6)
    np.testing.assert_allclose(tm.trainingCost, jm.trainingCost, rtol=1e-10)
    assert tm.numIter == jm.numIter
    tout, jout = tm.transform(tdf), jm.transform(jdf)
    np.testing.assert_array_equal(tout.column("prediction"), np.asarray(jout.column("prediction")))
    _assert_dtypes(tm, jm, tout, jout)
    assert tm.cluster_centers_.dtype == np.float64
    assert tm.predict(cols["features"][7]) == jm.predict(cols["features"][7])


@pytest.mark.parametrize("case", ["binomial", "multinomial", "l1"])
def test_logreg_f64_matches_jax(case):
    data = _data()
    label = "y3" if case == "multinomial" else "yb"
    cols = {"features": data["features"], "label": data[label]}
    jdf, tdf = _frames(cols)
    kw = dict(regParam=0.01, maxIter=200, tol=1e-12, float32_inputs=False)
    if case == "l1":
        kw.update(elasticNetParam=1.0, regParam=0.02)
    jm = JLogReg(num_workers=1, **kw).fit(jdf)
    tm = TLogReg(device="cpu", **kw).fit(tdf)
    np.testing.assert_allclose(tm.coef_, np.asarray(jm.coef_), atol=1e-4)
    np.testing.assert_allclose(tm.intercept_, np.asarray(jm.intercept_), atol=1e-4)
    if case == "l1":
        assert (tm.coef_ == 0).sum() == (np.asarray(jm.coef_) == 0).sum()
    tout, jout = tm.transform(tdf), jm.transform(jdf)
    for c in ("prediction", "probability", "rawPrediction"):
        np.testing.assert_allclose(tout.column(c), np.asarray(jout.column(c)), atol=1e-4, err_msg=c)
    _assert_dtypes(tm, jm, tout, jout)
    assert tm.coef_.dtype == np.float64 and tout.column("probability").dtype == np.float64


@pytest.mark.parametrize("case", ["ols", "ridge", "elastic_net", "weighted"])
def test_linreg_f64_matches_jax(case):
    data = _data()
    cols = {"features": data["features"], "label": data["label"], "w": data["w"]}
    jdf, tdf = _frames(cols)
    kw = {"ols": {}, "ridge": dict(regParam=0.1), "elastic_net": dict(regParam=0.05, elasticNetParam=0.5),
          "weighted": dict(weightCol="w", regParam=0.01)}[case]
    jm = JLinReg(num_workers=1, float32_inputs=False, **kw).fit(jdf)
    tm = TLinReg(device="cpu", float32_inputs=False, **kw).fit(tdf)
    tol = dict(rtol=1e-8, atol=1e-10) if case == "elastic_net" else CLOSED
    np.testing.assert_allclose(tm.coefficients, np.asarray(jm.coefficients), **tol)
    np.testing.assert_allclose(tm.intercept, float(jm.intercept), **tol)
    if case == "elastic_net":
        assert tm._model_attributes["n_iter"] == jm._model_attributes["n_iter"]
    tout, jout = tm.transform(tdf), jm.transform(jdf)
    np.testing.assert_allclose(tout.column("prediction"), np.asarray(jout.column("prediction")), **tol)
    _assert_dtypes(tm, jm, tout, jout)
    assert tout.column("prediction").dtype == np.float64


# ---------------------------------------------------------------------------
# streamed fits: against the port's resident f64 fits and the JAX package's
# streamed float32_inputs=False fits
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["pca", "linreg", "logreg", "kmeans"])
def test_streamed_f64_matches_resident_and_jax(kind):
    data = _data(n=700)
    if kind == "kmeans":
        cols = {"features": _blobs(n=700)}
    elif kind == "logreg":
        cols = {"features": data["features"], "label": data["yb"]}
    else:
        cols = {"features": data["features"], "label": data["label"]}
    jdf, tdf = _frames(cols)
    J, T, kw = {"pca": (JPCA, TPCA, dict(k=3)), "linreg": (JLinReg, TLinReg, dict(regParam=0.1)),
                "logreg": (JLogReg, TLogReg, dict(regParam=0.01, maxIter=50, tol=1e-12)),
                "kmeans": (JKMeans, TKMeans, dict(k=5, maxIter=10, seed=2, initMode="random"))}[kind]
    kw = dict(kw, float32_inputs=False)
    ts = T(device="cpu", streaming=True, stream_chunk_rows=128, **kw).fit(tdf)
    tr = T(device="cpu", **kw).fit(tdf)
    jr = J(num_workers=1, **kw).fit(jdf)
    js = J(num_workers=1, streaming=True, stream_chunk_rows=128, **kw).fit(jdf)
    assert ts._ingest_report["chunks"] > 0
    names = {"pca": ("mean_", "components_", "explained_variance_"), "linreg": ("coefficients", "intercept"),
             "logreg": ("coef_", "intercept_"), "kmeans": ("cluster_centers_",)}[kind]
    tol = dict(atol=1e-4) if kind == "logreg" else dict(atol=1e-6) if kind == "kmeans" else CLOSED
    # the JAX package's streamed "f64" fit sees f32-rounded chunks (above)
    js_tol = {"pca": dict(rtol=2e-4, atol=2e-5), "linreg": dict(rtol=5e-3, atol=5e-4)}.get(kind, tol)
    for name in names:
        t = np.asarray(getattr(ts, name))
        assert t.dtype == np.float64, name
        for ref in (np.asarray(getattr(tr, name)), np.asarray(getattr(jr, name))):
            np.testing.assert_allclose(t, ref, err_msg=name, **tol)
        np.testing.assert_allclose(t, np.asarray(getattr(js, name)), err_msg=name, **js_tol)
    _assert_dtypes(ts, js)


def test_streamed_f64_f16_wire_matches_jax(monkeypatch):
    """At the f16 wire an f64 fit ships f16 and upcasts into f64: the fit of
    the f16-rounded rows, exactly (closed form against the port's resident
    f64 fit of those rows), and the JAX package's f16-wire fit at the f32
    streamed tolerance (its means come back at f32 precision, above)."""
    X = _data(n=500)["features"]
    jdf, tdf = _frames({"features": X})
    monkeypatch.setattr(st, "WIRE_DTYPE", "f16")
    monkeypatch.setenv("TPUML_WIRE_DTYPE", "f16")
    ts = TPCA(k=3, device="cpu", streaming=True, stream_chunk_rows=96, float32_inputs=False).fit(tdf)
    js = JPCA(k=3, num_workers=1, streaming=True, stream_chunk_rows=96, float32_inputs=False).fit(jdf)
    rounded = TPCA(k=3, device="cpu", float32_inputs=False).fit(
        TDataFrame({"features": X.astype(np.float16).astype(np.float64)}))
    assert ts._ingest_report["wire_dtype"] == "f16"
    for name in ("mean_", "components_", "explained_variance_"):
        np.testing.assert_allclose(getattr(ts, name), getattr(rounded, name), err_msg=name, **CLOSED)
        np.testing.assert_allclose(getattr(ts, name), np.asarray(getattr(js, name)), err_msg=name,
                                   rtol=2e-4, atol=2e-5)
    # and the wire's rounding shows against the f32 wire
    monkeypatch.setattr(st, "WIRE_DTYPE", "f32")
    full = TPCA(k=3, device="cpu", streaming=True, stream_chunk_rows=96, float32_inputs=False).fit(tdf)
    assert np.abs(full.mean_ - ts.mean_).max() > 1e-8


def test_streamed_transform_of_a_parquet_scan_at_f64(tmp_path):
    data = _data(n=400)
    path = str(tmp_path / "scan")
    TDataFrame({"features": data["features"], "label": data["label"]}).write_parquet(path, rows_per_file=150)
    scan = TDataFrame.scan_parquet(path)
    pm = TPCA(k=3, device="cpu", stream_chunk_rows=128, float32_inputs=False).fit(scan)
    assert pm._ingest_report["chunks"] > 0 and not scan.is_materialized()
    out = pm.transform(scan)
    assert type(out).__name__ == "AugmentedScanFrame" and not scan.is_materialized()
    proj = out.column("pca_features")
    assert proj.dtype == np.float64
    np.testing.assert_allclose(proj, data["features"] @ pm.components_.T, **CLOSED)
    jm = JPCA(k=3, num_workers=1, float32_inputs=False).fit(JDataFrame({"features": data["features"]}))
    np.testing.assert_allclose(pm.components_, np.asarray(jm.components_), **CLOSED)


def test_f64_model_save_load(tmp_path):
    cols = {"features": _data(n=300)["features"]}
    jdf, tdf = _frames(cols)
    tm = TPCA(k=2, device="cpu", float32_inputs=False).fit(tdf)
    tm.write().overwrite().save(str(tmp_path / "port"))
    loaded = TPCAModel.load(str(tmp_path / "port"))
    loaded.setDevice("cpu")
    assert loaded._float32_inputs is False and loaded.components_.dtype == np.float64
    out = loaded.transform(tdf).column("pca_features")
    assert out.dtype == np.float64
    np.testing.assert_array_equal(out, tm.transform(tdf).column("pca_features"))
    # a JAX f64 model carried across: float32Inputs false, f64 transform
    jm = JPCA(k=2, num_workers=1, float32_inputs=False).fit(jdf)
    jm.write().save(str(tmp_path / "jax"))
    cm = interop.load_jax_model(str(tmp_path / "jax"), device="cpu")
    assert cm._float32_inputs is False
    np.testing.assert_allclose(cm.transform(tdf).column("pca_features"),
                               np.asarray(jm.transform(jdf).column("pca_features")), **CLOSED)
    assert cm.transform(tdf).column("pca_features").dtype == np.float64


# ---------------------------------------------------------------------------
# the dtype routing, and the estimators that stay float32
# ---------------------------------------------------------------------------


def test_f64_route_taken_for_f64_and_never_for_f32(monkeypatch):
    """Each kernel wrapper (its plain version here) serves the f32 fits and
    never an f64 one; each f64 route serves the f64 fits and never an f32
    one, resident and streamed."""
    calls = {}

    def spy(module, name, key):
        real = getattr(module, name)

        def wrapped(*a, **k):
            calls[key] = calls.get(key, 0) + 1
            return real(*a, **k)

        monkeypatch.setattr(module, name, wrapped)

    for module, names in ((tlinalg, ("shifted_gram", "shifted_gram_scan")),
                          (tlrk, ("shifted_gram", "shifted_gram_scan")),
                          (tkk, ("lloyd_step", "chunk_stats_xla")),
                          (tlk, ("logreg_loss_grad", "data_loss_xla")),
                          (st, ("shifted_gram", "shifted_gram_scan", "logreg_loss_grad", "logreg_loss_grad_xla"))):
        for name in names:
            spy(module, name, "f64 route" if name.endswith(("_scan", "_xla")) else "kernel")
    data = _data(n=300)
    for dtype, used, unused in ((np.float32, "kernel", "f64 route"), (np.float64, "f64 route", "kernel")):
        calls.clear()
        cols = {"features": data["features"].astype(dtype), "label": data["yb"].astype(dtype)}
        tdf = TDataFrame(cols)
        for streaming in (False, True):
            kw = dict(device="cpu", float32_inputs=False, streaming=streaming, stream_chunk_rows=100)
            TPCA(k=2, **kw).fit(tdf)
            TLinReg(**kw).fit(tdf)
            TLogReg(maxIter=3, **kw).fit(tdf)
            TKMeans(k=3, maxIter=2, **kw).fit(tdf)
        assert calls.get(used, 0) > 0 and calls.get(unused, 0) == 0, (dtype, calls)


@pytest.mark.parametrize("est", ["rf_classifier", "rf_regressor", "gbt_classifier"])
def test_forests_and_gbt_refuse_f64(est):
    from spark_rapids_ml_tpu_torch import GBTClassifier, RandomForestClassifier, RandomForestRegressor

    data = _data(n=120, d=4)
    E = {"rf_classifier": RandomForestClassifier, "rf_regressor": RandomForestRegressor,
         "gbt_classifier": GBTClassifier}[est]
    label = "label" if est == "rf_regressor" else "yb"
    df64 = TDataFrame({"features": data["features"], "label": data[label]})
    kw = dict(maxDepth=3, device="cpu")
    with pytest.raises(NotImplementedError, match="3a-ii"):
        E(float32_inputs=False, **kw).fit(df64)
    # f32 data with the flag, or f64 data without it: a float32 fit
    df32 = TDataFrame({"features": data["features"].astype(np.float32), "label": data[label]})
    model = E(float32_inputs=False, **kw).fit(df32)
    assert E(**kw).fit(df64).transform(df64).column("prediction").shape == (120,)
    with pytest.raises(NotImplementedError, match="3a-ii"):
        model.transform(df64)


def test_umap_transform_coerces_f64_to_f32():
    from spark_rapids_ml_tpu_torch import UMAP

    X = _blobs(n=200, d=5)
    m = UMAP(n_neighbors=8, random_state=1, device="cpu", float32_inputs=False).fit(TDataFrame({"features": X}))
    emb = m.transform(TDataFrame({"features": X[:20]})).column("embedding")
    assert emb.dtype == np.float32 and emb.shape == (20, 2)
