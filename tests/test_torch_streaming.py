"""Port parity: the streamed out-of-core path (``spark_rapids_ml_tpu_torch/
ops/streaming.py``, the stream decision in ``core.py``, and the streamed
PCA and LinearRegression fits) against the JAX package on the CPU.

The JAX side runs on a one-device mesh (``num_workers=1``); the port with
``device="cpu"``, where kernel K1 takes its plain version and the staging
ring is a plain copy. Inputs come from seeded numpy generators at small
sizes, with chunks of a few hundred rows so that every pass folds several
chunks and a ragged last one.

Tolerances: both packages accumulate the same f32 sums over the same
chunks in other orders, so a statistic of n rows agrees within
``8·√n·u`` of the largest entry (u = 2⁻²⁴; the random-walk band of an f32
sum of n terms, with room for the per-chunk products); the counts are
exact. Fitted models are held to the JAX package's own tolerances for a
streamed fit against a resident one (``tests/test_streaming.py``): PCA
rtol 2e-4 / atol 2e-5, LinearRegression rtol 5e-3 / atol 5e-4.
"""

import threading

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from spark_rapids_ml_tpu.classification import LogisticRegression as JLogReg
from spark_rapids_ml_tpu.clustering import KMeans as JKMeans
from spark_rapids_ml_tpu.data import DataFrame as JDataFrame
from spark_rapids_ml_tpu.data import chunks as jchunks
from spark_rapids_ml_tpu.feature import PCA as JPCA
from spark_rapids_ml_tpu.ops import streaming as jst
from spark_rapids_ml_tpu.parallel.mesh import make_mesh
from spark_rapids_ml_tpu.regression import LinearRegression as JLinReg
from spark_rapids_ml_tpu_torch import DataFrame as TDataFrame
from spark_rapids_ml_tpu_torch import core
from spark_rapids_ml_tpu_torch.classification import LogisticRegression as TLogReg
from spark_rapids_ml_tpu_torch.clustering import KMeans as TKMeans
from spark_rapids_ml_tpu_torch.data import chunks as tchunks
from spark_rapids_ml_tpu_torch.feature import PCA as TPCA
from spark_rapids_ml_tpu_torch.ops import streaming as st
from spark_rapids_ml_tpu_torch.regression import LinearRegression as TLinReg

CPU = torch.device("cpu")
U = 2.0 ** -24


def _band(n):
    return 8.0 * np.sqrt(n) * U


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _reg(n=2500, d=16, seed=0, offset=3.0):
    """Features of unequal scales off the origin, labels from a plane plus
    noise, row weights in [0.1, 2]."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)) * rng.uniform(0.5, 3.0, size=d) + offset
    y = (X - offset) @ rng.normal(size=d) + 2.5 + 0.3 * rng.normal(size=n)
    w = rng.uniform(0.1, 2.0, size=n)
    return X.astype(np.float32), y.astype(np.float32), w.astype(np.float32)


def _low_rank(n=2500, d=24, k=4, seed=1):
    """k well-separated principal directions plus small noise."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(d, k)))
    Z = rng.normal(size=(n, k)) * np.array([5.0, 4.0, 3.0, 2.0])[:k]
    return (Z @ Q.T + 0.05 * rng.normal(size=(n, d)) + 1.0).astype(np.float32)


# ---------------------------------------------------------------------------
# the rings: order, errors, shutdown
# ---------------------------------------------------------------------------


def _pass(source, chunk_rows=96, **kw):
    return [(c.n_valid, dev["X"].clone(), dev["mask"].clone(),
             None if dev["y"] is None else dev["y"].clone())
            for c, dev in st.iter_device_chunks(source, CPU, chunk_rows, **kw)]


@pytest.mark.parametrize("prefetch,stage", [(0, 0), (1, 0), (0, 1), (1, 1), (2, 2), (5, 3)])
def test_ring_order_does_not_depend_on_depths(monkeypatch, prefetch, stage):
    X, y, w = _reg(n=1000, d=5)
    src = tchunks.ArrayChunkSource(X, y, w)
    base = _pass(src)
    ref = st.streamed_suffstats(src, CPU, 96, with_y=True)
    monkeypatch.setattr(st, "_PREFETCH_DEPTH", prefetch)
    monkeypatch.setattr(st, "_STAGE_DEPTH", stage)
    got = _pass(src)
    assert [g[0] for g in got] == [b[0] for b in base] == [96] * 10 + [40]
    for a, b in zip(got, base):
        for u, v in zip(a[1:], b[1:]):
            assert torch.equal(u, v)
    stats = st.streamed_suffstats(src, CPU, 96, with_y=True)
    for k, v in ref.items():
        assert torch.equal(stats[k], v), k


class _FailingSource(tchunks.ArrayChunkSource):
    """Yields ``good`` chunks, then raises in the decode thread."""

    def __init__(self, X, good):
        super().__init__(X)
        self._good = good

    def iter_chunks(self, chunk_rows, dtype=np.float32):
        for i, c in enumerate(super().iter_chunks(chunk_rows, dtype)):
            if i == self._good:
                raise OSError("decode failed")
            yield c


def _ring_threads():
    return [t for t in threading.enumerate() if t.name in ("chunk-prefetch", "chunk-stage") and t.is_alive()]


def test_decode_error_reaches_the_consumer_after_its_chunks():
    X, _, _ = _reg(n=1000, d=4)
    got = []
    with pytest.raises(OSError, match="decode failed"):
        for c, _ in st.iter_device_chunks(_FailingSource(X, 3), CPU, 100):
            got.append(c.n_valid)
    assert got == [100, 100, 100]
    assert not _ring_threads()


def test_stage_error_reaches_the_consumer(monkeypatch):
    X, _, _ = _reg(n=1000, d=4)
    calls = []
    put = st.put_chunk

    def flaky(chunk, *a, **k):
        calls.append(chunk.n_valid)
        if len(calls) == 4:
            raise MemoryError("staging failed")
        return put(chunk, *a, **k)

    monkeypatch.setattr(st, "put_chunk", flaky)
    got = []
    with pytest.raises(MemoryError, match="staging failed"):
        for c, _ in st.iter_device_chunks(tchunks.ArrayChunkSource(X), CPU, 100):
            got.append(c.n_valid)
    assert got == [100, 100, 100]
    assert not _ring_threads()


def test_closing_early_leaves_no_live_thread():
    X, _, _ = _reg(n=5000, d=4)
    it = st.iter_device_chunks(tchunks.ArrayChunkSource(X), CPU, 50)
    next(it)
    next(it)
    assert _ring_threads()
    it.close()
    assert not _ring_threads()
    # the decode ring alone
    pre = st.prefetch_chunks(iter(range(1000)), depth=2)
    assert next(pre) == 0
    pre.close()
    assert not _ring_threads()


def test_put_chunk_columns_mask_and_f16_storage():
    rng = np.random.default_rng(3)
    X16 = rng.normal(size=(8, 3)).astype(np.float16)
    y = rng.normal(size=8).astype(np.float32)
    c = tchunks.Chunk(X=X16, n_valid=5, y=y, w=y)
    dev = st.put_chunk(c, CPU, need_w=False)
    assert dev["X"].dtype == torch.float32
    assert torch.equal(dev["X"], torch.from_numpy(X16.astype(np.float32)))
    assert dev["mask"].tolist() == [1.0] * 5 + [0.0] * 3
    assert torch.equal(dev["y"], torch.from_numpy(y)) and dev["w"] is None
    assert st.put_chunk(c, CPU, need_y=False)["y"] is None


def test_stream_guard_releases_every_sync_period():
    g = st.StreamGuard()
    dev = {"X": torch.zeros(2, 2)}
    for i in range(1, 10):
        g.tick(dev)
        assert len(g._pending) == i % st._SYNC_EVERY
    g.flush()
    assert not g._pending


# ---------------------------------------------------------------------------
# streamed_suffstats against the JAX package's
# ---------------------------------------------------------------------------


def _sources(kind, X, y, w):
    if kind == "csr":
        Xs = sp.csr_matrix(np.where(np.abs(X - 3.0) > 1.5, X, 0.0))
        return jchunks.CSRChunkSource(Xs, y, w), tchunks.CSRChunkSource(Xs, y, w)
    return jchunks.ArrayChunkSource(X, y, w), tchunks.ArrayChunkSource(X, y, w)


@pytest.mark.parametrize("with_y,weighted,fit_intercept,kind", [
    (False, False, True, "dense"), (True, False, True, "dense"), (True, True, True, "dense"),
    (True, False, False, "dense"), (True, True, False, "dense"), (False, True, True, "dense"),
    (True, False, True, "csr"), (True, True, True, "csr"),
])
def test_streamed_suffstats_matches_jax(with_y, weighted, fit_intercept, kind):
    n = 2300
    X, y, w = _reg(n=n, d=12)
    jsrc, tsrc = _sources(kind, X, y, w if weighted else None)
    ref = jst.streamed_suffstats(jsrc, make_mesh(1), 256, jnp.float32, with_y=with_y, fit_intercept=fit_intercept)
    got = st.streamed_suffstats(tsrc, CPU, 256, torch.float32, with_y=with_y, fit_intercept=fit_intercept)
    keys = {"n", "mean_x", "mean_all", "G", "var"} | ({"mean_y", "Xy", "yy"} if with_y else set())
    assert set(got) == keys and keys <= set(ref)
    for k in sorted(keys):
        assert got[k].dtype == torch.float32, k
        assert _rel(got[k].numpy(), np.asarray(ref[k])) <= _band(n), k
    if not weighted:
        assert float(got["n"]) == float(ref["n"]) == n


# ---------------------------------------------------------------------------
# streamed fits against the JAX package's and the port's resident fits
# ---------------------------------------------------------------------------


def _pca_attrs(m):
    return {"mean": m.mean_, "components": m.components_, "ev": m.explained_variance_,
            "evr": m.explained_variance_ratio_, "sv": m.singular_values_}


def _assert_pca_close(a, b):
    for k, v in _pca_attrs(b).items():
        np.testing.assert_allclose(_pca_attrs(a)[k], v, rtol=2e-4, atol=2e-5, err_msg=k)


@pytest.mark.parametrize("chunk_rows", [64, 300, 4096])
def test_pca_streamed_fit_matches_jax_and_resident(chunk_rows):
    X = _low_rank()
    t = TPCA(k=4, device="cpu", streaming=True, stream_chunk_rows=chunk_rows).fit(TDataFrame({"features": X}))
    j = JPCA(k=4, num_workers=1, streaming=True, stream_chunk_rows=chunk_rows).fit(JDataFrame({"features": X}))
    _assert_pca_close(t, j)
    _assert_pca_close(t, TPCA(k=4, device="cpu", streaming=False).fit(TDataFrame({"features": X})))
    assert t._ingest_report["passes"] == {"moments": 1, "gram": 1}
    assert t._ingest_report["chunks"] == 2 * -(-X.shape[0] // chunk_rows)


LINREG_CASES = [
    dict(regParam=0.0),
    dict(regParam=0.1),
    dict(regParam=0.1, elasticNetParam=0.5, maxIter=200),
    dict(regParam=0.0, fitIntercept=False),
    dict(regParam=0.05, standardization=False),
    dict(regParam=1e-5, elasticNetParam=0.5),
    dict(regParam=1e-5),
]


def _assert_linreg_close(a, b):
    np.testing.assert_allclose(a.coefficients, b.coefficients, rtol=5e-3, atol=5e-4)
    np.testing.assert_allclose(float(a.intercept), float(b.intercept), rtol=5e-3, atol=5e-4)


@pytest.mark.parametrize("kwargs", LINREG_CASES)
def test_linreg_streamed_fit_matches_jax_and_resident(kwargs):
    X, y, _ = _reg()
    cols = {"features": X, "label": y}
    t = TLinReg(device="cpu", streaming=True, stream_chunk_rows=300, **kwargs).fit(TDataFrame(cols))
    j = JLinReg(num_workers=1, streaming=True, stream_chunk_rows=300, **kwargs).fit(JDataFrame(cols))
    _assert_linreg_close(t, j)
    _assert_linreg_close(t, TLinReg(device="cpu", streaming=False, **kwargs).fit(TDataFrame(cols)))
    assert t._model_attributes["n_iter"] == j._model_attributes["n_iter"] or kwargs.get("elasticNetParam")


def test_linreg_streamed_weighted_matches_jax_and_resident():
    X, y, w = _reg(n=1800, d=10)
    cols = {"features": X, "label": y, "w": w}
    kw = dict(weightCol="w", regParam=0.01)
    t = TLinReg(device="cpu", streaming=True, stream_chunk_rows=128, **kw).fit(TDataFrame(cols))
    j = JLinReg(num_workers=1, streaming=True, stream_chunk_rows=128, **kw).fit(JDataFrame(cols))
    _assert_linreg_close(t, j)
    _assert_linreg_close(t, TLinReg(device="cpu", streaming=False, **kw).fit(TDataFrame(cols)))


def test_linreg_streamed_sparse_csr_matches_jax_and_dense():
    rng = np.random.default_rng(5)
    n, d = 1200, 20
    Xs = sp.random(n, d, density=0.3, format="csr", random_state=1, dtype=np.float64)
    y = np.asarray(Xs @ rng.normal(size=d)).ravel().astype(np.float32)
    Xd = np.asarray(Xs.todense(), np.float32)
    t = TLinReg(device="cpu", streaming=True, stream_chunk_rows=100, regParam=0.01).fit(
        TDataFrame({"features": Xs, "label": y}))
    j = JLinReg(num_workers=1, streaming=True, stream_chunk_rows=100, regParam=0.01).fit(
        JDataFrame({"features": Xs, "label": y}))
    _assert_linreg_close(t, j)
    _assert_linreg_close(t, TLinReg(device="cpu", streaming=False, regParam=0.01).fit(
        TDataFrame({"features": Xd, "label": y})))


def test_streamed_fits_from_a_parquet_scan_do_not_materialize(tmp_path):
    X, y, _ = _reg(n=1500, d=8)
    path = str(tmp_path / "p")
    TDataFrame({"features": X, "label": y}).write_parquet(path, rows_per_file=400)
    scan = TDataFrame.scan_parquet(path)
    pca = TPCA(k=3, device="cpu", stream_chunk_rows=128).fit(scan)  # a scan streams by itself
    lr = TLinReg(device="cpu", stream_chunk_rows=128, regParam=0.01).fit(scan)
    assert not scan.is_materialized()
    assert pca._ingest_report["passes"] == lr._ingest_report["passes"] == {"moments": 1, "gram": 1}
    jscan = JDataFrame.scan_parquet(path)
    _assert_pca_close(pca, JPCA(k=3, num_workers=1, stream_chunk_rows=128).fit(jscan))
    _assert_linreg_close(lr, JLinReg(num_workers=1, stream_chunk_rows=128, regParam=0.01).fit(jscan))
    df = TDataFrame({"features": X, "label": y})
    _assert_pca_close(pca, TPCA(k=3, device="cpu").fit(df))
    _assert_linreg_close(lr, TLinReg(device="cpu", regParam=0.01).fit(df))
    # streaming=False takes the resident path, which reads the scan
    TPCA(k=3, device="cpu", streaming=False).fit(scan)
    assert scan.is_materialized()


def test_fit_multiple_streamed_makes_one_stats_pass(monkeypatch):
    X, y, _ = _reg(n=1500, d=6)
    df = TDataFrame({"features": X, "label": y})
    calls = []
    real = st.streamed_suffstats

    def counted(*a, **k):
        calls.append(k["fit_intercept"])
        return real(*a, **k)

    monkeypatch.setattr(st, "streamed_suffstats", counted)
    grid = [{"regParam": 0.0}, {"regParam": 0.1}, {"regParam": 1.0},
            {"regParam": 1e-5, "elasticNetParam": 0.5}, {"regParam": 0.1, "fitIntercept": False}]
    est = TLinReg(device="cpu", streaming=True, stream_chunk_rows=128)
    models = dict(est.fitMultiple(df, grid))
    assert calls == [True, False]  # one pair of passes a fit_intercept value
    assert [models[i]._fit_report["stats_cached"] for i in range(5)] == [False, True, True, True, False]
    assert models[4]._ingest_report["passes"] == {"moments": 2, "gram": 2}
    norms = [np.linalg.norm(models[i].coefficients) for i in range(3)]
    assert norms[0] > norms[1] > norms[2]
    jmodels = dict(JLinReg(num_workers=1, streaming=True, stream_chunk_rows=128).fitMultiple(
        JDataFrame({"features": X, "label": y}), grid))
    for i in range(5):
        _assert_linreg_close(models[i], jmodels[i])
        _assert_linreg_close(models[i], est._with_params(grid[i]).fit(df))


# ---------------------------------------------------------------------------
# the stream decision
# ---------------------------------------------------------------------------


def test_default_stream_threshold_on_the_cpu():
    assert core._default_stream_threshold_bytes(CPU) == 8 << 30


@pytest.mark.parametrize("threshold", [1, 10_000, 1 << 40])
def test_should_stream_matches_jax(monkeypatch, tmp_path, threshold):
    """The decision against the JAX package's, at thresholds below, near
    and above the 48,000-byte design matrix (1,500 × 8 f32)."""
    monkeypatch.setattr(core, "_default_stream_threshold_bytes", lambda device: threshold)
    monkeypatch.setenv("TPUML_STREAM_THRESHOLD_BYTES", str(threshold))
    X, y, _ = _reg(n=1500, d=8)
    path = str(tmp_path / "q")
    TDataFrame({"features": X, "label": y}).write_parquet(path, rows_per_file=500)
    Xs = sp.csr_matrix(np.where(X > 3.5, X, 0.0))
    frames = [
        ({"features": X, "label": y}, None),
        ({"features": Xs, "label": y}, None),
        (None, path),
    ]
    for cols, scan_path in frames:
        for streaming in (None, True, False):
            for T, J, kw in ((TPCA, JPCA, {"k": 2}), (TLinReg, JLinReg, {}),
                             (TLogReg, JLogReg, {"enable_sparse_data_optim": True}), (TKMeans, JKMeans, {"k": 2})):
                t_df = TDataFrame.scan_parquet(scan_path) if scan_path else TDataFrame(cols)
                j_df = JDataFrame.scan_parquet(scan_path) if scan_path else JDataFrame(cols)
                t = T(device="cpu", streaming=streaming, **kw)
                j = J(num_workers=1, streaming=streaming, **kw)
                assert t._should_stream(t_df) == j._should_stream(j_df), (T.__name__, streaming, scan_path)


def test_auto_threshold_engages_streaming(monkeypatch):
    X, y, _ = _reg(n=1000, d=8)
    df = TDataFrame({"features": X, "label": y})
    monkeypatch.setattr(core, "_default_stream_threshold_bytes", lambda device: 1)
    streamed = TLinReg(device="cpu", stream_chunk_rows=200).fit(df)
    assert streamed._ingest_report["passes"] == {"moments": 1, "gram": 1}
    monkeypatch.setattr(core, "_default_stream_threshold_bytes", lambda device: 1 << 40)
    resident = TLinReg(device="cpu").fit(df)
    assert resident._ingest_report == {}
    _assert_linreg_close(streamed, resident)


def test_streamed_fit_refuses_float64_inputs():
    """Float64 inputs are no longer refused: the streamed f64 fit (f64
    chunks, K1's float64 route) matches the JAX package's streamed
    float32_inputs=False fit and the port's resident f64 fit."""
    X, y, _ = _reg(n=100, d=3)
    cols = {"features": X.astype(np.float64), "label": y.astype(np.float64)}
    t = TLinReg(device="cpu", streaming=True, stream_chunk_rows=32, float32_inputs=False).fit(TDataFrame(cols))
    j = JLinReg(num_workers=1, streaming=True, stream_chunk_rows=32, float32_inputs=False).fit(JDataFrame(cols))
    r = TLinReg(device="cpu", float32_inputs=False).fit(TDataFrame(cols))
    jr = JLinReg(num_workers=1, float32_inputs=False).fit(JDataFrame(cols))
    assert t._ingest_report["passes"] == {"moments": 1, "gram": 1}
    assert t.coefficients.dtype == np.asarray(j.coefficients).dtype == np.float64
    for ref in (np.asarray(j.coefficients), r.coefficients):
        np.testing.assert_allclose(t.coefficients, ref, rtol=1e-10, atol=1e-12)
    for ref in (r.intercept, float(jr.intercept)):
        np.testing.assert_allclose(t.intercept, ref, rtol=1e-10, atol=1e-12)
    # the JAX package's streamed label mean comes back rounded to f32
    # (2e-8 relative here), so its streamed intercept is held at that level
    np.testing.assert_allclose(t.intercept, float(j.intercept), rtol=1e-6)
