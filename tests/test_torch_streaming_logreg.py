"""Port parity: the streamed out-of-core LogisticRegression
(``spark_rapids_ml_tpu_torch/ops/streaming.py::streamed_logreg_fit``, the
host L-BFGS/OWL-QN of ``ops/lbfgs.py`` and the estimator's streaming fit
function) against the JAX package on the CPU.

The JAX side runs on a one-device mesh (``num_workers=1``); the port with
``device="cpu"``, where kernel K3 takes its plain version. Inputs come from
seeded numpy generators: a few hundred rows, d <= 8, chunks of 32-64 rows,
so that every pass folds several chunks and a ragged last one.

Tolerances:

* ``minimize_lbfgs_host`` and ``streamed_label_stats``: equal bit for bit
  (the same numpy arithmetic on the same inputs).
* one chunk fold and the variance fold: both packages sum the same f32
  terms in other orders (K3's plain version and the chain rule in f64
  against XLA's ``value_and_grad`` in f32), so an entry of n rows agrees
  within ``8·√n·u`` of the largest entry (u = 2⁻²⁴), as in
  ``tests/test_torch_streaming.py``.
* fitted models: both run the same f64 host solver on f32 objective
  passes that differ by a few ulps an evaluation, so the iterates agree to
  a few ulps times the problem's conditioning; held at rtol 1e-3 / atol
  1e-4 (the JAX package's own streamed-vs-resident test allows 2e-2), and
  CSR against dense streamed fits at the JAX package's 1e-5.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from spark_rapids_ml_tpu.classification import LogisticRegression as JLogReg
from spark_rapids_ml_tpu.data import DataFrame as JDataFrame
from spark_rapids_ml_tpu.data import chunks as jchunks
from spark_rapids_ml_tpu.ops import lbfgs as jlbfgs
from spark_rapids_ml_tpu.ops import streaming as jst
from spark_rapids_ml_tpu_torch import DataFrame as TDataFrame
from spark_rapids_ml_tpu_torch.classification import LogisticRegression as TLogReg
from spark_rapids_ml_tpu_torch.data import chunks as tchunks
from spark_rapids_ml_tpu_torch.ops import lbfgs as tlbfgs
from spark_rapids_ml_tpu_torch.ops import logreg_kernels as lk
from spark_rapids_ml_tpu_torch.ops import streaming as st

CPU = torch.device("cpu")
U = 2.0 ** -24
RTOL, ATOL = 1e-3, 1e-4


def _band(n):
    return 8.0 * np.sqrt(n) * U


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _binomial(n=400, d=6, seed=0, offset=2.0):
    """Features off the origin at unequal scales, labels drawn from a
    logistic model (not separable)."""
    rng = np.random.default_rng(seed)
    Z = rng.normal(size=(n, d)) * rng.uniform(0.5, 2.0, size=d)
    p = 1.0 / (1.0 + np.exp(-(Z @ rng.normal(size=d) + 0.3)))
    return (Z + offset).astype(np.float32), (rng.uniform(size=n) < p).astype(np.float32)


def _multinomial(n=450, d=5, k=3, seed=1):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = np.argmax(X @ rng.normal(size=(k, d)).T + rng.gumbel(size=(n, k)), axis=1).astype(np.float32)
    return X, y


def _assert_models_close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(a.coefficientMatrix, b.coefficientMatrix, rtol=rtol, atol=atol)
    np.testing.assert_allclose(a.interceptVector, b.interceptVector, rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# minimize_lbfgs_host against the JAX package's, bit for bit
# ---------------------------------------------------------------------------


def _logistic_value_grad(seed=3, n=300, d=7, l2=0.05):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    beta = rng.normal(size=d) * (np.arange(d) < 3)  # the last features carry no signal
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-X @ beta))).astype(np.float64)

    def value_grad(w):
        z = X @ w[:d] + w[d]
        f = float(np.mean(np.logaddexp(0.0, z) - y * z)) + 0.5 * l2 * float(w[:d] @ w[:d])
        r = (1.0 / (1.0 + np.exp(-z)) - y) / n
        return f, np.concatenate([X.T @ r + l2 * w[:d], [r.sum()]])

    return value_grad, d + 1


@pytest.mark.parametrize("l1", [0.0, 0.05])
@pytest.mark.parametrize("max_iter,history", [(50, 10), (7, 3)])
def test_minimize_lbfgs_host_matches_jax_bit_for_bit(l1, max_iter, history):
    value_grad, p = _logistic_value_grad()
    trail = {"jax": [], "port": []}

    def traced(name):
        def vg(w):
            trail[name].append(np.array(w))
            return value_grad(w)
        return vg

    l1w = np.r_[np.full(p - 1, l1), 0.0] if l1 else None
    kw = dict(max_iter=max_iter, tol=1e-9, l1_weights=l1w, history=history)
    j = jlbfgs.minimize_lbfgs_host(traced("jax"), np.zeros(p), **kw)
    t = tlbfgs.minimize_lbfgs_host(traced("port"), np.zeros(p), **kw)
    assert len(trail["port"]) == len(trail["jax"]) > 2
    for a, b in zip(trail["port"], trail["jax"]):
        assert np.array_equal(a, b)
    assert isinstance(t.w, np.ndarray) and t.w.dtype == np.float64 and np.array_equal(t.w, np.asarray(j.w))
    # the JAX package hands f back as a jax array (f32 unless x64 is on)
    assert type(t.f) is float and bool(jnp.asarray(t.f) == j.f)
    assert type(t.n_iter) is int and t.n_iter == int(j.n_iter)
    assert type(t.converged) is bool and t.converged == bool(j.converged)
    if l1:
        assert (t.w[:-1] == 0.0).any()  # OWL-QN's orthant projection zeroes coefficients


# ---------------------------------------------------------------------------
# streamed_label_stats against the JAX package's, exactly
# ---------------------------------------------------------------------------


LABEL_CASES = {
    "binary": np.r_[np.zeros(40), np.ones(57)],
    "classes": np.arange(130) % 5,
    "fractional": np.r_[np.zeros(70), [0.5], np.ones(30)],
    "negative": np.r_[np.ones(60), [-1.0]],
    "single_one": np.ones(90),
    "single_zero": np.zeros(33),
}


@pytest.mark.parametrize("case", sorted(LABEL_CASES))
def test_streamed_label_stats_matches_jax(case):
    y = LABEL_CASES[case].astype(np.float32)
    X = np.zeros((y.size, 2), np.float32)
    ref = jst.streamed_label_stats(jchunks.ArrayChunkSource(X, y), 32)
    got = st.streamed_label_stats(tchunks.ArrayChunkSource(X, y), 32)
    assert got == ref
    assert {k: type(v) for k, v in got.items()} == {k: type(v) for k, v in ref.items()}


def test_streamed_label_stats_empty_raises_as_jax():
    X, y = np.zeros((0, 3), np.float32), np.zeros((0,), np.float32)
    with pytest.raises(ValueError, match="empty"):
        jst.streamed_label_stats(jchunks.ArrayChunkSource(X, y), 32)
    with pytest.raises(ValueError, match="empty"):
        st.streamed_label_stats(tchunks.ArrayChunkSource(X, y), 32)


# ---------------------------------------------------------------------------
# the folds against the JAX package's chunk steps
# ---------------------------------------------------------------------------


def test_var_chunk_step_matches_jax():
    X, _ = _binomial(n=64, d=8)
    mask = np.r_[np.ones(50), np.zeros(14)].astype(np.float32)
    mean = X[:50].mean(axis=0)
    ref = jst.var_chunk_step(jnp.zeros(8, jnp.float32), jnp.asarray(X), jnp.asarray(mask), jnp.asarray(mean))
    got = st.var_chunk_step(torch.zeros(8), torch.from_numpy(X), torch.from_numpy(mask), torch.from_numpy(mean))
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), np.asarray(ref)) <= _band(64)


@pytest.mark.parametrize("multinomial", [False, True])
@pytest.mark.parametrize("fit_intercept,use_center", [(True, True), (True, False), (False, False)])
def test_chunk_fold_matches_jax(multinomial, fit_intercept, use_center):
    rng = np.random.default_rng(4)
    n, d = 64, 6
    K = 4 if multinomial else 1
    X = (rng.normal(size=(n, d)) * 1.5 + 2.0).astype(np.float32)
    y = (rng.integers(0, K, size=n) if multinomial else rng.integers(0, 2, size=n)).astype(np.float32)
    mask = np.r_[np.ones(41), np.zeros(n - 41)].astype(np.float32)
    X[41:] = 0.0
    y[41:] = 0.0
    mean = (X[:41].mean(axis=0)).astype(np.float32)
    inv_std = (1.0 / X[:41].std(axis=0, ddof=1)).astype(np.float32)
    p = K * d + (K if fit_intercept else 0)
    w = rng.normal(size=p) * 0.3
    ref = jst.logreg_chunk_vg_step(
        {"f": jnp.zeros((), jnp.float32), "g": jnp.zeros((p,), jnp.float32)},
        jnp.asarray(X), jnp.asarray(mask), jnp.asarray(y), jnp.asarray(w, jnp.float32),
        jnp.asarray(mean if use_center else np.zeros(d, np.float32)), jnp.asarray(inv_std),
        n_classes=K, multinomial=multinomial, fit_intercept=fit_intercept, use_center=use_center)
    mean64, inv64 = mean.astype(np.float64), inv_std.astype(np.float64)
    A = w[:K * d].reshape(K, d)
    b = w[K * d:] if fit_intercept else np.zeros(K)
    Aeff, beff = st.logreg_effective(A, b, mean64, inv64, use_center)
    acc = {"f": torch.zeros(()), "gA": torch.zeros((K, d)), "gb": torch.zeros(K)}
    for _ in range(2):  # the fold adds in place
        st.logreg_chunk_vg_step(acc, torch.from_numpy(X), torch.from_numpy(mask), torch.from_numpy(y),
                                torch.from_numpy(Aeff.astype(np.float32)),
                                torch.from_numpy(np.asarray(beff, np.float32)), multinomial)
    assert all(v.dtype == torch.float32 for v in acc.values())
    g = st.logreg_flat_grad(acc["gA"].numpy() / 2, acc["gb"].numpy() / 2, mean64, inv64,
                            use_center=use_center, fit_intercept=fit_intercept)
    assert g.shape == (p,)
    assert abs(float(acc["f"]) / 2 - float(ref["f"])) <= _band(n) * abs(float(ref["f"]))
    # the band of the gradient is relative to Σ|r|·|x|, not to the entry
    # (the mean term cancels where use_center)
    scale = np.abs(np.asarray(ref["g"])).max() + (np.abs(mean64).max() * inv64.max() * n if use_center else 0)
    assert np.abs(g - np.asarray(ref["g"], np.float64)).max() <= _band(n) * scale


def test_the_objective_pass_folds_every_chunk_through_k3(monkeypatch):
    X, y = _binomial(n=300, d=5)
    folds, plain = [], []
    real_k3, real_plain = st.logreg_loss_grad, lk.logreg_loss_grad_plain

    def k3(Xc, *a):
        folds.append(tuple(Xc.shape))
        return real_k3(Xc, *a)

    def plain_version(*a):
        plain.append(1)
        return real_plain(*a)

    monkeypatch.setattr(st, "logreg_loss_grad", k3)
    monkeypatch.setattr(lk, "logreg_loss_grad_plain", plain_version)
    launches = lk.logreg_loss_grad.launches
    m = TLogReg(device="cpu", streaming=True, stream_chunk_rows=64, regParam=0.01, maxIter=4).fit(
        TDataFrame({"features": X, "label": y}))
    # 300 rows: four chunks and a ragged fifth, each folded once a pass
    assert folds == [(64, 5)] * (5 * m._ingest_report["passes"]["objective"])
    assert len(plain) == len(folds)  # on the CPU each fold is K3's plain version
    assert lk.logreg_loss_grad.launches == launches  # and no launch is counted


# ---------------------------------------------------------------------------
# streamed fits against the JAX package's streamed fits
# ---------------------------------------------------------------------------


BINOMIAL_CONFIGS = [
    dict(regParam=0.01),
    dict(regParam=0.01, standardization=False),
    dict(regParam=0.05, elasticNetParam=0.5),
    dict(regParam=0.01, fitIntercept=False),
]


@pytest.mark.parametrize("kwargs", BINOMIAL_CONFIGS)
def test_binomial_streamed_fit_matches_jax(kwargs):
    X, y = _binomial()
    cols = {"features": X, "label": y}
    t = TLogReg(device="cpu", streaming=True, stream_chunk_rows=56, **kwargs).fit(TDataFrame(cols))
    j = JLogReg(num_workers=1, streaming=True, stream_chunk_rows=56, **kwargs).fit(JDataFrame(cols))
    _assert_models_close(t, j)
    assert t.n_iter_ == j._model_attributes["n_iter"]
    assert t.numClasses == 2 and not t._multinomial
    assert t._ingest_report["passes"]["objective"] >= t.n_iter_ + 1
    # and the port's resident fit, at the JAX package's streamed-vs-resident tolerance
    _assert_models_close(t, TLogReg(device="cpu", **kwargs).fit(TDataFrame(cols)), rtol=2e-2, atol=2e-3)


def test_multinomial_streamed_fit_matches_jax():
    X, y = _multinomial()
    cols = {"features": X, "label": y}
    t = TLogReg(device="cpu", streaming=True, stream_chunk_rows=64, regParam=0.01).fit(TDataFrame(cols))
    j = JLogReg(num_workers=1, streaming=True, stream_chunk_rows=64, regParam=0.01).fit(JDataFrame(cols))
    assert t.numClasses == 3 and t._multinomial
    assert abs(float(t.interceptVector.sum())) < 1e-5  # the multinomial intercepts are centred
    _assert_models_close(t, j)
    df = TDataFrame(cols)
    p_t = t.transform(df).column("prediction")
    p_j = np.asarray(j.transform(JDataFrame(cols)).column("prediction"))
    assert (p_t == p_j).all()


def test_parquet_scan_streams_unmaterialized(tmp_path):
    X, y = _binomial(n=300, d=4, seed=6)
    path = str(tmp_path / "lr")
    TDataFrame({"features": X, "label": y}).write_parquet(path, rows_per_file=80)
    scan = TDataFrame.scan_parquet(path)
    t = TLogReg(device="cpu", stream_chunk_rows=64, regParam=0.01).fit(scan)  # a scan streams by itself
    assert not scan.is_materialized()
    assert set(t._ingest_report["passes"]) == {"labels", "moments", "variance", "objective"}
    j = JLogReg(num_workers=1, stream_chunk_rows=64, regParam=0.01).fit(JDataFrame.scan_parquet(path))
    _assert_models_close(t, j)
    _assert_models_close(t, TLogReg(device="cpu", streaming=True, stream_chunk_rows=64, regParam=0.01).fit(
        TDataFrame({"features": X, "label": y})), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("label", [0.0, 1.0])
def test_single_label_streamed_fit_matches_jax(label):
    X = np.random.default_rng(7).normal(size=(80, 3)).astype(np.float32)
    y = np.full(80, label, np.float32)
    t = TLogReg(device="cpu", streaming=True, stream_chunk_rows=32).fit(TDataFrame({"features": X, "label": y}))
    j = JLogReg(num_workers=1, streaming=True, stream_chunk_rows=32).fit(JDataFrame({"features": X, "label": y}))
    assert np.array_equal(t.interceptVector, j.interceptVector)
    assert np.isinf(t.interceptVector).all() and (t.coefficients == 0).all()
    assert (t.transform(TDataFrame({"features": X})).column("prediction") == label).all()
    assert t._ingest_report["passes"] == {"labels": 1}  # no pass over the features


def test_streamed_fit_refuses_bad_labels_as_jax():
    X = np.zeros((50, 2), np.float32)
    for y in (np.r_[np.zeros(49), [0.5]], np.r_[np.ones(49), [-1.0]]):
        cols = {"features": X, "label": y.astype(np.float32)}
        with pytest.raises(RuntimeError, match="non-negative integers"):
            TLogReg(device="cpu", streaming=True, stream_chunk_rows=32).fit(TDataFrame(cols))
        with pytest.raises(RuntimeError, match="non-negative integers"):
            JLogReg(num_workers=1, streaming=True, stream_chunk_rows=32).fit(JDataFrame(cols))


def _csr(n, d, seed, density=0.3):
    Xs = sp.random(n, d, density=density, format="csr", random_state=seed, dtype=np.float64)
    rng = np.random.default_rng(seed)
    z = np.asarray(Xs @ rng.normal(size=d)).ravel()
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-4.0 * (z - np.median(z))))).astype(np.float32)
    return Xs, y


def test_sparse_csr_streamed_fit_matches_jax():
    Xs, y = _csr(250, 8, 2)
    kw = dict(streaming=True, stream_chunk_rows=48, regParam=0.01)
    t = TLogReg(device="cpu", **kw).fit(TDataFrame({"features": Xs, "label": y}))
    j = JLogReg(num_workers=1, **kw).fit(JDataFrame({"features": Xs, "label": y}))
    _assert_models_close(t, j)


def test_sparse_opt_in_forces_the_stream():
    Xs, y = _csr(120, 6, 3)
    df = TDataFrame({"features": Xs, "label": y})
    opt = TLogReg(device="cpu", enable_sparse_data_optim=True, regParam=0.01)
    auto = TLogReg(device="cpu", regParam=0.01)
    assert opt._should_stream(df) is True
    assert auto._should_stream(df) is False  # small, no opt-in: densified, resident
    m = opt.fit(df)
    assert m._ingest_report["passes"]["objective"] > 0
    assert auto.fit(df)._ingest_report == {}
    j = JLogReg(num_workers=1, enable_sparse_data_optim=True, regParam=0.01).fit(
        JDataFrame({"features": Xs, "label": y}))
    _assert_models_close(m, j)


def test_csr_and_dense_streamed_fits_agree():
    Xs, y = _csr(220, 7, 5)
    kw = dict(device="cpu", streaming=True, stream_chunk_rows=48, regParam=0.01)
    m_csr = TLogReg(**kw).fit(TDataFrame({"features": Xs, "label": y}))
    m_dense = TLogReg(**kw).fit(TDataFrame({"features": np.asarray(Xs.todense(), np.float32), "label": y}))
    _assert_models_close(m_csr, m_dense, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the ingest report: passes by kind
# ---------------------------------------------------------------------------


def test_fit_multiple_shares_the_label_and_moment_passes():
    X, y = _binomial(n=350, d=5, seed=8)
    df = TDataFrame({"features": X, "label": y})
    grid = [{"regParam": 0.01}, {"regParam": 0.1, "elasticNetParam": 0.5}]
    est = TLogReg(device="cpu", streaming=True, stream_chunk_rows=64, maxIter=20)
    models = dict(est.fitMultiple(df, grid))
    rep = models[1]._ingest_report
    objective = rep["passes"]["objective"]
    assert rep["passes"] == {"labels": 1, "moments": 1, "variance": 1, "objective": objective}
    assert objective >= models[0].n_iter_ + models[1].n_iter_ + 2
    assert rep["chunks"] == 6 * (2 + objective)  # 350 rows in six chunks a pass
    assert set(rep["pass_s"]) == set(rep["passes"])
    assert rep["passes"]["objective"] > models[0]._ingest_report["passes"]["objective"]
    jmodels = dict(JLogReg(num_workers=1, streaming=True, stream_chunk_rows=64, maxIter=20).fitMultiple(
        JDataFrame({"features": X, "label": y}), grid))
    for i in range(2):
        _assert_models_close(models[i], jmodels[i])


# ---------------------------------------------------------------------------
# chip_smoke.py's f64 truth and band, on the plain path
# ---------------------------------------------------------------------------


def test_chip_smoke_band_holds_each_streamed_evaluation():
    """``chip_smoke.py`` holds the card's streamed evaluations to their f64
    truth at a band derived from the chunks (``LrTruth``); on the CPU the
    same check must pass on K3's plain version and catch a pass that lost
    a chunk."""
    import chip_smoke

    X, y = _binomial(n=500, d=6, seed=9)
    chunk = 64
    blocks = [(torch.from_numpy(X[a:a + chunk]), torch.from_numpy(y[a:a + chunk]), 1) for a in range(0, 500, chunk)]
    with chip_smoke.record_streamed_fit(st, lk) as rec:
        TLogReg(device="cpu", streaming=True, stream_chunk_rows=chunk, regParam=1e-3, maxIter=4).fit(
            TDataFrame({"features": X, "label": y}))
    assert rec["plain_calls"] == 8 * len(rec["evals"])  # the CPU folds through the plain version
    truth = chip_smoke.LrTruth(torch, lk, blocks, rec["moments"]["mean"], rec["moments"]["inv_std"], K=1, l2=1e-3,
                               chunk=chunk, n_chunks=len(blocks))
    for w, f, g in rec["evals"]:
        F, G, bands = truth(w, bands=True)
        ef, eg = bands["streamed"]
        assert abs(f - F) <= ef and (np.abs(g - G) <= eg).all()
    lost = chip_smoke.LrTruth(torch, lk, blocks[:-1], rec["moments"]["mean"], rec["moments"]["inv_std"], K=1,
                              l2=1e-3, chunk=chunk, n_chunks=len(blocks))
    F_lost, G_lost = lost(w)
    assert (np.abs(G_lost - G) > eg).any()
