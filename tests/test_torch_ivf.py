"""Port parity: IVF-Flat approximate kNN (``spark_rapids_ml_tpu_torch.ops.
ivf_kernels``, ``ApproximateNearestNeighbors`` in ``models.knn``) and UMAP's
IVF graph engine against the JAX package, on the CPU.

Inputs are made with a seeded numpy generator. The heuristics, the gate,
the engine dispatch and the host capacity balance are the same arithmetic
and are held equal. The index build is held on Gaussian blobs: the sample
draw, the initial centres and the layout equal (lists, offsets, capacity,
ids, rows and norms); the quantizer's centres within rtol 1e-4 (Lloyd in
f32 in two summation orders). The port's search runs on the JAX package's
index, carried across as arrays: ids equal, squared distances within rtol
1e-5 (queries off the items, so no distance cancels to ~0). The JAX side's
dispatch is set through its environment, the port's through the module
constants ``ivf_kernels.UMAP_GRAPH`` and ``ANN_GATE_ROWS``.
"""

import logging

import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.data import DataFrame as JDataFrame
from spark_rapids_ml_tpu.knn import ApproximateNearestNeighbors as JANN
from spark_rapids_ml_tpu.knn import NearestNeighbors as JNN
from spark_rapids_ml_tpu.models import umap as jmu
from spark_rapids_ml_tpu.ops import ivf_kernels as jik
from spark_rapids_ml_tpu.parallel.mesh import make_mesh
from spark_rapids_ml_tpu.runtime import envspec
from spark_rapids_ml_tpu.umap import UMAP as JUMAP
from spark_rapids_ml_tpu_torch import DataFrame as TDataFrame
from spark_rapids_ml_tpu_torch.knn import ApproximateNearestNeighbors as TANN
from spark_rapids_ml_tpu_torch.knn import ApproximateNearestNeighborsModel as TANNModel
from spark_rapids_ml_tpu_torch.knn import NearestNeighbors as TNN
from spark_rapids_ml_tpu_torch.models import umap as tmu
from spark_rapids_ml_tpu_torch.ops import ivf_kernels as tik
from spark_rapids_ml_tpu_torch.umap import UMAP as TUMAP

_ENV = ("TPUML_UMAP_GRAPH", "TPUML_ANN_GATE_ROWS", "TPUML_ANN_NLIST", "TPUML_ANN_NPROBE", "TPUML_AUTOTUNE")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    """Both packages at their defaults unless a test sets otherwise."""
    for var in _ENV:
        monkeypatch.delenv(var, raising=False)


def _gate(monkeypatch, rows, mode="auto"):
    """The same dispatch in both packages: the JAX package's environment
    and the port's module constants."""
    monkeypatch.setenv("TPUML_ANN_GATE_ROWS", str(rows))
    monkeypatch.setenv("TPUML_UMAP_GRAPH", mode)
    monkeypatch.setattr(tik, "ANN_GATE_ROWS", rows)
    monkeypatch.setattr(tik, "UMAP_GRAPH", mode)


def _blobs(n, d, centers, seed, scale=4.0):
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(centers, d)) * scale
    return (c[rng.integers(0, centers, size=n)] + rng.normal(size=(n, d))).astype(np.float32)


def _carry(j):
    """The port's index from the JAX index's arrays."""
    return tik.ivf_index_from_arrays(
        np.asarray(j.centroids), np.asarray(j.grouped_x), np.asarray(j.grouped_sq), np.asarray(j.grouped_ids),
        j.offsets, j.lens, j.cap, j.nlist, j.n_rows)


# --------------------------------------------------------------------------
# heuristics, gate and dispatch
# --------------------------------------------------------------------------

_GRID = [4, 5, 100, 255, 256, 1000, 1023, 4096, 65_535, 131_072, 1_000_000]


def test_defaults_match_the_jax_environment():
    assert tik.UMAP_GRAPH == envspec.get("TPUML_UMAP_GRAPH") == "auto"
    assert tik.ANN_GATE_ROWS == envspec.get("TPUML_ANN_GATE_ROWS") == 131_072


@pytest.mark.parametrize("n", _GRID)
def test_heuristics_match_jax(n):
    assert tik.default_nlist(n) == jik.default_nlist(n)
    assert tik.resolve_ann_params(n) == jik.resolve_ann_params(n)
    for nlist in sorted({2, 8, 47, 48, 49, jik.default_nlist(n), 362, 1000}):
        assert tik.default_nprobe(nlist) == jik.default_nprobe(nlist)
        assert tik.hard_capacity(n, nlist) == jik.hard_capacity(n, nlist)
        for k in (1, 15, 16, 64, 128, n - 1, n):
            for nprobe in (1, 6, tik.default_nprobe(nlist), nlist):
                assert tik.ivf_feasible(n, k, nlist, nprobe) == jik.ivf_feasible(n, k, nlist, nprobe)


@pytest.mark.parametrize("n, nlist, nprobe", [(1000, 1, None), (100, 200, None), (1000, 16, 0), (1000, 16, 32),
                                              (1000, 16, 16), (1000, 0, 3), (3, 3, 1)])
def test_resolve_ann_params_and_errors_match_jax(n, nlist, nprobe):
    try:
        want = jik.resolve_ann_params(n, nlist=nlist, nprobe=nprobe)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tik.resolve_ann_params(n, nlist=nlist, nprobe=nprobe)
        assert str(got.value) == str(e)
    else:
        assert tik.resolve_ann_params(n, nlist=nlist, nprobe=nprobe) == want


@pytest.mark.parametrize("mode", ["auto", "exact", "ivf"])
def test_select_graph_engine_matches_jax(monkeypatch, mode):
    for gate in (1024, 131_072):
        _gate(monkeypatch, gate, mode)
        for n, k in [(100, 8), (300, 8), (1000, 16), (1000, 999), (4096, 16), (131_071, 16), (131_072, 16),
                     (131_072, 129), (1_000_000, 31)]:
            assert tik.select_graph_engine(n, k) == jik.select_graph_engine(n, k), (mode, gate, n, k)
        # explicit parameters, an out-of-domain one among them
        for nl, npb in ((8, 2), (4096, None), (64, 65)):
            got = tik.select_graph_engine(4096, 16, nlist=nl, nprobe=npb)
            assert got == jik.select_graph_engine(4096, 16, nlist=nl, nprobe=npb), (mode, nl, npb)


def test_explicit_ivf_on_an_infeasible_shape_warns_and_answers_exact(monkeypatch, caplog):
    _gate(monkeypatch, 131_072, "ivf")
    lg = logging.getLogger("spark_rapids_ml_tpu_torch.umap")
    lg.addHandler(caplog.handler)
    try:
        assert tik.select_graph_engine(100, 8) == "exact" == jik.select_graph_engine(100, 8)
    finally:
        lg.removeHandler(caplog.handler)
    assert any("falling back" in r.getMessage() for r in caplog.records)
    monkeypatch.setattr(tik, "UMAP_GRAPH", "bogus")
    with pytest.raises(ValueError, match="UMAP_GRAPH"):
        tik.select_graph_engine(4096, 16)


# --------------------------------------------------------------------------
# the capacity balance and the index build
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_balanced_assign_matches_jax_bit_for_bit(seed):
    """Skewed first choices, second choices that overflow too: both spill
    passes run."""
    rng = np.random.default_rng(seed)
    n, nlist = 3000, 12
    first = np.where(rng.random(n) < 0.55, 0, rng.integers(0, nlist, n))
    second = np.where(rng.random(n) < 0.7, 1, rng.integers(0, nlist, n))
    second = np.where(second == first, (first + 1) % nlist, second)
    idx_2 = np.stack([first, second], 1).astype(np.int32)
    d1 = rng.random(n).astype(np.float32) * 10
    d2_2 = np.stack([d1, d1 + rng.random(n).astype(np.float32)], 1)
    d2_2[:50, 1] = d2_2[:50, 0]  # zero margins: ties in the spill order
    cap = jik.hard_capacity(n, nlist)
    got = tik._balanced_assign(d2_2, idx_2, nlist, cap)
    want = jik._balanced_assign(d2_2, idx_2, nlist, cap)
    np.testing.assert_array_equal(got, want)
    counts = np.bincount(got, minlength=nlist)
    assert counts.max() <= cap
    # the first pass alone leaves list 1 overfull: the second pass ran
    after_first = first.copy()
    for l in np.flatnonzero(np.bincount(first, minlength=nlist) > cap):
        rows = np.flatnonzero(first == l)
        margin = d2_2[:, 1] - d2_2[:, 0]
        spill = rows[np.argsort(margin[rows], kind="stable")[: (first == l).sum() - cap]]
        after_first[spill] = second[spill]
    assert np.bincount(after_first, minlength=nlist).max() > cap


def _jax_index(X, nlist, seed):
    return jik.build_ivf_index(X, nlist=nlist, seed=seed, mesh=make_mesh(1))


@pytest.mark.parametrize("n, d, centers, nlist, seed", [(3000, 16, 12, 40, 0), (2500, 24, 5, 30, 3)])
def test_build_ivf_index_matches_jax(monkeypatch, n, d, centers, nlist, seed):
    """The training sample is drawn (``_TRAIN_SAMPLE`` patched below n in
    both packages), Lloyd runs, the layout is built."""
    monkeypatch.setattr(jik, "_TRAIN_SAMPLE", 1024)
    monkeypatch.setattr(tik, "_TRAIN_SAMPLE", 1024)
    X = _blobs(n, d, centers, seed + 10)
    j = _jax_index(X, nlist, seed)
    t = tik.build_ivf_index(X, nlist=nlist, seed=seed)
    assert (t.cap, t.nlist, t.n_rows) == (j.cap, j.nlist, j.n_rows)
    np.testing.assert_array_equal(t.lens, j.lens)
    np.testing.assert_array_equal(t.offsets, j.offsets)
    np.testing.assert_allclose(t.centroids.numpy(), np.asarray(j.centroids), rtol=1e-4, atol=1e-5)
    ids = t.grouped_ids.numpy()
    np.testing.assert_array_equal(ids, np.asarray(j.grouped_ids))
    real = ids >= 0
    np.testing.assert_array_equal(t.grouped_x.numpy()[real], np.asarray(j.grouped_x)[real])
    np.testing.assert_array_equal(t.grouped_sq.numpy()[real], np.asarray(j.grouped_sq)[real])
    assert np.isinf(t.grouped_sq.numpy()[~real]).all() and not t.grouped_x.numpy()[~real].any()
    np.testing.assert_array_equal(np.sort(ids[real]), np.arange(n))


def test_build_spills_rows_as_jax_does():
    """One hot blob and many lists: lists past the hard bound spill."""
    rng = np.random.default_rng(4)
    X = np.concatenate([rng.normal(size=(1500, 8)) * 0.01, rng.normal(size=(500, 8)) * 5]).astype(np.float32)
    j = _jax_index(X, 64, 1)
    t = tik.build_ivf_index(X, nlist=64, seed=1)
    assert j.lens.max() <= tik.hard_capacity(2000, 64) < np.bincount(
        tik._assign_top2(torch.from_numpy(X), t.centroids, chunk=2000)[1][:, 0].numpy(), minlength=64).max()
    np.testing.assert_array_equal(t.lens, j.lens)
    np.testing.assert_array_equal(t.grouped_ids.numpy(), np.asarray(j.grouped_ids))


# --------------------------------------------------------------------------
# the search, on the JAX package's index
# --------------------------------------------------------------------------


@pytest.mark.parametrize("nlist, nprobe, k", [(40, 6, 15), (40, 40, 10), (100, 3, 24), (100, 100, 24)])
def test_ivf_search_on_the_jax_index_matches_jax(nlist, nprobe, k):
    X = _blobs(1500 if nlist == 40 else 600, 12, 8, 21)
    Q = _blobs(200, 12, 8, 22)
    j = _jax_index(X, nlist, 5)
    t = _carry(j)
    if nlist == 100:
        assert t.cap < k  # the +inf / -1 pad of a narrow window
    jd2, jids = jik.ivf_search(Q, j, k=k, nprobe=nprobe)
    td2, tids = tik.ivf_search(torch.from_numpy(Q), t, k=k, nprobe=nprobe)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(td2.numpy(), np.asarray(jd2), rtol=1e-5)
    if nprobe == nlist:  # every list scanned: the exact neighbours
        Q64, X64 = Q.astype(np.float64), X.astype(np.float64)
        exact = np.argsort(((Q64[:, None] - X64[None]) ** 2).sum(-1), axis=1, kind="stable")[:, :k]
        np.testing.assert_array_equal(tids.numpy(), exact)


def test_ivf_search_ties_take_the_lower_position():
    """Each item three times: equal distances resolve by position in the
    merged row (earlier probe, then earlier slot), as ``lax.top_k`` does."""
    base = _blobs(400, 6, 4, 30)
    X = np.concatenate([base, base, base])
    j = _jax_index(X, 12, 2)
    Q = base[:64] + 2.0
    jd2, jids = jik.ivf_search(Q, j, k=9, nprobe=4)
    td2, tids = tik.ivf_search(torch.from_numpy(Q), _carry(j), k=9, nprobe=4)
    assert (tids.numpy()[:, 0] < 400).all()  # of three equal items, the first
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(td2.numpy(), np.asarray(jd2), rtol=1e-5)


# --------------------------------------------------------------------------
# the estimator
# --------------------------------------------------------------------------


def _ann_pair(monkeypatch, X, gate, **kw):
    _gate(monkeypatch, gate)
    jm = JANN(num_workers=1, **kw).fit(JDataFrame({"features": X}))
    tm = TANN(device="cpu", **kw).fit(TDataFrame({"features": X}))
    return jm, tm


@pytest.mark.parametrize("algo", [None, {"nlist": 24, "nprobe": 5, "seed": 7}])
def test_ann_kneighbors_and_join_match_jax_above_the_gate(monkeypatch, algo):
    X, Q = _blobs(1200, 10, 6, 40), _blobs(90, 10, 6, 41)
    kw = {"k": 7, **({"algoParams": algo} if algo else {})}
    jm, tm = _ann_pair(monkeypatch, X, 1, **kw)
    _, _, jk = jm.kneighbors(JDataFrame({"features": Q}))
    _, tq, tk = tm.kneighbors(TDataFrame({"features": Q}))
    for m in (jm, tm):
        assert m._ann_report["engine"] == "ivf"
    assert {k: tm._ann_report[k] for k in ("nlist", "nprobe")} == {k: jm._ann_report[k] for k in ("nlist",
                                                                                                  "nprobe")}
    assert tm._ann_report["build_seconds"] >= 0 and tm._ann_report["search_seconds"] >= 0
    assert tk.columns == jk.columns
    np.testing.assert_array_equal(tk.column("indices"), jk.column("indices"))
    np.testing.assert_allclose(tk.column("distances"), jk.column("distances"), rtol=1e-5)
    # the index is built once a model
    tm.kneighbors(TDataFrame({"features": Q[:5]}))
    assert len(tm._ivf_index_cache) == 1
    jj = jm.approxSimilarityJoin(JDataFrame({"features": Q, "tag": np.arange(90)}), distCol="dist")
    tj = tm.approxSimilarityJoin(TDataFrame({"features": Q, "tag": np.arange(90)}), distCol="dist")
    assert tj.columns == jj.columns
    for c in tj.columns:
        if c == "dist":
            np.testing.assert_allclose(tj.column(c), jj.column(c), rtol=1e-5)
        else:
            np.testing.assert_array_equal(tj.column(c), jj.column(c))


def test_ann_below_the_gate_answers_exact(monkeypatch):
    X, Q = _blobs(700, 8, 5, 50), _blobs(40, 8, 5, 51)
    jm, tm = _ann_pair(monkeypatch, X, 131_072, k=6)
    _, _, tk = tm.kneighbors(TDataFrame({"features": Q}))
    _, _, jk = jm.kneighbors(JDataFrame({"features": Q}))
    assert tm._ann_report == jm._ann_report == {"engine": "exact", "nlist": 26, "nprobe": 6}
    _, _, ek = TNN(k=6, device="cpu").fit(TDataFrame({"features": X})).kneighbors(TDataFrame({"features": Q}))
    for c in ("indices", "distances"):
        np.testing.assert_array_equal(tk.column(c), ek.column(c))
        np.testing.assert_allclose(tk.column(c), jk.column(c), rtol=1e-5)
    # above the gate on an infeasible shape (fewer than 256 rows): exact too
    jm, tm = _ann_pair(monkeypatch, X[:200], 1, k=4)
    tm.kneighbors(TDataFrame({"features": Q}))
    jm.kneighbors(JDataFrame({"features": Q}))
    assert tm._ann_report["engine"] == jm._ann_report["engine"] == "exact"


def _raised(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the type and text are compared
        return type(e), str(e)
    return None, None


def test_ann_errors_match_jax(monkeypatch):
    X = _blobs(300, 4, 3, 60)
    _gate(monkeypatch, 1)
    cases = [
        (lambda E, D, dev: E(k=3, algorithm="cagra", **dev).fit(D({"features": X}))),
        (lambda E, D, dev: E(k=3, algoParams={"n_lists": 8}, **dev)),
        (lambda E, D, dev: E(k=3, algoParams=[8, 2], **dev)),
        (lambda E, D, dev: E(k=3, algoParams={"nlist": 301}, **dev).fit(D({"features": X})).kneighbors(
            D({"features": X[:8]}))),
        (lambda E, D, dev: E(k=3, algoParams={"nlist": 1}, **dev).fit(D({"features": X})).kneighbors(
            D({"features": X[:8]}))),
        (lambda E, D, dev: E(k=301, **dev).fit(D({"features": X})).kneighbors(D({"features": X[:8]}))),
    ]
    for case in cases:
        jt, jmsg = _raised(lambda: case(JANN, JDataFrame, {"num_workers": 1}))
        tt, tmsg = _raised(lambda: case(TANN, TDataFrame, {"device": "cpu"}))
        assert jt is not None and tt is jt, (jt, jmsg, tt, tmsg)
        # the first clause: the port names no TPU engine
        assert tmsg.split(";")[0] == jmsg.split(";")[0], (jmsg, tmsg)
    for call in (TANN(k=3).write, TANN.read, TANNModel.read):
        with pytest.raises(NotImplementedError):
            call()
    est = TANN(k=3, device="cpu")
    assert est.fit(TDataFrame({"features": X}), params={"k": 5}).getK() == 5 and est.getK() == 3


# --------------------------------------------------------------------------
# UMAP's IVF graph
# --------------------------------------------------------------------------


def _record_graphs(monkeypatch, module, store):
    """Record the kNN graph each fit passes on (``drop_self_column``'s
    result) in ``store``."""
    real = module.drop_self_column

    def wrapped(dists, idx, *, k):
        out = real(dists, idx, k=k)
        store.append(tuple(np.asarray(o.cpu() if isinstance(o, torch.Tensor) else o) for o in out))
        return out

    monkeypatch.setattr(module, "drop_self_column", wrapped)


def test_umap_ivf_graph_matches_jax_above_the_gate(monkeypatch):
    X = _blobs(1500, 8, 6, 70, scale=3.0)
    _gate(monkeypatch, 1000)
    graphs = {"jax": [], "port": []}
    _record_graphs(monkeypatch, jmu, graphs["jax"])
    _record_graphs(monkeypatch, tmu, graphs["port"])
    kw = dict(n_neighbors=10, random_state=3, init="random", n_epochs=5)
    jm = JUMAP(num_workers=1, **kw).fit(JDataFrame({"features": X}))
    tm = TUMAP(device="cpu", **kw).fit(TDataFrame({"features": X}))
    jr, tr = jm._fit_report, tm._fit_report
    assert tr["graph_engine"] == jr["graph_engine"] == "ivf"
    assert (tr["ann_nlist"], tr["ann_nprobe"]) == (jr["ann_nlist"], jr["ann_nprobe"]) == (39, 6)
    (jd, ji), (td, ti) = graphs["jax"][0], graphs["port"][0]
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=2e-3)  # sqrt of a d2 that cancels near ~0 is not hit
    # the transform takes the IVF engine too, its index built once
    for part in (X[:50], X[50:90]):
        tm.transform(TDataFrame({"features": part}))
    jm.transform(JDataFrame({"features": X[:50]}))
    assert tm._transform_report["graph_engine"] == jm._transform_report["graph_engine"] == "ivf"
    assert len(tm._ivf_index_cache) == 1
    # pinning exact flips the transform of the same model
    monkeypatch.setattr(tik, "UMAP_GRAPH", "exact")
    tm.transform(TDataFrame({"features": X[:20]}))
    assert tm._transform_report["graph_engine"] == "exact"


def test_umap_default_engine_by_rows(monkeypatch):
    """At the defaults: fewer than 131,072 rows take the exact graph and
    131,072 rows the IVF graph, as in the JAX package. The fit asks the
    dispatch for its rows and k + 1 (a fit of 131,072 rows on the CPU
    takes too long here; ``chip_smoke.py``'s umap_ivf path fits one on the
    card)."""
    asked = []
    real = tik.select_graph_engine
    monkeypatch.setattr(tik, "select_graph_engine", lambda n, k, **kw: asked.append((n, k)) or real(n, k, **kw))
    rng = np.random.default_rng(80)
    small = TUMAP(n_neighbors=8, random_state=0, init="random", n_epochs=2, device="cpu").fit(
        TDataFrame({"features": rng.normal(size=(400, 4)).astype(np.float32)}))
    assert asked == [(400, 9)]
    assert small._fit_report["graph_engine"] == "exact" and "ann_nlist" not in small._fit_report
    for k in (16, 31, 128):
        assert real(131_071, k) == jik.select_graph_engine(131_071, k) == "exact"
        assert real(131_072, k) == jik.select_graph_engine(131_072, k) == "ivf"
    assert tik.resolve_ann_params(131_072) == jik.resolve_ann_params(131_072) == (362, 46)


def test_ann_without_device_needs_cuda(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    X = _blobs(400, 4, 3, 90)
    for gate in (1, 131_072):  # the IVF engine and the exact one
        _gate(monkeypatch, gate)
        model = TANN(k=3).fit(TDataFrame({"features": X}))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            model.kneighbors(TDataFrame({"features": X[:5]}))
