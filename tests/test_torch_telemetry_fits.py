"""The instrumented slice as a whole: traced fits of the port against the
JAX package's traced fits on the CPU, and the port's traced fits against
its untraced ones.

Span trees: a resident PCA fit and a streamed LogisticRegression fit of
both packages on the same seeded rows (streamed by patching each
package's streaming threshold: the JAX package's
``TPUML_STREAM_THRESHOLD_BYTES``, the port's
``core._default_stream_threshold_bytes``), traced into a directory each
(``TPUML_TRACE``; ``telemetry.TRACE_DIR``). Tolerance: the multisets of
(span name, parent name) are equal over the names both packages open.
By design only the port opens ``kmeans.lloyd_pass`` in the resident Lloyd
(ROADMAP queue 3).

The port's own: traced fits equal untraced ones bit for bit (device time
on and off), the pass spans count the passes the ingest report counts,
every span has its parent in the tree and is no longer than it, and the
CV, ANN, UMAP and forest paths open their spans.
"""

import collections
import json
import os

import numpy as np
import pytest

from spark_rapids_ml_tpu.classification import LogisticRegression as JLogReg
from spark_rapids_ml_tpu.data import DataFrame as JDataFrame
from spark_rapids_ml_tpu.feature import PCA as JPCA
from spark_rapids_ml_tpu.runtime import telemetry as jtel
from spark_rapids_ml_tpu_torch import ApproximateNearestNeighbors, DataFrame, RandomForestClassifier
from spark_rapids_ml_tpu_torch import UMAP as TUMAP
from spark_rapids_ml_tpu_torch import core
from spark_rapids_ml_tpu_torch.classification import LogisticRegression as TLogReg
from spark_rapids_ml_tpu_torch.clustering import KMeans as TKMeans
from spark_rapids_ml_tpu_torch.evaluation import RegressionEvaluator
from spark_rapids_ml_tpu_torch.feature import PCA as TPCA
from spark_rapids_ml_tpu_torch.ops import ivf_kernels
from spark_rapids_ml_tpu_torch.regression import LinearRegression as TLinReg
from spark_rapids_ml_tpu_torch.runtime import counters
from spark_rapids_ml_tpu_torch.runtime import telemetry as ttel
from spark_rapids_ml_tpu_torch import tuning


@pytest.fixture(autouse=True)
def _clean():
    jtel.reset_telemetry()
    ttel.reset_telemetry()
    yield
    jtel.reset_telemetry()
    ttel.reset_telemetry()


def _rows(n=700, d=12, seed=5):
    rng = np.random.default_rng(seed)
    X = (rng.normal(size=(n, d)) * rng.uniform(0.5, 2.0, size=d) + 1.0).astype(np.float32)
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-(X @ rng.normal(size=d) * 0.5)))).astype(np.float32)
    return {"features": X, "label": y}


def _spans(d):
    """The X events of the one trace file in ``d``, each with its parent's
    name: [(name, parent name, args, ts, dur, parent's (ts, dur))]."""
    names = [n for n in os.listdir(d) if n.startswith("trace-")]
    assert len(names) == 1, names
    with open(os.path.join(d, names[0])) as f:
        xs = [e for e in json.load(f)["traceEvents"] if e["ph"] == "X"]
    by_id = {e["args"]["span_id"]: e for e in xs}
    out = []
    for e in xs:
        p = by_id.get(e["args"].get("parent_id"))
        if "parent_id" in e["args"]:
            assert p is not None, f"{e['name']}: parent {e['args']['parent_id']} not in the trace"
        out.append((e["name"], None if p is None else p["name"], e["args"], e["ts"], e["dur"],
                    None if p is None else (p["ts"], p["dur"])))
    return out


def _pairs(spans):
    return collections.Counter((name, parent) for name, parent, *_ in spans)


def _check_tree(spans, root):
    """Rooted at ``root``; every child within its parent's interval (µs,
    rounded to 3 decimals in the export)."""
    assert [s[0] for s in spans if s[1] is None] == [root]
    for name, parent, _, ts, dur, pt in spans:
        if pt is not None:
            assert dur <= pt[1] + 1e-3, (name, parent)
            assert pt[0] - 1e-3 <= ts and ts + dur <= pt[0] + pt[1] + 1e-2, (name, parent)


@pytest.mark.parametrize("case", ["pca_resident", "logreg_streamed"])
def test_span_tree_matches_jax(monkeypatch, tmp_path, case):
    cols = _rows()
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    monkeypatch.setenv("TPUML_TRACE", jdir)
    monkeypatch.setattr(ttel, "TRACE_DIR", tdir)
    if case == "pca_resident":
        JPCA(k=3, num_workers=1).fit(JDataFrame(dict(cols)))
        TPCA(k=3, device="cpu").fit(DataFrame(dict(cols)))
        root = "PCA.fit"
    else:
        monkeypatch.setenv("TPUML_STREAM_THRESHOLD_BYTES", "1")
        monkeypatch.setattr(core, "_default_stream_threshold_bytes", lambda device: 1)
        kw = dict(regParam=0.01, maxIter=3, stream_chunk_rows=128)
        jm = JLogReg(num_workers=1, **kw).fit(JDataFrame(dict(cols)))
        tm = TLogReg(device="cpu", **kw).fit(DataFrame(dict(cols)))
        assert tm._ingest_report["passes"]["objective"] > 1 and tm.n_iter_ == jm.n_iter_
        root = "LogisticRegression.fit"
    jspans, tspans = _spans(jdir), _spans(tdir)
    _check_tree(tspans, root)
    jp, tp = _pairs(jspans), _pairs(tspans)
    shared = {n for n, _ in jp} & {n for n, _ in tp}
    assert {k: v for k, v in tp.items() if k[0] in shared} == {k: v for k, v in jp.items() if k[0] in shared}
    assert {n for n, _ in tp} - shared == set()
    if case == "logreg_streamed":
        assert {"stream.ingest", "stream.decode", "stream.stage", "stream.fold", "stream.sync",
                "logreg.objective_pass"} <= shared
        assert ("stream.decode", "stream.ingest") in tp and ("stream.stage", "stream.ingest") in tp


def _traced_fits(cols, km_cols):
    """PCA resident, LogisticRegression and PCA streamed, KMeans resident
    and streamed: the values a fit leaves, as bytes."""
    df, kdf = DataFrame(dict(cols)), DataFrame(dict(km_cols))
    out = {}
    m = TPCA(k=3, device="cpu").fit(df)
    out["pca"] = (m.components_.tobytes(), m.explained_variance_.tobytes())
    m = TPCA(k=3, device="cpu", streaming=True, stream_chunk_rows=200).fit(df)
    out["pca_streamed"] = (m.components_.tobytes(), m.explained_variance_.tobytes(), m._ingest_report["passes"])
    m = TLogReg(regParam=0.01, maxIter=4, device="cpu", streaming=True, stream_chunk_rows=200).fit(df)
    out["logreg_streamed"] = (m.coefficientMatrix.tobytes(), m.interceptVector.tobytes(),
                              m._ingest_report["passes"])
    for streaming in (False, True):
        m = TKMeans(k=4, initMode="random", seed=2, maxIter=4, device="cpu", streaming=streaming,
                    stream_chunk_rows=200).fit(kdf)
        out[f"kmeans_{streaming}"] = (m.cluster_centers_.tobytes(), m.trainingCost, m.numIter)
    return out


def _km_rows(seed=9):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(4, 12)) * 6.0
    return {"features": (centers[rng.integers(0, 4, size=600)] + rng.normal(size=(600, 12))).astype(np.float32)}


def test_traced_fits_equal_untraced_and_count_their_passes(monkeypatch, tmp_path):
    cols, km_cols = _rows(), _km_rows()
    monkeypatch.chdir(tmp_path)
    plain = _traced_fits(cols, km_cols)
    assert os.listdir(tmp_path) == [] and ttel.span_stats() == {}
    for device_time in (False, True):
        ttel.reset_telemetry()
        d = tmp_path / f"trace_{device_time}"
        monkeypatch.setattr(ttel, "TRACE_DIR", str(d))
        monkeypatch.setattr(ttel, "DEVICE_TIME", device_time)
        assert _traced_fits(cols, km_cols) == plain
    spans = _spans(str(d))
    roots = [s[0] for s in spans if s[1] is None]
    assert roots == ["PCA.fit", "PCA.fit", "LogisticRegression.fit", "KMeans.fit", "KMeans.fit"]
    for name, parent, _, ts, dur, pt in spans:
        if pt is not None:
            assert dur <= pt[1] + 1e-3, (name, parent)
    stats = ttel.span_stats()
    pca_passes, lr_passes = plain["pca_streamed"][2], plain["logreg_streamed"][2]
    n_chunks = -(-700 // 200)
    assert pca_passes == {"moments": 1, "gram": 1}
    assert stats["suffstats.pass"]["count"] == 2
    assert stats["logreg.objective_pass"]["count"] == lr_passes["objective"]
    km_chunks = -(-600 // 200)
    km_stream_passes = plain["kmeans_True"][2] + 1
    chunked = sum(v for k, v in lr_passes.items() if k != "labels") + 2
    assert stats["stream.fold"]["count"] == n_chunks * chunked + km_chunks * km_stream_passes
    assert stats["stream.ingest"]["count"] == chunked + km_stream_passes
    lloyd = [s for s in spans if s[0] == "kmeans.lloyd_pass"]
    # iterations, then the final cost pass (iteration None), resident then streamed
    iters = [s[2]["iteration"] for s in lloyd]
    n_res, n_str = plain["kmeans_False"][2], plain["kmeans_True"][2]
    assert iters == list(range(n_res)) + [None] + list(range(n_str)) + [None]
    assert {s[1] for s in lloyd} == {"fit.dispatch"}
    folds = [s for s in spans if s[0] == "stream.fold"]
    assert {s[1] for s in folds} == {"stream.ingest"} and folds[0][2]["chunk"] == 0


def test_cv_fold_spans_and_failed_fits(monkeypatch, tmp_path):
    rng = np.random.default_rng(8)
    X = rng.normal(size=(240, 5))
    df = DataFrame({"features": X, "label": X @ rng.normal(size=5) + 0.1 * rng.normal(size=240)})
    poison = 12345.0

    class Flaky(TLinReg):
        def _supportsTransformEvaluate(self, eva):
            return False

        def fit(self, dataset, params=None):
            if params and any(v == poison for v in params.values()):
                raise RuntimeError("injected fit failure")
            return super().fit(dataset, params)

    est = Flaky(float32_inputs=False, device="cpu")
    grid = tuning.ParamGridBuilder().addGrid(est.getParam("regParam"), [0.0, poison]).build()
    cv = tuning.CrossValidator(estimator=est, estimatorParamMaps=grid, evaluator=RegressionEvaluator(),
                               numFolds=3, parallelism=3, seed=1)
    monkeypatch.setattr(tuning, "CV_FAILFAST", False)
    monkeypatch.setattr(ttel, "TRACE_DIR", str(tmp_path))
    base = counters.snapshot()
    cv.fit(df)
    assert counters.delta_since(base) == {"cv_failed_fits": 3}
    spans = _spans(str(tmp_path))
    folds = sorted(s[2]["fold"] for s in spans if s[0] == "cv.fold")
    assert folds == [0, 1, 2] and all(s[1] is None for s in spans if s[0] == "cv.fold")
    fits = collections.Counter(s[1] for s in spans if s[0] == "Flaky.fit")
    # one good fit a fold, in its fold's span on a pool thread; the refit of the best map
    assert fits == {"cv.fold": 3, None: 1}


def _blobs(n, d, k, seed):
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(k, d)) * 4.0
    return (c[rng.integers(0, k, size=n)] + rng.normal(size=(n, d))).astype(np.float32)


def test_ann_umap_and_forest_spans(monkeypatch, tmp_path):
    monkeypatch.setattr(ttel, "TRACE_DIR", str(tmp_path))
    monkeypatch.setattr(ivf_kernels, "ANN_GATE_ROWS", 300)
    X = _blobs(400, 8, 5, 3)
    ann = ApproximateNearestNeighbors(k=4, algoParams={"nlist": 8, "nprobe": 3}, device="cpu").fit(
        DataFrame({"features": X}))
    ann.kneighbors(DataFrame({"features": X[:30]}))
    assert ann._ann_report["engine"] == "ivf"
    um = TUMAP(n_neighbors=6, random_state=1, init="random", n_epochs=3, device="cpu").fit(
        DataFrame({"features": X}))
    assert um._fit_report["graph_engine"] == "ivf" and um._resilience_report == {}
    for part in (X[:20], X[20:40]):
        um.transform(DataFrame({"features": part}))
    y = (X[:, 0] > 0).astype(np.float32)
    RandomForestClassifier(numTrees=10, maxDepth=3, seed=1, device="cpu").fit(DataFrame({"features": X, "label": y}))
    spans = _spans(str(tmp_path))
    by_name = collections.defaultdict(list)
    for s in spans:
        by_name[s[0]].append(s)
    (a,) = by_name["ann.kneighbors"]
    assert a[1] is None and (a[2]["nlist"], a[2]["nprobe"]) == (8, 3)
    assert [s[1] for s in by_name["ann.kneighbors.build"] + by_name["ann.kneighbors.search"]] == [
        "ann.kneighbors", "ann.kneighbors"]
    assert [s[1] for s in by_name["umap.fit.graph"] + by_name["umap.fit.init"] + by_name["umap.fit.sgd"]] == [
        "UMAP.fit"] * 3
    (b,) = by_name["umap.ivf_build"]  # one build for both transforms
    assert b[2]["nlist"] == um._fit_report["ann_nlist"] and b[1] == "UMAPModel.transform"
    assert len(by_name["UMAPModel.transform"]) == 2
    groups = by_name["forest.grow_group"]
    assert [g[2]["trees"] for g in groups] == [8, 2] and {g[1] for g in groups} == {"fit.dispatch"}
    assert {(g[2]["hist_strategy"], g[2]["gather"]) for g in groups} == {("compact", False)}
