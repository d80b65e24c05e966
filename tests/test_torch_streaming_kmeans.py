"""Port parity: the streamed out-of-core KMeans (``spark_rapids_ml_tpu_torch/
ops/streaming.py``: the chunk steps through K2's plain version, the
streamed Lloyd loop, the k-means|| seeding passes; the estimator's
streaming fit function and its seeding split) against the JAX package on
the CPU.

The JAX side runs on a one-device mesh (``num_workers=1``); the port with
``device="cpu"``, where kernel K2 takes its plain version. Inputs come from
seeded numpy generators: a few hundred rows, d <= 8, k <= 6, chunks of
32-64 rows, so that every pass folds several chunks and a ragged last one.
The blobs keep every row clear of a near tie, so assignments (and counts)
agree exactly.

Tolerances:

* ``streamed_rows_at``, the counts, ``n_iter`` and the seeds: equal.
* sums, cost and min distances: both packages add the same f32 terms in
  other orders (K2's plain version scores ``||c||² - 2x·c``, the JAX step
  ``||x||² - 2x·c + ||c||²``), so an entry of n terms agrees within
  ``8·√n·u`` of the largest entry (u = 2⁻²⁴), as in
  ``tests/test_torch_streaming.py``; a min distance, whose expansion
  cancels, within ``8·√d·u`` of the largest ``||x||² + ||c||²``.
* streamed Lloyd: the same host f64 update on f32 sums that differ by a
  few ulps a pass, so centres at rtol 1e-5 (atol 1e-5) and the cost at
  rtol 1e-5.
* fitted models: as ``tests/test_torch_slice.py`` holds the resident fit
  (cost within 1e-3, centres matched to their counterparts within 1e-3),
  and port streamed against port resident at the JAX package's own
  streamed-vs-resident rtol 5e-3 (``tests/test_streaming.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_ml_tpu.clustering import KMeans as JKMeans
from spark_rapids_ml_tpu.data import DataFrame as JDataFrame
from spark_rapids_ml_tpu.data import chunks as jchunks
from spark_rapids_ml_tpu.ops import streaming as jst
from spark_rapids_ml_tpu.parallel.mesh import make_mesh
from spark_rapids_ml_tpu_torch import DataFrame as TDataFrame
from spark_rapids_ml_tpu_torch.clustering import KMeans as TKMeans
from spark_rapids_ml_tpu_torch.data import chunks as tchunks
from spark_rapids_ml_tpu_torch.models.clustering import _SeedTimes
from spark_rapids_ml_tpu_torch.ops import kmeans_kernels as tkk
from spark_rapids_ml_tpu_torch.ops import streaming as st

CPU = torch.device("cpu")
U = 2.0 ** -24
F32 = torch.float32


def _band(n):
    return 8.0 * np.sqrt(n) * U


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _blobs(n=420, d=6, k=5, seed=0, spread=1.0, scale=8.0):
    """k Gaussian blobs far apart (no row near a tie), off the origin."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)) * scale + 3.0
    X = centers[rng.integers(0, k, size=n)] + spread * rng.normal(size=(n, d))
    return X.astype(np.float32), centers.astype(np.float32)


def _padded_chunk(X, rows, n_valid):
    """(X, mask) of a chunk of ``rows`` rows, zero past ``n_valid``."""
    Xc = np.zeros((rows, X.shape[1]), np.float32)
    Xc[:n_valid] = X[:n_valid]
    m = np.zeros(rows, np.float32)
    m[:n_valid] = 1.0
    return Xc, m


def _sources(X):
    return tchunks.ArrayChunkSource(X), jchunks.ArrayChunkSource(X)


def _match(ct, cj):
    """Each port centre's nearest JAX centre; must be a permutation."""
    match = ((ct[:, None, :] - cj[None]) ** 2).sum(-1).argmin(axis=1)
    assert sorted(match.tolist()) == list(range(len(cj)))
    return match


# ---------------------------------------------------------------------------
# the chunk steps
# ---------------------------------------------------------------------------


def test_kmeans_chunk_step_matches_jax():
    X, C = _blobs(n=64, seed=1)
    Xc, m = _padded_chunk(X, 64, 50)
    acc_j = {"sums": jnp.zeros((5, 6), jnp.float32), "counts": jnp.zeros((5,), jnp.int32),
             "cost": jnp.zeros((), jnp.float32)}
    for _ in range(2):  # two chunks into one accumulator
        acc_j = jst.kmeans_chunk_step(acc_j, jnp.asarray(Xc), jnp.asarray(m), jnp.asarray(C))
    acc = {"sums": torch.zeros((5, 6)), "counts": torch.zeros((5,), dtype=torch.int32), "cost": torch.zeros(())}
    for _ in range(2):
        out = st.kmeans_chunk_step(acc, torch.from_numpy(Xc), torch.from_numpy(m), torch.from_numpy(C))
    assert out is acc and acc["counts"].dtype == torch.int32
    np.testing.assert_array_equal(acc["counts"].numpy(), np.asarray(acc_j["counts"]))
    assert int(acc["counts"].sum()) == 100  # the padding rows count in no centre
    assert _rel(acc["sums"].numpy(), acc_j["sums"]) <= _band(100)
    assert _rel(float(acc["cost"]), float(acc_j["cost"])) <= _band(100 * 6)


def test_chunk_min_sq_dists_matches_jax(monkeypatch):
    X, C = _blobs(n=64, seed=2)
    Xc, m = _padded_chunk(X, 64, 41)
    ref = np.asarray(jst.chunk_min_sq_dists(jnp.asarray(Xc), jnp.asarray(m), jnp.asarray(C)))
    tol = 8.0 * np.sqrt(6) * U * float((Xc ** 2).sum(1).max() + (C ** 2).sum(1).max())
    out = st.chunk_min_sq_dists(torch.from_numpy(Xc), torch.from_numpy(m), torch.from_numpy(C)).numpy()
    assert np.abs(out - ref).max() <= tol
    assert (out[41:] == 0).all() and (ref[41:] == 0).all()
    # the distance block's row split (here 3 rows a block) changes nothing
    monkeypatch.setattr(st, "_MIN_D2_BLOCK", 16)
    blocked = st.chunk_min_sq_dists(torch.from_numpy(Xc), torch.from_numpy(m), torch.from_numpy(C)).numpy()
    assert np.abs(blocked - ref).max() <= tol


def test_count_closest_chunk_step_matches_jax():
    X, C = _blobs(n=64, seed=3)
    Xc, m = _padded_chunk(X, 64, 57)
    # the blob centres and two points far from every row (counts 0)
    cands = np.concatenate([C, C[:2] + 60.0]).astype(np.float32)
    ref = jst.count_closest_chunk_step(jnp.zeros((7,), jnp.int32), jnp.asarray(Xc), jnp.asarray(m),
                                       jnp.asarray(cands))
    counts = torch.zeros((7,), dtype=torch.int32)
    st.count_closest_chunk_step(counts, torch.from_numpy(Xc), torch.from_numpy(m), torch.from_numpy(cands))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(ref))
    assert int(counts.sum()) == 57


# ---------------------------------------------------------------------------
# the seeding passes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("idx", [
    [299, 3, 150, 64, 0],            # unsorted, across chunks, the last row
    [7, 7, 130, 7, 299, 299],        # repeated
    [260, 271, 288],                 # all in the ragged last chunk
    [],
])
def test_streamed_rows_at_matches_jax_bit_for_bit(idx):
    X, _ = _blobs(n=300, seed=4)
    t_src, j_src = _sources(X)
    out = st.streamed_rows_at(t_src, 64, np.asarray(idx), F32)
    ref = jst.streamed_rows_at(j_src, 64, np.asarray(idx), np.float32)
    assert out.dtype == np.float32 and out.shape == (len(idx), 6)
    assert np.array_equal(out, ref)
    assert np.array_equal(out, X[np.sort(np.asarray(idx, np.int64))])


def test_streamed_rows_at_generator_source_and_past_the_end():
    X, _ = _blobs(n=300, seed=5)

    def gen(start, count, _seed):
        return X[start:start + count], None

    t_src = tchunks.GeneratorChunkSource(gen, 300, 6)
    j_src = jchunks.GeneratorChunkSource(gen, 300, 6)
    idx = np.asarray([299, 0, 128, 255, 256])
    assert np.array_equal(st.streamed_rows_at(t_src, 64, idx, F32), jst.streamed_rows_at(j_src, 64, idx, np.float32))
    with pytest.raises(IndexError):
        st.streamed_rows_at(t_src, 64, np.asarray([5, 300]), F32)
    with pytest.raises(IndexError):
        jst.streamed_rows_at(j_src, 64, np.asarray([5, 300]), np.float32)


def test_streamed_min_sq_dists_update_matches_jax():
    X, _ = _blobs(n=300, seed=6)
    t_src, j_src = _sources(X)
    mesh = make_mesh(1)
    c1, c2 = X[[3, 77]], X[[150, 220, 299]]
    out = st.streamed_min_sq_dists_update(t_src, CPU, 64, F32, c1)
    ref = jst.streamed_min_sq_dists_update(j_src, mesh, 64, jnp.float32, c1)
    assert out.dtype == np.float64 and out.shape == (300,)
    scale = float((X.astype(np.float64) ** 2).sum(1).max() + (c2.astype(np.float64) ** 2).sum(1).max())
    assert np.abs(out - ref).max() <= 8.0 * np.sqrt(6) * U * scale
    # folding into an existing array: the element-wise minimum
    out2 = st.streamed_min_sq_dists_update(t_src, CPU, 64, F32, c2, out.copy())
    ref2 = jst.streamed_min_sq_dists_update(j_src, mesh, 64, jnp.float32, c2, ref.copy())
    assert np.abs(out2 - ref2).max() <= 8.0 * np.sqrt(6) * U * scale
    assert (out2 <= out).all()


def test_streamed_count_closest_matches_jax():
    X, C = _blobs(n=300, seed=7)
    t_src, j_src = _sources(X)
    cands = np.concatenate([C, C[:1] - 60.0]).astype(np.float32)
    out = st.streamed_count_closest(t_src, CPU, 64, F32, cands)
    ref = jst.streamed_count_closest(j_src, make_mesh(1), 64, jnp.float32, cands)
    assert out.dtype == np.float64
    np.testing.assert_array_equal(out, ref)
    assert out.sum() == 300


# ---------------------------------------------------------------------------
# the streamed Lloyd loop
# ---------------------------------------------------------------------------


def _lloyd_case(case):
    X, C = _blobs(n=360, seed=8)
    rng = np.random.default_rng(9)
    centers0 = X[rng.choice(360, size=5, replace=False)]
    kw = {"tol": dict(max_iter=50, tol=1e-3), "max_iter": dict(max_iter=3, tol=0.0),
          "zero": dict(max_iter=0, tol=1e-4), "empty": dict(max_iter=20, tol=1e-4)}[case]
    if case == "empty":  # one centre far from every row: its cluster stays empty
        centers0 = np.concatenate([centers0[:4], np.full((1, 6), 500.0, np.float32)])
    return X, centers0.astype(np.float32), kw


@pytest.mark.parametrize("case", ["tol", "max_iter", "zero", "empty"])
def test_streamed_kmeans_lloyd_matches_jax(case):
    X, centers0, kw = _lloyd_case(case)
    t_src, j_src = _sources(X)
    st.reset_ingest_report()
    shifts = []
    c, cost, it = st.streamed_kmeans_lloyd(t_src, CPU, 48, F32, centers0, shifts=shifts, **kw)
    cj, cost_j, it_j = jst.streamed_kmeans_lloyd(j_src, make_mesh(1), 48, jnp.float32, centers0, **kw)
    assert it == it_j and len(shifts) == it
    assert c.dtype == np.float32 and isinstance(cost, float) and isinstance(it, int)
    np.testing.assert_allclose(c, np.asarray(cj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(cost, cost_j, rtol=1e-5)
    passes = st.last_ingest_report()["passes"]
    assert passes == ({"lloyd": it, "cost": 1} if it else {"cost": 1})
    if case == "tol":
        assert 0 < it < 50 and shifts[-1] <= 1e-6 < shifts[-2]
    if case == "max_iter":
        assert it == 3
    if case == "zero":
        assert it == 0 and np.array_equal(c, centers0)
    if case == "empty":
        assert np.array_equal(c[4], centers0[4]) and np.array_equal(np.asarray(cj)[4], centers0[4])


def test_streamed_kmeans_lloyd_matches_resident_port():
    """The same walk as the resident ``kmeans_lloyd`` on the plain path."""
    X, centers0, kw = _lloyd_case("max_iter")
    c, cost, it = st.streamed_kmeans_lloyd(tchunks.ArrayChunkSource(X), CPU, 48, F32, centers0, **kw)
    m = torch.ones(360)
    cr, cost_r, it_r = tkk.kmeans_lloyd(torch.from_numpy(X), m, torch.from_numpy(centers0), **kw)
    assert it == it_r
    np.testing.assert_allclose(c, cr.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(cost, cost_r, rtol=1e-5)


# ---------------------------------------------------------------------------
# the estimator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("init", ["random", "k-means||"])
def test_streamed_kmeans_fit_matches_jax(init):
    X, _ = _blobs(n=420, seed=10)
    kw = dict(k=5, initMode=init, seed=7, maxIter=30, streaming=True, stream_chunk_rows=64)
    tm = TKMeans(device="cpu", **kw).fit(TDataFrame({"features": X}))
    jm = JKMeans(num_workers=1, **kw).fit(JDataFrame({"features": X}))
    assert abs(tm.trainingCost - jm.trainingCost) / jm.trainingCost < 1e-3
    ct, cj = tm.cluster_centers_, jm.cluster_centers_
    match = _match(ct, cj)
    assert np.abs(ct - cj[match]).max() < 1e-3
    pt = np.asarray(tm.transform(TDataFrame({"features": X})).column("prediction"))
    pj = np.asarray(jm.transform(JDataFrame({"features": X})).column("prediction"))
    assert (match[pt] == pj).all()


@pytest.mark.parametrize("init", ["random", "k-means||"])
def test_streamed_kmeans_matches_resident(init):
    """Mirror of the JAX package's ``test_kmeans_streaming_matches_resident``:
    one seed, one sampling scheme, so the same seeds and the same optimum."""
    X, _ = _blobs(n=420, seed=11)
    df = TDataFrame({"features": X})
    kw = dict(k=5, initMode=init, seed=7, maxIter=30, device="cpu")
    m_res = TKMeans(streaming=False, **kw).fit(df)
    m_str = TKMeans(streaming=True, stream_chunk_rows=64, **kw).fit(df)
    assert m_res._ingest_report == {} and m_str._ingest_report["passes"]["cost"] == 1
    c_res = np.asarray(sorted(m_res.clusterCenters(), key=lambda c: tuple(c)))
    c_str = np.asarray(sorted(m_str.clusterCenters(), key=lambda c: tuple(c)))
    np.testing.assert_allclose(c_str, c_res, rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(m_str.trainingCost, m_res.trainingCost, rtol=5e-3)
    assert m_str.numIter == m_res.numIter


def test_streamed_kmeans_from_parquet_scan(tmp_path):
    """Mirror of ``test_kmeans_streaming_from_parquet_scan``: the scan
    streams by itself and stays on disk."""
    X, _ = _blobs(n=300, seed=12, k=4)
    TDataFrame({"features": X}).write_parquet(str(tmp_path / "km"), rows_per_file=70)
    scan = TDataFrame.scan_parquet(str(tmp_path / "km"))
    m = TKMeans(k=4, seed=3, stream_chunk_rows=64, device="cpu").fit(scan)
    assert not scan.is_materialized()
    assert m._ingest_report["passes"]["seed_count"] == 1
    m_res = TKMeans(k=4, seed=3, device="cpu").fit(TDataFrame({"features": X}))
    assert m.trainingCost <= m_res.trainingCost * 1.05
    out = m.transform(scan)
    assert not scan.is_materialized()
    assert np.asarray(out.column("prediction")).shape == (300,)


def test_streamed_kmeans_transform_assignments():
    """Mirror of ``test_kmeans_streaming_transform_assignments``, and the
    streamed model predicts as the resident one of the same seed."""
    X, _ = _blobs(n=260, seed=13, k=4)
    df = TDataFrame({"features": X})
    m = TKMeans(k=4, seed=1, streaming=True, stream_chunk_rows=50, device="cpu").fit(df)
    preds = np.asarray(m.transform(df).column("prediction"))
    assert preds.shape == (260,)
    assert set(np.unique(preds)) <= set(range(4))
    r = TKMeans(k=4, seed=1, device="cpu").fit(df)
    match = _match(m.cluster_centers_, r.cluster_centers_)
    assert (match[preds] == np.asarray(r.transform(df).column("prediction"))).all()


@pytest.mark.parametrize("init,passes", [
    ("random", {"seed_rows": 1, "cost": 1}),
    ("k-means||", {"seed_rows": 3, "seed_min_d2": 3, "seed_count": 1, "cost": 1}),
])
def test_ingest_report_counts_the_passes_by_kind(init, passes):
    X, _ = _blobs(n=300, seed=14)
    m = TKMeans(k=5, initMode=init, seed=2, maxIter=6, streaming=True, stream_chunk_rows=64,
                device="cpu").fit(TDataFrame({"features": X}))
    rep = m._ingest_report
    assert rep["passes"] == {**passes, "lloyd": m.numIter}
    assert set(rep["pass_s"]) == set(rep["passes"])
    # the device passes' chunks: 5 a pass (the seed_rows pass is host-only)
    assert rep["chunks"] == 5 * (sum(rep["passes"].values()) - rep["passes"]["seed_rows"])


@pytest.mark.parametrize("streaming", [False, True])
@pytest.mark.parametrize("init", ["random", "k-means||"])
def test_fit_report_splits_the_seeding(streaming, init):
    X, _ = _blobs(n=300, seed=15)
    m = TKMeans(k=5, initMode=init, seed=4, maxIter=5, streaming=streaming, stream_chunk_rows=64,
                device="cpu").fit(TDataFrame({"features": X}))
    rep = m._fit_report
    assert rep["init"] == init and rep["n_iter"] == m.numIter == len(rep["shifts"])
    parts = {"random": {"draws", "gather"}, "k-means||": {"draws", "gather", "min_d2", "count", "kmeanspp"}}[init]
    assert set(rep["seed_parts_s"]) == parts == set(rep["seed_calls"])
    assert all(v >= 0.0 for v in rep["seed_parts_s"].values())
    assert sum(rep["seed_parts_s"].values()) <= rep["seed_s"] + 1e-6
    assert rep["lloyd_s"] > 0.0
    if init == "k-means||":
        assert rep["seed_calls"] == {"draws": 3, "gather": 3, "min_d2": 3, "count": 1, "kmeanspp": 1}
        assert rep["seed_candidates"] > 5
    else:
        assert rep["seed_calls"] == {"draws": 1, "gather": 1} and rep["seed_candidates"] == 0
    # provenance, not persisted
    assert "_fit_report" not in m._model_attributes


def _numpy_owner(X):
    n = X.shape[0]

    def min_d2_vs(cands):
        return ((X[:, None, :].astype(np.float64) - cands[None]) ** 2).sum(-1).min(axis=1)

    def count_closest(cands):
        a = ((X[:, None, :].astype(np.float64) - cands[None]) ** 2).sum(-1).argmin(axis=1)
        return np.bincount(a, minlength=len(cands))

    return {"offset": 0, "n_local": n, "gather_local": lambda idx: X[idx], "assemble": lambda rows: rows,
            "min_d2_vs": min_d2_vs, "reduce_sum": lambda x: x, "count_closest": count_closest}


@pytest.mark.parametrize("k", [3, 6])
def test_timed_seeding_draws_what_jax_draws(k):
    X, _ = _blobs(n=400, d=8, k=6, seed=16)
    owner = _numpy_owner(X)
    times = _SeedTimes()
    ct = TKMeans._seed_scalable_kmeanspp(400, k, 2, 2.0, np.random.default_rng(9), owner, times)
    cj = JKMeans._seed_scalable_kmeanspp(400, k, 2, 2.0, np.random.default_rng(9), owner)
    np.testing.assert_array_equal(ct, cj)
    assert times.candidates > k and set(times.seconds) == {"draws", "gather", "min_d2", "count", "kmeanspp"}
    rt = TKMeans._seed_random(400, k, np.random.default_rng(3), owner, _SeedTimes())
    np.testing.assert_array_equal(rt, JKMeans._seed_random(400, k, np.random.default_rng(3), owner))


def test_streamed_and_resident_fits_start_from_the_same_seeds():
    """The streamed owner's host gather and the resident owner's index
    select give the same seeds, bit for bit, for both inits."""
    X, _ = _blobs(n=300, seed=17)
    df = TDataFrame({"features": X})
    for init in ("random", "k-means||"):
        kw = dict(k=5, initMode=init, seed=5, maxIter=0, device="cpu")
        a = TKMeans(streaming=True, stream_chunk_rows=64, **kw).fit(df)
        b = TKMeans(**kw).fit(df)
        assert np.array_equal(a.cluster_centers_, b.cluster_centers_)


def test_streamed_bfloat16_matmul_fits_and_typo_raises_before_any_pass():
    """A matmul dtype the fit does not know raises before any pass; a
    bf16 streamed fit runs its passes, the Lloyd ones under the bf16
    contract, and equals the resident bf16 fit."""
    X, _ = _blobs(n=200, seed=18)
    df = TDataFrame({"features": X})
    st.reset_ingest_report()
    with pytest.raises(ValueError, match="matmul_dtype"):
        TKMeans(k=3, matmul_dtype="fp8", streaming=True, stream_chunk_rows=64, device="cpu").fit(df)
    assert "passes" not in st.last_ingest_report()
    kw = dict(k=3, seed=4, maxIter=5, matmul_dtype="bfloat16", device="cpu")
    streamed = TKMeans(streaming=True, stream_chunk_rows=64, **kw).fit(df)
    assert streamed._ingest_report["passes"]["cost"] == 1
    resident = TKMeans(**kw).fit(df)
    np.testing.assert_allclose(streamed.cluster_centers_, resident.cluster_centers_, rtol=0, atol=1e-5)


def test_stream_decision_engages_kmeans(monkeypatch):
    from spark_rapids_ml_tpu_torch import core

    X, _ = _blobs(n=300, seed=19)
    df = TDataFrame({"features": X})
    monkeypatch.setattr(core, "_default_stream_threshold_bytes", lambda device: 1)
    streamed = TKMeans(k=5, seed=2, stream_chunk_rows=64, device="cpu").fit(df)
    assert streamed._ingest_report["passes"]["cost"] == 1
    monkeypatch.setattr(core, "_default_stream_threshold_bytes", lambda device: 1 << 40)
    assert TKMeans(k=5, seed=2, device="cpu").fit(df)._ingest_report == {}


# ---------------------------------------------------------------------------
# chip_smoke.py's north-star truth on the plain path
# ---------------------------------------------------------------------------


def _repeated_pool(seed=20, block=32, n_blocks=4, n_chunks=11, last=19, d=6):
    """A tiny north star: ``n_chunks`` chunks of ``block`` rows, each a
    view of one of ``n_blocks`` pool blocks (drawn from ``seed``), the last
    a ``last``-row prefix; with the pool rows' multiplicities."""
    X, _ = _blobs(n=block * n_blocks, d=d, seed=seed)
    order = np.random.default_rng(seed).integers(0, n_blocks, size=n_chunks)
    mult = np.repeat(np.bincount(order[:-1], minlength=n_blocks), block).astype(np.float32)
    mult[order[-1] * block:order[-1] * block + last] += 1.0
    rows = [X[b * block:(b + 1) * block] for b in order[:-1]] + [X[order[-1] * block:order[-1] * block + last]]
    return X, order, mult, np.concatenate(rows)


def test_chip_smoke_weighted_truth_equals_the_materialized_rows():
    import chip_smoke

    X, _, mult, full = _repeated_pool()
    C = torch.from_numpy(full[[0, 40, 99, 150, 200]])
    w = chip_smoke.lloyd_reference(torch, tkk, torch.from_numpy(X), torch.from_numpy(mult), C, chunk=32,
                                   weighted=True)
    r = chip_smoke.lloyd_reference(torch, tkk, torch.from_numpy(full), torch.ones(len(full)), C, chunk=32)
    assert int(w["counts"].sum()) == len(full)
    np.testing.assert_array_equal(w["counts"].numpy(), r["counts"].numpy())
    np.testing.assert_array_equal(w["near"].numpy(), r["near"].numpy())
    for key in ("sums", "cost", "T", "T_cost", "slack", "slack_cost"):
        np.testing.assert_allclose(w[key].numpy(), r[key].numpy(), rtol=1e-12, atol=1e-9)
    # the f64 walk too
    Cw, cost_w = chip_smoke.lloyd_walk64(torch, tkk, torch.from_numpy(X), torch.from_numpy(mult), C, 3)
    Cr, cost_r = chip_smoke.lloyd_walk64(torch, tkk, torch.from_numpy(full), torch.ones(len(full)), C, 3)
    np.testing.assert_allclose(Cw.numpy(), Cr.numpy(), rtol=1e-12, atol=1e-12)
    assert abs(cost_w - cost_r) <= 1e-9 * cost_r


def test_chip_smoke_seeds_map_through_the_chunk_order():
    """The streamed fit's random seeds over a generator of repeated views
    are the pool rows that ``rng.choice`` names through the chunk -> block
    map (the gather pass, its offsets and the last chunk's prefix), and its
    one-pass cost holds against the weighted truth at the streamed band."""
    import chip_smoke
    from spark_rapids_ml_tpu_torch.core import StreamInputs

    X, order, mult, full = _repeated_pool()
    block, N = 32, len(full)

    def gen(start, count, _seed):
        b = order[start // block]
        return X[b * block:b * block + count], None

    inputs = StreamInputs(source=tchunks.GeneratorChunkSource(gen, N, 6), device=CPU, n_rows=N, n_features=6,
                          chunk_rows=block)
    est = TKMeans(k=20, maxIter=0, initMode="random", seed=3, device="cpu")
    m = est._create_model(est._get_streaming_fit_func(None)(inputs, dict(est._tpu_params)))
    idx = np.sort(np.random.default_rng(3).choice(N, size=20, replace=False))
    C0 = X[order[idx // block] * block + idx % block]
    assert np.array_equal(m.cluster_centers_, C0) and np.array_equal(C0, full[idx])
    ref = chip_smoke.lloyd_reference(torch, tkk, torch.from_numpy(X), torch.from_numpy(mult), torch.from_numpy(C0),
                                     chunk=block, weighted=True)
    n_chunks = len(order)
    _, ratio = chip_smoke.held(torch, torch.tensor(m.trainingCost, dtype=torch.float64), ref["cost"], ref["T_cost"],
                               block, ref["slack_cost"], terms=chip_smoke.TOL_TERMS + n_chunks,
                               walk=chip_smoke.TOL_WALK * block ** 0.5)
    assert ratio <= 1.0
    # a pass that lost one chunk is caught
    _, lost = chip_smoke.held(torch, torch.tensor(m.trainingCost * (1 - 1 / n_chunks), dtype=torch.float64),
                              ref["cost"], ref["T_cost"], block, ref["slack_cost"],
                              terms=chip_smoke.TOL_TERMS + n_chunks, walk=chip_smoke.TOL_WALK * block ** 0.5)
    assert lost > 1.0


def test_chip_smoke_one_iteration_band_holds_on_the_plain_path():
    """``km_centre_bands`` on the plain path: one streamed and one resident
    Lloyd iteration from the same seeds within their bands of the f64
    iteration, and a centre moved by one row's share caught."""
    import chip_smoke

    X, _ = _blobs(n=400, seed=21)
    C0 = X[[0, 50, 100, 150, 200]]
    n, chunk = 400, 64
    ref = chip_smoke.lloyd_reference(torch, tkk, torch.from_numpy(X), torch.ones(n), torch.from_numpy(C0),
                                     chunk=chunk)
    c1, e_s, e_r = chip_smoke.km_centre_bands(torch, ref, torch.from_numpy(C0), n, chunk, -(-n // chunk))
    cs, _, _ = st.streamed_kmeans_lloyd(tchunks.ArrayChunkSource(X), CPU, chunk, F32, C0, max_iter=1, tol=0.0)
    cr, _, _ = tkk.kmeans_lloyd(torch.from_numpy(X), torch.ones(n), torch.from_numpy(C0), max_iter=1, tol=0.0)
    assert chip_smoke.centre_ratio(torch, cs, c1, e_s)[1] <= 1.0
    assert chip_smoke.centre_ratio(torch, cr.numpy(), c1, e_r)[1] <= 1.0
    bad = cs.copy()
    bad[2] += (X[0] - bad[2]) / float(ref["counts"][2])  # one row more in centre 2
    assert chip_smoke.centre_ratio(torch, bad, c1, e_s)[1] > 1.0
