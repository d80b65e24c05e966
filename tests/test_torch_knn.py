"""Port parity: exact kNN (``spark_rapids_ml_tpu_torch.ops.knn_kernels``,
kernel K4's plain version, and ``models.knn``) against the JAX package.

Inputs are made with a seeded numpy generator. Against the search and the
estimator (``ring_knn``, ``lax.top_k`` order) they are integer-valued f32
blobs: every product and sum of the scores ``‖xi‖² − 2xq·xi`` is exact in
f32, so both packages compute the same scores bit for bit whatever their
summation order, and the many exact ties must go to the lower id in both.
So ids and distances are held to equality.

The JAX Pallas pass runs in interpret mode on the CPU. It breaks exact ties
by its slot order, not by id, so it is held on data with no ties and no
near ties: items on distinct shells around blob centres, queries near the
centres (ids equal, distances rtol 1e-5 for f32 rounding in two orders).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_ml_tpu.data import DataFrame as JDataFrame
from spark_rapids_ml_tpu.knn import NearestNeighbors as JNN
from spark_rapids_ml_tpu.ops.knn_kernels import ring_knn
from spark_rapids_ml_tpu.ops.knn_pallas import knn_pallas_pass
from spark_rapids_ml_tpu.parallel.mesh import make_mesh, shard_rows
from spark_rapids_ml_tpu_torch import DataFrame as TDataFrame
from spark_rapids_ml_tpu_torch.knn import NearestNeighbors as TNN
from spark_rapids_ml_tpu_torch.ops import knn_kernels as tkn


def _blobs(rng, n, d, k=12):
    """Integer-valued blobs: |x| <= 8, so ‖x‖² and x·y stay far below 2^24."""
    centers = rng.integers(-6, 7, size=(k, d))
    return (centers[rng.integers(0, k, size=n)] + rng.integers(-2, 3, size=(n, d))).astype(np.float32)


def _boundary_ties(Xq, Xi, k):
    """Rows whose k-th and (k+1)-th nearest items are at equal distance:
    there the tie rule, not the distance, decides the neighbour set."""
    q, i = Xq.astype(np.float64), Xi.astype(np.float64)
    s = np.sort((q * q).sum(1)[:, None] - 2 * q @ i.T + (i * i).sum(1)[None], axis=1)
    return int((s[:, k - 1] == s[:, k]).sum())


def _row_sorted(d, i):
    """Rows of a (score, id) state sorted by (score, id)."""
    o = np.stack([np.lexsort((ri, rd)) for rd, ri in zip(d, i)])
    return np.take_along_axis(d, o, 1), np.take_along_axis(i, o, 1)


def _shells(rng, nq, ni, d, n_blobs=16):
    """Items of blob c at radii 1 + 0.25·j (j a random rank, so ids and
    radii are unrelated) in random directions; queries within 0.1 of a
    centre. A query's distances to its blob's items follow the radii, with
    gaps >= 0.5 against perturbations of at most 0.2·r·|cos| and f32
    rounding of ~1e-3: no ties, no near ties."""
    centers = rng.normal(size=(n_blobs, d)) * 3.0
    lab = np.arange(ni) % n_blobs
    radius = np.empty(ni)
    for c in range(n_blobs):
        radius[lab == c] = 1.0 + 0.25 * rng.permutation((lab == c).sum())
    u = rng.normal(size=(ni, d))
    Xi = centers[lab] + radius[:, None] * u / np.linalg.norm(u, axis=1, keepdims=True)
    e = rng.normal(size=(nq, d))
    Xq = centers[rng.integers(0, n_blobs, nq)] + 0.1 * e / np.linalg.norm(e, axis=1, keepdims=True)
    return Xq.astype(np.float32), Xi.astype(np.float32)


@pytest.mark.parametrize("k", [1, 16])
def test_knn_topk_plain_matches_pallas_interpret(k):
    nq = ni = 2048  # the Pallas pass takes whole (2048, 1024) blocks
    d = 256
    Xq, Xi = _shells(np.random.default_rng(k), nq, ni, d)
    csq = (Xi * Xi).sum(axis=1).astype(np.float32)
    ids = np.arange(ni, dtype=np.int32)
    td0 = np.full((nq, k), np.inf, np.float32)
    ti0 = np.full((nq, k), -1, np.int32)
    jd, ji = knn_pallas_pass(
        jnp.asarray(Xq), jnp.asarray(Xi), jnp.asarray(csq[None]), jnp.asarray(ids[None]),
        jnp.asarray(td0), jnp.asarray(ti0), interpret=True,
    )
    jd, ji = _row_sorted(np.asarray(jd), np.asarray(ji))  # the TPU kernel's slots are unordered
    td, ti = tkn.knn_topk_pass(
        torch.from_numpy(Xq), torch.from_numpy(Xi), torch.from_numpy(csq), torch.from_numpy(ids),
        torch.from_numpy(td0), torch.from_numpy(ti0),
    )
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), ji)
    xsq = (Xq.astype(np.float64) ** 2).sum(axis=1)[:, None]
    np.testing.assert_allclose(td.numpy() + xsq, jd + xsq, rtol=1e-5)


def test_knn_topk_folds_in_passes_and_masks():
    # two passes (the second starting from the first's state) equal one;
    # masked items (+inf through csq) are never selected
    rng = np.random.default_rng(3)
    Xq, Xi = _blobs(rng, 300, 20), _blobs(rng, 1000, 20)
    csq = torch.from_numpy((Xi * Xi).sum(axis=1))
    csq[100:200] = float("inf")
    ids = torch.arange(1000, dtype=torch.int32)
    st = (torch.full((300, 8), float("inf")), torch.full((300, 8), -1, dtype=torch.int32))
    q, x = torch.from_numpy(Xq), torch.from_numpy(Xi)
    one = tkn.knn_topk_pass(q, x, csq, ids, *st)
    mid = tkn.knn_topk_pass(q, x[:400], csq[:400], ids[:400], *st)
    two = tkn.knn_topk_pass(q, x[400:], csq[400:], ids[400:], *mid)
    np.testing.assert_array_equal(one[1].numpy(), two[1].numpy())
    np.testing.assert_array_equal(one[0].numpy(), two[0].numpy())
    assert not ((one[1] >= 100) & (one[1] < 200)).any()
    # fewer valid items than k: the unfilled slots keep (+inf, -1)
    few = tkn.knn_topk_pass(q, x[:5], csq[:5], ids[:5], *st)
    assert torch.isinf(few[0][:, 5:]).all() and (few[1][:, 5:] == -1).all()


def _ring(Xq, Xi, k, mask=None):
    mesh = make_mesh(1)
    ni = Xi.shape[0]
    Xq_d, _ = shard_rows(Xq, mesh)
    Xi_d, mi_d = shard_rows(Xi, mesh)
    if mask is not None:
        mi_d = jnp.asarray(mask.astype(np.float32))
    ids_d, _ = shard_rows(np.arange(ni, dtype=np.int32), mesh)
    d2, idx = ring_knn(Xq_d, Xi_d, mi_d, ids_d, mesh=mesh, k=k)
    return np.asarray(d2)[: Xq.shape[0]], np.asarray(idx)[: Xq.shape[0]]


def _search(Xq, Xi, k, mask=None):
    ni = Xi.shape[0]
    m = torch.ones(ni) if mask is None else torch.from_numpy(mask.astype(np.float32))
    d2, idx = tkn.knn_search(torch.from_numpy(Xq), torch.from_numpy(Xi), m, torch.arange(ni), k)
    return d2.numpy(), idx.numpy()


@pytest.mark.parametrize("k", [1, 7, 16])
def test_knn_search_matches_ring_knn(k):
    rng = np.random.default_rng(10 + k)
    Xq, Xi = _blobs(rng, 400, 64), _blobs(rng, 3000, 64)
    assert _boundary_ties(Xq, Xi, k) > 0
    mask = np.ones(3000, bool)
    mask[::7] = False
    jd, ji = _ring(Xq, Xi, k, mask)
    td, ti = _search(Xq, Xi, k, mask)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td, jd)
    assert mask[ti].all()


def test_knn_search_exact_ties_take_the_lower_id():
    # duplicated items: equal distances to every query, in both packages
    # the lower id comes first
    rng = np.random.default_rng(4)
    Xi = _blobs(rng, 500, 32)
    dup = [(3, 250), (10, 11), (499, 20)]
    for a, b in dup:
        Xi[b] = Xi[a]
    Xq = np.concatenate([Xi[[3, 10, 499, 20]] + rng.integers(-1, 2, size=(4, 32)), Xi[[250, 11]]])
    Xq = Xq.astype(np.float32)
    jd, ji = _ring(Xq, Xi, 4)
    td, ti = _search(Xq, Xi, 4)
    np.testing.assert_array_equal(ti, ji)
    for row, (a, b) in zip(range(3), dup):
        assert list(ti[row, :2]) == sorted([a, b])
    assert list(ti[4, :2]) == [3, 250] and list(ti[5, :2]) == [10, 11]
    assert td[4, 0] == td[4, 1] and td[5, 0] == td[5, 1]


def _nn_frames(seed):
    rng = np.random.default_rng(seed)
    X = _blobs(rng, 600, 3, k=5)
    Q = _blobs(rng, 80, 3, k=5)
    items = {"a": X[:, 0], "b": X[:, 1], "c": X[:, 2],
             "name": np.array([f"item-{i:04d}" for i in range(600)], dtype=object)}
    queries = {"a": Q[:, 0], "b": Q[:, 1], "c": Q[:, 2],
               "name": np.array([f"q-{i:03d}" for i in range(80)][::-1], dtype=object)}
    return X, Q, items, queries


def test_nearest_neighbors_matches_jax_estimator():
    X, Q, items, queries = _nn_frames(6)
    kw = dict(k=5)
    jm = JNN(num_workers=1, **kw).setInputCol(["a", "b", "c"]).setIdCol("name").fit(JDataFrame(items))
    tm = TNN(device="cpu", **kw).setInputCol(["a", "b", "c"]).setIdCol("name").fit(TDataFrame(items))
    _, jq, jk = jm.kneighbors(JDataFrame(queries))
    _, tq, tk = tm.kneighbors(TDataFrame(queries))
    assert tk.columns == jk.columns == ["query_name", "indices", "distances"]
    np.testing.assert_array_equal(tk.column("query_name"), jk.column("query_name"))
    np.testing.assert_array_equal(tk.column("indices"), jk.column("indices"))
    np.testing.assert_array_equal(tk.column("distances"), jk.column("distances"))

    jj = jm.exactNearestNeighborsJoin(JDataFrame(queries), distCol="dist")
    tj = tm.exactNearestNeighborsJoin(TDataFrame(queries), distCol="dist")
    assert tj.columns == jj.columns
    for c in tj.columns:
        np.testing.assert_array_equal(tj.column(c), jj.column(c))


def test_nearest_neighbors_generated_ids_and_vector_column():
    rng = np.random.default_rng(8)
    X, Q = _blobs(rng, 500, 16), _blobs(rng, 50, 16)
    jm = JNN(k=3, num_workers=1).fit(JDataFrame({"features": X}))
    tm = TNN(k=3, device="cpu").fit(TDataFrame({"features": X}))
    _, _, jk = jm.kneighbors(JDataFrame({"features": Q}))
    _, tq, tk = tm.kneighbors(TDataFrame({"features": Q}))
    assert "unique_id" in tq.columns
    np.testing.assert_array_equal(tk.column("indices"), jk.column("indices"))
    tj = tm.exactNearestNeighborsJoin(TDataFrame({"features": Q}))
    jj = jm.exactNearestNeighborsJoin(JDataFrame({"features": Q}))
    assert tj.columns == jj.columns == ["item_features", "query_features", "distCol"]
    np.testing.assert_array_equal(tj.column("item_features"), jj.column("item_features"))


def test_nearest_neighbors_refusals():
    X = np.random.default_rng(0).normal(size=(20, 4)).astype(np.float32)
    df = TDataFrame({"features": X})
    with pytest.raises(NotImplementedError):
        TNN(k=2).write()
    with pytest.raises(NotImplementedError):
        TNN.read()
    m = TNN(k=2, device="cpu").fit(df)
    for call in (lambda: m.transform(df), m.write, type(m).read):
        with pytest.raises(NotImplementedError):
            call()
    with pytest.raises(ValueError, match="k=30"):
        TNN(k=30, device="cpu").fit(df).kneighbors(df)
    # fit(params=) fits a copy and leaves the estimator as it was
    est = TNN(k=30, device="cpu")
    assert est.fit(df, params={"k": 4}).kneighbors(df)[2].column("indices").shape == (20, 4)
    assert est.getK() == 30
    with pytest.raises(ValueError, match="idCol"):
        TNN(k=2, device="cpu").setIdCol("nope").fit(df)


def test_nearest_neighbors_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    df = TDataFrame({"features": np.zeros((10, 3), np.float32)})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TNN(k=2).fit(df).kneighbors(df)
