"""Port parity: UMAP (``spark_rapids_ml_tpu_torch.ops.umap_kernels``, kernel
K10's plain version and the SGD epoch loop, ``models.umap``) against the JAX
package, on the CPU.

Inputs are made with a seeded numpy generator. The host stages
(``build_row_adjacency``, the scipy symmetrization, ``spectral_init``,
``find_ab_params``) are the same code and are held bitwise or to rtol 1e-5;
the bisection and memberships are f32 on both sides (rtol 1e-5). PyTorch
cannot draw ``jax.random``'s bits, so one epoch is held against the JAX
Pallas kernel (interpret mode) on identical random numbers (atol 1e-5, f32
sums in two orders), the port's epoch loop against the XLA one for three
epochs fed JAX's own draws (atol 5e-4, as ``tests/test_umap_pallas.py``),
and whole fits only statistically: trustworthiness above 0.85 in both
packages and within 0.03 of each other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.manifold import trustworthiness

import chip_smoke
from spark_rapids_ml_tpu.data import DataFrame as JDataFrame
from spark_rapids_ml_tpu.models import umap as jmu
from spark_rapids_ml_tpu.ops import umap_kernels as juk
from spark_rapids_ml_tpu.ops.umap_pallas import sgd_epoch_rows as j_sgd_epoch_rows
from spark_rapids_ml_tpu.umap import UMAP as JUMAP
from spark_rapids_ml_tpu_torch import DataFrame as TDataFrame
from spark_rapids_ml_tpu_torch import interop
from spark_rapids_ml_tpu_torch.models import umap as tmu
from spark_rapids_ml_tpu_torch.ops import umap_kernels as tuk
from spark_rapids_ml_tpu_torch.umap import UMAP as TUMAP
from spark_rapids_ml_tpu_torch.umap import UMAPModel as TUMAPModel

A, B = juk.find_ab_params(1.0, 0.1)


def _blobs(n=500, d=12, k=5, seed=0, spread=0.3):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)) * 5
    labels = rng.integers(0, k, size=n)
    return (centers[labels] + spread * rng.normal(size=(n, d))).astype(np.float32), labels


def _int_blobs(n, d, k, seed):
    """Integer-valued f32 blobs: every squared distance is exact in f32, so
    both packages find the same neighbours at the same distances."""
    rng = np.random.default_rng(seed)
    centers = rng.integers(-8, 9, size=(k, d))
    labels = rng.integers(0, k, size=n)
    return (centers[labels] + rng.integers(-2, 3, size=(n, d))).astype(np.float32), labels


def _knn_graph(X, k):
    """(indices, distances) of each row's k nearest other rows, in f64."""
    X64 = X.astype(np.float64)
    d = np.sqrt(((X64[:, None] - X64[None]) ** 2).sum(-1))
    np.fill_diagonal(d, np.inf)
    idx = np.argsort(d, axis=1, kind="stable")[:, :k]
    return idx.astype(np.int32), np.take_along_axis(d, idx, 1).astype(np.float32)


def test_find_ab_params_matches_jax():
    for spread, min_dist in ((1.0, 0.1), (1.5, 0.25)):
        np.testing.assert_allclose(tuk.find_ab_params(spread, min_dist),
                                   juk.find_ab_params(spread, min_dist), rtol=1e-5)


@pytest.mark.parametrize("lc", [1.0, 1.5])
def test_smooth_knn_dist_and_memberships_match_jax(lc):
    X, _ = _blobs(n=400)
    _, dists = _knn_graph(X, 10)
    rho_j, sig_j = juk.smooth_knn_dist(jnp.asarray(dists), lc)
    w_j = juk.membership_strengths(jnp.asarray(dists), rho_j, sig_j)
    rho_t, sig_t = tuk.smooth_knn_dist(torch.from_numpy(dists), lc)
    w_t = tuk.membership_strengths(torch.from_numpy(dists), rho_t, sig_t)
    np.testing.assert_allclose(rho_t.numpy(), np.asarray(rho_j), rtol=1e-5)
    np.testing.assert_allclose(sig_t.numpy(), np.asarray(sig_j), rtol=1e-5)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-5, atol=1e-7)


def test_fuzzy_set_and_supervised_intersection_match_jax():
    X, labels = _blobs(n=300, seed=1)
    idx, dists = _knn_graph(X, 8)
    hj, tj, wj = juk.fuzzy_simplicial_set(idx, dists, 1.0, 1.0)
    ht, tt, wt = tuk.fuzzy_simplicial_set(idx, dists, 1.0, 1.0)
    np.testing.assert_array_equal(ht, hj)
    np.testing.assert_array_equal(tt, tj)
    np.testing.assert_allclose(wt, wj, rtol=1e-5)
    lab = labels.copy()
    lab[::5] = -1
    sj = juk.categorical_simplicial_set_intersection(hj, tj, wj, lab, 300)
    st = tuk.categorical_simplicial_set_intersection(hj, tj, wj, lab, 300)
    for a, b in zip(st, sj):
        np.testing.assert_array_equal(a, b)


def test_spectral_init_and_row_adjacency_match_jax():
    X, _ = _blobs(n=500, seed=2)
    idx, dists = _knn_graph(X, 10)
    heads, tails, weights = juk.fuzzy_simplicial_set(idx, dists, 1.0, 1.0)
    np.testing.assert_allclose(
        tuk.spectral_init(heads, tails, weights, 500, 2, 7),
        juk.spectral_init(heads, tails, weights, 500, 2, 7), rtol=1e-5, atol=1e-6,
    )
    for K, bucket in ((24, 256), (8, 4096)):
        for a, b in zip(tuk.build_row_adjacency(heads, tails, weights, 500, K=K, row_bucket=bucket),
                        juk.build_row_adjacency(heads, tails, weights, 500, K=K, row_bucket=bucket)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_knn_graph_and_drop_self_match_jax():
    X, _ = _blobs(n=300, seed=3)
    X[7] = X[6]  # a duplicate: self may sit second in its tie run
    dj, ij = jmu.knn_brute(jnp.asarray(X), jnp.asarray(X), k=9)
    dt, it = tmu.knn_brute(torch.from_numpy(X), torch.from_numpy(X), k=9)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    # ‖x‖² − 2x·y + ‖y‖² cancels: absolute f32 error ~ u·‖x‖²·√d ~ 1e-4
    # in the squared distance (a self distance of 0 may come out 1e-2)
    np.testing.assert_allclose(dt.numpy() ** 2, np.asarray(dj) ** 2, rtol=1e-5, atol=1e-3)
    dj2, ij2 = jmu.drop_self_column(dj, ij, k=8)
    dt2, it2 = tmu.drop_self_column(dt, it, k=8)
    np.testing.assert_array_equal(it2.numpy(), np.asarray(ij2))
    assert not (it2.numpy() == np.arange(300)[:, None]).any()


def _rows(n=600, k=6, K=8, seed=0, n_tab=None):
    """A random directed edge list packed into CSR-padded SGD rows."""
    rng = np.random.default_rng(seed)
    n_tab = n if n_tab is None else n_tab
    heads = np.repeat(np.arange(n, dtype=np.int64), k)
    tails = rng.integers(0, n_tab, size=n * k)
    w = rng.uniform(0.1, 1.0, size=n * k).astype(np.float32)
    row_heads, tails_pad, p_pad = juk.build_row_adjacency(heads, tails, w, n, K=K, row_bucket=256)
    return rng, row_heads, tails_pad, p_pad


@pytest.mark.parametrize("neg,scale", [(3, 2.0), (5, 1.0)])
def test_sgd_epoch_plain_matches_pallas_interpret(neg, scale):
    rng, row_heads, tails_pad, p_pad = _rows(seed=neg)
    R, K = tails_pad.shape
    src = rng.normal(size=(600, 2)).astype(np.float32)
    src[5] = src[tails_pad[0, 0]]  # a d2 = 0 slot on some row
    h = src[row_heads]
    u = rng.random((R, K)).astype(np.float32)
    perm = rng.permutation(600).astype(np.int32)
    offs = rng.integers(0, R, size=neg).astype(np.int32)
    nid = tuk.negative_ids(torch.from_numpy(perm), torch.from_numpy(offs), R, K)  # (R, K, neg)
    neg_ids = nid.permute(0, 2, 1).reshape(R, neg * K).to(torch.int32).numpy()  # slot-major per s
    ref = j_sgd_epoch_rows(
        jnp.asarray(src), jnp.asarray(h), jnp.asarray(tails_pad), jnp.asarray(p_pad),
        jnp.asarray(neg_ids), jnp.asarray(u), jnp.zeros((1, 1), jnp.int32),
        a=A, b=B, gamma=1.0, attract_scale=scale, rng="xla", interpret=True,
    )
    got = tuk.sgd_epoch_rows(
        *(torch.from_numpy(x) for x in (src, h, tails_pad, p_pad, perm, offs, u)), A, B, 1.0, scale
    )
    assert got.shape == (R, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("self_table", [True, False])
def test_epoch_loop_fed_jax_draws_matches_xla_loop(self_table):
    n_tab = 600 if self_table else 500
    rng, row_heads, tails_pad, p_pad = _rows(n=600 if self_table else 100, K=8, seed=11, n_tab=n_tab)
    R, K = tails_pad.shape
    n_head = 600 if self_table else 100
    emb0 = (rng.normal(size=(n_head, 2)) * 0.1).astype(np.float32)
    table = emb0 if self_table else rng.normal(size=(n_tab, 2)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    neg, n_epochs = 5, 3
    kw = dict(n_epochs=n_epochs, a=A, b=B, gamma=1.0, initial_alpha=1.0,
              negative_sample_rate=neg, self_table=self_table)
    emb_j = jnp.asarray(emb0)
    for e in range(n_epochs):  # one epoch per call, at its absolute index
        emb_j = juk.optimize_embedding_rows(
            emb_j, emb_j if self_table else jnp.asarray(table), jnp.asarray(row_heads),
            jnp.asarray(tails_pad), jnp.asarray(p_pad), key, epoch_offset=e, epoch_span=1, **kw,
        )

    def jax_draws(e):
        k1, k2, k3 = juk.epoch_rng_keys(key, e)
        return (torch.from_numpy(np.array(jax.random.uniform(k1, (R, K)))),
                torch.from_numpy(np.asarray(jax.random.permutation(k2, n_tab), np.int32)),
                torch.from_numpy(np.asarray(jax.random.randint(k3, (neg,), 0, R), np.int32)))

    emb_t = tuk.umap_sgd(
        torch.from_numpy(emb0), torch.from_numpy(table), torch.from_numpy(row_heads),
        torch.from_numpy(tails_pad), torch.from_numpy(p_pad), None, draws=jax_draws, **kw,
    )
    np.testing.assert_allclose(emb_t.numpy(), np.asarray(emb_j), atol=5e-4)


def test_epoch_loop_draws_from_its_generator():
    _, row_heads, tails_pad, p_pad = _rows(seed=2)
    emb0 = torch.from_numpy(np.random.default_rng(1).normal(size=(600, 2)).astype(np.float32))
    args = (emb0, emb0, torch.from_numpy(row_heads), torch.from_numpy(tails_pad), torch.from_numpy(p_pad))
    kw = dict(n_epochs=4, a=A, b=B)
    runs = [tuk.umap_sgd(*args, torch.Generator().manual_seed(s), **kw) for s in (3, 3, 4)]
    np.testing.assert_array_equal(runs[0].numpy(), runs[1].numpy())
    assert not np.allclose(runs[0].numpy(), runs[2].numpy())
    assert np.array_equal(emb0.numpy(), args[0].numpy())  # the input is left as it was


def test_trustworthiness_helper_matches_sklearn():
    X, _ = _blobs(n=300, seed=4)
    E = np.random.default_rng(0).normal(size=(300, 2)).astype(np.float32) + X[:, :2]
    got = chip_smoke.trustworthiness(torch, torch.from_numpy(X), torch.from_numpy(E), 15)
    assert abs(got - trustworthiness(X, E, n_neighbors=15)) < 1e-12


@pytest.mark.parametrize("init", ["random", "spectral"])
def test_umap_fit_matches_jax_statistically(init):
    X, labels = _blobs(n=500, d=12, k=5)
    jm = JUMAP(n_neighbors=12, random_state=42, init=init, num_workers=1).fit(JDataFrame({"features": X}))
    tm = TUMAP(n_neighbors=12, random_state=42, init=init, device="cpu").fit(TDataFrame({"features": X}))
    assert tm.embedding_.shape == (500, 2) and tm.embedding_.dtype == np.float32
    tj = trustworthiness(X, jm.embedding_, n_neighbors=12)
    tt = trustworthiness(X, tm.embedding_, n_neighbors=12)
    assert tj > 0.85 and tt > 0.85
    assert abs(tt - tj) < 0.03, (tt, tj)
    rep = tm._fit_report
    assert rep["sgd_engine"] == "plain" and rep["graph_engine"] == "exact" and rep["n_epochs"] == 500
    assert min(rep["graph_seconds"], rep["init_seconds"], rep["sgd_seconds"]) > 0
    # the clusters separate in the port's embedding
    emb = tm.embedding_
    cents = np.stack([emb[labels == c].mean(axis=0) for c in range(5)])
    intra = np.mean([np.linalg.norm(emb[labels == c] - cents[c], axis=1).mean() for c in range(5)])
    inter = np.mean([np.linalg.norm(cents[i] - cents[j]) for i in range(5) for j in range(i + 1, 5)])
    assert inter > 2 * intra


def _jax_emb0(jm, Xb, k, lc=1.0):
    """The JAX transform's start point (``models/umap.py:692-699``)."""
    dists, idx = jmu.knn_brute(jnp.asarray(jm.raw_data_), jnp.asarray(Xb), k=k)
    rho, sigma = juk.smooth_knn_dist(dists, lc)
    w = juk.membership_strengths(dists, rho, sigma)
    wn = w / jnp.maximum(w.sum(axis=1, keepdims=True), 1e-12)
    return np.asarray(jnp.einsum("qk,qkc->qc", wn, jnp.asarray(jm.embedding_)[idx]))


def test_transform_of_a_jax_fitted_model():
    # integer-valued rows: the transform's kNN distances are exact in both
    # packages, so emb0 (whose weights divide distance differences by a
    # small sigma) is held to 1e-5; fresh rows of the same blobs are queried
    X, labels = _int_blobs(450, 10, 3, seed=3)
    X, labels, Xb, lb = X[:300], labels[:300], X[300:], labels[300:]
    jm = JUMAP(n_neighbors=10, random_state=0, init="random", num_workers=1).fit(JDataFrame({"features": X}))
    params = {p.name: jm.getOrDefault(p) for p in jm.params if jm.isSet(p)}
    tm = interop.from_jax_attributes("UMAPModel", jm._get_model_attributes(), params, device="cpu")
    assert isinstance(tm, TUMAPModel) and tm._tpu_params["n_neighbors"] == 10
    emb0, _, _ = tm._transform_init(
        torch.from_numpy(Xb), torch.from_numpy(tm.raw_data_), torch.from_numpy(tm.embedding_), 10, 1.0
    )
    np.testing.assert_allclose(emb0.numpy(), _jax_emb0(jm, Xb, 10), atol=1e-5)
    out = np.asarray(tm.transform(TDataFrame({"features": Xb})).column("embedding"))
    assert out.shape == (150, 2) and tm._transform_report["refine_epochs"] == 166
    assert trustworthiness(Xb, out, n_neighbors=10) > 0.85
    # each transformed point lands in its own cluster of the fitted embedding
    from sklearn.neighbors import NearestNeighbors as SkNN

    _, near = SkNN(n_neighbors=1).fit(jm.embedding_).kneighbors(out)
    assert (labels[near[:, 0]] == lb).mean() > 0.95


def test_save_load_round_trip_and_cross_load(tmp_path):
    X, _ = _int_blobs(200, 6, 2, seed=0)
    df = TDataFrame({"features": X})
    tm = TUMAP(n_neighbors=6, random_state=2, init="random", device="cpu").fit(df)
    tm.write().save(str(tmp_path / "t"))
    loaded = TUMAPModel.load(str(tmp_path / "t")).setDevice("cpu")
    np.testing.assert_array_equal(loaded.embedding_, tm.embedding_)
    np.testing.assert_array_equal(loaded.raw_data_, tm.raw_data_)
    np.testing.assert_array_equal(loaded.transform(df).column("embedding"), tm.transform(df).column("embedding"))
    est = TUMAP(n_neighbors=7, min_dist=0.2, device="cpu")
    est.write().save(str(tmp_path / "est"))
    assert TUMAP.load(str(tmp_path / "est"))._tpu_params["min_dist"] == 0.2

    jm = JUMAP(n_neighbors=6, random_state=2, init="random", num_workers=1).fit(JDataFrame({"features": X}))
    jm.write().save(str(tmp_path / "j"))
    cm = interop.load_jax_model(str(tmp_path / "j"), device="cpu")
    assert isinstance(cm, TUMAPModel)
    np.testing.assert_array_equal(cm.embedding_, jm.embedding_)
    assert cm.getOrDefault("outputCol") == "embedding" and cm._tpu_params["random_state"] == 2
    Xf = X + np.random.default_rng(5).integers(-1, 2, size=X.shape).astype(np.float32)
    emb0, _, _ = cm._transform_init(torch.from_numpy(Xf), torch.from_numpy(cm.raw_data_),
                                    torch.from_numpy(cm.embedding_), 6, 1.0)
    np.testing.assert_allclose(emb0.numpy(), _jax_emb0(jm, Xf, 6), atol=1e-5)
    out = np.asarray(cm.transform(df).column("embedding"))
    assert out.shape == (200, 2) and np.isfinite(out).all()


def test_umap_supervised_and_sample_fraction():
    X, labels = _blobs(n=300, d=8, k=3, spread=3.5, seed=4)
    df = TDataFrame({"features": X, "label": labels.astype(np.float64)})
    unsup = TUMAP(n_neighbors=10, random_state=0, device="cpu").fit(df)
    sup = TUMAP(n_neighbors=10, random_state=0, labelCol="label", device="cpu").fit(df)
    assert not np.allclose(unsup.embedding_, sup.embedding_)
    with pytest.raises(ValueError, match="labelCol"):
        TUMAP(n_neighbors=5, labelCol="nope", device="cpu").fit(df)
    half = TUMAP(n_neighbors=8, random_state=1, init="random", sample_fraction=0.5, n_epochs=50,
                 device="cpu").fit(df)
    assert 100 < half.embedding_.shape[0] < 200
    assert half.transform(df).column("embedding").shape == (300, 2)


def test_umap_params_and_validation():
    est = TUMAP(n_neighbors=7, min_dist=0.2, negative_sample_rate=3, random_state=9)
    assert est._tpu_params["n_neighbors"] == 7 and est.getNNeighbors() == 7
    est.setNComponents(4)
    assert est._tpu_params["n_components"] == 4
    with pytest.raises(ValueError):
        TUMAP(bogus=1)
    with pytest.raises(ValueError, match="metric"):
        TUMAP(metric="cosine")
    with pytest.raises(ValueError, match="n_neighbors"):
        TUMAP(n_neighbors=15, device="cpu").fit(TDataFrame({"features": np.zeros((10, 4), np.float32)}))
    # fit(params=) fits a copy and leaves the estimator as it was
    X, _ = _blobs(n=60, d=4, k=2)
    est = TUMAP(n_neighbors=15, n_epochs=10, device="cpu")
    m = est.fit(TDataFrame({"features": X}), params={"n_neighbors": 5})
    assert m._tpu_params["n_neighbors"] == 5 and m.embedding_.shape == (60, 2)
    assert est._tpu_params["n_neighbors"] == 15


def test_umap_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    X, _ = _blobs(n=60, d=4, k=2)
    df = TDataFrame({"features": X})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TUMAP(n_neighbors=5).fit(df)
    model = TUMAP(n_neighbors=5, n_epochs=20, device="cpu").fit(df)
    model.setDevice(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.transform(df)
