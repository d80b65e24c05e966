"""The port's RandomForest kernels (K5, K6, K9) and quantization, held
against the JAX package on the CPU.

The port's wrappers run their plain PyTorch versions here (CPU tensors);
the JAX package's Pallas kernels run in interpret mode. Histogram partials
of integer stats (gini counts; variance stats of integer labels) are exact
in any summation order, so they must be equal; real-valued stats are held
to rtol 1e-6 with an absolute floor of 1e-6 of the entry's absolute terms.
Leaf ids and bins are integers: equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import spark_rapids_ml_tpu.ops.rf_pallas as rfp
import spark_rapids_ml_tpu.ops.tree_kernels as tk
from spark_rapids_ml_tpu_torch.ops import rf_kernels as rk
from spark_rapids_ml_tpu_torch.ops import tree_kernels as pt


def _sw(rng, rows, S, kind):
    """(rows, S) stats x weight: one-hot class counts times small integer
    weights, integer-label moments (1, y, y^2)·w, or real-valued moments;
    every 7th row is padding (weight 0)."""
    w = rng.integers(0, 4, size=rows).astype(np.float32)
    w[::7] = 0.0
    if kind == "gini":
        y = rng.integers(0, S, size=rows)
        return (np.eye(S, dtype=np.float32)[y] * w[:, None]).astype(np.float32)
    y = rng.integers(0, 10, size=rows).astype(np.float32) if kind == "int" else rng.normal(size=rows).astype(np.float32)
    return (np.stack([np.ones_like(y), y, y * y], 1) * w[:, None]).astype(np.float32)


def _hold(got, ref, sw, r_sub, S, exact):
    if exact:
        np.testing.assert_array_equal(got, ref)
        return
    # Σ|terms| per sub-block and stat bounds every entry's terms
    terms = np.abs(sw).reshape(-1, r_sub, S).sum(axis=1)[:, :, None]
    np.testing.assert_array_less(np.abs(got - ref), 1e-6 * np.abs(ref) + 1e-6 * terms + 1e-30)


@pytest.mark.parametrize(
    "kind,S,nb,r_sub",
    [("gini", 2, 32, 8), ("gini", 3, 128, 64), ("int", 3, 32, 16), ("real", 3, 32, 8)],
)
def test_subblock_hist_matches_pallas(kind, S, nb, r_sub):
    rng = np.random.default_rng(5)
    rows, k = 1024, 16
    binq = rng.integers(0, nb, size=(rows, k)).astype(np.int32)
    sw = _sw(rng, rows, S, kind)
    ref = np.asarray(rfp.subblock_hist(jnp.asarray(binq), jnp.asarray(sw), n_bins=nb, r_sub=r_sub,
                                       variance=kind != "gini", interpret=True))
    got = rk.subblock_hist(torch.from_numpy(binq), torch.from_numpy(sw), n_bins=nb, r_sub=r_sub).numpy()
    assert got.shape == ref.shape == (rows // r_sub, S, k * nb)
    _hold(got, ref, sw, r_sub, S, kind != "real")


def test_subblock_hist_batched_matches_pallas():
    rng = np.random.default_rng(6)
    T, n_pad, k, nb, S, r_sub = 2, 512, 8, 32, 2, 16
    binq = rng.integers(0, nb, size=(T, n_pad, k)).astype(np.int32)
    sw = _sw(rng, T * n_pad, S, "gini").reshape(T, n_pad, S)
    ref = np.asarray(rfp.subblock_hist_batched(jnp.asarray(binq), jnp.asarray(sw), n_bins=nb, r_sub=r_sub,
                                               interpret=True))
    got = rk.subblock_hist_batched(torch.from_numpy(binq), torch.from_numpy(sw), n_bins=nb, r_sub=r_sub)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize(
    "kind,n_features,d_pad",
    # 120 < d_pad: sentinel ids hit zero pad columns; 128 == d_pad: they
    # lie past the row
    [("gini", 120, 128), ("int", 128, 128), ("real", 128, 128)],
)
def test_subblock_hist_sel_matches_pallas(kind, n_features, d_pad):
    rng = np.random.default_rng(7)
    rows, r_sub, k, nb, S = 1024, 32, 16, 32, 2 if kind == "gini" else 3
    n_sb = rows // r_sub
    bq = rng.integers(0, nb, size=(rows, d_pad)).astype(np.uint8)
    bq[:, n_features:] = 0
    featsq = np.stack([rng.permutation(n_features)[:k] for _ in range(n_sb)]).astype(np.int32)
    featsq[:, 11:] = n_features  # k = 11 real slots, 5 sentinels
    sw = _sw(rng, rows, S, kind)
    ref = np.asarray(rfp.subblock_hist_sel(jnp.asarray(bq), jnp.asarray(featsq), jnp.asarray(sw.T), n_bins=nb,
                                           r_sub=r_sub, variance=kind != "gini", interpret=True))
    got = rk.subblock_hist_sel(torch.from_numpy(bq), torch.from_numpy(featsq), torch.from_numpy(sw),
                               n_bins=nb, r_sub=r_sub).numpy()
    _hold(got, ref, sw, r_sub, S, kind != "real")
    # a sentinel slot reads bin 0
    sent = got.reshape(n_sb, S, k, nb)[:, :, 11:, 1:]
    assert not sent.any()


def test_subblock_hist_sel_batched_matches_pallas():
    rng = np.random.default_rng(8)
    T, n_pad, d_pad, k, nb, S, r_sub = 2, 512, 64, 8, 32, 3, 16
    bq = rng.integers(0, nb, size=(T, n_pad, d_pad)).astype(np.uint8)
    featsq = rng.integers(0, d_pad, size=(T, n_pad // r_sub, k)).astype(np.int32)
    sw = _sw(rng, T * n_pad, S, "int").reshape(T, n_pad, S)
    ref = np.asarray(rfp.subblock_hist_sel_batched(
        jnp.asarray(bq), jnp.asarray(featsq), jnp.asarray(sw.transpose(0, 2, 1)), n_bins=nb, r_sub=r_sub,
        variance=True, interpret=True))
    got = rk.subblock_hist_sel_batched(torch.from_numpy(bq), torch.from_numpy(featsq), torch.from_numpy(sw),
                                       n_bins=nb, r_sub=r_sub)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_out_of_range_bins_add_nothing():
    """K5's plain version skips a bin outside [0, nb) (the Pallas one-hot
    matches no lane there); the CUDA kernel does the same."""
    binq = torch.tensor([[0, 5], [-1, 1], [3, 9]], dtype=torch.int32)
    sw = torch.ones((3, 1))
    out = rk.subblock_hist(binq, sw, n_bins=4, r_sub=3).reshape(1, 2, 4)
    np.testing.assert_array_equal(out.numpy(), [[[1, 0, 0, 1], [0, 1, 0, 0]]])


def _random_forest(rng, T, depth, d, nb):
    """Heap-ordered (feat, thr_bin) whose leaves' children are leaves;
    about a fifth of the internal nodes are early leaves."""
    M = pt.max_nodes(depth)
    feat = rng.integers(0, d, size=(T, M)).astype(np.int32)
    thrb = rng.integers(0, nb - 1, size=(T, M)).astype(np.int32)
    for i in range(M):
        p = (i - 1) // 2
        leaf = (i >= (1 << depth) - 1) | (rng.random(T) < 0.2)
        if i > 0:
            leaf |= feat[:, p] < 0
        feat[leaf, i] = -1
    return feat, thrb


@pytest.mark.parametrize("depth,T,d", [(8, 5, 16), (10, 3, 40)])
def test_packed_traverse_matches_pallas(depth, T, d):
    """Hop 1 and K9 of the port against the JAX package's hop 1 and its
    traversal kernel (interpret), leaf ids equal; T off the pad-of-8
    (padding trees), rows stopping in hop 1; and the whole packed
    descent against a per-row walk."""
    rng = np.random.default_rng(depth)
    n, nb = 1024, 64
    feat, thrb = _random_forest(rng, T, depth, d, nb)
    d_pad = -(-d // 4) * 4
    xb = rng.integers(0, nb, size=(n, d_pad)).astype(np.uint8)
    pf = pt.pack_forest(feat, thrb, max_depth=depth)
    jpf = tk.pack_forest(feat, thrb, max_depth=depth)
    for a, b in zip(pf, jpf):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert pf.k2 == depth - 7 and pf.feat1.shape[0] == 8

    i1_j = np.asarray(tk._packed_hop1(jnp.asarray(xb, jnp.bfloat16), pf.feat1, pf.thr1, k1=pf.k1))
    i1 = pt._packed_hop1(torch.from_numpy(xb), torch.from_numpy(pf.feat1), torch.from_numpy(pf.thr1), k1=pf.k1)
    np.testing.assert_array_equal(i1.numpy(), i1_j)
    assert (i1_j[:, :T] < (1 << pf.k1) - 1).any(), "no row stopped in hop 1"

    packed = pt.pack_bins(torch.from_numpy(xb))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(tk._pack_bins(jnp.asarray(xb))))
    ref = np.asarray(rfp.packed_traverse(
        jnp.asarray(packed.numpy()), jnp.asarray(i1_j), jnp.asarray(pf.feat2), jnp.asarray(pf.thr2),
        k1=pf.k1, k2=pf.k2, d_pad=d_pad, interpret=True))
    got = rk.packed_traverse(packed, i1, torch.from_numpy(pf.feat2), torch.from_numpy(pf.thr2), k1=pf.k1, k2=pf.k2)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy()[:, T:], 0)  # padding trees: leaf 0

    def walk(t, r):
        i = 0
        while feat[t, i] >= 0:
            i = 2 * i + 1 + int(xb[r, feat[t, i]] > thrb[t, i])
        return i

    rows = range(0, n, 37)
    np.testing.assert_array_equal(got.numpy()[list(rows), :T], [[walk(t, r) for t in range(T)] for r in rows])


def test_make_bin_edges_and_binize_match():
    rng = np.random.default_rng(9)
    X = rng.normal(size=(700, 10)).astype(np.float32)
    X[:, 3] = np.round(X[:, 3])  # repeated values: tied edges
    for nb, max_sample in ((32, 131072), (128, 256)):
        e = pt.make_bin_edges(X, nb, max_sample=max_sample, seed=4)
        np.testing.assert_array_equal(e, tk.make_bin_edges(X, nb, max_sample=max_sample, seed=4))
    Xq = X.copy()
    Xq[5] = np.nan
    Xq[6, 2] = np.inf
    Xq[7, 1] = -np.inf
    got = pt.binize(torch.from_numpy(Xq), torch.from_numpy(e), d_pad=16).numpy()
    ref = np.asarray(tk.binize(jnp.asarray(Xq), jnp.asarray(e), d_pad=16))
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == np.uint8 and not got[5].any() and not got[:, 10:].any()
    # several feature chunks (the compare tile holds 2^22 // n features),
    # the last one short of d_pad
    Xw = rng.normal(size=(20_000, 300)).astype(np.float32)
    ew = pt.make_bin_edges(Xw, 16)
    got = pt.binize(torch.from_numpy(Xw), torch.from_numpy(ew), d_pad=512).numpy()
    np.testing.assert_array_equal(got, np.asarray(tk.binize(jnp.asarray(Xw), jnp.asarray(ew), d_pad=512)))
