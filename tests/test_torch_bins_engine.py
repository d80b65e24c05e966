"""The port's two-hop bins engine held against the JAX package on the CPU,
and against the port's own packed engine.

Leaf ids are integers, so they must be equal; the value sums follow the
same order (partial sums of 8 trees in tree order, then across groups) in
every engine, so they must be equal bit for bit too. The JAX bins engine
runs twice: on its default compare-select contraction, and with its byte
gather (K8) engaged in interpret mode.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import spark_rapids_ml_tpu.ops.rf_pallas as rfp
import spark_rapids_ml_tpu.ops.tree_kernels as tk
from spark_rapids_ml_tpu_torch import DataFrame as TDataFrame
from spark_rapids_ml_tpu_torch import (
    GBTClassifier,
    GBTRegressor,
    RandomForestClassifier,
    RandomForestRegressor,
)
from spark_rapids_ml_tpu_torch.ops import rf_kernels as rk
from spark_rapids_ml_tpu_torch.ops import tree_kernels as pt


def _random_forest(rng, T, depth, d, nb):
    """Heap-ordered (feat, thr_bin) whose leaves' children are leaves;
    about a sixth of the internal nodes are early leaves."""
    M = pt.max_nodes(depth)
    feat = rng.integers(0, d, size=(T, M)).astype(np.int32)
    thrb = rng.integers(0, nb - 1, size=(T, M)).astype(np.int32)
    for i in range(M):
        leaf = (i >= (1 << depth) - 1) | (rng.random(T) < 0.15)
        if i > 0:
            leaf |= feat[:, (i - 1) // 2] < 0
        feat[leaf, i] = -1
    return feat, thrb


def _jax_bins(xb, feat, thrb, vals, depth, heads):
    """The JAX engine's leaf ids and value sums, and with ``heads`` its
    classifier and regressor outputs."""
    jx, jf, jt = jnp.asarray(xb), jnp.asarray(feat), jnp.asarray(thrb)
    out = [tk.forest_apply_bins(jx, jf, jt, max_depth=depth),
           tk.rf_eval_bins(jx, jf, jt, jnp.asarray(vals), max_depth=depth)]
    if heads:
        out += list(tk.rf_classify_bins(jx, jf, jt, jnp.asarray(np.abs(vals)), max_depth=depth))
        out.append(tk.rf_regress_bins(jx, jf, jt, jnp.asarray(vals[..., 0]), max_depth=depth))
    return [np.asarray(a) for a in out]


# depth 5, 8, 10, 13: k2 = 0, 1, 3, 6 (k1 = 5, 7, 7, 7); tree counts off
# the group of 8 and across two groups
@pytest.mark.parametrize("depth,T", [(5, 3), (8, 9), (10, 5), (13, 3)])
def test_bins_engine_matches_jax(monkeypatch, depth, T):
    rng = np.random.default_rng(depth)
    n, d, nb = 2048, 40, 64  # n: one byte-gather block of the TPU kernel
    feat, thrb = _random_forest(rng, T, depth, d, nb)
    xb = rng.integers(0, nb, size=(n, d)).astype(np.uint8)
    vals = rng.normal(size=(T, pt.max_nodes(depth), 3)).astype(np.float32)
    tx, tf, tt, tv = (torch.from_numpy(a) for a in (xb, feat, thrb, vals))

    launches = rk.packed_byte_gather_many.launches
    calls = []
    monkeypatch.setattr(pt, "packed_byte_gather_many",
                        lambda *a: calls.append(a[1].shape) or rk.packed_byte_gather_many(*a))
    ids = pt.forest_apply_bins(tx, tf, tt, max_depth=depth).numpy()
    s = pt.rf_eval_bins(tx, tf, tt, tv, max_depth=depth).numpy()
    heads = [a.numpy() for a in pt.rf_classify_bins(tx, tf, tt, tv.abs(), max_depth=depth)]
    heads.append(pt.rf_regress_bins(tx, tf, tt, tv[..., 0], max_depth=depth).numpy())
    k2 = pt._split_depths(depth)[1]
    # one gather per tree group (of 8) and call, with 2^k2 - 1 slots a row
    assert len(calls) == (4 * -(-T // 8) if k2 else 0)
    assert all(c[1:] == (n, (1 << k2) - 1) for c in calls)
    assert rk.packed_byte_gather_many.launches == launches  # CPU tensors: the plain version

    walk_rows = range(0, n, 97)
    for t in range(T):
        for r in walk_rows:
            i = 0
            while feat[t, i] >= 0:
                i = 2 * i + 1 + int(xb[r, feat[t, i]] > thrb[t, i])
            assert ids[t, r] == i

    jax_k8 = []
    pallas_k8 = rfp.packed_byte_gather_many
    monkeypatch.setattr(rfp, "packed_byte_gather_many", lambda *a, **kw: jax_k8.append(1) or pallas_k8(*a, **kw))
    try:
        # the default contraction with every head; the byte gather (K8 in
        # interpret mode) for the leaf ids and sums the heads are made of
        for byte_gather in (False, True):
            # the JAX engine reads the switch while it traces: clear the
            # compiled programs around each setting
            jax.clear_caches()
            monkeypatch.setattr(tk, "_RF_BYTE_GATHER", byte_gather)
            monkeypatch.setattr(rfp, "FORCE_INTERPRET", byte_gather)
            ref = _jax_bins(xb, feat, thrb, vals, depth, heads=not byte_gather)
            assert bool(jax_k8) == (byte_gather and k2 > 0)
            for a, b in zip([ids, s] + heads, ref):
                np.testing.assert_array_equal(a, b)
    finally:
        jax.clear_caches()

    # the packed engine: the same leaves, the same sums
    pf = pt.pack_forest(feat, thrb, max_depth=depth)
    tables = pt.packed_node_tables(pf, "cpu")
    np.testing.assert_array_equal(
        pt.forest_apply_packed(tx, *tables, k1=pf.k1, k2=pf.k2).numpy()[:, :T].T, ids)
    np.testing.assert_array_equal(pt.rf_eval_packed(tx, *tables, tv, k1=pf.k1, k2=pf.k2).numpy(), s)


def _frame(seed, n=800, d=12):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = ((X[:, 0] + 0.6 * X[:, 3] + 0.3 * rng.normal(size=n)) > 0).astype(np.float32)
    yr = (np.sin(X[:, 1]) * 2 + X[:, 2] + 0.1 * rng.normal(size=n)).astype(np.float32)
    return X, y, yr


@pytest.mark.parametrize(
    "make,label",
    [
        (lambda: RandomForestClassifier(numTrees=10, maxDepth=9, maxBins=32, seed=3, device="cpu"), "y"),
        (lambda: RandomForestRegressor(numTrees=3, maxDepth=8, maxBins=32, seed=4, device="cpu"), "yr"),
        (lambda: GBTClassifier(maxIter=9, maxDepth=8, maxBins=32, seed=5, device="cpu"), "y"),
        (lambda: GBTRegressor(maxIter=4, maxDepth=10, maxBins=32, seed=6, device="cpu"), "yr"),
    ],
)
def test_bins_engine_equals_packed_engine(make, label):
    """Every model through ``engine="bins"`` gives the packed engine's
    columns bit for bit; the default stays packed."""
    X, y, yr = _frame(7)
    df = TDataFrame({"features": X, "label": y if label == "y" else yr})
    model = make().fit(df)
    assert model._resolve_transform_engine() == "packed"
    assert model._resolve_transform_engine("bins") == "bins"
    assert model._resolve_transform_engine("legacy") == "legacy"
    packed = model.transform(TDataFrame({"features": X}))
    bins = model._apply_batched(model._get_transform_func(engine="bins"), X)
    assert set(bins) == set(model._out_cols())
    for c in model._out_cols():
        np.testing.assert_array_equal(bins[c], packed.column(c), err_msg=c)
    with pytest.raises(ValueError, match="unknown transform engine"):
        model._get_transform_func(engine="fast")
