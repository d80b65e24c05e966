"""The port's packed-forest descent (K9 from the root, with its leaf ids or
its leaf-payload sums) held against the JAX package on the CPU.

On CPU tensors ``packed_forest_eval`` runs its plain route (hop 1 as
gathers, hop 2, the payload sum in groups of 8 trees); the JAX package's
``forest_apply_packed`` / ``rf_eval_packed`` run their Pallas hop 2 in
interpret mode. Leaf ids are integers and the sums are the same f32 adds
in the same order: both are held equal, bit for bit. A numpy model of the
CUDA kernel's walk (its leaf-id formula and early stops) and of its
payload order is held to the plain route bit for bit too, its node words
read back as the JAX layout, and the kernel's launch geometry is pure
Python.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import spark_rapids_ml_tpu.ops.tree_kernels as tk
from spark_rapids_ml_tpu_torch.ops import rf_kernels as rk
from spark_rapids_ml_tpu_torch.ops import tree_kernels as pt

N_ROWS, N_BINS = 1024, 64


def _forest(rng, T, depth, d):
    """Heap-ordered (feat, thr_bin): every node of the top 3 levels splits,
    about a fifth of the deeper internal nodes are early leaves (so rows
    stop in hop 1 and in hop 2)."""
    M = pt.max_nodes(depth)
    feat = rng.integers(0, d, size=(T, M)).astype(np.int32)
    thrb = rng.integers(0, N_BINS - 1, size=(T, M)).astype(np.int32)
    for i in range(M):
        leaf = (i >= (1 << depth) - 1) | ((i >= 7) & (rng.random(T) < 0.2))
        if i > 0:
            leaf |= feat[:, (i - 1) // 2] < 0
        feat[leaf, i] = -1
    return feat, thrb


def _case(depth, T, V, d=40, seed=0):
    rng = np.random.default_rng(1000 * depth + 10 * T + V + seed)
    feat, thrb = _forest(rng, T, depth, d)
    xb = rng.integers(0, N_BINS, size=(N_ROWS, d), dtype=np.uint8)
    vals = rng.normal(size=feat.shape + (V,)).astype(np.float32)
    return feat, thrb, xb, vals


# depth 6, 8, 10: k2 = 0, 1, 3; T = 5 (one group, padding trees) and 11
# (two groups); payload width 1 and 3
CASES = [(6, 5, 1), (6, 11, 3), (8, 5, 3), (8, 11, 1), (10, 5, 1), (10, 11, 3)]


@pytest.mark.parametrize("depth,T,V", CASES)
def test_packed_route_matches_jax(depth, T, V):
    """``forest_apply_packed`` and ``rf_eval_packed`` of the port against
    the JAX package's (its hop 2 in interpret mode): leaf ids and payload
    sums equal bit for bit, rows stopping in hop 1 among them."""
    feat, thrb, xb, vals = _case(depth, T, V)
    pf = pt.pack_forest(feat, thrb, max_depth=depth)
    assert (pf.k2, pf.feat1.shape[0]) == (depth - min(7, depth), -(-T // 8) * 8)
    tables = pt.packed_node_tables(pf, "cpu")
    jtables = [jnp.asarray(a) for a in (pf.feat1, pf.thr1, pf.feat2, pf.thr2)]
    kw = dict(k1=pf.k1, k2=pf.k2)

    leaf = pt.forest_apply_packed(torch.from_numpy(xb), *tables, **kw).numpy()
    ref = np.asarray(tk.forest_apply_packed(jnp.asarray(xb), *jtables, max_depth=depth, interpret=True, **kw))
    np.testing.assert_array_equal(leaf, ref)
    n1 = (1 << pf.k1) - 1
    assert (leaf[:, :T] < n1).any(), "no row stopped in hop 1"
    if pf.k2:
        assert (leaf[:, :T] >= 2 * n1 + 1).any(), "no row reached hop 2"

    got = pt.rf_eval_packed(torch.from_numpy(xb), *tables, torch.from_numpy(vals), **kw).numpy()
    ref = np.asarray(tk.rf_eval_packed(jnp.asarray(xb), *jtables, jnp.asarray(vals), max_depth=depth,
                                       interpret=True, **kw))
    assert got.dtype == np.float32 and got.shape == (N_ROWS, V)
    np.testing.assert_array_equal(got, ref)


def _kernel_model(xb, nodes1, nodes2, k1, k2, vals, i1=None):
    """numpy model of csrc/rf_traverse.cu: each (row, tree) walked as the
    kernel walks it on the node words (hop 1 from the root, or from ``i1``;
    a negative word stops; right where the byte >= word & 511; the leaf id
    from the slot's depth by count-leading-zeros), then the payload as its
    (row, v) threads add it: 8 trees in tree order, then the group into the
    running sum, f32 adds."""
    n, d_pad = xb.shape
    t_pad, n1 = nodes1.shape
    K1 = 1 << k1
    leaf = np.zeros((n, t_pad), np.int64)
    for r in range(n):
        row = xb[r]
        for t in range(t_pad):
            if i1 is None:
                i = 0
                for _ in range(k1):
                    w = int(nodes1[t, i])
                    if w < 0:
                        break
                    i = 2 * i + 1 + int(row[min(w >> 9, d_pad - 1)] >= (w & 511))
            else:
                i = int(i1[r, t])
            if i < n1 or k2 == 0:
                leaf[r, t] = i
                continue
            l = min(i - n1, K1 - 1)
            m = 0
            for _ in range(k2):
                w = int(nodes2[t * K1 + l, m])
                if w < 0:
                    break
                m = 2 * m + 1 + int(row[min(w >> 9, d_pad - 1)] >= (w & 511))
            pd = 1 << (31 - (32 - int(m + 1).bit_length()))
            leaf[r, t] = (K1 * pd - 1) + l * pd + (m - (pd - 1))
    if vals is None:
        return leaf.astype(np.int32)
    T = vals.shape[0]
    acc = None
    for t0 in range(0, T, 8):
        part = vals[t0][leaf[:, t0]]
        for t in range(t0 + 1, min(t0 + 8, T)):
            part = (part + vals[t][leaf[:, t]]).astype(np.float32)
        acc = part if acc is None else (acc + part).astype(np.float32)
    return acc


@pytest.mark.parametrize("depth,T,V", [(6, 11, 3), (10, 11, 10), (13, 3, 2)])
def test_kernel_model_matches_plain_route(depth, T, V):
    """The kernel's walk and sum order (numpy model) equal the plain route
    bit for bit: from the root with the ids and the sums (V = 10: the
    generic instance's width), and from a given hop 1 (the I1 start)."""
    feat, thrb, xb, vals = _case(depth, T, V, d=24, seed=1)
    xb, vals = xb[:160], vals
    pf = pt.pack_forest(feat, thrb, max_depth=depth)
    nodes = pt.packed_node_tables(pf, "cpu")
    model = lambda v, i1=None: _kernel_model(xb, *(t.numpy() for t in nodes), pf.k1, pf.k2, v, i1)  # noqa: E731
    packed = pt.pack_bins(torch.from_numpy(xb))
    kw = dict(k1=pf.k1, k2=pf.k2)
    np.testing.assert_array_equal(model(None), rk.packed_forest_eval(packed, *nodes, **kw).numpy())
    np.testing.assert_array_equal(model(vals), rk.packed_forest_eval(packed, *nodes, torch.from_numpy(vals),
                                                                     **kw).numpy())
    if pf.k2:
        i1 = rk._packed_hop1(torch.from_numpy(xb), torch.from_numpy(pf.feat1), torch.from_numpy(pf.thr1), k1=pf.k1)
        got = rk.packed_traverse(packed, i1, torch.from_numpy(pf.feat2), torch.from_numpy(pf.thr2), **kw)
        np.testing.assert_array_equal(model(None, i1.numpy()), got.numpy())


def test_node_words_round_trip():
    """K9's node words read back as the JAX package's packed tables:
    every split node's feature and threshold, -1 at leaves; thresholds past
    a byte's range clamp to -1 and 255, features to 2^22 - 1, where every
    test keeps its outcome; rows past 2^22 bytes are refused."""
    feat, thrb, _, _ = _case(13, 11, 1)
    jpf = tk.pack_forest(feat, thrb, max_depth=13)
    for (f, t), w in zip(((jpf.feat1, jpf.thr1), (jpf.feat2, jpf.thr2)),
                         pt.packed_node_tables(pt.pack_forest(feat, thrb, max_depth=13), "cpu")):
        fw, tw = (a.numpy() for a in rk._node_fields(w))
        np.testing.assert_array_equal(fw, np.where(f < 0, -1, f))
        np.testing.assert_array_equal(tw[f >= 0], t[f >= 0])
    f = torch.tensor([3, 3, 7, -1, (1 << 22) - 1, 1 << 30])
    fw, tw = rk._node_fields(rk.forest_nodes(f, torch.tensor([-5, 300, 254, 9, 0, 7])))
    assert fw.tolist() == [3, 3, 7, -1, (1 << 22) - 1, (1 << 22) - 1] and tw[[0, 1, 2, 5]].tolist() == [-1, 255, 254, 7]
    nodes = rk.forest_nodes(torch.from_numpy(jpf.feat1), torch.from_numpy(jpf.thr1))
    with pytest.raises(ValueError, match="past a node word"):
        rk.packed_forest_eval(torch.zeros((1, (1 << 20) + 1), dtype=torch.int32), nodes, torch.zeros((0, 64)),
                              k1=jpf.k1, k2=0)


def test_wrapper_routes_cpu_and_refuses_mixed_devices():
    """A CPU call takes the plain route and launches nothing; tensors on
    two devices raise, and so do tensors on a device that is neither the
    CPU nor CUDA (the meta device stands in for a card this machine lacks)."""
    feat, thrb, xb, vals = _case(8, 5, 2)
    pf = pt.pack_forest(feat, thrb, max_depth=8)
    tables = pt.packed_node_tables(pf, "cpu")
    packed, v = pt.pack_bins(torch.from_numpy(xb)), torch.from_numpy(vals)
    before = rk.packed_forest_eval.launches
    got = rk.packed_forest_eval(packed, *tables, v, k1=pf.k1, k2=pf.k2)
    assert torch.equal(got, rk.packed_forest_eval_plain(packed, *tables, v, k1=pf.k1, k2=pf.k2))
    assert rk.packed_forest_eval.launches == before
    meta = [t.to("meta") for t in tables]
    with pytest.raises(ValueError, match="tensors on"):
        rk.packed_forest_eval(packed, *tables, v.to("meta"), k1=pf.k1, k2=pf.k2)
    with pytest.raises(ValueError, match="tensors on"):
        rk.packed_forest_eval(packed.to("meta"), *tables, k1=pf.k1, k2=pf.k2)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        rk.packed_forest_eval(packed.to("meta"), *meta, v.to("meta"), k1=pf.k1, k2=pf.k2)
    with pytest.raises(ValueError, match="values"):
        rk.packed_forest_eval(packed, *tables, v[:, :100], k1=pf.k1, k2=pf.k2)


@pytest.mark.parametrize("words,k1,stage,smem", [
    (64, 7, True, 2 * 8 * 127 * 4 + 2 * 64 * 9 * 4 + 64 * 65 * 4),     # bench rows
    (750, 7, True, 2 * 8 * 127 * 4 + 2 * 64 * 9 * 4 + 64 * 751 * 4),   # 3,000 bytes: one block an SM
    (799, 8, True, 2 * 8 * 255 * 4 + 2 * 64 * 9 * 4 + 64 * 799 * 4),   # the widest staged rows
    (800, 8, False, 2 * 8 * 255 * 4 + 2 * 64 * 9 * 4),                 # read from global memory
])
def test_forest_geometry(words, k1, stage, smem):
    """K9's launch geometry: rows staged at an odd word stride while a
    block's 64 fit _FOREST_STAGE_MAX, the block's shared memory within an
    SM's."""
    got = rk._forest_geometry(words, k1, True)
    assert got == (stage, words | 1, smem)
    assert got[2] <= rk._SMEM_MAX
    assert rk._forest_geometry(words, k1, False)[2] == smem - 2 * 8 * ((1 << k1) - 1) * 4
