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

from pathlib import Path

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


# --- K4 on the card: its grid, its fragment map and its 3xTF32 arithmetic,
# held here through pure functions and a numpy model (the kernel itself
# runs only on the card; chip_smoke.py holds it against the f64 plain
# version there) ---------------------------------------------------------


@pytest.mark.parametrize("d", [3, 124, 256, 300])
@pytest.mark.parametrize("k", [1, 16, 100, 128])
@pytest.mark.parametrize("ni", [1, 70_001, 10**6])
@pytest.mark.parametrize("nq", [1, 1_037, 4_096, 65_536, 131_072])
def test_knn_geometry(nq, ni, d, k):
    sms = 132
    g = tkn._knn_geometry(nq, ni, d, k, sms=sms, blocks_per_sm=1)
    assert g.bm in (64, 128) and 2 <= g.stages <= 4
    assert g.smem == tkn._knn_smem(g.bm, g.stages, k) <= 232_448
    # 128 rows a block wherever the state and two stages fit beside them
    assert (g.bm == 128) == (tkn._knn_smem(128, 2, k) <= 232_448)
    # query block b takes rows [b·bm, (b+1)·bm) cut at nq; split s items
    # [s·T·128, (s+1)·T·128) cut at ni: the (block, split) pairs cover
    # every (query row, item) pair once
    nb = -(-nq // g.bm)
    q0 = np.arange(nb) * g.bm
    q1 = np.minimum(q0 + g.bm, nq)
    i0 = np.arange(g.splits) * g.tiles_per_split * 128
    i1 = np.minimum(i0 + g.tiles_per_split * 128, ni)
    for lo, hi, n in ((q0, q1, nq), (i0, i1, ni)):
        assert lo[0] == 0 and hi[-1] == n and (lo[1:] == hi[:-1]).all() and (hi > lo).all()
    assert g.blocks == nb * g.splits and 1 <= g.splits <= tkn.MAX_SPLITS
    assert g.splits * nq * k * 8 < 2**31  # the partial states' scratch
    resident = sms  # one block an SM: the kernel's registers
    if nb >= 2 * resident:
        assert g.splits == 1
    else:
        # about two waves, and a block on every SM, where the items allow
        # that many splits
        most = max(1, min(tkn.MAX_SPLITS, -(-ni // 128) // 4))
        assert g.blocks >= min(1.5 * resident, nb * most) or g.splits == -(-(-(-ni // 128)) // g.tiles_per_split)
        assert g.blocks <= 3 * resident
        if nb * most >= 2 * resident:
            assert g.blocks >= resident


def test_knn_geometry_forced_and_refused():
    g = tkn._knn_geometry(4096, 10**6, 256, 16, splits=3, stages=2)
    assert (g.splits, g.stages) == (3, 2) and g.tiles_per_split == -(-7813 // 3)
    assert tkn._knn_geometry(10, 300, 8, 4, splits=50).splits == 3  # no empty split
    for k in (0, 129):
        with pytest.raises(NotImplementedError):
            tkn._knn_geometry(10, 10, 8, k)


def _before(s, i, t, j):
    """(s, i) strictly before (t, j) in the (score, id) order."""
    return (s < t) | ((s == t) & (i < j))


# the merge kernel's lists a lane (csrc/knn_topk.cu MERGE_LISTS)
_MERGE_LISTS = (tkn.MAX_SPLITS + 1) // 32


def _merge_model(in_d, in_i, part_d, part_i, k):
    """knn_merge_kernel in numpy, one warp of 32 lanes a row: lane l holds
    lists l, l + 32, ... (list 0 the incoming state, list s + 1 split s's
    partial state), each at its own position, with a (+inf, 0x7fffffff)
    head past its end or past the last list. Each of k rounds: each lane
    takes its least head by (score, id), its first list on a tie; a
    butterfly of shuffles (xor 16, 8, 4, 2, 1) takes the warp's least
    (score, id), the lower lane on a tie; that lane moves that list on."""
    nq = in_d.shape[0]
    n_lists = 1 + part_d.shape[0]
    # heads[q, lane, row, pos]: list lane + 32q, position k the filler
    hd = np.full((_MERGE_LISTS * 32, nq, k + 1), np.inf, np.float32)
    hi = np.full((_MERGE_LISTS * 32, nq, k + 1), 0x7FFFFFFF, np.int64)
    hd[:n_lists, :, :k] = np.concatenate([in_d[None], part_d])
    hi[:n_lists, :, :k] = np.concatenate([in_i[None], part_i])
    hd, hi = hd.reshape(_MERGE_LISTS, 32, nq, k + 1), hi.reshape(_MERGE_LISTS, 32, nq, k + 1)
    pos = np.zeros((_MERGE_LISTS, 32, nq), np.int64)
    q_ix, lane_ix, row_ix = np.meshgrid(np.arange(_MERGE_LISTS), np.arange(32), np.arange(nq), indexing="ij")
    lanes = np.broadcast_to(np.arange(32)[:, None], (32, nq))
    out_d, out_i = np.empty((nq, k), np.float32), np.empty((nq, k), np.int64)
    for r in range(k):
        s, i = hd[q_ix, lane_ix, row_ix, pos], hi[q_ix, lane_ix, row_ix, pos]
        bs, bi, bq = s[0], i[0], np.zeros((32, nq), np.int64)
        for q in range(1, _MERGE_LISTS):
            take = _before(s[q], i[q], bs, bi)
            bs, bi, bq = np.where(take, s[q], bs), np.where(take, i[q], bi), np.where(take, q, bq)
        ms, mi, ml = bs, bi, lanes
        for off in (16, 8, 4, 2, 1):
            o = np.arange(32) ^ off
            os_, oi, ol = ms[o], mi[o], ml[o]
            take = _before(os_, oi, ms, mi) | ((os_ == ms) & (oi == mi) & (ol < ml))
            ms, mi, ml = np.where(take, os_, ms), np.where(take, oi, mi), np.where(take, ol, ml)
        assert (ml == ml[0]).all()  # every lane names the same winner
        out_d[:, r], out_i[:, r] = ms[0], mi[0]
        win = ml[0]
        pos[bq[win, np.arange(nq)], win, np.arange(nq)] += 1
    return out_d, out_i


def test_merge_kernel_constants():
    src = (Path(tkn.__file__).parent.parent / "csrc" / "knn_topk.cu").read_text()
    assert f"constexpr int MAX_SPLITS = {tkn.MAX_SPLITS};" in src
    assert "constexpr int MERGE_LISTS = (MAX_SPLITS + 1) / 32;" in src
    assert "id = 0x7fffffff;" in src


@pytest.mark.parametrize("k", [1, 16, 128])
@pytest.mark.parametrize("splits", [1, 2, 31, 32, 255])
def test_merge_model_matches_lexsort(splits, k):
    # sorted states with (+inf, -1) fillers, exact score ties across lists
    # and the same (score, id) pair in several lists: the merge kernel's
    # walk gives the first k pairs of all the lists in (score, id) order
    rng = np.random.default_rng(1000 * splits + k)
    nq = 6
    n = splits + 1
    d = rng.integers(0, 6, size=(n, nq, k)).astype(np.float32)
    i = rng.integers(0, 3 * k, size=(n, nq, k)).astype(np.int64)
    fill = rng.random((n, nq, k)) < 0.3
    d[fill], i[fill] = np.inf, -1
    o = np.lexsort((i, d), axis=-1)
    d, i = np.take_along_axis(d, o, -1), np.take_along_axis(i, o, -1)
    md, mi = _merge_model(d[0], i[0], d[1:], i[1:], k)
    rd, ri = tkn.lexsort_rows(torch.from_numpy(np.concatenate(d, 1)), torch.from_numpy(np.concatenate(i, 1)), k)
    np.testing.assert_array_equal(mi, ri.numpy())
    np.testing.assert_array_equal(md, rd.numpy())
    assert (mi[np.isinf(md)] == -1).all()  # a filler beyond the lists is never taken


@pytest.mark.parametrize("splits", [1, 3, 7])
def test_knn_item_splits_merge_to_one_pass(splits):
    # the split grid's result: each item range folded into a fresh state,
    # then the incoming state and the partial states merged in (score, id)
    # order by the merge kernel's walk, equals one pass from the incoming
    # state (exact ties included)
    rng = np.random.default_rng(20 + splits)
    Xq, Xi = _blobs(rng, 37, 20), _blobs(rng, 1000, 20)
    q, x = torch.from_numpy(Xq), torch.from_numpy(Xi)
    csq = (x * x).sum(dim=1)
    csq[::9] = float("inf")
    ids = torch.arange(1000, dtype=torch.int32)
    k = 8
    fresh = (torch.full((37, k), float("inf")), torch.full((37, k), -1, dtype=torch.int32))
    incoming = tkn.knn_topk_pass(q, x[:300], csq[:300], ids[:300], *fresh)
    rest = slice(300, 1000)
    g = tkn._knn_geometry(37, 700, 20, k, splits=splits)
    parts = [incoming]
    for s in range(g.splits):
        lo = 300 + s * g.tiles_per_split * 128
        hi = min(1000, lo + g.tiles_per_split * 128)
        parts.append(tkn.knn_topk_pass(q, x[lo:hi], csq[lo:hi], ids[lo:hi], *fresh))
    merged = _merge_model(parts[0][0].numpy(), parts[0][1].numpy(), np.stack([p[0].numpy() for p in parts[1:]]),
                          np.stack([p[1].numpy() for p in parts[1:]]), k)
    one = tkn.knn_topk_pass(q, x[rest], csq[rest], ids[rest], *incoming)
    np.testing.assert_array_equal(merged[1], one[1].numpy())
    np.testing.assert_array_equal(merged[0], one[0].numpy())


def _sw128(r, c):
    """Byte offset of 16-byte chunk ``c`` of row ``r`` in a K-major tile of
    128-byte rows under the 128-byte swizzle (csrc/knn_topk.cu ``sw128``;
    the layout wgmma reads through a B128 descriptor)."""
    return r * 128 + ((c ^ (r & 7)) << 4)


def test_k4_fragment_map_covers_the_tile():
    # the kernel's maps, walked for one 32-feature stage of one block: the
    # query rows and the items stored in the ring slot (rows [0, bm) and
    # [bm, bm + 128), 128-byte rows under the 128-byte swizzle, as the
    # tensor copies store them); each thread's A fragments read from its
    # rows (g and g + 8 of its warp's 16; features t and t + 4 of each k = 8
    # step); the items read as wgmma reads a K-major tile through a B128
    # descriptor; m64n128k8 per warpgroup; and the accumulator fragments
    # mapped back to the score tile by the kernel's formula (row 16·warp + g
    # + 8·((e >> 1) & 1), column 8·(e >> 2) + 2t + (e & 1))
    rng = np.random.default_rng(5)
    bk = 32
    for wg in (2, 1):
        bm = 64 * wg
        Q = rng.normal(size=(bm, bk))
        X = rng.normal(size=(128, bk))
        rows = np.concatenate([Q, X])
        offs = np.array([[_sw128(r, c) for c in range(8)] for r in range(bm + 128)])
        assert len(np.unique(offs)) == offs.size and offs.min() == 0 and offs.max() == (bm + 128) * 128 - 16
        words = np.full((bm + 128) * bk, np.nan)
        for r in range(bm + 128):
            for e in range(bk):
                words[(_sw128(r, e // 4) + 4 * (e % 4)) // 4] = rows[r, e]

        def read(r, kcol):  # a read of row r, feature kcol of the slot
            return words[(_sw128(r, kcol // 4) + 4 * (kcol % 4)) // 4]

        B = np.array([[read(bm + n, c) for c in range(bk)] for n in range(128)])
        np.testing.assert_array_equal(B, X)
        tile = np.full((bm, 128), np.nan)
        hits = np.zeros((bm, 128), int)
        for group in range(wg):
            acc = np.zeros((128, 64))  # [thread of the warpgroup][fragment]
            for kk in range(bk // 8):
                A = np.full((64, 8), np.nan)
                for w in range(4):
                    for lane in range(32):
                        g, t = divmod(lane, 4)
                        r0 = (4 * group + w) * 16 + g
                        for c in range(4):  # a[c]: mma's A fragment layout
                            r, kf = r0 + 8 * (c & 1), kk * 8 + t + 4 * (c >> 1)
                            A[16 * w + g + 8 * (c & 1), t + 4 * (c >> 1)] = read(r, kf)
                D = A @ B[:, kk * 8:kk * 8 + 8].T
                for w in range(4):
                    for lane in range(32):
                        g, t = divmod(lane, 4)
                        for e in range(64):  # wgmma's accumulator layout
                            j, c = divmod(e, 4)
                            acc[32 * w + lane, e] += D[16 * w + g + 8 * (c // 2), 8 * j + 2 * t + c % 2]
            for w in range(4):
                warp = 4 * group + w
                for lane in range(32):
                    g, t = divmod(lane, 4)
                    for e in range(64):  # the kernel's map
                        r = warp * 16 + g + 8 * ((e >> 1) & 1)
                        col = 8 * (e >> 2) + 2 * t + (e & 1)
                        tile[r, col] = acc[32 * w + lane, e]
                        hits[r, col] += 1
        assert (hits == 1).all()
        np.testing.assert_allclose(tile, Q @ X.T, rtol=1e-12, atol=1e-12)
    # the gate's quarter tiles, 64 rows x 32 columns in a warpgroup's own
    # query rows of the slot: thread (warp w, g, t) stores fragments e of
    # quarter h as float pairs at row 16w + g + 8·((e >> 1) & 1), column
    # (8·((e >> 2) - 4h) + 2t) ^ 8·(row & 3); a warp reads row r's lane l at
    # column l ^ 8·(r & 3). Every entry is stored once, read back as written,
    # and each store of a half-warp (16 lanes, 8 bytes each) hits 32
    # distinct banks.
    for h in range(4):
        quarter = np.full((64, 32), -1)
        for w in range(4):
            for e in range(16 * h, 16 * h + 16, 2):
                banks = [[], []]
                for lane in range(32):
                    g, t = divmod(lane, 4)
                    rl = w * 16 + g + 8 * ((e >> 1) & 1)
                    col = 8 * ((e >> 2) - 4 * h) + 2 * t  # the fragment's column in the quarter
                    cl = col ^ (8 * (rl & 3))
                    assert (quarter[rl, cl:cl + 2] == -1).all()
                    quarter[rl, cl:cl + 2] = (col, col + 1)
                    banks[lane // 16] += [(rl * 32 + cl) % 32, (rl * 32 + cl + 1) % 32]
                assert all(len(set(b)) == 32 for b in banks)
        for rl in range(64):
            assert [quarter[rl, lane ^ (8 * (rl & 3))] for lane in range(32)] == list(range(32))


def _rz_f32(x):
    """f64 values to f32, rounded toward zero (the tensor cores' f32
    accumulation)."""
    y = x.astype(np.float32)
    over = np.abs(y.astype(np.float64)) > np.abs(x)
    y[over] = np.nextafter(y[over], np.float32(0))
    return y


def _k4_scores_model(Xq, Xi, csq, slab, three=True):
    """The kernel's scores csq - 2·run in numpy: operands zero-padded to
    whole k = 8 steps and split as the kernel splits them; per k = 8 step
    each TF32 product (lo·hi', hi·lo', hi·hi' in that order, or hi·hi'
    alone for one-pass TF32) adds 8 exact products to the f32 accumulator,
    truncated; a fresh accumulator per slab of features, folded into the
    running f32 score with a rounded add."""
    nq, d = Xq.shape
    dp = -(-d // 8) * 8
    q = np.zeros((nq, dp), np.float32)
    x = np.zeros((Xi.shape[0], dp), np.float32)
    q[:, :d], x[:, :d] = Xq, Xi
    (qh, ql), (xh, xl) = (tuple(t.numpy().astype(np.float64) for t in tkn.tf32_split(torch.from_numpy(a)))
                          for a in (q, x))
    pairs = ((ql, xh), (qh, xl), (qh, xh)) if three else ((qh, xh),)
    run = np.zeros((nq, x.shape[0]), np.float32)
    for s0 in range(0, dp, slab):
        acc = np.zeros_like(run)
        for k0 in range(s0, min(s0 + slab, dp), 8):
            for a, b in pairs:
                acc = _rz_f32(acc + a[:, k0:k0 + 8] @ b[:, k0:k0 + 8].T)
        run = run + acc  # f32: rounded to nearest
    return csq[None, :] - np.float32(2.0) * run


# chip_smoke.py's band: two f32 scores within TAU_UNITS·u·√d·T may order
# either way, T the entry's own terms ‖xq‖² + 2Σ|xq||xi| + ‖xi‖²
_TAU_UNITS, _U32 = 4.0, 2.0**-24


@pytest.mark.parametrize("d", [3, 124, 256, 300])
def test_3xtf32_score_error_within_k4_band(d):
    rng = np.random.default_rng(d)
    if d == 256:  # chip_smoke.py's blobs: shrinking centre scales, unit noise
        centres = rng.normal(size=(64, d)) * (4.0 * 0.9 ** np.arange(d))
        Xq = centres[rng.integers(0, 64, 64)] + rng.normal(size=(64, d))
        Xi = centres[rng.integers(0, 64, 512)] + rng.normal(size=(512, d))
    else:  # its ragged shapes: offset Gaussian rows
        Xq, Xi = rng.normal(size=(64, d)) + 3.0, rng.normal(size=(512, d)) + 3.0
    Xq, Xi = Xq.astype(np.float32), Xi.astype(np.float32)
    csq = (torch.from_numpy(Xi) ** 2).sum(dim=1).numpy()  # f32, as the wrapper's caller forms it
    q, x = Xq.astype(np.float64), Xi.astype(np.float64)
    ref = (x * x).sum(1)[None, :] - 2.0 * q @ x.T
    T = (q * q).sum(1)[:, None] + 2.0 * np.abs(q) @ np.abs(x).T + (x * x).sum(1)[None, :]
    tau = _TAU_UNITS * _U32 * np.sqrt(d) * T
    three = np.abs(_k4_scores_model(Xq, Xi, csq, tkn.K4_SLAB) - ref) / tau
    one = np.abs(_k4_scores_model(Xq, Xi, csq, tkn.K4_SLAB, three=False) - ref) / tau
    assert three.max() <= 0.5, three.max()  # inside the band with a factor 2 to spare
    assert one.max() > 1.0, one.max()  # one-pass TF32 falls outside it
