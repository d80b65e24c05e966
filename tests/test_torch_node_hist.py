"""K5 and K6 per node (``rf_kernels.node_hist_batched``,
``node_hist_sel_batched``: every node's histogram of a compact level, the
sub-blocks folded in the kernel; K6 picks each node's columns from the
full rows) held on the CPU.

- Its plain version against the JAX package's own composition: the
  per-sub-block Pallas kernel (interpret mode) followed by
  ``jax.ops.segment_sum`` over the sub-block -> node map, tree by tree,
  and the JAX ``_hist_compact_batched`` against the port's over a whole
  level, with K6's wide route against the JAX package's ``full_bins``
  branch (the node-sorted full rows through its fused-selection Pallas
  kernel). Integer stats are exact in any order, so equal; real stats are
  held to the f32 band u·(8·Σ|terms| + 4·√n·|ref|), n the rows of a node.
- Its summation order, bit for bit: a numpy model that sums each span's
  rows in order from +0 and folds a node's spans in order from +0
  (``SPAN_ROWS`` lowered so that nodes span several), over empty nodes,
  bins past nb and shared and per-tree tables, and K6's selection with
  sentinel ids inside and past the row; and, where every node is
  one span and the stats are integers, the per-sub-block plain version
  followed by the in-order per-node sum it replaced.
- The span table and the launch geometry: every sub-block of a real node
  in exactly one span, in order, the dump sub-blocks in none, the kernel's
  grid bounds covering every span and every multi-span node, shared memory
  within 232,448 bytes and the span partials within 256 MB at the builder's
  shapes (K6's at the 3,000-wide forest's, 131,072 and 1,000,000 rows), and
  the wide route's memory estimate at the reference's 1,000,000 rows.
"""

import bisect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import spark_rapids_ml_tpu.ops.rf_pallas as rfp
import spark_rapids_ml_tpu.ops.tree_kernels as tk
from spark_rapids_ml_tpu_torch.ops import rf_kernels as rk
from spark_rapids_ml_tpu_torch.ops import tree_kernels as pt

U32 = 2.0 ** -24


def _level(seed, T, n, n_nodes, F, S, nb, r_sub, per_tree, kind, empty=0.0, n_pad=None):
    """A compact level laid out by the port's glue: rows spread over the
    nodes at random (``empty`` of them hold none, a tenth of the rows are in
    no node), uint8 bins some of which are >= nb, and stats x weight: class
    counts (gini), integer-label moments (int) or Gaussian (real); weights
    0 on padding rows."""
    rng = np.random.default_rng(seed)
    p = rng.random(n_nodes) + 0.05
    p[rng.permutation(n_nodes)[:int(empty * n_nodes)]] = 0.0
    p = np.r_[0.9 * p / p.sum(), 0.1]
    seg = torch.from_numpy(rng.choice(n_nodes + 1, size=(T, n), p=p))
    if n_pad is None:
        # a multiple of BLOCK_ROWS as the builder pads (of r_sub where r_sub
        # does not divide it)
        step = r_sub if rk.BLOCK_ROWS % r_sub else rk.BLOCK_ROWS
        n_pad = -(-(n + (n_nodes + 1) * r_sub) // step) * step
    src2, pvalid, _, counts, pstart = pt._compact_layout(seg, n_nodes, r_sub, n_pad)
    bins = rng.integers(0, min(256, nb + 4), size=(T, n, F) if per_tree else (n, F)).astype(np.uint8)
    w = rng.integers(0, 3, size=(T, n)).astype(np.float32)
    if kind == "gini":
        sw = np.eye(S, dtype=np.float32)[rng.integers(0, S, size=(T, n))] * w[..., None]
    elif kind == "int":
        y = rng.integers(0, 10, size=(T, n)).astype(np.float32)
        sw = np.stack([np.ones_like(y), y, y * y], -1)[..., :S] * w[..., None]
    else:
        sw = rng.normal(size=(T, n, S)).astype(np.float32)
    sw = torch.from_numpy(np.ascontiguousarray(sw, dtype=np.float32))
    swq = (sw.gather(1, src2[..., None].expand(T, n_pad, S)) * pvalid[..., None]).contiguous()
    return {"seg": seg, "sw": sw, "bins": torch.from_numpy(bins), "src2": src2, "swq": swq, "pstart": pstart,
            "counts": counts, "n_pad": n_pad, "n_nodes": n_nodes, "nb": nb, "r_sub": r_sub, "T": T, "S": S, "F": F}


def _plain(lv):
    return rk.node_hist_plain(lv["bins"], lv["src2"], lv["swq"], lv["pstart"], n_bins=lv["nb"], r_sub=lv["r_sub"])


def _hold(got, ref, terms, n, exact):
    if exact:
        np.testing.assert_array_equal(got, ref)
        return
    tol = U32 * (8.0 * terms + 4.0 * np.sqrt(n) * np.abs(ref)) + 1e-30
    np.testing.assert_array_less(np.abs(got.astype(np.float64) - ref), tol)


def _longest(lv):
    return int((lv["pstart"][:, 1:] - lv["pstart"][:, :-1]).max())


# ---------------------------------------------------------------------------
# (a) against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,per_tree,S", [("gini", False, 2), ("int", True, 3), ("real", False, 3)])
def test_plain_matches_pallas_subblocks_and_segment_sum(kind, per_tree, S):
    """Tree by tree: the Pallas per-sub-block kernel (interpret) on the
    gathered int32 bins, then ``jax.ops.segment_sum`` over the sub-block ->
    node map (the dump sub-blocks into the dropped slot n_nodes)."""
    lv = _level(11, 2, 700, 4, 16, S, 32, 16, per_tree, kind, empty=0.25)
    got = _plain(lv).numpy()
    terms = rk.node_hist_plain(lv["bins"], lv["src2"], lv["swq"].abs(), lv["pstart"], n_bins=32, r_sub=16).numpy()
    n_sb = lv["n_pad"] // 16
    for t in range(lv["T"]):
        table = lv["bins"][t] if per_tree else lv["bins"]
        binq = table.index_select(0, lv["src2"][t]).to(torch.int32).numpy()
        parts = rfp.subblock_hist(jnp.asarray(binq), jnp.asarray(lv["swq"][t].numpy()), n_bins=32, r_sub=16,
                                  variance=kind != "gini", interpret=True)
        seg_red = np.repeat(np.arange(lv["n_nodes"] + 1), lv["counts"][t].numpy())
        ref = np.asarray(jax.ops.segment_sum(parts.reshape(n_sb, -1), jnp.asarray(seg_red),
                                             num_segments=lv["n_nodes"] + 1))[:lv["n_nodes"]]
        _hold(got[t], ref.reshape(got[t].shape), terms[t], _longest(lv), kind != "real")


def _feats(seed, T, n_nodes, n_features, k, F):
    """Each node's k distinct feature ids of n_features, sentinel
    n_features up to F slots, (T, n_nodes, F) int32."""
    rng = np.random.default_rng(seed)
    ids = np.argsort(rng.random((T, n_nodes, n_features)), axis=2)[..., :k]
    return np.concatenate([ids, np.full((T, n_nodes, F - k), n_features)], 2).astype(np.int32)


@pytest.mark.parametrize(
    "kind,subset,level,n_features",
    [pytest.param("gini", False, 2, None, id="gini-False-2"), pytest.param("gini", True, 3, None, id="gini-True-3"),
     pytest.param("int", True, 1, None, id="int-True-1"), pytest.param("real", False, 2, None, id="real-False-2"),
     # K6's wide route: full rows, the sentinel a zero pad column (60 of 64)
     # or past the row (64 of 64)
     pytest.param("gini", True, 3, 60, id="gini-full-60-of-64"),
     pytest.param("int", True, 2, 64, id="int-full-64-of-64"),
     pytest.param("real", True, 2, 60, id="real-full-60-of-64")],
)
def test_hist_compact_matches_jax(kind, subset, level, n_features):
    """The port's route of ``_hist_compact_batched`` over a whole level
    against the JAX package's (``interpret=True``): K5 over the shared (n,
    F) table (no subset) or per-tree (T, n, F) subset bins, or K6 over the
    shared full (n, 64) rows with each node's 11 ids (``full_bins``,
    ``feats``), the JAX package's own r_sub, padded row count and feature
    chunk."""
    T, n, F, nb, depth = 2, 900, 16, 32, 6
    S = 2 if kind == "gini" else 3
    n_nodes = 1 << level
    r_sub, n_pad, f_chunk = pt.compact_sizes(n, level, depth, S, F, nb)
    full = n_features is not None
    lv = _level(12 + level, T, n, n_nodes, 64 if full else F, S, nb, r_sub, subset and not full, kind, empty=0.2,
                n_pad=n_pad)
    jkw = dict(n_nodes=n_nodes, nb=nb, r_sub=r_sub, n_pad=n_pad, f_chunk=f_chunk, variance=kind != "gini",
               interpret=True)
    seg = jnp.asarray(lv["seg"].numpy().astype(np.int32))
    if full:
        bins = lv["bins"].clone()
        bins[:, n_features:] = 0
        feats = torch.from_numpy(_feats(level, T, n_nodes, n_features, 11, F))
        ref_h, ref_p = tk._hist_compact_batched(None, seg, jnp.asarray(lv["sw"].numpy()), full_bins=jnp.asarray(
            bins.numpy()), feats=jnp.asarray(feats.numpy()), **jkw)
        got_h, got_p = pt._hist_compact_batched(None, lv["seg"], lv["sw"], n_nodes=n_nodes, nb=nb, r_sub=r_sub,
                                                n_pad=n_pad, full_bins=bins, feats=feats)
        terms = rk.node_hist_sel_plain(bins, lv["src2"], lv["swq"].abs(), lv["pstart"], feats, n_bins=nb,
                                       r_sub=r_sub)
    else:
        hist_src = lv["bins"]
        ref_h, ref_p = tk._hist_compact_batched(jnp.asarray(hist_src.numpy()), seg, jnp.asarray(lv["sw"].numpy()),
                                                **jkw)
        got_h, got_p = pt._hist_compact_batched(hist_src, lv["seg"], lv["sw"], n_nodes=n_nodes, nb=nb, r_sub=r_sub,
                                                n_pad=n_pad)
        terms = rk.node_hist_plain(hist_src, lv["src2"], lv["swq"].abs(), lv["pstart"], n_bins=nb, r_sub=r_sub)
    assert got_h.shape == ref_h.shape == (T, F, n_nodes, nb, S)
    if kind == "real":
        terms = terms.reshape(T, n_nodes, S, F, nb).permute(0, 3, 1, 4, 2).numpy()
        _hold(got_h.numpy(), np.asarray(ref_h), terms, _longest(lv), False)
        np.testing.assert_allclose(got_p.numpy(), np.asarray(ref_p), rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(got_h.numpy(), np.asarray(ref_h))
        np.testing.assert_array_equal(got_p.numpy(), np.asarray(ref_p))


# ---------------------------------------------------------------------------
# (b) the span order, bit for bit
# ---------------------------------------------------------------------------


def _numpy_span_model(lv, span_rows):
    """Each span's bins summed over its rows in row order from +0 in f32,
    each node the in-order f32 fold of its spans from +0."""
    bins, src2, swq, pstart = (lv[k].numpy() for k in ("bins", "src2", "swq", "pstart"))
    T, n_nodes, S, F, nb, r_sub = lv["T"], lv["n_nodes"], lv["S"], lv["F"], lv["nb"], lv["r_sub"]
    a = max(1, span_rows // r_sub)
    out = np.zeros((T, n_nodes, S, F, nb), np.float32)
    for t in range(T):
        table = bins[t] if bins.ndim == 3 else bins
        for j in range(n_nodes):
            lo, hi = int(pstart[t, j]), int(pstart[t, j + 1])
            node = np.zeros((S, F, nb), np.float32)
            start = lo
            while True:
                end = min(hi, start + a * r_sub)
                span = np.zeros((S, F, nb), np.float32)
                for r in range(start, end):
                    b = table[src2[t, r]].astype(np.int64)
                    ok = b < nb
                    span[:, np.nonzero(ok)[0], b[ok]] += swq[t, r][:, None]
                node += span
                start = end
                if start >= hi:
                    break
            out[t, j] = node
    return out.reshape(T, n_nodes, S, F * nb)


@pytest.mark.parametrize(
    "per_tree,kind,span_rows,r_sub,nb",
    [(False, "real", 64, 8, 20), (True, "real", 48, 7, 32), (False, "int", 32, 4, 255), (True, "gini", 4096, 16, 16)],
)
def test_plain_equals_numpy_span_model(monkeypatch, per_tree, kind, span_rows, r_sub, nb):
    monkeypatch.setattr(rk, "SPAN_ROWS", span_rows)
    S = 2 if kind == "gini" else 3
    lv = _level(21 + r_sub, 2, 500, 5, 12, S, nb, r_sub, per_tree, kind, empty=0.3)
    spans = (lv["pstart"][:, 1:] - lv["pstart"][:, :-1]) // r_sub
    if span_rows < 4096:
        assert bool((spans > rk.span_subblocks(r_sub)).any()), "no node longer than one span"
    assert bool((spans == 0).any()), "no empty node"
    assert bool((lv["bins"] >= nb).any()) or nb > 250
    got = _plain(lv).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), _numpy_span_model(lv, span_rows).view(np.uint32))


def _numpy_sel_rows(lv, feats):
    """K6's bins of every padded row, in numpy: its node's ids read from
    its source row, 0 past the row."""
    bins, src2, pstart = lv["bins"].numpy(), lv["src2"].numpy(), lv["pstart"].numpy()
    T, n_pad, d_row = src2.shape[0], src2.shape[1], bins.shape[1]
    out = np.zeros((T, n_pad, feats.shape[-1]), np.uint8)
    for t in range(T):
        for r in range(n_pad):
            j = min(int(np.searchsorted(pstart[t, 1:], r, side="right")), lv["n_nodes"] - 1)
            for f, i in enumerate(feats[t, j]):
                out[t, r, f] = bins[src2[t, r], i] if 0 <= i < d_row else 0
    return out


@pytest.mark.parametrize(
    "kind,span_rows,r_sub,nb,n_features",
    [("real", 64, 8, 20, 40), ("int", 48, 7, 255, 40), ("gini", 4096, 16, 16, 37)],
)
def test_sel_plain_equals_numpy_span_model(monkeypatch, kind, span_rows, r_sub, nb, n_features):
    """K6's plain version: the numpy span model over rows whose bins are
    each node's ids read from the full row (sentinel ids past the row at 40
    of 40, a pad column at 37 of 40), multi-span and empty nodes."""
    monkeypatch.setattr(rk, "SPAN_ROWS", span_rows)
    S = 2 if kind == "gini" else 3
    lv = _level(61 + r_sub, 2, 500, 5, 40, S, nb, r_sub, False, kind, empty=0.3)
    spans = (lv["pstart"][:, 1:] - lv["pstart"][:, :-1]) // r_sub
    if span_rows < 4096:
        assert bool((spans > rk.span_subblocks(r_sub)).any()), "no node longer than one span"
    assert bool((spans == 0).any()), "no empty node"
    feats = _feats(r_sub, 2, 5, n_features, 9, 16)
    got = rk.node_hist_sel_batched(lv["bins"], lv["src2"], lv["swq"], lv["pstart"], torch.from_numpy(feats),
                                   n_bins=nb, r_sub=r_sub).numpy()
    model = _numpy_span_model({**lv, "bins": torch.from_numpy(_numpy_sel_rows(lv, feats)),
                               "src2": torch.arange(lv["n_pad"]).expand(2, -1), "F": 16}, span_rows)
    np.testing.assert_array_equal(got.view(np.uint32), model.view(np.uint32))


@pytest.mark.parametrize("per_tree,S", [(False, 2), (True, 3)])
def test_one_span_integer_stats_equal_subblock_route(per_tree, S):
    """Every node one span, integer stats: equal to the per-sub-block plain
    version followed by the in-order per-node sum of its partials (the
    route the builder took before)."""
    lv = _level(31, 2, 800, 8, 16, S, 32, 8, per_tree, "gini" if S == 2 else "int", empty=0.2)
    assert int((lv["pstart"][:, 1:] - lv["pstart"][:, :-1]).max()) <= rk.SPAN_ROWS
    T, n_pad, n_nodes = lv["T"], lv["n_pad"], lv["n_nodes"]
    if per_tree:
        binq = lv["bins"].gather(1, lv["src2"][..., None].expand(T, n_pad, 16))
    else:
        binq = lv["bins"].index_select(0, lv["src2"].reshape(-1)).reshape(T, n_pad, 16)
    parts = rk.subblock_hist_plain(binq.to(torch.int32).reshape(T * n_pad, 16), lv["swq"].reshape(T * n_pad, S),
                                   n_bins=32, r_sub=8)
    sb_node = torch.repeat_interleave(torch.arange(T * (n_nodes + 1)), lv["counts"].reshape(-1))
    old = pt._segment_sum(parts.reshape(T * (n_pad // 8), -1), sb_node, T * (n_nodes + 1))
    old = old.reshape(T, n_nodes + 1, S, -1)[:, :n_nodes]
    np.testing.assert_array_equal(_plain(lv).numpy(), old.numpy())


def test_wrapper_takes_the_plain_version_on_the_cpu():
    lv = _level(41, 1, 300, 2, 16, 2, 32, 8, False, "gini")
    got = rk.node_hist_batched(lv["bins"], lv["src2"], lv["swq"], lv["pstart"], n_bins=32, r_sub=8)
    np.testing.assert_array_equal(got.numpy(), _plain(lv).numpy())
    with pytest.raises(ValueError):
        rk.node_hist_batched(lv["bins"], lv["src2"], lv["swq"][:, :-1], lv["pstart"], n_bins=32, r_sub=8)


def test_sel_wrapper_takes_the_plain_version_on_the_cpu():
    lv = _level(42, 2, 300, 3, 32, 2, 32, 8, False, "gini")
    feats = torch.from_numpy(_feats(1, 2, 3, 30, 5, 8))
    got = rk.node_hist_sel_batched(lv["bins"], lv["src2"], lv["swq"], lv["pstart"], feats, n_bins=32, r_sub=8)
    ref = rk.node_hist_sel_plain(lv["bins"], lv["src2"], lv["swq"], lv["pstart"], feats, n_bins=32, r_sub=8)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
    with pytest.raises(ValueError):
        rk.node_hist_sel_batched(lv["bins"], lv["src2"], lv["swq"], lv["pstart"], feats[:, :2], n_bins=32, r_sub=8)
    with pytest.raises(ValueError):
        rk.node_hist_sel_batched(lv["bins"][None].expand(2, -1, -1), lv["src2"], lv["swq"], lv["pstart"], feats,
                                 n_bins=32, r_sub=8)


# ---------------------------------------------------------------------------
# (c) the span table and the launch geometry
# ---------------------------------------------------------------------------


def _kernel_walk(pstart, r_sub, n_pad, geo):
    """The span kernel's and the fold's view of a layout, as csrc/rf_hist.cu
    computes it: the span table (exclusive prefix sums over the nodes), each
    block u < geo.spans mapped to its node (u < n_nodes: node u's first
    span; else by the table's binary search over the spans past a node's
    first) and to its run of sub-blocks; returns {(t, sub-block): (node,
    span)} for every sub-block a block reads, after checking that the
    fold's x < geo.multi reach every multi-span node."""
    a = geo.a
    seen, folded = {}, set()
    for t in range(pstart.shape[0]):
        sbs = [int(v) // r_sub for v in pstart[t]]
        nn = len(sbs) - 1
        spans = [1 if sbs[j + 1] - sbs[j] <= a else -(-(sbs[j + 1] - sbs[j]) // a) for j in range(nn)]
        extra_cum = np.r_[0, np.cumsum([s - 1 for s in spans])]
        multi_cum = np.r_[0, np.cumsum([s > 1 for s in spans])]
        part_cum = np.r_[0, np.cumsum([s if s > 1 else 0 for s in spans])]
        assert part_cum[-1] <= geo.part_slots and multi_cum[-1] <= geo.multi and nn + extra_cum[-1] <= geo.spans
        for u in range(geo.spans):
            if u < nn:   # a node's first span
                j, i = u, 0
            elif u - nn < extra_cum[-1]:   # a span past its node's first
                j = bisect.bisect_right(extra_cum[:-1], u - nn) - 1
                i = 1 + u - nn - extra_cum[j]
            else:
                continue
            for sb in range(sbs[j] + i * a, min(sbs[j + 1], sbs[j] + (i + 1) * a)):
                assert (t, sb) not in seen, "a sub-block read by two blocks"
                seen[(t, sb)] = (j, i)
        for x in range(geo.multi):
            if x < multi_cum[-1]:
                folded.add((t, int(np.searchsorted(multi_cum[1:], x, side="right"))))
        assert folded >= {(t, j) for j in range(nn) if spans[j] > 1}
    return seen


@pytest.mark.parametrize("span_rows,r_sub,empty", [(64, 8, 0.3), (4096, 16, 0.0), (40, 7, 0.5)])
def test_span_table_covers_every_real_subblock_once(monkeypatch, span_rows, r_sub, empty):
    monkeypatch.setattr(rk, "SPAN_ROWS", span_rows)
    lv = _level(51, 3, 600, 6, 8, 2, 32, r_sub, False, "gini", empty=empty)
    pstart, n_pad = lv["pstart"], lv["n_pad"]
    T, n_sb, a = lv["T"], n_pad // r_sub, rk.span_subblocks(r_sub)
    span_of_sb, span_node, n_spans = rk.node_spans(pstart, r_sub, n_pad)
    sbs = (pstart // r_sub).numpy()
    for t in range(T):
        for sb in range(n_sb):
            real = sb < sbs[t, -1]
            s = int(span_of_sb[t, sb])
            if not real:
                assert s == n_spans, "a dump sub-block in a span"
                continue
            j = int(np.searchsorted(sbs[t, 1:], sb, side="right"))
            assert int(span_node[s]) == t * lv["n_nodes"] + j
            assert (sb - sbs[t, j]) // a == s - int((span_node < t * lv["n_nodes"] + j).sum())
    # spans in node order, each node at least one
    assert bool((span_node[1:] >= span_node[:-1]).all())
    assert torch.equal(torch.unique(span_node), torch.arange(T * lv["n_nodes"]))
    geo = rk.node_hist_geometry(T, n_pad, r_sub, lv["n_nodes"], 8, 2, 32)
    seen = _kernel_walk(pstart, r_sub, n_pad, geo)
    assert set(seen) == {(t, sb) for t in range(T) for sb in range(int(sbs[t, -1]))}


@pytest.mark.parametrize("a_extra", [1, 2])
def test_geometry_bounds_hold_for_the_worst_layout(a_extra):
    """Every node of a + a_extra sub-blocks (the most nodes of more than one
    span): the spans, multi-span nodes and partial slots stay within the
    geometry's bounds."""
    r_sub, n_nodes = 8, 40
    a = rk.span_subblocks(r_sub)
    c = a + a_extra
    n_pad = (n_nodes * c + 3) * r_sub
    pstart = torch.arange(n_nodes + 1)[None] * c * r_sub
    geo = rk.node_hist_geometry(1, n_pad, r_sub, n_nodes, 16, 2, 32)
    _kernel_walk(pstart, r_sub, n_pad, geo)


def _builder_shapes():
    # (T, n, depth, S, F, nb): the GBT (one tree, all 256 features), the
    # bench forest (8 trees, k = 16), its regressor (S = 3, 128 slots), a
    # 1,024-wide GBT, and nb = 256 and 32
    for T, n, depth, S, F, nb in ((1, 131_072, 8, 4, 256, 128), (8, 131_072, 13, 2, 16, 128),
                                  (8, 131_072, 13, 3, 128, 128), (1, 1_000_000, 8, 4, 1024, 128),
                                  (8, 131_072, 13, 2, 16, 256), (4, 500_000, 10, 5, 64, 32)):
        for level in range(depth):
            yield T, n, depth, level, S, F, nb


def test_geometry_within_shared_memory_and_scratch_at_builder_shapes():
    for T, n, depth, level, S, F, nb in _builder_shapes():
        r_sub, n_pad, _ = pt.compact_sizes(n, level, depth, S, F, nb)
        for vec in (True, False):
            geo = rk.node_hist_geometry(T, n_pad, r_sub, 1 << level, F, S, nb, vec)
            assert geo.smem <= 232_448, (T, level, F, geo)
            assert geo.scratch_bytes <= 256 << 20, (T, level, F, geo)
            assert geo.P % 32 == 0 and 32 <= geo.P <= 256
            assert geo.pitch % 16 == 0 and geo.rows >= 1
            # the stage holds the rows a chunk reads, and then the write's transpose
            assert geo.smem - 4 * geo.P * nb >= 2 * geo.rows * (geo.pitch + 4 * geo.ns) + 16 * geo.rows
            assert geo.smem - 4 * geo.P * nb >= 80 * geo.P + 16 * geo.rows
            if (T, n, F) == (1, 131_072, 256):
                assert geo.fc == F, "the GBT's slots in one launch"


def test_geometry_gbt_level7_one_launch_three_blocks_an_sm():
    r_sub, n_pad, _ = pt.compact_sizes(131_072, 7, 8, 4, 256, 128)
    geo = rk.node_hist_geometry(1, n_pad, r_sub, 128, 256, 4, 128)
    assert (geo.fc, geo.P, -(-4 * 256 // geo.P)) == (256, 128, 8)
    assert 3 * (geo.smem + 1024) <= 233_472


def _wide_forest_shapes():
    # (n, level): the 3,000-wide forest (8 trees, depth 13, k 55 -> 64,
    # d_pad 4,096, S 2, nb 128) at chip_smoke's 131,072 rows and the
    # reference's 1,000,000
    for n in (131_072, 1_000_000):
        for level in range(13):
            yield n, level


def test_sel_geometry_within_shared_memory_and_scratch_at_wide_forest_shapes():
    for n, level in _wide_forest_shapes():
        r_sub, n_pad, _ = pt.compact_sizes(n, level, 13, 2, 64, 128)
        geo = rk.node_hist_sel_geometry(8, n_pad, r_sub, 1 << level, 64, 2, 128)
        assert geo.smem <= 232_448, (n, level, geo)
        assert geo.scratch_bytes <= 256 << 20, (n, level, geo)
        assert geo.P % 32 == 0 and 32 <= geo.P <= 256 and geo.pitch % 16 == 0
        # a staged row holds the 4-byte word of each slot a tile touches
        assert geo.pitch >= 4 * min(geo.fc, (geo.P - 1) // 2 + 2) and geo.rows >= 1
        if n == 131_072:
            assert geo.fc == 64 and geo.P == 128, "the 131,072-row levels in one launch of one tile"


def test_sel_geometry_spans_cover_every_real_subblock_once(monkeypatch):
    monkeypatch.setattr(rk, "SPAN_ROWS", 64)
    lv = _level(52, 3, 600, 6, 64, 2, 32, 8, False, "gini", empty=0.3)
    geo = rk.node_hist_sel_geometry(3, lv["n_pad"], 8, 6, 16, 2, 32)
    seen = _kernel_walk(lv["pstart"], 8, lv["n_pad"], geo)
    sbs = (lv["pstart"] // 8).numpy()
    assert set(seen) == {(t, sb) for t in range(3) for sb in range(int(sbs[t, -1]))}


def test_wide_route_fits_the_reference_rows_on_an_80gb_card():
    """The builder's estimate of what the wide route holds at level 12 of
    1,000,000 x 3,000 rows, 8 trees, passes ``use_sel`` at an 80 GB card's
    budget (three quarters of it), with room for the rows the fit copies."""
    r_sub, n_pad, _ = pt.compact_sizes(1_000_000, 12, 13, 2, 64, 128)
    resident = pt._sel_resident(1_000_000, 4096, 8, n_pad, 4096, 2, 64, 128)
    assert resident <= 0.75 * 80e9 - 12e9, resident
