"""K5 per node (``rf_kernels.node_hist_batched``: every node's histogram of
a compact level, the sub-blocks folded in the kernel) held on the CPU.

- Its plain version against the JAX package's own composition: the
  per-sub-block Pallas kernel (interpret mode) followed by
  ``jax.ops.segment_sum`` over the sub-block -> node map, tree by tree,
  and the JAX ``_hist_compact_batched`` against the port's over a whole
  level. Integer stats are exact in any order, so equal; real stats are
  held to the f32 band u·(8·Σ|terms| + 4·√n·|ref|), n the rows of a node.
- Its summation order, bit for bit: a numpy model that sums each span's
  rows in order from +0 and folds a node's spans in order from +0
  (``SPAN_ROWS`` lowered so that nodes span several), over empty nodes,
  bins past nb and shared and per-tree tables; and, where every node is
  one span and the stats are integers, the per-sub-block plain version
  followed by the in-order per-node sum it replaced.
- The span table and the launch geometry: every sub-block of a real node
  in exactly one span, in order, the dump sub-blocks in none, the kernel's
  grid bounds covering every span and every multi-span node, shared memory
  within 232,448 bytes and the span partials within 256 MB at the builder's
  shapes.
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


@pytest.mark.parametrize(
    "kind,subset,level",
    [("gini", False, 2), ("gini", True, 3), ("int", True, 1), ("real", False, 2)],
)
def test_hist_compact_matches_jax(kind, subset, level):
    """The port's K5 route of ``_hist_compact_batched`` over a whole level
    against the JAX package's (``interpret=True``): the shared (n, F) table
    (no subset) or per-tree (T, n, F) subset bins, the JAX package's own
    r_sub, padded row count and feature chunk."""
    T, n, F, nb, depth = 2, 900, 16, 32, 6
    S = 2 if kind == "gini" else 3
    n_nodes = 1 << level
    r_sub, n_pad, f_chunk = pt.compact_sizes(n, level, depth, S, F, nb)
    lv = _level(12 + level, T, n, n_nodes, F, S, nb, r_sub, subset, kind, empty=0.2, n_pad=n_pad)
    hist_src = lv["bins"]
    ref_h, ref_p = tk._hist_compact_batched(
        jnp.asarray(hist_src.numpy()), jnp.asarray(lv["seg"].numpy().astype(np.int32)), jnp.asarray(lv["sw"].numpy()),
        n_nodes=n_nodes, nb=nb, r_sub=r_sub, n_pad=n_pad, f_chunk=f_chunk, variance=kind != "gini", interpret=True)
    got_h, got_p = pt._hist_compact_batched(hist_src, lv["seg"], lv["sw"], n_nodes=n_nodes, nb=nb, r_sub=r_sub,
                                            n_pad=n_pad)
    assert got_h.shape == ref_h.shape == (T, F, n_nodes, nb, S)
    if kind == "real":
        terms = rk.node_hist_plain(hist_src, lv["src2"], lv["swq"].abs(), lv["pstart"], n_bins=nb, r_sub=r_sub)
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
    parts = rk.subblock_hist_batched(binq.to(torch.int32), lv["swq"], n_bins=32, r_sub=8)
    sb_node = torch.repeat_interleave(torch.arange(T * (n_nodes + 1)), lv["counts"].reshape(-1))
    old = pt._segment_sum(parts.reshape(T * (n_pad // 8), -1), sb_node, T * (n_nodes + 1), grouped=True)
    old = old.reshape(T, n_nodes + 1, S, -1)[:, :n_nodes]
    np.testing.assert_array_equal(_plain(lv).numpy(), old.numpy())


def test_wrapper_takes_the_plain_version_on_the_cpu():
    lv = _level(41, 1, 300, 2, 16, 2, 32, 8, False, "gini")
    got = rk.node_hist_batched(lv["bins"], lv["src2"], lv["swq"], lv["pstart"], n_bins=32, r_sub=8)
    np.testing.assert_array_equal(got.numpy(), _plain(lv).numpy())
    with pytest.raises(ValueError):
        rk.node_hist_batched(lv["bins"], lv["src2"], lv["swq"][:, :-1], lv["pstart"], n_bins=32, r_sub=8)


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
