"""RandomForest builder and inference of the port (counterpart of
``spark_rapids_ml_tpu/ops/tree_kernels.py``).

* **Quantization**: host quantile edges (``make_bin_edges``, the JAX
  package's code, so the edges are bitwise equal) and a compare-count
  ``binize`` on the device (NaN lands in bin 0).
* **Builder**: level-wise histogram trees, T trees per level
  (``_grow_trees_batched``). Each split level runs the compact route of the
  JAX package: a stable sort of each tree's rows by node, every node's run
  padded to a multiple of ``r_sub`` rows, and one kernel launch for the
  whole tree batch, which reads each row's uint8 bins through the sort
  permutation and writes every node's histogram (its sub-blocks folded in
  the kernel): K5 over each tree's rows of its subset-gathered (or all)
  bins, or K6, which picks each node's feature subset from the full rows
  itself at ``d_pad > 1024``. The padded row counts and ``r_sub`` follow
  the JAX package's formulas, so both packages pad alike at every level.
  A level whose histogram tile exceeds ``_COMPACT_TILE_MAX`` (2^28)
  entries takes a plain scatter, as the JAX package does there.
* **Inference**: the packed-forest engine (``pack_forest``'s layout as
  K9's node words, both hops and the payload sum in one K9 launch a batch,
  the JAX package's summation order) for forests of depth <= 14; the
  two-hop bins engine (the same
  descent tree by tree in groups of 8, hop 2's feature bins gathered by
  K8, one launch per group), whose results equal the packed engine's bit
  for bit; and the raw-threshold descent (``forest_apply``) for deeper
  forests.

Every per-node sum is deterministic: the kernels add in row order without
atomics, K5 and K6 fold a node's spans in order (``rf_kernels.SPAN_ROWS``),
the per-node reductions (``_segment_sum``) sum each segment in order, and the
sums over a node's bins (parent stats, the gain search's
prefix sums) accumulate in f64 and round once. So a fit is bitwise
repeatable on the card and equal to the CPU's, also for real-valued
(regression, boosting) stats; integer stats (class counts times bootstrap
weights) are exact, so classification trees equal the JAX package's bit
for bit given the same draws.

Randomness: the JAX package draws bootstrap weights and per-level feature
uniforms from ``jax.random`` keys, whose bits cannot be reproduced. The
port draws the same quantities, with the same shapes and the same
logical-row indexing, from ``torch.Generator``s on the CPU derived from
the seed (``TorchDraws``), so a card fit and a CPU fit see the same draws;
the builder takes any other source through ``draws=`` (the tests feed it
the JAX package's own draws). A port fit and a JAX fit with the same seed
grow different forests.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..runtime import telemetry
from .rf_kernels import (
    _NH_SCRATCH_MAX,
    BLOCK_ROWS,
    LANES,
    _leaf_ids,
    forest_nodes,
    node_hist_batched,
    node_hist_sel_batched,
    packed_byte_gather_many,
    packed_forest_eval,
)

# elements per (F, nodes, bins, stats) histogram tile of the gain search
_HIST_BUDGET = 1 << 22
# minimum feature width for the fused-selection kernel K6 (below it the
# per-row subset gather is cheap); tests lower it
_SEL_MIN_DPAD = 1024
# largest (nodes, features, bins, stats) histogram tile of the compact
# route; a level past it takes the plain scatter (the JAX package's bound)
_COMPACT_TILE_MAX = 1 << 28
# device budget on the CPU (the JAX package's default without a device
# memory report)
_CPU_BUDGET = 12e9


class ForestConfig(NamedTuple):
    """Build configuration."""

    max_depth: int
    n_bins: int
    n_features: int        # real (unpadded) feature count
    n_stats: int           # classification: n_classes; regression: 3
    impurity: str          # "gini" | "entropy" | "variance"
    k_features: int        # features sampled per node (featureSubsetStrategy)
    min_samples_leaf: int  # Spark minInstancesPerNode
    min_info_gain: float   # Spark minInfoGain
    min_samples_split: int
    bootstrap: bool


def max_nodes(max_depth: int) -> int:
    """Full binary tree layout: node i's children are 2i+1 / 2i+2."""
    return (1 << (max_depth + 1)) - 1


def next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def _sel_hbm_budget(device: torch.device) -> float:
    """Three quarters of the card's memory (the CPU: a 12 GB default)."""
    if device.type == "cuda":
        return 0.75 * float(torch.cuda.mem_get_info(device)[1])
    return _CPU_BUDGET


def _sel_resident(n: int, d_pad: int, T: int, n_pad: int, n_nodes: int, S: int, d_hist: int, nb: int) -> int:
    """Device bytes of a level of the wide route (K6): the shared (n,
    d_pad) bins, each padded row's source index and weights, the node
    histograms and the gain search's permuted copy, and the span partials'
    bound."""
    return n * d_pad + T * n_pad * (8 + 4 * S) + 2 * T * n_nodes * S * d_hist * nb * 4 + _NH_SCRATCH_MAX


def _largest_divisor_leq(t: int, b: int) -> int:
    for d in range(min(t, b), 0, -1):
        if t % d == 0:
            return d
    return 1


def resolve_tree_batch(t_group: int, cfg: ForestConfig, n_rows: int, device: torch.device) -> int:
    """Trees advanced per level: the widest divisor of ``t_group`` whose
    per-level residents (stat weights, routing ids, subset-gathered bins,
    histogram copies) fit a quarter of ``_sel_hbm_budget`` (the JAX
    package's ``auto`` rule). The subset term counts the per-tree gathered
    bins of the route below d_pad 1,024; the wide route (K6) holds no copy
    of the rows, only each padded row's source index and weights beside
    the shared table (``_sel_resident``), which the same term bounds."""
    budget = _sel_hbm_budget(device) / 4.0
    subset = cfg.k_features < cfg.n_features
    d_hist = next_pow2(cfg.k_features if subset else max(1, cfg.n_features))
    n_nodes_max = 1 << max(0, cfg.max_depth - 1)
    tile = min(_HIST_BUDGET, n_nodes_max * cfg.n_bins * cfg.n_stats * d_hist)
    per_tree = 4 * n_rows * (cfg.n_stats + 4 + (d_hist if subset else 0)) + 16 * tile
    fit = max(1, int(budget // max(1, per_tree)))
    return _largest_divisor_leq(t_group, min(t_group, fit))


# ---------------------------------------------------------------------------
# quantization
# ---------------------------------------------------------------------------


def make_bin_edges(
    X: np.ndarray, n_bins: int, max_sample: int = 131072, seed: int = 0
) -> np.ndarray:
    """Per-feature quantile bin edges (host, on a row subsample):
    ``(d, n_bins - 1)`` float32; row x falls in bin ``#{edges <= x}``."""
    n = X.shape[0]
    if n > max_sample:
        idx = np.random.default_rng(seed).choice(n, max_sample, replace=False)
        Xs = X[idx]
    else:
        Xs = X
    qs = np.linspace(0.0, 1.0, n_bins + 1)[1:-1]
    edges = np.quantile(np.asarray(Xs, dtype=np.float64), qs, axis=0)
    return np.ascontiguousarray(edges.T.astype(np.float32))  # (d, nb-1)


def binize(X: torch.Tensor, edges: torch.Tensor, *, d_pad: int) -> torch.Tensor:
    """Quantize rows to bins: (n, d) x (d, nb-1) -> (n, d_pad) uint8,
    bin = #{edges <= x} as a compare-count in feature chunks (the (n, Fc,
    nb) compare tile stays near 2^22 · nb entries). NaN compares false
    against every edge and lands in bin 0. Padding features get bin 0."""
    n, d = X.shape
    Fc = max(1, min(d, (1 << 22) // max(n, 1)))
    out = torch.zeros((n, d_pad), dtype=torch.uint8, device=X.device)
    for c0 in range(0, d, Fc):
        xc = X[:, c0:c0 + Fc]
        ec = edges[c0:c0 + Fc]
        out[:, c0:c0 + xc.shape[1]] = (xc[:, :, None] >= ec[None, :, :]).sum(dim=2, dtype=torch.int32).to(torch.uint8)
    return out


# ---------------------------------------------------------------------------
# impurity and split search
# ---------------------------------------------------------------------------


def _sum_last(x: torch.Tensor) -> torch.Tensor:
    """Sum over the (short) last axis, left to right."""
    acc = x[..., 0]
    for s in range(1, x.shape[-1]):
        acc = acc + x[..., s]
    return acc


def _count(stats: torch.Tensor, impurity: str) -> torch.Tensor:
    """Row weight in a stats vector: class-count sum, or the weight slot."""
    if impurity == "variance":
        return stats[..., 0]
    return _sum_last(stats)


def _impurity(stats: torch.Tensor, impurity: str) -> torch.Tensor:
    n = _count(stats, impurity)
    safe = n.clamp_min(1e-12)
    if impurity == "variance":
        mean = stats[..., 1] / safe
        return (stats[..., 2] / safe - mean * mean).clamp_min(0.0)
    p = stats / safe[..., None]
    if impurity == "gini":
        return 1.0 - _sum_last(p * p)
    if impurity == "entropy":
        return -_sum_last(torch.where(p > 0.0, p * torch.log2(p.clamp_min(1e-30)), torch.zeros_like(p)))
    raise ValueError(f"unknown impurity {impurity!r}")


def _chunk_features(d_pad: int, n_nodes: int, n_bins: int, n_stats: int, budget: int = _HIST_BUDGET) -> int:
    """Largest power-of-two feature chunk keeping the histogram tile in
    budget; d_pad is a power of two, so the chunk divides it."""
    per_feat = max(1, n_nodes * n_bins * n_stats)
    f = max(1, budget // per_feat)
    f = 1 << (f.bit_length() - 1)
    return min(f, d_pad)


def _best_splits_from_hist(hist, parent, pcount, pimp, realf, nb, cfg):
    """Best (gain, feature, bin) per (tree, node) from a histogram block.

    ``hist`` is (T, F, n_nodes, nb, S); ``realf`` (T, F, n_nodes) maps
    block slots to real feature ids (sentinel ``cfg.n_features``, masked
    out). Equal gains across the empty-bin gap between two row populations
    take the middle edge (first/last/mid, as the JAX package); equal best
    gains across features take the first slot. The prefix sums over bins
    accumulate in f64 and round once to f32: the card's scan and the CPU's
    loop then give the same stats, and the empty bins of a gap leave exact
    ties."""
    cum = torch.cumsum(hist, dim=3, dtype=torch.float64).to(hist.dtype)
    left = cum[:, :, :, :-1, :]                          # threshold = bin b goes left
    right = parent[:, None, :, None, :] - left
    nl = _count(left, cfg.impurity)
    nr = _count(right, cfg.impurity)
    il = _impurity(left, cfg.impurity)
    ir = _impurity(right, cfg.impurity)
    denom = pcount.clamp_min(1e-12)[:, None, :, None]
    gain = pimp[:, None, :, None] - (nl * il + nr * ir) / denom
    ok = (nl >= cfg.min_samples_leaf) & (nr >= cfg.min_samples_leaf)
    ok = ok & (realf < cfg.n_features)[..., None]
    gain = torch.where(ok, gain, torch.full_like(gain, -float("inf")))
    m = gain.max(dim=3).values                           # (T, F, n_nodes)
    tie = (gain == m[..., None]).to(torch.int32)
    first = torch.argmax(tie, dim=3)
    last = (nb - 2) - torch.argmax(tie.flip(3), dim=3)
    mid = (first + last + 1) // 2
    midg = gain.gather(3, mid[..., None])[..., 0]
    bbin = torch.where(midg == m, mid, first)            # (T, F, n_nodes)
    fi = torch.argmax(m, dim=1, keepdim=True)            # (T, 1, n_nodes)
    g = m.gather(1, fi)[:, 0]
    f = realf.gather(1, fi)[:, 0]
    b = bbin.gather(1, fi)[:, 0].to(torch.int32)
    return g, f, b


# ---------------------------------------------------------------------------
# per-node sums
# ---------------------------------------------------------------------------


def _segment_sum(vals: torch.Tensor, ids: torch.Tensor, num: int) -> torch.Tensor:
    """(num, ...) sums of the rows of ``vals`` by ``ids`` in [0, num), each
    id's rows added in their order. On the card ``segment_reduce``
    after a stable sort (no atomics, so the sums are repeatable); on the
    CPU ``index_add_``, which adds in row order too (the same sums, ~10x
    faster there than the CPU ``segment_reduce``)."""
    if vals.device.type != "cuda":
        return torch.zeros((num,) + vals.shape[1:], dtype=vals.dtype).index_add_(0, ids, vals)
    counts = torch.bincount(ids, minlength=num)
    vals = vals[torch.sort(ids, stable=True)[1]]
    return torch.segment_reduce(vals, "sum", lengths=counts, axis=0)


def _seg_sum_trees(vals: torch.Tensor, seg: torch.Tensor, num: int) -> torch.Tensor:
    """Per-tree segment sums: ``vals`` (T, n, ...) and ``seg`` (T, n) in
    [0, num) -> (T, num, ...), one sort over all trees (tree t's segments
    offset by t·num)."""
    T, n = seg.shape
    gseg = (seg + num * torch.arange(T, device=seg.device)[:, None]).reshape(T * n)
    out = _segment_sum(vals.reshape((T * n,) + vals.shape[2:]), gseg, T * num)
    return out.reshape((T, num) + vals.shape[2:])


# ---------------------------------------------------------------------------
# compact histogram route: node-contiguous sub-blocks through K5 / K6
# ---------------------------------------------------------------------------


def _compact_r_sub(n: int, n_nodes: int, R: int, S: int) -> int:
    """Per-level sub-block size: ~half the average node width (the JAX
    package's formula, including its TPU block caps, so both packages pad
    alike)."""
    import math

    r = min(512, max(8, next_pow2(max(1, n // (n_nodes * 2)))))
    cap = min(R // (8 // math.gcd(S, 8)), R // 8)
    return max(1, min(r, cap, R))


def compact_sizes(n: int, level: int, max_depth: int, S: int, d_hist: int, nb: int) -> Tuple[int, int, int]:
    """(r_sub, n_pad, feature chunk) of a compact level, the JAX package's
    formulas: the sub-block size; the padded row count (one count for
    every level where the deepest split level's padding is small next to
    n, else this level's), a multiple of ``BLOCK_ROWS``; and the widest
    power-of-two feature chunk whose (n_pad / r_sub, S, chunk · nb) f32
    partials stay within 256 MB (the JAX package's and the per-sub-block
    K5's chunk; K5 per node takes all slots at once)."""
    n_nodes = 1 << level
    r_sub = _compact_r_sub(n, n_nodes, BLOCK_ROWS, S)
    n_nodes_max = 1 << max(0, max_depth - 1)
    if (n_nodes_max + 1) * r_sub * 3 <= n:
        n_pad = -(-(n + (n_nodes_max + 1) * r_sub) // BLOCK_ROWS) * BLOCK_ROWS
    else:
        n_pad = -(-(n + (n_nodes + 1) * r_sub) // BLOCK_ROWS) * BLOCK_ROWS
    Fc = 1 << max(0, min(d_hist, 8192 // nb).bit_length() - 1)
    while Fc > 1 and (d_hist % Fc != 0 or (n_pad // r_sub) * S * Fc * nb * 4 > (256 << 20)):
        Fc //= 2
    return r_sub, n_pad, Fc


def _compact_layout(seg: torch.Tensor, n_nodes: int, r_sub: int, n_pad: int):
    """Node-contiguous padded layout of each tree's rows.

    Returns ``src2`` (T, n_pad) the source row of every padded position,
    ``pvalid`` (T, n_pad) its validity, ``sbc`` (T, n_sb) the node of every
    sub-block (clipped to a real node), ``counts`` (T, n_nodes + 1) the
    sub-blocks per node, the last one counting the trailing dump blocks,
    and ``pstart`` (T, n_nodes + 1) the padded row where each node starts,
    the last entry where the dump blocks start."""
    T, n = seg.shape
    dev = seg.device
    n_sb = n_pad // r_sub
    keys_s, perm = torch.sort(seg, dim=1, stable=True)
    nodes = torch.arange(n_nodes + 1, device=dev, dtype=keys_s.dtype).expand(T, -1).contiguous()
    starts = torch.searchsorted(keys_s.contiguous(), nodes)          # (T, n_nodes+1)
    lens = starts[:, 1:] - starts[:, :-1]
    plen = (lens + r_sub - 1) // r_sub * r_sub
    pstart = torch.cat([torch.zeros((T, 1), dtype=plen.dtype, device=dev), torch.cumsum(plen, 1)], 1)
    sb_pos = (torch.arange(n_sb, device=dev, dtype=pstart.dtype) * r_sub).expand(T, -1).contiguous()
    seg_sb = torch.searchsorted(pstart[:, 1:].contiguous(), sb_pos, right=True)   # (T, n_sb)
    sbc = seg_sb.clamp(max=n_nodes - 1)
    st = starts[:, :-1].gather(1, sbc)
    ps = pstart[:, :-1].gather(1, sbc)
    ln = lens.gather(1, sbc)
    pos = torch.arange(n_pad, device=dev).reshape(1, n_sb, r_sub)
    off = pos - ps[..., None]
    src = (st[..., None] + off).clamp(0, n - 1).reshape(T, n_pad)
    pvalid = ((off < ln[..., None]) & (seg_sb < n_nodes)[..., None]).reshape(T, n_pad)
    src2 = perm.gather(1, src)
    counts = torch.cat([plen // r_sub, n_sb - pstart[:, n_nodes:] // r_sub], 1)
    return src2, pvalid, sbc, counts, pstart


def _hist_compact_batched(
    hist_src: Optional[torch.Tensor],
    seg: torch.Tensor,
    sw: torch.Tensor,
    *,
    n_nodes: int,
    nb: int,
    r_sub: int,
    n_pad: int,
    full_bins: Optional[torch.Tensor] = None,
    feats: Optional[torch.Tensor] = None,
):
    """(T, F, n_nodes, nb, S) histogram + (T, n_nodes, S) parent stats.

    ``hist_src`` is the shared (n, d_pad) uint8 bins (no subset) or
    per-tree (T, n, F) subset bins, which K5 reads through the sort
    permutation, all F slots and nodes in one launch; with ``full_bins``
    (n, d_pad) and ``feats`` (T, n_nodes, F) K6 reads the full rows through
    the sort permutation and picks each node's columns itself. The
    parent stats are the bin sums of feature slot 0 (always a real
    feature). A device's own f32 reduction order would move real-valued
    parent stats by an ulp and flip near-tied splits between a card fit and
    a CPU fit, so they are summed in f64."""
    T = seg.shape[0]
    S = sw.shape[-1]
    src2, pvalid, _, _, pstart = _compact_layout(seg, n_nodes, r_sub, n_pad)
    swq = (sw.gather(1, src2[..., None].expand(T, n_pad, S)) * pvalid[..., None].to(sw.dtype)).contiguous()
    if full_bins is not None:
        F = feats.shape[-1]
        hist_nodes = node_hist_sel_batched(full_bins, src2, swq, pstart, feats.to(torch.int32).contiguous(),
                                           n_bins=nb, r_sub=r_sub).reshape(T, n_nodes, S, F, nb)
    else:
        F = hist_src.shape[-1]
        hist_nodes = node_hist_batched(hist_src, src2, swq, pstart, n_bins=nb, r_sub=r_sub).reshape(
            T, n_nodes, S, F, nb)
    # f64 accumulation rounded once: the same parent stats on every device
    parent = hist_nodes[:, :, :, 0, :].sum(dim=-1, dtype=torch.float64).to(sw.dtype)   # (T, n_nodes, S)
    return hist_nodes.permute(0, 3, 1, 4, 2), parent      # (T, F, n_nodes, nb, S)


def _hist_scatter_batched(binc, local, in_level, sw, *, n_nodes, nb):
    """(T, F, n_nodes, nb, S) by sorted segment sums, for levels whose
    tile is past the compact route's bound. ``binc`` is (n, F) shared or
    (T, n, F) per-tree bins."""
    T, n, S = sw.shape
    if binc.dim() == 2:
        binc = binc.expand(T, n, binc.shape[1])
    F = binc.shape[-1]
    num = n_nodes * nb + 1
    ids = torch.where(in_level[..., None], local[..., None] * nb + binc.long(), n_nodes * nb)  # (T, n, F)
    gids = ids + num * torch.arange(T * F, device=sw.device).reshape(T, 1, F)
    vals = sw[:, :, None, :].expand(T, n, F, S).reshape(T * n * F, S)
    hist = _segment_sum(vals, gids.reshape(-1), T * F * num)
    return hist.reshape(T, F, num, S)[:, :, : n_nodes * nb].reshape(T, F, n_nodes, nb, S)


# ---------------------------------------------------------------------------
# randomness
# ---------------------------------------------------------------------------


class TorchDraws:
    """The builder's random quantities, drawn on the CPU from ``seed``: tree
    t's Poisson(1) bootstrap counts by logical row, and its per-level
    (n_nodes, n_features) uniforms whose k largest pick each node's
    features. Each (tree, stream) has its own generator, so what a tree
    draws does not depend on how trees are batched or on the device."""

    def __init__(self, seed: int) -> None:
        self.seed = int(seed)
        self.seconds = 0.0  # host time spent drawing

    def _generator(self, tree: int, stream: int) -> torch.Generator:
        state = np.random.SeedSequence([self.seed % (1 << 64), tree, stream]).generate_state(1, np.uint64)
        g = torch.Generator()
        g.manual_seed(int(state[0]) >> 1)
        return g

    def bootstrap(self, tree: int, n: int) -> torch.Tensor:
        t0 = time.perf_counter()
        out = torch.poisson(torch.ones(n), generator=self._generator(tree, 0))
        self.seconds += time.perf_counter() - t0
        return out

    def feature_uniforms(self, tree: int, level: int, n_nodes: int, n_features: int) -> torch.Tensor:
        t0 = time.perf_counter()
        out = torch.rand((n_nodes, n_features), generator=self._generator(tree, 1 + level))
        self.seconds += time.perf_counter() - t0
        return out


# ---------------------------------------------------------------------------
# tree-batched level-wise builder
# ---------------------------------------------------------------------------


def _grow_trees_batched(
    bins: torch.Tensor,
    sw: torch.Tensor,
    trees: Sequence[int],
    draws,
    cfg: ForestConfig,
    *,
    return_rows: bool = False,
    allreduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """Grow T trees level by level: ``bins`` (n, d_pad) uint8 shared,
    ``sw`` (T, n, S) stats × weight per tree, ``trees`` the T trees' ids
    (what ``draws`` is asked for). Returns (T, M) ``feature`` (-1 = leaf),
    ``threshold_bin`` and ``gain``, and (T, M, S) ``leaf_stats``.

    ``allreduce``: applied to every histogram and parent sum (the hook a
    data-parallel booster sums them over devices with). ``return_rows``:
    also return each row's final node (T, n)."""
    n, d_pad = bins.shape
    T = sw.shape[0]
    S = cfg.n_stats
    nb = cfg.n_bins
    M = max_nodes(cfg.max_depth)
    dt = sw.dtype
    dev = bins.device
    allred = allreduce or (lambda x: x)
    subset = cfg.k_features < cfg.n_features
    k_pad = next_pow2(cfg.k_features)

    feat = torch.full((T, M), -1, dtype=torch.int32, device=dev)
    thr_bin = torch.zeros((T, M), dtype=torch.int32, device=dev)
    leaf = torch.zeros((T, M, S), dtype=dt, device=dev)
    gains = torch.zeros((T, M), dtype=dt, device=dev)
    node = torch.zeros((T, n), dtype=torch.int64, device=dev)
    bins_t = bins.expand(T, n, d_pad)

    for level in range(cfg.max_depth + 1):
        offset = (1 << level) - 1
        n_nodes = 1 << level
        local = node - offset
        in_level = (local >= 0) & (local < n_nodes)
        seg = torch.where(in_level, local, torch.full_like(local, n_nodes))
        if level == cfg.max_depth:
            parent = allred(_seg_sum_trees(sw, seg, n_nodes + 1)[:, :n_nodes])
            leaf[:, offset:offset + n_nodes] = parent
            break

        if subset:
            r = torch.stack([
                torch.as_tensor(draws.feature_uniforms(t, level, n_nodes, cfg.n_features))
                for t in trees
            ]).to(dev)
            # the k largest, ties to the lower index (as lax.top_k)
            feats = torch.sort(r, dim=2, descending=True, stable=True)[1][:, :, :cfg.k_features]
            if k_pad > cfg.k_features:
                pad = torch.full((T, n_nodes, k_pad - cfg.k_features), cfg.n_features, dtype=feats.dtype, device=dev)
                feats = torch.cat([feats, pad], dim=2)
            del r
            d_hist = k_pad
        else:
            feats = None
            d_hist = d_pad

        def make_hist_src(feats=feats, local=local):
            if not subset:
                return bins
            lc0 = local.clamp(0, n_nodes - 1)
            row_feats = feats.gather(1, lc0[..., None].expand(T, n, k_pad))
            return bins_t.gather(2, row_feats.clamp(0, d_pad - 1))   # (T, n, k_pad) u8

        r_sub, n_pad_c, _ = compact_sizes(n, level, cfg.max_depth, S, d_hist, nb)
        use_compact = dt == torch.float32 and n_nodes * d_hist * nb * S <= _COMPACT_TILE_MAX
        use_sel = (
            use_compact and subset and d_pad > _SEL_MIN_DPAD
            and _sel_resident(n, d_pad, T, n_pad_c, n_nodes, S, d_hist, nb) <= _sel_hbm_budget(dev)
        )
        if use_sel:
            hist_full, parent = _hist_compact_batched(
                None, seg, sw, n_nodes=n_nodes, nb=nb, r_sub=r_sub, n_pad=n_pad_c, full_bins=bins, feats=feats,
            )
        elif use_compact:
            hist_full, parent = _hist_compact_batched(
                make_hist_src(), seg, sw, n_nodes=n_nodes, nb=nb, r_sub=r_sub, n_pad=n_pad_c,
            )
        else:
            parent = _seg_sum_trees(sw, seg, n_nodes + 1)[:, :n_nodes]
        parent = allred(parent)
        leaf[:, offset:offset + n_nodes] = parent
        pcount = _count(parent, cfg.impurity)           # (T, n_nodes)
        pimp = _impurity(parent, cfg.impurity)

        bg = torch.full((T, n_nodes), -float("inf"), dtype=dt, device=dev)
        bf = torch.zeros((T, n_nodes), dtype=torch.int64, device=dev)
        bb = torch.zeros((T, n_nodes), dtype=torch.int32, device=dev)

        def merge(g, f, b):
            upd = g > bg
            bg.copy_(torch.where(upd, g, bg))
            bf.copy_(torch.where(upd, f.to(bf.dtype), bf))
            bb.copy_(torch.where(upd, b, bb))

        def realf_of(c0, F):
            if subset:
                return feats[:, :, c0:c0 + F].transpose(1, 2)          # (T, F, n_nodes)
            return torch.arange(c0, c0 + F, device=dev)[None, :, None].expand(T, F, n_nodes)

        if use_compact:
            hist_full = allred(hist_full)
            # gain search in feature-slot chunks: the cumsum/gain chain
            # holds several copies of the tile; the strict > merge keeps
            # the first slot on ties, so chunking changes nothing
            Fc2 = d_hist
            while Fc2 > 1 and Fc2 * n_nodes * nb * S > 4 * _HIST_BUDGET:
                Fc2 //= 2
            for c0 in range(0, d_hist, Fc2):
                merge(*_best_splits_from_hist(
                    hist_full[:, c0:c0 + Fc2], parent, pcount, pimp, realf_of(c0, Fc2), nb, cfg
                ))
            del hist_full
        else:
            hist_src = make_hist_src()
            F = _chunk_features(d_hist, n_nodes, nb, S, (1 << 25) if subset else _HIST_BUDGET)
            for c0 in range(0, d_hist, F):
                hist = _hist_scatter_batched(
                    hist_src[..., c0:c0 + F], local, in_level, sw, n_nodes=n_nodes, nb=nb
                )
                merge(*_best_splits_from_hist(allred(hist), parent, pcount, pimp, realf_of(c0, F), nb, cfg))
            del hist_src

        do_split = (
            torch.isfinite(bg) & (bg >= max(cfg.min_info_gain, 1e-9)) & (pcount >= cfg.min_samples_split)
        )
        feat[:, offset:offset + n_nodes] = torch.where(do_split, bf, torch.full_like(bf, -1)).to(torch.int32)
        thr_bin[:, offset:offset + n_nodes] = bb
        gains[:, offset:offset + n_nodes] = torch.where(do_split, bg, torch.zeros_like(bg))

        # route rows to children; rows whose node became a leaf stay put
        lc = local.clamp(0, n_nodes - 1)
        row_feat = bf.gather(1, lc).clamp(0, d_pad - 1)
        row_bin = bins_t.gather(2, row_feat[..., None])[..., 0].to(torch.int32)
        go_right = (row_bin > bb.gather(1, lc)).to(torch.int64)
        moves = in_level & do_split.gather(1, lc)
        node = torch.where(moves, 2 * node + 1 + go_right, node)

    out = {"feature": feat, "threshold_bin": thr_bin, "leaf_stats": leaf, "gain": gains}
    if return_rows:
        out["node"] = node
    return out


def _build_trees_batched(
    bins: torch.Tensor,
    stats: torch.Tensor,
    valid: torch.Tensor,
    trees: Sequence[int],
    draws,
    cfg: ForestConfig,
) -> Dict[str, torch.Tensor]:
    """RandomForest front half of the batched builder: per-tree bootstrap
    weights (Poisson(1) counts indexed by logical row, the cumsum of the
    validity mask, so padding never shifts the draws), then growth."""
    n = bins.shape[0]
    dt = stats.dtype
    T = len(trees)
    if cfg.bootstrap:
        logical = (torch.cumsum(valid.to(torch.int64), 0) - 1).clamp(0, n - 1)
        counts = torch.stack([torch.as_tensor(draws.bootstrap(t, n)) for t in trees]).to(device=bins.device, dtype=dt)
        w = counts[:, logical] * valid[None, :]
    else:
        w = valid.to(dt)[None, :].expand(T, n)
    sw = stats[None] * w[:, :, None]                     # (T, n, S)
    return _grow_trees_batched(bins, sw, trees, draws, cfg)


def build_forest(
    bins: torch.Tensor,
    mask: torch.Tensor,
    stats: torch.Tensor,
    *,
    cfg: ForestConfig,
    n_trees: int,
    draws,
) -> Dict[str, np.ndarray]:
    """Grow ``n_trees`` trees on one device, in groups of at most 8 and
    tree batches sized by ``resolve_tree_batch`` (the JAX package's
    single-device ``build_forest``). Returns host arrays stacked over
    trees."""
    group = min(n_trees, 8)
    pieces: Dict[str, List[np.ndarray]] = {}
    for g0 in range(0, n_trees, group):
        trees = list(range(g0, min(g0 + group, n_trees)))
        tb = resolve_tree_batch(len(trees), cfg, bins.shape[0], bins.device)
        # the JAX package's span attrs: every level takes the compact route
        # here, and one device never gathers rows
        with telemetry.span("forest.grow_group", trees=len(trees), tree_batch=tb, hist_strategy="compact",
                            gather=False) as f_span:
            for b0 in range(0, len(trees), tb):
                out = _build_trees_batched(bins, stats, mask, trees[b0:b0 + tb], draws, cfg)
                for k, v in out.items():
                    pieces.setdefault(k, []).append(v.cpu().numpy())
            f_span.fence(bins)
    return {k: np.concatenate(v, axis=0) for k, v in pieces.items()}


# ---------------------------------------------------------------------------
# inference: raw-threshold descent
# ---------------------------------------------------------------------------


def _per_tree(x: torch.Tensor, n_trees: int) -> torch.Tensor:
    """``x / n_trees`` as the JAX package's compiled program computes it:
    a product with the f32 reciprocal of the tree count."""
    return x * (torch.ones((), dtype=x.dtype) / n_trees).item()


def forest_apply(X: torch.Tensor, feat: torch.Tensor, thr: torch.Tensor, *, max_depth: int) -> torch.Tensor:
    """Leaf index per (tree, row), (T, n): every tree descends level by
    level (``x >= thr`` goes right; a leaf's rows stay)."""
    n, d = X.shape
    T = feat.shape[0]
    feat, Xt = feat.long(), X.T
    node = torch.zeros((T, n), dtype=torch.int64, device=X.device)
    for _ in range(max_depth):
        nf = feat.gather(1, node)
        xv = Xt.gather(0, nf.clamp(0, d - 1))
        child = 2 * node + 1 + (xv >= thr.gather(1, node)).to(torch.int64)
        node = torch.where(nf < 0, node, child)
    return node


def rf_classify(X, feat, thr, leaf_prob, *, max_depth: int):
    """Spark RF vote semantics: rawPrediction = sum over trees of each
    tree's normalized leaf class distribution (in tree order);
    probability = raw / numTrees."""
    leaves = forest_apply(X, feat, thr, max_depth=max_depth)
    raw = leaf_prob[0][leaves[0]]
    for t in range(1, feat.shape[0]):
        raw = raw + leaf_prob[t][leaves[t]]
    prob = _per_tree(raw, feat.shape[0])
    pred = torch.argmax(raw, dim=1).to(X.dtype)
    return pred, prob, raw


def rf_regress(X, feat, thr, leaf_value, *, max_depth: int) -> torch.Tensor:
    leaves = forest_apply(X, feat, thr, max_depth=max_depth)
    acc = leaf_value[0][leaves[0]]
    for t in range(1, feat.shape[0]):
        acc = acc + leaf_value[t][leaves[t]]
    return _per_tree(acc, feat.shape[0])


# ---------------------------------------------------------------------------
# inference: packed-forest engine
# ---------------------------------------------------------------------------


class PackedForest(NamedTuple):
    """Breadth-first interleaved forest layout (``pack_forest``): host
    numpy arrays, persisted with the model. ``feat2``/``thr2`` are empty
    (0, 64) when ``k2 == 0``."""

    feat1: np.ndarray    # (T_pad, n1) int32 hop-1 root subtrees, -1 = leaf
    thr1: np.ndarray     # (T_pad, n1) int32 bin thresholds
    feat2: np.ndarray    # (T_pad * 2^k1, 64) int32 hop-2 tables, -1 pad
    thr2: np.ndarray     # (T_pad * 2^k1, 64) int32
    n_trees: int         # real tree count T
    k1: int              # hop-1 depth (root-subtree levels)
    k2: int              # hop-2 depth (per-subtree levels)
    max_depth: int


def pack_forest(feat, thr_bin, *, max_depth: int) -> PackedForest:
    """Re-lay a trained forest for the two-hop descent (host, once; the
    JAX package's layout, so its saved ``packed_*`` arrays load as they
    are). k1 = max(min(7, D), D - 6), k2 = D - k1; trees padded to a
    multiple of 8 with all-leaf trees; table row ``t * 2^k1 + s`` holds
    subtree s of tree t, its 2^k2 - 1 internal nodes in heap order along 64
    lanes."""
    feat = np.asarray(feat, dtype=np.int32)
    thr = np.asarray(thr_bin, dtype=np.int32)
    T, M = feat.shape
    D = int(max_depth)
    k1, k2 = _split_depths(D)
    n1 = (1 << k1) - 1
    T_pad = -(-T // 8) * 8
    featp = np.pad(feat, ((0, T_pad - T), (0, 0)), constant_values=-1)
    thrp = np.pad(thr, ((0, T_pad - T), (0, 0)))
    feat1 = np.ascontiguousarray(featp[:, :n1])
    thr1 = np.ascontiguousarray(thrp[:, :n1])
    if k2 == 0:
        feat2 = np.full((0, LANES), -1, np.int32)
        thr2 = np.zeros((0, LANES), np.int32)
    else:
        K1 = 1 << k1
        f2 = np.full((T_pad, K1, LANES), -1, np.int32)
        t2 = np.zeros((T_pad, K1, LANES), np.int32)
        for delta in range(k2):
            off = (1 << (k1 + delta)) - 1
            cnt = 1 << (k1 + delta)
            w = 1 << delta
            lo = (1 << delta) - 1  # heap-local lane offset of this level
            f2[:, :, lo:lo + w] = featp[:, off:off + cnt].reshape(T_pad, K1, w)
            t2[:, :, lo:lo + w] = thrp[:, off:off + cnt].reshape(T_pad, K1, w)
        feat2 = f2.reshape(T_pad * K1, LANES)
        thr2 = t2.reshape(T_pad * K1, LANES)
    return PackedForest(
        feat1=feat1, thr1=thr1, feat2=feat2, thr2=thr2, n_trees=T, k1=k1, k2=k2, max_depth=D
    )


def pack_bins(xb: torch.Tensor) -> torch.Tensor:
    """(n, d) uint8 bins -> (n, d/4) int32, byte j of word w = bin 4w + j
    (d % 4 == 0): the little-endian bytes reinterpreted in place."""
    return xb.contiguous().view(torch.int32)


def packed_node_tables(pf: PackedForest, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The packed layout's two tables as K9's node words on ``device``
    (``rf_kernels.forest_nodes``: one int32 a node), made once a model:
    (hop-1 (T_pad, n1), hop-2 (T_pad·2^k1, 64))."""
    return tuple(forest_nodes(torch.from_numpy(f), torch.from_numpy(t)).to(device)
                 for f, t in ((pf.feat1, pf.thr1), (pf.feat2, pf.thr2)))


def forest_apply_packed(xb, nodes1, nodes2, *, k1: int, k2: int) -> torch.Tensor:
    """Global leaf index per (row, tree), (n, T_pad) int32, from ``xb`` (n,
    d_pad) uint8 bins and the node words of ``packed_node_tables``: one
    launch of K9 (``rf_kernels.packed_forest_eval``) on the card, its plain
    route (hop 1, hop 2) on the CPU."""
    return packed_forest_eval(pack_bins(xb), nodes1, nodes2, k1=k1, k2=k2)


def rf_eval_packed(xb, nodes1, nodes2, values, *, k1: int, k2: int) -> torch.Tensor:
    """Sum over trees of each tree's leaf payload, (n, V): one launch of K9
    on the card (the leaf ids never leave the chip), its plain route (hop
    1, hop 2, ``_packed_payload``) on the CPU; the same f32 adds in the
    same order either way."""
    return packed_forest_eval(pack_bins(xb), nodes1, nodes2, values, k1=k1, k2=k2)


def rf_classify_packed(xb, nodes1, nodes2, leaf_prob, *, k1: int, k2: int, pred_dtype=torch.float32):
    """Spark RF vote semantics through the packed engine."""
    raw = rf_eval_packed(xb, nodes1, nodes2, leaf_prob, k1=k1, k2=k2)
    prob = _per_tree(raw, leaf_prob.shape[0])
    pred = torch.argmax(raw, dim=1).to(pred_dtype)
    return pred, prob, raw


def rf_regress_packed(xb, nodes1, nodes2, leaf_value, *, k1: int, k2: int) -> torch.Tensor:
    s = rf_eval_packed(xb, nodes1, nodes2, leaf_value[..., None], k1=k1, k2=k2)
    return _per_tree(s[:, 0], leaf_value.shape[0])


# ---------------------------------------------------------------------------
# inference: two-hop bins engine
# ---------------------------------------------------------------------------
#
# The JAX package's bin-space descent (``forest_apply_bins``, the middle of
# its packed > bins > legacy chain), tree by tree in groups of 8: hop 1 walks
# each tree's top k1 levels from the rows' bins, hop 2 reads the row's
# level-k1 subtree (its 2^k2 - 1 internal nodes, heap-ordered) from a
# per-tree table and walks k2 more levels. Hop 2's feature bins come from
# the rows' word-packed bins through K8, one launch per tree group. Every
# comparison is an integer one in bin space (bin(x) > b <=> x >= edges[f,
# b]), so leaf ids equal the packed engine's, and the payload sums follow
# the same group-of-8 order, so values equal it bit for bit.


def _split_depths(max_depth: int) -> Tuple[int, int]:
    """(k1, k2): hop 1 takes max(min(7, D), D - 6) levels, hop 2 the rest."""
    k1 = max(min(7, max_depth), max_depth - 6)
    return k1, max_depth - k1


def _navigate(enc: torch.Tensor, steps: int, L: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Heap-local descent over ``enc`` (n, L), heap order: enc[i] = 0 at a
    leaf (stop), else 1 + go-right, so each step is i -> 2i + enc[i] while
    enc[i] > 0. Step s reads only the depth-s slice enc[:, 2^s-1 : 2^(s+1)-1];
    a row frozen above it reads nothing. Returns (i, stopped early): rows
    that take every step land at an index >= L = 2^steps - 1."""
    i = torch.zeros(enc.shape[0], dtype=torch.int64, device=enc.device)
    for s in range(steps):
        lo, w = (1 << s) - 1, 1 << s
        e = enc[:, lo:lo + w].gather(1, (i - lo).clamp(0, w - 1)[:, None])[:, 0]
        e = torch.where(i >= lo, e, torch.zeros_like(e))
        i = torch.where(e > 0, 2 * i + e, i)
    return i, i < L


def _hop1(xb: torch.Tensor, feat_t: torch.Tensor, thr_t: torch.Tensor, k1: int):
    """One tree's hop 1 from the rows' bins: its top k1 levels' tests as one
    gather of the tested columns (the TPU's bf16 one-hot product gives the
    same small integers). Returns (heap index, stopped in hop 1)."""
    n1 = (1 << k1) - 1
    f1 = feat_t[:n1]
    tests1 = xb.index_select(1, f1.clamp(0, xb.shape[1] - 1)).long()    # (n, n1)
    enc1 = torch.where(f1 >= 0, 1 + (tests1 > thr_t[:n1]).long(), torch.zeros_like(tests1))
    return _navigate(enc1, k1, n1)


def _hop2_rows(xb: torch.Tensor, feat_t: torch.Tensor, thr_t: torch.Tensor, *, k1: int, k2: int):
    """One tree's hop 1 and its hop-2 table rows. ``feat_t``/``thr_t`` (M,)
    int64 heap tables. Returns (i1, done1, l7, rfeat, rthr, ridx): the hop-1
    heap index, whether the row stopped in hop 1, its level-k1 subtree, the
    subtree's (n, 2^k2 - 1) features and thresholds in heap order, and the
    byte indices (features clipped to the row) K8 gathers."""
    i1, done1 = _hop1(xb, feat_t, thr_t, k1)
    l7 = (i1 - ((1 << k1) - 1)).clamp(0, (1 << k1) - 1)
    sub_f, sub_t = [], []
    for delta in range(k2):
        off, cnt = (1 << (k1 + delta)) - 1, 1 << (k1 + delta)
        sub_f.append(feat_t[off:off + cnt].reshape(1 << k1, 1 << delta))
        sub_t.append(thr_t[off:off + cnt].reshape(1 << k1, 1 << delta))
    nint = (1 << k2) - 1
    rrow = torch.cat(sub_f + sub_t, dim=1)[l7]                             # (n, 2·nint)
    rfeat, rthr = rrow[:, :nint], rrow[:, nint:]
    return i1, done1, l7, rfeat, rthr, rfeat.clamp(0, xb.shape[1] - 1)


def _twohop_group(xb, packed, feat_g, thr_g, val_g, *, max_depth: int):
    """One tree group of the two-hop descent: ``xb`` (n, d) uint8 bins,
    ``packed`` their (n, d/4) int32 words, ``feat_g``/``thr_g`` (G, M),
    ``val_g`` (G, M, V) or None. Returns (leaf ids (G, n), the (n, V) value
    sum over the group in tree order, or None)."""
    k1, k2 = _split_depths(max_depth)
    leaf_ids, vals_sum, ph = [], None, []
    for g in range(feat_g.shape[0]):
        feat_t, thr_t = feat_g[g].long(), thr_g[g].long()
        if k2 == 0:
            leaf_ids.append(_hop1(xb, feat_t, thr_t, k1)[0])
        else:
            ph.append(_hop2_rows(xb, feat_t, thr_t, k1=k1, k2=k2))
    if k2 > 0:
        # phase B: K8 once for the whole group's hop-2 feature bins
        xv_all = packed_byte_gather_many(packed, torch.stack([p[5] for p in ph]).to(torch.int32))
        for g, (i1, done1, l7, rfeat, rthr, _) in enumerate(ph):
            split = rfeat >= 0
            enc2 = (1 + ((xv_all[g].long() > rthr) & split).long()) * split.long()
            enc2 = torch.where(done1[:, None], torch.zeros_like(enc2), enc2)
            m, _ = _navigate(enc2, k2, (1 << k2) - 1)
            leaf_ids.append(torch.where(done1, i1, _leaf_ids(m, l7, k1, k2)))
    if val_g is not None:
        for g, leaf in enumerate(leaf_ids):
            v = val_g[g][leaf]                                             # (n, V)
            vals_sum = v if vals_sum is None else vals_sum + v
    return torch.stack(leaf_ids), vals_sum


def _twohop_drive(xb, feat, thr_bin, values, *, max_depth: int, group: int):
    """The tree-group loop: (T, n) leaf ids when ``values`` is None, else
    the (n, V) value sum over trees (partial sums of ``group`` trees in
    tree order, then across groups: the packed engine's association)."""
    packed = pack_bins(xb)
    ids_out, acc = [], None
    for g0 in range(0, feat.shape[0], group):
        ids, v = _twohop_group(
            xb, packed, feat[g0:g0 + group], thr_bin[g0:g0 + group],
            None if values is None else values[g0:g0 + group], max_depth=max_depth,
        )
        if values is None:
            ids_out.append(ids)
        else:
            acc = v if acc is None else acc + v
    return torch.cat(ids_out) if values is None else acc


def forest_apply_bins(xb, feat, thr_bin, *, max_depth: int, group: int = 8) -> torch.Tensor:
    """Leaf index per (tree, row), (T, n) int64, from ``xb`` (n, d) uint8
    bins (d % 4 == 0), ``feat`` (T, M) (-1 = leaf) and ``thr_bin`` (T, M)
    (bin(x) > thr_bin goes right)."""
    return _twohop_drive(xb, feat, thr_bin, None, max_depth=max_depth, group=group)


def rf_eval_bins(xb, feat, thr_bin, values, *, max_depth: int, group: int = 8) -> torch.Tensor:
    """Sum over trees of each tree's leaf value vector: ``values`` (T, M,
    V) -> (n, V)."""
    return _twohop_drive(xb, feat, thr_bin, values, max_depth=max_depth, group=group)


def rf_classify_bins(xb, feat, thr_bin, leaf_prob, *, max_depth: int, group: int = 8, pred_dtype=torch.float32):
    """Spark RF vote semantics through the bins engine."""
    raw = rf_eval_bins(xb, feat, thr_bin, leaf_prob, max_depth=max_depth, group=group)
    prob = _per_tree(raw, feat.shape[0])
    pred = torch.argmax(raw, dim=1).to(pred_dtype)
    return pred, prob, raw


def rf_regress_bins(xb, feat, thr_bin, leaf_value, *, max_depth: int, group: int = 8) -> torch.Tensor:
    s = rf_eval_bins(xb, feat, thr_bin, leaf_value[..., None], max_depth=max_depth, group=group)
    return _per_tree(s[:, 0], leaf_value.shape[0])
