"""IVF-Flat approximate kNN of the port: a k-means coarse quantizer and a
probe-list scan (counterpart of ``spark_rapids_ml_tpu/ops/ivf_kernels.py``,
single device).

The index partitions the item rows into ``nlist`` Voronoi cells of a coarse
quantizer trained by Lloyd on a bounded sample; a query scans only its
``nprobe`` closest cells. Index layout as in the JAX package: rows are
cluster-sorted (CSR ``offsets``/``lens`` kept as metadata) and scattered
into a capacity-padded layout, list ``l`` owning slots ``[l*cap,
(l+1)*cap)``, padding slots carrying ``+inf`` squared norm and id ``-1``.
``cap`` is the observed longest list under a loosely balanced assignment:
rows spill to their second-closest list only above ``3 * n / nlist``.

Where it runs: the quantizer's Lloyd is kernel K2 (``kmeans_kernels.
kmeans_lloyd``, the card's 3xTF32 scores); the two-choice assignment and
the probe scan are plain PyTorch, as the JAX package computes them in XLA
outside any Pallas kernel; the capacity balance and the layout are host
numpy, verbatim. Ties resolve as ``lax.top_k`` resolves them, the lower
position first: every selection is a top-k over (distance, column) keys
that cannot tie, never ``torch.topk`` of the distances.

The JAX package's environment overrides (``TPUML_UMAP_GRAPH``,
``TPUML_ANN_GATE_ROWS``, ``TPUML_ANN_NLIST``/``NPROBE``) become the module
constants :data:`UMAP_GRAPH` and :data:`ANN_GATE_ROWS` (set them to change
the dispatch); the autotune consults and the list-sharded multi-device
search (with the provenance ``last_search_report`` gives of it) are not
ported.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils.logging import get_logger
from .kmeans_kernels import kmeans_lloyd, pairwise_sq_dists

_LOGGER = get_logger("umap")

# balanced-assignment HARD capacity: ceil(_BALANCE_HARD * n / nlist). Rows
# spill to their second-closest list only above it; the padded slot count
# of an index is the OBSERVED longest list (a multiple of _CAP_MULTIPLE)
_BALANCE_HARD = 3.0
_CAP_MULTIPLE = 8

# coarse-quantizer training: Lloyd on a bounded sample, 10 iterations
_TRAIN_SAMPLE = 1 << 18
_TRAIN_ITERS = 10
_TRAIN_TOL = 1e-4

# rows per chunk of the two-choice assignment: bounds its (chunk, nlist) tile
_ASSIGN_CHUNK = 16384

# search-time gathered tile budget, in f32 elements: the (qc, cap, d)
# per-probe candidate gather; qc adapts so it stays ~256 MB
_GATHER_BUDGET_ELEMS = 64 * 1024 * 1024

# below this many rows the build costs more than the exact sweep it displaces
_MIN_IVF_ROWS = 256
# every list must expect at least this many rows, or the cells fragment
_MIN_ROWS_PER_LIST = 4

# the graph-engine dispatch (the JAX package's TPUML_UMAP_GRAPH and
# TPUML_ANN_GATE_ROWS): "auto" takes the IVF engine from ANN_GATE_ROWS rows
# on a feasible shape, "exact" never, "ivf" wherever the shape is feasible
UMAP_GRAPH = "auto"
ANN_GATE_ROWS = 131_072
_GRAPH_MODES = ("auto", "exact", "ivf")


# --------------------------------------------------------------------------
# parameter heuristics
# --------------------------------------------------------------------------


def resolve_umap_graph() -> str:
    """The validated graph-engine mode :data:`UMAP_GRAPH` (auto | exact | ivf)."""
    if UMAP_GRAPH not in _GRAPH_MODES:
        raise ValueError(f"UMAP_GRAPH={UMAP_GRAPH!r} must be one of {_GRAPH_MODES}")
    return UMAP_GRAPH


def default_nlist(n_rows: int) -> int:
    """sqrt(n)-scaled list count, the standard IVF sizing."""
    return max(2, min(int(round(math.sqrt(max(n_rows, 4)))), n_rows // 2))


def default_nprobe(nlist: int) -> int:
    """nlist/8 probes (~12.5% of lists), floored at 6."""
    return min(nlist, max(6, -(-nlist // 8)))


def hard_capacity(n_rows: int, nlist: int) -> int:
    """The enforced per-list row bound (spill threshold)."""
    cap = -(-int(_BALANCE_HARD * n_rows) // nlist)
    return -(-max(cap, 1) // _CAP_MULTIPLE) * _CAP_MULTIPLE


def resolve_ann_params(
    n_rows: int, nlist: Optional[int] = None, nprobe: Optional[int] = None
) -> Tuple[int, int]:
    """Resolve and validate ``(nlist, nprobe)`` for an ``n_rows``-item
    index: explicit arguments (the estimator's ``algoParams``), then the
    heuristics. Raises ``ValueError`` on out-of-domain values."""
    if nlist is None:
        nlist = default_nlist(n_rows)
    nlist = int(nlist)
    if nlist < 2:
        raise ValueError(f"ivfflat nlist={nlist} must be >= 2")
    if nlist > max(n_rows, 1):
        raise ValueError(f"ivfflat nlist={nlist} must be <= number of index rows {n_rows}")
    if nprobe is None:
        nprobe = default_nprobe(nlist)
    nprobe = int(nprobe)
    if nprobe < 1:
        raise ValueError(f"ivfflat nprobe={nprobe} must be >= 1")
    if nprobe > nlist:
        raise ValueError(f"ivfflat nprobe={nprobe} must be <= nlist={nlist}")
    return nlist, nprobe


def ivf_feasible(n_rows: int, k: int, nlist: int, nprobe: int) -> bool:
    """Shape gate: False when the build would cost more than it saves, when
    the cells would fragment, or when the probed candidate pool cannot
    plausibly hold k rows (each probed list budgeted at a third of the
    mean)."""
    if n_rows < _MIN_IVF_ROWS or k >= n_rows:
        return False
    if nlist < 2 or n_rows < _MIN_ROWS_PER_LIST * nlist:
        return False
    min_per_list = n_rows // int(_BALANCE_HARD * nlist) or 1
    return nprobe * min_per_list >= k


def select_graph_engine(
    n_rows: int, k: int, *, nlist: Optional[int] = None, nprobe: Optional[int] = None
) -> str:
    """:data:`UMAP_GRAPH` against the feasibility gate: ``"ivf"`` or
    ``"exact"``. An explicit ``ivf`` that the gate rejects warns and
    answers ``exact``; ``auto`` also needs ``n_rows >= ANN_GATE_ROWS``."""
    mode = resolve_umap_graph()
    if mode == "exact":
        return "exact"
    try:
        nl, npb = resolve_ann_params(n_rows, nlist=nlist, nprobe=nprobe)
        feasible = ivf_feasible(n_rows, k, nl, npb)
        reason = "below the IVF feasibility gate"
    except ValueError as e:
        feasible = False
        reason = str(e)
    if mode == "ivf":
        if feasible:
            return "ivf"
        _LOGGER.warning(
            "UMAP_GRAPH=ivf but the IVF graph engine is unavailable for config (n_rows=%d, k=%d): %s; "
            "falling back to the exact brute-force graph",
            n_rows, k, reason,
        )
        return "exact"
    if feasible and n_rows >= ANN_GATE_ROWS:
        return "ivf"
    return "exact"


# --------------------------------------------------------------------------
# index build
# --------------------------------------------------------------------------


class IvfIndex(NamedTuple):
    """A built index: tensors on the search device and host CSR metadata.

    ``grouped_*`` use the capacity-padded cluster-grouped layout (list
    ``l`` at slots ``[l*cap, (l+1)*cap)``); ``offsets``/``lens`` describe
    the underlying cluster-sorted order."""

    centroids: torch.Tensor    # (nlist, d) f32 coarse quantizer
    grouped_x: torch.Tensor    # (nlist*cap, d) f32, zero on padding
    grouped_sq: torch.Tensor   # (nlist*cap,) f32 ||x||², +inf on padding
    grouped_ids: torch.Tensor  # (nlist*cap,) int32 source row ids, -1 on padding
    offsets: np.ndarray        # (nlist+1,) int64 CSR starts
    lens: np.ndarray           # (nlist,) int32 rows a list
    cap: int
    nlist: int
    n_rows: int


def _stable_smallest(d: torch.Tensor, k: int) -> torch.Tensor:
    """Columns of the ``k`` smallest entries of each row of ``d`` (entries
    >= 0 or +inf), ascending, the lower column first on ties
    (``lax.top_k(-d, k)``'s order): one top-k over keys that pack each
    entry's f32 bits (order-preserving for non-negative floats; ``+ 0.0``
    makes -0 +0) above its column, so no two keys tie."""
    bits = (d + 0.0).view(torch.int32).to(torch.int64)
    keys = (bits << 32) | torch.arange(d.shape[1], device=d.device)
    return torch.topk(keys, k, dim=1, largest=False, sorted=True).indices


def _assign_top2(X: torch.Tensor, centers: torch.Tensor, *, chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two closest centroids per row: ``(d2 (n, 2) ascending, idx (n, 2))``,
    in chunks of ``chunk`` rows. The second choice is the balancer's spill
    target; its distance gap is the spill cost."""
    c_sq = (centers * centers).sum(dim=1)
    d2_out, idx_out = [], []
    for lo in range(0, X.shape[0], chunk):
        d2 = pairwise_sq_dists(X[lo : lo + chunk], centers, c_sq)
        sel = _stable_smallest(d2, 2)
        d2_out.append(d2.gather(1, sel))
        idx_out.append(sel)
    return torch.cat(d2_out), torch.cat(idx_out)


def _balanced_assign(d2_2: np.ndarray, idx_2: np.ndarray, nlist: int, cap: int) -> np.ndarray:
    """Capacity-balanced list assignment (host): start from the nearest
    centroid, then spill each overfull list's cheapest-to-move rows
    (smallest second-choice distance gap) to their second choice; a rare
    final pass routes any still-overfull remainder to the least-loaded
    lists. Total capacity ``nlist*cap > n`` guarantees termination."""
    first = idx_2[:, 0].astype(np.int64)
    counts = np.bincount(first, minlength=nlist)
    if counts.max() <= cap:
        return first
    assign = first.copy()
    margin = d2_2[:, 1] - d2_2[:, 0]
    for l in np.flatnonzero(counts > cap):
        rows = np.flatnonzero(first == l)
        spill = rows[np.argsort(margin[rows], kind="stable")[: counts[l] - cap]]
        assign[spill] = idx_2[spill, 1]
    counts = np.bincount(assign, minlength=nlist)
    while counts.max() > cap:
        for l in np.flatnonzero(counts > cap):
            rows = np.flatnonzero(assign == l)
            spill = rows[np.argsort(margin[rows], kind="stable")[: counts[l] - cap]]
            for r in spill:
                tgt = int(np.argmin(counts))
                assign[r] = tgt
                counts[tgt] += 1
                counts[l] -= 1
    return assign


def ivf_index_from_arrays(
    centroids: np.ndarray,
    grouped_x: np.ndarray,
    grouped_sq: np.ndarray,
    grouped_ids: np.ndarray,
    offsets: np.ndarray,
    lens: np.ndarray,
    cap: int,
    nlist: int,
    n_rows: int,
    device: torch.device | str = "cpu",
) -> IvfIndex:
    """An :class:`IvfIndex` on ``device`` from host arrays, such as those of
    an index another implementation built (its state, carried across like
    a model's weights)."""

    def dev(a, dtype):
        return torch.from_numpy(np.array(a, dtype=dtype, order="C")).to(device)

    return IvfIndex(
        centroids=dev(centroids, np.float32), grouped_x=dev(grouped_x, np.float32),
        grouped_sq=dev(grouped_sq, np.float32), grouped_ids=dev(grouped_ids, np.int32),
        offsets=np.asarray(offsets, dtype=np.int64), lens=np.asarray(lens, dtype=np.int32),
        cap=int(cap), nlist=int(nlist), n_rows=int(n_rows),
    )


def build_ivf_index(
    X: np.ndarray, *, nlist: int, seed: int, device: torch.device | str = "cpu"
) -> IvfIndex:
    """Train the coarse quantizer and lay out the cluster-grouped index on
    ``device``.

    The sample draw and the initial centres come from
    ``np.random.default_rng(seed)`` in the JAX package's order; Lloyd runs
    on the sample through K2 (10 iterations, tol 1e-4); every row
    takes its two closest centres; the host balances and lays out."""
    X = np.ascontiguousarray(np.asarray(X, dtype=np.float32))
    n, d = X.shape
    rng = np.random.default_rng(seed)
    sample = X[rng.choice(n, _TRAIN_SAMPLE, replace=False)] if n > _TRAIN_SAMPLE else X
    centers0 = sample[rng.choice(sample.shape[0], nlist, replace=False)]

    # 1) coarse quantizer: Lloyd on the sample, one K2 launch a pass
    X_d = torch.from_numpy(X).to(device)
    Xs_d = X_d if sample is X else torch.from_numpy(sample).to(device)
    centers, _, _ = kmeans_lloyd(
        Xs_d, torch.ones(Xs_d.shape[0], dtype=torch.float32, device=X_d.device),
        torch.from_numpy(np.ascontiguousarray(centers0)).to(device), max_iter=_TRAIN_ITERS, tol=_TRAIN_TOL,
    )
    del Xs_d

    # 2) two-choice assignment of every row on the device; the host spills
    # only rows above the loose hard bound
    d2_2, idx_2 = _assign_top2(X_d, centers, chunk=min(_ASSIGN_CHUNK, max(n, 1)))
    del X_d
    assign = _balanced_assign(d2_2.cpu().numpy(), idx_2.cpu().numpy(), nlist, hard_capacity(n, nlist))
    lens = np.bincount(assign, minlength=nlist).astype(np.int32)
    cap = -(-max(int(lens.max()), 1) // _CAP_MULTIPLE) * _CAP_MULTIPLE

    # 3) cluster-sorted CSR order, then scatter into the padded layout
    order = np.argsort(assign, kind="stable")
    offsets = np.zeros(nlist + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    sorted_assign = assign[order]
    slots = sorted_assign * cap + (np.arange(n, dtype=np.int64) - offsets[sorted_assign])
    grouped_x = np.zeros((nlist * cap, d), dtype=np.float32)
    grouped_x[slots] = X[order]
    grouped_sq = np.full((nlist * cap,), np.inf, dtype=np.float32)
    grouped_sq[slots] = (X[order] * X[order]).sum(axis=1)
    grouped_ids = np.full((nlist * cap,), -1, dtype=np.int32)
    grouped_ids[slots] = order.astype(np.int32)
    return ivf_index_from_arrays(centers.cpu().numpy(), grouped_x, grouped_sq, grouped_ids, offsets, lens, cap,
                                 nlist, n, device)


# --------------------------------------------------------------------------
# probe search
# --------------------------------------------------------------------------


def _search_qchunk(cap: int, d: int) -> int:
    """Query chunk bounding the (qc, cap, d) gathered candidate tile to
    ``_GATHER_BUDGET_ELEMS`` f32 elements (a multiple of 8)."""
    qc = _GATHER_BUDGET_ELEMS // max(cap * d, 1)
    qc = max(8, min(1024, qc))
    return max(8, (qc // 8) * 8)


def _probe_scan(
    Xq: torch.Tensor, cents: torch.Tensor, gx: torch.Tensor, gsq: torch.Tensor, gids: torch.Tensor,
    *, k: int, nprobe: int, cap: int, qchunk: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The IVF search body: each query chunk's coarse distances and its
    top-``nprobe`` lists, then a probe-major scan folding each (qc, cap)
    candidate window into a running top-k (the tile's k smallest, then a
    2k merge, the running entries first). Lists are disjoint, so
    candidates never repeat across probes."""
    nq, d = Xq.shape
    c_sq = (cents * cents).sum(dim=1)
    gx3 = gx.view(-1, cap, d)
    gsq2, gids2 = gsq.view(-1, cap), gids.view(-1, cap)
    out_d, out_i = [], []
    for lo in range(0, nq, qchunk):
        xq = Xq[lo : lo + qchunk]
        qc = xq.shape[0]
        x_sq = (xq * xq).sum(dim=1)
        probes = _stable_smallest(pairwise_sq_dists(xq, cents, c_sq), nprobe)  # (qc, nprobe)
        bd = torch.full((qc, k), float("inf"), dtype=Xq.dtype, device=Xq.device)
        bi = torch.full((qc, k), -1, dtype=torch.int32, device=Xq.device)
        for j in range(nprobe):
            pj = probes[:, j]
            xi = gx3[pj]                                          # (qc, cap, d)
            dots = torch.bmm(xi, xq[:, :, None])[:, :, 0]
            d2 = torch.clamp(x_sq[:, None] - 2.0 * dots + gsq2[pj], min=0.0)
            ids = gids2[pj]
            if cap < k:  # a window narrower than k: pad with +inf / -1
                d2 = torch.nn.functional.pad(d2, (0, k - cap), value=float("inf"))
                ids = torch.nn.functional.pad(ids, (0, k - cap), value=-1)
            sel = _stable_smallest(d2, k)
            cat_d = torch.cat([bd, d2.gather(1, sel)], dim=1)
            cat_i = torch.cat([bi, ids.gather(1, sel)], dim=1)
            selm = _stable_smallest(cat_d, k)
            bd, bi = cat_d.gather(1, selm), cat_i.gather(1, selm)
        out_d.append(bd)
        out_i.append(bi)
    return torch.cat(out_d), torch.cat(out_i)


def ivf_search(Xq: torch.Tensor, index: IvfIndex, *, k: int, nprobe: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Approximate k-NN of the rows of ``Xq`` (on the index's device)
    against a built index: ``(d2 (nq, k) ascending SQUARED distances,
    ids (nq, k) int32 source-row ids)``, the exact search's contract;
    unfilled slots hold +inf and id -1."""
    return _probe_scan(
        Xq, index.centroids, index.grouped_x, index.grouped_sq, index.grouped_ids,
        k=k, nprobe=nprobe, cap=index.cap, qchunk=_search_qchunk(index.cap, index.grouped_x.shape[1]),
    )
