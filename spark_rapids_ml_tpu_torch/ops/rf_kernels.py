"""RandomForest kernels of the port (counterpart of
``spark_rapids_ml_tpu/ops/rf_pallas.py``): the per-node histogram of a
compact level (K5, with the per-node fold its caller applies) and its
fused-selection form (K6, each node's columns picked from the full rows),
the packed-byte gather (K8, and K7, its single-index-set form) and the
packed-forest descent (K9: both hops and the leaf-payload sum of a
transform batch), each a CUDA kernel
(``csrc/rf_hist.cu``, ``csrc/rf_byte_gather.cu``, ``csrc/rf_traverse.cu``)
beside its plain PyTorch version. The TPU's per-sub-block forms of K5 and
K6 keep their plain versions (``subblock_hist_plain``,
``subblock_hist_sel_plain``), which the CPU tests hold against the JAX
package's Pallas kernels.

A CPU tensor goes to the plain version; a CUDA tensor goes to the kernel,
or the wrapper raises. Each wrapper counts its launches in ``.launches``.

The TPU gates (``rf_hist_pallas_ok``, ``rf_hist_sel_ok``,
``packed_byte_gather_ok``, ``packed_traverse_ok``: lane alignment of
``k·nb``, ``S <= 16``, at most 8,192 histogram lanes or 128 packed words,
rows in multiples of 2,048, lowering probes) are not carried over: the
kernels take any sub-block size, row count, width, ``nb <= 256`` and stat
count. The builder keeps ``BLOCK_ROWS`` only to size its padded row counts
exactly as the JAX package does, so both packages' kernels see the same
inputs at every level.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from . import _build

_I64, _P, _INT = ctypes.c_int64, ctypes.c_void_p, ctypes.c_int

# rows per TPU grid block: the builder pads each level's rows to a multiple
BLOCK_ROWS = 512
# lanes of a hop-2 table row (2^k2 - 1 <= 63 internal nodes, k2 <= 6)
LANES = 64
# rows per chunk of the traversal's plain version: bounds its
# (rows, trees) gathers
_TRAVERSE_CHUNK = 1 << 14


def _check_cuda(name: str, *specs) -> None:
    """Each spec is (tensor, dtype): one CUDA device, that dtype,
    contiguous. Anything else raises — there is no fallback on the card."""
    dev = specs[0][0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: expected a CPU or CUDA tensor, got {dev}")
    for t, dtype in specs:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != dtype:
            raise NotImplementedError(f"{name}: the CUDA kernel takes {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def _round16(x: int) -> int:
    return -(-x // 16) * 16


def _check_hist_shapes(name: str, rows: int, sw: torch.Tensor, n_bins: int, r_sub: int) -> None:
    if sw.dim() != 2 or sw.shape[0] != rows:
        raise ValueError(f"{name}: sw {tuple(sw.shape)} must be (rows={rows}, S)")
    if r_sub < 1 or rows % r_sub:
        raise ValueError(f"{name}: {rows} rows are not a multiple of r_sub={r_sub}")
    if not 1 <= n_bins <= 256:
        raise ValueError(f"{name}: n_bins={n_bins} outside [1, 256]")


# ---------------------------------------------------------------------------
# K5 / K6: per-node histograms of a compact level
# ---------------------------------------------------------------------------


def subblock_hist_plain(binq: torch.Tensor, sw: torch.Tensor, *, n_bins: int, r_sub: int) -> torch.Tensor:
    """K5 as the TPU computes it, per sub-block (no kernel on the card: the
    builder's K5 folds the sub-blocks per node): one ``scatter_add_`` on the
    flattened (sub-block, s, slot·nb + bin) index. ``binq`` (rows, k) int32
    bins, ``sw`` (rows, S); every node's run padded to an ``r_sub``
    multiple; a bin outside [0, n_bins) adds nothing. On the CPU the scatter
    visits rows in order, so every bin is the sequential row-order sum."""
    rows, k = binq.shape
    S = sw.shape[1]
    nb = n_bins
    dev = binq.device
    b = binq.long()
    ok = (b >= 0) & (b < nb)
    base = (torch.arange(rows, device=dev) // r_sub)[:, None, None] * S + torch.arange(S, device=dev)[None, :, None]
    idx = (base * k + torch.arange(k, device=dev)[None, None, :]) * nb + b.clamp(0, nb - 1)[:, None, :]
    vals = sw[:, :, None] * ok[:, None, :].to(sw.dtype)
    out = torch.zeros((rows // r_sub) * S * k * nb, dtype=sw.dtype, device=dev)
    out.scatter_add_(0, idx.reshape(-1), vals.reshape(-1))
    return out.reshape(rows // r_sub, S, k * nb)


# K5 and K6: rows a span sums in order (their summation order's one
# constant: a node's padded run is cut into spans of max(1, SPAN_ROWS //
# r_sub) sub-blocks from its start, and the node is the in-order fold of its
# spans' sums)
SPAN_ROWS = 4096
# their geometry (csrc/rf_hist.cu): a block's shared histograms aim at this
# many bytes; threads a block at most; bytes a stage of rows (one chunk;
# there are two) aims at in a block of 128 pairs, in proportion to the
# block's pairs, at least _NH_STAGE_BYTES_MIN (a stage size sweep on an
# H100, `chip_smoke.py --hist-only --sweep`, PERF.md §6); rows a stage at
# most; the largest dynamic shared memory a block may take on an H100; the
# span partials a launch may hold
_NH_HIST_BYTES = 64 << 10
_NH_MAX_THREADS = 256
_NH_STAGE_BYTES = 4 << 10
_NH_STAGE_BYTES_MIN = 2 << 10
_NH_STAGE_ROWS = 256
_SMEM_MAX = 232_448
_NH_SCRATCH_MAX = 256 << 20
_NH_TRANSPOSE_BYTES = 80  # a pair's row of the write-out transpose: 20 floats


def span_subblocks(r_sub: int) -> int:
    """Sub-blocks a span of K5's and K6's per-node sums covers."""
    return max(1, SPAN_ROWS // r_sub)


class NodeHistGeometry(NamedTuple):
    a: int            # sub-blocks a span
    spans: int        # bound on a tree's spans: the span kernel's grid x
    multi: int        # bound on a tree's nodes of more than one span: the fold's grid x
    part_slots: int   # bound on a tree's spans in such nodes: partial slots
    fc: int           # slots a launch (the row width F unless the partials need chunks)
    P: int            # threads a block: one (slot, stat) pair each
    rows: int         # rows staged at a time
    pitch: int        # bytes of a staged row's bins
    ns: int           # weights a staged row holds at most (S)
    smem: int         # dynamic shared memory a block, bytes
    scratch_bytes: int  # span partials and span tables a launch


def _span_geometry(name: str, T: int, n_pad: int, r_sub: int, n_nodes: int, F: int, S: int, nb: int):
    """(a, spans, multi, part_slots, fc, P, slots a tile touches) of K5's
    and K6's span kernels: see ``node_hist_geometry``."""
    if min(T, n_pad, r_sub, n_nodes, F, S, nb) < 1 or n_pad % r_sub or nb > 256:
        raise ValueError(f"{name}: no geometry for T={T}, n_pad={n_pad}, r_sub={r_sub}, "
                         f"n_nodes={n_nodes}, F={F}, S={S}, nb={nb}")
    a = span_subblocks(r_sub)
    n_sb = n_pad // r_sub
    spans = n_nodes + -(-n_sb // a)
    multi = min(n_nodes, n_sb // (a + 1))
    part_slots = (n_sb + multi * (a - 1)) // a if multi else 0
    fc = F
    while fc > 1 and 4 * T * part_slots * S * fc * nb > _NH_SCRATCH_MAX:
        fc = -(-fc // 2)
    P = min(_NH_MAX_THREADS, max(32, _NH_HIST_BYTES // (4 * nb) // 32 * 32), -(-(S * fc) // 32) * 32)
    nf = min(fc, (P - 1) // S + 2)        # slots a tile of P pairs touches
    return a, spans, multi, part_slots, fc, P, nf


def _stage_geometry(name, P, nb, S, pitch, tail):
    """(rows a stage, shared memory a block) for staged rows of ``pitch``
    bytes and S weights: the histograms, two stages of rows (the write's
    transpose rows reuse them), the src2 entries of two chunks, and
    ``tail`` bytes more. Raises past ``_SMEM_MAX``."""
    row_bytes = pitch + 4 * S
    stage_bytes = max(_NH_STAGE_BYTES_MIN, _NH_STAGE_BYTES * P // 128)
    rows = max(1, min(_NH_STAGE_ROWS, stage_bytes // row_bytes))
    smem = 4 * P * nb + max(2 * _round16(rows * row_bytes), _NH_TRANSPOSE_BYTES * P) + 16 * rows + tail
    if smem > _SMEM_MAX:
        raise ValueError(f"{name}: {smem} bytes of shared memory a block (at most {_SMEM_MAX})")
    return rows, smem


def node_hist_geometry(T: int, n_pad: int, r_sub: int, n_nodes: int, F: int, S: int, nb: int,
                       vec: bool = True) -> NodeHistGeometry:
    """K5's launch sizes for T trees of ``n_pad`` padded rows in sub-blocks
    of ``r_sub``, ``n_nodes`` nodes, F slots a row, S stats, ``nb`` bins;
    ``vec``: rows read as aligned 16-byte words.

    A tree has at most n_nodes + ceil(n_sb / a) spans (every node one
    span more than its sub-blocks over a, an empty node one span of no
    rows); a node of more than one span has at least a + 1 sub-blocks, so
    at most min(n_nodes, n_sb // (a + 1)) of them hold at most (n_sb +
    multi·(a - 1)) // a spans. The slots go in chunks of ``fc`` only where
    the partials of those spans would pass ``_NH_SCRATCH_MAX``. Raises when
    a block's shared memory passes ``_SMEM_MAX``."""
    a, spans, multi, part_slots, fc, P, nf = _span_geometry("node_hist", T, n_pad, r_sub, n_nodes, F, S, nb)
    pitch = min(_round16(F), _round16(nf + 15)) if vec else _round16(nf)
    rows, smem = _stage_geometry("node_hist", P, nb, S, pitch, 0)
    scratch = 4 * T * part_slots * S * fc * nb + 4 * T * 3 * (n_nodes + 1)
    return NodeHistGeometry(a, spans, multi, part_slots, fc, P, rows, pitch, S, smem, scratch)


def node_hist_sel_geometry(T: int, n_pad: int, r_sub: int, n_nodes: int, F: int, S: int,
                           nb: int) -> NodeHistGeometry:
    """K6's launch sizes: K5's spans, slot chunks and tiles for F slots (a
    node's ids), with each staged row holding the 4-byte word of each slot
    of a tile. Past the src2 entries a block holds each slot's row offset,
    16 zero bytes (a sentinel slot's bin), and two rows and weights of
    slack for the walk's reads past the last stage."""
    a, spans, multi, part_slots, fc, P, nf = _span_geometry("node_hist_sel", T, n_pad, r_sub, n_nodes, F, S, nb)
    pitch = _round16(4 * nf)
    tail = 4 * -(-nf // 4) * 4 + 16 + 2 * pitch + 8 * S
    rows, smem = _stage_geometry("node_hist_sel", P, nb, S, pitch, tail)
    scratch = 4 * T * part_slots * S * fc * nb + 4 * T * 3 * (n_nodes + 1)
    return NodeHistGeometry(a, spans, multi, part_slots, fc, P, rows, pitch, S, smem, scratch)


def node_spans(pstart: torch.Tensor, r_sub: int, n_pad: int):
    """K5's and K6's span table of a compact level's layout: ``pstart`` (T,
    n_nodes + 1) the padded row where each node starts (the last entry:
    where the dump sub-blocks start). Returns the global span id (T, n_pad
    // r_sub) of every sub-block (the span count for a dump sub-block), the
    global node id ``t·n_nodes + j`` (n_spans,) of every span in span
    order, and the span count. A node's spans are consecutive, in row
    order; an empty node has one span of no sub-blocks."""
    T, n_nodes = pstart.shape[0], pstart.shape[1] - 1
    dev = pstart.device
    a = span_subblocks(r_sub)
    sbs = pstart // r_sub
    spans = ((sbs[:, 1:] - sbs[:, :-1] + a - 1) // a).clamp_min(1).reshape(-1)
    first = torch.cumsum(spans, 0) - spans
    n_spans = int(spans.sum())
    span_node = torch.repeat_interleave(torch.arange(T * n_nodes, device=dev), spans, output_size=n_spans)
    sb = torch.arange(n_pad // r_sub, device=dev).expand(T, -1).contiguous()
    j = torch.searchsorted(sbs[:, 1:].contiguous(), sb, right=True)
    jc = j.clamp(max=n_nodes - 1)
    gid = first.reshape(T, n_nodes).gather(1, jc) + (sb - sbs.gather(1, jc)) // a
    return torch.where(j < n_nodes, gid, n_spans), span_node, n_spans


def fold_spans(sums: torch.Tensor, span_node: torch.Tensor, num: int) -> torch.Tensor:
    """(num, W) per-node folds of the span sums ``sums`` (n_spans, W), each
    node's spans added in span order from +0 (``index_add_`` adds in index
    order on the CPU)."""
    return torch.zeros((num, sums.shape[1]), dtype=sums.dtype, device=sums.device).index_add_(0, span_node, sums)


def _check_node_hist(name, bins, src2, swq, pstart, n_bins, r_sub):
    T, n_pad = src2.shape
    if bins.dim() not in (2, 3) or (bins.dim() == 3 and bins.shape[0] != T):
        raise ValueError(f"{name}: bins {tuple(bins.shape)} must be (n, F) or (T={T}, n, F)")
    if swq.dim() != 3 or swq.shape[:2] != (T, n_pad):
        raise ValueError(f"{name}: swq {tuple(swq.shape)} must be (T={T}, n_pad={n_pad}, S)")
    if pstart.dim() != 2 or pstart.shape[0] != T or pstart.shape[1] < 2:
        raise ValueError(f"{name}: pstart {tuple(pstart.shape)} must be (T={T}, n_nodes + 1)")
    _check_hist_shapes(name, n_pad, swq[0], n_bins, r_sub)


def _span_scatter(rows: torch.Tensor, swq: torch.Tensor, pstart: torch.Tensor, n_bins: int,
                  r_sub: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The span sums (n_spans, S·F·nb) of the padded rows' bins ``rows``
    (T, n_pad, F), by one ``scatter_add_`` of every row in order onto
    (span, s, slot·nb + bin), and the global node (n_spans,) of each span
    (``node_spans``)."""
    T, n_pad, F = rows.shape
    S, nb = swq.shape[-1], n_bins
    dev = rows.device
    span_of_sb, span_node, n_spans = node_spans(pstart, r_sub, n_pad)
    rows = rows.long()
    span = span_of_sb.repeat_interleave(r_sub, dim=1)
    base = span[..., None] * S + torch.arange(S, device=dev)
    idx = (base[..., None] * F + torch.arange(F, device=dev)) * nb + rows.clamp(max=nb - 1)[:, :, None, :]
    vals = torch.where((rows < nb)[:, :, None, :], swq[..., None], torch.zeros((), dtype=swq.dtype, device=dev))
    sums = torch.zeros((n_spans + 1) * S * F * nb, dtype=swq.dtype, device=dev)
    sums.scatter_add_(0, idx.reshape(-1), vals.reshape(-1))
    return sums.reshape(n_spans + 1, S * F * nb)[:n_spans], span_node


def span_sums_plain(bins: torch.Tensor, src2: torch.Tensor, swq: torch.Tensor, pstart: torch.Tensor, *,
                    n_bins: int, r_sub: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The span sums (n_spans, S·F·nb) of K5 per node (``_span_scatter``
    of the rows read through ``src2``), and the global node (n_spans,) of
    each span."""
    T, n_pad = src2.shape
    F = bins.shape[-1]
    if bins.dim() == 2:
        rows = bins.index_select(0, src2.reshape(-1)).reshape(T, n_pad, F)
    else:
        rows = bins.gather(1, src2[..., None].expand(T, n_pad, F))
    return _span_scatter(rows, swq, pstart, n_bins, r_sub)


def node_hist_plain(bins: torch.Tensor, src2: torch.Tensor, swq: torch.Tensor, pstart: torch.Tensor, *,
                    n_bins: int, r_sub: int) -> torch.Tensor:
    """Plain version of K5 per node: ``span_sums_plain``, then
    ``fold_spans`` into nodes, in ``swq``'s dtype (f64 for the on-card
    check). On the CPU the scatter visits rows in order, so a span's bin is
    the sequential row-order sum the kernel computes, and the fold is its
    in-order fold."""
    T, n_nodes = src2.shape[0], pstart.shape[1] - 1
    sums, span_node = span_sums_plain(bins, src2, swq, pstart, n_bins=n_bins, r_sub=r_sub)
    return fold_spans(sums, span_node, T * n_nodes).reshape(T, n_nodes, swq.shape[-1], -1)


def select_rows_plain(bins: torch.Tensor, src2: torch.Tensor, pstart: torch.Tensor,
                      feats: torch.Tensor) -> torch.Tensor:
    """K6's bins of every padded row (T, n_pad, F) uint8: ``bins[src2[t,
    r], feats[t, j, f]]`` for the node j whose run holds row r (the last
    node for the dump rows past every node), 0 where the id lies outside
    [0, d_row) (the sentinel ``n_features`` when ``n_features == d_row``)."""
    T, n_pad = src2.shape
    n_nodes, F, d_row = pstart.shape[1] - 1, feats.shape[-1], bins.shape[1]
    pos = torch.arange(n_pad, device=src2.device).expand(T, -1).contiguous()
    node = torch.searchsorted(pstart[:, 1:].contiguous(), pos, right=True).clamp(max=n_nodes - 1)
    ids = feats.gather(1, node[..., None].expand(T, n_pad, F)).long()
    inside = (ids >= 0) & (ids < d_row)
    rows = bins.reshape(-1)[src2[..., None] * d_row + ids.clamp(0, d_row - 1)]
    return torch.where(inside, rows, torch.zeros((), dtype=rows.dtype, device=rows.device))


def node_hist_sel_plain(bins: torch.Tensor, src2: torch.Tensor, swq: torch.Tensor, pstart: torch.Tensor,
                        feats: torch.Tensor, *, n_bins: int, r_sub: int) -> torch.Tensor:
    """Plain version of K6 per node: each padded row's bytes selected by
    its node's ids (``select_rows_plain``), then K5's span scatter and
    in-order fold, in ``swq``'s dtype: the kernel's sums bit for bit on the
    CPU."""
    T, n_nodes = src2.shape[0], pstart.shape[1] - 1
    sums, span_node = _span_scatter(select_rows_plain(bins, src2, pstart, feats), swq, pstart, n_bins, r_sub)
    return fold_spans(sums, span_node, T * n_nodes).reshape(T, n_nodes, swq.shape[-1], -1)


class _NodeHistPlan(ctypes.Structure):
    """A launch's sizes, as ``NodeHistPlan`` in csrc/rf_hist.cu."""
    _fields_ = [("n_pad", ctypes.c_int64), ("tree_stride", ctypes.c_int64), ("part_slots", ctypes.c_int64)] + [
        (name, ctypes.c_int) for name in ("F", "S", "nb", "r_sub", "a", "n_nodes", "T", "f_lo", "fc", "P", "rows",
                                          "pitch", "ns", "tiles", "spans", "multi", "smem", "vec", "skip",
                                          "d_row")]


def node_hist_batched(bins: torch.Tensor, src2: torch.Tensor, swq: torch.Tensor, pstart: torch.Tensor, *,
                      n_bins: int, r_sub: int) -> torch.Tensor:
    """Kernel K5: every node's histogram (T, n_nodes, S, F·n_bins) of a
    compact level, in one launch. Tree t's padded row r reads the bins
    ``bins[src2[t, r]]`` of the uint8 table ``bins``, shared (n, F) or
    per tree (T, n, F), and the weights ``swq`` (T, n_pad, S) f32 (0 on
    padding rows); ``pstart`` (T, n_nodes + 1) int64 is where each node's
    run of ``r_sub``-multiple rows starts (``_compact_layout``). A bin >=
    n_bins adds nothing; the dump sub-blocks past the last node are read by
    no one. The sums are fixed in order (``SPAN_ROWS``): equal to
    ``node_hist_plain`` on the CPU bit for bit. Replaces
    ``spark_rapids_ml_tpu/ops/rf_pallas.py::subblock_hist`` with its
    caller's per-node ``segment_sum``."""
    _check_node_hist("node_hist_batched", bins, src2, swq, pstart, n_bins, r_sub)
    if src2.device.type == "cpu":
        return node_hist_plain(bins, src2, swq, pstart, n_bins=n_bins, r_sub=r_sub)
    _check_cuda("node_hist_batched", (bins, torch.uint8), (src2, torch.int64), (swq, torch.float32),
                (pstart, torch.int64))
    fn = _build.function("rf_hist", "node_hist_launch", [_P] * 8 + [_INT, _P])
    return _node_hist_run(bins, src2, swq, pstart, n_bins, r_sub, fn,
                          torch.cuda.current_stream(src2.device).cuda_stream)


node_hist_batched.launches = 0


def _launch_levels(geo, fn, ptrs, dims, vec, skip, stream, wrapper, dev) -> torch.Tensor:
    """A level's output (T, n_nodes, S, F·nb) f32, span tables and span
    partials, and one launch of the C entry point ``fn`` (the span table
    with the first) a chunk of ``geo.fc`` slots; ``ptrs`` its pointers
    before the output, ``dims`` the plan's (n_pad, tree_stride, F, S, nb,
    r_sub, n_nodes, T, d_row). Counts each launch on ``wrapper``."""
    n_pad, tree_stride, F, S, nb, r_sub, n_nodes, T, d_row = dims
    out = torch.empty((T, n_nodes, S, F * nb), dtype=torch.float32, device=dev)
    tabs = torch.empty((T, 3, n_nodes + 1), dtype=torch.int32, device=dev)
    parts = torch.empty(max(1, T * geo.part_slots * S * geo.fc * nb), dtype=torch.float32, device=dev)
    for f_lo in range(0, F, geo.fc):
        fc = min(geo.fc, F - f_lo)
        plan = _NodeHistPlan(n_pad, tree_stride, geo.part_slots, F, S, nb, r_sub, geo.a, n_nodes, T, f_lo, fc,
                             geo.P, geo.rows, geo.pitch, geo.ns, -(-(S * fc) // geo.P), geo.spans, geo.multi,
                             geo.smem, vec, skip, d_row)
        code = fn(*ptrs, out.data_ptr(), tabs.data_ptr(), parts.data_ptr(), ctypes.addressof(plan),
                  int(f_lo == 0), stream)
        wrapper.launches += 1
        _build.check("rf_hist", code)
    return out


def _node_hist_run(bins, src2, swq, pstart, n_bins, r_sub, fn, stream, skip: int = 0) -> torch.Tensor:
    """K5's launches through the C entry point ``fn`` (``node_hist_launch``)
    on checked tensors. ``skip``: a probe's knock-outs (1 the walk, 2 the
    row loads, 4 the write; the output is then not K5's)."""
    T, n_pad = src2.shape
    S, F, n_nodes = swq.shape[-1], bins.shape[-1], pstart.shape[1] - 1
    vec = F % 16 == 0 and bins.data_ptr() % 16 == 0
    geo = node_hist_geometry(T, n_pad, r_sub, n_nodes, F, S, n_bins, vec)
    dims = (n_pad, bins.shape[1] * F if bins.dim() == 3 else 0, F, S, n_bins, r_sub, n_nodes, T, F)
    return _launch_levels(geo, fn, (bins.data_ptr(), src2.data_ptr(), swq.data_ptr(), pstart.data_ptr()), dims,
                          int(vec), skip, stream, node_hist_batched, src2.device)


def node_hist_sel_batched(bins: torch.Tensor, src2: torch.Tensor, swq: torch.Tensor, pstart: torch.Tensor,
                          feats: torch.Tensor, *, n_bins: int, r_sub: int) -> torch.Tensor:
    """Kernel K6: every node's histogram (T, n_nodes, S, F·n_bins) of a
    compact level over the node's own F feature ids ``feats`` (T, n_nodes,
    F) int32, picked in the kernel from the full rows of the shared uint8
    table ``bins`` (n, d_row) read through ``src2``; an id outside [0,
    d_row) reads as bin 0. The rest as ``node_hist_batched``, and the same
    summation order: equal to ``node_hist_sel_plain`` on the CPU bit for
    bit. On the card the table's rows must be 4-byte aligned (d_row % 4 ==
    0). Replaces ``spark_rapids_ml_tpu/ops/rf_pallas.py::
    subblock_hist_sel`` with its caller's gather of the node-sorted full
    rows and per-node ``segment_sum``."""
    _check_node_hist("node_hist_sel_batched", bins, src2, swq, pstart, n_bins, r_sub)
    T, n_nodes = src2.shape[0], pstart.shape[1] - 1
    if bins.dim() != 2 or feats.dim() != 3 or feats.shape[:2] != (T, n_nodes):
        raise ValueError(f"node_hist_sel_batched: bins {tuple(bins.shape)} must be (n, d_row) and feats "
                         f"{tuple(feats.shape)} (T={T}, n_nodes={n_nodes}, F)")
    if src2.device.type == "cpu":
        return node_hist_sel_plain(bins, src2, swq, pstart, feats, n_bins=n_bins, r_sub=r_sub)
    _check_cuda("node_hist_sel_batched", (bins, torch.uint8), (src2, torch.int64), (swq, torch.float32),
                (pstart, torch.int64), (feats, torch.int32))
    if bins.shape[1] % 4 or bins.data_ptr() % 4:
        raise ValueError(f"node_hist_sel_batched: the kernel reads 4-byte words; rows of {bins.shape[1]} bytes "
                         f"at an address {bins.data_ptr() % 4} bytes past 4-byte alignment")
    return _node_hist_sel_run(bins, src2, swq, pstart, feats, n_bins, r_sub, _sel_launch(),
                              torch.cuda.current_stream(src2.device).cuda_stream)


node_hist_sel_batched.launches = 0


def _sel_launch():
    """K6's C entry point ``node_hist_sel_launch``."""
    return _build.function("rf_hist", "node_hist_sel_launch", [_P] * 9 + [_INT, _P])


def _node_hist_sel_run(bins, src2, swq, pstart, feats, n_bins, r_sub, fn, stream, skip: int = 0) -> torch.Tensor:
    """K6's launches through ``fn`` on checked tensors, as ``_node_hist_run``."""
    T, n_pad = src2.shape
    S, F, n_nodes, d_row = swq.shape[-1], feats.shape[-1], pstart.shape[1] - 1, bins.shape[1]
    geo = node_hist_sel_geometry(T, n_pad, r_sub, n_nodes, F, S, n_bins)
    ptrs = (bins.data_ptr(), src2.data_ptr(), swq.data_ptr(), pstart.data_ptr(), feats.data_ptr())
    return _launch_levels(geo, fn, ptrs, (n_pad, 0, F, S, n_bins, r_sub, n_nodes, T, d_row), 0, skip, stream,
                          node_hist_sel_batched, src2.device)


def node_hist_attributes(vec: bool, P: int, smem: int, sel: bool = False) -> Tuple[int, int, int]:
    """(registers, local bytes a thread, resident blocks an SM) of K5's
    span kernel (``vec``: its 16-byte instance) or, with ``sel``, K6's at P
    threads and ``smem`` bytes a block on the current card."""
    fn = _build.function("rf_hist", "node_hist_attributes", [_INT, _INT, _INT, _INT, _P, _P, _P])
    out = [ctypes.c_int(0) for _ in range(3)]
    _build.check("rf_hist", fn(int(sel), int(vec), P, smem, *(ctypes.byref(v) for v in out)))
    return tuple(v.value for v in out)


def select_bins_plain(bq: torch.Tensor, featsq: torch.Tensor, r_sub: int) -> torch.Tensor:
    """Each row's selected bins (rows, k) int32: ``bq[r, featsq[r // r_sub,
    j]]``, 0 where the id lies outside [0, d_pad) (the sentinel
    ``n_features`` when ``n_features == d_pad``)."""
    d_pad = bq.shape[1]
    fid = featsq.repeat_interleave(r_sub, dim=0).long()
    inside = (fid >= 0) & (fid < d_pad)
    b = bq.gather(1, fid.clamp(0, d_pad - 1)).to(torch.int32)
    return torch.where(inside, b, torch.zeros_like(b))


def subblock_hist_sel_plain(
    bq: torch.Tensor, featsq: torch.Tensor, sw: torch.Tensor, *, n_bins: int, r_sub: int
) -> torch.Tensor:
    """K6 as the TPU computes it, per sub-block (no kernel on the card: the
    builder's K6 works per node): each sub-block's selected columns of the
    node-sorted full rows ``bq`` (rows, d_pad) by ``featsq`` (rows //
    r_sub, k) int32, then ``subblock_hist_plain``."""
    return subblock_hist_plain(select_bins_plain(bq, featsq, r_sub), sw, n_bins=n_bins, r_sub=r_sub)


# ---------------------------------------------------------------------------
# K7 / K8: byte gather from word-packed bins
# ---------------------------------------------------------------------------


def packed_byte_gather_many_plain(packed: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of K8: ``(packed[r, i >> 2] >> 8·(i & 3)) & 0xFF`` for
    every index ``i = idx[g, r, j]``, 0 where ``i`` lies outside [0,
    4·words) (the JAX package's ``_contract_gather`` matches no word
    there). One index set at a time, in int64 (the word's sign extension
    is masked off with the byte)."""
    n, words = packed.shape
    p = packed.long()
    out = torch.empty(idx.shape, dtype=torch.int32, device=idx.device)
    for g in range(idx.shape[0]):
        i = idx[g].long()
        inside = (i >= 0) & (i < 4 * words)
        ic = i.clamp(0, 4 * words - 1)
        b = (p.gather(1, ic >> 2) >> ((ic & 3) * 8)) & 0xFF
        out[g] = torch.where(inside, b, torch.zeros_like(b))
    return out


def _check_byte_gather(name: str, packed: torch.Tensor, idx: torch.Tensor, row_dim: int = 1) -> None:
    """packed (n, words) and idx (G, n, k) (K8), or (n, k) with
    ``row_dim=0`` (K7)."""
    if packed.dim() != 2 or idx.dim() != row_dim + 2 or idx.shape[row_dim] != packed.shape[0]:
        raise ValueError(
            f"{name}: packed {tuple(packed.shape)} must be (n, words) and idx "
            f"{tuple(idx.shape)} {'(G, n, k)' if row_dim else '(n, k)'}"
        )


def _check_gather_cuda(name: str, packed: torch.Tensor, idx: torch.Tensor) -> None:
    """``_check_cuda`` for K7/K8's two int32 tensors, in one pass (the
    check sits on a launch-sized call's host path); ``_check_cuda`` words
    the error."""
    dev = idx.device
    if not (dev.type == "cuda" and packed.device == dev and packed.dtype == torch.int32
            and idx.dtype == torch.int32 and packed.is_contiguous() and idx.is_contiguous()):
        _check_cuda(name, (packed, torch.int32), (idx, torch.int32))


# K7/K8 geometry (csrc/rf_byte_gather.cu), set from chunk-size and grid
# sweeps on an H100 (`chip_smoke.py --gather-only --sweep`; PERF.md §6):
# threads a block; entries a direct chunk aims at; bytes of rows a direct
# chunk keeps in L1 and a stage holds; staged where a row's 32-byte
# sectors take this many lookups each
_GATHER_THREADS = 256
_GATHER_ENTRIES = 32_768
_GATHER_L1_BYTES = 32 << 10
_GATHER_STAGE_BYTES = 16 << 10
_GATHER_DENSE_LOOKUPS = 32
# an SM's shared memory, of which each resident block reserves 1 KB; a grid
# of this many waves of resident blocks or more runs one chunk a block
_SM_SHARED_BYTES = 233_472
_GATHER_WAVES_UNROLLED = 3
_GATHER_INSTANCES = {"direct_scalar": 0, "direct_vec": 1, "staged_scalar": 2, "staged_vec": 3}


class GatherGeometry(NamedTuple):
    instance: str   # a key of _GATHER_INSTANCES
    rows: int       # R: rows a chunk, a multiple of 4
    stages: int     # shared-memory stages (2 staged, 0 direct)
    grid: int       # blocks
    smem: int       # dynamic shared memory a block, bytes


class _Plan(ctypes.Structure):
    """A launch's sizes, as ``Plan`` in csrc/rf_byte_gather.cu."""
    _fields_ = [("n", ctypes.c_int64), ("words", ctypes.c_int), ("k", ctypes.c_int), ("G", ctypes.c_int),
                ("instance", ctypes.c_int), ("rows", ctypes.c_int), ("grid", ctypes.c_int), ("smem", ctypes.c_int)]


def _floor4(x: int) -> int:
    return x // 4 * 4


def _gather_geometry(
    n: int, words: int, k: int, G: int, packed_aligned: bool, stream_aligned: bool, smem_per_block: int,
    sms: int, resident: int, staged: Optional[bool] = None,
) -> GatherGeometry:
    """K7/K8's instance and sizes for ``packed`` (n, words) and ``idx`` (G,
    n, k), n, k, G >= 1, on a card of ``sms`` SMs that holds ``resident``
    blocks an SM by registers and threads, ``smem_per_block`` bytes of
    shared memory a block.

    A block serves chunks of R rows (a multiple of 4) with all G index sets.
    The staged instance copies a chunk's rows into shared memory (two
    stages) and serves the lookups from there: it takes dense gathers,
    ``G·k`` lookups a row at least ``_GATHER_DENSE_LOOKUPS`` times the
    row's 32-byte sectors, with ``packed`` 16-byte aligned and two stages
    of 4 rows within ``smem_per_block``. The direct instance reads each
    looked-up word from global memory, where L1 keeps a chunk's rows for
    its G sets: everything else. ``staged`` forces one (a probe, a test);
    a shape the staged instance cannot take raises. Both take their vector
    form when ``idx`` and the output are 16-byte aligned
    (``stream_aligned``), else their scalar one.

    R: a stage of ``_GATHER_STAGE_BYTES``, or (direct) about
    ``_GATHER_ENTRIES`` entries in at most ``_GATHER_L1_BYTES`` of rows;
    at most n over a wave of resident blocks, so that every block has a
    chunk. The grid is one wave of resident blocks walking the chunks,
    or, from ``_GATHER_WAVES_UNROLLED`` waves of chunks, one block a
    chunk."""
    row_bytes = 4 * words
    if min(n, words, k, G) < 1:
        raise ValueError(f"packed_byte_gather: no geometry for n={n}, words={words}, k={k}, G={G}")
    if G * k * 4 >= 1 << 31:
        raise ValueError(f"packed_byte_gather: G·k = {G * k} index entries a row is too many")
    fits = packed_aligned and 2 * 4 * row_bytes <= smem_per_block
    if staged is None:
        staged = fits and G * k >= _GATHER_DENSE_LOOKUPS * -(-words // 8)
    elif staged and not fits:
        raise ValueError(f"packed_byte_gather: {words} words a row do not stage in {smem_per_block} bytes")
    wave = sms * max(1, resident)
    if staged:
        R = min(_GATHER_STAGE_BYTES, smem_per_block // 2) // row_bytes
    else:
        R = min(-(-_GATHER_ENTRIES // (G * k)), _GATHER_L1_BYTES // row_bytes)
    R = max(4, _floor4(min(R, -(-n // wave) + 3, ((1 << 31) - 1) // (G * k), ((1 << 31) - 1) // words)))
    if staged:
        wave = sms * max(1, min(resident, _SM_SHARED_BYTES // (2 * R * row_bytes + 1024)))
    chunks = -(-n // R)
    if chunks > (1 << 31) - 1:
        raise ValueError(f"packed_byte_gather: {n} rows make too many chunks")
    instance = ("staged" if staged else "direct") + ("_vec" if stream_aligned else "_scalar")
    return GatherGeometry(instance, R, 2 if staged else 0,
                          chunks if chunks >= _GATHER_WAVES_UNROLLED * wave else min(chunks, wave),
                          2 * R * row_bytes if staged else 0)


@functools.lru_cache(maxsize=None)
def _gather_device(index: int) -> Tuple[int, int, int]:
    """(SMs, shared memory a block may opt into, resident K7/K8 blocks an
    SM by registers and threads) of CUDA device ``index``."""
    fn = _build.function("rf_byte_gather", "packed_byte_gather_device", [_INT, _P, _P, _P])
    out = [ctypes.c_int(0) for _ in range(3)]
    _build.check("rf_byte_gather", fn(index, *(ctypes.byref(v) for v in out)))
    return tuple(v.value for v in out)


def _gather_plan(n: int, words: int, k: int, G: int, geometry: GatherGeometry) -> Tuple[_Plan, int]:
    """The C ``Plan`` of a launch, and its address (valid while the
    ``_Plan`` lives)."""
    plan = _Plan(n, words, k, G, _GATHER_INSTANCES[geometry.instance], geometry.rows, geometry.grid,
                 geometry.smem)
    return plan, ctypes.addressof(plan)


@functools.lru_cache(maxsize=1024)
def _gather_route(n: int, words: int, k: int, G: int, packed_aligned: bool, stream_aligned: bool,
                  index: int) -> Tuple[GatherGeometry, _Plan, int]:
    """The routed geometry of a shape on device ``index``, with its plan
    (cached: a launch-sized call pays one lookup)."""
    sms, smem_per_block, resident = _gather_device(index)
    geom = _gather_geometry(n, words, k, G, packed_aligned, stream_aligned, smem_per_block, sms, resident)
    return (geom, *_gather_plan(n, words, k, G, geom))


def _route_for(packed: torch.Tensor, idx: torch.Tensor) -> Tuple[GatherGeometry, _Plan, int]:
    """``_gather_route`` for CUDA ``packed`` (n, words) and ``idx`` (G, n,
    k) or, for K7, (n, k): by shape and by the alignment of their bases."""
    G, n, k = idx.shape if idx.dim() == 3 else (1, *idx.shape)
    return _gather_route(n, packed.shape[1], k, G, packed.data_ptr() % 16 == 0, idx.data_ptr() % 16 == 0,
                         idx.device.index)


def gather_geometry(packed: torch.Tensor, idx: torch.Tensor) -> GatherGeometry:
    """The geometry K7/K8 take for these CUDA tensors."""
    return _route_for(packed, idx)[0]


_gather_launch = None  # the bound C entry point, once per process


def _launch_byte_gather(packed: torch.Tensor, idx: torch.Tensor,
                        geometry: Optional[GatherGeometry] = None) -> torch.Tensor:
    """One launch of the CUDA kernel on (n, words) rows and (G, n, k) —
    for K7 (n, k) — indices, checked CUDA int32 contiguous tensors, with
    the routed geometry or ``geometry``. The output has ``idx``'s shape."""
    global _gather_launch
    if idx.numel() == 0:  # nothing to gather
        return torch.empty_like(idx)
    if geometry is None:
        plan_at = _route_for(packed, idx)[2]
    else:
        G, n, k = idx.shape if idx.dim() == 3 else (1, *idx.shape)
        plan, plan_at = _gather_plan(n, packed.shape[1], k, G, geometry)  # alive through the call
    out = torch.empty_like(idx)  # a new allocation: 16-byte aligned
    if _gather_launch is None:
        _gather_launch = _build.function("rf_byte_gather", "packed_byte_gather_launch", [_P, _P, _P, _P, _P])
    # torch._C._cuda_getCurrentRawStream (private): the caller's current
    # stream as a raw handle, without the Stream object that
    # torch.cuda.current_stream builds on every call
    code = _gather_launch(packed.data_ptr(), idx.data_ptr(), out.data_ptr(), plan_at,
                          torch._C._cuda_getCurrentRawStream(idx.device.index))
    if code:
        _build.check("rf_byte_gather", code)
    return out


def packed_byte_gather_many(packed: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Kernel K8: byte ``idx[g, r, j]`` of row r's word-packed bins, (G, n,
    k) int32, for G index sets ``idx`` (G, n, k) int32 against the same
    rows ``packed`` (n, words) int32 in one launch; an index outside [0,
    4·words) gives 0. Replaces ``spark_rapids_ml_tpu/ops/rf_pallas.py::
    packed_byte_gather_many``, without its width (64-128 words), row
    (multiples of 2,048) and lane-padding gates."""
    _check_byte_gather("packed_byte_gather_many", packed, idx)
    if idx.device.type == "cpu":
        return packed_byte_gather_many_plain(packed, idx)
    _check_gather_cuda("packed_byte_gather_many", packed, idx)
    out = _launch_byte_gather(packed, idx)
    packed_byte_gather_many.launches += 1
    return out


packed_byte_gather_many.launches = 0


def packed_byte_gather_plain(packed: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of K7: K8's with one index set."""
    return packed_byte_gather_many_plain(packed, idx[None])[0]


def packed_byte_gather(packed: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Kernel K7: ``packed_byte_gather_many`` for one index set ``idx`` (n,
    k) int32 -> (n, k) int32, the same CUDA kernel with G = 1. Replaces
    ``spark_rapids_ml_tpu/ops/rf_pallas.py::packed_byte_gather``, which
    has no caller in either package."""
    _check_byte_gather("packed_byte_gather", packed, idx, row_dim=0)
    if idx.device.type == "cpu":
        return packed_byte_gather_plain(packed, idx)
    _check_gather_cuda("packed_byte_gather", packed, idx)
    out = _launch_byte_gather(packed, idx)
    packed_byte_gather.launches += 1
    return out


packed_byte_gather.launches = 0


# ---------------------------------------------------------------------------
# K9: the packed-forest descent (hop 1, hop 2, leaf-payload sums)
# ---------------------------------------------------------------------------

# K9's geometry (csrc/rf_traverse.cu): rows a block (two a lane), trees a
# pass (its warps; the payload sum's group); a block stages its rows in
# shared memory up to this many bytes (3,200 a row), wider rows are read
# from global memory (at 3,000 bytes a row, one staged block an SM beat
# reading them: PERF.md section 6)
_FOREST_ROWS = 64
_FOREST_GROUP = 8
_FOREST_STAGE_MAX = 200 << 10


def _forest_geometry(words: int, k1: int, root: bool) -> Tuple[bool, int, int]:
    """(stage, ws, smem) of a K9 launch on rows of ``words`` int32 words:
    whether the block's rows are staged in shared memory, a staged row's
    stride in words (odd: 32 rows' bytes at one feature fall in 32 banks)
    and the dynamic shared memory in bytes: two buffers (a pass's and the
    next one's) of the 8 trees' hop-1 node words, two of the leaf ids at 9
    words a row, and the rows."""
    ws = words | 1
    rows_bytes = _FOREST_ROWS * ws * 4
    stage = rows_bytes <= _FOREST_STAGE_MAX
    smem = (2 * _FOREST_GROUP * ((1 << k1) - 1) * 4 if root else 0) + 2 * _FOREST_ROWS * (_FOREST_GROUP + 1) * 4
    return stage, ws, smem + (rows_bytes if stage else 0)


# the largest feature a node word holds: (feature << 9) stays below 2^31
_NODE_FEATURE_MAX = (1 << 22) - 1


def forest_nodes(feat: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
    """K9's node words of a (feature, bin threshold) table, one int32 a
    node so that a step of the walk is one load: -1 at a leaf (feature <
    0), else ``(feature << 9) | (threshold + 1)``, the threshold clamped to
    [-1, 255] and the feature to 2^22 - 1. Neither clamp changes a test:
    a byte is above 255 never and above -1 always, and the walk reads a
    feature past the row as the row's last byte, rows having at most 2^22
    bytes (``packed_forest_eval`` refuses longer ones)."""
    w = (feat.long().clamp(max=_NODE_FEATURE_MAX) << 9) | (thr.long().clamp(-1, 255) + 1)
    return torch.where(feat < 0, torch.full_like(w, -1), w).to(torch.int32)


def _node_fields(nodes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(feature, threshold) of node words: feature -1 at a leaf, where the
    threshold means nothing."""
    return torch.where(nodes < 0, torch.full_like(nodes, -1), nodes >> 9), (nodes & 511) - 1


def _leaf_ids(m: torch.Tensor, l: torch.Tensor, k1: int, k2: int) -> torch.Tensor:
    """Global heap index of the leaf at local heap slot ``m`` of level-k1
    subtree ``l``."""
    delta = torch.zeros_like(m)
    for j in range(1, k2 + 1):
        delta += (m + 1 >= (1 << j)).to(m.dtype)
    pd = torch.ones_like(m) << delta
    return ((1 << k1) * pd - 1) + l * pd + (m - (pd - 1))


def _packed_hop1(xb: torch.Tensor, feat1: torch.Tensor, thr1: torch.Tensor, *, k1: int) -> torch.Tensor:
    """All trees' hop 1: k1 steps of ``bin > thr`` from the root, as
    gathers. Returns (n, T_pad) int32 heap indices; a row that stopped at a
    hop-1 leaf holds an index < 2^k1 - 1."""
    n, d_pad = xb.shape
    T_pad, n1 = feat1.shape
    f1, t1 = feat1.reshape(-1).long(), thr1.reshape(-1).long()
    base = torch.arange(T_pad, device=xb.device)[None, :] * n1
    i = torch.zeros((n, T_pad), dtype=torch.int64, device=xb.device)
    for _ in range(k1):
        j = base + i
        f = f1[j]
        x = xb.gather(1, f.clamp(0, d_pad - 1)).long()
        e = torch.where(f >= 0, 1 + (x > t1[j]).long(), torch.zeros_like(f))
        i = torch.where(e > 0, 2 * i + e, i)
    return i.to(torch.int32)


def packed_traverse_plain(
    packed: torch.Tensor, i1: torch.Tensor, feat2: torch.Tensor, thr2: torch.Tensor, *, k1: int, k2: int
) -> torch.Tensor:
    """Plain version of K9's hop 2: the same walk, as row-chunked gathers
    over k2 steps (a stopped row keeps its slot)."""
    n, t_pad = i1.shape
    dev = i1.device
    K1 = 1 << k1
    n1 = K1 - 1
    d_pad = 4 * packed.shape[1]
    lanes = feat2.shape[1]
    f2, t2 = feat2.reshape(-1).long(), thr2.reshape(-1).long()
    trees = torch.arange(t_pad, device=dev)[None, :] * K1
    out = torch.empty_like(i1)
    for lo in range(0, n, _TRAVERSE_CHUNK):
        iv = i1[lo:lo + _TRAVERSE_CHUNK].long()
        pk = packed[lo:lo + _TRAVERSE_CHUNK].long()
        l = (iv - n1).clamp(0, K1 - 1)
        row = (trees + l) * lanes
        m = torch.zeros_like(iv)
        walking = torch.ones_like(iv, dtype=torch.bool)
        for _ in range(k2):
            f = f2[row + m]
            walking &= f >= 0
            fc = f.clamp(0, d_pad - 1)
            b = (pk.gather(1, fc >> 2) >> ((fc & 3) * 8)) & 0xFF
            m = torch.where(walking, 2 * m + 1 + (b > t2[row + m]).long(), m)
        gid = _leaf_ids(m, l, k1, k2)
        out[lo:lo + _TRAVERSE_CHUNK] = torch.where(iv < n1, iv, gid).to(i1.dtype)
    return out


def _packed_payload(leaf: torch.Tensor, values: torch.Tensor, *, n_trees: int, group: int = 8) -> torch.Tensor:
    """Sum over trees of each tree's leaf payload (n, V), in the JAX
    package's association: partial sums of 8 trees in tree order, then
    across groups."""
    leaf = leaf.long()
    acc = None
    for g0 in range(0, n_trees, group):
        part = None
        for t in range(g0, min(g0 + group, n_trees)):
            v = values[t][leaf[:, t]]
            part = v if part is None else part + v
        acc = part if acc is None else acc + part
    return acc


def _forest_launch(packed, t_pad, k1, k2, nodes2, *, nodes1=None, i1=None, values=None) -> torch.Tensor:
    """One K9 launch on CUDA tensors the wrapper checked: ROOT (``nodes1``)
    or I1 (``i1``), SUM (``values``) or LEAF."""
    n, words = packed.shape
    root = i1 is None
    stage, ws, smem = _forest_geometry(words, k1, root)
    if values is None:
        out = torch.empty((n, t_pad), dtype=torch.int32, device=packed.device)
        leaf_out, sum_out, n_trees, M, V = out.data_ptr(), None, 0, 0, 0
    else:
        n_trees, M, V = values.shape
        if _FOREST_GROUP * M * V >= 1 << 31:
            raise ValueError(f"packed_forest_eval: payload {tuple(values.shape)} past 32-bit offsets in a group")
        out = torch.empty((n, V), dtype=torch.float32, device=packed.device)
        leaf_out, sum_out = None, out.data_ptr()
    if (t_pad << k1) * LANES >= 1 << 31:
        raise ValueError(f"packed_forest_eval: hop-2 table of {t_pad << k1} rows past 32-bit offsets")
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    fn = _build.function(
        "rf_traverse", "packed_forest_launch",
        [_P, _INT, _INT, _INT, _INT, _INT, _P, _P, _P, _P, _INT, _INT, _INT, _P, _P, _INT, _INT, _INT, _INT, _P],
    )
    code = fn(packed.data_ptr(), n, words, ws, int(stage), int(root), ptr(nodes1), ptr(i1), nodes2.data_ptr(),
              ptr(values), M, V, n_trees, leaf_out, sum_out, t_pad, k1, k2, smem,
              torch.cuda.current_stream(packed.device).cuda_stream)
    _build.check("rf_traverse", code)
    return out


def packed_traverse(
    packed: torch.Tensor, i1: torch.Tensor, feat2: torch.Tensor, thr2: torch.Tensor, *, k1: int, k2: int
) -> torch.Tensor:
    """Kernel K9 from a given hop 1 (its I1 start, LEAF epilogue): the
    global leaf index (n, T_pad) int32 of every (row, tree), from the rows'
    word-packed bins ``packed`` (n, d_pad/4) int32, their hop-1 heap
    indices ``i1`` (n, T_pad) int32 and the hop-2 tables ``feat2``/``thr2``
    (T_pad·2^k1, 64) int32 of ``pack_forest``. Rows with ``i1 < 2^k1 - 1``
    stopped in hop 1 and keep it. The contract of
    ``spark_rapids_ml_tpu/ops/rf_pallas.py::packed_traverse``, without its
    128-word width limit; the transform path walks from the root
    (``packed_forest_eval``)."""
    n, t_pad = i1.shape
    if packed.shape[0] != n or feat2.shape != thr2.shape or feat2.shape[0] != t_pad << k1:
        raise ValueError(
            f"packed_traverse: packed {tuple(packed.shape)}, i1 {tuple(i1.shape)}, tables "
            f"{tuple(feat2.shape)} / {tuple(thr2.shape)} do not agree at k1={k1}"
        )
    if not 1 <= k2 or (1 << k2) - 1 > feat2.shape[1]:
        raise ValueError(f"packed_traverse: k2={k2} does not fit {feat2.shape[1]} lanes")
    if i1.device.type == "cpu":
        return packed_traverse_plain(packed, i1, feat2, thr2, k1=k1, k2=k2)
    _check_cuda("packed_traverse", (packed, torch.int32), (i1, torch.int32), (feat2, torch.int32),
                (thr2, torch.int32))
    if not 1 <= k1 <= 8 or k2 > 6 or t_pad % _FOREST_GROUP or feat2.shape[1] != LANES:
        raise ValueError(f"packed_traverse: k1={k1}, k2={k2}, {t_pad} trees, {feat2.shape[1]} lanes: the kernel "
                         f"takes k1 <= 8, k2 <= 6, trees padded to a multiple of 8, {LANES} lanes")
    out = _forest_launch(packed, t_pad, k1, k2, forest_nodes(feat2, thr2), i1=i1)
    packed_traverse.launches += 1
    return out


packed_traverse.launches = 0


def packed_forest_eval_plain(packed, nodes1, nodes2, values=None, *, k1: int, k2: int) -> torch.Tensor:
    """Plain version of ``packed_forest_eval``: the node words read back as
    the JAX package's tables, then hop 1 as gathers (``_packed_hop1``), hop
    2 (``packed_traverse_plain``) and the payload sum (``_packed_payload``),
    the route of the JAX package's ``forest_apply_packed`` /
    ``rf_eval_packed``."""
    feat1, thr1 = _node_fields(nodes1)
    i1 = _packed_hop1(packed.view(torch.uint8), feat1, thr1, k1=k1)
    leaf = i1 if k2 == 0 else packed_traverse_plain(packed, i1, *_node_fields(nodes2), k1=k1, k2=k2)
    return leaf if values is None else _packed_payload(leaf, values, n_trees=values.shape[0])


def packed_forest_eval(packed, nodes1, nodes2, values=None, *, k1: int, k2: int) -> torch.Tensor:
    """Kernel K9, the transform's descent in one launch: every (row, tree)
    walked from the root through the hop-1 node words ``nodes1`` (T_pad,
    2^k1 - 1) int32 and the hop-2 node words ``nodes2`` (T_pad·2^k1, 64)
    int32 (``forest_nodes`` of ``pack_forest``'s tables; empty when k2 =
    0), on the rows' word-packed bins ``packed`` (n, d_pad/4) int32.
    Returns the global leaf ids (n, T_pad) int32 when ``values`` is None,
    else the (n, V) f32 sums over the T real trees of ``values`` (T, M, V)
    at each tree's leaf, in the JAX package's association (partial sums of
    8 trees in tree order, then across groups), bit for bit. Replaces
    ``spark_rapids_ml_tpu/ops/rf_pallas.py::packed_traverse`` with its
    caller's hop 1 and payload sum."""
    t_pad, n1 = nodes1.shape
    tensors = [packed, nodes1, nodes2] + ([] if values is None else [values])
    if len({t.device for t in tensors}) > 1:
        raise ValueError(f"packed_forest_eval: tensors on {sorted({str(t.device) for t in tensors})}")
    if 4 * packed.shape[1] > _NODE_FEATURE_MAX + 1:
        raise ValueError(f"packed_forest_eval: rows of {4 * packed.shape[1]} bytes, past a node word's "
                         f"{_NODE_FEATURE_MAX + 1} features")
    if not (1 <= k1 <= 8 and 0 <= k2 <= 6) or n1 != (1 << k1) - 1:
        raise ValueError(f"packed_forest_eval: hop-1 nodes {tuple(nodes1.shape)} at k1={k1}, k2={k2} "
                         "(1 <= k1 <= 8, 0 <= k2 <= 6)")
    if k2 and tuple(nodes2.shape) != (t_pad << k1, LANES):
        raise ValueError(f"packed_forest_eval: hop-2 nodes {tuple(nodes2.shape)} do not fit {t_pad} trees at "
                         f"k1={k1}")
    if values is not None and (values.dim() != 3 or not 1 <= values.shape[0] <= t_pad
                               or values.shape[1] < (2 << (k1 + k2)) - 1):
        raise ValueError(f"packed_forest_eval: values {tuple(values.shape)} must be (T <= {t_pad}, "
                         f">= {(2 << (k1 + k2)) - 1} nodes, V)")
    if packed.device.type == "cpu":
        return packed_forest_eval_plain(packed, nodes1, nodes2, values, k1=k1, k2=k2)
    specs = [(packed, torch.int32), (nodes1, torch.int32), (nodes2, torch.int32)]
    _check_cuda("packed_forest_eval", *specs, *([] if values is None else [(values, torch.float32)]))
    if t_pad % _FOREST_GROUP:
        raise ValueError(f"packed_forest_eval: {t_pad} trees: pack_forest pads to a multiple of 8")
    out = _forest_launch(packed, t_pad, k1, k2, nodes2, nodes1=nodes1, values=values)
    packed_forest_eval.launches += 1
    return out


packed_forest_eval.launches = 0
