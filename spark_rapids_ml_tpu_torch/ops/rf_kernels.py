"""RandomForest kernels of the port (counterpart of
``spark_rapids_ml_tpu/ops/rf_pallas.py``): the per-sub-block histogram
(K5), its fused-selection variant (K6) and the packed-forest hop-2
traversal (K9), each a CUDA kernel (``csrc/rf_hist.cu``,
``csrc/rf_traverse.cu``) beside its plain PyTorch version.

A CPU tensor goes to the plain version; a CUDA tensor goes to the kernel,
or the wrapper raises. Each wrapper counts its launches in ``.launches``.

The TPU gates (``rf_hist_pallas_ok``, ``rf_hist_sel_ok``,
``packed_traverse_ok``: lane alignment of ``k·nb``, ``S <= 16``, at most
8,192 histogram lanes or 128 packed words, lowering probes) are not
carried over: the kernels take any sub-block size, row count, width,
``nb <= 256`` and stat count. The builder keeps ``BLOCK_ROWS`` only to size
its padded row counts exactly as the JAX package does, so both packages'
kernels see the same inputs at every level.
"""

from __future__ import annotations

import ctypes

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


def _check_hist_shapes(name: str, rows: int, sw: torch.Tensor, n_bins: int, r_sub: int) -> None:
    if sw.dim() != 2 or sw.shape[0] != rows:
        raise ValueError(f"{name}: sw {tuple(sw.shape)} must be (rows={rows}, S)")
    if r_sub < 1 or rows % r_sub:
        raise ValueError(f"{name}: {rows} rows are not a multiple of r_sub={r_sub}")
    if not 1 <= n_bins <= 256:
        raise ValueError(f"{name}: n_bins={n_bins} outside [1, 256]")


# ---------------------------------------------------------------------------
# K5 / K6: per-sub-block histograms
# ---------------------------------------------------------------------------


def subblock_hist_plain(binq: torch.Tensor, sw: torch.Tensor, *, n_bins: int, r_sub: int) -> torch.Tensor:
    """Plain version of K5: one ``scatter_add_`` on the flattened
    (sub-block, s, slot·nb + bin) index, in ``sw``'s dtype (f64 for the
    on-card check). On the CPU the scatter visits rows in order, so every
    bin is the sequential row-order sum the kernel computes."""
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


def subblock_hist(binq: torch.Tensor, sw: torch.Tensor, *, n_bins: int, r_sub: int) -> torch.Tensor:
    """Kernel K5: per-sub-block histograms (rows // r_sub, S, k·n_bins)
    of ``sw`` (rows, S) over the bins ``binq`` (rows, k) int32, for rows
    sorted by node with every node's run padded to an ``r_sub`` multiple
    (padding rows carry sw == 0). A bin outside [0, n_bins) adds nothing.
    Replaces ``spark_rapids_ml_tpu/ops/rf_pallas.py::subblock_hist``."""
    rows, k = binq.shape
    _check_hist_shapes("subblock_hist", rows, sw, n_bins, r_sub)
    if binq.device.type == "cpu":
        return subblock_hist_plain(binq, sw, n_bins=n_bins, r_sub=r_sub)
    _check_cuda("subblock_hist", (binq, torch.int32), (sw, torch.float32))
    S = sw.shape[1]
    n_sb = rows // r_sub
    out = torch.empty((n_sb, S, k * n_bins), dtype=torch.float32, device=binq.device)
    fn = _build.function(
        "rf_hist", "subblock_hist_launch", [_P, _P, _P, _I64, _INT, _INT, _INT, _INT, _P]
    )
    code = fn(binq.data_ptr(), sw.data_ptr(), out.data_ptr(), n_sb, r_sub, k, n_bins, S,
              torch.cuda.current_stream(binq.device).cuda_stream)
    subblock_hist.launches += 1
    _build.check("rf_hist", code)
    return out


subblock_hist.launches = 0


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
    """Plain version of K6: gather each sub-block's selected columns, then
    K5's plain version."""
    return subblock_hist_plain(select_bins_plain(bq, featsq, r_sub), sw, n_bins=n_bins, r_sub=r_sub)


def subblock_hist_sel(
    bq: torch.Tensor, featsq: torch.Tensor, sw: torch.Tensor, *, n_bins: int, r_sub: int
) -> torch.Tensor:
    """Kernel K6: K5's output, with sub-block j's k columns selected in the
    kernel from the full uint8 rows ``bq`` (rows, d_pad) by the feature ids
    ``featsq`` (rows // r_sub, k) int32. An id outside [0, d_pad) reads as
    bin 0. Replaces ``spark_rapids_ml_tpu/ops/rf_pallas.py::
    subblock_hist_sel``."""
    rows, d_pad = bq.shape
    _check_hist_shapes("subblock_hist_sel", rows, sw, n_bins, r_sub)
    n_sb, k = featsq.shape
    if n_sb * r_sub != rows:
        raise ValueError(f"subblock_hist_sel: featsq {tuple(featsq.shape)} for {rows} rows of r_sub={r_sub}")
    if bq.device.type == "cpu":
        return subblock_hist_sel_plain(bq, featsq, sw, n_bins=n_bins, r_sub=r_sub)
    _check_cuda("subblock_hist_sel", (bq, torch.uint8), (featsq, torch.int32), (sw, torch.float32))
    S = sw.shape[1]
    out = torch.empty((n_sb, S, k * n_bins), dtype=torch.float32, device=bq.device)
    fn = _build.function(
        "rf_hist", "subblock_hist_sel_launch",
        [_P, _P, _P, _P, _I64, _INT, _INT, _INT, _INT, _INT, _P],
    )
    code = fn(bq.data_ptr(), featsq.data_ptr(), sw.data_ptr(), out.data_ptr(), n_sb, r_sub, k,
              n_bins, S, d_pad, torch.cuda.current_stream(bq.device).cuda_stream)
    subblock_hist_sel.launches += 1
    _build.check("rf_hist", code)
    return out


subblock_hist_sel.launches = 0


def subblock_hist_batched(binq: torch.Tensor, sw: torch.Tensor, *, n_bins: int, r_sub: int) -> torch.Tensor:
    """K5 over a tree batch in one launch: ``binq`` (T, n_pad, k), ``sw``
    (T, n_pad, S) -> (T, n_pad // r_sub, S, k·n_bins). n_pad is a multiple
    of r_sub, so every sub-block lies inside one tree."""
    T, n_pad, k = binq.shape
    out = subblock_hist(binq.reshape(T * n_pad, k), sw.reshape(T * n_pad, -1), n_bins=n_bins, r_sub=r_sub)
    return out.reshape(T, n_pad // r_sub, out.shape[1], out.shape[2])


def subblock_hist_sel_batched(
    bq: torch.Tensor, featsq: torch.Tensor, sw: torch.Tensor, *, n_bins: int, r_sub: int
) -> torch.Tensor:
    """K6 over a tree batch in one launch: ``bq`` (T, n_pad, d_pad),
    ``featsq`` (T, n_sb, k), ``sw`` (T, n_pad, S) -> (T, n_sb, S,
    k·n_bins)."""
    T, n_pad, d_pad = bq.shape
    n_sb, k = featsq.shape[1:]
    out = subblock_hist_sel(
        bq.reshape(T * n_pad, d_pad), featsq.reshape(T * n_sb, k), sw.reshape(T * n_pad, -1),
        n_bins=n_bins, r_sub=r_sub,
    )
    return out.reshape(T, n_sb, out.shape[1], out.shape[2])


# ---------------------------------------------------------------------------
# K9: packed-forest hop-2 traversal
# ---------------------------------------------------------------------------


def _leaf_ids(m: torch.Tensor, l: torch.Tensor, k1: int, k2: int) -> torch.Tensor:
    """Global heap index of the leaf at local heap slot ``m`` of level-k1
    subtree ``l``."""
    delta = torch.zeros_like(m)
    for j in range(1, k2 + 1):
        delta += (m + 1 >= (1 << j)).to(m.dtype)
    pd = torch.ones_like(m) << delta
    return ((1 << k1) * pd - 1) + l * pd + (m - (pd - 1))


def packed_traverse_plain(
    packed: torch.Tensor, i1: torch.Tensor, feat2: torch.Tensor, thr2: torch.Tensor, *, k1: int, k2: int
) -> torch.Tensor:
    """Plain version of K9: the same walk, as row-chunked gathers over k2
    steps (a stopped row keeps its slot)."""
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


def packed_traverse(
    packed: torch.Tensor, i1: torch.Tensor, feat2: torch.Tensor, thr2: torch.Tensor, *, k1: int, k2: int
) -> torch.Tensor:
    """Kernel K9: the global leaf index (n, T_pad) int32 of every (row,
    tree), from the rows' word-packed bins ``packed`` (n, d_pad/4) int32,
    their hop-1 heap indices ``i1`` (n, T_pad) int32 and the hop-2 tables
    ``feat2``/``thr2`` (T_pad·2^k1, 64) int32 of ``pack_forest``. Rows
    with ``i1 < 2^k1 - 1`` stopped in hop 1 and keep it. Replaces
    ``spark_rapids_ml_tpu/ops/rf_pallas.py::packed_traverse``, without its
    128-word width limit."""
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
    out = torch.empty_like(i1)
    fn = _build.function(
        "rf_traverse", "packed_traverse_launch",
        [_P, _P, _P, _P, _P, _I64, _INT, _INT, _INT, _INT, _INT, _P],
    )
    code = fn(packed.data_ptr(), i1.data_ptr(), feat2.data_ptr(), thr2.data_ptr(), out.data_ptr(), n,
              packed.shape[1], t_pad, k1, k2, feat2.shape[1],
              torch.cuda.current_stream(i1.device).cuda_stream)
    packed_traverse.launches += 1
    _build.check("rf_traverse", code)
    return out


packed_traverse.launches = 0
