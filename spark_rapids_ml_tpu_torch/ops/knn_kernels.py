"""Exact kNN of the port: the fused distance + running top-k pass (kernel
K4, ``csrc/knn_topk.cu``) beside its plain PyTorch version, and a
single-device search (counterpart of ``spark_rapids_ml_tpu/ops/
knn_kernels.py`` and ``knn_pallas.py``).

The JAX package's ``ring_knn`` rotates item shards around a device ring;
on one card there is no ring, and the search is one pass over all items.
Results are ordered by (distance, id), so an exact tie keeps the lower id,
as ``lax.top_k`` does.

On the card K4 forms its scores on the tensor cores in 3xTF32: each
operand value is split into a TF32 ``hi`` and a TF32 ``lo`` (rounded as
:func:`tf32_round`), three TF32 products are accumulated per pair in a
fresh f32 accumulator for each slab of ``K4_SLAB`` features (one stage of
the kernel's ring), and the slabs are folded into the running f32 score
with rounded adds.
:func:`knn_geometry` picks the block rows, stage depth and item splits.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from . import _build
from .linalg import _check_cuda_f32

_I64, _P, _INT, _U32 = ctypes.c_int64, ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32

# the kernel keeps k (score, id) pairs per query row in shared memory
MAX_K = 128
# chunks of the plain version: bound its (queries, items) score tile
_Q_CHUNK = 4096
_I_CHUNK = 32768

# The kernel's arithmetic, read by the wrapper (passed to the kernel) and
# by the tests' model of it. TF32 keeps 10 of f32's 23 mantissa bits; a
# value rounds to nearest, ties away from zero (cvt.rna.tf32.f32's
# rounding) as (bits + TF32_BIAS) & TF32_MASK. A fresh accumulator takes
# K4_SLAB features, one 32-feature stage of the kernel (its BK), before it
# is folded into the running score: the tensor cores' f32 accumulation
# truncates, the fold rounds.
TF32_BIAS = 0x1000
TF32_MASK = 0xFFFFE000
K4_SLAB = 32

# the kernel's tiles (csrc/knn_topk.cu): items a tile, features a stage
_BN = 128
_BK = K4_SLAB
SMEM_PER_BLOCK = 232_448  # an H100 block's shared memory, above 48 KB opt in
MAX_SPLITS = 255  # the merge kernel's lanes hold at most 256 lists
_STAGES = (3, 2)  # stage depths, the deepest that fits first
_WAVES = 2  # split the items until the grid makes about this many waves
_MIN_TILES_PER_SPLIT = 4


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32 as the kernel rounds it (nearest, ties
    away from zero; infinities stay)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    # int32 arithmetic wraps, as the kernel's unsigned arithmetic does
    return ((bits + TF32_BIAS) & (TF32_MASK - 2**32)).view(torch.float32)


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's split of each f32 operand value: ``hi = tf32(x)``,
    ``lo = tf32(x - hi)`` (the difference is exact in f32)."""
    hi = tf32_round(x)
    return hi, tf32_round(x.to(torch.float32) - hi)


class KnnGeometry(NamedTuple):
    """K4's launch: ``bm`` query rows a block (128 or 64), ``stages`` in
    the ring of tensor copies, ``splits`` item ranges of ``tiles_per_split`` tiles
    of 128 items (gridDim.y; > 1 adds the merge launch), ``smem`` bytes of
    shared memory a block and ``blocks`` in the grid."""

    bm: int
    stages: int
    splits: int
    tiles_per_split: int
    smem: int
    blocks: int


def _knn_smem(bm: int, stages: int, k: int) -> int:
    """Shared memory of one K4 block: 1,024 bytes of alignment slack, the
    stage ring (each slot 32 features of the query rows and the items'
    TF32 hi and lo, the tile's csq and ids and a transaction barrier) and
    the (score, id) state."""
    return 1024 + stages * ((bm + 2 * _BN) * _BK * 4 + 2 * _BN * 4 + 8) + bm * k * 8


def _knn_geometry(
    nq: int, ni: int, d: int, k: int, sms: int = 132, blocks_per_sm: int = 1,
    smem_per_block: int = SMEM_PER_BLOCK, splits: int | None = None, stages: int | None = None,
) -> KnnGeometry:
    """K4's grid for ``nq`` queries, ``ni`` items of ``d`` features and k.

    128 rows a block where its state and two stages fit in
    ``smem_per_block``, else 64 (large k); the deepest ring of
    ``_STAGES`` that fits. Query block ``b`` takes rows ``[b·bm, (b+1)·bm)``
    and split ``s`` items ``[s·T·128, (s+1)·T·128)`` (T tiles a split), both
    cut at nq and ni. Where the ``ceil(nq / bm)`` blocks make fewer than
    ``_WAVES`` waves of ``sms × blocks_per_sm`` resident blocks, the items
    are split until they make about that many (at most ``MAX_SPLITS``
    splits, each of at least ``_MIN_TILES_PER_SPLIT`` tiles), so that a
    small query batch still puts a block on every SM. ``splits`` and
    ``stages`` force those choices (the probe's sweeps)."""
    if not 1 <= k <= MAX_K:
        raise NotImplementedError(f"knn_topk_pass: the CUDA kernel takes 1 <= k <= {MAX_K}, got {k}")
    bm = 128 if _knn_smem(128, min(_STAGES), k) <= smem_per_block else 64
    if stages is None:
        stages = next(s for s in _STAGES if _knn_smem(bm, s, k) <= smem_per_block)
    nb = -(-nq // bm)
    tiles = -(-ni // _BN)
    if splits is None:
        resident = sms * blocks_per_sm
        most = max(1, min(MAX_SPLITS, tiles // _MIN_TILES_PER_SPLIT))
        splits = 1 if nb >= _WAVES * resident else min(most, max(1, round(_WAVES * resident / max(nb, 1))))
    splits = max(1, min(splits, MAX_SPLITS, max(tiles, 1)))
    per = max(1, -(-tiles // splits))
    splits = max(1, -(-tiles // per))  # no empty split
    return KnnGeometry(bm, stages, splits, per, _knn_smem(bm, stages, k), nb * splits)


@functools.lru_cache(maxsize=None)
def _knn_attributes(bm: int, k: int, stages: int) -> Tuple[int, int, int, int]:
    """(registers, spill bytes, resident blocks an SM, shared memory) of
    the kernel instance, from the CUDA runtime's occupancy calculator."""
    fn = _build.function("knn_topk", "knn_topk_attributes", [_INT, _INT, _INT, _P])
    out = (ctypes.c_int * 4)()
    _build.check("knn_topk", fn(bm, k, stages, ctypes.addressof(out)))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def knn_geometry(nq: int, ni: int, d: int, k: int) -> KnnGeometry:
    """:func:`_knn_geometry` on the current card: its SM count and the
    kernel's resident blocks an SM."""
    sms = torch.cuda.get_device_properties(torch.cuda.current_device()).multi_processor_count
    g = _knn_geometry(nq, ni, d, k, sms=sms)
    return _knn_geometry(nq, ni, d, k, sms=sms, blocks_per_sm=max(1, _knn_attributes(g.bm, k, g.stages)[2]))


def lexsort_rows(
    d: torch.Tensor, i: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first ``k`` columns of each row of ``(d, i)`` in (d, i) order."""
    o = torch.argsort(i, dim=1, stable=True)
    d, i = d.gather(1, o), i.gather(1, o)
    o = torch.argsort(d, dim=1, stable=True)[:, :k]
    return d.gather(1, o), i.gather(1, o)


def _fold(
    topd: torch.Tensor, topi: torch.Tensor, s: torch.Tensor, ids: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold one (rows, w) score tile with item ids ``ids`` (w,) into the
    running state, exactly in (score, id) order. ``torch.topk`` picks any
    of the entries tied at its k-th value; rows with more such entries
    than it kept are re-selected by a full (score, id) sort."""
    k = topd.shape[1]
    kk = min(k, s.shape[1])
    v, j = torch.topk(s, kk, dim=1, largest=False)
    ci = ids[j]
    amb = ((s <= v[:, -1:]).sum(dim=1) > kk).nonzero()[:, 0]
    if len(amb):
        v[amb], ci[amb] = lexsort_rows(s[amb], ids.expand(len(amb), -1), kk)
    return lexsort_rows(torch.cat([topd, v], 1), torch.cat([topi, ci.to(topi.dtype)], 1), k)


def knn_topk_pass_plain(
    Xq: torch.Tensor,
    Xi: torch.Tensor,
    csq_eff: torch.Tensor,
    ids: torch.Tensor,
    topd: torch.Tensor,
    topi: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K4: chunked ``addmm`` scores ``||xi||² - 2xq·xi``
    and an exact ``torch.topk`` merge; takes and returns the state sorted
    by (score, id). Works in the inputs' dtype (f64 for the on-card
    check)."""
    outd, outi = [], []
    for lo in range(0, Xq.shape[0], _Q_CHUNK):
        xq = Xq[lo : lo + _Q_CHUNK]
        d, i = topd[lo : lo + _Q_CHUNK], topi[lo : lo + _Q_CHUNK]
        for jo in range(0, Xi.shape[0], _I_CHUNK):
            s = torch.addmm(csq_eff[None, jo : jo + _I_CHUNK], xq, Xi[jo : jo + _I_CHUNK].T, alpha=-2.0)
            d, i = _fold(d, i, s, ids[jo : jo + _I_CHUNK])
        outd.append(d)
        outi.append(i)
    return torch.cat(outd), torch.cat(outi)


def _knn_topk_run(
    Xq: torch.Tensor,
    Xi: torch.Tensor,
    csq_eff: torch.Tensor,
    ids: torch.Tensor,
    topd: torch.Tensor,
    topi: torch.Tensor,
    geo: KnnGeometry,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K4 (and, with ``geo.splits > 1``, its merge) with the launch
    ``geo`` on checked card tensors; returns the new state."""
    nq, d = Xq.shape
    ni, k = Xi.shape[0], topd.shape[1]
    outd, outi = torch.empty_like(topd), torch.empty_like(topi)
    part_d = part_i = None
    if geo.splits > 1:
        part_d = torch.empty((geo.splits, nq, k), dtype=torch.float32, device=Xq.device)
        part_i = torch.empty((geo.splits, nq, k), dtype=torch.int32, device=Xq.device)
    # the kernel's tensor copies take rows of whole 16-byte chunks from a
    # 16-byte aligned base: zero features pad d to a multiple of 4 (the
    # scores do not change)
    if d % 4 or Xq.data_ptr() % 16 or Xi.data_ptr() % 16:
        pad = -d % 4
        Xq, Xi = (torch.nn.functional.pad(t, (0, pad)) for t in (Xq, Xi))
        d += pad
    fn = _build.function(
        "knn_topk", "knn_topk_launch",
        [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _INT, _INT, _INT, _INT, _INT, _I64, _U32, _U32,
         _P],
    )
    code = fn(
        Xq.data_ptr(), Xi.data_ptr(), csq_eff.data_ptr(), ids.data_ptr(), topd.data_ptr(), topi.data_ptr(),
        outd.data_ptr(), outi.data_ptr(), 0 if part_d is None else part_d.data_ptr(),
        0 if part_i is None else part_i.data_ptr(), nq, ni, d, k, geo.bm, geo.stages, geo.splits,
        geo.tiles_per_split, TF32_BIAS, TF32_MASK,
        torch.cuda.current_stream(Xq.device).cuda_stream,
    )
    _build.check("knn_topk", code)
    return outd, outi


def knn_topk_pass(
    Xq: torch.Tensor,
    Xi: torch.Tensor,
    csq_eff: torch.Tensor,
    ids: torch.Tensor,
    topd: torch.Tensor,
    topi: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel K4: fold every item of ``Xi`` (ni, d) into the running
    ``(topd, topi)`` (nq, k) state of the queries ``Xq`` (nq, d). Scores
    are ``csq_eff - 2 xq·xi`` with ``csq_eff`` (ni,) = ``||xi||²`` and
    +inf for masked items; ``ids`` (ni,) int32 are the items' global ids.
    The state comes in sorted by (score, id) per row (a fresh (+inf, -1)
    state, or one this function returned) and goes out so; the incoming
    tensors are not changed.

    A CPU tensor goes to :func:`knn_topk_pass_plain`; a CUDA tensor to the
    CUDA kernel (k <= 128; its scores in 3xTF32 on the tensor cores), or
    this raises. Replaces ``spark_rapids_ml_tpu/ops/knn_pallas.py::
    knn_pallas_pass``."""
    if Xq.device.type == "cpu":
        return knn_topk_pass_plain(Xq, Xi, csq_eff, ids, topd, topi)
    _check_cuda_f32("knn_topk_pass", Xq, Xi, csq_eff, topd)
    nq, d = Xq.shape
    ni, k = Xi.shape[0], topd.shape[1]
    if Xi.shape[1] != d or csq_eff.shape != (ni,) or ids.shape != (ni,) or topd.shape != (nq, k) \
            or topi.shape != (nq, k):
        raise ValueError(
            f"knn_topk_pass: shapes Xq {tuple(Xq.shape)}, Xi {tuple(Xi.shape)}, csq "
            f"{tuple(csq_eff.shape)}, ids {tuple(ids.shape)}, state {tuple(topd.shape)} / "
            f"{tuple(topi.shape)} do not agree"
        )
    for t in (ids, topi):
        if t.dtype != torch.int32 or t.device != Xq.device or not t.is_contiguous():
            raise ValueError("knn_topk_pass: ids and topi must be contiguous int32 on the card")
    if not 1 <= k <= MAX_K:
        raise NotImplementedError(f"knn_topk_pass: the CUDA kernel takes 1 <= k <= {MAX_K}, got {k}")
    out = _knn_topk_run(Xq, Xi, csq_eff, ids, topd, topi, knn_geometry(nq, ni, d, k))
    knn_topk_pass.launches += 1
    return out


knn_topk_pass.launches = 0


def knn_search(
    Xq: torch.Tensor, Xi: torch.Tensor, mask: torch.Tensor, ids: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN of ``Xq`` (nq, d) among the rows of ``Xi`` (ni, d) whose
    ``mask`` (ni,) is positive: ``(d2 (nq, k) ascending squared euclidean
    distances, ids (nq, k) int32 global ids from ``ids`` (ni,))``, ordered
    by (distance, id). One K4 pass; unfilled slots (fewer than k valid
    items) hold +inf and id -1. The counterpart of ``ring_knn`` on one
    device."""
    nq, dev = Xq.shape[0], Xq.device
    csq = (Xi * Xi).sum(dim=1).masked_fill(mask <= 0, float("inf"))
    topd = torch.full((nq, k), float("inf"), dtype=Xq.dtype, device=dev)
    topi = torch.full((nq, k), -1, dtype=torch.int32, device=dev)
    topd, topi = knn_topk_pass(Xq, Xi, csq, ids.to(torch.int32), topd, topi)
    # restore the row-constant ||xq||² term
    d2 = torch.clamp(topd + (Xq * Xq).sum(dim=1)[:, None], min=0.0)
    return lexsort_rows(d2, topi, k)
