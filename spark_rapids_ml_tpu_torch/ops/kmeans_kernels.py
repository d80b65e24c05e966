"""KMeans kernels of the port: Lloyd iterations and k-means|| support
(counterpart of ``spark_rapids_ml_tpu/ops/kmeans_kernels.py`` and
``kmeans_pallas.py``, single device).

Holds kernel K2, the fused Lloyd step (``csrc/lloyd_step.cu``), beside its
plain PyTorch version. The JAX package's ``lax.while_loop`` becomes a
Python loop over device tensors with one host read of the centre shift per
iteration.

On the card K2 forms its scores on the tensor cores in 3xTF32, as K4 does
(``knn_kernels``): the centres are split once a launch into TF32 ``hi`` and
``lo`` (rounded as :func:`~.knn_kernels.tf32_round`), the rows per stage,
three TF32 products are accumulated per pair in a fresh f32 accumulator
for each slab of ``K2_SLAB`` features, and the slabs are folded into the
running f32 score with rounded adds. :func:`lloyd_geometry` picks its
stage depth and persistent grid.

K2 takes float32. A float64 fit (``float32_inputs=False``) takes
:func:`chunk_stats_xla` instead, chosen by dtype in :func:`chunk_stats`
before any kernel wrapper is called, as the JAX package's
``kmeans_pallas_ok`` sends f64 to the XLA branch of ``_chunk_stats``.

``matmul_dtype=bfloat16`` (KMeans' ``matmul_dtype`` option) is the Pallas
kernel's bf16 contract: the rows and centres rounded to bf16 feed the
score product with f32 accumulation, and the row weight rounded to bf16
times the bf16 rows feeds the sums; the norms, scores, cost and counts
stay f32. On the card K2's bf16 instance runs it (``wgmma`` bf16
products); its plain version rounds with ``.to(torch.bfloat16)`` and
multiplies in f32 (a product of two bf16 values is exact in f32). A final
cost pass always runs in f32, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from ..runtime import telemetry
from . import _build
from .knn_kernels import SMEM_PER_BLOCK, TF32_BIAS, TF32_MASK
from .linalg import _check_cuda_f32, bf16_round

_I64, _P, _INT, _U32 = ctypes.c_int64, ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32

# the kernel's tiles (csrc/lloyd_step.cu): rows a row block, centres a
# tile, features a stage (one fresh accumulator: the slab); and the warps
# that walk a row block's rows, each writing one cost partial
_LLOYD_ROWS = 128
_LLOYD_CENTRES = 128
K2_SLAB = 32
_WALK_WARPS = 3
_STAGES = (4, 3, 2)  # stage depths, the deepest that fits first
# rows per chunk of the plain version: bounds its (rows, k) score block
_PLAIN_CHUNK = 65_536
# distances a row block of the float64 route holds (the seeding's
# min-distance passes block the same way)
_XLA_BLOCK = 1 << 25


def is_bf16(matmul_dtype: Optional[torch.dtype]) -> bool:
    """True for the bf16 matmul option ``torch.bfloat16``, False for None
    (the f32 contract); the estimator resolves its string option to one of
    the two (``KMeans._resolve_matmul_dtype``), and anything else raises."""
    if matmul_dtype is not None and matmul_dtype is not torch.bfloat16:
        raise ValueError(f"matmul_dtype must be None or torch.bfloat16, got {matmul_dtype!r}")
    return matmul_dtype is not None


def pairwise_sq_dists(
    x: torch.Tensor, centers: torch.Tensor, c_sq: Optional[torch.Tensor] = None,
    matmul_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """(rows, k) squared euclidean distances ``||x||² - 2 x·c + ||c||²``,
    clamped at 0 — the distance of seeding, transform and predict.
    ``matmul_dtype`` bf16 rounds the product's operands to bf16 (the norms
    stay unrounded), as the JAX function's option does."""
    if c_sq is None:
        c_sq = (centers * centers).sum(dim=1)
    x_sq = (x * x).sum(dim=1)
    if is_bf16(matmul_dtype):
        x, centers = bf16_round(x), bf16_round(centers)
    d2 = x_sq[:, None] - 2.0 * (x @ centers.T) + c_sq[None, :]
    return torch.clamp(d2, min=0.0)


def lloyd_step_plain(
    X: torch.Tensor, m: torch.Tensor, C: torch.Tensor, chunk: int = _PLAIN_CHUNK,
    matmul_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K2, chunked over rows: ``(sums (k, d), counts
    int32 (k,), cost ())``, scoring by ``||c||² - 2 x·c`` (first index on
    ties, ``||x||²`` in the cost only) as the Pallas kernel does. With
    ``matmul_dtype`` bf16 the two products take bf16-rounded rows, centres
    and weights, multiplied in ``X``'s dtype (never a bf16 ``matmul``,
    which returns bf16 on the CPU); ``||c||²``, ``||x||²`` and the cost's
    weight stay unrounded."""
    k, d = C.shape
    bf = is_bf16(matmul_dtype)
    c_sq = (C * C).sum(dim=1)
    Cm = bf16_round(C) if bf else C
    sums = torch.zeros((k, d), dtype=X.dtype, device=X.device)
    counts = torch.zeros((k,), dtype=torch.int64, device=X.device)
    cost = torch.zeros((), dtype=X.dtype, device=X.device)
    for lo in range(0, X.shape[0], chunk):
        x, mm = X[lo : lo + chunk], m[lo : lo + chunk]
        xm = bf16_round(x) if bf else x
        part = c_sq[None, :] - 2.0 * (xm @ Cm.T)
        best, a = torch.min(part, dim=1)  # first index of the minimum
        x_sq = (x * x).sum(dim=1)
        cost = cost + (torch.clamp(best + x_sq, min=0.0) * mm).sum()
        counts += torch.bincount(a[mm > 0], minlength=k)
        sums.index_add_(0, a, xm * (bf16_round(mm) if bf else mm)[:, None])
    return sums, counts.to(torch.int32), cost


class LloydGeometry(NamedTuple):
    """K2's launch: ``stages`` in the ring of tensor copies, ``grid``
    persistent blocks (block b walks row blocks b, b + grid, ...), ``smem``
    bytes of shared memory a block, ``row_blocks`` of 128 rows, and the
    scratch: ``split_floats`` for each of the centres' hi and lo,
    ``csq_floats`` of ||c||² padded to whole tiles and ``cost_floats`` of
    per-warp cost partials."""

    stages: int
    grid: int
    smem: int
    row_blocks: int
    split_floats: int
    csq_floats: int
    cost_floats: int


def _lloyd_smem(stages: int) -> int:
    """Shared memory of one K2 block: 1,024 bytes of alignment slack, the
    stage ring (each slot 32 features of the 128 rows and of the centre
    tile's TF32 hi and lo, and a transaction barrier) and the two buffers of
    (best, arg) pairs handed to the walking warps."""
    return 1024 + stages * ((_LLOYD_ROWS + 2 * _LLOYD_CENTRES) * K2_SLAB * 4 + 8) + 2 * _LLOYD_ROWS * 8


def _lloyd_geometry(
    n: int, k: int, d: int, sms: int = 132, blocks_per_sm: int = 1,
    smem_per_block: int = SMEM_PER_BLOCK, stages: int | None = None,
) -> LloydGeometry:
    """K2's launch for ``n`` rows, ``k`` centres and ``d`` features (a
    multiple of 4, as the wrapper pads it): the deepest ring of ``_STAGES``
    that fits ``smem_per_block`` (``stages`` forces one), and one block for
    each resident slot of the card, at most one a row block. Raises where
    no ring fits."""
    if stages is None:
        stages = next((s for s in _STAGES if _lloyd_smem(s) <= smem_per_block), min(_STAGES))
    smem = _lloyd_smem(stages)
    if smem > smem_per_block:
        raise NotImplementedError(f"lloyd_step: {smem} bytes of shared memory a block, above {smem_per_block}")
    row_blocks = -(-n // _LLOYD_ROWS)
    grid = max(1, min(row_blocks, sms * blocks_per_sm))
    tiles = -(-k // _LLOYD_CENTRES)
    return LloydGeometry(stages, grid, smem, row_blocks, k * d, tiles * _LLOYD_CENTRES,
                         max(1, row_blocks * _WALK_WARPS))


@functools.lru_cache(maxsize=None)
def _lloyd_attributes(stages: int, bf16: bool = False) -> Tuple[int, int, int, int]:
    """(registers, spill bytes, resident blocks an SM, shared memory) of
    the kernel with ``stages`` slots (``bf16``: its bf16 instance), from
    the CUDA runtime's occupancy calculator."""
    fn = _build.function("lloyd_step", "lloyd_step_attributes", [_INT, _INT, _P])
    out = (ctypes.c_int * 4)()
    _build.check("lloyd_step", fn(stages, int(bf16), ctypes.addressof(out)))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def lloyd_geometry(n: int, k: int, d: int) -> LloydGeometry:
    """:func:`_lloyd_geometry` on the current card: its SM count and the
    kernel's resident blocks an SM."""
    sms = torch.cuda.get_device_properties(torch.cuda.current_device()).multi_processor_count
    g = _lloyd_geometry(n, k, d, sms=sms)
    return _lloyd_geometry(n, k, d, sms=sms, blocks_per_sm=max(1, _lloyd_attributes(g.stages)[2]))


def lloyd_operands(X: torch.Tensor, C: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(X, C)`` as the kernel takes them: the tensor copies and the
    vector atomics take rows of whole 16-byte chunks from 16-byte aligned
    bases, so where d % 4 != 0 both, and where only a base is not aligned
    that operand, get zero features up to a multiple of 4 in aligned copies (the scores do not
    change; the extra columns of the sums are dropped). An aligned operand
    of whole chunks is passed as it is."""
    pad = -X.shape[1] % 4
    return tuple(t if not pad and t.data_ptr() % 16 == 0 else torch.nn.functional.pad(t, (0, pad)) for t in (X, C))


def _lloyd_run(
    X: torch.Tensor, m: torch.Tensor, C: torch.Tensor, geo: LloydGeometry | None = None,
    matmul_dtype: Optional[torch.dtype] = None, knock: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch K2 (the centres' split, the Lloyd pass and the cost's
    reduce) on checked card tensors with the launch ``geo`` (the routed one
    when None); with ``matmul_dtype`` bf16 its bf16 instance (the centres
    rounded into a bf16 (k, d8) scratch instead of split), whose ``knock``
    1 makes the sums take the unrounded weight (a negative control: the
    result is then wrong)."""
    n, d = X.shape
    k = C.shape[0]
    dev = X.device
    c_sq = (C * C).sum(dim=1)
    Xk, Ck = lloyd_operands(X, C)
    dk = Xk.shape[1]
    if geo is None:
        geo = lloyd_geometry(n, k, dk)
    sums = torch.empty((k, dk), dtype=torch.float32, device=dev)
    counts = torch.empty((k,), dtype=torch.int32, device=dev)
    cost = torch.empty((1,), dtype=torch.float32, device=dev)
    csq_pad = torch.empty((geo.csq_floats,), dtype=torch.float32, device=dev)
    cost_part = torch.empty((geo.cost_floats,), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if is_bf16(matmul_dtype):
        cb = torch.empty((k, -(-dk // 8) * 8), dtype=torch.bfloat16, device=dev)
        fn = _build.function(
            "lloyd_step", "lloyd_step_bf16_launch",
            [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _INT, _INT, _INT, _INT, _INT, _P],
        )
        code = fn(
            Xk.data_ptr(), m.data_ptr(), Ck.data_ptr(), c_sq.data_ptr(), cb.data_ptr(), csq_pad.data_ptr(),
            sums.data_ptr(), counts.data_ptr(), cost.data_ptr(), cost_part.data_ptr(),
            n, dk, k, geo.stages, geo.grid, knock, stream,
        )
        _build.check("lloyd_step", code)
        return (sums if dk == d else sums[:, :d].contiguous()), counts, cost[0]
    split = torch.empty((2, geo.split_floats), dtype=torch.float32, device=dev)
    fn = _build.function(
        "lloyd_step", "lloyd_step_launch",
        [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _INT, _INT, _INT, _INT, _U32, _U32, _P],
    )
    code = fn(
        Xk.data_ptr(), m.data_ptr(), Ck.data_ptr(), c_sq.data_ptr(), split[0].data_ptr(), split[1].data_ptr(),
        csq_pad.data_ptr(), sums.data_ptr(), counts.data_ptr(), cost.data_ptr(), cost_part.data_ptr(),
        n, dk, k, geo.stages, geo.grid, TF32_BIAS, TF32_MASK, stream,
    )
    _build.check("lloyd_step", code)
    return (sums if dk == d else sums[:, :d].contiguous()), counts, cost[0]


def lloyd_step(
    X: torch.Tensor, m: torch.Tensor, C: torch.Tensor, matmul_dtype: Optional[torch.dtype] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel K2: one Lloyd accumulation pass over the rows of ``X``
    (n, d) with row weights ``m`` against centres ``C`` (k, d); returns
    ``(sums (k, d) f32, counts (k,) int32, cost () f32)``. ``matmul_dtype``
    bf16: the Pallas kernel's bf16 contract (f32 ``X`` and ``C``, rounded
    inside).

    A CPU tensor goes to :func:`lloyd_step_plain`; a CUDA tensor to the
    CUDA kernel (its scores in 3xTF32 on the tensor cores; the bf16
    contract in its bf16 instance), or this raises.
    Replaces ``spark_rapids_ml_tpu/ops/kmeans_pallas.py::lloyd_step_pallas``."""
    bf = is_bf16(matmul_dtype)
    if X.device.type == "cpu":
        return lloyd_step_plain(X, m, C, matmul_dtype=matmul_dtype)
    _check_cuda_f32("lloyd_step", X, m, C)
    n, d = X.shape
    k = C.shape[0]
    if m.shape != (n,) or C.shape[1] != d or k < 1:
        raise ValueError(
            f"lloyd_step: shapes X {tuple(X.shape)}, m {tuple(m.shape)}, "
            f"C {tuple(C.shape)} do not agree"
        )
    out = _lloyd_run(X, m, C, matmul_dtype=matmul_dtype)
    lloyd_step.launches += 1
    lloyd_step.bf16_launches += int(bf)
    return out


lloyd_step.launches = 0
lloyd_step.bf16_launches = 0  # of them, the bf16 instance's


def lloyd_kernel_ok(dtype: torch.dtype) -> bool:
    """True where K2 takes a Lloyd pass of this dtype: float32 only (the JAX
    package's ``kmeans_pallas_ok`` gate on dtype)."""
    return dtype == torch.float32


def chunk_stats_xla(
    X: torch.Tensor, m: torch.Tensor, C: torch.Tensor, matmul_dtype: Optional[torch.dtype] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2's contract in ``X``'s dtype, outside any kernel: the counterpart
    of the XLA branch of the JAX package's ``_chunk_stats``: distances
    ``max(||x||² - 2x·c + ||c||², 0)``, the first index of the minimum, the
    weighted sums (``index_add_`` for the one-hot product), int32 counts and
    the cost ``Σ m·min d²``, in row blocks of at most ``_XLA_BLOCK``
    distances. The route of float64 fits, on the CPU and the card. With
    ``matmul_dtype`` bf16 both products take bf16-rounded operands (rows,
    centres, the weight), multiplied in ``X``'s dtype, as the XLA branch's
    ``pairwise_sq_dists`` and ``stats_dot`` do."""
    k, d = C.shape
    bf = is_bf16(matmul_dtype)
    c_sq = (C * C).sum(dim=1)
    sums = torch.zeros((k, d), dtype=X.dtype, device=X.device)
    counts = torch.zeros((k,), dtype=torch.int64, device=X.device)
    cost = torch.zeros((), dtype=X.dtype, device=X.device)
    rows = max(1, _XLA_BLOCK // max(1, k))
    for lo in range(0, X.shape[0], rows):
        x, mm = X[lo : lo + rows], m[lo : lo + rows]
        best, a = torch.min(pairwise_sq_dists(x, C, c_sq, matmul_dtype), dim=1)
        sums.index_add_(0, a, bf16_round(x) * bf16_round(mm)[:, None] if bf else x * mm[:, None])
        cost = cost + (best * mm).sum()
        counts += torch.bincount(a[mm > 0], minlength=k)
    return sums, counts.to(torch.int32), cost


def chunk_stats(
    X: torch.Tensor, m: torch.Tensor, C: torch.Tensor, matmul_dtype: Optional[torch.dtype] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One Lloyd accumulation pass ``(sums, counts, cost)`` (the JAX
    package's ``_chunk_stats``): kernel K2 for float32 rows, the XLA
    branch's counterpart (:func:`chunk_stats_xla`) for float64, either
    under ``matmul_dtype``."""
    if lloyd_kernel_ok(X.dtype):
        return lloyd_step(X, m, C, matmul_dtype=matmul_dtype)
    return chunk_stats_xla(X, m, C, matmul_dtype=matmul_dtype)


def kmeans_lloyd(
    X: torch.Tensor,
    mask: torch.Tensor,
    centers0: torch.Tensor,
    *,
    max_iter: int,
    tol: float,
    shifts: Optional[list] = None,
    matmul_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, float, int]:
    """Lloyd to convergence: ``(centers, cost, n_iters)``.

    Runs until ``max_iter`` or until the largest squared centre shift is
    ``<= tol²`` (each iteration's appended to ``shifts`` where given); an
    empty cluster keeps its centre (Spark behaviour); a final cost pass at
    the converged centres follows the loop. Each pass over the rows is one
    :func:`chunk_stats`: a launch of kernel K2 (the JAX package's
    ``_chunk_stats`` at its Pallas branch), or its float64 route, each
    iteration's under ``matmul_dtype``; the final cost pass always in f32
    (the bf16 distance expansion cancels near the centres, as the JAX
    package notes)."""
    centers = centers0
    shift = float("inf")
    it = 0
    while it < max_iter and shift > tol * tol:
        # a span a pass, as the streamed Lloyd opens (the JAX package's
        # resident Lloyd is one compiled loop, with none)
        with telemetry.span("kmeans.lloyd_pass", iteration=it) as p_span:
            sums, counts, _ = chunk_stats(X, mask, centers, matmul_dtype=matmul_dtype)
            p_span.fence(sums)
        countsf = counts.to(sums.dtype)
        safe = torch.clamp(countsf, min=1.0)
        new_centers = torch.where(counts[:, None] > 0, sums / safe[:, None], centers)
        shift = float(((new_centers - centers) ** 2).sum(dim=1).max())
        if shifts is not None:
            shifts.append(shift)
        centers = new_centers
        it += 1
    with telemetry.span("kmeans.lloyd_pass", iteration=None) as p_span:
        _, _, cost = chunk_stats(X, mask, centers)
        p_span.fence(cost)
    return centers, float(cost), it


def min_sq_dists(
    X: torch.Tensor, mask: torch.Tensor, centers: torch.Tensor, *, csize: int
) -> torch.Tensor:
    """Per-row min squared distance to any centre (padding rows -> 0),
    scanned in ``csize`` row chunks: unchunked, 12M rows against ~4k
    k-means|| candidates would be a ~200 GB distance matrix."""
    c_sq = (centers * centers).sum(dim=1)
    out = torch.empty((X.shape[0],), dtype=X.dtype, device=X.device)
    for lo in range(0, X.shape[0], csize):
        out[lo : lo + csize] = pairwise_sq_dists(X[lo : lo + csize], centers, c_sq).min(dim=1).values
    return out * mask


def count_closest(X: torch.Tensor, mask: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """How many rows are closest to each centre — k-means|| candidate
    weights (kernel K2 at k = the candidate count, or its float64 route)."""
    _, counts, _ = chunk_stats(X, mask, centers)
    return counts
