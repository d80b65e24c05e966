"""LogisticRegression kernels of the port (counterpart of
``spark_rapids_ml_tpu/ops/logreg_kernels.py`` and ``logreg_pallas.py``,
single device).

Holds kernel K3, the fused logistic loss and gradient
(``csrc/logreg_loss_grad.cu``), beside its plain PyTorch version, wrapped in
a ``torch.autograd.Function`` whose forward pass also yields the gradient,
so each L-BFGS value-and-gradient costs one read of X (the contract of the
JAX package's custom VJP). ``logreg_fit`` keeps the JAX package's
standardization-as-reparametrization, intercept handling and multinomial
intercept centring.

K3 takes float32. A float64 fit (``float32_inputs=False``) takes
:func:`data_loss_xla` instead, chosen by dtype in
:func:`make_fused_data_loss` before any kernel wrapper is called, as the
JAX package's ``logreg_pallas_ok`` sends f64 to its XLA logits: the masked
log-loss of the logits ``X Aᵀ + b`` in float64, differentiated by autograd.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from . import _build
from .knn_kernels import TF32_BIAS, TF32_MASK
from .lbfgs import minimize_lbfgs
from .linalg import _check_cuda_f32, masked_mean, standardize_moments

_I64, _P = ctypes.c_int64, ctypes.c_void_p

# csrc/logreg_loss_grad.cu limits: rows per tile and the (rows, K) logit
# tile kept in at most 48 KB of shared memory
_LOGREG_TILE_ROWS = 64
_LOGREG_SMEM = 48 * 1024
# cap on the per-block (K, d+1) partials the second pass reduces
_LOGREG_SCRATCH = 256 << 20
# logreg_mrows_kernel: 8 warps a block
_MROWS_WARPS = 8
# logreg_tile_kernel: threads a block; the shared memory one block an SM
# can have on an H100, and each of two (the SM's 233,472 B halved, less
# the 1 KB reserved a block and the kernel's 32 static bytes); the
# gradient items a thread can own (its instances); the rows a tile may take
# (multiples of 8 for the multinomial logits' 8-row blocks, powers of 2 for
# the binomial form's warps per row); ring slots (the source's TILE_STAGES)
_TILE_THREADS = 256
_TILE_SMEM_MAX = 232_448
_TILE_SMEM_TWO = 115_680
_TILE_IPT = {False: (1, 2, 4, 8, 16), True: (1, 2, 4)}
_TILE_BM = {False: (64, 32, 16, 8, 4, 2, 1), True: (64, 56, 48, 40, 32, 24, 16, 8)}
_TILE_STAGES = 2
# the route past the tile kernel's cap (logreg_route_kernel): wgmma N
# sizes (classes a warpgroup; 129-256 classes split over two warpgroups of
# 128, code 3256; 257 to 12,288 classes in tiles of 128, the class-tiled
# instance, code 3900), the depth of a stage, ring depths (the deepest that
# fits first), the cap on R^T's hi and lo (2 K rows floats) that sets the
# rows of a launch pair, and a tile's fixed cost (epilogue, ring fill) in
# stages, for the gradient kernel's row ranges
_ROUTE_BN = (16, 32, 64, 128)
_ROUTE_MAX_K = 256
_ROUTE_TILED = 3900
_ROUTE_TILED_MAX_K = 12_288
_ROUTE_RB = 32
_ROUTE_STAGES = (4, 3, 2)
_ROUTE_SCRATCH = 512 << 20
_ROUTE_TILE_COST = 8
# the cluster kernel (logreg_cluster_kernel: binomial rows past the tile
# kernel's cap, each row's columns split over the CTAs of a thread-block
# cluster, one CTA an SM): launcher code 5000 + its float4 gradient items
# a thread (the source's CL_IPT); cluster sizes (16 is past the portable
# 8), the widest d (16 CTAs of 4,096 chunks), and the ring's slots (the
# source's CL_MAX_STAGES at most, at least 3 so that a row's copy is in
# flight while two are read)
_CLUSTER = 5000
_CLUSTER_IPT = 16
_CLUSTER_SIZES = (2, 4, 8, 16)
_CLUSTER_D_MAX = 4 * _TILE_THREADS * _CLUSTER_IPT * 16
_CLUSTER_STAGES = (3, 8)
# the exchange's slots of partial logits (the source's CL_XSLOTS: two
# rows a CTA may run ahead of its slowest peer)
_CLUSTER_XSLOTS = 6


class TileGeometry(NamedTuple):
    """``logreg_tile_kernel``'s launch: ``items`` (class group, 16-byte
    column chunk) items of the block gradient, the intercept chunk
    included, ``ipt`` of them a thread at most (the instance), ``BM`` rows a
    tile, ``smem`` bytes of shared memory a block,
    ``blocks_per_sm`` resident blocks an SM and ``grid`` blocks (at most
    one a tile)."""

    ipt: int
    items: int
    BM: int
    smem: int
    blocks_per_sm: int
    grid: int


def _tile_smem(d: int, K: int, multinomial: bool, BM: int) -> int:
    """Bytes of shared memory of a tile-kernel block (the source's
    ``tile_smem_floats``): A padded to (KP, DP), b padded to 16 bytes, the
    logits (binomial: and the partial logits of 8 / BM warps a row), and
    ``_TILE_STAGES`` slots of BM rows of DP + 4 floats with their m and y."""
    dp = -(-d // 4) * 4
    kp = -(-K // 4) * 4 if multinomial else 1
    z = BM * kp if multinomial else -(-(BM + max(BM, 8)) // 4) * 4
    return 4 * (kp * dp + -(-kp // 4) * 4 + z + _TILE_STAGES * (BM * (dp + 4) + -(-2 * BM // 4) * 4))


def _tile_rows_score(BM: int, K: int, multinomial: bool) -> float:
    """Rows a tile times the share of the 8 warps' logit rounds that hold
    a (8-row block, 4-class chunk) pair (multinomial; 1 for the binomial
    form, whose BM rows split evenly over the warps)."""
    if not multinomial:
        return float(BM)
    pairs = (BM // 8) * (-(-K // 4))
    return BM * pairs / (8 * -(-pairs // 8))


def _tile_geometry(n: int, d: int, K: int, multinomial: bool, sms: int = 132) -> Optional[TileGeometry]:
    """The tile kernel's launch for ``n`` rows of ``d`` features and ``K``
    classes, or None where the block gradient or the ring does not fit
    (the general kernel takes those). Binomial: two resident blocks an SM
    where a two-slot ring fits twice (one block's barriers then overlap
    the other's work), with the most rows a tile; multinomial (its
    registers allow one block): the best :func:`_tile_rows_score` that
    fits."""
    kg = 4 if multinomial else 1
    kp = -(-K // 4) * 4 if multinomial else 1
    items = (kp // kg) * (-(-d // 4) + 1)
    ipt = next((i for i in _TILE_IPT[multinomial] if i * _TILE_THREADS >= items), None)
    if ipt is None or d < 1 or K < 1:
        return None
    budgets = [(2, _TILE_SMEM_TWO), (1, _TILE_SMEM_MAX)] if not multinomial else [(1, _TILE_SMEM_MAX)]
    for bps, budget in budgets:
        rows = [b for b in _TILE_BM[multinomial] if _tile_smem(d, K, multinomial, b) <= budget]
        if rows:
            bm = max(rows, key=lambda b: (_tile_rows_score(b, K, multinomial), b))
            smem = _tile_smem(d, K, multinomial, bm)
            grid = max(1, min(-(-max(n, 1) // bm), sms * bps))
            return TileGeometry(ipt, items, bm, smem, bps, grid)
    return None


class RouteGeometry(NamedTuple):
    """The route's launch past the tile kernel's cap: ``code`` (3000 +
    BN, BN the wgmma N of a warpgroup; 3256 for 129-256 classes split over
    the two warpgroups; 3900 for the class-tiled instance), ``npt``
    classes a block (a class tile's), ``block_m`` rows (logits kernel) or
    columns (gradient kernel) a block, ``stages`` in the ring, ``smem``
    bytes a block, ``chunk_rows`` rows a launch pair (R^T's scratch holds
    one chunk), and for a full chunk: ``grid_a`` logits blocks,
    ``col_tiles`` x ``class_tiles`` x ``ranges`` gradient tiles of
    ``range_rows`` rows (a multiple of 32) on ``grid_b`` blocks
    (``class_tiles`` is 1 but for the class-tiled instance)."""

    code: int
    npt: int
    block_m: int
    stages: int
    smem: int
    chunk_rows: int
    grid_a: int
    col_tiles: int
    ranges: int
    range_rows: int
    grid_b: int
    class_tiles: int = 1


def _route_code(K: int) -> Optional[int]:
    """The route's instance for K classes: 3000 + the least wgmma N of
    ``_ROUTE_BN`` that holds them, 3256 for 129-256 classes, 3900 (the
    class-tiled instance) for 257 to 12,288, None past that."""
    if K < 2 or K > _ROUTE_TILED_MAX_K:
        return None
    if K > _ROUTE_MAX_K:
        return _ROUTE_TILED
    return 3000 + next((bn for bn in _ROUTE_BN if bn >= K), _ROUTE_MAX_K)


def _route_smem(code: int, stages: int) -> int:
    """Bytes of dynamic shared memory of a route kernel (the source's
    ``route_smem_bytes``): 1,024 bytes of alignment slack, ``stages`` slots
    of the X tile (block_m x 32 floats) and the B operand's hi and lo (npt
    x 32 floats each) with a barrier each, the 8 warps' intercept sums (BN
    floats each; two buffers of them in the class-tiled instance), the
    split's exchange (512 floats) and the warps' losses."""
    bn = 128 if code in (3256, _ROUTE_TILED) else code - 3000
    bm, npt = (64, 256) if code == 3256 else (128, bn)
    sums = 16 * bn if code == _ROUTE_TILED else 8 * bn
    return 1024 + stages * ((bm + 2 * npt) * _ROUTE_RB * 4 + 8) + 4 * (sums + 512 + 8)


@functools.lru_cache(maxsize=None)
def _route_ranges(rows: int, col_tiles: int, sms: int) -> Tuple[int, int]:
    """(ranges, range_rows) of the gradient kernel over ``rows`` rows: the
    split into row ranges of whole 32-row stages whose waves of
    ``col_tiles`` x ranges tiles on ``sms`` blocks cost the least, each
    tile counted as its stages plus ``_ROUTE_TILE_COST``; the fewest
    ranges on ties."""
    stages = max(1, -(-rows // _ROUTE_RB))
    best = None
    for r in range(1, min(stages, 4 * sms) + 1):
        per = -(-stages // r)
        cost = -(-(col_tiles * r) // sms) * (per + _ROUTE_TILE_COST)
        if best is None or cost < best[0]:
            best = (cost, per)
    range_rows = best[1] * _ROUTE_RB
    return -(-max(rows, 1) // range_rows), range_rows


def _route_geometry(n: int, d: int, K: int, sms: int = 132) -> Optional[RouteGeometry]:
    """The route's launch for ``n`` rows, ``d`` features and ``K``
    classes (None past 12,288 classes): the deepest ring of
    ``_ROUTE_STAGES`` that fits one block an SM, chunks of rows whose R^T
    hi and lo fit ``_ROUTE_SCRATCH`` bytes (a multiple of 128 rows), one
    logits block an SM at most, and the gradient kernel's column tiles,
    class tiles and row ranges for a full chunk."""
    code = _route_code(K)
    if code is None or d < 1:
        return None
    split = code == 3256
    bm, npt = (64, 256) if split else (128, 128 if code == _ROUTE_TILED else code - 3000)
    class_tiles = -(-K // npt) if code == _ROUTE_TILED else 1
    stages = next(s for s in _ROUTE_STAGES if _route_smem(code, s) <= _TILE_SMEM_MAX)
    chunk = min(max(n, 1), max(128, _ROUTE_SCRATCH // (8 * npt * class_tiles) // 128 * 128))
    col_tiles = -(-d // bm)
    ranges, range_rows = _route_ranges(chunk, col_tiles * class_tiles, sms)
    return RouteGeometry(code, npt, bm, stages, _route_smem(code, stages), chunk,
                         min(-(-chunk // bm), sms), col_tiles, ranges, range_rows,
                         min(col_tiles * class_tiles * ranges, sms), class_tiles)


def _route_chunks(n: int, geo: RouteGeometry, sms: int = 132) -> List[Tuple[int, int, int, int, int, int]]:
    """The launch pairs of the route over ``n`` rows: (first row, rows,
    grid_a, ranges, range_rows, grid_b) for each chunk of
    ``geo.chunk_rows`` rows; a shorter last chunk gets its own grids and
    ranges."""
    out = []
    tiles = geo.col_tiles * geo.class_tiles
    for r0 in range(0, max(n, 1), geo.chunk_rows):
        rows = min(geo.chunk_rows, max(n, 1) - r0)
        if rows == geo.chunk_rows:
            out.append((r0, rows, geo.grid_a, geo.ranges, geo.range_rows, geo.grid_b))
            continue
        ranges, range_rows = _route_ranges(rows, tiles, sms)
        out.append((r0, rows, min(-(-rows // geo.block_m), sms), ranges, range_rows,
                    min(tiles * ranges, sms)))
    return out


class ClusterGeometry(NamedTuple):
    """``logreg_cluster_kernel``'s launch: ``C`` CTAs a cluster, each
    owning ``W`` 16-byte chunks of every row (rank r the columns [4 W r,
    4 W (r + 1))), ``stages`` ring slots of one row slice, ``smem`` bytes
    of shared memory a CTA (one CTA an SM), and ``clusters`` clusters (at
    most one a row; the wrapper also caps them at what the card holds at
    once)."""

    C: int
    W: int
    stages: int
    smem: int
    clusters: int


def _cluster_smem(W: int, stages: int) -> int:
    """Bytes of shared memory of a cluster-kernel CTA (the source's
    ``cluster_smem_bytes``): ``stages`` slots of a row slice of 4 (W + 1)
    floats (a rank's slice and room to stage it off 16-byte alignment),
    the exchange's ``_CLUSTER_XSLOTS`` slots of 16 ranks' partials, the 8
    warps' partials and the residual (two row parities each), and a
    barrier a ring slot and an exchange slot."""
    return stages * (W + 1) * 16 + 4 * (16 * _CLUSTER_XSLOTS + 2 * 8 + 2) + 8 * (stages + _CLUSTER_XSLOTS)


def _cluster_geometry(n: int, d: int, sms: int = 132, C: Optional[int] = None) -> Optional[ClusterGeometry]:
    """The cluster kernel's launch for ``n`` binomial rows of ``d``
    features: the least cluster size of ``_CLUSTER_SIZES`` (or ``C``) whose
    slice of ceil(d / 4) chunks a rank's 256 threads hold in
    ``_CLUSTER_IPT`` float4 gradient registers each, and the most ring
    slots that fit one CTA an SM. None past ``_CLUSTER_D_MAX``."""
    if d < 1:
        return None
    chunks = -(-d // 4)
    for c in (C,) if C else _CLUSTER_SIZES:
        w = -(-chunks // c)
        if w > _CLUSTER_IPT * _TILE_THREADS:
            continue
        lo, hi = _CLUSTER_STAGES
        stages = max(s for s in range(lo, hi + 1) if _cluster_smem(w, s) <= _TILE_SMEM_MAX)
        return ClusterGeometry(c, w, stages, _cluster_smem(w, stages), max(1, min(n, sms // c)))
    return None


def _k3_variant(d: int, K: int, multinomial: bool, aligned: bool = True) -> int:
    """Which kernel of ``csrc/logreg_loss_grad.cu`` takes a (d, K) pass, as
    the launcher's code: ``10·NV + 1`` for the binomial row-per-warp kernel
    (K = 1, d ≤ 1024, NV ∈ {1, 2, 4, 8} float4 chunks a lane), ``100·NV +
    K`` for the multinomial register-row kernel (2 ≤ K ≤ 16, d ≤ 256,
    NV ∈ {1, 2}), ``1000 + IPT`` (binomial) or ``2000 + IPT``
    (multinomial) for the tile kernel with IPT gradient items a thread,
    where :func:`_tile_geometry` fits, the route's :func:`_route_code`
    (3000 + BN, 3256, or 3900 for the class-tiled instance past 256
    classes) for every other multinomial shape with 2 ≤ K ≤ 12,288,
    5016 for the cluster kernel (binomial 16,380 < d ≤ 262,144,
    :func:`_cluster_geometry`), and 0 for the general kernel (binomial
    d > 262,144; past 12,288 classes the wrapper raises). The first two
    need d a multiple of 4 and 16-byte aligned X and A (``aligned``); the
    tile kernel, the route and the cluster kernel take any."""
    if d < 1:
        return 0
    if aligned and d % 4 == 0:
        nv = -(-d // 128)
        if K == 1 and d <= 1024:
            return 10 * (1 if nv <= 1 else 2 if nv <= 2 else 4 if nv <= 4 else 8) + 1
        if multinomial and 2 <= K <= 16 and d <= 256:
            return 100 * nv + K
    geo = _tile_geometry(1, d, K, multinomial)
    if geo is not None:
        return (2000 if multinomial else 1000) + geo.ipt
    if multinomial and _route_code(K) is not None:
        return _route_code(K)
    if K == 1 and not multinomial and _cluster_geometry(1, d) is not None:
        return _CLUSTER + _CLUSTER_IPT
    return 0


def logreg_loss_grad_plain(
    X: torch.Tensor, y: torch.Tensor, m: torch.Tensor,
    A: torch.Tensor, b: torch.Tensor, multinomial: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K3: ``(Σ m·logloss, gA (K, d), gb (K,))`` with
    logits ``X Aᵀ + b`` and residuals ``R = (p - onehot(y))·m``."""
    z = X @ A.T + b[None, :]
    if multinomial:
        yi = y.to(torch.int64)
        lse = torch.logsumexp(z, dim=1)
        onehot = torch.nn.functional.one_hot(yi, z.shape[1]).to(z.dtype)
        ll = lse - (z * onehot).sum(dim=1)
        R = (torch.softmax(z, dim=1) - onehot) * m[:, None]
    else:
        z1 = z[:, 0]
        ll = torch.nn.functional.softplus(z1) - y * z1
        R = ((torch.sigmoid(z1) - y) * m)[:, None]
    return (ll * m).sum(), R.T @ X, R.sum(dim=0)


def logreg_loss_grad(
    X: torch.Tensor, y: torch.Tensor, m: torch.Tensor,
    A: torch.Tensor, b: torch.Tensor, multinomial: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel K3: loss, ``gA`` and ``gb`` of the masked logistic data term
    in one pass over ``X`` (n, d); ``A`` (K, d), ``b`` (K,), K = 1 for the
    binomial (sigmoid) form.

    A CPU tensor goes to :func:`logreg_loss_grad_plain`; a CUDA tensor to
    the CUDA kernel, or this raises (bf16 X included: not ported yet; more
    than ``_ROUTE_TILED_MAX_K`` classes).
    Replaces ``spark_rapids_ml_tpu/ops/logreg_pallas.py::_loss_grad_pallas``."""
    if X.device.type == "cpu":
        return logreg_loss_grad_plain(X, y, m, A, b, multinomial)
    if A.shape[0] > _ROUTE_TILED_MAX_K:
        raise ValueError(f"logreg_loss_grad: K = {A.shape[0]} classes exceed the kernels' {_ROUTE_TILED_MAX_K:,}")
    variant = _k3_variant(X.shape[1], A.shape[0], multinomial,
                          X.data_ptr() % 16 == 0 and A.data_ptr() % 16 == 0)
    out = _logreg_run(X, y, m, A, b, multinomial, variant)
    logreg_loss_grad.launches += 1
    logreg_loss_grad.variants[variant] = logreg_loss_grad.variants.get(variant, 0) + 1
    return out


def _logreg_run(
    X: torch.Tensor, y: torch.Tensor, m: torch.Tensor,
    A: torch.Tensor, b: torch.Tensor, multinomial: bool, variant: int,
    knock: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch K3 on card tensors: the kernel ``variant`` names (the tile
    kernel or the route at its routed geometry), then the second pass.
    ``knock`` is a probe's bit mask (1: the first kernel alone (the route:
    its two kernels), 2: the second pass alone, 4 and 8: the general
    kernel's gradient stage without its X re-read or its per-tile partial
    write, 16: the route's logits kernel alone, 32: the class-tiled
    instance's tiles merged without rescaling the sum, a negative
    control; the cluster kernel: 4, its gradient stage without its reads
    of the staged rows, 64: its cluster exchange knocked out, 128: the
    last rank's partial left out of every logit, a negative control); any
    bit makes the result wrong."""
    _check_cuda_f32("logreg_loss_grad", X, y, m, A, b)
    n, d = X.shape
    K = A.shape[0]
    if y.shape != (n,) or m.shape != (n,) or A.shape[1] != d or b.shape != (K,):
        raise ValueError(
            f"logreg_loss_grad: shapes X {tuple(X.shape)}, y {tuple(y.shape)}, "
            f"m {tuple(m.shape)}, A {tuple(A.shape)}, b {tuple(b.shape)} do not agree"
        )
    if not multinomial and K != 1:
        raise ValueError("logreg_loss_grad: the binomial form takes K = 1")
    if variant >= _CLUSTER:
        if multinomial:
            raise ValueError(f"logreg_loss_grad: the cluster kernel {variant} takes the binomial form only")
        return _cluster_run(X, y, m, A, b, variant, knock)
    if variant >= 3000:
        if not multinomial or _route_code(K) != variant:
            raise ValueError(f"logreg_loss_grad: the route {variant} does not take K = {K}")
        return _route_run(X, y, m, A, b, knock)
    rt = min(_LOGREG_TILE_ROWS, _LOGREG_SMEM // (4 * K))
    if rt < 1:
        raise ValueError(
            f"logreg_loss_grad: K = {K} classes exceed the kernel's logit tile"
        )
    dev = X.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per_block = K * (d + 1)
    rows = 0
    geo = TileGeometry(0, 0, 0, 0, 0, 0)
    if variant >= 1000:  # one resident block per SM walks the row tiles
        geo = _tile_geometry(n, d, K, multinomial, sms)
        if geo is None or variant % 1000 != geo.ipt or variant // 1000 != 1 + multinomial:
            raise ValueError(f"logreg_loss_grad: the tile kernel {variant} does not take d = {d}, K = {K}")
        nblocks = geo.grid
    elif variant >= 100:  # one resident block per SM walks the row groups
        groups = -(-max(n, 1) // (4 if K <= 8 else 2))  # rows a group
        nblocks = max(1, min(-(-groups // _MROWS_WARPS), sms))
    elif variant:
        nblocks = max(1, min(-(-max(n, 1) // 16), 4 * sms))
    else:
        nblocks = max(1, min(-(-max(n, 1) // rt), 8 * sms, _LOGREG_SCRATCH // (4 * per_block)))
        rows = -(-max(n, 1) // nblocks)
        nblocks = -(-max(n, 1) // rows)
    gA = torch.empty((K, d), dtype=torch.float32, device=dev)
    gb = torch.empty((K,), dtype=torch.float32, device=dev)
    loss = torch.empty((1,), dtype=torch.float32, device=dev)
    part = torch.empty((nblocks, per_block), dtype=torch.float32, device=dev)
    loss_part = torch.empty((nblocks,), dtype=torch.float32, device=dev)
    fn = _build.function(
        "logreg_loss_grad", "logreg_loss_grad_launch",
        [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, _I64, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, _P],
    )
    vec = int(d % 4 == 0 and X.data_ptr() % 16 == 0)
    code = fn(
        X.data_ptr(), y.data_ptr(), m.data_ptr(), A.data_ptr(), b.data_ptr(),
        gA.data_ptr(), gb.data_ptr(), loss.data_ptr(), part.data_ptr(),
        loss_part.data_ptr(), n, d, K, int(multinomial), rt, nblocks, rows, variant,
        geo.BM, vec, geo.smem, knock, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check("logreg_loss_grad", code)
    return loss[0], gA, gb


def _route_run(
    X: torch.Tensor, y: torch.Tensor, m: torch.Tensor, A: torch.Tensor, b: torch.Tensor, knock: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The route past the tile kernel's cap on checked card tensors: for
    each chunk of rows the logits kernel (A's TF32 split first, once) and
    the gradient kernel, then the fixed-order second pass over every
    chunk's partials (the class-tiled instance: over its ranges' partials,
    which every chunk adds to)."""
    n, d = X.shape
    K = A.shape[0]
    dev = X.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    geo = _route_geometry(n, d, K, sms)
    chunks = _route_chunks(n, geo, sms)
    tiled = geo.code == _ROUTE_TILED
    da, nr = -(-d // 4) * 4, -(-geo.chunk_rows // 4) * 4
    ops = torch.empty((2, K, da), dtype=torch.float32, device=dev)  # A's hi and lo
    rt = torch.empty((2, K, nr), dtype=torch.float32, device=dev)  # R^T's hi and lo
    if tiled:  # the ranges' partials, added to by every chunk in turn; each logits block's raw logits
        part = torch.zeros((max(c[3] for c in chunks), K * (d + 1)), dtype=torch.float32, device=dev)
        zs = torch.empty((geo.grid_a * geo.class_tiles * geo.npt // 2 * 256,), dtype=torch.float32, device=dev)
    else:
        part = torch.empty((sum(c[3] for c in chunks), K * (d + 1)), dtype=torch.float32, device=dev)
        zs = None
    side = torch.empty((sum(c[2] for c in chunks), K + 1), dtype=torch.float32, device=dev)
    gA = torch.empty((K, d), dtype=torch.float32, device=dev)
    gb = torch.empty((K,), dtype=torch.float32, device=dev)
    loss = torch.empty((1,), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if not knock & 2:
        fn = _build.function(
            "logreg_loss_grad", "logreg_route_launch",
            [_P] * 12 + [ctypes.c_int] * 14 + [ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int, _P],
        )
        p0 = s0 = 0
        for i, (r0, rows, grid_a, ranges, range_rows, grid_b) in enumerate(chunks):
            Xc = X[r0:r0 + rows]
            code = fn(
                Xc.data_ptr(), y[r0:].data_ptr(), m[r0:].data_ptr(), A.data_ptr(), b.data_ptr(),
                ops[0].data_ptr(), ops[1].data_ptr(), rt[0].data_ptr(), rt[1].data_ptr(),
                part[p0:].data_ptr(), side[s0:].data_ptr(), zs.data_ptr() if tiled else None, rows, d, K,
                geo.code, geo.stages, grid_a, geo.col_tiles, ranges, range_rows, grid_b, da, nr, int(i == 0),
                int(d % 4 == 0 and Xc.data_ptr() % 16 == 0), TF32_BIAS, TF32_MASK, knock, stream,
            )
            _build.check("logreg_loss_grad", code)
            p0, s0 = p0 + (0 if tiled else ranges), s0 + grid_a
    if not knock & 1:
        fn = _build.function("logreg_loss_grad", "logreg_route_reduce",
                             [_P, ctypes.c_int, _P, ctypes.c_int, _P, _P, _P, ctypes.c_int, ctypes.c_int, _P])
        _build.check("logreg_loss_grad", fn(part.data_ptr(), part.shape[0], side.data_ptr(), side.shape[0],
                                            gA.data_ptr(), gb.data_ptr(), loss.data_ptr(), d, K, stream))
    return loss[0], gA, gb


@functools.lru_cache(maxsize=None)
def _cluster_active(device: int, vec: bool, C: int, smem: int) -> int:
    """The most clusters of ``C`` CTAs of the cluster kernel's instance
    ``vec`` at ``smem`` bytes each that card ``device`` holds at once
    (``cudaOccupancyMaxActiveClusters``); raises where it is 0."""
    fn = _build.function("logreg_loss_grad", "logreg_cluster_occupancy",
                         [ctypes.c_int, ctypes.c_int, ctypes.c_int, _P])
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        _build.check("logreg_loss_grad", fn(int(vec), C, smem, ctypes.addressof(out)))
    if out.value < 1:
        raise RuntimeError(f"logreg_loss_grad: no cluster of {C} CTAs with {smem:,} B of shared memory "
                           "each can be resident on this card")
    return out.value


def _cluster_run(
    X: torch.Tensor, y: torch.Tensor, m: torch.Tensor, A: torch.Tensor, b: torch.Tensor, variant: int,
    knock: int = 0, geo: Optional[ClusterGeometry] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The cluster kernel on checked card tensors at ``geo`` (by default
    :func:`_cluster_geometry`'s; ``variant`` must be its code), on
    as many clusters as it plans and the card holds at once, then the
    fixed-order second pass over one partial a cluster. A launch the card
    refuses raises."""
    n, d = X.shape
    dev = X.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    geo = geo or _cluster_geometry(n, d, sms)
    if geo is None or variant != _CLUSTER + _CLUSTER_IPT:
        raise ValueError(f"logreg_loss_grad: the cluster kernel {variant} does not take d = {d}")
    vec = d % 4 == 0 and X.data_ptr() % 16 == 0
    clusters = min(geo.clusters, _cluster_active(dev.index or 0, vec, geo.C, geo.smem))
    gA = torch.empty((1, d), dtype=torch.float32, device=dev)
    gb = torch.empty((1,), dtype=torch.float32, device=dev)
    loss = torch.empty((1,), dtype=torch.float32, device=dev)
    part = torch.empty((clusters, d + 1), dtype=torch.float32, device=dev)
    loss_part = torch.empty((clusters,), dtype=torch.float32, device=dev)
    fn = _build.function(
        "logreg_loss_grad", "logreg_cluster_launch",
        [_P] * 10 + [_I64] + [ctypes.c_int] * 8 + [_P],
    )
    _build.check("logreg_loss_grad", fn(
        X.data_ptr(), y.data_ptr(), m.data_ptr(), A.data_ptr(), b.data_ptr(), gA.data_ptr(), gb.data_ptr(),
        loss.data_ptr(), part.data_ptr(), loss_part.data_ptr(), n, d, geo.C, geo.W, geo.stages, geo.smem,
        clusters, int(vec), knock,
        torch.cuda.current_stream(dev).cuda_stream,
    ))
    return loss[0], gA, gb


def _logreg_attributes(variant: int, smem: int = 0) -> Tuple[int, int, int, int]:
    """(registers, spill bytes, resident blocks an SM, shared memory) of
    K3's kernel ``variant`` (0: the general kernel, 1000 + IPT and 2000 +
    IPT: the tile kernel's instances, 3000 + BN, 3256 and 3900: the
    route's logits kernel, 4000 + BN, 4256 and 4900: its gradient kernel,
    5016 and 5116: the cluster kernel's instances on the bulk copies alone
    and off 16-byte alignment, -1: the second pass) at
    ``smem`` bytes of dynamic shared memory, from
    the CUDA runtime's occupancy calculator."""
    fn = _build.function("logreg_loss_grad", "logreg_attributes", [ctypes.c_int, ctypes.c_int, _P])
    out = (ctypes.c_int * 4)()
    _build.check("logreg_loss_grad", fn(variant, smem, ctypes.addressof(out)))
    return tuple(out)


logreg_loss_grad.launches = 0
logreg_loss_grad.variants = {}  # launches by launcher code (_k3_variant)


class _FusedDataLoss(torch.autograd.Function):
    """``Σ m·logloss`` as a function of ``(Aeff, beff)`` whose forward pass
    also computes the gradient (one data pass); backward scales it."""

    @staticmethod
    def forward(ctx, Aeff, beff, X, y, m, multinomial):  # type: ignore[override]
        loss, gA, gb = logreg_loss_grad(
            X, y, m, Aeff.contiguous(), beff.contiguous(), multinomial
        )
        ctx.save_for_backward(gA, gb)
        return loss

    @staticmethod
    def backward(ctx, g):  # type: ignore[override]
        gA, gb = ctx.saved_tensors
        return g * gA, g * gb, None, None, None, None


def logreg_kernel_ok(dtype: torch.dtype) -> bool:
    """True where K3 takes a data pass of this dtype: float32 only (the JAX
    package's ``logreg_pallas_ok`` gate on dtype; bf16 operands are not
    ported)."""
    return dtype == torch.float32


def data_loss_xla(
    X: torch.Tensor, y: torch.Tensor, mask: torch.Tensor, multinomial: bool
) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """``f(Aeff, beff) -> Σ m·logloss`` in ``X``'s dtype, outside any kernel,
    its gradient by autograd: the counterpart of the JAX package's
    ``smooth_loss`` where no Pallas loss is fused (softplus for the
    binomial form, logsumexp less the label's logit for the multinomial
    one). The route of float64 fits, on the CPU and the card."""
    yi = y.to(torch.int64)[:, None] if multinomial else None

    def f(Aeff: torch.Tensor, beff: torch.Tensor) -> torch.Tensor:
        logits = X @ Aeff.T + beff[None, :]
        if multinomial:
            ll = torch.logsumexp(logits, dim=1) - torch.gather(logits, 1, yi)[:, 0]
        else:
            z = logits[:, 0]
            ll = torch.nn.functional.softplus(z) - y * z
        return (ll * mask).sum()

    return f


def logreg_loss_grad_xla(
    X: torch.Tensor, y: torch.Tensor, m: torch.Tensor,
    A: torch.Tensor, b: torch.Tensor, multinomial: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3's contract ``(Σ m·logloss, gA, gb)`` from :func:`data_loss_xla` and
    autograd, in ``X``'s dtype: the float64 fold of a streamed chunk."""
    Av, bv = A.detach().requires_grad_(True), b.detach().requires_grad_(True)
    with torch.enable_grad():
        loss = data_loss_xla(X, y, m, multinomial)(Av, bv)
        gA, gb = torch.autograd.grad(loss, (Av, bv))
    return loss.detach(), gA, gb


def make_fused_data_loss(
    X: torch.Tensor, y: torch.Tensor, mask: torch.Tensor, multinomial: bool
) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """``f(Aeff, beff) -> Σ m·logloss`` whose value and gradient cost one
    data pass (kernel K3 on the card, its plain version on the CPU); for
    float64 ``X`` the autograd route :func:`data_loss_xla`."""
    if not logreg_kernel_ok(X.dtype):
        return data_loss_xla(X, y, mask, multinomial)

    def f(Aeff: torch.Tensor, beff: torch.Tensor) -> torch.Tensor:
        return _FusedDataLoss.apply(Aeff, beff, X, y, mask, multinomial)

    return f


def logreg_fit(
    X: torch.Tensor,
    mask: torch.Tensor,
    y: torch.Tensor,
    *,
    n_classes: int,
    multinomial: bool,
    fit_intercept: bool,
    standardization: bool,
    l1: float,
    l2: float,
    use_l1: bool,
    max_iter: int,
    tol: float,
    history: int = 10,
    objective_dtype: str = "float32",
) -> Dict[str, object]:
    """Fit logistic regression; returns ``coef_`` (K, d), ``intercept_``
    (K,), ``n_iter``, ``objective``. K = 1 for the binomial (sigmoid)
    form, else ``n_classes``.

    Spark objective ``(1/n)·Σ logloss + λ[(1−α)/2‖β‖₂² + α‖β‖₁]`` on the
    standardized coefficients, never on intercepts. Standardization is a
    reparametrization: the solver works in standardized-coefficient space
    and the affine map folds into the logits (``to_original``), so X is
    never copied. The fit runs in ``X``'s dtype: float64 ``X`` takes the
    autograd objective and an L-BFGS in float64."""
    if objective_dtype != "float32":
        raise NotImplementedError(
            f"objective_dtype={objective_dtype!r}: only float32 is ported"
        )
    dtype = X.dtype
    d = X.shape[1]
    n = mask.sum()
    yf = y.to(dtype)

    if standardization:
        mean, std, _ = standardize_moments(X, mask, ddof=1)
        inv_std = torch.where(std > 0, 1.0 / std, torch.ones_like(std))
    else:
        mean, _ = masked_mean(X, mask)
        inv_std = torch.ones((d,), dtype=dtype, device=X.device)
    # the reference skips centering when fit_intercept=False
    use_center = standardization and fit_intercept

    K = n_classes if multinomial else 1
    n_coef = K * d
    p = n_coef + (K if fit_intercept else 0)

    def unpack(wflat: torch.Tensor):
        A = wflat[:n_coef].reshape(K, d)
        b = wflat[n_coef:] if fit_intercept else torch.zeros((K,), dtype=dtype, device=X.device)
        return A, b

    def to_original(A: torch.Tensor, b: torch.Tensor):
        Aeff = A * inv_std[None, :]
        beff = b - (Aeff @ mean) if use_center else b
        return Aeff, beff

    coef_mask = torch.cat([
        torch.ones((n_coef,), dtype=dtype, device=X.device),
        torch.zeros((p - n_coef,), dtype=dtype, device=X.device),
    ])
    fused_data = make_fused_data_loss(X, yf, mask, multinomial)

    def smooth_loss(wflat: torch.Tensor) -> torch.Tensor:
        A, b = unpack(wflat)
        Aeff, beff = to_original(A, b)
        data_loss = fused_data(Aeff, beff) / n
        coefs = wflat * coef_mask  # penalty never touches intercepts
        return data_loss + 0.5 * l2 * torch.dot(coefs, coefs)

    w0 = torch.zeros((p,), dtype=dtype, device=X.device)
    res = minimize_lbfgs(
        smooth_loss,
        w0,
        max_iter=max_iter,
        tol=tol,
        l1_weights=l1 * coef_mask if use_l1 else None,
        history=history,
    )
    A, b = unpack(res.w)
    coef, intercept = to_original(A, b)
    if fit_intercept and K > 1:
        # Spark centers multinomial intercepts
        intercept = intercept - intercept.mean()
    return {
        "coef_": coef,
        "intercept_": intercept,
        "n_iter": res.n_iter,
        "objective": res.f,
    }


def logreg_predict(
    Xb: torch.Tensor, coef: torch.Tensor, intercept: torch.Tensor, *, multinomial: bool
):
    """Batch inference -> (prediction, probability, rawPrediction); the
    binomial rawPrediction follows Spark's [-m, m] convention."""
    return logreg_link(Xb @ coef.T + intercept[None, :], multinomial=multinomial)


def logreg_link(scores: torch.Tensor, *, multinomial: bool):
    """(prediction, probability, rawPrediction) of scores whose last axis
    is the classes' (one class, the binomial margin, where not
    multinomial): (n, K) for one model, (n, m, K) for m stacked ones."""
    if multinomial:
        raw = scores
        prob = torch.softmax(scores, dim=-1)
        pred = torch.argmax(scores, dim=-1).to(scores.dtype)
    else:
        z = scores[..., 0]
        raw = torch.stack([-z, z], dim=-1)
        p1 = torch.sigmoid(z)
        prob = torch.stack([1.0 - p1, p1], dim=-1)
        pred = (p1 > 0.5).to(scores.dtype)
    return pred, prob, raw
