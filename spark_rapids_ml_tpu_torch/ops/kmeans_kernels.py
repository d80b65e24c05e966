"""KMeans kernels of the port: Lloyd iterations and k-means|| support
(counterpart of ``spark_rapids_ml_tpu/ops/kmeans_kernels.py`` and
``kmeans_pallas.py``, single device).

Holds kernel K2, the fused Lloyd step (``csrc/lloyd_step.cu``), beside its
plain PyTorch version. The JAX package's ``lax.while_loop`` becomes a
Python loop over device tensors with one host read of the centre shift per
iteration.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build
from .linalg import _check_cuda_f32

_I64, _P = ctypes.c_int64, ctypes.c_void_p

# rows per block of csrc/lloyd_step.cu
_LLOYD_ROWS = 128
# rows per chunk of the plain version: bounds its (rows, k) score block
_PLAIN_CHUNK = 65_536


def pairwise_sq_dists(
    x: torch.Tensor, centers: torch.Tensor, c_sq: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """(rows, k) squared euclidean distances ``||x||² - 2 x·c + ||c||²``,
    clamped at 0 — the distance of seeding, transform and predict."""
    if c_sq is None:
        c_sq = (centers * centers).sum(dim=1)
    x_sq = (x * x).sum(dim=1)
    d2 = x_sq[:, None] - 2.0 * (x @ centers.T) + c_sq[None, :]
    return torch.clamp(d2, min=0.0)


def lloyd_step_plain(
    X: torch.Tensor, m: torch.Tensor, C: torch.Tensor, chunk: int = _PLAIN_CHUNK
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K2, chunked over rows: ``(sums (k, d), counts
    int32 (k,), cost ())``, scoring by ``||c||² - 2 x·c`` (first index on
    ties, ``||x||²`` in the cost only) as the Pallas kernel does."""
    k, d = C.shape
    c_sq = (C * C).sum(dim=1)
    sums = torch.zeros((k, d), dtype=X.dtype, device=X.device)
    counts = torch.zeros((k,), dtype=torch.int64, device=X.device)
    cost = torch.zeros((), dtype=X.dtype, device=X.device)
    for lo in range(0, X.shape[0], chunk):
        x, mm = X[lo : lo + chunk], m[lo : lo + chunk]
        part = c_sq[None, :] - 2.0 * (x @ C.T)
        best, a = torch.min(part, dim=1)  # first index of the minimum
        x_sq = (x * x).sum(dim=1)
        cost = cost + (torch.clamp(best + x_sq, min=0.0) * mm).sum()
        counts += torch.bincount(a[mm > 0], minlength=k)
        sums.index_add_(0, a, x * mm[:, None])
    return sums, counts.to(torch.int32), cost


def lloyd_step(
    X: torch.Tensor, m: torch.Tensor, C: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel K2: one Lloyd accumulation pass over the rows of ``X``
    (n, d) with row weights ``m`` against centres ``C`` (k, d); returns
    ``(sums (k, d) f32, counts (k,) int32, cost () f32)``.

    A CPU tensor goes to :func:`lloyd_step_plain`; a CUDA tensor to the
    CUDA kernel, or this raises. Replaces
    ``spark_rapids_ml_tpu/ops/kmeans_pallas.py::lloyd_step_pallas``."""
    if X.device.type == "cpu":
        return lloyd_step_plain(X, m, C)
    _check_cuda_f32("lloyd_step", X, m, C)
    n, d = X.shape
    k = C.shape[0]
    if m.shape != (n,) or C.shape[1] != d or k < 1:
        raise ValueError(
            f"lloyd_step: shapes X {tuple(X.shape)}, m {tuple(m.shape)}, "
            f"C {tuple(C.shape)} do not agree"
        )
    dev = X.device
    c_sq = (C * C).sum(dim=1)
    sums = torch.empty((k, d), dtype=torch.float32, device=dev)
    counts = torch.empty((k,), dtype=torch.int32, device=dev)
    cost = torch.empty((1,), dtype=torch.float32, device=dev)
    cost_part = torch.empty((max(1, -(-n // _LLOYD_ROWS)),), dtype=torch.float32, device=dev)
    fn = _build.function(
        "lloyd_step", "lloyd_step_launch",
        [_P, _P, _P, _P, _P, _P, _P, _P, _I64, ctypes.c_int, ctypes.c_int, _P],
    )
    code = fn(
        X.data_ptr(), m.data_ptr(), C.data_ptr(), c_sq.data_ptr(),
        sums.data_ptr(), counts.data_ptr(), cost.data_ptr(), cost_part.data_ptr(),
        n, d, k, torch.cuda.current_stream(dev).cuda_stream,
    )
    lloyd_step.launches += 1
    _build.check("lloyd_step", code)
    return sums, counts, cost[0]


lloyd_step.launches = 0


def kmeans_lloyd(
    X: torch.Tensor,
    mask: torch.Tensor,
    centers0: torch.Tensor,
    *,
    max_iter: int,
    tol: float,
) -> Tuple[torch.Tensor, float, int]:
    """Lloyd to convergence: ``(centers, cost, n_iters)``.

    Runs until ``max_iter`` or until the largest squared centre shift is
    ``<= tol²``; an empty cluster keeps its centre (Spark behaviour); a
    final f32 cost pass at the converged centres follows the loop. Each
    pass over the rows is one launch of kernel K2 (the JAX package's
    ``_chunk_stats`` at its Pallas branch)."""
    centers = centers0
    shift = float("inf")
    it = 0
    while it < max_iter and shift > tol * tol:
        sums, counts, _ = lloyd_step(X, mask, centers)
        countsf = counts.to(sums.dtype)
        safe = torch.clamp(countsf, min=1.0)
        new_centers = torch.where(counts[:, None] > 0, sums / safe[:, None], centers)
        shift = float(((new_centers - centers) ** 2).sum(dim=1).max())
        centers = new_centers
        it += 1
    _, _, cost = lloyd_step(X, mask, centers)
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
    weights (kernel K2 at k = the candidate count)."""
    _, counts, _ = lloyd_step(X, mask, centers)
    return counts
