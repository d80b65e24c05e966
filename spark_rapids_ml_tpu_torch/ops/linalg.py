"""Dense linear algebra of the port (counterpart of
``spark_rapids_ml_tpu/ops/linalg.py``, single device).

Holds kernel K1, the shifted Gram pass (``csrc/shifted_gram.cu``), beside
its plain PyTorch version, and the covariance / eigendecomposition glue
around it. The mean estimate, the shift and the exact rank-1 re-centre
follow the JAX package step for step, so at ``num_workers=1`` both
packages shift by the same μ̂.

K1 takes float32. A float64 fit (``float32_inputs=False``) takes
:func:`shifted_gram_scan` instead, chosen by dtype at the call site
(:func:`gram_kernel_ok`), as the JAX package's ``_pallas_gram_ok`` sends
f64 to its scan branch: on the card a float64 product through cuBLAS.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import _build

_I64, _P = ctypes.c_int64, ctypes.c_void_p

# K1 geometry, mirrored from csrc/shifted_gram.cu
_GRAM_TILE = 128
_GRAM_STAGE = 16
# block waves the row splits make: a diagonal tile does 3/4 of an
# off-diagonal tile's work, so one wave leaves SMs idle at its tail and
# many let the block scheduler even the load out (16: within ~1% of 32 at
# 12M x 256, half the partials)
_GRAM_WAVES = 16
# rows a split may hold: the kernel counts them in 32 bits
_GRAM_SPLIT_ROWS_MAX = 1 << 30


# rows per chunk of the moment passes: XLA fuses the JAX package's
# elementwise forms, eager PyTorch would materialize (n, d) temporaries
_MOMENT_CHUNK = 1 << 20


def masked_mean(X: torch.Tensor, mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(column means, valid count) under a row-validity mask, in row chunks."""
    n = mask.sum()
    s = sum(
        mask[lo : lo + _MOMENT_CHUNK] @ X[lo : lo + _MOMENT_CHUNK]
        for lo in range(0, X.shape[0], _MOMENT_CHUNK)
    )
    return s / n, n


def mean_and_cov(X: torch.Tensor, mask: torch.Tensor):
    """Column mean and sample covariance (n-1 normalized), centred before
    the Gram (the one-pass form cancels in f32 when |μ| >> σ)."""
    mean, n = masked_mean(X, mask)
    Xc = (X - mean[None, :]) * mask[:, None]
    cov = (Xc.T @ Xc) / (n - 1.0)
    return mean, cov, n


def shifted_gram_plain(
    X: torch.Tensor, m: torch.Tensor, mu: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1: ``(Σ m²·(x-μ̂)(x-μ̂)ᵀ, Σ m·(x-μ̂))``."""
    xs = (X - mu[None, :]) * m[:, None]
    return xs.T @ xs, xs.sum(dim=0)


def _gram_geometry(n: int, d: int, sms: int, blocks_per_sm: int) -> Tuple[int, int, int, int]:
    """K1's grid: ``(T, n_up, nsplit, rows_per_split)``.

    ``T`` column tiles of ``_GRAM_TILE``, ``n_up = T(T+1)/2`` upper-triangle
    output tiles, and ``nsplit`` row splits of ``rows_per_split`` rows (a
    multiple of the stage, at most ``_GRAM_SPLIT_ROWS_MAX``): split ``i``
    takes rows ``[i·rows, (i+1)·rows)`` cut at ``n``, so every row falls in
    exactly one split. The ``n_up × nsplit`` blocks make about
    ``_GRAM_WAVES`` waves of ``sms × blocks_per_sm`` resident blocks when
    there are rows enough. The partial buffers are ``(nsplit, n_up, TILE,
    TILE)`` and ``(nsplit, n_up, TILE)`` (the diagonal tiles' column sums)."""
    T = -(-d // _GRAM_TILE)
    n_up = T * (T + 1) // 2
    rows_total = max(n, 1)
    want = -(-_GRAM_WAVES * sms * blocks_per_sm // n_up)
    nsplit = max(1, min(-(-rows_total // _GRAM_STAGE), want), -(-rows_total // _GRAM_SPLIT_ROWS_MAX))
    rows = -(-rows_total // nsplit)
    rows = -(-rows // _GRAM_STAGE) * _GRAM_STAGE
    return T, n_up, -(-rows_total // rows), rows


@functools.lru_cache(maxsize=None)
def _gram_blocks_per_sm() -> int:
    """Resident K1 blocks per SM, from the CUDA occupancy calculator (the
    kernel asks for 2; fewer if its build came out otherwise)."""
    fn = _build.function("shifted_gram", "shifted_gram_blocks_per_sm", [_P])
    out = ctypes.c_int(0)
    _build.check("shifted_gram", fn(ctypes.byref(out)))
    return max(1, out.value)


def shifted_gram(
    X: torch.Tensor, m: torch.Tensor, mu: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel K1: one pass over the rows of ``X`` (n, d) with row scales
    ``m`` (n,) and shift ``mu`` (d,); returns ``(G, s)`` in f32 with
    ``G = Σ m²·(x-μ̂)(x-μ̂)ᵀ`` (d, d) and ``s = Σ m·(x-μ̂)`` (d,): each row
    is scaled by ``m`` before the product. For a 0/1 mask ``m² = m``; row
    weights ``w`` enter as ``m = √w`` (LinearRegression), and then ``s``
    is ``Σ √w·(x-μ̂)``, not the weighted sum.

    A CPU tensor goes to :func:`shifted_gram_plain`; a CUDA tensor to the
    CUDA kernel, or this raises. Replaces
    ``spark_rapids_ml_tpu/ops/linalg.py::_shifted_gram_pallas``."""
    if X.device.type == "cpu":
        return shifted_gram_plain(X, m, mu)
    _check_cuda_f32("shifted_gram", X, m, mu)
    n, d = X.shape
    if m.shape != (n,) or mu.shape != (d,):
        raise ValueError(
            f"shifted_gram: shapes X {tuple(X.shape)}, m {tuple(m.shape)}, "
            f"mu {tuple(mu.shape)} do not agree"
        )
    sms = torch.cuda.get_device_properties(X.device).multi_processor_count
    T, n_up, nsplit, rows = _gram_geometry(n, d, sms, _gram_blocks_per_sm())
    G = torch.empty((d, d), dtype=torch.float32, device=X.device)
    s = torch.empty((d,), dtype=torch.float32, device=X.device)
    part_G = torch.empty((nsplit, n_up, _GRAM_TILE, _GRAM_TILE), dtype=torch.float32, device=X.device)
    part_s = torch.empty((nsplit, n_up, _GRAM_TILE), dtype=torch.float32, device=X.device)
    # float4 loads need whole float4s in every row and a 16-byte aligned base
    vec = d % 4 == 0 and X.data_ptr() % 16 == 0
    fn = _build.function(
        "shifted_gram", "shifted_gram_launch",
        [_P, _P, _P, _P, _P, _P, _P, _I64, ctypes.c_int, ctypes.c_int, _I64, ctypes.c_int, _P],
    )
    code = fn(
        X.data_ptr(), m.data_ptr(), mu.data_ptr(), G.data_ptr(), s.data_ptr(),
        part_G.data_ptr(), part_s.data_ptr(), n, d, nsplit, rows, int(vec),
        torch.cuda.current_stream(X.device).cuda_stream,
    )
    shifted_gram.launches += 1
    _build.check("shifted_gram", code)
    return G, s


shifted_gram.launches = 0


def gram_kernel_ok(dtype: torch.dtype) -> bool:
    """True where K1 takes a Gram pass of this dtype: float32 only (the JAX
    package's ``_pallas_gram_ok`` gate on dtype). Callers route float64 to
    :func:`shifted_gram_scan` before any wrapper is called."""
    return dtype == torch.float32


def shifted_gram_scan(
    X: torch.Tensor, m: torch.Tensor, mu: torch.Tensor, rows: int = _MOMENT_CHUNK
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's contract in ``X``'s dtype, outside any kernel: the counterpart
    of the scan branch of the JAX package's ``mean_and_cov_chunked``
    (``xs = (x - μ̂)·m`` a chunk of ``rows`` rows, ``G += xsᵀxs``,
    ``s += Σ xs``). The route of float64 fits, on the CPU and the card."""
    d = X.shape[1]
    G = torch.zeros((d, d), dtype=X.dtype, device=X.device)
    s = torch.zeros((d,), dtype=X.dtype, device=X.device)
    for lo in range(0, X.shape[0], rows):
        xs = (X[lo : lo + rows] - mu[None, :]) * m[lo : lo + rows, None]
        G += xs.T @ xs
        s += xs.sum(dim=0)
    return G, s


def _check_cuda_f32(name: str, *tensors: torch.Tensor) -> None:
    """The kernels' common argument contract: f32, contiguous, one CUDA
    device. Anything else raises — there is no fallback on the card."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: expected a CPU or CUDA tensor, got {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != torch.float32:
            raise NotImplementedError(
                f"{name}: the CUDA kernel takes float32, got {t.dtype}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def mean_and_cov_chunked(
    X: torch.Tensor, mask: torch.Tensor, csize: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`mean_and_cov` in one pass over X (the JAX function at
    ``mp_blocks=False`` on one device).

    The mean is estimated from ``csize`` rows strided across all rows
    (``e = min(csize, n)``, ``stride = max(1, n // e)``), the pass
    accumulates the Gram and row sum shifted by that estimate (kernel K1),
    and an exact rank-1 correction re-centres: with ``δ = mean - μ̂`` small
    the correction does not cancel. Rows must be padded to a ``csize``
    multiple (:func:`parallel.mesh.shard_rows`), as in the JAX package.
    Float64 rows take :func:`shifted_gram_scan` in ``csize`` chunks."""
    N = X.shape[0]
    e = min(csize, N)
    stride = max(1, N // e)
    x0, m0 = X[::stride][:e], mask[::stride][:e]
    s0 = (x0 * m0[:, None]).sum(dim=0)
    c0 = m0.sum()
    mean_hat = (s0 / torch.clamp(c0, min=1.0)).contiguous()
    if gram_kernel_ok(X.dtype):
        G, s = shifted_gram(X, mask, mean_hat)
    else:
        G, s = shifted_gram_scan(X, mask, mean_hat, csize)
    n = mask.sum()
    delta = s / n  # exact mean minus μ̂
    mean = mean_hat + delta
    cov = (G - n * torch.outer(delta, delta)) / (n - 1.0)
    return mean, cov, n


def sign_flip(vectors: torch.Tensor) -> torch.Tensor:
    """Make the max-|.| entry of each column positive (the cuML / sklearn
    ``svd_flip`` convention). ``vectors``: (d, k), columns are vectors."""
    idx = torch.argmax(torch.abs(vectors), dim=0)
    picked = vectors[idx, torch.arange(vectors.shape[1], device=vectors.device)]
    signs = torch.where(picked < 0, -1.0, 1.0).to(vectors.dtype)
    return vectors * signs[None, :]


def topk_eigh(cov: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k eigenpairs of a symmetric matrix, descending, sign-fixed:
    (eigenvalues (k,), eigenvectors (d, k))."""
    evals, evecs = torch.linalg.eigh(cov)  # ascending
    evals = torch.flip(evals, dims=(0,))[:k]
    evecs = torch.flip(evecs, dims=(1,))[:, :k]
    return evals, sign_flip(evecs)


def standardize_moments(
    X: torch.Tensor, mask: torch.Tensor, ddof: int = 0
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mean, std, n) for feature standardization, centred second pass in
    row chunks. ``ddof=0`` is the JAX function's population std; ``ddof=1``
    the sample std that LogisticRegression standardizes by."""
    mean, n = masked_mean(X, mask)
    sq = sum(
        mask[lo : lo + _MOMENT_CHUNK] @ (X[lo : lo + _MOMENT_CHUNK] - mean[None, :]) ** 2
        for lo in range(0, X.shape[0], _MOMENT_CHUNK)
    )
    var = sq / torch.clamp(n - ddof, min=1.0)
    return mean, torch.sqrt(torch.clamp(var, min=0.0)), n
