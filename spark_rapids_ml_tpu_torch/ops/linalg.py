"""Dense linear algebra of the port (counterpart of
``spark_rapids_ml_tpu/ops/linalg.py``, single device).

Holds kernel K1, the shifted Gram pass (``csrc/shifted_gram.cu``), beside
its plain PyTorch version, and the covariance / eigendecomposition glue
around it. The mean estimate, the shift and the exact rank-1 re-centre
follow the JAX package step for step, so at ``num_workers=1`` both
packages shift by the same μ̂.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

_I64, _P = ctypes.c_int64, ctypes.c_void_p

# K1 geometry, mirrored from csrc/shifted_gram.cu
_GRAM_TILE = 128
_GRAM_STAGE = 16


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
    """Plain version of K1: ``(Σ m·(x-μ̂)(x-μ̂)ᵀ, Σ m·(x-μ̂))``."""
    xs = (X - mu[None, :]) * m[:, None]
    return xs.T @ xs, xs.sum(dim=0)


def shifted_gram(
    X: torch.Tensor, m: torch.Tensor, mu: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel K1: one pass over the rows of ``X`` (n, d) with row weights
    ``m`` (n,) and shift ``mu`` (d,); returns ``(G (d, d), s (d,))`` in f32.

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
    T = -(-d // _GRAM_TILE)
    n_up = T * (T + 1) // 2
    # about two resident blocks per SM: the row splits fill the card when
    # there are few output tiles (3 at d = 256)
    sms = torch.cuda.get_device_properties(X.device).multi_processor_count
    nsplit = max(1, min(-(-max(n, 1) // _GRAM_STAGE), -(-2 * sms // n_up)))
    rows = -(-max(n, 1) // nsplit)
    rows = -(-rows // _GRAM_STAGE) * _GRAM_STAGE
    nsplit = -(-max(n, 1) // rows)
    G = torch.empty((d, d), dtype=torch.float32, device=X.device)
    s = torch.empty((d,), dtype=torch.float32, device=X.device)
    part_G = torch.empty((nsplit, n_up, _GRAM_TILE, _GRAM_TILE), dtype=torch.float32, device=X.device)
    part_s = torch.empty((nsplit, T * _GRAM_TILE), dtype=torch.float32, device=X.device)
    fn = _build.function(
        "shifted_gram", "shifted_gram_launch",
        [_P, _P, _P, _P, _P, _P, _P, _I64, ctypes.c_int, ctypes.c_int, _I64, _P],
    )
    code = fn(
        X.data_ptr(), m.data_ptr(), mu.data_ptr(), G.data_ptr(), s.data_ptr(),
        part_G.data_ptr(), part_s.data_ptr(), n, d, nsplit, rows,
        torch.cuda.current_stream(X.device).cuda_stream,
    )
    shifted_gram.launches += 1
    _build.check("shifted_gram", code)
    return G, s


shifted_gram.launches = 0


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
    multiple (:func:`parallel.mesh.shard_rows`), as in the JAX package."""
    N = X.shape[0]
    e = min(csize, N)
    stride = max(1, N // e)
    x0, m0 = X[::stride][:e], mask[::stride][:e]
    s0 = (x0 * m0[:, None]).sum(dim=0)
    c0 = m0.sum()
    mean_hat = (s0 / torch.clamp(c0, min=1.0)).contiguous()
    G, s = shifted_gram(X, mask, mean_hat)
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
