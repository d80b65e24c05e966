"""LinearRegression's sufficient statistics and solvers (counterpart of
``spark_rapids_ml_tpu/ops/linreg_kernels.py``, single device).

One pass over the design matrix gives the weighted centred statistics
(Gram d×d, Xᵀy, yᵀy, moments); every solver then works on the d×d system
alone: OLS and ridge are a Cholesky solve, the elastic net is FISTA on the
quadratic form, with no further pass over the data.

The Gram goes through kernel K1 (``ops.linalg.shifted_gram``) with row
scales ``m = √(mask·w)``: K1 forms ``Σ m²·(x-μ̂)(x-μ̂)ᵀ = Σ w·(x-μ̂)(x-μ̂)ᵀ``,
the JAX scan's ``Σ xsᵀxs``. What K1 does not give (Xy, yy, the label and
weight sums, the weighted column sums and the shifted variance where they
differ from K1's) comes from one plain pass over X in row chunks, shifted
by the same μ̂ before any product. A float64 fit takes the same contract
through ``ops.linalg.shifted_gram_scan`` instead (chosen by dtype here),
and its solvers work in float64 throughout.

Spark objective: 1/(2n)·Σ wᵢ(yᵢ - x·β - b)² + λ[(1-α)/2‖β‖₂² + α‖β‖₁], the
penalty on standardized coefficients when ``standardization=True``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..parallel.mesh import _np_dtype
from .linalg import _MOMENT_CHUNK, gram_kernel_ok, shifted_gram, shifted_gram_scan

# elements of X a chunk of the plain pass holds: _MOMENT_CHUNK rows at
# d = 256, fewer rows at wider d (its (rows, d) temporaries stay ~1 GB)
_PASS_ELEMS = _MOMENT_CHUNK * 256


def _pass_rows(d: int) -> int:
    return max(1, _PASS_ELEMS // max(d, 1))


def _gram(X: torch.Tensor, m: torch.Tensor, mu: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(Σ m²(x-μ)(x-μ)ᵀ, Σ m(x-μ))``: K1 for float32 rows, the scan route
    for float64 (the gate on dtype comes before any kernel wrapper)."""
    if gram_kernel_ok(X.dtype):
        return shifted_gram(X, m, mu)
    return shifted_gram_scan(X, m, mu, _pass_rows(X.shape[1]))


def linreg_suffstats(
    X: torch.Tensor,
    mask: torch.Tensor,
    y: torch.Tensor,
    row_w: Optional[torch.Tensor] = None,
    *,
    fit_intercept: bool = True,
) -> Dict[str, torch.Tensor]:
    """Weighted centred statistics in one pass, the JAX package's fused
    form (for inputs whose rows do not cut into chunks): ``n`` (Σw),
    ``mean_x``, ``mean_y``, ``G = (Xc√w)ᵀ(Xc√w)``, ``Xy``, ``yy``, ``var``.
    The Gram is K1 at the exact weighted mean."""
    w = mask if row_w is None else mask * row_w
    n = w.sum()
    mean_all = (w @ X) / n  # true feature means
    if fit_intercept:
        mean_x = mean_all
        mean_y = (y * w).sum() / n
    else:
        mean_x = torch.zeros((X.shape[1],), dtype=X.dtype, device=X.device)
        mean_y = torch.zeros((), dtype=X.dtype, device=X.device)
    sw = torch.sqrt(w).contiguous()
    G, _ = _gram(X, sw, mean_x.contiguous())
    yc = (y - mean_y) * sw
    Xy = ((X - mean_x[None, :]) * sw[:, None]).T @ yc
    yy = (yc * yc).sum()
    # the penalty scale is the true (centred) variance even when
    # fit_intercept=False leaves G uncentred
    var = torch.diagonal(G) / n
    if not fit_intercept:
        var = var - mean_all * mean_all
    return {"n": n, "mean_x": mean_x, "mean_y": mean_y, "G": G, "Xy": Xy, "yy": yy, "var": var}


def linreg_suffstats_chunked(
    X: torch.Tensor,
    mask: torch.Tensor,
    y: torch.Tensor,
    row_w: Optional[torch.Tensor] = None,
    *,
    csize: int,
    fit_intercept: bool = True,
) -> Dict[str, torch.Tensor]:
    """:func:`linreg_suffstats` shifted by a mean estimate and re-centred
    exactly (the JAX function at ``num_workers=1``, ``mp_blocks=False``).

    μ̂ comes from the leading ``e = min(csize, N)`` rows weighted by
    ``mask·w``. K1 accumulates the Gram shifted by μ̂ when the fit centres
    (``fit_intercept``) and unshifted when it does not (the solver's G
    stays uncentred then); the plain pass accumulates, shifted by μ̂ before
    any product, ``Σw(x-μ̂)``, ``Σw(y-μ̂y)``, ``Σw``, Xy and yy, and
    ``Σw(x-μ̂)²`` where K1's diagonal is not it. With ``dx = Σw(x-μ̂)/n``
    the rank-1 re-centre ``G -= n·dx·dxᵀ`` (and alike for Xy, yy) gives
    the centred statistics; ``var = vs/n - dx²`` is stable for any |μ|.
    With ``fit_intercept=False`` the means are zero and ``var`` stays the
    shifted one. Rows must be padded to a ``csize`` multiple."""
    weighted = row_w is not None
    N, d = X.shape
    wl = mask * row_w if weighted else mask
    e = min(csize, N)
    w0 = wl[:e]
    c0 = torch.clamp(w0.sum(), min=1.0)
    mu_x = ((w0 @ X[:e]) / c0).contiguous()
    mu_y = (y[:e] * w0).sum() / c0

    sqw = torch.sqrt(wl).contiguous()
    shift = mu_x if fit_intercept else torch.zeros_like(mu_x)
    G, s = _gram(X, sqw, shift)

    # K1's s is Σ√w(x-μ̂): the weighted sum only for 0/1 weights at the μ̂ shift
    need_sx = weighted or not fit_intercept
    need_vs = not fit_intercept
    yd = y - mu_y
    v = wl * (yd if fit_intercept else y)  # w·(y-μ̂y), or w·y uncentred
    Xy = torch.zeros((d,), dtype=X.dtype, device=X.device)
    sx = torch.zeros_like(Xy) if need_sx else s
    vs = torch.zeros_like(Xy) if need_vs else torch.diagonal(G)
    step = _pass_rows(d)
    for lo in range(0, N, step):
        x, w = X[lo:lo + step], wl[lo:lo + step]
        xd = x - mu_x[None, :]
        Xy += v[lo:lo + step] @ (xd if fit_intercept else x)
        if need_sx:
            sx += w @ xd
        if need_vs:
            vs += w @ (xd * xd)
    sy = (wl * yd).sum()
    W = wl.sum()
    yy = (v * (yd if fit_intercept else y)).sum()

    n = W
    dx, dy = sx / n, sy / n
    var = vs / n - dx * dx
    if fit_intercept:
        G = G - n * torch.outer(dx, dx)
        Xy = Xy - n * dx * dy
        yy = yy - n * dy * dy
        mean_x, mean_y = mu_x + dx, mu_y + dy
    else:
        mean_x = torch.zeros((d,), dtype=X.dtype, device=X.device)
        mean_y = torch.zeros((), dtype=X.dtype, device=X.device)
    return {"n": n, "mean_x": mean_x, "mean_y": mean_y, "G": G, "Xy": Xy, "yy": yy, "var": var}


def _to_standardized(stats: Dict[str, torch.Tensor], standardization: bool):
    """Scale the quadratic system into standardized-coefficient space."""
    std = torch.sqrt(torch.clamp(stats["var"], min=0.0))
    safe = torch.where(std > 0, std, torch.ones_like(std))
    if standardization:
        G = stats["G"] / torch.outer(safe, safe)
        Xy = stats["Xy"] / safe
    else:
        G, Xy = stats["G"], stats["Xy"]
    return G, Xy, std, safe


def _finish(stats, beta, std, safe, standardization: bool):
    if standardization:
        beta = torch.where(std > 0, beta / safe, torch.zeros_like(beta))
    intercept = stats["mean_y"] - stats["mean_x"] @ beta
    return beta, intercept


def solve_normal(
    stats: Dict[str, torch.Tensor], l2: float, *, standardization: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closed-form OLS/ridge: ``(G/n + λ₂I) β = Xy/n`` by Cholesky, with
    the jitter ``eps(G.dtype)·trace(A)`` that keeps exactly collinear
    features positive definite. Returns (coefficients in original scale,
    intercept)."""
    n = stats["n"]
    G, Xy, std, safe = _to_standardized(stats, standardization)
    d = G.shape[0]
    eye = torch.eye(d, dtype=G.dtype, device=G.device)
    A = G / n + l2 * eye
    A = A + torch.finfo(G.dtype).eps * torch.trace(A) * eye
    L = torch.linalg.cholesky(A)
    beta = torch.cholesky_solve((Xy / n)[:, None], L)[:, 0]
    return _finish(stats, beta, std, safe, standardization)


def solve_elasticnet(
    stats: Dict[str, torch.Tensor],
    l1: float,
    l2: float,
    *,
    standardization: bool,
    max_iter: int,
    tol: float,
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """FISTA on the precomputed quadratic form, the JAX package's solver
    step for step: ``grad = Gβ/n - Xy/n + λ₂β``, soft-threshold at λ₁/L,
    L from 16 power iterations on G/n from the cos start vector (the
    Frobenius norm where the iterate collapses), and an iteration while
    ``it < max_iter and delta > tol`` (a host loop: ``n_iter`` counts the
    iterations run). Returns (coefficients, intercept, n_iter)."""
    n = stats["n"]
    G, Xy, std, safe = _to_standardized(stats, standardization)
    d = G.shape[0]
    Gn = G / n
    b = Xy / n

    v = torch.cos(torch.arange(d, dtype=G.dtype, device=G.device) * 1.61803398875 + 0.5)
    v = v / torch.clamp(torch.linalg.vector_norm(v), min=1e-30)
    for _ in range(16):
        v = Gn @ v
        v = v / torch.clamp(torch.linalg.vector_norm(v), min=1e-30)
    fro = torch.sqrt((Gn * Gn).sum())
    L_pow = (v @ (Gn @ v)) / torch.clamp(v @ v, min=1e-30)
    L_smooth = torch.where(L_pow > 1e-6 * fro, L_pow * 1.01, fro)
    L = L_smooth + l2 + 1e-12

    def soft(x, t):
        return torch.sign(x) * torch.clamp(torch.abs(x) - t, min=0.0)

    # the momentum scalar and the stopping test in G's dtype, as in the JAX loop
    ft = _np_dtype(G.dtype).type
    one = ft(1.0)
    tol_g = ft(tol)
    beta = torch.zeros((d,), dtype=G.dtype, device=G.device)
    z = beta
    t = one
    it = 0
    delta = ft(np.inf)
    while it < max_iter and delta > tol_g:
        grad = Gn @ z - b + l2 * z
        beta_new = soft(z - grad / L, l1 / L)
        t_new = ft(0.5) * (one + np.sqrt(one + ft(4.0) * t * t))
        z = beta_new + float((t - one) / t_new) * (beta_new - beta)
        delta = ft(torch.abs(beta_new - beta).max().item())
        beta, t, it = beta_new, t_new, it + 1
    beta, intercept = _finish(stats, beta, std, safe, standardization)
    return beta, intercept, it
