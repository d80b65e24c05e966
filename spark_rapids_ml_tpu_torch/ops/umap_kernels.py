"""UMAP of the port: fuzzy simplicial set, spectral init, and the
negative-sampling SGD over CSR-padded rows (counterpart of
``spark_rapids_ml_tpu/ops/umap_kernels.py`` and ``umap_pallas.py``).

Graph construction stays on the host (scipy sparse), as in the JAX
package; the per-point bisection runs on device tensors. The SGD keeps the
JAX package's head-only, CSR-padded formulation: one epoch is one launch of
kernel K10 (``csrc/umap_sgd_epoch.cu``, the per-row gradient sums) plus an
``index_add_`` of the rows into their heads and the ``alpha`` step. The
JAX package has two engines for that epoch (``optimize_embedding_rows``
in XLA, ``umap_sgd_pallas`` around the Pallas kernel); they compute the
same function, and the port has one loop, :func:`umap_sgd`, whose epoch
goes through the K10 wrapper (its plain version on the CPU).

Randomness: ``jax.random`` bits cannot be reproduced in PyTorch, so each
epoch draws its slot uniforms, permutation and roll offsets from a
``torch.Generator``; ``umap_sgd(..., draws=)`` takes them from the caller
instead, which is how the tests feed both packages the same numbers.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from . import _build
from .linalg import _check_cuda_f32

_I64, _P, _F = ctypes.c_int64, ctypes.c_void_p, ctypes.c_float

_MIN_K_DIST_SCALE = 1e-3
# limits of csrc/umap_sgd_epoch.cu (the JAX gate's range: C <= 8, neg <= 16)
MAX_COMPONENTS = 8
MAX_NEG = 16

Draws = Callable[[int], Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def find_ab_params(spread: float, min_dist: float) -> Tuple[float, float]:
    """Fit the (a, b) differentiable-curve params (umap-learn convention)."""
    from scipy.optimize import curve_fit

    def curve(x, a, b):
        return 1.0 / (1.0 + a * x ** (2 * b))

    xv = np.linspace(0, spread * 3, 300)
    yv = np.zeros(xv.shape)
    yv[xv < min_dist] = 1.0
    yv[xv >= min_dist] = np.exp(-(xv[xv >= min_dist] - min_dist) / spread)
    params, _ = curve_fit(curve, xv, yv)
    return float(params[0]), float(params[1])


def smooth_knn_dist(
    knn_dists: torch.Tensor, local_connectivity: float, *, n_iter: int = 64
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-point (rho, sigma) of ``knn_dists`` (n, k) ascending neighbour
    distances (self excluded): rho = distance to the local_connectivity-th
    neighbour (interpolated), sigma solves sum exp(-(d-rho)/sigma) =
    log2(k) by ``n_iter`` halving steps."""
    n, k = knn_dists.shape
    dev, dt = knn_dists.device, knn_dists.dtype
    target = torch.log2(torch.tensor(float(k), dtype=dt, device=dev))

    idx = int(np.floor(local_connectivity)) - 1
    frac = float(local_connectivity) - int(np.floor(local_connectivity))
    idx = max(idx, 0)
    rho = knn_dists[:, min(idx, k - 1)]
    if frac > 0 and idx + 1 < k:
        rho = rho + frac * (knn_dists[:, idx + 1] - knn_dists[:, idx])

    d = torch.clamp(knn_dists - rho[:, None], min=0.0)
    lo = torch.zeros((n,), dtype=dt, device=dev)
    hi = torch.full((n,), float("inf"), dtype=dt, device=dev)
    mid = torch.ones((n,), dtype=dt, device=dev)
    for _ in range(n_iter):
        too_high = torch.exp(-d / mid[:, None]).sum(dim=1) > target
        hi = torch.where(too_high, mid, hi)
        lo = torch.where(too_high, lo, mid)
        mid = torch.where(torch.isinf(hi), lo * 2.0, (lo + hi) / 2.0)

    # floor sigma like umap-learn: never below MIN_K_DIST_SCALE * mean dist
    mean_d = torch.clamp(knn_dists.mean(), min=1e-12)
    return rho, torch.maximum(mid, _MIN_K_DIST_SCALE * mean_d)


def membership_strengths(
    knn_dists: torch.Tensor, rho: torch.Tensor, sigma: torch.Tensor
) -> torch.Tensor:
    """Directed fuzzy-set weights w_ij = exp(-max(0, d - rho_i)/sigma_i)."""
    return torch.exp(-torch.clamp(knn_dists - rho[:, None], min=0.0) / sigma[:, None])


def fuzzy_simplicial_set(
    knn_indices: np.ndarray,
    knn_dists: np.ndarray,
    local_connectivity: float,
    set_op_mix_ratio: float,
    device: Optional[torch.device] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Symmetrized edge list (heads, tails, weights) of the (n, k) kNN
    graph (self excluded): the bisection on ``device`` (the CPU by
    default), the symmetrization on the host with scipy sparse."""
    import scipy.sparse as sp

    n, k = knn_indices.shape
    kd = torch.as_tensor(knn_dists, device=device)
    rho, sigma = smooth_knn_dist(kd, local_connectivity)
    w = membership_strengths(kd, rho, sigma).cpu().numpy()

    rows = np.repeat(np.arange(n), k)
    cols = knn_indices.reshape(-1)
    A = sp.coo_matrix((w.reshape(-1), (rows, cols)), shape=(n, n)).tocsr()
    return _fuzzy_union_edges(A, set_op_mix_ratio)


def _fuzzy_union_edges(A, set_op_mix_ratio: float = 1.0):
    """Symmetrize a directed membership CSR via the probabilistic t-conorm
    (mixed with the intersection per ``set_op_mix_ratio``) and extract the
    positive-weight edge list."""
    T = A.T.tocsr()
    prod = A.multiply(T)
    sym = (set_op_mix_ratio * (A + T - prod) + (1.0 - set_op_mix_ratio) * prod).tocoo()
    mask = sym.data > 0
    return (
        sym.row[mask].astype(np.int32),
        sym.col[mask].astype(np.int32),
        sym.data[mask].astype(np.float32),
    )


def categorical_simplicial_set_intersection(
    heads: np.ndarray,
    tails: np.ndarray,
    weights: np.ndarray,
    labels: np.ndarray,
    n: int,
    far_dist: float = 5.0,
    unknown_dist: float = 1.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Supervised (categorical) intersection of the fuzzy simplicial set
    with a label-induced set: edges joining different labels are scaled by
    exp(-far_dist), edges with an unknown (< 0) endpoint by
    exp(-unknown_dist); local connectivity is then reset (per-row max
    normalization + fuzzy union)."""
    import scipy.sparse as sp

    li = labels[heads]
    lj = labels[tails]
    unknown = (li < 0) | (lj < 0)
    diff = (li != lj) & ~unknown
    scale = np.where(unknown, np.exp(-unknown_dist), np.where(diff, np.exp(-far_dist), 1.0))
    w = weights * scale

    A = sp.coo_matrix((w, (heads, tails)), shape=(n, n)).tocsr()
    rowmax = np.asarray(A.max(axis=1).todense()).ravel()
    A = sp.diags(1.0 / np.maximum(rowmax, 1e-12)) @ A
    return _fuzzy_union_edges(A)


def spectral_init(
    heads: np.ndarray, tails: np.ndarray, weights: np.ndarray, n: int,
    n_components: int, seed: int,
) -> np.ndarray:
    """Normalized-Laplacian spectral layout (umap 'init=spectral'); falls
    back to random on solver failure. Host scipy, as in the JAX package."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    try:
        graph = sp.coo_matrix((weights, (heads, tails)), shape=(n, n)).tocsr()
        diag = np.asarray(graph.sum(axis=1)).ravel()
        d_inv_sqrt = 1.0 / np.sqrt(np.maximum(diag, 1e-12))
        D = sp.diags(d_inv_sqrt)
        from scipy.sparse.linalg import eigsh

        # smallest eigenpairs of L = I - D·G·D as the largest of the
        # spectrum-flipped I + D·G·D (plain Lanczos, no factorization);
        # tol=1e-4 because this is an init; the seeded v0 keeps it
        # deterministic
        k = n_components + 1
        v0 = rng.normal(size=n)
        flip_vals, vecs = eigsh(
            sp.identity(n) + D @ graph @ D, k=k, which="LM", maxiter=n * 5,
            tol=1e-4, v0=v0,
        )
        order = np.argsort(2.0 - flip_vals)  # ascending eigenvalues of L
        emb = vecs[:, order[1 : n_components + 1]]
        expansion = 10.0 / np.maximum(np.abs(emb).max(), 1e-12)
        return (emb * expansion).astype(np.float32) + rng.normal(
            scale=1e-4, size=(n, n_components)
        ).astype(np.float32)
    except Exception:
        return rng.uniform(-10, 10, size=(n, n_components)).astype(np.float32)


def build_row_adjacency(
    heads: np.ndarray,
    tails: np.ndarray,
    weights: np.ndarray,
    n: int,
    *,
    K: int = 32,
    row_bucket: int = 4096,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pack a directed edge list into CSR-padded rows of K slots: node i's
    edges fill ``ceil(deg_i / K)`` consecutive rows headed by i. Returns
    ``(row_heads (R,), tails_pad (R, K), p_pad (R, K))`` with R padded to a
    ``row_bucket`` multiple. Padding slots carry p = 0 (never active) and
    tail 0; padding rows are headed by n-1, keeping ``row_heads``
    ascending."""
    order = np.argsort(heads, kind="stable")
    h = np.asarray(heads, dtype=np.int64)[order]
    t = np.asarray(tails, dtype=np.int32)[order]
    w = np.asarray(weights, dtype=np.float32)[order]
    deg = np.bincount(h, minlength=n)
    nrows = -(-deg // K)  # ceil; 0 rows for isolated nodes
    R = int(nrows.sum())
    R_pad = max(row_bucket, -(-R // row_bucket) * row_bucket)

    starts = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=starts[1:])
    within = np.arange(len(h), dtype=np.int64) - starts[h]
    row_off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(nrows, out=row_off[1:])
    r = (row_off[h] + within // K).astype(np.int64)
    s = (within % K).astype(np.int64)

    row_heads = np.full(R_pad, n - 1, dtype=np.int32)
    row_heads[:R] = np.repeat(np.arange(n, dtype=np.int32), nrows)
    tails_pad = np.zeros((R_pad, K), dtype=np.int32)
    p_pad = np.zeros((R_pad, K), dtype=np.float32)
    tails_pad[r, s] = t
    p_pad[r, s] = w / max(float(w.max()) if len(w) else 1.0, 1e-12)
    return row_heads, tails_pad, p_pad


def epoch_alpha(initial_alpha: float, e: int, n_epochs: int) -> float:
    """umap-learn's linear learning-rate decay."""
    return initial_alpha * (1.0 - e / n_epochs)


def default_n_epochs(n: int) -> int:
    return 500 if n <= 10000 else 200


def negative_ids(perm: torch.Tensor, offs: torch.Tensor, R: int, K: int) -> torch.Tensor:
    """(R, K, neg) table rows of the negative samples: a permutation of the
    table laid cyclically over the slots, rolled by ``offs[s]`` rows for
    sample s — ``perm[(((r - offs[s]) mod R)·K + k) mod n_tab]``."""
    dev = perm.device
    rr = (torch.arange(R, device=dev)[:, None] - offs.long()[None, :]) % R
    f = (rr[:, None, :] * K + torch.arange(K, device=dev)[None, :, None]) % perm.shape[0]
    return perm.long()[f]


def sgd_epoch_rows_plain(
    src: torch.Tensor,
    h: torch.Tensor,
    tails_pad: torch.Tensor,
    p_pad: torch.Tensor,
    perm: torch.Tensor,
    offs: torch.Tensor,
    u: torch.Tensor,
    a: float,
    b: float,
    gamma: float,
    attract_scale: float,
) -> torch.Tensor:
    """Plain version of K10, in the JAX package's XLA form; works in the
    dtype of ``src`` (f64 for the on-card check)."""
    R, K = tails_pad.shape
    active = (u < p_pad).to(src.dtype)
    diff = h[:, None, :] - src[tails_pad.long()]  # (R, K, C)
    d2 = (diff * diff).sum(dim=2)
    # attractive: -2ab d^{2(b-1)} / (1 + a d^{2b})
    ac = (-2.0 * a * b * d2 ** (b - 1.0)) / (a * d2**b + 1.0)
    ac = torch.where(d2 > 0.0, ac, 0.0) * active
    grad = torch.clamp(ac[..., None] * diff, -4.0, 4.0) * attract_scale
    # repulsive, from the tiled-permutation negatives
    diff_n = h[:, None, None, :] - src[negative_ids(perm, offs, R, K)]  # (R, K, neg, C)
    d2n = (diff_n * diff_n).sum(dim=3)
    rc = (2.0 * gamma * b) / ((0.001 + d2n) * (a * d2n**b + 1.0))
    rc = torch.where(d2n > 0.0, rc, 0.0) * active[..., None]
    grad = grad + torch.clamp(rc[..., None] * diff_n, -4.0, 4.0).sum(dim=2)
    return grad.sum(dim=1)


def sgd_epoch_rows(
    src: torch.Tensor,
    h: torch.Tensor,
    tails_pad: torch.Tensor,
    p_pad: torch.Tensor,
    perm: torch.Tensor,
    offs: torch.Tensor,
    u: torch.Tensor,
    a: float,
    b: float,
    gamma: float,
    attract_scale: float,
) -> torch.Tensor:
    """Kernel K10: one SGD epoch's per-row gradient sums (R, C) for the
    CSR-padded rows ``tails_pad``/``p_pad`` (R, K) with head rows ``h``
    (R, C) against the table ``src`` (n_tab, C): slot (r, k) is active
    when ``u[r, k] < p_pad[r, k]``; its negatives come from ``perm``
    (n_tab,) and ``offs`` (neg,) as in :func:`negative_ids`.

    A CPU tensor goes to :func:`sgd_epoch_rows_plain`; a CUDA tensor to the
    CUDA kernel (C <= 8, neg <= 16), or this raises. Replaces
    ``spark_rapids_ml_tpu/ops/umap_pallas.py::sgd_epoch_rows``."""
    if src.device.type == "cpu":
        return sgd_epoch_rows_plain(src, h, tails_pad, p_pad, perm, offs, u, a, b, gamma, attract_scale)
    _check_cuda_f32("sgd_epoch_rows", src, h, p_pad, u)
    R, K = tails_pad.shape
    n_tab, C = src.shape
    neg = offs.shape[0]
    if h.shape != (R, C) or p_pad.shape != (R, K) or u.shape != (R, K) or perm.shape != (n_tab,) \
            or offs.dim() != 1:
        raise ValueError(
            f"sgd_epoch_rows: shapes src {tuple(src.shape)}, h {tuple(h.shape)}, tails "
            f"{tuple(tails_pad.shape)}, p {tuple(p_pad.shape)}, u {tuple(u.shape)}, perm "
            f"{tuple(perm.shape)}, offs {tuple(offs.shape)} do not agree"
        )
    for t in (tails_pad, perm, offs):
        if t.dtype != torch.int32 or t.device != src.device or not t.is_contiguous():
            raise ValueError("sgd_epoch_rows: tails_pad, perm and offs must be contiguous int32 on the card")
    if not (1 <= C <= MAX_COMPONENTS and neg <= MAX_NEG):
        raise NotImplementedError(
            f"sgd_epoch_rows: the CUDA kernel takes C <= {MAX_COMPONENTS} and neg <= {MAX_NEG}, "
            f"got C={C}, neg={neg}"
        )
    out = torch.empty((R, C), dtype=torch.float32, device=src.device)
    fn = _build.function(
        "umap_sgd_epoch", "umap_sgd_epoch_launch",
        [_P, _P, _P, _P, _P, _P, _P, _P, _I64, ctypes.c_int, ctypes.c_int, ctypes.c_int, _I64,
         _F, _F, _F, _F, _F, _F, _P],
    )
    # the f32 constants the reference's expressions round to
    code = fn(
        src.data_ptr(), h.data_ptr(), tails_pad.data_ptr(), p_pad.data_ptr(), perm.data_ptr(),
        offs.data_ptr(), u.data_ptr(), out.data_ptr(), R, K, C, neg, n_tab,
        a, b, b - 1.0, -2.0 * a * b, 2.0 * gamma * b, attract_scale,
        torch.cuda.current_stream(src.device).cuda_stream,
    )
    sgd_epoch_rows.launches += 1
    _build.check("umap_sgd_epoch", code)
    return out


sgd_epoch_rows.launches = 0


def umap_sgd(
    emb_head: torch.Tensor,
    table: torch.Tensor,
    row_heads: torch.Tensor,
    tails_pad: torch.Tensor,
    p_pad: torch.Tensor,
    generator: Optional[torch.Generator],
    *,
    n_epochs: int,
    a: float,
    b: float,
    gamma: float = 1.0,
    initial_alpha: float = 1.0,
    negative_sample_rate: int = 5,
    self_table: bool = True,
    draws: Optional[Draws] = None,
) -> torch.Tensor:
    """Head-only negative-sampling SGD over CSR-padded rows: ``n_epochs``
    epochs of ``emb_head`` (n_head, C) against ``table`` (n_tab, C) (for
    fit the embedding itself: ``self_table=True``); ``row_heads`` (R,),
    ``tails_pad`` (R, K) int32 and ``p_pad`` (R, K). Returns the new
    embedding (the input is not modified).

    Each epoch draws its slot uniforms ``u`` (R, K), permutation ``perm``
    (n_tab,) and roll offsets ``offs`` (neg,) from ``generator`` (on the
    tensors' device), or takes them from ``draws(e)``; then one K10 launch,
    an ``index_add_`` of the rows into their heads and ``emb += alpha·upd``.
    Attractive terms count twice on a self table: each directed edge moves
    only its head, and the reverse copy supplies the other endpoint's pull.
    """
    R, K = tails_pad.shape
    n_tab = table.shape[0]
    neg = int(negative_sample_rate)
    dev = emb_head.device
    heads = row_heads.long()
    attract_scale = 2.0 if self_table else 1.0
    emb = emb_head.clone(memory_format=torch.contiguous_format)
    upd = torch.empty_like(emb)
    for e in range(n_epochs):
        src = emb if self_table else table
        if draws is None:
            u = torch.rand((R, K), generator=generator, device=dev)
            perm = torch.randperm(n_tab, generator=generator, device=dev, dtype=torch.int32)
            offs = torch.randint(0, R, (neg,), generator=generator, device=dev, dtype=torch.int32)
        else:
            u, perm, offs = draws(e)
        row_upd = sgd_epoch_rows(src, emb[heads], tails_pad, p_pad, perm, offs, u, a, b, gamma, attract_scale)
        upd.zero_().index_add_(0, heads, row_upd)
        emb.add_(upd, alpha=epoch_alpha(initial_alpha, e, n_epochs))
    return emb
