"""UMAP of the port: fuzzy simplicial set, spectral init, and the
negative-sampling SGD over CSR-padded rows (counterpart of
``spark_rapids_ml_tpu/ops/umap_kernels.py`` and ``umap_pallas.py``).

Graph construction stays on the host (scipy sparse), as in the JAX
package; the per-point bisection runs on device tensors. The SGD keeps the
JAX package's head-only, CSR-padded formulation. Kernel K10
(``csrc/umap_sgd_epoch.cu``) has two epilogues: ROWS, the per-row gradient
sums (:func:`sgd_epoch_rows`, the TPU kernel's contract), and STEP, the
whole epoch (:func:`sgd_epoch_step`: the rows' sums added into their heads
in a fixed order and the ``alpha`` step, written to a second buffer). The
JAX package has two engines for that epoch (``optimize_embedding_rows``
in XLA, ``umap_sgd_pallas`` around the Pallas kernel); they compute the
same function, and the port has one loop, :func:`umap_sgd`, one STEP
launch an epoch (its plain version on the CPU).

Randomness: ``jax.random`` bits cannot be reproduced in PyTorch. Each
epoch draws its permutation and roll offsets from a ``torch.Generator``;
its slot uniforms come from a counter-based hash of (seed, slot)
(:func:`slot_bits_plain`, computed inside the kernel on the card: the
port's counterpart of the TPU kernel's ``rng="onchip"`` mode), the seed
drawn from the generator once a call. ``umap_sgd(..., draws=)`` takes all
three from the caller instead and streams the uniforms, which is how the
tests feed both packages the same numbers.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..runtime.faults import fault_site
from . import _build
from .linalg import _check_cuda_f32

_I64, _P, _F = ctypes.c_int64, ctypes.c_void_p, ctypes.c_float

_MIN_K_DIST_SCALE = 1e-3
# the slot hash of csrc/umap_sgd_epoch.cu: bits = mix32(mix32(ctr ^ key) +
# key), key = mix32(seed + _GOLDEN), mix32 an xor-shift-multiply finaliser
_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_MIX = (0x21F0AAAD, 0xD35A2D97)

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


def negative_ids(perm: torch.Tensor, offs: torch.Tensor, R: int, K: int, r=None, k=None) -> torch.Tensor:
    """Table rows of the negative samples: a permutation of the table laid
    cyclically over the slots, rolled by ``offs[s]`` rows for sample s —
    ``perm[(((r - offs[s]) mod R)·K + k) mod n_tab]``. (R, K, neg) for every
    slot, or (n, neg) for the slots of the index vectors ``r``, ``k``."""
    if r is None:
        r = torch.arange(R, device=perm.device)[:, None]
        k = torch.arange(K, device=perm.device)[None, :]
    rr = (r[..., None] - offs.long()) % R
    return perm.long()[(rr * K + k[..., None]) % perm.shape[0]]


def _mul32(x, m: int):
    """Low 32 bits of ``x * m`` for ``x`` in [0, 2^32) (an int64 tensor or
    an int), without overflowing int64: the two 16-bit halves of ``x``."""
    return ((x & 0xFFFF) * m + ((((x >> 16) * m) & 0xFFFF) << 16)) & _M32


def _mix32(x):
    x = x ^ (x >> 16)
    x = _mul32(x, _MIX[0])
    x = x ^ (x >> 15)
    x = _mul32(x, _MIX[1])
    return x ^ (x >> 15)


def slot_bits_plain(seed: int, R: int, K: int, device=None) -> torch.Tensor:
    """(R, K) int64 in [0, 2^32): the bits of slot (r, k) for ``seed``, the
    hash K10 computes in its kernel — ``mix32(mix32(ctr ^ key) + key)``
    with ``ctr = (r·K + k) mod 2^32`` and ``key = mix32(seed + 0x9e3779b9)``."""
    key = _mix32((int(seed) + _GOLDEN) & _M32)
    ctr = torch.arange(R * K, dtype=torch.int64, device=device).reshape(R, K) & _M32
    return _mix32((_mix32(ctr ^ key) + key) & _M32)


def slot_uniforms_plain(seed: int, R: int, K: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """(R, K) slot uniforms in [0, 1): the top 24 bits of
    :func:`slot_bits_plain` times 2^-24 (exact in f32 and f64)."""
    return (slot_bits_plain(seed, R, K, device) >> 8).to(dtype) * 2.0**-24


def sgd_epoch_rows_plain(
    src: torch.Tensor,
    h: torch.Tensor,
    tails_pad: torch.Tensor,
    p_pad: torch.Tensor,
    perm: torch.Tensor,
    offs: torch.Tensor,
    u: Optional[torch.Tensor],
    a: float,
    b: float,
    gamma: float,
    attract_scale: float,
    *,
    seed: Optional[int] = None,
) -> torch.Tensor:
    """Plain version of K10's ROWS epilogue: the JAX package's XLA terms,
    evaluated for the active slots only (an inactive slot's terms are
    zeros) and added into their rows; works in the dtype of ``src`` (f64
    for the on-card check). ``u`` None: the slot uniforms of ``seed``
    (:func:`slot_uniforms_plain`)."""
    R, K = tails_pad.shape
    if u is None:
        u = slot_uniforms_plain(seed, R, K, src.dtype, src.device)
    r, k = torch.nonzero(u < p_pad, as_tuple=True)
    hr = h[r]
    diff = hr - src[tails_pad[r, k].long()]  # (n_active, C)
    d2 = (diff * diff).sum(dim=1)
    # attractive: -2ab d^{2(b-1)} / (1 + a d^{2b})
    ac = (-2.0 * a * b * d2 ** (b - 1.0)) / (a * d2**b + 1.0)
    ac = torch.where(d2 > 0.0, ac, 0.0)
    grad = torch.clamp(ac[:, None] * diff, -4.0, 4.0) * attract_scale
    # repulsive, from the tiled-permutation negatives
    diff_n = hr[:, None, :] - src[negative_ids(perm, offs, R, K, r, k)]  # (n_active, neg, C)
    d2n = (diff_n * diff_n).sum(dim=2)
    rc = (2.0 * gamma * b) / ((0.001 + d2n) * (a * d2n**b + 1.0))
    rc = torch.where(d2n > 0.0, rc, 0.0)
    grad = grad + torch.clamp(rc[..., None] * diff_n, -4.0, 4.0).sum(dim=1)
    return torch.zeros((R, src.shape[1]), dtype=src.dtype, device=src.device).index_add_(0, r, grad)


class HeadRows(NamedTuple):
    """The rows of each head for :func:`sgd_epoch_step`, rows sorted by
    head: ``heads`` (R,) int32, the head of each row; ``off`` (n_head + 1,)
    int64, the first row of each head, over the live rows only. On the
    card, the kernel's geometry and workspace for these rows: a warp takes
    ``rows_per_warp`` rows, and ``part`` (warps, 2, C) and ``arrive``
    (warps,) int32 hold the sums of the heads two warps share (each launch
    leaves ``arrive`` at zero; launches that share them run on one stream).
    On the CPU those three are None, None and 0."""

    heads: torch.Tensor
    off: torch.Tensor
    part: Optional[torch.Tensor]
    arrive: Optional[torch.Tensor]
    rows_per_warp: int


def head_rows(row_heads: torch.Tensor, p_pad: torch.Tensor, n_head: int, n_components: int) -> HeadRows:
    """:class:`HeadRows` of ``row_heads`` (R,) ascending in [0, n_head),
    built once a :func:`umap_sgd` call for an embedding of ``n_components``.
    Rows after the last row with a slot of p > 0 (``build_row_adjacency``'s
    padding) are not live: no draw activates them, so their terms are exact
    zeros."""
    dev = p_pad.device
    live_rows = torch.nonzero((p_pad > 0).any(dim=1))
    live = int(live_rows[-1]) + 1 if live_rows.numel() else 0
    heads = row_heads[:live].long()
    if live and (int(heads.min()) < 0 or int(heads.max()) >= n_head or bool((heads.diff() < 0).any())):
        raise ValueError(f"head_rows: the row heads must be ascending in [0, {n_head})")
    off = torch.zeros((n_head + 1,), dtype=torch.int64, device=dev)
    torch.cumsum(torch.bincount(heads, minlength=n_head), 0, out=off[1:])
    heads32 = row_heads.to(device=dev, dtype=torch.int32).contiguous()
    if dev.type == "cpu":
        return HeadRows(heads32, off, None, None, 0)
    rpw, warps = k10_geometry(p_pad.shape[0], _resident_warps(n_components, dev))
    return HeadRows(heads32, off, torch.empty((warps, 2, n_components), dtype=torch.float32, device=dev),
                    torch.zeros((warps,), dtype=torch.int32, device=dev), rpw)


def sgd_epoch_step_plain(
    emb: torch.Tensor,
    table: torch.Tensor,
    rows: HeadRows,
    tails_pad: torch.Tensor,
    p_pad: torch.Tensor,
    perm: torch.Tensor,
    offs: torch.Tensor,
    a: float,
    b: float,
    gamma: float,
    attract_scale: float,
    alpha: float,
    *,
    u: Optional[torch.Tensor] = None,
    seed: Optional[int] = None,
) -> torch.Tensor:
    """Plain version of K10's STEP epilogue: :func:`sgd_epoch_rows_plain`
    on the rows' heads ``emb[heads]``, an ``index_add_`` of the rows into
    their heads and ``emb + alpha·upd`` (a head without rows keeps its
    row); works in the dtype of ``emb``."""
    n_head = emb.shape[0]
    R = tails_pad.shape[0]
    counts = rows.off.diff()
    live = int(rows.off[-1])
    heads = torch.repeat_interleave(torch.arange(n_head, device=emb.device), counts)
    # rows past the live ones take the last head: their terms are zeros
    h = emb[torch.cat([heads, heads.new_full((R - live,), max(n_head - 1, 0))])]
    sums = sgd_epoch_rows_plain(table, h, tails_pad, p_pad, perm, offs, u, a, b, gamma, attract_scale, seed=seed)
    upd = torch.zeros_like(emb).index_add_(0, heads, sums[:live])
    return torch.where((counts > 0)[:, None], emb + alpha * upd, emb)


def _check_k10(name, src, tails_pad, p_pad, perm, offs, u):
    _check_cuda_f32(name, src, p_pad, *(() if u is None else (u,)))
    R, K = tails_pad.shape
    if p_pad.shape != (R, K) or (u is not None and u.shape != (R, K)) or perm.dim() != 1 \
            or offs.dim() != 1 or src.dim() != 2:
        raise ValueError(
            f"{name}: shapes src {tuple(src.shape)}, tails {tuple(tails_pad.shape)}, p "
            f"{tuple(p_pad.shape)}, u {None if u is None else tuple(u.shape)}, perm "
            f"{tuple(perm.shape)}, offs {tuple(offs.shape)} do not agree"
        )
    for t in (tails_pad, perm, offs):
        if t.dtype != torch.int32 or t.device != src.device or not t.is_contiguous():
            raise ValueError(f"{name}: tails_pad, perm and offs must be contiguous int32 on the card")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself, or a copy where its base is off the 16 bytes the
    kernel's vector loads of a row assume."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


# K10's geometry: a warp takes rows_per_warp consecutive rows, about this
# many waves of the card's resident warps over the rows
_WAVES = 4
_RESIDENT: Dict[Tuple[int, int], int] = {}


def k10_geometry(R: int, resident_warps: int) -> Tuple[int, int]:
    """(rows a warp, warps) of a K10 launch over R rows: about ``_WAVES``
    waves of the card's ``resident_warps``; the warps cover all R rows."""
    rows_per_warp = max(1, R // (resident_warps * _WAVES))
    return rows_per_warp, max(1, -(-R // rows_per_warp))


def _resident_warps(C: int, device: torch.device) -> int:
    key = (device.index or 0, min(C, 9))
    if key not in _RESIDENT:
        fn = _build.function("umap_sgd_epoch", "umap_sgd_epoch_resident_warps", [ctypes.c_int, _P])
        warps = ctypes.c_int(0)
        _build.check("umap_sgd_epoch", fn(C, ctypes.addressof(warps)))
        _RESIDENT[key] = warps.value
    return _RESIDENT[key]


def _k10_launch(src, h, rows, tails_pad, p_pad, perm, offs, u, seed, bits_out, out, a, b, gamma,
                attract_scale, alpha, *, knock: int = 0):
    """Launch K10 on card tensors; returns the launcher's status code.
    ``knock`` is a probe's bit mask (``chip_smoke.py --umap-only --sweep``;
    the wrappers launch with 0): parts of the work knocked out (1 the
    terms, 2 the powf, 4 the negatives' perm reads, 8 all but the
    launch), so that the results are wrong."""
    R, K = tails_pad.shape
    C = src.shape[1]
    if max(R, h.shape[0]) >= 2**31:
        raise ValueError(f"K10 takes fewer than 2^31 rows and heads, got {R} rows, {h.shape[0]} heads")
    if rows is None:
        rpw, warps = k10_geometry(R, _resident_warps(C, src.device))
        row_heads = row_off = part = arrive = None
    else:
        row_heads, row_off, part, arrive, rpw = rows
        warps = arrive.shape[0]
    fn = _build.function(
        "umap_sgd_epoch", "umap_sgd_epoch_launch",
        [_P, _P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_uint32, _P, _P, _P, _P, _I64, _I64, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, _I64, _F, _F, _F, _F, _F, _F, _F, ctypes.c_int, _I64, ctypes.c_int, _P],
    )

    def ptr(t):
        return None if t is None else t.data_ptr()

    # bound to names, so that an aligned copy outlives the launch's enqueue
    src_a, h_a = _aligned(src), _aligned(h)
    # the f32 constants the reference's expressions round to
    return fn(
        src_a.data_ptr(), h_a.data_ptr(), ptr(row_off), ptr(row_heads), tails_pad.data_ptr(),
        p_pad.data_ptr(), perm.data_ptr(), offs.data_ptr(), ptr(u), 0 if seed is None else int(seed) & _M32,
        ptr(bits_out), out.data_ptr(), ptr(part), ptr(arrive), R, h.shape[0], K, C, offs.shape[0], src.shape[0],
        a, b, b - 1.0, -2.0 * a * b, 2.0 * gamma * b, attract_scale, alpha, rpw, warps, knock,
        torch.cuda.current_stream(src.device).cuda_stream,
    )


def sgd_epoch_rows(
    src: torch.Tensor,
    h: torch.Tensor,
    tails_pad: torch.Tensor,
    p_pad: torch.Tensor,
    perm: torch.Tensor,
    offs: torch.Tensor,
    u: Optional[torch.Tensor],
    a: float,
    b: float,
    gamma: float,
    attract_scale: float,
    *,
    seed: Optional[int] = None,
    bits_out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Kernel K10, ROWS epilogue: one SGD epoch's per-row gradient sums
    (R, C) for the CSR-padded rows ``tails_pad``/``p_pad`` (R, K) with head
    rows ``h`` (R, C) against the table ``src`` (n_tab, C): slot (r, k) is
    active when ``u[r, k] < p_pad[r, k]`` (``u`` None: the uniforms of
    ``seed``, drawn in the kernel; ``bits_out``, an (R, K) int32 tensor,
    then receives each slot's bits); its negatives come from ``perm``
    (n_tab,) and ``offs`` (neg,) as in :func:`negative_ids`. Any C and neg.

    A CPU tensor goes to :func:`sgd_epoch_rows_plain`; a CUDA tensor to the
    CUDA kernel, or this raises. Replaces
    ``spark_rapids_ml_tpu/ops/umap_pallas.py::sgd_epoch_rows``."""
    if src.device.type == "cpu":
        if bits_out is not None:
            bits_out.copy_(slot_bits_plain(seed, *tails_pad.shape).to(torch.int32))
        return sgd_epoch_rows_plain(src, h, tails_pad, p_pad, perm, offs, u, a, b, gamma, attract_scale, seed=seed)
    _check_k10("sgd_epoch_rows", src, tails_pad, p_pad, perm, offs, u)
    _check_cuda_f32("sgd_epoch_rows", src, h)
    R, K = tails_pad.shape
    C = src.shape[1]
    if h.shape != (R, C) or (u is None and seed is None) or (bits_out is not None and (
            bits_out.shape != (R, K) or bits_out.dtype != torch.int32 or u is not None)):
        raise ValueError(
            f"sgd_epoch_rows: h {tuple(h.shape)} for {R} rows of C = {C}, u or seed, and bits_out (R, K) int32 "
            "with the kernel's draws only"
        )
    out = torch.empty((R, C), dtype=torch.float32, device=src.device)
    code = _k10_launch(src, h, None, tails_pad, p_pad, perm, offs, u, seed, bits_out, out, a, b, gamma,
                       attract_scale, 0.0)
    sgd_epoch_rows.launches += 1
    _build.check("umap_sgd_epoch", code)
    return out


sgd_epoch_rows.launches = 0


def sgd_epoch_step(
    emb: torch.Tensor,
    table: torch.Tensor,
    rows: HeadRows,
    tails_pad: torch.Tensor,
    p_pad: torch.Tensor,
    perm: torch.Tensor,
    offs: torch.Tensor,
    a: float,
    b: float,
    gamma: float,
    attract_scale: float,
    alpha: float,
    *,
    u: Optional[torch.Tensor] = None,
    seed: Optional[int] = None,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Kernel K10, STEP epilogue: one whole SGD epoch of ``emb`` (n_head,
    C) against ``table`` (n_tab, C) (``emb`` itself on the fit's self
    table): the next embedding ``emb + alpha·upd``, ``upd`` the sum of each
    head's rows' gradient sums, the rows of head i being ``rows.off[i] :
    rows.off[i + 1]`` (:func:`head_rows`); a head without rows is copied.
    Slot draws as in :func:`sgd_epoch_rows` (``u``, or the kernel's of
    ``seed``). Writes into ``out`` (not ``emb``) when given, else a new
    tensor. On the card, launches on one stream at a time: they share a
    workspace.

    A CPU tensor goes to :func:`sgd_epoch_step_plain`; a CUDA tensor to the
    CUDA kernel, or this raises. Replaces the TPU kernel with its caller's
    ``segment_sum`` and step (``umap_pallas.py:390-400``)."""
    if emb.device.type == "cpu":
        nxt = sgd_epoch_step_plain(emb, table, rows, tails_pad, p_pad, perm, offs, a, b, gamma,
                                   attract_scale, alpha, u=u, seed=seed)
        return nxt if out is None else out.copy_(nxt)
    _check_k10("sgd_epoch_step", table, tails_pad, p_pad, perm, offs, u)
    _check_cuda_f32("sgd_epoch_step", emb, table)
    n_head, C = emb.shape
    heads, off, part, arrive, rpw = rows
    if table.shape[1] != C or off.shape != (n_head + 1,) or off.dtype != torch.int64 or off.device != emb.device \
            or heads.shape != tails_pad.shape[:1] or heads.dtype != torch.int32 or heads.device != emb.device \
            or not heads.is_contiguous() or part is None or part.shape[2] != C \
            or part.shape[0] * rpw < tails_pad.shape[0] or (u is None and seed is None) \
            or (out is not None and (out.shape != emb.shape or out.dtype != emb.dtype or out.device != emb.device
                                     or not out.is_contiguous() or out.data_ptr() % 16
                                     or out.data_ptr() == emb.data_ptr())):
        raise ValueError(
            f"sgd_epoch_step: emb {tuple(emb.shape)}, table {tuple(table.shape)}, rows (heads "
            f"{tuple(heads.shape)} {heads.dtype}, off {tuple(off.shape)} {off.dtype}) from head_rows on the card for "
            "C components, u or seed, and out, a second aligned buffer of emb's shape"
        )
    nxt = torch.empty_like(emb) if out is None else out
    code = _k10_launch(table, emb, rows, tails_pad, p_pad, perm, offs, u, seed, None, nxt, a, b, gamma,
                       attract_scale, alpha)
    sgd_epoch_step.launches += 1
    _build.check("umap_sgd_epoch", code)
    return nxt


sgd_epoch_step.launches = 0


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
    start_epoch: int = 0,
    seed_base: Optional[int] = None,
    segment: int = 0,
    on_segment: Optional[Callable[[int, torch.Tensor], None]] = None,
) -> torch.Tensor:
    """Head-only negative-sampling SGD over CSR-padded rows: epochs
    ``start_epoch`` to ``n_epochs`` of ``emb_head`` (n_head, C) against
    ``table`` (n_tab, C) (for fit the embedding itself:
    ``self_table=True``); ``row_heads`` (R,) ascending, ``tails_pad`` (R, K)
    int32 and ``p_pad`` (R, K). Returns the new embedding (the input is not
    modified).

    Each epoch draws its permutation ``perm`` (n_tab,) and roll offsets
    ``offs`` (neg,) from ``generator`` (on the tensors' device), its slot
    uniforms from the hash of ``seed_base + e`` (``seed_base`` drawn from
    ``generator`` once a call by :func:`draw_seed_base` where not given),
    or takes all three from ``draws(e)``; then one K10 STEP launch into the
    second of two buffers. Attractive terms count twice on a self table:
    each directed edge moves only its head, and the reverse copy supplies
    the other endpoint's pull.

    ``segment`` > 0 walks the epochs in segments of that many from
    ``start_epoch``: each segment starts at an ``sgd:epoch`` fault site
    (``runtime.faults``) and ends with ``on_segment(epoch, emb)`` (the
    epochs done, the embedding after them). The learning rate and the
    hash are functions of the absolute epoch, so a walk resumed at a
    segment boundary with the generator's state and ``seed_base`` of that
    boundary takes the uninterrupted walk's epochs.
    """
    R = tails_pad.shape[0]
    n_tab = table.shape[0]
    neg = int(negative_sample_rate)
    dev = emb_head.device
    attract_scale = 2.0 if self_table else 1.0
    emb = emb_head.clone(memory_format=torch.contiguous_format)
    nxt = torch.empty_like(emb)
    rows = head_rows(row_heads, p_pad, emb.shape[0], emb.shape[1])
    if draws is not None:
        seed_base = 0
    elif seed_base is None:
        seed_base = draw_seed_base(generator, dev)
    for e in range(start_epoch, n_epochs):
        if segment and (e - start_epoch) % segment == 0:
            fault_site("sgd:epoch")
        if draws is None:
            u, seed = None, (seed_base + e) & _M32
            perm = torch.randperm(n_tab, generator=generator, device=dev, dtype=torch.int32)
            offs = torch.randint(0, R, (neg,), generator=generator, device=dev, dtype=torch.int32)
        else:
            (u, perm, offs), seed = draws(e), None
        sgd_epoch_step(emb, emb if self_table else table, rows, tails_pad, p_pad, perm, offs, a, b, gamma,
                       attract_scale, epoch_alpha(initial_alpha, e, n_epochs), u=u, seed=seed, out=nxt)
        emb, nxt = nxt, emb
        if segment and on_segment is not None and ((e + 1 - start_epoch) % segment == 0 or e + 1 == n_epochs):
            on_segment(e + 1, emb)
    return emb


def draw_seed_base(generator: Optional[torch.Generator], dev: torch.device) -> int:
    """The base of a ``umap_sgd`` call's slot-hash seeds: one draw from
    ``generator``, before the call's first epoch draws."""
    return int(torch.randint(0, 2**31 - 1, (1,), generator=generator, device=dev))
