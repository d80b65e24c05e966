"""Exact kNN of the port: the fused distance + running top-k pass (kernel
K4, ``csrc/knn_topk.cu``) beside its plain PyTorch version, and a
single-device search (counterpart of ``spark_rapids_ml_tpu/ops/
knn_kernels.py`` and ``knn_pallas.py``).

The JAX package's ``ring_knn`` rotates item shards around a device ring;
on one card there is no ring, and the search is one pass over all items.
Results are ordered by (distance, id), so an exact tie keeps the lower id,
as ``lax.top_k`` does.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build
from .linalg import _check_cuda_f32

_I64, _P = ctypes.c_int64, ctypes.c_void_p

# the kernel keeps k (score, id) pairs per query row in shared memory
MAX_K = 128
# chunks of the plain version: bound its (queries, items) score tile
_Q_CHUNK = 4096
_I_CHUNK = 32768


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
    state, or one this function returned) and goes out so.

    A CPU tensor goes to :func:`knn_topk_pass_plain`; a CUDA tensor to the
    CUDA kernel (k <= 128), or this raises. Replaces
    ``spark_rapids_ml_tpu/ops/knn_pallas.py::knn_pallas_pass``."""
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
    # the kernel updates the state in place
    topd, topi = (t.clone(memory_format=torch.contiguous_format) for t in (topd, topi))
    fn = _build.function(
        "knn_topk", "knn_topk_launch",
        [_P, _P, _P, _P, _P, _P, _I64, _I64, ctypes.c_int, ctypes.c_int, _P],
    )
    code = fn(
        Xq.data_ptr(), Xi.data_ptr(), csq_eff.data_ptr(), ids.data_ptr(), topd.data_ptr(),
        topi.data_ptr(), nq, ni, d, k, torch.cuda.current_stream(Xq.device).cuda_stream,
    )
    knn_topk_pass.launches += 1
    _build.check("knn_topk", code)
    return topd, topi


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
