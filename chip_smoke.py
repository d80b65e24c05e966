#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card.

    python3 chip_smoke.py               # full size: 12M x 256 f32
    python3 chip_smoke.py --rows 2000000

Phases (each prints one JSON line; any failure exits non-zero):

1. card: ``nvidia-smi`` name and power limit, torch and CUDA versions, and
   the parallel ``nvcc`` build of every kernel (with ptxas register/spill
   lines).
2. kernels: each kernel's wrapper on card tensors at the main path's shapes
   (and at ragged shapes) against its plain PyTorch version evaluated in
   f64 on the same inputs, each output entry within its own tolerance
   (see ``held``); at the main path's shapes a deliberately wrong output
   must fail the same check. Kernel, plain, library-call and bound times.
3. end to end: PCA(k=16), KMeans(k=1024, maxIter=10) and binomial
   LogisticRegression(maxIter=20) fit then transform through ``DataFrame``
   on N x 256 f32 rows made from ``--seed``; launch counters are zeroed
   before and read after, and every kernel must have run. Sanity checks,
   then a 100k-row subset fitted on the card and on the CPU (plain path)
   and compared.

The last three lines are the card line, ``{"kernels": [...]}`` and
``{"ok": true, "device": {...}}``. Without a CUDA card the script exits 1
and prints no result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

# H100 SXM data-sheet peaks: FP32 outside the
# tensor cores, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

E2E_D = 256
E2E_CENTRES = 1024


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def bound_ms(nbytes: float, flops: float):
    t_b = nbytes / PEAK_BYTES_PER_S * 1e3
    t_f = flops / PEAK_F32_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds per call by CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def make_data(torch, n_rows: int, n_alloc: int, seed: int, dev):
    """(X (n_alloc, 256) on the card with rows >= n_rows zero, labels (n_rows,)).

    Gaussian blobs around 1024 centres whose coordinates shrink
    geometrically (so the leading principal directions are separated), plus
    unit noise; binary labels from a random hyperplane through the median."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    scales = 4.0 * 0.9 ** torch.arange(E2E_D, device=dev, dtype=torch.float32)
    centres = torch.randn(E2E_CENTRES, E2E_D, generator=g, device=dev) * scales
    X = torch.zeros((n_alloc, E2E_D), dtype=torch.float32, device=dev)
    step = 1 << 20
    for lo in range(0, n_rows, step):
        hi = min(lo + step, n_rows)
        lab = torch.randint(0, E2E_CENTRES, (hi - lo,), generator=g, device=dev)
        X[lo:hi] = torch.randn(hi - lo, E2E_D, generator=g, device=dev) + centres[lab]
    w = torch.randn(E2E_D, generator=g, device=dev)
    z = X[:n_rows] @ w
    y = (z > z.median()).to(torch.float32)
    return X, y


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

# Each f32 kernel output entry is held against the plain version evaluated
# in f64 on the same inputs (upcast), entry by entry:
#     |out - ref| <= u * (TOL_TERMS * T + TOL_WALK * sqrt(n) * |ref|) + slack
# with u the f32 unit roundoff and T the sum of the absolute values of the
# terms the entry adds up (and of the rounding of what feeds them). The first
# part covers the rounding of each term and the accumulation of terms that
# cancel; the second the accumulation of terms that drift one way, as a
# random walk over at most n additions (any summation order, atomics
# included). A tolerance scaled by each entry's own terms keeps the small
# entries (the noise dimensions of the data) as tightly checked as the large.
U32 = 2.0 ** -24
TOL_TERMS = 8.0
TOL_WALK = 4.0
# K2 score rounding band: two f32 scores within TAU_UNITS * u * sqrt(d) *
# (||x||² + 2 max ||c||²) may order either way (a length-d dot product
# rounds as a random walk)
TAU_UNITS = 4.0
REF_CHUNK = 1 << 20


def held(torch, out, ref, T, n, slack=None):
    """Per-entry comparison of ``out`` with the f64 ``ref``; returns the
    largest absolute error and the largest rounding error over its
    tolerance (the error beyond ``slack``, the part a known cause such as a
    near tie explains). Holds when the ratio is at most 1."""
    ref = ref.to(torch.float64)
    err = (out.to(torch.float64) - ref).abs()
    tol = U32 * (TOL_TERMS * T + TOL_WALK * (n ** 0.5) * ref.abs())
    excess = err if slack is None else torch.clamp(err - slack, min=0.0)
    ratio = torch.where(excess > 0, excess / tol, torch.zeros_like(err))
    return float(err.max()), float(ratio.max())


def negative_controls(torch, cases, ref, T, n, slack=None):
    """The same check on deliberately wrong outputs ``{what: bad}``: each
    must fail. Also says whether a tolerance of 1e-4 of the largest entry
    (the check this one replaced) would have caught it."""
    old_tol = 1e-4 * float(ref.abs().max())
    out = []
    for what, bad in cases.items():
        err, ratio = held(torch, bad, ref, T, n, slack)
        check(ratio > 1.0, f"the check does not catch a wrong result ({what}): err/tol {ratio:.3g}")
        out.append({"control": what, "max_abs_err": err, "err_over_tol": ratio,
                    "caught_by_1e-4_of_max": err > old_tol})
    return out


# rows that the subtle controls lose: one of this many row ranges
CONTROL_SPLIT = 64


def gram_reference(torch, lin, X, m, mu):
    """K1's plain version in f64, in row chunks, with the absolute sums T."""
    d, f64 = X.shape[1], torch.float64
    G = torch.zeros((d, d), dtype=f64, device=X.device)
    TG = torch.zeros_like(G)
    s = torch.zeros((d,), dtype=f64, device=X.device)
    Ts = torch.zeros_like(s)
    mu64 = mu.to(f64)
    for lo in range(0, X.shape[0], REF_CHUNK):
        x, mm = X[lo:lo + REF_CHUNK].to(f64), m[lo:lo + REF_CHUNK].to(f64)
        g, sc = lin.shifted_gram_plain(x, mm, mu64)
        a = ((x - mu64) * mm[:, None]).abs()
        G += g
        s += sc
        TG += a.T @ a
        Ts += a.sum(dim=0)
    return G, s, TG, Ts


def check_shifted_gram(torch, lin, X, m, reps, control=False):
    n, d = X.shape
    mu = X[:: max(1, n // 65536)][:65536].mean(dim=0).contiguous()
    G, s = lin.shifted_gram(X, m, mu)
    Gr, sr, TG, Ts = gram_reference(torch, lin, X, m, mu)
    err_G, r_G = held(torch, G, Gr, TG, n)
    err_s, r_s = held(torch, s, sr, Ts, n)
    check(r_G <= 1.0 and r_s <= 1.0,
          f"shifted_gram {n}x{d}: |dG|/tol {r_G:.3g} or |ds|/tol {r_s:.3g} above 1")
    out = {"n": n, "d": d, "max_abs_err": err_G, "err_over_tol": r_G, "s_err": err_s,
           "s_err_over_tol": r_s}
    if control:  # a kernel that loses an output tile, or one row range in a tile
        tile = G.clone()
        tile[128:, :128] = 0.0
        tile[:128, 128:] = 0.0
        L = n // CONTROL_SPLIT
        lost = lin.shifted_gram_plain(X[:L], m[:L], mu)[0]
        lost[:128, :] = 0.0
        lost[:, :128] = 0.0
        lost.fill_diagonal_(0.0)
        out["controls"] = negative_controls(torch, {
            "off-diagonal 128x128 tile zeroed": tile,
            f"first 1/{CONTROL_SPLIT} of rows lost in G[128:, 128:] off the diagonal": G - lost,
        }, Gr, TG, n)
    if reps:
        Xc = (X - mu) * m[:, None]
        out["ms"] = cuda_ms(torch, lambda: lin.shifted_gram(X, m, mu), reps)
        out["plain_ms"] = cuda_ms(torch, lambda: lin.shifted_gram_plain(X, m, mu), reps)
        out["library_ms"] = cuda_ms(torch, lambda: torch.matmul(Xc.T, Xc), reps)
        del Xc
        nbytes = 4.0 * (n * d + n + d + d * d + d)
        flops = float(n) * d * (d + 1) + 3.0 * n * d  # symmetric G + shift/mask/sum
        out["bound_ms"], out["bound_by"] = bound_ms(nbytes, flops)
    return out


def lloyd_reference(torch, kk, X, m, C, chunk=1 << 17):
    """K2's plain version in f64, in row chunks, with the absolute sums T
    and the near ties: rows whose second (or third) best f64 score lies
    within the f32 rounding band of the best, which the kernel may assign
    to any of those centres. For each centre, ``near`` counts such rows
    with the centre in their band and ``slack`` adds up their ``m·|x|``."""
    k, d = C.shape
    f64, dev = torch.float64, X.device
    C64 = C.to(f64)
    C64_abs = C64.abs()
    c_sq = (C64 * C64).sum(dim=1)
    c_sq_max = float(c_sq.max())
    r = {"sums": torch.zeros((k, d), dtype=f64, device=dev),
         "counts": torch.zeros((k,), dtype=torch.int64, device=dev),
         "cost": torch.zeros((), dtype=f64, device=dev),
         "T": torch.zeros((k, d), dtype=f64, device=dev),
         "T_cost": torch.zeros((), dtype=f64, device=dev),
         "near": torch.zeros((k,), dtype=torch.int64, device=dev),
         "slack": torch.zeros((k, d), dtype=f64, device=dev),
         "slack_cost": torch.zeros((), dtype=f64, device=dev),
         "near_rows": 0}
    for lo in range(0, X.shape[0], chunk):
        x, mm = X[lo:lo + chunk].to(f64), m[lo:lo + chunk].to(f64)
        s_, c_, cost_ = kk.lloyd_step_plain(x, mm, C64)
        r["sums"] += s_
        r["counts"] += c_.to(torch.int64)
        r["cost"] += cost_
        sc = c_sq[None, :] - 2.0 * (x @ C64.T)
        _, a = torch.min(sc, dim=1)
        ax = x.abs() * mm[:, None]
        r["T"].index_add_(0, a, ax)
        r["T_cost"] += (mm * ((x.abs() + C64_abs[a]) ** 2).sum(dim=1)).sum()
        if k < 2:
            continue
        top = torch.topk(sc, min(k, 3), dim=1, largest=False)
        tau = TAU_UNITS * U32 * d ** 0.5 * ((x * x).sum(dim=1) + 2.0 * c_sq_max)
        near_row = ((top.values[:, 1] - top.values[:, 0]) < tau) & (mm > 0)
        band = ((top.values - top.values[:, :1]) < tau[:, None]) & near_row[:, None]
        for col in range(top.indices.shape[1]):
            sel = band[:, col]
            r["near"] += torch.bincount(top.indices[sel, col], minlength=k)
            r["slack"].index_add_(0, top.indices[sel, col], ax[sel])
        r["slack_cost"] += (tau * mm)[near_row].sum()
        r["near_rows"] += int(near_row.sum())
    return r


def check_lloyd_step(torch, kk, X, m, C, reps, control=False):
    n, d = X.shape
    k = C.shape[0]
    sums, counts, cost = kk.lloyd_step(X, m, C)
    ref = lloyd_reference(torch, kk, X, m, C)
    # a row may change centre only across a near tie
    dcount = (counts.to(torch.int64) - ref["counts"]).abs()
    counts_ok = bool((dcount <= ref["near"]).all())
    err, r_sums = held(torch, sums, ref["sums"], ref["T"], n, ref["slack"])
    _, r_cost = held(torch, cost, ref["cost"], ref["T_cost"], n, ref["slack_cost"])
    check(counts_ok and r_sums <= 1.0 and r_cost <= 1.0,
          f"lloyd_step {n}x{d} k={k}: counts beyond the near ties ({counts_ok}), "
          f"|dsums|/tol {r_sums:.3g} or |dcost|/tol {r_cost:.3g} above 1")
    out = {"n": n, "d": d, "k": k, "max_abs_err": err, "err_over_tol": r_sums,
           "count_changes": int(dcount.sum()), "near_tie_rows": ref["near_rows"],
           "cost_rel_err": abs(float(cost) - float(ref["cost"])) / float(ref["cost"]),
           "cost_err_over_tol": r_cost}
    if control:  # a kernel that loses the second feature tile, or one row range in it
        tile = sums.clone()
        tile[:, 128:] = 0.0
        L = n // CONTROL_SPLIT
        lost = sums.clone()
        lost[:, 128:] -= kk.lloyd_step_plain(X[:L], m[:L], C)[0][:, 128:]
        out["controls"] = negative_controls(torch, {
            "sums[:, 128:] zeroed": tile,
            f"first 1/{CONTROL_SPLIT} of rows lost in sums[:, 128:]": lost,
        }, ref["sums"], ref["T"], n, ref["slack"])
    del ref
    if reps:
        c_sq = (C * C).sum(dim=1)

        def library():  # score product, argmin, index_add_, 1M rows a call
            acc = torch.zeros_like(sums)
            for lo in range(0, n, 1 << 20):
                xs = X[lo:lo + (1 << 20)]
                a = torch.argmin(c_sq[None, :] - 2.0 * (xs @ C.T), dim=1)
                acc.index_add_(0, a, xs * m[lo:lo + (1 << 20), None])
            return acc

        out["ms"] = cuda_ms(torch, lambda: kk.lloyd_step(X, m, C), reps)
        out["plain_ms"] = cuda_ms(torch, lambda: kk.lloyd_step_plain(X, m, C), reps)
        out["library_ms"] = cuda_ms(torch, library, reps)
        nbytes = 4.0 * (n * d + n + k * d + k * d + k + 1)
        flops = 2.0 * n * k * d + 2.0 * n * d + 3.0 * n * k  # scores, sums+||x||², argmin
        out["bound_ms"], out["bound_by"] = bound_ms(nbytes, flops)
    return out


def logreg_reference(torch, lk, X, y, m, A, b, multinomial):
    """K3's plain version in f64, in row chunks, with the absolute sums T.
    A residual is at most 1 in size; the f32 logits are off by at most
    about u·S (S = the row's largest Σ|x·a| + |b|), which moves a residual
    or a row's loss by at most 2·u·S: each row weighs (1 + 2S) in T."""
    d, K, f64 = X.shape[1], A.shape[0], torch.float64
    A64, b64 = A.to(f64), b.to(f64)
    loss = torch.zeros((), dtype=f64, device=X.device)
    gA = torch.zeros((K, d), dtype=f64, device=X.device)
    gb = torch.zeros((K,), dtype=f64, device=X.device)
    T_row = torch.zeros((d,), dtype=f64, device=X.device)
    T_b = torch.zeros((), dtype=f64, device=X.device)
    T_z = torch.zeros((), dtype=f64, device=X.device)
    for lo in range(0, X.shape[0], REF_CHUNK):
        x, mm = X[lo:lo + REF_CHUNK].to(f64), m[lo:lo + REF_CHUNK].to(f64)
        l_, gA_, gb_ = lk.logreg_loss_grad_plain(x, y[lo:lo + REF_CHUNK].to(f64), mm, A64, b64,
                                                 multinomial)
        loss += l_
        gA += gA_
        gb += gb_
        S = (x.abs() @ A64.abs().T + b64.abs()[None, :]).max(dim=1).values
        w = mm * (1.0 + 2.0 * S)
        T_row += w @ x.abs()
        T_b += w.sum()
        T_z += (2.0 * mm * S).sum()
    T_gA = T_row[None, :].expand(K, d)
    return loss, gA, gb, T_gA, T_b.expand(K), loss.abs() + T_z


def check_logreg(torch, lk, X, y, m, K, reps, seed, control=False):
    n, d = X.shape
    g = torch.Generator(device=X.device)
    g.manual_seed(seed)
    A = (torch.randn(K, d, generator=g, device=X.device) * 0.05).contiguous()
    b = torch.randn(K, generator=g, device=X.device) * 0.1
    multinomial = K > 1
    yk = y if not multinomial else torch.randint(0, K, (n,), generator=g, device=X.device).float()
    loss, gA, gb = lk.logreg_loss_grad(X, yk, m, A, b, multinomial)
    lr, gAr, gbr, T_gA, T_gb, T_loss = logreg_reference(torch, lk, X, yk, m, A, b, multinomial)
    err, r_gA = held(torch, gA, gAr, T_gA, n)
    gb_err, r_gb = held(torch, gb, gbr, T_gb, n)
    _, r_loss = held(torch, loss, lr, T_loss, n)
    check(r_gA <= 1.0 and r_gb <= 1.0 and r_loss <= 1.0,
          f"logreg_loss_grad {n}x{d} K={K}: |dgA|/tol {r_gA:.3g}, |dgb|/tol {r_gb:.3g} "
          f"or |dloss|/tol {r_loss:.3g} above 1")
    out = {"n": n, "d": d, "K": K, "max_abs_err": err, "err_over_tol": r_gA,
           "loss_rel_err": abs(float(loss) - float(lr)) / abs(float(lr)),
           "loss_err_over_tol": r_loss, "gb_err": gb_err, "gb_err_over_tol": r_gb}
    if control:  # a kernel that loses the second feature tile, or one row range in it
        tile = gA.clone()
        tile[:, 128:] = 0.0
        L = n // CONTROL_SPLIT
        lost = gA.clone()
        lost[:, 128:] -= lk.logreg_loss_grad_plain(X[:L], yk[:L], m[:L], A, b, multinomial)[1][:, 128:]
        out["controls"] = negative_controls(torch, {
            "gA[:, 128:] zeroed": tile,
            f"first 1/{CONTROL_SPLIT} of rows lost in gA[:, 128:]": lost,
        }, gAr, T_gA, n)
    if reps:
        def library():  # autograd of the plain loss
            Ar = A.detach().requires_grad_(True)
            br = b.detach().requires_grad_(True)
            z = X @ Ar.T + br[None, :]
            if multinomial:
                ll = torch.logsumexp(z, 1) - z.gather(1, yk.long()[:, None])[:, 0]
            else:
                ll = torch.nn.functional.softplus(z[:, 0]) - yk * z[:, 0]
            return torch.autograd.grad((ll * m).sum(), (Ar, br))

        out["ms"] = cuda_ms(torch, lambda: lk.logreg_loss_grad(X, yk, m, A, b, multinomial), reps)
        out["plain_ms"] = cuda_ms(
            torch, lambda: lk.logreg_loss_grad_plain(X, yk, m, A, b, multinomial), reps)
        out["library_ms"] = cuda_ms(torch, library, reps)
        nbytes = 4.0 * (n * d + 2 * n + 2 * K * d + 2 * K + 1)
        flops = 4.0 * n * K * d + 10.0 * n * K  # logits + R^T x, loss/residual
        out["bound_ms"], out["bound_by"] = bound_ms(nbytes, flops)
    return out


def phase_kernels(torch, X_pca, n_rows, reps, seed):
    from spark_rapids_ml_tpu_torch.ops import kmeans_kernels as kk
    from spark_rapids_ml_tpu_torch.ops import linalg as lin
    from spark_rapids_ml_tpu_torch.ops import logreg_kernels as lk

    dev = X_pca.device
    m_pca = torch.zeros(X_pca.shape[0], device=dev)
    m_pca[:n_rows] = 1.0
    X = X_pca[:n_rows]
    m = torch.ones(n_rows, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 1)
    res = {}

    res["shifted_gram"] = check_shifted_gram(torch, lin, X_pca, m_pca, reps, control=True)
    emit({"phase": "kernels", "kernel": "shifted_gram", **res["shifted_gram"]})

    # k = 1024: the Lloyd iterations; ~4k: count_closest over the k-means||
    # candidates (1 + 2 steps x 2k draws at oversampling 2)
    idx = torch.randint(0, n_rows, (4097,), generator=g, device=dev)
    C1024 = X[idx[:1024]] + 0.1 * torch.randn(1024, E2E_D, generator=g, device=dev)
    res["lloyd_step"] = check_lloyd_step(torch, kk, X, m, C1024.contiguous(), reps, control=True)
    emit({"phase": "kernels", "kernel": "lloyd_step", **res["lloyd_step"]})
    res["lloyd_step_4097"] = check_lloyd_step(torch, kk, X, m, X[idx].contiguous(),
                                              max(1, reps // 2), control=True)
    emit({"phase": "kernels", "kernel": "lloyd_step", **res["lloyd_step_4097"]})

    y = (X[:, 0] > X[:, 0].median()).float()
    res["logreg_loss_grad"] = check_logreg(torch, lk, X, y, m, 1, reps, seed, control=True)
    emit({"phase": "kernels", "kernel": "logreg_loss_grad", **res["logreg_loss_grad"]})
    res["logreg_loss_grad_10"] = check_logreg(torch, lk, X, y, m, 10, reps, seed, control=True)
    emit({"phase": "kernels", "kernel": "logreg_loss_grad", **res["logreg_loss_grad_10"]})

    # ragged shapes: n, d, k and K off every tile size
    for n_r, d_r in ((100_003, 300), (50_001, 124), (1_037, 3000)):
        Xr = torch.randn(n_r, d_r, generator=g, device=dev) + 3.0
        mr = (torch.rand(n_r, generator=g, device=dev) > 0.1).float()
        yr = (torch.rand(n_r, generator=g, device=dev) > 0.5).float()
        emit({"phase": "kernels", "kernel": "shifted_gram", "ragged": True,
              **check_shifted_gram(torch, lin, Xr, mr, 0)})
        for k_r in (1, 37, 130):
            Cr = Xr[torch.randint(0, n_r, (k_r,), generator=g, device=dev)].contiguous()
            emit({"phase": "kernels", "kernel": "lloyd_step", "ragged": True,
                  **check_lloyd_step(torch, kk, Xr, mr, Cr, 0)})
        for K_r in (1, 5, 130):
            emit({"phase": "kernels", "kernel": "logreg_loss_grad", "ragged": True,
                  **check_logreg(torch, lk, Xr, yr, mr, K_r, 0, seed)})
        del Xr
    torch.cuda.synchronize()
    return res


# ---------------------------------------------------------------------------
# phase 3: end to end
# ---------------------------------------------------------------------------


def _timed(torch, fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def phase_e2e(torch, X_host, y_host, seed):
    from spark_rapids_ml_tpu_torch import DataFrame
    from spark_rapids_ml_tpu_torch.classification import LogisticRegression
    from spark_rapids_ml_tpu_torch.clustering import KMeans
    from spark_rapids_ml_tpu_torch.feature import PCA
    from spark_rapids_ml_tpu_torch.ops import kmeans_kernels as kk
    from spark_rapids_ml_tpu_torch.ops import linalg as lin
    from spark_rapids_ml_tpu_torch.ops import logreg_kernels as lk

    wrappers = {"shifted_gram": lin.shifted_gram, "lloyd_step": kk.lloyd_step,
                "logreg_loss_grad": lk.logreg_loss_grad}
    n = X_host.shape[0]
    df = DataFrame({"features": X_host, "label": y_host})
    # the host->device copy every fit starts with, on its own
    from spark_rapids_ml_tpu_torch.parallel.mesh import shard_rows

    placed, t_h2d = _timed(torch, lambda: shard_rows(X_host, torch.device("cuda:0")))
    del placed
    emit({"phase": "e2e", "check": "host_to_device", "bytes": X_host.nbytes, "s": t_h2d,
          "gb_per_s": X_host.nbytes / t_h2d / 1e9})
    for w in wrappers.values():
        w.launches = 0

    pca = PCA(k=16)
    pm, t_fit = _timed(torch, lambda: pca.fit(df))
    out, t_tr = _timed(torch, lambda: pm.transform(df))
    proj = out.column("pca_features")
    evr = pm.explained_variance_ratio_
    check(proj.shape == (n, 16) and np.isfinite(proj).all(), "PCA transform not finite/shape")
    check(bool(((evr > 0) & (evr <= 1)).all()) and float(evr.sum()) <= 1.0 + 1e-5,
          f"PCA explained-variance ratios outside (0, 1]: {evr}")
    emit({"phase": "e2e", "estimator": "PCA", "k": 16, "rows": n, "fit_s": t_fit,
          "transform_s": t_tr, "fit_rows_per_s": n / t_fit, "transform_rows_per_s": n / t_tr,
          "explained_variance_ratio_sum": float(evr.sum()),
          "shifted_gram_launches": wrappers["shifted_gram"].launches})

    km = KMeans(k=E2E_CENTRES, maxIter=10, seed=seed)
    kmm, t_fit = _timed(torch, lambda: km.fit(df))
    out, t_tr = _timed(torch, lambda: kmm.transform(df))
    pred = out.column("prediction")
    check(pred.shape == (n,) and int(pred.min()) >= 0 and int(pred.max()) < E2E_CENTRES,
          "KMeans predictions out of range")
    check(np.isfinite(kmm.cluster_centers_).all() and np.isfinite(kmm.trainingCost),
          "KMeans centres or cost not finite")
    emit({"phase": "e2e", "estimator": "KMeans", "k": E2E_CENTRES, "maxIter": 10, "rows": n,
          "fit_s": t_fit, "transform_s": t_tr, "fit_rows_per_s": n / t_fit,
          "transform_rows_per_s": n / t_tr, "n_iter": kmm.numIter, "cost": kmm.trainingCost,
          "lloyd_step_launches": wrappers["lloyd_step"].launches})

    lr = LogisticRegression(maxIter=20)
    lrm, t_fit = _timed(torch, lambda: lr.fit(df))
    out, t_tr = _timed(torch, lambda: lrm.transform(df))
    prob = out.column("probability")
    acc = float((out.column("prediction") == y_host).mean())
    check(np.isfinite(prob).all() and np.isfinite(lrm.coefficients).all(), "LogReg not finite")
    check(acc > 0.95, f"LogReg accuracy {acc} on hyperplane labels <= 0.95")
    emit({"phase": "e2e", "estimator": "LogisticRegression", "maxIter": 20, "rows": n,
          "fit_s": t_fit, "transform_s": t_tr, "fit_rows_per_s": n / t_fit,
          "transform_rows_per_s": n / t_tr, "n_iter": lrm.n_iter_, "accuracy": acc,
          "logreg_loss_grad_launches": wrappers["logreg_loss_grad"].launches})

    launches = {name: w.launches for name, w in wrappers.items()}
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched on the main path")

    # the seeds' cost: maxIter=0 runs the same seeding, then the cost pass
    # (its fit time is the copy + seeding + one cost pass: the Lloyd-free part)
    km0, t_seed = _timed(torch, lambda: KMeans(k=E2E_CENTRES, maxIter=0, seed=seed).fit(df))
    check(kmm.trainingCost <= km0.trainingCost * (1 + 1e-6),
          f"KMeans cost {kmm.trainingCost} above its seeds' {km0.trainingCost}")
    emit({"phase": "e2e", "check": "kmeans_cost_vs_seeds", "cost": kmm.trainingCost,
          "seed_cost": km0.trainingCost, "maxIter0_fit_s": t_seed})
    return launches


def phase_subset(torch, X_host, y_host, seed, rows):
    """The same fits on the card and on the CPU (plain path) on a subset."""
    from spark_rapids_ml_tpu_torch import DataFrame
    from spark_rapids_ml_tpu_torch.classification import LogisticRegression
    from spark_rapids_ml_tpu_torch.clustering import KMeans
    from spark_rapids_ml_tpu_torch.feature import PCA

    df = DataFrame({"features": X_host[:rows], "label": y_host[:rows]})
    fits = {}
    for dev in ("cuda:0", "cpu"):
        fits[dev] = (
            PCA(k=16, device=dev).fit(df),
            KMeans(k=E2E_CENTRES, maxIter=10, seed=seed, device=dev).fit(df),
            LogisticRegression(maxIter=20, device=dev).fit(df),
        )
    (pg, kg, lg), (pc, kc, lc) = fits["cuda:0"], fits["cpu"]
    # PCA: separated spectrum, f32 sums in other orders
    evr_err = float(np.abs(pg.explained_variance_ratio_ - pc.explained_variance_ratio_).max()
                    / np.abs(pc.explained_variance_ratio_).max())
    pc_err = float(np.abs(pg.pc - pc.pc).max())
    # KMeans: the same seed draws the same numbers, but an ulp of distance
    # may flip one draw near its threshold: hold the cost, not the centres
    cost_rel = abs(kg.trainingCost - kc.trainingCost) / kc.trainingCost
    # LogReg: 20 L-BFGS steps in f32 on each side
    coef_err = float(np.abs(lg.coefficients - lc.coefficients).max() / np.abs(lc.coefficients).max())
    agree = float((lg.transform(df).column("prediction") == lc.transform(df).column("prediction")).mean())
    res = {"phase": "subset", "rows": rows, "pca_evr_rel_err": evr_err, "pca_evr_tol": 1e-4,
           "pca_pc_abs_err": pc_err, "pca_pc_tol": 1e-3, "kmeans_cost_rel_err": cost_rel,
           "kmeans_cost_tol": 0.02, "logreg_coef_rel_err": coef_err, "logreg_coef_tol": 0.05,
           "logreg_prediction_agreement": agree, "logreg_agreement_min": 0.995}
    emit(res)
    check(evr_err <= 1e-4 and pc_err <= 1e-3, "PCA card vs CPU beyond tolerance")
    check(cost_rel <= 0.02, "KMeans card vs CPU cost beyond tolerance")
    check(coef_err <= 0.05 and agree >= 0.995, "LogReg card vs CPU beyond tolerance")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=12_000_000, help="end-to-end rows (N x 256 f32)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=3, help="timed calls per kernel measurement")
    ap.add_argument("--subset", type=int, default=100_000, help="rows of the card-vs-CPU fits")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 1
    from spark_rapids_ml_tpu_torch.ops import _build

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in exact f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    t = time.perf_counter()
    build_s = _build.build()
    build_total = time.perf_counter() - t
    ptxas = {
        name: [ln.strip() for ln in (_build.BUILD_DIR / f"{name}.log").read_text().splitlines()
               if "registers" in ln or "spill" in ln]
        for name in _build.SOURCES if (_build.BUILD_DIR / f"{name}.log").exists()
    }
    emit({"phase": "card", "nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda, "build_s": build_s,
          "build_total_s": build_total, "ptxas": ptxas})

    # the PCA fit pads rows to its chunk multiple: the kernels see that shape
    from spark_rapids_ml_tpu_torch.feature import PCA

    n = args.rows
    csize = PCA._equal_chunk_rows(n, 1, 65_536)
    n_pca = -(-n // csize) * csize
    X, y = make_data(torch, n, n_pca, args.seed, dev)
    kern = phase_kernels(torch, X, n, args.reps, args.seed)
    X_host = X[:n].cpu().numpy()
    y_host = y.cpu().numpy()
    del X, y
    torch.cuda.empty_cache()
    launches = phase_e2e(torch, X_host, y_host, args.seed)
    phase_subset(torch, X_host, y_host, args.seed, min(args.subset, n))

    sources = {
        "shifted_gram": ("spark_rapids_ml_tpu/ops/linalg.py:141", "shifted_gram"),
        "lloyd_step": ("spark_rapids_ml_tpu/ops/kmeans_pallas.py:174", "lloyd_step"),
        "logreg_loss_grad": ("spark_rapids_ml_tpu/ops/logreg_pallas.py:152", "logreg_loss_grad"),
    }
    kernels = []
    for name, (replaces, key) in sources.items():
        r = kern[key]
        entry = {
            "name": name, "route": "cuda",
            "source": f"spark_rapids_ml_tpu_torch/csrc/{name}.cu", "replaces": replaces,
            "launches": launches[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": {k: r[k] for k in ("n", "d", "k", "K") if k in r},
        }
        kernels.append(entry)
    extra = {"lloyd_step_k4097": kern["lloyd_step_4097"], "logreg_loss_grad_K10": kern["logreg_loss_grad_10"]}
    emit({"phase": "done", "total_s": time.perf_counter() - t_start, "extra_shapes": extra})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
