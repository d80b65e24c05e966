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
   K4 (kNN distance + top-k) at 131,072 queries x 1M items x 256, k = 16,
   on a 4,096-row sample, at the UMAP graph (k = 16) and transform (k =
   15) shapes of 65,536 x 65,536 x 256 on a 4,096-row sample, and in full
   at ragged shapes; K10 (one UMAP SGD epoch) on the rows of the 65,536 x
   256 UMAP graph and at the transform's shape (65,536 rows, K = 15); the
   forest kernels at the builder's own level layouts: K5 (sub-block
   histograms) at the deepest (level 12) and a shallow (level 2) call of
   the bench forest (131,072 x 256, 8 trees a batch, k = 16, 128 bins),
   the regressor's S = 3 call and ragged shapes, exact for integer stats,
   repeatable bit for bit; K6 (fused selection) at the 131,072 x 3,000
   level-12 call and a ragged one with n_features == d_pad; K9 (packed
   traversal) on one transform batch of a depth-13, 50-tree forest, at
   3,000 features and at k2 in {1, 6}, equal to its plain version.
3. end to end, each path with the launch counters zeroed just before it
   and read just after (every kernel of the path must have run): PCA(k=16),
   KMeans(k=1024, maxIter=10) and binomial LogisticRegression(maxIter=20)
   fit then transform through ``DataFrame`` on N x 256 f32 rows made from
   ``--seed``, with a 100k-row subset fitted on the card and on the CPU
   (plain path) and compared; NearestNeighbors(k=16).kneighbors of the
   first 131,072 of 1M of those rows against all 1M, and a join; UMAP(
   n_neighbors=15, random_state=42) fit, transform and save/load at
   65,536 x 256 (bench.py's blobs), held by trustworthiness on a 4,096-row
   sample, and a 20,000-row UMAP fitted on the card and on the CPU;
   RandomForestClassifier(numTrees=50, maxDepth=13, maxBins=128) fit,
   transform, save/load and transform on the first 131,072 rows (bench.py's
   rf config), RandomForestRegressor(numTrees=8) on the same rows with a
   real-valued label, RandomForestClassifier(numTrees=8) on 131,072 x 3,000
   rows (the reference's benchmark width: K6), and an 8-tree depth-10
   forest on 20,000 rows fitted on the card and on the CPU (the same draws:
   predictions agree on >= 99.9% of rows).

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
# the kNN and UMAP shapes of bench.py (KNN_QUERIES x KNN_ITEMS, UMAP_ROWS)
KNN_QUERIES = 131_072
KNN_ITEMS = 1_000_000
KNN_K = 16
UMAP_ROWS = 65_536
UMAP_NEIGHBORS = 15
# trustworthiness threshold of tests/test_umap.py, on a sample of this many rows
TRUST_MIN = 0.85
TRUST_ROWS = 4096
# rows of the UMAP fitted on the card and on the CPU
UMAP_SUBSET = 20_000
# bench.py's rf config (bench.py:652-728): 131,072 x 256, 50 trees, depth
# 13, 128 bins; the regressor and the 3,000-feature forest (the
# reference's benchmark width, rows cut from 1M) keep 8 trees
RF_ROWS = 131_072
RF_TREES = 50
RF_DEPTH = 13
RF_BINS = 128
RF_SMALL_TREES = 8
RF_WIDE_D = 3000
# the forest fitted on the card and on the CPU
RF_SUBSET_ROWS = 20_000
RF_SUBSET_DEPTH = 10
RF_AGREE_MIN = 0.999


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


def knn_reference(torch, kn, Xq, Xi, csq, ids, k):
    """K4's plain version in f64 at k + 1: (d2 (nq, k+1) in (distance, id)
    order, ids, tau). tau bounds the f32 error of each entry's distance:
    TAU_UNITS·u·√d·(‖xq‖² + 2 Σ|xq·xi| + ‖xi‖²), the K2 band with the
    entry's own terms."""
    f64 = torch.float64
    Xq64 = Xq.to(f64)
    state = (torch.full((Xq.shape[0], k + 1), float("inf"), dtype=f64, device=Xq.device),
             torch.full((Xq.shape[0], k + 1), -1, dtype=torch.int32, device=Xq.device))
    csq64 = (Xi.to(f64) ** 2).sum(dim=1).masked_fill(~torch.isfinite(csq), float("inf"))
    s, i = kn.knn_topk_pass_plain(Xq64, Xi.to(f64), csq64, ids, *state)
    xsq = (Xq64 * Xq64).sum(dim=1)
    xi = Xi[i.long().clamp(min=0)].to(f64)  # (nq, k+1, d)
    T = xsq[:, None] + 2.0 * (Xq64.abs()[:, None, :] * xi.abs()).sum(dim=2) + (xi * xi).sum(dim=2)
    tau = TAU_UNITS * U32 * Xq.shape[1] ** 0.5 * T
    return s + xsq[:, None], i, tau


def knn_held(torch, d2, ids, ref_d2, ref_ids, tau):
    """Kernel K4's (d2, ids) (nq, k) against the f64 reference at k + 1.
    Each distance within the row's largest tau of the reference at the
    same position (order statistics move by at most the largest error); the
    id sets equal, except on rows whose reference k-th and (k+1)-th
    distances lie within 2·tau of each other (a near tie at the boundary,
    which f32 may break either way). Returns (max abs err, worst err/tau,
    rows whose ids differ, near-tie rows, rows whose ids differ outside the
    band)."""
    k = d2.shape[1]
    band = tau.max(dim=1).values
    err = (d2.to(torch.float64) - ref_d2[:, :k]).abs()
    ratio = float((err / band[:, None]).max())
    same = (ids.sort(dim=1).values == ref_ids[:, :k].sort(dim=1).values).all(dim=1)
    near = (ref_d2[:, k] - ref_d2[:, k - 1]) < 2.0 * band
    return float(err.max()), ratio, int((~same).sum()), int(near.sum()), int((~same & ~near).sum())


def check_knn_topk(torch, kn, Xq, Xi, mask, k, sample=None, reps=0, split=None, control=False):
    """K4 on (Xq, Xi) against its f64 plain version on the ``sample`` query
    rows (all rows when None). ``split`` folds the items in two passes,
    the second starting from the first's state."""
    nq, d = Xq.shape
    ni = Xi.shape[0]
    dev = Xq.device
    ids = torch.arange(ni, dtype=torch.int32, device=dev)
    csq = (Xi * Xi).sum(dim=1).masked_fill(mask <= 0, float("inf"))
    state = (torch.full((nq, k), float("inf"), device=dev), torch.full((nq, k), -1, dtype=torch.int32, device=dev))
    if split:
        state = kn.knn_topk_pass(Xq, Xi[:split], csq[:split], ids[:split], *state)
        topd, topi = kn.knn_topk_pass(Xq, Xi[split:], csq[split:], ids[split:], *state)
    else:
        topd, topi = kn.knn_topk_pass(Xq, Xi, csq, ids, *state)
    torch.cuda.synchronize()
    rows = torch.arange(nq, device=dev) if sample is None else sample
    xsq = (Xq[rows] * Xq[rows]).sum(dim=1)
    d2 = topd[rows] + xsq[:, None]
    ref_d2, ref_ids, tau = knn_reference(torch, kn, Xq[rows], Xi, csq, ids, k)
    err, ratio, differ, near, bad = knn_held(torch, d2, topi[rows], ref_d2, ref_ids, tau)
    masked_hit = int((~(mask[topi[rows].long().clamp(min=0)] > 0)).sum())
    check(ratio <= 1.0 and bad == 0 and masked_hit == 0,
          f"knn_topk {nq}x{ni}x{d} k={k}: |dd2|/tau {ratio:.3g}, {bad} rows with other ids "
          f"outside the near-tie band, {masked_hit} masked items selected")
    out = {"nq": nq, "ni": ni, "d": d, "k": k, "rows_checked": len(rows), "max_abs_err": err,
           "err_over_tol": ratio, "rows_other_ids": differ, "near_tie_rows": near,
           "masked_items": int((mask <= 0).sum()), "split": split}
    if control:  # the ids of one query tile shifted by one
        bad_ids = topi[rows].clone()
        bad_ids[:128] += 1
        b = knn_held(torch, d2, bad_ids, ref_d2, ref_ids, tau)
        check(b[4] > 0, "the K4 check does not catch one query tile's ids shifted")
        out["controls"] = [{"control": "ids of query rows 0..127 shifted by one",
                            "rows_other_ids_outside_band": b[4]}]
    del ref_d2, ref_ids, tau
    if reps:
        st0 = (torch.full((nq, k), float("inf"), device=dev), torch.full((nq, k), -1, dtype=torch.int32, device=dev))

        def library():  # chunked addmm + torch.topk (ties in any order)
            outs = []
            for lo in range(0, nq, 4096):
                bd = None
                for jo in range(0, ni, 32768):
                    s = torch.addmm(csq[None, jo:jo + 32768], Xq[lo:lo + 4096], Xi[jo:jo + 32768].T,
                                    alpha=-2.0)
                    v, j = torch.topk(s, k, dim=1, largest=False)
                    j = j + jo
                    if bd is not None:
                        v, sel = torch.topk(torch.cat([bd, v], 1), k, dim=1, largest=False)
                        j = torch.cat([bi, j], 1).gather(1, sel)
                    bd, bi = v, j
                outs.append(bi)
            return outs

        out["ms"] = cuda_ms(torch, lambda: kn.knn_topk_pass(Xq, Xi, csq, ids, *st0), reps)
        out["plain_ms"] = cuda_ms(torch, lambda: kn.knn_topk_pass_plain(Xq, Xi, csq, ids, *st0), reps)
        out["library_ms"] = cuda_ms(torch, library, reps)
        nbytes = 4.0 * (nq * d + ni * d + 2 * ni + 4 * nq * k)  # Xq, Xi, csq, ids, state in + out
        flops = 2.0 * nq * ni * d + 2.0 * nq * ni  # products, then csq - 2·dot
        out["bound_ms"], out["bound_by"] = bound_ms(nbytes, flops)
    return out


# K10: each term passes through two powf (a few ulps each), a division and
# the rounding of diff and d2, so its f32 error is held at TOL_TERMS_SGD·u
# of its size rather than TOL_TERMS
TOL_TERMS_SGD = 32.0


def sgd_terms_abs(torch, uk, src, h, tails, p, perm, offs, u, a, b, gamma, scale):
    """Σ|term| per (row, component) of one K10 epoch, in f64: the T of
    ``held`` for the kernel's per-row sums."""
    R, K = tails.shape
    active = (u < p).to(src.dtype)
    diff = h[:, None, :] - src[tails.long()]
    d2 = (diff * diff).sum(dim=2)
    ac = torch.where(d2 > 0, (2.0 * a * b * d2 ** (b - 1.0)) / (a * d2 ** b + 1.0), 0.0) * active
    T = torch.clamp((ac[..., None] * diff).abs(), max=4.0).sum(dim=1) * scale
    diff_n = h[:, None, None, :] - src[uk.negative_ids(perm, offs, R, K)]
    d2n = (diff_n * diff_n).sum(dim=3)
    rc = torch.where(d2n > 0, (2.0 * gamma * b) / ((0.001 + d2n) * (a * d2n ** b + 1.0)), 0.0)
    return T + torch.clamp((rc * active[..., None])[..., None] * diff_n.abs(), max=4.0).sum(dim=(1, 2))


def check_sgd_epoch(torch, uk, src, h, tails, p, perm, offs, u, a, b, reps, control=False, scale=2.0):
    """K10 against its plain version in f64 on the same u/perm/offs;
    ``scale`` is the attractive factor (2 on the fit's self table, 1 in
    the transform's refine epochs)."""
    R, K = tails.shape
    n_tab, C = src.shape
    neg = offs.shape[0]
    gamma = 1.0
    out = uk.sgd_epoch_rows(src, h, tails, p, perm, offs, u, a, b, gamma, scale)
    f64 = torch.float64
    args64 = (src.to(f64), h.to(f64), tails, p.to(f64), perm, offs, u.to(f64))
    ref = uk.sgd_epoch_rows_plain(*args64, a, b, gamma, scale)
    T = sgd_terms_abs(torch, uk, *args64, a, b, gamma, scale)
    n_terms = K * (1 + neg)
    err = (out.to(f64) - ref).abs()
    tol = U32 * (TOL_TERMS_SGD * T + TOL_WALK * n_terms ** 0.5 * ref.abs())
    ratio = float(torch.where(err > 0, err / tol, torch.zeros_like(err)).max())
    check(ratio <= 1.0, f"sgd_epoch_rows R={R} K={K} C={C}: |d|/tol {ratio:.3g} above 1")
    active = int((u < p).sum())
    res = {"R": R, "K": K, "C": C, "neg": neg, "n_tab": n_tab, "attract_scale": scale, "active_slots": active,
           "max_abs_err": float(err.max()), "err_over_tol": ratio}
    if control:  # a kernel that drops the repulsive term on every other row
        bad = out.clone()
        bad[::2] = uk.sgd_epoch_rows_plain(src, h, tails, p, perm, offs, u, a, b, 0.0, scale)[::2]
        e = (bad.to(f64) - ref).abs()
        r = float(torch.where(e > 0, e / tol, torch.zeros_like(e)).max())
        check(r > 1.0, f"the K10 check does not catch a dropped repulsive term: err/tol {r:.3g}")
        res["controls"] = [{"control": "repulsive term dropped on even rows", "max_abs_err": float(e.max()),
                            "err_over_tol": r}]
    if reps:
        res["ms"] = cuda_ms(torch, lambda: uk.sgd_epoch_rows(src, h, tails, p, perm, offs, u, a, b, gamma,
                                                                   scale), reps)
        res["plain_ms"] = cuda_ms(torch, lambda: uk.sgd_epoch_rows_plain(src, h, tails, p, perm, offs, u, a, b,
                                                                               gamma, scale), reps)
        res["library_ms"] = None  # no single PyTorch call computes one epoch's row sums
        # tails, p, u streamed once; table, heads, perm, offs read once; sums written
        nbytes = 4.0 * (3 * R * K + n_tab * C + R * C + n_tab + neg + R * C)
        # per evaluated term (active slot x (1 + neg)): 3C for diff and d2,
        # ~10 for the coefficient, 3C to clip and add
        flops = active * (1.0 + neg) * (6.0 * C + 10.0)
        res["bound_ms"], res["bound_by"] = bound_ms(nbytes, flops)
    return res


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


def make_umap_data(n: int, seed: int) -> np.ndarray:
    """(n, 256) f32 host rows: 32 Gaussian blobs (centre scale 4, unit
    noise), the recipe of ``bench.py``'s UMAP entry (its seed 3 at
    ``--seed 0``)."""
    rng = np.random.default_rng(seed + 3)
    centers = rng.normal(size=(32, E2E_D)).astype(np.float32) * 4.0
    lab = rng.integers(0, 32, size=n)
    return (centers[lab] + rng.normal(size=(n, E2E_D))).astype(np.float32)


def query_sample(torch, nq, dev, rows=4096):
    """``rows`` query rows: the first query tile (the negative control
    shifts its ids), then rows spread over the rest."""
    step = max(1, (nq - 128) // (rows - 128))
    return torch.cat([torch.arange(min(128, nq), device=dev),
                      torch.arange(128, nq, step, device=dev)[:rows - 128]])


def phase_knn_umap_kernels(torch, X_items, X_umap, reps, seed):
    """K4 at the kNN shape (131,072 queries x 1M items, k = 16), at ragged
    shapes, and at the UMAP shapes (65,536 rows against themselves: the
    graph at k = 16, the transform at k = 15); K10 at the UMAP fit shape
    (the CSR rows of the 65,536 x 256 graph, K = 24, C = 2, neg = 5) and
    the transform shape (65,536 rows, K = 15, neg = 5, frozen table)."""
    from spark_rapids_ml_tpu_torch.models.umap import drop_self_column, knn_brute
    from spark_rapids_ml_tpu_torch.ops import knn_kernels as kn
    from spark_rapids_ml_tpu_torch.ops import umap_kernels as uk

    dev = X_items.device
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 2)
    res = {}
    nq, ni = min(KNN_QUERIES, X_items.shape[0]), X_items.shape[0]
    res["knn_topk"] = check_knn_topk(torch, kn, X_items[:nq], X_items, torch.ones(ni, device=dev), KNN_K,
                                     sample=query_sample(torch, nq, dev), reps=max(1, reps // 3), control=True)
    emit({"phase": "kernels", "kernel": "knn_topk", **res["knn_topk"]})
    # ragged shapes: nq, ni off the tiles, a masked item block, d in {3,
    # 124, 300}, k in {1, 16, 100}, and one fold in two passes
    for d_r in (3, 124, 300):
        Xq = torch.randn(1037, d_r, generator=g, device=dev) + 3.0
        Xi = torch.randn(70_001, d_r, generator=g, device=dev) + 3.0
        mask = torch.ones(70_001, device=dev)
        mask[5000:7000] = 0.0
        for k_r in (1, 16, 100):
            emit({"phase": "kernels", "kernel": "knn_topk", "ragged": True,
                  **check_knn_topk(torch, kn, Xq, Xi, mask, k_r,
                                   split=30_011 if (d_r, k_r) == (124, 16) else None)})

    # K10 on the UMAP fit's own rows: its graph, a random table
    Xd = torch.from_numpy(X_umap).to(dev)
    dists, idx = drop_self_column(*knn_brute(Xd, Xd, k=UMAP_NEIGHBORS + 1), k=UMAP_NEIGHBORS)
    heads, tails, weights = uk.fuzzy_simplicial_set(idx.cpu().numpy(), dists, 1.0, 1.0, device=dev)
    row_heads, tails_pad, p_pad = uk.build_row_adjacency(heads, tails, weights, X_umap.shape[0], K=24)
    # K4 at the UMAP shapes: the graph (65,536 rows against themselves,
    # k = 16) and the transform of the same rows (k = 15)
    n = Xd.shape[0]
    ones, sample = torch.ones(n, device=dev), query_sample(torch, n, dev)
    res["knn_topk_umap_graph"] = check_knn_topk(torch, kn, Xd, Xd, ones, UMAP_NEIGHBORS + 1, sample=sample,
                                                reps=max(1, reps))
    emit({"phase": "kernels", "kernel": "knn_topk", "umap_graph_shape": True, **res["knn_topk_umap_graph"]})
    res["knn_topk_umap_transform"] = check_knn_topk(torch, kn, Xd, Xd, ones, UMAP_NEIGHBORS, sample=sample)
    emit({"phase": "kernels", "kernel": "knn_topk", "umap_transform_shape": True,
          **res["knn_topk_umap_transform"]})
    # the transform's tails: each row's 15 training neighbours (self excluded)
    tails_tr = idx.contiguous()
    del Xd, dists, ones
    a, b = uk.find_ab_params(1.0, 0.1)
    src = torch.rand((n, 2), generator=g, device=dev) * 20.0 - 10.0
    tails_d = torch.from_numpy(tails_pad).to(dev)
    p_d = torch.from_numpy(p_pad).to(dev)
    R, K = tails_pad.shape
    h = src[torch.from_numpy(row_heads).to(dev).long()]
    u = torch.rand((R, K), generator=g, device=dev)
    perm = torch.randperm(n, generator=g, device=dev, dtype=torch.int32)
    offs = torch.randint(0, R, (5,), generator=g, device=dev, dtype=torch.int32)
    res["sgd_epoch_rows"] = check_sgd_epoch(torch, uk, src, h, tails_d, p_d, perm, offs, u, a, b,
                                            max(20, reps), control=True)
    emit({"phase": "kernels", "kernel": "sgd_epoch_rows", **res["sgd_epoch_rows"]})
    # the transform's epoch: one row per query (R = 65,536), its K = 15
    # neighbours into the frozen table, neg = 5 offsets in [0, R), the
    # attractive term once
    shp = tails_tr.shape
    offs_tr = torch.randint(0, shp[0], (5,), generator=g, device=dev, dtype=torch.int32)
    res["sgd_epoch_rows_transform"] = check_sgd_epoch(
        torch, uk, src, src + 0.5, tails_tr, torch.rand(shp, generator=g, device=dev), perm, offs_tr,
        torch.rand(shp, generator=g, device=dev), a, b, max(20, reps), control=True, scale=1.0)
    emit({"phase": "kernels", "kernel": "sgd_epoch_rows", "umap_transform_shape": True,
          **res["sgd_epoch_rows_transform"]})
    torch.cuda.synchronize()
    return res


def rf_level_inputs(torch, pt, bins, stats, level, T, k, n_features, g, sel=False):
    """The inputs one compact level of the forest builder gives K5 (K6 with
    ``sel``) for T trees, laid out by the builder's own glue
    (``compact_sizes``, ``_compact_layout``): each tree's rows (Poisson(1)
    bootstrap weights) spread over the level's 2^level nodes at random,
    each node's k features drawn at random, sentinel slots up to the next
    power of two."""
    n, d_pad = bins.shape
    dev, S = bins.device, stats.shape[1]
    n_nodes, k_pad = 1 << level, pt.next_pow2(k)
    r_sub, n_pad, f_chunk = pt.compact_sizes(n, level, RF_DEPTH, S, k_pad, RF_BINS)
    seg = torch.randint(0, n_nodes, (T, n), generator=g, device=dev)
    src2, pvalid, sbc, _ = pt._compact_layout(seg, n_nodes, r_sub, n_pad)
    w = torch.poisson(torch.ones((T, n), device=dev), generator=g)
    sw = (stats[None] * w[..., None]).gather(1, src2[..., None].expand(T, n_pad, S))
    sw = (sw * pvalid[..., None]).reshape(T * n_pad, S).contiguous()
    feats = torch.rand((T, n_nodes, n_features), generator=g, device=dev).argsort(dim=2)[..., :k]
    feats = torch.cat([feats, torch.full((T, n_nodes, k_pad - k), n_features, device=dev)], 2)
    out = {"T": T, "level": level, "n": n, "n_pad": n_pad, "r_sub": r_sub, "S": S, "nb": RF_BINS,
           "k": k, "k_pad": k_pad, "sw": sw}
    if sel:
        out["bq"] = bins.index_select(0, src2.reshape(-1))
        out["featsq"] = feats.gather(1, sbc[..., None].expand(-1, -1, k_pad)).reshape(-1, k_pad).to(torch.int32)
        out["d_pad"] = d_pad
    else:
        rows = feats.gather(1, seg.clamp(max=n_nodes - 1)[..., None].expand(-1, -1, k_pad))
        src = bins.expand(T, n, d_pad).gather(2, rows.clamp(max=d_pad - 1))
        binq = src.gather(1, src2[..., None].expand(T, n_pad, k_pad)).to(torch.int32)
        out["binq"] = binq[..., :f_chunk].reshape(T * n_pad, f_chunk).contiguous()
        out["f_chunk"] = f_chunk
    return out


def _last_weighted_row(torch, sw, r_sub, j):
    """The last row of sub-block j (or the first sub-block after it) that
    carries weight: the row a kernel that drops one row per sub-block would
    lose."""
    w = sw.abs().sum(dim=1).reshape(-1, r_sub)
    while not bool((w[j] > 0).any()):
        j += 1
    return j * r_sub + int(torch.nonzero(w[j] > 0)[-1, 0])


def check_subblock_hist(torch, rk, inp, reps, exact=True, control=False, sel=False):
    """K5 (K6 with ``sel``) against its plain version in f64 on the same
    inputs: equal for integer stats, else within ``held`` of the f64 sums
    (T = the plain version over |sw|, n = r_sub additions). Two launches
    must give the same bits. The control drops the last weighted row of
    one sub-block, which the check must catch."""
    sw, nb, r_sub = inp["sw"], inp["nb"], inp["r_sub"]
    if sel:
        args, kern, plain = (inp["bq"], inp["featsq"]), rk.subblock_hist_sel, rk.subblock_hist_sel_plain
        k = inp["featsq"].shape[1]
    else:
        args, kern, plain = (inp["binq"],), rk.subblock_hist, rk.subblock_hist_plain
        k = inp["binq"].shape[1]
    out = kern(*args, sw, n_bins=nb, r_sub=r_sub)
    again = kern(*args, sw, n_bins=nb, r_sub=r_sub)
    torch.cuda.synchronize()
    repeatable = bool(torch.equal(out, again))
    del again
    ref = plain(*args, sw.double(), n_bins=nb, r_sub=r_sub)
    rows, S = sw.shape
    n_sb = rows // r_sub
    res = {key: inp[key] for key in ("T", "level", "n", "n_pad", "r_sub", "S", "nb", "k", "k_pad", "d_pad")
           if key in inp}
    res.update({"k_launch": k, "n_sb": n_sb, "repeatable": repeatable})
    if exact:
        # integer sums below 2^24: the f64 reference is exact in f32 too
        ref = ref.float()
        err = float((out - ref).abs().max())
        ok, ratio, T_abs = bool(torch.equal(out, ref)), 0.0, None
    else:
        T_abs = plain(*args, sw.double().abs(), n_bins=nb, r_sub=r_sub)
        err, ratio = held(torch, out, ref, T_abs, r_sub)
        ok = ratio <= 1.0
    check(ok and repeatable, f"{kern.__name__} {rows}x{k} S={S} nb={nb} r_sub={r_sub}: "
          f"max err {err}, err/tol {ratio:.3g}, repeatable {repeatable}")
    res.update({"max_abs_err": err, "err_over_tol": ratio, "exact": exact})
    if control:
        r = _last_weighted_row(torch, sw, r_sub, n_sb // 2)
        bad_sw = sw.double().clone()
        bad_sw[r] = 0.0
        bad = plain(*args, bad_sw, n_bins=nb, r_sub=r_sub)
        if exact:
            caught = not bool(torch.equal(out, bad.float()))
        else:
            caught = held(torch, bad, ref, T_abs, r_sub)[1] > 1.0
        check(caught, f"the {kern.__name__} check does not catch a dropped row")
        res["controls"] = [{"control": f"row {r} (last weighted row of its sub-block) dropped", "caught": caught}]
        del bad, bad_sw
    del ref, T_abs
    if reps:
        res["ms"] = cuda_ms(torch, lambda: kern(*args, sw, n_bins=nb, r_sub=r_sub), reps)
        res["plain_ms"] = cuda_ms(torch, lambda: plain(*args, sw, n_bins=nb, r_sub=r_sub), reps)
        # one scatter_add_ on the flattened (sub-block, s, slot, bin) index
        # (K6: the column gather first, a second call)
        binq = rk.select_bins_plain(args[0], args[1], r_sub) if sel else args[0]
        sb = torch.arange(rows, device=sw.device) // r_sub
        base = sb[:, None, None] * S + torch.arange(S, device=sw.device)[None, :, None]
        idx = ((base * k + torch.arange(k, device=sw.device)[None, None, :]) * nb
               + binq.long().clamp(0, nb - 1)[:, None, :]).reshape(-1)
        vals = sw[:, :, None].expand(rows, S, k).reshape(-1)
        size = n_sb * S * k * nb

        def library():
            b = rk.select_bins_plain(args[0], args[1], r_sub) if sel else None
            return torch.zeros(size, device=sw.device).scatter_add_(0, idx, vals), b

        res["library_ms"] = cuda_ms(torch, library, reps)
        res["library_calls"] = "gather + scatter_add_ (two calls)" if sel else "scatter_add_"
        del idx, vals, base, sb, binq
        # each input byte read once, the dense output written once; K6 reads
        # only the k selected bytes of each full row (bq holds d_pad)
        in_bins = rows * k * (1 if sel else 4)
        nbytes = in_bins + 4.0 * (rows * S + n_sb * S * k * nb) + (4.0 * n_sb * k if sel else 0.0)
        res["bytes"] = nbytes
        res["bound_ms"], res["bound_by"] = bound_ms(nbytes, float(rows) * S * k)
    del out
    return res


def random_forest(rng, T, depth, d, nb, leaf_p=0.15):
    """(feat, thr_bin) of T random heap-ordered trees of depth ``depth``:
    every node of the top levels splits, a fraction ``leaf_p`` of the deeper
    ones is an early leaf (and its subtree with it)."""
    M = (1 << (depth + 1)) - 1
    feat = rng.integers(0, d, size=(T, M)).astype(np.int32)
    early = rng.random((T, M)) < leaf_p
    early[:, :7] = False
    early[:, (1 << depth) - 1:] = True
    feat[early] = -1
    for i in range(1, (1 << depth) - 1):
        feat[feat[:, (i - 1) // 2] < 0, i] = -1
    thr = rng.integers(0, nb - 1, size=(T, M)).astype(np.int32)
    return feat, thr


def check_packed_traverse(torch, rk, pt, xb, feat, thr, depth, reps, control=False):
    """K9 on one transform batch against its plain version: the leaf ids
    equal. The control moves one hop-2 threshold of the subtree most rows
    reach; some leaf ids must move."""
    pf = pt.pack_forest(feat, thr, max_depth=depth)
    dev = xb.device
    f1, t1, f2, t2 = (torch.from_numpy(a).to(dev) for a in (pf.feat1, pf.thr1, pf.feat2, pf.thr2))
    i1 = pt._packed_hop1(xb, f1, t1, k1=pf.k1)
    packed = pt.pack_bins(xb)
    out = rk.packed_traverse(packed, i1, f2, t2, k1=pf.k1, k2=pf.k2)
    ref = rk.packed_traverse_plain(packed, i1, f2, t2, k1=pf.k1, k2=pf.k2)
    torch.cuda.synchronize()
    n, t_pad = i1.shape
    differ = int((out != ref).sum())
    check(differ == 0, f"packed_traverse {n}x{t_pad} k1={pf.k1} k2={pf.k2}: {differ} leaf ids differ")
    n1 = (1 << pf.k1) - 1
    res = {"rows": n, "trees": feat.shape[0], "t_pad": t_pad, "d_pad": xb.shape[1], "words": packed.shape[1],
           "depth": depth, "k1": pf.k1, "k2": pf.k2, "max_abs_err": 0, "leaf_ids_differ": differ,
           "rows_past_hop1": float((i1[:, :feat.shape[0]] >= n1).float().mean())}
    if control:
        # tree 0's busiest hop-2 subtree whose root splits: every row there
        # sent left (threshold 255), then right (-1); some leaf ids must move
        past = i1[:, 0].long() >= n1
        busy = torch.bincount(i1[past, 0].long() - n1, minlength=1 << pf.k1)
        busy[f2[:1 << pf.k1, 0] < 0] = 0
        row = int(busy.argmax())
        moved = 0
        for thr_bad in (255, -1):
            bad_t2 = t2.clone()
            bad_t2[row, 0] = thr_bad
            moved += int((rk.packed_traverse_plain(packed, i1, f2, bad_t2, k1=pf.k1, k2=pf.k2) != ref).sum())
        check(moved > 0, "the K9 control (one threshold moved) moves no leaf id")
        res["controls"] = [{"control": f"tree 0, subtree {row} ({int(busy[row])} rows): root threshold set to "
                            "255, then -1", "leaf_ids_moved": moved}]
    if reps:
        res["ms"] = cuda_ms(torch, lambda: rk.packed_traverse(packed, i1, f2, t2, k1=pf.k1, k2=pf.k2), reps)
        res["plain_ms"] = cuda_ms(torch, lambda: rk.packed_traverse_plain(packed, i1, f2, t2, k1=pf.k1, k2=pf.k2),
                                  reps)
        res["library_ms"] = None  # none: no single PyTorch call walks the packed subtrees
        nbytes = 4.0 * (packed.numel() + 2 * n * t_pad + 2 * f2.numel())
        # ~10 integer operations a step, at the FP32 rate
        res["bytes"] = nbytes
        res["bound_ms"], res["bound_by"] = bound_ms(nbytes, 10.0 * n * t_pad * pf.k2)
    return res


def phase_rf_kernels(torch, X_rf, y_rf, reps, seed):
    """K5, K6 and K9 at the shapes the forest paths give them."""
    from spark_rapids_ml_tpu_torch.ops import rf_kernels as rk
    from spark_rapids_ml_tpu_torch.ops import tree_kernels as pt

    dev = X_rf.device
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 7)
    rng = np.random.default_rng(seed + 7)
    n = X_rf.shape[0]
    edges = torch.from_numpy(pt.make_bin_edges(X_rf.cpu().numpy(), RF_BINS, seed=seed)).to(dev)
    bins = pt.binize(X_rf, edges, d_pad=E2E_D)
    cls = torch.nn.functional.one_hot(y_rf.long(), 2).float()
    res = {}
    # K5: the bench forest's deepest split level (12) and a shallow one
    inp = rf_level_inputs(torch, pt, bins, cls, 12, 8, 16, E2E_D, g)
    res["subblock_hist"] = check_subblock_hist(torch, rk, inp, reps, control=True)
    emit({"phase": "kernels", "kernel": "subblock_hist", **res["subblock_hist"]})
    inp = rf_level_inputs(torch, pt, bins, cls, 2, 8, 16, E2E_D, g)
    res["subblock_hist_level2"] = check_subblock_hist(torch, rk, inp, reps)
    emit({"phase": "kernels", "kernel": "subblock_hist", **res["subblock_hist_level2"]})
    # the regressor's level 12: S = 3 real-valued moments, k = 86 -> 128 in
    # feature chunks
    yr = X_rf[:, :8].sum(dim=1) + 0.5 * torch.randn(n, generator=g, device=dev)
    reg = torch.stack([torch.ones_like(yr), yr, yr * yr], 1)
    inp = rf_level_inputs(torch, pt, bins, reg, 12, 8, 86, E2E_D, g)
    res["subblock_hist_variance"] = check_subblock_hist(torch, rk, inp, reps, exact=False, control=True)
    emit({"phase": "kernels", "kernel": "subblock_hist", **res["subblock_hist_variance"]})
    del inp
    # ragged: k = 11 with out-of-range bins, nb in {32, 255}, S = 5, odd
    # sub-block counts and sizes
    for nb_r, r_sub, n_sb in ((32, 24, 1001), (255, 7, 3333)):
        rows = r_sub * n_sb
        binq = torch.randint(-2, nb_r + 3, (rows, 11), generator=g, device=dev, dtype=torch.int32)
        sw = torch.poisson(torch.ones((rows, 5), device=dev), generator=g)
        emit({"phase": "kernels", "kernel": "subblock_hist", "ragged": True, **check_subblock_hist(
            torch, rk, {"binq": binq, "sw": sw, "nb": nb_r, "r_sub": r_sub}, 0)})
    # K6: the 3,000-feature forest's level 12 (k = 55 -> 64, d_pad 4,096)
    Xw = torch.randn((n, RF_WIDE_D), generator=g, device=dev)
    ew = torch.from_numpy(pt.make_bin_edges(Xw[::8].cpu().numpy(), RF_BINS, seed=seed)).to(dev)
    wide = pt.binize(Xw, ew, d_pad=pt.next_pow2(RF_WIDE_D))
    del Xw
    inp = rf_level_inputs(torch, pt, wide, cls, 12, 8, 55, RF_WIDE_D, g, sel=True)
    res["subblock_hist_sel"] = check_subblock_hist(torch, rk, inp, reps, control=True, sel=True)
    emit({"phase": "kernels", "kernel": "subblock_hist_sel", **res["subblock_hist_sel"]})
    del inp
    torch.cuda.empty_cache()
    # ragged K6: n_features == d_pad (the sentinel lies past the row), S = 3
    r_sub, n_sb, d_r = 40, 333, 200
    bq = torch.randint(0, 255, (r_sub * n_sb, d_r), generator=g, device=dev, dtype=torch.uint8)
    featsq = torch.randint(0, d_r + 1, (n_sb, 13), generator=g, device=dev, dtype=torch.int32)
    sw = torch.poisson(torch.ones((r_sub * n_sb, 3), device=dev), generator=g)
    emit({"phase": "kernels", "kernel": "subblock_hist_sel", "ragged": True, **check_subblock_hist(
        torch, rk, {"bq": bq, "featsq": featsq, "sw": sw, "nb": 255, "r_sub": r_sub, "d_pad": d_r}, 0,
        control=True, sel=True)})
    # K9: one transform batch of the bench forest (depth 13: k1 = 7, k2 = 6)
    feat, thr = random_forest(rng, RF_TREES, RF_DEPTH, E2E_D, RF_BINS)
    res["packed_traverse"] = check_packed_traverse(torch, rk, pt, bins, feat, thr, RF_DEPTH, max(reps, 10),
                                                   control=True)
    emit({"phase": "kernels", "kernel": "packed_traverse", **res["packed_traverse"]})
    # at 3,000 features (750 words a row), k2 = 1 and 6
    xw = wide[:65_536, :RF_WIDE_D].contiguous()
    for depth in (8, RF_DEPTH):
        feat, thr = random_forest(rng, 16, depth, RF_WIDE_D, RF_BINS)
        emit({"phase": "kernels", "kernel": "packed_traverse", "wide": True,
              **check_packed_traverse(torch, rk, pt, xw, feat, thr, depth, 0, control=True)})
    del wide, xw
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
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


def trustworthiness(torch, X, E, k: int) -> float:
    """sklearn.manifold.trustworthiness (euclidean) of the embedding ``E``
    of the rows ``X``, in f64 on their device: 1 minus the normalized sum
    of how far beyond k each embedding-space neighbour ranks in input
    space."""
    n = X.shape[0]
    X, E = X.to(torch.float64), E.to(torch.float64)
    dX = torch.cdist(X, X)
    dX.fill_diagonal_(float("inf"))
    ind_X = torch.argsort(dX, dim=1)
    del dX
    dE = torch.cdist(E, E)
    dE.fill_diagonal_(float("inf"))
    ind_E = torch.topk(dE, k, dim=1, largest=False).indices
    ranks_of = torch.empty_like(ind_X)
    ranks_of.scatter_(1, ind_X, torch.arange(1, n + 1, device=X.device).expand(n, n))
    ranks = ranks_of.gather(1, ind_E) - k
    t = float(ranks[ranks > 0].sum())
    return 1.0 - t * (2.0 / (n * k * (2.0 * n - 3.0 * k - 1.0)))


def _trust_sample(torch, X, E, seed):
    rows = np.random.default_rng(seed).choice(X.shape[0], size=min(TRUST_ROWS, X.shape[0]), replace=False)
    dev = torch.device("cuda:0")
    return trustworthiness(torch, torch.from_numpy(X[rows]).to(dev), torch.from_numpy(E[rows]).to(dev),
                           UMAP_NEIGHBORS)


def phase_knn_e2e(torch, Xi_host):
    """NearestNeighbors(k=16) through DataFrame: the first 131,072 item rows
    queried against all items (bench.py's kNN entry)."""
    from spark_rapids_ml_tpu_torch import DataFrame, NearestNeighbors
    from spark_rapids_ml_tpu_torch.ops import knn_kernels as kn

    ni = Xi_host.shape[0]
    nq = min(KNN_QUERIES, ni)
    item_df = DataFrame({"features": Xi_host})
    query_df = DataFrame({"features": Xi_host[:nq]})
    kn.knn_topk_pass.launches = 0
    model = NearestNeighbors(k=KNN_K).fit(item_df)
    (_, _, knn_df), t = _timed(torch, lambda: model.kneighbors(query_df))
    launches = kn.knn_topk_pass.launches
    idx = np.asarray(knn_df.column("indices"))
    dist = np.asarray(knn_df.column("distances"))
    check(idx.shape == (nq, KNN_K) and np.isfinite(dist).all(), "kneighbors output shape or finiteness")
    check(bool((np.diff(dist, axis=1) >= 0).all()), "kneighbors distances not ascending")
    # every query is an item: its nearest neighbour is itself, at distance
    # 0 up to the f32 rounding of ||x||² - 2x·x + ||x||² (TAU band)
    self_ok = float((idx[:, 0] == np.arange(nq)).mean())
    xsq = (Xi_host[:nq].astype(np.float64) ** 2).sum(axis=1)
    self_tol = np.sqrt(TAU_UNITS * U32 * E2E_D ** 0.5 * 4.0 * xsq)
    check(self_ok == 1.0 and bool((dist[:, 0] <= self_tol).all()),
          f"kNN self match {self_ok}, self distance up to {float(dist[:, 0].max())}")
    nj = min(4096, ni)
    join_q = DataFrame({"features": Xi_host[:nj], "tag": np.arange(nj)})
    joined, t_join = _timed(torch, lambda: model.exactNearestNeighborsJoin(join_q))
    check(joined.count() == nj * KNN_K and np.isfinite(np.asarray(joined.column("distCol"))).all(),
          "exactNearestNeighborsJoin rows")
    launches_all = kn.knn_topk_pass.launches
    res = {"phase": "e2e", "estimator": "NearestNeighbors", "k": KNN_K, "queries": nq, "items": ni,
           "kneighbors_s": t, "queries_per_s": nq / t, "self_match": self_ok,
           "self_distance_max": float(dist[:, 0].max()), "join_queries": nj, "join_s": t_join,
           "knn_topk_launches": launches, "knn_topk_launches_with_join": launches_all}
    emit(res)
    check(launches > 0, "kernel knn_topk was not launched by kneighbors")
    return launches_all


def phase_umap_e2e(torch, X_umap, seed):
    """UMAP(n_neighbors=15, random_state=42) fit, transform of the same rows,
    and a save/load round trip, at 65,536 x 256."""
    import tempfile

    from spark_rapids_ml_tpu_torch import DataFrame, UMAP, UMAPModel
    from spark_rapids_ml_tpu_torch.ops import knn_kernels as kn
    from spark_rapids_ml_tpu_torch.ops import umap_kernels as uk

    n = X_umap.shape[0]
    df = DataFrame({"features": X_umap})
    kn.knn_topk_pass.launches = 0
    uk.sgd_epoch_rows.launches = 0
    model, t_fit = _timed(torch, lambda: UMAP(n_neighbors=UMAP_NEIGHBORS, random_state=42).fit(df))
    fit_launches = {"knn_topk": kn.knn_topk_pass.launches, "sgd_epoch_rows": uk.sgd_epoch_rows.launches}
    out, t_tr = _timed(torch, lambda: model.transform(df))
    launches = {"knn_topk": kn.knn_topk_pass.launches, "sgd_epoch_rows": uk.sgd_epoch_rows.launches}
    emb, emb_t = model.embedding_, np.asarray(out.column("embedding"))
    check(emb.shape == (n, 2) and np.isfinite(emb).all(), "UMAP embedding shape or finiteness")
    check(emb_t.shape == (n, 2) and np.isfinite(emb_t).all(), "UMAP transform shape or finiteness")
    trust_fit = _trust_sample(torch, X_umap, emb, seed)
    trust_tr = _trust_sample(torch, X_umap, emb_t, seed)
    check(trust_fit > TRUST_MIN and trust_tr > TRUST_MIN,
          f"UMAP trustworthiness fit {trust_fit}, transform {trust_tr} not above {TRUST_MIN}")
    with tempfile.TemporaryDirectory() as tmp:
        (_, t_save) = _timed(torch, lambda: model.write().overwrite().save(tmp + "/umap"))
        loaded, t_load = _timed(torch, lambda: UMAPModel.load(tmp + "/umap"))
    part = DataFrame({"features": X_umap[:4096]})
    same_emb = bool(np.array_equal(loaded.embedding_, emb))
    tr_a = np.asarray(model.transform(part).column("embedding"))
    tr_b = np.asarray(loaded.transform(part).column("embedding"))
    check(same_emb and np.array_equal(tr_a, tr_b), "UMAP save/load round trip changed the model")
    rep = model._fit_report
    emit({"phase": "e2e", "estimator": "UMAP", "n_neighbors": UMAP_NEIGHBORS, "rows": n,
          "fit_s": t_fit, "transform_s": t_tr, "graph_s": rep["graph_seconds"],
          "init_s": rep["init_seconds"], "sgd_s": rep["sgd_seconds"], "epoch_ms": rep["epoch_ms"],
          "n_epochs": rep["n_epochs"], "sgd_rows": rep["rows"], "refine_epochs": model._transform_report["refine_epochs"],
          "trustworthiness_fit": trust_fit, "trustworthiness_transform": trust_tr,
          "trust_rows": TRUST_ROWS, "trust_min": TRUST_MIN, "save_s": t_save, "load_s": t_load,
          "fit_launches": fit_launches, "launches": launches})
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched on the UMAP path")
    return launches


def phase_umap_subset(torch, X_umap, seed, rows):
    """The same UMAP fitted on the card and on the CPU (plain path), with
    the default spectral init and with a random one: on 32 nearly
    disconnected blobs the spectral init's leading eigenvectors are nearly
    degenerate, so the f32 rounding that separates the two graphs can move
    the init (and the final trustworthiness by ~0.01); the random init
    isolates the SGD."""
    from spark_rapids_ml_tpu_torch import DataFrame, UMAP

    X = X_umap[:rows]
    df = DataFrame({"features": X})
    for init in ("spectral", "random"):
        trust, secs = {}, {}
        for dev in ("cuda:0", "cpu"):
            m, secs[dev] = _timed(torch, lambda: UMAP(n_neighbors=UMAP_NEIGHBORS, random_state=42, init=init,
                                                      device=dev).fit(df))
            trust[dev] = _trust_sample(torch, X, m.embedding_, seed)
        diff = abs(trust["cuda:0"] - trust["cpu"])
        emit({"phase": "subset", "estimator": "UMAP", "init": init, "rows": rows, "trust_card": trust["cuda:0"],
              "trust_cpu": trust["cpu"], "trust_diff": diff, "trust_diff_tol": 0.03,
              "fit_s_card": secs["cuda:0"], "fit_s_cpu": secs["cpu"]})
        check(diff <= 0.03, f"UMAP ({init} init) card vs CPU trustworthiness differ by {diff}")


RF_WRAPPERS = ("subblock_hist", "subblock_hist_sel", "packed_traverse")


def _rf_counts(rk, zero=False):
    out = {}
    for name in RF_WRAPPERS:
        w = getattr(rk, name)
        out[name] = w.launches
        if zero:
            w.launches = 0
    return out


def phase_rf_e2e(torch, X_host, y_host, seed):
    """The forest paths through ``DataFrame``, each with the launch counters
    zeroed just before it and read just after: bench.py's classifier (fit,
    transform, save/load, transform), the regressor on a real-valued label,
    and the 3,000-feature classifier. Returns {kernel: {path: launches}}."""
    import tempfile

    from spark_rapids_ml_tpu_torch import DataFrame, RandomForestClassifier, RandomForestRegressor
    from spark_rapids_ml_tpu_torch.classification import RandomForestClassificationModel
    from spark_rapids_ml_tpu_torch.ops import rf_kernels as rk

    X, y = X_host[:RF_ROWS], y_host[:RF_ROWS]
    n = X.shape[0]
    by_path = {name: {} for name in RF_WRAPPERS}
    feats = DataFrame({"features": X})

    def record(path, counts, needed):
        for name, c in counts.items():
            by_path[name][path] = c
        for name in needed:
            check(counts[name] > 0, f"kernel {name} was not launched on the {path} path")

    # 1. bench.py's rf config
    _rf_counts(rk, zero=True)
    est = RandomForestClassifier(numTrees=RF_TREES, maxDepth=RF_DEPTH, maxBins=RF_BINS, seed=seed)
    model, t_fit = _timed(torch, lambda: est.fit(DataFrame({"features": X, "label": y})))
    fit_counts = _rf_counts(rk)
    out, t_tr = _timed(torch, lambda: model.transform(feats))
    pred, prob = out.column("prediction"), out.column("probability")
    with tempfile.TemporaryDirectory() as tmp:
        (_, t_save) = _timed(torch, lambda: model.write().overwrite().save(tmp + "/rf"))
        loaded, t_load = _timed(torch, lambda: RandomForestClassificationModel.load(tmp + "/rf"))
    out2, t_tr2 = _timed(torch, lambda: loaded.transform(feats))
    counts = _rf_counts(rk)
    acc = float((pred == y).mean())
    check(pred.shape == (n,) and np.isfinite(prob).all() and bool((np.abs(prob.sum(1) - 1) < 1e-5).all()),
          "RandomForestClassifier transform shape, finiteness or probabilities")
    check(np.array_equal(pred, out2.column("prediction")) and np.array_equal(prob, out2.column("probability")),
          "RandomForestClassifier save/load changed the predictions")
    check(acc > 0.9, f"RandomForestClassifier training accuracy {acc} <= 0.9")
    emit({"phase": "e2e", "estimator": "RandomForestClassifier", "numTrees": RF_TREES, "maxDepth": RF_DEPTH,
          "maxBins": RF_BINS, "rows": n, "d": X.shape[1], "fit_s": t_fit, "transform_s": t_tr,
          "transform_rows_per_s": n / t_tr, "save_s": t_save, "load_s": t_load, "transform_after_load_s": t_tr2,
          "train_accuracy": acc, "nodes": model.totalNumNodes, "engine": model._resolve_transform_engine(),
          "fit_report": model._fit_report, "fit_launches": fit_counts, "launches": counts})
    record("rf_classifier", counts, ("subblock_hist", "packed_traverse"))

    # 2. the regressor: a real-valued label from --seed
    rng = np.random.default_rng(seed + 11)
    w = rng.normal(size=8).astype(np.float32)
    yr = (X[:, :8] @ w + np.sin(X[:, 8]) + 0.3 * rng.normal(size=n)).astype(np.float32)
    _rf_counts(rk, zero=True)
    est = RandomForestRegressor(numTrees=RF_SMALL_TREES, maxDepth=RF_DEPTH, maxBins=RF_BINS, seed=seed)
    rmodel, t_fit = _timed(torch, lambda: est.fit(DataFrame({"features": X, "label": yr})))
    out, t_tr = _timed(torch, lambda: rmodel.transform(feats))
    counts = _rf_counts(rk)
    pr = out.column("prediction")
    r2 = float(1.0 - ((pr - yr) ** 2).mean() / yr.var())
    check(np.isfinite(pr).all() and r2 > 0.5, f"RandomForestRegressor training R^2 {r2} <= 0.5")
    emit({"phase": "e2e", "estimator": "RandomForestRegressor", "numTrees": RF_SMALL_TREES, "maxDepth": RF_DEPTH,
          "maxBins": RF_BINS, "rows": n, "fit_s": t_fit, "transform_s": t_tr, "train_r2": r2,
          "nodes": rmodel.totalNumNodes, "fit_report": rmodel._fit_report, "launches": counts})
    record("rf_regressor", counts, ("subblock_hist", "packed_traverse"))
    del rmodel, out

    # 3. the reference's 3,000-feature width: K6 selects each node's 55
    # features from the full rows
    g = torch.Generator(device="cuda:0")
    g.manual_seed(seed + 13)
    Xw = torch.randn((n, RF_WIDE_D), generator=g, device="cuda:0")
    cols = torch.randperm(RF_WIDE_D, generator=g, device="cuda:0")[:30]
    yw = (Xw[:, cols].sum(dim=1) > 0).float().cpu().numpy()
    Xw = Xw.cpu().numpy()
    torch.cuda.empty_cache()
    _rf_counts(rk, zero=True)
    torch.cuda.reset_peak_memory_stats()
    est = RandomForestClassifier(numTrees=RF_SMALL_TREES, maxDepth=RF_DEPTH, maxBins=RF_BINS, seed=seed)
    wmodel, t_fit = _timed(torch, lambda: est.fit(DataFrame({"features": Xw, "label": yw})))
    peak = torch.cuda.max_memory_allocated()
    out, t_tr = _timed(torch, lambda: wmodel.transform(DataFrame({"features": Xw})))
    counts = _rf_counts(rk)
    acc_w = float((out.column("prediction") == yw).mean())
    # each node sees 55 of the 3,000 features, about one of the 30 the label
    # depends on: the check is that the forest learned something
    check(acc_w > 0.6, f"3,000-feature RandomForestClassifier training accuracy {acc_w} <= 0.6")
    emit({"phase": "e2e", "estimator": "RandomForestClassifier", "numTrees": RF_SMALL_TREES, "maxDepth": RF_DEPTH,
          "maxBins": RF_BINS, "rows": n, "d": RF_WIDE_D, "fit_s": t_fit, "transform_s": t_tr,
          "train_accuracy": acc_w, "peak_device_gb": peak / 1e9, "fit_report": wmodel._fit_report,
          "launches": counts})
    record("rf_wide", counts, ("subblock_hist_sel", "packed_traverse"))
    return by_path


def phase_rf_profile(torch, X_host, y_host, seed):
    """One tree batch (8 trees) of the bench forest fitted again under
    ``torch.profiler``: the device time of every kernel and copy against
    the fit's wall clock (the device's busy share; the profiler adds host
    overhead, so the share is a lower bound), and the largest device-time
    kernels and copies."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from spark_rapids_ml_tpu_torch import DataFrame, RandomForestClassifier

    df = DataFrame({"features": X_host[:RF_ROWS], "label": y_host[:RF_ROWS]})
    est = RandomForestClassifier(numTrees=RF_SMALL_TREES, maxDepth=RF_DEPTH, maxBins=RF_BINS, seed=seed)
    plain_model, t_plain = _timed(torch, lambda: est.fit(df))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, t_prof = _timed(torch, lambda: est.fit(df))
    # device-side events only (kernels, copies, sets): an operator's entry
    # carries the device time of the kernels it launched again
    ops = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if e.device_type == DeviceType.CUDA and us > 0:
            ops.append((us, e.key, e.count))
    ops.sort(reverse=True)
    device_s = sum(us for us, _, _ in ops) / 1e6
    emit({"phase": "e2e", "check": "rf_profile", "numTrees": RF_SMALL_TREES, "maxDepth": RF_DEPTH, "rows": RF_ROWS,
          "fit_s": t_plain, "fit_report": plain_model._fit_report, "profiled_fit_s": t_prof,
          "device_s": device_s if ops else "not measured",
          "device_busy_share": device_s / t_prof if ops else "not measured",
          "top_device_ops": [{"op": k[:80], "ms": us / 1e3, "calls": c} for us, k, c in ops[:12]]})


def phase_rf_subset(torch, X_host, y_host, seed, rows):
    """The same forest fitted on the card and on the CPU (plain versions),
    with the same draws (a CPU generator on either side) and exact integer
    histograms: the trees are expected to be equal. Counts the differing
    nodes and holds the predictions to RF_AGREE_MIN agreement."""
    from spark_rapids_ml_tpu_torch import DataFrame, RandomForestClassifier
    from spark_rapids_ml_tpu_torch.ops import rf_kernels as rk

    df = DataFrame({"features": X_host[:rows], "label": y_host[:rows]})
    _rf_counts(rk, zero=True)
    fits, secs, preds = {}, {}, {}
    for dev in ("cuda:0", "cpu"):
        est = RandomForestClassifier(numTrees=RF_SMALL_TREES, maxDepth=RF_SUBSET_DEPTH, maxBins=RF_BINS,
                                     seed=seed, device=dev)
        fits[dev], secs[dev] = _timed(torch, lambda: est.fit(df))
        preds[dev] = fits[dev].transform(df).column("prediction")
    counts = _rf_counts(rk)
    a, b = fits["cuda:0"]._model_attributes, fits["cpu"]._model_attributes
    differ = int(((a["features"] != b["features"]) | (a["threshold_bins"] != b["threshold_bins"])).sum())
    leaf_differ = int((a["leaf_stats"] != b["leaf_stats"]).any(axis=2).sum())
    agree = float((preds["cuda:0"] == preds["cpu"]).mean())
    emit({"phase": "subset", "estimator": "RandomForestClassifier", "rows": rows, "numTrees": RF_SMALL_TREES,
          "maxDepth": RF_SUBSET_DEPTH, "nodes_differ": differ, "leaf_stats_differ": leaf_differ,
          "gains_equal": bool(np.array_equal(a["gains"], b["gains"])), "prediction_agreement": agree,
          "agreement_min": RF_AGREE_MIN, "fit_s_card": secs["cuda:0"], "fit_s_cpu": secs["cpu"],
          "launches": counts})
    check(agree >= RF_AGREE_MIN, f"forest card vs CPU predictions agree on {agree} < {RF_AGREE_MIN}")
    for name in ("subblock_hist", "packed_traverse"):
        check(counts[name] > 0, f"kernel {name} was not launched on the card-vs-CPU path")
    return counts


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
    X_umap = make_umap_data(UMAP_ROWS, args.seed)
    ni = min(KNN_ITEMS, n)
    kern.update(phase_knn_umap_kernels(torch, X[:ni], X_umap, args.reps, args.seed))
    kern.update(phase_rf_kernels(torch, X[:min(RF_ROWS, n)], y[:min(RF_ROWS, n)], args.reps, args.seed))
    X_host = X[:n].cpu().numpy()
    y_host = y.cpu().numpy()
    del X, y
    torch.cuda.empty_cache()
    # each path runs with the launch counters zeroed just before it and
    # read just after: {kernel: {path: launches}}
    by_path = {key: {"pca_kmeans_logreg": c} for key, c in phase_e2e(torch, X_host, y_host, args.seed).items()}
    phase_subset(torch, X_host, y_host, args.seed, min(args.subset, n))
    by_path["knn_topk"] = {"knn": phase_knn_e2e(torch, X_host[:ni])}
    umap_launches = phase_umap_e2e(torch, X_umap, args.seed)
    by_path["knn_topk"]["umap"] = umap_launches["knn_topk"]
    by_path["sgd_epoch_rows"] = {"umap": umap_launches["sgd_epoch_rows"]}
    phase_umap_subset(torch, X_umap, args.seed, UMAP_SUBSET)
    rf_paths = phase_rf_e2e(torch, X_host, y_host, args.seed)
    phase_rf_profile(torch, X_host, y_host, args.seed)
    rf_subset = phase_rf_subset(torch, X_host, y_host, args.seed, min(RF_SUBSET_ROWS, n))
    for name, paths in rf_paths.items():
        by_path[name] = {path: c for path, c in paths.items() if c}
        if rf_subset[name]:
            by_path[name]["rf_card_vs_cpu"] = rf_subset[name]

    # name -> (TPU kernel's pallas_call, key of the measurement, source file)
    sources = {
        "shifted_gram": ("spark_rapids_ml_tpu/ops/linalg.py:141", "shifted_gram", "shifted_gram"),
        "lloyd_step": ("spark_rapids_ml_tpu/ops/kmeans_pallas.py:174", "lloyd_step", "lloyd_step"),
        "logreg_loss_grad": ("spark_rapids_ml_tpu/ops/logreg_pallas.py:152", "logreg_loss_grad",
                             "logreg_loss_grad"),
        "knn_topk": ("spark_rapids_ml_tpu/ops/knn_pallas.py:160", "knn_topk", "knn_topk"),
        "umap_sgd_epoch": ("spark_rapids_ml_tpu/ops/umap_pallas.py:277", "sgd_epoch_rows", "umap_sgd_epoch"),
        "subblock_hist": ("spark_rapids_ml_tpu/ops/rf_pallas.py:190", "subblock_hist", "rf_hist"),
        "subblock_hist_sel": ("spark_rapids_ml_tpu/ops/rf_pallas.py:312", "subblock_hist_sel", "rf_hist"),
        "packed_traverse": ("spark_rapids_ml_tpu/ops/rf_pallas.py:676", "packed_traverse", "rf_traverse"),
    }
    kernels = []
    for name, (replaces, key, src) in sources.items():
        r = kern[key]
        entry = {
            "name": name, "route": "cuda",
            "source": f"spark_rapids_ml_tpu_torch/csrc/{src}.cu", "replaces": replaces,
            # the sum over the paths that run the kernel, each counted alone
            "launches": sum(by_path[key].values()), "launches_by_path": by_path[key],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "shape": {k: r[k] for k in ("n", "d", "k", "K", "nq", "ni", "R", "C", "neg", "n_tab", "T", "level",
                                        "n_pad", "r_sub", "S", "nb", "k_pad", "d_pad", "rows", "trees", "t_pad",
                                        "k1", "k2") if k in r},
        }
        kernels.append(entry)
    extra = {"lloyd_step_k4097": kern["lloyd_step_4097"], "logreg_loss_grad_K10": kern["logreg_loss_grad_10"],
             "knn_topk_umap_graph": kern["knn_topk_umap_graph"],
             "knn_topk_umap_transform": kern["knn_topk_umap_transform"],
             "sgd_epoch_rows_umap_transform": kern["sgd_epoch_rows_transform"],
             "subblock_hist_level2": kern["subblock_hist_level2"],
             "subblock_hist_variance": kern["subblock_hist_variance"]}
    emit({"phase": "done", "total_s": time.perf_counter() - t_start, "extra_shapes": extra})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
