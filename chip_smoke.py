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
   K1 (shifted Gram) at the PCA fit's padded 12M x 256 shape (which must
   beat its plain version; a wrong mirror of a diagonal tile's skipped
   quadrant is one of its controls) and at ragged shapes, on and off its
   float4 path (d % 4 != 0, a base off 16-byte alignment).
   K2 (fused Lloyd step: 3xTF32 ``wgmma`` products on the tensor cores fed
   by TMA, the centres split into TF32 hi and lo once a launch, a fused
   argmin, and the accumulation's vector atomics overlapped with the next
   row block by a persistent grid) at 12M x 256 with k = 1024 and k =
   4,097 (its controls: a lost feature tile, a lost row range, and one-pass
   TF32 scores, which its rule must refuse) and at ragged shapes (d in {300,
   124, 3000, 257, 61} and a base off 16-byte alignment, k in {1, 37,
   130}); it must beat its plain version and one matmul + argmin +
   ``index_add_`` at both main shapes and take at most LLOYD_MS_MAX at k =
   1024.
   K3 (logistic loss + gradient) at K = 1 and, through its multinomial
   kernel, at K = 10 on the 12M rows (which must beat its plain version)
   and at ragged shapes, each with the kernel that ran it; K4 (kNN
   distance + top-k, 3xTF32 on the tensor cores) at 131,072 queries x 1M
   items x 256, k = 16, on a 4,096-row sample (its controls: shifted ids,
   and one-pass TF32 scores, which the band must refuse), at the join's
   4,096 queries x 1M (item splits and their merge), at the UMAP graph (k
   = 16) and transform (k = 15) shapes of 65,536 x 65,536 x 256 on a
   4,096-row sample, and in full at ragged shapes; it must beat its plain
   version at all four main shapes, one chunked addmm + topk at the kNN and
   UMAP-graph shapes, and take at most KNN_MS_MAX at the kNN shape; K10
   (one UMAP SGD epoch) on the rows of the 65,536 x 256 UMAP graph and at
   the transform's shape (65,536 rows, K = 15); the
   forest kernels at the builder's own level layouts: K5 (sub-block
   histograms) at the deepest (level 12) and a shallow (level 2) call of
   the bench forest (131,072 x 256, 8 trees a batch, k = 16, 128 bins),
   the regressor's S = 3 call and ragged shapes, exact for integer stats,
   repeatable bit for bit; K6 (fused selection) at the 131,072 x 3,000
   level-12 call and a ragged one with n_features == d_pad; K9 (packed
   traversal) on one transform batch of a depth-13, 50-tree forest, at
   3,000 features and at k2 in {1, 6}, equal to its plain version; K8
   (packed-byte gather, one launch per group of 8 trees) at the byte
   indices the bins engine makes for 8 depth-13 trees (k = 63), for 8
   depth-8 trees (the GBT's k = 1), at 3,000 features (750 words) and at
   ragged shapes with out-of-range indices, equal to its plain version,
   and K7 (its one-index-set form) likewise, each timed over 200 calls
   also as device time alone (the calls queued behind a device wait) and
   host time a call, beside one ``torch.gather``, and each of its two
   instances (staged, direct) held and timed alone; K5 at the GBT's
   deepest split level (S = 4 logistic stats, one tree, all 256 features).
3. end to end, each path with the launch counters zeroed just before it
   and read just after (every kernel of the path must have run): PCA(k=16),
   KMeans(k=1024, maxIter=10) and binomial LogisticRegression(maxIter=20)
   fit then transform through ``DataFrame`` on N x 256 f32 rows made from
   ``--seed``, with a 100k-row subset fitted on the card and on the CPU
   (plain path) and compared, and a 10-class (multinomial)
   LogisticRegression on those rows fitted on both and compared (its K3
   launches a path of their own); NearestNeighbors(k=16).kneighbors of the
   first 131,072 of 1M of those rows against all 1M, and a join; UMAP(
   n_neighbors=15, random_state=42) fit, transform and save/load at
   65,536 x 256 (bench.py's blobs), held by trustworthiness on a 4,096-row
   sample, and a 20,000-row UMAP fitted on the card and on the CPU;
   RandomForestClassifier(numTrees=50, maxDepth=13, maxBins=128) fit,
   transform, save/load and transform on the first 131,072 rows (bench.py's
   rf config), RandomForestRegressor(numTrees=8) on the same rows with a
   real-valued label, RandomForestClassifier(numTrees=8) on 131,072 x 3,000
   rows (the reference's benchmark width: K6), each classifier's bins
   engine (K8) equal to its packed engine (K9) bit for bit, and an 8-tree
   depth-10 forest on 20,000 rows fitted on the card and on the CPU (the
   same draws: predictions agree on >= 99.9% of rows);
   GBTClassifier(maxIter=20, maxDepth=8, maxBins=128) fit, transform, bins
   engine (equal bit for bit) and save/load on the rf rows (bench.py's gbt
   config), GBTRegressor likewise on the regressor's label, and a 20,000-row
   10-round GBT fitted on the card and on the CPU (predictions agree on >=
   99.5% of rows).

The last three lines are the card line, ``{"kernels": [...]}`` and
``{"ok": true, "device": {...}}``. Without a CUDA card the script exits 1
and prints no result.

    python3 chip_smoke.py --gather-only [--sweep]

is a probe: K7/K8's kernel phase alone on 131,072 rows (and, with
``--sweep``, each instance at a range of chunk sizes and grids), with the
host cost of the wrapper's steps; it prints no result line.

    python3 chip_smoke.py --knn-only [--sweep]

is a probe too: K4's kernel phase alone (its four main shapes, ragged
shapes and controls) on 1M rows made from ``--seed``, with the kernel's
registers, spills, resident blocks and SASS instruction counts and its
gates' verdicts (reported, not enforced); ``--sweep`` times other stage depths and item
splits, and a tight state that no tile passes (the product and the gate
without the insertion).

    python3 chip_smoke.py --kmeans-only [--sweep]

is a probe of K2 alike: its kernel phase alone on ``--rows`` rows, with
its attributes, SASS counts (``HGMMA``, ``FFMA``, ``UTMALDG``, the atomics)
and gates; ``--sweep`` times every row weight 0 beside every row weight 1
(an m = 0 row skips the atomics: the product, the argmin and the row walk
alone) and the other stage depths.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time

import numpy as np

# H100 SXM data-sheet peaks: FP32 outside the
# tensor cores, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12  # dense, on the tensor cores
PEAK_BYTES_PER_S = 3.35e12
# timed calls of K7/K8 and their library call: launch-sized, so many
SLEEP_CYCLES = 60_000_000  # the device wait ahead of them: ~30 ms at 1.98 GHz
GATHER_REPS = 200

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
# bench.py's gbt config (bench.py:955-1137): binary logistic on the rf rows,
# 20 rounds, depth 8 (hop 1 of 7 levels, hop 2 of 1), 128 bins, all features
GBT_ROUNDS = 20
GBT_DEPTH = 8
# training accuracy floor of the GBT classifier: the label is a hyperplane
# through all 256 features, which 20 lr-0.1 rounds of axis-aligned depth-8
# trees fit to about 0.8 (a flipped near-tie moves it by about 0.01); the
# constant model scores 0.5
GBT_ACC_MIN = 0.75
# the GBT fitted on the card and on the CPU: gradient stats are real
# valued, so sums in other orders may move a near-tied split (RF's 99.9%
# rests on exact integer histograms)
GBT_SUBSET_ROUNDS = 10
GBT_AGREE_MIN = 0.995
# the multinomial LogisticRegression fitted on the card and on the CPU
LOGREG_CLASSES = 10
LOGREG10_AGREE_MIN = 0.995


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def bound_ms(nbytes: float, flops: float, peak: float = PEAK_F32_FLOPS):
    t_b = nbytes / PEAK_BYTES_PER_S * 1e3
    t_f = flops / peak * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def device_host(torch, fn, reps: int):
    """(device ms per call, host µs per call) of ``fn`` over ``reps`` calls
    queued behind a device wait (``torch.cuda._sleep``, a spin kernel), so
    that the host runs ahead and the events around the calls time the
    device alone; the host clock times their enqueue, with no
    synchronisation inside. Fails if the enqueue outlasted the wait: the
    device would then have gone idle between calls, and the number would
    not be device-only."""
    fn()
    torch.cuda.synchronize()
    e0, e1, e2 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    t = time.perf_counter()
    e0.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    e1.record()
    h = time.perf_counter()
    for _ in range(reps):
        fn()
    t_end = time.perf_counter()
    e2.record()
    e2.synchronize()
    wait_ms = e0.elapsed_time(e1)
    check((t_end - t) * 1e3 < wait_ms,
          f"{reps} calls took {(t_end - t) * 1e3:.3f} ms to enqueue, longer than the {wait_ms:.3f} ms device wait")
    return e1.elapsed_time(e2) / reps, (t_end - h) * 1e6 / reps


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
    if control:  # a kernel that loses an output tile, one row range in a tile,
        # or mirrors a diagonal tile's skipped lower-left quadrant wrongly
        tile = G.clone()
        tile[128:, :128] = 0.0
        tile[:128, 128:] = 0.0
        mirror = G.clone()
        mirror[64:128, :64] = 0.0
        L = n // CONTROL_SPLIT
        lost = lin.shifted_gram_plain(X[:L], m[:L], mu)[0]
        lost[:128, :] = 0.0
        lost[:, :128] = 0.0
        lost.fill_diagonal_(0.0)
        out["controls"] = negative_controls(torch, {
            "off-diagonal 128x128 tile zeroed": tile,
            f"first 1/{CONTROL_SPLIT} of rows lost in G[128:, 128:] off the diagonal": G - lost,
            "diagonal tile's lower-left 64x64 quadrant zeroed (a wrong mirror)": mirror,
        }, Gr, TG, n)
    if reps:
        Xc = (X - mu) * m[:, None]
        out["ms"] = cuda_ms(torch, lambda: lin.shifted_gram(X, m, mu), reps)
        out["plain_ms"] = cuda_ms(torch, lambda: lin.shifted_gram_plain(X, m, mu), reps)
        out["library_ms"] = cuda_ms(torch, lambda: torch.matmul(Xc.T, Xc), reps)
        out["ms_over_library"] = out["ms"] / out["library_ms"]
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


def lloyd_verdict(torch, sums, counts, cost, ref, n):
    """K2's rule against the f64 reference: a row may change centre only
    across a near tie, and the sums and cost within ``held``'s band beyond
    the near ties' slack. Returns (counts within the near ties, |dcount|,
    max |dsums|, |dsums|/tol, |dcost|/tol)."""
    dcount = (counts.to(torch.int64) - ref["counts"]).abs()
    counts_ok = bool((dcount <= ref["near"]).all())
    err, r_sums = held(torch, sums, ref["sums"], ref["T"], n, ref["slack"])
    _, r_cost = held(torch, cost, ref["cost"], ref["T_cost"], n, ref["slack_cost"])
    return counts_ok, dcount, err, r_sums, r_cost


def check_lloyd_step(torch, kk, X, m, C, reps, control=False):
    n, d = X.shape
    k = C.shape[0]
    sums, counts, cost = kk.lloyd_step(X, m, C)
    ref = lloyd_reference(torch, kk, X, m, C)
    counts_ok, dcount, err, r_sums, r_cost = lloyd_verdict(torch, sums, counts, cost, ref, n)
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
        # one-pass TF32 scores (the plain version with TF32 matmuls) must
        # fail the rule that the kernel's 3xTF32 scores keep to
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            s32, c32, cost32 = kk.lloyd_step_plain(X, m, C)
            torch.cuda.synchronize()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
        ok32, dc32, _, rs32, rc32 = lloyd_verdict(torch, s32, c32, cost32, ref, n)
        check(not (ok32 and rs32 <= 1.0 and rc32 <= 1.0), "the K2 check does not catch one-pass TF32 scores")
        out["controls"].append({"control": "plain version with one-pass TF32 matmuls",
                                "counts_within_near_ties": ok32, "count_changes": int(dc32.sum()),
                                "err_over_tol": rs32, "cost_err_over_tol": rc32})
        del s32, c32
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
        # the score product runs on the tensor cores in 3xTF32: three TF32
        # products per (row, centre, feature), at the dense TF32 rate; the
        # sums, ||x||² and the argmin on the CUDA cores are below 1% of it
        out["bound_ms"], out["bound_by"] = bound_ms(nbytes, 3.0 * 2.0 * n * k * d, PEAK_TF32_FLOPS)
        # the same work as f32 FMA on the CUDA cores
        flops = 2.0 * n * k * d + 2.0 * n * d + 3.0 * n * k  # scores, sums+||x||², argmin
        out["bound_f32_ms"] = bound_ms(nbytes, flops)[0]
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


def k3_variant(lk, d, K, multinomial, aligned=True) -> str:
    """Which kernel of ``csrc/logreg_loss_grad.cu`` the wrapper launches."""
    code = lk._k3_variant(d, K, multinomial, aligned)
    if code == 0:
        return "general"
    return f"rows(NV={code // 10}, KR=1)" if code < 100 else f"mrows(NV={code // 100}, K={code % 100})"


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
    aligned = X.data_ptr() % 16 == 0 and A.data_ptr() % 16 == 0
    out = {"n": n, "d": d, "K": K, "variant": k3_variant(lk, d, K, multinomial, aligned),
           "max_abs_err": err, "err_over_tol": r_gA,
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
        # one-pass TF32 scores (the plain version with TF32 matmuls) must
        # fall outside the band that the kernel's 3xTF32 scores keep to
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            st = (torch.full((len(rows), k), float("inf"), device=dev),
                  torch.full((len(rows), k), -1, dtype=torch.int32, device=dev))
            td32, ti32 = kn.knn_topk_pass_plain(Xq[rows], Xi, csq, ids, *st)
            torch.cuda.synchronize()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
        c = knn_held(torch, td32 + xsq[:, None], ti32, ref_d2, ref_ids, tau)
        check(c[1] > 1.0 or c[4] > 0, "the K4 check does not catch one-pass TF32 scores")
        out["controls"] = [{"control": "ids of query rows 0..127 shifted by one",
                            "rows_other_ids_outside_band": b[4]},
                           {"control": "plain version with one-pass TF32 matmuls", "err_over_tol": c[1],
                            "rows_other_ids_outside_band": c[4]}]
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
        # the products run on the tensor cores in 3xTF32: three TF32
        # products per operand pair, at the dense TF32 rate
        out["bound_ms"], out["bound_by"] = bound_ms(nbytes, 3.0 * 2.0 * nq * ni * d, PEAK_TF32_FLOPS)
        # the same work as f32 FMA on the CUDA cores
        out["bound_f32_ms"] = bound_ms(nbytes, 2.0 * nq * ni * d + 2.0 * nq * ni)[0]
    g = kn.knn_geometry(nq, ni, d, k)
    out.update(BM=g.bm, S=g.splits, stages=g.stages, slab=kn.K4_SLAB, blocks=g.blocks)
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

    res["shifted_gram"] = k1 = check_shifted_gram(torch, lin, X_pca, m_pca, reps, control=True)
    emit({"phase": "kernels", "kernel": "shifted_gram", **k1})
    if reps:  # the redesigned kernel must beat the plain version it replaces
        check(k1["ms"] < k1["plain_ms"],
              f"shifted_gram {k1['ms']:.3f} ms not below its plain version's {k1['plain_ms']:.3f} ms")

    y = (X[:, 0] > X[:, 0].median()).float()
    res["logreg_loss_grad"] = check_logreg(torch, lk, X, y, m, 1, reps, seed, control=True)
    emit({"phase": "kernels", "kernel": "logreg_loss_grad", **res["logreg_loss_grad"]})
    res["logreg_loss_grad_10"] = k10 = check_logreg(torch, lk, X, y, m, 10, reps, seed, control=True)
    emit({"phase": "kernels", "kernel": "logreg_loss_grad", **k10})
    if reps:  # the multinomial kernel must beat the plain version it replaces
        check(k10["ms"] < k10["plain_ms"],
              f"logreg_loss_grad K=10 {k10['ms']:.3f} ms not below its plain version's {k10['plain_ms']:.3f} ms")

    # ragged shapes: n, d, k and K off every tile size
    for n_r, d_r in ((100_003, 300), (50_001, 124), (1_037, 3000)):
        Xr = torch.randn(n_r, d_r, generator=g, device=dev) + 3.0
        mr = (torch.rand(n_r, generator=g, device=dev) > 0.1).float()
        yr = (torch.rand(n_r, generator=g, device=dev) > 0.5).float()
        emit({"phase": "kernels", "kernel": "shifted_gram", "ragged": True,
              **check_shifted_gram(torch, lin, Xr, mr, 0)})
        for K_r in (1, 5, 130):
            emit({"phase": "kernels", "kernel": "logreg_loss_grad", "ragged": True,
                  **check_logreg(torch, lk, Xr, yr, mr, K_r, 0, seed)})
        del Xr
    # K1 off its float4 path: d % 4 != 0 (one column past a tile, and
    # narrower than half a tile), and a base 4 bytes off 16-byte alignment
    for n_r, d_r, offset in ((100_003, 257, 0), (50_001, 61, 0), (100_003, 256, 1)):
        buf = torch.randn(n_r * d_r + offset, generator=g, device=dev) + 3.0
        Xr = buf[offset:].view(n_r, d_r)
        mr = (torch.rand(n_r, generator=g, device=dev) > 0.1).float()
        emit({"phase": "kernels", "kernel": "shifted_gram", "ragged": True, "misaligned": bool(offset),
              **check_shifted_gram(torch, lin, Xr, mr, 0)})
        del buf, Xr
    # the multinomial register-row kernel off its tiles (d = 124, K = 5
    # above lands there too)
    Xr = torch.randn(100_003, 252, generator=g, device=dev) + 3.0
    mr = (torch.rand(100_003, generator=g, device=dev) > 0.1).float()
    emit({"phase": "kernels", "kernel": "logreg_loss_grad", "ragged": True,
          **check_logreg(torch, lk, Xr, mr, mr, 13, 0, seed)})
    del Xr
    torch.cuda.synchronize()
    return res


# K2 at k = 1024 must take at most three quarters of the 194.61 ms of the
# kernel it replaced (H100 80GB HBM3 at 700 W)
LLOYD_MS_MAX = 146.0


def phase_lloyd_kernels(torch, X, reps, seed):
    """K2 at the two shapes the main path gives it, each timed with its
    controls: k = 1024 (the Lloyd iterations) and k = 4,097
    (count_closest over the k-means|| candidates: 1 + 2 steps x 2k draws at
    oversampling 2); and at ragged shapes, n, d and k off every tile, d %
    4 != 0 and a base 4 bytes off 16-byte alignment, at k in {1, 37, 130}."""
    from spark_rapids_ml_tpu_torch.ops import kmeans_kernels as kk

    n, dev = X.shape[0], X.device
    m = torch.ones(n, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 4)
    res = {}
    idx = torch.randint(0, n, (4097,), generator=g, device=dev)
    C1024 = X[idx[:1024]] + 0.1 * torch.randn(1024, E2E_D, generator=g, device=dev)
    res["lloyd_step"] = check_lloyd_step(torch, kk, X, m, C1024.contiguous(), reps, control=True)
    emit({"phase": "kernels", "kernel": "lloyd_step", **res["lloyd_step"]})
    res["lloyd_step_4097"] = check_lloyd_step(torch, kk, X, m, X[idx].contiguous(), max(1, reps // 2),
                                              control=True)
    emit({"phase": "kernels", "kernel": "lloyd_step", **res["lloyd_step_4097"]})
    del m
    for n_r, d_r, offset in ((100_003, 300, 0), (50_001, 124, 0), (1_037, 3000, 0), (100_003, 257, 0),
                             (50_001, 61, 0), (100_003, 256, 1)):
        buf = torch.randn(n_r * d_r + offset, generator=g, device=dev) + 3.0
        Xr = buf[offset:].view(n_r, d_r)
        mr = (torch.rand(n_r, generator=g, device=dev) > 0.1).float()
        for k_r in (1, 37, 130):
            Cr = Xr[torch.randint(0, n_r, (k_r,), generator=g, device=dev)].contiguous()
            emit({"phase": "kernels", "kernel": "lloyd_step", "ragged": True, "misaligned": bool(offset),
                  **check_lloyd_step(torch, kk, Xr, mr, Cr, 0)})
        del buf, Xr
    torch.cuda.synchronize()
    return res


def lloyd_gates(res) -> dict:
    """K2's gates: below its plain version and its library call at k =
    1024 and k = 4,097, and at most LLOYD_MS_MAX at k = 1024. Returns each
    gate's verdict; the caller fails the run on any False."""
    out = {}
    for key in ("lloyd_step", "lloyd_step_4097"):
        r = res[key]
        out[f"{key}_below_plain"] = r["ms"] < r["plain_ms"]
        out[f"{key}_below_library"] = r["ms"] < r["library_ms"]
    out["lloyd_step_at_most_ms_max"] = res["lloyd_step"]["ms"] <= LLOYD_MS_MAX
    return out


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


KNN_JOIN_QUERIES = 4096  # exactNearestNeighborsJoin's queries in the kNN path
# K4 at the kNN shape must take at most half of the 2,142.10 ms of the
# kernel it replaced (H100 80GB HBM3 at 700 W)
KNN_MS_MAX = 1071.0


def phase_knn_kernels(torch, X_items, X_umap, reps, seed):
    """K4 at the four shapes the main path gives it, each timed: kNN
    (131,072 queries x 1M items, k = 16, with its negative controls), the
    join (4,096 queries x 1M), the UMAP graph (65,536 rows against
    themselves, k = 16) and the UMAP transform (k = 15); and in full at
    ragged shapes."""
    from spark_rapids_ml_tpu_torch.ops import knn_kernels as kn

    dev = X_items.device
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 2)
    res = {}
    nq, ni = min(KNN_QUERIES, X_items.shape[0]), X_items.shape[0]
    ones = torch.ones(ni, device=dev)
    res["knn_topk"] = check_knn_topk(torch, kn, X_items[:nq], X_items, ones, KNN_K,
                                     sample=query_sample(torch, nq, dev), reps=max(1, reps // 3), control=True)
    emit({"phase": "kernels", "kernel": "knn_topk", **res["knn_topk"]})
    nj = min(KNN_JOIN_QUERIES, ni)
    res["knn_topk_join"] = check_knn_topk(torch, kn, X_items[:nj], X_items, ones, KNN_K,
                                          sample=query_sample(torch, nj, dev, rows=1024), reps=max(1, reps))
    emit({"phase": "kernels", "kernel": "knn_topk", "join_shape": True, **res["knn_topk_join"]})
    del ones
    # ragged shapes: nq, ni off the tiles, a masked item block, d in {3,
    # 124, 300}, k in {1, 16, 100, 128} (128: the 64-row blocks), and one
    # fold in two passes
    for d_r in (3, 124, 300):
        Xq = torch.randn(1037, d_r, generator=g, device=dev) + 3.0
        Xi = torch.randn(70_001, d_r, generator=g, device=dev) + 3.0
        mask = torch.ones(70_001, device=dev)
        mask[5000:7000] = 0.0
        for k_r in (1, 16, 100, 128):
            emit({"phase": "kernels", "kernel": "knn_topk", "ragged": True,
                  **check_knn_topk(torch, kn, Xq, Xi, mask, k_r,
                                   split=30_011 if (d_r, k_r) == (124, 16) else None)})
    # the UMAP shapes: the graph (65,536 rows against themselves, k = 16)
    # and the transform of the same rows (k = 15)
    Xd = torch.from_numpy(X_umap).to(dev)
    n = Xd.shape[0]
    ones, sample = torch.ones(n, device=dev), query_sample(torch, n, dev)
    res["knn_topk_umap_graph"] = check_knn_topk(torch, kn, Xd, Xd, ones, UMAP_NEIGHBORS + 1, sample=sample,
                                                reps=max(1, reps))
    emit({"phase": "kernels", "kernel": "knn_topk", "umap_graph_shape": True, **res["knn_topk_umap_graph"]})
    res["knn_topk_umap_transform"] = check_knn_topk(torch, kn, Xd, Xd, ones, UMAP_NEIGHBORS, sample=sample,
                                                    reps=max(1, reps))
    emit({"phase": "kernels", "kernel": "knn_topk", "umap_transform_shape": True,
          **res["knn_topk_umap_transform"]})
    torch.cuda.synchronize()
    return res


def knn_gates(res) -> dict:
    """K4's gates: below its plain version at all four shapes, below one
    chunked addmm + topk at the kNN and UMAP-graph shapes, and at most
    KNN_MS_MAX at the kNN shape. Returns each gate's verdict; the caller
    fails the run on any False."""
    out = {}
    for key in ("knn_topk", "knn_topk_join", "knn_topk_umap_graph", "knn_topk_umap_transform"):
        r = res[key]
        out[f"{key}_below_plain"] = r["ms"] < r["plain_ms"]
        if key in ("knn_topk", "knn_topk_umap_graph"):
            out[f"{key}_below_library"] = r["ms"] < r["library_ms"]
    out["knn_topk_at_most_ms_max"] = res["knn_topk"]["ms"] <= KNN_MS_MAX
    return out


def phase_knn_umap_kernels(torch, X_items, X_umap, reps, seed):
    """K4 (``phase_knn_kernels``, gated) and K10 at the UMAP fit shape (the
    CSR rows of the 65,536 x 256 graph, K = 24, C = 2, neg = 5) and the
    transform shape (65,536 rows, K = 15, neg = 5, frozen table)."""
    from spark_rapids_ml_tpu_torch.models.umap import drop_self_column, knn_brute
    from spark_rapids_ml_tpu_torch.ops import umap_kernels as uk

    res = phase_knn_kernels(torch, X_items, X_umap, reps, seed)
    gates = knn_gates(res)
    emit({"phase": "kernels", "kernel": "knn_topk", "gates": gates, "ms_max": KNN_MS_MAX})
    for name, ok in gates.items():
        check(ok, f"K4 gate {name} failed: " + json.dumps(
            {k: {m: r[m] for m in ("ms", "plain_ms", "library_ms")} for k, r in res.items()}))
    dev = X_items.device
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 3)
    # K10 on the UMAP fit's own rows: its graph, a random table
    Xd = torch.from_numpy(X_umap).to(dev)
    n = Xd.shape[0]
    dists, idx = drop_self_column(*knn_brute(Xd, Xd, k=UMAP_NEIGHBORS + 1), k=UMAP_NEIGHBORS)
    heads, tails, weights = uk.fuzzy_simplicial_set(idx.cpu().numpy(), dists, 1.0, 1.0, device=dev)
    row_heads, tails_pad, p_pad = uk.build_row_adjacency(heads, tails, weights, X_umap.shape[0], K=24)
    # the transform's tails: each row's 15 training neighbours (self excluded)
    tails_tr = idx.contiguous()
    del Xd, dists
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


def rf_level_inputs(torch, pt, bins, stats, level, T, k, n_features, g, sel=False, depth=RF_DEPTH,
                    bootstrap=True):
    """The inputs one compact level of the forest builder gives K5 (K6 with
    ``sel``) for T trees of ``depth`` levels, laid out by the builder's own
    glue (``compact_sizes``, ``_compact_layout``): each tree's rows
    (Poisson(1) bootstrap weights, or 1 without ``bootstrap``) spread over
    the level's 2^level nodes at random, each node's k features drawn at
    random, sentinel slots up to the next power of two."""
    n, d_pad = bins.shape
    dev, S = bins.device, stats.shape[1]
    n_nodes, k_pad = 1 << level, pt.next_pow2(k)
    r_sub, n_pad, f_chunk = pt.compact_sizes(n, level, depth, S, k_pad, RF_BINS)
    seg = torch.randint(0, n_nodes, (T, n), generator=g, device=dev)
    src2, pvalid, sbc, _ = pt._compact_layout(seg, n_nodes, r_sub, n_pad)
    w = torch.poisson(torch.ones((T, n), device=dev), generator=g) if bootstrap else torch.ones((T, n), device=dev)
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


def hop2_indices(torch, pt, xb, feat, thr, depth):
    """The (G, n, 2^k2 - 1) int32 byte indices the bins engine gives K8 for
    one group of trees: each row's hop-2 table row, selected by its own
    hop 1 (``tree_kernels._hop2_rows``)."""
    k1, k2 = pt._split_depths(depth)
    f, t = torch.from_numpy(feat).to(xb.device).long(), torch.from_numpy(thr).to(xb.device).long()
    return torch.stack([pt._hop2_rows(xb, f[i], t[i], k1=k1, k2=k2)[5] for i in range(f.shape[0])]).to(torch.int32)


def check_byte_gather(torch, rk, packed, idx, reps, control=False, single=False):
    """K8 (K7 with ``single``: the first index set alone) against its plain
    version: integer bytes, equal. The control flips one output byte,
    which the check must catch. Library: one ``torch.gather`` on the
    rows' byte view with an int64 index made beforehand (the index
    conversion is not timed)."""
    if single:
        idx = idx[0]
        kern, plain = rk.packed_byte_gather, rk.packed_byte_gather_plain
    else:
        kern, plain = rk.packed_byte_gather_many, rk.packed_byte_gather_many_plain
    out = kern(packed, idx)
    ref = plain(packed, idx)
    torch.cuda.synchronize()
    n, words = packed.shape
    G, k = (1, idx.shape[1]) if single else (idx.shape[0], idx.shape[2])
    differ = int((out != ref).sum())
    check(differ == 0, f"{kern.__name__} n={n} words={words} G={G} k={k}: {differ} bytes differ")
    outside = int(((idx < 0) | (idx >= 4 * words)).sum())
    # a package from before K7/K8's routing (a parent checkout, timed in the
    # same call for a before/after comparison) has no geometry to report
    routed = hasattr(rk, "gather_geometry")
    res = {"rows": n, "words": words, "G": G, "k": k, "max_abs_err": 0, "bytes_differ": differ,
           "out_of_range_indices": outside,
           "variant": rk.gather_geometry(packed, idx)._asdict() if routed else "one thread an entry"}
    if control:
        bad = out.clone().view(-1)
        pos = bad.numel() // 2 + 1
        bad[pos] ^= 1
        caught = not bool(torch.equal(bad.view(out.shape), ref))
        check(caught, f"the {kern.__name__} check does not catch a flipped output byte")
        res["controls"] = [{"control": f"output entry {pos}: lowest bit flipped", "caught": caught}]
        del bad
    if reps:
        # ms: events around back-to-back calls (the host may set their
        # pace); device_ms / host_us: the same calls split (device_host)
        call = lambda: kern(packed, idx)  # noqa: E731
        res["ms"] = cuda_ms(torch, call, GATHER_REPS)
        res["device_ms"], res["host_us"] = device_host(torch, call, GATHER_REPS)
        res["timed_calls"] = GATHER_REPS
        res["plain_ms"] = cuda_ms(torch, lambda: plain(packed, idx), reps)
        pb = packed.view(torch.uint8)                    # (n, 4·words), little-endian bytes
        i64 = idx.long()
        src = pb if single else pb.unsqueeze(0).expand(G, n, 4 * words)
        library = lambda: torch.gather(src, src.dim() - 1, i64)  # noqa: E731
        res["library_ms"] = cuda_ms(torch, library, GATHER_REPS)
        res["library_device_ms"], res["library_host_us"] = device_host(torch, library, GATHER_REPS)
        res["library_call"] = "torch.gather on the uint8 byte view, int64 index made beforehand"
        del i64
        # each instance that takes the shape, forced (device ms, host µs)
        res["instances"] = {}
        for staged in (True, False) if routed else ():
            try:
                geom = rk._gather_geometry(n, words, k, G, True, True, *gather_device(rk), staged=staged)
            except ValueError:
                continue
            res["instances"][geom.instance] = {"rows": geom.rows, "grid": geom.grid, **dict(zip(
                ("device_ms", "host_us"), device_host(torch, lambda: rk._launch_byte_gather(packed, idx, geom),
                                                      GATHER_REPS)))}
        # idx read once, out written once (int32 each), and of the rows the
        # 32-byte sectors (the card's unit of access) that the lookups touch:
        # what this run's indices need (at the GBT's k = 1 a row's 8 lookups
        # touch ~5 of its 8 sectors)
        inside = (idx >= 0) & (idx < 4 * words)
        row_at = torch.arange(n, device=idx.device).view(n, 1) * (4 * words)
        touched = int(torch.unique(((row_at + idx.long()) >> 5)[inside]).numel())
        nbytes = 4.0 * 2 * G * n * k + 32.0 * touched
        res["bytes"], res["touched_sectors"], res["row_sectors"] = nbytes, touched, -(-n * 4 * words // 32)
        # a shift, a mask, a compare pair and a select per output
        res["bound_ms"], res["bound_by"] = bound_ms(nbytes, 5.0 * G * n * k)
    return res


def gather_device(rk):
    """(shared memory a block may opt into, SMs, resident blocks an SM) of
    cuda:0, as K7/K8's geometry takes them."""
    sms, smem, resident = rk._gather_device(0)
    return smem, sms, resident


def check_gather_instances(torch, rk, packed, idx, what):
    """Each instance of K8 that takes (packed, idx), forced, against the
    plain version: 0 bytes differ, and a flipped byte is caught."""
    if not hasattr(rk, "gather_geometry"):  # see check_byte_gather
        return
    G, n, k = idx.shape
    words = packed.shape[1]
    ref = rk.packed_byte_gather_many_plain(packed, idx)
    for staged in (True, False):
        try:
            geom = rk._gather_geometry(n, words, k, G, packed.data_ptr() % 16 == 0, idx.data_ptr() % 16 == 0,
                                       *gather_device(rk), staged=staged)
        except ValueError:  # the staged instance does not take these rows
            continue
        out = rk._launch_byte_gather(packed, idx, geom)
        torch.cuda.synchronize()
        differ = int((out != ref).sum())
        check(differ == 0, f"packed_byte_gather_many {what} ({geom.instance}): {differ} bytes differ")
        bad = out.view(-1).clone()
        bad[bad.numel() // 3] ^= 1 << 7
        caught = not bool(torch.equal(bad.view(out.shape), ref))
        check(caught, f"the {geom.instance} check does not catch a flipped output byte")
        emit({"phase": "kernels", "kernel": "packed_byte_gather_many", "ragged": what, "instance": geom._asdict(),
              "rows": n, "words": words, "G": G, "k": k, "bytes_differ": differ,
              "out_of_range_indices": int(((idx < 0) | (idx >= 4 * words)).sum()),
              "controls": [{"control": f"output entry {bad.numel() // 3}: bit 7 flipped", "caught": caught}]})


def ragged_gather_inputs(torch, rng, n, words, G, k, idx_offset=0, packed_offset=0):
    """Random packed rows and indices in [-1, 4·words], with 4·words (the
    sentinel past the row) and -1 planted; a nonzero offset makes the
    tensor a contiguous view that many entries into its storage."""
    pk = rng.integers(-2 ** 31, 2 ** 31, size=n * words + packed_offset, dtype=np.int64).astype(np.int32)
    ir = rng.integers(-1, 4 * words + 1, size=G * n * k + idx_offset).astype(np.int32)
    pk = torch.from_numpy(pk).cuda()[packed_offset:].view(n, words)
    ir = torch.from_numpy(ir).cuda()[idx_offset:].view(G, n, k)
    ir[:, ::7, 0] = 4 * words
    ir[:, ::5, -1] = -1
    return pk, ir


def sweep_gather(torch, rk, shape, packed, idx):
    """Device ms of each instance at chunk sizes R around the routed ones
    (a probe: ``--gather-only``), each held against the routed kernel."""
    from spark_rapids_ml_tpu_torch.ops import _build

    G, n, k = idx.shape
    words = packed.shape[1]
    smem_optin, sms, resident = gather_device(rk)
    occ = _build.function("rf_byte_gather", "packed_byte_gather_occupancy", [ctypes.c_int, ctypes.c_int,
                                                                              ctypes.c_void_p])
    ref = rk._launch_byte_gather(packed, idx)
    for instance in ("staged_vec", "direct_vec"):
        for R in (4, 8, 16, 24, 32, 48, 64, 96, 128, 256, 512):
            smem = 2 * R * 4 * words if instance == "staged_vec" else 0
            if smem > smem_optin or R * 8 > n:
                continue
            blocks = ctypes.c_int(0)
            _build.check("rf_byte_gather", occ(rk._GATHER_INSTANCES[instance], smem, ctypes.byref(blocks)))
            chunks = -(-n // R)
            for grid in sorted({min(chunks, sms * blocks.value), chunks}):
                geom = rk.GatherGeometry(instance, R, 2 if smem else 0, grid, smem)
                check(torch.equal(rk._launch_byte_gather(packed, idx, geom), ref), f"sweep {geom} differs")
                ms, _ = device_host(torch, lambda: rk._launch_byte_gather(packed, idx, geom), GATHER_REPS)
                emit({"probe": "sweep", "shape": shape, **geom._asdict(), "resident": blocks.value,
                      "device_ms": ms})


def phase_byte_gather_kernels(torch, bins, wide, reps, seed, sweep=False):
    """K8 (and K7) at the bins engine's shapes: the bench forest's (8
    depth-13 trees, k = 63, 64 words), the GBT's (8 depth-8 trees, k = 1),
    3,000 features (750 words), and ragged n, words, G and k with
    out-of-range indices. ``sweep``: also ``sweep_gather`` at the four
    timed shapes."""
    from spark_rapids_ml_tpu_torch.ops import rf_kernels as rk
    from spark_rapids_ml_tpu_torch.ops import tree_kernels as pt

    rng = np.random.default_rng(seed + 17)
    res = {}
    packed = pt.pack_bins(bins)
    feat, thr = random_forest(rng, 8, RF_DEPTH, bins.shape[1], RF_BINS)
    idx = hop2_indices(torch, pt, bins, feat, thr, RF_DEPTH)

    def held_timed(key, kernel, shape, packed_rows, indices, single=False):
        res[key] = r = check_byte_gather(torch, rk, packed_rows, indices, reps, control=True, single=single)
        emit({"phase": "kernels", "kernel": kernel, "shape": shape, **r})
        if reps:  # the redesigned kernel must beat the plain version it replaces
            check(r["device_ms"] < r["plain_ms"],
                  f"{kernel} ({shape}) {r['device_ms']:.4f} ms not below its plain version's {r['plain_ms']:.4f} ms")
        if sweep:
            sweep_gather(torch, rk, shape, packed_rows, indices[:1] if single else indices)

    held_timed("packed_byte_gather_many", "packed_byte_gather_many", "rf_bench", packed, idx)
    held_timed("packed_byte_gather", "packed_byte_gather", "rf_bench_one_tree", packed, idx, single=True)
    feat, thr = random_forest(rng, 8, GBT_DEPTH, bins.shape[1], RF_BINS)
    idx = hop2_indices(torch, pt, bins, feat, thr, GBT_DEPTH)
    held_timed("packed_byte_gather_many_gbt", "packed_byte_gather_many", "gbt", packed, idx)
    xw = wide[:, :RF_WIDE_D].contiguous()
    feat, thr = random_forest(rng, 8, RF_DEPTH, RF_WIDE_D, RF_BINS)
    idx = hop2_indices(torch, pt, xw, feat, thr, RF_DEPTH)
    held_timed("packed_byte_gather_many_wide", "packed_byte_gather_many", "rf_wide", pt.pack_bins(xw), idx)
    del xw, idx
    # ragged: n, words, G and k off every block size (n·k % 4 != 0),
    # indices at 4·words (the sentinel past the row) and -1, which must
    # read 0; each instance forced, then the routed wrappers
    n_r, w_r, g_r, k_r = 10_007, 37, 3, 5
    pk, ir = ragged_gather_inputs(torch, rng, n_r, w_r, g_r, k_r)
    check_gather_instances(torch, rk, pk, ir, "n·k % 4 != 0")
    check_gather_instances(torch, rk, *ragged_gather_inputs(torch, rng, n_r, w_r, g_r, k_r, idx_offset=1),
                           "idx one entry into its storage")
    check_gather_instances(torch, rk, *ragged_gather_inputs(torch, rng, 4_099, 64, 1, 1), "k = 1, G = 1")
    check_gather_instances(torch, rk, *ragged_gather_inputs(torch, rng, 1_001, 7_300, 2, 7),
                           "7,300 words: past the staged cap")
    check_gather_instances(torch, rk, *ragged_gather_inputs(torch, rng, 2_001, 61, 2, 9, packed_offset=1),
                           "packed one word into its storage")
    r = check_byte_gather(torch, rk, pk, ir, 0, control=True)
    check(bool((rk.packed_byte_gather_many(pk, ir)[(ir < 0) | (ir >= 4 * w_r)] == 0).all()),
          "packed_byte_gather_many: an out-of-range index did not read 0")
    emit({"phase": "kernels", "kernel": "packed_byte_gather_many", "ragged": True, **r})
    emit({"phase": "kernels", "kernel": "packed_byte_gather", "ragged": True,
          **check_byte_gather(torch, rk, pk, ir, 0, single=True)})
    torch.cuda.synchronize()
    return res


def rf_bins(torch, pt, X_rf, seed):
    """The forest paths' (n, 256) uint8 bins of ``X_rf``."""
    edges = torch.from_numpy(pt.make_bin_edges(X_rf.cpu().numpy(), RF_BINS, seed=seed)).to(X_rf.device)
    return pt.binize(X_rf, edges, d_pad=E2E_D)


def wide_bins(torch, pt, n, g, seed):
    """(n, 4,096) uint8 bins of n Gaussian rows of 3,000 features."""
    Xw = torch.randn((n, RF_WIDE_D), generator=g, device=g.device)
    ew = torch.from_numpy(pt.make_bin_edges(Xw[::8].cpu().numpy(), RF_BINS, seed=seed)).to(g.device)
    return pt.binize(Xw, ew, d_pad=pt.next_pow2(RF_WIDE_D))


def phase_rf_kernels(torch, X_rf, y_rf, reps, seed):
    """K5, K6 and K9 at the shapes the forest paths give them, K5 at the
    GBT's deepest split level, and K8/K7 (``phase_byte_gather_kernels``)."""
    from spark_rapids_ml_tpu_torch.ops import rf_kernels as rk
    from spark_rapids_ml_tpu_torch.ops import tree_kernels as pt

    dev = X_rf.device
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 7)
    rng = np.random.default_rng(seed + 7)
    n = X_rf.shape[0]
    bins = rf_bins(torch, pt, X_rf, seed)
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
    wide = wide_bins(torch, pt, n, g, seed)
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
    del xw
    res.update(phase_byte_gather_kernels(torch, bins, wide, reps, seed))
    del wide
    torch.cuda.empty_cache()
    # K5 at the GBT's deepest split level (7 of depth 8): one tree, all 256
    # features, S = 4 logistic stats (w, r, r^2, h) at random margins
    m = torch.randn(n, generator=g, device=dev)
    p = torch.sigmoid(m)
    r = y_rf - p
    logit = torch.stack([torch.ones_like(r), r, r * r, (p * (1 - p)).clamp_min(1e-12)], 1)
    inp = rf_level_inputs(torch, pt, bins, logit, GBT_DEPTH - 1, 1, E2E_D, E2E_D, g, depth=GBT_DEPTH,
                          bootstrap=False)
    res["subblock_hist_gbt"] = check_subblock_hist(torch, rk, inp, reps, exact=False, control=True)
    emit({"phase": "kernels", "kernel": "subblock_hist", "shape": "gbt_level7", **res["subblock_hist_gbt"]})
    del inp
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


def phase_logreg10_subset(torch, X_host, seed, rows):
    """A 10-class LogisticRegression (multinomial: K3's register-row
    multinomial kernel) fitted on the card and on the CPU; labels
    argmax(X W + Gumbel noise) from numpy. Returns the card fit's K3
    launches, counted alone."""
    from spark_rapids_ml_tpu_torch import DataFrame
    from spark_rapids_ml_tpu_torch.classification import LogisticRegression
    from spark_rapids_ml_tpu_torch.ops import logreg_kernels as lk

    rng = np.random.default_rng(seed + 10)
    X = X_host[:rows]
    W = rng.normal(size=(E2E_D, LOGREG_CLASSES)) * 0.2
    y = (X @ W + rng.gumbel(size=(rows, LOGREG_CLASSES))).argmax(axis=1).astype(np.float32)
    df = DataFrame({"features": X, "label": y})
    lk.logreg_loss_grad.launches = 0
    lg, t_card = _timed(torch, lambda: LogisticRegression(maxIter=20, device="cuda:0").fit(df))
    launches = lk.logreg_loss_grad.launches
    t = time.perf_counter()
    lc = LogisticRegression(maxIter=20, device="cpu").fit(df)
    t_cpu = time.perf_counter() - t
    check(lg.coefficientMatrix.shape == (LOGREG_CLASSES, E2E_D) and np.isfinite(lg.coefficientMatrix).all(),
          "10-class LogReg coefficients not finite/shape")
    coef_err = float(np.abs(lg.coefficientMatrix - lc.coefficientMatrix).max()
                     / np.abs(lc.coefficientMatrix).max())
    pg, pc = lg.transform(df).column("prediction"), lc.transform(df).column("prediction")
    agree = float((pg == pc).mean())
    emit({"phase": "subset", "estimator": "LogisticRegression", "classes": LOGREG_CLASSES, "rows": rows,
          "maxIter": 20, "card_fit_s": t_card, "cpu_fit_s": t_cpu, "n_iter_card": lg.n_iter_,
          "n_iter_cpu": lc.n_iter_, "logreg_loss_grad_launches": launches,
          "variant": k3_variant(lk, E2E_D, LOGREG_CLASSES, True),
          "accuracy_card": float((pg == y).mean()), "coef_rel_err": coef_err, "coef_tol": 0.05,
          "prediction_agreement": agree, "agreement_min": LOGREG10_AGREE_MIN})
    check(launches > 0, "the 10-class card fit launched no K3 kernel")
    check(coef_err <= 0.05 and agree >= LOGREG10_AGREE_MIN, "10-class LogReg card vs CPU beyond tolerance")
    return launches


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


RF_WRAPPERS = ("subblock_hist", "subblock_hist_sel", "packed_traverse", "packed_byte_gather_many",
               "packed_byte_gather")


def _rf_counts(rk, zero=False):
    out = {}
    for name in RF_WRAPPERS:
        w = getattr(rk, name)
        out[name] = w.launches
        if zero:
            w.launches = 0
    return out


def regression_label(X, seed):
    """A real-valued label from ``--seed``: a linear part, a bend, noise."""
    rng = np.random.default_rng(seed + 11)
    w = rng.normal(size=8).astype(np.float32)
    return (X[:, :8] @ w + np.sin(X[:, 8]) + 0.3 * rng.normal(size=X.shape[0])).astype(np.float32)


def bins_engine_equal(torch, model, X, packed_out, what):
    """The model's bins engine (K8) on the same rows: every column equal to
    the packed engine's (K9) bit for bit. Returns its seconds."""
    fn = model._get_transform_func(engine="bins")
    out, secs = _timed(torch, lambda: model._apply_batched(fn, X))
    for c in model._out_cols():
        check(np.array_equal(out[c], packed_out.column(c)), f"{what}: bins and packed engines differ in {c}")
    return secs


def phase_rf_e2e(torch, X_host, y_host, seed):
    """The forest paths through ``DataFrame``, each with the launch counters
    zeroed just before it and read just after: bench.py's classifier (fit,
    transform, the bins engine, save/load, transform), the regressor on a
    real-valued label, and the 3,000-feature classifier (fit, transform,
    the bins engine). Returns {kernel: {path: launches}}."""
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
    t_bins = bins_engine_equal(torch, model, X, out, "RandomForestClassifier")
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
          "transform_bins_s": t_bins, "bins_equal_packed": True, "train_accuracy": acc,
          "nodes": model.totalNumNodes, "engine": model._resolve_transform_engine(),
          "fit_report": model._fit_report, "fit_launches": fit_counts, "launches": counts})
    record("rf_classifier", counts, ("subblock_hist", "packed_traverse", "packed_byte_gather_many"))

    # 2. the regressor: a real-valued label from --seed
    yr = regression_label(X, seed)
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
    t_bins = bins_engine_equal(torch, wmodel, Xw, out, "3,000-feature RandomForestClassifier")
    counts = _rf_counts(rk)
    acc_w = float((out.column("prediction") == yw).mean())
    # each node sees 55 of the 3,000 features, about one of the 30 the label
    # depends on: the check is that the forest learned something
    check(acc_w > 0.6, f"3,000-feature RandomForestClassifier training accuracy {acc_w} <= 0.6")
    emit({"phase": "e2e", "estimator": "RandomForestClassifier", "numTrees": RF_SMALL_TREES, "maxDepth": RF_DEPTH,
          "maxBins": RF_BINS, "rows": n, "d": RF_WIDE_D, "fit_s": t_fit, "transform_s": t_tr,
          "transform_bins_s": t_bins, "bins_equal_packed": True, "train_accuracy": acc_w,
          "peak_device_gb": peak / 1e9, "fit_report": wmodel._fit_report, "launches": counts})
    record("rf_wide", counts, ("subblock_hist_sel", "packed_traverse", "packed_byte_gather_many"))
    return by_path


def phase_gbt_e2e(torch, X_host, y_host, seed):
    """bench.py's gbt config through ``DataFrame``, each estimator with the
    launch counters zeroed just before it and read just after:
    GBTClassifier (fit, transform through the packed engine, the bins
    engine, save/load, transform) on the rf rows and labels, and
    GBTRegressor (fit, both engines) on the regressor's real-valued label.
    Returns {kernel: {path: launches}}."""
    import tempfile

    from spark_rapids_ml_tpu_torch import DataFrame, GBTClassifier, GBTRegressor
    from spark_rapids_ml_tpu_torch.classification import GBTClassificationModel
    from spark_rapids_ml_tpu_torch.ops import rf_kernels as rk

    X, y = X_host[:RF_ROWS], y_host[:RF_ROWS]
    n = X.shape[0]
    feats = DataFrame({"features": X})
    by_path = {name: {} for name in RF_WRAPPERS}
    needed = ("subblock_hist", "packed_traverse", "packed_byte_gather_many")
    kw = dict(maxIter=GBT_ROUNDS, maxDepth=GBT_DEPTH, maxBins=RF_BINS, seed=seed)

    def run(path, est, label, extra):
        _rf_counts(rk, zero=True)
        model, t_fit = _timed(torch, lambda: est.fit(DataFrame({"features": X, "label": label})))
        fit_counts = _rf_counts(rk)
        out, t_tr = _timed(torch, lambda: model.transform(feats))
        t_bins = bins_engine_equal(torch, model, X, out, type(est).__name__)
        res, checks = extra(model, out)
        counts = _rf_counts(rk)
        for name, c in counts.items():
            by_path[name][path] = c
        emit({"phase": "e2e", "estimator": type(est).__name__, "maxIter": GBT_ROUNDS, "maxDepth": GBT_DEPTH,
              "maxBins": RF_BINS, "rows": n, "d": X.shape[1], "fit_s": t_fit, "transform_s": t_tr,
              "transform_rows_per_s": n / t_tr, "transform_bins_s": t_bins, "bins_equal_packed": True,
              "engine": model._resolve_transform_engine(), "k1_k2": [model._ensure_packed().k1,
                                                                    model._ensure_packed().k2],
              "trees": model.getNumTrees(), "nodes": model.totalNumNodes, "fit_report": model._fit_report,
              "fit_launches": fit_counts, "launches": counts, **res})
        for cond, msg in checks:
            check(cond, msg)
        for name in needed:
            check(counts[name] > 0, f"kernel {name} was not launched on the {path} path")

    def classifier_checks(model, out):
        pred, prob = out.column("prediction"), out.column("probability")
        with tempfile.TemporaryDirectory() as tmp:
            _, t_save = _timed(torch, lambda: model.write().overwrite().save(tmp + "/gbt"))
            loaded, t_load = _timed(torch, lambda: GBTClassificationModel.load(tmp + "/gbt"))
        out2, t_tr2 = _timed(torch, lambda: loaded.transform(feats))
        acc = float((pred == y).mean())
        checks = [(np.array_equal(out.column(c), out2.column(c)), f"GBTClassifier save/load changed {c}")
                  for c in model._out_cols()]
        checks += [
            (pred.shape == (n,) and np.isfinite(prob).all() and bool((np.abs(prob.sum(1) - 1) < 1e-5).all()),
             "GBTClassifier transform shape, finiteness or probabilities"),
            (acc > GBT_ACC_MIN, f"GBTClassifier training accuracy {acc} <= {GBT_ACC_MIN}"),
        ]
        return {"train_accuracy": acc, "save_s": t_save, "load_s": t_load, "transform_after_load_s": t_tr2}, checks

    yr = regression_label(X, seed)

    def regressor_checks(model, out):
        pr = out.column("prediction")
        r2 = float(1.0 - ((pr - yr) ** 2).mean() / yr.var())
        return {"train_r2": r2}, [(np.isfinite(pr).all() and r2 > 0.5, f"GBTRegressor training R^2 {r2} <= 0.5")]

    run("gbt_classifier", GBTClassifier(**kw), y, classifier_checks)
    run("gbt_regressor", GBTRegressor(**kw), yr, regressor_checks)
    return by_path


def phase_gbt_subset(torch, X_host, y_host, seed, rows):
    """The same GBT fitted on the card and on the CPU (plain versions):
    no draws, and K5 adds in row order as the CPU does, but the gradient
    stats are real valued, so the card's other rounding (sigmoid, per-node
    sums) may move a near-tied split. Counts the differing nodes and the
    largest margin difference, and holds the predictions to GBT_AGREE_MIN
    agreement."""
    from spark_rapids_ml_tpu_torch import DataFrame, GBTClassifier
    from spark_rapids_ml_tpu_torch.ops import rf_kernels as rk

    df = DataFrame({"features": X_host[:rows], "label": y_host[:rows]})
    _rf_counts(rk, zero=True)
    fits, secs, outs = {}, {}, {}
    for dev in ("cuda:0", "cpu"):
        est = GBTClassifier(maxIter=GBT_SUBSET_ROUNDS, maxDepth=GBT_DEPTH, maxBins=RF_BINS, seed=seed, device=dev)
        fits[dev], secs[dev] = _timed(torch, lambda: est.fit(df))
        outs[dev] = fits[dev].transform(df)
    counts = _rf_counts(rk)
    a, b = fits["cuda:0"]._model_attributes, fits["cpu"]._model_attributes
    differ = int(((a["features"] != b["features"]) | (a["threshold_bins"] != b["threshold_bins"])).sum())
    margin_diff = float(np.abs(outs["cuda:0"].column("rawPrediction")[:, 1]
                               - outs["cpu"].column("rawPrediction")[:, 1]).max())
    agree = float((outs["cuda:0"].column("prediction") == outs["cpu"].column("prediction")).mean())
    emit({"phase": "subset", "estimator": "GBTClassifier", "rows": rows, "maxIter": GBT_SUBSET_ROUNDS,
          "maxDepth": GBT_DEPTH, "nodes_differ": differ, "max_margin_diff": margin_diff,
          "leaf_values_max_diff": float(np.abs(a["leaf_values"] - b["leaf_values"]).max()),
          "prediction_agreement": agree, "agreement_min": GBT_AGREE_MIN, "fit_s_card": secs["cuda:0"],
          "fit_s_cpu": secs["cpu"], "fit_report_card": fits["cuda:0"]._fit_report, "launches": counts})
    check(agree >= GBT_AGREE_MIN, f"GBT card vs CPU predictions agree on {agree} < {GBT_AGREE_MIN}")
    for name in ("subblock_hist", "packed_traverse"):
        check(counts[name] > 0, f"kernel {name} was not launched on the GBT card-vs-CPU path")
    return counts


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


def host_parts(torch, rk, packed, idx, calls=2000):
    """Host µs per call of each step of a wrapper's host path, alone."""
    dev = idx.device
    steps = {
        "current_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "check_cuda": lambda: rk._check_cuda("k", (packed, torch.int32), (idx, torch.int32)),
        "empty_like": lambda: torch.empty_like(idx),
        "empty": lambda: torch.empty(idx.shape, dtype=torch.int32, device=dev),
        "data_ptr_x2": lambda: (packed.data_ptr(), idx.data_ptr()),
        "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(dev.index),
    }
    if hasattr(rk, "gather_geometry"):  # the routed package (see check_byte_gather)
        # the ctypes call alone: a plan of 0 rows returns at once
        launch = rk._build.function("rf_byte_gather", "packed_byte_gather_launch", [ctypes.c_void_p] * 5)
        plan, at = rk._gather_plan(0, 1, 1, 1, rk.GatherGeometry("direct_vec", 4, 0, 1, 0))
        steps["ctypes_call"] = lambda: launch(packed.data_ptr(), idx.data_ptr(), idx.data_ptr(), at, 0)
        steps["route_lookup"] = lambda: rk.gather_geometry(packed, idx)
    out = {}
    for name, step in steps.items():
        step()
        t = time.perf_counter()
        for _ in range(calls):
            step()
        out[name] = (time.perf_counter() - t) * 1e6 / calls
    torch.cuda.synchronize()
    return out


def gather_probe(torch, args, dev) -> int:
    """``--gather-only``: K7/K8's kernel phase alone, on 131,072 rows made
    from ``--seed`` (binned as the forest phase bins them) and 131,072
    3,000-feature rows, and the host cost of the wrapper's steps."""
    from spark_rapids_ml_tpu_torch.ops import rf_kernels as rk
    from spark_rapids_ml_tpu_torch.ops import tree_kernels as pt

    X, _ = make_data(torch, RF_ROWS, RF_ROWS, args.seed, dev)
    bins = rf_bins(torch, pt, X, args.seed)
    del X
    g = torch.Generator(device=dev)
    g.manual_seed(args.seed + 7)
    res = phase_byte_gather_kernels(torch, bins, wide_bins(torch, pt, RF_ROWS, g, args.seed), args.reps, args.seed,
                                    sweep=args.sweep)
    packed = pt.pack_bins(bins)
    idx = torch.zeros((8, RF_ROWS, 1), dtype=torch.int32, device=dev)
    emit({"probe": "byte_gather", "package": rk.__file__, "host_parts_us": host_parts(torch, rk, packed, idx),
          "shapes": {k: {m: v for m, v in r.items() if m != "controls"} for k, r in res.items()}})
    return 0


def knn_attributes(torch, kn) -> dict:
    """K4's registers, spill bytes a thread, resident blocks an SM and
    shared memory a block (the CUDA occupancy calculator), at the kNN,
    UMAP and k = 100 shapes."""
    out = {}
    for name, (nq, ni, k) in {"knn": (KNN_QUERIES, KNN_ITEMS, KNN_K), "join": (KNN_JOIN_QUERIES, KNN_ITEMS, KNN_K),
                              "umap_transform": (UMAP_ROWS, UMAP_ROWS, UMAP_NEIGHBORS),
                              "k100": (1037, 70_001, 100)}.items():
        g = kn.knn_geometry(nq, ni, E2E_D, k)
        a = kn._knn_attributes(g.bm, k, g.stages)
        out[name] = {"registers": a[0], "local_bytes": a[1], "blocks_per_sm": a[2], "smem": a[3]}
    return out


def sass_counts(name, mnemonics):
    """How many instructions of each mnemonic prefix the SASS of kernel
    library ``name`` holds (``cuobjdump`` beside ``nvcc``)."""
    import os
    import re

    from spark_rapids_ml_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(_build.library_path(name))], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    return {m: len(re.findall(r"\b" + re.escape(m), sass)) for m in mnemonics}


def sweep_knn(torch, kn, X):
    """K4 at the kNN and join shapes under other geometries (stage depth,
    item splits), and with a tight state (every row's k-th
    pair at -inf, so that no tile passes the gate and nothing is inserted:
    the product and the gate alone). Each variant's ids are compared with
    the routed geometry's."""
    dev = X.device
    out = []
    for name, nq in (("knn", KNN_QUERIES), ("join", KNN_JOIN_QUERIES)):
        Xq, ni, k = X[:nq], X.shape[0], KNN_K
        csq = (X * X).sum(dim=1)
        ids = torch.arange(ni, dtype=torch.int32, device=dev)
        st = (torch.full((nq, k), float("inf"), device=dev), torch.full((nq, k), -1, dtype=torch.int32, device=dev))
        base = kn.knn_geometry(nq, ni, E2E_D, k)
        ref_ids = kn._knn_topk_run(Xq, X, csq, ids, *st, base)[1]
        tight = (torch.full((nq, k), -float("inf"), device=dev), st[1])
        out.append({"shape": name, **base._asdict(), "tight_state": True,
                    "ms": cuda_ms(torch, lambda: kn._knn_topk_run(Xq, X, csq, ids, *tight, base), 1)})
        variants = [base._replace(stages=st_) for st_ in kn._STAGES if st_ != base.stages]
        if name == "join":
            variants += [kn._knn_geometry(nq, ni, E2E_D, k, splits=sp) for sp in (1, 2, 4, 16, 32)]
        for geo in variants:
            geo = geo._replace(smem=kn._knn_smem(geo.bm, geo.stages, k))
            if geo.smem > kn.SMEM_PER_BLOCK:
                continue
            topi = kn._knn_topk_run(Xq, X, csq, ids, *st, geo)[1]
            same = float((topi.sort(dim=1).values == ref_ids.sort(dim=1).values).all(dim=1).float().mean())
            out.append({"shape": name, **geo._asdict(), "rows_same_ids": same,
                        "ms": cuda_ms(torch, lambda: kn._knn_topk_run(Xq, X, csq, ids, *st, geo), 1)})
            emit({"probe": "knn_sweep", **out[-1]})
        del ref_ids
    return out


def knn_probe(torch, args, dev) -> int:
    """``--knn-only``: K4's kernel phase alone (all four shapes, ragged
    shapes and controls) on 1M rows made from ``--seed``, with the kernel's
    attributes and its gates' verdicts (reported, not enforced: the probe
    also measures older kernels); ``--sweep`` adds other geometries."""
    from spark_rapids_ml_tpu_torch.ops import knn_kernels as kn

    X, _ = make_data(torch, KNN_ITEMS, KNN_ITEMS, args.seed, dev)
    attrs = knn_attributes(torch, kn)
    # the products' instructions: tensor-core TF32 (wgmma or mma.sync), or FP32 FMA
    sass = sass_counts("knn_topk", ("HGMMA.64x128x8.F32.TF32", "HMMA", "FFMA", "UTMALDG"))
    emit({"probe": "knn_topk", "attributes": attrs, "sass": sass})
    res = phase_knn_kernels(torch, X, make_umap_data(UMAP_ROWS, args.seed), args.reps, args.seed)
    out = {"probe": "knn_topk", "package": kn.__file__, "attributes": attrs, "sass": sass, "gates": knn_gates(res),
           "shapes": {k: {m: v for m, v in r.items() if m != "controls"} for k, r in res.items()}}
    if args.sweep:
        out["sweep"] = sweep_knn(torch, kn, X)
    emit(out)
    return 0


def sweep_lloyd(torch, kk, X, seed, reps):
    """K2 at k = 1024 and k = 4,097 with every row weight 1 and with every
    row weight 0 (an m = 0 row adds nothing to the sums or counts, so the
    second call times the product, the argmin and the row walk without the
    atomics), and at the other stage depths. Each depth's counts are
    compared with the routed launch's."""
    dev = X.device
    n = X.shape[0]
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 5)
    ones, zeros = torch.ones(n, device=dev), torch.zeros(n, device=dev)
    out = []
    for k in (E2E_CENTRES, 4097):
        C = X[torch.randint(0, n, (k,), generator=g, device=dev)].contiguous()
        base = kk.lloyd_geometry(n, k, E2E_D)
        row = {"k": k, **base._asdict(), "ms": cuda_ms(torch, lambda: kk.lloyd_step(X, ones, C), reps),
               "m0_ms": cuda_ms(torch, lambda: kk.lloyd_step(X, zeros, C), reps)}
        row["atomics_share"] = 1.0 - row["m0_ms"] / row["ms"]
        out.append(row)
        emit({"probe": "lloyd_sweep", **row})
        ref = kk.lloyd_step(X, ones, C)[1]
        for stages in kk._STAGES:
            if stages == base.stages:
                continue
            geo = kk._lloyd_geometry(n, k, E2E_D, sms=base.grid, stages=stages)
            same = bool(torch.equal(kk._lloyd_run(X, ones, C, geo)[1], ref))
            out.append({"k": k, **geo._asdict(), "counts_equal_routed": same,
                        "ms": cuda_ms(torch, lambda: kk._lloyd_run(X, ones, C, geo), reps)})
            emit({"probe": "lloyd_sweep", **out[-1]})
    return out


def lloyd_attributes(torch, kk) -> dict:
    """K2's registers, spill bytes a thread, resident blocks an SM and
    shared memory a block (the CUDA occupancy calculator) at each stage
    depth, and its launch at the main path's two shapes."""
    out = {f"stages_{s}": dict(zip(("registers", "local_bytes", "blocks_per_sm", "smem"), kk._lloyd_attributes(s)))
           for s in kk._STAGES}
    for k in (E2E_CENTRES, 4097):
        out[f"geometry_k{k}"] = kk.lloyd_geometry(12_000_000, k, E2E_D)._asdict()
    return out


def kmeans_probe(torch, args, dev) -> int:
    """``--kmeans-only``: K2's kernel phase alone (k = 1024 and 4,097 with
    their controls, the ragged shapes) on ``--rows`` rows made from
    ``--seed``, with the kernel's attributes, SASS instruction counts and
    its gates' verdicts (reported, not enforced); ``--sweep`` adds the m =
    0 split and the other stage depths."""
    from spark_rapids_ml_tpu_torch.ops import kmeans_kernels as kk

    X, _ = make_data(torch, args.rows, args.rows, args.seed, dev)
    attrs = lloyd_attributes(torch, kk)
    # the products' instructions (tensor-core TF32, or FP32 FMA), the tensor
    # copies, the accumulation's atomics, and local (spill) stores and loads
    sass = sass_counts("lloyd_step", ("HGMMA.64x128x8.F32.TF32", "FFMA", "UTMALDG", "RED", "ATOM", "STL", "LDL"))
    emit({"probe": "lloyd_step", "attributes": attrs, "sass": sass})
    res = phase_lloyd_kernels(torch, X, args.reps, args.seed)
    out = {"probe": "lloyd_step", "package": kk.__file__, "attributes": attrs, "sass": sass,
           "gates": lloyd_gates(res),
           "ms_max": LLOYD_MS_MAX,
           "shapes": {k: {m: v for m, v in r.items() if m != "controls"} for k, r in res.items()}}
    if args.sweep:
        out["sweep"] = sweep_lloyd(torch, kk, X, args.seed, args.reps)
    emit(out)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=12_000_000, help="end-to-end rows (N x 256 f32)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=3, help="timed calls per kernel measurement")
    ap.add_argument("--subset", type=int, default=100_000, help="rows of the card-vs-CPU fits")
    ap.add_argument("--gather-only", action="store_true",
                    help="a probe: build K7/K8 alone and run only their kernel phase (prints no result line)")
    ap.add_argument("--knn-only", action="store_true",
                    help="a probe: build K4 alone and run only its kernel phase (prints no result line)")
    ap.add_argument("--kmeans-only", action="store_true",
                    help="a probe: build K2 alone and run only its kernel phase (prints no result line)")
    ap.add_argument("--sweep", action="store_true",
                    help="with --gather-only: time chunk sizes and grids too; with --knn-only: other "
                         "geometries; with --kmeans-only: the m = 0 split and stage depths")
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
    build_s = _build.build(["rf_byte_gather"] if args.gather_only else ["knn_topk"] if args.knn_only
                           else ["lloyd_step"] if args.kmeans_only else _build.SOURCES)
    build_total = time.perf_counter() - t
    ptxas = {
        name: [ln.strip() for ln in (_build.BUILD_DIR / f"{name}.log").read_text().splitlines()
               if "registers" in ln or "spill" in ln]
        for name in _build.SOURCES if (_build.BUILD_DIR / f"{name}.log").exists()
    }
    emit({"phase": "card", "nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda, "build_s": build_s,
          "build_total_s": build_total, "ptxas": ptxas})

    if args.gather_only:
        return gather_probe(torch, args, dev)
    if args.knn_only:
        return knn_probe(torch, args, dev)
    if args.kmeans_only:
        return kmeans_probe(torch, args, dev)

    # the PCA fit pads rows to its chunk multiple: the kernels see that shape
    from spark_rapids_ml_tpu_torch.feature import PCA

    n = args.rows
    csize = PCA._equal_chunk_rows(n, 1, 65_536)
    n_pca = -(-n // csize) * csize
    X, y = make_data(torch, n, n_pca, args.seed, dev)
    kern = phase_kernels(torch, X, n, args.reps, args.seed)
    kern.update(phase_lloyd_kernels(torch, X[:n], args.reps, args.seed))
    gates = lloyd_gates(kern)
    emit({"phase": "kernels", "kernel": "lloyd_step", "gates": gates, "ms_max": LLOYD_MS_MAX})
    for name, ok in gates.items():
        check(ok, f"K2 gate {name} failed: " + json.dumps(
            {k: {m: kern[k][m] for m in ("ms", "plain_ms", "library_ms")} for k in ("lloyd_step", "lloyd_step_4097")}))
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
    by_path["logreg_loss_grad"]["logreg10_card_vs_cpu"] = phase_logreg10_subset(
        torch, X_host, args.seed, min(args.subset, n))
    by_path["knn_topk"] = {"knn": phase_knn_e2e(torch, X_host[:ni])}
    umap_launches = phase_umap_e2e(torch, X_umap, args.seed)
    by_path["knn_topk"]["umap"] = umap_launches["knn_topk"]
    by_path["sgd_epoch_rows"] = {"umap": umap_launches["sgd_epoch_rows"]}
    phase_umap_subset(torch, X_umap, args.seed, UMAP_SUBSET)
    rf_paths = phase_rf_e2e(torch, X_host, y_host, args.seed)
    phase_rf_profile(torch, X_host, y_host, args.seed)
    rf_subset = phase_rf_subset(torch, X_host, y_host, args.seed, min(RF_SUBSET_ROWS, n))
    gbt_paths = phase_gbt_e2e(torch, X_host, y_host, args.seed)
    gbt_subset = phase_gbt_subset(torch, X_host, y_host, args.seed, min(RF_SUBSET_ROWS, n))
    for name in RF_WRAPPERS:
        by_path[name] = {path: c for paths in (rf_paths[name], gbt_paths[name]) for path, c in paths.items() if c}
        for path, sub in (("rf_card_vs_cpu", rf_subset), ("gbt_card_vs_cpu", gbt_subset)):
            if sub[name]:
                by_path[name][path] = sub[name]

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
        "packed_byte_gather_many": ("spark_rapids_ml_tpu/ops/rf_pallas.py:727", "packed_byte_gather_many",
                                    "rf_byte_gather"),
        # no caller in either package: its held measurement, no launches
        "packed_byte_gather": ("spark_rapids_ml_tpu/ops/rf_pallas.py:507", "packed_byte_gather", "rf_byte_gather"),
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
            # K2, K4: the FP32 bound beside bound_ms, the 3xTF32 tensor-core one
            **{k: r[k] for k in ("bound_f32_ms",) if k in r},
            # K7/K8: device time and host cost apart, and the routed instance
            **{k: r[k] for k in ("device_ms", "library_device_ms", "host_us", "variant") if k in r and name in (
                "packed_byte_gather_many", "packed_byte_gather")},
            "shape": {k: r[k] for k in ("n", "d", "k", "K", "nq", "ni", "R", "C", "neg", "n_tab", "T", "level",
                                        "n_pad", "r_sub", "S", "nb", "k_pad", "d_pad", "rows", "trees", "t_pad",
                                        "k1", "k2", "words", "G", "variant", "BM", "stages", "slab", "blocks")
                      if k in r},
        }
        kernels.append(entry)
    extra = {"lloyd_step_k4097": kern["lloyd_step_4097"], "logreg_loss_grad_K10": kern["logreg_loss_grad_10"],
             "knn_topk_join": kern["knn_topk_join"], "knn_topk_umap_graph": kern["knn_topk_umap_graph"],
             "knn_topk_umap_transform": kern["knn_topk_umap_transform"],
             "sgd_epoch_rows_umap_transform": kern["sgd_epoch_rows_transform"],
             "subblock_hist_level2": kern["subblock_hist_level2"],
             "subblock_hist_variance": kern["subblock_hist_variance"],
             "subblock_hist_gbt_level7": kern["subblock_hist_gbt"],
             "packed_byte_gather_many_gbt": kern["packed_byte_gather_many_gbt"],
             "packed_byte_gather_many_wide": kern["packed_byte_gather_many_wide"]}
    emit({"phase": "done", "total_s": time.perf_counter() - t_start, "extra_shapes": extra})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
