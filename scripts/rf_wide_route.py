#!/usr/bin/env python3
"""Time the forest builder's wide histogram route on one CUDA card.

    python3 scripts/rf_wide_route.py [--tree DIR] [--seed 0] [--reps 5] [--fit-rows 1000000]

The wide route is ``_hist_compact_batched`` with ``full_bins``: a level
of a forest on 3,000 features (d_pad 4,096, 55 of them a node, 64 slots
with the sentinels, 128 bins, two one-hot classes times Poisson(1)
bootstrap weights, 8 trees). ``--tree`` names the checkout of the port to
import (default: the one this script lies in), so that two checkouts can
be timed in one call, each in its own process. At the level shapes
131,072 rows x levels 12 and 2 and 1,000,000 rows x level 12, the script
times with CUDA events (mean of ``--reps`` after a warm-up):

- the whole route (layout, weights, histograms);
- its stages, by what the checkout has: the ``index_select`` of the
  node-sorted full rows, the per-sub-block kernel on them, and the
  per-node ``_segment_sum`` of its partials (a checkout with
  ``subblock_hist_sel_batched``); or the per-node kernel alone (a
  checkout with ``node_hist_sel_batched``);
- route B, what the builder runs at d_pad <= 1,024: the per-row subset
  gather, then the per-node kernel over the gathered bins, each alone and
  together;

and then fits RandomForestClassifier(numTrees=8, maxDepth=13,
maxBins=128) on ``--fit-rows`` x 3,000 Gaussian rows (fit s, the fit
report's stages, peak device memory; an out-of-memory fit is reported as
such). Each result is one JSON line, beside the card's name and power
limit. Exits 1 without a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

D, D_PAD, K, NB, DEPTH, T = 3000, 4096, 55, 128, 13, 8
SHAPES = ((131_072, 12), (131_072, 2), (1_000_000, 12))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def wide_bins(torch, pt, n, g):
    """(n, 4,096) uint8 bins of n Gaussian rows of 3,000 features, edges
    from every 64th row, made a block of rows at a time."""
    dev = g.device
    edges = torch.from_numpy(pt.make_bin_edges(torch.randn((n // 64, D), generator=g, device=dev).cpu().numpy(),
                                               NB)).to(dev)
    out = torch.empty((n, D_PAD), dtype=torch.uint8, device=dev)
    for r0 in range(0, n, 1 << 17):
        x = torch.randn((min(1 << 17, n - r0), D), generator=g, device=dev)
        out[r0:r0 + x.shape[0]] = pt.binize(x, edges, d_pad=D_PAD)
    return out


def level(torch, pt, rk, bins, lvl, g, reps):
    """One level's timings (ms) on ``bins``."""
    n, dev = bins.shape[0], bins.device
    n_nodes, k_pad, S = 1 << lvl, pt.next_pow2(K), 2
    r_sub, n_pad, _ = pt.compact_sizes(n, lvl, DEPTH, S, k_pad, NB)
    seg = torch.randint(0, n_nodes, (T, n), generator=g, device=dev)
    y = torch.randint(0, 2, (n,), generator=g, device=dev)
    w = torch.poisson(torch.ones((T, n), device=dev), generator=g)
    sw = torch.nn.functional.one_hot(y, 2).float()[None] * w[..., None]
    feats = torch.rand((T, n_nodes, D), generator=g, device=dev).argsort(dim=2)[..., :K]
    feats = torch.cat([feats, torch.full((T, n_nodes, k_pad - K), D, device=dev)], 2)
    kw = dict(n_nodes=n_nodes, nb=NB, r_sub=r_sub, n_pad=n_pad)
    row = {"rows": n, "level": lvl, "T": T, "n_pad": n_pad, "r_sub": r_sub, "n_nodes": n_nodes, "k_pad": k_pad}
    row["route_ms"] = cuda_ms(torch, lambda: pt._hist_compact_batched(None, seg, sw, full_bins=bins, feats=feats,
                                                                      **kw), reps)
    src2, pvalid, sbc, counts, pstart = pt._compact_layout(seg, n_nodes, r_sub, n_pad)
    swq = (sw.gather(1, src2[..., None].expand(T, n_pad, S)) * pvalid[..., None]).contiguous()
    row["layout_ms"] = cuda_ms(torch, lambda: pt._compact_layout(seg, n_nodes, r_sub, n_pad), reps)
    if hasattr(rk, "subblock_hist_sel_batched"):
        n_sb = n_pad // r_sub
        rows = lambda: bins.index_select(0, src2.reshape(-1)).reshape(T, n_pad, D_PAD)  # noqa: E731
        row["index_select_ms"] = cuda_ms(torch, rows, reps)
        featsq = feats.gather(1, sbc[..., None].expand(T, n_sb, k_pad)).to(torch.int32).contiguous()
        bq = rows()
        sel = lambda: rk.subblock_hist_sel_batched(bq, featsq, swq, n_bins=NB, r_sub=r_sub)  # noqa: E731
        row["subblock_kernel_ms"] = cuda_ms(torch, sel, reps)
        parts = sel().reshape(T * n_sb, -1)
        del bq
        sb_node = torch.repeat_interleave(torch.arange(T * (n_nodes + 1), device=dev), counts.reshape(-1))
        row["segment_sum_ms"] = cuda_ms(
            torch, lambda: pt._segment_sum(parts, sb_node, T * (n_nodes + 1), grouped=True), reps)
        del parts
    if hasattr(rk, "node_hist_sel_batched"):
        f32 = feats.to(torch.int32)
        row["node_kernel_ms"] = cuda_ms(
            torch, lambda: rk.node_hist_sel_batched(bins, src2, swq, pstart, f32, n_bins=NB, r_sub=r_sub), reps)
    # route B: each row's node's columns gathered, then the per-node kernel
    lc = seg.clamp(max=n_nodes - 1)

    def subset():
        row_feats = feats.gather(1, lc[..., None].expand(T, n, k_pad))
        return bins.expand(T, n, D_PAD).gather(2, row_feats.clamp(0, D_PAD - 1))

    row["route_b_gather_ms"] = cuda_ms(torch, subset, reps)
    hist_src = subset()
    row["route_b_node_hist_ms"] = cuda_ms(
        torch, lambda: rk.node_hist_batched(hist_src, src2, swq, pstart, n_bins=NB, r_sub=r_sub), reps)
    row["route_b_ms"] = cuda_ms(torch, lambda: pt._hist_compact_batched(subset(), seg, sw, **kw), reps)
    return row


def fit(torch, rows, seed):
    """The 8-tree 3,000-wide classifier on ``rows`` Gaussian rows (labels:
    the sign of 30 columns' sum), as chip_smoke.py's rf_wide path."""
    from spark_rapids_ml_tpu_torch import DataFrame, RandomForestClassifier

    g = torch.Generator(device="cuda:0")
    g.manual_seed(seed + 13)
    Xw = torch.randn((rows, D), generator=g, device="cuda:0")
    cols = torch.randperm(D, generator=g, device="cuda:0")[:30]
    yw = (Xw[:, cols].sum(dim=1) > 0).float().cpu().numpy()
    Xw = Xw.cpu().numpy()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    est = RandomForestClassifier(numTrees=T, maxDepth=DEPTH, maxBins=NB, seed=seed)
    out = {"check": "rf_wide_fit", "rows": rows, "d": D, "numTrees": T, "maxDepth": DEPTH, "maxBins": NB}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        model = est.fit(DataFrame({"features": Xw, "label": yw}))
        torch.cuda.synchronize()
        out.update({"fit_s": time.perf_counter() - t0, "fit_report": model._fit_report})
    except torch.cuda.OutOfMemoryError as e:
        out.update({"out_of_memory_after_s": time.perf_counter() - t0, "error": str(e).splitlines()[0]})
    out["peak_device_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parent.parent),
                    help="checkout of the port to time")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--fit-rows", type=int, default=1_000_000, help="rows of the fit (0: no fit)")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("rf_wide_route: CUDA is not available; nothing was run", file=sys.stderr)
        return 1
    from spark_rapids_ml_tpu_torch.ops import rf_kernels as rk
    from spark_rapids_ml_tpu_torch.ops import tree_kernels as pt

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    emit({"tree": str(Path(rk.__file__).resolve().parent.parent), "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0)})
    g = torch.Generator(device="cuda:0")
    g.manual_seed(args.seed + 17)
    bins = None
    for n, lvl in SHAPES:
        if bins is None or bins.shape[0] != n:
            bins = None
            torch.cuda.empty_cache()
            bins = wide_bins(torch, pt, n, g)
        emit({"check": "wide_route", **level(torch, pt, rk, bins, lvl, g, args.reps)})
        torch.cuda.empty_cache()
    del bins
    torch.cuda.empty_cache()
    if args.fit_rows:
        emit(fit(torch, args.fit_rows, args.seed))
    return 0


if __name__ == "__main__":
    sys.exit(main())
