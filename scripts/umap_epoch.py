#!/usr/bin/env python3
"""Time the UMAP SGD epoch (kernel K10 and the operations around it) on one
CUDA card.

    python3 scripts/umap_epoch.py [--tree DIR] [--seed 0] [--reps 50] [--epochs 20]

``--tree`` names the checkout of the port to import (default: the one this
script lies in), so that two checkouts can be timed in one call, each in
its own process. The inputs are those of ``chip_smoke.py``'s K10 checks:
the CSR rows (K = 24) of the exact 15-neighbour graph of its 65,536 x 256
UMAP rows, a random (65,536, 2) table, neg = 5 (the fit shape), and 65,536
rows of K = 15 against the frozen table (the transform shape). It prints,
one JSON line each, beside the card's name and power limit:

- K10's per-row sums (``sgd_epoch_rows``, streamed uniforms) at both
  shapes, device time (the calls queued behind a device wait, so that the
  events around them time the device alone), mean of ``--reps`` after a
  warm-up; with a
  checkout that has the STEP epilogue (``sgd_epoch_step``), that too, with
  the slot draws made in the kernel and with streamed uniforms;
- one fit epoch split into its operations: each operation's device time
  (the epochs queued behind a device wait, so that the events between the
  operations time the device alone), its host time (the enqueue, by the
  host clock), and the epoch's wall time with nothing queued ahead (host
  clock to a ``synchronize``), mean over ``--epochs`` epochs after two;
- ``umap_sgd`` whole at both shapes (200 fit epochs, 66 transform epochs):
  host clock to a ``synchronize``, per epoch.

Exits 1 without a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

UMAP_ROWS, NEIGHBORS, K_FIT, NEG = 65_536, 15, 24, 5
FIT_EPOCHS, TRANSFORM_EPOCHS = 200, 66
SLEEP_CYCLES = 60_000_000  # the device wait ahead of the timed calls: ~30 ms at 1.98 GHz


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def device_ms(torch, fn, reps: int) -> float:
    """Device ms a call of ``fn``: ``reps`` calls queued behind a device
    wait, so that the events around them time the device alone (a call's
    host time can exceed its kernel's); fails if the enqueue outlasted the
    wait."""
    fn()
    torch.cuda.synchronize()
    e0, e1, e2 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    e0.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    e1.record()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    enqueue_ms = (time.perf_counter() - t) * 1e3
    e2.record()
    e2.synchronize()
    if enqueue_ms >= e0.elapsed_time(e1):
        raise SystemExit(f"umap_epoch: {reps} calls took {enqueue_ms:.3f} ms to enqueue, longer than the wait")
    return e1.elapsed_time(e2) / reps


def inputs(torch, uk, seed: int):
    """The fit and transform shapes' tensors, made as ``chip_smoke.py``'s
    K10 checks make them (the same generator, in the same order)."""
    import chip_smoke
    from spark_rapids_ml_tpu_torch.models.umap import drop_self_column, knn_brute

    dev = torch.device("cuda:0")
    X = chip_smoke.make_umap_data(UMAP_ROWS, seed)
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 3)
    Xd = torch.from_numpy(X).to(dev)
    dists, idx = drop_self_column(*knn_brute(Xd, Xd, k=NEIGHBORS + 1), k=NEIGHBORS)
    heads, tails, weights = uk.fuzzy_simplicial_set(idx.cpu().numpy(), dists, 1.0, 1.0, device=dev)
    row_heads, tails_pad, p_pad = uk.build_row_adjacency(heads, tails, weights, UMAP_ROWS, K=K_FIT)
    del Xd, dists
    a, b = uk.find_ab_params(1.0, 0.1)
    src = torch.rand((UMAP_ROWS, 2), generator=g, device=dev) * 20.0 - 10.0
    tails_d, p_d = torch.from_numpy(tails_pad).to(dev), torch.from_numpy(p_pad).to(dev)
    R, K = tails_pad.shape
    heads_d = torch.from_numpy(row_heads).to(dev)
    u = torch.rand((R, K), generator=g, device=dev)
    perm = torch.randperm(UMAP_ROWS, generator=g, device=dev, dtype=torch.int32)
    offs = torch.randint(0, R, (NEG,), generator=g, device=dev, dtype=torch.int32)
    fit = dict(src=src, heads=heads_d, tails=tails_d, p=p_d, u=u, perm=perm, offs=offs, scale=2.0)
    tails_tr = idx.contiguous()
    shp = tails_tr.shape
    offs_tr = torch.randint(0, shp[0], (NEG,), generator=g, device=dev, dtype=torch.int32)
    p_tr = torch.rand(shp, generator=g, device=dev)
    u_tr = torch.rand(shp, generator=g, device=dev)
    transform = dict(src=src, h=src + 0.5, heads=torch.arange(shp[0], device=dev), tails=tails_tr, p=p_tr,
                     u=u_tr, perm=perm, offs=offs_tr, scale=1.0)
    fit["h"] = src[heads_d.long()]
    return a, b, g, {"fit": fit, "transform": transform}


def kernel_times(torch, uk, a, b, shapes, reps):
    for name, s in shapes.items():
        R, K = s["tails"].shape
        line = {"check": "k10", "shape": name, "R": R, "K": K, "C": s["src"].shape[1], "neg": s["offs"].shape[0],
                "active_slots": int((s["u"] < s["p"]).sum())}
        line["rows_ms"] = device_ms(torch, lambda: uk.sgd_epoch_rows(
            s["src"], s["h"], s["tails"], s["p"], s["perm"], s["offs"], s["u"], a, b, 1.0, s["scale"]), reps)
        if hasattr(uk, "sgd_epoch_step"):
            head = s["src"] if name == "fit" else s["h"]
            rows = uk.head_rows(s["heads"], s["p"], head.shape[0], head.shape[1])
            out = torch.empty_like(head)
            for key, kw in (("step_ms", {"seed": 12345}), ("step_streamed_ms", {"u": s["u"]})):
                line[key] = device_ms(torch, lambda: uk.sgd_epoch_step(
                    head, s["src"], rows, s["tails"], s["p"], s["perm"], s["offs"], a, b, 1.0, s["scale"], 0.5,
                    out=out, **kw), reps)
        emit(line)


def epoch_ops(torch, uk, a, b, g, s):
    """The fit epoch's operations, in the order the checkout's ``umap_sgd``
    runs them: (name, callable) pairs over a shared state."""
    dev = s["src"].device
    R, K = s["tails"].shape
    n_tab = s["src"].shape[0]
    heads = s["heads"].long()
    st = {"emb": s["src"].clone(), "alpha": 0.5}
    ops = [("randperm", lambda: st.__setitem__("perm", torch.randperm(
               n_tab, generator=g, device=dev, dtype=torch.int32))),
           ("randint", lambda: st.__setitem__("offs", torch.randint(
               0, R, (NEG,), generator=g, device=dev, dtype=torch.int32)))]
    if hasattr(uk, "sgd_epoch_step"):
        rows = uk.head_rows(s["heads"], s["p"], n_tab, st["emb"].shape[1])
        st["nxt"] = torch.empty_like(st["emb"])

        def step():
            uk.sgd_epoch_step(st["emb"], st["emb"], rows, s["tails"], s["p"], st["perm"], st["offs"], a, b, 1.0,
                              2.0, st["alpha"], seed=777, out=st["nxt"])
            st["emb"], st["nxt"] = st["nxt"], st["emb"]

        return ops + [("k10_step", step)]
    st["upd"] = torch.empty_like(st["emb"])
    return [("rand", lambda: st.__setitem__("u", torch.rand((R, K), generator=g, device=dev)))] + ops + [
        ("gather_heads", lambda: st.__setitem__("h", st["emb"][heads])),
        ("k10_rows", lambda: st.__setitem__("rows", uk.sgd_epoch_rows(
            st["emb"], st["h"], s["tails"], s["p"], st["perm"], st["offs"], st["u"], a, b, 1.0, 2.0))),
        ("zero_", lambda: st["upd"].zero_()),
        ("index_add_", lambda: st["upd"].index_add_(0, heads, st["rows"])),
        ("add_", lambda: st["emb"].add_(st["upd"], alpha=st["alpha"])),
    ]


def epoch_split(torch, ops, epochs: int) -> dict:
    for _ in range(2):
        for _, f in ops:
            f()
    torch.cuda.synchronize()
    evs = [torch.cuda.Event(enable_timing=True) for _ in range(epochs * len(ops) + 1)]
    w0, w1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    host = [0.0] * len(ops)
    w0.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    w1.record()
    t0 = time.perf_counter()
    evs[0].record()
    i = 0
    for _ in range(epochs):
        for j, (_, f) in enumerate(ops):
            h0 = time.perf_counter()
            f()
            host[j] += time.perf_counter() - h0
            i += 1
            evs[i].record()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    evs[-1].synchronize()
    wait_ms = w0.elapsed_time(w1)
    dev = [0.0] * len(ops)
    for i in range(epochs * len(ops)):
        dev[i % len(ops)] += evs[i].elapsed_time(evs[i + 1])
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(epochs):
        for _, f in ops:
            f()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3 / epochs
    dev_sum = sum(dev) / epochs
    return {"ops": {name: {"device_ms": dev[j] / epochs, "host_us": host[j] * 1e6 / epochs}
                    for j, (name, _) in enumerate(ops)},
            "device_ms": dev_sum, "host_ms": sum(host) * 1e3 / epochs, "wall_ms": wall,
            "idle_share": 1.0 - dev_sum / wall, "device_only": enqueue_ms < wait_ms,
            "enqueue_ms": enqueue_ms, "wait_ms": wait_ms}


def whole_loops(torch, uk, a, b, shapes, seed):
    for name, n_epochs in (("fit", FIT_EPOCHS), ("transform", TRANSFORM_EPOCHS)):
        s = shapes[name]
        fit = name == "fit"
        head = s["src"] if fit else s["h"]
        gen = torch.Generator(device=head.device)
        gen.manual_seed(seed)

        def run():
            return uk.umap_sgd(head, s["src"], s["heads"], s["tails"], s["p"], gen, n_epochs=n_epochs, a=a, b=b,
                               self_table=fit)

        run()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        emit({"check": "umap_sgd", "shape": name, "n_epochs": n_epochs, "seconds": secs,
              "epoch_ms": secs * 1e3 / n_epochs, "finite": bool(torch.isfinite(out).all())})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parent.parent),
                    help="checkout of the port to time")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--epochs", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("umap_epoch: CUDA is not available; nothing was run", file=sys.stderr)
        return 1
    from spark_rapids_ml_tpu_torch.ops import umap_kernels as uk

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    emit({"tree": str(Path(uk.__file__).resolve().parent.parent.parent), "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0)})
    a, b, g, shapes = inputs(torch, uk, args.seed)
    kernel_times(torch, uk, a, b, shapes, args.reps)
    emit({"check": "epoch_split", "shape": "fit", "epochs": args.epochs,
          **epoch_split(torch, epoch_ops(torch, uk, a, b, g, shapes["fit"]), args.epochs)})
    whole_loops(torch, uk, a, b, shapes, args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
