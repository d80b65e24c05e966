"""Typed catalog of every telemetry metric name (counterpart of
``spark_rapids_ml_tpu/runtime/metricspec.py``).

The JAX package's catalog, name for name, kind and labels, so that the
exports of either package read the same and the later ops-plane and SLO
modules find the names they expect; a test holds the two catalogs equal.
The docs are the JAX package's, apart from what differs in the port:
``xla_compiles`` / ``xla_compile_seconds`` count the port's kernel
library builds (``ops/_build.py``: ``nvcc`` where the library is not built
yet, then its ``ctypes`` load), and ``hbm_live_bytes`` reads
``torch.cuda.memory_allocated``. Where a doc names a ``TPUML_*`` variable,
the port's setting is the module constant that takes its place
(``telemetry.TRACE_DIR``, ``DEVICE_TIME``, ``RESERVOIR``,
``RETRACE_LIMIT``, ``lockwitness.MODE``, ``tuning.CV_FAILFAST``); the port
reads no environment variable.

Kinds:

- ``counter``   — monotonically increasing int; ``delta_since`` reports
                  the difference.
- ``gauge``     — last-write-wins value; ``delta_since`` reports the
                  current value when it changed (not a difference).
- ``histogram`` — observation stream with exact running count/sum/min/
                  max plus a bounded deterministic ring of the last N
                  observations feeding exported quantiles
                  (``telemetry.RESERVOIR``).

``legacy=True`` marks the resilience counters visible through
``counters.snapshot()`` / ``delta_since`` (the ``_resilience_report``
contract). Stdlib-only.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

KINDS = ("counter", "gauge", "histogram")


@dataclass(frozen=True)
class MetricSpec:
    """One cataloged metric. ``kind`` is counter|gauge|histogram."""

    name: str
    kind: str
    doc: str
    # visible through the legacy counters.snapshot()/delta_since API
    # (the _resilience_report contract established before the typed
    # registry existed)
    legacy: bool = False
    # the CLOSED set of label keys call sites may pass — lint rule
    # TPU008 rejects undeclared keys and `**dict` splats, so a metric's
    # label cardinality is bounded by declaration, not by whatever the
    # hottest code path happened to pass (an unbounded per-request
    # label set would explode the live /metrics endpoint)
    labels: Tuple[str, ...] = ()


def _registry(*specs: MetricSpec) -> Dict[str, MetricSpec]:
    out: Dict[str, MetricSpec] = {}
    for s in specs:
        assert s.kind in KINDS, f"{s.name}: bad kind {s.kind}"
        assert s.name not in out, f"duplicate registration {s.name}"
        out[s.name] = s
    return out


SPEC: Dict[str, MetricSpec] = _registry(
    # --- resilience (legacy counters.py catalog, PRs 4-7) -----------------
    MetricSpec(
        "retries", "counter",
        "Attempts beyond the first made by `with_retries`.",
        legacy=True,
    ),
    MetricSpec(
        "chunk_halvings", "counter",
        "Chunk splits performed after RESOURCE_EXHAUSTED staging "
        "failures (`ops/streaming.py`).",
        legacy=True,
    ),
    MetricSpec(
        "resumed_fits", "counter",
        "Fits that restored optimizer state from a checkpoint instead "
        "of starting at iteration 0.",
        legacy=True,
    ),
    MetricSpec(
        "resumed_from", "gauge",
        "Iteration/epoch the most recent resume continued from (0 when "
        "nothing resumed).",
        legacy=True,
    ),
    MetricSpec(
        "cv_failed_fits", "counter",
        "Param combos recorded as worst-metric by the CrossValidator "
        "tolerant mode (`TPUML_CV_FAILFAST=0`).",
        legacy=True,
    ),
    MetricSpec(
        "wire_release_errors", "counter",
        "Chunk device buffers whose post-fold `delete()` raised "
        "(`ops/streaming.py` release helper); a nonzero delta means "
        "retired wire buffers may be leaking host/device memory.",
        legacy=True,
    ),
    MetricSpec(
        "gang_dispatches", "counter",
        "Batched gang-fit device dispatches issued by "
        "`core._TpuEstimator._gang_dispatch` (`core.GANG_FIT`); one "
        "per static-bucket chunk.",
        legacy=True,
    ),
    MetricSpec(
        "gang_lanes_total", "counter",
        "Param lanes fitted across all gang dispatches "
        "(`gang_lanes_total / gang_dispatches` = mean gang width).",
        legacy=True,
    ),
    # --- telemetry runtime (PR 9) -----------------------------------------
    MetricSpec(
        "spans_recorded", "counter",
        "Spans closed and recorded by the tracing layer while "
        "`TPUML_TRACE` is set (0 forever when unset — the inertness "
        "sentinel).",
    ),
    MetricSpec(
        "span_seconds", "histogram",
        "Wall-clock duration of every recorded span, labeled by span "
        "name (the distribution behind the Chrome-trace export).",
        labels=("name",),
    ),
    MetricSpec(
        "xla_compiles", "counter",
        "Kernel library builds observed by the retrace watchdog "
        "(`ops/_build.py`: `nvcc` where the library is not built yet, "
        "then its `ctypes` load; one per library a process), labeled by "
        "the innermost active span at build time.",
        labels=("site",),
    ),
    MetricSpec(
        "xla_compile_seconds", "histogram",
        "Seconds of each observed kernel library build and load, "
        "labeled like `xla_compiles`.",
        labels=("site",),
    ),
    MetricSpec(
        "retrace_storms", "counter",
        "Span sites whose attributed compilation count crossed "
        "`TPUML_TELEMETRY_RETRACE_LIMIT` (each site warns and counts "
        "once).",
    ),
    MetricSpec(
        "hbm_budget_bytes", "gauge",
        "Most recent HBM peak estimate produced by a budget resolver, "
        "labeled by site (`gang_fit`, `tree_batch`, `stream_stage`, "
        "`serve_registry`).",
        labels=("site",),
    ),
    MetricSpec(
        "hbm_live_bytes", "gauge",
        "Live device memory in use when an HBM estimate was recorded, "
        "as `torch.cuda.memory_allocated` reports it (absent without a "
        "card).",
        labels=("site",),
    ),
    # --- roofline attribution (PR 10) -------------------------------------
    MetricSpec(
        "span_flops_total", "counter",
        "XLA cost-model FLOPs attributed to each span site, labeled by "
        "span name: the sum over distinct programs compiled while the "
        "site was innermost, times the site's call count "
        "(`runtime/roofline.py`).",
        labels=("name",),
    ),
    MetricSpec(
        "span_bytes_total", "counter",
        "XLA cost-model bytes accessed attributed to each span site, "
        "labeled like `span_flops_total`.",
        labels=("name",),
    ),
    MetricSpec(
        "span_mfu", "histogram",
        "Model FLOP/s utilization of each roofline-attributed span "
        "call: cost-model FLOPs over fenced device seconds times the "
        "per-chip peak (`TPUML_PEAK_FLOPS` or the built-in device-kind "
        "table) times device count.",
        labels=("name",),
    ),
    MetricSpec(
        "span_achieved_gbps", "histogram",
        "Achieved HBM GB/s of each roofline-attributed span call "
        "(cost-model bytes over fenced device seconds), compared "
        "against `TPUML_PEAK_HBM_GBPS` for the compute/memory-bound "
        "verdict.",
        labels=("name",),
    ),
    # --- online serving (PR 11) -------------------------------------------
    MetricSpec(
        "serve_requests_total", "counter",
        "Requests accepted by `serving.ServingRuntime.predict`, labeled "
        "by registered model name; incremented at enqueue, so the gap "
        "against completed futures is the in-flight count.",
        labels=("model",),
    ),
    MetricSpec(
        "serve_queue_depth", "gauge",
        "Requests waiting in the serving queue when the dispatcher "
        "last drained it (sampled per drain, not per enqueue).",
    ),
    MetricSpec(
        "serve_batch_fill", "histogram",
        "Valid-row fraction of each dispatched padded bucket "
        "(`n_valid / bucket_rows`), labeled by model name; low fill "
        "means the batch window is too short or buckets too coarse "
        "for the offered load.",
        labels=("model",),
    ),
    MetricSpec(
        "serve_p99_ms", "histogram",
        "End-to-end per-request serving latency in milliseconds "
        "(enqueue to result materialized), labeled by model name; the "
        "exported ring quantiles carry the p50/p99 the bench and CI "
        "smoke assert on.",
        labels=("model",),
    ),
    # --- serving resilience (PR 14) ---------------------------------------
    MetricSpec(
        "serve_shed_total", "counter",
        "Requests rejected at admission by `serving.ServingRuntime`, "
        "labeled by model and shed reason (`queue_full` | "
        "`deadline_unmeetable` | `breaker_open` | `draining`); the "
        "typed `Overloaded`/`ShuttingDown` raise is the caller-visible "
        "side of each increment.",
        labels=("model", "reason"),
    ),
    MetricSpec(
        "serve_deadline_miss_total", "counter",
        "Admitted requests whose deadline expired while queued — failed "
        "with `DeadlineExceeded` before padding/dispatch (device time is "
        "never spent on a request that already missed), labeled by "
        "model name.",
        labels=("model",),
    ),
    MetricSpec(
        "serve_dispatch_errors_total", "counter",
        "Unexpected exceptions that escaped a serving dispatch batch; "
        "each one fails that batch's futures and restarts the dispatch "
        "loop instead of killing the serve thread. Nonzero in steady "
        "state means a bug (or injected `serve:*` fault), not load.",
    ),
    MetricSpec(
        "serve_breaker_state", "gauge",
        "Per-model circuit-breaker state (0 closed, 1 half-open, 2 "
        "open), labeled by model name; exported to `/statusz` and an "
        "open breaker flips `/readyz` to 503.",
        labels=("model",),
    ),
    MetricSpec(
        "fault_injections", "counter",
        "Faults raised by the `runtime/faults.py` injection hooks "
        "(`TPUML_FAULT_*`), labeled by fault kind; paired with a "
        "span event so postmortem traces show the injection inline.",
        labels=("kind",),
    ),
    # --- live operations plane (PR 12) ------------------------------------
    MetricSpec(
        "ops_requests_total", "counter",
        "Requests served by the in-process ops HTTP server "
        "(`TPUML_OPS_PORT`), labeled by endpoint (`metrics`, `healthz`, "
        "`readyz`, `statusz`, `flight`, `other`).",
        labels=("endpoint",),
    ),
    MetricSpec(
        "ops_request_seconds", "histogram",
        "Wall-clock handling time of each ops-server request, labeled "
        "like `ops_requests_total` — the live-scrape-under-load "
        "latency the serving bench and CI smoke assert stays in the "
        "tens of milliseconds.",
        labels=("endpoint",),
    ),
    MetricSpec(
        "flight_dumps_total", "counter",
        "Flight-recorder shards written, labeled by trigger (`signal`, "
        "`atexit`, `slo_burn`); the SLO one-shot contract is exactly "
        "one `slo_burn` dump per process.",
        labels=("reason",),
    ),
    MetricSpec(
        "slo_burn_alerts", "counter",
        "SLO catalog entries whose multi-window burn rate crossed "
        "`TPUML_SLO_BURN_THRESHOLD` (one increment per alert "
        "transition, labeled by SLO name — see `runtime/slo.py`).",
        labels=("slo",),
    ),
    MetricSpec(
        "loop_heartbeat_ts", "gauge",
        "`time.monotonic()` of the most recent liveness beat of a "
        "long-running loop, labeled by loop site (`stream_ingest`, "
        "`stream_stage`, `serve_dispatch`, `fit_sched`); `/statusz` reports "
        "`now - value` as the heartbeat age, so a wedged loop shows "
        "up as a growing age instead of silence.",
        labels=("loop",),
    ),
    # --- fit scheduler (PR 15) --------------------------------------------
    MetricSpec(
        "sched_queue_depth", "gauge",
        "Fit jobs admitted to a `runtime.FitScheduler` and not yet "
        "dispatched, sampled by the scheduler loop each pass; bounded "
        "by `TPUML_SCHED_QUEUE_LIMIT` when that is set.",
    ),
    MetricSpec(
        "sched_inflight", "gauge",
        "Fit jobs the scheduler currently has on the device (the "
        "dispatch in progress, including every lane of a packed gang); "
        "`0` whenever the loop is idle.",
    ),
    MetricSpec(
        "sched_fit_ms", "histogram",
        "End-to-end scheduled-fit latency in milliseconds (submit to "
        "future resolution, spanning queue wait, every preempted "
        "segment, and requeue gaps), labeled by tenant; the ring "
        "quantiles carry the admitted p50/p99 the `fit_sched` bench "
        "and the `sched_fit_p99` SLO assert on.",
        labels=("tenant",),
    ),
    MetricSpec(
        "sched_shed_total", "counter",
        "Fit jobs rejected at scheduler admission, labeled by tenant "
        "and shed reason (`queue_full` | `deadline_unmeetable` | "
        "`breaker_open` | `draining`); the typed "
        "`Overloaded`/`ShuttingDown` raise is the caller-visible side "
        "of each increment.",
        labels=("tenant", "reason"),
    ),
    MetricSpec(
        "sched_deadline_miss_total", "counter",
        "Admitted fit jobs whose deadline expired while queued — "
        "failed with `DeadlineExceeded` before dispatch (device time "
        "is never spent on a fit that already missed), labeled by "
        "tenant.",
        labels=("tenant",),
    ),
    MetricSpec(
        "sched_preemptions_total", "counter",
        "Scheduled fits checkpointed and re-queued at a quantum "
        "boundary (`TPUML_SCHED_QUANTUM_MS`); each preemption is "
        "eventually paired with a `sched_resumes_total` increment "
        "unless the scheduler drains first.",
    ),
    MetricSpec(
        "sched_resumes_total", "counter",
        "Re-dispatches of previously preempted fit jobs; the resumed "
        "segment restores from the quantum-boundary checkpoint via the "
        "same `FitCheckpointer` path fault recovery uses.",
    ),
    MetricSpec(
        "sched_dispatch_errors_total", "counter",
        "Fit dispatches that raised (tenant bug or injected `sched:*` "
        "fault); each one fails only that job's future and leaves the "
        "scheduler loop running. Nonzero in steady state means a bad "
        "tenant, not scheduler load.",
    ),
    MetricSpec(
        "sched_breaker_state", "gauge",
        "Per-tenant scheduler circuit-breaker state (0 closed, 1 "
        "half-open, 2 open), labeled by tenant; exported to `/statusz` "
        "and an open breaker flips `/readyz` to 503.",
        labels=("tenant",),
    ),
    MetricSpec(
        "ingest_ring_occupancy", "gauge",
        "Staged chunks buffered in the streaming device-staging ring "
        "when it last accepted one (0..`TPUML_STREAM_STAGE_DEPTH`); "
        "persistently 0 under load means staging is the bottleneck, "
        "persistently full means the fold is.",
    ),
    # --- pod-scale serving router (serving/router.py, PR 17) --------------
    MetricSpec(
        "router_requests_total", "counter",
        "Requests presented to the serving router's front door, labeled "
        "by model — before replica picking, so "
        "`router_requests_total - sum(router_shed_total)` is the count "
        "actually handed to a replica.",
        labels=("model",),
    ),
    MetricSpec(
        "router_picks_total", "counter",
        "Requests dispatched to each replica (labeled by replica "
        "index); the pick distribution under load is the routing "
        "policy's observable — a slow replica's share collapses while "
        "its EWMA wait dominates the score.",
        labels=("replica",),
    ),
    MetricSpec(
        "router_shed_total", "counter",
        "Requests the router rejected with a typed `Overloaded` after "
        "exhausting its reroute budget, labeled by model and reason "
        "(`queue_full` | `deadline_unmeetable` | `breaker_open` | "
        "`draining` | `no_replicas`). Every shed is typed — a router "
        "caller never sees a bare RuntimeError for load.",
        labels=("model", "reason"),
    ),
    MetricSpec(
        "router_breaker_state", "gauge",
        "Per-replica router-side circuit-breaker state (0 closed, 1 "
        "half-open, 2 open), labeled by replica index. Open means the "
        "replica is being routed around after "
        "`TPUML_ROUTER_BREAKER_FAILS` consecutive dispatch faults.",
        labels=("replica",),
    ),
    MetricSpec(
        "router_replica_depth", "gauge",
        "Queue depth of a replica as last observed by the router at "
        "pick time, labeled by replica index (loopback: live dispatcher "
        "queue size; subprocess: in-flight RPC count).",
        labels=("replica",),
    ),
    MetricSpec(
        "fleet_replicas", "gauge",
        "Replica count of the most recently constructed serving "
        "router; static per router lifetime. Compare with the healthy "
        "count in `/statusz`'s fleet section to see degraded capacity.",
    ),
    # --- continuous-training lifecycle (serving/lifecycle.py, PR 18) ------
    MetricSpec(
        "swap_total", "counter",
        "Completed zero-downtime hot-swaps (staged vN+1 warmed and "
        "atomically routed, vN released), labeled by model. A swap only "
        "counts here after the flip — failures land in "
        "`swap_failures_total` instead.",
        labels=("model",),
    ),
    MetricSpec(
        "swap_failures_total", "counter",
        "Hot-swaps that failed before completing, labeled by model and "
        "the stage that died (`load` | `warm` | `flip`); every failure "
        "is also a typed `SwapError` to the caller, and whatever the "
        "stage the prior version keeps serving untouched.",
        labels=("model", "stage"),
    ),
    MetricSpec(
        "swap_duration_ms", "histogram",
        "Wall time of a completed hot-swap in milliseconds (load + "
        "staged ladder warmup + atomic flip), labeled by model — the "
        "window during which the staged version doubles the model's "
        "HBM residency.",
        labels=("model",),
    ),
    MetricSpec(
        "serve_model_version", "gauge",
        "Registry version currently routed for a served model, labeled "
        "by model; bumped by the atomic flip of a hot-swap or canary "
        "promotion. Only recorded on lifecycle transitions — plain "
        "register/serve paths never touch it (defaults-inert).",
        labels=("model",),
    ),
    MetricSpec(
        "canary_requests_total", "counter",
        "Admitted live requests mirrored to a canary candidate, "
        "labeled by the LIVE model name (the candidate's own traffic "
        "shows under `serve_requests_total` at its alias). Callers "
        "always receive the live version's output while this counts.",
        labels=("model",),
    ),
    MetricSpec(
        "canary_promotions_total", "counter",
        "Canary candidates promoted to live after scoring at or above "
        "`TPUML_CANARY_MIN_SCORE` over `TPUML_CANARY_MIN_REQUESTS` "
        "mirrored pairs, labeled by model; the promotion reuses the "
        "already-warmed shadow entry, so it is a pure atomic flip.",
        labels=("model",),
    ),
    MetricSpec(
        "canary_rollbacks_total", "counter",
        "Canary candidates discarded with the prior version still "
        "serving, labeled by model and reason (`score` | `slo_burn` | "
        "`manual` | `shutdown`); each rollback opens the model's "
        "version breaker for `TPUML_CANARY_COOLDOWN_MS`.",
        labels=("model", "reason"),
    ),
    MetricSpec(
        "serve_drift_score", "histogram",
        "Prediction-distribution drift per scoring window: population "
        "stability index (PSI) of the served primary output against "
        "the model's frozen first-window reference, labeled by model. "
        "Rule of thumb: < 0.1 stable, 0.1-0.25 drifting, > 0.25 "
        "retrain; the `serving_drift` SLO budgets the worst ring p99.",
        labels=("model",),
    ),
    MetricSpec(
        "lifecycle_refresh_total", "counter",
        "RefreshDriver re-fit cycles, labeled by model and outcome "
        "(`swapped` | `canary` | `failed` | `skipped`): a completed "
        "low-priority scheduled fit handed to the swap or canary path, "
        "a fit/swap that raised, or a cycle skipped because a canary "
        "was already in progress or the version breaker was open.",
        labels=("model", "outcome"),
    ),
    # --- lock-order witness (runtime/lockwitness.py, PR 19) ---------------
    MetricSpec(
        "lock_order_violations_total", "counter",
        "Distinct lock-order violations observed by the runtime "
        "witness (`TPUML_LOCK_WITNESS`): a rank inversion against the "
        "`runtime/lockspec.py` hierarchy or an acquisition cycle, "
        "labeled by the held and the acquired lock's cataloged names. "
        "Each distinct (held, acquired) pair counts exactly once per "
        "process; both label sets are closed by the lock catalog.",
        labels=("held", "acquired"),
    ),
    MetricSpec(
        "lock_hold_ms", "histogram",
        "Milliseconds a cataloged lock was held, per release, labeled "
        "by the lock's `lockspec` name. Only recorded while the "
        "witness is active — the series answer \"whose critical "
        "section is long\" on `/statusz`.",
        labels=("lock",),
    ),
    MetricSpec(
        "lock_wait_ms", "histogram",
        "Milliseconds an acquire blocked before getting a cataloged "
        "lock, labeled by the lock's `lockspec` name — the direct "
        "contention measurement next to `lock_hold_ms`.",
        labels=("lock",),
    ),
    # --- measured autotuner (runtime/autotune.py, PR 20) ------------------
    MetricSpec(
        "autotune_cache_hits", "counter",
        "Tuning-cache consultations answered from a stored winner, "
        "labeled by knob. Only moves while `TPUML_AUTOTUNE` is `on` or "
        "`force` — an unset tuner leaves no series.",
        labels=("knob",),
    ),
    MetricSpec(
        "autotune_cache_misses", "counter",
        "Tuning-cache consultations that found no entry for the "
        "(knob, shape) key, labeled by knob; the resolver either "
        "probes (when it can measure in place) or falls back to its "
        "static heuristic.",
        labels=("knob",),
    ),
    MetricSpec(
        "autotune_probes_total", "counter",
        "Completed probe searches (one per (knob, shape) measured, "
        "however many candidates the search visited), labeled by knob. "
        "A warm cache must read 0 — probes on a repeat shape mean the "
        "cache is not persisting.",
        labels=("knob",),
    ),
    MetricSpec(
        "autotune_probe_ms", "histogram",
        "Wall milliseconds one probe search spent measuring "
        "candidates, labeled by knob; bounded per search by "
        "`TPUML_AUTOTUNE_BUDGET_MS`.",
        labels=("knob",),
    ),
)


def registered_names() -> Tuple[str, ...]:
    return tuple(SPEC)


def kind_of(name: str) -> str:
    """The registered kind of ``name``; KeyError names the registry."""
    try:
        return SPEC[name].kind
    except KeyError:
        raise KeyError(
            f"{name} is not a cataloged metric "
            f"(spark_rapids_ml_tpu_torch/runtime/metricspec.py is the registry)"
        ) from None
