"""Unified telemetry runtime of the port: structured spans, typed metrics,
the kernel-build watchdog (counterpart of
``spark_rapids_ml_tpu/runtime/telemetry.py``).

One layer answers "where did this fit's wall time go" across host
threads, streaming stages and device work:

- **Spans** — hierarchical wall-clock intervals with ``contextvars``
  parent propagation that survives worker threads (the fold pool in
  ``tuning.py``, the decode/stage threads in ``ops/streaming.py``) via
  :func:`bind_context`. Wall time is always measured; device time is
  opt-in (:data:`DEVICE_TIME`) through a fence at span close that
  synchronizes the CUDA device of every fenced tensor (:func:`_sync`).
  Spans export as a Chrome-trace/Perfetto JSON plus a JSONL event log
  under :data:`TRACE_DIR`.
- **Typed metrics** — counter / gauge / histogram-with-bounded-ring,
  optionally labeled, cataloged in :mod:`.metricspec`. The
  :mod:`.counters` API is a shim over this registry. Exports: Prometheus
  text format and a JSON snapshot.
- **Kernel-build watchdog** — the port's counterpart of the JAX
  package's retrace watchdog: each kernel library build and load of
  ``ops/_build.py`` counts in ``xla_compiles`` / ``xla_compile_seconds``
  under the innermost active span, and a site past :data:`RETRACE_LIMIT`
  warns once.
- **Device memory accounting** — :func:`record_hbm_estimate` files a
  budget's peak estimate as a labeled gauge next to
  ``torch.cuda.memory_allocated``.
- **Span sinks** — :func:`add_span_sink` attaches a callable fed every
  completed span/instant event; while a sink is attached, spans are live
  even with ``TRACE_DIR`` unset, but the trace buffers, ``span_stats``
  and ``spans_recorded`` stay empty.

The settings are module constants, the JAX package's defaults
(``TPUML_TRACE``, ``TPUML_TELEMETRY_DEVICE_TIME``,
``TPUML_TELEMETRY_RESERVOIR``, ``TPUML_TELEMETRY_RETRACE_LIMIT``); one
process has rank 0 (``TPUML_PROC_ID``).

Defaults are inert: with ``TRACE_DIR`` None and no sink attached,
:func:`span` returns a shared no-op, nothing is recorded or written, and
every fit keeps its route, its launches and its results bit for bit.

Not ported: roofline attribution (ROADMAP item 7c) and the cross-process
metric merge and trace shards of several hosts (item 6: one process,
whose :func:`aggregate_metrics` merges its own snapshot).
"""

from __future__ import annotations

import atexit
import contextvars
import itertools
import json
import logging
import os
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

from . import lockwitness, metricspec

_LOGGER = logging.getLogger("spark_rapids_ml_tpu_torch")

# directory of the trace and metric files; None keeps the whole layer inert
# (the JAX package's TPUML_TRACE)
TRACE_DIR: Optional[str] = None
# fence fenced spans at close and record the wait as device seconds (the
# JAX package's TPUML_TELEMETRY_DEVICE_TIME); only read while spans record
DEVICE_TIME = False
# bound of each histogram's observation ring (TPUML_TELEMETRY_RESERVOIR)
RESERVOIR = 512
# kernel builds a span site may take before the watchdog warns; 0 turns
# the watchdog off (TPUML_TELEMETRY_RETRACE_LIMIT)
RETRACE_LIMIT = 16

__all__ = [
    "enabled",
    "span",
    "timed_span",
    "bind_context",
    "add_span_sink",
    "remove_span_sink",
    "active_spans",
    "counter",
    "gauge",
    "histogram",
    "metric_kind",
    "add_span_event",
    "span_stats",
    "flush",
    "prometheus_dump",
    "metrics_snapshot",
    "merge_metric_snapshots",
    "aggregate_metrics",
    "write_metrics",
    "record_hbm_estimate",
    "install_retrace_watchdog",
    "reset_telemetry",
]


# --------------------------------------------------------------------------
# enable gates
# --------------------------------------------------------------------------


def enabled() -> bool:
    """True when ``TRACE_DIR`` is set (spans record and export)."""
    return bool(TRACE_DIR)


def _recording() -> bool:
    """True when spans must be live objects: tracing is enabled OR a
    span sink (the ops-plane flight recorder) is attached. Sinks see
    every completed span/event but nothing is buffered for file export
    unless ``TRACE_DIR`` is also set."""
    return bool(_SINKS) or enabled()


def _trace_dir() -> Optional[str]:
    return TRACE_DIR or None


def _device_time() -> bool:
    return bool(DEVICE_TIME)


def _process_index() -> int:
    """This process's rank in the trace-shard layout: 0, the port runs
    one process (multi-process fits are ROADMAP item 6)."""
    return 0


# --------------------------------------------------------------------------
# typed metrics registry
# --------------------------------------------------------------------------

# RLock: _Hist.quantile locks its ring copy, and the exporters call it
# while already holding the registry lock
_MLOCK = lockwitness.make_rlock("telemetry.metrics")
_METRICS: Dict[str, "_Metric"] = {}


class _Hist:
    """Exact running count/sum/min/max plus a deterministic last-N ring
    (no sampling randomness — TPU004 applies to telemetry too)."""

    __slots__ = ("count", "sum", "min", "max", "ring")

    def __init__(self, reservoir: int) -> None:
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self.ring: Deque[float] = deque(maxlen=reservoir)

    def observe(self, value: float) -> None:
        self.count += 1
        self.sum += value
        if self.min is None or value < self.min:
            self.min = value
        if self.max is None or value > self.max:
            self.max = value
        self.ring.append(value)

    def quantile(self, q: float) -> Optional[float]:
        """Deterministic ring quantile: None on an empty reservoir, the
        lone observation for a single sample (any ``q``), exact min/max
        at q=0/1, and out-of-range ``q`` clamped — never an IndexError
        or interpolated garbage. The ring copy happens under the metric
        lock: a sort racing a concurrent ``observe`` would otherwise
        raise "deque mutated during iteration"."""
        with _MLOCK:
            ordered = sorted(self.ring)
        if not ordered:
            return None
        q = min(1.0, max(0.0, q))
        return ordered[min(len(ordered) - 1, int(q * (len(ordered) - 1)))]


class _Metric:
    """One named metric: kind + labeled series map.

    ``legacy`` series stay visible through ``counters.snapshot()`` /
    ``delta_since`` (the ``_resilience_report`` contract); typed-only
    metrics export through Prometheus/JSON instead.
    """

    __slots__ = ("name", "kind", "legacy", "series")

    def __init__(self, name: str, kind: str, legacy: bool) -> None:
        self.name = name
        self.kind = kind
        self.legacy = legacy
        self.series: Dict[Tuple[Tuple[str, str], ...], Any] = {}

    @staticmethod
    def _key(labels: Dict[str, Any]) -> Tuple[Tuple[str, str], ...]:
        return tuple(sorted((k, str(v)) for k, v in labels.items()))

    def inc(self, by: int = 1, **labels: Any) -> None:
        if self.kind != "counter":
            raise ValueError(f"{self.name} is a {self.kind}, not a counter")
        key = self._key(labels)
        with _MLOCK:
            self.series[key] = self.series.get(key, 0) + int(by)

    def set(self, value: float, **labels: Any) -> None:
        if self.kind != "gauge":
            raise ValueError(f"{self.name} is a {self.kind}, not a gauge")
        key = self._key(labels)
        with _MLOCK:
            self.series[key] = value

    def observe(self, value: float, **labels: Any) -> None:
        if self.kind != "histogram":
            raise ValueError(
                f"{self.name} is a {self.kind}, not a histogram"
            )
        key = self._key(labels)
        with _MLOCK:
            h = self.series.get(key)
            if h is None:
                h = self.series[key] = _Hist(int(RESERVOIR))
            h.observe(value)

    def value(self, **labels: Any) -> Any:
        with _MLOCK:
            return self.series.get(self._key(labels))


def _metric(name: str, kind: str, *, legacy: bool = False) -> _Metric:
    """The metric instance for ``name``, created on first use.

    Cataloged names take their kind (and legacy visibility) from
    :mod:`metricspec` — asking for a cataloged gauge as a counter is a
    ``ValueError``, which is what makes gauge-vs-counter a property of
    the metric rather than a name check. Uncataloged names are allowed
    at runtime.
    """
    with _MLOCK:
        m = _METRICS.get(name)
        if m is None:
            spec = metricspec.SPEC.get(name)
            if spec is not None:
                m = _Metric(name, spec.kind, spec.legacy)
            else:
                m = _Metric(name, kind, legacy)
            _METRICS[name] = m
    if m.kind != kind:
        raise ValueError(
            f"metric {name!r} is registered as a {m.kind}, not a {kind}"
        )
    return m


def counter(name: str) -> _Metric:
    return _metric(name, "counter")


def gauge(name: str) -> _Metric:
    return _metric(name, "gauge")


def histogram(name: str) -> _Metric:
    return _metric(name, "histogram")


def metric_kind(name: str) -> str:
    """The kind of ``name`` — live instance first, then the catalog,
    defaulting to ``counter`` for uncataloged dynamic names."""
    with _MLOCK:
        m = _METRICS.get(name)
    if m is not None:
        return m.kind
    spec = metricspec.SPEC.get(name)
    return spec.kind if spec is not None else "counter"


# legacy counters.py bridge -------------------------------------------------


def _legacy_metric(name: str, kind: str) -> _Metric:
    """Shim entry point: uncataloged names created here stay visible in
    ``counters.snapshot()`` like the pre-registry dict did."""
    return _metric(name, kind, legacy=True)


def _legacy_snapshot() -> Dict[str, int]:
    with _MLOCK:
        out: Dict[str, int] = {}
        for name, m in _METRICS.items():
            if not m.legacy or m.kind == "histogram":
                continue
            v = m.series.get(())
            if v is not None:
                out[name] = int(v)
        return out


def _reset_metrics() -> None:
    with _MLOCK:
        _METRICS.clear()


# --------------------------------------------------------------------------
# spans
# --------------------------------------------------------------------------

_CURRENT: "contextvars.ContextVar[Optional[_Span]]" = contextvars.ContextVar(
    "tpuml_torch_current_span", default=None
)
_IDS = itertools.count(1)

_RLOCK = lockwitness.make_lock("telemetry.trace")
_EPOCH: Optional[float] = None  # perf_counter origin of trace timestamps
_EVENTS: List[Dict[str, Any]] = []  # chrome-trace "X" events
_PENDING_LINES: List[str] = []  # jsonl lines not yet appended to disk
_THREADS: Dict[int, str] = {}  # tid -> thread name (trace metadata)
_STATS: Dict[str, List[float]] = {}  # name -> [count, wall_s, device_s]
_ATEXIT_REGISTERED = False
# span sinks: callables fed every completed span/instant event dict
# (chrome-trace shape) plus the originating thread name. While any sink
# is attached, spans are live even with TRACE_DIR unset (see _recording()).
_SINKS: List[Any] = []
# open spans, span_id -> {span_id, parent_id, name, thread, t0}; empty
# whenever nothing records
_ACTIVE: Dict[int, Dict[str, Any]] = {}


def add_span_sink(fn: Any) -> None:
    """Attach ``fn(event_dict, thread_name)`` to every completed span
    and instant event. Attaching makes spans live (allocated, parented,
    timed) even when ``TRACE_DIR`` is unset; file export stays gated on
    it. Sink exceptions are swallowed — observability must never fail
    the fit."""
    with _RLOCK:
        if fn not in _SINKS:
            _SINKS.append(fn)


def remove_span_sink(fn: Any) -> None:
    with _RLOCK:
        try:
            _SINKS.remove(fn)
        except ValueError:
            pass


def active_spans() -> List[Dict[str, Any]]:
    """Open spans right now: ``[{span_id, parent_id, name, thread,
    age_seconds}, ...]`` sorted by span_id (creation order), so a
    client can rebuild the live span tree with wall-clock ages. Empty
    while nothing records."""
    now = time.perf_counter()
    with _RLOCK:
        snap = [dict(rec) for rec in _ACTIVE.values()]
    out = []
    for rec in sorted(snap, key=lambda r: r["span_id"]):
        rec["age_seconds"] = round(now - rec.pop("t0"), 6)
        out.append(rec)
    return out


class _NullSpan:
    """Shared no-op returned while tracing is disabled."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: Any) -> None:
        return None

    def set_attr(self, **attrs: Any) -> None:
        return None

    def fence(self, arrays: Any) -> None:
        return None


_NULL = _NullSpan()


class _Span:
    """One live span: wall interval + optional device fence + attrs."""

    __slots__ = (
        "name",
        "attrs",
        "span_id",
        "parent_id",
        "_token",
        "_t0",
        "device_s",
        "_fences",
        "tid",
        "thread_name",
    )

    def __init__(self, name: str, attrs: Dict[str, Any]) -> None:
        self.name = name
        self.attrs = attrs
        self.device_s = 0.0
        self._fences: List[Any] = []

    def __enter__(self) -> "_Span":
        parent = _CURRENT.get()
        self.parent_id = parent.span_id if parent is not None else None
        if parent is not None and parent.attrs.get("warmup"):
            # warmup is a property of the whole subtree: a declared-
            # compilation site (serving warmup/probe) calls into closures
            # that open their own dispatch spans, and the retrace
            # watchdog reads the INNERMOST span — without inheritance
            # those inner sites would score the absorbed compiles as
            # storms
            self.attrs.setdefault("warmup", True)
        self.span_id = next(_IDS)
        self._token = _CURRENT.set(self)
        t = threading.current_thread()
        self.tid = t.ident or 0
        self.thread_name = t.name
        self._t0 = time.perf_counter()
        with _RLOCK:
            _ACTIVE[self.span_id] = {
                "span_id": self.span_id,
                "parent_id": self.parent_id,
                "name": self.name,
                "thread": self.thread_name,
                "t0": self._t0,
            }
        return self

    def set_attr(self, **attrs: Any) -> None:
        self.attrs.update(attrs)

    def fence(self, arrays: Any) -> None:
        """Register tensors (or a dict / list / tuple of them, or a
        ``torch.device``) whose CUDA device is synchronized at close when
        ``DEVICE_TIME`` is on, so the span's duration includes the device
        work enqueued before it and the blocked wait is accounted as
        ``device_seconds``. CPU tensors are not fenced."""
        self._fences.append(arrays)

    def __exit__(self, *exc: Any) -> None:
        try:
            if self._fences and _device_time():
                # no try/except: CUDA reports a failed launch at the next
                # synchronization, and this may be it — the error must
                # reach the caller, not vanish into the trace
                t_fence = time.perf_counter()
                if _sync(self._fences):
                    self.device_s = time.perf_counter() - t_fence
        finally:
            dur = time.perf_counter() - self._t0
            _CURRENT.reset(self._token)
            _record(self, dur)
        return None


def _cuda_devices(obj: Any, out: Optional[List[Any]] = None) -> List[Any]:
    """The distinct CUDA devices of the tensors in ``obj`` (tensors,
    ``torch.device`` objects, and dicts / lists / tuples of them, nested);
    anything else, CPU tensors included, adds none."""
    out = [] if out is None else out
    if isinstance(obj, dict):
        for v in obj.values():
            _cuda_devices(v, out)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _cuda_devices(v, out)
    else:
        dev = getattr(obj, "device", obj) if hasattr(obj, "is_cuda") else obj
        if getattr(dev, "type", None) == "cuda" and dev not in out:
            out.append(dev)
    return out


def _sync(fences: Any) -> bool:
    """Synchronize the CUDA device of every fenced tensor; True when one
    was synchronized (False: nothing on a card, no device time).

    A whole-device synchronize, from the thread that closes the span: the
    streamed fold runs on the caller's stream, fed by the staging ring's
    copy stream and its events, so waiting for one stream would miss
    work on the other; the device-wide wait covers both."""
    devices = _cuda_devices(fences)
    if not devices:
        return False
    import torch

    for dev in devices:
        torch.cuda.synchronize(dev)
    return True


def span(name: str, **attrs: Any) -> Any:
    """A context manager for one named span.

    No-op (a shared singleton, no allocation or recording) while
    ``TRACE_DIR`` is unset and no span sink is attached. The returned
    object supports ``set_attr(**kw)`` and ``fence(arrays)`` in both
    modes.
    """
    if not _recording():
        return _NULL
    _ensure_hooks()
    return _Span(name, attrs)


class timed_span:
    """A span that always measures wall time (``.seconds`` after exit),
    recording to the trace only when tracing is enabled. The report
    dicts (``_fit_report`` / ``_transform_report`` / ...) read their
    stage seconds from this layer, so enabling the trace never changes
    what they contain."""

    __slots__ = ("_span", "_t0", "seconds")

    def __init__(self, name: str, **attrs: Any) -> None:
        self._span = span(name, **attrs)
        self.seconds = 0.0

    def __enter__(self) -> "timed_span":
        self._span.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc: Any) -> Any:
        self.seconds = time.perf_counter() - self._t0
        return self._span.__exit__(*exc)


def bind_context(fn: Any) -> Any:
    """Wrap ``fn`` so invocations on another thread inherit the caller's
    span stack. Captures the current ``contextvars`` context once; each
    call runs in a private copy (one Context object cannot be entered
    concurrently). Identity while nothing records."""
    if not _recording():
        return fn
    snap = contextvars.copy_context()

    def _bound(*args: Any, **kwargs: Any) -> Any:
        return snap.copy().run(fn, *args, **kwargs)

    return _bound


def _record(s: _Span, dur: float) -> None:
    global _EPOCH, _ATEXIT_REGISTERED
    root_closed = s.parent_id is None
    exporting = enabled()
    with _RLOCK:
        _ACTIVE.pop(s.span_id, None)
        if _EPOCH is None:
            _EPOCH = s._t0
        ts_us = (s._t0 - _EPOCH) * 1e6
        args: Dict[str, Any] = dict(s.attrs)
        args["span_id"] = s.span_id
        if s.parent_id is not None:
            args["parent_id"] = s.parent_id
        if s.device_s:
            args["device_seconds"] = round(s.device_s, 6)
        ev = {
            "name": s.name,
            "ph": "X",
            "ts": round(ts_us, 3),
            "dur": round(dur * 1e6, 3),
            "pid": os.getpid(),
            "tid": s.tid,
            "args": args,
        }
        # the file-export buffers (trace JSON, JSONL log, span_stats)
        # and their metrics stay gated on TRACE_DIR — the sink-only path
        # accumulates nothing here (spans_recorded stays the inertness
        # sentinel)
        if exporting:
            _EVENTS.append(ev)
            _THREADS.setdefault(s.tid, s.thread_name)
            _PENDING_LINES.append(
                json.dumps(
                    {
                        "event": "span",
                        "name": s.name,
                        "span_id": s.span_id,
                        "parent_id": s.parent_id,
                        "thread": s.thread_name,
                        "ts_us": round(ts_us, 3),
                        "wall_seconds": round(dur, 6),
                        "device_seconds": round(s.device_s, 6),
                        "attrs": s.attrs,
                    },
                    sort_keys=True,
                    default=str,
                )
            )
            st = _STATS.get(s.name)
            if st is None:
                st = _STATS[s.name] = [0, 0.0, 0.0]
            st[0] += 1
            st[1] += dur
            st[2] += s.device_s
            if not _ATEXIT_REGISTERED:
                _ATEXIT_REGISTERED = True
                atexit.register(_atexit_flush)
        sinks = list(_SINKS)
    for sink in sinks:
        try:
            sink(ev, s.thread_name)
        except Exception:  # a broken sink must never fail a span close
            pass
    if exporting:
        counter("spans_recorded").inc()
        histogram("span_seconds").observe(dur, name=s.name)
        if root_closed:
            flush()


def _atexit_flush() -> None:
    """Crash-path persistence: at interpreter exit (including an
    unhandled exception unwinding mid-fit) write whatever the buffers
    hold — the trace shard, pending JSONL lines, AND a metric snapshot,
    so a postmortem has both the timeline and the counters."""
    try:
        flush()
    except Exception:
        pass
    try:
        write_metrics()
    except Exception:
        pass


def add_span_event(name: str, **attrs: Any) -> None:
    """Record an instant event (a point in time, not an interval) under
    the innermost active span — retries, injected faults, and similar
    occurrences show up inline on the trace timeline for postmortems.
    No-op while nothing records (tracing disabled, no sink attached)."""
    if not _recording():
        return
    global _EPOCH, _ATEXIT_REGISTERED
    exporting = enabled()
    cur = _CURRENT.get()
    t = threading.current_thread()
    tid = t.ident or 0
    now = time.perf_counter()
    with _RLOCK:
        if _EPOCH is None:
            _EPOCH = now
        ts_us = (now - _EPOCH) * 1e6
        args: Dict[str, Any] = dict(attrs)
        if cur is not None:
            args["span_id"] = cur.span_id
        ev = {
            "name": name,
            "ph": "i",
            "s": "t",  # thread-scoped instant marker
            "ts": round(ts_us, 3),
            "pid": os.getpid(),
            "tid": tid,
            "args": args,
        }
        if exporting:
            _EVENTS.append(ev)
            _THREADS.setdefault(tid, t.name)
            _PENDING_LINES.append(
                json.dumps(
                    {
                        "event": "point",
                        "name": name,
                        "span": cur.name if cur is not None else None,
                        "thread": t.name,
                        "ts_us": round(ts_us, 3),
                        "attrs": attrs,
                    },
                    sort_keys=True,
                    default=str,
                )
            )
            if not _ATEXIT_REGISTERED:
                _ATEXIT_REGISTERED = True
                atexit.register(_atexit_flush)
        sinks = list(_SINKS)
    for sink in sinks:
        try:
            sink(ev, t.name)
        except Exception:
            pass


def span_stats() -> Dict[str, Dict[str, float]]:
    """Per-span-name running aggregates:
    ``{name: {count, wall_seconds, device_seconds}}`` (empty while
    tracing never enabled — the inertness sentinel). Roofline
    attributes (``flops_total``, ``mfu``, ...) come with ROADMAP item
    7c."""
    with _RLOCK:
        stats: Dict[str, Dict[str, float]] = {
            name: {
                "count": int(st[0]),
                "wall_seconds": st[1],
                "device_seconds": st[2],
            }
            for name, st in _STATS.items()
        }
    return stats


def flush() -> Optional[str]:
    """Write the Chrome-trace JSON (rewritten whole) and append pending
    JSONL span events under ``TRACE_DIR``. Called automatically at
    every root-span close and at interpreter exit; safe to call any
    time. Returns the trace file path, or None when there is nothing to
    write or ``TRACE_DIR`` was unset meanwhile.

    The JAX package's rank-aware layout: every filename carries the
    process index (``trace-r00-<pid>.json``; the port runs one process,
    rank 0), and the document carries it as ``metadata.process_index``.
    """
    out_dir = _trace_dir()
    with _RLOCK:
        if out_dir is None or not _EVENTS:
            return None
        rank = _process_index()
        meta = [
            {
                "ph": "M",
                "name": "process_name",
                "pid": os.getpid(),
                "tid": 0,
                "args": {"name": "spark_rapids_ml_tpu_torch"},
            }
        ]
        for tid, tname in sorted(_THREADS.items()):
            meta.append(
                {
                    "ph": "M",
                    "name": "thread_name",
                    "pid": os.getpid(),
                    "tid": tid,
                    "args": {"name": tname},
                }
            )
        doc = {
            "traceEvents": meta + _EVENTS,
            "displayTimeUnit": "ms",
            "metadata": {"process_index": rank},
        }
        pending, _PENDING_LINES[:] = _PENDING_LINES[:], []
        os.makedirs(out_dir, exist_ok=True)
        tag = f"r{rank:02d}-{os.getpid()}"
        trace_path = os.path.join(out_dir, f"trace-{tag}.json")
        tmp = trace_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, trace_path)
        if pending:
            events_path = os.path.join(out_dir, f"events-{tag}.jsonl")
            with open(events_path, "a") as f:
                f.write("\n".join(pending) + "\n")
        return trace_path


def reset_telemetry() -> None:
    """Clear spans, metrics and watchdog state (test isolation)."""
    global _EPOCH
    with _RLOCK:
        _EPOCH = None
        _EVENTS.clear()
        _PENDING_LINES.clear()
        _THREADS.clear()
        _STATS.clear()
        _ACTIVE.clear()
        _SINKS.clear()
    _reset_metrics()
    with _WD_LOCK:
        _WD_COUNTS.clear()
        _WD_WARNED.clear()


# --------------------------------------------------------------------------
# metric exports
# --------------------------------------------------------------------------

_QUANTILES = (0.5, 0.95, 0.99)


def _label_str(key: Tuple[Tuple[str, str], ...], extra: str = "") -> str:
    parts = [
        f'{k}="{v}"'.replace("\n", " ")
        for k, v in key
    ]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def prometheus_dump() -> str:
    """Every live metric in Prometheus text exposition format
    (``tpuml_`` prefix; histograms exported summary-style from the
    bounded ring plus exact ``_count`` / ``_sum``)."""
    with _MLOCK:
        metrics = sorted(_METRICS.items())
        lines: List[str] = []
        for name, m in metrics:
            spec = metricspec.SPEC.get(name)
            doc = spec.doc if spec is not None else "(uncataloged metric)"
            pname = f"tpuml_{name}"
            ptype = "summary" if m.kind == "histogram" else m.kind
            lines.append(f"# HELP {pname} {doc}".replace("\n", " "))
            lines.append(f"# TYPE {pname} {ptype}")
            for key, v in sorted(m.series.items()):
                if m.kind == "histogram":
                    for q in _QUANTILES:
                        qv = v.quantile(q)
                        if qv is None:
                            continue
                        qlabel = 'quantile="%g"' % q
                        lines.append(
                            f"{pname}{_label_str(key, qlabel)} {qv:g}"
                        )
                    lines.append(
                        f"{pname}_count{_label_str(key)} {v.count}"
                    )
                    lines.append(f"{pname}_sum{_label_str(key)} {v.sum:g}")
                else:
                    lines.append(f"{pname}{_label_str(key)} {v:g}")
        return "\n".join(lines) + ("\n" if lines else "")


def metrics_snapshot() -> Dict[str, Any]:
    """A JSON-able snapshot of every live metric: kind plus each labeled
    series (histograms as count/sum/min/max + ring quantiles + the
    sorted bounded reservoir itself, so a cross-rank merge can quantile
    the fleet exactly instead of approximating from count/sum)."""
    with _MLOCK:
        out: Dict[str, Any] = {}
        for name, m in sorted(_METRICS.items()):
            series = []
            for key, v in sorted(m.series.items()):
                labels = dict(key)
                if m.kind == "histogram":
                    series.append(
                        {
                            "labels": labels,
                            "count": v.count,
                            "sum": v.sum,
                            "min": v.min,
                            "max": v.max,
                            "reservoir": sorted(v.ring),
                            **{
                                f"p{int(q * 100)}": v.quantile(q)
                                for q in _QUANTILES
                            },
                        }
                    )
                else:
                    series.append({"labels": labels, "value": v})
            out[name] = {"kind": m.kind, "series": series}
        return out


def write_metrics(out_dir: Optional[str] = None) -> Optional[Tuple[str, str]]:
    """Write ``metrics-r00-<pid>.prom`` (text format) and
    ``metrics-r00-<pid>.json`` (snapshot) into ``out_dir`` (default:
    ``TRACE_DIR``), process-index-tagged like the trace shards. Returns the two paths, or None when no directory is
    configured."""
    out_dir = out_dir or _trace_dir()
    if out_dir is None:
        return None
    os.makedirs(out_dir, exist_ok=True)
    tag = f"r{_process_index():02d}-{os.getpid()}"
    prom = os.path.join(out_dir, f"metrics-{tag}.prom")
    js = os.path.join(out_dir, f"metrics-{tag}.json")
    with open(prom, "w") as f:
        f.write(prometheus_dump())
    with open(js, "w") as f:
        json.dump(metrics_snapshot(), f, indent=2, sort_keys=True)
    return prom, js


# --------------------------------------------------------------------------
# cross-host aggregation
# --------------------------------------------------------------------------


#: Bound on a merged reservoir: concatenated per-rank rings are sorted
#: and evenly downsampled to at most this many samples, so an N-rank
#: fold stays O(cap) no matter the fleet size (the JAX package's value).
RESERVOIR_MERGE_CAP = 4096


def _merged_quantile(ordered: List[float], q: float) -> float:
    """The exact ``_Hist.quantile`` rule over an already-sorted list."""
    q = min(1.0, max(0.0, q))
    return ordered[min(len(ordered) - 1, int(q * (len(ordered) - 1)))]


def _fold_reservoir(samples: List[float]) -> List[float]:
    """Sort concatenated per-rank reservoirs and evenly downsample to
    ``RESERVOIR_MERGE_CAP`` keeping both endpoints — deterministic
    (TPU004: no sampling randomness) and input-order-independent."""
    ordered = sorted(samples)
    n = len(ordered)
    cap = RESERVOIR_MERGE_CAP
    if n <= cap:
        return ordered
    return [ordered[i * (n - 1) // (cap - 1)] for i in range(cap)]


def merge_metric_snapshots(snaps: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Fold per-process :func:`metrics_snapshot` dicts into one
    cluster-wide view, kind-aware per labeled series: counters SUM,
    gauges MAX (each rank's last-write is a local reading; the peak is
    the conservative cluster answer), histogram count/sum SUM with
    min/max merged and per-rank reservoirs concatenated, sorted,
    bounded to ``RESERVOIR_MERGE_CAP``, and re-quantiled — merged p99
    is measured over the pooled samples, not approximated. Snapshots
    without a ``reservoir`` key still merge; their per-rank quantiles
    are dropped rather than faked.
    """
    merged: Dict[str, Any] = {}
    for snap in snaps:
        for name, entry in snap.items():
            kind = entry.get("kind", "counter")
            slot = merged.setdefault(name, {"kind": kind, "series": {}})
            for series in entry.get("series", []):
                labels = series.get("labels", {})
                key = tuple(sorted(labels.items()))
                have = slot["series"].get(key)
                if kind == "histogram":
                    if have is None:
                        slot["series"][key] = {
                            "labels": labels,
                            "count": series.get("count", 0),
                            "sum": series.get("sum", 0.0),
                            "min": series.get("min"),
                            "max": series.get("max"),
                            "reservoir": list(
                                series.get("reservoir") or []
                            ),
                        }
                    else:
                        have["count"] += series.get("count", 0)
                        have["sum"] += series.get("sum", 0.0)
                        for fld, pick in (("min", min), ("max", max)):
                            v = series.get(fld)
                            if v is not None:
                                have[fld] = (
                                    v if have[fld] is None
                                    else pick(have[fld], v)
                                )
                        have["reservoir"].extend(
                            series.get("reservoir") or []
                        )
                else:
                    value = series.get("value", 0)
                    if have is None:
                        slot["series"][key] = {
                            "labels": labels, "value": value,
                        }
                    elif kind == "gauge":
                        have["value"] = max(have["value"], value)
                    else:
                        have["value"] += value
    out: Dict[str, Any] = {}
    for name, entry in sorted(merged.items()):
        series_out = []
        for k in sorted(entry["series"]):
            s = entry["series"][k]
            if entry["kind"] == "histogram":
                res = _fold_reservoir(s.pop("reservoir"))
                if res:
                    s["reservoir"] = res
                    for q in (0.5, 0.95, 0.99):
                        s[f"p{int(q * 100)}"] = _merged_quantile(res, q)
            series_out.append(s)
        out[name] = {"kind": entry["kind"], "series": series_out}
    return out


def aggregate_metrics() -> Dict[str, Any]:
    """The merged metric snapshot of every process: one process here
    (the cross-process gather is ROADMAP item 6), so the merge of the
    local snapshot alone — the shape the JAX package returns on one
    process."""
    return merge_metric_snapshots([metrics_snapshot()])


# --------------------------------------------------------------------------
# kernel-build watchdog (the JAX package's retrace watchdog)
# --------------------------------------------------------------------------

_WD_LOCK = lockwitness.make_lock("telemetry.watchdog")
_WD_INSTALLED = False
_WD_CHECKED = False
_WD_COUNTS: Dict[str, int] = {}
_WD_WARNED: set = set()


def _retrace_limit() -> int:
    return int(RETRACE_LIMIT)


def _watchdog_active() -> bool:
    """The listener stays installed once installed, but its EFFECT
    follows the live opt-in: telemetry recording. A process that traced
    once does not charge every later untraced build to ``<untraced>``."""
    return _recording()


def _on_build(name: str, duration: float) -> None:
    """Listener of ``ops/_build.py``: one kernel library was built (where
    it was not built yet) and loaded in ``duration`` seconds — the port's
    counterpart of an XLA backend compile."""
    try:  # a listener exception must never fail a kernel's first launch
        if not _watchdog_active():
            return
        cur = _CURRENT.get()
        site = cur.name if cur is not None else "<untraced>"
        counter("xla_compiles").inc(1, site=site)
        histogram("xla_compile_seconds").observe(duration, site=site)
        if cur is not None and cur.attrs.get("warmup"):
            # declared-build sites (`span(..., warmup=True)`) count their
            # builds but are never scored as a storm
            return
        storm = False
        with _WD_LOCK:
            count = _WD_COUNTS[site] = _WD_COUNTS.get(site, 0) + 1
            if site not in _WD_WARNED:
                limit = _retrace_limit()
                storm = limit > 0 and count > limit
                if storm:
                    _WD_WARNED.add(site)
        if storm:
            counter("retrace_storms").inc()
            _LOGGER.warning(
                "build storm: %d kernel library builds attributed to span "
                "site %r (limit %d) — a kernel source or its flags is "
                "likely changing every call",
                count,
                site,
                limit,
            )
    except Exception:
        pass


def install_retrace_watchdog() -> bool:
    """Register the build listener with ``ops/_build.py`` (idempotent).
    Returns True when installed (now or earlier). Happens on the first
    recording span while ``RETRACE_LIMIT`` > 0, or on a direct call."""
    global _WD_INSTALLED
    with _WD_LOCK:
        if _WD_INSTALLED:
            return True
        from ..ops import _build

        _build.add_build_listener(_on_build)
        _WD_INSTALLED = True
        return True


def _ensure_hooks() -> None:
    """Install the build listener and the crash-path atexit flush on the
    first recording span; cheap after the first call. The JAX package
    also installs its roofline cost capture here: that is ROADMAP item
    7c, so spans carry no ``flops_total`` / ``mfu`` yet."""
    global _WD_CHECKED, _ATEXIT_REGISTERED
    if _WD_CHECKED:
        return
    _WD_CHECKED = True
    if _retrace_limit() > 0:
        install_retrace_watchdog()
    with _RLOCK:
        if not _ATEXIT_REGISTERED:
            _ATEXIT_REGISTERED = True
            atexit.register(_atexit_flush)


# --------------------------------------------------------------------------
# HBM accounting
# --------------------------------------------------------------------------


def record_hbm_estimate(site: str, nbytes: float, device: Any = None) -> None:
    """File a budget's peak device-memory estimate (``site`` is, in the
    port, ``stream_stage``: the staged chunks and the staging ring's
    page-locked buffers, or ``gang_fit``: a gang dispatch's lanes) next to
    the live bytes
    ``torch.cuda.memory_allocated(device)`` reports (the current device
    where None; skipped without a card). No-op while nothing records, so
    budget resolution stays allocation-free by default."""
    if not _recording():
        return
    gauge("hbm_budget_bytes").set(float(nbytes), site=site)
    import torch

    if not torch.cuda.is_available():
        return
    if device is not None and getattr(device, "type", "cuda") != "cuda":
        return
    gauge("hbm_live_bytes").set(float(torch.cuda.memory_allocated(device)), site=site)
