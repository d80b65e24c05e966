"""Port parity: the telemetry runtime (``spark_rapids_ml_tpu_torch/runtime/
telemetry.py`` and ``metricspec.py``, ``utils/profiling.py``) against the
JAX package's on the CPU.

One scripted sequence of spans (nested, one across a ``bind_context``
thread, an instant event), counters, gauges and histograms runs through
both packages' telemetry, the JAX side with ``TPUML_TRACE`` set through
``monkeypatch``, the port with ``telemetry.TRACE_DIR``. ``time.perf_counter``
is a fake clock in both runs (a quarter second a call, exact in binary),
so the durations are equal too. Tolerances: the catalogs, the Prometheus
text, the metric snapshots and their merges are equal; the Chrome trace
and the JSONL log are equal in structure (names, parent links, attrs,
thread names), ignoring span ids, thread ids and pids.

The port's own contract: defaults inert (the shared no-op span, no file),
a fence that lets a CUDA error through (``_sync`` patched to raise: the
real one skips CPU tensors), the kernel-build watchdog fed by
``ops/_build.py`` against the JAX package's retrace watchdog fed the same
compile events, and ``profiling.trace`` writing a Chrome trace.
"""

import ctypes
import itertools
import json
import os
import threading
import time

import pytest
import torch

from spark_rapids_ml_tpu.runtime import counters as jcounters
from spark_rapids_ml_tpu.runtime import metricspec as jmetricspec
from spark_rapids_ml_tpu.runtime import lockspec as jlockspec
from spark_rapids_ml_tpu.runtime import telemetry as jtel
from spark_rapids_ml_tpu_torch.ops import _build
from spark_rapids_ml_tpu_torch.runtime import counters as tcounters
from spark_rapids_ml_tpu_torch.runtime import lockspec as tlockspec
from spark_rapids_ml_tpu_torch.runtime import metricspec as tmetricspec
from spark_rapids_ml_tpu_torch.runtime import telemetry as ttel
from spark_rapids_ml_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def _clean():
    jtel.reset_telemetry()
    ttel.reset_telemetry()
    yield
    jtel.reset_telemetry()
    ttel.reset_telemetry()


@pytest.fixture
def fake_clock(monkeypatch):
    ticks = itertools.count()
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks) * 0.25)


def _trace_on(monkeypatch, tmp_path):
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    monkeypatch.setenv("TPUML_TRACE", str(jdir))
    monkeypatch.setattr(ttel, "TRACE_DIR", str(tdir))
    return str(jdir), str(tdir)


def _script(tel, counters):
    """The scripted sequence: two roots, nesting, a worker thread bound to
    the first root, an instant event, counters, gauges and histograms."""
    with tel.span("fit", phase="a"):
        with tel.span("stage", rows=3) as sp:
            sp.set_attr(extra=1)
            tel.add_span_event("retry", attempt=1)

        def work():
            with tel.span("child", k=2):
                with tel.span("grandchild"):
                    pass

        th = threading.Thread(target=tel.bind_context(work), name="worker")
        th.start()
        th.join()
        counters.bump("retries")
        counters.bump("retries", 2)
        counters.note("resumed_from", 3)
        tel.gauge("ingest_ring_occupancy").set(2)
        tel.gauge("loop_heartbeat_ts").set(12.5, loop="stream_ingest")
        tel.counter("fault_injections").inc(2, kind="stage")
        for v in (1.5, 0.25, 3.0):
            tel.histogram("lock_wait_ms").observe(v, lock="telemetry.trace")
    with tel.span("second_root"):
        pass


def _files(d, prefix):
    names = [n for n in os.listdir(d) if n.startswith(prefix)]
    assert len(names) == 1, names
    return os.path.join(d, names[0])


def _trace_structure(d):
    with open(_files(d, "trace-")) as f:
        doc = json.load(f)
    assert doc["displayTimeUnit"] == "ms" and doc["metadata"] == {"process_index": 0}
    names = {e["args"]["span_id"]: e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
    out = []
    for e in doc["traceEvents"]:
        args = {k: v for k, v in e.get("args", {}).items() if k not in ("span_id", "parent_id")}
        if e["ph"] == "M":
            out.append(("M", e["name"], args.get("name") if e["name"] == "thread_name" else None))
        elif e["ph"] == "X":
            out.append(("X", e["name"], names.get(e["args"].get("parent_id")), args, e["ts"], e["dur"]))
        else:
            out.append((e["ph"], e["name"], names.get(e["args"].get("span_id")), args, e["ts"], e["s"]))
    return out


def _jsonl_structure(d):
    with open(_files(d, "events-")) as f:
        lines = [json.loads(ln) for ln in f]
    names = {ln["span_id"]: ln["name"] for ln in lines if ln["event"] == "span"}
    out = []
    for ln in lines:
        ln = dict(ln)
        if ln["event"] == "span":
            ln["parent"] = names.get(ln.pop("parent_id"))
            ln.pop("span_id")
        out.append(ln)
    return out


# ---------------------------------------------------------------------------
# the catalogs
# ---------------------------------------------------------------------------


def test_metric_catalog_matches_jax():
    j, t = jmetricspec.SPEC, tmetricspec.SPEC
    assert list(t) == list(j)
    for name, spec in j.items():
        assert (t[name].kind, t[name].labels, t[name].legacy) == (spec.kind, spec.labels, spec.legacy), name
    assert tmetricspec.registered_names() == jmetricspec.registered_names()
    assert tmetricspec.kind_of("span_seconds") == "histogram"
    with pytest.raises(KeyError, match="spark_rapids_ml_tpu_torch"):
        tmetricspec.kind_of("not_a_metric")


def test_lock_catalog_is_the_jax_telemetry_band():
    for name, spec in tlockspec.SPEC.items():
        j = jlockspec.SPEC[name]
        assert (spec.rank, spec.kind, spec.cls, spec.attr) == (j.rank, j.kind, j.cls, j.attr)
        assert spec.module == j.module.replace("spark_rapids_ml_tpu/", "spark_rapids_ml_tpu_torch/")
    assert set(tlockspec.SPEC) == {"telemetry.metrics", "telemetry.trace", "telemetry.watchdog",
                                   "scheduler.state", "scheduler.breakers", "admission.ewma", "admission.breaker",
                                   "faults.plan", "faults.cache"}


# ---------------------------------------------------------------------------
# the scripted sequence through both packages
# ---------------------------------------------------------------------------


def test_scripted_sequence_matches_jax(monkeypatch, tmp_path, fake_clock):
    jdir, tdir = _trace_on(monkeypatch, tmp_path)
    _script(jtel, jcounters)
    _script(ttel, tcounters)
    # the root closes flushed both files
    assert _trace_structure(tdir) == _trace_structure(jdir)
    assert _jsonl_structure(tdir) == _jsonl_structure(jdir)
    tdoc = _trace_structure(tdir)
    assert ("M", "thread_name", "worker") in tdoc
    xs = {e[1]: e[2] for e in tdoc if e[0] == "X"}
    assert xs == {"stage": "fit", "child": "fit", "grandchild": "child", "fit": None, "second_root": None}
    assert ttel.prometheus_dump() == jtel.prometheus_dump()
    tsnap, jsnap = ttel.metrics_snapshot(), jtel.metrics_snapshot()
    assert tsnap == jsnap
    assert tsnap["spans_recorded"]["series"] == [{"labels": {}, "value": 5}]
    assert ttel.merge_metric_snapshots([tsnap, tsnap, {}]) == jtel.merge_metric_snapshots([jsnap, jsnap, {}])
    assert ttel.aggregate_metrics() == ttel.merge_metric_snapshots([tsnap])
    assert ttel.span_stats() == jtel.span_stats()
    assert tcounters.snapshot() == jcounters.snapshot() == {"retries": 3, "resumed_from": 3}
    # metric files, tagged with rank 0 and the pid
    paths = ttel.write_metrics()
    assert [os.path.basename(p) for p in paths] == [f"metrics-r00-{os.getpid()}.prom",
                                                    f"metrics-r00-{os.getpid()}.json"]
    with open(paths[0]) as f:
        assert f.read() == jtel.prometheus_dump()


def test_merge_of_other_snapshots_matches_jax():
    """Counters sum, gauges take the max, histogram reservoirs pool past the
    merge cap, and snapshots without a reservoir still merge."""
    a = {"retries": {"kind": "counter", "series": [{"labels": {}, "value": 2}]},
         "loop_heartbeat_ts": {"kind": "gauge", "series": [{"labels": {"loop": "x"}, "value": 5.0}]},
         "span_seconds": {"kind": "histogram", "series": [
             {"labels": {"name": "s"}, "count": 3000, "sum": 9.0, "min": 0.0, "max": 2.0,
              "reservoir": [i / 1000 for i in range(3000)]}]}}
    b = {"retries": {"kind": "counter", "series": [{"labels": {}, "value": 5}]},
         "loop_heartbeat_ts": {"kind": "gauge", "series": [{"labels": {"loop": "x"}, "value": 4.0}]},
         "span_seconds": {"kind": "histogram", "series": [
             {"labels": {"name": "s"}, "count": 2000, "sum": 1.0, "min": 0.5, "max": 9.0,
              "reservoir": [9.0 - i / 1000 for i in range(2000)]},
             {"labels": {"name": "t"}, "count": 1, "sum": 1.0, "min": 1.0, "max": 1.0}]}}
    merged = ttel.merge_metric_snapshots([a, b])
    assert merged == jtel.merge_metric_snapshots([a, b])
    assert merged["retries"]["series"][0]["value"] == 7
    assert len(merged["span_seconds"]["series"][0]["reservoir"]) == ttel.RESERVOIR_MERGE_CAP


def test_histogram_ring_and_kind_checks_match_jax(monkeypatch):
    monkeypatch.setenv("TPUML_TELEMETRY_RESERVOIR", "4")
    monkeypatch.setattr(ttel, "RESERVOIR", 4)
    for tel in (jtel, ttel):
        h = tel.histogram("span_seconds")
        for v in range(10):
            h.observe(float(v), name="s")
        with pytest.raises(ValueError, match="not a counter"):
            tel.counter("span_seconds")
        with pytest.raises(ValueError, match="not a gauge"):
            tel._metric("retries", "counter").set(1.0)
    assert ttel.metrics_snapshot() == jtel.metrics_snapshot()
    assert ttel.metrics_snapshot()["span_seconds"]["series"][0]["reservoir"] == [6.0, 7.0, 8.0, 9.0]


# ---------------------------------------------------------------------------
# the port's contract
# ---------------------------------------------------------------------------


def test_defaults_are_inert(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert ttel.TRACE_DIR is None and ttel.DEVICE_TIME is False
    assert (ttel.RESERVOIR, ttel.RETRACE_LIMIT) == (512, 16)
    s = ttel.span("x", a=1)
    assert s is ttel._NULL and ttel.span("y") is s
    with s as inner:
        inner.set_attr(b=2)
        inner.fence(torch.zeros(2))

    def f():
        return 1

    assert ttel.bind_context(f) is f
    ts = ttel.timed_span("t")
    with ts:
        pass
    assert ts.seconds >= 0.0
    ttel.add_span_event("e")
    ttel.record_hbm_estimate("stream_stage", 1.0)
    assert ttel.flush() is None and ttel.write_metrics() is None
    assert ttel.span_stats() == {} and ttel.active_spans() == []
    assert "spans_recorded" not in ttel.metrics_snapshot()
    assert "hbm_budget_bytes" not in ttel.metrics_snapshot()
    assert os.listdir(tmp_path) == []


def test_fence_lets_a_device_error_through(monkeypatch, tmp_path):
    """A span that fenced a tensor synchronizes its device at close; the
    error of that synchronization (CUDA reports a failed launch there)
    propagates, and the span is still closed and recorded."""
    monkeypatch.setattr(ttel, "TRACE_DIR", str(tmp_path))
    monkeypatch.setattr(ttel, "DEVICE_TIME", True)
    # the real _sync: a CPU tensor is not fenced, no device time
    with ttel.span("cpu") as sp:
        sp.fence({"a": [torch.zeros(3)], "b": (torch.ones(1),)})
    assert sp.device_s == 0.0

    def failing(fences):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(ttel, "_sync", failing)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        with ttel.span("root"):
            with ttel.span("fenced") as sp:
                sp.fence(torch.zeros(3))
    assert ttel._CURRENT.get() is None
    assert ttel.span_stats()["fenced"]["count"] == 1 and ttel.span_stats()["root"]["count"] == 1
    # an unfenced span, or device time off, never synchronizes
    with ttel.span("unfenced"):
        pass
    monkeypatch.setattr(ttel, "DEVICE_TIME", False)
    with ttel.span("off") as sp:
        sp.fence(torch.zeros(3))
    # and a device time is recorded where the fence synchronized
    monkeypatch.setattr(ttel, "DEVICE_TIME", True)
    monkeypatch.setattr(ttel, "_sync", lambda fences: True)
    with ttel.span("synced") as sp:
        sp.fence(torch.zeros(1))
    assert sp.device_s > 0.0 and ttel.span_stats()["synced"]["device_seconds"] == sp.device_s


def test_fence_walks_to_the_cuda_devices():
    cuda0, cuda1 = torch.device("cuda", 0), torch.device("cuda", 1)
    got = ttel._cuda_devices({"a": [cuda0, torch.zeros(2)], "b": (cuda1, {"c": cuda0}), "d": 3, "e": None})
    assert got == [cuda0, cuda1]
    assert ttel._cuda_devices([torch.zeros(2), torch.device("cpu"), "cuda"]) == []
    assert ttel._sync([torch.zeros(2)]) is False


def _compile_sequence(on_event):
    """Builds (or compiles) at three sites: a storm at 'hot' past a limit
    of 2, a warmup site that never storms, untraced ones."""
    for _ in range(4):
        on_event("hot")
    on_event("warm")
    on_event("warm")
    on_event("warm")
    on_event(None)


def test_build_watchdog_matches_the_jax_retrace_watchdog(monkeypatch, tmp_path):
    jdir, tdir = _trace_on(monkeypatch, tmp_path)
    warned = []
    monkeypatch.setattr(ttel._LOGGER, "warning", lambda msg, *a: warned.append(msg % a))
    monkeypatch.setenv("TPUML_TELEMETRY_RETRACE_LIMIT", "2")
    monkeypatch.setattr(ttel, "RETRACE_LIMIT", 2)
    assert ttel.install_retrace_watchdog() and ttel._on_build in _build._BUILD_LISTENERS

    def runner(tel, fire):
        def on_event(site):
            if site is None:
                fire()
                return
            with tel.span(site, **({"warmup": True} if site == "warm" else {})):
                fire()
        return on_event

    _compile_sequence(runner(jtel, lambda: jtel._on_event_duration(jtel._COMPILE_EVENT, 0.5)))
    _compile_sequence(runner(ttel, lambda: ttel._on_build("shifted_gram", 0.5)))
    names = ("xla_compiles", "xla_compile_seconds", "retrace_storms")
    jsnap, tsnap = jtel.metrics_snapshot(), ttel.metrics_snapshot()
    assert {n: tsnap[n] for n in names} == {n: jsnap[n] for n in names}
    assert tsnap["retrace_storms"]["series"][0]["value"] == 1
    assert len(warned) == 1 and "'hot'" in warned[0]


def test_a_kernel_library_load_reaches_the_watchdog(monkeypatch, tmp_path):
    """``_build.function`` tells its listeners once a library, after its
    build (a no-op here) and load (a stand-in library)."""
    monkeypatch.setattr(ttel, "TRACE_DIR", str(tmp_path))
    seen = []
    monkeypatch.setattr(_build, "_BUILD_LISTENERS", [lambda name, s: seen.append((name, s))])
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "_FUNCS", {})
    monkeypatch.setattr(_build, "build", lambda names: {n: 0.0 for n in names})

    class Fn:
        pass

    class Lib:
        entry = Fn()
        other = Fn()

    monkeypatch.setattr(ctypes, "CDLL", lambda path: Lib())
    _build.function("shifted_gram", "entry", [ctypes.c_int])
    _build.function("shifted_gram", "other", [ctypes.c_int])
    assert [n for n, _ in seen] == ["shifted_gram"] and seen[0][1] >= 0.0
    ttel.install_retrace_watchdog()
    _build.add_build_listener(ttel._on_build)
    with ttel.span("fit.dispatch"):
        _build.function("lloyd_step", "entry", [ctypes.c_int])
    assert ttel.metrics_snapshot()["xla_compiles"]["series"] == [
        {"labels": {"site": "fit.dispatch"}, "value": 1}]


def test_record_hbm_estimate_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(ttel, "TRACE_DIR", str(tmp_path))
    ttel.record_hbm_estimate("stream_stage", 3.0, torch.device("cpu"))
    snap = ttel.metrics_snapshot()
    assert snap["hbm_budget_bytes"]["series"] == [{"labels": {"site": "stream_stage"}, "value": 3.0}]
    assert "hbm_live_bytes" not in snap


def test_profiling_trace_writes_a_chrome_trace(tmp_path, caplog):
    out = tmp_path / "prof"
    with profiling.trace(str(out)):
        with profiling.annotate("phase"):
            torch.ones(64) @ torch.ones(64)
    names = os.listdir(out)
    assert names == [f"trace-{os.getpid()}.json"]
    with open(out / names[0]) as f:
        doc = json.load(f)
    assert any(e.get("name") == "phase" for e in doc["traceEvents"])
    with profiling.trace(None):
        pass
    import logging

    log = logging.getLogger("test_torch_telemetry")
    with caplog.at_level(logging.DEBUG, logger="test_torch_telemetry"):
        with profiling.timed(log, "step"):
            pass
    assert any("step took" in r.getMessage() for r in caplog.records)


def test_stage_timer_stages_are_spans(monkeypatch, tmp_path):
    monkeypatch.setattr(ttel, "TRACE_DIR", str(tmp_path))
    timer = profiling.StageTimer("umap.fit")
    with ttel.span("UMAP.fit"):
        for label in ("graph", "init", "graph"):
            with timer.stage(label):
                pass
    assert timer.counts == {"graph": 2, "init": 1}
    stats = ttel.span_stats()
    assert stats["umap.fit.graph"]["count"] == 2 and stats["umap.fit.init"]["count"] == 1
