"""Port parity: the fit scheduler (``spark_rapids_ml_tpu_torch/runtime/
scheduler.py``, ``runtime/admission.py``) and the gang entry
``core._TpuEstimator._fit_coscheduled``, against the JAX package's
``runtime.FitScheduler`` on the CPU.

The JAX side is set through ``TPUML_*`` variables (``monkeypatch.setenv``),
the port through its module constants (``runtime.faults.FAULT_SPEC``,
``runtime.checkpoint.CKPT_DIR`` / ``CKPT_EVERY``, ``core.GANG_FIT``) and
``FitScheduler``'s arguments. The sheds, drains and breakers run a
duck-typed estimator with the JAX test's ``_FakeEstimator`` surface (both
packages' stream hook names), so dispatch timing is exact and no device is
touched. The port's fits run with ``device="cpu"``.

Tolerances, each stated where it is held:

* The sheds' ``sched_shed_total`` series, the stats and the typed errors
  of one scripted sequence: equal to the JAX package's.
* A surviving tenant's model, a preempted-then-resumed streamed fit and a
  sequential coscheduled lane against the same solo fit of the port:
  equal, bit for bit (the same preprocess and fit function run in the
  same order; the carry is the whole state of a resumed loop).
* A gang lane (``core.GANG_FIT = "auto"``) against its solo fit: the JAX
  gang test's rtol 5e-3, atol 1e-5·max(1, max|coef|) with the
  iterations within 1 (LogisticRegression), rtol 1e-5 and atol 1e-8
  (LinearRegression).
"""

import os
import threading
import time

import numpy as np
import pytest

from spark_rapids_ml_tpu.runtime import FitScheduler as JFitScheduler
from spark_rapids_ml_tpu.runtime import counters as jcounters
from spark_rapids_ml_tpu.runtime import faults as jfaults
from spark_rapids_ml_tpu.runtime import opsplane as jopsplane
from spark_rapids_ml_tpu.runtime import telemetry as jtelemetry
from spark_rapids_ml_tpu_torch import DataFrame
from spark_rapids_ml_tpu_torch import core
from spark_rapids_ml_tpu_torch.classification import LogisticRegression
from spark_rapids_ml_tpu_torch.clustering import KMeans
from spark_rapids_ml_tpu_torch.regression import LinearRegression
from spark_rapids_ml_tpu_torch.runtime import (
    DeadlineExceeded,
    FitScheduler,
    Overloaded,
    ShuttingDown,
    checkpoint,
    counters,
    faults,
    scheduler,
    telemetry,
)
from spark_rapids_ml_tpu_torch.runtime.faults import InjectedFault
from spark_rapids_ml_tpu_torch.runtime.scheduler import preempt_point

_JAX_ENV = ("TPUML_SCHED_QUEUE_LIMIT", "TPUML_SCHED_QUANTUM_MS", "TPUML_SCHED_BREAKER_FAILS",
            "TPUML_SCHED_BREAKER_COOLDOWN_MS", "TPUML_SCHED_AGING_MS", "TPUML_SCHED_DEFAULT_DEADLINE_MS",
            "TPUML_CKPT_DIR", "TPUML_CKPT_EVERY", "TPUML_FAULT_SPEC", "TPUML_RETRIES", "TPUML_GANG_FIT")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in _JAX_ENV:
        monkeypatch.delenv(var, raising=False)
    for mod, name in ((faults, "FAULT_SPEC"), (checkpoint, "CKPT_DIR"), (checkpoint, "CKPT_EVERY"),
                      (core, "GANG_FIT")):
        monkeypatch.setattr(mod, name, getattr(mod, name))
    jopsplane.stop()
    for tel, fl, cnt in ((telemetry, faults, counters), (jtelemetry, jfaults, jcounters)):
        tel.reset_telemetry()
        fl.reset_faults()
        cnt.reset()
    yield
    jopsplane.stop()
    for tel, fl, cnt in ((telemetry, faults, counters), (jtelemetry, jfaults, jcounters)):
        tel.reset_telemetry()
        fl.reset_faults()
        cnt.reset()


def _wait_until(cond, timeout=30.0, interval=0.002):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return False


class _FakeEstimator:
    """Duck-typed estimator: the admission and pack-key surface of both
    packages (the JAX stream hook and the port's), no device."""

    num_workers = 1

    def __init__(self, delay_s=0.0, fail=False, result="model"):
        self.delay_s = delay_s
        self.fail = fail
        self.result = result

    def _get_input_columns(self):
        return "features", None

    def getOrDefault(self, name):  # pragma: no cover - label path unused
        return None

    def _require_label(self):
        return False

    def _get_streaming_fit_func(self, dataset):
        return None

    _get_tpu_streaming_fit_func = _get_streaming_fit_func

    def fit(self, dataset):
        time.sleep(self.delay_s)
        if self.fail:
            raise RuntimeError("injected tenant failure")
        return self.result


def _shed_reasons(tel):
    series = (tel.metrics_snapshot().get("sched_shed_total") or {}).get("series") or []
    return {(s["labels"].get("tenant"), s["labels"].get("reason")): s["value"] for s in series}


# ---------------------------------------------------------------------------
# defaults-inert
# ---------------------------------------------------------------------------


def test_defaults_inert_no_thread_no_metrics_bitwise_fit():
    X = np.random.default_rng(0).normal(size=(96, 4)).astype(np.float32)
    df = DataFrame({"features": X})
    before = {t.name for t in threading.enumerate()}
    a = KMeans(k=3, maxIter=5, seed=1, device="cpu").fit(df)
    b = KMeans(k=3, maxIter=5, seed=1, device="cpu").fit(df)
    assert a.cluster_centers_.tobytes() == b.cluster_centers_.tobytes()
    assert "fit-sched" not in {t.name for t in threading.enumerate()} - before
    assert not any(k.startswith("sched_") for k in telemetry.metrics_snapshot())
    assert (scheduler.QUEUE_LIMIT, scheduler.QUANTUM_MS, scheduler.BREAKER_FAILS, scheduler.BREAKER_COOLDOWN_MS,
            scheduler.AGING_MS, scheduler.DEFAULT_DEADLINE_MS) == (None, None, 0, 1000.0, 10000.0, None)
    # outside a scheduler quantum preempt_point does nothing, even with a
    # checkpointer-looking object
    preempt_point(object(), 3, {"w": np.zeros(2)})


def test_constants_configure_a_new_scheduler(monkeypatch):
    monkeypatch.setattr(scheduler, "QUEUE_LIMIT", 3)
    monkeypatch.setattr(scheduler, "BREAKER_FAILS", 2)
    monkeypatch.setattr(scheduler, "DEFAULT_DEADLINE_MS", 500.0)
    s = FitScheduler(breaker_cooldown_ms=50.0)
    try:
        assert (s.queue_limit, s.breaker_fails, s.breaker_cooldown_s, s._default_deadline_s) == (3, 2, 0.05, 0.5)
        assert not s.dispatcher_started()  # the thread starts with the first submit
    finally:
        s.close()


# ---------------------------------------------------------------------------
# the typed sheds, against the JAX package's
# ---------------------------------------------------------------------------


def _shed_script(Sched, tel, errors):
    """One scripted sequence of sheds through ``Sched``: queue_full,
    deadline_unmeetable, breaker_open and draining. Returns (what each step
    raised, the shed series)."""
    seen = []

    def expect(fn, exc):
        try:
            fn()
            seen.append(None)
        except exc as e:
            seen.append((type(e).__name__, getattr(e, "reason", None)))

    Overloaded_, ShuttingDown_ = errors
    with Sched(queue_limit=1, breaker_fails=2, breaker_cooldown_ms=60000) as s:
        slow = s.submit(_FakeEstimator(delay_s=0.3), object(), tenant="a")
        assert _wait_until(lambda: s.stats()["inflight"] == 1)
        queued = s.submit(_FakeEstimator(), object(), tenant="b")
        expect(lambda: s.submit(_FakeEstimator(), object(), tenant="c"), Overloaded_)
        slow.result(timeout=30)
        queued.result(timeout=30)
        for _ in range(2):
            with pytest.raises(RuntimeError):
                s.submit(_FakeEstimator(fail=True), object(), tenant="t").result(timeout=30)
        assert _wait_until(lambda: s.breaker_states().get("t") == "open")
        expect(lambda: s.submit(_FakeEstimator(), object(), tenant="t"), Overloaded_)
        assert s.fit(_FakeEstimator(), object(), tenant="u", timeout=30) == "model"
    with Sched() as s:
        s.fit(_FakeEstimator(delay_s=0.2), object(), timeout=30)  # the EWMA's first point
        busy = s.submit(_FakeEstimator(delay_s=0.3), object())
        assert _wait_until(lambda: s.stats()["inflight"] == 1)
        queued = s.submit(_FakeEstimator(delay_s=0.2), object())
        expect(lambda: s.submit(_FakeEstimator(), object(), tenant="late", deadline_ms=1.0), Overloaded_)
        busy.result(timeout=30)
        queued.result(timeout=30)
    s = Sched()
    fut = s.submit(_FakeEstimator(delay_s=0.3), object())
    shed = {}

    def draining_submit():
        assert _wait_until(s.is_draining, timeout=5)
        try:
            s.submit(_FakeEstimator(), object(), tenant="drain")
        except ShuttingDown_ as e:
            shed["exc"] = type(e).__name__

    t = threading.Thread(target=draining_submit)
    t.start()
    report = s.drain(timeout=30)
    t.join()
    seen.append(shed.get("exc"))
    assert fut.result(timeout=1) == "model" and report == {"drained": True, "aborted": 0}
    return seen, _shed_reasons(tel)


def test_typed_sheds_match_jax():
    from spark_rapids_ml_tpu.runtime import Overloaded as JOverloaded
    from spark_rapids_ml_tpu.runtime import ShuttingDown as JShuttingDown

    port = _shed_script(FitScheduler, telemetry, (Overloaded, ShuttingDown))
    jax = _shed_script(JFitScheduler, jtelemetry, (JOverloaded, JShuttingDown))
    assert port == jax
    assert port[0] == [("Overloaded", "queue_full"), ("Overloaded", "breaker_open"),
                       ("Overloaded", "deadline_unmeetable"), "ShuttingDown"]
    assert port[1] == {("c", "queue_full"): 1, ("t", "breaker_open"): 1, ("late", "deadline_unmeetable"): 1,
                       ("drain", "draining"): 1}


def test_admitted_job_missing_deadline_fails_typed():
    with FitScheduler() as sched:
        busy = sched.submit(_FakeEstimator(delay_s=0.3), object())
        assert _wait_until(lambda: sched.stats()["inflight"] == 1)
        late = sched.submit(_FakeEstimator(), object(), tenant="d", deadline_ms=50)
        with pytest.raises(DeadlineExceeded):
            late.result(timeout=30)
        busy.result(timeout=30)
        assert sched.stats()["deadline_misses"] == 1
    with pytest.raises(ValueError):
        FitScheduler().submit(_FakeEstimator(), object(), deadline_ms=0)


def test_drain_under_load_resolves_every_future():
    sched = FitScheduler()
    futs = [sched.submit(_FakeEstimator(delay_s=0.1), object(), tenant=f"t{i}") for i in range(8)]
    report = sched.drain(timeout=0.3)
    assert report["aborted"] >= 1  # 8 x 100 ms cannot finish in 300 ms
    done = aborted = 0
    for fut in futs:
        try:
            assert fut.result(timeout=5) == "model"
            done += 1
        except ShuttingDown:
            aborted += 1
    assert done + aborted == 8 and aborted == report["aborted"]
    assert report["drained"] == (aborted == 0)
    with pytest.raises(ShuttingDown):
        sched.submit(_FakeEstimator(), object())


def test_concurrent_submitters_lose_no_job():
    """More submitting threads than cores with a short switch interval:
    every admitted job resolves exactly once, and the stats add up."""
    import sys

    n_threads, per_thread = 2 * (os.cpu_count() or 4), 12
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    futs, lock = [], threading.Lock()
    try:
        with FitScheduler() as sched:
            def submitter(t):
                for i in range(per_thread):
                    f = sched.submit(_FakeEstimator(result=(t, i)), object(), tenant=f"t{t % 3}")
                    with lock:
                        futs.append(f)

            threads = [threading.Thread(target=submitter, args=(t,)) for t in range(n_threads)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60)
            assert not any(th.is_alive() for th in threads)
            results = [f.result(timeout=60) for f in futs]
            stats = sched.stats()
    finally:
        sys.setswitchinterval(prev)
    assert sorted(results) == [(t, i) for t in range(n_threads) for i in range(per_thread)]
    assert stats["dispatches"] == n_threads * per_thread and stats["queue_depth"] == 0


# ---------------------------------------------------------------------------
# fault isolation
# ---------------------------------------------------------------------------


def _fleet():
    """Five tenants, each its own dataset, so every fit dispatches solo."""
    fleet = []
    for i, (n, d, k) in enumerate([(96, 3, 2), (128, 4, 3)]):
        X = np.random.default_rng(10 + i).normal(size=(n, d)).astype(np.float32)
        fleet.append((f"kmeans-{i}", lambda k=k, i=i: KMeans(k=k, maxIter=6, seed=20 + i, device="cpu"),
                      DataFrame({"features": X}), lambda m: np.asarray(m.cluster_centers_)))
    rng = np.random.default_rng(30)
    X = rng.normal(size=(100, 4)).astype(np.float32)
    fleet.append(("linreg", lambda: LinearRegression(maxIter=40, device="cpu"),
                  DataFrame({"features": X, "label": (X @ rng.normal(size=4)).astype(np.float32)}),
                  lambda m: np.append(np.asarray(m.coefficients), m.intercept)))
    for i, (n, d) in enumerate([(120, 3), (90, 5)]):
        rng = np.random.default_rng(40 + i)
        X = rng.normal(size=(n, d)).astype(np.float32)
        y = (X[:, 0] + 0.3 * rng.normal(size=n) > 0).astype(np.float32)
        fleet.append((f"logreg-{i}", lambda: LogisticRegression(maxIter=30, device="cpu"),
                      DataFrame({"features": X, "label": y}),
                      lambda m: np.append(np.asarray(m.coefficients), m.intercept)))
    return fleet


def test_mid_fleet_fault_leaves_survivors_bitwise(monkeypatch):
    fleet = _fleet()
    solo = {name: extract(make().fit(df)) for name, make, df, extract in fleet}
    # the 3rd dispatch (hit index 2) raises inside the dispatch frame; the
    # dispatch order is the submit order (equal priority, no deadlines)
    monkeypatch.setattr(faults, "FAULT_SPEC", "sched:dispatch:2:raise")
    faults.reset_faults()
    with FitScheduler() as sched:
        futs = [(name, extract, sched.submit(make(), df, tenant=name)) for name, make, df, extract in fleet]
        for name, extract, fut in futs:
            if name == "linreg":
                with pytest.raises(InjectedFault):
                    fut.result(timeout=120)
            else:
                assert extract(fut.result(timeout=120)).tobytes() == solo[name].tobytes(), name
        stats = sched.stats()
    assert (stats["dispatches"], stats["dispatch_errors"], stats["queue_depth"], stats["inflight"]) == (4, 1, 0, 0)


# ---------------------------------------------------------------------------
# preemption and resume
# ---------------------------------------------------------------------------


def _stream_data(seed=7):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(256, 5)).astype(np.float32)
    X[:64] += 4.0
    X[64:128] -= 4.0
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.float32)
    return DataFrame({"features": X, "label": y})


@pytest.mark.parametrize("name", ["kmeans", "logreg"])
def test_preempted_fit_matches_uninterrupted_twin(monkeypatch, tmp_path, name):
    df = _stream_data()
    kw = dict(streaming=True, stream_chunk_rows=64, device="cpu")
    if name == "kmeans":
        make = lambda: KMeans(k=4, maxIter=8, tol=1e-12, seed=5, **kw)  # noqa: E731
        coef = lambda m: m.cluster_centers_  # noqa: E731
    else:
        make = lambda: LogisticRegression(maxIter=15, regParam=0.01, tol=1e-12, **kw)  # noqa: E731
        coef = lambda m: m.coefficientMatrix  # noqa: E731
    clean = make().fit(df)
    monkeypatch.setattr(checkpoint, "CKPT_DIR", str(tmp_path))
    monkeypatch.setattr(checkpoint, "CKPT_EVERY", 1)
    base = counters.snapshot()
    with FitScheduler(quantum_ms=1.0) as sched:
        model = sched.fit(make(), df, tenant="preemptee", timeout=300)
        stats = sched.stats()
    assert stats["preemptions"] >= 1 and stats["resumes"] == stats["preemptions"] and stats["dispatches"] == 1
    delta = counters.delta_since(base)
    assert delta.get("resumed_fits", 0) == stats["resumes"]
    assert coef(model).tobytes() == coef(clean).tobytes()
    assert os.listdir(tmp_path) == []
    series = telemetry.metrics_snapshot()
    assert series["sched_preemptions_total"]["series"][0]["value"] == stats["preemptions"]
    # without a checkpoint directory a quantum preempts nothing
    monkeypatch.setattr(checkpoint, "CKPT_DIR", None)
    with FitScheduler(quantum_ms=1.0) as sched:
        again = sched.fit(make(), df, timeout=300)
        assert sched.stats()["preemptions"] == 0
    assert coef(again).tobytes() == coef(clean).tobytes()


def test_gbt_preempted_through_the_scheduler_matches_uninterrupted(monkeypatch, tmp_path):
    from spark_rapids_ml_tpu_torch import GBTClassifier

    rng = np.random.default_rng(3)
    X = rng.normal(size=(256, 6)).astype(np.float32)
    df = DataFrame({"features": X, "label": (1.3 * X[:, 0] - 0.8 * X[:, 2] > 0).astype(np.float32)})
    make = lambda: GBTClassifier(maxIter=6, maxDepth=3, seed=11, device="cpu")  # noqa: E731
    clean = make().fit(df)
    monkeypatch.setattr(checkpoint, "CKPT_DIR", str(tmp_path))
    with FitScheduler(quantum_ms=1.0) as sched:
        model = sched.fit(make(), df, timeout=300)
        assert sched.stats()["preemptions"] >= 1
    for k in ("features", "threshold_bins", "leaf_values"):
        assert model._model_attributes[k].tobytes() == clean._model_attributes[k].tobytes(), k


# ---------------------------------------------------------------------------
# elastic gang packing through _fit_coscheduled
# ---------------------------------------------------------------------------


def _spy(monkeypatch, cls):
    gangs = []
    real = cls._fit_coscheduled

    def spy(self, dataset, estimators):
        gangs.append(len(estimators))
        return real(self, dataset, estimators)

    monkeypatch.setattr(cls, "_fit_coscheduled", spy)
    return gangs


def _held(sched, jobs, df):
    """Hold the dispatcher on a fake job so ``jobs`` sit in the backlog
    together, then submit them: their futures."""
    busy = sched.submit(_FakeEstimator(delay_s=0.3), object())
    assert _wait_until(lambda: sched.stats()["inflight"] == 1)
    futs = [sched.submit(est, df, tenant=f"g{i}") for i, est in enumerate(jobs)]
    busy.result(timeout=30)
    return futs


def test_pack_compatible_jobs_gang_through_one_coscheduled_pass(monkeypatch):
    X = np.random.default_rng(9).normal(size=(128, 4)).astype(np.float32)
    df = DataFrame({"features": X})
    gangs = _spy(monkeypatch, KMeans)
    solo = [KMeans(k=k, maxIter=6, seed=2, device="cpu").fit(df) for k in (3, 4)]
    assert gangs == []  # direct fits never take the coscheduled path
    with FitScheduler() as sched:
        futs = _held(sched, [KMeans(k=k, maxIter=6, seed=2, device="cpu") for k in (3, 4)], df)
        models = [f.result(timeout=120) for f in futs]
        stats = sched.stats()
    assert gangs == [2] and stats["dispatches"] == 3
    for m, s in zip(models, solo):
        assert m.cluster_centers_.tobytes() == s.cluster_centers_.tobytes()


@pytest.mark.parametrize("cls", ["logreg", "linreg"])
def test_gang_lanes_of_one_pack_key(monkeypatch, cls):
    rng = np.random.default_rng(4)
    X = rng.normal(size=(300, 6)).astype(np.float32)
    if cls == "logreg":
        y = (X @ rng.normal(size=6) + 0.3 * rng.normal(size=300) > 0).astype(np.float32)
        Est, regs = LogisticRegression, [1e-4, 1e-3, 1e-2, 1e-1]
        make = lambda r: Est(maxIter=30, tol=1e-5, regParam=r, device="cpu")  # noqa: E731
    else:
        y = (X @ rng.normal(size=6) + 0.1 * rng.normal(size=300)).astype(np.float32)
        Est, regs = LinearRegression, [0.01, 0.02, 0.05, 0.1]
        make = lambda r: Est(maxIter=300, tol=1e-10, regParam=r, elasticNetParam=0.5, device="cpu")  # noqa: E731
    df = DataFrame({"features": X, "label": y})
    solo = [make(r).fit(df) for r in regs]
    gangs = _spy(monkeypatch, Est)
    monkeypatch.setattr(core, "GANG_FIT", "auto")
    with FitScheduler() as sched:
        models = [f.result(timeout=120) for f in _held(sched, [make(r) for r in regs], df)]
    assert gangs == [4]
    for m, s in zip(models, solo):
        assert m._fit_report.get("gang_lanes") == 4
        a, b = np.asarray(m.coefficients), np.asarray(s.coefficients)
        if cls == "logreg":
            np.testing.assert_allclose(a, b, rtol=5e-3, atol=1e-5 * max(1.0, np.abs(b).max()))
            assert abs(m.n_iter_ - s.n_iter_) <= 1
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("split", ["device", "weight", "float64"])
def test_lanes_that_preprocess_apart_never_gang(monkeypatch, split):
    """Two lanes on one dataset that differ in device, weight column or
    ``float32_inputs`` preprocess apart, so they dispatch solo and each
    equals its solo fit (on a host without a card, the default-device
    lane fails as its solo fit does)."""
    rng = np.random.default_rng(5)
    X = rng.normal(size=(200, 5))
    y = X @ rng.normal(size=5) + 0.1 * rng.normal(size=200)
    df = DataFrame({"features": X, "label": y, "w": rng.uniform(0.1, 2.0, 200)})
    second = {"device": {"device": None}, "weight": {"weightCol": "w", "device": "cpu"},
              "float64": {"float32_inputs": False, "device": "cpu"}}[split]
    # streaming=False: the resident path, decided without resolving the device
    make = [lambda: LinearRegression(regParam=0.01, streaming=False, device="cpu"),
            lambda: LinearRegression(regParam=0.02, streaming=False, **second)]

    def outcome(fit):
        try:
            return np.asarray(fit().coefficients).tobytes()
        except Exception as e:  # the default device without a card
            return type(e)

    solo = [outcome(lambda mk=mk: mk().fit(df)) for mk in make]
    assert solo[0] != solo[1]
    gangs = _spy(monkeypatch, LinearRegression)
    monkeypatch.setattr(core, "GANG_FIT", "auto")
    with FitScheduler() as sched:
        futs = _held(sched, [mk() for mk in make], df)
        got = [outcome(lambda f=f: f.result(timeout=120)) for f in futs]
    assert gangs == []
    assert got == solo


def test_a_gang_failing_as_a_unit_is_redispatched_solo(monkeypatch):
    X = np.random.default_rng(9).normal(size=(128, 4)).astype(np.float32)
    df = DataFrame({"features": X})
    solo = [KMeans(k=k, maxIter=6, seed=2, device="cpu").fit(df) for k in (2, 3, 4)]
    gangs = _spy(monkeypatch, KMeans)
    # the held fake's dispatch is hit 0, the gang's hit 1 (raised), the
    # solo re-dispatches hits 2-4
    monkeypatch.setattr(faults, "FAULT_SPEC", "sched:dispatch:1:raise")
    faults.reset_faults()
    with FitScheduler() as sched:
        futs = _held(sched, [KMeans(k=k, maxIter=6, seed=2, device="cpu") for k in (2, 3, 4)], df)
        models = [f.result(timeout=120) for f in futs]
        assert sched.drain(timeout=30) == {"drained": True, "aborted": 0}
    assert gangs == []  # the fault fired before the gang's pass
    for m, s in zip(models, solo):
        assert m.cluster_centers_.tobytes() == s.cluster_centers_.tobytes()


def test_coscheduled_root_span(monkeypatch, tmp_path):
    """One root ``KMeans.fit`` with ``coscheduled=2``, one preprocess, a
    dispatch a lane, each lane's model from its own estimator."""
    import glob
    import json

    monkeypatch.setattr(telemetry, "TRACE_DIR", str(tmp_path))
    X = np.random.default_rng(9).normal(size=(128, 4)).astype(np.float32)
    df = DataFrame({"features": X})
    ests = [KMeans(k=k, maxIter=3, seed=2, device="cpu") for k in (2, 3)]
    models = ests[0]._fit_coscheduled(df, ests)
    assert [m.cluster_centers_.shape[0] for m in models] == [2, 3]
    (trace,) = glob.glob(os.path.join(str(tmp_path), "trace-*.json"))
    with open(trace) as f:
        xs = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    roots = [e for e in xs if "parent_id" not in e["args"]]
    assert [(e["name"], e["args"].get("coscheduled")) for e in roots] == [("KMeans.fit", 2)]
    names = [e["name"] for e in xs]
    assert names.count("preprocess") == 1 and names.count("fit.dispatch") == 2
