"""Elastic multi-tenant fit scheduler: preemptible, fault-isolated
fits-as-a-service (counterpart of ``spark_rapids_ml_tpu/runtime/
scheduler.py``).

A :class:`FitScheduler` accepts asynchronous fit jobs (estimator +
dataset + optional tenant/priority/deadline) and runs them through one
dispatcher thread under four contracts:

- **Admission control** — the submit-time gate uses the shared primitives
  of :mod:`runtime.admission`: a bounded queue (:data:`QUEUE_LIMIT`), a
  per-tenant consecutive-failure breaker (:data:`BREAKER_FAILS`), and an
  EWMA-of-fit-time shed when a deadline is already unmeetable. Every
  rejection is a typed :class:`Overloaded` / :class:`DeadlineExceeded` /
  :class:`ShuttingDown` and a ``sched_shed_total{tenant,reason}``
  increment — never a hang.
- **Elastic gang packing** — queued jobs sharing (dataset, estimator
  class, input columns) are dispatched as one pass through
  ``_TpuEstimator._fit_coscheduled``: a single preprocess copying the
  rows to the card once, and — when ``core.GANG_FIT`` is on and the
  estimator has a gang path — batched lanes through ``_gang_dispatch``.
  Ordering is earliest-deadline-first with aging (:data:`AGING_MS`): a
  deadline-free job is treated as due ``aging_ms`` after submit, so a
  stream of urgent fits can overtake a large gang but can never starve
  anyone.
- **Preemption / resume** — with :data:`QUANTUM_MS` set *and*
  checkpointing enabled (``runtime.checkpoint.CKPT_DIR``), an iterative
  fit whose quantum expires checkpoints at its next iteration boundary
  (the solvers call :func:`preempt_point` right after their
  ``FitCheckpointer.maybe_save`` site), yields the card via the
  :class:`FitPreempted` control-flow signal, and is re-queued; the
  resumed dispatch restores through the same checkpoint, so a
  preempted-then-resumed fit walks the iterates of its uninterrupted
  twin. Every dispatch completes at least one iteration before the first
  yield point, so progress is guaranteed.
- **Fault isolation** — a tenant whose fit raises (or hits an injected
  ``sched:*`` fault) fails alone: a gang that errors as a unit is
  re-dispatched lane by lane so surviving tenants still get their
  (solo-equal) results, the faulty tenant's future carries the typed
  error, its breaker absorbs repeat offenders, and ``drain(timeout)``
  resolves every pending future.

The dispatcher runs one fit at a time, as in the JAX package: the
streamed path's ingest report and the staging ring assume one fit at a
time. Before each dispatch it makes the estimator's card the thread's
current device (the staging ring's copy stream is per device).

The settings are module constants with the JAX package's defaults (its
``TPUML_SCHED_*`` variables); a constructor argument overrides each. The
ops plane's drain of live schedulers on SIGTERM and its ``/statusz``
section come with ROADMAP queue 1 item 7d; the dispatcher keeps the
``loop_heartbeat_ts{loop="fit_sched"}`` gauge it would read.

Defaults-inert: with no explicitly constructed ``FitScheduler`` there is
no thread, no new metric series, and a direct ``.fit()`` is the same as
without this module — :func:`preempt_point` is a single thread-local read
on the non-scheduled path.
"""

from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple, Union

from . import faults, lockwitness, telemetry
from .admission import (
    CircuitBreaker,
    DeadlineExceeded,
    Overloaded,
    ServiceEwma,
    ShuttingDown,
)

__all__ = [
    "FitScheduler",
    "FitPreempted",
    "preempt_point",
    "DeadlineExceeded",
    "Overloaded",
    "ShuttingDown",
]

logger = logging.getLogger("spark_rapids_ml_tpu_torch.runtime.scheduler")

# the JAX package's TPUML_SCHED_QUEUE_LIMIT (None: unbounded),
# TPUML_SCHED_QUANTUM_MS (None: fits run to completion), TPUML_SCHED_
# BREAKER_FAILS (0: no breaker), TPUML_SCHED_BREAKER_COOLDOWN_MS,
# TPUML_SCHED_AGING_MS and TPUML_SCHED_DEFAULT_DEADLINE_MS (None: no
# deadline)
QUEUE_LIMIT: Optional[int] = None
QUANTUM_MS: Optional[float] = None
BREAKER_FAILS = 0
BREAKER_COOLDOWN_MS = 1000.0
AGING_MS = 10000.0
DEFAULT_DEADLINE_MS: Optional[float] = None

# dispatcher wakes at least this often while idle so the
# loop_heartbeat_ts{loop="fit_sched"} age stays a liveness signal
_IDLE_TICK_S = 1.0


def _device_of(estimator: Any) -> Any:
    """The device the estimator names (``cuda:0`` where it names none),
    without checking that a card is present."""
    import torch

    dev = getattr(estimator, "_device", None)
    return torch.device("cuda:0" if dev is None else dev)


def _bind_device(estimator: Any) -> None:
    """Make the estimator's card the dispatcher thread's current device;
    nothing for a CPU estimator."""
    import torch

    dev = _device_of(estimator)
    if dev.type == "cuda" and torch.cuda.is_available():
        torch.cuda.set_device(dev)


class FitPreempted(BaseException):
    """Control-flow signal: a scheduled fit checkpointed and yielded at
    a quantum boundary.

    Deliberately a ``BaseException``: it must sail through every
    ``except Exception`` on the way out of a solver (retry wrappers,
    crash-proof loops, telemetry spans) exactly like a
    ``KeyboardInterrupt`` would — only the scheduler's dispatch frame
    catches it, bumps ``sched_preemptions_total``, and re-queues the
    job. It never escapes :class:`FitScheduler`.
    """

    def __init__(self, iteration: int) -> None:
        super().__init__(f"fit preempted at iteration {iteration}")
        self.iteration = int(iteration)


# quantum state for the dispatcher thread; solvers observe it through
# preempt_point() only, so the non-scheduled path costs one getattr
_tls = threading.local()


class _Quantum:
    __slots__ = ("deadline",)

    def __init__(self, deadline: float) -> None:
        self.deadline = deadline


def preempt_point(
    checkpointer: Any,
    iteration: int,
    arrays: Union[Mapping[str, Any], Callable[[], Mapping[str, Any]]],
    extra: Optional[Mapping[str, Any]] = None,
) -> None:
    """Cooperative yield hook for iterative solvers.

    Called at each iteration boundary, right after the solver's
    ``FitCheckpointer.maybe_save`` site, with the same state that site
    would persist (``arrays`` may be a zero-arg callable so the host
    transfer is only paid when actually preempting). No-op unless ALL
    of: the calling thread is inside a scheduler quantum, the quantum
    has expired, and the checkpointer is enabled (nowhere to save ==
    run to completion). When it fires it force-saves at ``iteration``
    (bypassing the ``every`` stride — the resume point must be the
    exact iteration the fit yielded at) and raises
    :class:`FitPreempted`.
    """
    q = getattr(_tls, "quantum", None)
    if q is None or time.monotonic() < q.deadline:
        return
    if checkpointer is None or not getattr(checkpointer, "enabled", False):
        return
    faults.fault_site("sched:preempt")
    state = arrays() if callable(arrays) else arrays
    checkpointer.save(iteration, state, extra)
    raise FitPreempted(iteration)


@dataclass
class _Job:
    estimator: Any
    dataset: Any
    future: "Future[Any]"
    tenant: str
    priority: int
    seq: int
    pack_key: Tuple[Any, ...]
    service_key: str
    t_submit: float = field(default_factory=time.perf_counter)
    deadline: Optional[float] = None  # absolute perf_counter seconds
    aging_s: Optional[float] = None  # per-job override of the
    # scheduler-wide aging horizon (background refits age slower)
    resumed: bool = False
    preempt_count: int = 0
    settled: bool = False

    def effective_due(self, aging_s: float) -> float:
        # EDF with aging: a deadline-free job is ordered as if due
        # aging_s after submit, so it can be overtaken but not starved
        if self.deadline is not None:
            return self.deadline
        if self.aging_s is not None:
            aging_s = self.aging_s
        return self.t_submit + aging_s


class FitScheduler:
    """Fits-as-a-service over one card: bounded admission, EDF
    ordering with aging, elastic gang packing, quantum preemption, and
    per-tenant fault isolation.

    Explicit-construction only — building this object is the opt-in.
    ``with FitScheduler() as sched: sched.submit(est, df).result()``.
    """

    def __init__(
        self,
        queue_limit: Optional[int] = None,
        quantum_ms: Optional[float] = None,
        breaker_fails: Optional[int] = None,
        breaker_cooldown_ms: Optional[float] = None,
        aging_ms: Optional[float] = None,
        default_deadline_ms: Optional[float] = None,
    ) -> None:
        queue_limit = QUEUE_LIMIT if queue_limit is None else queue_limit
        self.queue_limit = None if queue_limit is None else int(queue_limit)
        quantum_ms = QUANTUM_MS if quantum_ms is None else quantum_ms
        self._quantum_s = None if quantum_ms is None else float(quantum_ms) / 1e3
        self.breaker_fails = int(BREAKER_FAILS if breaker_fails is None else breaker_fails)
        self.breaker_cooldown_s = float(
            BREAKER_COOLDOWN_MS if breaker_cooldown_ms is None else breaker_cooldown_ms
        ) / 1e3
        self._aging_s = float(AGING_MS if aging_ms is None else aging_ms) / 1e3
        default_deadline_ms = (
            DEFAULT_DEADLINE_MS if default_deadline_ms is None else default_deadline_ms
        )
        if default_deadline_ms is not None:
            default_deadline_ms = float(default_deadline_ms)
        self._default_deadline_s = (
            None if default_deadline_ms is None else default_deadline_ms / 1e3
        )
        self._lock = lockwitness.make_lock("scheduler.state")
        self._cv = lockwitness.make_condition(
            "scheduler.state", lock=self._lock
        )
        self._block = lockwitness.make_lock("scheduler.breakers")
        self._backlog: List[_Job] = []
        self._inflight: List[_Job] = []
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        self._draining = False
        self._pending = 0  # admitted, unresolved futures
        self._seq = 0
        self._last_beat: Optional[float] = None
        self._service = ServiceEwma()
        self._breakers: Dict[str, CircuitBreaker] = {}
        # lifetime totals for stats()
        self._n_dispatches = 0
        self._n_preemptions = 0
        self._n_resumes = 0
        self._n_dispatch_errors = 0
        self._n_deadline_misses = 0
        self._n_sheds = 0
        self._busy_s = 0.0
        self._t_start = time.monotonic()

    # -- lifecycle ---------------------------------------------------------
    def __enter__(self) -> "FitScheduler":
        self.start()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    def start(self) -> None:
        # the JAX package registers the scheduler with its ops plane here
        # (/statusz, /readyz, the SIGTERM drain): ROADMAP queue 1 item 7d
        with self._lock:
            if self._thread is not None or self._closed:
                return
            self._thread = threading.Thread(
                target=telemetry.bind_context(self._sched_loop),
                name="fit-sched",
                daemon=True,
            )
            self._thread.start()

    def close(self) -> None:
        """Stop immediately: no new admissions, the dispatcher exits
        after the job it is on, anything still queued resolves with
        :class:`ShuttingDown`. Use :meth:`drain` to finish queued work
        first."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._cv.notify_all()
            t = self._thread
        if t is not None:
            t.join()
        self._abort_outstanding()

    def drain(self, timeout: float = 30.0) -> Dict[str, Any]:
        """Graceful shutdown: stop admission (new submits raise
        :class:`ShuttingDown`), let the
        dispatcher finish everything already admitted, then close. Any
        job still unresolved at ``timeout`` — including one wedged
        inside a device call — is failed with :class:`ShuttingDown`;
        this never hangs past the timeout and never strands a future."""
        with self._lock:
            if self._closed:
                return {"drained": True, "aborted": 0}
            self._draining = True
            t = self._thread
        deadline = time.monotonic() + max(0.0, float(timeout))
        with self._cv:
            while self._pending > 0 and not self._closed:
                remain = deadline - time.monotonic()
                if remain <= 0:
                    break
                self._cv.wait(min(remain, 0.1))
        with self._lock:
            if self._closed:  # lost a race against close()/second drain
                return {"drained": True, "aborted": 0}
            self._closed = True
            self._cv.notify_all()
        if t is not None:
            # bounded join: a dispatcher wedged in a device call must
            # not turn drain into the hang it exists to prevent
            t.join(timeout=max(0.5, deadline - time.monotonic() + 0.5))
        aborted = self._abort_outstanding()
        return {"drained": aborted == 0, "aborted": aborted}

    def _abort_outstanding(self) -> int:
        """Resolve every still-unsettled job (queued or in-flight) with
        :class:`ShuttingDown`. Safe against the dispatcher racing a
        late resolution — ``_settle`` is first-writer-wins."""
        with self._lock:
            backlog, self._backlog = self._backlog, []
            inflight = list(self._inflight)
        n = 0
        for job in backlog:
            if self._settle(
                job,
                exc=ShuttingDown(
                    "FitScheduler is closed; fit aborted before dispatch"
                ),
            ):
                n += 1
        for job in inflight:
            if self._settle(
                job,
                exc=ShuttingDown(
                    "FitScheduler is closed; fit aborted mid-dispatch"
                ),
            ):
                n += 1
        return n

    # -- submit surface ----------------------------------------------------
    def submit(
        self,
        estimator: Any,
        dataset: Any,
        *,
        tenant: str = "default",
        priority: int = 0,
        deadline_ms: Optional[float] = None,
        aging_ms: Optional[float] = None,
    ) -> "Future[Any]":
        """Enqueue one fit; the future resolves to the fitted model
        (what ``estimator.fit(dataset)`` would return) or raises the
        typed admission/dispatch error.

        ``deadline_ms`` (default :data:`DEFAULT_DEADLINE_MS`;
        unset = wait forever) bounds total latency: admission sheds
        with :class:`Overloaded` when the EWMA fit-time estimate says
        the deadline is unmeetable, and an admitted job whose deadline
        passes before dispatch fails with :class:`DeadlineExceeded`.
        Higher ``priority`` wins ties between equally-due jobs.
        ``aging_ms`` overrides :data:`AGING_MS` for this job
        only — background work (lifecycle refresh re-fits) passes a
        long horizon so it ages toward the EDF front slower than
        interactive fits but still cannot starve."""
        if self._closed:
            raise ShuttingDown("FitScheduler is closed")
        self.start()
        if deadline_ms is not None and deadline_ms <= 0:
            raise ValueError(f"deadline_ms must be > 0, got {deadline_ms}")
        deadline_s = (
            self._default_deadline_s if deadline_ms is None
            else deadline_ms / 1e3
        )
        service_key = type(estimator).__name__
        pack_key = self._pack_key(estimator, dataset)
        now = time.perf_counter()
        fut: "Future[Any]" = Future()
        # admission and enqueue are one atomic step against close():
        # once _closed is set under this lock, nothing lands behind it
        with self._lock:
            if self._closed:
                raise ShuttingDown("FitScheduler is closed")
            if self._draining:
                self._count_shed(tenant, "draining")
                raise ShuttingDown(
                    "FitScheduler is closed to new fits (draining)"
                )
            if not self.breaker(tenant).allow():
                self._shed(
                    tenant, "breaker_open",
                    f"circuit breaker open for tenant {tenant!r} "
                    f"(cooldown {self.breaker_cooldown_s * 1e3:.0f} ms)",
                )
            depth = len(self._backlog)
            if self.queue_limit is not None and depth >= self.queue_limit:
                self._shed(
                    tenant, "queue_full",
                    f"fit queue full ({depth} >= "
                    f"queue_limit={self.queue_limit})",
                )
            if deadline_s is not None:
                est = self._service.estimated_wait_s(service_key, depth)
                if est is not None and est > deadline_s:
                    self._shed(
                        tenant, "deadline_unmeetable",
                        f"estimated wait {est * 1e3:.1f} ms exceeds "
                        f"deadline {deadline_s * 1e3:.1f} ms for "
                        f"tenant {tenant!r} ({service_key})",
                    )
            faults.fault_site("sched:admit")
            self._seq += 1
            job = _Job(
                estimator=estimator,
                dataset=dataset,
                future=fut,
                tenant=tenant,
                priority=int(priority),
                seq=self._seq,
                pack_key=pack_key,
                service_key=service_key,
                t_submit=now,
                deadline=None if deadline_s is None else now + deadline_s,
                aging_s=None if aging_ms is None else float(aging_ms) / 1e3,
            )
            self._pending += 1
            self._backlog.append(job)
            self._cv.notify_all()
        return fut

    def fit(
        self,
        estimator: Any,
        dataset: Any,
        *,
        tenant: str = "default",
        priority: int = 0,
        deadline_ms: Optional[float] = None,
        timeout: Optional[float] = None,
    ) -> Any:
        return self.submit(
            estimator, dataset,
            tenant=tenant, priority=priority, deadline_ms=deadline_ms,
        ).result(timeout)

    @staticmethod
    def _pack_key(estimator: Any, dataset: Any) -> Tuple[Any, ...]:
        """Jobs are gang-packable iff they would preprocess to the same
        resident FitInputs: same dataset object, estimator class, input
        columns, label column, worker count, device, weight column and
        ``float32_inputs``, and a non-streaming path (streamed fits
        dispatch solo — they are the preemptible ones). The gang's one
        preprocess binds the first lane's device, weights and dtype, so
        lanes that differ in any of them dispatch apart (the JAX
        package's key leaves these three out)."""
        ic, ics = estimator._get_input_columns()
        label = (
            estimator.getOrDefault("labelCol")
            if estimator._require_label() else None
        )
        stream_func = estimator._get_streaming_fit_func(dataset)
        streaming = (
            stream_func is not None and estimator._should_stream(dataset)
        )
        weight_col = getattr(estimator, "_resolved_weight_col", lambda: None)()
        return (
            id(dataset), type(estimator), ic,
            tuple(ics) if ics else None, label,
            estimator.num_workers, str(_device_of(estimator)), weight_col,
            bool(getattr(estimator, "_float32_inputs", True)), bool(streaming),
        )

    # -- admission helpers -------------------------------------------------
    def _count_shed(self, tenant: str, reason: str) -> None:
        self._n_sheds += 1
        telemetry.counter("sched_shed_total").inc(
            1, tenant=tenant, reason=reason
        )

    def _shed(self, tenant: str, reason: str, message: str) -> None:
        self._count_shed(tenant, reason)
        raise Overloaded(message, reason=reason)

    def breaker(self, tenant: str) -> CircuitBreaker:
        with self._block:
            b = self._breakers.get(tenant)
            if b is None:
                b = CircuitBreaker(
                    tenant,
                    self.breaker_fails,
                    self.breaker_cooldown_s,
                    on_state=lambda state, _t=tenant: telemetry.gauge(
                        "sched_breaker_state"
                    ).set(state, tenant=_t),
                )
                self._breakers[tenant] = b
            return b

    def breaker_states(self) -> Dict[str, str]:
        with self._block:
            breakers = dict(self._breakers)
        return {t: b.state_name() for t, b in breakers.items()}

    # -- introspection (ops plane) ----------------------------------------
    def is_closed(self) -> bool:
        return self._closed

    def is_draining(self) -> bool:
        return self._draining and not self._closed

    def dispatcher_alive(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def dispatcher_started(self) -> bool:
        return self._thread is not None

    def heartbeat_age_s(self) -> Optional[float]:
        beat = self._last_beat
        return None if beat is None else max(0.0, time.monotonic() - beat)

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._backlog)

    def stats(self) -> Dict[str, Any]:
        """Lifetime scheduler state."""
        elapsed = max(time.monotonic() - self._t_start, 1e-9)
        with self._lock:
            return {
                "queue_depth": len(self._backlog),
                "inflight": len(self._inflight),
                "dispatches": self._n_dispatches,
                "preemptions": self._n_preemptions,
                "resumes": self._n_resumes,
                "dispatch_errors": self._n_dispatch_errors,
                "deadline_misses": self._n_deadline_misses,
                "sheds": self._n_sheds,
                "occupancy": round(min(self._busy_s / elapsed, 1.0), 4),
            }

    # -- settlement --------------------------------------------------------
    def _settle(
        self,
        job: _Job,
        *,
        result: Any = None,
        exc: Optional[BaseException] = None,
    ) -> bool:
        """Resolve a job exactly once (first writer wins) and release
        its slot in the pending count."""
        with self._cv:
            if job.settled:
                return False
            job.settled = True
            self._pending -= 1
            if self._pending <= 0:
                self._cv.notify_all()
        try:
            if exc is not None:
                job.future.set_exception(exc)
            else:
                job.future.set_result(result)
        except Exception:  # future cancelled by the caller: settled anyway
            pass
        return True

    # -- dispatcher --------------------------------------------------------
    def _beat(self) -> None:
        self._last_beat = time.monotonic()
        telemetry.gauge("loop_heartbeat_ts").set(
            self._last_beat, loop="fit_sched"
        )

    def _sched_loop(self) -> None:
        # crash-proof: an exception escaping a tick fails at most that
        # tick's jobs (handled in the dispatch frames); anything
        # escaping even that is counted and the loop restarts — the
        # scheduler never dies silently while submit keeps enqueueing
        while True:
            try:
                if self._sched_tick():
                    return
            except FitPreempted:  # pragma: no cover - dispatch frame bug net
                telemetry.counter("sched_dispatch_errors_total").inc()
                logger.exception(
                    "scheduler: FitPreempted escaped a dispatch frame"
                )
            except Exception:
                telemetry.counter("sched_dispatch_errors_total").inc()
                logger.exception(
                    "scheduler: tick failed — restarting loop"
                )

    def _sched_tick(self) -> bool:
        """One select-pack-dispatch cycle; True = shutdown."""
        self._beat()
        with self._cv:
            if not self._backlog and not self._closed:
                self._cv.wait(_IDLE_TICK_S)
            if self._closed:
                return True
            if not self._backlog:
                return False
            group, missed = self._select_group_locked()
            self._inflight = group
            telemetry.gauge("sched_queue_depth").set(len(self._backlog))
            telemetry.gauge("sched_inflight").set(len(group))
        # settle deadline-missed jobs OUTSIDE the lock (_settle takes it)
        for job, msg in missed:
            self._n_deadline_misses += 1
            telemetry.counter("sched_deadline_miss_total").inc(
                1, tenant=job.tenant
            )
            self._settle(job, exc=DeadlineExceeded(msg))
        t0 = time.monotonic()
        try:
            if group:
                if len(group) == 1:
                    self._dispatch_solo(group[0])
                else:
                    self._dispatch_group(group)
        finally:
            self._busy_s += time.monotonic() - t0
            with self._lock:
                self._inflight = []
                telemetry.gauge("sched_inflight").set(0)
        return False

    def _select_group_locked(self) -> Tuple[List[_Job], List[Tuple[_Job, str]]]:
        """Pick the next dispatch under the lock: order the backlog
        EDF-with-aging (stable by priority then arrival), collect jobs
        whose deadline already passed or cannot make the EWMA estimate
        (the caller fails them with ``DeadlineExceeded`` after
        releasing the lock — ``_settle`` re-takes it), then take the
        head job plus every backlog job sharing its pack key (the
        elastic gang)."""
        self._backlog.sort(
            key=lambda j: (j.effective_due(self._aging_s), -j.priority, j.seq)
        )
        now = time.perf_counter()
        live: List[_Job] = []
        missed: List[Tuple[_Job, str]] = []
        for job in self._backlog:
            if job.deadline is None:
                live.append(job)
                continue
            remain = job.deadline - now
            est = self._service.estimate_s(job.service_key)
            if remain <= 0:
                msg = (
                    f"deadline expired {-remain * 1e3:.1f} ms before "
                    f"dispatch (tenant {job.tenant!r})"
                )
            elif est is not None and remain < est:
                msg = (
                    f"remaining deadline {remain * 1e3:.1f} ms is under "
                    f"the estimated fit time {est * 1e3:.1f} ms "
                    f"(tenant {job.tenant!r})"
                )
            else:
                live.append(job)
                continue
            missed.append((job, msg))
        self._backlog = live
        if not live:
            return [], missed
        head = live[0]
        # a resumed (previously preempted) job always dispatches solo:
        # its checkpoint restore must not be tied to gang lane order
        if head.resumed or head.pack_key[-1]:  # [-1] == streaming flag
            group = [head]
        else:
            group = [
                j for j in live
                if j.pack_key == head.pack_key and not j.resumed
            ]
        taken = set(id(j) for j in group)
        self._backlog = [j for j in live if id(j) not in taken]
        return group, missed

    def _requeue(self, job: _Job) -> None:
        with self._cv:
            closed = self._closed
            if not closed:
                self._backlog.append(job)
                self._cv.notify_all()
        if closed:
            # close() already swept _inflight or will; make sure a
            # preempted job racing shutdown still resolves
            self._settle(
                job,
                exc=ShuttingDown(
                    "FitScheduler is closed; preempted fit not resumed"
                ),
            )

    def _dispatch_solo(self, job: _Job) -> None:
        if job.resumed:
            faults.fault_site("sched:resume")
            self._n_resumes += 1
            telemetry.counter("sched_resumes_total").inc()
        quantum = self._quantum_s
        t0 = time.perf_counter()
        try:
            faults.fault_site("sched:dispatch")
            if quantum is not None:
                _tls.quantum = _Quantum(time.monotonic() + quantum)
            try:
                _bind_device(job.estimator)
                with telemetry.span(
                    "sched.dispatch", tenant=job.tenant,
                    algo=job.service_key, resumed=job.resumed,
                ):
                    model = job.estimator.fit(job.dataset)
            finally:
                _tls.quantum = None
        except FitPreempted as p:
            self._n_preemptions += 1
            job.preempt_count += 1
            job.resumed = True
            telemetry.counter("sched_preemptions_total").inc()
            telemetry.add_span_event(
                "sched_preempted", tenant=job.tenant, iteration=p.iteration,
                count=job.preempt_count,
            )
            self._requeue(job)
            return
        except Exception as e:
            self.breaker(job.tenant).record_failure()
            self._n_dispatch_errors += 1
            telemetry.counter("sched_dispatch_errors_total").inc()
            logger.exception(
                "scheduler: fit failed for tenant %r (%s)",
                job.tenant, job.service_key,
            )
            self._settle(job, exc=e)
            return
        self._n_dispatches += 1
        self.breaker(job.tenant).record_success()
        self._service.note(job.service_key, time.perf_counter() - t0, 1)
        self._finish(job, model)

    def _dispatch_group(self, jobs: List[_Job]) -> None:
        """One coscheduled pass for a gang of pack-compatible jobs:
        one preprocess, gang-batched lanes when the kernel supports
        it. Isolation contract: if the gang fails as a *unit* (one bad
        lane poisons the shared dispatch, or an injected fault fires
        at gang granularity), every lane is re-dispatched solo so
        surviving tenants still get results bit-identical to their
        solo fits and only the faulty tenant sees the error."""
        est0 = jobs[0].estimator
        t0 = time.perf_counter()
        try:
            faults.fault_site("sched:dispatch")
            _bind_device(est0)
            with telemetry.span(
                "sched.gang", lanes=len(jobs), algo=jobs[0].service_key,
            ):
                models = est0._fit_coscheduled(
                    jobs[0].dataset, [j.estimator for j in jobs]
                )
        except Exception:
            logger.exception(
                "scheduler: %d-lane gang failed — re-dispatching lanes "
                "solo for fault isolation", len(jobs),
            )
            telemetry.add_span_event(
                "sched_gang_isolated", lanes=len(jobs),
            )
            for job in jobs:
                if not job.settled:
                    self._dispatch_solo(job)
            return
        self._n_dispatches += len(jobs)
        self._service.note(
            jobs[0].service_key, time.perf_counter() - t0, len(jobs)
        )
        for job, model in zip(jobs, models):
            self.breaker(job.tenant).record_success()
            self._finish(job, model)

    def _finish(self, job: _Job, model: Any) -> None:
        done = time.perf_counter()
        self._settle(job, result=model)
        telemetry.histogram("sched_fit_ms").observe(
            (done - job.t_submit) * 1e3, tenant=job.tenant
        )
