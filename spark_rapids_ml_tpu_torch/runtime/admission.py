"""Shared admission-control primitives: typed errors, EWMA service-time
model, and the consecutive-failure circuit breaker (counterpart of
``spark_rapids_ml_tpu/runtime/admission.py``; the same state machines).

The fit scheduler (``runtime/scheduler.py``) gates its submits with them;
the serving dispatcher (ROADMAP queue 1 item 8) will gate its requests the
same way, so they live here once:

- the typed error surface (:class:`AdmissionError` and subclasses) —
  every way work can be rejected without a result is a distinct type,
  all subclassing ``RuntimeError`` so pre-typed callers keep working;
- :class:`ServiceEwma` — the per-key EWMA of (service seconds per
  dispatch, items per dispatch) behind the "is this deadline meetable"
  estimate;
- :class:`CircuitBreaker` — closed → open after N *consecutive*
  failures, open → half-open after a cooldown (one probe), half-open →
  closed on probe success / back to open on probe failure.

This module is metric-agnostic: the breaker reports state transitions
through an ``on_state`` callback so each plane exports its own gauge
(``sched_breaker_state{tenant}`` for the scheduler) without this file
hard-coding a metric name.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

from . import lockwitness

# breaker states (the gauge values both planes export)
CLOSED = 0
HALF_OPEN = 1
OPEN = 2

STATE_NAMES = {CLOSED: "closed", HALF_OPEN: "half_open", OPEN: "open"}

# EWMA smoothing for service time / items per dispatch: ~5-dispatch
# memory, fast enough to track a load shift within one burst
EWMA_ALPHA = 0.2


class AdmissionError(RuntimeError):
    """Base of the typed admission error surface. Subclasses
    ``RuntimeError`` so pre-existing callers catching RuntimeError keep
    working."""


class DeadlineExceeded(AdmissionError):
    """The work's deadline expired before dispatch (never after a
    result was computed — expiry is checked *before* dispatch)."""


class Overloaded(AdmissionError):
    """Rejected at admission; ``reason`` is the shed-metric label
    (``queue_full`` | ``deadline_unmeetable`` | ``breaker_open``)."""

    def __init__(self, message: str, reason: str) -> None:
        super().__init__(message)
        self.reason = reason


class ShuttingDown(AdmissionError):
    """The runtime is closed or draining. The message always contains
    "closed" — callers matching the pre-typed RuntimeError still match."""

    def __init__(self, message: str = "ServingRuntime is closed") -> None:
        super().__init__(message)


class ServiceEwma:
    """Per-key EWMA of ``(service seconds per dispatch, items per
    dispatch)``. Thread-safe; the first observation seeds the average
    directly so early estimates are not dragged toward zero."""

    def __init__(self, alpha: float = EWMA_ALPHA) -> None:
        self.alpha = float(alpha)
        self._lock = lockwitness.make_lock("admission.ewma")
        self._ewma: Dict[str, Tuple[float, float]] = {}

    def note(self, key: str, service_s: float, n_items: int = 1) -> None:
        """Record one completed dispatch of ``n_items`` taking
        ``service_s`` seconds."""
        a = self.alpha
        with self._lock:
            prev = self._ewma.get(key)
            if prev is None:
                self._ewma[key] = (float(service_s), float(n_items))
            else:
                s, r = prev
                self._ewma[key] = (
                    a * float(service_s) + (1 - a) * s,
                    a * float(n_items) + (1 - a) * r,
                )

    def estimate_s(self, key: str) -> Optional[float]:
        """EWMA seconds one dispatch of ``key`` takes, or None before
        any dispatch has been observed."""
        with self._lock:
            ew = self._ewma.get(key)
        return None if ew is None else ew[0]

    def estimated_wait_s(self, key: str, depth: int) -> Optional[float]:
        """Expected queueing delay for work arriving now, behind
        ``depth`` already-admitted items. None = no data yet (first
        dispatches are never shed on the deadline estimate)."""
        with self._lock:
            ew = self._ewma.get(key)
        if ew is None:
            return None
        service_s, items_per_dispatch = ew
        dispatches = depth / max(items_per_dispatch, 1.0)
        return dispatches * service_s


class CircuitBreaker:
    """Per-key consecutive-failure breaker. Thread-safe; owned by the
    admission side and poked by the dispatch side
    (record_success/record_failure), so every transition is locked.
    ``on_state`` (optional) is invoked with the new state int on every
    transition — the hook each plane uses to export its gauge."""

    def __init__(
        self,
        key: str,
        fails: int,
        cooldown_s: float,
        on_state: Optional[Callable[[int], None]] = None,
    ) -> None:
        self.key = key
        self.fails = int(fails)  # 0 = disabled
        self.cooldown_s = float(cooldown_s)
        self._on_state = on_state
        self._state = CLOSED
        self._consecutive = 0
        self._opened_at = 0.0
        self._lock = lockwitness.make_lock("admission.breaker")

    @property
    def enabled(self) -> bool:
        return self.fails > 0

    def _set_state(self, state: int) -> None:
        self._state = state
        if self._on_state is not None:
            self._on_state(state)

    def state(self) -> int:
        with self._lock:
            return self._state

    def state_name(self) -> str:
        return STATE_NAMES[self.state()]

    def allow(self) -> bool:
        """Admission-side check. Open blocks; after the cooldown the
        breaker moves to half-open and admits exactly one probe."""
        if not self.enabled:
            return True
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if time.monotonic() - self._opened_at < self.cooldown_s:
                    return False
                self._set_state(HALF_OPEN)
                return True
            # HALF_OPEN: one probe is already in flight; block the rest
            # until the dispatch side reports its outcome
            return False

    def record_success(self) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._consecutive = 0
            if self._state != CLOSED:
                self._set_state(CLOSED)

    def record_failure(self) -> None:
        if not self.enabled:
            return
        with self._lock:
            if self._state == HALF_OPEN:
                # the probe failed: straight back to open, fresh cooldown
                self._opened_at = time.monotonic()
                self._set_state(OPEN)
                return
            self._consecutive += 1
            if self._state == CLOSED and self._consecutive >= self.fails:
                self._opened_at = time.monotonic()
                self._set_state(OPEN)
