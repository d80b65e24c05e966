"""Runtime lock-order witness: instrumented locks, opt-in and inert
(counterpart of ``spark_rapids_ml_tpu/runtime/lockwitness.py``).

Every cataloged lock of the port's runtime is constructed through this
module's factories (:func:`make_lock` / :func:`make_rlock` /
:func:`make_condition`) with its :mod:`lockspec` name. With :data:`MODE`
``"off"`` (the default, the JAX package's ``TPUML_LOCK_WITNESS`` default)
the factories validate the name against the catalog and return **raw**
``threading`` primitives: no per-acquire overhead and no metric series.

With ``MODE`` ``"count"`` (alias ``"1"``; ``"raise"`` escalates) at the
moment a cataloged site constructs its lock, the factories return witness
wrappers that, at every acquire:

- check the per-thread held stack against the catalog's rank order —
  acquiring a lock whose rank is not strictly above everything already
  held is an inversion (for a plain ``Lock``, re-acquiring the same
  name is self-deadlock and flagged the same way);
- extend a process-wide acquisition graph (``held -> acquired`` edges
  across all threads) and walk it for cycles;
- record wait time (contention) and, at release, hold time.

Each distinct violation (ordered name pair) is reported **exactly
once**: counted in ``lock_order_violations_total{held,acquired}``,
logged, and — in ``raise`` mode — raised as :class:`LockOrderError`.
Hold/wait histograms export as ``lock_hold_ms`` / ``lock_wait_ms``
labeled by lock name.

Metric emission happens through :mod:`.telemetry`, whose own registry
locks are themselves witnessed — a thread-local reentrancy guard keeps
the witness from observing its own bookkeeping.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, List, Optional, Set, Tuple

from . import lockspec

_LOGGER = logging.getLogger("spark_rapids_ml_tpu_torch")

# the JAX package's TPUML_LOCK_WITNESS: "off" (raw primitives), "count"
# (alias "1": witness wrappers that count and log each violation) or
# "raise" (the first occurrence of each violation raises); read when a
# cataloged site constructs its lock
MODE = "off"

__all__ = [
    "LockOrderError",
    "active",
    "make_lock",
    "make_rlock",
    "make_condition",
    "violations",
    "reset_lockwitness",
]


class LockOrderError(RuntimeError):
    """A rank inversion or acquisition cycle under ``raise`` mode."""


_MODES = ("off", "count", "raise")


def _mode() -> str:
    """``off`` | ``count`` | ``raise`` (``1`` is an alias for count)."""
    v = "count" if MODE == "1" else MODE
    if v not in _MODES:
        raise ValueError(f"lockwitness.MODE={MODE!r} must be one of off, count, 1, raise")
    return v


def active() -> bool:
    """True when the witness instruments new locks (``MODE`` not ``off``
    at the moment a cataloged site constructs its lock)."""
    return _mode() != "off"


# --------------------------------------------------------------------------
# witness state (all guarded by a raw, unwitnessed internal lock)
# --------------------------------------------------------------------------

_TLS = threading.local()  # .held: List[_Held]; .busy: bool (reentrancy)
_GRAPH_LOCK = threading.Lock()
_EDGES: Dict[str, Set[str]] = {}  # held name -> {acquired names}
_REPORTED: Set[Tuple[str, str]] = set()  # (held, acquired) pairs


class _Held:
    __slots__ = ("spec", "t_acquired", "count")

    def __init__(self, spec: lockspec.LockSpec, t_acquired: float) -> None:
        self.spec = spec
        self.t_acquired = t_acquired
        self.count = 1


def _held_stack() -> List[_Held]:
    held = getattr(_TLS, "held", None)
    if held is None:
        held = _TLS.held = []
    return held


def _busy() -> bool:
    return bool(getattr(_TLS, "busy", False))


def violations() -> Tuple[Tuple[str, str], ...]:
    """The distinct (held, acquired) pairs reported so far."""
    with _GRAPH_LOCK:
        return tuple(sorted(_REPORTED))


def reset_lockwitness() -> None:
    """Clear the acquisition graph and reported set (test isolation).
    Per-thread held stacks are left alone — they empty themselves as
    ``with`` blocks unwind."""
    with _GRAPH_LOCK:
        _EDGES.clear()
        _REPORTED.clear()


def _cycle_from(start: str) -> bool:
    """True when ``start`` can reach itself through the edge graph.
    Called with ``_GRAPH_LOCK`` held; the graph is tiny (one node per
    cataloged lock) so an iterative DFS is plenty."""
    stack, seen = [start], set()
    while stack:
        node = stack.pop()
        for nxt in _EDGES.get(node, ()):
            if nxt == start:
                return True
            if nxt not in seen:
                seen.add(nxt)
                stack.append(nxt)
    return False


def _emit(fn: Any) -> None:
    """Run a telemetry-recording thunk with the reentrancy guard up:
    the registry's own witnessed locks skip bookkeeping while we hold
    the guard, so recording a hold time never recurses into itself."""
    _TLS.busy = True
    try:
        fn()
    except Exception:  # observability must never fail the holder
        pass
    finally:
        _TLS.busy = False


def _report(held: lockspec.LockSpec, spec: lockspec.LockSpec,
            why: str, mode: str) -> None:
    pair = (held.name, spec.name)
    with _GRAPH_LOCK:
        if pair in _REPORTED:
            return
        _REPORTED.add(pair)

    def _count() -> None:
        from . import telemetry

        telemetry.counter("lock_order_violations_total").inc(
            held=held.name, acquired=spec.name
        )

    _emit(_count)
    msg = (
        f"lock-order violation ({why}): acquiring {spec.name!r} "
        f"(rank {spec.rank}) while holding {held.name!r} (rank "
        f"{held.rank}) on thread {threading.current_thread().name!r} — "
        "the declared hierarchy is runtime/lockspec.py"
    )
    if mode == "raise":
        raise LockOrderError(msg)
    _LOGGER.error("%s", msg)


def _note_acquired(spec: lockspec.LockSpec, wait_s: float) -> None:
    """Order/cycle checks + bookkeeping after the real acquire
    succeeded. Runs on the acquiring thread; never blocks on anything
    but the internal graph lock."""
    held = _held_stack()
    mode = _mode()
    top = held[-1] if held else None
    for h in held:
        if h.spec.rank >= spec.rank:
            why = (
                "self-nesting would deadlock"
                if h.spec.name == spec.name
                else "rank not ascending"
            )
            _report(h.spec, spec, why, mode)
    if top is not None and top.spec.name != spec.name:
        with _GRAPH_LOCK:
            fresh = spec.name not in _EDGES.setdefault(
                top.spec.name, set()
            )
            if fresh:
                _EDGES[top.spec.name].add(spec.name)
                cyclic = _cycle_from(top.spec.name)
            else:
                cyclic = False
        if cyclic:
            _report(top.spec, spec, "acquisition cycle", mode)
    held.append(_Held(spec, time.perf_counter()))
    if wait_s >= 0.0:

        def _observe() -> None:
            from . import telemetry

            telemetry.histogram("lock_wait_ms").observe(
                wait_s * 1e3, lock=spec.name
            )

        _emit(_observe)


def _note_released(spec: lockspec.LockSpec) -> None:
    held = _held_stack()
    for i in range(len(held) - 1, -1, -1):
        if held[i].spec.name == spec.name:
            hold_s = time.perf_counter() - held[i].t_acquired
            del held[i]

            def _observe() -> None:
                from . import telemetry

                telemetry.histogram("lock_hold_ms").observe(
                    hold_s * 1e3, lock=spec.name
                )

            _emit(_observe)
            return


# --------------------------------------------------------------------------
# instrumented primitives
# --------------------------------------------------------------------------


class _WitnessLock:
    """``threading.Lock`` wrapper with acquire-time order checking."""

    _reentrant = False

    def __init__(self, spec: lockspec.LockSpec) -> None:
        self._spec = spec
        self._inner = threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if _busy():
            return self._inner.acquire(blocking, timeout)
        t0 = time.perf_counter()
        got = self._inner.acquire(blocking, timeout)
        if got:
            try:
                self._note_entry(time.perf_counter() - t0)
            except LockOrderError:
                # raise-mode detection must not leave the lock held:
                # __enter__ raising means __exit__ never runs
                self._inner.release()
                raise
        return got

    def _note_entry(self, wait_s: float) -> None:
        if self._reentrant:
            held = _held_stack()
            for h in held:
                if h.spec.name == self._spec.name:
                    h.count += 1
                    return
        _note_acquired(self._spec, wait_s)

    def release(self) -> None:
        if not _busy():
            self._note_exit()
        self._inner.release()

    def _note_exit(self) -> None:
        if self._reentrant:
            held = _held_stack()
            for h in held:
                if h.spec.name == self._spec.name and h.count > 1:
                    h.count -= 1
                    return
        _note_released(self._spec)

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc: Any) -> None:
        self.release()


class _WitnessRLock(_WitnessLock):
    """``threading.RLock`` wrapper: re-entry by the owning thread is
    sanctioned (bookkept once, refcounted)."""

    _reentrant = True

    def __init__(self, spec: lockspec.LockSpec) -> None:
        self._spec = spec
        self._inner = threading.RLock()  # type: ignore[assignment]

    def locked(self) -> bool:  # RLock has no locked() before 3.12
        if self._inner.acquire(blocking=False):
            self._inner.release()
            return False
        return True


class _WitnessCondition:
    """``threading.Condition`` wrapper. Built either standalone or over
    an existing witness lock (``threading.Condition(self._lock)``
    style) — in the shared case enter/exit bookkeeping goes through the
    shared lock's spec, so the acquisition graph sees one lock however
    it was reached. ``wait`` pops the held entry while blocked (the
    lock really is released) and re-books it on wake."""

    def __init__(
        self,
        spec: lockspec.LockSpec,
        lock: Optional[_WitnessLock] = None,
    ) -> None:
        self._spec = lock._spec if lock is not None else spec
        self._wl = lock
        inner = lock._inner if lock is not None else threading.Lock()
        self._cond = threading.Condition(inner)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if _busy():
            return self._cond.acquire(blocking, timeout)
        t0 = time.perf_counter()
        got = self._cond.acquire(blocking, timeout)
        if got:
            try:
                _note_acquired(self._spec, time.perf_counter() - t0)
            except LockOrderError:
                self._cond.release()
                raise
        return got

    def release(self) -> None:
        if not _busy():
            _note_released(self._spec)
        self._cond.release()

    def __enter__(self) -> "_WitnessCondition":
        self.acquire()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.release()

    def wait(self, timeout: Optional[float] = None) -> bool:
        if _busy():
            return self._cond.wait(timeout)
        _note_released(self._spec)
        try:
            return self._cond.wait(timeout)
        finally:
            _note_acquired(self._spec, -1.0)

    def wait_for(self, predicate: Any,
                 timeout: Optional[float] = None) -> Any:
        """Re-implemented over :meth:`wait` so each internal sleep
        cycles the held bookkeeping like the stdlib's lock handoff."""
        endtime = None
        result = predicate()
        while not result:
            if timeout is not None:
                if endtime is None:
                    endtime = time.monotonic() + timeout
                waittime = endtime - time.monotonic()
                if waittime <= 0:
                    break
            else:
                waittime = None
            self.wait(waittime)
            result = predicate()
        return result

    def notify(self, n: int = 1) -> None:
        self._cond.notify(n)

    def notify_all(self) -> None:
        self._cond.notify_all()


# --------------------------------------------------------------------------
# factories — the only way cataloged sites construct locks
# --------------------------------------------------------------------------


def _spec(name: str, kind: str) -> lockspec.LockSpec:
    spec = lockspec.SPEC.get(name)
    if spec is None:
        raise ValueError(
            f"{name!r} is not a cataloged lock "
            "(spark_rapids_ml_tpu_torch/runtime/lockspec.py is the registry)"
        )
    if spec.kind != kind:
        raise ValueError(
            f"lock {name!r} is cataloged as a {spec.kind}, not a {kind}"
        )
    return spec


def make_lock(name: str) -> Any:
    """A ``threading.Lock`` (witnessed when :data:`MODE` is not
    ``off``) for cataloged lock ``name``. The catalog lookup happens in
    both modes, so a name typo fails loudly even with the witness
    off."""
    spec = _spec(name, "lock")
    if not active():
        return threading.Lock()
    return _WitnessLock(spec)


def make_rlock(name: str) -> Any:
    """The ``threading.RLock`` analog of :func:`make_lock`."""
    spec = _spec(name, "rlock")
    if not active():
        return threading.RLock()
    return _WitnessRLock(spec)


def make_condition(name: str, lock: Any = None) -> Any:
    """A ``threading.Condition`` for cataloged name ``name``; pass
    ``lock`` (made by :func:`make_lock`) to share its underlying lock,
    the ``Condition(self._lock)`` idiom — bookkeeping then unifies on
    the shared lock's cataloged name."""
    if lock is None:
        spec = _spec(name, "condition")
    else:
        spec = _spec(name, "lock")
    if not active():
        return threading.Condition(
            lock if not isinstance(lock, _WitnessLock) else lock._inner
        )
    return _WitnessCondition(
        spec, lock if isinstance(lock, _WitnessLock) else None
    )
