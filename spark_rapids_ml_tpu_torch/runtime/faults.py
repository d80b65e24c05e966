"""Deterministic fault injection driven by a module constant (counterpart of
``spark_rapids_ml_tpu/runtime/faults.py``; the same grammar and semantics).

:data:`FAULT_SPEC` is a comma-separated list of entries

    scope:point:index:action

where ``scope:point`` names an instrumented site (``ingest:chunk``,
``sgd:epoch``, ``gbt:round``, ``init:connect``, the serving plane's
``serve:admit`` / ``serve:dispatch`` / ``serve:transfer``, the fit
scheduler's ``sched:admit`` / ``sched:preempt`` / ``sched:resume`` /
``sched:dispatch`` and the hot-swap's ``swap:warm`` / ``swap:flip``),
``index`` is the 0-based hit count at that site on which the fault fires,
and ``action`` is one of

- ``raise``   — raise :class:`InjectedFault` (a generic hard error),
- ``preempt`` — raise :class:`SimulatedPreemption` (terminal: the retry
                wrapper never swallows it, modeling a preemption that
                kills the process; recovery is refit-from-checkpoint),
- ``oom``     — raise :class:`InjectedResourceExhausted` (its message
                contains ``RESOURCE_EXHAUSTED`` so it takes the staging
                chunk-halving path).

Each entry fires exactly once: after firing it is spent, so an in-process
retry or refit sails past the site. Hit counters are per-site and
monotonically increase for the life of the injector; :func:`reset_faults`
rebuilds the injector (tests call it between scenarios). The injector is
cached on the value of :data:`FAULT_SPEC`: assigning a new value builds a
new one at the next hit.

Sites wired in the port: ``ingest:chunk`` (``ops.streaming.put_chunk``),
``sgd:epoch`` (``ops.lbfgs.minimize_lbfgs_host``, the streamed Lloyd, UMAP's
epoch segments), ``gbt:round`` (the GBT boosting loop) and the four
``sched:*`` sites (``runtime.scheduler``). ``init:connect`` comes with the
multi-GPU rendezvous (ROADMAP queue 1 item 6), the ``serve:*`` and
``swap:*`` sites with serving (item 8); :data:`SITES` lists them all so the
grammar equals the JAX package's.

With :data:`FAULT_SPEC` empty every hook is a no-op costing one cache
lookup — the production path stays inert.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from . import lockwitness

# the fault plan (the JAX package's TPUML_FAULT_SPEC); "" = inert
FAULT_SPEC = ""

SITES = (
    "ingest:chunk", "sgd:epoch", "init:connect",
    # serving plane (ROADMAP queue 1 item 8)
    "serve:admit", "serve:dispatch", "serve:transfer",
    # GBT boosting round boundary (models/tree.py): the per-round twin
    # of sgd:epoch
    "gbt:round",
    # fit scheduler (hit per job submit / quantum yield / resumed
    # re-dispatch / job dispatch — see runtime/scheduler.py)
    "sched:admit", "sched:preempt", "sched:resume", "sched:dispatch",
    # hot-swap lifecycle (ROADMAP queue 1 item 8)
    "swap:warm", "swap:flip",
)
ACTIONS = ("raise", "preempt", "oom")

_NAME = "runtime.faults.FAULT_SPEC"


class FaultSpecError(ValueError):
    """Malformed :data:`FAULT_SPEC` value."""


class InjectedFault(RuntimeError):
    """Generic injected failure (``raise`` action)."""


class SimulatedPreemption(RuntimeError):
    """Injected preemption (``preempt`` action).

    Terminal by contract: ``with_retries`` re-raises it without retrying,
    the same way a real preemption is not survivable in-process.
    """


class InjectedResourceExhausted(RuntimeError):
    """Injected allocator failure (``oom`` action).

    The message embeds ``RESOURCE_EXHAUSTED`` so
    :func:`spark_rapids_ml_tpu_torch.runtime.retry.is_resource_exhausted`
    classifies it like a real allocator failure.
    """

    def __init__(self, site: str) -> None:
        super().__init__(f"RESOURCE_EXHAUSTED: injected at {site}")


def parse_fault_spec(spec: str) -> List[Tuple[str, int, str]]:
    """Parse a fault spec into ``[(site, index, action), ...]``."""
    entries: List[Tuple[str, int, str]] = []
    for raw in spec.split(","):
        raw = raw.strip()
        if not raw:
            continue
        parts = raw.split(":")
        if len(parts) != 4:
            raise FaultSpecError(f"{_NAME} entry {raw!r} is not scope:point:index:action")
        scope, point, idx_s, action = (p.strip() for p in parts)
        site = f"{scope}:{point}"
        if site not in SITES:
            raise FaultSpecError(
                f"{_NAME} entry {raw!r}: unknown site {site!r} (expected one of {', '.join(SITES)})"
            )
        if action not in ACTIONS:
            raise FaultSpecError(
                f"{_NAME} entry {raw!r}: unknown action {action!r} (expected one of {', '.join(ACTIONS)})"
            )
        try:
            idx = int(idx_s)
        except ValueError:
            raise FaultSpecError(f"{_NAME} entry {raw!r}: index {idx_s!r} is not an integer") from None
        if idx < 0:
            raise FaultSpecError(f"{_NAME} entry {raw!r}: index must be >= 0")
        entries.append((site, idx, action))
    return entries


class FaultInjector:
    """Deterministic chaos hooks driven by a parsed fault spec."""

    def __init__(self, spec: str) -> None:
        self.spec = spec
        self._lock = lockwitness.make_lock("faults.plan")
        self._hits: Dict[str, int] = {}
        # site -> {index: action}; later entries for the same (site, index)
        # win ("last setting wins")
        self._pending: Dict[str, Dict[int, str]] = {}
        for site, idx, action in parse_fault_spec(spec):
            self._pending.setdefault(site, {})[idx] = action

    def active_sites(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(s for s, m in self._pending.items() if m)

    def hit(self, site: str) -> None:
        """Record one pass through ``site``; raise if a fault is due."""
        with self._lock:
            n = self._hits.get(site, 0)
            self._hits[site] = n + 1
            action = self._pending.get(site, {}).pop(n, None)
        if action is None:
            return
        try:
            from . import telemetry

            telemetry.counter("fault_injections").inc(kind=action)
            telemetry.add_span_event("fault_injected", site=site, index=n, action=action)
        except Exception:  # pragma: no cover - tracing must not mask the fault
            pass
        if action == "preempt":
            raise SimulatedPreemption(f"injected preemption at {site}[{n}]")
        if action == "oom":
            raise InjectedResourceExhausted(f"{site}[{n}]")
        raise InjectedFault(f"injected fault at {site}[{n}]")


_cache_lock = lockwitness.make_lock("faults.cache")
_cached: Optional[Tuple[str, Optional[FaultInjector]]] = None


def _injector() -> Optional[FaultInjector]:
    global _cached
    spec = FAULT_SPEC
    with _cache_lock:
        if _cached is not None and _cached[0] == spec:
            return _cached[1]
        inj = FaultInjector(spec) if spec else None
        _cached = (spec, inj)
        return inj


def fault_site(site: str) -> None:
    """Instrumentation hook: call at every pass through ``site``.

    No-op (one cache hit) unless :data:`FAULT_SPEC` names a pending fault
    for this site at the current hit index.
    """
    inj = _injector()
    if inj is not None:
        inj.hit(site)


def fault_sites_active(*sites: str) -> bool:
    """True when any of ``sites`` still has an unfired fault entry."""
    inj = _injector()
    if inj is None:
        return False
    active = inj.active_sites()
    return any(s in active for s in sites)


def reset_faults() -> None:
    """Forget fired entries and hit counts (rebuilds from :data:`FAULT_SPEC`)."""
    global _cached
    with _cache_lock:
        _cached = None
