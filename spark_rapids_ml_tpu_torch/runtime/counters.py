"""Process-wide resilience counters (counterpart of
``spark_rapids_ml_tpu/runtime/counters.py``).

A shim over the typed metric registry of :mod:`.telemetry` (the catalog
is :mod:`.metricspec`; gauge-vs-counter is a property of the registered
metric, not a name check here), with the JAX package's API: ``bump`` /
``note`` / ``get`` / ``snapshot`` / ``delta_since`` / ``reset``. The
estimators take a ``snapshot`` before each lane's fit and attach its
``delta_since`` as the model's ``_resilience_report``, so a clean fit
reports ``{}``.
"""

from __future__ import annotations

from typing import Dict

from . import telemetry


def bump(name: str, by: int = 1) -> None:
    """Increment counter ``name`` by ``by`` (creates it at 0)."""
    telemetry._legacy_metric(name, "counter").inc(int(by))


def note(name: str, value: int) -> None:
    """Set gauge ``name`` to ``value`` (last-write-wins semantics)."""
    telemetry._legacy_metric(name, "gauge").set(int(value))


def get(name: str) -> int:
    return int(telemetry._legacy_snapshot().get(name, 0))


def snapshot() -> Dict[str, int]:
    """A point-in-time copy of every legacy-visible counter/gauge."""
    return telemetry._legacy_snapshot()


def delta_since(base: Dict[str, int]) -> Dict[str, int]:
    """Counter changes since ``base`` (a prior :func:`snapshot`).

    Gauges are reported as their current value when it changed; plain
    counters as the difference — decided by each metric's registered
    kind (``metricspec`` / the live registry), not its name. Keys with
    zero delta are omitted so the clean path reports ``{}``.
    """
    cur = snapshot()
    out: Dict[str, int] = {}
    for name, value in cur.items():
        if telemetry.metric_kind(name) == "gauge":
            if value != base.get(name, 0):
                out[name] = value
        else:
            d = value - base.get(name, 0)
            if d:
                out[name] = d
    return out


def reset() -> None:
    """Zero every counter (test isolation)."""
    telemetry._reset_metrics()
