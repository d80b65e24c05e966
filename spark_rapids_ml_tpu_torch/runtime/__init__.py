"""Run-time services of the port: checkpoint/resume of the iterative fits
(:mod:`.checkpoint`), bounded retries (:mod:`.retry`), fault injection
(:mod:`.faults`), the fit scheduler and its admission primitives
(:mod:`.scheduler`, :mod:`.admission`), spans and typed metrics
(:mod:`.telemetry`, the catalog :mod:`.metricspec`), the resilience
counters (:mod:`.counters`) and the lock catalog and its witness
(:mod:`.lockspec`, :mod:`.lockwitness`). Every setting is a module
constant, inert by default."""

from . import counters, faults, lockspec, lockwitness, metricspec, retry, scheduler, telemetry
from .admission import (
    AdmissionError,
    CircuitBreaker,
    DeadlineExceeded,
    Overloaded,
    ServiceEwma,
    ShuttingDown,
)
from .checkpoint import CKPT_VERSION, FitCheckpointer, array_digest, params_hash
from .faults import (
    FaultInjector,
    FaultSpecError,
    InjectedFault,
    InjectedResourceExhausted,
    SimulatedPreemption,
    fault_site,
    fault_sites_active,
    parse_fault_spec,
    reset_faults,
)
from .retry import backoff_schedule, is_resource_exhausted, resolve_backoff_ms, resolve_retries, with_retries
from .scheduler import FitPreempted, FitScheduler, preempt_point

__all__ = [
    "AdmissionError",
    "CKPT_VERSION",
    "CircuitBreaker",
    "DeadlineExceeded",
    "FaultInjector",
    "FaultSpecError",
    "FitCheckpointer",
    "FitPreempted",
    "FitScheduler",
    "InjectedFault",
    "InjectedResourceExhausted",
    "Overloaded",
    "ServiceEwma",
    "ShuttingDown",
    "SimulatedPreemption",
    "array_digest",
    "backoff_schedule",
    "counters",
    "fault_site",
    "fault_sites_active",
    "faults",
    "is_resource_exhausted",
    "lockspec",
    "lockwitness",
    "metricspec",
    "params_hash",
    "parse_fault_spec",
    "preempt_point",
    "reset_faults",
    "resolve_backoff_ms",
    "resolve_retries",
    "retry",
    "scheduler",
    "telemetry",
    "with_retries",
]
