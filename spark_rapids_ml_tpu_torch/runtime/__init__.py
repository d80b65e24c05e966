"""Run-time services of the port: checkpoint/resume of the iterative
streamed fits (:mod:`.checkpoint`), spans and typed metrics
(:mod:`.telemetry`, the catalog :mod:`.metricspec`), the resilience
counters (:mod:`.counters`) and the lock catalog and its witness
(:mod:`.lockspec`, :mod:`.lockwitness`)."""

from . import counters, lockspec, lockwitness, metricspec, telemetry
from .checkpoint import CKPT_VERSION, FitCheckpointer, array_digest, params_hash

__all__ = [
    "CKPT_VERSION",
    "FitCheckpointer",
    "array_digest",
    "counters",
    "lockspec",
    "lockwitness",
    "metricspec",
    "params_hash",
    "telemetry",
]
