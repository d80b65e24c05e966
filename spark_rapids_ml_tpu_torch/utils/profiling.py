"""Tracing / profiling of the port (counterpart of
``spark_rapids_ml_tpu/utils/profiling.py``).

* :func:`annotate` — a ``torch.profiler.record_function`` range: a named
  range on a ``torch.profiler`` trace and, on the card, an NVTX-visible
  range (a no-op cost outside a capture).
* :func:`trace` — capture a ``torch.profiler`` profile of the CPU and, where
  a card is present, its CUDA activity into a directory as a Chrome trace.
* :func:`timed` — phase wall-clock logging at debug level.
* :class:`StageTimer` — accumulating per-stage breakdown; each stage is
  also a ``runtime.telemetry`` span, so the report dicts built from
  ``totals`` and the exported trace see the same measurement.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Iterator, Optional

import torch

from ..runtime import telemetry


def annotate(name: str):
    """Named range on the profiler timeline (no-op outside a capture)."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """Capture a ``torch.profiler`` profile of the region into ``log_dir``
    (``trace-<pid>.json``, a Chrome trace) when ``log_dir`` is set;
    transparent otherwise. CUDA activity is captured where a card is
    present."""
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.__enter__()
    try:
        yield
    finally:
        prof.__exit__(None, None, None)
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, f"trace-{os.getpid()}.json"))


@contextlib.contextmanager
def timed(logger, phase: str) -> Iterator[None]:
    """Debug-level phase timing (device work is NOT synchronized — pair
    with a synchronize at the call site when exact numbers matter)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        logger.debug("%s took %.4fs", phase, time.perf_counter() - t0)


class StageTimer:
    """Accumulating per-stage wall-clock breakdown of a repeated pipeline;
    one summary line a call.

    Same caveat as :func:`timed`: a stage measures host time, and device
    wait lands in whichever stage first reads a result back to the host.
    """

    def __init__(self, name: str) -> None:
        self.name = name
        self.totals: dict = {}
        self.counts: dict = {}
        # fold threads may share a timer (the CV's fold pool)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, label: str) -> Iterator[None]:
        ts = telemetry.timed_span(f"{self.name}.{label}")
        ts.__enter__()
        try:
            yield
        finally:
            ts.__exit__(None, None, None)
            with self._lock:
                self.totals[label] = self.totals.get(label, 0.0) + ts.seconds
                self.counts[label] = self.counts.get(label, 0) + 1

    def log_summary(self, logger) -> None:
        """Debug-log accumulated stages and reset for the next call."""
        with self._lock:
            if not self.totals:
                return
            parts = ", ".join(
                f"{k}={v:.4f}s/{self.counts[k]}x"
                for k, v in sorted(self.totals.items())
            )
            self.totals.clear()
            self.counts.clear()
        logger.debug("%s stages: %s", self.name, parts)
