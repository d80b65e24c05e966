"""Bounded exponential-backoff retries for transient infrastructure faults
(counterpart of ``spark_rapids_ml_tpu/runtime/retry.py``).

``with_retries`` wraps a launch-time race; the streamed path's
``ops.streaming.stage_chunks`` runs the same budget inline around each
chunk's staging. The budget is two module constants, so the launcher — not
the algorithm code — decides how patient a fit is:

- :data:`RETRIES`    — extra attempts after the first (default 0: a single
                       attempt, no sleeps, fully inert).
- :data:`BACKOFF_MS` — base delay of the exponential schedule (default 100;
                       the delay before retry *a* is ``min(base * 2**a,
                       30 s)`` with 50-100% jitter).

:class:`~spark_rapids_ml_tpu_torch.runtime.faults.SimulatedPreemption` is
terminal by contract and is never retried — preemption is survived by
refit-from-checkpoint, not by waiting. The rendezvous ``with_retries``
wraps in the JAX package comes with the multi-GPU context (ROADMAP queue 1
item 6).
"""

from __future__ import annotations

import logging
import random
import time
from typing import Callable, List, Optional, Tuple, Type, TypeVar

from .counters import bump
from .faults import SimulatedPreemption

logger = logging.getLogger("spark_rapids_ml_tpu_torch.runtime.retry")

_T = TypeVar("_T")

_BACKOFF_CAP_MS = 30_000.0

# the retry budget (the JAX package's TPUML_RETRIES / TPUML_BACKOFF_MS)
RETRIES = 0
BACKOFF_MS = 100.0


def resolve_retries() -> int:
    """:data:`RETRIES` as a non-negative int (default 0 = inert)."""
    n = int(RETRIES)
    if n < 0:
        raise ValueError(f"runtime.retry.RETRIES must be >= 0, got {RETRIES!r}")
    return n


def resolve_backoff_ms() -> float:
    """:data:`BACKOFF_MS` as a positive float (default 100)."""
    ms = float(BACKOFF_MS)
    if ms <= 0:
        raise ValueError(f"runtime.retry.BACKOFF_MS must be > 0, got {BACKOFF_MS!r}")
    return ms


def backoff_schedule(
    retries: int,
    backoff_ms: float,
    *,
    cap_ms: float = _BACKOFF_CAP_MS,
    seed: int = 0,
) -> List[float]:
    """Delays (ms) before each retry: capped exponential with jitter.

    Attempt *a* (0-based) sleeps ``min(backoff_ms * 2**a, cap_ms)`` scaled
    by a uniform factor in [0.5, 1.0) — "equal jitter", so delays never
    collapse to zero but concurrent workers still decorrelate. Seeded
    (``random.Random``, as the JAX package) so the schedule is
    deterministic and equal to the JAX package's for the same seed.
    """
    rng = random.Random(seed)
    out: List[float] = []
    for a in range(retries):
        base = min(backoff_ms * (2.0**a), cap_ms)
        out.append(base * (0.5 + 0.5 * rng.random()))
    return out


def is_resource_exhausted(exc: BaseException) -> bool:
    """True for allocator-pressure failures: the caching allocator's
    ``torch.OutOfMemoryError`` ("CUDA out of memory"), or any error whose
    message says ``RESOURCE_EXHAUSTED`` (an injected ``oom``). A CUDA launch
    error is not one."""
    import torch

    oom = getattr(torch, "OutOfMemoryError", None) or torch.cuda.OutOfMemoryError
    return isinstance(exc, oom) or "RESOURCE_EXHAUSTED" in str(exc)


def with_retries(
    fn: Callable[[], _T],
    *,
    what: str,
    retries: Optional[int] = None,
    backoff_ms: Optional[float] = None,
    retry_on: Tuple[Type[BaseException], ...] = (Exception,),
    giveup: Optional[Callable[[BaseException], bool]] = None,
    seed: int = 0,
    sleep: Callable[[float], None] = time.sleep,
) -> _T:
    """Call ``fn`` with up to ``retries`` re-attempts on transient failure.

    ``giveup`` classifies errors that retrying at the same shape cannot
    fix (e.g. ``is_resource_exhausted``) — they re-raise immediately so
    the caller's degradation path (chunk halving) runs instead of burning
    the backoff budget on a deterministic failure.

    With the default budget (:data:`RETRIES` 0) this is exactly one
    ``fn()`` call — no sleeps, no counter traffic, no behavior change.
    """
    budget = resolve_retries() if retries is None else retries
    if budget <= 0:
        return fn()
    delays = backoff_schedule(budget, resolve_backoff_ms() if backoff_ms is None else backoff_ms, seed=seed)
    last: Optional[BaseException] = None
    for attempt in range(budget + 1):
        try:
            return fn()
        except SimulatedPreemption:
            raise  # terminal by contract: survived via checkpoint, not retry
        except retry_on as exc:
            if giveup is not None and giveup(exc):
                raise
            last = exc
            if attempt >= budget:
                break
            bump("retries")
            try:
                from . import telemetry

                telemetry.add_span_event(
                    "retry", what=what, attempt=attempt + 1, error=f"{type(exc).__name__}: {exc}"[:200]
                )
            except Exception:  # pragma: no cover - tracing must not break retry
                pass
            delay = delays[attempt]
            logger.warning(
                "%s failed (attempt %d/%d): %s — retrying in %.0f ms", what, attempt + 1, budget + 1, exc, delay
            )
            sleep(delay / 1000.0)
    assert last is not None
    raise last
