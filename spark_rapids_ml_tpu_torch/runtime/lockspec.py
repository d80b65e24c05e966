"""Typed catalog of the port's named runtime locks (counterpart of
``spark_rapids_ml_tpu/runtime/lockspec.py``).

Each entry gives a lock a stable dotted name, a **rank**, and its declared
home (module / class / attribute). The rank is the lock-order discipline: a
thread may only acquire a lock whose rank is *strictly greater* than every
lock it already holds. :mod:`.lockwitness` checks that discipline on the
real per-thread acquisition order when ``lockwitness.MODE`` is not
``"off"``.

The port catalogs the locks of the modules it has ported, with the JAX
package's names and ranks: the three telemetry registries (the innermost
band, 90-92). The ops plane, lifecycle, scheduler, serving, registry,
admission, fault, autotune and roofline locks come with their modules.
The JAX package declares no lock of its streaming, tuning, mesh or build
code, so the port's locks there (``ops/_build.py``, ``ops/streaming.py``,
``parallel/mesh.py``, ``tuning.py``) stay plain ``threading`` locks.

Stdlib-only, like the JAX package's catalog.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

KINDS = ("lock", "rlock", "condition")


@dataclass(frozen=True)
class LockSpec:
    """One cataloged lock. ``kind`` is lock|rlock|condition."""

    name: str
    rank: int
    kind: str
    # declared home: repo-relative module path, owning class ("" for
    # module level), and attribute name
    module: str
    cls: str
    attr: str
    doc: str


def _registry(*specs: LockSpec) -> Dict[str, LockSpec]:
    out: Dict[str, LockSpec] = {}
    ranks: Dict[int, str] = {}
    for s in specs:
        assert s.kind in KINDS, f"{s.name}: bad kind {s.kind}"
        assert s.name not in out, f"duplicate registration {s.name}"
        assert s.rank not in ranks, (
            f"{s.name}: rank {s.rank} already held by {ranks[s.rank]} — "
            "ranks are unique so every ordering question has one answer"
        )
        out[s.name] = s
        ranks[s.rank] = s.name
    return out


_RT = "spark_rapids_ml_tpu_torch/runtime"

SPEC: Dict[str, LockSpec] = _registry(
    # --- telemetry (innermost leaves) --------------------------------------
    LockSpec(
        "telemetry.metrics", 90, "rlock", f"{_RT}/telemetry.py", "", "_MLOCK",
        "The typed metric registry. Innermost band: every layer above "
        "records metrics while holding its own lock.",
    ),
    LockSpec(
        "telemetry.trace", 91, "lock", f"{_RT}/telemetry.py", "", "_RLOCK",
        "Span/trace buffers and sink list.",
    ),
    LockSpec(
        "telemetry.watchdog", 92, "lock", f"{_RT}/telemetry.py", "", "_WD_LOCK",
        "Retrace-watchdog per-site kernel-build counts.",
    ),
)


def registered_names() -> Tuple[str, ...]:
    return tuple(SPEC)
