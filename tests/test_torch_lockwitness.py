"""Port parity: the lock-order witness (``spark_rapids_ml_tpu_torch/runtime/
lockwitness.py`` over the port's ``lockspec`` catalog) against the JAX
package's on the CPU.

The same seeded inversions, on the cataloged telemetry locks both
packages share (``telemetry.metrics`` rank 90, ``telemetry.trace`` 91,
``telemetry.watchdog`` 92), run under the JAX package's
``TPUML_LOCK_WITNESS`` set through ``monkeypatch`` and the port's
``lockwitness.MODE``. Tolerances: ``violations()`` and the violation
counter's series are equal; the defaults are raw ``threading`` primitives.
"""

import threading

import pytest

from spark_rapids_ml_tpu.runtime import lockwitness as jlw
from spark_rapids_ml_tpu.runtime import telemetry as jtel
from spark_rapids_ml_tpu_torch.runtime import lockwitness as tlw
from spark_rapids_ml_tpu_torch.runtime import telemetry as ttel


@pytest.fixture(autouse=True)
def _clean():
    for lw, tel in ((jlw, jtel), (tlw, ttel)):
        lw.reset_lockwitness()
        tel.reset_telemetry()
    yield
    for lw, tel in ((jlw, jtel), (tlw, ttel)):
        lw.reset_lockwitness()
        tel.reset_telemetry()


def _mode(monkeypatch, mode):
    monkeypatch.setenv("TPUML_LOCK_WITNESS", mode)
    monkeypatch.setattr(tlw, "MODE", mode)


def _violation_series(tel):
    m = tel.metrics_snapshot().get("lock_order_violations_total")
    return [] if m is None else m["series"]


def _inversion(lw):
    """A worker acquiring rank 90 under rank 92, three times (one
    inversion), then in rank order, which closes a cycle with the edge the
    inversion left (a second pair)."""
    outer = lw.make_lock("telemetry.watchdog")  # rank 92
    inner = lw.make_rlock("telemetry.metrics")  # rank 90
    errors = []

    def worker():
        try:
            for _ in range(3):
                with outer:
                    with inner:
                        with inner:  # an RLock's re-entry is sanctioned
                            pass
            with inner:
                with outer:
                    pass
        except Exception as e:  # count mode never raises
            errors.append(e)

    t = threading.Thread(target=worker, name="lock-inversion", daemon=True)
    t.start()
    t.join(10)
    assert not errors


@pytest.mark.parametrize("mode", ["count", "1"])
def test_inversion_reported_once_as_in_jax(monkeypatch, mode):
    _mode(monkeypatch, mode)
    _inversion(jlw)
    _inversion(tlw)
    assert tlw.violations() == jlw.violations() == (
        ("telemetry.metrics", "telemetry.watchdog"), ("telemetry.watchdog", "telemetry.metrics"))
    assert _violation_series(ttel) == _violation_series(jtel) == [
        {"labels": {"acquired": "telemetry.metrics", "held": "telemetry.watchdog"}, "value": 1},
        {"labels": {"acquired": "telemetry.watchdog", "held": "telemetry.metrics"}, "value": 1}]
    # the witness timed every acquire and release
    snap = ttel.metrics_snapshot()
    assert {s["labels"]["lock"] for s in snap["lock_hold_ms"]["series"]} == {"telemetry.metrics",
                                                                             "telemetry.watchdog"}
    assert {s["labels"]["lock"] for s in snap["lock_wait_ms"]["series"]} == {"telemetry.metrics",
                                                                             "telemetry.watchdog"}


def test_self_nesting_and_cycle_as_in_jax(monkeypatch):
    """A plain Lock taken twice by name is flagged (self-deadlock shape);
    the edge trace -> watchdog then watchdog -> trace closes a cycle."""
    _mode(monkeypatch, "count")
    for lw in (jlw, tlw):
        a, a2 = lw.make_lock("telemetry.trace"), lw.make_lock("telemetry.trace")
        b = lw.make_lock("telemetry.watchdog")
        with a:
            with a2:
                pass
        with a:
            with b:
                pass
        assert lw.violations() == (("telemetry.trace", "telemetry.trace"),)
        with b:
            with a:
                pass
    assert tlw.violations() == jlw.violations() == (
        ("telemetry.trace", "telemetry.trace"), ("telemetry.watchdog", "telemetry.trace"))


def test_raise_mode_raises_and_releases(monkeypatch):
    _mode(monkeypatch, "raise")
    outer = tlw.make_lock("telemetry.watchdog")
    inner = tlw.make_lock("telemetry.trace")
    with outer:
        with pytest.raises(tlw.LockOrderError, match="rank not ascending"):
            with inner:
                pass
    with inner:  # the failed acquire released it
        assert inner.locked()
    assert not inner.locked()


def test_condition_wait_is_not_an_inversion(monkeypatch):
    _mode(monkeypatch, "count")
    lock = tlw.make_lock("telemetry.trace")
    # the Condition(self._lock) idiom: the condition shares the cataloged lock
    cv = tlw.make_condition("telemetry.trace", lock)  # tpuml: ignore[TPU010]
    hits = []

    def waiter():
        with cv:
            cv.wait_for(lambda: hits, timeout=5)

    t = threading.Thread(target=waiter, name="cv-waiter", daemon=True)
    t.start()
    with cv:
        hits.append(1)
        cv.notify_all()
    t.join(10)
    assert tlw.violations() == ()


def test_defaults_are_raw_primitives_and_names_are_checked(monkeypatch):
    assert tlw.MODE == "off" and not tlw.active()
    assert type(tlw.make_lock("telemetry.trace")) is type(threading.Lock())
    assert type(tlw.make_rlock("telemetry.metrics")) is type(threading.RLock())
    shared = tlw.make_lock("telemetry.trace")
    assert isinstance(tlw.make_condition("telemetry.trace", shared), threading.Condition)  # tpuml: ignore[TPU010]
    # the catalog lookup happens in every mode
    for mode in ("off", "count"):
        monkeypatch.setattr(tlw, "MODE", mode)
        # deliberately uncataloged and mis-kinded: the runtime rejections under test
        with pytest.raises(ValueError, match="not a cataloged lock"):
            tlw.make_lock("not.a.lock")  # tpuml: ignore[TPU010]
        with pytest.raises(ValueError, match="cataloged as a rlock"):
            tlw.make_lock("telemetry.metrics")  # tpuml: ignore[TPU010]
    monkeypatch.setattr(tlw, "MODE", "sometimes")
    with pytest.raises(ValueError, match="MODE"):
        tlw.active()
    # the telemetry registries were built through the factories: raw at import
    assert type(ttel._RLOCK) is type(threading.Lock())
    assert type(ttel._MLOCK) is type(threading.RLock())
