"""Port parity: the resilience counters (``spark_rapids_ml_tpu_torch/runtime/
counters.py``) and the models' ``_resilience_report`` against the JAX
package's on the CPU.

The same sequence of bumps and notes runs through both packages'
counters; the streamed LogisticRegression and KMeans are interrupted by a
chunk source that raises in the first pass after the checkpoint of
iteration 2 was committed and fitted again through ``fit``, in both
packages (the JAX side with ``TPUML_CKPT_DIR`` and its streaming threshold
through ``monkeypatch``; the port with ``runtime.checkpoint.CKPT_DIR`` and
``streaming=True``). Tolerances: the deltas and the reports are equal.
"""

import glob
import json
import os

import numpy as np
import pytest

from spark_rapids_ml_tpu.classification import LogisticRegression as JLogReg
from spark_rapids_ml_tpu.clustering import KMeans as JKMeans
from spark_rapids_ml_tpu.data import DataFrame as JDataFrame
from spark_rapids_ml_tpu.data import chunks as jchunks
from spark_rapids_ml_tpu.runtime import counters as jcounters
from spark_rapids_ml_tpu.runtime import telemetry as jtel
from spark_rapids_ml_tpu_torch import DataFrame as TDataFrame
from spark_rapids_ml_tpu_torch.classification import LogisticRegression as TLogReg
from spark_rapids_ml_tpu_torch.clustering import KMeans as TKMeans
from spark_rapids_ml_tpu_torch.core import _TpuModel
from spark_rapids_ml_tpu_torch.data import chunks as tchunks
from spark_rapids_ml_tpu_torch.ops import lbfgs as tlbfgs
from spark_rapids_ml_tpu_torch.runtime import checkpoint as tckpt
from spark_rapids_ml_tpu_torch.runtime import counters as tcounters
from spark_rapids_ml_tpu_torch.runtime import telemetry as ttel


@pytest.fixture(autouse=True)
def _clean():
    jtel.reset_telemetry()
    ttel.reset_telemetry()
    yield
    jtel.reset_telemetry()
    ttel.reset_telemetry()


def _sequence(counters):
    """Deltas over a scripted sequence: counters differ, gauges report
    their value when it changed, unchanged keys are left out."""
    counters.bump("retries")
    counters.note("resumed_from", 4)
    base = counters.snapshot()
    out = [counters.delta_since(base)]
    counters.bump("retries", 3)
    counters.bump("cv_failed_fits")
    counters.note("resumed_from", 4)
    out.append(counters.delta_since(base))
    counters.note("resumed_from", 7)
    counters.bump("resumed_fits")
    out.append(counters.delta_since(base))
    out.append(counters.delta_since({}))
    out.append((counters.get("retries"), counters.get("chunk_halvings"), counters.snapshot()))
    counters.reset()
    out.append(counters.snapshot())
    return out


def test_delta_since_matches_jax():
    got, want = _sequence(tcounters), _sequence(jcounters)
    assert got == want
    assert got[1] == {"retries": 3, "cv_failed_fits": 1}
    assert got[2] == {"retries": 3, "cv_failed_fits": 1, "resumed_from": 7, "resumed_fits": 1}


class _Interrupt(RuntimeError):
    pass


def _committed(ckpt_dir):
    its = [json.loads(open(p).read())["iteration"] for p in glob.glob(os.path.join(ckpt_dir, "*.json"))]
    return max(its, default=0)


def _interrupt_source(monkeypatch, module, ckpt_dir, after=2):
    """Patch ``module.ArrayChunkSource`` so that every pass that starts
    after the checkpoint of iteration ``after`` was committed raises after
    its first chunk; returns the undo."""
    real = module.ArrayChunkSource.iter_chunks

    def iter_chunks(self, chunk_rows, dtype=np.float32):
        armed = _committed(ckpt_dir) >= after
        for i, c in enumerate(real(self, chunk_rows, dtype)):
            if armed and i == 1:
                raise _Interrupt("interrupted")
            yield c

    monkeypatch.setattr(module.ArrayChunkSource, "iter_chunks", iter_chunks)
    return lambda: monkeypatch.setattr(module.ArrayChunkSource, "iter_chunks", real)


def _data(kind):
    rng = np.random.default_rng(21)
    if kind == "logreg":
        Z = rng.normal(size=(400, 6))
        y = (rng.uniform(size=400) < 1.0 / (1.0 + np.exp(-(Z @ rng.normal(size=6))))).astype(np.float32)
        return {"features": (Z + 1.0).astype(np.float32), "label": y}
    centers = rng.normal(size=(5, 6)) * 8.0
    return {"features": (centers[rng.integers(0, 5, size=420)] + rng.normal(size=(420, 6))).astype(np.float32)}


def _fit_interrupted_then_resumed(monkeypatch, make, frame, module, ckpt_dir):
    undo = _interrupt_source(monkeypatch, module, ckpt_dir)
    with pytest.raises(_Interrupt):
        make().fit(frame)
    undo()
    assert _committed(ckpt_dir) == 2
    return make().fit(frame)


@pytest.mark.parametrize("kind", ["logreg", "kmeans"])
def test_resumed_fit_report_matches_jax(monkeypatch, tmp_path, kind):
    cols = _data(kind)
    if kind == "logreg":
        kw = dict(regParam=0.01, maxIter=8)
        jmake = lambda: JLogReg(num_workers=1, stream_chunk_rows=64, **kw)  # noqa: E731
        tmake = lambda: TLogReg(device="cpu", streaming=True, stream_chunk_rows=64, **kw)  # noqa: E731
    else:
        kw = dict(k=5, initMode="random", seed=3, maxIter=5, tol=0.0)
        jmake = lambda: JKMeans(num_workers=1, stream_chunk_rows=64, **kw)  # noqa: E731
        tmake = lambda: TKMeans(device="cpu", streaming=True, stream_chunk_rows=64, **kw)  # noqa: E731
    monkeypatch.setenv("TPUML_STREAM_THRESHOLD_BYTES", "1")
    monkeypatch.setenv("TPUML_CKPT_DIR", str(tmp_path / "jax"))
    jm = _fit_interrupted_then_resumed(monkeypatch, jmake, JDataFrame(dict(cols)), jchunks, str(tmp_path / "jax"))
    monkeypatch.setattr(tckpt, "CKPT_DIR", str(tmp_path / "port"))
    tm = _fit_interrupted_then_resumed(monkeypatch, tmake, TDataFrame(dict(cols)), tchunks, str(tmp_path / "port"))
    assert tm._resilience_report == jm._resilience_report == {"resumed_fits": 1, "resumed_from": 2}
    # a clean refit reports nothing, in both
    assert tmake().fit(TDataFrame(dict(cols)))._resilience_report == {}
    assert jmake().fit(JDataFrame(dict(cols)))._resilience_report == {}


def test_minimize_lbfgs_host_counts_a_resume(monkeypatch, tmp_path):
    rng = np.random.default_rng(2)
    A = rng.normal(size=(50, 4))
    b = rng.normal(size=50)

    def vg(w):
        r = A @ w - b
        return float(r @ r) / 50, 2.0 * A.T @ r / 50

    monkeypatch.setattr(tckpt, "CKPT_DIR", str(tmp_path))
    ck = tckpt.FitCheckpointer.from_settings("lbfgs_test", {"n": 50})
    calls = []

    def failing(w):
        calls.append(1)
        if len(calls) > 4:
            raise _Interrupt("stop")
        return vg(w)

    with pytest.raises(_Interrupt):
        tlbfgs.minimize_lbfgs_host(failing, np.zeros(4), max_iter=10, tol=0.0, checkpointer=ck)
    base = tcounters.snapshot()
    tlbfgs.minimize_lbfgs_host(vg, np.zeros(4), max_iter=10, tol=0.0, checkpointer=ck)
    delta = tcounters.delta_since(base)
    assert delta["resumed_fits"] == 1 and delta["resumed_from"] >= 1


def test_loaded_models_have_an_empty_report():
    assert _TpuModel._resilience_report == {}
