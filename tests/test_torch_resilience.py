"""Port parity: fault injection, retries, chunk halving and the
checkpoint/resume of GBT and UMAP (``spark_rapids_ml_tpu_torch/runtime/
{faults,retry}.py``, ``ops/streaming.py``, ``models/tree.py``,
``models/umap.py``) against the JAX package on the CPU.

Each package is set its own way: the JAX side through ``TPUML_FAULT_SPEC``
/ ``TPUML_RETRIES`` / ``TPUML_BACKOFF_MS`` / ``TPUML_CKPT_DIR`` /
``TPUML_CKPT_EVERY`` / ``TPUML_RF_CHECK_FINITE`` (``monkeypatch.setenv``),
the port through its module constants ``runtime.faults.FAULT_SPEC``,
``runtime.retry.RETRIES`` / ``BACKOFF_MS``, ``runtime.checkpoint.
CKPT_DIR`` / ``CKPT_EVERY`` and ``models.tree.RF_CHECK_FINITE``
(``monkeypatch.setattr``). The port runs with ``device="cpu"``, the JAX
side with ``num_workers=1``; both get the same numpy-seeded rows.

Tolerances, each stated where it is held:

* The grammar, the injector, the backoff schedule, ``_split_chunk`` and
  the lock catalog: equal to the JAX package's.
* A fit with a retried chunk, a resumed fit and a segmented UMAP walk
  against the same uninterrupted fit of the port: equal, bit for bit (the
  chunk shapes are the same and every fold is deterministic here).
* A fit with a halved chunk against its unfaulted twin: the JAX test's
  rtol 1e-4, atol 1e-5 (two halves fold in another f32 order).
* A faulted port fit against the JAX package's faulted fit: the
  tolerances its unfaulted streamed fits are held to
  (``tests/test_torch_streaming*.py``: LogisticRegression rtol 1e-3, atol
  1e-4; PCA components 1e-4 up to sign; KMeans centres 1e-3).
* GBT resumed: the port's predictions and tables equal its
  uninterrupted fit's, and its predictions the JAX package's resumed
  fit's (the packages grow the same trees at GBT's defaults).
"""

import logging
import os
import threading

import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.classification import GBTClassifier as JGBTC
from spark_rapids_ml_tpu.classification import LogisticRegression as JLogReg
from spark_rapids_ml_tpu.clustering import KMeans as JKMeans
from spark_rapids_ml_tpu.data import DataFrame as JDataFrame
from spark_rapids_ml_tpu.data.chunks import Chunk as JChunk
from spark_rapids_ml_tpu.feature import PCA as JPCA
from spark_rapids_ml_tpu.ops import streaming as jst
from spark_rapids_ml_tpu.runtime import counters as jcounters
from spark_rapids_ml_tpu.runtime import faults as jfaults
from spark_rapids_ml_tpu.runtime import lockspec as jlockspec
from spark_rapids_ml_tpu.runtime import retry as jretry
from spark_rapids_ml_tpu.umap import UMAP as JUMAP
from spark_rapids_ml_tpu_torch import DataFrame as TDataFrame
from spark_rapids_ml_tpu_torch import GBTClassifier, RandomForestClassifier, UMAP
from spark_rapids_ml_tpu_torch.classification import LogisticRegression as TLogReg
from spark_rapids_ml_tpu_torch.clustering import KMeans as TKMeans
from spark_rapids_ml_tpu_torch.data.chunks import Chunk
from spark_rapids_ml_tpu_torch.feature import PCA as TPCA
from spark_rapids_ml_tpu_torch.models import tree as ttree
from spark_rapids_ml_tpu_torch.ops import streaming as st
from spark_rapids_ml_tpu_torch.ops import umap_kernels as tuk
from spark_rapids_ml_tpu_torch.runtime import checkpoint as tckpt
from spark_rapids_ml_tpu_torch.runtime import counters, faults, lockspec, retry, telemetry

CPU = torch.device("cpu")
_JAX_ENV = ("TPUML_CKPT_DIR", "TPUML_CKPT_EVERY", "TPUML_RETRIES", "TPUML_BACKOFF_MS", "TPUML_FAULT_SPEC",
            "TPUML_RF_CHECK_FINITE")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in _JAX_ENV:
        monkeypatch.delenv(var, raising=False)
    for mod, name in ((faults, "FAULT_SPEC"), (retry, "RETRIES"), (retry, "BACKOFF_MS"), (tckpt, "CKPT_DIR"),
                      (tckpt, "CKPT_EVERY"), (ttree, "RF_CHECK_FINITE")):
        monkeypatch.setattr(mod, name, getattr(mod, name))
    faults.reset_faults()
    jfaults.reset_faults()
    counters.reset()
    jcounters.reset()
    yield
    faults.reset_faults()
    jfaults.reset_faults()
    counters.reset()
    jcounters.reset()


def _set(monkeypatch, *, spec=None, retries=None, backoff=None, ckpt_dir=None, every=None):
    """The same settings in both packages: the JAX package's variables and
    the port's constants; both injectors rebuilt."""
    for env, mod, name, v in (("TPUML_FAULT_SPEC", faults, "FAULT_SPEC", spec),
                              ("TPUML_RETRIES", retry, "RETRIES", retries),
                              ("TPUML_BACKOFF_MS", retry, "BACKOFF_MS", backoff),
                              ("TPUML_CKPT_DIR", tckpt, "CKPT_DIR", ckpt_dir),
                              ("TPUML_CKPT_EVERY", tckpt, "CKPT_EVERY", every)):
        if v is None:
            continue
        monkeypatch.setenv(env, str(v))
        monkeypatch.setattr(mod, name, v)
    faults.reset_faults()
    jfaults.reset_faults()


# ---------------------------------------------------------------------------
# the fault grammar and the injector
# ---------------------------------------------------------------------------

VALID_SPECS = ["ingest:chunk:3:raise, sgd:epoch:5:preempt,init:connect:2:oom", "", " , ",
               "gbt:round:0:preempt,gbt:round:0:raise", "sched:dispatch:1:raise,sched:admit:0:oom",
               "serve:admit:4:raise,swap:flip:0:preempt,ingest:chunk: 7 :oom"]
BAD_SPECS = ["sgd:epoch:raise", "bogus:site:0:raise", "sgd:epoch:0:explode", "sgd:epoch:x:raise",
             "sgd:epoch:-1:raise", "a:b:c:d:e", "sgd:epoch:1.5:oom"]


@pytest.mark.parametrize("spec", VALID_SPECS)
def test_fault_spec_parses_as_jax(spec):
    assert faults.parse_fault_spec(spec) == jfaults.parse_fault_spec(spec)
    assert faults.SITES == jfaults.SITES and faults.ACTIONS == jfaults.ACTIONS


@pytest.mark.parametrize("bad", BAD_SPECS)
def test_fault_spec_rejects_malformed_as_jax(bad):
    with pytest.raises(faults.FaultSpecError) as t:
        faults.parse_fault_spec(bad)
    with pytest.raises(jfaults.FaultSpecError) as j:
        jfaults.parse_fault_spec(bad)
    assert str(t.value) == str(j.value).replace("TPUML_FAULT_SPEC", "runtime.faults.FAULT_SPEC")


def test_injector_fires_exactly_once_at_index():
    for mod in (faults, jfaults):
        inj = mod.FaultInjector("sgd:epoch:2:raise,sgd:epoch:4:oom")
        inj.hit("sgd:epoch")
        inj.hit("sgd:epoch")
        with pytest.raises(mod.InjectedFault, match=r"sgd:epoch\[2\]"):
            inj.hit("sgd:epoch")
        assert inj.active_sites() == ("sgd:epoch",)
        inj.hit("sgd:epoch")
        with pytest.raises(mod.InjectedResourceExhausted):
            inj.hit("sgd:epoch")
        assert inj.active_sites() == ()
        for _ in range(10):  # spent: the resumed fit sails through
            inj.hit("sgd:epoch")


def test_injector_actions_map_to_exception_types():
    for mod, rmod in ((faults, retry), (jfaults, jretry)):
        inj = mod.FaultInjector("ingest:chunk:0:oom,init:connect:0:preempt,gbt:round:0:raise")
        with pytest.raises(mod.InjectedResourceExhausted) as ei:
            inj.hit("ingest:chunk")
        assert rmod.is_resource_exhausted(ei.value)
        with pytest.raises(mod.SimulatedPreemption):
            inj.hit("init:connect")
        with pytest.raises(mod.InjectedFault) as ef:
            inj.hit("gbt:round")
        assert not rmod.is_resource_exhausted(ef.value)


def test_fault_site_follows_the_constant(monkeypatch):
    for _ in range(5):
        faults.fault_site("sgd:epoch")
    assert not faults.fault_sites_active("sgd:epoch")
    _set(monkeypatch, spec="sgd:epoch:1:raise")
    seen = {}
    for name, mod in (("port", faults), ("jax", jfaults)):
        assert mod.fault_sites_active("sgd:epoch")
        out = []
        for _ in range(4):
            try:
                mod.fault_site("sgd:epoch")
                out.append("ok")
            except mod.InjectedFault:
                out.append("fault")
        seen[name] = out
        assert not mod.fault_sites_active("sgd:epoch")  # spent
    assert seen["port"] == seen["jax"] == ["ok", "fault", "ok", "ok"]
    # a new value of the constant is a new plan
    monkeypatch.setattr(faults, "FAULT_SPEC", "sgd:epoch:0:preempt")
    with pytest.raises(faults.SimulatedPreemption):
        faults.fault_site("sgd:epoch")
    monkeypatch.setattr(faults, "FAULT_SPEC", "sgd:epoch:q:raise")
    with pytest.raises(faults.FaultSpecError, match="runtime.faults.FAULT_SPEC"):
        faults.fault_site("sgd:epoch")


def test_fired_fault_is_counted_by_kind():
    inj = faults.FaultInjector("sgd:epoch:0:oom,gbt:round:0:raise")
    for site in ("sgd:epoch", "gbt:round"):
        with pytest.raises(RuntimeError):
            inj.hit(site)
    series = telemetry.metrics_snapshot()["fault_injections"]["series"]
    assert {s["labels"]["kind"]: s["value"] for s in series} == {"oom": 1, "raise": 1}


# ---------------------------------------------------------------------------
# the backoff schedule and with_retries
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("retries,base,seed", [(6, 100.0, 3), (3, 1.0, 0), (20, 5000.0, 11), (0, 100.0, 1)])
def test_backoff_schedule_matches_jax(retries, base, seed):
    got = retry.backoff_schedule(retries, base, seed=seed)
    assert got == jretry.backoff_schedule(retries, base, seed=seed)
    for a, d in enumerate(got):
        cap = min(base * 2.0 ** a, 30_000.0)
        assert 0.5 * cap <= d < cap


def test_with_retries_inert_at_zero_budget():
    calls = []

    def boom():
        calls.append(1)
        raise RuntimeError("x")

    with pytest.raises(RuntimeError):
        retry.with_retries(boom, what="t")
    assert calls == [1] and counters.delta_since({}) == {}


def test_with_retries_recovers_and_counts():
    calls, slept = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise ConnectionError("not up yet")
        return "ok"

    assert retry.with_retries(flaky, what="t", retries=3, backoff_ms=10.0, sleep=slept.append) == "ok"
    assert len(calls) == 3 and counters.get("retries") == 2
    assert slept == [d / 1e3 for d in retry.backoff_schedule(3, 10.0)[:2]]


def test_with_retries_gives_up_and_never_retries_a_preemption():
    calls = []

    def always():
        calls.append(1)
        raise OSError("down")

    with pytest.raises(OSError):
        retry.with_retries(always, what="t", retries=2, backoff_ms=1.0, sleep=lambda s: None)
    assert len(calls) == 3 and counters.get("retries") == 2
    calls.clear()

    def preempted():
        calls.append(1)
        raise faults.SimulatedPreemption("p")

    with pytest.raises(faults.SimulatedPreemption):
        retry.with_retries(preempted, what="t", retries=5, backoff_ms=1.0, sleep=lambda s: None)
    assert calls == [1]
    with pytest.raises(faults.InjectedResourceExhausted):
        retry.with_retries(lambda: (_ for _ in ()).throw(faults.InjectedResourceExhausted("s")), what="t",
                           retries=5, giveup=retry.is_resource_exhausted, sleep=lambda s: None)
    assert counters.get("retries") == 2


def test_resource_exhausted_classifier():
    oom = getattr(torch, "OutOfMemoryError", None) or torch.cuda.OutOfMemoryError
    assert retry.is_resource_exhausted(oom("CUDA out of memory. Tried to allocate 2.00 GiB"))
    assert retry.is_resource_exhausted(faults.InjectedResourceExhausted("ingest:chunk[1]"))
    assert retry.is_resource_exhausted(RuntimeError("RESOURCE_EXHAUSTED: out of HBM"))
    # a launch error is not an allocator failure
    assert not retry.is_resource_exhausted(RuntimeError("CUDA error: an illegal memory access was encountered"))
    assert not retry.is_resource_exhausted(faults.InjectedFault("injected fault at ingest:chunk[2]"))
    with pytest.raises(ValueError, match="RETRIES"):
        retry.RETRIES = -1
        try:
            retry.resolve_retries()
        finally:
            retry.RETRIES = 0


# ---------------------------------------------------------------------------
# chunk halving and the staging loop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows,n_valid,with_y,with_w", [(64, 40, True, False), (7, 7, False, True),
                                                        (65, 3, True, True), (2, 1, False, False)])
def test_split_chunk_matches_jax(rows, n_valid, with_y, with_w):
    rng = np.random.default_rng(rows)
    X = rng.normal(size=(rows, 3)).astype(np.float32)
    y = rng.normal(size=rows).astype(np.float32) if with_y else None
    w = rng.uniform(size=rows).astype(np.float32) if with_w else None
    got = st._split_chunk(Chunk(X=X, n_valid=n_valid, y=y, w=w))
    want = jst._split_chunk(JChunk(X=X, n_valid=n_valid, y=y, w=w), row_mult=1)
    for g, j in zip(got, want):
        assert g.n_valid == j.n_valid
        for k in ("X", "y", "w"):
            a, b = getattr(g, k), getattr(j, k)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
    assert sum(p.n_valid for p in got) == n_valid
    assert st._split_chunk(Chunk(X=X[:1], n_valid=1)) is None


def test_stage_chunks_halves_retries_and_passes_preemption(monkeypatch):
    X = np.arange(64 * 3, dtype=np.float32).reshape(64, 3)
    chunk = Chunk(X=X, n_valid=50, y=np.arange(64, dtype=np.float32))
    # no budget: one piece, the fault raises
    _set(monkeypatch, spec="ingest:chunk:0:oom")
    with pytest.raises(faults.InjectedResourceExhausted):
        list(st.stage_chunks(chunk, CPU))
    # oom on the whole chunk and again on its first half: 16 + 16 + 32 rows
    _set(monkeypatch, spec="ingest:chunk:0:oom,ingest:chunk:1:oom", retries=2, backoff=1.0)
    pieces = list(st.stage_chunks(chunk, CPU))
    assert [p.X.shape[0] for p, _ in pieces] == [16, 16, 32] and counters.get("chunk_halvings") == 2
    assert [int(dev["mask"].sum()) for _, dev in pieces] == [16, 16, 18]
    np.testing.assert_array_equal(torch.cat([dev["X"] for _, dev in pieces]).numpy(), X)
    np.testing.assert_array_equal(torch.cat([dev["y"] for _, dev in pieces]).numpy(), chunk.y)
    # two failures within a budget of two: one piece, two retries
    _set(monkeypatch, spec="ingest:chunk:0:raise,ingest:chunk:1:raise")
    assert len(list(st.stage_chunks(chunk, CPU))) == 1 and counters.get("retries") == 2
    # three: the budget is spent
    _set(monkeypatch, spec="ingest:chunk:0:raise,ingest:chunk:1:raise,ingest:chunk:2:raise")
    with pytest.raises(faults.InjectedFault):
        list(st.stage_chunks(chunk, CPU))
    _set(monkeypatch, spec="ingest:chunk:0:preempt")
    with pytest.raises(faults.SimulatedPreemption):
        list(st.stage_chunks(chunk, CPU))
    assert counters.get("retries") == 4


def test_the_ring_is_bypassed_only_under_a_budget(monkeypatch):
    rows = np.random.default_rng(1).normal(size=(200, 4)).astype(np.float32)
    src = __import__("spark_rapids_ml_tpu_torch.data.chunks", fromlist=["x"]).ArrayChunkSource(rows)
    used = []
    real_ring, real_stage = st._staged_chunks, st.stage_chunks
    monkeypatch.setattr(st, "_staged_chunks", lambda *a, **k: (used.append("ring"), real_ring(*a, **k))[1])
    monkeypatch.setattr(st, "stage_chunks", lambda *a, **k: (used.append("serial"), real_stage(*a, **k))[1])
    monkeypatch.setattr(st, "_STAGE_DEPTH", 2)
    a = [dev["X"].clone() for _, dev in st.iter_device_chunks(src, CPU, 64)]
    assert used == ["ring"]
    used.clear()
    _set(monkeypatch, retries=1)
    b = [dev["X"].clone() for _, dev in st.iter_device_chunks(src, CPU, 64)]
    assert used == ["serial"] * 4
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# streamed fits under injected faults, against the JAX package's
# ---------------------------------------------------------------------------


def _blobs(n=256, d=5, seed=42):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    X[:64] += 4.0
    X[64:128] -= 4.0
    y = (X[:, 0] + 0.5 * X[:, 1] + 0.3 * rng.normal(size=n) > 0).astype(np.float32)
    return X, y


_STREAM = dict(streaming=True, stream_chunk_rows=64)
_FITS = {
    "kmeans": (lambda: TKMeans(k=4, maxIter=6, tol=1e-8, seed=5, device="cpu", **_STREAM),
               lambda: JKMeans(k=4, maxIter=6, tol=1e-8, seed=5, num_workers=1, **_STREAM)),
    "pca": (lambda: TPCA(k=2, device="cpu", **_STREAM), lambda: JPCA(k=2, num_workers=1, **_STREAM)),
    "logreg": (lambda: TLogReg(maxIter=15, regParam=0.01, tol=1e-10, device="cpu", **_STREAM),
               lambda: JLogReg(maxIter=15, regParam=0.01, tol=1e-10, num_workers=1, **_STREAM)),
}


def _coef(name, m):
    if name == "kmeans":
        return np.asarray(m.cluster_centers_)
    if name == "pca":
        c = np.asarray(m.components_ if hasattr(m, "components_") else m.pc.T)
        return c * np.sign(c[:, :1])
    return np.append(np.asarray(m.coefficientMatrix).ravel(), np.asarray(m.interceptVector))


def _both(name, X, y):
    t, j = _FITS[name]
    cols = {"features": X} if name != "logreg" else {"features": X, "label": y}
    return t().fit(TDataFrame(cols)), j().fit(JDataFrame(cols))


@pytest.mark.parametrize("name", ["kmeans", "pca", "logreg"])
def test_streamed_fit_survives_injected_oom_by_halving(monkeypatch, name):
    X, y = _blobs()
    clean = _FITS[name][0]().fit(TDataFrame({"features": X, "label": y}))
    _set(monkeypatch, spec="ingest:chunk:1:oom", retries=2, backoff=1.0)
    base, jbase = counters.snapshot(), jcounters.snapshot()
    t, j = _both(name, X, y)
    assert counters.delta_since(base).get("chunk_halvings", 0) >= 1
    assert counters.delta_since(base) == jcounters.delta_since(jbase)
    # every pass stages its 4 chunks, and one chunk of the whole fit twice as halves
    passes = sum(v for k, v in t._ingest_report["passes"].items() if k not in ("labels", "seed_rows"))
    assert t._ingest_report["chunks"] == 4 * passes + counters.delta_since(base)["chunk_halvings"]
    # two halves fold to the whole chunk's sums: the JAX test's tolerance
    np.testing.assert_allclose(_coef(name, t), _coef(name, clean), rtol=1e-4, atol=1e-5)
    tol = {"kmeans": 1e-3, "pca": 1e-4, "logreg": 1e-3}[name]
    np.testing.assert_allclose(_coef(name, t), _coef(name, j), rtol=tol, atol=tol * 0.1)


@pytest.mark.parametrize("name", ["pca", "logreg"])
def test_a_retried_chunk_changes_nothing(monkeypatch, name):
    X, y = _blobs(seed=3)
    df = TDataFrame({"features": X, "label": y})
    clean = _FITS[name][0]().fit(df)
    _set(monkeypatch, spec="ingest:chunk:2:raise", retries=2, backoff=1.0)
    base = counters.snapshot()
    got = _FITS[name][0]().fit(df)
    assert counters.delta_since(base) == {"retries": 1}
    assert _coef(name, got).tobytes() == _coef(name, clean).tobytes()
    _set(monkeypatch, spec="ingest:chunk:2:raise", retries=0)
    with pytest.raises(faults.InjectedFault):
        _FITS[name][0]().fit(df)


@pytest.mark.parametrize("name,spec,at", [("kmeans", "sgd:epoch:2:preempt", 2), ("logreg", "sgd:epoch:3:preempt", 3)])
def test_streamed_fit_preempted_then_resumed_bit_for_bit(monkeypatch, tmp_path, name, spec, at):
    X, y = _blobs(seed=7)
    df = TDataFrame({"features": X, "label": y})
    clean = _FITS[name][0]().fit(df)
    _set(monkeypatch, spec=spec, ckpt_dir=str(tmp_path), every=1)
    with pytest.raises(faults.SimulatedPreemption):
        _FITS[name][0]().fit(df)
    assert os.listdir(tmp_path)
    _set(monkeypatch, spec="")
    base = counters.snapshot()
    resumed = _FITS[name][0]().fit(df)
    assert counters.delta_since(base) == {"resumed_fits": 1, "resumed_from": at}
    assert resumed._resilience_report == {"resumed_fits": 1, "resumed_from": at}
    assert _coef(name, resumed).tobytes() == _coef(name, clean).tobytes()
    assert os.listdir(tmp_path) == []


# ---------------------------------------------------------------------------
# GBT checkpoint/resume
# ---------------------------------------------------------------------------


def _gbt_data():
    rng = np.random.default_rng(3)
    X = rng.normal(size=(256, 6)).astype(np.float32)
    y = (1.3 * X[:, 0] - 0.8 * X[:, 2] + 0.2 * rng.normal(size=256) > 0).astype(np.float32)
    return X, y


def test_gbt_interrupted_then_resumed_equals_uninterrupted_and_jax(monkeypatch, tmp_path):
    X, y = _gbt_data()
    tdf, jdf = TDataFrame({"features": X, "label": y}), JDataFrame({"features": X, "label": y})
    clean = GBTClassifier(maxIter=6, maxDepth=3, seed=11, device="cpu").fit(tdf)
    _set(monkeypatch, spec="gbt:round:3:preempt", ckpt_dir=str(tmp_path / "t"), every=1)
    monkeypatch.setenv("TPUML_CKPT_DIR", str(tmp_path / "j"))
    with pytest.raises(faults.SimulatedPreemption):
        GBTClassifier(maxIter=6, maxDepth=3, seed=11, device="cpu").fit(tdf)
    with pytest.raises(jfaults.SimulatedPreemption):
        JGBTC(maxIter=6, maxDepth=3, seed=11, num_workers=1).fit(jdf)
    _set(monkeypatch, spec="")
    base, jbase = counters.snapshot(), jcounters.snapshot()
    resumed = GBTClassifier(maxIter=6, maxDepth=3, seed=11, device="cpu").fit(tdf)
    jres = JGBTC(maxIter=6, maxDepth=3, seed=11, num_workers=1).fit(jdf)
    assert counters.delta_since(base) == jcounters.delta_since(jbase) == {"resumed_fits": 1, "resumed_from": 3}
    for k in ("features", "threshold_bins", "leaf_values", "leaf_stats", "gains"):
        assert resumed._model_attributes[k].tobytes() == clean._model_attributes[k].tobytes(), k
    pred = resumed.transform(tdf).column("prediction")
    np.testing.assert_array_equal(pred, clean.transform(tdf).column("prediction"))
    np.testing.assert_array_equal(pred, np.asarray(jres.transform(jdf).column("prediction")))
    assert os.listdir(tmp_path / "t") == []


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def test_gbt_checkpoint_cadence_and_round_log(monkeypatch, tmp_path):
    X, y = _gbt_data()
    tdf = TDataFrame({"features": X, "label": y})
    saves = []
    real = tckpt.FitCheckpointer.save
    monkeypatch.setattr(tckpt.FitCheckpointer, "save", lambda self, it, *a, **k: (saves.append(it),
                                                                                  real(self, it, *a, **k))[1])
    _set(monkeypatch, ckpt_dir=str(tmp_path), every=2)
    monkeypatch.setattr(ttree, "GBT_ROUND_LOG_EVERY", 3)
    # the port's loggers hang under one package logger that does not propagate
    pkg, lines = logging.getLogger("spark_rapids_ml_tpu_torch"), _Lines()
    pkg.addHandler(lines)
    try:
        GBTClassifier(maxIter=6, maxDepth=3, seed=1, device="cpu").fit(tdf)
    finally:
        pkg.removeHandler(lines)
    assert saves == [2, 4, 6] and os.listdir(tmp_path) == []
    logged = [m for m in lines.lines if "GBT round" in m]
    assert [m.split(":")[0] for m in logged] == ["GBT round 3/6", "GBT round 6/6"]


def test_gbt_checkpoint_identity_matches_jax(monkeypatch, tmp_path):
    from spark_rapids_ml_tpu.runtime import checkpoint as jckpt

    # the port builds its identity only with checkpointing on
    _set(monkeypatch, ckpt_dir=str(tmp_path))
    seen = {}

    def spy(cls, algo, params, _r, _k):
        params = params() if callable(params) else params
        seen.setdefault(_k, (algo, dict(params)))
        return _r(cls, algo, params)

    for mod, name, key in ((tckpt, "from_settings", "t"), (jckpt, "from_env", "j")):
        real = getattr(mod.FitCheckpointer, name).__func__
        monkeypatch.setattr(mod.FitCheckpointer, name, classmethod(
            lambda cls, algo, params, _r=real, _k=key: spy(cls, algo, params, _r, _k)))
    X, y = _gbt_data()
    GBTClassifier(maxIter=2, maxDepth=3, seed=4, device="cpu").fit(TDataFrame({"features": X, "label": y}))
    JGBTC(maxIter=2, maxDepth=3, seed=4, num_workers=1).fit(JDataFrame({"features": X, "label": y}))
    assert seen["t"] == seen["j"]


def test_checkpoint_identity_not_digested_with_checkpointing_off(monkeypatch):
    """With ``CKPT_DIR`` None the GBT and UMAP fits digest none of their
    arrays for a checkpoint identity."""
    from spark_rapids_ml_tpu_torch.models import tree as ttree
    from spark_rapids_ml_tpu_torch.models import umap as tumap

    digests = []
    for mod in (ttree, tumap):
        monkeypatch.setattr(mod, "array_digest", lambda a: digests.append(a.shape) or "x")
    X, y = _gbt_data()
    GBTClassifier(maxIter=2, maxDepth=3, seed=4, device="cpu").fit(TDataFrame({"features": X, "label": y}))
    _umap().fit(_umap_df()[1])
    assert digests == []


# ---------------------------------------------------------------------------
# UMAP: the segmented walk and its resume
# ---------------------------------------------------------------------------


def _umap_df():
    X = np.random.default_rng(42).normal(size=(60, 6)).astype(np.float32)
    return X, TDataFrame({"features": X})


def _umap(**kw):
    return UMAP(n_neighbors=8, random_state=3, init="random", n_epochs=20, device="cpu", **kw)


def test_umap_segmented_walk_equals_unsegmented(monkeypatch, tmp_path):
    X, df = _umap_df()
    clean = _umap().fit(df).embedding_
    # a pending sgd:epoch fault (never reached) segments the walk epoch by epoch
    _set(monkeypatch, spec="sgd:epoch:100:raise")
    segs = []
    real = tuk.umap_sgd
    monkeypatch.setattr("spark_rapids_ml_tpu_torch.models.umap.umap_sgd",
                        lambda *a, **k: (segs.append(k.get("segment", 0)), real(*a, **k))[1])
    assert _umap().fit(df).embedding_.tobytes() == clean.tobytes()
    # a checkpointer: segments of CKPT_EVERY epochs (20 = 3 x 7 - 1)
    _set(monkeypatch, spec="", ckpt_dir=str(tmp_path), every=7)
    assert _umap().fit(df).embedding_.tobytes() == clean.tobytes()
    assert segs == [1, 7] and os.listdir(tmp_path) == []


def test_umap_preempted_then_resumed_bit_for_bit(monkeypatch, tmp_path):
    X, df = _umap_df()
    clean = _umap().fit(df).embedding_
    _set(monkeypatch, spec="sgd:epoch:2:preempt", ckpt_dir=str(tmp_path / "t"), every=5)
    monkeypatch.setenv("TPUML_CKPT_DIR", str(tmp_path / "j"))
    with pytest.raises(faults.SimulatedPreemption):
        _umap().fit(df)
    with pytest.raises(jfaults.SimulatedPreemption):
        JUMAP(n_neighbors=8, random_state=3, init="random", n_epochs=20, num_workers=1).fit(
            JDataFrame({"features": X}))
    _set(monkeypatch, spec="")
    base, jbase = counters.snapshot(), jcounters.snapshot()
    resumed = _umap().fit(df)
    JUMAP(n_neighbors=8, random_state=3, init="random", n_epochs=20, num_workers=1).fit(JDataFrame({"features": X}))
    # segment boundaries are the fault sites: index 2 -> epoch 10, in both
    assert counters.delta_since(base) == jcounters.delta_since(jbase) == {"resumed_fits": 1, "resumed_from": 10}
    assert resumed._resilience_report == {"resumed_fits": 1, "resumed_from": 10}
    assert resumed.embedding_.tobytes() == clean.tobytes()
    assert os.listdir(tmp_path / "t") == []


def test_umap_sgd_resumed_mid_walk_on_its_own(monkeypatch):
    """``umap_sgd`` from a start epoch with the generator's state and the
    hash seed of that epoch takes the uninterrupted walk's epochs."""
    rng = np.random.default_rng(5)
    n, c, R, K = 40, 2, 40, 4
    emb0 = torch.from_numpy(rng.normal(size=(n, c)).astype(np.float32))
    args = (torch.arange(R, dtype=torch.int32), torch.from_numpy(rng.integers(0, n, (R, K)).astype(np.int32)),
            torch.from_numpy(rng.uniform(0.2, 1.0, (R, K)).astype(np.float32)))
    kw = dict(n_epochs=9, a=1.6, b=0.9, negative_sample_rate=3)
    g = torch.Generator().manual_seed(2)
    whole = tuk.umap_sgd(emb0, emb0, *args, g, **kw)
    g = torch.Generator().manual_seed(2)
    base = tuk.draw_seed_base(g, CPU)
    at = {}
    tuk.umap_sgd(emb0, emb0, *args, g, seed_base=base, segment=4,
                 on_segment=lambda e, emb: at.setdefault(e, (emb.clone(), g.get_state())), **kw)
    assert sorted(at) == [4, 8, 9] and at[9][0].numpy().tobytes() == whole.numpy().tobytes()
    emb4, state4 = at[4]
    g2 = torch.Generator()
    g2.set_state(state4)
    out = tuk.umap_sgd(emb4, emb4, *args, g2, start_epoch=4, seed_base=base, **kw)
    assert out.numpy().tobytes() == whole.numpy().tobytes()


# ---------------------------------------------------------------------------
# the forests' finite-input screen
# ---------------------------------------------------------------------------


def test_rf_check_finite(monkeypatch):
    rng = np.random.default_rng(2)
    X = rng.normal(size=(200, 8)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    m = RandomForestClassifier(numTrees=3, maxDepth=4, seed=1, device="cpu").fit(
        TDataFrame({"features": X, "label": y}))
    clean = m.transform(TDataFrame({"features": X}))
    Xn = X.copy()
    Xn[7, 3] = np.nan
    assert np.asarray(m.transform(TDataFrame({"features": Xn})).column("prediction")).shape == (200,)
    # on: the same model (its transform closure cached) screens every batch
    monkeypatch.setattr(ttree, "RF_CHECK_FINITE", True)
    with pytest.raises(ValueError, match="NaN/Inf"):
        m.transform(TDataFrame({"features": Xn}))
    with pytest.raises(ValueError, match="NaN/Inf"):
        m._apply_batched(m._get_transform_func(engine="bins"), Xn)
    out = m.transform(TDataFrame({"features": X}))
    for col in ("prediction", "probability", "rawPrediction"):
        assert np.asarray(out.column(col)).tobytes() == np.asarray(clean.column(col)).tobytes(), col


# ---------------------------------------------------------------------------
# the lock catalog and the inert defaults
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["scheduler.state", "scheduler.breakers", "admission.ewma", "admission.breaker",
                                  "faults.plan", "faults.cache"])
def test_lock_catalog_entries_match_jax(name):
    t, j = lockspec.SPEC[name], jlockspec.SPEC[name]
    assert (t.name, t.rank, t.kind, t.cls, t.attr) == (j.name, j.rank, j.kind, j.cls, j.attr)
    assert t.module == j.module.replace("spark_rapids_ml_tpu/", "spark_rapids_ml_tpu_torch/")


def test_defaults_are_inert(monkeypatch):
    """Every new constant at its default: a resident and a streamed fit take
    the staging ring and the unsegmented paths, start no thread of the
    scheduler, leave no counter and no fault or scheduler series, and equal
    bit for bit the same fits with the fault sites and preempt points cut
    out (the code paths as they were before them)."""
    assert (faults.FAULT_SPEC, retry.RETRIES, tckpt.CKPT_DIR, ttree.RF_CHECK_FINITE) == ("", 0, None, False)
    X, y = _blobs(seed=9)
    df = TDataFrame({"features": X, "label": y})
    fits = {"kmeans": lambda: TKMeans(k=4, maxIter=5, seed=2, device="cpu").fit(df),
            "logreg": lambda: TLogReg(maxIter=10, regParam=0.01, device="cpu", **_STREAM).fit(df)}
    before = {t.name for t in threading.enumerate()}
    base = counters.snapshot()
    ring = []
    real_ring = st._staged_chunks
    monkeypatch.setattr(st, "_staged_chunks", lambda *a, **k: (ring.append(1), real_ring(*a, **k))[1])
    got = {k: f() for k, f in fits.items()}
    assert ring and counters.delta_since(base) == {}
    assert all(m._resilience_report == {} for m in got.values())
    assert "fit-sched" not in {t.name for t in threading.enumerate()} - before
    snap = telemetry.metrics_snapshot()
    assert not any(k.startswith("sched_") or k in ("fault_injections", "retries", "chunk_halvings") for k in snap)
    import spark_rapids_ml_tpu_torch.ops.lbfgs as tlb

    for mod in (st, tlb):
        monkeypatch.setattr(mod, "fault_site", lambda site: None)
        monkeypatch.setattr(mod, "preempt_point", lambda *a, **k: None)
    cut = {k: f() for k, f in fits.items()}
    assert got["kmeans"].cluster_centers_.tobytes() == cut["kmeans"].cluster_centers_.tobytes()
    assert got["logreg"].coefficientMatrix.tobytes() == cut["logreg"].coefficientMatrix.tobytes()
    from spark_rapids_ml_tpu_torch.runtime.scheduler import preempt_point

    preempt_point(object(), 3, {"w": np.zeros(2)})  # outside a quantum: nothing
