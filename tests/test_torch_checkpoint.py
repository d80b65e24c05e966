"""Port parity: checkpoint/resume (``spark_rapids_ml_tpu_torch/runtime/
checkpoint.py``, ``ops/lbfgs.py::minimize_lbfgs_host`` and the streamed
LogisticRegression and KMeans fits that take a checkpointer) against the
JAX package's on the CPU.

The JAX side runs on a one-device mesh (``num_workers=1``) with
``TPUML_CKPT_DIR`` set through ``monkeypatch``; the port with
``device="cpu"`` and ``runtime.checkpoint.CKPT_DIR``. A fit is interrupted
by a chunk source that raises in the first pass that starts after the
checkpoint of iteration 2 was committed, then fitted again.

Tolerances:

* the module (``params_hash``, ``array_digest``, the files) and the
  identity dicts: equal.
* a resumed ``minimize_lbfgs_host`` or fit against the uninterrupted one
  on the CPU: equal, bit for bit (the carry is the whole state and every
  pass is deterministic here).
* a resumed fit against the JAX package's fit: the tolerances the
  streamed fits are held to (``tests/test_torch_streaming_logreg.py``:
  rtol 1e-3 / atol 1e-4; ``tests/test_torch_streaming_kmeans.py``: cost
  and centres 1e-3).
"""

import glob
import json
import os
import shutil

import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.classification import LogisticRegression as JLogReg
from spark_rapids_ml_tpu.clustering import KMeans as JKMeans
from spark_rapids_ml_tpu.core import StreamInputs as JStreamInputs
from spark_rapids_ml_tpu.data import DataFrame as JDataFrame
from spark_rapids_ml_tpu.data import chunks as jchunks
from spark_rapids_ml_tpu.ops import lbfgs as jlbfgs
from spark_rapids_ml_tpu.parallel.mesh import make_mesh
from spark_rapids_ml_tpu.runtime import checkpoint as jckpt
from spark_rapids_ml_tpu_torch import DataFrame as TDataFrame
from spark_rapids_ml_tpu_torch.classification import LogisticRegression as TLogReg
from spark_rapids_ml_tpu_torch.clustering import KMeans as TKMeans
from spark_rapids_ml_tpu_torch.core import StreamInputs
from spark_rapids_ml_tpu_torch.data import chunks as tchunks
from spark_rapids_ml_tpu_torch.ops import lbfgs as tlbfgs
from spark_rapids_ml_tpu_torch.ops import streaming as st
from spark_rapids_ml_tpu_torch.runtime import checkpoint as tckpt

CPU = torch.device("cpu")
PARAMS = {"k": 5, "tol": 1e-4, "init": "random", "centers0": "ab" * 32, "n_rows": 1000}


# ---------------------------------------------------------------------------
# the module against the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arr", [np.arange(12, dtype=np.float32).reshape(3, 4), np.zeros((0, 5)),
                                 np.array([1.5, -2.0], np.float64), np.array(3, np.int64)])
def test_array_digest_matches_jax(arr):
    assert tckpt.array_digest(arr) == jckpt.array_digest(arr)


@pytest.mark.parametrize("params", [PARAMS, {}, {"l1": 0.1 * 3, "multinomial": True, "tol": 1e-30},
                                    {"b": None, "a": [1, 2], "z": "x"}])
def test_params_hash_matches_jax(params):
    assert tckpt.params_hash(params) == jckpt.params_hash(params)


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=7), "S": rng.normal(size=(3, 7)), "centers": rng.normal(size=(5, 2)).astype(
        np.float32)}


@pytest.mark.parametrize("writer,reader", [(tckpt, jckpt), (jckpt, tckpt), (tckpt, tckpt)])
def test_a_checkpoint_loads_in_either_package(tmp_path, writer, reader):
    arrays, extra = _arrays(), {"f": 0.1 + 0.2, "converged": False, "prev_shift": 1e-300}
    writer.FitCheckpointer("kmeans", PARAMS, str(tmp_path)).save(3, arrays, extra)
    it, got, got_extra = reader.FitCheckpointer("kmeans", PARAMS, str(tmp_path)).load()
    assert it == 3 and got_extra == extra and set(got) == set(arrays)
    for k, v in arrays.items():
        assert got[k].dtype == v.dtype and got[k].tobytes() == v.tobytes(), k
    stem = f"kmeans-{tckpt.params_hash(PARAMS)[:16]}"
    assert sorted(os.listdir(tmp_path)) == [stem + ".json", stem + ".npz"]


def _manifest(tmp_path):
    (path,) = glob.glob(str(tmp_path / "*.json"))
    return path


@pytest.mark.parametrize("fault", ["version", "hash", "algo", "corrupt_json", "corrupt_npz", "missing_array",
                                   "missing_npz"])
def test_mismatch_or_corruption_cold_starts(tmp_path, fault):
    ck = tckpt.FitCheckpointer("logreg", PARAMS, str(tmp_path))
    ck.save(2, _arrays())
    assert ck.load() is not None
    path = _manifest(tmp_path)
    man = json.loads(open(path).read())
    if fault == "version":
        man["version"] = tckpt.CKPT_VERSION + 1
    elif fault == "algo":
        man["algo"] = "kmeans"
    elif fault == "missing_array":
        man["arrays"] = man["arrays"] + ["Y"]
    if fault in ("version", "algo", "missing_array"):
        open(path, "w").write(json.dumps(man))
    elif fault == "hash":
        ck = tckpt.FitCheckpointer("logreg", {**PARAMS, "k": 6}, str(tmp_path))
    elif fault == "corrupt_json":
        open(path, "w").write("{not json")
    elif fault == "corrupt_npz":
        open(path[:-5] + ".npz", "wb").write(b"PK\x03\x04 truncated")
    else:
        os.unlink(path[:-5] + ".npz")
    assert ck.load() is None
    # the JAX package cold-starts on the same files
    jck = jckpt.FitCheckpointer("logreg", {**PARAMS, "k": 6} if fault == "hash" else PARAMS, str(tmp_path))
    assert jck.load() is None


@pytest.mark.parametrize("every", [1, 2, 3])
def test_save_cadence_and_clear(tmp_path, every):
    ck = tckpt.FitCheckpointer("kmeans", PARAMS, str(tmp_path / "sub"), every=every)
    saved = []
    for it in range(0, 7):
        ck.maybe_save(it, {"centers": np.full((2, 2), it, np.float32)}, {"prev_shift": float(it)})
        got = ck.load()
        saved.append(None if got is None else got[0])
    want, last = [], None
    for it in range(0, 7):
        last = it if it > 0 and it % every == 0 else last
        want.append(last)
    assert saved == want
    ck.clear()
    assert os.listdir(tmp_path / "sub") == [] and ck.load() is None
    ck.clear()  # a second clear is harmless


def test_disabled_checkpointer_does_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert tckpt.CKPT_DIR is None and tckpt.CKPT_EVERY == 1
    ck = tckpt.FitCheckpointer.from_settings("kmeans", PARAMS)
    assert not ck.enabled
    ck.save(1, _arrays())
    ck.maybe_save(2, _arrays())
    assert ck.load() is None
    ck.clear()
    assert os.listdir(tmp_path) == []
    monkeypatch.setattr(tckpt, "CKPT_DIR", str(tmp_path / "c"))
    monkeypatch.setattr(tckpt, "CKPT_EVERY", 3)
    ck = tckpt.FitCheckpointer.from_settings("kmeans", PARAMS)
    assert ck.enabled and ck.every == 3 and ck.ckpt_dir == str(tmp_path / "c")
    assert ck.params_hash == jckpt.FitCheckpointer("kmeans", PARAMS, "x").params_hash


# ---------------------------------------------------------------------------
# the host solver resumed mid-walk
# ---------------------------------------------------------------------------


class _Interrupt(Exception):
    pass


def _value_grad(seed=3, n=300, d=7, l2=0.05, fail_after=None):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    beta = rng.normal(size=d) * (np.arange(d) < 3)
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-X @ beta))).astype(np.float64)
    calls = [0]

    def value_grad(w):
        calls[0] += 1
        if fail_after is not None and calls[0] > fail_after:
            raise _Interrupt()
        z = X @ w[:d] + w[d]
        f = float(np.mean(np.logaddexp(0.0, z) - y * z)) + 0.5 * l2 * float(w[:d] @ w[:d])
        r = (1.0 / (1.0 + np.exp(-z)) - y) / n
        return f, np.concatenate([X.T @ r + l2 * w[:d], [r.sum()]])

    return value_grad, d + 1, calls


@pytest.mark.parametrize("l1,fail_after,history", [(None, 4, 10), (0.02, 7, 3), (None, 8, 2)])
def test_minimize_lbfgs_host_resumes_bit_for_bit(tmp_path, l1, fail_after, history):
    vg, p, calls = _value_grad()
    kw = dict(max_iter=25, tol=1e-12, history=history, l1_weights=None if l1 is None else np.full(p, l1))
    full = tlbfgs.minimize_lbfgs_host(vg, np.zeros(p), **kw)
    n_full = calls[0]
    ck = tckpt.FitCheckpointer("logreg", {"case": fail_after}, str(tmp_path))
    vg_fail, _, _ = _value_grad(fail_after=fail_after)
    with pytest.raises(_Interrupt):
        tlbfgs.minimize_lbfgs_host(vg_fail, np.zeros(p), checkpointer=ck, **kw)
    it0 = ck.load()[0]
    assert 0 < it0 < full.n_iter
    shutil.copytree(tmp_path, tmp_path.parent / (tmp_path.name + "_jax"))
    vg2, _, calls2 = _value_grad()
    res = tlbfgs.minimize_lbfgs_host(vg2, np.zeros(p), checkpointer=ck, **kw)
    assert res.w.tobytes() == full.w.tobytes() and res.f == full.f
    assert res.n_iter == full.n_iter and res.converged == full.converged
    assert calls2[0] < n_full  # the evaluations before the checkpoint were skipped
    assert os.listdir(tmp_path) == []
    # the JAX solver resumed from the same files walks to the same point
    jdir = str(tmp_path.parent / (tmp_path.name + "_jax"))
    vg3, _, _ = _value_grad()
    jres = jlbfgs.minimize_lbfgs_host(vg3, np.zeros(p), checkpointer=jckpt.FitCheckpointer(
        "logreg", {"case": fail_after}, jdir), **kw)
    assert np.asarray(jres.w).tobytes() == res.w.tobytes() and int(jres.n_iter) == res.n_iter
    assert os.listdir(jdir) == []


# ---------------------------------------------------------------------------
# the streamed fits interrupted and resumed
# ---------------------------------------------------------------------------


def _committed(ckpt_dir):
    """The iteration of the committed checkpoint in ``ckpt_dir``, else 0."""
    its = [json.loads(open(p).read())["iteration"] for p in glob.glob(os.path.join(ckpt_dir, "*.json"))]
    return max(its, default=0)


def _interrupting(base, ckpt_dir, after=2):
    """A chunk source of ``base``'s class whose every pass that starts
    after the checkpoint of iteration ``after`` was committed raises after
    its first chunk."""

    class Interrupting(base):
        def iter_chunks(self, chunk_rows, dtype=np.float32):
            armed = _committed(ckpt_dir) >= after
            for i, c in enumerate(super().iter_chunks(chunk_rows, dtype)):
                if armed and i == 1:
                    raise _Interrupt("interrupted")
                yield c

    return Interrupting


def _binomial(n=400, d=6, seed=0):
    rng = np.random.default_rng(seed)
    Z = rng.normal(size=(n, d)) * rng.uniform(0.5, 2.0, size=d)
    p = 1.0 / (1.0 + np.exp(-(Z @ rng.normal(size=d) + 0.3)))
    return (Z + 2.0).astype(np.float32), (rng.uniform(size=n) < p).astype(np.float32)


def _blobs(n=420, d=6, k=5, seed=10):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)) * 8.0 + 3.0
    return (centers[rng.integers(0, k, size=n)] + rng.normal(size=(n, d))).astype(np.float32)


def _stream_fit(est, source, n_rows, d, chunk):
    """The estimator's streaming fit function on ``source`` (the call its
    ``fit`` makes) with a fresh ingest report: (model, report)."""
    st.reset_ingest_report()
    inputs = StreamInputs(source=source, device=CPU, n_rows=n_rows, n_features=d, chunk_rows=chunk)
    model = est._create_model(est._get_streaming_fit_func(None)(inputs, dict(est._tpu_params)))
    return model, st.last_ingest_report()


LR_CONFIGS = [dict(regParam=0.01, maxIter=8), dict(regParam=0.05, elasticNetParam=0.5, maxIter=8)]


@pytest.mark.parametrize("kwargs", LR_CONFIGS)
def test_streamed_logreg_resumes_bit_for_bit(tmp_path, monkeypatch, kwargs):
    X, y = _binomial()
    n, d = X.shape
    est = TLogReg(device="cpu", **kwargs)
    full, rep_full = _stream_fit(est, tchunks.ArrayChunkSource(X, y), n, d, 56)
    assert full.n_iter_ > 3
    monkeypatch.setattr(tckpt, "CKPT_DIR", str(tmp_path))
    src = _interrupting(tchunks.ArrayChunkSource, str(tmp_path))(X, y)
    with pytest.raises(_Interrupt):
        _stream_fit(est, src, n, d, 56)
    done = st.last_ingest_report()["passes"]["objective"] - 1  # the objective passes completed
    assert _committed(str(tmp_path)) == 2
    resumed, rep = _stream_fit(est, tchunks.ArrayChunkSource(X, y), n, d, 56)
    assert resumed.coefficientMatrix.tobytes() == full.coefficientMatrix.tobytes()
    assert resumed.interceptVector.tobytes() == full.interceptVector.tobytes()
    assert resumed.n_iter_ == full.n_iter_
    assert rep["passes"]["objective"] == rep_full["passes"]["objective"] - done
    assert rep["passes"]["moments"] == 1 and rep["passes"]["labels"] == 1
    assert os.listdir(tmp_path) == []
    # and the JAX package's streamed fit of the same rows
    j = JLogReg(num_workers=1, streaming=True, stream_chunk_rows=56, **kwargs).fit(
        JDataFrame({"features": X, "label": y}))
    np.testing.assert_allclose(resumed.coefficientMatrix, j.coefficientMatrix, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(resumed.interceptVector, j.interceptVector, rtol=1e-3, atol=1e-4)


def test_streamed_logreg_estimator_resumes_and_clears(tmp_path, monkeypatch):
    """Through ``fit``: a refit after a completed one starts cold (the
    files were cleared) and equals it."""
    X, y = _binomial(seed=4)
    df = TDataFrame({"features": X, "label": y})
    kw = dict(regParam=0.01, maxIter=6, device="cpu", streaming=True, stream_chunk_rows=64)
    base = TLogReg(**kw).fit(df)
    monkeypatch.setattr(tckpt, "CKPT_DIR", str(tmp_path))
    a = TLogReg(**kw).fit(df)
    assert os.listdir(tmp_path) == []
    assert a.coefficientMatrix.tobytes() == base.coefficientMatrix.tobytes()
    assert a._ingest_report["passes"] == base._ingest_report["passes"]


@pytest.mark.parametrize("init", ["random", "k-means||"])
def test_streamed_kmeans_resumes_bit_for_bit(tmp_path, monkeypatch, init):
    X = _blobs()
    n, d = X.shape
    est = TKMeans(k=5, initMode=init, seed=7, maxIter=4, tol=0.0, device="cpu")
    full, rep_full = _stream_fit(est, tchunks.ArrayChunkSource(X), n, d, 64)
    assert full.numIter == 4 and rep_full["passes"]["lloyd"] == 4
    monkeypatch.setattr(tckpt, "CKPT_DIR", str(tmp_path))
    src = _interrupting(tchunks.ArrayChunkSource, str(tmp_path))(X)
    with pytest.raises(_Interrupt):
        _stream_fit(est, src, n, d, 64)
    assert st.last_ingest_report()["passes"]["lloyd"] == 3 and _committed(str(tmp_path)) == 2
    resumed, rep = _stream_fit(est, tchunks.ArrayChunkSource(X), n, d, 64)
    assert resumed.cluster_centers_.tobytes() == full.cluster_centers_.tobytes()
    assert resumed.trainingCost == full.trainingCost and resumed.numIter == 4
    assert rep["passes"]["lloyd"] == 2 and rep["passes"]["cost"] == 1
    assert os.listdir(tmp_path) == []
    j = JKMeans(k=5, initMode=init, seed=7, maxIter=4, tol=0.0, num_workers=1, streaming=True,
                stream_chunk_rows=64).fit(JDataFrame({"features": X}))
    assert abs(resumed.trainingCost - j.trainingCost) / j.trainingCost < 1e-3
    assert np.abs(resumed.cluster_centers_ - j.cluster_centers_).max() < 1e-3


def test_port_resumes_a_jax_kmeans_checkpoint(tmp_path, monkeypatch):
    """The JAX package's streamed KMeans, interrupted after iteration 2,
    leaves files the port's fit of the same rows and params resumes."""
    X = _blobs(seed=12)
    n, d = X.shape
    kw = dict(k=5, initMode="random", seed=3, maxIter=4, tol=0.0)
    full, _ = _stream_fit(TKMeans(device="cpu", **kw), tchunks.ArrayChunkSource(X), n, d, 64)
    monkeypatch.setenv("TPUML_CKPT_DIR", str(tmp_path))
    jest = JKMeans(num_workers=1, **kw)
    jsrc = _interrupting(jchunks.ArrayChunkSource, str(tmp_path))(X)
    with pytest.raises(_Interrupt):
        jest._get_tpu_streaming_fit_func(None)(
            JStreamInputs(source=jsrc, mesh=make_mesh(1), n_rows=n, n_features=d, chunk_rows=64),
            dict(jest._tpu_params))
    assert _committed(str(tmp_path)) == 2
    monkeypatch.setattr(tckpt, "CKPT_DIR", str(tmp_path))
    resumed, rep = _stream_fit(TKMeans(device="cpu", **kw), tchunks.ArrayChunkSource(X), n, d, 64)
    assert rep["passes"]["lloyd"] == 2 and os.listdir(tmp_path) == []
    assert abs(resumed.trainingCost - full.trainingCost) / full.trainingCost < 1e-3
    assert np.abs(resumed.cluster_centers_ - full.cluster_centers_).max() < 1e-3


# ---------------------------------------------------------------------------
# the identity dicts against the JAX package's
# ---------------------------------------------------------------------------


def _capture(monkeypatch, module, name):
    seen = []
    real = getattr(module.FitCheckpointer, name).__func__

    def spy(cls, algo, params):
        seen.append((algo, dict(params)))
        return real(cls, algo, params)

    monkeypatch.setattr(module.FitCheckpointer, name, classmethod(spy))
    return seen


@pytest.mark.parametrize("case", ["logreg", "logreg_multinomial", "kmeans_random", "kmeans_parallel"])
def test_identity_dicts_match_jax(tmp_path, monkeypatch, case):
    t_seen = _capture(monkeypatch, tckpt, "from_settings")
    j_seen = _capture(monkeypatch, jckpt, "from_env")
    kw = dict(streaming=True, stream_chunk_rows=64)
    if case.startswith("logreg"):
        if case == "logreg":
            X, y = _binomial()
        else:
            rng = np.random.default_rng(1)
            X = rng.normal(size=(300, 5)).astype(np.float32)
            y = rng.integers(0, 3, size=300).astype(np.float32)
        p = dict(regParam=0.02, elasticNetParam=0.3, maxIter=3, tol=1e-5, standardization=False)
        TLogReg(device="cpu", **kw, **p).fit(TDataFrame({"features": X, "label": y}))
        JLogReg(num_workers=1, **kw, **p).fit(JDataFrame({"features": X, "label": y}))
    else:
        X = _blobs()
        p = dict(k=5, initMode="random" if case == "kmeans_random" else "k-means||", seed=9, maxIter=3, tol=1e-3)
        TKMeans(device="cpu", **kw, **p).fit(TDataFrame({"features": X}))
        JKMeans(num_workers=1, **kw, **p).fit(JDataFrame({"features": X}))
    assert len(t_seen) == len(j_seen) == 1
    assert t_seen[0] == j_seen[0]
