"""Port parity: the streamed path's wire formats (``spark_rapids_ml_tpu_torch/
ops/streaming.py``: ``WIRE_DTYPE`` / ``wire=``, the host encoders, the
once-a-pass resolution and the dequantize after the copy) against the JAX
package's (``TPUML_WIRE_DTYPE``) on the CPU.

The JAX side runs on a one-device mesh (``num_workers=1``), its wire set
through ``TPUML_WIRE_DTYPE`` with ``monkeypatch``; the port with
``device="cpu"``, its wire through ``wire=`` or the module constant.
Inputs come from seeded numpy generators at small sizes, with chunks of a
few dozen rows so that every pass folds several chunks and a ragged last
one.

Tolerances:

* the encoders (int8 ``q``, ``scale``, ``offset``; the f8 bytes), the
  auto probe's errors and its choice: equal, bit for bit.
* the dequantized chunk: within 1 ulp of the JAX package's
  ``QuantizedWire.dense`` (the same two f32 roundings; XLA may fuse them).
* statistics and fits at a narrow wire against the JAX package at the
  same wire: both fold the same dequantized chunks, so they are held as
  the f32 streamed path is held against the JAX package (PRs 21-23):
  statistics within ``8·√n·u`` of the largest entry, PCA rtol 2e-4 / atol
  2e-5, LinearRegression rtol 5e-3 / atol 5e-4, KMeans cost 1e-3 and
  centres 1e-3, LogisticRegression rtol 1e-3 / atol 1e-4.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_ml_tpu.classification import LogisticRegression as JLogReg
from spark_rapids_ml_tpu.clustering import KMeans as JKMeans
from spark_rapids_ml_tpu.data import DataFrame as JDataFrame
from spark_rapids_ml_tpu.data import chunks as jchunks
from spark_rapids_ml_tpu.feature import PCA as JPCA
from spark_rapids_ml_tpu.ops import streaming as jst
from spark_rapids_ml_tpu.parallel.mesh import make_mesh
from spark_rapids_ml_tpu.regression import LinearRegression as JLinReg
from spark_rapids_ml_tpu_torch import DataFrame as TDataFrame
from spark_rapids_ml_tpu_torch.classification import LogisticRegression as TLogReg
from spark_rapids_ml_tpu_torch.clustering import KMeans as TKMeans
from spark_rapids_ml_tpu_torch.data import chunks as tchunks
from spark_rapids_ml_tpu_torch.feature import PCA as TPCA
from spark_rapids_ml_tpu_torch.ops import streaming as st
from spark_rapids_ml_tpu_torch.regression import LinearRegression as TLinReg

CPU = torch.device("cpu")
U = 2.0 ** -24
NARROW = ["f16", "int8", "f8"]


def _band(n):
    return 8.0 * np.sqrt(n) * U


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _reg(n=900, d=8, seed=0, offset=3.0):
    """Features of unequal scales off the origin, labels from a plane plus
    noise, row weights in [0.1, 2]."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)) * rng.uniform(0.5, 3.0, size=d) + offset
    y = (X - offset) @ rng.normal(size=d) + 2.5 + 0.3 * rng.normal(size=n)
    w = rng.uniform(0.1, 2.0, size=n)
    return X.astype(np.float32), y.astype(np.float32), w.astype(np.float32)


def _chunk_x(seed, rows=64, d=7, n_valid=50, const_col=3, dtype=np.float32, pad=1e3):
    """A chunk's rows: unequal scales off the origin, a constant column,
    and padding rows past ``n_valid`` at ``pad`` (outside the valid range
    by default; a chunk source pads with zeros)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, d)) * rng.uniform(0.01, 50.0, size=d) + rng.normal(size=d) * 10
    x[:, const_col] = 2.5
    x[n_valid:] = pad
    return x.astype(dtype)


def _jax_wire(monkeypatch, wire):
    if wire is None:
        monkeypatch.delenv("TPUML_WIRE_DTYPE", raising=False)
    else:
        monkeypatch.setenv("TPUML_WIRE_DTYPE", wire)


# ---------------------------------------------------------------------------
# the host encoders and the dispatch, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,n_valid,dtype", [(0, 50, np.float32), (1, 64, np.float32), (2, 1, np.float32),
                                                (3, 40, np.float16)])
def test_quantize_int8_matches_jax_bit_for_bit(seed, n_valid, dtype):
    x = _chunk_x(seed, n_valid=n_valid, dtype=dtype)
    q, scale, offset = st._quantize_int8(x, n_valid)
    qj, sj, oj = jst._quantize_int8(x, n_valid)
    assert q.dtype == np.int8 and scale.dtype == offset.dtype == np.float32
    for a, b in ((q, qj), (scale, sj), (offset, oj)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert scale[3] == 1.0  # the constant column reconstructs exactly
    assert np.array_equal(q[:n_valid, 3].astype(np.float32) * scale[3] + offset[3], x[:n_valid, 3])


@pytest.mark.parametrize("seed,n_valid", [(0, 50), (1, 64), (4, 7)])
def test_quantize_f8_bytes_equal_ml_dtypes(seed, n_valid):
    """On a chunk as a source makes it (zero padding rows). Padding rows
    past 464 scaled units would part: the JAX package's bytes NaN, the
    port's 448 (``test_f8_cast_equals_ml_dtypes_at_and_around_448``); the
    folds mask them away either way."""
    x = _chunk_x(seed, n_valid=n_valid, pad=0.0)
    x[: n_valid // 2, 0] *= -1.0  # both signs reach the column's absmax
    q, scale = st._quantize_f8(x, n_valid)
    qj, sj = jst._quantize_f8(x, n_valid)
    assert q.dtype == np.uint8 and np.asarray(qj).dtype == np.dtype(ml_dtypes.float8_e4m3fn)
    assert q.tobytes() == np.asarray(qj).view(np.uint8).tobytes()
    assert scale.tobytes() == np.asarray(sj).tobytes()
    # a scaled valid value never exceeds 448 by more than its rounding
    assert float(np.abs(x[:n_valid] / scale).max()) <= 448.0 * (1 + 2.0 ** -22)


def test_f8_cast_equals_ml_dtypes_at_and_around_448():
    """torch's e4m3 cast against ``ml_dtypes`` on every value the f8 wire
    can meet: a dense grid of |x| <= 464 (both signs, subnormals, the
    rounding midpoints) gives the same bytes; past 464 the two part
    (torch saturates to 448, byte 126; ``ml_dtypes`` gives NaN, 127),
    which a scaled chunk never reaches."""
    grid = np.concatenate([np.linspace(-464.0, 464.0, 200_001), np.linspace(-2.0 ** -6, 2.0 ** -6, 4001),
                           [448.0, -448.0, 447.99997, 448.00003, 464.0, -464.0, 416.0, 432.0, 440.0]])
    x = grid.astype(np.float32)
    got = torch.from_numpy(x).to(torch.float8_e4m3fn).view(torch.uint8).numpy()
    want = x.astype(ml_dtypes.float8_e4m3fn).view(np.uint8)
    assert np.array_equal(got, want)
    past = np.array([465.0, 480.0, 1e4, -465.0], np.float32)
    assert torch.from_numpy(past).to(torch.float8_e4m3fn).view(torch.uint8).tolist() == [126, 126, 126, 254]
    assert past.astype(ml_dtypes.float8_e4m3fn).view(np.uint8).tolist() == [127, 127, 127, 255]


def _probe_inputs():
    rng = np.random.default_rng(0)
    wide = rng.normal(size=(2048, 3)).astype(np.float32) + 400.0
    wide[0], wide[1] = 1e5, -1e5
    f16_only = rng.normal(size=(512, 4)).astype(np.float32)
    f16_only[0] = 60.0  # one outlier stretches the int8 bins past their gate, f16 holds
    return {
        "bounded": rng.normal(size=(128, 4)).astype(np.float32),
        "f16_only": f16_only,
        "wide_range": wide,
        "integer_storage": np.arange(32, dtype=np.int32).reshape(8, 4),
        "f16_storage": rng.normal(size=(64, 5)).astype(np.float16),
    }


@pytest.mark.parametrize("name", list(_probe_inputs()))
def test_probe_and_selection_match_jax(monkeypatch, name):
    x = _probe_inputs()[name]
    if x.dtype.kind == "f":
        with np.errstate(over="ignore"):
            for kind in ("int8", "f16"):
                assert st._probe_quant_error(x, kind) == jst._probe_quant_error(x, kind)
    for req in ("f32", "f16", "int8", "f8", "auto"):
        with np.errstate(over="ignore"):
            assert st.select_wire_format(x, req) == jst.select_wire_format(x, requested=req), req
    want = {"bounded": "int8", "f16_only": "f16", "wide_range": "f32", "integer_storage": "f32",
            "f16_storage": "int8"}[name]
    with np.errstate(over="ignore"):
        assert st.select_wire_format(x, "auto") == want
    # the module constant is the default request
    monkeypatch.setattr(st, "WIRE_DTYPE", "auto")
    _jax_wire(monkeypatch, "auto")
    with np.errstate(over="ignore"):
        assert st.select_wire_format(x) == jst.select_wire_format(x) == want


def test_invalid_wire_raises():
    X, _, _ = _reg(n=100, d=3)
    src = tchunks.ArrayChunkSource(X)
    for bad in ("int4", "F16", "bf16", ""):
        with pytest.raises(ValueError, match="wire dtype"):
            st.resolve_wire_dtype(bad)
        with pytest.raises(ValueError, match="wire dtype"):
            st.select_wire_format(X, bad)
        with pytest.raises(ValueError, match="wire dtype"):
            next(st.iter_device_chunks(src, CPU, 32, wire=bad))


def test_invalid_module_constant_raises(monkeypatch):
    X, _, _ = _reg(n=100, d=3)
    monkeypatch.setattr(st, "WIRE_DTYPE", "fp8")
    with pytest.raises(ValueError, match="wire dtype"):
        st.streamed_suffstats(tchunks.ArrayChunkSource(X), CPU, 32)
    with pytest.raises(ValueError, match="wire dtype"):
        TPCA(k=2, device="cpu", streaming=True, stream_chunk_rows=32).fit(TDataFrame({"features": X}))


def test_f8_falls_back_to_f16_without_torch_e4m3(monkeypatch):
    monkeypatch.setattr(st, "_f8_supported", lambda: False)
    assert st.select_wire_format(np.ones((8, 2), np.float32), "f8") == "f16"


@pytest.mark.parametrize("wire", NARROW)
def test_dequantized_chunk_within_one_ulp_of_jax(wire):
    x = _chunk_x(5, rows=64, d=6, n_valid=45, pad=0.0)
    c = tchunks.Chunk(X=x, n_valid=45)
    dev = st.put_chunk(c, CPU, wire=wire)
    got = dev["X"]
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert dev["mask"].tolist() == [1.0] * 45 + [0.0] * 19
    if wire == "f16":
        want = x.astype(np.float16).astype(np.float32)
    else:
        if wire == "int8":
            q, scale, offset = jst._quantize_int8(x, 45)
        else:
            (q, scale), offset = jst._quantize_f8(x, 45), None
        qw = jst.QuantizedWire(jnp.asarray(q), jnp.asarray(scale), None if offset is None else jnp.asarray(offset),
                               jnp.float32)
        want = np.asarray(qw.dense())
    ulp = np.spacing(np.abs(want).astype(np.float32))
    assert (np.abs(got.numpy() - want) <= ulp).all()
    # and the port's own dequantize in its stated order
    if wire != "f16":
        enc = st._quantize_int8(x, 45) if wire == "int8" else (*st._quantize_f8(x, 45), None)
        t = [None if a is None else torch.from_numpy(a) for a in enc]
        ref = (t[0].view(torch.float8_e4m3fn) if wire == "f8" else t[0]).to(torch.float32) * t[1]
        if t[2] is not None:
            ref = ref + t[2]
        assert torch.equal(got, ref)


# ---------------------------------------------------------------------------
# the statistics pass and the fits at each wire against the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("wire", NARROW + ["auto"])
@pytest.mark.parametrize("with_y,weighted", [(False, False), (True, True)])
def test_streamed_suffstats_at_each_wire_matches_jax(monkeypatch, wire, with_y, weighted):
    n = 700
    X, y, w = _reg(n=n, d=8)
    w = w if weighted else None
    _jax_wire(monkeypatch, wire)
    ref = jst.streamed_suffstats(jchunks.ArrayChunkSource(X, y, w), make_mesh(1), 96, jnp.float32, with_y=with_y)
    want_wire = jst.last_ingest_report()["wire_dtype"]
    st.reset_ingest_report()
    monkeypatch.setattr(st, "WIRE_DTYPE", wire)
    got = st.streamed_suffstats(tchunks.ArrayChunkSource(X, y, w), CPU, 96, with_y=with_y)
    rep = st.last_ingest_report()
    assert rep["wire_dtype"] == want_wire == ("int8" if wire == "auto" else wire)
    assert rep["encode_s"] > 0.0 and rep["bytes"] == 0 and rep["chunks"] == 2 * 8
    for k in got:
        assert _rel(got[k].numpy(), np.asarray(ref[k])) <= _band(n), k


def test_f32_wire_is_byte_identical_to_no_wire_argument():
    X, y, w = _reg(n=500, d=6)
    src = tchunks.ArrayChunkSource(X, y, w)
    assert st.WIRE_DTYPE == "f32"
    st.streamed_suffstats(src, CPU, 64, with_y=True)
    assert st.last_ingest_report()["wire_dtype"] == "f32"
    pairs = zip(src.iter_chunks(64), st.iter_device_chunks(src, CPU, 64), st.iter_device_chunks(src, CPU, 64,
                                                                                                 wire="f32"))
    for c, (_, a), (_, b) in pairs:
        for k in ("X", "y", "w", "mask"):
            assert a[k].dtype == torch.float32 and torch.equal(a[k], b[k]), k
        assert torch.equal(a["X"], torch.from_numpy(c.X)) and torch.equal(a["y"], torch.from_numpy(c.y))
        # the f32 wire encodes nothing: the host chunk ships as it is
        x, scale, offset = st._encode(c.X, c.n_valid, "f32", np.dtype(np.float32))
        assert x is c.X and scale is None and offset is None


@pytest.mark.parametrize("prefetch,stage", [(0, 0), (0, 3), (4, 1), (1, 5)])
def test_int8_results_independent_of_ring_depths(monkeypatch, prefetch, stage):
    X, y, w = _reg(n=700, d=6)
    src = tchunks.ArrayChunkSource(X, y, w)
    monkeypatch.setattr(st, "WIRE_DTYPE", "int8")
    base = st.streamed_suffstats(src, CPU, 64, with_y=True)
    monkeypatch.setattr(st, "_PREFETCH_DEPTH", prefetch)
    monkeypatch.setattr(st, "_STAGE_DEPTH", stage)
    got = st.streamed_suffstats(src, CPU, 64, with_y=True)
    assert st.last_ingest_report()["wire_dtype"] == "int8"
    assert st.last_ingest_report()["stage_depth"] == stage
    for k, v in base.items():
        assert torch.equal(got[k], v), k


def _low_rank(n=900, d=12, k=3, seed=1):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(d, k)))
    Z = rng.normal(size=(n, k)) * np.array([5.0, 4.0, 3.0])[:k]
    return (Z @ Q.T + 0.05 * rng.normal(size=(n, d)) + 1.0).astype(np.float32)


@pytest.mark.parametrize("wire", NARROW + ["auto"])
def test_pca_fit_at_each_wire_matches_jax(monkeypatch, wire):
    X = _low_rank()
    monkeypatch.setattr(st, "WIRE_DTYPE", wire)
    _jax_wire(monkeypatch, wire)
    t = TPCA(k=3, device="cpu", streaming=True, stream_chunk_rows=128).fit(TDataFrame({"features": X}))
    j = JPCA(k=3, num_workers=1, streaming=True, stream_chunk_rows=128).fit(JDataFrame({"features": X}))
    assert t._ingest_report["wire_dtype"] == j._ingest_report["wire_dtype"]
    for a, b in ((t.mean_, j.mean_), (t.components_, j.components_), (t.explained_variance_,
                                                                       j.explained_variance_)):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("wire", NARROW)
def test_linreg_fit_at_each_wire_matches_jax(monkeypatch, wire):
    X, y, w = _reg()
    cols = {"features": X, "label": y, "w": w}
    monkeypatch.setattr(st, "WIRE_DTYPE", wire)
    _jax_wire(monkeypatch, wire)
    kw = dict(regParam=0.01, weightCol="w", streaming=True, stream_chunk_rows=128)
    t = TLinReg(device="cpu", **kw).fit(TDataFrame(cols))
    j = JLinReg(num_workers=1, **kw).fit(JDataFrame(cols))
    assert t._ingest_report["wire_dtype"] == wire
    np.testing.assert_allclose(t.coefficients, j.coefficients, rtol=5e-3, atol=5e-4)
    np.testing.assert_allclose(float(t.intercept), float(j.intercept), rtol=5e-3, atol=5e-4)


def _blobs(n=420, d=6, k=5, seed=10):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)) * 8.0 + 3.0
    return (centers[rng.integers(0, k, size=n)] + rng.normal(size=(n, d))).astype(np.float32)


@pytest.mark.parametrize("wire", NARROW)
def test_kmeans_fit_at_each_wire_matches_jax(monkeypatch, wire):
    X = _blobs()
    monkeypatch.setattr(st, "WIRE_DTYPE", wire)
    _jax_wire(monkeypatch, wire)
    kw = dict(k=5, initMode="random", seed=7, maxIter=20, streaming=True, stream_chunk_rows=64)
    tm = TKMeans(device="cpu", **kw).fit(TDataFrame({"features": X}))
    jm = JKMeans(num_workers=1, **kw).fit(JDataFrame({"features": X}))
    assert tm._ingest_report["wire_dtype"] == wire and tm.numIter == jm._model_attributes["n_iter"]
    assert abs(tm.trainingCost - jm.trainingCost) / jm.trainingCost < 1e-3
    assert np.abs(tm.cluster_centers_ - jm.cluster_centers_).max() < 1e-3


@pytest.mark.parametrize("wire", NARROW)
def test_logreg_fit_at_each_wire_matches_jax(monkeypatch, wire):
    rng = np.random.default_rng(0)
    Z = rng.normal(size=(400, 6)) * rng.uniform(0.5, 2.0, size=6)
    y = (rng.uniform(size=400) < 1.0 / (1.0 + np.exp(-(Z @ rng.normal(size=6) + 0.3)))).astype(np.float32)
    cols = {"features": (Z + 2.0).astype(np.float32), "label": y}
    monkeypatch.setattr(st, "WIRE_DTYPE", wire)
    _jax_wire(monkeypatch, wire)
    kw = dict(regParam=0.01, streaming=True, stream_chunk_rows=56)
    t = TLogReg(device="cpu", **kw).fit(TDataFrame(cols))
    j = JLogReg(num_workers=1, **kw).fit(JDataFrame(cols))
    assert t._ingest_report["wire_dtype"] == wire and t.n_iter_ == j._model_attributes["n_iter"]
    np.testing.assert_allclose(t.coefficientMatrix, j.coefficientMatrix, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(t.interceptVector, j.interceptVector, rtol=1e-3, atol=1e-4)
