"""Port parity: the chunk sources of ``spark_rapids_ml_tpu_torch/data/chunks.py``
against the JAX package's ``data/chunks.py``, which the port copies.

Both run on the same seeded numpy inputs on the CPU. A chunk source moves
host arrays without arithmetic, so every chunk must be equal bit for bit:
its padded ``X``, ``y``, ``w``, ``n_valid`` and mask, in the same order.
Parquet files are written once by the JAX package's writer and read by
both packages' sources, across file boundaries and with f16 storage.
"""

import numpy as np
import pytest
import scipy.sparse as sp

from spark_rapids_ml_tpu.data import DataFrame as JDataFrame
from spark_rapids_ml_tpu.data import chunks as jchunks
from spark_rapids_ml_tpu_torch.data import chunks as tchunks


def _chunk_fields(c):
    return (c.X, c.n_valid, c.y, c.w, c.mask())


def _assert_same_chunks(jsrc, tsrc, chunk_rows, dtype=np.float32):
    assert (tsrc.n_rows, tsrc.n_features, tsrc.has_label, tsrc.has_weight) == (
        jsrc.n_rows, jsrc.n_features, jsrc.has_label, jsrc.has_weight)
    assert tsrc.num_chunks(chunk_rows) == jsrc.num_chunks(chunk_rows)
    jc = list(jsrc.iter_chunks(chunk_rows, dtype))
    tc = list(tsrc.iter_chunks(chunk_rows, dtype))
    assert len(tc) == len(jc) >= 1
    for a, b in zip(jc, tc):
        for fa, fb in zip(_chunk_fields(a), _chunk_fields(b)):
            if fa is None:
                assert fb is None
            elif isinstance(fa, int):
                assert fa == fb
            else:
                assert fa.dtype == fb.dtype and fa.shape == fb.shape
                np.testing.assert_array_equal(fa, fb)
    return tc


def _data(n=1003, d=7, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32), rng.normal(size=n).astype(np.float32),
            rng.uniform(0.1, 2.0, size=n).astype(np.float32))


@pytest.mark.parametrize("chunk_rows", [1, 96, 1003, 4096])
@pytest.mark.parametrize("cols", ["X", "Xy", "Xyw"])
def test_array_chunk_source_matches_jax(chunk_rows, cols):
    X, y, w = _data()
    args = (X, y if "y" in cols else None, w if "w" in cols else None)
    chunks = _assert_same_chunks(jchunks.ArrayChunkSource(*args), tchunks.ArrayChunkSource(*args), chunk_rows)
    np.testing.assert_array_equal(np.concatenate([c.X[: c.n_valid] for c in chunks]), X)


def test_array_chunk_source_float64_cast_and_reiteration():
    X, y, w = _data(n=300)
    X64 = X.astype(np.float64)
    src = tchunks.ArrayChunkSource(X64, y, w)
    _assert_same_chunks(jchunks.ArrayChunkSource(X64, y, w), src, 64)
    _assert_same_chunks(jchunks.ArrayChunkSource(X64, y, w), src, 64, np.float64)
    # re-iterable: a second pass gives the same chunks
    a = [c.X.copy() for c in src.iter_chunks(64)]
    b = [c.X for c in src.iter_chunks(64)]
    for x1, x2 in zip(a, b):
        np.testing.assert_array_equal(x1, x2)


@pytest.mark.parametrize("chunk_rows", [40, 128])
def test_csr_chunk_source_matches_jax(chunk_rows):
    Xs = sp.random(257, 19, density=0.2, format="csr", random_state=3, dtype=np.float64)
    _, y, w = _data(n=257)
    _assert_same_chunks(jchunks.CSRChunkSource(Xs, y, w), tchunks.CSRChunkSource(Xs, y, w), chunk_rows)
    _assert_same_chunks(jchunks.CSRChunkSource(Xs), tchunks.CSRChunkSource(Xs), chunk_rows)
    with pytest.raises(TypeError):
        tchunks.CSRChunkSource(np.zeros((3, 3)))


def _write(tmp_path, name, cols, rows_per_file):
    path = str(tmp_path / name)
    JDataFrame(cols).write_parquet(path, rows_per_file=rows_per_file)
    return path


@pytest.mark.parametrize("chunk_rows", [50, 64, 157, 1000])
def test_parquet_chunk_source_matches_jax_across_files(tmp_path, chunk_rows):
    X, y, w = _data(n=157, d=4)
    path = _write(tmp_path, "ds", {"features": X, "label": y, "w": w}, 23)  # 7 ragged files
    kw = dict(label_col="label", weight_col="w")
    chunks = _assert_same_chunks(jchunks.ParquetChunkSource(path, **kw), tchunks.ParquetChunkSource(path, **kw),
                                 chunk_rows)
    np.testing.assert_array_equal(np.concatenate([c.X[: c.n_valid] for c in chunks]), X)
    np.testing.assert_array_equal(np.concatenate([c.y[: c.n_valid] for c in chunks]), y)
    _assert_same_chunks(jchunks.ParquetChunkSource(path), tchunks.ParquetChunkSource(path), chunk_rows)


def test_parquet_chunk_source_keeps_f16_storage(tmp_path):
    X, y, _ = _data(n=130, d=6)
    X16 = X.astype(np.float16)
    path = _write(tmp_path, "f16", {"features": X16, "label": y}, 40)
    tc = _assert_same_chunks(jchunks.ParquetChunkSource(path, label_col="label"),
                             tchunks.ParquetChunkSource(path, label_col="label"), 48)
    assert all(c.X.dtype == np.float16 for c in tc)
    np.testing.assert_array_equal(np.concatenate([c.X[: c.n_valid] for c in tc]), X16)


def test_parquet_row_counts_labels_and_metadata(tmp_path):
    X, y, _ = _data(n=211, d=3)
    path = _write(tmp_path, "m", {"features": X, "label": y}, 50)
    files = sorted(str(p) for p in (tmp_path / "m").iterdir())
    assert tchunks.parquet_row_counts(files) == jchunks.parquet_row_counts(files) == [50, 50, 50, 50, 11]
    t = tchunks.ParquetChunkSource(path, label_col="label")
    j = jchunks.ParquetChunkSource(path, label_col="label")
    for a, b in zip(j.iter_labels(64), t.iter_labels(64)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        list(tchunks.ParquetChunkSource(path).iter_labels(64))
    with pytest.raises(FileNotFoundError):
        tchunks.ParquetChunkSource(str(tmp_path / "empty"), _files=[])


def test_array_source_iter_labels_matches_jax():
    X, y, _ = _data(n=100)
    a = list(jchunks.ArrayChunkSource(X, y).iter_labels(30))
    b = list(tchunks.ArrayChunkSource(X, y).iter_labels(30))
    assert len(a) == len(b) == 4
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)


def _gen(start, count, seed):
    r = np.random.default_rng(seed)
    return r.normal(size=(count, 5)) + start, r.normal(size=count)


@pytest.mark.parametrize("chunk_rows", [32, 100, 128])
def test_generator_chunk_source_matches_jax(chunk_rows):
    _assert_same_chunks(jchunks.GeneratorChunkSource(_gen, 100, 5, seed=5, has_label=True),
                        tchunks.GeneratorChunkSource(_gen, 100, 5, seed=5, has_label=True), chunk_rows)


@pytest.mark.parametrize("n_features,itemsize,n_dp,target,max_rows", [
    (256, 4, 1, 128 << 20, 1 << 20), (100, 4, 8, 1 << 20, 1 << 20), (3000, 4, 1, 128 << 20, 1 << 20),
    (1, 4, 1, 128 << 20, 1 << 20), (7, 8, 3, 1000, 50), (1 << 30, 4, 2, 1 << 20, 1 << 20),
])
def test_auto_chunk_rows_matches_jax(n_features, itemsize, n_dp, target, max_rows):
    kw = dict(target_bytes=target, max_rows=max_rows)
    got = tchunks.auto_chunk_rows(n_features, itemsize, n_dp, **kw)
    assert got == jchunks.auto_chunk_rows(n_features, itemsize, n_dp, **kw)
    assert got % n_dp == 0 and got >= n_dp
