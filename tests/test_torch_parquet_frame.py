"""Port parity: the parquet half of ``spark_rapids_ml_tpu_torch/data/dataframe.py``
(``write_parquet``, ``read_parquet``, ``scan_parquet``, ``ParquetScanFrame``,
``AugmentedScanFrame``, ``toPandas`` / ``from_pandas``, Spark VectorUDT
decoding) against the JAX package's, which the port copies, and a model's
streamed transform of a scan.

I/O moves values without arithmetic, so columns must be equal bit for bit.
The streamed transform is the resident transform a chunk at a time: the
same f32 products on the same rows, so equal bit for bit to the resident
transform on the CPU, and within f32 rounding of the JAX package's.
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_rapids_ml_tpu.data import DataFrame as JDataFrame
from spark_rapids_ml_tpu.data import chunks as jchunks
from spark_rapids_ml_tpu.feature import PCA as JPCA
from spark_rapids_ml_tpu.regression import LinearRegression as JLinReg
from spark_rapids_ml_tpu_torch import DataFrame as TDataFrame
from spark_rapids_ml_tpu_torch.data import chunks as tchunks
from spark_rapids_ml_tpu_torch.data.dataframe import AugmentedScanFrame, ParquetScanFrame
from spark_rapids_ml_tpu_torch.feature import PCA as TPCA
from spark_rapids_ml_tpu_torch.regression import LinearRegression as TLinReg


def _cols(n=230, d=6, seed=0):
    rng = np.random.default_rng(seed)
    X = (rng.normal(size=(n, d)) + 2.0).astype(np.float32)
    return {"features": X, "label": (X @ rng.normal(size=d)).astype(np.float32),
            "id": np.arange(n, dtype=np.int64)}


def _assert_frames_equal(a, b):
    assert a.columns == b.columns and a.count() == b.count()
    for c in a.columns:
        x, y = np.asarray(a.column(c)), np.asarray(b.column(c))
        assert x.dtype == y.dtype and x.shape == y.shape, c
        np.testing.assert_array_equal(x, y, err_msg=c)


@pytest.mark.parametrize("rows_per_file", [None, 37, 230])
def test_write_and_read_parquet_match_jax(tmp_path, rows_per_file):
    cols = _cols()
    TDataFrame(cols, num_partitions=3).write_parquet(str(tmp_path / "t"), rows_per_file=rows_per_file)
    JDataFrame(cols, num_partitions=3).write_parquet(str(tmp_path / "j"), rows_per_file=rows_per_file)
    t_files = sorted(p.name for p in (tmp_path / "t").iterdir())
    assert t_files == sorted(p.name for p in (tmp_path / "j").iterdir())
    for name in ("t", "j"):
        _assert_frames_equal(JDataFrame.read_parquet(str(tmp_path / name)),
                             TDataFrame.read_parquet(str(tmp_path / name)))
    _assert_frames_equal(TDataFrame.read_parquet(str(tmp_path / "t")), TDataFrame(cols))


def test_sparse_column_writes_dense(tmp_path):
    import scipy.sparse as sp

    Xs = sp.random(40, 5, density=0.3, format="csr", random_state=0, dtype=np.float64)
    TDataFrame({"features": Xs}).write_parquet(str(tmp_path / "s"), rows_per_file=16)
    got = TDataFrame.read_parquet(str(tmp_path / "s")).column("features")
    np.testing.assert_array_equal(got, np.asarray(Xs.todense()))


def _spark_vector_table(n=9):
    """A Spark ML VectorUDT column: dense and sparse rows mixed, d = 4."""
    kinds, sizes, idx, vals = [], [], [], []
    rng = np.random.default_rng(1)
    for i in range(n):
        if i % 3 == 0:
            kinds.append(0)
            sizes.append(4)
            idx.append([1, 3])
            vals.append(list(rng.normal(size=2)))
        else:
            kinds.append(1)
            sizes.append(None)
            idx.append([])
            vals.append(list(rng.normal(size=4)))
    struct = pa.StructArray.from_arrays(
        [pa.array(kinds, pa.int8()), pa.array(sizes, pa.int32()), pa.array(idx, pa.list_(pa.int32())),
         pa.array(vals, pa.list_(pa.float64()))], names=["type", "size", "indices", "values"])
    return pa.Table.from_arrays([struct, pa.array(np.arange(n, dtype=np.float32))], names=["features", "label"])


def test_spark_vector_columns_decode_like_jax(tmp_path):
    d = tmp_path / "udt"
    d.mkdir()
    pq.write_table(_spark_vector_table(), str(d / "part-00000.parquet"))
    _assert_frames_equal(JDataFrame.read_parquet(str(d)), TDataFrame.read_parquet(str(d)))
    assert TDataFrame.scan_parquet(str(d)).dtypes() == JDataFrame.scan_parquet(str(d)).dtypes()
    js, ts = (m.ParquetChunkSource(str(d), label_col="label") for m in (jchunks, tchunks))
    assert ts.n_features == js.n_features == 4
    for a, b in zip(js.iter_chunks(4), ts.iter_chunks(4)):
        np.testing.assert_array_equal(a.X, b.X)
        np.testing.assert_array_equal(a.y, b.y)


def test_scan_frame_metadata_matches_jax_without_reading(tmp_path):
    cols = _cols()
    path = str(tmp_path / "p")
    JDataFrame(cols).write_parquet(path, rows_per_file=60)
    t, j = TDataFrame.scan_parquet(path), JDataFrame.scan_parquet(path)
    assert isinstance(t, ParquetScanFrame)
    assert (t.count(), t.columns, t.dtypes()) == (j.count(), j.columns, j.dtypes())
    assert ("label" in t) and ("nope" not in t) and t.has_disk_column("features")
    assert not t.is_materialized()
    src = t.chunk_source(features_col="features", label_col="label")
    assert (src.n_rows, src.n_features) == (230, 6) and not t.is_materialized()
    # touching a column materializes the scan, as in the JAX package
    np.testing.assert_array_equal(t.column("label"), cols["label"])
    assert t.is_materialized()
    _assert_frames_equal(j, t)


def test_augmented_scan_frame_matches_jax(tmp_path):
    cols = _cols(n=50)
    path = str(tmp_path / "a")
    JDataFrame(cols).write_parquet(path, rows_per_file=20)
    extra = {"pred": np.arange(50, dtype=np.float64), "label": np.zeros(50, np.float32)}
    from spark_rapids_ml_tpu.data.dataframe import AugmentedScanFrame as JAug

    t = AugmentedScanFrame(TDataFrame.scan_parquet(path), extra)
    j = JAug(JDataFrame.scan_parquet(path), extra)
    assert (t.columns, t.dtypes(), "pred" in t) == (j.columns, j.dtypes(), "pred" in j)
    # an appended column shadows the on-disk one of the same name
    assert not t.has_disk_column("label") and t.has_disk_column("features")
    np.testing.assert_array_equal(t.column("pred"), extra["pred"])
    assert not t.is_materialized()
    np.testing.assert_array_equal(t.column("features"), cols["features"])
    assert t.is_materialized()
    np.testing.assert_array_equal(t.column("label"), extra["label"])
    _assert_frames_equal(j, t)


def test_pandas_round_trip_matches_jax():
    cols = _cols(n=12)
    tp, jp = TDataFrame(cols).toPandas(), JDataFrame(cols).toPandas()
    assert list(tp.columns) == list(jp.columns)
    _assert_frames_equal(JDataFrame.from_pandas(jp), TDataFrame.from_pandas(tp))
    _assert_frames_equal(TDataFrame.from_pandas(tp), TDataFrame(cols))


@pytest.mark.parametrize("estimator", ["pca", "linreg"])
def test_streamed_transform_of_a_scan(tmp_path, estimator):
    """A model's transform over a scan streams it (the scan stays on disk)
    and gives the resident transform's column bit for bit; the JAX
    package's streamed transform of the same scan agrees within f32
    rounding of the products (d = 6 terms of |x·w| ~ 10)."""
    cols = _cols(n=700)
    path = str(tmp_path / "s")
    JDataFrame(cols).write_parquet(path, rows_per_file=150)
    df = TDataFrame(cols)
    if estimator == "pca":
        tm = TPCA(k=3, device="cpu").fit(df)
        jm = JPCA(k=3, num_workers=1).fit(JDataFrame(cols))
        out_col = "pca_features"
    else:
        tm = TLinReg(device="cpu").fit(df)
        jm = JLinReg(num_workers=1).fit(JDataFrame(cols))
        out_col = "prediction"
    tm._transform_batch_rows = lambda: 128  # several ragged chunks
    scan = TDataFrame.scan_parquet(path)
    out = tm.transform(scan)
    assert isinstance(out, AugmentedScanFrame) and not scan.is_materialized() and not out.is_materialized()
    np.testing.assert_array_equal(out.column(out_col), tm.transform(df).column(out_col))
    jout = jm.transform(JDataFrame.scan_parquet(path)).column(out_col)
    np.testing.assert_allclose(out.column(out_col), jout, rtol=1e-4, atol=1e-4)
    assert out_col in out.columns and out.count() == 700
