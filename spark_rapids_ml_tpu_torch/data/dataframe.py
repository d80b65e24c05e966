"""Lightweight host DataFrame — the port's data plane.

A copy of ``spark_rapids_ml_tpu/data/dataframe.py`` (the port may not
import the JAX package). A ``DataFrame`` is a
host-resident column store (numpy arrays / scipy CSR matrices) with a
logical partition count; estimators copy its rows straight onto the card.
``DataFrame.scan_parquet`` gives a :class:`ParquetScanFrame` whose columns
stay on disk: the streamed fits read it chunk by chunk
(``data.chunks.ParquetChunkSource``) and never materialize it.

Column kinds:
  * scalar column  -> 1-D numpy array (any dtype)
  * vector column  -> 2-D numpy array (rows, dim)  — the analog of Spark's
    VectorUDT / array<float> columns
  * sparse vector  -> scipy.sparse.csr_matrix

Row order is meaningful and preserved by all operations.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import scipy.sparse as sp

ColumnLike = Union[np.ndarray, "sp.csr_matrix"]


def _is_sparse(col: Any) -> bool:
    return sp.issparse(col)


def is_spark_vector_struct(arrow_type: Any) -> bool:
    """True for the parquet physical schema Spark ML writes for VectorUDT:
    ``struct<type: tinyint, size: int, indices: list<int>, values:
    list<double>>`` (``type`` 1 = dense, 0 = sparse)."""
    import pyarrow as pa

    if not pa.types.is_struct(arrow_type):
        return False
    names = {arrow_type.field(i).name for i in range(arrow_type.num_fields)}
    return {"type", "size", "indices", "values"} <= names


def spark_vector_to_numpy(col: Any, dtype: Any = np.float64) -> np.ndarray:
    """Decode a Spark VectorUDT struct column (arrow) to a dense (n, d)
    array. Dense and sparse rows may be mixed, as Spark allows."""
    import pyarrow as pa

    if isinstance(col, pa.ChunkedArray):
        col = col.combine_chunks()
    n = len(col)
    kinds = col.field("type").fill_null(1).to_numpy(zero_copy_only=False)
    sizes = col.field("size").fill_null(-1).to_numpy(zero_copy_only=False)
    values = col.field("values")
    indices = col.field("indices")
    vflat = np.asarray(values.flatten().to_numpy(zero_copy_only=False))
    voff = np.asarray(values.offsets.to_numpy(zero_copy_only=False))
    iflat = np.asarray(indices.flatten().to_numpy(zero_copy_only=False))
    ioff = np.asarray(indices.offsets.to_numpy(zero_copy_only=False))

    dense = kinds == 1
    vlen = np.diff(voff)
    if dense.any():
        d = int(vlen[dense][0])
        if not (vlen[dense] == d).all():
            raise ValueError("ragged dense vectors in VectorUDT column")
    else:
        d = int(sizes.max())
    if (sizes[~dense] > d).any() or d <= 0:
        raise ValueError(
            f"inconsistent VectorUDT dimensions (dense d={d}, "
            f"max sparse size={sizes.max()})"
        )

    out = np.zeros((n, d), dtype=dtype)
    didx = np.nonzero(dense)[0]
    if didx.size:
        gather = voff[didx][:, None] + np.arange(d)[None, :]
        out[didx] = vflat[gather]
    if (~dense).any():
        # indices lists are empty for dense rows, so iflat holds exactly the
        # sparse rows' columns; align the values by masking them to sparse rows
        row_of_v = np.repeat(np.arange(n), vlen)
        sparse_mask = ~dense[row_of_v]
        row_of_i = np.repeat(np.arange(n), np.diff(ioff))
        if sparse_mask.sum() != len(iflat):
            raise ValueError("VectorUDT sparse rows have mismatched lists")
        out[row_of_i, iflat] = vflat[sparse_mask]
    return out


def _col_nrows(col: ColumnLike) -> int:
    return int(col.shape[0])


class Row(dict):
    """Dict-like row with attribute access, like ``pyspark.sql.Row``."""

    def __getattr__(self, item: str) -> Any:
        try:
            return self[item]
        except KeyError as e:
            raise AttributeError(item) from e


class DataFrame:
    def __init__(
        self,
        data: Dict[str, ColumnLike],
        num_partitions: Optional[int] = None,
    ):
        if not data:
            raise ValueError("DataFrame requires at least one column")
        nrows = None
        cols: Dict[str, ColumnLike] = {}
        for name, col in data.items():
            if _is_sparse(col):
                col = col.tocsr()
            else:
                col = np.asarray(col)
                if col.ndim == 0:
                    raise ValueError(
                        f"Column {name!r} must be at least 1-D (scalar column); got a 0-D value"
                    )
            n = _col_nrows(col)
            if nrows is None:
                nrows = n
            elif n != nrows:
                raise ValueError(
                    f"Column {name!r} has {n} rows; expected {nrows}"
                )
            cols[name] = col
        self._data = cols
        self._nrows = int(nrows or 0)
        self._num_partitions = max(1, int(num_partitions or 1))

    # -- basic info --------------------------------------------------------
    @property
    def columns(self) -> List[str]:
        return list(self._data.keys())

    def count(self) -> int:
        return self._nrows

    def __len__(self) -> int:
        return self._nrows

    @property
    def num_partitions(self) -> int:
        return self._num_partitions

    def dtypes(self) -> List[Tuple[str, str]]:
        out = []
        for name, col in self._data.items():
            if _is_sparse(col):
                out.append((name, f"sparse_vector<{col.dtype}>[{col.shape[1]}]"))
            elif col.ndim == 2:
                out.append((name, f"vector<{col.dtype}>[{col.shape[1]}]"))
            elif col.ndim > 2:
                dims = "x".join(str(s) for s in col.shape[1:])
                out.append((name, f"tensor<{col.dtype}>[{dims}]"))
            else:
                out.append((name, str(col.dtype)))
        return out

    def column(self, name: str) -> ColumnLike:
        if name not in self._data:
            raise KeyError(f"No column {name!r}; have {self.columns}")
        return self._data[name]

    def __getitem__(self, name: str) -> ColumnLike:
        return self.column(name)

    def __contains__(self, name: str) -> bool:
        return name in self._data

    # -- projection / mutation (all return new frames) ---------------------
    def select(self, *cols: str) -> "DataFrame":
        names: List[str] = []
        for c in cols:
            if isinstance(c, (list, tuple)):
                names.extend(c)
            else:
                names.append(c)
        return DataFrame({c: self.column(c) for c in names}, self._num_partitions)

    def withColumn(self, name: str, col: ColumnLike) -> "DataFrame":
        data = dict(self._data)
        data[name] = col
        return DataFrame(data, self._num_partitions)

    def withColumnRenamed(self, old: str, new: str) -> "DataFrame":
        data = {}
        for k, v in self._data.items():
            data[new if k == old else k] = v
        return DataFrame(data, self._num_partitions)

    def drop(self, *cols: str) -> "DataFrame":
        data = {k: v for k, v in self._data.items() if k not in cols}
        return DataFrame(data, self._num_partitions)

    def repartition(self, n: int) -> "DataFrame":
        return DataFrame(dict(self._data), n)

    def filter(self, mask: Union[np.ndarray, Callable[["DataFrame"], np.ndarray]]) -> "DataFrame":
        if callable(mask):
            mask = mask(self)
        mask = np.asarray(mask, dtype=bool)
        return self.take_rows(np.nonzero(mask)[0])

    def take_rows(self, idx: np.ndarray) -> "DataFrame":
        idx = np.asarray(idx)
        data = {}
        for k, v in self._data.items():
            data[k] = v[idx]
        return DataFrame(data, self._num_partitions)

    def union(self, other: "DataFrame") -> "DataFrame":
        if set(self.columns) != set(other.columns):
            raise ValueError(f"union: column mismatch {self.columns} vs {other.columns}")
        data: Dict[str, ColumnLike] = {}
        for k in self.columns:
            a, b = self._data[k], other._data[k]
            if _is_sparse(a) or _is_sparse(b):
                data[k] = sp.vstack([sp.csr_matrix(a), sp.csr_matrix(b)]).tocsr()
            else:
                data[k] = np.concatenate([a, np.asarray(b)], axis=0)
        return DataFrame(data, self._num_partitions)

    def sample(self, fraction: float, seed: int = 0) -> "DataFrame":
        rng = np.random.default_rng(seed)
        mask = rng.random(self._nrows) < fraction
        return self.filter(mask)

    def randomSplit(self, weights: Sequence[float], seed: int = 0) -> List["DataFrame"]:
        weights = np.asarray(weights, dtype=float)
        weights = weights / weights.sum()
        rng = np.random.default_rng(seed)
        u = rng.random(self._nrows)
        edges = np.concatenate([[0.0], np.cumsum(weights)])
        out = []
        for i in range(len(weights)):
            mask = (u >= edges[i]) & (u < edges[i + 1])
            out.append(self.filter(mask))
        return out

    def orderBy(self, col: str, ascending: bool = True) -> "DataFrame":
        key = self.column(col)
        if key.ndim != 1:
            raise ValueError("orderBy requires a scalar column")
        idx = np.argsort(key, kind="stable")
        if not ascending:
            idx = idx[::-1]
        return self.take_rows(idx)

    # -- partition iteration -----------------------------------------------
    def partition_bounds(self) -> List[Tuple[int, int]]:
        """Row ranges of each logical partition (balanced split)."""
        n, p = self._nrows, self._num_partitions
        sizes = [n // p + (1 if i < n % p else 0) for i in range(p)]
        bounds, start = [], 0
        for s in sizes:
            bounds.append((start, start + s))
            start += s
        return bounds

    def iter_partitions(self) -> Iterator["DataFrame"]:
        for lo, hi in self.partition_bounds():
            yield self.take_rows(np.arange(lo, hi))

    # -- materialization ---------------------------------------------------
    def collect(self) -> List[Row]:
        rows = []
        dense = {
            k: (v.toarray() if _is_sparse(v) else v) for k, v in self._data.items()
        }
        for i in range(self._nrows):
            rows.append(Row({k: (v[i] if v.ndim == 1 else v[i, :]) for k, v in dense.items()}))
        return rows

    def take(self, n: int) -> List[Row]:
        return self.take_rows(np.arange(min(n, self._nrows))).collect()

    def first(self) -> Optional[Row]:
        rows = self.take(1)
        return rows[0] if rows else None

    def cache(self) -> "DataFrame":
        return self  # host-resident already

    def unpersist(self) -> "DataFrame":
        return self

    def toPandas(self) -> "Any":
        import pandas as pd

        out = {}
        for k, v in self._data.items():
            if _is_sparse(v):
                out[k] = list(np.asarray(v.todense()))
            elif v.ndim == 2:
                out[k] = list(v)
            else:
                out[k] = v
        return pd.DataFrame(out)

    @staticmethod
    def from_pandas(pdf: "Any", num_partitions: int = 1) -> "DataFrame":
        data: Dict[str, ColumnLike] = {}
        for k in pdf.columns:
            col = pdf[k]
            if len(col) and isinstance(col.iloc[0], (list, tuple, np.ndarray)):
                data[k] = np.stack([np.asarray(v) for v in col])
            else:
                data[k] = col.to_numpy()
        return DataFrame(data, num_partitions)

    # -- parquet I/O (pyarrow; vector columns as fixed-size lists) ---------
    def write_parquet(self, path: str, rows_per_file: Optional[int] = None) -> None:
        import pyarrow as pa
        import pyarrow.parquet as pq

        os.makedirs(path, exist_ok=True)
        n = self._nrows
        rows_per_file = rows_per_file or max(1, (n + self._num_partitions - 1) // self._num_partitions)
        file_idx = 0
        for lo in range(0, n, rows_per_file):
            hi = min(lo + rows_per_file, n)
            arrays, names = [], []
            for k, v in self._data.items():
                names.append(k)
                if _is_sparse(v):
                    v = np.asarray(v[lo:hi].todense())
                    arrays.append(pa.FixedSizeListArray.from_arrays(pa.array(v.ravel()), v.shape[1]))
                elif v.ndim == 2:
                    chunk = v[lo:hi]
                    arrays.append(
                        pa.FixedSizeListArray.from_arrays(pa.array(chunk.ravel()), chunk.shape[1])
                    )
                else:
                    arrays.append(pa.array(v[lo:hi]))
            table = pa.Table.from_arrays(arrays, names=names)
            pq.write_table(table, os.path.join(path, f"part-{file_idx:05d}.parquet"))
            file_idx += 1

    @staticmethod
    def scan_parquet(path: str, num_partitions: int = 1) -> "ParquetScanFrame":
        """Lazy parquet scan: rows are never materialized on the host
        unless a column is accessed. Estimators with a streamed fit read
        this frame chunk by chunk."""
        return ParquetScanFrame(path, num_partitions)

    @staticmethod
    def read_parquet(path: str, num_partitions: int = 1) -> "DataFrame":
        import pyarrow as pa
        import pyarrow.parquet as pq

        tables = [pq.read_table(f) for f in _parquet_files(path)]
        table = pa.concat_tables(tables)
        data: Dict[str, ColumnLike] = {}
        for name in table.column_names:
            col = table.column(name).combine_chunks()
            if isinstance(col.type, (pa.FixedSizeListType,)):
                dim = col.type.list_size
                flat = col.flatten().to_numpy(zero_copy_only=False)
                data[name] = flat.reshape(-1, dim)
            elif pa.types.is_list(col.type) or pa.types.is_large_list(col.type):
                pylist = col.to_pylist()
                data[name] = np.stack([np.asarray(v) for v in pylist])
            elif is_spark_vector_struct(col.type):
                data[name] = spark_vector_to_numpy(col)
            else:
                data[name] = col.to_numpy(zero_copy_only=False)
        return DataFrame(data, num_partitions)


def _parquet_files(path: str) -> List[str]:
    """The ``.parquet`` files of a directory, sorted, or the one file."""
    if os.path.isdir(path):
        return sorted(os.path.join(path, f) for f in os.listdir(path) if f.endswith(".parquet"))
    return [path]


class ParquetScanFrame(DataFrame):
    """A DataFrame whose columns stay on disk until touched.

    ``count()`` / ``columns`` / ``dtypes()`` come from parquet metadata.
    Accessing any column (or any mutating/materializing method inherited
    from :class:`DataFrame`) reads the files; streamed estimators instead
    take :meth:`chunk_source` and never materialize.
    """

    def __init__(self, path: str, num_partitions: int = 1):
        import pyarrow.parquet as pq

        from .chunks import parquet_row_counts

        files = _parquet_files(path)
        if not files:
            raise FileNotFoundError(f"No parquet files under {path}")
        self._path = path
        self._files = files
        self._schema = pq.ParquetFile(files[0]).schema_arrow
        self._nrows = sum(parquet_row_counts(files))
        self._num_partitions = max(1, int(num_partitions))
        self._materialized: Optional[Dict[str, ColumnLike]] = None

    # `_data` drives every inherited method; materialize on first touch
    @property
    def _data(self) -> Dict[str, ColumnLike]:
        if self._materialized is None:
            self._materialized = DataFrame.read_parquet(self._path)._data
        return self._materialized

    @_data.setter
    def _data(self, value: Dict[str, ColumnLike]) -> None:
        self._materialized = value

    @property
    def columns(self) -> List[str]:
        return list(self._schema.names)

    def count(self) -> int:
        return self._nrows

    def __contains__(self, name: str) -> bool:
        return name in self._schema.names

    def dtypes(self) -> List[Tuple[str, str]]:
        import pyarrow as pa

        out = []
        for f in self._schema:
            if isinstance(f.type, pa.FixedSizeListType):
                out.append((f.name, f"vector<{f.type.value_type}>[{f.type.list_size}]"))
            elif pa.types.is_list(f.type) or pa.types.is_large_list(f.type):
                out.append((f.name, f"vector<{f.type.value_type}>[?]"))
            elif is_spark_vector_struct(f.type):
                out.append((f.name, "vector<spark-udt>[?]"))
            else:
                out.append((f.name, str(f.type)))
        return out

    def is_materialized(self) -> bool:
        return self._materialized is not None

    def has_disk_column(self, name: str) -> bool:
        """True when ``name`` is backed by the parquet files themselves
        (streamable), as opposed to an in-memory appended column."""
        return name in self._schema.names

    def chunk_source(
        self,
        features_col: str = "features",
        label_col: Optional[str] = None,
        weight_col: Optional[str] = None,
    ):
        from .chunks import ParquetChunkSource

        return ParquetChunkSource(
            self._path,
            features_col=features_col,
            label_col=label_col,
            weight_col=weight_col,
            _files=self._files,
            _n_rows=self._nrows,
        )


class AugmentedScanFrame(ParquetScanFrame):
    """A parquet scan plus in-memory appended columns: what a streamed
    ``model.transform(scan)`` returns. Output columns (predictions,
    projections) live in memory, the on-disk columns stay lazy. Touching
    an on-disk column materializes the scan; the appended columns never
    force that."""

    def __init__(self, base: ParquetScanFrame, extra: Dict[str, ColumnLike]):
        # share the base scan's metadata; a prior streamed transform's
        # appended columns carry over
        self._path = base._path
        self._files = base._files
        self._schema = base._schema
        self._nrows = base._nrows
        self._num_partitions = base._num_partitions
        self._materialized = None
        self._extra = {**getattr(base, "_extra", {}), **extra}

    @property
    def _data(self) -> Dict[str, ColumnLike]:
        if self._materialized is None:
            d = DataFrame.read_parquet(self._path)._data
            d.update(self._extra)
            self._materialized = d
        return self._materialized

    @_data.setter
    def _data(self, value: Dict[str, ColumnLike]) -> None:
        self._materialized = value

    @property
    def columns(self) -> List[str]:
        return list(self._schema.names) + [
            c for c in self._extra if c not in self._schema.names
        ]

    def __contains__(self, name: str) -> bool:
        return name in self._extra or name in self._schema.names

    def column(self, name: str) -> ColumnLike:
        if self._materialized is None and name in self._extra:
            return self._extra[name]
        return super().column(name)

    def has_disk_column(self, name: str) -> bool:
        # an in-memory appended column shadows a same-named disk column
        # (column() prefers it): streaming must not read the stale bytes
        return name not in self._extra and super().has_disk_column(name)

    def dtypes(self) -> List[Tuple[str, str]]:
        out = super().dtypes()
        listed = {n for n, _ in out}
        for name, col in self._extra.items():
            if name not in listed:
                arr = np.asarray(col)
                kind = (
                    f"vector<{arr.dtype}>[{arr.shape[1]}]"
                    if arr.ndim == 2
                    else str(arr.dtype)
                )
                out.append((name, kind))
        return out


def kfold_ids(n_rows: int, n_folds: int, seed: int = 0) -> np.ndarray:
    """Per-row fold assignment: one seeded numpy draw, the JAX package's,
    so both packages split a dataset into the same folds."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, n_folds, size=n_rows).astype(np.int8)


def kfold(df: DataFrame, n_folds: int, seed: int = 0) -> List[Tuple[DataFrame, DataFrame]]:
    """Random k-fold split -> list of (train, validation) pairs, the analog
    of pyspark CrossValidator's ``_kFold``."""
    fold_of = kfold_ids(df.count(), n_folds, seed)
    out = []
    for f in range(n_folds):
        val_mask = fold_of == f
        out.append((df.filter(~val_mask), df.filter(val_mask)))
    return out
