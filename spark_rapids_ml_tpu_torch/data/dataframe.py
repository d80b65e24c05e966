"""Lightweight host DataFrame — the port's data plane.

A copy of the in-memory part of ``spark_rapids_ml_tpu/data/dataframe.py``
(the port may not import the JAX package). A ``DataFrame`` is a
host-resident column store (numpy arrays / scipy CSR matrices) with a
logical partition count; estimators copy its rows straight onto the card.
The lazy parquet scan frames belong to the streamed out-of-core path, which
is not ported yet.

Column kinds:
  * scalar column  -> 1-D numpy array (any dtype)
  * vector column  -> 2-D numpy array (rows, dim)  — the analog of Spark's
    VectorUDT / array<float> columns
  * sparse vector  -> scipy.sparse.csr_matrix

Row order is meaningful and preserved by all operations.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import scipy.sparse as sp

ColumnLike = Union[np.ndarray, "sp.csr_matrix"]


def _is_sparse(col: Any) -> bool:
    return sp.issparse(col)


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
