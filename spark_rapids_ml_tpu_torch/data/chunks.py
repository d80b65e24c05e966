"""Chunked data sources: the ingest plane of the streamed out-of-core fits.

A copy of ``spark_rapids_ml_tpu/data/chunks.py`` (the port may not import
the JAX package), single process: :class:`ParquetChunkSource` has no
per-host file sharding. A streamed fit moves fixed-shape host chunks
through a small ring of device buffers while its state (sufficient
statistics) stays on the card, so the card never holds the dataset.

A :class:`ChunkSource` is a re-iterable description of a dataset: several
passes are first-class.

Sources:
  * :class:`ArrayChunkSource`    — in-memory dense numpy arrays
  * :class:`CSRChunkSource`      — scipy CSR, densified one chunk at a time
  * :class:`ParquetChunkSource`  — a directory of parquet files, read file
    by file (never materializes the dataset on the host)
  * :class:`GeneratorChunkSource`— chunks made by a function of the chunk's
    first row, row count and seed (datasets of any size without host
    materialization)
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

import scipy.sparse as sp


@dataclass
class Chunk:
    """One fixed-shape slab of rows.

    ``X`` always has exactly the requested ``chunk_rows`` rows; the last
    chunk of a pass is zero-padded and ``n_valid`` marks the real rows.
    """

    X: np.ndarray                    # (chunk_rows, d)
    n_valid: int
    y: Optional[np.ndarray] = None   # (chunk_rows,)
    w: Optional[np.ndarray] = None   # (chunk_rows,)

    def mask(self, dtype: Any = np.float32) -> np.ndarray:
        m = np.zeros((self.X.shape[0],), dtype=dtype)
        m[: self.n_valid] = 1.0
        return m


class ChunkSource:
    """Abstract re-iterable chunked dataset."""

    n_rows: int
    n_features: int
    has_label: bool = False
    has_weight: bool = False

    def iter_chunks(self, chunk_rows: int, dtype: Any = np.float32) -> Iterator[Chunk]:
        raise NotImplementedError

    def iter_labels(self, chunk_rows: int) -> Iterator[np.ndarray]:
        """Valid (unpadded) label values, one array per chunk.

        Label-only scans (class counting) must not pay for features: any
        source holding labels as a host array (``self._y``) slices it
        directly; others override (ParquetChunkSource reads only the label
        column) or fall through to full chunks.
        """
        y = getattr(self, "_y", None)
        if y is not None:
            for lo in range(0, self.n_rows, chunk_rows):
                yield np.asarray(y[lo : lo + chunk_rows])
            return
        if not self.has_label:
            raise ValueError("Chunk source has no label column")
        for chunk in self.iter_chunks(chunk_rows, np.float32):
            if chunk.y is None:
                raise ValueError("Chunk source has no label column")
            yield chunk.y[: chunk.n_valid]

    def num_chunks(self, chunk_rows: int) -> int:
        return max(1, -(-self.n_rows // chunk_rows))


def _pad_rows_to(a: Optional[np.ndarray], rows: int) -> Optional[np.ndarray]:
    if a is None or a.shape[0] == rows:
        return a
    pad = [(0, rows - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
    return np.pad(a, pad)


class ArrayChunkSource(ChunkSource):
    def __init__(
        self,
        X: np.ndarray,
        y: Optional[np.ndarray] = None,
        w: Optional[np.ndarray] = None,
    ):
        self._X, self._y, self._w = X, y, w
        self.n_rows, self.n_features = X.shape
        self.has_label = y is not None
        self.has_weight = w is not None

    def iter_chunks(self, chunk_rows: int, dtype: Any = np.float32) -> Iterator[Chunk]:
        for lo in range(0, self.n_rows, chunk_rows):
            hi = min(lo + chunk_rows, self.n_rows)
            X = np.ascontiguousarray(self._X[lo:hi], dtype=dtype)
            y = None if self._y is None else np.asarray(self._y[lo:hi], dtype=dtype)
            w = None if self._w is None else np.asarray(self._w[lo:hi], dtype=dtype)
            yield Chunk(
                X=_pad_rows_to(X, chunk_rows),
                n_valid=hi - lo,
                y=_pad_rows_to(y, chunk_rows),
                w=_pad_rows_to(w, chunk_rows),
            )


class CSRChunkSource(ChunkSource):
    """Sparse CSR rows densified one chunk at a time.

    Host CSR slices become dense device slabs of bounded size: device
    memory never holds the dense full matrix.
    """

    def __init__(self, X_csr: Any, y: Optional[np.ndarray] = None,
                 w: Optional[np.ndarray] = None):
        if not sp.issparse(X_csr):
            raise TypeError(f"CSRChunkSource takes a scipy sparse matrix, got {type(X_csr).__name__}")
        self._X = X_csr.tocsr()
        self._y, self._w = y, w
        self.n_rows, self.n_features = self._X.shape
        self.has_label = y is not None
        self.has_weight = w is not None

    def iter_chunks(self, chunk_rows: int, dtype: Any = np.float32) -> Iterator[Chunk]:
        for lo in range(0, self.n_rows, chunk_rows):
            hi = min(lo + chunk_rows, self.n_rows)
            X = np.asarray(self._X[lo:hi].todense(), dtype=dtype)
            y = None if self._y is None else np.asarray(self._y[lo:hi], dtype=dtype)
            w = None if self._w is None else np.asarray(self._w[lo:hi], dtype=dtype)
            yield Chunk(
                X=_pad_rows_to(X, chunk_rows),
                n_valid=hi - lo,
                y=_pad_rows_to(y, chunk_rows),
                w=_pad_rows_to(w, chunk_rows),
            )


def parquet_row_counts(files: Sequence[str]) -> List[int]:
    """Per-file ``num_rows`` from the parquet footers, scanned in parallel.

    A footer read is a tiny metadata round-trip dominated by I/O latency
    (object stores: one GET each), so a 50-file directory paid 50
    sequential round-trips before the first chunk could stream. A small
    thread pool overlaps them; order follows ``files``.
    """
    import pyarrow.parquet as pq

    def count(f: str) -> int:
        return int(pq.ParquetFile(f).metadata.num_rows)

    if len(files) <= 1:
        return [count(f) for f in files]
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(
        max_workers=min(16, len(files)), thread_name_prefix="parquet-footer"
    ) as pool:
        return list(pool.map(count, files))


class ParquetChunkSource(ChunkSource):
    """Stream a directory of parquet files without materializing it.

    Host memory is bounded by one parquet file plus one chunk buffer.
    Row counts and the feature dimension come from parquet metadata only.
    One process reads every file (the JAX package's per-host file sharding,
    ``shard_by_host``, is not ported).
    """

    def __init__(
        self,
        path: str,
        features_col: str = "features",
        label_col: Optional[str] = None,
        weight_col: Optional[str] = None,
        _files: Optional[Sequence[str]] = None,
        _n_rows: Optional[int] = None,
    ):
        import pyarrow as pa
        import pyarrow.parquet as pq

        from .dataframe import _parquet_files

        # _files/_n_rows: metadata a ParquetScanFrame already read, so the
        # directory is not listed and the footers are not read again
        self._files = list(_files) if _files is not None else _parquet_files(path)
        if not self._files:
            raise FileNotFoundError(f"No parquet files under {path}")
        self._features_col = features_col
        self._label_col = label_col
        self._weight_col = weight_col
        self.n_rows = int(_n_rows) if _n_rows is not None else sum(parquet_row_counts(self._files))
        first = pq.ParquetFile(self._files[0])
        ftype = first.schema_arrow.field(features_col).type
        if isinstance(ftype, pa.FixedSizeListType):
            self.n_features = ftype.list_size
        else:
            # variable list / Spark VectorUDT struct: peek ONE row (a full
            # row group would materialize rows x d float64 on the host just
            # to learn the dimension)
            from .dataframe import is_spark_vector_struct, spark_vector_to_numpy

            batch = next(first.iter_batches(batch_size=1, columns=[features_col]))
            col = batch.column(0)
            if is_spark_vector_struct(ftype):
                self.n_features = spark_vector_to_numpy(col).shape[1]
            else:
                self.n_features = len(col[0].as_py())
        self.has_label = label_col is not None
        self.has_weight = weight_col is not None

    def _read_file(self, f: str, dtype: Any):
        import pyarrow as pa
        import pyarrow.parquet as pq

        cols = [self._features_col]
        if self._label_col:
            cols.append(self._label_col)
        if self._weight_col:
            cols.append(self._weight_col)
        t = pq.read_table(f, columns=cols)
        fc = t.column(self._features_col).combine_chunks()
        if isinstance(fc.type, pa.FixedSizeListType):
            X = fc.flatten().to_numpy(zero_copy_only=False).reshape(-1, self.n_features)
        else:
            from .dataframe import is_spark_vector_struct, spark_vector_to_numpy

            if is_spark_vector_struct(fc.type):
                X = spark_vector_to_numpy(fc, dtype=dtype)
            else:
                X = np.stack([np.asarray(v) for v in fc.to_pylist()])
        # keep a narrower float storage dtype: put_chunk ships it as it is
        # and upcasts on the card
        if not (
            X.dtype.kind == "f" and X.dtype.itemsize < np.dtype(dtype).itemsize
        ):
            X = np.asarray(X, dtype=dtype)
        y = w = None
        if self._label_col:
            y = t.column(self._label_col).to_numpy(zero_copy_only=False).astype(dtype)
        if self._weight_col:
            w = t.column(self._weight_col).to_numpy(zero_copy_only=False).astype(dtype)
        return X, y, w

    def iter_labels(self, chunk_rows: int) -> Iterator[np.ndarray]:
        import pyarrow.parquet as pq

        if self._label_col is None:
            raise ValueError("Chunk source has no label column")
        for f in self._files:
            t = pq.read_table(f, columns=[self._label_col])
            yield t.column(self._label_col).to_numpy(zero_copy_only=False)

    def iter_chunks(self, chunk_rows: int, dtype: Any = np.float32) -> Iterator[Chunk]:
        bufX: List[np.ndarray] = []
        bufy: List[np.ndarray] = []
        bufw: List[np.ndarray] = []
        buffered = 0

        def drain(final: bool) -> Iterator[Chunk]:
            nonlocal bufX, bufy, bufw, buffered
            X = np.concatenate(bufX, axis=0) if len(bufX) > 1 else bufX[0]
            y = (np.concatenate(bufy) if len(bufy) > 1 else bufy[0]) if bufy else None
            w = (np.concatenate(bufw) if len(bufw) > 1 else bufw[0]) if bufw else None
            lo = 0
            while buffered - lo >= chunk_rows or (final and lo < buffered):
                hi = min(lo + chunk_rows, buffered)
                yield Chunk(
                    X=_pad_rows_to(np.ascontiguousarray(X[lo:hi]), chunk_rows),
                    n_valid=hi - lo,
                    y=_pad_rows_to(None if y is None else y[lo:hi], chunk_rows),
                    w=_pad_rows_to(None if w is None else w[lo:hi], chunk_rows),
                )
                lo = hi
            bufX = [X[lo:]] if lo < buffered else []
            bufy = [y[lo:]] if (y is not None and lo < buffered) else []
            bufw = [w[lo:]] if (w is not None and lo < buffered) else []
            buffered -= lo

        for f in self._files:
            X, y, w = self._read_file(f, dtype)
            bufX.append(X)
            if y is not None:
                bufy.append(y)
            if w is not None:
                bufw.append(w)
            buffered += X.shape[0]
            if buffered >= chunk_rows:
                yield from drain(final=False)
        if buffered:
            yield from drain(final=True)


class GeneratorChunkSource(ChunkSource):
    """Synthetic chunks from ``fn(start_row, n_rows, seed) -> (X, y|None)``.

    Each chunk is made deterministically from ``seed + chunk_index``, so
    any chunk can be produced on its own, at any scale, with no host
    materialization of the whole dataset.
    """

    def __init__(
        self,
        fn: Callable[[int, int, int], Tuple[np.ndarray, Optional[np.ndarray]]],
        n_rows: int,
        n_features: int,
        seed: int = 0,
        has_label: bool = False,
    ):
        self._fn = fn
        self.n_rows = n_rows
        self.n_features = n_features
        self._seed = seed
        self.has_label = has_label

    def iter_chunks(self, chunk_rows: int, dtype: Any = np.float32) -> Iterator[Chunk]:
        idx = 0
        for lo in range(0, self.n_rows, chunk_rows):
            hi = min(lo + chunk_rows, self.n_rows)
            X, y = self._fn(lo, hi - lo, self._seed + idx)
            X = np.ascontiguousarray(np.asarray(X, dtype=dtype))
            y = None if y is None else np.asarray(y, dtype=dtype)
            yield Chunk(
                X=_pad_rows_to(X, chunk_rows),
                n_valid=hi - lo,
                y=_pad_rows_to(y, chunk_rows),
            )
            idx += 1


def auto_chunk_rows(
    n_features: int,
    itemsize: int,
    n_dp: int,
    target_bytes: int = 128 << 20,
    max_rows: int = 1 << 20,
) -> int:
    """Rows per chunk so one chunk is ~``target_bytes`` on the device,
    rounded to a multiple of ``n_dp`` (1 on one card)."""
    rows = max(1, target_bytes // max(1, n_features * itemsize))
    rows = min(rows, max_rows)
    mult = max(1, n_dp)
    rows = max(mult, (rows // mult) * mult)
    return rows
