"""Streamed (out-of-core) sufficient statistics (counterpart of
``spark_rapids_ml_tpu/ops/streaming.py``, single device).

A streamed fit never holds the dataset on the card: fixed-shape host
chunks (``data.chunks``) move through a pipeline of bounded rings and are
folded into accumulators that stay on the card.

1. **decode**: :func:`prefetch_chunks` runs ``source.iter_chunks`` (parquet
   decode, CSR densification, a generator) on a thread, ``_PREFETCH_DEPTH``
   chunks ahead;
2. **stage**: :func:`_staged_chunks` copies each chunk through the page-
   locked staging ring of ``parallel.mesh`` onto the card, on the ring's
   copy stream, ``_STAGE_DEPTH`` chunks ahead of the fold;
3. **fold**: the caller's loop, on its own stream, which waits for the
   chunk's copy (an event) before its first read. Each chunk tensor is
   marked as used by that stream (``record_stream``), so the caching
   allocator does not hand its memory out again before the fold that read
   it is done; :class:`StreamGuard` proves the folds done every
   ``_SYNC_EVERY`` chunks and at the end of a pass, which bounds the
   chunks in flight.

Host and device memory are O(ring depths × chunk) whatever the row count.
Order, and so every accumulator, does not depend on the depths (one
producer a stage, FIFO queues).

Numerics: the means first, the centred Gram second (two passes), as in the
JAX package. The Gram pass is kernel K1 (``ops.linalg.shifted_gram``) a
chunk, with row scales √(mask·w) and the exact mean of pass 1 as its shift.
Accumulators are in the fit's dtype, as in the JAX package: f32, or f64
under ``float32_inputs=False``, where the chunks travel as f64 and every
fold takes its kernel's float64 route (chosen by dtype at the fold:
``shifted_gram_scan``, ``logreg_loss_grad_xla``, ``chunk_stats_xla``).

LogisticRegression (:func:`streamed_logreg_fit`): one host pass over the
labels, a moments pass and, under ``standardization``, a variance pass,
then the host L-BFGS/OWL-QN of ``ops.lbfgs``, each of whose evaluations is
one pass that folds every chunk through kernel K3
(``ops.logreg_kernels.logreg_loss_grad``) at the evaluation's effective
coefficients; the chain rule back to the solver's coordinates is applied
once a pass, in f64 on the host.

KMeans (:func:`streamed_kmeans_lloyd`): one pass a Lloyd iteration, every
chunk folded through kernel K2 (``ops.kmeans_kernels.lloyd_step``) into
``(sums, counts, cost)`` on the card, the centre update on the host in
f64, and a final cost pass. The k-means|| seeding passes: a host gather of
rows by global index (:func:`streamed_rows_at`), the min distances to the
candidates into a host f64 array (:func:`streamed_min_sq_dists_update`,
the plain distance product) and the candidates' closest-row counts
(:func:`streamed_count_closest`, K2's counts).

Wire formats (``WIRE_DTYPE``, or ``wire=`` of :func:`iter_device_chunks`
for one loop): the staging thread encodes each chunk's ``X`` as f32 (the
default), f16, per-column affine int8 or scaled e4m3 f8 (:func:`put_chunk`;
the bytes are the JAX package's), the ring moves the narrow buffer and its
O(d) scales, and the card dequantizes it on the ring's copy stream into the
fit's dtype, so the folds and kernels K1/K2/K3 read an f32 ``X`` as before
(a float64 fit: an f64 ``X``; its ``f32`` wire ships f64 unchanged);
``auto`` picks a pass's encoding from its first chunk
(:func:`select_wire_format`).

Checkpoint/resume: the streamed LogisticRegression (through
``ops.lbfgs.minimize_lbfgs_host``) and the streamed Lloyd take a
``runtime.checkpoint.FitCheckpointer`` and resume from its last committed
iteration.

Not ported (ROADMAP): the retry budget and chunk halving of
``stage_chunks``, fault sites, preempt points, telemetry spans, ops-plane
gauges and autotune consults (the wire's among them), per-host file
sharding, the blocked (mp) Gram and the cross-process sums of partials and
label summaries (the identity on one process).
"""

from __future__ import annotations

import contextlib
import itertools
import queue
import threading
import time
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..data.chunks import Chunk, ChunkSource
from ..parallel.mesh import _np_dtype, _torch_dtype, pinned_ring
from ..utils.logging import get_logger
from .kmeans_kernels import chunk_stats, min_sq_dists
from .lbfgs import minimize_lbfgs_host
from .linalg import gram_kernel_ok, shifted_gram, shifted_gram_scan
from .logreg_kernels import logreg_kernel_ok, logreg_loss_grad, logreg_loss_grad_xla

# the JAX package's TPUML_STREAM_PREFETCH, TPUML_STREAM_STAGE_DEPTH and
# TPUML_STREAM_SYNC_EVERY defaults: decoded chunks ahead, staged chunks
# ahead, and chunks between StreamGuard syncs
_PREFETCH_DEPTH = 2
_STAGE_DEPTH = 2
_SYNC_EVERY = 4

_TENSORS = ("X", "mask", "y", "w")


# ---------------------------------------------------------------------------
# Ingest report: what the pipeline did, for the port to see its own pace
# ---------------------------------------------------------------------------

_INGEST: Dict[str, Any] = {}
_INGEST_LOCK = threading.Lock()


def reset_ingest_report() -> None:
    """Start a new report; every pass until the next reset adds to it."""
    with _INGEST_LOCK:
        _INGEST.clear()


def last_ingest_report() -> Dict[str, Any]:
    """Copy of the report of the passes since the last reset: the ring
    depths, the wire encoding of the last pass (``wire_dtype``), the passes
    by name and their wall seconds by name (``pass_s``), the chunks folded
    and the bytes the card was sent (at the wire's width, scales included;
    0 on the CPU), and the seconds in decode (host), wire encoding (host,
    ``encode_s``), host → page-locked copies (host), waits for a
    page-locked buffer to come free (host), host → device
    copies (card: each chunk's span on the copy stream, from its first
    piece's start to its last's end, so including any wait for the host to
    fill a buffer; absent on the CPU), and the fold (the caller's loop body
    on the host, and on the card its stream's time from the chunk's arrival
    to the fold's end)."""
    with _INGEST_LOCK:
        return {k: (dict(v) if isinstance(v, dict) else v) for k, v in _INGEST.items()}


def _report_add(**values: Any) -> None:
    """Add counts and seconds to the report (a dict value adds key by key)."""
    with _INGEST_LOCK:
        for k, v in values.items():
            if isinstance(v, dict):
                d = _INGEST.setdefault(k, {})
                for kk, vv in v.items():
                    d[kk] = d.get(kk, 0) + vv
            else:
                _INGEST[k] = _INGEST.get(k, 0) + v


# ---------------------------------------------------------------------------
# Chunk transfer
# ---------------------------------------------------------------------------


class StreamGuard:
    """Bounds the chunks a streaming loop has in flight.

    Each ``tick`` hands the guard one staged chunk. Every ``_SYNC_EVERY``
    chunks, and at :meth:`flush`, which every loop must call at its end,
    the guard records an event on the current stream after the folds
    enqueued so far and waits for it: that proves every fold that read the
    held chunks done, and only then drops its references to them. So the
    host can run at most ``_SYNC_EVERY`` chunks ahead of the card. On the
    CPU nothing is pending and the sync is a no-op."""

    def __init__(self) -> None:
        self._pending: list = []
        self._i = 0

    def _sync_and_release(self) -> None:
        last = self._pending[-1]
        if last["X"].is_cuda:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(last["X"].device))
            done.synchronize()
        self._pending.clear()

    def tick(self, dev: Dict[str, Any]) -> None:
        self._pending.append(dev)
        self._i += 1
        if _SYNC_EVERY > 0 and self._i % _SYNC_EVERY == 0:
            self._sync_and_release()

    def flush(self) -> None:
        """Sync and release the tail; call after every streaming loop."""
        if self._pending:
            self._sync_and_release()


def _queue_ring(produce, depth: int, name: str):
    """Run ``produce(put)`` on a thread that hands items through a FIFO
    queue of ``depth``; yield them in order. An error in the thread reaches
    the consumer (after the items made before it); closing the generator
    early cancels the thread, which polls a flag between puts, and joins it."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    end = object()
    cancel = threading.Event()
    err: list = []

    def put(item) -> bool:
        while not cancel.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            produce(put)
        except BaseException as e:  # noqa: BLE001 — re-raised on the consumer
            err.append(e)
        finally:
            put(end)

    th = threading.Thread(target=worker, name=name, daemon=True)
    th.start()
    try:
        while True:
            # deliver what was made before a failure, then raise at once
            # instead of waiting behind `depth` buffered items
            if err:
                try:
                    item = q.get_nowait()
                except queue.Empty:
                    raise err[0].with_traceback(err[0].__traceback__) from None
            else:
                item = q.get()
            if item is end:
                break
            yield item
        if err:
            raise err[0].with_traceback(err[0].__traceback__)
    finally:
        cancel.set()
        th.join(timeout=30.0)


def prefetch_chunks(it, depth: Optional[int] = None):
    """Decode chunks on a background thread, ``depth`` ahead (default
    ``_PREFETCH_DEPTH``; 0 yields ``it`` unchanged), so that decode overlaps
    the copies and the fold. The seconds spent in ``next(it)`` go to the
    ingest report as ``decode_s``. Close the generator when abandoning it
    early."""
    depth = _PREFETCH_DEPTH if depth is None else depth
    if depth <= 0:
        yield from it
        return

    def produce(put):
        src = iter(it)
        decode_s = 0.0
        try:
            while True:
                t = time.perf_counter()
                c = next(src, None)
                decode_s += time.perf_counter() - t
                if c is None or not put(c):
                    return
        finally:
            _report_add(decode_s=decode_s)

    yield from _queue_ring(produce, depth, "chunk-prefetch")


# ---------------------------------------------------------------------------
# Wire formats: fewer bytes over the host -> device link
# ---------------------------------------------------------------------------

# the wire encoding of streamed feature chunks, the JAX package's
# TPUML_WIRE_DTYPE: "f32" ships the storage dtype unchanged (the default),
# "f16" downcasts on the host and upcasts on the card, "int8" / "f8"
# quantize per chunk column on the host (affine / e4m3 scaled) and
# dequantize on the card, "auto" probes the first chunk of a pass
WIRE_DTYPE = "f32"
_WIRE_KINDS = ("f32", "f16", "int8", "f8", "auto")

# float8 e4m3 finite max (S.1111.110 -> 448); quantization maps each
# column's observed absmax onto it
_F8_MAX = 448.0

# auto-probe acceptance thresholds: relative RMS reconstruction error of
# the first chunk under each encoding
_AUTO_INT8_TOL = 2e-2
_AUTO_F16_TOL = 2e-3

_WIRE_LOGGER = get_logger("streaming.wire")


def _quantize_int8(x: np.ndarray, n_valid: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-chunk-column affine int8: ``x ~ q * scale + offset``.

    Ranges come from the valid rows only (padding rows quantize to
    whatever clips: every fold step multiplies them away by the mask). A
    constant column gets scale 1 so the reconstruction is exact. The bytes
    are the JAX package's."""
    v = x[:n_valid] if 0 < n_valid < x.shape[0] else x
    lo = v.min(axis=0).astype(np.float32)
    hi = v.max(axis=0).astype(np.float32)
    scale = ((hi - lo) / np.float32(254.0)).astype(np.float32)
    scale = np.where(scale > 0, scale, np.float32(1.0))
    offset = ((hi + lo) * np.float32(0.5)).astype(np.float32)
    # in place: this runs a chunk on the staging thread, so no stack of
    # chunk-sized temporaries
    q = x - offset
    q /= scale
    np.rint(q, out=q)
    np.clip(q, -127, 127, out=q)
    return q.astype(np.int8), scale, offset


def _f8_supported() -> bool:
    """True where torch has the e4m3 dtype the f8 wire encodes with."""
    return hasattr(torch, "float8_e4m3fn")


def _quantize_f8(x: np.ndarray, n_valid: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-chunk-column scaled e4m3: ``x ~ q * scale`` with each column's
    absmax mapped to the f8 finite max (no offset). ``q`` is the e4m3 bytes
    as ``uint8``, cast by torch (numpy has no e4m3 without ``ml_dtypes``):
    round to nearest even, as ``ml_dtypes`` rounds. Past 464 torch
    saturates to 448 where ``ml_dtypes`` gives NaN, but a scaled value
    exceeds 448 by at most its rounding, so the bytes are the JAX
    package's."""
    v = x[:n_valid] if 0 < n_valid < x.shape[0] else x
    amax = np.abs(v).max(axis=0).astype(np.float32)
    scale = np.where(amax > 0, amax / np.float32(_F8_MAX), np.float32(1.0))
    q = torch.from_numpy(np.ascontiguousarray(x / scale)).to(torch.float8_e4m3fn).view(torch.uint8)
    return q.numpy(), scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor, offset: Optional[torch.Tensor], wire: str,
                dtype: torch.dtype) -> torch.Tensor:
    """The dense chunk of a quantized wire buffer, as the JAX package's
    ``QuantizedWire.dense``: ``q`` upcast, times ``scale``, then plus
    ``offset`` (absent for f8), each step rounded to ``dtype``."""
    if wire == "f8":
        q = q.view(torch.float8_e4m3fn)
    x = q.to(dtype)
    x.mul_(scale.to(dtype))
    if offset is not None:
        x.add_(offset.to(dtype))
    return x


def resolve_wire_dtype(requested: Optional[str] = None) -> str:
    """``requested``, or ``WIRE_DTYPE`` where None, checked: ``ValueError``
    for anything but f32, f16, int8, f8 or auto."""
    kind = WIRE_DTYPE if requested is None else requested
    if kind not in _WIRE_KINDS:
        raise ValueError(f"wire dtype {kind!r} must be one of {', '.join(_WIRE_KINDS)}")
    return kind


def _probe_quant_error(x: np.ndarray, kind: str) -> float:
    """Relative RMS reconstruction error of encoding ``x`` as ``kind``."""
    v = np.asarray(x, np.float32)
    if kind == "int8":
        q, scale, offset = _quantize_int8(v, v.shape[0])
        rec = q.astype(np.float32) * scale + offset
    else:  # f16
        rec = v.astype(np.float16).astype(np.float32)
    rms = float(np.sqrt(np.mean(v * v)))
    return float(np.sqrt(np.mean((rec - v) ** 2))) / max(rms, 1e-12)


def select_wire_format(sample_X: np.ndarray, requested: Optional[str] = None) -> str:
    """The wire encoding of one streaming pass (never ``auto``), from its
    first chunk: ``requested`` (None: ``WIRE_DTYPE``); non-float storage
    ships as ``f32``; ``auto`` takes int8 where the chunk's int8
    reconstruction error is within ``_AUTO_INT8_TOL``, else f16 within
    ``_AUTO_F16_TOL``, else f32; an explicit request is never second-
    guessed, but f8 on a torch without e4m3 warns and ships f16."""
    kind = resolve_wire_dtype(requested)
    x = np.asarray(sample_X)
    if x.dtype.kind != "f":
        return "f32"
    if kind == "auto":
        err8 = _probe_quant_error(x, "int8")
        if err8 <= _AUTO_INT8_TOL:
            kind = "int8"
        elif _probe_quant_error(x, "f16") <= _AUTO_F16_TOL:
            kind = "f16"
        else:
            kind = "f32"
        _WIRE_LOGGER.info("wire auto: int8 probe error %.2e -> wire %s", err8, kind)
    if kind == "f8" and not _f8_supported():
        _WIRE_LOGGER.warning("wire f8 requested but this torch has no float8_e4m3fn; falling back to f16")
        kind = "f16"
    return kind


def _encode(x: np.ndarray, n_valid: int, wire: str, np_dtype: np.dtype):
    """``(X as it ships, scale, offset)`` of a host chunk at the resolved
    ``wire``: int8 / f8 quantized with their O(d) scales (f8: no offset);
    a float narrower than ``np_dtype`` (f16 storage) as it is; f16 a
    downcast; else ``X`` in ``np_dtype``."""
    if wire in ("int8", "f8") and x.dtype.kind == "f":
        if wire == "int8":
            return _quantize_int8(x, n_valid)
        return (*_quantize_f8(x, n_valid), None)
    if x.dtype.kind == "f" and x.dtype.itemsize < np_dtype.itemsize:
        return x, None, None
    if wire == "f16" and x.dtype.kind == "f" and x.dtype.itemsize > 2:
        return x.astype(np.float16), None, None
    return np.asarray(x, dtype=np_dtype), None, None


def put_chunk(
    chunk: Chunk, device: torch.device, dtype: torch.dtype = torch.float32, *,
    need_y: bool = True, need_w: bool = True, wire: str = "f32",
) -> Dict[str, Any]:
    """Copy one host chunk onto ``device``: ``X``, ``mask`` (1 for the
    chunk's ``n_valid`` rows, 0 for its padding), and ``y`` / ``w`` where
    the chunk has them and ``need_y`` / ``need_w`` ask for them (a step
    that does not read a column must not pay for its copy).

    ``wire`` is a resolved :func:`select_wire_format` value (never
    ``auto``): int8 / f8 quantize ``X`` per chunk column on the host and
    ship the 1-byte buffer with its O(d) ``scale`` (and int8's ``offset``),
    dequantized on the card (:func:`_dequantize`); f16 downcasts on the
    host. A chunk stored in a float narrower than ``dtype`` (f16 parquet,
    or the f16 wire) is copied as it is and upcast on the card. So every
    fold reads ``X`` in ``dtype``; the narrow buffer is dropped once the upcast
    is enqueued behind it on the same stream. On a card every copy goes
    through the page-locked staging ring on its copy stream and the tensors
    are made on that stream; ``_ready`` is the event after them, for which
    a reader on another stream must wait (:func:`iter_device_chunks` does).
    ``_h2d`` is the pair of timing events around the copies, ``_bytes`` the
    host bytes moved, ``_encode_s`` the host seconds of the encoding."""
    np_dtype = _np_dtype(dtype)
    t0 = time.perf_counter()
    x_host, scale, offset = _encode(np.asarray(chunk.X), chunk.n_valid, wire, np_dtype)
    encode_s = time.perf_counter() - t0
    host = {
        "X": x_host,
        "scale": scale,
        "offset": offset,
        "y": None if chunk.y is None or not need_y else np.asarray(chunk.y, dtype=np_dtype),
        "w": None if chunk.w is None or not need_w else np.asarray(chunk.w, dtype=np_dtype),
    }
    rows = x_host.shape[0]
    if device.type != "cuda":
        dev = {k: None if a is None else torch.from_numpy(np.array(a)) for k, a in host.items()}
        out = _dense_columns(dev, wire, dtype)
        out.update(mask=torch.from_numpy(chunk.mask(np_dtype)), _ready=None, _h2d=None, _bytes=0,
                   _encode_s=encode_s)
        return out
    ring = pinned_ring(device)
    dev = {}
    nbytes = 0
    with ring.lock, torch.cuda.stream(ring.stream):
        start = torch.cuda.Event(enable_timing=True)
        start.record(ring.stream)
        for k, a in host.items():
            if a is None:
                dev[k] = None
                continue
            t = torch.empty(a.shape, dtype=_torch_dtype(a.dtype), device=device)
            ring.copy(t, a)
            nbytes += a.nbytes
            dev[k] = t
        out = _dense_columns(dev, wire, dtype)  # the dequantize / upcast, on the card
        mask = torch.zeros((rows,), dtype=dtype, device=device)
        mask[: chunk.n_valid] = 1.0
        out["mask"] = mask
        ready = torch.cuda.Event(enable_timing=True)
        ready.record(ring.stream)
    out.update(_ready=ready, _h2d=(start, ready), _bytes=nbytes, _encode_s=encode_s)
    return out


def _dense_columns(dev: Dict[str, Optional[torch.Tensor]], wire: str, dtype: torch.dtype) -> Dict[str, Any]:
    """``X``, ``y``, ``w`` in ``dtype`` from the tensors as they were
    shipped: ``X`` dequantized where it came with a ``scale``."""
    out: Dict[str, Any] = {k: None if dev[k] is None else dev[k].to(dtype) for k in ("y", "w")}
    if dev["scale"] is not None:
        out["X"] = _dequantize(dev["X"], dev["scale"], dev["offset"], wire, dtype)
    else:
        out["X"] = dev["X"].to(dtype)
    return out


def _await_chunk(dev: Dict[str, Any], stream: Optional[torch.cuda.Stream]) -> None:
    """Make ``stream`` wait for a staged chunk, and mark its tensors as used
    there so their memory is not handed out again before the fold is done."""
    ready = dev.get("_ready")
    if ready is None:
        return
    stream.wait_event(ready)
    for k in _TENSORS:
        if dev[k] is not None:
            dev[k].record_stream(stream)


def stage_chunks(chunk: Chunk, device: torch.device, dtype: torch.dtype = torch.float32, *,
                 need_y: bool = True, need_w: bool = True, wire: str = "f32"):
    """Stage ``chunk`` on ``device``: yields one ``(chunk, dev)`` pair (the
    JAX package's retry budget and chunk halving are not ported)."""
    yield chunk, put_chunk(chunk, device, dtype, need_y=need_y, need_w=need_w, wire=wire)


def _staged_chunks(chunks, device: torch.device, dtype: torch.dtype, *, need_y: bool, need_w: bool,
                   wire: str, depth: int):
    """The staging ring stage: a thread pulls decoded chunks, encodes them
    for the ``wire`` and stages them (:func:`put_chunk`) up to ``depth``
    ahead of the consumer, so the fold and the StreamGuard's waits do not
    serialize against the encoding and the copies. Yields ``(chunk, dev)``
    in source order; the seconds of host → page-locked copies and of
    buffer waits go to the ingest report."""
    ring = pinned_ring(device) if device.type == "cuda" else None

    def produce(put):
        if ring is not None:
            torch.cuda.set_device(device)
        host0, wait0 = (ring.host_s, ring.wait_s) if ring is not None else (0.0, 0.0)
        try:
            for chunk in chunks:
                if not put((chunk, put_chunk(chunk, device, dtype, need_y=need_y, need_w=need_w, wire=wire))):
                    return
        finally:
            if ring is not None:
                _report_add(host_to_pinned_s=ring.host_s - host0, slot_wait_s=ring.wait_s - wait0)

    yield from _queue_ring(produce, depth, "chunk-stage")


def iter_device_chunks(
    source: ChunkSource,
    device: torch.device,
    chunk_rows: int,
    dtype: torch.dtype = torch.float32,
    *,
    need_y: bool = True,
    need_w: bool = True,
    pass_name: str = "pass",
    wire: Optional[str] = None,
) -> Iterator[Tuple[Chunk, Dict[str, Any]]]:
    """The ingest pipeline of every streaming loop: yields ``(chunk, dev)``
    in source order, ``dev`` ready to read on the caller's current stream.
    The wire encoding is resolved once, from the first chunk
    (:func:`select_wire_format`; ``wire`` None: ``WIRE_DTYPE``), and every
    chunk of the pass ships in it. Adds this pass to the ingest report
    (:func:`last_ingest_report`) under ``pass_name``."""
    requested = resolve_wire_dtype(wire)
    np_dtype = _np_dtype(dtype)
    stream = torch.cuda.current_stream(device) if device.type == "cuda" else None
    it = prefetch_chunks(source.iter_chunks(chunk_rows, np_dtype))
    h2d, folds = [], []
    n_chunks = nbytes = 0
    fold_s = encode_s = 0.0
    kind = None
    t_pass = time.perf_counter()
    try:
        first = next(it, None)
        kind = "f32" if first is None else select_wire_format(first.X, requested)
        chunks = iter(()) if first is None else itertools.chain([first], it)
        if _STAGE_DEPTH > 0:
            staged = _staged_chunks(chunks, device, dtype, need_y=need_y, need_w=need_w, wire=kind,
                                    depth=_STAGE_DEPTH)
        else:
            staged = (pair for chunk in chunks for pair in stage_chunks(
                chunk, device, dtype, need_y=need_y, need_w=need_w, wire=kind))
        with contextlib.closing(staged) as staged_it:
            for chunk, dev in staged_it:
                _await_chunk(dev, stream)
                ev0 = ev1 = None
                if stream is not None:
                    ev0 = torch.cuda.Event(enable_timing=True)
                    ev0.record(stream)
                t = time.perf_counter()
                yield chunk, dev
                fold_s += time.perf_counter() - t
                if stream is not None:
                    ev1 = torch.cuda.Event(enable_timing=True)
                    ev1.record(stream)
                    h2d.append(dev["_h2d"])
                    folds.append((ev0, ev1))
                n_chunks += 1
                nbytes += dev["_bytes"]
                encode_s += dev["_encode_s"]
    finally:
        it.close()
        card = {}
        if stream is not None and folds:
            folds[-1][1].synchronize()
            h2d[-1][1].synchronize()
            card = {"host_to_device_s": sum(a.elapsed_time(b) for a, b in h2d) / 1e3,
                    "fold_device_s": sum(a.elapsed_time(b) for a, b in folds) / 1e3}
        wall = time.perf_counter() - t_pass
        _report_add(passes={pass_name: 1}, pass_s={pass_name: wall}, chunks=n_chunks, bytes=nbytes,
                    encode_s=encode_s, fold_s=fold_s, wall_s=wall, **card)
        with _INGEST_LOCK:
            _INGEST.update(prefetch_depth=_PREFETCH_DEPTH, stage_depth=_STAGE_DEPTH, sync_every=_SYNC_EVERY,
                           chunk_rows=int(chunk_rows))
            if kind is not None:
                _INGEST["wire_dtype"] = kind


# ---------------------------------------------------------------------------
# Pass 1: weighted first moments
# ---------------------------------------------------------------------------


def moments1_init(d: int, device: torch.device, dtype: torch.dtype, with_y: bool) -> Dict[str, torch.Tensor]:
    acc = {
        "n": torch.zeros((), dtype=dtype, device=device),
        "sum_x": torch.zeros((d,), dtype=dtype, device=device),
    }
    if with_y:
        acc["sum_y"] = torch.zeros((), dtype=dtype, device=device)
    return acc


def moments1_step(acc: Dict[str, torch.Tensor], X: torch.Tensor, rw: torch.Tensor,
                  y: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Fold one chunk into (Σw, Σw·x [, Σw·y]) in place; ``rw`` = mask·weight."""
    acc["n"] += rw.sum()
    acc["sum_x"] += rw @ X
    if y is not None:
        acc["sum_y"] += y @ rw
    return acc


# ---------------------------------------------------------------------------
# Pass 2: centred second moments (Gram / cross / residual)
# ---------------------------------------------------------------------------


def gram2_init(d: int, device: torch.device, dtype: torch.dtype, with_y: bool) -> Dict[str, torch.Tensor]:
    acc = {"G": torch.zeros((d, d), dtype=dtype, device=device)}
    if with_y:
        acc["Xy"] = torch.zeros((d,), dtype=dtype, device=device)
        acc["yy"] = torch.zeros((), dtype=dtype, device=device)
    return acc


def gram2_step(acc: Dict[str, torch.Tensor], X: torch.Tensor, rw: torch.Tensor, mean_x: torch.Tensor,
               y: Optional[torch.Tensor] = None, mean_y: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Fold one chunk into G = (Xc√w)ᵀ(Xc√w) [, Xy, yy], centred at the
    exact means, in place. G is kernel K1 with m = √w and μ = ``mean_x``
    (a float64 chunk: ``shifted_gram_scan``); Xy and yy are plain products
    over the centred, √w-scaled chunk."""
    sw = torch.sqrt(rw).contiguous()
    G, _ = shifted_gram(X, sw, mean_x) if gram_kernel_ok(X.dtype) else shifted_gram_scan(X, sw, mean_x)
    acc["G"] += G
    if y is not None:
        yc = (y - mean_y) * sw
        acc["Xy"] += ((X - mean_x[None, :]) * sw[:, None]).T @ yc
        acc["yy"] += yc @ yc
    return acc


def streamed_suffstats(
    source: ChunkSource,
    device: torch.device,
    chunk_rows: int,
    dtype: torch.dtype = torch.float32,
    *,
    with_y: bool = False,
    fit_intercept: bool = True,
) -> Dict[str, torch.Tensor]:
    """Two streaming passes → the statistics the resident solvers take
    (``n``, ``mean_x``, ``mean_all``, ``G``, ``var`` [, ``mean_y``, ``Xy``,
    ``yy``]): LinearRegression's ``_solve_from_stats`` and PCA's
    ``_pca_from_cov`` are reused unchanged. One process: the JAX package's
    cross-process sum of the partials is the identity here."""
    d = source.n_features
    acc1 = moments1_init(d, device, dtype, with_y)
    guard = StreamGuard()
    with contextlib.closing(iter_device_chunks(source, device, chunk_rows, dtype, need_y=with_y,
                                               pass_name="moments")) as chunks:
        for _, dev in chunks:
            rw = dev["mask"] if dev["w"] is None else dev["mask"] * dev["w"]
            moments1_step(acc1, dev["X"], rw, dev["y"] if with_y else None)
            guard.tick(dev)
        guard.flush()
    n = acc1["n"]
    mean_all = acc1["sum_x"] / n
    if fit_intercept:
        mean_x = mean_all
        mean_y = acc1["sum_y"] / n if with_y else None
    else:
        mean_x = torch.zeros((d,), dtype=dtype, device=device)
        mean_y = torch.zeros((), dtype=dtype, device=device) if with_y else None
    mean_x = mean_x.contiguous()

    acc2 = gram2_init(d, device, dtype, with_y)
    guard = StreamGuard()
    with contextlib.closing(iter_device_chunks(source, device, chunk_rows, dtype, need_y=with_y,
                                               pass_name="gram")) as chunks:
        for _, dev in chunks:
            rw = dev["mask"] if dev["w"] is None else dev["mask"] * dev["w"]
            gram2_step(acc2, dev["X"], rw, mean_x, dev["y"] if with_y else None, mean_y)
            guard.tick(dev)
        guard.flush()

    G = acc2["G"]
    var = torch.diagonal(G) / n
    if not fit_intercept:
        var = var - mean_all * mean_all
    stats = {"n": n, "mean_x": mean_x, "mean_all": mean_all, "G": G, "var": var}
    if with_y:
        stats.update(mean_y=mean_y, Xy=acc2["Xy"], yy=acc2["yy"])
    return stats


# ---------------------------------------------------------------------------
# LogisticRegression: label statistics, feature moments, objective passes
# ---------------------------------------------------------------------------


def streamed_label_stats(source: ChunkSource, chunk_rows: int) -> Dict[str, Any]:
    """One host pass over the label stream (``source.iter_labels``): what
    ``parallel.mesh.global_label_summary`` returns on one process
    (``y_max``, ``y_min``, ``all_int``, ``all_same``, ``first``,
    ``total``), without materializing the dataset. Raises ``ValueError``
    on an empty label column. Counts as a ``labels`` pass in the report."""
    y_max = -np.inf
    y_min = np.inf
    all_int = True
    first = None
    all_same = True
    n_seen = 0
    t = time.perf_counter()
    for yv in source.iter_labels(chunk_rows):
        if yv.size == 0:
            continue
        n_seen += yv.size
        y_max = max(y_max, float(yv.max()))
        y_min = min(y_min, float(yv.min()))
        if not np.all(yv == np.floor(yv)):
            all_int = False
        if first is None:
            first = float(yv[0])
        if not np.all(yv == first):
            all_same = False
    _report_add(passes={"labels": 1}, pass_s={"labels": time.perf_counter() - t})
    if n_seen == 0:
        raise ValueError("Labels column is empty")
    return {"y_max": float(y_max), "y_min": float(y_min), "all_int": all_int, "all_same": all_same,
            "first": float(first), "total": int(n_seen)}


def var_chunk_step(acc: torch.Tensor, X: torch.Tensor, rw: torch.Tensor, mean: torch.Tensor) -> torch.Tensor:
    """Fold one chunk into Σ w·(x − mean)² (the diagonal of the centred
    second moment) in place; ``rw`` = mask·weight."""
    dx = (X - mean[None, :]) * torch.sqrt(rw)[:, None]
    acc += (dx * dx).sum(dim=0)
    return acc


def logreg_chunk_vg_step(
    acc: Dict[str, torch.Tensor], X: torch.Tensor, mask: torch.Tensor, y: torch.Tensor,
    Aeff: torch.Tensor, beff: torch.Tensor, multinomial: bool,
) -> Dict[str, torch.Tensor]:
    """Fold one chunk's masked log-loss and its gradient with respect to
    the effective coefficients ``(Aeff (K, d), beff (K,))`` into ``acc``
    (``f``, ``gA``, ``gb``) in place: kernel K3 on the card, its plain
    version on the CPU; a float64 chunk the autograd route
    (``logreg_loss_grad_xla``) on either."""
    if logreg_kernel_ok(X.dtype):
        loss, gA, gb = logreg_loss_grad(X, y, mask, Aeff, beff, multinomial)
    else:
        loss, gA, gb = logreg_loss_grad_xla(X, y, mask, Aeff, beff, multinomial)
    acc["f"] += loss
    acc["gA"] += gA
    acc["gb"] += gb
    return acc


def logreg_effective(A: np.ndarray, b: np.ndarray, mean: np.ndarray, inv_std: np.ndarray,
                     use_center: bool) -> Tuple[np.ndarray, np.ndarray]:
    """The logits' coefficients of standardized-space ``(A, b)``:
    ``Aeff = A·inv_std``, ``beff = b − Aeff·mean`` (``b`` where not
    ``use_center``), in f64."""
    Aeff = A * inv_std[None, :]
    return Aeff, (b - Aeff @ mean) if use_center else b


def logreg_flat_grad(gA: np.ndarray, gb: np.ndarray, mean: np.ndarray, inv_std: np.ndarray, *,
                     use_center: bool, fit_intercept: bool) -> np.ndarray:
    """The chain rule from the effective coefficients' gradient back to the
    solver's flat vector ``[A.ravel(), b]``, in f64: ``gA = (gAeff −
    gbeff ⊗ mean)·inv_std`` (the mean term only where ``use_center``),
    ``gb = gbeff`` (absent without an intercept)."""
    gA = np.asarray(gA, np.float64)
    gb = np.asarray(gb, np.float64)
    if use_center:
        gA = gA - gb[:, None] * mean[None, :]
    gA = gA * inv_std[None, :]
    return np.concatenate([gA.ravel(), gb]) if fit_intercept else gA.ravel()


def streamed_logreg_moments(
    source: ChunkSource, device: torch.device, chunk_rows: int, dtype: torch.dtype = torch.float32, *,
    variance: bool, cache: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """The feature statistics of a streamed LogisticRegression, into
    ``cache`` (a fresh dict if None) where it lacks them: pass 1 the row
    count ``n`` (a float) and ``mean`` (f32 on ``device``); where
    ``variance``, pass 2 the unbiased variance (n − 1, the reference's
    denominator) as ``inv_std`` (1 where a column is constant). Every param
    map of one ``fitMultiple`` shares one cache, so one moments pass and at
    most one variance pass serve them all."""
    cache = {} if cache is None else cache
    d = source.n_features
    if "mean" not in cache:
        acc = moments1_init(d, device, dtype, with_y=False)
        guard = StreamGuard()
        with contextlib.closing(iter_device_chunks(source, device, chunk_rows, dtype, need_y=False,
                                                   need_w=False, pass_name="moments")) as chunks:
            for _, dev in chunks:
                moments1_step(acc, dev["X"], dev["mask"])
                guard.tick(dev)
            guard.flush()
        cache["n"] = float(acc["n"])
        cache["mean"] = (acc["sum_x"] / acc["n"]).contiguous()
    if variance and "inv_std" not in cache:
        vacc = torch.zeros((d,), dtype=dtype, device=device)
        guard = StreamGuard()
        with contextlib.closing(iter_device_chunks(source, device, chunk_rows, dtype, need_y=False,
                                                   need_w=False, pass_name="variance")) as chunks:
            for _, dev in chunks:
                var_chunk_step(vacc, dev["X"], dev["mask"], cache["mean"])
                guard.tick(dev)
            guard.flush()
        std = torch.sqrt(torch.clamp(vacc / max(cache["n"] - 1.0, 1.0), min=0.0))
        cache["inv_std"] = torch.where(std > 0, 1.0 / std, torch.ones_like(std))
    return cache


def streamed_logreg_fit(
    source: ChunkSource,
    device: torch.device,
    chunk_rows: int,
    dtype: torch.dtype = torch.float32,
    *,
    n_classes: int,
    multinomial: bool,
    fit_intercept: bool,
    standardization: bool,
    l1: float,
    l2: float,
    max_iter: int,
    tol: float,
    history: int = 10,
    moments: Optional[Dict[str, Any]] = None,
    checkpointer=None,
) -> Dict[str, Any]:
    """Out-of-core LogisticRegression: :func:`minimize_lbfgs_host` whose
    every evaluation is one chunked pass, each chunk folded through K3
    (:func:`logreg_chunk_vg_step`) into accumulators of ``dtype`` on the
    card, read back once a pass.

    The objective is the resident fit's (``ops.logreg_kernels.logreg_fit``):
    (1/n)·Σ logloss + λ[(1−α)/2‖β‖₂² + α‖β‖₁] on the standardized
    coefficients, never on intercepts; standardization folds into the
    effective coefficients, formed once an evaluation; multinomial
    intercepts are centred. ``moments``: a cache shared across calls
    (:func:`streamed_logreg_moments`). ``checkpointer``: the solver's
    (:func:`minimize_lbfgs_host`); a resumed fit reruns the moment passes
    and skips the evaluations before its checkpoint. Returns ``coef_`` (K,
    d) and ``intercept_`` (K,) as numpy of ``dtype``, ``n_iter`` and
    ``objective``."""
    d = source.n_features
    np_dtype = _np_dtype(dtype)
    moments = streamed_logreg_moments(source, device, chunk_rows, dtype, variance=standardization, cache=moments)
    n = moments["n"]
    mean = moments["mean"].double().cpu().numpy()
    inv_std = moments["inv_std"].double().cpu().numpy() if standardization else np.ones((d,))
    use_center = standardization and fit_intercept
    K = n_classes if multinomial else 1
    n_coef = K * d
    p = n_coef + (K if fit_intercept else 0)
    coef_mask = np.concatenate([np.ones(n_coef), np.zeros(p - n_coef)])

    def unpack(w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        return w[:n_coef].reshape(K, d), w[n_coef:] if fit_intercept else np.zeros((K,))

    def value_grad(w: np.ndarray) -> Tuple[float, np.ndarray]:
        Aeff, beff = logreg_effective(*unpack(w), mean, inv_std, use_center)
        Aeff_d = torch.from_numpy(Aeff.astype(np_dtype)).to(device)
        beff_d = torch.from_numpy(np.asarray(beff, np_dtype)).to(device)
        acc = {"f": torch.zeros((), dtype=dtype, device=device),
               "gA": torch.zeros((K, d), dtype=dtype, device=device),
               "gb": torch.zeros((K,), dtype=dtype, device=device)}
        guard = StreamGuard()
        with contextlib.closing(iter_device_chunks(source, device, chunk_rows, dtype, need_w=False,
                                                   pass_name="objective")) as chunks:
            for _, dev in chunks:
                logreg_chunk_vg_step(acc, dev["X"], dev["mask"], dev["y"], Aeff_d, beff_d, multinomial)
                guard.tick(dev)
            guard.flush()
        g = logreg_flat_grad(acc["gA"].cpu().numpy(), acc["gb"].cpu().numpy(), mean, inv_std,
                             use_center=use_center, fit_intercept=fit_intercept)
        coefs = w * coef_mask
        return float(acc["f"]) / n + 0.5 * l2 * float(coefs @ coefs), g / n + l2 * coefs

    res = minimize_lbfgs_host(value_grad, np.zeros((p,)), max_iter=max_iter, tol=tol,
                              l1_weights=(l1 * coef_mask) if l1 > 0.0 else None, history=history,
                              checkpointer=checkpointer)
    coef, intercept = logreg_effective(*unpack(res.w), mean, inv_std, use_center)
    if fit_intercept and K > 1:
        intercept = intercept - intercept.mean()
    return {"coef_": coef.astype(np_dtype), "intercept_": np.asarray(intercept, np_dtype),
            "n_iter": res.n_iter, "objective": res.f}


# ---------------------------------------------------------------------------
# KMeans: Lloyd passes and the k-means|| seeding passes
# ---------------------------------------------------------------------------

# elements of one (rows, k) distance block of the min-distance pass: a
# 131,072-row chunk against ~4k k-means|| candidates would be 2 GB at once
_MIN_D2_BLOCK = 1 << 25
# chunks whose min distances may be in flight to the host at once
_MIN_D2_INFLIGHT = 2 * _SYNC_EVERY


def kmeans_chunk_step(
    acc: Dict[str, torch.Tensor], X: torch.Tensor, mask: torch.Tensor, centers: torch.Tensor
) -> Dict[str, torch.Tensor]:
    """Fold one chunk's assignment statistics into ``acc`` (``sums`` in the
    chunk dtype, ``counts`` int32, ``cost``) in place: kernel K2
    (``ops.kmeans_kernels.lloyd_step``) on the card, its plain version on
    the CPU; a float64 chunk ``chunk_stats_xla`` on either
    (``ops.kmeans_kernels.chunk_stats``). Counts stay int32: a float count
    drops +1 increments past 2²⁴ rows."""
    sums, counts, cost = chunk_stats(X, mask, centers)
    acc["sums"] += sums
    acc["counts"] += counts
    acc["cost"] += cost
    return acc


def chunk_min_sq_dists(X: torch.Tensor, mask: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Per-row min squared distance of a chunk to ``centers`` (padding rows
    -> 0): the plain ``pairwise_sq_dists`` product, in row blocks of at
    most ``_MIN_D2_BLOCK`` distances."""
    rows = max(1, _MIN_D2_BLOCK // max(1, centers.shape[0]))
    return min_sq_dists(X, mask, centers, csize=rows)


def count_closest_chunk_step(counts: torch.Tensor, X: torch.Tensor, mask: torch.Tensor,
                             cands: torch.Tensor) -> torch.Tensor:
    """Fold one chunk into the int32 closest-row counts of the k-means||
    candidates in place: K2's counts at k = the candidate count (a float64
    chunk: ``chunk_stats_xla``'s)."""
    counts += chunk_stats(X, mask, cands)[1]
    return counts


def _on_device(a: np.ndarray, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=_np_dtype(dtype))).to(device)


def streamed_kmeans_lloyd(
    source: ChunkSource,
    device: torch.device,
    chunk_rows: int,
    dtype: torch.dtype,
    centers0: np.ndarray,
    *,
    max_iter: int,
    tol: float,
    shifts: Optional[list] = None,
    checkpointer=None,
) -> Tuple[np.ndarray, float, int]:
    """Out-of-core Lloyd: one chunked pass an iteration (a ``lloyd`` pass
    in the ingest report) folds every chunk through K2 into ``(sums,
    counts, cost)`` on the card, read back once a pass. The update runs on
    the host in f64, as in the JAX package: ``where(counts > 0, sums /
    max(counts, 1), centers)`` (an empty cluster keeps its centre, Spark's
    rule), then the centres return to the card in the chunk dtype. The loop
    runs while ``it < max_iter`` and the largest squared centre shift of the
    last iteration is above ``tol²`` (each one appended to ``shifts``
    where given); a final ``cost`` pass at the last centres follows.
    Returns ``(centers, cost, n_iter)`` as host values.

    ``checkpointer`` (a ``runtime.FitCheckpointer``, or None) snapshots the
    centres and the last shift after each iteration; a refit resumes from
    the last committed iteration (Lloyd is deterministic given the
    centres, so it walks the same centres and stops at the same iteration;
    ``shifts`` then holds the resumed iterations' only) and clears the
    files after the final cost pass."""
    np_dtype = _np_dtype(dtype)
    k, d = centers0.shape
    centers = np.asarray(centers0, np_dtype)

    def one_pass(cts: np.ndarray, name: str) -> Dict[str, torch.Tensor]:
        cts_d = _on_device(cts, device, dtype)
        acc = {"sums": torch.zeros((k, d), dtype=dtype, device=device),
               "counts": torch.zeros((k,), dtype=torch.int32, device=device),
               "cost": torch.zeros((), dtype=dtype, device=device)}
        guard = StreamGuard()
        with contextlib.closing(iter_device_chunks(source, device, chunk_rows, dtype, need_y=False,
                                                   need_w=False, pass_name=name)) as chunks:
            for _, dev in chunks:
                kmeans_chunk_step(acc, dev["X"], dev["mask"], cts_d)
                guard.tick(dev)
            guard.flush()
        return acc

    it = 0
    prev_shift = np.inf
    resumed = checkpointer.load() if checkpointer is not None else None
    if resumed is not None:
        it, arrays, extra = resumed
        centers = np.asarray(arrays["centers"], np_dtype)
        prev_shift = float(extra["prev_shift"])
    while it < max_iter and prev_shift > tol * tol:
        acc = one_pass(centers, "lloyd")
        sums = acc["sums"].cpu().numpy().astype(np.float64)
        counts = acc["counts"].cpu().numpy()
        old = centers.astype(np.float64)
        safe = np.maximum(counts.astype(np.float64), 1.0)
        new_centers = np.where(counts[:, None] > 0, sums / safe[:, None], old)
        prev_shift = float(((new_centers - old) ** 2).sum(axis=1).max())
        if shifts is not None:
            shifts.append(prev_shift)
        centers = new_centers.astype(np_dtype)
        it += 1
        if checkpointer is not None:
            checkpointer.maybe_save(it, {"centers": centers}, {"prev_shift": prev_shift})
    final = one_pass(centers, "cost")
    if checkpointer is not None:
        checkpointer.clear()
    return centers, float(final["cost"]), it


def streamed_rows_at(source: ChunkSource, chunk_rows: int, idx: np.ndarray, dtype) -> np.ndarray:
    """Rows at global indices ``idx`` in one sequential host pass over
    ``source.iter_chunks`` (a ``seed_rows`` pass in the ingest report),
    in sorted index order: the out-of-core replacement for indexing the
    resident matrix. Stops once the last index is served; raises
    ``IndexError`` for an index past the end. A chunk's padding rows are
    never served."""
    np_dtype = _np_dtype(dtype)
    idx = np.sort(np.asarray(idx, np.int64))
    out = np.empty((len(idx), source.n_features), dtype=np_dtype)
    if len(idx) == 0:
        return out
    t = time.perf_counter()
    pos = 0  # next unserved request
    offset = 0
    with contextlib.closing(source.iter_chunks(chunk_rows, np_dtype)) as chunks:
        for chunk in chunks:
            hi = offset + chunk.n_valid
            end = int(np.searchsorted(idx, hi, side="left"))
            out[pos:end] = chunk.X[idx[pos:end] - offset]
            pos, offset = end, hi
            if pos == len(idx):
                break
    _report_add(passes={"seed_rows": 1}, pass_s={"seed_rows": time.perf_counter() - t})
    if pos != len(idx):
        raise IndexError(f"row index {idx[pos]} out of range ({offset} rows)")
    return out


def streamed_min_sq_dists_update(
    source: ChunkSource,
    device: torch.device,
    chunk_rows: int,
    dtype: torch.dtype,
    cands: np.ndarray,
    min_d2: Optional[np.ndarray] = None,
) -> np.ndarray:
    """One chunked pass (``seed_min_d2``): each row's min squared distance
    to ``cands``, folded into the host f64 array ``min_d2`` (one entry a
    row, ∞ where None: the only per-row state k-means|| keeps; the dataset
    never materializes). Each chunk's f32 distances reach the host by an
    asynchronous copy into page-locked memory, folded once the copy is
    proved done, so the loop does not wait on the card a chunk; f32 to
    f64 is exact, as in the JAX package."""
    cands_d = _on_device(cands, device, dtype)
    out = np.full((source.n_rows,), np.inf, np.float64) if min_d2 is None else min_d2
    cuda = device.type == "cuda"
    pinned = [torch.empty((chunk_rows,), dtype=dtype, pin_memory=True) for _ in range(_MIN_D2_INFLIGHT)] \
        if cuda else []
    pending: list = []  # (done event or None, host distances, offset, n_valid)

    def fold_oldest() -> None:
        done, host, lo, nv = pending.pop(0)
        if done is not None:
            done.synchronize()
        np.minimum(out[lo:lo + nv], host[:nv], out=out[lo:lo + nv])

    offset = 0
    guard = StreamGuard()
    with contextlib.closing(iter_device_chunks(source, device, chunk_rows, dtype, need_y=False,
                                               need_w=False, pass_name="seed_min_d2")) as chunks:
        for i, (piece, dev) in enumerate(chunks):
            d2 = chunk_min_sq_dists(dev["X"], dev["mask"], cands_d)
            if len(pending) == _MIN_D2_INFLIGHT:
                fold_oldest()
            if cuda:
                buf = pinned[i % _MIN_D2_INFLIGHT]
                buf[: d2.shape[0]].copy_(d2, non_blocking=True)
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(device))
                pending.append((done, buf.numpy(), offset, piece.n_valid))
            else:
                pending.append((None, d2.numpy(), offset, piece.n_valid))
            guard.tick(dev)
            offset += piece.n_valid
        guard.flush()
    while pending:
        fold_oldest()
    return out


def streamed_count_closest(
    source: ChunkSource, device: torch.device, chunk_rows: int, dtype: torch.dtype, cands: np.ndarray
) -> np.ndarray:
    """One chunked pass (``seed_count``): how many rows are closest to each
    candidate (the k-means|| candidate weights), K2's counts a chunk in
    int32 on the card; returned as f64 on the host."""
    cands_d = _on_device(cands, device, dtype)
    counts = torch.zeros((cands.shape[0],), dtype=torch.int32, device=device)
    guard = StreamGuard()
    with contextlib.closing(iter_device_chunks(source, device, chunk_rows, dtype, need_y=False,
                                               need_w=False, pass_name="seed_count")) as chunks:
        for _, dev in chunks:
            count_closest_chunk_step(counts, dev["X"], dev["mask"], cands_d)
            guard.tick(dev)
        guard.flush()
    return counts.cpu().numpy().astype(np.float64)
