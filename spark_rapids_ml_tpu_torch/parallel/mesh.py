"""Row placement on one device (counterpart of
``spark_rapids_ml_tpu/parallel/mesh.py``).

The JAX package pads rows to an even dp shard and carries a row-validity
mask (``shard_rows``, ``shard_aligned``). The port keeps that contract on
a single device: host numpy becomes a device tensor padded to a
``row_multiple`` plus an f32 mask (1 valid, 0 padding). The padding keeps
chunk-shaped arithmetic (the strided mean estimate of
``ops.linalg.mean_and_cov_chunked``) identical to the JAX package at
``num_workers=1``; kernels themselves take any row count.

On a card every host→device copy of a fit goes through a
:class:`PinnedRing`: a few page-locked host buffers, allocated once a
process, and a CUDA copy stream of its own. Pageable memory would make the
CUDA runtime stage the copy itself, synchronously, at a fraction of the link's
rate; the ring copies host rows into a free page-locked buffer (a CPU copy,
parallel over torch's threads) while the buffer before it is still on its
way to the card, and waits on an event, never on the device, before it
reuses a buffer. The streamed fits (``ops.streaming.put_chunk``) stage
their chunks through the same ring.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

# page-locked host buffers of the staging ring, and the bytes of each: the
# ring's host memory is fixed (128 MB) whatever the size of the copy
STAGE_SLOTS = 4
STAGE_SLOT_BYTES = 32 << 20


class PinnedRing:
    """Page-locked host buffers and a copy stream for one CUDA device.

    :meth:`copy` moves a host array into a device tensor in pieces of at
    most one buffer: each piece waits until its buffer's last transfer is
    done (an event recorded on the copy stream after it), is copied into
    the buffer on the host, and is sent on the copy stream with
    ``non_blocking=True``. Counters (pieces, bytes, seconds of host copies
    and of buffer waits) say where a copy's time went. One ring serves
    every thread of the process; a lock keeps one copy at a time on it."""

    def __init__(self, device: torch.device, slots: int = STAGE_SLOTS,
                 slot_bytes: int = STAGE_SLOT_BYTES):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.slots = [torch.empty((slot_bytes,), dtype=torch.uint8, pin_memory=True) for _ in range(slots)]
        for buf in self.slots:
            if not buf.is_pinned():
                raise RuntimeError("a staging buffer could not be page-locked")
        self.slot_bytes = slot_bytes
        self.lock = threading.RLock()
        self._free: list = [None] * slots  # event after each buffer's last transfer
        self._next = 0
        self.pieces = 0
        self.bytes = 0
        self.host_s = 0.0  # host -> page-locked copies
        self.wait_s = 0.0  # waits for a buffer to come free

    def copy(self, dst: torch.Tensor, src: np.ndarray) -> torch.cuda.Event:
        """Copy the host array ``src`` into ``dst``, a contiguous tensor on
        this ring's device with as many bytes. The copy stream first waits
        for the calling thread's current stream (``dst`` may be memory that
        stream has just released); the returned event, recorded on the copy
        stream after the last piece, is what a reader of ``dst`` on another
        stream must wait for."""
        src = np.ascontiguousarray(src)
        nbytes = src.nbytes
        if dst.device != self.device or not dst.is_contiguous() or dst.numel() * dst.element_size() != nbytes:
            raise ValueError(
                f"PinnedRing.copy: {nbytes} host bytes into a {tuple(dst.shape)} {dst.dtype} tensor on "
                f"{dst.device} (contiguous: {dst.is_contiguous()}), ring on {self.device}"
            )
        flat_src = src.reshape(-1).view(np.uint8)
        flat_dst = dst.view(-1).view(torch.uint8)
        with self.lock:
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
            for lo in range(0, nbytes, self.slot_bytes):
                hi = min(lo + self.slot_bytes, nbytes)
                k = self._next
                self._next = (k + 1) % len(self.slots)
                t0 = time.perf_counter()
                if self._free[k] is not None:
                    self._free[k].synchronize()
                t1 = time.perf_counter()
                buf = self.slots[k][: hi - lo]
                if flat_src.flags.writeable:
                    buf.copy_(torch.from_numpy(flat_src[lo:hi]))
                else:  # torch.from_numpy wants writeable memory
                    np.copyto(buf.numpy(), flat_src[lo:hi])
                t2 = time.perf_counter()
                copy_async(flat_dst[lo:hi], buf, self.stream)
                done = torch.cuda.Event()
                done.record(self.stream)
                self._free[k] = done
                self.wait_s += t1 - t0
                self.host_s += t2 - t1
                self.pieces += 1
            self.bytes += nbytes
            end = torch.cuda.Event()
            end.record(self.stream)
        return end


def copy_async(dst: torch.Tensor, src: torch.Tensor, stream: torch.cuda.Stream) -> None:
    """``dst.copy_(src, non_blocking=True)`` on ``stream``. A pageable
    source would make the copy silently synchronous, so one raises."""
    if not src.is_pinned():
        raise RuntimeError("a non_blocking host->device copy needs a page-locked source")
    with torch.cuda.stream(stream):
        dst.copy_(src, non_blocking=True)


_RINGS: Dict[torch.device, PinnedRing] = {}
_RINGS_LOCK = threading.Lock()


def pinned_ring(device: torch.device) -> PinnedRing:
    """The process's staging ring for CUDA ``device``, made at first use."""
    with _RINGS_LOCK:
        ring = _RINGS.get(device)
        if ring is None:
            ring = _RINGS[device] = PinnedRing(device)
        return ring


def shard_rows(
    x: np.ndarray, device: torch.device, row_multiple: int = 1, dtype: Optional[torch.dtype] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Copy host rows onto ``device``, zero-padded to a ``row_multiple``.

    Returns ``(x_padded, mask)``; the mask is in the rows' dtype where they
    are float64 (a float64 fit's masked products keep one dtype), else
    float32. The padded tensor is allocated on the
    device and filled in place, so no padded host copy is made (at
    12M x 256 f32 that copy alone would be 12 GB). On a card the rows go
    through the :class:`PinnedRing`, and the current stream waits for the
    copy before anything it runs next reads them. ``dtype`` (e.g. bf16)
    places the rows in that dtype instead: on a card a block of
    ``_CAST_BYTES`` of host rows at a time is copied and cast there, so the
    card never holds the rows in both dtypes."""
    x = np.ascontiguousarray(x)
    n = x.shape[0]
    n_pad = -(-max(n, 1) // row_multiple) * row_multiple
    host = _torch_dtype(x.dtype)
    xd = torch.empty((n_pad,) + x.shape[1:], dtype=dtype or host, device=device)
    if xd.dtype == host or xd.device.type != "cuda":
        _fill(xd[:n], x)  # the CPU's copy_ casts
    else:
        rows = max(1, _CAST_BYTES // max(1, x[:1].nbytes))
        tmp = torch.empty((min(rows, max(n, 1)),) + x.shape[1:], dtype=host, device=device)
        for lo in range(0, n, rows):
            hi = min(n, lo + rows)
            _fill(tmp[: hi - lo], x[lo:hi])  # the ring's copy first waits for the last cast
            xd[lo:hi].copy_(tmp[: hi - lo])
        del tmp
    xd[n:].zero_()
    mask = torch.zeros((n_pad,), dtype=torch.float64 if xd.dtype == torch.float64 else torch.float32, device=device)
    mask[:n] = 1.0
    return xd, mask


# host bytes a block of rows placed in another dtype is copied and cast in
_CAST_BYTES = 64 << 20


def shard_aligned(v: np.ndarray, device: torch.device, total_rows: int) -> torch.Tensor:
    """A 1-D host array (labels/weights) with the row layout of a
    :func:`shard_rows` output of ``total_rows`` rows (padding zero)."""
    v = np.ascontiguousarray(v)
    out = torch.zeros((total_rows,), dtype=_torch_dtype(v.dtype), device=device)
    _fill(out[: v.shape[0]], v)
    return out


def _fill(dst: torch.Tensor, src: np.ndarray) -> None:
    """``dst[...] = src`` from the host: a plain copy on the CPU, the
    staging ring on a card."""
    if dst.device.type != "cuda":
        dst.copy_(torch.from_numpy(src))
    elif src.size:
        done = pinned_ring(dst.device).copy(dst, src)
        torch.cuda.current_stream(dst.device).wait_event(done)


def global_label_summary(y_local: np.ndarray) -> Dict[str, Any]:
    """Label statistics ``{y_max, y_min, all_int, all_same, first, total}``
    (one process: the local column is the whole world)."""
    y = np.asarray(y_local)
    if y.size == 0:
        return {
            "y_max": -np.inf, "y_min": np.inf, "all_int": True,
            "all_same": True, "first": 0.0, "total": 0,
        }
    return {
        "y_max": float(y.max()),
        "y_min": float(y.min()),
        "all_int": bool(np.all(y == np.floor(y))),
        "all_same": bool(np.all(y == y[0])),
        "first": float(y[0]),
        "total": int(y.size),
    }


def _torch_dtype(dtype: Any) -> torch.dtype:
    return torch.from_numpy(np.zeros((0,), dtype=dtype)).dtype


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    return np.dtype(str(dtype).replace("torch.", ""))
