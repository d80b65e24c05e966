"""Row placement on one device (counterpart of
``spark_rapids_ml_tpu/parallel/mesh.py``).

The JAX package pads rows to an even dp shard and carries a row-validity
mask (``shard_rows``, ``shard_aligned``). The port keeps that contract on
a single device: host numpy becomes a device tensor padded to a
``row_multiple`` plus an f32 mask (1 valid, 0 padding). The padding keeps
chunk-shaped arithmetic (the strided mean estimate of
``ops.linalg.mean_and_cov_chunked``) identical to the JAX package at
``num_workers=1``; kernels themselves take any row count.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch


def shard_rows(
    x: np.ndarray, device: torch.device, row_multiple: int = 1
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Copy host rows onto ``device``, zero-padded to a ``row_multiple``.

    Returns ``(x_padded, mask)``. The padded tensor is allocated on the
    device and filled in place, so no padded host copy is made (at
    12M x 256 f32 that copy alone would be 12 GB)."""
    x = np.ascontiguousarray(x)
    n = x.shape[0]
    n_pad = -(-max(n, 1) // row_multiple) * row_multiple
    xd = torch.empty((n_pad,) + x.shape[1:], dtype=_torch_dtype(x.dtype), device=device)
    xd[:n].copy_(torch.from_numpy(x))
    xd[n:].zero_()
    mask = torch.zeros((n_pad,), dtype=torch.float32, device=device)
    mask[:n] = 1.0
    return xd, mask


def shard_aligned(v: np.ndarray, device: torch.device, total_rows: int) -> torch.Tensor:
    """A 1-D host array (labels/weights) with the row layout of a
    :func:`shard_rows` output of ``total_rows`` rows (padding zero)."""
    v = np.ascontiguousarray(v)
    out = torch.zeros((total_rows,), dtype=_torch_dtype(v.dtype), device=device)
    out[: v.shape[0]].copy_(torch.from_numpy(v))
    return out


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
