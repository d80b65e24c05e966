"""Atomic host-side checkpoints for iterative fits (counterpart of
``spark_rapids_ml_tpu/runtime/checkpoint.py``; the same files).

A :class:`FitCheckpointer` snapshots the *host-visible* carry of a
host-driven loop (the L-BFGS ``w/g/S/Y``, the Lloyd centres) every
``CKPT_EVERY`` iterations into ``CKPT_DIR``. A refit with the same
algorithm and identity params resumes from the last completed iteration
and walks the same iterates as the uninterrupted fit: the carry is the
whole state of both loops.

On-disk layout (per fit identity ``{algo}-{params_hash[:16]}``):

- ``{stem}.npz``  — the array state, written first via tmp + ``os.replace``.
- ``{stem}.json`` — manifest ``{version, algo, params_hash, iteration,
  arrays, extra}``; written last (also tmp + rename), so it is the commit
  point: a crash between the two writes leaves the previous manifest
  pointing at the previous consistent pair, and a manifest is never
  observable without the arrays it describes.

A checkpoint written by either package loads in the other: the stem, the
hash and both files are the same.

``load`` returns ``None`` — never raises — on any mismatch (different
params hash, missing/corrupt files, wrong version): a resume that cannot
be proven to belong to *this* fit falls back to a cold start. ``clear``
removes both files on fit success so a finished model can never poison a
later fit that happens to share the identity.

The settings are module constants (the defaults of the JAX package's
``TPUML_CKPT_DIR`` / ``TPUML_CKPT_EVERY``); :meth:`FitCheckpointer.from_settings`
reads them. With ``CKPT_DIR`` None the checkpointer is disabled: every
method is a no-op returning ``None`` and the fit path is the same as
without this module.
"""

from __future__ import annotations

import hashlib
import io
import json
import logging
import os
import tempfile
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np

logger = logging.getLogger("spark_rapids_ml_tpu_torch.runtime.checkpoint")

CKPT_VERSION = 1

# directory of the fit snapshots (None: checkpointing off) and the cadence
# in solver iterations
CKPT_DIR: Optional[str] = None
CKPT_EVERY = 1


def array_digest(arr: Any) -> str:
    """Stable content digest of an array-like (shape + dtype + bytes)."""
    a = np.ascontiguousarray(np.asarray(arr))
    h = hashlib.sha256()
    h.update(str(a.shape).encode())
    h.update(str(a.dtype).encode())
    h.update(a.tobytes())
    return h.hexdigest()


def params_hash(params: Mapping[str, Any]) -> str:
    """sha256 over the sorted JSON of the fit-identity params.

    Array-valued entries must be pre-digested with :func:`array_digest`
    by the caller (keeps the manifest human-readable and the hash cheap).
    """
    blob = json.dumps(
        {k: params[k] for k in sorted(params)}, sort_keys=True, default=str
    )
    return hashlib.sha256(blob.encode()).hexdigest()


class FitCheckpointer:
    """Checkpoint/resume of one fit identity."""

    def __init__(
        self,
        algo: str,
        params: Mapping[str, Any],
        ckpt_dir: Optional[str],
        every: int = 1,
    ) -> None:
        self.algo = algo
        self.params_hash = params_hash(params)
        self.ckpt_dir = ckpt_dir
        self.every = max(1, int(every))
        self.enabled = bool(ckpt_dir)

    @classmethod
    def from_settings(cls, algo: str, params: Mapping[str, Any]) -> "FitCheckpointer":
        """Build from the module's ``CKPT_DIR`` / ``CKPT_EVERY``."""
        return cls(algo, params, CKPT_DIR, CKPT_EVERY)

    @property
    def _stem(self) -> str:
        assert self.ckpt_dir is not None
        return os.path.join(self.ckpt_dir, f"{self.algo}-{self.params_hash[:16]}")

    def _atomic_write(self, path: str, data: bytes) -> None:
        d = os.path.dirname(path)
        fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path) + ".tmp.")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def save(
        self,
        iteration: int,
        arrays: Mapping[str, Any],
        extra: Optional[Mapping[str, Any]] = None,
    ) -> None:
        """Snapshot ``arrays`` (+ JSON-scalar ``extra``) at ``iteration``."""
        if not self.enabled:
            return
        os.makedirs(self.ckpt_dir, exist_ok=True)  # type: ignore[arg-type]
        host = {k: np.asarray(v) for k, v in arrays.items()}
        buf = io.BytesIO()
        np.savez(buf, **host)
        self._atomic_write(self._stem + ".npz", buf.getvalue())
        manifest = {
            "version": CKPT_VERSION,
            "algo": self.algo,
            "params_hash": self.params_hash,
            "iteration": int(iteration),
            "arrays": sorted(host),
            "extra": dict(extra or {}),
        }
        self._atomic_write(
            self._stem + ".json", json.dumps(manifest, sort_keys=True).encode()
        )
        logger.info(
            "checkpointed %s at iteration %d -> %s", self.algo, iteration, self._stem
        )

    def maybe_save(
        self,
        iteration: int,
        arrays: Mapping[str, Any],
        extra: Optional[Mapping[str, Any]] = None,
    ) -> None:
        """``save`` when ``iteration`` is a multiple of ``every`` (and > 0)."""
        if self.enabled and iteration > 0 and iteration % self.every == 0:
            self.save(iteration, arrays, extra)

    def load(
        self,
    ) -> Optional[Tuple[int, Dict[str, np.ndarray], Dict[str, Any]]]:
        """``(iteration, arrays, extra)`` of the last commit, else ``None``."""
        if not self.enabled:
            return None
        try:
            with open(self._stem + ".json", "rb") as f:
                manifest = json.loads(f.read())
            if (
                manifest.get("version") != CKPT_VERSION
                or manifest.get("algo") != self.algo
                or manifest.get("params_hash") != self.params_hash
            ):
                logger.warning(
                    "checkpoint at %s does not match this fit; cold start",
                    self._stem,
                )
                return None
            with np.load(self._stem + ".npz") as z:
                arrays = {k: z[k] for k in z.files}
            missing = set(manifest.get("arrays", [])) - set(arrays)
            if missing:
                logger.warning(
                    "checkpoint at %s missing arrays %s; cold start",
                    self._stem,
                    sorted(missing),
                )
                return None
            return int(manifest["iteration"]), arrays, dict(manifest.get("extra", {}))
        except FileNotFoundError:
            return None
        except Exception as exc:  # corrupt files must never kill the fit
            logger.warning("unreadable checkpoint at %s (%s); cold start", self._stem, exc)
            return None

    def clear(self) -> None:
        """Remove the checkpoint pair (called on fit success)."""
        if not self.enabled:
            return
        for suffix in (".json", ".npz"):  # manifest first: uncommit, then free
            try:
                os.unlink(self._stem + suffix)
            except OSError:
                pass
