"""Run-time services of the port: checkpoint/resume of the iterative
streamed fits (:mod:`.checkpoint`)."""

from .checkpoint import CKPT_VERSION, FitCheckpointer, array_digest, params_hash

__all__ = ["CKPT_VERSION", "FitCheckpointer", "array_digest", "params_hash"]
