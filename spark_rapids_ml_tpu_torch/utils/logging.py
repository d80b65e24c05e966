"""Logger factory (reference: spark-rapids-ml ``python/src/spark_rapids_ml/utils.py:271-288``)."""

from __future__ import annotations

import logging
import sys
from typing import Any, Optional, Union

_FORMAT = "%(asctime)s %(levelname)s %(name)s: %(message)s"
_configured = False


def _ensure_configured() -> None:
    global _configured
    if not _configured:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT))
        root = logging.getLogger("spark_rapids_ml_tpu_torch")
        if not root.handlers:
            root.addHandler(handler)
        root.setLevel(logging.INFO)
        root.propagate = False
        _configured = True


def get_logger(
    cls: Union[type, str, Any], level: Optional[int] = None
) -> logging.Logger:
    """Per-class logger. ``level`` is only applied when explicitly given —
    a bare ``get_logger`` must never reset a level the user raised (e.g.
    the ``verbose=True`` framework kwarg); unset loggers inherit INFO from
    the package root."""
    _ensure_configured()
    if isinstance(cls, str):
        name = cls
    elif isinstance(cls, type):
        name = cls.__name__
    else:
        name = type(cls).__name__
    logger = logging.getLogger(f"spark_rapids_ml_tpu_torch.{name}")
    if level is not None:
        logger.setLevel(level)
    return logger
