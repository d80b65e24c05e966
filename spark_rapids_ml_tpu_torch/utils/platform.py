"""Device resolution (counterpart of ``spark_rapids_ml_tpu/utils/platform.py``).

The JAX package pins a platform for the whole process; the port instead
names a torch device on every entry point. The default is the first CUDA
card. The CPU is used only when the caller asks for it (``device="cpu"``,
as the tests do): a missing card is an error, never a silent move to the
CPU, so no CPU number can pass for a card number.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``cuda:0`` unless told otherwise; raises when CUDA is asked for (or
    defaulted to) and no card is present."""
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but CUDA is not available; "
                "pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r}: expected cuda or cpu")
    return dev
