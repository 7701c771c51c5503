"""Where the port runs: the CUDA card unless the caller asks for the CPU.

Entry points (`ImageFeaturizer`, `TorchModel`) resolve their `device`
Param here.  No device given means ``cuda``; without a CUDA device that
raises instead of dropping quietly to the CPU, so a run that was meant
for the card can never report CPU numbers.  ``device="cpu"`` is the
explicit opt-in the CPU tests use.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device", "DEVICE_DOC"]

#: the doc of an entry point's `device` Param
DEVICE_DOC = "'cuda' (default) or 'cpu'; without CUDA only an explicit 'cpu' runs"


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The torch.device for an entry point's `device` setting."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "mmlspark_tpu_torch runs on a CUDA device by default and none "
            "is available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
