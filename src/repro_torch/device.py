"""Device selection shared by the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None,
                   ) -> torch.device:
    """The device an entry point runs on: ``cuda`` (the current card)
    unless the caller names another.  Raises when CUDA is asked for
    (explicitly or by default) and no card is present — the port never
    falls back to the CPU quietly.  ``meta`` (shapes and dtypes only) is
    accepted for the model's dry-run."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels explicitly")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
