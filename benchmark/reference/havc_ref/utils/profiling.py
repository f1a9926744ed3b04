"""The device rule of the port's ``havc_tpu_torch/utils/profiling.py``,
frozen; ``stage_timer`` times nothing here."""
from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch

__all__ = ["stage_timer", "resolve_device", "on_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device comes back with its index."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def on_device(x, device=None) -> torch.Tensor:
    """``x`` as a float32 tensor: a tensor stays on its device unless
    ``device`` names one; numpy goes to ``resolve_device(device)``."""
    if isinstance(x, torch.Tensor) and device is None:
        return x.float()
    return torch.as_tensor(x, dtype=torch.float32).to(resolve_device(device))


@contextlib.contextmanager
def stage_timer(name: str):
    del name
    yield
