"""Device resolution for the port.

Every index, table and search in the package lives on one explicit
``torch.device``. ``resolve_device`` turns what a caller passed into that
device. The default is the card: a process that finds no CUDA device
raises instead of carrying on on the CPU, because asking for the card and
silently getting the CPU would turn every later measurement into a CPU
measurement. The CPU is used only when the caller asks for it.
"""

from __future__ import annotations

import contextlib
from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """None -> the first CUDA device. A CUDA device (the default included)
    that is not available raises; pass ``device="cpu"`` for the CPU."""
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not available "
                               "(pass device=\"cpu\" to run on the CPU)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device type: {dev.type}")
    return dev


def on_device(dev: torch.device):
    """Make ``dev`` the current CUDA device (a no-op for the CPU)."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()
