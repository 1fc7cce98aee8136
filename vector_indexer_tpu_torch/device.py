"""Device resolution for the port.

Every index, table and search in the package lives on one explicit
``torch.device``. ``resolve_device`` turns what a caller passed into that
device and refuses a CUDA device the process cannot reach: asking for the
card and silently getting the CPU would turn every later measurement into a
CPU measurement.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """None -> the first CUDA device when one is present, else the CPU.
    An explicit CUDA device that is not available raises."""
    if device is None:
        return torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device type: {dev.type}")
    return dev
