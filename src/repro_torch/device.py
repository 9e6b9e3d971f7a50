"""Device resolution for the port's entry points.

Every entry point takes ``device=`` (default ``"cuda"``).  A CUDA request
on a machine without a usable card raises: nothing drops to the CPU on
its own, so a CPU run is always one the caller asked for.  The planner
(`launch/dryrun.py`) also asks for ``meta``: tensors with shapes and no
data.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``device`` as a `torch.device`; raises when CUDA is asked for and
    missing.  Only ``cpu``, ``cuda`` and ``meta`` devices are
    supported."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the CPU")
        if dev.index is None:       # "cuda" -> "cuda:<current>", as tensors
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {str(device)!r}; "
                         "use 'cuda', 'cpu' or 'meta'")
    return dev
