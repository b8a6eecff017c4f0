"""Explicit device selection (the port's stand-in for utils/jaxsetup.py).

The port never picks a device behind the caller's back: the CLI and
chip_smoke.py ask for ``cuda`` and fail when there is none; tests pass
``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

from .timing import COUNTS


def resolve_device(name: str | torch.device = "cuda") -> torch.device:
    """``name`` as a torch.device; raises if it names CUDA and none exists."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {str(name)!r} requested but "
                               "torch.cuda.is_available() is False")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(name)!r} (cuda or cpu)")
    return dev


def upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """`a` as a tensor on `device` (a C-contiguous copy where `a` is not),
    its bytes counted in timing.COUNTS["h2d_bytes"] unless the target is
    the CPU: every host-to-device copy of fastqc's path goes through
    here."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type != "cpu":
        COUNTS["h2d_bytes"] += t.nbytes
    return t.to(device)
