"""Explicit device selection (the port's stand-in for utils/jaxsetup.py).

The port never picks a device behind the caller's back: the CLI and
chip_smoke.py ask for ``cuda`` and fail when there is none; tests pass
``device="cpu"``.
"""

from __future__ import annotations

import torch


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

