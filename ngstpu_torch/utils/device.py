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


def check_mesh(mesh_n: int, device: torch.device) -> None:
    """`-m` / NGSTPU_MESH of the sort-engine tools.

    ngstpu shards over min(mesh_n, len(jax.devices())) devices and runs its
    single-device path when that is 1. The port counts
    min(mesh_n, torch.cuda.device_count()) on cuda and 1 on cpu; one device
    takes the single-device path, and more raise, because the sharded
    dedup and sort (ngstpu/parallel/dsort.py) are not ported yet."""
    n = min(mesh_n, torch.cuda.device_count()) if device.type == "cuda" else 1
    if n > 1:
        raise NotImplementedError(
            f"-m {mesh_n}: sharding over {n} devices is not ported yet "
            "(ROADMAP queue 1 item 10, parallel/); run with -m 1")
