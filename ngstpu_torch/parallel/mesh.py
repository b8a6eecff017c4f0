"""Device meshes of the port's scale-out layer (ngstpu/parallel/mesh.py).

A mesh is the shards' devices in order plus axis names: ("dp",) for data
parallelism over read batches, the counterpart of the reference's
thread-per-file (fastq_count.c:213-231), or ("dp", "coord") when the
genome-coordinate axis of a pileup is sharded too. The collectives between
the shards are parallel/collectives.py's. A mesh is one of two kinds:

- in-process: every shard lives in this process, as under JAX's single
  controller. A device may carry several shards: the CPU tests pass
  [cpu] * n where JAX's get n virtual CPU devices, and chip_smoke.py
  shards four ways over one card;
- process group: one shard per process of an initialised
  torch.distributed group (NCCL on CUDA, gloo on the CPU), the
  counterpart of JAX's multi-controller mode under jax.distributed.
  make_mesh builds one whenever a default group is initialised and no
  devices are given; the group's rank is the shard's index.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """shape: shards per axis, row-major over axis_names; shards: the
    global indices of the shards this process holds (all of them
    in-process, its rank in a process group), devices: their devices;
    group: the torch.distributed group, None in-process."""
    shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    shards: tuple[int, ...]
    devices: tuple[torch.device, ...]
    group: object = None

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def axis_size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]

    def coords(self, shard: int) -> tuple[int, ...]:
        """The shard's position on each axis."""
        return tuple(int(c) for c in np.unravel_index(shard, self.shape))


def available_devices() -> list[torch.device]:
    """cuda:0..count-1, or [cpu] where there is no card."""
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def spread_devices(n: int, device: str | torch.device) -> list[torch.device]:
    """n shard devices of `device`'s kind, cycling over the cards (each
    card takes n / count shards); [cpu] * n for the CPU."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return [dev] * n
    devs = [d for d in available_devices() if d.type == dev.type]
    if not devs:
        raise RuntimeError(f"device {str(device)!r} requested but "
                           "torch.cuda.is_available() is False")
    return [devs[i % len(devs)] for i in range(n)]


def group_device() -> torch.device:
    """This process's device in the default group: the current card under
    NCCL (torchrun's processes call torch.cuda.set_device(LOCAL_RANK)
    first), the CPU otherwise."""
    import torch.distributed as dist

    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_mesh(n_devices: int | None = None, coord: int | None = None,
              devices: list[torch.device] | None = None) -> Mesh:
    """A ('dp',) mesh, or ('dp', 'coord') for any explicit `coord`
    (including 1), over the first n_devices of `devices` (default
    available_devices()); or, with a torch.distributed group initialised
    and no `devices`, a process-group mesh over all its ranks."""
    import torch.distributed as dist

    group = None
    if devices is None and dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        n = world if n_devices is None else n_devices
        if n != world:
            raise ValueError(f"requested {n} devices; a process-group mesh "
                             f"spans the group's {world} ranks")
        shards, devs = (rank,), (group_device(),)
        group = dist.group.WORLD
    else:
        devs = list(available_devices() if devices is None else devices)
        n = len(devs) if n_devices is None else n_devices
        if n > len(devs):
            raise ValueError(f"requested {n} devices, have {len(devs)}")
        devs = tuple(devs[:n])
        shards = tuple(range(n))
    if coord is not None:
        if n % coord:
            raise ValueError(f"n={n} not divisible by coord={coord}")
        return Mesh((n // coord, coord), ("dp", "coord"), shards, devs,
                    group)
    return Mesh((n,), ("dp",), shards, devs, group)


def tool_mesh(mesh_n: int, device: torch.device) -> Mesh | None:
    """`-m` / NGSTPU_MESH of the sort-engine tools, ngstpu's rule: shard
    over min(mesh_n, available devices of `device`'s kind) devices; None
    (the single-device path) when that is one or fewer."""
    devs = [d for d in available_devices() if d.type == device.type]
    n = min(mesh_n, len(devs))
    return make_mesh(n, devices=devs) if n > 1 else None
