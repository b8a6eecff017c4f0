"""The collectives between a mesh's shards: what JAX writes under shard_map.

A body that JAX runs per shard under shard_map becomes, in the port, stage
functions mapped over this process's local shards (a list of tensors, one
per entry of Mesh.shards), with these collectives between the stages:

- psum(xs, axis): the sum over the axis, on every shard;
- all_gather(xs, axis): the shards concatenated along dim 0 in their
  order on the axis (JAX's tiled=True), on every shard;
- all_to_all(xs, axis): each shard's [n, cap, ...] tensor cut into n
  chunks along dim 0; chunk j of shard i lands as chunk i of shard j
  (JAX's tiled=False on axis 0);
- axis_index(axis): each local shard's position on the axis;
- collect(xs): every shard's tensor in shard order, the counterpart of
  JAX's process_allgather(tiled=True) of a sharded result.

InProcess holds every shard and moves tensors with .to(dst) copies;
results on one device may share storage, so callers must not modify them
in place. ProcessGroup holds one shard per process and calls
torch.distributed (all_reduce, all_to_all_single, all_gather) on its
group; every process must call the same collectives in the same order.
"""

from __future__ import annotations

import numpy as np
import torch

from .mesh import Mesh


def _members(mesh: Mesh, shard: int, axis: str) -> list[int]:
    """The shards that differ from `shard` only on `axis`, in axis order."""
    a = mesh.axis_names.index(axis)
    pos = list(mesh.coords(shard))
    out = []
    for k in range(mesh.shape[a]):
        pos[a] = k
        out.append(int(np.ravel_multi_index(pos, mesh.shape)))
    return out


class InProcess:
    """Every shard in this process."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.dev = dict(zip(mesh.shards, mesh.devices))

    def _groups(self, axis: str) -> list[list[int]]:
        seen, out = set(), []
        for s in self.mesh.shards:
            if s not in seen:
                g = _members(self.mesh, s, axis)
                seen.update(g)
                out.append(g)
        return out

    def psum(self, xs: list[torch.Tensor], axis: str = "dp"
             ) -> list[torch.Tensor]:
        out: list = [None] * len(xs)
        for g in self._groups(axis):
            total = xs[g[0]]
            for i in g[1:]:
                total = total + xs[i].to(total.device)
            for i in g:
                out[i] = total.to(self.dev[i])
        return out

    def all_gather(self, xs: list[torch.Tensor], axis: str = "dp"
                   ) -> list[torch.Tensor]:
        out: list = [None] * len(xs)
        for g in self._groups(axis):
            cat = torch.cat([xs[i].to(self.dev[g[0]]) for i in g])
            for i in g:
                out[i] = cat.to(self.dev[i])
        return out

    def all_to_all(self, xs: list[torch.Tensor], axis: str = "dp"
                   ) -> list[torch.Tensor]:
        out: list = [None] * len(xs)
        for g in self._groups(axis):
            for j, dst in enumerate(g):
                out[dst] = torch.stack([xs[i][j].to(self.dev[dst])
                                        for i in g])
        return out

    def axis_index(self, axis: str) -> list[int]:
        a = self.mesh.axis_names.index(axis)
        return [self.mesh.coords(s)[a] for s in self.mesh.shards]

    def collect(self, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        return list(xs)


class ProcessGroup:
    """One shard per process of mesh.group; the collectives run over the
    whole group, so an axis must span it (a 1-D mesh). Tensors lie on the
    group's device (the card under NCCL, the CPU under gloo) and have the
    same shape on every rank; bools travel as uint8."""

    def __init__(self, mesh: Mesh):
        import torch.distributed as dist

        self.dist = dist
        self.mesh = mesh
        (self.shard,) = mesh.shards

    def _whole(self, axis: str) -> None:
        if self.mesh.axis_size(axis) != self.mesh.size:
            raise ValueError(f"a process-group collective over {axis!r} "
                             f"needs an axis that spans the group (mesh "
                             f"shape {self.mesh.shape})")

    def psum(self, xs: list[torch.Tensor], axis: str = "dp"
             ) -> list[torch.Tensor]:
        self._whole(axis)
        total = xs[0].clone()
        self.dist.all_reduce(total, group=self.mesh.group)
        return [total]

    def all_gather(self, xs: list[torch.Tensor], axis: str = "dp"
                   ) -> list[torch.Tensor]:
        self._whole(axis)
        return [torch.cat(self.collect(xs))]

    def all_to_all(self, xs: list[torch.Tensor], axis: str = "dp"
                   ) -> list[torch.Tensor]:
        self._whole(axis)
        x = xs[0].contiguous()
        out = torch.empty_like(x)
        self.dist.all_to_all_single(out, x, group=self.mesh.group)
        return [out]

    def axis_index(self, axis: str) -> list[int]:
        return [self.mesh.coords(self.shard)[
            self.mesh.axis_names.index(axis)]]

    def collect(self, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        """Every rank's tensor, in rank order."""
        (x,) = xs
        if x.dtype == torch.bool:
            return [p.bool() for p in self.collect([x.to(torch.uint8)])]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.mesh.size)]
        self.dist.all_gather(parts, x, group=self.mesh.group)
        return parts


def of(mesh: Mesh) -> InProcess | ProcessGroup:
    """The backend of `mesh`."""
    return InProcess(mesh) if mesh.group is None else ProcessGroup(mesh)
