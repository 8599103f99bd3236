"""Rank meshes over torch.distributed (counterpart of
wenet_tpu/parallel/mesh.py).

JAX's mesh is one controller over many devices.  Here every rank is a
process with one device, and a `Mesh` is the grid of the world's ranks
with named axes, laid out row-major (rank = b * tp + m on a (dp, tp)
grid), so the last axis groups neighbouring ranks: a launcher that numbers
ranks host by host keeps a `tp` group within one host whenever the ranks
per host divide by `tp`, as `make_hybrid_mesh` wants.  Functions that take
a `mesh=` are called SPMD: in every rank, with the same arguments, and
they return the same result in every rank.

A mesh of a world of one (no process group started) runs every
collective as the identity, so a `mesh=` function also runs in a plain
process.
"""
from __future__ import annotations

import math
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device


class Mesh:
    """The world's ranks as a grid with named axes, this rank's place in it,
    its device, and the two collectives the `mesh=` functions need.

    shape: {axis name: size}, in axis order; the sizes multiply to the
    world size.  device: "cuda" (this rank's card, `cuda:{LOCAL_RANK %
    device_count}`) or "cpu".
    """

    def __init__(self, shape: dict, device="cuda"):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)
        self.size = math.prod(self.shape.values())
        world = dist.get_world_size() if dist.is_initialized() else 1
        if self.size != world:
            raise ValueError(f"a mesh of shape {self.shape} needs {self.size}"
                             f" ranks; the world has {world}")
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        dims = tuple(self.shape.values())
        self.coords = dict(zip(self.axis_names,
                               (int(c) for c in np.unravel_index(self.rank,
                                                                 dims))))
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            local = int(os.environ.get("LOCAL_RANK", self.rank))
            dev = torch.device("cuda", local % torch.cuda.device_count())
        self.device = dev
        self._groups = _axis_groups(self.rank, dims, self.axis_names)
        self.backend = dist.get_backend() if dist.is_initialized() else None
        # what the collectives cost: calls, host-clock seconds inside them,
        # bytes copied between a card and the host for a gloo group
        self.collectives = 0
        self.collective_s = 0.0
        self.staged_bytes = 0

    def __repr__(self):
        return (f"Mesh({self.shape}, rank={self.rank}, device={self.device},"
                f" backend={self.backend})")

    def index(self, axis: str) -> int:
        """This rank's index along `axis`."""
        return self.coords[axis]

    def group(self, axis: str | None = None):
        """The process group of the ranks along `axis` that hold this rank
        (the whole mesh for None); None where a collective over it is the
        identity (one rank)."""
        if axis is None:
            return dist.group.WORLD if dist.is_initialized() else None
        return self._groups[axis]

    def sum(self, t: torch.Tensor, axis: str | None = None) -> torch.Tensor:
        """The sum of `t` over the ranks along `axis` (the whole mesh for
        None), returned in each of them; `t` is left as it was."""
        group = self.group(axis)
        if group is None:
            return t

        def op(x):
            dist.all_reduce(x, group=group)
            return x
        return self._collective(t, group, op)

    def gather(self, t: torch.Tensor, axis: str | None = None
               ) -> torch.Tensor:
        """`t` of every rank along `axis` (the whole mesh for None),
        concatenated along dim 0 in the order of their index; every rank
        gives a tensor of the same shape."""
        group = self.group(axis)
        if group is None:
            return t

        def op(x):
            parts = [torch.empty_like(x)
                     for _ in range(dist.get_world_size(group))]
            dist.all_gather(parts, x, group=group)
            return torch.cat(parts)
        return self._collective(t, group, op)

    def _collective(self, t, group, op):
        """Run `op` on a copy of `t` that it may overwrite.  A gloo group
        gets a card's tensor through the host: the tensor is copied to the
        host, reduced or gathered there, and the result copied back to the
        card.  This is the backend's transport, not a fallback: no compute
        leaves the card.  (NCCL refuses two ranks on one card, so several
        ranks sharing one card take gloo.)"""
        staged = t.is_cuda and dist.get_backend(group) == "gloo"
        if t.is_cuda:
            torch.cuda.synchronize(t.device)   # time the collective alone
        t0 = time.perf_counter()
        if staged:
            x = t.detach().to("cpu", copy=True).contiguous()
            out = op(x).to(t.device)
            self.staged_bytes += x.nbytes + out.nbytes
        else:
            out = op(t.detach().clone().contiguous())
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        self.collective_s += time.perf_counter() - t0
        self.collectives += 1
        return out


def _axis_groups(rank: int, dims: tuple, names: tuple) -> dict:
    """{axis: the group of the ranks along it that hold `rank`}.  Every
    rank creates every group, in one order, as torch.distributed asks."""
    groups = {}
    world = math.prod(dims)
    ranks = np.arange(world).reshape(dims)
    for i, name in enumerate(names):
        if not dist.is_initialized():
            groups[name] = None
        elif dims[i] == world:
            groups[name] = dist.group.WORLD
        elif dims[i] == 1:
            groups[name] = None
        else:
            for line in np.moveaxis(ranks, i, -1).reshape(-1, dims[i]):
                g = dist.new_group([int(r) for r in line])
                if rank in line:
                    groups[name] = g
    return groups


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(n_devices: int | None = None, axis: str = "batch",
              device="cuda") -> Mesh:
    """1-D data-parallel mesh over the world's ranks.  JAX's `n_devices`
    takes the first n of one controller's devices, which has no meaning per
    rank: here it must be None or the world size."""
    n = _world()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"n_devices={n_devices}: a mesh spans the whole "
                         f"world of {n} ranks")
    return Mesh({axis: n}, device)


def make_mesh_2d(dp: int, tp: int, axes=("batch", "model"),
                 device="cuda") -> Mesh:
    """2-D mesh: data-parallel x tensor-parallel (for the sharded BP
    decode); dp * tp must be the world size."""
    return Mesh({axes[0]: dp, axes[1]: tp}, device)


def make_hybrid_mesh(tp: int = 1, axes=("batch", "model"),
                     device="cuda") -> Mesh:
    """(world / tp, tp) mesh with the tp group innermost: ranks numbered
    host by host keep each tp group within one host when the ranks per
    host divide by tp (JAX: ICI for the per-iteration sums of the model
    axis, DCN for the batch axis)."""
    n = _world()
    if n % tp:
        raise ValueError(f"tp={tp} does not divide {n} devices")
    return make_mesh_2d(n // tp, tp, axes, device)


def _default_backend(num_processes: int) -> str:
    """NCCL when every rank of this host has a card of its own, gloo
    otherwise (NCCL refuses two ranks on one card)."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    if torch.cuda.is_available() and local <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None) -> int:
    """Start this rank's process group (`tcp://coordinator`, host:port) when
    there are several processes, or when a backend is named (a world of one
    that runs its collectives through that backend); otherwise a no-op.
    backend: "nccl" or "gloo" (default: NCCL when each rank of the host has a card, else gloo).  Returns the
    world size (1 when no group was started)."""
    n = num_processes or 1
    if (n > 1 or backend is not None) and not dist.is_initialized():
        backend = backend or _default_backend(n)
        if backend == "nccl":
            local = int(os.environ.get("LOCAL_RANK", process_id or 0))
            torch.cuda.set_device(local % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=n, rank=process_id or 0)
    return _world()


def mesh_device(device, mesh: Mesh | None) -> torch.device:
    """The device a `mesh=` function runs on: the one the caller names,
    else the mesh rank's, else CUDA (raises without a card)."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh, got {mesh!r}")
    if device is None and mesh is not None:
        return mesh.device
    return resolve_device(device)


def shard_rows(n: int, mesh: Mesh | None, axis: str | None = None) -> slice:
    """This rank's rows of n rows split evenly along `axis` (the whole mesh,
    by flat rank, for None); n must divide by the axis size.  All rows
    without a mesh."""
    if mesh is None:
        return slice(None)
    k = mesh.size if axis is None else mesh.shape[axis]
    i = mesh.rank if axis is None else mesh.index(axis)
    if n % k:
        raise ValueError(f"{n} rows do not split over {k} ranks")
    return slice(i * n // k, (i + 1) * n // k)
