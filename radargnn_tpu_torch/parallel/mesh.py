"""The device mesh over `torch.distributed` ranks, and the sharded batch.

Port of `radargnn_tpu/parallel/mesh.py`. One process drives one rank. The
ranks form a mesh of named axes laid out row-major, as the JAX package
reshapes its device list:

    data   — data parallelism: each rank of a data coordinate takes G/dp
             graphs of a batch; the trainer sums the gradients over the
             ranks that hold distinct rows,
    model  — halo edge partitioning (`parallel.halo_dense`,
             `parallel.halo_windowed`): each graph's nodes split into mp
             contiguous shards, one all_to_all over the axis for the
             boundary senders; or column-parallel weights
             (`parallel.tensor`).

Under JAX, GSPMD inserts every collective of a sharded step. Here each rank
holds only its own rows, so the collectives are explicit
(`parallel.comm`): the gradient sum, the batch-wide BatchNorm statistics
(`models.mlp.batch_stats_over`), the global denominators of the masked
losses, and the halo exchange and its transpose.

`init_distributed` (the counterpart of `initialize_multihost`) joins the
process group that `torchrun` describes in the environment; `make_mesh`
then builds one process group per axis. A one-rank mesh needs no process
group at all, and its collectives are the identity.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from radargnn_tpu_torch.device import DeviceLike, resolve_device

# a collective that waits longer than this raises on every rank
DEFAULT_TIMEOUT_S = 600


@dataclasses.dataclass
class Mesh:
    """This rank's place in a mesh of ranks: the axes ({name: size}, in
    row-major order), its coordinate on each, one process group per axis
    (the ranks that share every other coordinate, ordered by this axis's
    coordinate) and the world's. `device` is where this rank computes."""

    axes: Dict[str, int]
    rank: int
    coords: Dict[str, int]
    groups: Dict[str, Optional[object]]
    world_group: Optional[object]
    device: torch.device

    @property
    def shape(self) -> Dict[str, int]:
        return dict(self.axes)

    @property
    def world_size(self) -> int:
        return int(np.prod(list(self.axes.values()))) if self.axes else 1

    def size(self, axis: str) -> int:
        return self.axes.get(axis, 1)

    def coord(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        """The process group of `axis` (None where the axis has one rank
        or the mesh is absent from it)."""
        return self.groups.get(axis)


def resolve_axes(axes: Optional[Dict[str, int]], n: int) -> Dict[str, int]:
    """{"axis": size} with -1 meaning "all remaining" over `n` devices, as
    the JAX package's make_mesh; default all devices on `data`. Raises
    where the mesh needs more than `n` devices."""
    axes = dict(axes) if axes else {"data": n}
    known = 1
    wild = None
    for k, v in axes.items():
        if v == -1:
            wild = k
        else:
            known *= v
    if wild is not None:
        axes[wild] = max(1, n // known)
    total = int(np.prod(list(axes.values())))
    if total > n:
        raise ValueError(f"mesh {axes} needs {total} devices, have {n}")
    return axes


def make_mesh(axes: Optional[Dict[str, int]] = None,
              world_size: Optional[int] = None, rank: Optional[int] = None,
              device: DeviceLike = None) -> Mesh:
    """Builds this rank's Mesh from {"axis": size} (-1: all remaining).

    `world_size` and `rank` default to the process group's (1 and 0 where
    none is initialised). With a process group of more than one rank the
    mesh must cover the whole world (a rank outside it would idle), and
    every rank must call make_mesh with the same axes, in the same order as
    its other collectives: it creates one process group per axis line.
    `device` defaults to the current card, and raises where there is none
    (`device.resolve_device`): a CPU mesh is asked for with device='cpu'."""
    initialised = dist.is_available() and dist.is_initialized()
    if world_size is None:
        world_size = dist.get_world_size() if initialised else 1
    if rank is None:
        rank = dist.get_rank() if initialised else 0
    axes = resolve_axes(axes, world_size)
    total = int(np.prod(list(axes.values())))
    if initialised and world_size > 1 and total != world_size:
        raise ValueError(f"mesh {axes} covers {total} of the {world_size} "
                         "ranks; every rank must be on the mesh")
    shape = tuple(axes.values())
    coords = dict(zip(axes, (int(c) for c in np.unravel_index(
        rank, shape)))) if rank < total else {}
    groups: Dict[str, Optional[object]] = {}
    world_group = None
    if initialised and total > 1:
        ids = np.arange(total).reshape(shape)
        for i, name in enumerate(axes):
            lines = np.moveaxis(ids, i, -1).reshape(-1, shape[i])
            for line in lines:
                # every rank creates every group, in one order
                g = dist.new_group([int(r) for r in line]) \
                    if shape[i] > 1 else None
                if rank in line:
                    groups[name] = g
        world_group = dist.group.WORLD
    if device is None and torch.cuda.is_available():
        device = torch.device("cuda", torch.cuda.current_device())
    return Mesh(axes, rank, coords, groups, world_group,
                resolve_device(device))


def init_distributed(backend: Optional[str] = None,
                     device: DeviceLike = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Joins the process group `torchrun` describes in the environment
    (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) and returns
    this rank's device: `cuda:LOCAL_RANK` unless `device` is the CPU.

    The backend is the caller's choice: NCCL by default on the card, gloo
    on the CPU. NCCL needs a card per rank and raises otherwise; gloo may
    put several ranks on one card. Without WORLD_SIZE in the environment (a
    plain single process) nothing is initialised and the device is
    returned as is."""
    want_cpu = device is not None and torch.device(device).type == "cpu"
    backend = backend or ("gloo" if want_cpu else "nccl")
    world = int(os.environ.get("WORLD_SIZE", "1"))
    local = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))
    if want_cpu:
        dev = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' (and the "
                "gloo backend) to run the ranks on the CPU")
        cards = torch.cuda.device_count()
        if backend == "nccl" and local >= cards:
            raise RuntimeError(
                f"NCCL needs one card per rank: local rank {local} of a "
                f"machine with {cards} card(s); use the gloo backend to "
                "share a card")
        dev = torch.device("cuda", local % cards)
        torch.cuda.set_device(dev)
    if world > 1 and not dist.is_initialized():
        kwargs = dict(backend=backend,
                      timeout=datetime.timedelta(seconds=timeout_s))
        if backend == "nccl":
            kwargs["device_id"] = dev
        dist.init_process_group(**kwargs)
    return dev


def shard_batch(batch, mesh: Optional[Mesh]):
    """This rank's part of a batch, on the mesh's device (no-op without a
    mesh, or on a batch already sharded): its data coordinate's G/dp
    graphs; for a halo-partitioned batch also only its model shard's node
    rows and halo plan (`GraphBatch.rank_shard`)."""
    if mesh is None or batch.mesh_shard is not None:
        return batch
    return batch.rank_shard(mesh.coord("data"), mesh.size("data"),
                            mesh.coord("model"), mesh.size("model")
                            ).to(mesh.device)
