"""Collectives for the sharded paths, and a launcher of local ranks.

Under JAX the sharded step's collectives are inserted by GSPMD (and their
transposes by autodiff); here they are explicit:

  * `all_to_all` — the halo exchange: chunk j of dim 0 goes to group rank
    j, received chunks concatenate in source order (`jax.lax.all_to_all`
    over the split axis). Its backward is the same exchange of the
    gradient, which sends each chunk's cotangent back to its source.
  * `all_reduce_sum` — a differentiable sum over a group (the BatchNorm
    statistics of rows spread over ranks); its backward sums the gradient
    over the group, since every rank's result depends on every rank's
    input.
  * `all_reduce_` / `all_gather_cat` / `broadcast_` — in place and outside
    autograd: gradient sums, loss denominators, weight shards.

A group of None (an axis of one rank) makes each of them the identity.
The smoke runs two gloo ranks on one card (NCCL refuses two ranks on one
device): gloo takes CUDA tensors for its all-reduce and all_to_all_single
(checked on the card, torch's gloo backend), so the tensors go to the
collectives as they are, whatever the backend.

`run_ranks` starts `world` local rank processes (the `spawn` start method:
CUDA and the test runner's threads rule out `fork`) joined by a file store
in a fresh temporary directory, runs a top-level function in each and
returns their results in rank order. A rank's exception reaches the caller
as a RuntimeError with the rank's traceback; a rank that hangs in a
collective hits the process group's timeout, and the whole run a join
limit.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_reduce_(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """In-place all-reduce of `t` over `group` ("sum" or "max"); returns
    t. Outside autograd."""
    if group_size(group) == 1:
        return t
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    dist.all_reduce(t, op=red, group=group)
    return t


def all_reduce_many_(tensors: Sequence[torch.Tensor], group) -> None:
    """Sums several tensors over `group` in one collective (flattened into
    one float32 buffer and copied back)."""
    tensors = [t for t in tensors if t is not None]
    if group_size(group) == 1 or not tensors:
        return
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    all_reduce_(flat, group)
    i = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[i:i + n].view_as(t))
        i += n


def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors concatenated along `dim` in group-rank order
    (equal shapes). Outside autograd."""
    n = group_size(group)
    if n == 1:
        return t
    src = t.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim)


def broadcast_(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """In-place broadcast of `t` from global rank `src` over `group`."""
    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size(group) == 1:
        return t
    dist.broadcast(t, src, group=group)
    return t


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable exchange over `group`: x [P, ...] with P the group's
    size; chunk j goes to group rank j, and chunk j of the result came from
    group rank j (module docstring)."""
    if group_size(group) == 1:
        return x
    if x.shape[0] != group_size(group):
        raise ValueError(f"all_to_all: dim 0 is {x.shape[0]}, the group "
                         f"has {group_size(group)} ranks")
    return _AllToAll.apply(x, group)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum of `x` over `group` (module docstring)."""
    if group_size(group) == 1:
        return x
    return _AllReduceSum.apply(x, group)


# ---------------------------------------------------------------------------
# local ranks
# ---------------------------------------------------------------------------

def _rank_main(fn, rank, world, backend, store, timeout_s, devices,
               threads, args, results):
    try:
        if threads:
            torch.set_num_threads(threads)
        dev = torch.device(devices[rank % len(devices)])
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        kwargs = dict(backend=backend, init_method=f"file://{store}",
                      rank=rank, world_size=world,
                      timeout=datetime.timedelta(seconds=timeout_s))
        if backend == "nccl":
            kwargs["device_id"] = dev
        dist.init_process_group(**kwargs)
        try:
            out = fn(rank, world, dev, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        # the parent reports it (with every failed rank's); exit non-zero
        results.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn: Callable, world: int, backend: str = "gloo",
              args: tuple = (), devices: Optional[Sequence[str]] = None,
              timeout_s: float = 300, threads: Optional[int] = 1
              ) -> List[Any]:
    """Runs `fn(rank, world, device, *args)` in `world` spawned processes
    joined by one process group (`backend`; rank r computes on
    devices[r % len(devices)], the CPU by default) and returns the results
    in rank order. `fn` must be a top-level function of a module the
    children can import (and that imports no JAX: a spawned child imports
    it afresh). `threads` caps each rank's torch threads. Raises
    RuntimeError with the first failed rank's traceback, or TimeoutError
    after `timeout_s` (each collective's timeout too); every child is
    stopped before it returns."""
    devices = list(devices or ["cpu"])
    if backend == "nccl" and len(set(devices)) < world:
        raise ValueError("NCCL needs a card per rank: use gloo to share "
                         "a card")
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="radargnn_ranks_")
    results = ctx.Queue()
    procs = [ctx.Process(
        target=_rank_main, daemon=True,
        args=(fn, r, world, backend, os.path.join(tmp, "store"), timeout_s,
              devices, threads, args, results)) for r in range(world)]
    try:
        for p in procs:
            p.start()
        got: dict = {}
        failed: dict = {}
        deadline = time.monotonic() + timeout_s + 30
        grace = float("inf")
        while len(got) + len(failed) < world:
            if time.monotonic() > grace:
                break
            try:
                rank, ok, out = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if r not in got
                        and r not in failed and p.exitcode is not None]
                if dead and not failed:
                    raise RuntimeError(
                        f"rank {dead[0]} of {world} exited with code "
                        f"{procs[dead[0]].exitcode} without a result")
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{world} ranks did not finish within "
                        f"{timeout_s + 30:.0f} s")
                continue
            if ok:
                got[rank] = out
                continue
            if not failed:
                # the other ranks' collectives fail once one rank is gone:
                # gather their reports briefly, so the first cause is there
                grace = time.monotonic() + 5.0
            failed[rank] = out
        if failed:
            raise RuntimeError("\n".join(
                f"rank {r} of {world} failed:\n{failed[r]}"
                for r in sorted(failed)))
        for p in procs:
            p.join(timeout=60)
        return [got[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
