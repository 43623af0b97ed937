"""Process-group placement for the replica ensemble (counterpart of
``neuralmelting_tpu.parallel.mesh``), over ``torch.distributed``.

The scaling axis is the (P, T) replica grid: replicas are independent
between tempering events, so the leading replica axis of every ensemble
tensor is split over one process per device, and a process's shard
index is its rank. Every process builds the identical full-R ensemble
(same config, same seed) and keeps its slice (``to_global``); the
tempering exchange and the output writers need whole-R values, which
``all_gather`` / ``host_fetch`` bring to every rank.

The backend follows the layout of this rank's node (``pick_backend``):
NCCL where each rank of the node owns its card, gloo on the CPU and
where ranks share one card (NCCL refuses two ranks on one device). A
rank's place on its node is its local rank among the node's local world
size: ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE`` where the launcher sets
them (torchrun does), else the rank and the world size, as on one node.
Under gloo a collective's tensors go through the host; they are the O(R)
scalars of a record block, while the kernels and the sampling stay on
each rank's device.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import torch
import torch.distributed as dist


def process_count() -> int:
    """Processes in the run (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank, its shard index (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def local_layout(num_processes: int, process_id: int) -> tuple:
    """(local rank, local world size) of this rank on its node: the
    launcher's ``LOCAL_WORLD_SIZE`` (else ``num_processes``) and
    ``LOCAL_RANK`` (else ``process_id`` modulo the local world size,
    ranks numbered node by node)."""
    size = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    return int(os.environ.get("LOCAL_RANK", process_id % size)), size


def pick_backend(device, num_processes: int, process_id: int) -> str:
    """"nccl" where each rank of the node owns its card (no more local
    ranks than the node's cards: local rank i on cuda:i), "gloo" on the
    CPU and where ranks share a card. The choice depends on the local
    world size and the node's card count alone, so every rank of a
    uniform launch makes the same one."""
    dev = torch.device(device)
    local, size = local_layout(num_processes, process_id)
    if dev.type != "cuda" or size > torch.cuda.device_count():
        return "gloo"
    if dev.index not in (None, local):
        raise ValueError(f"rank {process_id} (local rank {local}) on {dev}: "
                         "with a card a rank, local rank i runs on cuda:i")
    return "nccl"


def rank_device(device, num_processes: int, process_id: int) -> str:
    """A rank's device: ``cuda:<local rank % the node's card count>`` for
    a bare "cuda", else ``device`` as given."""
    if str(device) == "cuda" and torch.cuda.is_available():
        local, _ = local_layout(num_processes, process_id)
        return f"cuda:{local % torch.cuda.device_count()}"
    return str(device)


def init_multihost(coordinator=None, num_processes=None, process_id=None,
                   device="cpu"):
    """Join the process group at ``coordinator`` ("host:port"), one
    process per device, this one ``process_id`` of ``num_processes``, on
    the backend ``pick_backend`` chooses from the layout. A no-op when
    ``coordinator`` is None (single-process run). Returns the backend's
    name (None for the no-op)."""
    if coordinator is None:
        return None
    if num_processes is None or process_id is None:
        raise ValueError("a multi-process run needs --nprocs and --procid")
    backend = pick_backend(device, num_processes, process_id)
    if backend == "nccl":
        torch.cuda.set_device(local_layout(num_processes, process_id)[0])
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    print(f"[mesh] process {process_id} of {num_processes} on {device}: "
          f"backend {backend}", file=sys.stderr, flush=True)
    return backend


def shutdown():
    """Leave the process group (a no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def barrier() -> None:
    """Wait for every rank (a no-op without a process group); under NCCL
    on this rank's card, which ``init_multihost`` made current."""
    if process_count() == 1:
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def _via_host(x: torch.Tensor) -> bool:
    """Whether a collective on ``x`` goes through the host: a device
    tensor under gloo."""
    return x.device.type != "cpu" and dist.get_backend() != "nccl"


def _map(fn, tree):
    """``fn`` on every tensor leaf of tuples, lists, dicts and
    dataclasses; None and other leaves pass through."""
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    return tree


def shard_rows(r: int) -> slice:
    """This rank's rows of the R replicas; R must divide by the process
    count."""
    n = process_count()
    if r % n:
        raise ValueError(f"{r} replicas do not split over {n} processes: "
                         "the replica count must divide by the process "
                         "count")
    lo = process_index() * (r // n)
    return slice(lo, lo + r // n)


def to_global(tree, r: int):
    """This rank's shard of an identical-per-process whole-R tree: every
    tensor with a leading axis of R replicas is sliced to this rank's
    rows (a copy); scalars and other tensors pass through."""
    rows = shard_rows(r)

    def take(x):
        if x.dim() >= 1 and x.shape[0] == r:
            return x[rows].clone()
        return x

    return _map(take, tree)


def all_gather(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``axis`` in rank order, on
    every rank (through the host under gloo)."""
    n = process_count()
    if n == 1:
        return x
    dev = x.device
    via_host = _via_host(x)
    src = (x.cpu() if via_host else x).contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src)
    out = torch.cat(parts, dim=axis)
    return out.to(dev) if via_host else out


def host_fetch(tree, r: int, axis: int = 0):
    """Whole-R tensors on every rank: a tensor whose ``axis`` holds this
    rank's R / process_count() replicas is all-gathered along it; one
    that already holds all R, a scalar or one without that axis passes
    through untouched. Every rank must call it with the same tree (one
    collective a sharded leaf, in the same order on every rank)."""
    n = process_count()
    if n == 1:
        return tree

    def fetch(x):
        if x.dim() > axis and x.shape[axis] == r // n:
            return all_gather(x, axis)
        return x

    return _map(fetch, tree)


def all_reduce_(x: torch.Tensor, op) -> torch.Tensor:
    """In-place ``all_reduce`` of ``x`` (through the host under gloo)."""
    if process_count() == 1:
        return x
    if _via_host(x):
        h = x.cpu()
        dist.all_reduce(h, op=op)
        x.copy_(h)
    else:
        dist.all_reduce(x, op=op)
    return x


def any_ranks(flag: torch.Tensor) -> torch.Tensor:
    """A 0-dim flag ORed over the ranks: an int32 ``all_reduce`` with MAX
    (gloo takes no bool), through the host under gloo; ``flag`` itself
    in one process."""
    if process_count() == 1:
        return flag
    return all_reduce_(flag.to(torch.int32, copy=True), dist.ReduceOp.MAX)
