"""Data parallelism over ``torch.distributed``, one process per rank
(counterpart of dtlr_tpu/parallel/mesh.py).

JAX runs one program over a device mesh and shards the batch's leading
axis over it (``NamedSharding(mesh, P("data"))``); its losses and
metrics are global sums over the sharded batch, and XLA inserts the
gradients' all-reduce. Here each rank is a process (``torchrun
--nproc_per_node W``) that takes its rows of every global batch:
``batch_size`` stays the global batch, as in JAX, and rank r takes rows
[r·B/W, (r+1)·B/W). The train steps divide each rank's sums by the
global batch's normalizers and sum the gradients over the ranks
(``all_reduce_sum``), so that the step is the one of one process on the
whole batch.

``init_distributed`` reads ``torchrun``'s environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``) and joins the group: NCCL for a CUDA
device (``cuda:LOCAL_RANK``), gloo for the CPU. Without that environment
there is no group and the world is one process; every function here is
then the identity, so a run without ``torchrun`` is the one-process path
as it was. A group that the caller initialized is used as it is, with
its own backend (gloo on CUDA tensors is how two ranks share one card).

Collectives on CUDA tensors under gloo are staged through the host here:
the tensor is copied to the CPU, reduced or broadcast, and copied back.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

#: how long a collective waits for the other ranks before it raises
TIMEOUT = datetime.timedelta(minutes=10)


class World(NamedTuple):
    rank: int
    world_size: int
    local_rank: int
    backend: Optional[str]   # None: no process group


def distributed() -> bool:
    """Whether a process group is up."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if distributed() else 0


def world_size() -> int:
    return dist.get_world_size() if distributed() else 1


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def init_distributed(device: str = "cuda", backend: Optional[str] = None) -> World:
    """Join the process group that ``torchrun`` describes in the
    environment; a group already initialized is taken as it is; without
    ``WORLD_SIZE`` in the environment there is none (world size 1).
    ``backend`` defaults to NCCL for a CUDA ``device`` and gloo for the
    CPU. A CUDA device where there is none raises, as does a failed
    initialization."""
    if distributed():
        return World(dist.get_rank(), dist.get_world_size(), local_rank(), dist.get_backend())
    if "WORLD_SIZE" not in os.environ:
        return World(0, 1, 0, None)
    world = int(os.environ["WORLD_SIZE"])
    rk = int(os.environ["RANK"])
    local = local_rank()
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass --device cpu to train on the CPU "
                               "over gloo")
        torch.cuda.set_device(dev.index if dev.index is not None else local)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method="env://", rank=rk, world_size=world,
                            timeout=TIMEOUT)
    return World(rk, world, local, backend)


def shutdown() -> None:
    """Leave the process group, if there is one."""
    if distributed():
        dist.destroy_process_group()


def shard_rows(n: int, rank: int, world: int) -> slice:
    """Rank ``rank``'s rows of a batch of ``n``: [rank·n/W, (rank+1)·n/W)
    (the layout of JAX's ``NamedSharding(mesh, P("data"))`` when W divides
    ``n``; balanced, contiguous rows when it does not)."""
    return slice(rank * n // world, (rank + 1) * n // world)


def shard_batch(arrays: Dict, rank: int, world: int) -> Dict:
    """The rank's rows of every array (numpy or torch) and list of a
    batch dict."""
    n = len(next(iter(arrays.values())))
    rows = shard_rows(n, rank, world)
    return {k: (list(v[rows]) if isinstance(v, (list, tuple)) else v[rows])
            for k, v in arrays.items()}


def pad_batch_to_devices(arrays: Dict, n_devices: Optional[int] = None) -> Dict:
    """Pad the batch axis to a multiple of ``n_devices`` (default: the
    world size): images repeat the last sample, and ``labels``, ``boxes``
    and ``valid`` are zeroed on the padded rows so that they add no
    target (dtlr_tpu/parallel/mesh.py:56-72)."""
    n = n_devices or world_size()
    B = next(iter(arrays.values())).shape[0]
    pad = (-B) % n
    if pad == 0:
        return arrays
    out = {}
    for k, v in arrays.items():
        tail = np.repeat(v[-1:], pad, axis=0)
        if k in ("labels", "boxes", "valid"):
            tail = np.zeros_like(tail)
        out[k] = np.concatenate([v, tail], axis=0)
    return out


def _staged(t: torch.Tensor) -> bool:
    return t.is_cuda and dist.get_backend() == "gloo"


def all_reduce_sum(tensor: torch.Tensor) -> torch.Tensor:
    """Sum ``tensor`` over the ranks, in place; returns it. The identity
    without a group."""
    if not distributed():
        return tensor
    if _staged(tensor):
        host = tensor.cpu()
        dist.all_reduce(host)
        tensor.copy_(host)
    else:
        dist.all_reduce(tensor)
    return tensor


def all_reduce_coalesced(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The sums over the ranks of ``tensors`` (float32, on one device) in
    one collective: flattened in their order into one buffer, summed, and
    returned as views of it with the inputs' shapes. The inputs as they
    are without a group."""
    if not distributed():
        return list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    all_reduce_sum(flat)
    out, start = [], 0
    for t in tensors:
        out.append(flat[start:start + t.numel()].view(t.shape))
        start += t.numel()
    return out


def broadcast(tensor: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``tensor`` on every rank, in place; returns it."""
    if not distributed():
        return tensor
    if _staged(tensor):
        host = tensor.cpu()
        dist.broadcast(host, src)
        tensor.copy_(host)
    else:
        dist.broadcast(tensor, src)
    return tensor


def broadcast_object(obj, src: int = 0):
    """Rank ``src``'s picklable ``obj`` on every rank."""
    if not distributed():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src, device=_object_device())
    return box[0]


def all_gather_object(obj) -> list:
    """Every rank's picklable ``obj``, in rank order."""
    if not distributed():
        return [obj]
    out = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out


def _object_device():
    return (torch.device("cuda", torch.cuda.current_device())
            if dist.get_backend() == "nccl" else torch.device("cpu"))


def barrier() -> None:
    if distributed():
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


def lockstep(batches):
    """The batches of ``batches`` while every rank has one: each rank
    draws its next batch and the ranks sum how many did, so that all stop
    together, and a rank that runs out alone raises on every rank instead
    of leaving the others waiting in a collective."""
    it = iter(batches)
    if world_size() == 1:
        yield from it
        return
    dev = _object_device()
    while True:
        try:
            item, have = next(it), 1
        except StopIteration:
            item, have = None, 0
        count = all_reduce_sum(torch.tensor([have], dtype=torch.int64, device=dev))
        n = int(count.item())
        if n == 0:
            return
        if n != world_size():
            raise RuntimeError(f"the ranks' batches ran out of step: {n} of {world_size()} "
                               "ranks had another batch")
        yield item
