"""Data parallelism over ``torch.distributed`` (``mesh.py``)."""

from .mesh import (World, all_gather_object, all_reduce_coalesced, all_reduce_sum, barrier,
                   broadcast, broadcast_object, distributed, init_distributed, local_rank,
                   lockstep, pad_batch_to_devices, rank, shard_batch, shard_rows, shutdown,
                   world_size)

__all__ = ["World", "all_gather_object", "all_reduce_coalesced", "all_reduce_sum", "barrier",
           "broadcast", "broadcast_object", "distributed", "init_distributed", "local_rank",
           "lockstep", "pad_batch_to_devices", "rank", "shard_batch", "shard_rows", "shutdown",
           "world_size"]
