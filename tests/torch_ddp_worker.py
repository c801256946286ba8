"""One rank of tests/test_torch_parallel.py's group (``python -m
torch.distributed.run --nproc_per_node 2 tests/torch_ddp_worker.py OUT``):
a toy gradient step on the rank's rows, summed over the ranks, and the
collectives of ``dtlr_tpu_torch.parallel``; rank 0 writes what it saw to
OUT as JSON."""

import json
import sys

import numpy as np
import torch

from dtlr_tpu_torch import parallel


def main(out: str) -> None:
    world = parallel.init_distributed("cpu")
    rank, W = world.rank, world.world_size
    # test_parallel.py's toy: mean((x @ W)^2) over 16 rows
    x = np.random.default_rng(0).standard_normal((16, 4)).astype(np.float32)
    weight = torch.ones((4, 2), requires_grad=True)
    rows = torch.from_numpy(x[parallel.shard_rows(16, rank, W)])
    # each rank's share of the global mean: its sum over the global count
    loss = ((rows @ weight) ** 2).sum() / (16 * 2)
    loss.backward()
    grad, total = parallel.all_reduce_coalesced([weight.grad, loss.detach().reshape(1)])
    record = {"world": W, "backend": world.backend, "grad": grad.tolist(),
              "loss": float(total[0]),
              "broadcast": parallel.broadcast(torch.tensor([float(rank + 7)])).tolist(),
              "broadcast_object": parallel.broadcast_object({"from": rank}),
              "gathered": parallel.all_gather_object(rank * 10)}
    # batches that run out together stop together
    record["lockstep"] = list(parallel.lockstep(range(3)))
    # a rank that runs out alone: every rank raises, none waits
    try:
        list(parallel.lockstep(range(3 + rank)))
        record["uneven"] = "no error"
    except RuntimeError as exc:
        record["uneven"] = str(exc)
    record["uneven_seen_by"] = parallel.all_gather_object(record["uneven"])
    if rank == 0:
        with open(out, "w") as fh:
            json.dump(record, fh)
    parallel.shutdown()


if __name__ == "__main__":
    main(sys.argv[1])
