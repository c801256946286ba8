"""The port's data parallelism helpers (dtlr_tpu_torch/parallel/mesh.py)
against dtlr_tpu/parallel/mesh.py, the counterpart of test_parallel.py.

- ``shard_rows``/``shard_batch``: rank r's rows are the rows JAX's
  ``shard_batch`` puts on the mesh's device r (``NamedSharding(mesh,
  P("data"))`` on the conftest's virtual CPU devices), and the ranks'
  rows reassemble the batch;
- ``pad_batch_to_devices``: JAX's, bit for bit;
- a toy gradient step over a two-rank gloo group (``torchrun``) equals
  the gradient on the whole batch (test_parallel.py's
  ``test_sharded_train_math_matches_single_device``), and the group's
  broadcast, gathers and ``lockstep`` do what they say, a rank that runs
  out of batches alone making every rank raise;
- without torchrun's environment there is no group and the world is one
  process; a CUDA device where there is none, or a failed
  initialization, raises; ``resolve_device`` takes the rank's card.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dtlr_tpu_torch
from dtlr_tpu.parallel.mesh import create_mesh
from dtlr_tpu.parallel.mesh import pad_batch_to_devices as jax_pad
from dtlr_tpu.parallel.mesh import shard_batch as jax_shard_batch
from dtlr_tpu_torch import parallel
from dtlr_tpu_torch.parallel import launch
from dtlr_tpu_torch.train.engine import check_batch_size
from test_torch_ddp_step import rank_threads

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_ddp_worker.py")


@pytest.mark.parametrize("n_dev,B", [(2, 4), (4, 16), (8, 16), (8, 8)])
def test_rank_rows_are_jax_device_rows(n_dev, B):
    mesh = create_mesh("data", jax.devices()[:n_dev])
    arrays = {"x": np.arange(B * 3, dtype=np.float32).reshape(B, 3),
              "y": np.arange(B, dtype=np.int32)}
    out = jax_shard_batch(mesh, arrays)
    device_rank = {d: i for i, d in enumerate(mesh.devices.flat)}
    for name, arr in out.items():
        for shard in arr.addressable_shards:
            r = device_rank[shard.device]
            mine = parallel.shard_batch(arrays, r, n_dev)[name]
            np.testing.assert_array_equal(mine, np.asarray(shard.data))
            assert parallel.shard_rows(B, r, n_dev) == shard.index[0]
    for name, arr in arrays.items():
        parts = [parallel.shard_batch(arrays, r, n_dev)[name] for r in range(n_dev)]
        np.testing.assert_array_equal(np.concatenate(parts), arr)


def test_shard_batch_takes_lists_and_tensors_too():
    batch = {"images": torch.arange(6).reshape(3, 2), "texts": ["a", "b", "c"]}
    parts = [parallel.shard_batch(batch, r, 2) for r in range(2)]
    assert [p["texts"] for p in parts] == [["a"], ["b", "c"]]
    assert torch.equal(torch.cat([p["images"] for p in parts]), batch["images"])


@pytest.mark.parametrize("B,n", [(5, 8), (5, 2), (8, 8), (3, 4), (1, 3)])
def test_pad_batch_to_devices_is_jax(B, n):
    rng = np.random.default_rng(B * 10 + n)
    arrays = {"images": rng.integers(0, 255, (B, 4, 6, 3)).astype(np.uint8),
              "valid_hw": rng.integers(1, 9, (B, 2)).astype(np.int32),
              "labels": rng.integers(0, 9, (B, 5)).astype(np.int32),
              "boxes": rng.uniform(0, 1, (B, 5, 4)).astype(np.float32),
              "valid": rng.uniform(0, 1, (B, 5)) > 0.3}
    got, want = parallel.pad_batch_to_devices(arrays, n), jax_pad(arrays, n)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape[0] % n == 0
        np.testing.assert_array_equal(got[k], want[k])


@pytest.fixture(scope="module")
def group_record(tmp_path_factory):
    out = tmp_path_factory.mktemp("group") / "rank0.json"
    done = launch.run_child(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         "2", WORKER, str(out)], timeout=120, threads=rank_threads())
    assert done.returncode == 0, done.stderr[-4000:]
    with open(out) as fh:
        return json.load(fh)


def test_toy_step_over_two_ranks_is_the_whole_batch_gradient(group_record):
    """test_parallel.py's toy loss; the gradient of the global mean is
    the sum over the ranks of each rank's share."""
    x = np.random.default_rng(0).standard_normal((16, 4)).astype(np.float32)

    def loss(w, x):
        return jnp.mean((x @ w) ** 2)

    g_local = jax.grad(loss)(jnp.ones((4, 2)), jnp.asarray(x))
    assert group_record["world"] == 2 and group_record["backend"] == "gloo"
    np.testing.assert_allclose(np.asarray(group_record["grad"]), np.asarray(g_local), rtol=1e-5)
    np.testing.assert_allclose(group_record["loss"], float(loss(jnp.ones((4, 2)), x)),
                               rtol=1e-5)


def test_collectives_and_lockstep(group_record):
    assert group_record["broadcast"] == [7.0]
    assert group_record["broadcast_object"] == {"from": 0}
    assert group_record["gathered"] == [0, 10]
    assert group_record["lockstep"] == [0, 1, 2]
    assert all("ran out of step" in seen for seen in group_record["uneven_seen_by"])


def test_no_environment_no_group(monkeypatch):
    for key in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    world = parallel.init_distributed("cpu")
    assert world == parallel.World(0, 1, 0, None)
    assert not parallel.distributed() and parallel.world_size() == 1 and parallel.rank() == 0
    t = torch.arange(3.0)
    assert parallel.all_reduce_sum(t) is t and torch.equal(t, torch.arange(3.0))
    assert parallel.all_gather_object("x") == ["x"]
    assert list(parallel.lockstep(iter([1, 2]))) == [1, 2]


def test_no_fallback(monkeypatch):
    """Under torchrun's environment a CUDA device where there is none
    raises, and so does a process group that cannot start; nothing
    carries on in one process."""
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        parallel.init_distributed("cuda")
    if not torch.distributed.is_nccl_available():
        with pytest.raises(Exception):
            parallel.init_distributed("cpu", backend="nccl")
    assert not parallel.distributed()


def test_resolve_device_takes_the_rank_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert dtlr_tpu_torch.resolve_device("cuda") == torch.device("cuda", 3)
    assert dtlr_tpu_torch.resolve_device("cuda:1") == torch.device("cuda", 1)
    assert dtlr_tpu_torch.resolve_device("cpu") == torch.device("cpu")
    monkeypatch.delenv("LOCAL_RANK")
    assert dtlr_tpu_torch.resolve_device("cuda") == torch.device("cuda")


@pytest.mark.parametrize("bs,world,message", [
    (8, 2, None), (8, 8, None), (8, 1, None),
    (3, 2, "batch_size 3 is the global batch.*use batch_size 2 or 4.*launch \\[1, 3\\]"),
    (8, 3, "batch_size 6 or 9.*\\[1, 2, 4, 8\\]")])
def test_batch_size_rule(bs, world, message):
    """The world size must divide the global batch (JAX takes the device
    prefix that divides it, dtlr_tpu/train/engine.py:110-119)."""
    if message is None:
        check_batch_size(bs, world)
    else:
        with pytest.raises(ValueError, match=message):
            check_batch_size(bs, world)
