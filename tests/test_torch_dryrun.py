"""The port's multi-rank dry run (dtlr_tpu_torch/scripts/dryrun_multichip.py,
the counterpart of __graft_entry__.py's ``dryrun_multichip``): the full
detection step of the JAX package's tiny model (with 2 heads of 32, the
kernel's head size, for its 4 of 16) over two gloo ranks on the CPU
finishes with a finite loss and ranks whose parameters agree bit
for bit (the run fails otherwise), and its loss is one process's on the
same global batch of two lines, within 1e-5 relative (only the
summation order differs)."""

import math

from dtlr_tpu_torch.scripts import dryrun_multichip as dryrun
from test_torch_ddp_step import RANKS, rank_threads


def test_dryrun_multichip_two_ranks():
    loss = dryrun.dryrun_multichip(RANKS, device="cpu", timeout=300, threads=rank_threads())
    assert math.isfinite(loss)
    one = dryrun.rank_step("cpu", lines=RANKS)
    # the ranks print the loss to 4 decimals
    assert abs(loss - one) <= max(1e-5 * abs(one), 5e-5), (loss, one)


def test_global_batch_is_jax_draws():
    """__graft_entry__.py:94-104's batch, drawn in its order."""
    import numpy as np

    b = dryrun.global_batch(3)
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(b["images"], rng.integers(0, 256, (3, 64, 128, 3)))
    np.testing.assert_array_equal(b["labels"], rng.integers(0, 166, (3, 8)))
    np.testing.assert_array_equal(b["boxes"], rng.uniform(0.3, 0.6, (3, 8, 4)).astype(np.float32))
    assert b["valid"].all() and (b["valid_hw"] == [64, 128]).all()
