"""The port's row gather (dtlr_tpu_torch/ops/gather.py) against the JAX
probe's Pallas kernel (``kernel`` in ``main()`` of
scripts/pallas_probe.py), and the port's probe entry point.

The probe defines its kernel inside ``main()``, so a shim in place of
``pl.pallas_call`` records the body it is given and runs it in interpret
mode; ``main()`` returns 0 on the CPU that way. The recorded body then
runs through ``pl.pallas_call(..., interpret=True)`` on the probe's
inputs and on a second seed. A gather and a doubling are exact in
float32, so the results must be equal bit for bit.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from dtlr_tpu_torch.ops import gather
from dtlr_tpu_torch.scripts import gather_probe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, C, Q = 1024, 64, 128


@pytest.fixture(scope="module")
def probe_kernel():
    spec = importlib.util.spec_from_file_location(
        "pallas_probe", os.path.join(REPO, "scripts", "pallas_probe.py"))
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    recorded = {}
    real = pl.pallas_call

    def shim(kernel, **kwargs):
        recorded["kernel"] = kernel
        kwargs["interpret"] = True
        return real(kernel, **kwargs)

    pl.pallas_call = shim
    try:
        assert probe.main() == 0
    finally:
        pl.pallas_call = real
    return recorded["kernel"]


def inputs(val_seed, idx_seed):
    val = np.random.RandomState(val_seed).randn(S, C).astype(np.float32)
    idx = np.random.RandomState(idx_seed).randint(0, S, Q).astype(np.int32)
    return val, idx


@pytest.mark.parametrize("seeds", [(0, 1), (2, 3)], ids=["probe", "second_seed"])
def test_reference_matches_pallas_probe_kernel(probe_kernel, seeds):
    val, idx = inputs(*seeds)
    want = pl.pallas_call(probe_kernel, out_shape=jax.ShapeDtypeStruct((Q, C), jnp.float32),
                          interpret=True)(jnp.asarray(val), jnp.asarray(idx))
    got = gather.row_gather_reference(torch.from_numpy(val), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # on CPU tensors the wrapper is the plain version and launches nothing
    launches = dict(gather.row_gather.launches)
    np.testing.assert_array_equal(
        gather.row_gather(torch.from_numpy(val), torch.from_numpy(idx)).numpy(), got.numpy())
    assert gather.row_gather.launches == launches


def test_probe_entry_point(monkeypatch, capsys):
    assert gather_probe.main(["--device", "cpu"]) == 0
    assert capsys.readouterr().out.startswith("PASS")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        gather_probe.main([])


def test_out_of_range_index_is_refused_on_the_cpu():
    """On CPU tensors the wrapper is ``index_select``, which raises; on the
    card the kernel's device-side assert refuses the index
    (test_torch_kernels_gpu.py::test_row_gather_rejects_what_it_does_not_take)."""
    val = torch.zeros(16, 4)
    for bad in ([0, 16], [-1, 3]):
        with pytest.raises(IndexError):
            gather.row_gather(val, torch.tensor(bad, dtype=torch.int32))
