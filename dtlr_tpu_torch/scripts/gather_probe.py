"""The dynamic row gather on the card (counterpart of
scripts/pallas_probe.py): val (1024, 64) float32 from RandomState(0),
idx (128,) int32 from RandomState(1), out = val[idx] * 2 through the
hand-written kernel, held against numpy's gather with rtol 1e-6.

Usage: python -m dtlr_tpu_torch.scripts.gather_probe [--device cuda]

Prints PASS and exits 0, or prints FAIL and exits 1.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .. import resolve_device
from ..ops.gather import row_gather

S, C, Q = 1024, 64, 128


def main(argv=None) -> int:
    p = argparse.ArgumentParser("row gather probe")
    p.add_argument("--device", default="cuda")
    dev = resolve_device(p.parse_args(argv).device)
    val = np.random.RandomState(0).randn(S, C).astype(np.float32)
    idx = np.random.RandomState(1).randint(0, S, Q).astype(np.int32)
    got = row_gather(torch.from_numpy(val).to(dev), torch.from_numpy(idx).to(dev))
    try:
        np.testing.assert_allclose(got.cpu().numpy(), val[idx] * 2.0, rtol=1e-6)
    except AssertionError as exc:
        print(f"FAIL: the row gather on {dev} disagrees with numpy: {exc}")
        return 1
    print(f"PASS: the row gather on {dev} matches val[idx] * 2")
    return 0


if __name__ == "__main__":
    sys.exit(main())
