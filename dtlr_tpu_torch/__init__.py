"""PyTorch/CUDA port of dtlr_tpu for NVIDIA Hopper.

Its layout mirrors ``dtlr_tpu/``: ``models/`` (the DINO detector),
``ops/`` (pixels, the box-prior attention kernel and its plain version,
the deformable attention's sampling, the CTC loss and blank synthesis,
NMS, the matcher), ``eval/`` (decode, metrics, the evaluate entry point
and its sweep), ``train/`` (optimizer, train steps, checkpoints, the
trainer and the finetune and pretrain entry points, the fresh
initialization, the reference's ``.pth`` map), ``data/`` (charsets,
transforms, the bucketed batcher, npz line datasets, the HWDB synthetic
stream), ``config/`` (the loader of recipe files) with ``configs/`` (the
recipe files), ``parallel/`` (data parallelism over ``torch.distributed``),
``utils/`` (boxes, the rank-aware logger) and ``scripts/`` (the gather
probe, the data-parallel dry run and step check). The package
imports torch and numpy only; its CUDA sources live in ``csrc/`` and
are compiled with ``nvcc`` at first use (``ops/flash_attn.py``).
"""

import os

import torch


def resolve_device(device: str = "cuda") -> torch.device:
    """The port's entry points run on the card unless the caller asks for
    the CPU; asking for CUDA where there is none raises. Under
    ``torchrun`` (``LOCAL_RANK`` set) a bare ``cuda`` is the rank's card,
    ``cuda:LOCAL_RANK``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the port's plain PyTorch path")
    if dev.type == "cuda" and dev.index is None and "LOCAL_RANK" in os.environ:
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return dev


def set_deterministic() -> None:
    """Runs that repeat bit for bit on the card: PyTorch's deterministic
    algorithms everywhere (an op that has none raises), cuDNN's
    deterministic convolutions and cuBLAS's fixed workspace. The
    backward's scatter-adds then sort instead of adding atomically, so
    steps are slower. Call it before the first CUDA work."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
