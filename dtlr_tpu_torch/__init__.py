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
recipe files) and ``utils/boxes.py``. The package
imports torch and numpy only; its CUDA sources live in ``csrc/`` and
are compiled with ``nvcc`` at first use (``ops/flash_attn.py``).
"""

import torch


def resolve_device(device: str = "cuda") -> torch.device:
    """The port's entry points run on the card unless the caller asks for
    the CPU; asking for CUDA where there is none raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the port's plain PyTorch path")
    return dev
