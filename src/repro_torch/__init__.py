"""repro_torch: the PyTorch / CUDA (NVIDIA H100) port of ``repro``.

It runs the paper's Rand-Proj-Spatial estimator end to end, from chunking
through the SRHT client encode to the fused CG server decode and the
compressed gradient mean of ``dist.collectives``, on hand-written Hopper
kernels (``kernels/csrc``). It imports neither JAX nor ``repro``.

Every entry point takes ``device=None``, which means ``default_device()``:
the CUDA device, or a ``RuntimeError`` when there is none. Nothing moves to
the CPU because no GPU was found; the CPU runs only when asked for.
"""
from __future__ import annotations

import torch

__version__ = "0.1.0"


def default_device() -> torch.device:
    """The CUDA device; raises RuntimeError when CUDA is absent."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; "
            "pass device='cpu' explicitly to run the plain versions on the CPU"
        )
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device, ``default_device()`` when None."""
    return default_device() if device is None else torch.device(device)
