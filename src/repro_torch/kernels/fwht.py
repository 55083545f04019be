"""Wrapper of the CUDA FWHT kernel (csrc/fwht.cu), the Hopper port of
``repro/kernels/fwht.py::fwht_pallas``.

``fwht_cuda`` checks shapes, dtypes and devices, allocates the output and
launches on PyTorch's current stream; it never falls back to the plain
version. ``LAUNCHES`` counts its launches.
"""
from __future__ import annotations

import collections

import torch

from . import _build

LAUNCHES: collections.Counter = collections.Counter()
MAX_D = 1 << 15  # one row a block of 1024 threads, 32 floats a thread
_DTYPES = {torch.float32: "fwht_f32", torch.bfloat16: "fwht_bf16"}


def check_width(d: int) -> None:
    if d < 2 or d & (d - 1) != 0 or d > MAX_D:
        raise ValueError(f"FWHT width must be a power of two in [2, {MAX_D}], got {d}")


def check_cuda(*tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"CUDA kernel needs every tensor on one CUDA device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("CUDA kernel needs contiguous tensors")


def stream_handle(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def fwht_cuda(x: torch.Tensor, signs: torch.Tensor | None = None,
              rows: torch.Tensor | None = None, *, scale: float = 1.0) -> torch.Tensor:
    """``(scale * H_d (signs * x))[:, rows]`` for x (R, d), f32 or bf16.

    signs: optional (d,) float32 diagonal shared by every row; rows: optional
    (k,) int64 output columns (the SRHT encode's gather, fused). -> (R, k|d)
    in x's dtype."""
    if x.dim() != 2 or x.dtype not in _DTYPES:
        raise ValueError(f"x must be (rows, d) float32 or bfloat16, got {tuple(x.shape)} {x.dtype}")
    n_rows, d = x.shape
    check_width(d)
    if n_rows >= 1 << 31:
        raise ValueError(f"too many rows for one launch: {n_rows}")
    tensors = [x]
    if signs is not None:
        if signs.shape != (d,) or signs.dtype != torch.float32:
            raise ValueError(
                f"signs must be ({d},) float32, got {tuple(signs.shape)} {signs.dtype}")
        tensors.append(signs)
    k = d
    if rows is not None:
        if rows.dim() != 1 or rows.dtype != torch.int64:
            raise ValueError(f"rows must be (k,) int64, got {tuple(rows.shape)} {rows.dtype}")
        k = rows.shape[0]
        tensors.append(rows)
    check_cuda(*tensors)
    if x.data_ptr() % 16:  # the kernel reads x 16 bytes at a time
        x = x.clone()
    out = torch.empty((n_rows, k), dtype=x.dtype, device=x.device)
    _build.launch(
        "fwht", _DTYPES[x.dtype], x.data_ptr(),
        None if signs is None else signs.data_ptr(),
        None if rows is None else rows.data_ptr(),
        out.data_ptr(), n_rows, d, k, scale, stream_handle(x),
    )
    LAUNCHES["fwht"] += 1
    return out
