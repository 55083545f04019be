"""Wrapper of the CUDA flash-attention kernel (csrc/flash_attention.cu), the
Hopper port of ``repro/kernels/flash_attention.py::flash_attention_pallas``.

``flash_attention_cuda`` checks shapes, dtypes and devices, allocates the
output and launches on PyTorch's current stream; it never falls back to the
plain version. The kernel picks its own tiles (64 query rows by 64 keys), so
the Pallas kernel's ``q_tile`` / ``kv_tile`` have no counterpart here, and Sq
and Sk need not be multiples of anything. ``LAUNCHES`` counts its launches.
"""
from __future__ import annotations

import collections
import math

import torch

from . import _build
from .fwht import check_cuda, stream_handle

LAUNCHES: collections.Counter = collections.Counter()
MAX_D_HEAD = 256
_DTYPES = {torch.float32: "flash_attention_f32", torch.bfloat16: "flash_attention_bf16"}


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, rep: int, window: int,
                 q_offset: int) -> None:
    """Raise ValueError on what the kernel does not take."""
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(f"q must be (N_q, Sq, dh) and k, v one (N_kv, Sk, dh) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share float32 or bfloat16, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    n_q, _, dh = q.shape
    n_kv, sk, dk = k.shape
    if dk != dh or dh % 8 != 0 or not 8 <= dh <= MAX_D_HEAD:
        raise ValueError(f"d_head must be a multiple of 8 in [8, {MAX_D_HEAD}] and the same for "
                         f"q and k, got {dh} and {dk}")
    if rep < 1 or n_q != n_kv * rep:
        raise ValueError(f"N_q must be N_kv * rep, got {n_q} != {n_kv} * {rep}")
    if n_q > 65535 or sk < 1 or window < 0 or q_offset < 0:
        raise ValueError(f"need N_q <= 65535, Sk >= 1, window >= 0 and q_offset >= 0, got "
                         f"N_q={n_q}, Sk={sk}, window={window}, q_offset={q_offset}")
    if max(q.numel(), k.numel()) >= 1 << 31 or q_offset + q.shape[1] >= 1 << 30:
        raise ValueError("too large for one launch")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, rep: int,
                         window: int = 0, q_offset: int = 0) -> torch.Tensor:
    """Causal GQA attention; q (N_q, Sq, dh), k and v (N_kv, Sk, dh), f32 or
    bf16, contiguous and 16-byte aligned. -> (N_q, Sq, dh) in q's dtype."""
    check_shapes(q, k, v, rep, window, q_offset)
    check_cuda(q, k, v)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention_cuda needs 16-byte aligned tensors")
    n_q, sq, dh = q.shape
    out = torch.empty_like(q)
    _build.launch(
        "flash_attention", _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), n_q, sq, k.shape[1], dh, rep, window, q_offset, 1.0 / math.sqrt(dh),
        stream_handle(q),
    )
    LAUNCHES["flash_attention"] += 1
    return out
