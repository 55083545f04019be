"""Wrappers of the CUDA flash-attention kernels, the Hopper port of
``repro/kernels/flash_attention.py::flash_attention_pallas``, routed by dtype:

- bfloat16: ``csrc/flash_attention_tc.cu``, on the tensor cores (``wgmma``,
  K/V tiles loaded by TMA; 128 query rows by 64 keys at d_head 256, by 128
  keys at d_head <= 128), P carried into the P V product as P_hi + P_lo, two
  bf16 values (about 16 significant bits);
- float32: ``csrc/flash_attention.cu``, on the tensor cores in split TF32
  (``mma.sync``; each float32 operand as hi + lo, two TF32 values, three
  products a pair, which keeps the float32 tolerances that plain TF32 would
  break), K/V tiles loaded by TMA, P kept in registers.

``flash_attention_cuda`` checks shapes, dtypes, alignment and devices,
allocates the output and launches on PyTorch's current stream. There is no
fallback: a bf16 tensor launches the bf16 kernel or raises, a float32 tensor
the float32 kernel or raises, never the other route or the plain version.
The kernels pick their own tiles, so the Pallas kernel's ``q_tile`` /
``kv_tile`` have no counterpart here, and Sq and Sk need not be multiples
of anything. ``LAUNCHES`` counts the
launches of each route (``flash_attention_bf16``, ``flash_attention_f32``).
"""
from __future__ import annotations

import collections
import math

import torch

from . import _build
from .fwht import check_cuda, stream_handle

LAUNCHES: collections.Counter = collections.Counter()
MAX_D_HEAD = 256
BF16_Q_TILE = 128  # query rows per block of the tensor-core kernel
# dtype -> (route, i.e. the launch count's key; csrc source; C launcher)
ROUTES = {
    torch.bfloat16: ("flash_attention_bf16", "flash_attention_tc", "flash_attention_bf16_wgmma"),
    torch.float32: ("flash_attention_f32", "flash_attention", "flash_attention_f32"),
}


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, rep: int, window: int,
                 q_offset: int) -> None:
    """Raise ValueError on what the kernel does not take."""
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(f"q must be (N_q, Sq, dh) and k, v one (N_kv, Sk, dh) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in ROUTES or k.dtype != q.dtype or v.dtype != q.dtype:
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
    if q.dtype == torch.bfloat16 and -(-q.shape[1] // BF16_Q_TILE) > 65535:
        raise ValueError(f"Sq = {q.shape[1]} gives more than 65535 query tiles of "
                         f"{BF16_Q_TILE} rows, the tensor-core kernel's grid limit")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, rep: int,
                         window: int = 0, q_offset: int = 0) -> torch.Tensor:
    """Causal GQA attention; q (N_q, Sq, dh), k and v (N_kv, Sk, dh), all
    bf16 (the wgmma kernel) or all float32 (the split-TF32 kernel),
    contiguous, 16-byte aligned, on one CUDA device. -> (N_q, Sq, dh) in
    q's dtype. Raises ValueError on anything else."""
    check_shapes(q, k, v, rep, window, q_offset)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention_cuda needs 16-byte aligned tensors")
    check_cuda(q, k, v)
    route, source, launcher = ROUTES[q.dtype]
    n_q, sq, dh = q.shape
    out = torch.empty_like(q)
    _build.launch(
        source, launcher, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), n_q, sq,
        k.shape[1], dh, rep, window, q_offset, 1.0 / math.sqrt(dh), stream_handle(q),
    )
    LAUNCHES[route] += 1
    return out
