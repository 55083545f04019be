"""Wrappers of the fused SRHT CUDA kernels (csrc/srht_fused.cu), the Hopper
ports of ``repro/kernels/srht_fused.py``:

``fwht_rowsigns_cuda``   <- ``fwht_rowsigns_pallas``   (per-row-draw encode)
``srht_decode_sum_cuda`` <- ``srht_decode_sum_pallas`` (y = sum_i G_i^T z_i)
``srht_gram_apply_cuda`` <- ``srht_gram_apply_pallas`` (CG inner apply S v)
``srht_cg_step_cuda``    <- the same kernel with one CG iteration fused into
                            its epilogue (the decode's solve runs this one)

Each checks shapes, dtypes and devices, allocates its output (the CG step
updates its state in place) and launches on PyTorch's current stream, with
no fallback. ``LAUNCHES`` counts launches. Unlike the TPU kernels,
``srht_decode_sum_cuda`` takes the (n, C, k) payloads and their rows and
scatters them in shared memory, and the Gram apply and the CG step take the
draws' rows instead of the (n, C|1, d) float mask.
"""
from __future__ import annotations

import collections

import torch

from . import _build
from .fwht import check_cuda, check_width, stream_handle

LAUNCHES: collections.Counter = collections.Counter()
MAX_D = 1 << 14  # two float32 rows in shared memory (128 KB) for K3 and K4


def _f32(name: str, t: torch.Tensor, shape: tuple) -> None:
    if tuple(t.shape) != tuple(shape) or t.dtype != torch.float32:
        raise ValueError(f"{name} must be {tuple(shape)} float32, got {tuple(t.shape)} {t.dtype}")


def _per_chunk(name: str, t: torch.Tensor, n: int, c: int) -> bool:
    """True for a (n, C, w) draw, False for a shared (n, 1, w) one."""
    if t.dim() != 3 or t.shape[0] != n or t.shape[1] not in (1, c):
        raise ValueError(f"{name} must be ({n}, 1 or {c}, w), got {tuple(t.shape)}")
    return t.shape[1] == c and c != 1


def fwht_rowsigns_cuda(x: torch.Tensor, signs: torch.Tensor, rows: torch.Tensor | None = None,
                       *, sign_pre: bool = False, sign_post: bool = False,
                       scale: float = 1.0) -> torch.Tensor:
    """``(scale * [s *] H ([s *] x))[r, rows[r]]`` with x, signs (R, d) float32
    and optional per-row output columns rows (R, k) int64. -> (R, k|d)"""
    if x.dim() != 2:
        raise ValueError(f"x must be (rows, d), got {tuple(x.shape)}")
    n_rows, d = x.shape
    check_width(d)
    if n_rows >= 1 << 31:
        raise ValueError(f"too many rows for one launch: {n_rows}")
    _f32("x", x, (n_rows, d))
    _f32("signs", signs, (n_rows, d))
    tensors = [x, signs]
    k = d
    if rows is not None:
        if rows.dim() != 2 or rows.shape[0] != n_rows or rows.dtype != torch.int64:
            raise ValueError(
                f"rows must be ({n_rows}, k) int64, got {tuple(rows.shape)} {rows.dtype}")
        k = rows.shape[1]
        tensors.append(rows)
    check_cuda(*tensors)
    out = torch.empty((n_rows, k), dtype=torch.float32, device=x.device)
    _build.launch(
        "srht_fused", "fwht_rowsigns_f32", x.data_ptr(), signs.data_ptr(),
        None if rows is None else rows.data_ptr(), out.data_ptr(), n_rows, d, k,
        int(sign_pre), int(sign_post), scale, stream_handle(x),
    )
    LAUNCHES["fwht_rowsigns"] += 1
    return out


def srht_decode_sum_cuda(z: torch.Tensor, signs: torch.Tensor, rows: torch.Tensor, d: int,
                         *, scale: float) -> torch.Tensor:
    """``y_c = sum_i scale * s_i * H scatter(z_ic, rows_i)``.

    z: (n, C, k) float32; signs: (n, C|1, d) float32; rows: (n, C|1, k) int64.
    -> (C, d) float32."""
    if z.dim() != 3:
        raise ValueError(f"z must be (n, C, k), got {tuple(z.shape)}")
    n, c, k = z.shape
    check_width(d)
    if d > MAX_D or c >= 1 << 31:
        raise ValueError(f"srht_decode_sum takes d <= {MAX_D} and C < 2**31, got d={d}, C={c}")
    _f32("z", z, (n, c, k))
    s_pc = _per_chunk("signs", signs, n, c)
    r_pc = _per_chunk("rows", rows, n, c)
    _f32("signs", signs, (n, signs.shape[1], d))
    if rows.shape[2] != k or rows.dtype != torch.int64:
        raise ValueError(
            f"rows must be ({n}, 1|{c}, {k}) int64, got {tuple(rows.shape)} {rows.dtype}")
    check_cuda(z, signs, rows)
    out = torch.empty((c, d), dtype=torch.float32, device=z.device)
    _build.launch(
        "srht_fused", "srht_decode_sum_f32", z.data_ptr(), rows.data_ptr(), signs.data_ptr(),
        out.data_ptr(), n, c, d, k, int(r_pc), int(s_pc), scale, stream_handle(z),
    )
    LAUNCHES["srht_decode_sum"] += 1
    return out


def _draws(v: torch.Tensor, signs: torch.Tensor, rows: torch.Tensor) -> tuple:
    """Checks v (C, d) float32 against its draws; -> (C, d, n, k, signs per
    chunk, rows per chunk)."""
    if v.dim() != 2:
        raise ValueError(f"v must be (C, d), got {tuple(v.shape)}")
    c, d = v.shape
    check_width(d)
    if d > MAX_D or c >= 1 << 31:
        raise ValueError(f"the Gram apply takes d <= {MAX_D} and C < 2**31, got d={d}, C={c}")
    n = signs.shape[0] if signs.dim() == 3 else -1
    _f32("v", v, (c, d))
    s_pc = _per_chunk("signs", signs, n, c)
    _f32("signs", signs, (n, signs.shape[1], d))
    r_pc = _per_chunk("rows", rows, n, c)
    if rows.dtype != torch.int64:
        raise ValueError(f"rows must be int64, got {rows.dtype}")
    return c, d, n, rows.shape[2], s_pc, r_pc


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it when its data is not 16-byte aligned (the K4
    kernels read v and the signs 16 bytes at a time)."""
    return t.clone() if t.data_ptr() % 16 else t


def srht_gram_apply_cuda(v: torch.Tensor, signs: torch.Tensor, rows: torch.Tensor, *,
                         scale: float) -> torch.Tensor:
    """``S v = sum_i scale * s_i * H (m_i * H (s_i * v))``, m_i the 0/1
    indicator of rows_i.

    v: (C, d) float32; signs: (n, C|1, d) float32; rows: (n, C|1, k) int64.
    -> (C, d) float32."""
    c, d, n, k, s_pc, r_pc = _draws(v, signs, rows)
    check_cuda(v, signs, rows)
    v, signs = _aligned16(v), _aligned16(signs)
    out = torch.empty((c, d), dtype=torch.float32, device=v.device)
    _build.launch(
        "srht_fused", "srht_gram_apply_f32", v.data_ptr(), signs.data_ptr(), rows.data_ptr(),
        out.data_ptr(), n, c, d, k, int(s_pc), int(r_pc), scale, stream_handle(v),
    )
    LAUNCHES["srht_gram_apply"] += 1
    return out


def _scalar_or_per_chunk(name: str, t: torch.Tensor, c: int) -> bool:
    """True for a (C,) float32 tensor, False for a 0-dim one."""
    if t.dtype != torch.float32 or tuple(t.shape) not in ((), (c,)) or not t.is_contiguous():
        raise ValueError(f"{name} must be 0-dim or ({c},) float32, got {tuple(t.shape)} {t.dtype}")
    return t.dim() == 1


def srht_cg_step_cuda(x: torch.Tensor, r: torch.Tensor, p: torch.Tensor, rs: torch.Tensor,
                      done: torch.Tensor, c0: torch.Tensor, c1: torch.Tensor,
                      tol2: torch.Tensor, signs: torch.Tensor, rows: torch.Tensor, *,
                      scale: float) -> None:
    """One CG iteration for (c0 I + c1 S) x = y in one launch, in place.

    x, r, p: (C, d) float32, contiguous and 16-byte aligned, updated in place;
    rs: (C, 1) float32 and done: (C, 1) bool, updated in place; tol2: (C, 1)
    float32; c0, c1: 0-dim or (C,) float32; signs, rows as for
    ``srht_gram_apply_cuda``. Chunks already done are not written."""
    c, d, n, k, s_pc, r_pc = _draws(p, signs, rows)
    for name, t in (("x", x), ("r", r), ("p", p)):
        _f32(name, t, (c, d))
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    for name, t in (("rs", rs), ("tol2", tol2)):
        _f32(name, t, (c, 1))
    if tuple(done.shape) != (c, 1) or done.dtype != torch.bool:
        raise ValueError(f"done must be ({c}, 1) bool, got {tuple(done.shape)} {done.dtype}")
    c0_pc = _scalar_or_per_chunk("c0", c0, c)
    c1_pc = _scalar_or_per_chunk("c1", c1, c)
    check_cuda(x, r, p, rs, done, c0, c1, tol2, signs, rows)
    signs = _aligned16(signs)
    _build.launch(
        "srht_fused", "srht_cg_step_f32", x.data_ptr(), r.data_ptr(), p.data_ptr(),
        rs.data_ptr(), done.data_ptr(), c0.data_ptr(), c1.data_ptr(), tol2.data_ptr(),
        signs.data_ptr(), rows.data_ptr(), n, c, d, k, int(c0_pc), int(c1_pc), int(s_pc),
        int(r_pc), scale, stream_handle(p),
    )
    LAUNCHES["srht_cg_step"] += 1
