"""Public ops: the hand-written CUDA kernel on a CUDA tensor, the plain
version on a CPU tensor (port of repro/kernels/ops.py).

``use_kernel`` mirrors the JAX package's ``use_pallas``:

- ``"auto"``  - the CUDA kernel on CUDA tensors, the plain version on CPU ones;
- ``"force"`` - the CUDA kernel; raises on a CPU tensor;
- ``"never"`` - the plain version, on either device (the comparisons of the
  tests and of chip_smoke.py).

On a CUDA tensor there is no fallback: a build or launch failure raises.

``fwht``, ``srht_encode`` and ``srht_decode`` run the FWHT kernel
(csrc/fwht.cu); ``srht_encode_batch``, ``srht_decode_sum``,
``srht_gram_apply`` and ``srht_cg_step`` the fused kernels
(csrc/srht_fused.cu);
``flash_attention`` a flash-attention kernel chosen by dtype, both on the
tensor cores: bf16 the wgmma kernel (csrc/flash_attention_tc.cu), float32
the split-TF32 one (csrc/flash_attention.cu).

The very-sparse projection ops (``sparse_proj_*``) are plain PyTorch on
every device and take no ``use_kernel``: the JAX package pins them to XLA
(no Pallas kernel stands behind them), and a gather, a reduce and a
scatter-add are all they do.

Every call counts its route under ``kernels/dispatch{op,route}`` while the
metrics registry records (``obs.profile.record_dispatch``: ``kernel`` or
``plain``; the sparse ops always ``plain``). On CUDA tensors ``index_add_`` /
``scatter_add_`` add in an unspecified order, so their results are not
bitwise from run to run there.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..obs.profile import record_dispatch
from . import flash_attention as _flash
from . import fwht as _fwht
from . import ref as _ref
from . import srht_fused as _fused

USE_KERNEL = ("auto", "force", "never")


def _use_kernel(op: str, t: torch.Tensor, use_kernel: str) -> bool:
    """The route of one call of ``op``, counted as ``kernels/dispatch``."""
    if use_kernel not in USE_KERNEL:
        raise ValueError(f"use_kernel must be one of {USE_KERNEL}, got {use_kernel!r}")
    if use_kernel == "force" and not t.is_cuda:
        raise RuntimeError(
            f"use_kernel='force' needs a CUDA tensor; the CUDA kernels do not run on {t.device}"
        )
    use = use_kernel != "never" and t.is_cuda
    record_dispatch(op, use)
    return use


def launch_counts() -> dict:
    """Kernel launches since the last ``reset_launch_counts``, by kernel."""
    return {**_fwht.LAUNCHES, **_fused.LAUNCHES, **_flash.LAUNCHES}


def reset_launch_counts() -> None:
    _fwht.LAUNCHES.clear()
    _fused.LAUNCHES.clear()
    _flash.LAUNCHES.clear()


def _fwht_plain(x2: torch.Tensor, signs, scale: float) -> torch.Tensor:
    """The FWHT kernel's function: f32 compute, output in x's dtype."""
    t = x2.float()
    if signs is not None:
        t = t * signs
    out = _ref.fwht_ref(t) * scale
    return out.to(x2.dtype)


def fwht(x: torch.Tensor, *, scale: float = 1.0, use_kernel: str = "auto") -> torch.Tensor:
    """``scale * H_d @ x`` along the last axis; x: (..., d), f32 or bf16."""
    d = x.shape[-1]
    x2 = x.reshape(-1, d)
    if _use_kernel("fwht", x2, use_kernel):
        out = _fwht.fwht_cuda(x2.contiguous(), scale=scale)
    else:
        out = _fwht_plain(x2, None, scale)
    return out.reshape(x.shape)


def srht_encode(x: torch.Tensor, signs: torch.Tensor, rows: torch.Tensor, *,
                use_kernel: str = "auto") -> torch.Tensor:
    """``G x = (1/sqrt(d)) (H (signs * x))[rows]``; x (..., d), signs (d,),
    rows (k,). -> (..., k). The kernel fuses the gather and writes only k
    columns per row."""
    d = x.shape[-1]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, d)
    inv = 1.0 / math.sqrt(d)
    rows = rows.long()
    if _use_kernel("srht_encode", x2, use_kernel):
        out = _fwht.fwht_cuda(x2.contiguous(), signs.float().contiguous(), rows.contiguous(),
                              scale=inv)
    else:
        out = torch.index_select(_fwht_plain(x2, signs, inv), -1, rows)
    return out.reshape(*lead, rows.shape[0])


def srht_decode(u: torch.Tensor, signs: torch.Tensor, rows: torch.Tensor, d: int, *,
                use_kernel: str = "auto") -> torch.Tensor:
    """SRHT adjoint ``G^T u = (1/sqrt(d)) signs * (H scatter_rows(u))``;
    u (..., k) -> (..., d)."""
    k = u.shape[-1]
    lead = u.shape[:-1]
    full = _ref.srht_scatter_ref(u.reshape(-1, k), rows, d)
    inv = 1.0 / math.sqrt(d)
    if _use_kernel("srht_decode", full, use_kernel):
        out = _fwht.fwht_cuda(full, scale=inv) * signs
    else:
        out = _fwht_plain(full, None, inv) * signs
    return out.reshape(*lead, d)


def srht_encode_batch(x: torch.Tensor, signs: torch.Tensor, rows: torch.Tensor, *,
                      use_kernel: str = "auto") -> torch.Tensor:
    """Per-row draws: ``out[r] = (1/sqrt(d)) (H (signs[r] * x[r]))[rows[r]]``.

    x, signs: (..., d); rows: (..., k), leading dims aligned. -> (..., k)"""
    d = x.shape[-1]
    k = rows.shape[-1]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, d)
    s2 = torch.broadcast_to(signs, x.shape).reshape(-1, d)
    r2 = torch.broadcast_to(rows.long(), lead + (k,)).reshape(-1, k)
    inv = 1.0 / math.sqrt(d)
    if _use_kernel("srht_encode_batch", x2, use_kernel):
        out = _fused.fwht_rowsigns_cuda(x2.float().contiguous(), s2.float().contiguous(),
                                        r2.contiguous(), sign_pre=True, scale=inv)
    else:
        t = _ref.fwht_rowsigns_ref(x2, s2, sign_pre=True, scale=inv)
        out = torch.gather(t, -1, r2)
    return out.reshape(*lead, k)


def srht_decode_sum(z: torch.Tensor, signs: torch.Tensor, rows: torch.Tensor, d: int, *,
                    use_kernel: str = "auto") -> torch.Tensor:
    """Client-summed SRHT adjoint ``y_c = sum_i G_i^T z_ic``.

    z: (n, C, k); signs: (n, C|1, d); rows: (n, C|1, k). -> (C, d)"""
    if _use_kernel("srht_decode_sum", z, use_kernel):
        return _fused.srht_decode_sum_cuda(
            z.float().contiguous(), signs.float().contiguous(), rows.long().contiguous(), d,
            scale=1.0 / math.sqrt(d),
        )
    return _ref.srht_decode_sum_ref(z, signs, rows, d)


def _mask(rows: torch.Tensor, d: int, dtype, device) -> torch.Tensor:
    """The 0/1 indicator of each draw's rows, (n, C|1, k) -> (n, C|1, d)."""
    return _ref.srht_scatter_ref(torch.ones(rows.shape, dtype=dtype, device=device), rows, d)


def srht_gram_apply(v: torch.Tensor, signs: torch.Tensor, rows: torch.Tensor, *,
                    use_kernel: str = "auto") -> torch.Tensor:
    """Matrix-free ``S v = sum_i G_i^T G_i v``; v (C, d), signs (n, C|1, d),
    rows (n, C|1, k) the draws' rows. -> (C, d)"""
    d = v.shape[-1]
    if _use_kernel("srht_gram_apply", v, use_kernel):
        return _fused.srht_gram_apply_cuda(
            v.float().contiguous(), signs.float().contiguous(), rows.long().contiguous(),
            scale=1.0 / d,
        )
    return _ref.srht_gram_apply_ref(v, signs, _mask(rows, d, v.dtype, v.device))


def srht_cg_step(x: torch.Tensor, r: torch.Tensor, p: torch.Tensor, rs: torch.Tensor,
                 done: torch.Tensor, c0: torch.Tensor, c1: torch.Tensor, tol2: torch.Tensor,
                 signs: torch.Tensor, rows: torch.Tensor, *, use_kernel: str = "auto") -> None:
    """One iteration of the batched CG for (c0 I + c1 S) x = y, IN PLACE:
    updates x, r, p (C, d) float32, rs (C, 1) float32 and done (C, 1) bool;
    c0, c1: 0-dim or (C,) float32; tol2 (C, 1); signs (n, C|1, d), rows
    (n, C|1, k). Chunks already done keep every bit. The kernel runs the
    whole step (S p and every update) in one launch."""
    if _use_kernel("srht_cg_step", p, use_kernel):
        _fused.srht_cg_step_cuda(x, r, p, rs, done, c0.float(), c1.float(), tol2,
                                 signs.float().contiguous(), rows.long().contiguous(),
                                 scale=1.0 / p.shape[-1])
        return
    new = _ref.srht_cg_step_ref(x, r, p, rs, done, c0, c1, tol2, signs,
                                _mask(rows, p.shape[-1], p.dtype, p.device))
    for dst, src in zip((x, r, p, rs, done), new):
        dst.copy_(src)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, rep: int,
                    window: int = 0, q_offset: int = 0, use_kernel: str = "auto") -> torch.Tensor:
    """Causal GQA flash attention; q (N_q, Sq, dh), k/v (N_kv, Sk, dh), kv
    head = q head // rep, optional sliding ``window``, queries at positions
    ``q_offset + i``. -> (N_q, Sq, dh) in q's dtype.

    On CUDA tensors the route follows the dtype: bf16 runs the wgmma kernel
    (P carried as P_hi + P_lo, two bf16 values, into the P V product),
    float32 the split-TF32 kernel (each float32 operand as two TF32 values,
    three products a pair), and there is no fallback between them or
    to the plain version; any other dtype raises. The kernels pick their own
    tiles, so the Pallas wrapper's q_tile / kv_tile are not taken.

    Neither kernel has a backward, nor has the JAX package's Pallas kernel:
    the kernel route raises NotImplementedError on tensors that require
    grad, rather than return a result that autograd cannot reach q, k and v
    through. The plain version stays differentiable."""
    if _use_kernel("flash_attention", q, use_kernel):
        if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
            raise NotImplementedError(
                "the flash-attention kernels have no backward (ROADMAP A.11): train with "
                "attn_impl='blocked', or take the plain version (use_kernel='never')")
        return _flash.flash_attention_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                                           rep=rep, window=window, q_offset=q_offset)
    return _ref.flash_attention_ref(q, k, v, rep=rep, window=window, q_offset=q_offset)


def srht_rows_matrix(signs: torch.Tensor, rows: torch.Tensor, d: int) -> torch.Tensor:
    """G = (1/sqrt(d)) E H D as a (..., k, d) matrix: row r is
    H[rows[r], :] * signs. signs (..., d), rows (..., k)."""
    h = torch.as_tensor(_ref.hadamard_matrix(d), device=signs.device)
    return (h[rows.long()] * signs[..., None, :]) * (1.0 / np.sqrt(d))


# ------------------------------------------------- very-sparse projection ops
# Shapes as the SparseProj codec (core/estimators/sparse_proj.py) gives them:
# one client's chunks x (C, d) with its draws (1|C, k, nnz), or stacked
# payloads (n, C, k) with stacked draws (n, 1|C, k, nnz). Each client's map is
# applied to its own chunks, never broadcast to (n, C, ...): with shared draws
# the columns index x once, and the client sum runs in client order.


def _sparse_gather(x: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """x (C, d) at one client's columns (1|C, k, nnz). -> (C, k, nnz)"""
    c = x.shape[0]
    k, nnz = cols.shape[-2:]
    if cols.shape[0] == 1:
        t = torch.index_select(x, -1, cols.reshape(-1).long())
    else:
        t = torch.gather(x, -1, cols.reshape(c, k * nnz).long())
    return t.reshape(c, k, nnz)


def _sparse_scatter(z: torch.Tensor, signs: torch.Tensor, cols: torch.Tensor,
                    d: int) -> torch.Tensor:
    """One client's unscaled adjoint: z (C, k), draws (1|C, k, nnz). -> (C, d)"""
    c, k = z.shape
    nnz = cols.shape[-1]
    contrib = (z[..., None] * signs).reshape(c, k * nnz)
    out = torch.zeros((c, d), dtype=contrib.dtype, device=contrib.device)
    if cols.shape[0] == 1:
        return out.index_add_(-1, cols.reshape(-1).long(), contrib)
    return out.scatter_add_(-1, cols.reshape(c, k * nnz).long(), contrib)


def sparse_proj_encode(x: torch.Tensor, signs: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Very-sparse projection encode ``G x`` of one client's chunks, G's rows
    ``nnz`` signed entries of magnitude 1/sqrt(nnz) at the drawn columns.

    x: (C, d); signs, cols: (1|C, k, nnz). -> (C, k)"""
    record_dispatch("sparse_proj_encode", False)
    nnz = cols.shape[-1]
    return (_sparse_gather(x, cols) * signs).sum(-1) * (1.0 / math.sqrt(nnz))


def sparse_proj_adjoint(z: torch.Tensor, signs: torch.Tensor, cols: torch.Tensor,
                        d: int) -> torch.Tensor:
    """Sparse adjoint ``G^T z`` per client (no client sum: the decode's
    pooled R-hat reads each client's).

    z: (C, k) with draws (1|C, k, nnz), or (n, C, k) with (n, 1|C, k, nnz).
    -> (C, d) or (n, C, d)"""
    record_dispatch("sparse_proj_adjoint", False)
    scale = 1.0 / math.sqrt(cols.shape[-1])
    if z.dim() == 2:
        return _sparse_scatter(z, signs, cols, d) * scale
    out = torch.empty(z.shape[:2] + (d,), dtype=z.dtype, device=z.device)
    for i in range(z.shape[0]):
        out[i] = _sparse_scatter(z[i], signs[i], cols[i], d) * scale
    return out


def sparse_proj_gram_apply(v: torch.Tensor, signs: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Matrix-free ``S v = sum_i G_i^T G_i v``, the CG inner apply of the
    SparseProj decode; the client sum in client order.

    v: (C, d); signs, cols: (n, 1|C, k, nnz). -> (C, d)"""
    record_dispatch("sparse_proj_gram_apply", False)
    d = v.shape[-1]
    acc = None
    for i in range(signs.shape[0]):
        z = (_sparse_gather(v, cols[i]) * signs[i]).sum(-1)
        t = _sparse_scatter(z, signs[i], cols[i], d)
        acc = t if acc is None else acc + t
    return acc * (1.0 / cols.shape[-1])
