"""Plain PyTorch versions of the kernels (port of repro/kernels/ref.py).

They are the correctness contract of the CUDA kernels: each kernel computes
the same function with the same operations in the same order, so on the
golden grid of small integers (every partial sum exact in float32) kernel and
plain version agree bit for bit. The scale is an explicit multiply AFTER the
transform, where the fused kernels apply it.

``flash_attention_ref`` is the flash-attention kernel's plain version; it
materialises the (N_q, Sq, Sk) scores and agrees with the kernel to float
tolerance, not bitwise (the kernel's online softmax sums in another order).

The wrappers in ``kernels.ops`` run these on CPU tensors, and on CUDA tensors
only when asked with ``use_kernel="never"``.
"""
from __future__ import annotations

import numpy as np
import torch


def hadamard_matrix(d: int, dtype=np.float32) -> np.ndarray:
    """Sylvester-ordered Hadamard matrix H_d with +-1 entries (d = 2**m)."""
    if d & (d - 1) != 0 or d < 1:
        raise ValueError(f"d must be a power of two, got {d}")
    h = np.array([[1.0]], dtype=np.float64)
    while h.shape[0] < d:
        h = np.block([[h, h], [h, -h]])
    return h.astype(dtype)


def fwht_ref(x: torch.Tensor) -> torch.Tensor:
    """Unnormalised Walsh-Hadamard transform ``H_d @ x`` along the last axis,
    by the log2(d)-stage Sylvester-order butterfly, in x's dtype."""
    d = x.shape[-1]
    if d & (d - 1) != 0:
        raise ValueError(f"last dim must be a power of two, got {d}")
    lead = x.shape[:-1]
    h = 1
    while h < d:
        x = x.reshape(*lead, d // (2 * h), 2, h)
        a = x[..., 0, :]
        b = x[..., 1, :]
        x = torch.stack([a + b, a - b], dim=-2).reshape(*lead, d)
        h *= 2
    return x


def srht_encode_ref(x: torch.Tensor, signs: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``(1/sqrt(d)) (H (signs * x))[rows]``; x (..., d), signs (d,), rows (k,)."""
    d = x.shape[-1]
    t = fwht_ref(x * signs) * (1.0 / np.sqrt(d))
    return torch.index_select(t, -1, rows.long())


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, rep: int,
                        window: int = 0, q_offset: int = 0) -> torch.Tensor:
    """Causal GQA attention over absolute positions, in float32.

    q: (N_q, Sq, dh); k, v: (N_kv, Sk, dh); N_q = N_kv * rep, kv head = q
    head // rep. Query i sits at position q_offset + i and attends to key j
    when j <= q_offset + i (and q_offset + i - j < window when window > 0).
    -> (N_q, Sq, dh) in q's dtype."""
    sq, dh = q.shape[1], q.shape[2]
    k = torch.repeat_interleave(k, rep, dim=0)
    v = torch.repeat_interleave(v, rep, dim=0)
    sk = k.shape[1]
    s = torch.einsum("nqd,nkd->nqk", q.float(), k.float()) / np.sqrt(dh)
    q_pos = q_offset + torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(sk, device=q.device)[None, :]
    mask = k_pos <= q_pos
    if window > 0:
        mask &= q_pos - k_pos < window
    s = torch.where(mask[None], s, -1e9)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("nqk,nkd->nqd", p, v.float()).to(q.dtype)


def srht_scatter_ref(z: torch.Tensor, rows: torch.Tensor, d: int) -> torch.Tensor:
    """``out[..., rows[..., j]] = z[..., j]``; rows broadcastable to z. -> (..., d)"""
    rows = torch.broadcast_to(rows.long(), z.shape)
    full = torch.zeros(z.shape[:-1] + (d,), dtype=z.dtype, device=z.device)
    return full.scatter_(-1, rows, z)


def srht_decode_ref(u: torch.Tensor, signs: torch.Tensor, rows: torch.Tensor,
                    d: int) -> torch.Tensor:
    """SRHT adjoint ``G^T u = (1/sqrt(d)) signs * (H scatter_rows(u))``;
    u (..., k), signs (d,), rows (k,). -> (..., d)"""
    return fwht_ref(srht_scatter_ref(u, rows, d)) * (signs * (1.0 / np.sqrt(d)))


def fwht_rowsigns_ref(
    x: torch.Tensor,
    signs: torch.Tensor | None,
    *,
    sign_pre: bool = False,
    sign_post: bool = False,
    scale: float = 1.0,
) -> torch.Tensor:
    """``scale * [signs *] H ([signs *] x)`` with one sign diagonal per row."""
    t = x * signs if sign_pre else x
    t = fwht_ref(t)
    if sign_post:
        t = t * signs
    if scale != 1.0:
        t = t * scale
    return t


def srht_encode_batch_ref(x: torch.Tensor, signs: torch.Tensor,
                          rows: torch.Tensor) -> torch.Tensor:
    """Per-row draws: ``(1/sqrt(d)) (H (signs * x))[rows]`` row for row.

    x, signs: (..., d); rows: (..., k), leading dims aligned."""
    d = x.shape[-1]
    t = fwht_rowsigns_ref(x, signs, sign_pre=True, scale=1.0 / np.sqrt(d))
    return torch.gather(t, -1, rows.long())


def client_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum over the leading (client) axis in client order, as the kernels do."""
    acc = t[0]
    for i in range(1, t.shape[0]):
        acc = acc + t[i]
    return acc


def srht_decode_sum_ref(z: torch.Tensor, signs: torch.Tensor, rows: torch.Tensor,
                        d: int) -> torch.Tensor:
    """``y = sum_i G_i^T z_i`` per chunk; z (n, C, k), signs (n, C|1, d),
    rows (n, C|1, k). -> (C, d)"""
    full = srht_scatter_ref(z, rows, d)
    out = fwht_rowsigns_ref(full, signs, sign_post=True, scale=1.0 / np.sqrt(d))
    return client_sum(out)


def srht_gram_apply_ref(v: torch.Tensor, signs: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
    """Matrix-free ``S v = (1/d) sum_i signs_i * H (mask_i * H (signs_i * v))``.

    v: (C, d); signs, mask: (n, C|1, d). -> (C, d)"""
    d = v.shape[-1]
    t = fwht_rowsigns_ref(v[None], signs, sign_pre=True)
    t = fwht_rowsigns_ref(mask * t, signs, sign_post=True, scale=1.0 / d)
    return client_sum(t)


def row_dot_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``sum_j a[..., j] * b[..., j]`` in a fixed order, keepdim: multiply,
    then halve ``t = t[..., :h] + t[..., h:]`` until one column is left. The
    CG step kernel reduces its rows in this order. Width a power of two."""
    t = a * b
    d = t.shape[-1]
    if d & (d - 1) != 0:
        raise ValueError(f"last dim must be a power of two, got {d}")
    while t.shape[-1] > 1:
        h = t.shape[-1] // 2
        t = t[..., :h] + t[..., h:]
    return t


def srht_cg_step_ref(x, r, p, rs, done, c0, c1, tol2, signs, mask, *,
                     gram_apply=srht_gram_apply_ref, dot=row_dot_ref) -> tuple:
    """One iteration of the batched CG for ((c0) I + (c1) S) x = y, one
    system per chunk, S v = ``gram_apply(v, signs, mask)``, row dot
    products by ``dot``.

    x, r, p: (C, d); rs, tol2: (C, 1); done: (C, 1) bool; c0, c1: 0-dim or
    (C,); signs, mask: (n, C|1, d). Chunks already done keep every bit (each
    update is a ``where(done, old, new)``). -> new (x, r, p, rs, done)"""
    def col(v):
        return v if v.dim() == 0 else v[:, None]

    zero = torch.zeros((), dtype=p.dtype, device=p.device)
    one = torch.ones((), dtype=p.dtype, device=p.device)
    ap = col(c0) * p + col(c1) * gram_apply(p, signs, mask)
    pap = dot(p, ap)
    alpha = torch.where(done, zero, rs / torch.where(pap > 0, pap, one))
    x2 = torch.where(done, x, x + alpha * p)
    r2 = torch.where(done, r, r - alpha * ap)
    rs2 = torch.where(done, rs, dot(r2, r2))
    done2 = done | (rs2 <= tol2)
    bet = torch.where(done2, zero, rs2 / torch.where(rs > 0, rs, one))
    p2 = torch.where(done2, p, r2 + bet * p)
    return x2, r2, p2, rs2, done2


# ---------------------------------------------- very-sparse projection oracles
# A row of G holds ``nnz`` signed entries at drawn columns, so the encode is a
# gather and reduce, the adjoint a scatter-add and the Gram apply the two
# composed. The 1/sqrt(nnz) and 1/nnz scales are applied by kernels.ops as
# post-multiplies, as in the JAX package. Columns are drawn with replacement
# and may repeat within a row: the scatter-ADD merges every repeat.


def sparse_encode_ref(x: torch.Tensor, signs: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Unscaled ``out[..., r] = sum_t signs[..., r, t] * x[..., cols[..., r, t]]``.

    x: (..., d); signs, cols: (..., k, nnz), leading dims broadcast. -> (..., k)"""
    lead = np.broadcast_shapes(x.shape[:-1], cols.shape[:-2], signs.shape[:-2])
    k, nnz = cols.shape[-2:]
    xb = torch.broadcast_to(x, lead + x.shape[-1:])
    cb = torch.broadcast_to(cols.long(), lead + (k, nnz)).reshape(*lead, k * nnz)
    t = torch.gather(xb, -1, cb).reshape(*lead, k, nnz)
    return (t * signs).sum(-1)


def sparse_scatter_add_ref(z: torch.Tensor, signs: torch.Tensor, cols: torch.Tensor,
                           d: int) -> torch.Tensor:
    """Unscaled adjoint ``out[..., cols[..., r, t]] += signs[..., r, t] * z[..., r]``.

    z: (..., k); signs, cols: (..., k, nnz), leading dims broadcast. -> (..., d)"""
    contrib = z[..., None] * signs
    lead = contrib.shape[:-2]
    m = contrib.shape[-2] * contrib.shape[-1]
    cf = torch.broadcast_to(cols.long(), contrib.shape).reshape(*lead, m)
    full = torch.zeros(lead + (d,), dtype=contrib.dtype, device=contrib.device)
    return full.scatter_add_(-1, cf, contrib.reshape(*lead, m))


def sparse_gram_apply_ref(v: torch.Tensor, signs: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Unscaled matrix-free ``sum_i G_i^T G_i v``, the client sum in client
    order. v: (C, d); signs, cols: (n, C|1, k, nnz). -> (C, d)"""
    z = sparse_encode_ref(v[None], signs, cols)
    return client_sum(sparse_scatter_add_ref(z, signs, cols, v.shape[-1]))
