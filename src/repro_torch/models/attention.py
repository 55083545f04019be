"""GQA attention (port of repro/models/attention.py): kv-blocked online
softmax or the flash-attention kernel for prefill, dense for single-token
decode. Causal masking, sliding windows, QKV bias and ring-buffer KV caches
with explicit stored positions.

The cache is updated IN PLACE: ``attn_layer`` writes the new keys, values and
positions into the tensors of the cache it is given and returns that same
dict, where the JAX package returns fresh arrays.

Under a placement whose ``model`` axis splits the heads (dist/sharding.py:
``wq``/``wk``/``wv`` by columns, ``wo`` by rows) a rank attends over its
own heads (through the flash kernel at prefill) and one sum over ``model``
follows ``wo``, where GSPMD puts it. Where the kv heads do not divide over
``model`` (h * dh may divide while the heads do not), the split weights
are gathered first and the layer runs whole on every rank, as GSPMD's
gather before use does; the cache's kv heads are then whole too
(``cache_shardings``).
"""
from __future__ import annotations

import math

import torch

from ..dist import sharding as shard_lib
from ..kernels import ops
from . import layers

_NEG = -1e9


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor, window: int) -> torch.Tensor:
    """(B, Sq, Sk) bool. k_pos = -1 marks invalid (unfilled cache) slots."""
    q = q_pos[:, :, None]
    k = k_pos[:, None, :]
    m = (k <= q) & (k >= 0)
    if window > 0:
        m &= q - k < window
    return m


def attention_dense(q, k, v, q_pos, k_pos, window: int) -> torch.Tensor:
    """One-shot attention (decode / short sequences).

    q: (B, Sq, H, dh); k, v: (B, Sk, KV, dh); *_pos: (B, S*) int. The scores
    are float32 (JAX's preferred_element_type); the probabilities are cast
    to v's dtype before the PV product, as in the JAX package."""
    b, sq, h, dh = q.shape
    kvh = k.shape[2]
    rep = h // kvh
    qr = q.reshape(b, sq, kvh, rep, dh)
    s = torch.einsum("bqgrd,bkgd->bqgrk", qr.float(), k.float())
    s = s / math.sqrt(dh)
    m = _mask(q_pos, k_pos, window)[:, :, None, None, :]
    s = torch.where(m, s, _NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bqgrk,bkgd->bqgrd", p.to(v.dtype), v)
    return o.reshape(b, sq, h, dh)


def attention_blocked(q, k, v, q_pos, k_pos, window: int, kv_block: int) -> torch.Tensor:
    """Online softmax over kv blocks (plain flash attention); a Python loop
    over the blocks where the JAX package scans them. P stays float32."""
    b, sq, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    rep = h // kvh
    qr = q.reshape(b, sq, kvh, rep, dh).float()
    kb = min(kv_block, sk)
    nb = -(-sk // kb)
    pad = nb * kb - sk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = torch.nn.functional.pad(k_pos, (0, pad), value=-1)
    scale = 1.0 / math.sqrt(dh)
    m = torch.full((b, sq, kvh, rep), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, sq, kvh, rep), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, sq, kvh, rep, dh), dtype=torch.float32, device=q.device)
    for i in range(nb):
        kb_ = k[:, i * kb:(i + 1) * kb].float()
        vb_ = v[:, i * kb:(i + 1) * kb].float()
        msk = _mask(q_pos, k_pos[:, i * kb:(i + 1) * kb], window)[:, :, None, None, :]
        s = torch.einsum("bqgrd,bkgd->bqgrk", qr, kb_) * scale
        s = torch.where(msk, s, _NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        p = torch.where(msk, p, 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bqgrk,bkgd->bqgrd", p, vb_)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, sq, h, dh).to(q.dtype)


_HEAD_DIM = {"wq": -1, "wk": -1, "wv": -1, "bq": -1, "bk": -1, "bv": -1, "wo": 0}


def placed_heads(p, cfg) -> tuple:
    """-> (p, heads, kv heads, tp): the layer's weights and the heads this
    rank computes. ``tp``: the weights are split by whole heads over
    ``model`` (the kv heads divide), so the rank computes its own; else any
    split weight is gathered and the heads are all of them."""
    h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    whole = {"wq": h * dh, "bq": h * dh, "wo": h * dh}
    split = [n for n, dim in _HEAD_DIM.items()
             if n in p and p[n].shape[dim] != whole.get(n, kvh * dh)]
    if not split:
        return p, h, kvh, False
    m = shard_lib.model_size()
    if kvh % m == 0 and len(split) == sum(n in p for n in _HEAD_DIM):
        return p, h // m, kvh // m, True
    p = dict(p)
    for n in split:
        p[n] = shard_lib.gather_from(p[n], "model", _HEAD_DIM[n])
    return p, h, kvh, False


def attn_layer(x, p, cfg, spec, *, positions, cache=None, use_kernel: str = "auto"):
    """Full attention layer (pre-norm, residual). Returns (y, cache).

    Prefill: attends causally within x (through the flash-attention kernel
    when ``cfg.attn_impl == "flash"``; ``use_kernel`` as in kernels.ops) and,
    with a cache, writes the last S_alloc tokens at slot pos % S_alloc.
    Decode: x is (B, 1, D); the new k, v and position go to slot
    pos % S_alloc of each row (a ring buffer when windowed), then dense
    attention over the cache. The cache is updated in place.
    """
    b, s, _ = x.shape
    p, h, kvh, tp = placed_heads(p, cfg)
    dh = cfg.d_head
    xn = layers.rms_norm(x, p["norm"], cfg.norm_eps)
    if tp:
        xn = shard_lib.copy_to(xn)
    q = layers.dense(xn, p["wq"], p.get("bq")).reshape(b, s, h, dh)
    k = layers.dense(xn, p["wk"], p.get("bk")).reshape(b, s, kvh, dh)
    v = layers.dense(xn, p["wv"], p.get("bv")).reshape(b, s, kvh, dh)
    q = layers.rope(q, positions, cfg.rope_theta)
    k = layers.rope(k, positions, cfg.rope_theta)
    if cfg.gqa_repeat_kv and kvh < h and cache is None:
        k = torch.repeat_interleave(k, h // kvh, dim=2)
        v = torch.repeat_interleave(v, h // kvh, dim=2)
        kvh = h

    if cache is None or s > 1:
        if cfg.attn_impl == "flash":
            # positions assumed contiguous from 0 in every row, as in the JAX package
            qf = q.transpose(1, 2).reshape(b * h, s, dh)
            kf = k.transpose(1, 2).reshape(b * kvh, s, dh)
            vf = v.transpose(1, 2).reshape(b * kvh, s, dh)
            of = ops.flash_attention(qf, kf, vf, rep=h // kvh, window=spec.window,
                                     use_kernel=use_kernel)
            o = of.reshape(b, h, s, dh).transpose(1, 2)
        elif s > cfg.attn_kv_block:
            o = attention_blocked(q, k, v, positions, positions, spec.window, cfg.attn_kv_block)
        else:
            o = attention_dense(q, k, v, positions, positions, spec.window)
        if cache is not None:
            s_alloc = cache["k"].shape[1]
            sa = min(s, s_alloc)
            tail_pos = positions[:, s - sa:]
            idx = (tail_pos % s_alloc).long()  # (B, sa)
            rows = torch.arange(b, device=x.device)[:, None]
            cache["k"][rows, idx] = k[:, s - sa:].to(cache["k"].dtype)
            cache["v"][rows, idx] = v[:, s - sa:].to(cache["v"].dtype)
            cache["pos"][rows, idx] = tail_pos.to(cache["pos"].dtype)
    else:
        s_alloc = cache["k"].shape[1]
        slot = (positions[:, 0] % s_alloc).long()  # (B,)
        rows = torch.arange(b, device=x.device)
        cache["k"][rows, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][rows, slot] = v[:, 0].to(cache["v"].dtype)
        cache["pos"][rows, slot] = positions[:, 0].to(cache["pos"].dtype)
        o = attention_dense(q, cache["k"], cache["v"], positions, cache["pos"], spec.window)

    y = layers.dense(o.reshape(b, s, h * dh), p["wo"])
    if tp:
        y = shard_lib.reduce_from(y)
    return x + y, cache


def init_attn_cache(cfg, spec, batch: int, seq_len: int, dtype: torch.dtype, device=None) -> dict:
    """Empty cache for one attention layer (ring-buffered when windowed)."""
    s_alloc = min(seq_len, spec.window) if spec.window > 0 else seq_len
    kvh, dh = cfg.n_kv_heads, cfg.d_head
    return {
        "k": torch.zeros((batch, s_alloc, kvh, dh), dtype=dtype, device=device),
        "v": torch.zeros((batch, s_alloc, kvh, dh), dtype=dtype, device=device),
        "pos": torch.full((batch, s_alloc), -1, dtype=torch.int32, device=device),
    }
