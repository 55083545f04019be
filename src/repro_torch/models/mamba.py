"""Mamba2 (SSD, state-space duality) block (port of repro/models/mamba.py).

Training and prefill use the chunked SSD algorithm (arXiv:2405.21060):
within a chunk the recurrence is a decay-masked attention-like product,
across chunks a Python loop carries the (heads, state, headdim) state in
float32 where the JAX package scans. Decode is the O(1) recurrence.

Layout: in_proj -> [z (gate), x, B, C, dt]; a short causal depthwise conv
over (x, B, C); SSD; gated RMSNorm; out_proj. Jamba's Mamba-1 layers are
realised with this SSD block, as in the JAX package.

One departure from the reference: the intra-chunk decay exponentiates the
causally MASKED exponent, exp(where(mask, cs_q - cs_k, -inf)). The
reference exponentiates the whole (q, q) square and masks after; above the
diagonal the exponent is +sum |A| dt over the chunk, which overflows float32
at the published chunk (256) and the init's A and dt, and its backward then
multiplies a zero cotangent by inf. Both give the same forward; only this
one has a finite gradient there.

The cache is updated IN PLACE: the new conv history and SSM state are
copied into the tensors of the cache ``mamba_layer`` is given.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..dist import sharding as shard_lib
from . import layers


def _conv_taps(hist, w, b):
    """SiLU of the causal depthwise conv, float32, over a history that holds
    the K - 1 inputs before the first output: hist (B, S + K - 1, C) ->
    (B, S, C); w (C, K), tap j on input t - (K - 1) + j (no flip, as XLA's
    cross-correlation). One product and add a tap, in tap order."""
    k = w.shape[-1]
    s = hist.shape[1] - (k - 1)
    wf = w.float()
    out = hist[:, 0:s] * wf[:, 0]
    for j in range(1, k):
        out = out + hist[:, j:j + s] * wf[:, j]
    return F.silu(out + b.float())


def _conv_train(xbc, w, b):
    """Causal depthwise conv along seq. xbc: (B, S, C); w: (C, K)."""
    hist = F.pad(xbc.float(), (0, 0, w.shape[-1] - 1, 0))
    return _conv_taps(hist, w, b).to(xbc.dtype)


def ssd_chunked(x, dt, a_log, bb, cc, dd, chunk: int):
    """Chunked SSD scan.

    x:  (B, L, H, P)   inputs per head
    dt: (B, L, H)      positive step sizes (post-softplus)
    a_log: (H,)        log(-A)
    bb, cc: (B, L, H, N)  input/output projections (groups pre-broadcast)
    dd: (H,)           skip
    -> (y (B, L, H, P) float32, h_final (B, H, N, P) float32)
    """
    b, l, h, p = x.shape
    n = bb.shape[-1]
    q = min(chunk, l)
    nc = -(-l // q)
    pad = nc * q - l
    if pad:  # dt = 0 on the padding: those steps neither decay nor add to the state
        x, dt, bb, cc = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in (x, dt, bb, cc))

    f32 = torch.float32
    xr = x.reshape(b, nc, q, h, p).to(f32)
    dtr = dt.reshape(b, nc, q, h).to(f32)
    br = bb.reshape(b, nc, q, h, n).to(f32)
    cr = cc.reshape(b, nc, q, h, n).to(f32)

    da = -torch.exp(a_log.to(f32)) * dtr  # (b, nc, q, h) log-decay per step
    cs = torch.cumsum(da, dim=2)  # inclusive cumsum
    xdt = xr * dtr[..., None]

    # intra-chunk: y_q += C_q . sum_{k<=q} exp(cs_q - cs_k) dt_k B_k x_k,
    # the exponent masked to -inf above the diagonal before the exp
    csh = cs.transpose(2, 3)  # (b, nc, h, q)
    mask = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(torch.where(mask, csh[..., :, None] - csh[..., None, :], -torch.inf))
    scores = torch.einsum("bcqhn,bckhn->bchqk", cr, br) * decay
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", scores, xdt)

    # chunk-end states: S_c = sum_k exp(cs_Q - cs_k) B_k (dt_k x_k)^T
    end_decay = torch.exp(cs[:, :, -1:, :] - cs)  # (b, nc, q, h)
    states = torch.einsum("bckhn,bckhp->bchnp", br * end_decay[..., None], xdt)
    total = torch.exp(cs[:, :, -1, :])  # (b, nc, h) chunk total decay

    # across chunks: h_{c+1} = h_c * total_c + S_c, keeping each chunk's START state
    state = torch.zeros((b, h, n, p), dtype=f32, device=x.device)
    starts = []
    for c in range(nc):
        starts.append(state)
        state = state * total[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(starts, dim=1)  # (b, nc, h, n, p)

    y_inter = torch.einsum("bcqhn,bchnp->bcqhp", cr * torch.exp(cs)[..., None], h_prev)
    y = (y_intra + y_inter).reshape(b, nc * q, h, p)[:, :l]
    y = y + x.reshape(b, nc * q, h, p)[:, :l].to(f32) * dd.to(f32)[None, None, :, None]
    return y, state


_INNER = {"in_proj": -1, "in_z": -1, "in_x": -1, "conv_w": 0, "conv_b": 0,
          "out_norm": 0, "out_proj": 0}  # the "mamba_inner" dim of each weight
_SHARED = ("in_proj", "conv_w", "conv_b", "in_bc", "in_dt", "dt_bias", "a_log", "d_skip")


def _inner_width(cfg, name: str) -> int:
    di = cfg.mamba_d_inner
    return {"in_proj": 2 * di + 2 * cfg.mamba_ngroups * cfg.d_state + cfg.mamba_heads,
            "conv_w": cfg.mamba_conv_dim, "conv_b": cfg.mamba_conv_dim}.get(name, di)


def placed_heads(p, cfg) -> tuple:
    """-> (p, first head, heads, tp): the layer's weights and the SSD heads
    this rank computes.

    ``tp``: the placement splits ``mamba_inner`` over ``model`` and the
    heads divide, so the rank computes its own heads (z and x columns,
    their conv channels, dt and the state) and one sum over ``model``
    follows ``out_proj``. The fused ``in_proj`` ([z, x, B, C, dt]) and the
    conv over x|B|C split across their parts' boundaries, so they are
    gathered and the rank takes its columns; a weight every rank reads
    whole inside the split region enters it by ``copy_to``. Otherwise any
    split weight is gathered and the layer runs whole."""
    nh = cfg.mamba_heads
    split = {n for n, dim in _INNER.items() if n in p and p[n].shape[dim] != _inner_width(cfg, n)}
    if not split:
        return p, 0, nh, False
    m = shard_lib.model_size()
    p = dict(p)
    own = {"out_norm", "out_proj"} | ({"in_z", "in_x"} if "in_z" in p else set())
    if nh % m or not own <= split:
        for n in split:
            p[n] = shard_lib.gather_from(p[n], "model", _INNER[n])
        return p, 0, nh, False
    for n in _SHARED:
        if n in p:
            w = shard_lib.gather_from(p[n], "model", _INNER[n]) if n in split else p[n]
            p[n] = shard_lib.copy_to(w)
    return p, shard_lib.current().index("model") * (nh // m), nh // m, True


def _x_channels(cfg, h0: int, nh: int) -> torch.Tensor:
    """The conv channels of heads [h0, h0 + nh): their x, then all of B|C."""
    hd, di = cfg.mamba_headdim, cfg.mamba_d_inner
    return torch.cat([torch.arange(h0 * hd, (h0 + nh) * hd),
                      torch.arange(di, cfg.mamba_conv_dim)])


def _proj_columns(cfg, h0: int, nh: int) -> torch.Tensor:
    """The fused in_proj columns of heads [h0, h0 + nh): z, x, B|C, dt."""
    hd, di = cfg.mamba_headdim, cfg.mamba_d_inner
    gn2 = 2 * cfg.mamba_ngroups * cfg.d_state
    z = torch.arange(h0 * hd, (h0 + nh) * hd)
    return torch.cat([z, di + z, torch.arange(2 * di, 2 * di + gn2),
                      torch.arange(2 * di + gn2 + h0, 2 * di + gn2 + h0 + nh)])


def _conv_history(cache, cfg, rows):
    """The cached conv inputs in the layer's channels (``rows`` of the
    whole x|B|C, or all of them when None), gathered over ``model`` where
    the cache splits them."""
    conv = cache["conv"]
    if conv.shape[-1] != cfg.mamba_conv_dim:
        conv = shard_lib.current().all_gather(conv, "model", -1)
    return conv if rows is None else conv[..., rows.to(conv.device)]


def _store_conv(cache, hist, cfg, x_width: int, tp: bool) -> None:
    """Write the layer's new conv history (its channels) to the cache: the
    x channels of every rank's heads gathered first under ``tp``, and this
    rank's share of the channels kept where the cache splits them."""
    pl = shard_lib.current()
    if tp:
        x_all = pl.all_gather(hist[..., :x_width].contiguous(), "model", -1)
        hist = torch.cat([x_all, hist[..., x_width:]], dim=-1)
    w = cache["conv"].shape[-1]
    if w != cfg.mamba_conv_dim:
        hist = hist.narrow(-1, pl.index("model") * w, w)
    cache["conv"].copy_(hist)


def _split_norm(x, weight, eps: float, width: int):
    """``layers.rms_norm`` of a row split over ``model``: the mean square
    summed over the ranks (each rank then scales its own part)."""
    xf = x.float()
    var = shard_lib.psum(torch.sum(xf * xf, dim=-1, keepdim=True)) / width
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def mamba_layer(x, p, cfg, *, cache=None):
    """Mamba2 block with residual. Returns (y, cache), the cache updated in
    place (None without one).

    cache = {"conv": (B, K-1, convdim), "ssm": (B, H, N, P)}: with s > 1 a
    prefill from an empty cache, with s == 1 one decode step. Under a
    placement the rank computes the heads ``placed_heads`` gives it; the
    cache holds those heads' state and its share of the conv channels
    (``dist.sharding.cache_shardings``).
    """
    b, s, _ = x.shape
    hd, g, n = cfg.mamba_headdim, cfg.mamba_ngroups, cfg.d_state
    p, h0, nh, tp = placed_heads(p, cfg)
    hs, di = slice(h0, h0 + nh), nh * hd
    rows = _x_channels(cfg, h0, nh) if tp else None
    xn = layers.rms_norm(x, p["norm"], cfg.norm_eps)
    if tp:
        xn = shard_lib.copy_to(xn)
    if cfg.mamba_split_proj:
        z = layers.dense(xn, p["in_z"])
        xi = layers.dense(xn, p["in_x"])
        bb, cc = torch.chunk(layers.dense(xn, p["in_bc"]), 2, dim=-1)
        dt = layers.dense(xn, p["in_dt"][:, hs] if tp else p["in_dt"])
    else:
        w = p["in_proj"][:, _proj_columns(cfg, h0, nh).to(x.device)] if tp else p["in_proj"]
        z, xi, bb, cc, dt = torch.split(layers.dense(xn, w), [di, di, g * n, g * n, nh], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"][hs].float())
    conv_w, conv_b = p["conv_w"], p["conv_b"]
    if tp:
        conv_w, conv_b = conv_w[rows.to(x.device)], conv_b[rows.to(x.device)]
    a_log, d_skip = p["a_log"][hs], p["d_skip"][hs]

    xbc = torch.cat([xi, bb, cc], dim=-1)  # (B, S, convdim)
    if cache is None or s > 1:
        xbc_act = _conv_train(xbc, conv_w, conv_b)
        xi, bb, cc = torch.split(xbc_act, [di, g * n, g * n], dim=-1)
        xh = xi.reshape(b, s, nh, hd)
        bh = torch.repeat_interleave(bb.reshape(b, s, g, n), cfg.mamba_heads // g, dim=2)[:, :, hs]
        ch = torch.repeat_interleave(cc.reshape(b, s, g, n), cfg.mamba_heads // g, dim=2)[:, :, hs]
        y, h_final = ssd_chunked(xh, dt, a_log, bh, ch, d_skip, cfg.mamba_chunk)
        if cache is not None:
            # prefill: conv history = last (K-1) PRE-activation inputs
            kconv = conv_w.shape[-1]
            hist = torch.cat([_conv_history(cache, cfg, rows), xbc], dim=1)[:, -(kconv - 1):]
            _store_conv(cache, hist, cfg, di, tp)
            cache["ssm"].copy_(h_final)
    else:
        # ---- O(1) recurrent decode (s == 1) -----------------------------
        hist = torch.cat([_conv_history(cache, cfg, rows), xbc], dim=1)  # (B, K, convdim)
        xbc1 = _conv_taps(hist.float(), conv_w, conv_b)[:, 0].to(x.dtype)
        xi, bb, cc = torch.split(xbc1, [di, g * n, g * n], dim=-1)
        xh = xi.reshape(b, nh, hd)
        bh = torch.repeat_interleave(bb.reshape(b, g, n), cfg.mamba_heads // g, dim=1)[:, hs]
        ch = torch.repeat_interleave(cc.reshape(b, g, n), cfg.mamba_heads // g, dim=1)[:, hs]
        dt1 = dt[:, 0]  # (B, H)
        da = torch.exp(-torch.exp(a_log.float()) * dt1)  # (B, H)
        upd = torch.einsum("bhn,bhp->bhnp", bh.float(), xh.float() * dt1[..., None])
        ssm = cache["ssm"] * da[..., None, None] + upd
        y = torch.einsum("bhn,bhnp->bhp", ch.float(), ssm)
        y = y + xh.float() * d_skip.float()[None, :, None]
        y = y[:, None]  # (B, 1, H, P)
        _store_conv(cache, hist[:, 1:], cfg, di, tp)
        cache["ssm"].copy_(ssm)

    yv = y.reshape(b, s, di).to(x.dtype)
    if tp:
        yf = _split_norm(yv, p["out_norm"], cfg.norm_eps, cfg.mamba_d_inner)
    else:
        yf = layers.rms_norm(yv, p["out_norm"], cfg.norm_eps)
    out = layers.dense(yf * F.silu(z), p["out_proj"])
    if tp:
        out = shard_lib.reduce_from(out)
    return x + out, cache


def init_mamba_cache(cfg, batch: int, dtype: torch.dtype, device=None) -> dict:
    """Empty cache for one Mamba layer: the conv history in ``dtype``, the
    SSM state in float32."""
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, cfg.mamba_conv_dim), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, cfg.mamba_heads, cfg.d_state, cfg.mamba_headdim),
                           dtype=torch.float32, device=device),
    }
