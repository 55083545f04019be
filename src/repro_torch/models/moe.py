"""Mixture-of-Experts FFN (port of repro/models/moe.py): top-k routing with
sort-based dispatch into a fixed (E, C, D) buffer, E-batched expert
matmuls, outputs combined back in token order. Capacity overflow slots are
dropped (the residual carries them); shared experts (DeepSeekMoE) process
every token densely. Returns the Switch-style load-balance auxiliary loss.

Every shape is static and nothing is read back to the host, so the routing
launches no host synchronisation on the card.

Under a placement (dist/sharding.py) the tokens are this rank's rows of a
batch split over ``batch_axes``, and the routing keeps the whole batch's
meaning, as GSPMD does: the capacity comes from the global token count, a
slot's place in its expert's queue counts the slots of the lower-indexed
ranks first (rank-major order is the global stable order), and the aux
loss takes the global f_e and p_e. The experts' weights split over
``model`` by ``ff`` (column / row parallel, one sum over ``model``) or by
``experts`` (each rank runs its experts, their outputs gathered).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..dist import sharding as shard_lib
from . import layers


def capacity(cfg, n_tokens: int) -> int:
    c = int(cfg.capacity_factor * n_tokens * cfg.top_k_experts / cfg.n_experts)
    return max(8, -(-c // 8) * 8)


def route(x, router, k: int):
    """float32 router: -> (probs (T, E), renormalised gates (T, K), selected
    experts (T, K))."""
    probs = torch.softmax(x.float() @ router.float(), dim=-1)
    gate, sel = torch.topk(probs, k, dim=-1)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return probs, gate, sel


def dispatch(sel, n_experts: int, cap: int, before=None):
    """Sort the (token, choice) slots by expert (stable): -> (order, the
    slots' experts in that order, each slot's position in its expert's
    buffer, and which positions are under the capacity). ``before`` (E,):
    slots of each expert queued ahead of these (on lower-indexed ranks)."""
    flat_e = sel.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    starts = torch.searchsorted(sorted_e, torch.arange(n_experts, device=sel.device))
    pos_in_e = torch.arange(flat_e.numel(), device=sel.device) - starts[sorted_e]
    queued = pos_in_e if before is None else pos_in_e + before[sorted_e]
    return order, sorted_e, pos_in_e, queued < cap


def _experts(buf, p, cfg):
    """The E-batched expert FFN of the (E, C, D) buffer, on this rank's
    share of the experts' weights."""
    e, f = cfg.n_experts, cfg.d_ff_expert
    split_e, split_f = p["w_up"].shape[0] != e, p["w_up"].shape[-1] != f
    if split_e:  # each rank its experts, the outputs gathered
        n = p["w_up"].shape[0]
        buf = shard_lib.copy_to(buf).narrow(0, shard_lib.current().index("model") * n, n)
    elif split_f:  # columns of w_gate / w_up, rows of w_down
        buf = shard_lib.copy_to(buf)
    dt = buf.dtype
    if cfg.act == "silu":
        h = F.silu(torch.bmm(buf, p["w_gate"].to(dt))) * torch.bmm(buf, p["w_up"].to(dt))
    else:
        h = F.gelu(torch.bmm(buf, p["w_up"].to(dt)), approximate="tanh")
    y_buf = torch.bmm(h, p["w_down"].to(dt))
    if split_e:
        return shard_lib.gather_from(y_buf, "model", 0)
    return shard_lib.reduce_from(y_buf) if split_f else y_buf


def moe_ffn(x, p, cfg):
    """x: (T, D) -> (y (T, D), aux_loss 0-dim float32)."""
    t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k_experts
    pl = shard_lib.current()
    axes = () if pl is None else pl.batch_axes
    ranks = 1 if pl is None else pl.size(axes)
    t_all = t * ranks  # the batch's tokens over every rank of the batch axes
    cap = capacity(cfg, t_all)
    probs, gate, sel = route(x, p["router"], k)

    # load-balance aux (Switch): E * sum_e f_e * p_e; the counts are exact in float32
    counts = torch.zeros(e, dtype=torch.float32, device=x.device).index_add_(
        0, sel.reshape(-1), torch.ones(t * k, dtype=torch.float32, device=x.device))
    before = None
    if ranks > 1:
        every = pl.all_gather(counts[None], axes, 0)  # (ranks, E), rank-major
        before = every[:pl.index(axes)].sum(0).long()
        counts = every.sum(0)
        p_mean = shard_lib.reduce_from(probs.sum(0), axes) / t_all
    else:
        p_mean = probs.mean(0)
    aux = e * torch.sum(counts / (t_all * k) * p_mean)

    # ---- sort-based dispatch: dropped slots go to a spare row, trimmed ----
    order, sorted_e, pos_in_e, keep = dispatch(sel, e, cap, before)
    buf = x.new_zeros((e, cap + 1, d)).index_put(
        (sorted_e, torch.where(keep, pos_in_e, cap)), x[order // k])[:, :cap]

    # ---- E-batched expert FFN ------------------------------------------
    y_buf = _experts(buf, p, cfg)

    # ---- combine back ---------------------------------------------------
    gathered = torch.where(keep[:, None], y_buf[sorted_e, pos_in_e.clamp(max=cap - 1)], 0.0)
    slot_out = torch.zeros_like(gathered).index_copy(0, order, gathered)
    y = (slot_out.reshape(t, k, d) * gate[..., None].to(x.dtype)).sum(1)

    if cfg.n_shared_experts > 0:
        y = y + layers.placed_mlp(x, p["shared"], cfg.act,
                                  cfg.n_shared_experts * cfg.d_ff_expert)
    return y, aux


def ffn_layer(x, p, cfg, spec):
    """Pre-norm FFN residual block; dispatches dense vs MoE. -> (y, aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if spec.ffn == "none":
        return x, aux
    b, s, d = x.shape
    xn = layers.rms_norm(x, p["norm"], cfg.norm_eps)
    if spec.ffn == "dense":
        return x + layers.placed_mlp(xn, p, cfg.act, cfg.d_ff), aux
    y, aux = moe_ffn(xn.reshape(b * s, d), p, cfg)
    return x + y.reshape(b, s, d), aux
