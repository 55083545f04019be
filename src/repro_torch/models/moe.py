"""Mixture-of-Experts FFN (port of repro/models/moe.py): top-k routing with
sort-based dispatch into a fixed (E, C, D) buffer, E-batched expert
matmuls, outputs combined back in token order. Capacity overflow slots are
dropped (the residual carries them); shared experts (DeepSeekMoE) process
every token densely. Returns the Switch-style load-balance auxiliary loss.

Every shape is static and nothing is read back to the host, so the routing
launches no host synchronisation on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

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


def dispatch(sel, n_experts: int, cap: int):
    """Sort the (token, choice) slots by expert (stable): -> (order, the
    slots' experts in that order, each slot's position in its expert's
    buffer, and which positions are under the capacity)."""
    flat_e = sel.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    starts = torch.searchsorted(sorted_e, torch.arange(n_experts, device=sel.device))
    pos_in_e = torch.arange(flat_e.numel(), device=sel.device) - starts[sorted_e]
    return order, sorted_e, pos_in_e, pos_in_e < cap


def moe_ffn(x, p, cfg):
    """x: (T, D) -> (y (T, D), aux_loss 0-dim float32)."""
    t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k_experts
    cap = capacity(cfg, t)
    probs, gate, sel = route(x, p["router"], k)

    # load-balance aux (Switch): E * sum_e f_e * p_e; the counts are exact in float32
    counts = torch.zeros(e, dtype=torch.float32, device=x.device).index_add_(
        0, sel.reshape(-1), torch.ones(t * k, dtype=torch.float32, device=x.device))
    aux = e * torch.sum(counts / (t * k) * probs.mean(0))

    # ---- sort-based dispatch: dropped slots go to a spare row, trimmed ----
    order, sorted_e, pos_in_e, keep = dispatch(sel, e, cap)
    buf = x.new_zeros((e, cap + 1, d)).index_put(
        (sorted_e, torch.where(keep, pos_in_e, cap)), x[order // k])[:, :cap]

    # ---- E-batched expert FFN ------------------------------------------
    if cfg.act == "silu":
        h = F.silu(torch.bmm(buf, p["w_gate"].to(x.dtype))) * torch.bmm(buf, p["w_up"].to(x.dtype))
    else:
        h = F.gelu(torch.bmm(buf, p["w_up"].to(x.dtype)), approximate="tanh")
    y_buf = torch.bmm(h, p["w_down"].to(x.dtype))

    # ---- combine back ---------------------------------------------------
    gathered = torch.where(keep[:, None], y_buf[sorted_e, pos_in_e.clamp(max=cap - 1)], 0.0)
    slot_out = torch.zeros_like(gathered).index_copy(0, order, gathered)
    y = (slot_out.reshape(t, k, d) * gate[..., None].to(x.dtype)).sum(1)

    if cfg.n_shared_experts > 0:
        y = y + layers.mlp(x, p["shared"], cfg.act)
    return y, aux


def ffn_layer(x, p, cfg, spec):
    """Pre-norm FFN residual block; dispatches dense vs MoE. -> (y, aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if spec.ffn == "none":
        return x, aux
    b, s, d = x.shape
    xn = layers.rms_norm(x, p["norm"], cfg.norm_eps)
    if spec.ffn == "dense":
        return x + layers.mlp(xn, p, cfg.act), aux
    y, aux = moe_ffn(xn.reshape(b * s, d), p, cfg)
    return x + y.reshape(b, s, d), aux
