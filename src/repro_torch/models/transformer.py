"""Config -> model (port of repro/models/transformer.py): parameter
definitions, init, forward, prefill and decode for every config: attention
and Mamba (SSD) layers, dense and routed MoE FFNs.

``param_defs(cfg)`` is the one structural source of truth, a tree of
ParamDef with the JAX package's layout: the repeated block's weights are
stacked on a leading "layers" axis under ``blocks``, the irregular layers sit
in the ``prologue`` / ``epilogue`` tuples, so the two packages' trees compare
leaf by leaf (``interop.params_from_numpy`` carries one across).

``backbone`` runs the stacked blocks in a Python loop; it computes what the
JAX scan computes. Under autograd, ``remat="block"`` runs each block
through ``torch.utils.checkpoint`` (its activations recomputed in the
backward, as ``jax.checkpoint`` of the scan body does), which changes no
number. ``force_unroll`` is a cost-calibration knob of the JAX package and
changes nothing here. ``act_sharding.constrain`` is called where the JAX
package calls it (each block, the embedding, the head). ``loss_fn`` is the
training loss. Caches are updated in place (models/attention.py,
models/mamba.py).

Placed parameters (ROADMAP A.9.2). Under an installed
``dist.sharding.Placement`` the parameters are this rank's ``model``
shards (whole over ``data``: the steps gather the FSDP shards before
use) and the batch is this rank's rows. The embedding and the head split
by vocab (a lookup summed over ``model``; logits gathered over it), every
layer kind computes on its ``model`` shard (attention.py, layers.py,
moe.py, mamba.py), and the loss divides by the whole batch's label
count.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from .. import resolve_device
from ..core import chunking
from ..core import random as prand
from ..dist import sharding as shard_lib
from . import act_sharding, attention, layers, mamba, moe
from .common import LayerSpec, ModelConfig


class ParamDef(NamedTuple):
    shape: tuple
    axes: tuple       # logical axis names, len == len(shape)
    init: str = "normal"   # normal | zeros | ones | scaled | a_log | dt_bias
    scale: float = 0.02


def map_defs(fn, tree):
    """``tree`` with every ParamDef leaf replaced by ``fn(leaf)``."""
    if isinstance(tree, ParamDef):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_defs(fn, v) for k, v in tree.items()}
    return tuple(map_defs(fn, v) for v in tree)


def def_leaves(tree) -> list:
    """The ParamDef leaves of ``tree``."""
    out = []
    map_defs(out.append, tree)
    return out


# --------------------------------------------------------------- definitions


def _attn_defs(cfg: ModelConfig):
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    out = {
        "norm": ParamDef((d,), (None,), "ones"),
        "wq": ParamDef((d, h * dh), ("embed", "heads")),
        "wk": ParamDef((d, kv * dh), ("embed", "heads")),
        "wv": ParamDef((d, kv * dh), ("embed", "heads")),
        "wo": ParamDef((h * dh, d), ("heads", "embed"), "scaled"),
    }
    if cfg.qkv_bias:
        out["bq"] = ParamDef((h * dh,), ("heads",), "zeros")
        out["bk"] = ParamDef((kv * dh,), ("heads",), "zeros")
        out["bv"] = ParamDef((kv * dh,), ("heads",), "zeros")
    return out


def _dense_ffn_defs(cfg: ModelConfig, d_ff: int):
    d = cfg.d_model
    out = {
        "norm": ParamDef((d,), (None,), "ones"),
        "w_up": ParamDef((d, d_ff), ("embed", "ff")),
        "w_down": ParamDef((d_ff, d), ("ff", "embed"), "scaled"),
    }
    if cfg.act == "silu":
        out["w_gate"] = ParamDef((d, d_ff), ("embed", "ff"))
    return out


def _moe_defs(cfg: ModelConfig):
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    out = {
        "norm": ParamDef((d,), (None,), "ones"),
        "router": ParamDef((d, e), ("embed", None)),
        "w_gate": ParamDef((e, d, f), ("experts", "embed", "ff")),
        "w_up": ParamDef((e, d, f), ("experts", "embed", "ff")),
        "w_down": ParamDef((e, f, d), ("experts", "ff", "embed"), "scaled"),
    }
    if cfg.n_shared_experts > 0:
        fs = cfg.n_shared_experts * f
        shared = {
            "w_up": ParamDef((d, fs), ("embed", "ff")),
            "w_down": ParamDef((fs, d), ("ff", "embed"), "scaled"),
        }
        if cfg.act == "silu":
            shared["w_gate"] = ParamDef((d, fs), ("embed", "ff"))
        out["shared"] = shared
    return out


def _mamba_defs(cfg: ModelConfig):
    d, di = cfg.d_model, cfg.mamba_d_inner
    nh, conv_dim = cfg.mamba_heads, cfg.mamba_conv_dim
    p_in = 2 * di + 2 * cfg.mamba_ngroups * cfg.d_state + nh
    if cfg.mamba_split_proj:
        proj = {
            "in_z": ParamDef((d, di), ("embed", "mamba_inner")),
            "in_x": ParamDef((d, di), ("embed", "mamba_inner")),
            "in_bc": ParamDef((d, 2 * cfg.mamba_ngroups * cfg.d_state), ("embed", None)),
            "in_dt": ParamDef((d, nh), ("embed", None)),
        }
    else:
        proj = {"in_proj": ParamDef((d, p_in), ("embed", "mamba_inner"))}
    return {
        "norm": ParamDef((d,), (None,), "ones"),
        **proj,
        "conv_w": ParamDef((conv_dim, cfg.d_conv), ("mamba_inner", None)),
        "conv_b": ParamDef((conv_dim,), ("mamba_inner",), "zeros"),
        "dt_bias": ParamDef((nh,), (None,), "dt_bias"),
        "a_log": ParamDef((nh,), (None,), "a_log"),
        "d_skip": ParamDef((nh,), (None,), "ones"),
        "out_norm": ParamDef((di,), ("mamba_inner",), "ones"),
        "out_proj": ParamDef((di, d), ("mamba_inner", "embed"), "scaled"),
    }


def _layer_defs(cfg: ModelConfig, spec: LayerSpec):
    out = {}
    if spec.kind == "attn":
        out["attn"] = _attn_defs(cfg)
    else:
        out["mamba"] = _mamba_defs(cfg)
    if spec.ffn == "dense":
        out["ffn"] = _dense_ffn_defs(cfg, cfg.d_ff)
    elif spec.ffn == "moe":
        out["ffn"] = _moe_defs(cfg)
    return out


def _stack_def(defn: ParamDef, n: int) -> ParamDef:
    return ParamDef((n,) + defn.shape, ("layers",) + defn.axes, defn.init, defn.scale)


def param_defs(cfg: ModelConfig):
    vp, d = cfg.vocab_padded, cfg.d_model
    tree = {
        "embed": ParamDef((vp, d), ("vocab", "embed")),
        "final_norm": ParamDef((d,), (None,), "ones"),
        "prologue": tuple(_layer_defs(cfg, s) for s in cfg.prologue),
        "epilogue": tuple(_layer_defs(cfg, s) for s in cfg.epilogue),
    }
    if cfg.n_blocks > 0:
        block = {f"l{i:02d}": _layer_defs(cfg, s) for i, s in enumerate(cfg.block_pattern)}
        tree["blocks"] = map_defs(lambda pd: _stack_def(pd, cfg.n_blocks), block)
    else:
        tree["blocks"] = {}
    if not cfg.tie_embeddings:
        tree["lm_head"] = ParamDef((d, vp), ("embed", "vocab"))
    return tree


# --------------------------------------------------------------------- init


def _init_leaf(defn: ParamDef, key: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    dev = key.device
    if defn.init == "zeros":
        return torch.zeros(defn.shape, dtype=dtype, device=dev)
    if defn.init == "ones":
        return torch.ones(defn.shape, dtype=dtype, device=dev)
    if defn.init == "a_log":
        base = torch.log(torch.linspace(1.0, 16.0, defn.shape[-1], device=dev))
        return torch.broadcast_to(base, defn.shape).to(dtype).clone()
    if defn.init == "dt_bias":
        dt = torch.exp(torch.linspace(math.log(1e-3), math.log(1e-1), defn.shape[-1], device=dev))
        return torch.broadcast_to(torch.log(torch.expm1(dt)), defn.shape).to(dtype).clone()
    scale = defn.scale
    if defn.init == "scaled":
        scale = defn.scale / max(1.0, (2.0 * 24.0) ** 0.5)  # residual-branch damping
    return prand.normal(key, defn.shape).mul_(scale).to(dtype)


def _n_defs(tree) -> int:
    return len(def_leaves(tree))


def init_params(cfg: ModelConfig, key, device=None, shardings=None):
    """Random parameters with the JAX package's recipes (normal * scale,
    damped residual outputs, ones, zeros) from ``key`` (a core.random key or
    an integer seed) on ``device`` (the key's, or the card when None), as
    the JAX package draws them: ``split(key, leaves)``, one key a leaf in
    its tree-flatten order (dict keys sorted), so the weights are the JAX
    package's within the ``normal`` draw's few float32 ulp.

    ``shardings`` (``dist.sharding.param_shardings``): each leaf is drawn
    whole and cut to this rank's shard at once, so no more than one whole
    leaf is ever held."""
    if device is None and isinstance(key, torch.Tensor):
        device = key.device
    defs = param_defs(cfg)
    keys = iter(prand.split(prand.as_key(key, resolve_device(device)), _n_defs(defs)))
    pl = None
    if shardings is not None:
        pl = shard_lib.Placement(chunking.tree_leaves(shardings)[0].mesh)

    def build(tree, sh):  # in the order of jax.tree.flatten: dict keys sorted
        if isinstance(tree, ParamDef):
            leaf = _init_leaf(tree, next(keys), cfg.params_dtype)
            return leaf if sh is None else pl.local(leaf, sh.spec)
        if isinstance(tree, dict):
            return {k: build(tree[k], None if sh is None else sh[k]) for k in sorted(tree)}
        return tuple(build(v, None if sh is None else sh[i]) for i, v in enumerate(tree))

    return build(defs, shardings)


def abstract_params(cfg: ModelConfig):
    """The parameter tree's shapes and dtype without storage: meta tensors
    (``jax.eval_shape(init_params)``'s counterpart)."""
    return map_defs(lambda d: torch.empty(d.shape, dtype=cfg.params_dtype, device="meta"),
                    param_defs(cfg))


def param_axes(cfg: ModelConfig):
    """Each parameter's logical axis names, in the parameter tree's layout."""
    return map_defs(lambda d: d.axes, param_defs(cfg))


# ------------------------------------------------------------------ forward


def _run_layer(cfg, spec, p, x, aux, positions, cache, use_kernel):
    mix = None if cache is None else cache["mix"]
    if spec.kind == "attn":
        x, _ = attention.attn_layer(x, p["attn"], cfg, spec, positions=positions, cache=mix,
                                    use_kernel=use_kernel)
    else:
        x, _ = mamba.mamba_layer(x, p["mamba"], cfg, cache=mix)
    if spec.ffn != "none":
        x, a = moe.ffn_layer(x, p["ffn"], cfg, spec)
        aux = aux + a
    return x, aux


def _index(tree, i: int):
    """Leaf ``i`` of every stacked leaf of ``tree`` (views, not copies)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _unstack(tree, n: int) -> list:
    """The ``n`` per-block trees of a stacked tree: one ``torch.unbind`` a
    leaf (views). Its backward stacks the blocks' gradients once; indexing
    one block at a time would add a zero-filled full-size gradient a block."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return list(torch.unbind(tree, 0))


def _run_block(cfg, p_block, x, aux, positions, c_block, use_kernel):
    """One repeat of ``cfg.block_pattern``. -> (x, aux)."""
    x = act_sharding.constrain(x)
    for i, spec in enumerate(cfg.block_pattern):
        key = f"l{i:02d}"
        x, aux = _run_layer(cfg, spec, p_block[key], x, aux, positions,
                            None if c_block is None else c_block[key], use_kernel)
    return x, aux


def backbone(params, cfg: ModelConfig, x, positions, cache=None, use_kernel: str = "auto"):
    """Run all layers. x: (B, S, D). Returns (x, aux, cache), the cache
    updated in place (None without one). Without a cache and under autograd,
    ``cfg.remat == "block"`` recomputes each block's activations in the
    backward."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, spec in enumerate(cfg.prologue):
        x, aux = _run_layer(cfg, spec, params["prologue"][i], x, aux, positions,
                            None if cache is None else cache["prologue"][i], use_kernel)
    remat = cfg.remat == "block" and cache is None and torch.is_grad_enabled()
    for b, p_block in enumerate(_unstack(params["blocks"], cfg.n_blocks)):
        c_block = None if cache is None else _index(cache["blocks"], b)
        if remat:
            x, aux = torch.utils.checkpoint.checkpoint(
                _run_block, cfg, p_block, x, aux, positions, None, use_kernel,
                use_reentrant=False)
        else:
            x, aux = _run_block(cfg, p_block, x, aux, positions, c_block, use_kernel)
    for i, spec in enumerate(cfg.epilogue):
        x, aux = _run_layer(cfg, spec, params["epilogue"][i], x, aux, positions,
                            None if cache is None else cache["epilogue"][i], use_kernel)
    return x, aux, cache


def embed_inputs(params, cfg: ModelConfig, inputs):
    """The (B, S, D) activations of ``inputs``: the table's rows of the
    tokens (a vocab shard's rows summed over ``model`` where the placement
    splits the vocab), or the embeddings, in the compute dtype."""
    if cfg.input_mode != "tokens":
        return act_sharding.constrain(inputs.to(cfg.compute_dtype))
    table = params["embed"]
    if table.shape[0] == cfg.vocab_padded:
        x = layers.embed_tokens(inputs, table, cfg.compute_dtype)
    else:  # this rank's vocab rows; the others' tokens add zeros
        local = inputs.long() - shard_lib.current().index("model") * table.shape[0]
        hit = (local >= 0) & (local < table.shape[0])
        rows = F.embedding(torch.where(hit, local, 0), table)
        x = shard_lib.reduce_from(torch.where(hit[..., None], rows, 0.0)).to(cfg.compute_dtype)
    return act_sharding.constrain(x)


def logits_fn(params, cfg: ModelConfig, x):
    """Final norm and the vocab projection in the compute dtype (the tied
    embedding's transpose when ``tie_embeddings``); float32 logits over the
    padded vocab (each rank's vocab columns gathered over ``model`` where
    the placement splits them)."""
    x = act_sharding.constrain(x)
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    if w.shape[-1] == cfg.vocab_padded:
        return (x @ w.to(x.dtype)).float()
    logits = (shard_lib.copy_to(x) @ w.to(x.dtype)).float()
    return shard_lib.gather_from(logits, "model", -1)


def _positions(inputs) -> torch.Tensor:
    b, s = inputs.shape[0], inputs.shape[1]
    return torch.arange(s, dtype=torch.int32, device=inputs.device).expand(b, s)


def forward(params, cfg: ModelConfig, inputs, positions=None, use_kernel: str = "auto"):
    """Train/prefill forward. inputs: (B, S) tokens or (B, S, D) embeds.
    -> (logits (B, S, vocab_padded) float32, aux)."""
    if positions is None:
        positions = _positions(inputs)
    x = embed_inputs(params, cfg, inputs)
    x, aux, _ = backbone(params, cfg, x, positions, use_kernel=use_kernel)
    return logits_fn(params, cfg, x), aux


def loss_fn(params, cfg: ModelConfig, batch):
    """Next-token CE (+ router aux). batch: {"inputs", "labels"}; labels < 0
    are ignored. -> (loss, {"ce", "aux"}), 0-dim float32."""
    logits, aux = forward(params, cfg, batch["inputs"])
    return cross_entropy_loss(cfg, logits, batch["labels"], aux)


def cross_entropy_loss(cfg: ModelConfig, logits, labels, aux):
    """``loss_fn``'s loss from its logits: the mean next-token CE over the
    labels >= 0, plus the router aux loss. -> (loss, {"ce", "aux"}).

    Under a placement whose batch axes split the rows, the mean divides by
    the whole batch's label count: ``loss`` is this rank's share of the
    whole loss (the shares' gradients sum to its gradient) and the metrics
    carry the whole batch's ce and loss (``"loss"``)."""
    labels = labels.long()
    valid = labels >= 0
    labels_safe = torch.where(valid, labels, 0)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels_safe[..., None])[..., 0]
    pl = shard_lib.current()
    split = pl is not None and pl.size(pl.batch_axes) > 1
    n_valid = pl.all_reduce(valid.sum(), pl.batch_axes) if split else valid.sum()
    denom = torch.clamp(n_valid, min=1)
    total = torch.where(valid, nll, 0.0).sum()
    ce = total / denom
    loss = ce + cfg.router_aux_weight * aux
    if not split:
        return loss, {"ce": ce, "aux": aux}
    ce_all = pl.all_reduce(total.detach(), pl.batch_axes) / denom
    return loss, {"ce": ce_all, "aux": aux,
                  "loss": ce_all + cfg.router_aux_weight * aux.detach()}


# ------------------------------------------------------------------- decode


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype=None, device=None):
    """Empty cache in the JAX package's layout (blocks stacked): an
    attention layer's KV zeros with every position -1, a Mamba layer's conv
    history and float32 SSM state zeros; ``device="meta"`` gives the shapes
    alone."""
    dtype = dtype or cfg.compute_dtype

    def one(spec: LayerSpec):
        if spec.kind != "attn":
            return {"mix": mamba.init_mamba_cache(cfg, batch, dtype, device)}
        return {"mix": attention.init_attn_cache(cfg, spec, batch, seq_len, dtype, device)}

    cache = {
        "prologue": tuple(one(s) for s in cfg.prologue),
        "epilogue": tuple(one(s) for s in cfg.epilogue),
    }
    if cfg.n_blocks > 0:
        block = {f"l{i:02d}": one(s) for i, s in enumerate(cfg.block_pattern)}
        cache["blocks"] = {
            key: {"mix": {name: t.unsqueeze(0).repeat((cfg.n_blocks,) + (1,) * t.dim())
                          for name, t in layer["mix"].items()}}
            for key, layer in block.items()
        }
    else:
        cache["blocks"] = {}
    return cache


def decode_step(params, cfg: ModelConfig, cache, inputs, positions):
    """One-token decode. inputs: (B, 1) tokens or (B, 1, D); positions: (B, 1).

    Returns (logits (B, 1, vocab_padded) float32, cache), the cache updated
    in place."""
    x = embed_inputs(params, cfg, inputs)
    x, _, cache = backbone(params, cfg, x, positions, cache)
    return logits_fn(params, cfg, x), cache


def prefill(params, cfg: ModelConfig, cache, inputs, use_kernel: str = "auto"):
    """Prefill the cache (in place) from a full prompt; logits for the LAST
    position only (no (B, S, vocab) tensor at long prompts)."""
    positions = _positions(inputs)
    x = embed_inputs(params, cfg, inputs)
    x, _, cache = backbone(params, cfg, x, positions, cache, use_kernel=use_kernel)
    return logits_fn(params, cfg, x[:, -1:]), cache
