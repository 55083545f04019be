"""Carry the JAX package's state into the port, through numpy.

The estimator's state is the per-client maps of a round and the eigenvalue
bank behind beta. On core.random's threefry the port draws the JAX
package's own maps and bank from the same seed; a comparison that holds
one part alone carries the JAX draws and bank across instead, as numpy
arrays:

- ``draws_from_numpy`` takes the ``_fused_draws`` layout of
  repro.core.estimators.rand_proj_spatial, one form a projection: srht
  signs (n, 1|C, d) and rows (n, 1|C, k); rows alone (Rand-k's indices,
  the subsample projection); gauss g (n, 1|C, k, d); and sparse_proj's
  signs and cols (n, 1|C, k, nnz). Rows and cols become int64;
- ``bank_from_numpy`` takes the (trials, nk) bank of repro.core.beta;
- ``tree_from_numpy`` takes a tree (dicts, lists, tuples) of arrays;
- ``params_from_numpy`` takes a model's ``init_params`` tree and
  ``cache_from_numpy`` its KV cache, each checked leaf by leaf against the
  port's own layout (the stacked ``blocks``, the ``prologue`` / ``epilogue``
  tuples), so the two packages' models compare leaf by leaf;
- ``train_state_from_numpy`` takes a train state (``init_train_state`` or
  a train step's): the optimizer's moments checked as parameters are, its
  step, and the error-feedback residuals ``ef`` when present.
"""
from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .core import chunking
from .models import transformer


_DRAW_FORMS = {  # names -> (dtype, ndim) of each array
    ("rows", "signs"): {"signs": (np.float32, 3), "rows": (np.int64, 3)},
    ("rows",): {"rows": (np.int64, 3)},
    ("g",): {"g": (np.float32, 4)},
    ("cols", "signs"): {"signs": (np.float32, 4), "cols": (np.int64, 4)},
}


def draws_from_numpy(draws: dict, device=None) -> dict:
    """Draw arrays -> tensors on ``device``: srht {"signs" (n, 1|C, d),
    "rows" (n, 1|C, k)}, {"rows"} alone, gauss {"g" (n, 1|C, k, d)}, or
    sparse_proj {"signs", "cols" (n, 1|C, k, nnz)}."""
    dev = resolve_device(device)
    form = _DRAW_FORMS.get(tuple(sorted(draws)))
    if form is None:
        raise ValueError(f"draws must hold {[list(f) for f in _DRAW_FORMS]}, got {sorted(draws)}")
    arrs = {name: np.array(draws[name], dtype=dtype) for name, (dtype, _) in form.items()}
    lead = {a.shape[:2] for a in arrs.values()}
    # sparse_proj's signs and cols are one (k, nnz) grid a draw
    same = "cols" not in arrs or arrs["cols"].shape == arrs["signs"].shape
    if any(a.ndim != form[name][1] for name, a in arrs.items()) or len(lead) != 1 or not same:
        want = ", ".join(f"{name} of {ndim} dims" for name, (_, ndim) in form.items())
        if "cols" in arrs:
            want += " of one shape (n, 1|C, k, nnz)"
        raise ValueError(f"draws must be {want}, all led by (n, 1|C), got "
                         f"{ {name: a.shape for name, a in arrs.items()} }")
    return {name: torch.from_numpy(a).to(dev) for name, a in arrs.items()}


def bank_from_numpy(eigs) -> torch.Tensor:
    """(trials, nk) eigenvalue bank -> float32 CPU tensor (beta moves it)."""
    eigs = np.array(eigs, dtype=np.float32)
    if eigs.ndim != 2:
        raise ValueError(f"an eigenvalue bank is (trials, nk), got {eigs.shape}")
    return torch.from_numpy(eigs)


def tree_from_numpy(tree, device=None):
    """A tree of arrays -> the same tree of tensors on ``device``."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_from_numpy(v, dev) for v in tree)
    return torch.from_numpy(np.array(tree)).to(dev)


def _checked(tree, like, dtype_of, dev, path="") -> object:
    """``tree``'s arrays as tensors on ``dev``, laid out as ``like``; raises
    ValueError where a key, a length or a leaf's shape differs."""
    if isinstance(like, dict):
        if not isinstance(tree, dict) or set(tree) != set(like):
            got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
            raise ValueError(f"{path or 'tree'}: keys {got} != {sorted(like)}")
        return {k: _checked(tree[k], like[k], dtype_of, dev, f"{path}/{k}") for k in like}
    if isinstance(like, tuple) and not isinstance(like, transformer.ParamDef):
        if not isinstance(tree, (tuple, list)) or len(tree) != len(like):
            raise ValueError(f"{path}: expected a sequence of {len(like)} layers")
        return tuple(_checked(t, lk, dtype_of, dev, f"{path}/{i}")
                     for i, (t, lk) in enumerate(zip(tree, like)))
    shape = tuple(like.shape)
    arr = np.asarray(tree)
    if arr.shape != shape:
        raise ValueError(f"{path}: shape {arr.shape} != the port's {shape}")
    # floats (bfloat16 included) pass through float32, which holds them exactly
    arr = arr.astype(np.float32) if arr.dtype.kind not in "iub" else np.array(arr)
    return torch.from_numpy(arr).to(device=dev, dtype=dtype_of(like))


def params_from_numpy(cfg, tree, device=None) -> dict:
    """The JAX package's ``init_params(cfg, key)`` tree, with numpy leaves
    (any float dtype), as the port's parameters in ``cfg.params_dtype``."""
    return _checked(tree, transformer.param_defs(cfg), lambda _: cfg.params_dtype,
                    resolve_device(device))


def cache_from_numpy(cfg, tree, batch: int, seq_len: int, device=None) -> dict:
    """The JAX package's ``init_cache(cfg, batch, seq_len)`` layout, with
    numpy leaves, as the port's cache (k, v in the compute dtype, pos int32)."""
    like = transformer.init_cache(cfg, batch, seq_len, device="meta")
    return _checked(tree, like, lambda t: t.dtype, resolve_device(device))


def train_state_from_numpy(cfg, state, device=None) -> dict:
    """The JAX package's train state for ``cfg``, with numpy leaves:
    {"opt": {"step", and "mu", "nu" (AdamW) or "m" (SGDM with momentum)},
    "ef" (n, C, d_block) when the pipeline has error feedback}. -> the
    port's: moments float32 in ``param_defs``' layout, step an int32
    0-dim tensor, ef float32 with C the parameter count's chunks of d_block."""
    dev = resolve_device(device)
    if not isinstance(state, dict) or "opt" not in state or not set(state) <= {"opt", "ef"}:
        got = sorted(state) if isinstance(state, dict) else type(state).__name__
        raise ValueError(f"a train state is {{'opt'[, 'ef']}}, got {got}")
    if "step" not in state["opt"]:
        raise ValueError(f"opt: no 'step' among {sorted(state['opt'])}")
    defs = transformer.param_defs(cfg)
    opt = {}
    for name, leaf in state["opt"].items():
        if name != "step":
            opt[name] = _checked(leaf, defs, lambda _: torch.float32, dev, f"opt/{name}")
            continue
        step = np.asarray(leaf)
        if step.shape != () or step.dtype.kind not in "iu":
            raise ValueError(f"opt/step: an integer scalar, got {step.dtype} {step.shape}")
        opt[name] = torch.tensor(int(step), dtype=torch.int32, device=dev)
    out = {"opt": opt}
    if "ef" in state:
        ef = np.asarray(state["ef"])
        if ef.ndim != 3 or ef.shape[1] != chunking.num_chunks(cfg.n_params(), ef.shape[2]):
            raise ValueError(f"ef: (n, C, d_block) with C = ceil({cfg.n_params()} / d_block), "
                             f"got {ef.shape}")
        out["ef"] = torch.from_numpy(ef.astype(np.float32)).to(dev)
    return out
