"""Fault-tolerant checkpointing: atomic, sharded, async, keep-N, resumable
(port of repro/train/checkpoint.py).

Layout (one directory per step):
    <dir>/step_000120.tmp_<nonce>/   -> written, then atomically renamed;
    <dir>/step_000120/                  readers only ever see complete
        meta.json                       checkpoints.
        shard_00000.npz                 leaves partitioned into ~512MB shards
        ...

- The tree's structure (its leaf paths) and each leaf's shape and dtype
  travel in meta.json; arrays in npz shards, so a checkpoint restores on
  another device than it was written from. The JAX package writes its meta
  with msgpack and carries bf16 through ml_dtypes; the port needs neither:
  JSON for the meta, and a bf16 leaf stored as its raw 16-bit patterns
  (torch's bit view) and viewed back on restore.
- ``AsyncCheckpointer.save_async`` copies every leaf to the host before it
  returns and serializes on a background thread, so the train loop goes on
  and may change its tensors without touching the snapshot.
- ``latest_step`` / ``restore`` skip corrupt/partial directories (crash-safe).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import uuid

import numpy as np
import torch

from ..core import chunking

_SHARD_BYTES = 512 << 20
_STEP_RE = re.compile(r"^step_(\d+)$")
_META = "meta.json"

# npz can't hold these; they round-trip through bit-equal integer views
_BIT_VIEWS = {torch.bfloat16: torch.int16, torch.float8_e4m3fn: torch.uint8,
              torch.float8_e5m2: torch.uint8}
_DTYPE_NAMES = {str(dt).removeprefix("torch."): dt for dt in (
    torch.float32, torch.float64, torch.float16, torch.int64, torch.int32, torch.int16,
    torch.int8, torch.uint8, torch.bool, *_BIT_VIEWS)}


def _to_host(leaf) -> tuple:
    """A tensor (any device) or array -> (numpy array npz can hold, a copy;
    dtype name)."""
    t = torch.as_tensor(leaf).detach()
    name = str(t.dtype).removeprefix("torch.")
    if name not in _DTYPE_NAMES:
        raise TypeError(f"cannot checkpoint a {t.dtype} leaf")
    if t.dtype in _BIT_VIEWS:
        t = t.view(_BIT_VIEWS[t.dtype])
    return t.to("cpu", copy=True).numpy(), name


def _from_host(arr: np.ndarray, name: str) -> torch.Tensor:
    dtype = _DTYPE_NAMES[name]
    t = torch.from_numpy(arr)
    return t.view(dtype) if dtype in _BIT_VIEWS else t


def _paths(tree, prefix: str = "") -> list:
    """Each leaf's path in ``chunking.tree_leaves`` order: the tree's structure."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, sub in enumerate(tree) for p in _paths(sub, f"{prefix}/{i}")]
    if tree is None:
        return []
    return [prefix or "/"]


def _write(ckpt_dir: str, step: int, paths: list, host: list, keep: int) -> str:
    """Publish host leaves ``host`` ((array, dtype name) each) as step ``step``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:06d}")
    tmp = final + f".tmp_{uuid.uuid4().hex[:8]}"
    os.makedirs(tmp, exist_ok=True)

    shards, cur, cur_bytes = [], [], 0
    for i, (arr, _) in enumerate(host):
        cur.append(i)
        cur_bytes += arr.nbytes
        if cur_bytes >= _SHARD_BYTES:
            shards.append(cur)
            cur, cur_bytes = [], 0
    if cur:
        shards.append(cur)

    leaf_meta = [None] * len(host)
    for si, idxs in enumerate(shards):
        for i in idxs:
            leaf_meta[i] = {"path": paths[i], "shape": list(host[i][0].shape),
                            "dtype": host[i][1], "shard": si}
    meta = {"step": step, "n_leaves": len(host), "leaves": leaf_meta, "shards": len(shards)}
    for si, idxs in enumerate(shards):
        np.savez(os.path.join(tmp, f"shard_{si:05d}.npz"),
                 **{f"leaf_{i}": host[i][0] for i in idxs})
    # the meta last: a directory with a meta holds every shard
    with open(os.path.join(tmp, _META), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        # a complete checkpoint for this step was already published
        shutil.rmtree(tmp, ignore_errors=True)
    else:
        os.replace(tmp, final)  # atomic publish
    _gc(ckpt_dir, keep)
    return final


def save(ckpt_dir: str, step: int, tree, *, keep: int = 3) -> str:
    """Write ``tree`` (dicts, lists, tuples of tensors) as step ``step``;
    keep the newest ``keep`` steps. -> the step's directory."""
    return _write(ckpt_dir, step, _paths(tree),
                  [_to_host(leaf) for leaf in chunking.tree_leaves(tree)], keep)


class AsyncCheckpointer:
    """Snapshot-on-call, serialize-on-thread. wait() joins the last save."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: threading.Thread | None = None

    def save_async(self, step: int, tree) -> None:
        host = [_to_host(leaf) for leaf in chunking.tree_leaves(tree)]  # device->host now
        paths = _paths(tree)
        self.wait()
        self._thread = threading.Thread(
            target=_write, args=(self.ckpt_dir, step, paths, host, self.keep))
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = _STEP_RE.match(name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, _META)):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(ckpt_dir: str) -> int | None:
    s = steps(ckpt_dir)
    return s[-1] if s else None


def _placement_leaves(tree) -> list:
    """The leaves of a placement tree in ``chunking.tree_leaves`` order, None
    (no placement) kept as a leaf."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _placement_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for sub in tree for leaf in _placement_leaves(sub)]
    return [tree]


def restore(ckpt_dir: str, tree_like, step: int | None = None, *, shardings=None):
    """Restore into the structure of ``tree_like``: each leaf on the device
    of ``tree_like``'s leaf in its place. -> (tree, step).

    ``shardings``: a tree like ``tree_like`` of ``dist.sharding.NamedSharding``
    (``param_shardings``) or None leaves, for an elastic restore onto a
    mesh: each leaf with a placement becomes a DTensor, each rank keeping
    its shard of the values it restored (``distribute_tensor`` with no
    source rank: every rank reads the same checkpoint, so nothing is sent);
    its ``full_tensor()`` is the plain restore."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:06d}")
    with open(os.path.join(path, _META)) as f:
        meta = json.load(f)
    leaves_like = chunking.tree_leaves(tree_like)
    if meta["n_leaves"] != len(leaves_like):
        raise ValueError(
            f"checkpoint has {meta['n_leaves']} leaves, target tree {len(leaves_like)}")
    want = _paths(tree_like)
    got = [leaf["path"] for leaf in meta["leaves"]]
    if got != want:
        bad = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
        raise ValueError(f"checkpoint leaf {bad} is {got[bad]!r}, the target tree's {want[bad]!r}")
    host: list = [None] * meta["n_leaves"]
    for si in range(meta["shards"]):
        with np.load(os.path.join(path, f"shard_{si:05d}.npz")) as z:
            for name in z.files:
                i = int(name.split("_")[1])
                host[i] = _from_host(z[name], meta["leaves"][i]["dtype"])
    out = [h.to(torch.as_tensor(like).device) for h, like in zip(host, leaves_like)]
    if shardings is not None:
        from torch.distributed.tensor import distribute_tensor

        places = _placement_leaves(shardings)
        if len(places) != len(out):
            raise ValueError(f"shardings has {len(places)} leaves, the target tree {len(out)}")
        out = [t if sh is None else distribute_tensor(t, sh.mesh, sh.placements,
                                                      src_data_rank=None)
               for t, sh in zip(out, places)]
    return chunking.tree_unflatten(tree_like, out), step


def _gc(ckpt_dir: str, keep: int) -> None:
    all_steps = steps(ckpt_dir)
    for s in all_steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:06d}"), ignore_errors=True)
    # clean stale tmp dirs from crashed writers
    for name in os.listdir(ckpt_dir):
        if ".tmp_" in name:
            full = os.path.join(ckpt_dir, name)
            if os.path.isdir(full):
                shutil.rmtree(full, ignore_errors=True)
