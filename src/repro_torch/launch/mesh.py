"""Mesh builders (port of repro/launch/mesh.py): functions, not module
constants, so importing this module touches no process group.

``make_mesh`` is ``dist.sharding.make_mesh`` (a ``DeviceMesh`` over the
running ``torch.distributed`` group, on the card unless ``device`` names
another). The JAX module's roofline constants are a TPU's and have no
counterpart here; the port's measurements carry the card's own name and
power limit (PERF.md).
"""
from __future__ import annotations

import math
import os

import torch.distributed as dist

from ..dist import sharding as shard_lib


def make_mesh(shape: tuple, axes: tuple, device=None):
    return shard_lib.make_mesh(shape, axes, device)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16 x 16 = 256 ranks a pod (``data``, ``model``); ``multi_pod`` adds a
    leading 2-pod axis. Raises unless the world has exactly that many
    ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1")))
    if world != math.prod(shape):
        raise ValueError(f"the production mesh {shape} {axes} needs {math.prod(shape)} ranks; "
                         f"the world has {world}")
    return make_mesh(shape, axes, device)
