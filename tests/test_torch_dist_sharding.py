"""The port's placement rules (repro_torch/dist/sharding.py) against the JAX
package's, on meshes given by their axis names and sizes alone.

- ``spec_for`` on tests/test_distribution.py's cases, and against JAX's
  ``spec_for`` on every ParamDef leaf of all ten configs;
- ``param_shardings`` and ``cache_shardings`` for all ten configs, leaf by
  leaf against JAX's (its ``NamedSharding`` replaced by a stand-in that
  keeps the spec, since a JAX ``NamedSharding`` needs a mesh of devices),
  on four meshes, with the expert-parallel preference, without FSDP and
  with the sequence sharded;
- ``mesh_axis_sizes``, ``dp_axes``, ``abstract_params`` and ``param_axes``;
- the spec to DTensor placements converter.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

from repro import configs as jconfigs
from repro.dist import sharding as jshard
from repro.models import transformer as jtf
from repro_torch import configs as tconfigs
from repro_torch.core import chunking
from repro_torch.dist import sharding as tshard
from repro_torch.models import transformer as ttf


class FakeMesh:
    """A mesh by its axis names and sizes (tests/test_distribution.py's)."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape)


MESHES = {
    "data_model": FakeMesh((16, 16), ("data", "model")),
    "pod_data_model": FakeMesh((2, 16, 16), ("pod", "data", "model")),
    "pod": FakeMesh((4,), ("pod",)),
    "pod_data_model_small": FakeMesh((2, 2, 4), ("pod", "data", "model")),
}
KINDS = {"default": {}, "ep_first": {"model_pref": "ep"}, "no_fsdp": {"fsdp": False}}


def test_spec_for_divisibility():
    mesh = MESHES["data_model"]
    assert tshard.spec_for((5120, 5120), ("embed", "heads"), mesh) == ("data", "model")
    assert tshard.spec_for((768, 3352), ("embed", "mamba_inner"), mesh) == ("data", None)
    assert tshard.spec_for((8, 6144, 16384), ("experts", "embed", "ff"), mesh) == \
        (None, "data", "model")
    assert tshard.spec_for((5120,), (None,), mesh) == (None,)
    mesh3 = MESHES["pod_data_model"]
    assert tshard.spec_for((5120, 5120), ("embed", "heads"), mesh3) == ("data", "model")
    assert tshard.MODEL_PREF == jshard.MODEL_PREF
    assert tshard.MODEL_PREF_EP == jshard.MODEL_PREF_EP
    assert tshard.DATA_PREF == jshard.DATA_PREF


@pytest.mark.parametrize("mesh", list(MESHES))
def test_mesh_axis_sizes_and_dp_axes(mesh):
    m = MESHES[mesh]
    assert tshard.mesh_axis_sizes(m) == jshard.mesh_axis_sizes(m)
    assert tshard.dp_axes(m) == jshard.dp_axes(m)


class _Spec:
    """A pytree leaf holding a spec: JAX's NamedSharding stand-in."""

    def __init__(self, mesh, spec):
        self.spec = tuple(spec)


def _pref(kw: dict, mod) -> dict:
    kw = dict(kw)
    if kw.get("model_pref") == "ep":
        kw["model_pref"] = mod.MODEL_PREF_EP
    return kw


@pytest.fixture
def jax_named(monkeypatch):
    monkeypatch.setattr(jshard, "NamedSharding", _Spec)


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_param_shardings_match_jax(jax_named, arch):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    jdefs = jax.tree.leaves(jtf.param_defs(jcfg), is_leaf=lambda x: isinstance(x, jtf.ParamDef))
    for mesh in MESHES.values():
        for kw in KINDS.values():
            want = [s.spec for s in jax.tree.leaves(jshard.param_shardings(jcfg, mesh,
                                                                           **_pref(kw, jshard)))]
            got = chunking.tree_leaves(tshard.param_shardings(tcfg, mesh, **_pref(kw, tshard)))
            assert [g.spec for g in got] == want
            assert all(g.mesh is mesh for g in got)
            # the same rule, leaf by leaf on JAX's own ParamDefs
            assert [tshard.spec_for(d.shape, d.axes, mesh, **_pref(kw, tshard))
                    for d in jdefs] == [tuple(jshard.spec_for(d.shape, d.axes, mesh,
                                                              **_pref(kw, jshard)))
                                        for d in jdefs]


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_cache_shardings_match_jax(jax_named, arch):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    batch, seq = 4, 32
    cache_abs = jax.eval_shape(lambda: jtf.init_cache(jcfg, batch, seq, jnp.bfloat16))
    cache_meta = ttf.init_cache(tcfg, batch, seq, device="meta")
    assert [tuple(t.shape) for t in chunking.tree_leaves(cache_meta)] == \
        [tuple(a.shape) for a in jax.tree.leaves(cache_abs)]
    for mesh in MESHES.values():
        for seq_shard in (False, True):
            want = [s.spec for s in jax.tree.leaves(
                jshard.cache_shardings(jcfg, mesh, cache_abs, seq_shard=seq_shard))]
            got = tshard.cache_shardings(tcfg, mesh, cache_meta, seq_shard=seq_shard)
            assert [g.spec for g in chunking.tree_leaves(got)] == want


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_abstract_params_and_param_axes_match_jax(arch):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    want = jax.tree.leaves(jtf.abstract_params(jcfg))
    got = chunking.tree_leaves(ttf.abstract_params(tcfg))
    assert [tuple(t.shape) for t in got] == [tuple(a.shape) for a in want]
    assert {str(t.dtype).removeprefix("torch.") for t in got} == {str(a.dtype) for a in want}
    assert all(t.device.type == "meta" for t in got)
    assert _axes_leaves(ttf.param_axes(tcfg)) == jax.tree.leaves(jtf.param_axes(jcfg),
                                                                  is_leaf=_is_axes)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None))) for a in x)


def _axes_leaves(tree) -> list:
    """The axis tuples of a param_axes tree, in tree_leaves order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _axes_leaves(tree[k])]
    return [tree] if _is_axes(tree) else [leaf for sub in tree for leaf in _axes_leaves(sub)]


def test_placements_of_a_spec():
    mesh = MESHES["pod_data_model"]
    assert tshard.placements(("data", "model"), mesh) == (Replicate(), Shard(0), Shard(1))
    assert tshard.placements((("pod", "data"), None, "model"), mesh) == \
        (Shard(0), Shard(0), Shard(2))
    assert tshard.placements((None,), mesh) == (Replicate(),) * 3
    named = tshard.NamedSharding(mesh, tuple(P(None, "model")))
    assert named.placements == (Replicate(), Replicate(), Shard(1))
