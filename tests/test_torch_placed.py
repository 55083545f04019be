"""Parameters placed over the ``data`` (FSDP) and ``model`` (tensor-parallel)
mesh axes (ROADMAP A.9.2), ``launch/{mesh,specs}.py`` and
``models/act_sharding.py`` of the port, on the CPU over gloo.

One spawn of 4 ranks (tests/torch_dist_ranks.py's ``placed``, 120 s
deadline) runs, on the meshes (pod, data, model) = (1, 2, 2) and (2, 2, 1),
the tiny preset (``vocab_pad_multiple=32``; batch (2, 4, 32), numpy
tokens; weights with ``init_params``' recipes, numpy draws) of each case
of ``PLACED_CASES``: the DME step (``rand_proj_spatial`` k 16 / d_block
128) of musicgen-medium (attention and a dense FFN), deepseek-moe-16b
(MoE, ``MODEL_PREF`` and ``MODEL_PREF_EP``), mamba2-130m and
jamba-v0.1-52b (hybrid) on both meshes; the plain step (rows over the DP
axes) of deepseek-moe-16b and mamba2-130m on (2, 2, 1), of the split
``in_proj``, of heads whose h * dh divides over ``model`` while h does
not, and of a batch whose data slices differ in valid labels and in
routed drops. Against the mesh-less step of the port on the same weights
and batch, each within these gates: loss 1e-6, the gradient entering
AdamW relative L2 1e-5, the update at AdamW eps 1e-6 2e-5; every rank
holding only its shards of the parameters and moments at rest; a placed
float32 prefill and 4 greedy tokens (``launch.serve.serve``) within 1e-4
of the mesh-less logits, the tokens equal. Every placed DME step is also
held, within the same gates, against the JAX package's mesh-less
``make_train_step`` (one compiled program an arch). The MoE layer and the
``drops`` batch show the whole-batch semantics: what each rank would
compute alone differs.

In this process: ``launch/specs.py``'s shapes, dtypes and specs against
the JAX package's for every config, ``act_sharding``'s hook and
``launch/mesh.py``.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_dist_ranks as ranks
from repro import configs as jconfigs
from repro.core import codec as jcodec
from repro.dist import sharding as jshard
from repro.launch import specs as jspecs
from repro.models import transformer as jtf
from repro.optim import AdamW as JAdamW
from repro.train import make_train_step as jmake_train_step
from repro.train.train_step import init_train_state as jinit_train_state
from repro_torch import configs as tconfigs
from repro_torch.core import chunking
from repro_torch.dist import sharding
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import specs as tspecs
from repro_torch.models import act_sharding, moe
from repro_torch.models import transformer as ttf
from repro_torch.optim import AdamW

LOSS_TOL, GRAD_RTOL, UPDATE_TOL = 1e-6, 1e-5, 2e-5
SERVE_TOL = 1e-4

STEPS = [(name, m) for name, case in ranks.PLACED_CASES.items() for m in case[4]]
SERVES = [(name, m) for name, m in STEPS if name in ranks.PLACED_SERVED]


class FakeMesh:
    """A mesh by its axis names and sizes (tests/test_distribution.py's)."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    return ranks.run_ranks("placed", 4, tmp_path_factory.mktemp("placed"))


_MESHLESS: dict = {}


def _meshless(name: str, kind: str) -> dict:
    """The mesh-less step or serving of a case, computed once."""
    if (name, kind) not in _MESHLESS:
        run = ranks.placed_step if kind == "step" else ranks.placed_serve
        _MESHLESS[name, kind] = run(name)
    return _MESHLESS[name, kind]


def _rel(got, want) -> float:
    got, want = torch.as_tensor(np.asarray(got)), torch.as_tensor(np.asarray(want))
    return float((got - want).norm() / want.norm())


def _flat(leaves) -> torch.Tensor:
    return torch.cat([torch.as_tensor(np.asarray(t)).reshape(-1) for t in leaves])


def _check_step(got: dict, want_loss: float, want_grads, want_params, what: str) -> None:
    assert abs(got["metrics"]["loss"] - want_loss) <= LOSS_TOL, what
    assert _rel(_flat(got["grads"]), _flat(want_grads)) < GRAD_RTOL, what
    gap = max(float(np.abs(a.numpy() - np.asarray(b)).max())
              for a, b in zip(got["params"], want_params))
    assert gap <= UPDATE_TOL, (what, gap)


# ------------------------------------------------------- the placed steps


@pytest.mark.parametrize("name,mesh", STEPS)
def test_placed_step_matches_meshless(spawned, name, mesh):
    want = _meshless(name, "step")
    results = [r[f"{name}/{mesh}/step"] for r in spawned]
    for rank, got in enumerate(results):
        _check_step(got, want["metrics"]["loss"], want["grads"], want["params"],
                    f"{name} {mesh} rank {rank}")
        for key in ("grad_norm", "aux"):
            if key in want["metrics"]:
                assert got["metrics"][key] == pytest.approx(want["metrics"][key], rel=1e-5)
        assert all(torch.equal(a, b) for a, b in zip(got["params"], results[0]["params"]))


@pytest.mark.parametrize("name,mesh", STEPS)
def test_placed_step_holds_shards_at_rest(spawned, name, mesh):
    """Each rank's parameters and AdamW moments after the step are its
    shards alone: their shapes are the specs' local shapes, and a rank
    holds less than the whole tree."""
    fake = FakeMesh(ranks.PLACED_MESHES[mesh], ranks.PLACED_AXES)
    whole = [tuple(t.shape) for t in _meshless(name, "step")["params"]]
    for rank, r in enumerate(spawned):
        got = r[f"{name}/{mesh}/step"]
        want = [sharding.local_shape(s, spec, fake) for s, spec in zip(whole, got["specs"])]
        assert got["at_rest"] == want * 3, (name, mesh, rank)  # params, mu, nu
        assert sum(map(math.prod, want)) < sum(map(math.prod, whole))


def _compile_cheaply(fn, *args):
    """``jax.jit(fn)`` compiled for ``args`` without XLA's costly
    optimisation passes and with the CPU's loop emitters instead of its
    fusion emitters, which compile faster: the program runs once, and
    neither changes its operations."""
    was = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        return jax.jit(fn).lower(*args).compile(
            compiler_options={"xla_cpu_use_fusion_emitters": False})
    finally:
        jax.config.update("jax_disable_most_optimizations", was)


class _JaxGradRecorder:
    """JAX's AdamW, returning the gradient it was given among its metrics."""

    def __init__(self, inner):
        self.inner = inner

    def init(self, params):
        return self.inner.init(params)

    def update(self, grads, state, params):
        new, st, om = self.inner.update(grads, state, params)
        return new, st, {**om, "grads": grads}


_JAX: dict = {}


def _jax_step(arch: str) -> dict:
    """The JAX package's mesh-less DME step of ``arch``'s case on the same
    weights and batch (one compiled program an arch), as numpy."""
    if arch not in _JAX:
        cfg = jconfigs.reduce_for_smoke(jconfigs.get_config(arch)).replace(vocab_pad_multiple=32)
        params = jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                              ranks.placed_params(ranks.placed_config(arch)))
        batch = {k: jnp.asarray(v.numpy())
                 for k, v in ranks.placed_batch(arch, cfg.vocab_size).items()}
        spec = jcodec.build("rand_proj_spatial", k=16, d_block=128, use_pallas="never")
        opt = _JaxGradRecorder(JAdamW(**ranks.PLACED_OPT))
        step = jmake_train_step(cfg, opt, dme_spec=spec)
        state = jinit_train_state(cfg, opt, params, spec, ranks.PLACED_BATCH[0])
        new, _, metrics = _compile_cheaply(step, params, state, batch, 0)(params, state, batch, 0)
        _JAX[arch] = {"loss": float(metrics["loss"]),
                      "grads": [np.asarray(g) for g in jax.tree.leaves(metrics["grads"])],
                      "params": [np.asarray(p) for p in jax.tree.leaves(new)]}
    return _JAX[arch]


DME_STEPS = [(name, m) for name, m in STEPS if ranks.PLACED_CASES[name][3] == "dme"]


@pytest.mark.parametrize("name,mesh", DME_STEPS)
def test_placed_dme_step_matches_jax(spawned, name, mesh):
    """Every arch's placed DME step (deepseek-moe-16b with both model
    preferences) on both meshes against the JAX package's mesh-less
    ``make_train_step``, which GSPMD's placed step computes too."""
    want = _jax_step(ranks.PLACED_CASES[name][0])
    for rank, r in enumerate(spawned):
        _check_step(r[f"{name}/{mesh}/step"], want["loss"], want["grads"], want["params"],
                    f"{name} {mesh} rank {rank}")


# ------------------------------------------------------------- serving


@pytest.mark.parametrize("name,mesh", SERVES)
def test_placed_serving_matches_meshless(spawned, name, mesh):
    want = _meshless(name, "serve")
    for rank, r in enumerate(spawned):
        got = r[f"{name}/{mesh}/serve"]
        assert torch.equal(got["tokens"], want["tokens"]), (name, mesh, rank)
        for key in ("prefill_logits", "last_logits"):
            gap = float((got[key] - want[key]).abs().max())
            assert gap <= SERVE_TOL, (name, mesh, rank, key, gap)


# ------------------------------------------ whole-batch semantics, and more


@pytest.mark.parametrize("mesh", ranks.PLACED_CASES["drops"][4])
def test_drops_batch_would_fail_under_local_semantics(mesh):
    """The ``drops`` batch's data slices differ in valid labels and in the
    MoE's drops: the mean of the slices' own losses (what each rank would
    report alone, with its own label count, capacity, drops and aux) is far
    from the whole batch's, which the placed step matches
    (test_placed_step_matches_meshless)."""
    cfg = ranks.placed_config("drops")
    params = ranks.placed_params(cfg)
    batch = ranks.placed_batch("drops", cfg.vocab_size)
    k = math.prod(ranks.PLACED_MESHES[mesh][:2])  # rows over pod x data
    n = batch["inputs"].shape[0] // k
    whole = float(ttf.loss_fn(params, cfg, batch)[0])
    alone = [float(ttf.loss_fn(params, cfg, {key: v[i * n:(i + 1) * n] for key, v in
                                             batch.items()})[0]) for i in range(k)]
    assert abs(np.mean(alone) - whole) > 1e-2
    assert whole == pytest.approx(_meshless("drops", "step")["metrics"]["loss"], abs=LOSS_TOL)


def _dropped(cfg, x, cap: int) -> int:
    _, _, sel = moe.route(x, ranks.placed_params(cfg)["blocks"]["l00"]["ffn"]["router"][0],
                          cfg.top_k_experts)
    return int((~moe.dispatch(sel, cfg.n_experts, cap)[3]).sum())


def test_moe_layer_routes_over_the_whole_batch(spawned):
    """The MoE FFN over 64 tokens split over ``data``: capacity, drop order
    and aux of the whole batch, as the mesh-less layer on all 64 tokens;
    each half alone keeps other slots."""
    cfg = ranks.placed_config("deepseek-moe-16b").replace(n_shared_experts=0)
    p = {k: v[0] for k, v in ranks.placed_params(cfg)["blocks"]["l00"]["ffn"].items()}
    x = ranks.placed_moe_tokens(cfg)
    y, aux = moe.moe_ffn(x, p, cfg)
    for r in spawned:
        assert float((r["moe_layer"]["y"] - y).abs().max()) <= 1e-6
        assert r["moe_layer"]["aux"] == pytest.approx(float(aux), rel=1e-6)
    halves = [moe.moe_ffn(x[:32], p, cfg), moe.moe_ffn(x[32:], p, cfg)]
    assert _rel(torch.cat([h[0] for h in halves]), y) > 0.1
    whole_drops = _dropped(cfg, x, moe.capacity(cfg, 64))
    alone_drops = sum(_dropped(cfg, h, moe.capacity(cfg, 32)) for h in (x[:32], x[32:]))
    assert whole_drops > 0 and alone_drops != whole_drops


def test_init_params_draws_whole_leaves_and_keeps_shards(spawned):
    """``init_params(shardings=)`` gathered back is ``init_params``."""
    cfg = ranks.placed_config("mamba2-130m").replace(d_model=16, mamba_d_inner=32,
                                                     mamba_headdim=8, d_state=4,
                                                     vocab_size=64, n_blocks=1)
    want = chunking.tree_leaves(ttf.init_params(cfg, 0, device="cpu"))
    for r in spawned:
        assert all(torch.equal(a, b) for a, b in zip(r["init"], want))


def test_ranks_import_no_jax(spawned):
    assert all(r["imported"] == [] for r in spawned)


# ------------------------------------------------------ launch/specs.py

SPEC_MESHES = {
    "data_model": FakeMesh((16, 16), ("data", "model")),
    "pod_data_model": FakeMesh((2, 16, 16), ("pod", "data", "model")),
    "pod_data_model_small": FakeMesh((2, 2, 4), ("pod", "data", "model")),
}


class _Spec:
    """JAX's NamedSharding stand-in: the spec alone (a JAX NamedSharding
    needs a mesh of devices)."""

    def __init__(self, mesh, spec):
        self.spec = tuple(spec)


@pytest.fixture
def jax_named(monkeypatch):
    monkeypatch.setattr(jshard, "NamedSharding", _Spec)
    monkeypatch.setattr(jspecs, "NamedSharding", _Spec)
    monkeypatch.setattr(jspecs, "_sds", lambda shape, dtype, ns: (tuple(shape),
                                                                  str(np.dtype(dtype)), ns.spec))


def _port(ts) -> tuple:
    return tuple(ts.shape), str(ts.dtype).removeprefix("torch."), tuple(ts.sharding.spec)


def _leaves(tree) -> list:
    return chunking.tree_leaves(tree)


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_specs_match_jax(jax_named, arch):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    for mesh in SPEC_MESHES.values():
        for pref in ("default", "ep"):
            kw = {} if pref == "default" else {"model_pref": jshard.MODEL_PREF_EP}
            tkw = {} if pref == "default" else {"model_pref": sharding.MODEL_PREF_EP}
            want = jax.tree.leaves(jspecs.params_specs(jcfg, mesh, **kw),
                                   is_leaf=lambda x: isinstance(x, tuple) and len(x) == 3
                                   and isinstance(x[1], str))
            got = tspecs.params_specs(tcfg, mesh, **tkw)
            assert [_port(t) for t in _leaves(got)] == want
            opt = tspecs.opt_state_specs(AdamW(), got)
            assert [t.sharding for t in _leaves(opt["mu"])] == [t.sharding for t in _leaves(got)]
            assert opt["step"] == tspecs.TensorSpec((), torch.int32, None)
        for shape in jspecs.SHAPES:
            assert tspecs.supported(tcfg, shape) == jspecs.supported(jcfg, shape)
            for n in (0, 4):
                want = jspecs.batch_specs(jcfg, shape, mesh, n_clients=n)
                got = tspecs.batch_specs(tcfg, shape, mesh, n_clients=n)
                assert {k: _port(v) for k, v in got.items()} == want
            want = jspecs.decode_specs(jcfg, shape, mesh)
            got = tspecs.decode_specs(tcfg, shape, mesh)
            assert [_port(t) for t in _leaves(got[0])] == jax.tree.leaves(
                want[0], is_leaf=lambda x: isinstance(x, tuple) and len(x) == 3
                and isinstance(x[1], str))
            assert _port(got[1]) == want[1]
            assert (got[2] is None) == (want[2] is None)
            if got[2] is not None:
                assert _port(got[2]) == want[2]


def test_opt_state_specs_match_jax_shapes():
    jcfg, tcfg = jconfigs.get_config("jamba-v0.1-52b"), tconfigs.get_config("jamba-v0.1-52b")
    mesh = SPEC_MESHES["pod_data_model_small"]
    want = jax.eval_shape(JAdamW().init, jtf.abstract_params(jcfg))
    got = tspecs.opt_state_specs(AdamW(), tspecs.params_specs(tcfg, mesh))
    for k in ("mu", "nu"):
        assert [(t.shape, str(t.dtype).removeprefix("torch.")) for t in _leaves(got[k])] == \
            [(tuple(a.shape), str(a.dtype)) for a in jax.tree.leaves(want[k])]
    assert (got["step"].shape, str(got["step"].dtype)) == ((), "torch.int32")


# ------------------------------------------- act_sharding, launch/mesh.py


def test_act_sharding_hook():
    x = torch.randn(2, 3, 4)
    assert act_sharding.current() is None and act_sharding.constrain(x) is x
    layout = sharding.NamedSharding(SPEC_MESHES["pod_data_model"], (("pod", "data"), None, None))
    with act_sharding.constraint(layout):
        assert act_sharding.current() is layout
        assert act_sharding.constrain(x) is x
        row = x[0]
        assert act_sharding.constrain(row) is row  # not (B, S, D): untouched
        with act_sharding.constraint(None):
            assert act_sharding.current() is None
        bad = sharding.NamedSharding(layout.mesh, ("data", None, "model"))
        with act_sharding.constraint(bad), pytest.raises(ValueError, match="model"):
            act_sharding.constrain(x)
    assert act_sharding.current() is None
    act_sharding.set_constraint(layout)
    try:
        assert act_sharding.current() is layout
    finally:
        act_sharding.set_constraint(None)


def test_pipelined_loss_turns_the_constraint_off(monkeypatch):
    """Inside ``pipeline_apply`` no layout is installed (the stages place
    their own activations); the embedding and the head see the caller's."""
    seen = []
    real = act_sharding.constrain
    monkeypatch.setattr(act_sharding, "constrain",
                        lambda x: seen.append(act_sharding.current()) or real(x))
    cfg = ranks.placed_config("musicgen-medium")
    params = ranks.placed_params(cfg)
    batch = {k: v.reshape(8, -1) for k, v in ranks.placed_batch("musicgen-medium",
                                                                cfg.vocab_size).items()}
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = sharding.make_mesh((1,), ("pipe",), device="cpu")
        layout = sharding.NamedSharding(mesh, (None, None, None))
        with act_sharding.constraint(layout):
            from repro_torch.train.train_step import _pipelined_loss
            _pipelined_loss(params, cfg, batch, mesh=mesh, axis="pipe", n_stages=1, n_micro=2)
    finally:
        dist.destroy_process_group()
    assert seen[0] is layout and seen[-1] is layout  # embed_inputs, logits_fn
    assert seen[1:-1] and all(s is None for s in seen[1:-1])  # the blocks


def test_launch_mesh():
    assert not any(hasattr(tmesh, k) for k in ("PEAK_FLOPS_BF16", "HBM_BW", "ICI_BW"))
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = tmesh.make_mesh((1, 1), ("data", "model"), device="cpu")
        assert sharding.mesh_axis_sizes(mesh) == {"data": 1, "model": 1}
        for multi, n in ((False, 256), (True, 512)):
            with pytest.raises(ValueError, match=f"needs {n} ranks; the world has 1"):
                tmesh.make_production_mesh(multi_pod=multi, device="cpu")
    finally:
        dist.destroy_process_group()


def test_local_and_whole_shapes():
    mesh = SPEC_MESHES["pod_data_model_small"]
    assert sharding.local_shape((8, 12), ("data", "model"), mesh) == (4, 3)
    assert sharding.local_shape((8, 12), (("pod", "data"), None), mesh) == (2, 12)
    assert sharding.whole_shape((4, 3), ("data", "model"), mesh) == (8, 12)
    with pytest.raises(ValueError, match="does not split"):
        sharding.local_shape((6,), ("model",), mesh)
