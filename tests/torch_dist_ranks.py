"""Rank bodies of the port's multi-rank tests (tests/test_torch_dist_mesh.py,
tests/test_torch_pipeline.py, tests/test_torch_runtime.py,
tests/test_torch_placed.py).

``run_ranks(body, world, tmp_path)`` starts ``world`` processes with
torch.multiprocessing (forked from a server process that imported this
module once), joins them into one gloo group through a FileStore
under ``tmp_path`` (no TCP port, so parallel test workers cannot collide),
runs ``BODIES[body](rank, world)`` in each on one thread, and returns every
rank's result, written with ``torch.save``. A rank that raises fails the
call with its traceback; a group that outlives the deadline is killed and
fails it. The ranks import no JAX.
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import configs
from repro_torch.core import chunking, codec
from repro_torch.data import SyntheticLM
from repro_torch.dist import collectives as coll
from repro_torch.dist import pipeline, sharding
from repro_torch.fl import Cohort, RoundConfig, get_task, run_rounds
from repro_torch.models import init_params
from repro_torch.optim import AdamW
from repro_torch.train import checkpoint, init_train_state, make_train_step

DEADLINE_S = 120
KEY = 0
N_CLIENTS = 8
SPECS = {  # tests/test_ownership.py's four-shard subprocess
    "rand_proj_spatial": lambda: codec.RandProjSpatial(k=16, d_block=128),
    "rand_k_per_chunk": lambda: codec.RandK(k=16, d_block=128, shared_randomness=False),
    # every kept coordinate gets a slot, as in tests/test_torch_seeded.py
    "wangni": lambda: codec.Wangni(k=16, d_block=128, capacity=8.0),
    "induced": lambda: codec.Induced(k=16, d_block=128),
    "identity": lambda: codec.Identity(d_block=128),
    "rand_k_int8": lambda: codec.Pipeline([codec.RandK(k=16, d_block=128), codec.Int8Quant()]),
}
PARTICIPANTS = [0, 2, 5, 6, 7]
PSUM_CHUNKS = (3, 4, 8)
PSUM_COUNTS = [2.0, 3.0, 1.0, 4.0]
TRAIN_CLIENTS, TRAIN_STEPS = 4, 2


def ef_pipe(k: int = 16, d_block: int = 128):
    return codec.Pipeline([codec.RandK(k=k, d_block=d_block), codec.ErrorFeedback()])


def tree(n: int = N_CLIENTS) -> dict:
    rng = np.random.default_rng(0)
    return {"w": torch.from_numpy(rng.standard_normal((n, 40, 20)).astype(np.float32)),
            "b": torch.from_numpy(rng.standard_normal((n, 33)).astype(np.float32))}


def big_tree() -> dict:
    """n k payload bytes a chunk well above d's: the owner route moves fewer."""
    rng = np.random.default_rng(1)
    return {"w": torch.from_numpy(rng.standard_normal((N_CLIENTS, 64, 32)).astype(np.float32))}


RAGGED = {  # (leaf shape a client, d_block): 7 chunks over 4 owners, and 3
    "ragged": ((5, 84), 64),
    "more_shards": ((150,), 64),
}


def ragged_tree(name: str) -> dict:
    shape, _ = RAGGED[name]
    rng = np.random.default_rng(2)
    return {"w": torch.from_numpy(rng.standard_normal((N_CLIENTS,) + shape).astype(np.float32))}


def psum_tiles(n_chunks: int) -> torch.Tensor:
    rng = np.random.default_rng(n_chunks)
    return torch.from_numpy(rng.standard_normal((4, n_chunks, 16)).astype(np.float32))


ROUND_CASES = {  # name -> (pipeline, RoundConfig fields beside the backend, backends)
    "srht": (lambda: codec.RandProjSpatial(k=16, d_block=128, transform="avg"), {},
             ("gspmd", "shard_map")),
    "srht_owners": (lambda: codec.RandProjSpatial(k=16, d_block=128, transform="avg"),
                    {"ownership": True, "n_owners": 4}, ("gspmd", "shard_map")),
    # the driver gathers the residual rows; the server mirrors the memories
    "top_k_ef": (lambda: codec.build("top_k", k=16, d_block=128, ef=True), {}, ("shard_map",)),
    "rand_k_client_temporal": (lambda: codec.build("rand_k", k=16, d_block=128, temporal=True),
                               {"ownership": True}, ("shard_map",)),
}


def rounds(case: str, backend: str, mesh=None):
    make, kw, _ = ROUND_CASES[case]
    task = get_task("drift", n_clients=N_CLIENTS, d=128, rho=0.95, omega=0.02, device="cpu")
    cohort = Cohort(n_clients=N_CLIENTS, dropout=0.2)
    cfg = RoundConfig(n_rounds=3, backend=backend, mesh=mesh, **kw)
    _, hist = run_rounds(task, make(), cohort, cfg, device="cpu")
    return hist


def history(hist) -> dict:
    out = {k: list(getattr(hist, k)) for k in ("mse", "mse_pop", "bytes", "coded_bytes",
                                               "intra_pod_bytes", "n_survivors")}
    st = hist.client_state
    out["state"] = None if st is None else {"ef": st.ef, "memory": st.memory}
    return out


TRAIN_ARCH = "musicgen-medium"


def train_setup(n_clients: int = TRAIN_CLIENTS):
    cfg = configs.preset_config(TRAIN_ARCH, "tiny")
    params = init_params(cfg, 0, device="cpu")
    opt = AdamW(lr=1e-2, warmup_steps=1)
    spec = codec.build("top_k", k=16, d_block=256, ef=True)
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=8, batch=1, n_clients=n_clients,
                       seed=0)
    return cfg, params, opt, spec, data


def train(mesh=None, n_clients: int = TRAIN_CLIENTS, **kw) -> dict:
    """TRAIN_STEPS DME steps with error feedback: the parameters, the last
    step's metrics and residual rows."""
    cfg, params, opt, spec, data = train_setup(n_clients)
    state = init_train_state(cfg, opt, params, spec, n_clients)
    step_fn = make_train_step(cfg, opt, dme_spec=spec, mesh=mesh, device="cpu", **kw)
    for step in range(TRAIN_STEPS):
        params, state, metrics = step_fn(params, state, data.batch_at(step, "cpu"), step)
    return {"params": chunking.tree_leaves(params), "ef": state["ef"],
            "metrics": {k: torch.as_tensor(v) for k, v in metrics.items()}}


# ------------------------------------------------------------------ bodies


def _rows(t: dict, rank: int, n_local: int) -> dict:
    return {k: v[rank * n_local:(rank + 1) * n_local] for k, v in t.items()}


def _mean(m: dict) -> torch.Tensor:
    return torch.cat([leaf.reshape(-1) for leaf in chunking.tree_leaves(m)])


def _shardmap(spec, grads, mesh, **kw):
    m, info, ef = coll.compressed_mean_tree_shardmap(spec, KEY, grads, mesh, device="cpu", **kw)
    return {"mean": _mean(m), "info": info, "ef": ef}


def _gspmd(spec, grads, mesh, **kw):
    m, info, ef = coll.compressed_mean_tree(spec, KEY, grads, coll.dme_shardings(mesh),
                                            device="cpu", **kw)
    return {"mean": _mean(m), "info": info, "ef": ef}


def four_ranks(rank: int, world: int) -> dict:
    mesh = sharding.make_mesh((world,), ("pod",), device="cpu")
    n_local = N_CLIENTS // world
    full = tree()
    mine = _rows(full, rank, n_local)
    out: dict = {}
    for name, make in SPECS.items():
        out[f"{name}/shard_map"] = _shardmap(make(), mine, mesh)
        out[f"{name}/shard_map_owners"] = _shardmap(make(), mine, mesh, ownership=True)
    rps = SPECS["rand_proj_spatial"]()
    out["rand_proj_spatial/gspmd"] = _gspmd(rps, full, mesh)
    out["rand_proj_spatial/gspmd_owners"] = _gspmd(rps, full, mesh, ownership=True)
    pipe = ef_pipe()
    out["ef/shard_map_participants"] = _shardmap(pipe, mine, mesh, participants=PARTICIPANTS)
    first = _shardmap(pipe, mine, mesh, participants=PARTICIPANTS, ownership=True)
    out["ef/shard_map_participants_owners"] = first
    out["ef/shard_map_owners_second"] = _shardmap(pipe, mine, mesh, ef_chunks=first["ef"],
                                                  ownership=True)
    out["ef/shard_map_owners_overlap"] = _shardmap(pipe, mine, mesh, ownership=True,
                                                   overlap=True, overlap_tile=2)
    out["ef/gspmd_participants_owners_overlap"] = _gspmd(
        pipe, full, mesh, participants=PARTICIPANTS, ownership=True, overlap=True,
        overlap_tile=2)
    for name, (_, d_block) in RAGGED.items():
        grid = ragged_tree(name)
        mine_r = _rows(grid, rank, n_local)
        small = codec.RandProjSpatial(k=8, d_block=d_block)
        out[f"{name}/owners"] = _shardmap(small, mine_r, mesh, ownership=True)
        out[f"{name}/owners_overlap"] = _shardmap(small, mine_r, mesh, ownership=True,
                                                  overlap=True, overlap_tile=1)
        out[f"{name}/ef_participants_owners_overlap"] = _shardmap(
            ef_pipe(8, d_block), mine_r, mesh, participants=PARTICIPANTS, ownership=True,
            overlap=True, overlap_tile=1)
    beta8 = codec.RandProjSpatial(k=64, d_block=128, beta_trials=8)
    mine_b = _rows(big_tree(), rank, n_local)
    out["beta8/shard_map"] = _shardmap(beta8, mine_b, mesh)
    out["beta8/shard_map_owners"] = _shardmap(beta8, mine_b, mesh, ownership=True)
    for c in PSUM_CHUNKS:
        out[f"psum/{c}"] = coll.psum_scatter_mean(psum_tiles(c), PSUM_COUNTS, mesh)
    for case, (_, _, backends) in ROUND_CASES.items():
        for backend in backends:
            out[f"rounds/{case}/{backend}"] = history(rounds(case, backend, mesh))
    out["train/shard_map"] = train(mesh)
    # two client axes, flattened into one group of four
    mesh2 = sharding.make_mesh((2, 2), ("pod", "data"), device="cpu")
    out["two_axes/shard_map"] = _shardmap(rps, mine, mesh2, client_axes=("pod", "data"))
    out["two_axes/shard_map_owners"] = _shardmap(rps, mine, mesh2, client_axes=("pod", "data"),
                                                 ownership=True)
    out["imported"] = sorted(m for m in sys.modules
                             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    return out


def restore_case(world: int) -> dict:
    """A checkpoint of tiny musicgen-medium's parameters restored onto a
    ``model`` mesh axis over the ranks: each leaf's full_tensor() against
    the plain restore, how many leaves were sharded, and whether each
    DTensor's local part is the shard ``sharding.shard_tree`` cuts."""
    import tempfile

    cfg = configs.preset_config(TRAIN_ARCH, "tiny")
    params = init_params(cfg, 0, device="cpu")
    mesh = sharding.make_mesh((world,), ("model",), device="cpu")
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save(d, 1, params)
        plain, _ = checkpoint.restore(d, params)
        placed, step = checkpoint.restore(d, params, shardings=sharding.param_shardings(cfg, mesh))
    pairs = list(zip(chunking.tree_leaves(plain), chunking.tree_leaves(placed)))
    sh = sharding.param_shardings(cfg, mesh)
    shards = chunking.tree_leaves(sharding.shard_tree(plain, sh))
    return {"step": step,
            "local_is_shard_tree": all(torch.equal(b.to_local(), c)
                                       for (_, b), c in zip(pairs, shards)),
            "bitwise": [bool(torch.equal(a, b.full_tensor())) for a, b in pairs],
            "sharded": sum(any(not p.is_replicate() for p in b.placements) for _, b in pairs),
            "leaves": len(pairs)}


def two_ranks(rank: int, world: int) -> dict:
    """The GSPMD route with n = 5 clients over 2 ranks (shares of 3 and 2),
    training steps whose 3 clients do not divide over them (auto takes the
    GSPMD route), and a restore onto the ranks."""
    mesh = sharding.make_mesh((world,), ("pod",), device="cpu")
    full = tree(5)
    rps = SPECS["rand_proj_spatial"]()
    return {
        "gspmd": _gspmd(rps, full, mesh),
        "gspmd_owners": _gspmd(rps, full, mesh, ownership=True),
        "gspmd_ef": _gspmd(ef_pipe(), full, mesh, participants=[0, 1, 3, 4], ownership=True,
                           overlap=True, overlap_tile=2),
        "train_auto": train(mesh, n_clients=3),
        "restore": restore_case(world),
    }


# ------------------------------------------------- the GPipe schedule


def pipe_data() -> dict:
    """tests/test_pipeline.py's blocks and microbatches (8 blocks tanh(h @ w
    + b) of width 16; 6 microbatches of 3), made with numpy, and a probe
    whose product with the output is the loss the gradients are of."""
    rng = np.random.default_rng(3)
    return {"w": (0.3 * rng.standard_normal((8, 16, 16))).astype(np.float32),
            "b": (0.1 * rng.standard_normal((8, 16))).astype(np.float32),
            "x": rng.standard_normal((6, 3, 16)).astype(np.float32),
            "probe": rng.standard_normal((6, 3, 16)).astype(np.float32)}


def _tanh_stage(stage_params, h):
    for w, b in zip(stage_params["w"].unbind(0), stage_params["b"].unbind(0)):
        h = torch.tanh(h @ w + b)
    return h


def pipeline_case(world: int) -> dict:
    """``pipeline_apply`` over a ``pipe`` axis of ``world`` ranks: the
    output and the gradients of sum(output * probe) (the blocks' summed over
    the stages)."""
    mesh = sharding.make_mesh((world,), ("pipe",), device="cpu")
    data = {k: torch.from_numpy(v) for k, v in pipe_data().items()}
    w, b, x = (data[k].requires_grad_() for k in ("w", "b", "x"))
    out = pipeline.pipeline_apply(_tanh_stage, pipeline.partition_blocks({"w": w, "b": b}, world),
                                  x, mesh)
    gw, gb, gx = torch.autograd.grad((out * data["probe"]).sum(), [w, b, x])
    gw, gb = pipeline.reduce_stage_grads([gw, gb], mesh)
    return {"out": out.detach(), "w": gw, "b": gb, "x": gx}


PIPE_ARCH = "musicgen-medium"
PIPE_SEQ = 16
PIPE_STEPS = {  # name -> (codec args or None, clients, batch a client, microbatches)
    "plain": (None, 0, 4, 4),
    "dme": (("identity", dict(d_block=256)), 3, 2, 2),
}


def pipe_step(name: str, mesh=None, stages: int = 0) -> dict:
    """One training step of tiny musicgen-medium, pipelined over ``mesh``'s
    ``pipe`` axis when ``stages``: the loss and the new parameters."""
    spec_args, clients, batch, micro = PIPE_STEPS[name]
    cfg = configs.preset_config(PIPE_ARCH, "tiny")
    params = init_params(cfg, 0, device="cpu")
    opt = AdamW(lr=1e-3, warmup_steps=2)
    spec = None if spec_args is None else codec.build(spec_args[0], **spec_args[1])
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=PIPE_SEQ, batch=batch,
                       n_clients=clients, seed=0)
    step = make_train_step(cfg, opt, dme_spec=spec, mesh=mesh, pipeline_stages=stages,
                           pipeline_microbatches=micro if stages else 0, device="cpu")
    new, _, metrics = step(params, init_train_state(cfg, opt, params, spec, clients),
                           data.batch_at(0, "cpu"), 0)
    return {"loss": float(metrics["loss"]), "params": chunking.tree_leaves(new)}


def pipe_two(rank: int, world: int) -> dict:
    """The schedule on two ranks, and the two-stage steps (rank 0 also the
    unpipelined ones)."""
    mesh = sharding.make_mesh((world,), ("pipe",), device="cpu")
    out = {"apply": pipeline_case(world)}
    for name in PIPE_STEPS:
        out[name] = {"pipelined": pipe_step(name, mesh, world),
                     "plain": pipe_step(name) if rank == 0 else None}
    return out


def pipe_four(rank: int, world: int) -> dict:
    return {"apply": pipeline_case(world)}


# ------------------------------------------- the runtime's two processes

RUNTIME_BASE = dict(  # tests/test_runtime.py's BASE
    task="drift",
    task_kw=dict(n_clients=8, d=128, rho=0.9, omega=0.05, client_bias=0.5),
    stages=[("rand_proj_spatial", dict(k=8, d_block=64, transform="wavg"))],
    cohort=dict(n_clients=8, participation=0.9, dropout=0.2),
    rounds=dict(n_rounds=3, hierarchy="hier", pods=2),
)
RUNTIME_VARIANTS = {  # tests/test_runtime.py's variants, and the base
    "base": RUNTIME_BASE,
    "ef": dict(RUNTIME_BASE, stages=[("top_k", dict(k=8, d_block=64)),
                                     ("error_feedback", dict())]),
    "hetero": dict(RUNTIME_BASE, cohort=dict(RUNTIME_BASE["cohort"],
                                             budgets=(4, 4, 8, 8, 8, 8, 16, 16))),
    "async": dict(RUNTIME_BASE, rounds=dict(RUNTIME_BASE["rounds"], async_rounds=True)),
}


def runtime_two(rank: int, world: int) -> dict:
    """One of the runtime's processes: it joins the runtime (process 0
    hosts the store, at a port it hands the others over the gloo group),
    checks the store's byte round trip, then runs every variant's
    hierarchical rounds."""
    from repro_torch.runtime import launch, workers

    port = [launch.free_port() if rank == 0 else None]
    dist.broadcast_object_list(port, src=0)
    ctx = launch.initialize(launch.Topology(world, rank, f"127.0.0.1:{port[0]}"), device="cpu")
    try:
        out = {"kv": workers.kv_roundtrip_worker(ctx)}
        for tag, spec in RUNTIME_VARIANTS.items():
            out[tag] = workers.round_worker(ctx, spec)
    finally:
        launch.shutdown()
    return out


# ------------------------------------- parameters placed over data / model

PLACED_MESHES = {"1x2x2": (1, 2, 2), "2x2x1": (2, 2, 1)}  # (pod, data, model)
PLACED_AXES = ("pod", "data", "model")
PLACED_BATCH = (2, 4, 32)  # clients x rows a client x tokens: tests/test_distribution.py's
PLACED_SERVE = dict(batch=4, prompt_len=16, gen=5)  # the prefill and 4 greedy tokens
PLACED_OPT = dict(eps=1e-6)  # AdamW at eps 1e-6, as tests/test_torch_train.py's parity steps
# name -> (arch, config overrides, model preference, step kind, meshes). The
# DME cases (every arch, deepseek-moe-16b with both model preferences) run
# on both meshes and are also held against the JAX package's step; the
# others take the plain step (rows over the DP axes, the gradient summed
# over them) with the same placement.
PLACED_MESH_NAMES = tuple(PLACED_MESHES)
PLACED_CASES = {
    "musicgen-medium": ("musicgen-medium", {}, "default", "dme", PLACED_MESH_NAMES),
    "deepseek-moe-16b": ("deepseek-moe-16b", {}, "default", "dme", PLACED_MESH_NAMES),
    "deepseek-moe-16b_ep": ("deepseek-moe-16b", {}, "ep", "dme", PLACED_MESH_NAMES),
    "deepseek-moe-16b_plain": ("deepseek-moe-16b", {}, "default", "plain", ("2x2x1",)),
    "mamba2-130m": ("mamba2-130m", {}, "default", "dme", PLACED_MESH_NAMES),
    "mamba2-130m_plain": ("mamba2-130m", {}, "default", "plain", ("2x2x1",)),
    "jamba-v0.1-52b": ("jamba-v0.1-52b", {}, "default", "dme", PLACED_MESH_NAMES),
    # the split in_z / in_x layout, and heads whose h * dh divides over
    # model while h does not (the weights gathered before use)
    "mamba2-130m_split": ("mamba2-130m", {"mamba_split_proj": True}, "default", "plain",
                          ("1x2x2",)),
    "musicgen-medium_heads3": ("musicgen-medium", {"n_heads": 3, "n_kv_heads": 3}, "default",
                               "plain", ("1x2x2",)),
    # the data slices differ in valid labels and in routed drops
    "drops": ("deepseek-moe-16b", {}, "default", "plain", ("1x2x2", "2x2x1")),
}
PLACED_SERVED = tuple(n for n in PLACED_CASES if n != "drops")  # also served on their meshes


def placed_config(name: str):
    arch, over, _, _, _ = PLACED_CASES[name]
    return configs.reduce_for_smoke(configs.get_config(arch)).replace(vocab_pad_multiple=32,
                                                                      **over)


def placed_spec():
    return codec.build("rand_proj_spatial", k=16, d_block=128)


def placed_params(cfg) -> dict:
    """Weights with ``init_params``' recipes, the random leaves drawn with
    numpy (seed 0): threefry's draws cost each rank seconds on the CPU."""
    from repro_torch.models import transformer

    rng = np.random.default_rng(0)

    def leaf(d):
        if d.init not in ("normal", "scaled"):
            return transformer._init_leaf(d, torch.zeros(2, dtype=torch.int64), torch.float32)
        scale = d.scale / (2.0 * 24.0) ** 0.5 if d.init == "scaled" else d.scale
        return torch.from_numpy((scale * rng.standard_normal(d.shape)).astype(np.float32))

    return transformer.map_defs(leaf, transformer.param_defs(cfg))


def placed_batch(name: str, vocab: int) -> dict:
    """The case's (2, 4, 32) token batch, made with numpy; the plain step
    takes the clients' rows as one batch of 8. ``drops``: the first half of
    the 8 rows (the first data slice on either mesh) repeat one token, so
    their slots crowd two experts past the capacity, and all their labels
    count; the other rows keep 3 labels a row."""
    c, r, s = PLACED_BATCH
    rng = np.random.default_rng(5)
    toks = rng.integers(0, vocab, (c, r, s + 1)).astype(np.int32)
    plain = PLACED_CASES[name][3] == "plain"
    if plain:
        toks = toks.reshape(c * r, s + 1)
    labels = toks[..., 1:].copy()
    if name == "drops":
        toks[:c * r // 2] = 7
        labels = toks[..., 1:].copy()
        labels[c * r // 2:, 3:] = -1
    return {"inputs": torch.from_numpy(toks[..., :-1].copy()), "labels": torch.from_numpy(labels)}


class GradRecorder:
    """AdamW that keeps the gradient of its last update."""

    def __init__(self, inner):
        self.inner, self.grads = inner, None

    def init(self, params):
        return self.inner.init(params)

    def update(self, grads, state, params, **kw):
        self.grads = grads
        return self.inner.update(grads, state, params, **kw)


def placed_step(name: str, mesh=None) -> dict:
    """One step of the case from ``init_params(seed 0)``, placed over
    ``mesh`` (None: the mesh-less step): the loss, metrics, the gradient
    entering AdamW and the new parameters as whole trees; with a mesh
    also the shapes this rank held at rest."""
    arch, _, pref, kind, _ = PLACED_CASES[name]
    cfg = placed_config(name)
    spec = placed_spec() if kind == "dme" else None
    opt = GradRecorder(AdamW(**PLACED_OPT))
    sh, params = None, placed_params(cfg)
    if mesh is not None:
        sh = sharding.param_shardings(
            cfg, mesh, model_pref=sharding.MODEL_PREF_EP if pref == "ep" else sharding.MODEL_PREF)
        params = sharding.shard_tree(params, sh)
    state = init_train_state(cfg, opt, params, spec, PLACED_BATCH[0], shardings=sh)
    step = make_train_step(cfg, opt, dme_spec=spec, mesh=mesh, param_shardings=sh, device="cpu")
    new, new_state, metrics = step(params, state, placed_batch(name, cfg.vocab_size), 0)
    out = {"metrics": {k: float(v) for k, v in metrics.items()}}
    if mesh is None:
        return {**out, "grads": chunking.tree_leaves(opt.grads),
                "params": chunking.tree_leaves(new)}
    opt_leaves = chunking.tree_leaves({k: new_state["opt"][k] for k in ("mu", "nu")})
    return {**out, "grads": chunking.tree_leaves(sharding.full_tree(opt.grads, sh)),
            "params": chunking.tree_leaves(sharding.full_tree(new, sh)),
            "at_rest": [tuple(t.shape) for t in chunking.tree_leaves(new) + opt_leaves],
            "specs": [s.spec for s in chunking.tree_leaves(sh)]}


def placed_serve(name: str, mesh=None) -> dict:
    """The case's float32 prefill and 4 greedy tokens (``launch.serve.serve``
    on seed 0's weights and prompts), placed over ``mesh`` or not."""
    from repro_torch.launch.serve import serve

    cfg = placed_config(name)
    sh = None if mesh is None else sharding.param_shardings(
        cfg, mesh, model_pref=sharding.MODEL_PREF_EP if PLACED_CASES[name][2] == "ep"
        else sharding.MODEL_PREF)
    params = placed_params(cfg) if sh is None else sharding.shard_tree(placed_params(cfg), sh)
    res = serve(cfg, params, device="cpu", mesh=mesh, param_shardings=sh, **PLACED_SERVE)
    return {k: res[k] for k in ("tokens", "prefill_logits", "last_logits")}


def placed_moe_layer(mesh) -> dict:
    """tiny deepseek-moe-16b's MoE FFN on 64 tokens whose first half (the
    first ``data`` slice) is one token repeated: this rank's rows of y and
    the aux loss, under a placement whose batch axes are ``data``."""
    from repro_torch.models import moe

    cfg = placed_config("deepseek-moe-16b")
    p = placed_params(cfg)["blocks"]["l00"]["ffn"]
    p = {k: v[0] for k, v in p.items() if k != "shared"}
    x = placed_moe_tokens(cfg)
    pl = sharding.Placement(mesh, batch_axes=("data",))
    n = x.shape[0] // pl.size("data")
    sh = sharding.param_shardings(cfg, mesh)["blocks"]["l00"]["ffn"]
    # the model shards, whole over data (what the steps hand the layers)
    local = {k: pl.local(v, tuple(None if e == "data" else e for e in sh[k].spec[1:]))
             for k, v in p.items()}
    with sharding.placing(pl):
        y, aux = moe.moe_ffn(x[pl.index("data") * n:(pl.index("data") + 1) * n], local,
                             cfg.replace(n_shared_experts=0))
    return {"y": pl.all_gather(y, ("data",), 0), "aux": float(aux)}


def placed_moe_tokens(cfg) -> torch.Tensor:
    rng = np.random.default_rng(6)
    x = rng.standard_normal((64, cfg.d_model)).astype(np.float32)
    x[:32] = x[0]
    return torch.from_numpy(x)


def placed_init(mesh) -> list:
    """``init_params(shardings=)`` of a narrow config, gathered back whole."""
    cfg = placed_config("mamba2-130m").replace(d_model=16, mamba_d_inner=32, mamba_headdim=8,
                                               d_state=4, vocab_size=64, n_blocks=1)
    sh = sharding.param_shardings(cfg, mesh)
    return chunking.tree_leaves(sharding.full_tree(
        init_params(cfg, 0, device="cpu", shardings=sh), sh))


def placed(rank: int, world: int) -> dict:
    mesh = sharding.make_mesh((1, 2, 2), PLACED_AXES, device="cpu")
    out = {"moe_layer": placed_moe_layer(mesh), "init": placed_init(mesh)}
    for mesh_name, shape in PLACED_MESHES.items():
        mesh = sharding.make_mesh(shape, PLACED_AXES, device="cpu")
        for name, (_, _, _, _, meshes) in PLACED_CASES.items():
            if mesh_name in meshes:
                out[f"{name}/{mesh_name}/step"] = placed_step(name, mesh)
                if name in PLACED_SERVED:
                    out[f"{name}/{mesh_name}/serve"] = placed_serve(name, mesh)
    out["imported"] = sorted(m for m in sys.modules
                             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    return out


BODIES = {"four_ranks": four_ranks, "two_ranks": two_ranks, "pipe_two": pipe_two,
          "pipe_four": pipe_four, "runtime_two": runtime_two, "placed": placed}


# --------------------------------------------------------------- the spawn


def _entry(rank: int, world: int, store: str, out_dir: str, body: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        result = BODIES[body](rank, world)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(body: str, world: int, tmp_path) -> list:
    """Every rank's result of ``BODIES[body]`` run on ``world`` spawned gloo
    ranks; fails past DEADLINE_S, or with a rank's traceback."""
    out_dir = str(tmp_path)
    # the ranks fork from one server process that imported this module (and
    # torch) once, instead of each importing it anew
    mp.set_forkserver_preload([__name__])
    ctx = mp.start_processes(_entry, args=(world, os.path.join(out_dir, "store"), out_dir, body),
                             nprocs=world, join=False, start_method="forkserver")
    deadline = time.monotonic() + DEADLINE_S
    try:
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{body}: {world} ranks still running after {DEADLINE_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]
