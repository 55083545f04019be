"""The port's GPipe schedule (src/repro_torch/dist/pipeline.py) and the
pipelined training step against the JAX package, on the CPU over gloo.

- ``partition_blocks``: shapes, values and the refusal, as JAX's;
- ``pipeline_apply`` on a ``pipe`` axis of 1, 2 and 4 ranks (one rank in
  this process, 2 and 4 spawned once each through
  tests/torch_dist_ranks.py's ``run_ranks``) against the JAX package's
  serial composition of tests/test_pipeline.py's blocks on the same numpy
  inputs: the output and the gradients of sum(output * probe) (the blocks'
  summed over the stages, the input's on every rank) within rtol 2e-5 /
  atol 2e-6, every rank's equal to rank 0's;
- the pipelined step on tiny musicgen-medium (one stage, two microbatches),
  plain and through the identity codec, against the JAX package's
  ``make_train_step(pipeline_stages=1)`` with the identity codec (one
  compiled program), its weights carried across by ``interop`` and the
  same token batch: loss and update within 2e-5;
- the same two steps on two ranks at two stages against the unpipelined
  port step (tests/torch_dist_ranks.py's ``PIPE_STEPS``): loss and update
  within 2e-5, both ranks' updates bitwise equal;
- the bad configs refused as tests/test_pipeline.py refuses them, and the
  training CLI's ``--pipeline-stages 1`` on a one-rank group.
"""
from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_dist_ranks as ranks
from repro.core import codec as jcodec
from repro.dist import pipeline as jpipeline
from repro.launch.train import preset_config as jpreset
from repro.optim import AdamW as JAdamW
from repro.train import make_train_step as jmake_train_step
from repro.train.train_step import init_train_state as jinit_train_state
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.core import chunking
from repro_torch.core import codec as tcodec
from repro_torch.dist import pipeline, sharding
from repro_torch.launch import train as tlaunch
from repro_torch.optim import AdamW
from repro_torch.train import init_train_state, make_train_step

RTOL, ATOL = 2e-5, 2e-6   # tests/test_pipeline.py's
STEP_TOL = 2e-5           # tests/test_pipeline.py's loss and update bound
# tests/test_torch_train.py's AdamW against JAX: eps 1e-6 for the default
# 1e-8, since AdamW divides each gradient element g by |g| + eps and at
# 1e-8 turns the two packages' float32 rounding of a near-zero g into
# update gaps of 1e-5 and more (that file's comment has the numbers)
OPT = dict(lr=1e-3, warmup_steps=2, eps=1e-6)
SEQ = 16


@contextlib.contextmanager
def _one_rank_group():
    """A world-size-1 gloo group in this process, ended on exit."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield sharding.make_mesh((1,), ("pipe",), device="cpu")
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _cheap_compiles():
    """Compile the JAX reference without XLA's costly optimisation passes:
    it runs once, and they change no float semantics."""
    was = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        yield
    finally:
        jax.config.update("jax_disable_most_optimizations", was)


# ---------------------------------------------------------- partition_blocks


def test_partition_blocks_shapes_and_refusal():
    rng = np.random.default_rng(0)
    tree = {"w": rng.standard_normal((8, 3, 5)).astype(np.float32),
            "b": rng.standard_normal((8,)).astype(np.float32)}
    want = jpipeline.partition_blocks({k: jnp.asarray(v) for k, v in tree.items()}, 4)
    got = pipeline.partition_blocks({k: torch.from_numpy(v) for k, v in tree.items()}, 4)
    assert got["w"].shape == (4, 2, 3, 5) and got["b"].shape == (4, 2)
    for k in tree:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k]))
    with pytest.raises(ValueError, match="not divisible"):
        jpipeline.partition_blocks({"w": jnp.zeros((8, 2))}, 3)
    with pytest.raises(ValueError, match="not divisible"):
        pipeline.partition_blocks({"w": torch.zeros(8, 2)}, 3)


# ------------------------------------------------------------ pipeline_apply


@pytest.fixture(scope="module")
def serial_reference():
    """The JAX package's serial composition of the blocks, and its
    gradients, on ``ranks.pipe_data()``."""
    data = {k: jnp.asarray(v) for k, v in ranks.pipe_data().items()}

    def serial(w, b, x):
        for i in range(w.shape[0]):
            x = jnp.tanh(x @ w[i] + b[i])
        return x

    with _cheap_compiles():
        out = jax.jit(serial)(data["w"], data["b"], data["x"])
        grads = jax.jit(jax.grad(lambda w, b, x: jnp.sum(serial(w, b, x) * data["probe"]),
                                 argnums=(0, 1, 2)))(data["w"], data["b"], data["x"])
    return {"out": np.asarray(out), **{k: np.asarray(g) for k, g in zip("wbx", grads)}}


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Every rank's result of the two- and four-rank bodies (one spawn
    each)."""
    return {2: ranks.run_ranks("pipe_two", 2, tmp_path_factory.mktemp("pipe2")),
            4: ranks.run_ranks("pipe_four", 4, tmp_path_factory.mktemp("pipe4"))}


@pytest.mark.parametrize("world", [1, 2, 4])
def test_pipeline_apply_matches_jax_serial(world, serial_reference, request):
    if world == 1:
        with _one_rank_group():
            results = [ranks.pipeline_case(1)]
    else:
        results = [r["apply"] for r in request.getfixturevalue("spawned")[world]]
    for rank, got in enumerate(results):
        for key in ("out", "w", "b", "x"):
            np.testing.assert_allclose(got[key].numpy(), serial_reference[key], rtol=RTOL,
                                       atol=ATOL, err_msg=f"rank {rank} {key}")
            assert torch.equal(got[key], results[0][key]), f"rank {rank} {key}"


# ------------------------------------------------------ the pipelined step


def _tokens(vocab: int, lead: tuple, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, lead + (SEQ + 1,)).astype(np.int32)
    return {"inputs": toks[..., :-1].copy(), "labels": toks[..., 1:].copy()}


CLIENTS, ROWS = 3, 2     # the JAX step's batch: clients x rows a client
STEPS = {  # name -> the port step's codec args (None: the plain step)
    "plain": None,
    "dme": ("identity", dict(d_block=256)),
}


@pytest.fixture(scope="module")
def jax_step():
    """JAX's pipelined DME step through the identity codec (one stage, two
    microbatches), as numpy: the weights (the port's ``init_params`` at
    seed 0, in JAX's layout), the batch, the loss and the new weights. The
    identity codec's mean of the clients' gradients is the plain step's
    gradient of the clients' rows together, so this one compiled program is
    the reference of both port steps."""
    cfg = jpreset(ranks.PIPE_ARCH, "tiny")
    opt = JAdamW(**OPT)
    tcfg = tconfigs.preset_config(ranks.PIPE_ARCH, "tiny")
    params = jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                          ranks.init_params(tcfg, 0, device="cpu"))
    batch = _tokens(cfg.vocab_size, (CLIENTS, ROWS), seed=0)
    spec = jcodec.build(STEPS["dme"][0], **STEPS["dme"][1])
    step = jmake_train_step(cfg, opt, dme_spec=spec, mesh=jax.make_mesh((1,), ("pipe",)),
                            pipeline_stages=1, pipeline_microbatches=2)
    with _cheap_compiles():
        new, _, metrics = jax.jit(step)(params, jinit_train_state(cfg, opt, params, spec,
                                                                  CLIENTS), batch, 0)
    return jax.tree.map(np.asarray, {"params": params, "batch": batch,
                                     "loss": metrics["loss"], "new": new})


@pytest.mark.parametrize("name", list(STEPS))
def test_pipelined_step_matches_jax(name, jax_step):
    cfg = tconfigs.preset_config(ranks.PIPE_ARCH, "tiny")
    params = interop.params_from_numpy(cfg, jax_step["params"], "cpu")
    spec_args = STEPS[name]
    spec = None if spec_args is None else tcodec.build(spec_args[0], **spec_args[1])
    opt = AdamW(**OPT)
    batch = {k: torch.from_numpy(v) for k, v in jax_step["batch"].items()}
    if spec is None:  # the plain step takes the clients' rows as one batch
        batch = {k: v.reshape(CLIENTS * ROWS, -1) for k, v in batch.items()}
    with _one_rank_group() as mesh:
        step = make_train_step(cfg, opt, dme_spec=spec, mesh=mesh, pipeline_stages=1,
                               pipeline_microbatches=2, device="cpu")
        new, _, metrics = step(params, init_train_state(cfg, opt, params, spec,
                                                        CLIENTS if spec else 0), batch, 0)
    assert abs(float(metrics["loss"]) - float(jax_step["loss"])) < STEP_TOL
    got, want = chunking.tree_leaves(new), jax.tree.leaves(jax_step["new"])
    assert len(got) == len(want)
    gap = max(float(np.abs(g.numpy() - w).max()) for g, w in zip(got, want))
    assert gap < STEP_TOL, gap


@pytest.mark.parametrize("name", list(ranks.PIPE_STEPS))
def test_two_stage_step_matches_unpipelined(name, spawned):
    results = [r[name] for r in spawned[2]]
    plain = results[0]["plain"]  # the unpipelined step, on rank 0
    for rank, res in enumerate(results):
        assert abs(res["pipelined"]["loss"] - plain["loss"]) < STEP_TOL, rank
        gap = max(float((a - b).abs().max())
                  for a, b in zip(res["pipelined"]["params"], plain["params"]))
        assert gap < STEP_TOL, (rank, gap)
        assert all(torch.equal(a, b) for a, b in zip(res["pipelined"]["params"],
                                                     results[0]["pipelined"]["params"])), rank


def test_pipelined_step_rejects_bad_configs():
    """tests/test_pipeline.py's refusals, and the MoE block pattern and a
    batch that does not split into the microbatches."""
    cfg = tconfigs.preset_config(ranks.PIPE_ARCH, "tiny")
    with pytest.raises(ValueError, match="mesh"):
        make_train_step(cfg, AdamW(), pipeline_stages=2, device="cpu")
    moe = tconfigs.preset_config("deepseek-moe-16b", "tiny")
    with _one_rank_group() as mesh:
        with pytest.raises(ValueError, match="size"):
            make_train_step(cfg, AdamW(), mesh=mesh, pipeline_stages=2, device="cpu")
        with pytest.raises(ValueError, match="MoE"):
            make_train_step(moe, AdamW(), mesh=mesh, pipeline_stages=1, device="cpu")
        params = ranks.init_params(cfg, 0, device="cpu")
        batch = {k: torch.from_numpy(v) for k, v in _tokens(cfg.vocab_size, (3,), 0).items()}
        step = make_train_step(cfg, AdamW(), mesh=mesh, pipeline_stages=1,
                               pipeline_microbatches=2, device="cpu")
        with pytest.raises(ValueError, match="microbatches"):
            step(params, init_train_state(cfg, AdamW(), params), batch, 0)


def test_train_cli_one_stage(tmp_path):
    """``--pipeline-stages 1`` trains in this process on a one-rank group,
    which ends with the run."""
    history = tlaunch.main(["--device", "cpu", "--arch", ranks.PIPE_ARCH, "--steps", "2",
                            "--seq", "16", "--batch", "2", "--clients", "2", "--k", "16",
                            "--d-block", "256", "--pipeline-stages", "1",
                            "--pipeline-microbatches", "2",
                            "--ckpt-dir", str(tmp_path)])
    assert [s for s, _ in history] == [0] and np.isfinite(history[0][1])
    assert not dist.is_initialized()
