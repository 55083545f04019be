"""Rules of the PyTorch port (src/repro_torch, chip_smoke.py).

- it imports neither JAX nor the JAX package, nor msgpack or ml_dtypes
  (the card's machine has neither);
- ``default_device()`` is CUDA or an error, never a silent CPU fallback;
- on a CPU tensor the ops run the plain versions, ``use_kernel="force"``
  raises, and the CUDA build is never reached, by the estimator or by a
  model's prefill;
- the FL layer's entry points (``get_task``, ``run_rounds``, the CLI) run
  on the card unless asked for the CPU;
- what is not ported yet (parameters placed over a data or model mesh
  axis) raises NotImplementedError naming its ROADMAP item; Mamba layers,
  the MoE FFN, the profiler session, the mesh route of dist/, hierarchical
  rounds (``--pods``, ``--hosts``) and the GPipe schedule
  (``pipeline_stages``), once refused, run on the CPU when asked.
"""
from __future__ import annotations

import ast
import pathlib
import types

import numpy as np

import pytest
import torch
import torch.distributed as dist

import repro_torch
from repro_torch.core import codec
from repro_torch.core.estimators import base as est_base
from repro_torch.dist import collectives, sharding
from repro_torch import configs, interop
from repro_torch.fl import rounds as fl_rounds
from repro_torch.fl import run as fl_run
from repro_torch.fl import tasks as fl_tasks
from repro_torch.core import beta
from repro_torch.kernels import _build, ops
from repro_torch.launch import serve
from repro_torch.models import transformer
from repro_torch.optim import AdamW
from repro_torch.train import make_train_step

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_no_jax_and_no_reference_package():
    files = _port_files()
    assert len(files) > 15
    bad = [
        (str(p.relative_to(ROOT)), mod)
        for p in files for mod in _imported_modules(p)
        if mod.split(".")[0] in ("jax", "jaxlib", "flax", "repro", "msgpack", "ml_dtypes")
    ]
    assert bad == []


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.default_device()
    tree = {"w": torch.zeros(2, 64)}
    with pytest.raises(RuntimeError, match="CUDA"):
        collectives.compressed_mean_tree(codec.RandProjSpatial(k=8, d_block=64), 0, tree)


_NEW_ENTRY_POINTS = {
    "sparse_proj_mean": lambda: codec.Pipeline([codec.SparseProj(k=4, d_block=32)]).mean_estimate(
        0, torch.zeros(2, 1, 32)),
    "int8_mean": lambda: codec.build("rand_k", k=4, d_block=32, payload_dtype="int8")
    .mean_estimate(0, torch.zeros(2, 1, 32)),
    "ef_collective": lambda: collectives.compressed_mean_tree(
        codec.build("top_k", k=4, d_block=32, ef=True), 0, {"w": torch.zeros(2, 32)}),
    "client_state": lambda: codec.build("rand_k", k=4, d_block=32, temporal=True)
    .init_client_state(2, 1),
    "sparse_bank": lambda: beta.sparse_eig_bank(2, 4, 32, 2, trials=2, seed=123),
}


@pytest.mark.parametrize("name", sorted(_NEW_ENTRY_POINTS))
def test_codec_entry_points_need_cuda_without_device(monkeypatch, name):
    """The codec layer's entry points run on the card unless asked for the
    CPU: without CUDA they raise, never fall back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        _NEW_ENTRY_POINTS[name]()


def _op_calls(x, v, signs, rows):
    kv = x[:1]  # one kv head for the two q rows: rep 2
    return {
        "flash_attention": lambda u: ops.flash_attention(x[:, :2], kv, kv, rep=2, window=2,
                                                         use_kernel=u),
        "fwht": lambda u: ops.fwht(x, use_kernel=u),
        "srht_encode": lambda u: ops.srht_encode(x, signs[0, 0], rows[0, 0], use_kernel=u),
        "srht_decode": lambda u: ops.srht_decode(x[..., :4], signs[0, 0], rows[0, 0], 16,
                                                 use_kernel=u),
        "srht_encode_batch": lambda u: ops.srht_encode_batch(
            x, signs.expand(2, 3, 16), rows.expand(2, 3, 4), use_kernel=u),
        "srht_decode_sum": lambda u: ops.srht_decode_sum(x[..., :4], signs, rows, 16,
                                                         use_kernel=u),
        "srht_gram_apply": lambda u: ops.srht_gram_apply(v, signs, rows, use_kernel=u),
        "srht_cg_step": lambda u: _cg_step(v, signs, rows, u),
    }


def _cg_step(v, signs, rows, use_kernel):
    """One in-place CG step from x = 0, r = p = v; -> the new state, stacked."""
    x, r, p = torch.zeros_like(v), v.clone(), v.clone()
    rs = (v * v).sum(-1, keepdim=True)
    done = torch.zeros(rs.shape, dtype=torch.bool)
    ops.srht_cg_step(x, r, p, rs, done, torch.tensor(0.5), torch.tensor(0.5), 1e-8 * rs, signs,
                     rows, use_kernel=use_kernel)
    return torch.cat([x, r, p, rs, done.float()], dim=1)


_OPS = ["flash_attention", "fwht", "srht_encode", "srht_decode", "srht_encode_batch",
        "srht_decode_sum", "srht_gram_apply", "srht_cg_step"]


@pytest.mark.parametrize("op", _OPS)
def test_force_on_cpu_tensor_raises(op):
    x = torch.randn(2, 3, 16)
    signs = torch.ones(2, 1, 16)
    rows = torch.arange(4).expand(2, 1, 4)
    call = _op_calls(x, x[0], signs, rows)[op]
    with pytest.raises(RuntimeError, match="force"):
        call("force")
    assert torch.equal(call("auto"), call("never"))


@pytest.mark.parametrize("spec", [
    codec.RandProjSpatial(k=4, d_block=32),
    codec.RandK(k=4, d_block=32),
    codec.RandProjSpatial(k=4, d_block=32, decode_method="gram", beta_trials=64),
    codec.SparseProj(k=4, d_block=32, s=4.0, beta_trials=64),
    codec.build("rand_proj_spatial", k=4, d_block=32, payload_dtype="int8"),
], ids=["fused", "rand_k", "gram", "sparse_proj", "fused_int8"])
def test_cpu_path_never_touches_the_kernel_build(monkeypatch, spec):
    def no_build():
        raise AssertionError("the CPU path reached the CUDA build")

    monkeypatch.setattr(_build, "build", no_build)
    before = ops.launch_counts()
    xs = torch.randn(3, 2, 32)
    pipe = codec.as_pipeline(spec)
    out = pipe.mean_estimate(0, xs, device="cpu")
    assert out.shape == (2, 32) and torch.isfinite(out).all()
    assert ops.launch_counts() == before


def test_unported_options_raise(capfd):
    """What is not ported raises, naming its ROADMAP item; the mesh route of
    dist/ (A.9: ``shardings=``, the gspmd / shard_map round backends and
    the CLI's ``--backend``), hierarchical rounds and the CLI's ``--pods``
    / ``--hosts`` (A.10) and the GPipe schedule (A.9.1), once refused here,
    run on the CPU."""
    with pytest.raises(KeyError, match="unknown estimator"):
        est_base.get("rand_q")
    with pytest.raises(TypeError, match="not a codec stage"):
        codec.Pipeline([codec.RandK(k=4, d_block=32), types.SimpleNamespace(role="compress")])
    tree = {"w": torch.zeros(2, 64)}
    spec = codec.RandK(k=8, d_block=64)
    task = fl_tasks.get_task("dme", device="cpu", n_clients=2, d=64)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = sharding.make_mesh((1,), ("pod",), device="cpu")
        _, info, _ = collectives.compressed_mean_tree(
            spec, 0, tree, device="cpu", shardings=collectives.dme_shardings(mesh))
        assert info["n_shards"] == 1
        for backend in ("gspmd", "shard_map"):
            _, hist = fl_rounds.run_rounds(
                task, spec, cfg=fl_rounds.RoundConfig(n_rounds=1, backend=backend, mesh=mesh),
                device="cpu")
            assert len(hist.mse) == 1
    finally:
        dist.destroy_process_group()
    assert fl_run.main(["--device", "cpu", "--smoke", "--task", "dme", "--backend", "gspmd"]) == 0
    assert not dist.is_initialized()  # the CLI ends the group it started
    _, hist = fl_rounds.run_rounds(task, spec, cfg=fl_rounds.RoundConfig(
        n_rounds=1, hierarchy="hier", pods=2), device="cpu")
    assert len(hist.dcn_bytes) == 1 and hist.dcn_bytes[0] > 0
    capfd.readouterr()
    for argv in (["--pods", "2"], ["--pods", "2", "--hosts", "2"]):
        assert fl_run.main(["--device", "cpu", "--smoke", "--task", "dme", *argv]) == 0
        assert "total_bytes=" in capfd.readouterr().out  # process 0 reported
    # the GPipe schedule on a one-rank pipe axis; parameters placed over a
    # data or model axis (tests/test_torch_placed.py), but not through it
    cfg = configs.preset_config("musicgen-medium", "tiny")
    params = transformer.init_params(cfg, 0, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(0))
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = sharding.make_mesh((1,), ("pipe",), device="cpu")
        step = make_train_step(cfg, AdamW(), mesh=mesh, pipeline_stages=1, device="cpu")
        _, _, metrics = step(params, {"opt": AdamW().init(params)},
                             {"inputs": tokens, "labels": tokens}, 0)
        assert torch.isfinite(metrics["loss"])
    finally:
        dist.destroy_process_group()
    for shape in ((1, 2, 1), (1, 1, 2)):
        mesh = types.SimpleNamespace(axis_names=("pipe", "data", "model"),
                                     devices=np.empty(shape))
        with pytest.raises(NotImplementedError, match=r"data or model axis.*ROADMAP A\.9\.4"):
            make_train_step(cfg, AdamW(), mesh=mesh, pipeline_stages=1, device="cpu")
    with pytest.raises(ValueError):
        ops.fwht(torch.randn(2, 8), use_kernel="sometimes")


_FL_ENTRY_POINTS = {
    "get_task": lambda: fl_tasks.get_task("dme", n_clients=2, d=32),
    "run_rounds": lambda: fl_rounds.run_rounds(
        fl_tasks.get_task("dme", device="cpu", n_clients=2, d=32), codec.RandK(k=4, d_block=32),
        cfg=fl_rounds.RoundConfig(n_rounds=1)),
    "cli": lambda: fl_run.main(["--smoke", "--task", "dme"]),
}


@pytest.mark.parametrize("name", sorted(_FL_ENTRY_POINTS))
def test_fl_entry_points_need_cuda_without_device(monkeypatch, name):
    """The FL layer runs on the card unless asked for the CPU: without CUDA
    its entry points raise, never fall back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        _FL_ENTRY_POINTS[name]()


def test_draws_from_numpy_takes_sparse_draws():
    signs = np.ones((3, 1, 4, 5), np.float32)
    cols = np.zeros((3, 1, 4, 5), np.int32)
    got = interop.draws_from_numpy({"signs": signs, "cols": cols}, "cpu")
    assert got["cols"].dtype == torch.int64 and got["signs"].shape == (3, 1, 4, 5)
    with pytest.raises(ValueError, match="one shape"):
        interop.draws_from_numpy({"signs": signs, "cols": cols[..., :4]}, "cpu")
    with pytest.raises(ValueError, match="4 dims"):
        interop.draws_from_numpy({"signs": signs[0], "cols": cols[0]}, "cpu")


def _tiny(arch: str, **over):
    cfg = configs.preset_config(arch, "tiny").replace(**over)
    params = transformer.init_params(cfg, 0, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 12), generator=torch.Generator().manual_seed(1))
    return cfg, params, tokens


def test_cpu_prefill_never_touches_the_kernel_build(monkeypatch):
    def no_build():
        raise AssertionError("the CPU prefill reached the CUDA build")

    monkeypatch.setattr(_build, "build", no_build)
    cfg, params, tokens = _tiny("gemma3-4b", attn_impl="flash")
    before = ops.launch_counts()
    cache = transformer.init_cache(cfg, 2, 16, device="cpu")
    logits, _ = transformer.prefill(params, cfg, cache, tokens)
    assert logits.shape == (2, 1, cfg.vocab_padded) and torch.isfinite(logits).all()
    assert ops.launch_counts() == before


@pytest.mark.parametrize("arch", ["mamba2-130m", "mixtral-8x22b"])
def test_unported_layers_raise(arch):
    """The layers once refused here (Mamba, the MoE FFN) now run: the
    forward gives finite logits."""
    cfg, params, tokens = _tiny(arch)
    logits, aux = transformer.forward(params, cfg, tokens)
    assert logits.shape == (2, 12, cfg.vocab_padded)
    assert torch.isfinite(logits).all() and torch.isfinite(aux)


def test_serve_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--preset", "tiny", "--prompt-len", "8", "--gen", "2"])
