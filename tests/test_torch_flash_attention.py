"""The port's flash attention against the JAX package's.

``repro_torch.kernels.ops.flash_attention`` runs its plain version on a CPU
tensor; it is held against ``repro.kernels.flash_attention_pallas`` in
interpret mode (q and kv tiles of 32) and against ``repro.kernels.ref``'s
oracle, on the same numpy inputs: rep 1 and 2, window 0 and 8, a q_offset
with Sq < Sk, float32 within 2e-5 (3e-5 / 1e-4 with a window or an offset,
the JAX package's own tolerances for its kernel) and bfloat16 within 2e-2.
The CUDA kernel itself runs only on the card: the last test holds it against
the plain version there and skips elsewhere.
"""
from __future__ import annotations

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops as tops

F32, BF16 = "float32", "bfloat16"
# name: (n_kv, rep, sq, sk, dh, window, q_offset, dtype)
CASES = {
    "causal-rep1": (2, 1, 64, 64, 16, 0, 0, F32),
    "window-rep2": (1, 2, 64, 64, 32, 8, 0, F32),
    "offset-window-rep1": (2, 1, 32, 64, 16, 8, 32, F32),
    "window-rep2-bf16": (1, 2, 64, 64, 16, 8, 0, BF16),
    "offset-rep1-bf16": (2, 1, 32, 64, 16, 0, 32, BF16),
}
# against the oracle only: two more on the tiles (each Pallas interpret case
# costs a compile), and Sq, Sk off the 32-row tiles, which Pallas does not take
ORACLE_ONLY = {
    "causal-rep2": (2, 2, 64, 64, 16, 0, 0, F32),
    "offset-rep2": (1, 2, 32, 64, 16, 0, 32, F32),
    "ragged-window-rep2": (1, 2, 40, 40, 16, 8, 0, F32),
    "ragged-offset-rep1": (2, 1, 24, 56, 16, 0, 32, F32),
}


def _inputs(case, seed):
    n_kv, rep, sq, sk, dh = case[:5]
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((n_kv * rep, sq, dh), (n_kv, sk, dh), (n_kv, sk, dh)))


def _tol(case):
    window, q_offset, dtype = case[5:]
    if dtype == BF16:
        return 2e-2, 2e-2
    return (3e-5, 1e-4) if window or q_offset else (2e-5, 2e-5)


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


@functools.cache
def _jax_side():
    """Inputs per case, and JAX's Pallas (interpret) and oracle outputs as
    float32 numpy, from ONE compiled program."""
    cases = {**CASES, **ORACLE_ONLY}
    inputs = {name: _inputs(case, seed) for seed, (name, case) in enumerate(cases.items())}

    def run(arrays):
        out = {}
        for name, case in cases.items():
            rep, window, q_offset, dtype = case[1], case[5], case[6], case[7]
            q, k, v = (a.astype(dtype) for a in arrays[name])
            kw = dict(rep=rep, window=window, q_offset=q_offset)
            want = jref.flash_attention_ref(q, k, v, **kw).astype(jnp.float32)
            got = None
            if name in CASES:
                got = flash_attention_pallas(q, k, v, q_tile=32, kv_tile=32, interpret=True,
                                             **kw).astype(jnp.float32)
            out[name] = (got, want)
        return out

    with _cheap_compiles():
        res = jax.jit(run)(inputs)
    return inputs, jax.tree.map(np.asarray, res)


def _port(name, case):
    inputs, _ = _jax_side()
    dtype = getattr(torch, case[7])
    q, k, v = (torch.from_numpy(a).to(dtype) for a in inputs[name])
    out = tops.flash_attention(q, k, v, rep=case[1], window=case[5], q_offset=case[6])
    assert out.dtype == dtype and out.shape == q.shape
    return out.float().numpy()


@pytest.mark.parametrize("name", list(CASES))
def test_plain_version_matches_pallas_kernel_and_oracle(name):
    case = CASES[name]
    got = _port(name, case)
    pallas, oracle = _jax_side()[1][name]
    atol, rtol = _tol(case)
    np.testing.assert_allclose(got, pallas, atol=atol, rtol=rtol)
    np.testing.assert_allclose(got, oracle, atol=atol, rtol=rtol)


@pytest.mark.parametrize("name", list(ORACLE_ONLY))
def test_plain_version_matches_oracle(name):
    case = ORACLE_ONLY[name]
    atol, rtol = _tol(case)
    np.testing.assert_allclose(_port(name, case), _jax_side()[1][name][1], atol=atol, rtol=rtol)


@pytest.mark.parametrize("bad", ["d_head", "d_head_big", "rep", "dtype", "kv_shape"])
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(bad):
    q, k, v = torch.zeros(4, 8, 16), torch.zeros(2, 8, 16), torch.zeros(2, 8, 16)
    rep = 2
    if bad == "d_head":
        q, k, v = q[..., :12], k[..., :12], v[..., :12]
    elif bad == "d_head_big":
        q, k, v = (t.new_zeros(t.shape[:2] + (264,)) for t in (q, k, v))
    elif bad == "rep":
        rep = 3
    elif bad == "dtype":
        k = k.bfloat16()
    else:
        v = v[:, :4]
    with pytest.raises(ValueError):
        tflash.flash_attention_cuda(q.contiguous(), k.contiguous(), v.contiguous(), rep=rep)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    """The kernel against its plain version on the card: ragged lengths,
    rep 1/2, a window, an offset, d_head 64 and 256, float32 and bfloat16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    rng = np.random.default_rng(3)
    for n_kv, rep, sq, sk, dh, window, q_offset in [(2, 1, 100, 100, 64, 0, 0),
                                                     (2, 2, 130, 130, 256, 64, 0),
                                                     (1, 2, 70, 454, 128, 0, 384)]:
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to("cuda", dtype)
                       for s in ((n_kv * rep, sq, dh), (n_kv, sk, dh), (n_kv, sk, dh)))
            kw = dict(rep=rep, window=window, q_offset=q_offset)
            got = tops.flash_attention(q, k, v, use_kernel="force", **kw).float()
            want = tops.flash_attention(q, k, v, use_kernel="never", **kw).float()
            torch.testing.assert_close(got, want, atol=tol, rtol=tol)
