"""The port's plain kernel versions (repro_torch.kernels.ref) against the JAX
package's oracles (repro.kernels.ref).

On the golden grid of tests/test_kernels.py (small integers, +-1 signs,
power-of-two scales, ragged chunk counts, shared and per-chunk signs) every
partial sum is exact in float32, so the two must agree bit for bit; on
random floats they agree to rtol 1e-6 / atol 1e-5 (sums may associate
differently). The CUDA kernels themselves run only on the card: the last
test holds them against these plain versions there and skips elsewhere.
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
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref


def _ints(rng, shape, hi=8):
    return rng.integers(-hi, hi, shape).astype(np.float32)


def _signs(rng, shape):
    return (rng.integers(0, 2, shape) * 2 - 1).astype(np.float32)


def _rows(rng, lead, k, d):
    out = np.stack([rng.permutation(d)[:k] for _ in range(int(np.prod(lead)))])
    return out.reshape(*lead, k).astype(np.int32)


def _same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_hadamard_matrix_matches():
    for d in (1, 2, 8, 64):
        np.testing.assert_array_equal(tref.hadamard_matrix(d), jref.hadamard_matrix(d))
    with pytest.raises(ValueError):
        tref.hadamard_matrix(12)


def _oracles(ref, x, signs, rows, z, v, mask, d, decode_sum=True):
    """Every SRHT oracle of one ``ref`` module on one cell's inputs (the
    decode sum's slot None without ``decode_sum``)."""
    n, c, _ = x.shape
    k = rows.shape[-1]
    s_full = ref_broadcast(ref, signs, (n, c, d))
    r_full = ref_broadcast(ref, rows, (n, c, k))
    return (
        ref.fwht_ref(x),
        ref.srht_encode_ref(x[0], signs[0, 0], rows[0, 0]),
        ref.srht_scatter_ref(z, rows, d),
        ref.fwht_rowsigns_ref(x, s_full, sign_pre=True, scale=0.25),
        ref.fwht_rowsigns_ref(x, s_full, sign_post=True, scale=0.25),
        ref.srht_encode_batch_ref(x, s_full, r_full),
        ref.srht_decode_sum_ref(z, signs, rows, d) if decode_sum else None,
        ref.srht_gram_apply_ref(v, signs, mask),
    )


def ref_broadcast(ref, a, shape):
    return torch.broadcast_to(a, shape) if ref is tref else jnp.broadcast_to(a, shape)


@contextlib.contextmanager
def _cheap_compiles():
    """Compile the JAX reference without XLA's costly optimisation passes.
    It runs once, so they cost more than they save, and they change no
    float semantics (no fast math either way)."""
    was = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        yield
    finally:
        jax.config.update("jax_disable_most_optimizations", was)


def _jax_cell(x, signs, rows, z, v, mask):
    """JAX's oracles on one cell. Under jit XLA pulls the decode sum's scale
    out of its client sum, which rounds differently from the eager oracle;
    so that oracle's per-client terms come out here and its final sum runs
    eagerly (``_cell``)."""
    d = x.shape[-1]
    terms = jref.fwht_rowsigns_ref(jref.srht_scatter_ref(z, rows, d), signs, sign_post=True,
                                   scale=1.0 / np.sqrt(d))
    return _oracles(jref, x, signs, rows, z, v, mask, d, decode_sum=False), terms


# (n, C, d, k, shared, draw_ints): the golden grid's cells (ragged chunk
# counts; one sign draw per client, or one per chunk) and one of random floats
CELLS = {
    "d8-shared": (3, 3, 8, 2, True, True),
    "d64-per_chunk": (3, 5, 64, 16, False, True),
    "d512-shared": (3, 5, 512, 128, True, True),
    "d4096-per_chunk": (3, 3, 4096, 1024, False, True),
    "random": (4, 5, 256, 32, False, False),
}


def _inputs(seed, n, c, d, k, shared, draw_ints):
    rng = np.random.default_rng(seed)
    cs = 1 if shared else c
    x = _ints(rng, (n, c, d)) if draw_ints else rng.standard_normal((n, c, d)).astype(np.float32)
    signs = _signs(rng, (n, cs, d))
    rows = _rows(rng, (n, cs), k, d)
    z = _ints(rng, (n, c, k)) if draw_ints else rng.standard_normal((n, c, k)).astype(np.float32)
    v = _ints(rng, (c, d), hi=4) if draw_ints else rng.standard_normal((c, d)).astype(np.float32)
    mask = np.zeros((n, cs, d), np.float32)
    np.put_along_axis(mask, rows, 1.0, axis=-1)
    return x, signs, rows, z, v, mask


@functools.cache
def _jax_cells() -> dict:
    """name -> (inputs, JAX's oracles) for every cell, from ONE compiled
    program: one compile is far cheaper than one per cell."""
    inputs = {name: _inputs(i, *cell) for i, (name, cell) in enumerate(CELLS.items())}
    args = {name: tuple(jnp.asarray(a) for a in inp) for name, inp in inputs.items()}
    cells = {}
    with _cheap_compiles():
        out = jax.jit(lambda args: {name: _jax_cell(*a) for name, a in args.items()})(args)
        for name, (want, terms) in out.items():
            want = list(want)
            want[6] = jnp.sum(terms, axis=0)
            cells[name] = inputs[name], [np.asarray(w) for w in want]
    return cells


def _cell(name):
    inputs, want = _jax_cells()[name]
    d = inputs[0].shape[-1]
    return _oracles(tref, *[_t(a) for a in inputs], d=d), want


@pytest.mark.parametrize("name", [name for name in CELLS if name != "random"])
def test_golden_bitwise(name):
    """Every SRHT oracle, bit for bit, on one cell of the golden grid."""
    got, want = _cell(name)
    d = CELLS[name][2]
    for g, w in zip(got[:-1], want[:-1]):
        _same(g, w)
    if d <= 512:  # the double transform leaves the exact range above (test_kernels.py)
        _same(got[-1], want[-1])
    else:
        np.testing.assert_allclose(got[-1].numpy(), want[-1], rtol=1e-6, atol=1e-5 * d)


@pytest.mark.parametrize("name", [name for name in CELLS if name != "random"])
def test_decode_sum_schedule_matches_jax_oracle(name):
    """The CUDA decode sum's per-client order, as tests/test_torch_fwht_schedule.py
    emulates it, against the JAX oracle of the same cell, bit for bit."""
    from test_torch_fwht_schedule import emulate_decode_sum

    inputs, want = _jax_cells()[name]
    _, signs, rows, z, _, _ = (_t(a) for a in inputs)
    d = CELLS[name][2]
    _same(emulate_decode_sum(z, signs, rows, d, 1.0 / np.sqrt(d)), want[6])


def test_random_floats_close():
    got, want = _cell("random")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-5)


def test_ops_plain_paths():
    """The dispatching ops on CPU tensors take the plain versions: the bf16
    FWHT computes in float32 and rounds once to bf16, as the kernel does, and
    the dense SRHT matrix is H[rows] * signs / sqrt(d)."""
    rng = np.random.default_rng(3)
    c, d, k = 3, 64, 16
    x = _ints(rng, (c, d))
    signs = _signs(rng, (d,))
    rows = _rows(rng, (1,), k, d)[0]
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = tops.fwht(xb, scale=0.5)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, (tref.fwht_ref(xb.float()) * 0.5).to(torch.bfloat16))
    enc = tops.srht_encode(_t(x), _t(signs), _t(rows))
    assert torch.equal(enc, tref.srht_encode_ref(_t(x), _t(signs), _t(rows)))
    g = tops.srht_rows_matrix(_t(signs), _t(rows), d)
    want = (jref.hadamard_matrix(d)[rows] * signs[None, :]) * np.float32(1.0 / np.sqrt(d))
    np.testing.assert_array_equal(g.numpy(), want)
    # the adjoint: <G x, u> == <x, G^T u>
    u = torch.from_numpy(rng.standard_normal((c, k)).astype(np.float32))
    lhs = (enc * u).sum()
    rhs = (_t(x) * tops.srht_decode(u, _t(signs), _t(rows), d)).sum()
    assert torch.allclose(lhs, rhs, rtol=1e-5)


def _cg_step_case(x, signs, rows, use_kernel):
    """One in-place CG step from r = x[1], p = x[0] with chunk 0 frozen;
    -> the new (x, r, p, rs, done)."""
    x0, r, p = x[2].clone(), x[1].clone(), x[0].clone()
    rs = tref.row_dot_ref(r, r)
    done = torch.zeros(rs.shape, dtype=torch.bool, device=x.device)
    done[0] = True
    c1 = torch.full((x.shape[1],), 0.75, device=x.device)
    tops.srht_cg_step(x0, r, p, rs, done, 1.0 - c1, c1, 1e-8 * rs, signs, rows,
                      use_kernel=use_kernel)
    return x0, r, p, rs, done


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    """Each CUDA kernel against its plain version on the card, golden grid;
    K1, K3, the Gram apply and the CG step also at d = 1024 and 2048 (one
    warp a row, and a row across the warps of a block)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    rng = np.random.default_rng(5)
    n, c, k = 3, 5, 64
    dev = "cuda"
    for d in (512, 1024, 2048):
        x = torch.from_numpy(_ints(rng, (n, c, d))).to(dev)
        signs = torch.from_numpy(_signs(rng, (n, 1, d))).to(dev)
        rows = torch.from_numpy(_rows(rng, (n, 1), k, d)).long().to(dev)
        cases = [
            lambda u: tops.srht_encode(x[0], signs[0, 0], rows[0, 0], use_kernel=u),
            lambda u: tops.srht_decode_sum(x[..., :k].contiguous(), signs, rows, d, use_kernel=u),
            lambda u: tops.srht_gram_apply(x[0], signs, rows, use_kernel=u),
            lambda u: torch.cat([t.float().flatten() for t in _cg_step_case(x, signs, rows, u)]),
        ]
        if d == 512:
            cases += [
                lambda u: tops.srht_encode_batch(x, signs.expand(n, c, d), rows.expand(n, c, k),
                                                 use_kernel=u),
            ]
        for case in cases:
            assert torch.equal(case("force"), case("never"))
