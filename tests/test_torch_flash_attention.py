"""The port's flash attention against the JAX package's.

``repro_torch.kernels.ops.flash_attention`` runs its plain version on a CPU
tensor; it is held against ``repro.kernels.flash_attention_pallas`` in
interpret mode (q and kv tiles of 32) and against ``repro.kernels.ref``'s
oracle, on the same numpy inputs: rep 1 and 2, window 0 and 8, a q_offset
with Sq < Sk, float32 within 2e-5 (3e-5 / 1e-4 with a window or an offset,
the JAX package's own tolerances for its kernel) and bfloat16 within 2e-2.

The CUDA kernels run only on the card, so their arithmetic is repeated here
in torch on the CPU and held against the Pallas kernel and the plain
version at the same tolerances:

- ``_tensor_core_emulation``: the bf16 route (csrc/flash_attention_tc.cu),
  P carried as P_hi + P_lo, two bf16 values, into the P V product;
- ``_split_tf32_emulation``: the float32 route (csrc/flash_attention.cu),
  both products in split TF32 (three TF32 products a pair of operands).

The last test holds both routes against the plain version on the card and
skips elsewhere.
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
from repro_torch.kernels import ref as tref

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


def _online_softmax(q, k, v, *, rep, window, q_offset, bkv, scale_log2, scores, pv):
    """The kernels' online softmax over kv tiles of ``bkv`` keys, in float32:
    t = scores(q, k_tile) * scale_log2 (log2(e) folded into the scale), -1e9
    where masked, m the running row max, p = exp2(t - m) (0 where masked),
    ``pv(p, v_tile)`` -> (the P V product, the row sums of the P that entered
    it), and the output acc / max(l, 1e-30) in float32."""
    n_q, sq, dh = q.shape
    kf = torch.repeat_interleave(k, rep, 0).float()
    vf = torch.repeat_interleave(v, rep, 0).float()
    pos = q_offset + torch.arange(sq)[:, None]
    m = torch.full((n_q, sq, 1), -1e9)
    l = torch.zeros((n_q, sq, 1))
    acc = torch.zeros((n_q, sq, dh))
    for k0 in range(0, kf.shape[1], bkv):
        kt, vt = kf[:, k0:k0 + bkv], vf[:, k0:k0 + bkv]
        key = k0 + torch.arange(kt.shape[1])[None, :]
        ok = key <= pos
        if window:
            ok &= pos - key < window
        t = torch.where(ok, scores(q.float(), kt) * scale_log2, -1e9)
        m_new = torch.maximum(m, t.amax(-1, keepdim=True))
        p = torch.where(ok, torch.exp2(t - m_new), 0.0)
        corr = torch.exp2(m - m_new)
        prod, row_sum = pv(p, vt)
        l = l * corr + row_sum
        acc = acc * corr + prod
        m = m_new
    return acc / l.clamp_min(1e-30)


def _scale_log2(dh):
    """1/sqrt(dh) times log2(e), each rounded to float32 as the launchers do."""
    return float(np.float32(np.float32(1.0 / np.sqrt(dh)) * np.float32(np.log2(np.e))))


def _split_bf16(x):
    """x as hi + lo, two bf16 values: hi = bf16(x), lo = bf16(x - hi)."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _tensor_core_emulation(q, k, v, *, rep, window=0, q_offset=0):
    """The bf16 kernel's arithmetic (csrc/flash_attention_tc.cu) in torch:
    S = Q K^T in float32 from bf16 inputs, the scale 1/sqrt(dh) and log2(e)
    applied after the product (both rounded to float32 as the launcher
    does), exp2, kv tiles of the kernel's width (64 keys at d_head > 128,
    else 128), P split as P_hi + P_lo (two bf16 values) for the P V product,
    P_lo V first, then P_hi V, l summing P_hi + P_lo, the output
    acc / max(l, 1e-30) rounded to bf16."""
    dh = q.shape[2]

    def pv(p, vt):
        hi, lo = _split_bf16(p)
        return lo @ vt + hi @ vt, (hi + lo).sum(-1, keepdim=True)

    out = _online_softmax(q, k, v, rep=rep, window=window, q_offset=q_offset,
                          bkv=64 if dh > 128 else 128, scale_log2=_scale_log2(dh),
                          scores=lambda qf, kt: qf @ kt.transpose(1, 2), pv=pv)
    return out.to(torch.bfloat16)


def _tf32(x):
    """cvt.rna.tf32.f32 on the int32 view: round to nearest, ties away from
    zero, to 10 mantissa bits (the low 13 bits cleared)."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _split_tf32(x):
    """x as hi + lo, two TF32 values, as the kernel splits each fragment:
    hi = tf32(x), lo = tf32(x - hi)."""
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _split_mm(a, b):
    """a @ b in split TF32, the small terms first: lo hi, hi lo, hi hi. Each
    product of two TF32 values is exact in float32; the sums are float32."""
    a_hi, a_lo = _split_tf32(a)
    b_hi, b_lo = _split_tf32(b)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def f32_kv_tile(dh):
    """Keys per kv tile of the float32 kernel at this d_head: keep in step
    with ``Pick`` in csrc/flash_attention.cu (the tile sets where the online
    softmax rescales)."""
    return 24 if dh > 128 else 64


def _split_tf32_emulation(q, k, v, *, rep, window=0, q_offset=0):
    """The float32 kernel's arithmetic (csrc/flash_attention.cu) in torch:
    S = Q K^T in split TF32 from the unscaled float32 inputs, the scale
    1/sqrt(dh) and log2(e) applied after the product, exp2, kv tiles of the
    kernel's width, O += P V in split TF32 (P split like any operand), l
    summing P in float32, the output acc / max(l, 1e-30) in float32."""
    dh = q.shape[2]
    return _online_softmax(q, k, v, rep=rep, window=window, q_offset=q_offset,
                           bkv=f32_kv_tile(dh), scale_log2=_scale_log2(dh),
                           scores=lambda qf, kt: _split_mm(qf, kt.transpose(1, 2)),
                           pv=lambda p, vt: (_split_mm(p, vt), p.sum(-1, keepdim=True)))


# against the plain version: (n_kv, rep, sq, sk, dh, window, q_offset, q scale)
EMULATION_CASES = {
    "ragged-window-dh256": (1, 2, 200, 200, 256, 64, 0, 1.0),  # 4 kv tiles of 64, Sq past 128
    "ragged-offset-dh40": (2, 1, 100, 484, 40, 8, 384, 1.0),   # 4 kv tiles of 128, the last ragged
    "peaked-logits": (1, 2, 130, 130, 128, 0, 0, 8.0),         # q x 8: near one-hot rows
}


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c[7] == BF16])
def test_tensor_core_emulation_matches_pallas_kernel(name):
    case = CASES[name]
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _jax_side()[0][name])
    got = _tensor_core_emulation(q, k, v, rep=case[1], window=case[5], q_offset=case[6])
    atol, rtol = _tol(case)
    np.testing.assert_allclose(got.float().numpy(), _jax_side()[1][name][0], atol=atol, rtol=rtol)


@pytest.mark.parametrize("name", list(EMULATION_CASES))
def test_tensor_core_emulation_matches_plain_version(name):
    q, k, v, kw = _emulation_inputs(name, torch.bfloat16)
    got = _tensor_core_emulation(q, k, v, **kw)
    want = tref.flash_attention_ref(q, k, v, **kw)
    assert got.dtype == want.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)


def _emulation_inputs(name, dtype):
    n_kv, rep, sq, sk, dh, window, q_offset, q_scale = EMULATION_CASES[name]
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
               for shape in ((n_kv * rep, sq, dh), (n_kv, sk, dh), (n_kv, sk, dh)))
    q = q * q_scale  # a power of two: exact in bf16 and float32
    return q, k, v, dict(rep=rep, window=window, q_offset=q_offset)


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c[7] == F32])
def test_split_tf32_emulation_matches_pallas_kernel(name):
    case = CASES[name]
    q, k, v = (torch.from_numpy(a) for a in _jax_side()[0][name])
    got = _split_tf32_emulation(q, k, v, rep=case[1], window=case[5], q_offset=case[6])
    assert got.dtype == torch.float32
    atol, rtol = _tol(case)
    np.testing.assert_allclose(got.numpy(), _jax_side()[1][name][0], atol=atol, rtol=rtol)


@pytest.mark.parametrize("name", list(EMULATION_CASES))
def test_split_tf32_emulation_matches_plain_version(name):
    """Float32 twins of the bf16 emulation's cases (d_head 256 with a
    window, a ragged offset, peaked logits) at the float32 tolerances."""
    q, k, v, kw = _emulation_inputs(name, torch.float32)
    got = _split_tf32_emulation(q, k, v, **kw)
    want = tref.flash_attention_ref(q, k, v, **kw)
    atol, rtol = _tol(EMULATION_CASES[name][:7] + (F32,))
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol)


def _random_unit_floats(seed):
    """float32 in (0, 1]: uniform, and log-uniform down to 2^-100."""
    rng = np.random.default_rng(seed)
    uniform = 1.0 - rng.random(50_000)
    spread = np.exp2(-100.0 * rng.random(50_000))
    return torch.from_numpy(np.concatenate([uniform, spread]).astype(np.float32))


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_split_of_p_carries_16_bits(seed):
    """P_hi + P_lo, two bf16 values, is within 2^-16 P of P."""
    p = _random_unit_floats(seed)
    hi, lo = _split_bf16(p)
    assert bool(((p - (hi + lo)).abs() <= p * 2.0 ** -16).all())


@pytest.mark.parametrize("seed", [0, 1])
def test_tf32_split_carries_22_bits(seed):
    """hi and lo are TF32 values (the low 13 bits clear), hi is x rounded to
    nearest, and hi + lo is within 2^-22 |x| of x, either sign."""
    x = _random_unit_floats(seed) * torch.where(torch.arange(100_000) % 2 == 0, 1.0, -1.0)
    hi, lo = _split_tf32(x)
    for part in (hi, lo):
        assert bool((part.view(torch.int32) & 0x1FFF == 0).all())
    assert bool(((x - hi).abs() <= x.abs() * 2.0 ** -11).all())
    assert bool(((x - (hi + lo)).abs() <= x.abs() * 2.0 ** -22).all())


_REFUSED = ["d_head", "d_head_big", "rep", "dtype", "kv_shape", "float16", "misaligned",
            "cpu_tensor"]


@pytest.mark.parametrize(
    "dtype,bad",
    [pytest.param(torch.float32, bad, id=bad) for bad in _REFUSED]
    + [pytest.param(torch.bfloat16, bad, id=f"bf16-{bad}") for bad in _REFUSED + ["q_tiles"]])
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(dtype, bad):
    """Both routes (float32: the split-TF32 kernel; bf16: the wgmma one)
    raise before any launch; nothing falls back to the other route or
    to the plain version."""
    q, k, v = (torch.zeros(shape, dtype=dtype) for shape in ((4, 8, 16), (2, 8, 16), (2, 8, 16)))
    rep = 2
    if bad == "d_head":
        q, k, v = q[..., :12], k[..., :12], v[..., :12]
    elif bad == "d_head_big":
        q, k, v = (t.new_zeros(t.shape[:2] + (264,)) for t in (q, k, v))
    elif bad == "rep":
        rep = 3
    elif bad == "dtype":
        k = k.bfloat16() if dtype == torch.float32 else k.float()
    elif bad == "kv_shape":
        v = v[:, :4]
    elif bad == "float16":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "misaligned":  # contiguous, but one element past a 16-byte boundary
        q = torch.zeros(q.numel() + 1, dtype=dtype)[1:].view(q.shape)
    elif bad == "q_tiles":  # more 128-row q tiles than the grid takes (never touched)
        q = torch.empty((2, 128 * 65535 + 1, 8), dtype=dtype)
        k, v = k[..., :8], v[..., :8]
    # "cpu_tensor": all else valid, but the kernels run on the card only
    with pytest.raises(ValueError):
        tflash.flash_attention_cuda(q.contiguous(), k.contiguous(), v.contiguous(), rep=rep)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    """Both routes against the plain version on the card: ragged lengths,
    rep 1/2, windows (8, smaller than a kv tile; 64), offsets (130 to 384),
    d_head 64/128/256 and off them (8 to 248: column boxes partly or wholly
    past d_head), Sq 1, 129 and 200 against the kernels' 128-row q tiles; float32 (the split-TF32 kernel) and bfloat16 (the wgmma
    kernel, counted as its own route)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    rng = np.random.default_rng(3)
    for n_kv, rep, sq, sk, dh, window, q_offset in [(2, 1, 100, 100, 64, 0, 0),
                                                     (2, 2, 130, 130, 256, 64, 0),
                                                     (1, 2, 70, 454, 128, 0, 384),
                                                     (2, 1, 1, 385, 64, 8, 384),
                                                     (2, 2, 129, 129, 128, 8, 0),
                                                     (1, 2, 200, 200, 256, 8, 0),
                                                     (2, 2, 129, 513, 256, 0, 384),
                                                     (1, 2, 200, 584, 64, 8, 384),
                                                     (1, 1, 1, 1, 128, 0, 0),
                                                     # d_head off the padded widths
                                                     (1, 2, 100, 100, 8, 0, 0),
                                                     (2, 1, 70, 200, 16, 8, 130),
                                                     (1, 1, 50, 50, 32, 0, 0),
                                                     (1, 2, 129, 129, 40, 64, 0),
                                                     (1, 1, 64, 64, 96, 0, 0),
                                                     (2, 1, 100, 300, 200, 0, 200),
                                                     (1, 2, 130, 130, 248, 8, 0)]:
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to("cuda", dtype)
                       for s in ((n_kv * rep, sq, dh), (n_kv, sk, dh), (n_kv, sk, dh)))
            kw = dict(rep=rep, window=window, q_offset=q_offset)
            route = tflash.ROUTES[dtype][0]
            before = tops.launch_counts().get(route, 0)
            got = tops.flash_attention(q, k, v, use_kernel="force", **kw).float()
            assert tops.launch_counts().get(route, 0) == before + 1
            want = tops.flash_attention(q, k, v, use_kernel="never", **kw).float()
            torch.testing.assert_close(got, want, atol=tol, rtol=tol)
