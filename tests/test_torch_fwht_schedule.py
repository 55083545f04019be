"""The index plan of the register-resident butterfly (Butterfly<LOG_D> in
src/repro_torch/kernels/csrc/fwht_common.cuh, which K1 fwht.cu and K3 and
K4 srht_fused.cu run), emulated in torch on the CPU.

The CUDA kernels run only on the card. What usually goes wrong in such a
kernel is the index mapping: which (warp, lane, register) holds which element
in each layout, where the swizzled shared tile puts it, and whether the
stages keep the reference's order. The emulation below follows the kernels'
index formulas step by step (the tile's addresses, layouts A, B and C, the
stages on register bits, K1's 16-byte load layout and row gather, K3's
scatter, zero restore, sign, scale and client-order accumulation, K4's row
gather into a zero tile and the CG step's folds and update) with the same
float32 operations, so it must equal the plain versions bit for bit: K1's
for every width 2 to 32768 on random floats, K3's on the golden grid, K4's
(the Gram apply and the CG step) on both.
It also checks that every shared-memory access of the plan is free of bank
conflicts. No JAX here; tests/test_torch_kernels_ref.py holds the K3
emulation against the JAX oracle on its golden cells.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref as tref


def swz(p: torch.Tensor) -> torch.Tensor:
    """Shared-tile address of tile element p (fwht_common.cuh ``swz``)."""
    return p ^ (((p >> 5) & 7) << 2)


class Plan:
    """Butterfly<LOG_D>: a group of ``threads`` threads, 32 registers each,
    owns a tile of ``tile`` elements (``rows`` rows of d)."""

    def __init__(self, log_d: int):
        self.d = d = 1 << log_d
        self.tile = max(d, 1024)
        self.warps = w = self.tile // 1024
        self.threads = self.tile // 32
        self.rows = self.tile // d
        self.stages = (min(log_d, 5), 0 if log_d < 5 else min(log_d - 5, 5), max(log_d - 10, 0))
        g = torch.arange(self.threads)[:, None]
        r = torch.arange(32)[None, :]
        # tile elements of layouts A, B and C (the final one)
        self.a = 32 * g + r
        self.b = 1024 * (g >> 5) + (g & 31) + 32 * r
        self.final = self.b if w == 1 else 1024 * (r % w) + 32 * w * (r // w) + g
        # their shared-tile addresses as the kernel writes them (a_addr,
        # b_addr, final_addr); layout A is accessed 16 bytes (float4 q) at a time
        self.a_addr = 32 * g + 4 * ((r // 4) ^ (g & 7)) + r % 4
        self.b_addr = 1024 * (g >> 5) + 32 * r + ((g & 31) ^ ((r & 7) << 2))
        hi = w * (r // w)
        self.final_addr = (self.b_addr if w == 1
                           else 1024 * (r % w) + 32 * hi + (swz(g) ^ ((hi & 7) << 2)))


def stages(v: torch.Tensor, count: int) -> torch.Tensor:
    """The stages of register bits 0 .. count-1, lowest first: (a + b, a - b)
    on registers (r, r + h) for every r with bit h clear."""
    t = v.shape[0]
    for s in range(count):
        h = 1 << s
        w = v.reshape(t, 32 // (2 * h), 2, h)
        v = torch.stack([w[:, :, 0] + w[:, :, 1], w[:, :, 0] - w[:, :, 1]], dim=2).reshape(t, 32)
    return v


def transform(plan: Plan, v: torch.Tensor, tile: torch.Tensor) -> torch.Tensor:
    """``Butterfly::transform``: v in layout A -> v at ``plan.final``."""
    v = stages(v, plan.stages[0])
    tile[plan.a_addr] = v
    v = tile[plan.b_addr]
    v = stages(v, plan.stages[1])
    if plan.warps > 1:
        tile[plan.b_addr] = v
        v = tile[plan.final_addr]
        v = stages(v, plan.stages[2])
    return v


def load_layout(plan: Plan, vec: int) -> torch.Tensor:
    """K1's coalesced load: thread g, vector q, element e holds tile element
    vec (q threads + g) + e. -> (threads, 32) element indices."""
    g = torch.arange(plan.threads)[:, None, None]
    q = torch.arange(32 // vec)[None, :, None]
    e = torch.arange(vec)[None, None, :]
    return (vec * (q * plan.threads + g) + e).reshape(plan.threads, 32)


def emulate_fwht(x: torch.Tensor, signs, rows, scale: float, vec: int) -> torch.Tensor:
    """K1 (``fwht_butterfly_kernel``) on float32 values x (R, d); ``vec``
    elements a 16-byte load (4 for float32 input, 8 for bf16)."""
    n_rows, d = x.shape
    plan = Plan(d.bit_length() - 1)
    flat = x.reshape(-1)
    p_load = load_layout(plan, vec)
    # float4 stores of each loaded vector into the tile
    load_addr = swz(p_load - p_load % 4) + p_load % 4
    sg = None if signs is None else signs[p_load % d]
    k = d if rows is None else rows.shape[0]
    out = torch.full((n_rows * k,), float("nan"))
    for task in range(-(-n_rows // plan.rows)):
        row0 = task * plan.rows
        valid = min(n_rows - row0, plan.rows) * d
        vals = torch.where(p_load < valid, flat[(row0 * d + p_load).clamp(max=flat.numel() - 1)],
                           torch.zeros(()))
        if sg is not None:
            vals = vals * sg
        tile = torch.full((plan.tile,), float("nan"))
        tile[load_addr] = vals
        assert not tile.isnan().any(), "the load layout leaves a tile element unwritten"
        v = transform(plan, tile[plan.a_addr], tile)
        if rows is None:
            keep = plan.final < valid
            out[row0 * d + plan.final[keep]] = v[keep] * scale
        else:
            tile[plan.final_addr] = v
            t = torch.arange(valid // d * k)
            rho = t // k
            j = rows[t - rho * k]
            inside = (j >= 0) & (j < d)
            got = tile[swz(rho * d + j.clamp(0, d - 1))] * scale
            out[row0 * k + t] = torch.where(inside, got, torch.full((), float("nan")))
    return out.reshape(n_rows, k)


def emulate_decode_sum(z: torch.Tensor, signs: torch.Tensor, rows: torch.Tensor, d: int,
                       scale: float) -> torch.Tensor:
    """K3 (``decode_sum_butterfly_kernel``): z (n, C, k), signs (n, C|1, d),
    rows (n, C|1, k). -> (C, d)"""
    n, c, k = z.shape
    plan = Plan(d.bit_length() - 1)
    rows_pc, signs_pc = rows.shape[1] == c, signs.shape[1] == c
    out = torch.full((c * d,), float("nan"))
    p = plan.final
    for task in range(-(-c // plan.rows)):
        c0 = task * plan.rows
        nc = min(c - c0, plan.rows)
        ztile = torch.zeros(plan.tile)
        xtile = torch.full((plan.tile,), float("nan"))  # read before written -> NaN out
        acc = torch.full((plan.threads, 32), -0.0)
        keep = p < nc * d
        for i in range(n):
            t = torch.arange(nc * k)
            rho = t // k
            j = rows[i, c0 + rho if rows_pc else 0, t - rho * k].long()
            inside = (j >= 0) & (j < d)
            addr = swz(rho * d + j)[inside]
            ztile[addr] = z[i, c0 + rho, t - rho * k][inside]
            v = ztile[plan.a_addr]
            ztile[addr] = 0.0
            assert not ztile.any(), "the zero restore missed a scattered element"
            v = transform(plan, v, xtile)
            rho_p = (p // d).clamp(max=nc - 1)
            s = signs[i, c0 + rho_p if signs_pc else 0, p % d]
            acc = torch.where(keep, acc + v * s * scale, acc)
        out[c0 * d + p[keep]] = acc[keep]
    return out.reshape(c, d)


def _distinct(groups: torch.Tensor) -> bool:
    """True when every column holds distinct values along dim 1."""
    srt = torch.sort(groups, dim=1).values
    return bool((srt.diff(dim=1) != 0).all())


def check_no_bank_conflicts(plan: Plan) -> None:
    """4-byte accesses: the 32 lanes of a warp on 32 banks; 16-byte
    accesses: the 8 lanes of each quarter warp on 8 distinct 16-byte groups."""
    def scalar(addr):
        assert _distinct((addr % 32).reshape(-1, 32, addr.shape[1])), "4-byte bank conflict"

    def vector(addr):  # one column per float4
        assert _distinct(((addr // 4) % 8).reshape(-1, 8, addr.shape[1])), "16-byte conflict"

    scalar(plan.b_addr)
    scalar(plan.final_addr)
    vector(plan.a_addr[:, ::4])
    for vec in (4, 8):
        p = load_layout(plan, vec)
        vector(swz(p[:, ::4]))


@pytest.mark.parametrize("log_d", range(1, 16))
def test_fwht_plan_matches_plain_version(log_d):
    """K1's plan, bit for bit: the bare transform against fwht_ref, and the
    encode (signs, scale, gather with an out-of-range row reading NaN) against
    the plain version, for both load layouts; a ragged last tile where it
    holds several rows. Every shared access of the plan is conflict-free."""
    d = 1 << log_d
    plan = Plan(log_d)
    for index, addr in ((plan.a, plan.a_addr), (plan.b, plan.b_addr),
                        (plan.final, plan.final_addr)):
        assert torch.equal(addr, swz(index)), "an address form is not the tile's swizzle"
    check_no_bank_conflicts(plan)
    rng = np.random.default_rng(log_d)
    n_rows = plan.rows + 1 if plan.rows > 1 else 2
    x = torch.from_numpy(rng.standard_normal((n_rows, d)).astype(np.float32))
    signs = torch.from_numpy((rng.integers(0, 2, d) * 2 - 1).astype(np.float32))
    k = max(1, d // 4)
    rows = torch.from_numpy(rng.permutation(d)[:k].astype(np.int64))
    rows[-1] = d  # out of range: NaN, as jnp.take fills
    scale = 1.0 / np.sqrt(d)
    bare = tref.fwht_ref(x)
    want = torch.index_select(tref.fwht_ref(x * signs) * scale, -1, rows[:-1])
    for vec in (4, 8):
        assert torch.equal(emulate_fwht(x, None, None, 1.0, vec), bare)
        got = emulate_fwht(x, signs, rows, scale, vec)
        assert torch.equal(got[:, :-1], want)
        assert got[:, -1].isnan().all()


def _golden(seed, n, c, d, k, shared):
    rng = np.random.default_rng(seed)
    cs = 1 if shared else c
    z = rng.integers(-8, 8, (n, c, k)).astype(np.float32)
    signs = (rng.integers(0, 2, (n, cs, d)) * 2 - 1).astype(np.float32)
    rows = np.stack([rng.permutation(d)[:k] for _ in range(n * cs)]).reshape(n, cs, k)
    return torch.from_numpy(z), torch.from_numpy(signs), torch.from_numpy(rows.astype(np.int64))


# (n, C, d, k, shared): the golden grid's widths, its edges, and the main
# path's (4 clients, k = 64 of d = 1024)
DECODE_CELLS = {
    "d2-per_chunk": (3, 9, 2, 1, False),
    "d8-shared": (3, 3, 8, 2, True),
    "d32-per_chunk": (3, 5, 32, 8, False),
    "d64-per_chunk": (3, 5, 64, 16, False),
    "d512-shared": (3, 5, 512, 128, True),
    "d1024-shared": (4, 3, 1024, 64, True),
    "d2048-per_chunk": (3, 3, 2048, 512, False),
    "d16384-shared": (3, 2, 16384, 4096, True),
}


@pytest.mark.parametrize("name", DECODE_CELLS)
def test_decode_sum_order_matches_plain_version(name):
    """K3's per-client order on the golden grid, bit for bit."""
    n, c, d, k, shared = DECODE_CELLS[name]
    z, signs, rows = _golden(len(name), n, c, d, k, shared)
    got = emulate_decode_sum(z, signs, rows, d, 1.0 / np.sqrt(d))
    assert torch.equal(got, tref.srht_decode_sum_ref(z, signs, rows, d))


# ----------------------------------------------------------------- K4

STAGE_SIGN_BYTES = 32 * 1024  # srht_fused.cu kStageSignBytes: shared signs staged up to this


def row_sum(plan: Plan, t: torch.Tensor) -> torch.Tensor:
    """``row_sum``: every register (final layout) becomes its row's total,
    by register folds, ``__shfl_down_sync`` folds (a lane past 31 reads its
    own value) and the broadcast; above d = 1024 the folds of
    ``cg_epilogue_wide`` and ``cross_warp_sum``."""
    t = t.clone()
    lane = torch.arange(32)
    if plan.warps == 1:
        regs = max(plan.d // 32, 1)  # registers a row
        lanes = min(plan.d, 32)      # lanes a row
        hr = regs // 2
        while hr >= 1:
            for r in range(32):
                if r % regs < hr:
                    t[:, r] = t[:, r] + t[:, r + hr]
            hr //= 2
        h = lanes // 2
        while h >= 1:
            src = torch.where(lane + h < 32, lane + h, lane)
            for r in range(0, 32, regs):
                t[:, r] = t[:, r] + t[src, r]
            h //= 2
        for r in range(0, 32, regs):
            s = t[lane & ~(lanes - 1), r]
            for q in range(regs):
                t[:, r + q] = s
        return t
    # above 1024 (cg_epilogue_wide): each group of W registers (r / W fixed)
    # by halving_sum, then the groups, then cross_warp_sum
    w = plan.warps
    gs = [halving_sum([t[:, w * q + m] for m in range(w)]) for q in range(32 // w)]
    red = halving_sum(gs)  # red[g]
    s = halving_sum([red[32 * m + lane] for m in range(w)])
    h = 16
    while h >= 1:
        s = s + s[torch.where(lane + h < 32, lane + h, lane)]
        h //= 2
    t[:] = s[0]
    return t


def halving_sum(a: list) -> torch.Tensor:
    """``halving_sum``: a[j] += a[j + h] for j < h, h = N/2, ..., 1."""
    a = list(a)
    h = len(a) // 2
    while h >= 1:
        for j in range(h):
            a[j] = a[j] + a[j + h]
        h //= 2
    return a[0]


def emulate_gram(v: torch.Tensor, signs: torch.Tensor, rows: torch.Tensor, scale: float,
                 state: dict | None = None):
    """K4 (``gram_body``): v (C, d) the rows of the p tile, signs (n, C|1, d),
    rows (n, C|1, k). Without ``state`` the Gram apply
    (``gram_apply_butterfly_kernel``) -> (C, d); with state {x, r, rs, done,
    c0, c1, tol2} the CG step (``cg_step_butterfly_kernel``) -> the new
    (x, r, p, rs, done)."""
    c, d = v.shape
    n, k = signs.shape[0], rows.shape[-1]
    plan = Plan(d.bit_length() - 1)
    signs_pc, rows_pc = signs.shape[1] == c and c != 1, rows.shape[1] == c and c != 1
    staged = not signs_pc and 4 * n * plan.tile <= STAGE_SIGN_BYTES
    flat = v.reshape(-1)
    p_load = load_layout(plan, 4)
    load_addr = swz(p_load - p_load % 4) + p_load % 4
    final = plan.final
    if state is None:
        out = torch.full((c * d,), float("nan"))
    else:
        x, r, p = (t.clone().reshape(-1) for t in (state["x"], state["r"], v))
        rs, done = state["rs"].clone().reshape(-1), state["done"].clone().reshape(-1)
        c0v, c1v, tol2 = state["c0"], state["c1"], state["tol2"].reshape(-1)
    for task in range(-(-c // plan.rows)):
        c0 = task * plan.rows
        nc = min(c - c0, plan.rows)
        valid = nc * d
        if state is not None and bool(done[c0:c0 + nc].all()):
            continue  # every chunk done: the task is skipped
        ptile = torch.full((plan.tile,), float("nan"))
        ptile[load_addr] = torch.where(
            p_load < valid, flat[(c0 * d + p_load).clamp(max=flat.numel() - 1)], torch.zeros(()))
        ztile = torch.zeros(plan.tile)
        acc = torch.full((plan.threads, 32), -0.0)
        for i in range(n):
            si = signs[i].reshape(-1)
            if staged:  # client i's tile: element q at swz(q) holds s_i[q % d]
                st = torch.empty(plan.tile)
                q = torch.arange(plan.tile)
                st[swz(q)] = si[q % d]
                s_a, s_f = st[plan.a_addr], st[plan.final_addr]
            else:
                def at(e):
                    idx = c0 * d + e if signs_pc else e % d
                    return torch.where(e < valid, si[idx.clamp(max=si.numel() - 1)],
                                       torch.zeros(()))
                s_a, s_f = at(plan.a), at(final)
            t = torch.arange(nc * k)
            rho = t // k
            j = rows[i, c0 + rho if rows_pc else 0, t - rho * k].long()
            pos = swz(rho * d + j)
            vv = torch.where(plan.a < valid, ptile[plan.a_addr] * s_a, ptile[plan.a_addr])
            xtile = torch.full((plan.tile,), float("nan"))
            vv = transform(plan, vv, xtile)
            xtile[plan.final_addr] = vv
            ztile[pos] = xtile[pos]
            vv = ztile[plan.a_addr]
            ztile[pos] = 0.0
            assert not ztile.any(), "the zero restore missed a gathered element"
            vv = transform(plan, vv, xtile)
            acc = acc + vv * s_f * scale
        keep = final < valid
        if state is None:
            out[c0 * d + final[keep]] = acc[keep]
            continue
        # the CG epilogue (cg_epilogue; above 1024 cg_epilogue_wide, whose folds
        # row_sum follows)
        row = final // d
        ch = c0 + row.clamp(max=nc - 1)
        live = keep & ~done[ch]
        cc0 = c0v if c0v.dim() == 0 else c0v[ch]
        cc1 = c1v if c1v.dim() == 0 else c1v[ch]
        pv = ptile[plan.final_addr]
        ap = cc0 * pv + cc1 * acc
        pap = row_sum(plan, pv * ap)
        alpha = rs[ch] / torch.where(pap > 0, pap, torch.ones(()))
        e = c0 * d + final.clamp(max=valid - 1)
        x[e[live]] = (x[e] + alpha * pv)[live]
        r2 = torch.where(live, r[e] - alpha * ap, torch.zeros(()))
        r[e[live]] = r2[live]
        rs2 = row_sum(plan, r2 * r2)
        done2 = rs2 <= tol2[ch]
        bet = rs2 / torch.where(rs[ch] > 0, rs[ch], torch.ones(()))
        upd = live & ~done2
        p[e[upd]] = (r2 + bet * pv)[upd]
        owner = live & (final % d == 0)
        rs[ch[owner]] = rs2[owner]
        done[ch[owner]] = done2[owner]
    if state is None:
        return out.reshape(c, d)
    return x.reshape(c, d), r.reshape(c, d), p.reshape(c, d), rs[:, None], done[:, None]


# (n, C, d, k, shared): d = 2 (several rows a lane), 64 (several rows a
# warp), 1024 (the main path's, a row a warp), 2048 and 16384 (a row across
# the warps of a block; 16384 reads its shared signs from device memory)
GRAM_CELLS = {
    "d2-per_chunk": (3, 9, 2, 1, False),
    "d64-shared": (3, 5, 64, 16, True),
    "d1024-shared": (4, 3, 1024, 64, True),
    "d1024-per_chunk": (4, 3, 1024, 64, False),
    "d2048-per_chunk": (3, 3, 2048, 512, False),
    "d16384-shared": (3, 3, 16384, 4096, True),
}


def _gram_inputs(name: str, golden: bool) -> tuple:
    """(v, signs, rows, CG state): small integers on the golden grid, else
    random floats. The state has chunk 0 done (frozen) and chunk 1 with a
    tolerance it meets in this step; c0, c1 one value, or one per chunk for
    the per-chunk cells (as r_mode="est" gives)."""
    n, c, d, k, shared = GRAM_CELLS[name]
    rng = np.random.default_rng(len(name) + 100 * golden)
    _, signs, rows = _golden(len(name), n, c, d, k, shared)

    def vals(shape):
        if golden:
            return torch.from_numpy(rng.integers(-4, 4, shape).astype(np.float32))
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    v, x, r = vals((c, d)), vals((c, d)), vals((c, d))
    rs = tref.row_dot_ref(r, r)
    tol2 = 1e-8 * rs
    tol2[1] = 3.0e38
    done = torch.zeros((c, 1), dtype=torch.bool)
    done[0] = True
    if shared:
        c0, c1 = torch.tensor(0.125), torch.tensor(0.875)
    else:
        c1 = torch.from_numpy(rng.uniform(0.1, 0.9, c).astype(np.float32))
        c0 = 1.0 - c1 + 0.01
    state = dict(x=x, r=r, rs=rs, done=done, c0=c0, c1=c1, tol2=tol2)
    return v, signs, rows, state


def _mask(rows: torch.Tensor, d: int) -> torch.Tensor:
    return tref.srht_scatter_ref(torch.ones(rows.shape), rows, d)


@pytest.mark.parametrize("golden", [True, False], ids=["golden", "random"])
@pytest.mark.parametrize("name", GRAM_CELLS)
def test_gram_plan_matches_plain_version(name, golden):
    """K4's plan, bit for bit: the Gram apply (rows gathered into the zero
    tile, the trip back to layout A, the second transform, sign, scale and
    client-order sum) against srht_gram_apply_ref, and the CG step (the
    epilogue's halving reductions and update, a frozen chunk, one that
    converges) against srht_cg_step_ref."""
    v, signs, rows, st = _gram_inputs(name, golden)
    d = v.shape[-1]
    mask = _mask(rows, d)
    want = tref.srht_gram_apply_ref(v, signs, mask)
    assert torch.equal(emulate_gram(v, signs, rows, 1.0 / d), want)
    got = emulate_gram(v, signs, rows, 1.0 / d, st)
    want = tref.srht_cg_step_ref(st["x"], st["r"], v, st["rs"], st["done"], st["c0"], st["c1"],
                                 st["tol2"], signs, mask)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert bool(want[4][1]) and not torch.equal(want[0][2], st["x"][2])  # one converged, one moved


@pytest.mark.parametrize("log_d", [1, 3, 5, 6, 10, 11, 14])
def test_row_sum_plan_is_row_dot_order(log_d):
    """``row_sum``'s folds give row_dot_ref's sums bit for bit on random
    floats (where the order shows), at each kind of row: several a lane,
    several a warp, one a warp, one across warps."""
    plan = Plan(log_d)
    rng = np.random.default_rng(log_d)
    vals = torch.from_numpy(rng.standard_normal(plan.tile).astype(np.float32) * 1e3)
    t = torch.empty((plan.threads, 32))
    t[:, :] = vals[plan.final]
    got = row_sum(plan, t)
    want = tref.row_dot_ref(vals.reshape(-1, plan.d), torch.ones(plan.d))[:, 0]
    assert torch.equal(got, want[plan.final // plan.d])
