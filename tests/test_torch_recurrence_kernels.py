"""The recurrence kernels' schedules and two operand repairs, in Python on the CPU.

Row 12, the whole-sequence LSTM in bf16 (``csrc/lstm_mma.cu``): an
emulation of the kernels' schedule, one cluster of C blocks per 16 batch
rows, the groups of 8 units split over the blocks as the kernels split
them: per block and group, products on bf16-rounded operands with f32
accumulation in the kernels' k order (16-term k-steps; the forward's even
and odd k-steps in two sums, the backward's k-steps mod 4 in four, added
pairwise; the order does not depend on how much of Wh is resident), held
against the plain versions and JAX ``lstm_core`` (Pallas, interpret mode)
at small shapes: two clusters, a width that is not a multiple of 8, more
blocks than units per block. The plan itself (C, resident k-steps, shared
memory) is the library's and is tested on the card
(``tests/test_torch_cuda.py``).

Row 9, the RNN-T DP (``csrc/rnnt_dp.cu``): the α and β sweeps run apart
into natural-coordinate lattices and a parallel pass forms gbl and gem,
bit-equal to ``ops/rnnt_loss.py:rnnt_loss_from_logprobs_plain`` and within
1e-5 of JAX ``rnnt_loss_from_logprobs`` (interpret mode), on ragged
lengths with a row of one frame and a row without labels.

The bf16 attention backwards' dv from pd split into bf16 hi + lo (kernels
A and B): as close to a float64 dv as the f32 product of the plain
version. The column-sum partials summed as a fixed balanced tree
(``csrc/row_reduce.cu:sum_partials_kernel``): the tree's order, and closer
to float64 than a sum in order.

Tolerances: f32 schedules against plain and JAX differ in summation order
only, 2e-5 on values and 2e-4 on gradients; bf16, one flipped rounding of
a stored value, 2e-2 (as ``tests/test_torch_lstm_kernel.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowasr_tpu.ops.pallas.lstm_kernel import lstm_core as jlstm_core
from tensorflowasr_tpu.ops.pallas.rnnt_kernel import rnnt_loss_from_logprobs as jdp
from tensorflowasr_tpu.utils.math_util import LOG_0
from tensorflowasr_tpu_torch.ops.cuda import lstm_kernel as lk
from tensorflowasr_tpu_torch.ops.cuda import rnnt_kernel as rk
from tensorflowasr_tpu_torch.ops.rnnt_loss import _logaddexp, rnnt_loss_from_logprobs_plain

# ------------------------------------- LSTM schedule ------------------------------------- #


def _kstep_product(a: torch.Tensor, w: torch.Tensor, sets: int) -> torch.Tensor:
    """a [M, K] · w [K, N] (K a multiple of 16) as the kernels sum it: each
    16-term k-step exact, rounded to f32 (an mma of bf16 operands), added in
    k order into accumulator set (k-step mod ``sets``); the sets then added
    (two: s0 + s1; four: (s0 + s1) + (s2 + s3))."""
    acc = [torch.zeros(a.shape[0], w.shape[1]) for _ in range(sets)]
    for kk in range(a.shape[1] // 16):
        part = (a[:, 16 * kk:16 * kk + 16].double() @ w[16 * kk:16 * kk + 16].double()).float()
        acc[kk % sets] = acc[kk % sets] + part
    return acc[0] + acc[1] if sets == 2 else (acc[0] + acc[1]) + (acc[2] + acc[3])


class Split:
    """A cluster of ``cluster`` blocks per 16 of ``b`` batch rows, the
    ceil(h / 8) groups of 8 units split over the blocks in contiguous runs,
    the first ``groups % cluster`` blocks one group more (``lm_split_start``,
    ``lm_split_count`` in ``csrc/lstm_mma.cu``)."""

    def __init__(self, b: int, h: int, cluster: int):
        self.clusters, self.groups, self.cluster = -(-b // 16), -(-h // 8), cluster

    def block_groups(self, r: int) -> range:
        n, c = self.groups, self.cluster
        start = r * (n // c) + min(r, n % c)
        return range(start, start + n // c + (r < n % c))


def _layout(plan: Split):
    hp = 8 * plan.groups
    return hp, -(-hp // 16) * 16


def emulate_lstm_fwd(xg, wh, h0, c0, plan):
    """The forward's schedule, one cluster of 16 rows per 16 batch rows:
    block r, group gi computes its 4 × 8 gate columns from the bf16 h of the
    previous step (rows past B and units past H zero)."""
    dt, (b, t, g4) = xg.dtype, xg.shape
    h, rows = g4 // 4, 16 * plan.clusters
    hp, kp = _layout(plan)
    hb = torch.zeros(rows, kp)
    hb[:b, :h] = h0.float()
    c = torch.zeros(rows, hp)
    c[:b, :h] = c0.float()
    w = torch.zeros(kp, 4, hp)  # w[k, q, u] = Wh[k, q H + u]
    w[:h, :, :h] = wh.float().reshape(h, 4, h)
    x = torch.zeros(rows, t, 4, hp)
    x[:b, :, :, :h] = xg.float().reshape(b, t, 4, h)
    y, cs, gs = torch.zeros(rows, t, hp), torch.zeros(rows, t, hp), torch.zeros(rows, t, 4, hp)
    for s in range(t):
        nxt = torch.zeros(rows, kp)
        for r in range(plan.cluster):
            for gi in plan.block_groups(r):
                u = slice(8 * gi, 8 * gi + 8)
                acc = _kstep_product(hb, w[:, :, u].reshape(kp, 32), 2).reshape(rows, 4, 8)
                a = x[:, s, :, u] + acc
                ig, fg, gg, og = torch.sigmoid(a[:, 0]), torch.sigmoid(a[:, 1]), torch.tanh(a[:, 2]), torch.sigmoid(a[:, 3])
                c[:, u] = fg * c[:, u] + ig * gg
                hv = og * torch.tanh(c[:, u])
                y[:, s, u], cs[:, s, u] = hv.to(dt).float(), c[:, u].to(dt).float()
                gs[:, s, :, u] = torch.stack([ig, fg, gg, og], 1).to(dt).float()
                nxt[:, u] = hv.to(dt).float()
        nxt[b:], nxt[:, h:] = 0.0, 0.0
        hb = nxt
    return (y[:b, :, :h].to(dt), cs[:b, :, :h].to(dt), gs[:b, :, :, :h].reshape(b, t, 4 * h).to(dt))


def emulate_lstm_bwd(gates, cseq, c0, wh, dy, dcseq, plan):
    """The backward's schedule: block r, group gi forms its 8 units' dh from
    the bf16 dxg of the step after over all 4·Hp columns (column q·Hp + u)."""
    dt, (b, t, h) = cseq.dtype, cseq.shape
    rows = 16 * plan.clusters
    hp, _ = _layout(plan)
    w = torch.zeros(hp, 4, hp)  # w[u, q, v] = Wh[u, q H + v]
    w[:h, :, :h] = wh.float().reshape(h, 4, h)
    w = w.reshape(hp, 4 * hp)
    dxg = torch.zeros(b, t, 4 * h)
    dnext = torch.zeros(rows, 4 * hp)
    dh, dc = torch.zeros(rows, hp), torch.zeros(rows, hp)
    for s in range(t - 1, -1, -1):
        if s + 1 < t:
            for r in range(plan.cluster):
                for gi in plan.block_groups(r):
                    u = slice(8 * gi, 8 * gi + 8)
                    dh[:, u] = _kstep_product(dnext, w[u].t(), 4)
        cur = torch.zeros(rows, 4, hp)
        ig, fg, gg, og = gates[:, s].float().reshape(b, 4, h).unbind(1)
        tc = torch.tanh(cseq[:, s].float())
        dhv = dy[:, s].float() + dh[:b, :h]
        dct = dhv * og * (1.0 - tc * tc) + dc[:b, :h] + dcseq[:, s].float()
        cprev = (cseq[:, s - 1] if s > 0 else c0.to(dt)).float()
        da = torch.stack([dct * gg * ig * (1.0 - ig), dct * cprev * fg * (1.0 - fg), dct * ig * (1.0 - gg * gg), dhv * tc * og * (1.0 - og)], 1)
        dxg[:, s] = da.reshape(b, 4 * h)
        dc[:b, :h] = dct * fg
        cur[:b, :, :h] = da.to(dt).float()
        dnext = cur.reshape(rows, 4 * hp)
    for r in range(plan.cluster):
        for gi in plan.block_groups(r):
            u = slice(8 * gi, 8 * gi + 8)
            dh[:, u] = _kstep_product(dnext, w[u].t(), 4)
    return dxg, dh[:b, :h], dc[:b, :h]


def _lstm_inputs(dt, b=3, t=5, h=40, seed=0):
    rng = np.random.default_rng(seed)
    xg = rng.standard_normal((b, t, 4 * h)).astype(np.float32)
    wh = (rng.standard_normal((h, 4 * h)) / np.sqrt(h)).astype(np.float32)
    h0, c0 = ((rng.standard_normal((b, h)) * 0.3).astype(np.float32) for _ in range(2))
    dy, dc = rng.standard_normal((b, t, h)).astype(np.float32), (rng.standard_normal((b, t, h)) * 0.3).astype(np.float32)
    return [torch.tensor(a).to(dt) for a in (xg, wh, h0, c0)], [torch.tensor(a) for a in (dy, dc)]


TOLS = {torch.float32: (dict(rtol=2e-5, atol=2e-5), dict(rtol=2e-4, atol=2e-4)), torch.bfloat16: (dict(rtol=2e-2, atol=2e-2), dict(rtol=2e-2, atol=2e-2))}

# (B, H, C): 5 groups over 4 blocks (2, 1, 1, 1); two clusters; H 36 padded to 5 groups on one block; 9 groups over 8 blocks
SPLITS = [(3, 40, 4), (17, 24, 2), (5, 36, 1), (2, 72, 8)]


def test_split_owns_every_unit_once():
    for b, h, c in SPLITS:
        plan = Split(b, h, c)
        groups = [list(plan.block_groups(r)) for r in range(c)]
        assert sum(groups, []) == list(range(plan.groups)) and all(groups), (h, c)
        assert max(map(len, groups)) - min(map(len, groups)) <= 1
    assert Split(3, 40, 4).block_groups(0) == range(0, 2)


@pytest.mark.parametrize("b,h,c", SPLITS)
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_lstm_schedule_matches_plain_and_jax(dt, b, h, c):
    (xg, wh, h0, c0), (dy, dc) = _lstm_inputs(dt, b=b, h=h)
    plan = Split(b, h, c)
    val, grad = TOLS[dt]
    got = emulate_lstm_fwd(xg, wh, h0, c0, plan)
    ref = lk.lstm_fwd_plain(xg, wh, h0, c0)
    jy, jc = jlstm_core(*(jnp.asarray(a.float().numpy(), dtype=jnp.bfloat16 if dt == torch.bfloat16 else jnp.float32) for a in (xg, wh, h0, c0)),
                        True)
    for name, g, r in zip(("y", "cseq", "gates"), got, ref):
        torch.testing.assert_close(g, r, **val, msg=name)
    for name, g, j in zip(("y", "cseq"), got, (jy, jc)):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(j, dtype=np.float32), **val, err_msg=f"{name} vs JAX")
    _, cseq, gates = ref
    grads = emulate_lstm_bwd(gates, cseq, c0, wh, dy, dc, plan)
    for name, g, r in zip(("dxg", "dh0", "dc0"), grads, lk.lstm_bwd_plain(gates, cseq, c0, wh, dy, dc)):
        torch.testing.assert_close(g, r, **grad, msg=name)


@pytest.mark.parametrize("b,h,c", SPLITS)
def test_lstm_schedule_gradients_match_jax_vjp(b, h, c):
    """f32: the emulated backward's dxg (with dWh = hprevᵀ·dxg outside the
    kernel), dh0 and dc0 against ``jax.vjp`` of JAX ``lstm_core``."""
    import jax

    (xg, wh, h0, c0), (dy, dc) = _lstm_inputs(torch.float32, b=b, h=h, seed=1)
    plan = Split(b, h, c)
    y, cseq, gates = emulate_lstm_fwd(xg, wh, h0, c0, plan)
    dxg, dh0, dc0 = emulate_lstm_bwd(gates, cseq, c0, wh, dy, dc, plan)
    _, vjp = jax.vjp(lambda *a: jlstm_core(*a, True), *(jnp.asarray(a.numpy()) for a in (xg, wh, h0, c0)))
    ref = vjp((jnp.asarray(dy.numpy()), jnp.asarray(dc.numpy())))
    for name, g, r in zip(("dxg", "dwh", "dh0", "dc0"), (dxg, lk.weight_grad(y, h0, dxg), dh0, dc0), ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOLS[torch.float32][1], err_msg=name)


# -------------------------------------- DP schedule -------------------------------------- #


def emulate_dp(lpb: torch.Tensor, lpe: torch.Tensor, t_len: torch.Tensor, u_len: torch.Tensor):
    """The kernel's schedule in f32: the α sweep (the loss from its side) and
    the β sweep, each on its own into [B, T, U+1] lattices in natural
    coordinates, one anti-diagonal per step with the left (α) or right (β)
    neighbour from the previous diagonal; then gbl and gem for every cell at
    once, with β[t+1, u] the exit seed (0 at u = U_b) past T_b − 1 and
    β[t, u+1] LOG_0 past U_b."""
    b, t, u1 = lpb.shape
    neg = torch.tensor(LOG_0, dtype=torch.float32)
    alpha, beta = torch.full((b, t, u1), LOG_0), torch.full((b, t, u1), LOG_0)
    loss = torch.zeros(b)
    for i in range(b):
        tb, ub = int(t_len[i]), int(u_len[i])
        u = torch.arange(ub + 1)
        a = torch.where(u == 0, torch.zeros(()), neg)
        alpha[i, 0, 0] = 0.0
        for d in range(1, tb + ub):
            tt = d - u
            ok = (tt >= 0) & (tt < tb)
            fb = torch.where(ok & (tt >= 1), lpb[i, (tt - 1).clamp(0, t - 1), u], neg)
            fe = torch.where(ok & (u >= 1), lpe[i, tt.clamp(0, t - 1), (u - 1).clamp(0)], neg)
            left = torch.cat([neg[None], a[:-1]])
            a = torch.where(ok, _logaddexp(a + fb, left + fe), neg)
            alpha[i, tt[ok], u[ok]] = a[ok]
        loss[i] = -(a[ub] + lpb[i, tb - 1, ub])
        bn = torch.where(u == ub, torch.zeros(()), neg)
        for d in range(tb - 1 + ub, -1, -1):
            tt = d - u
            ok = (tt >= 0) & (tt < tb)
            fb, fe = lpb[i, tt.clamp(0, t - 1), u], lpe[i, tt.clamp(0, t - 1), u]
            right = torch.cat([bn[1:], neg[None]])
            bn = torch.where(ok, _logaddexp(fb + bn, fe + right), neg)
            beta[i, tt[ok], u[ok]] = bn[ok]
    tt, uu = torch.arange(t)[None, :, None], torch.arange(u1)[None, None, :]
    tb, ub = t_len.long()[:, None, None], u_len.long()[:, None, None]
    ok = (tt < tb) & (uu <= ub)
    b_next = torch.where(tt + 1 < tb, torch.cat([beta[:, 1:], torch.full((b, 1, u1), LOG_0)], 1), torch.where(uu == ub, torch.zeros(()), neg))
    right = torch.where(uu + 1 <= ub, torch.cat([beta[..., 1:], torch.full((b, t, 1), LOG_0)], 2), neg)
    ll = -loss[:, None, None]
    zero = torch.zeros(())
    gbl = torch.where(ok, -torch.exp(alpha + lpb + b_next - ll), zero)
    gem = torch.where(ok, -torch.exp(alpha + lpe + right - ll), zero)
    return loss, gbl, gem


# (T_b, U_b) per row: full, ragged, one frame, no labels, one frame and no labels, more labels than frames
DP_CASES = [(np.array([9, 6, 1, 9, 1, 3]), np.array([5, 2, 4, 0, 0, 5]), 9, 5), (np.array([1]), np.array([0]), 1, 0),
            (np.array([40, 17, 33]), np.array([37, 12, 1]), 40, 37)]


@pytest.mark.parametrize("t_np,u_np,t,u", DP_CASES)
def test_dp_schedule_is_bit_equal_to_plain_and_close_to_jax(t_np, u_np, t, u):
    rng = np.random.default_rng(int(t + 7 * u))
    b = len(t_np)
    logits = rng.standard_normal((b, t, u + 1, 3)).astype(np.float32) * 2.0
    lp = torch.log_softmax(torch.tensor(logits), dim=-1)
    lpb, lpe = lp[..., 0].contiguous(), lp[..., 1].contiguous()
    lpe[..., u] = LOG_0
    t_len, u_len = torch.tensor(t_np, dtype=torch.int32), torch.tensor(u_np, dtype=torch.int32)
    got = emulate_dp(lpb, lpe, t_len, u_len)
    ref = rnnt_loss_from_logprobs_plain(lpb, lpe, t_len, u_len)
    for name, g, r in zip(("loss", "gbl", "gem"), got, ref):
        assert torch.equal(g, r), f"{name}: max abs diff {(g - r).abs().max().item()}"
    jl = jdp(jnp.asarray(lpb.numpy()), jnp.asarray(lpe.numpy()), jnp.asarray(t_np), jnp.asarray(u_np), True)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("u1,warps", [(1, 1), (32, 1), (33, 2), (129, 5), (1000, 32), (1024, 32)])
def test_dp_warps(u1, warps):
    """The sweep's warps: one label position per lane, ceil(U+1 / 32) warps."""
    assert rk.dp_warps(u1) == warps


def test_dp_warps_refuses_past_1024():
    with pytest.raises(ValueError, match="1024"):
        rk.dp_warps(1025)


# ----------------------------------- dv from pd hi + lo ----------------------------------- #


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


@pytest.mark.parametrize("t,s,d", [(64, 32, 36), (96, 64, 128), (400, 32, 44)])
def test_dv_from_pd_hi_plus_lo(t, s, d):
    """dv = pdᵀ·do over t query rows with pd in f32 (softmax probabilities
    times a keep factor) and do in bf16, dv leaving in bf16: hiᵀ·do + loᵀ·do
    on bf16 operands with f32 accumulation sits as close to the float64
    product as the plain version's f32 product does (within 1.1× by rms),
    where bf16(pd)ᵀ·do sits further off (more than 1.2×)."""
    g = torch.Generator().manual_seed(t + s + d)
    pd = torch.softmax(torch.randn(t, s, generator=g) * 3.0, dim=-1) * (torch.rand(t, s, generator=g) > 0.1) / 0.9
    do = _bf16(torch.randn(t, d, generator=g))
    hi = _bf16(pd)
    lo = _bf16(pd - hi)
    ref = pd.double().t() @ do.double()
    split = _bf16((hi.double().t() @ do.double()).float() + (lo.double().t() @ do.double()).float())
    f32 = _bf16(pd.t() @ do)
    rounded = _bf16(hi.t() @ do)

    def rms(x):
        return (x.double() - ref).pow(2).mean().sqrt().item()

    assert rms(split) <= 1.1 * rms(f32)
    assert rms(rounded) > 1.2 * rms(f32)


# ------------------------------ the fixed pairwise partial sum ------------------------------ #


def pairwise_partials(partials: np.ndarray) -> np.ndarray:
    """Pairwise summation over axis 0 in f32, defined by a stack of subtree
    sums: partial p closes one subtree per trailing one bit of p; the stack
    is then added from the top (the smallest subtree) down."""
    stack = []
    for p, v in enumerate(partials.astype(np.float32)):
        q = p
        while q & 1:
            v = np.float32(stack.pop() + v)
            q >>= 1
        stack.append(v)
    s = stack.pop()
    while stack:
        s = np.float32(stack.pop() + s)
    return s


def kernel_partials(partials: np.ndarray, chunk: int = 32) -> np.ndarray:
    """``sum_partials_kernel``'s order in f32 over axis 0: chunks of 32
    partials summed level by level (element a takes in a + 2^L where that
    exists), then the chunk sums by the same levels."""

    def levels(v):
        v, step = list(v), 1
        while step < len(v):
            for a in range(0, len(v) - step, 2 * step):
                v[a] = np.float32(v[a] + v[a + step])
            step *= 2
        return v[0]

    x = partials.astype(np.float32)
    return levels([levels(x[c:c + chunk]) for c in range(0, len(x), chunk)])


def _tree(x: np.ndarray) -> np.ndarray:
    """The balanced binary tree over a power-of-two count, written recursively."""
    if len(x) == 1:
        return x[0].astype(np.float32)
    h = len(x) // 2
    return np.float32(_tree(x[:h]) + _tree(x[h:]))


@pytest.mark.parametrize("splits", [1, 2, 3, 7, 16, 31, 33, 400, 401, 1025])
def test_pairwise_partials_order_and_accuracy(splits):
    rng = np.random.default_rng(splits)
    partials = (rng.standard_normal((splits, 512)) * 8.0 + 3.0).astype(np.float32)  # 512 columns with a common offset
    got = kernel_partials(partials)
    np.testing.assert_array_equal(got, pairwise_partials(partials))  # the kernel's levels are the pairwise tree, bit for bit
    ref = partials.astype(np.float64).sum(0)
    if splits & (splits - 1) == 0:
        np.testing.assert_array_equal(got, _tree(partials))
    in_order = np.zeros(512, np.float32)
    for row in partials:
        in_order = np.float32(in_order + row)
    if splits >= 16:
        assert np.sqrt(np.mean((got - ref) ** 2)) < np.sqrt(np.mean((in_order - ref) ** 2))
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(partials).sum(0).max() * np.log2(2 * splits)
