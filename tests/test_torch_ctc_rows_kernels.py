"""The CTC kernel's and the RNN-T log-probability row kernel's schedules, in Python on the CPU.

Row 11, the CTC loss (``csrc/ctc.cu``): the α and β sweeps run apart, each
into its own lattice, the states split into warps of 32 lanes; a warp
takes its neighbours inside the warp by a shift and across a warp boundary
only from the pair its upstream neighbour's edge lanes published in the
previous step into a double buffer (a named barrier of the warps per
step). Then the parallel occupancy pass. Held against
``ops/ctc_loss.py:ctc_occupancy_plain`` bit for bit, and against JAX
``ctc_loss_pallas`` (Pallas, interpret mode): the loss and the gradient
(softmax − occupancy, the port's backward) to 1e-5.

Row 10a, the log-probability rows (``csrc/rnnt_rows.cu``): the plan by
shape (``logprobs_plan``), and the tile kernel's schedule emulated: a
tile's rows → (b, t, u) in 32-bit arithmetic (tiles that cross a batch row
and a tail tile), each row by its group of G lanes, lane q taking the
16-byte chunks q, q + G, ... eight a pass (passes for rows over 4 KB,
-inf past the row's end), the max of a pass over the group, the sums in
two alternating chains rescaled pass to pass and combined over the group
as the kernel's shuffles do, x[0] from lane 0's first chunk and x[label]
from the lane, pass and position that hold the label's chunk; a label ≥ V
picks 0; the one-element form for V 29. Held against
``logits_to_logprobs_plain`` and JAX ``_logits_to_logprobs`` (interpret
mode) at V 256, 29, 1000 and 3000, f32 and bf16, to 1e-5 (summation order
only: both sides upcast the same values).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowasr_tpu.ops.pallas import ctc_kernel as jctc
from tensorflowasr_tpu.ops.pallas.rnnt_kernel import _logits_to_logprobs as jlogprobs
from tensorflowasr_tpu_torch.ops.ctc_loss import LOG_0, _lse3, ctc_occupancy_plain, ctc_prep
from tensorflowasr_tpu_torch.ops.cuda import ctc_kernel as ctk
from tensorflowasr_tpu_torch.ops.cuda import rnnt_kernel as rk
from tensorflowasr_tpu_torch.ops.rnnt_loss import logits_to_logprobs_plain

# csrc/ctc.cu: a warp's boundary pair is written at step k, read at step k + 1 (after the barrier of step k) and free
# again after the barrier of step k + 1, so a slot is rewritten at step k + 2: the hand-off has two slots
CTC_SLOTS = 2

# ------------------------------------- CTC schedule -------------------------------------- #


def _sweep(lp: torch.Tensor, skip: torch.Tensor, tb: int, s_last: int, fwd: bool):
    """One sweep of one row as the kernel's warps run it: [T_b, 32 W] rows
    of α (fwd) or β, the row of step k at index k (α) or T_b − 1 − k (β).
    ``lp`` [T, S] and ``skip`` [S] of the row. Each step, every warp reads
    its upstream neighbour's pair of the previous step from slot
    (k − 1) mod ``CTC_SLOTS`` of that warp's buffer, computes its 32 lanes,
    and its edge lane publishes its own pair into slot k mod ``CTC_SLOTS``;
    then the barrier. Each slot carries the step that wrote it, and a read
    asserts that it holds step k − 1: no pair was overwritten before it was
    read."""
    s = lp.shape[1]
    w = -(-s // 32)
    idx = torch.arange(32 * w)
    inn, ok = idx < s, idx <= s_last
    neg = torch.tensor(LOG_0)
    pad = lambda x, fill: torch.cat([x, torch.full((32 * w - s,), fill)])  # noqa: E731
    lp_w = [pad(lp[r], 0.0) for r in range(lp.shape[0])]
    if fwd:
        add = pad(skip, LOG_0)
    else:
        add = torch.where(idx + 2 < s, pad(torch.cat([skip[2:], torch.full((2,), LOG_0)]), LOG_0), neg)
    ring = [[None] * CTC_SLOTS for _ in range(w)]  # per warp and slot: (step, the pair of its edge lanes), or None (never written)
    up = [(j - 1 if fwd else (j + 1 if j + 1 < w else -1)) for j in range(w)]
    down = [(j + 1 if j + 1 < w else -1) if fwd else j - 1 for j in range(w)]
    out = torch.full((tb, 32 * w), float("nan"))
    state = [None] * w  # per warp: its 32 lanes' carried value (α, or β's term β + lp)
    for k in range(tb):
        r = k if fwd else tb - 1 - k
        pairs = []
        for j in range(w):
            sl = slice(32 * j, 32 * j + 32)
            if k == 0:
                if fwd:
                    v = torch.where(ok[sl] & (idx[sl] < 2), lp_w[r][sl], neg)
                    out[r, sl] = v
                else:
                    v = torch.where(ok[sl] & ((idx[sl] == s_last) | ((idx[sl] == s_last - 1) & (s_last > 0))), torch.zeros(()), neg)
                    out[r, sl] = v
                    v = torch.where(inn[sl], v + lp_w[r][sl], neg)
            else:
                if up[j] >= 0:
                    step, e = ring[up[j]][(k - 1) % CTC_SLOTS]
                    assert step == k - 1, f"warp {j} step {k} read the pair of step {step}"
                else:
                    e = (neg, neg)
                cur = state[j]
                if fwd:  # n1 = α[s − 1], n2 = α[s − 2]; lanes 0 and 1 from the upstream pair (its lanes 30, 31)
                    n1 = torch.cat([e[1][None], cur[:-1]])
                    n2 = torch.cat([e[0][None], e[1][None], cur[:-2]])
                    v = torch.where(ok[sl], _lse3(cur, n1, n2 + add[sl]) + lp_w[r][sl], neg)
                    out[r, sl] = v
                else:  # n1, n2 = the terms of s + 1, s + 2; lanes 31 and 30 from the upstream pair (its lanes 0, 1)
                    n1 = torch.cat([cur[1:], e[0][None]])
                    n2 = torch.cat([cur[2:], e[0][None], e[1][None]])
                    bt = torch.where(ok[sl], _lse3(cur, n1, n2 + add[sl]), neg)
                    out[r, sl] = bt
                    v = torch.where(inn[sl], bt + lp_w[r][sl], neg)
            state[j] = v
            pairs.append((v[30], v[31]) if fwd else (v[0], v[1]))
        for j in range(w):  # the edge lanes publish; the barrier
            if down[j] >= 0:
                ring[j][k % CTC_SLOTS] = (k, pairs[j])
    return out


def emulate_ctc(lp_ext: torch.Tensor, skip_add: torch.Tensor, t_len: torch.Tensor, u_len: torch.Tensor):
    """(occupancy, loss) by the kernel's schedule: the two sweeps apart, then the occupancy pass."""
    b, t, s = lp_ext.shape
    alpha, beta = torch.zeros((b, t, s)), torch.zeros((b, t, s))
    loss = torch.zeros(b)
    neg = torch.tensor(LOG_0)
    tbs, lasts = [], []
    for i in range(b):
        tb, s_last = min(max(int(t_len[i]), 1), t), min(2 * max(int(u_len[i]), 0), s - 1)
        tbs.append(tb)
        lasts.append(s_last)
        a = _sweep(lp_ext[i], skip_add[i], tb, s_last, True)
        bt = _sweep(lp_ext[i], skip_add[i], tb, s_last, False)
        alpha[i, :tb], beta[i, :tb] = a[:, :s], bt[:, :s]
        fin = a[tb - 1]
        loss[i] = -_lse3(fin[s_last], fin[s_last - 1] if s_last > 0 else neg, neg)
    tt, ss = torch.arange(t)[None, :, None], torch.arange(s)[None, None, :]
    live = (tt < torch.tensor(tbs)[:, None, None]) & (ss <= torch.tensor(lasts)[:, None, None])
    ll = -loss[:, None, None]
    occ = torch.where(live, -torch.exp(torch.where(live, alpha, 0.0) + torch.where(live, beta, 0.0) - ll), torch.zeros(()))
    return occ, loss


def _ctc_inputs(seed: int, b: int, t: int, u: int, v: int):
    """Ragged lengths; row 0 full with a repeated label, row 1 no labels,
    row 2 one frame and one label, row 3 infeasible (4 frames for three
    equal labels, which need 5)."""
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((b, t, v)) * 2.0).astype(np.float32)
    labels = rng.integers(1, v, (b, u)).astype(np.int32)
    u_len = rng.integers(0, u + 1, b).astype(np.int32)
    t_len = rng.integers(1, t + 1, b).astype(np.int32)
    u_len[0], t_len[0] = u, t
    labels[0, 1] = labels[0, 0]
    u_len[1] = 0
    u_len[2], t_len[2] = 1, 1
    labels[3, :3] = labels[3, 0]
    u_len[3], t_len[3] = min(u, 3), min(t, 4)
    labels[np.arange(u)[None, :] >= u_len[:, None]] = 0
    return logits, np.maximum(t_len, u_len), labels, u_len


# (B, T, U, V): S = 2U + 1 = 9, 31 | 33 (a warp boundary), 63 | 65 (two)
CTC_CASES = [(4, 7, 4, 9), (4, 20, 15, 24), (5, 20, 16, 24), (4, 36, 31, 40), (4, 36, 32, 40)]


@pytest.mark.parametrize("b,t,u,v", CTC_CASES)
def test_ctc_schedule_is_bit_equal_to_plain(b, t, u, v):
    logits, t_len, labels, u_len = _ctc_inputs(b * 100 + u, b, t, u, v)
    lp_ext, skip, _ = ctc_prep(torch.tensor(logits), torch.tensor(labels))
    tl, ul = torch.tensor(t_len), torch.tensor(u_len)
    got = emulate_ctc(lp_ext, skip, tl, ul)
    ref = ctc_occupancy_plain(lp_ext, skip, tl, ul)
    for name, g, r in zip(("occupancy", "loss"), got, ref):
        assert torch.equal(g, r), f"{name}: max abs diff {(g - r).abs().max().item()}"
    assert got[1][3] > 1e29  # the infeasible row: JAX's finite LOG_0-based loss


def test_ctc_schedule_loss_and_gradient_match_jax():
    b, t, u, v = CTC_CASES[2]  # S = 33: two warps a sweep
    logits, t_len, labels, u_len = _ctc_inputs(b * 100 + u, b, t, u, v)
    x = torch.tensor(logits)
    lp_ext, skip, lse = ctc_prep(x, torch.tensor(labels))
    occ, loss = emulate_ctc(lp_ext, skip, torch.tensor(t_len), torch.tensor(u_len))
    w = np.linspace(0.5, 1.5, b).astype(np.float32)
    ctx = types.SimpleNamespace(saved_tensors=(x, lse, occ, torch.tensor(labels)))
    grad = ctk._CtcLossPallas.backward(ctx, torch.tensor(w))[0]
    ref, vjp = jax.vjp(lambda z: jctc.ctc_loss_pallas(z, jnp.asarray(t_len), jnp.asarray(labels), jnp.asarray(u_len)), jnp.asarray(logits))
    (ref_grad,) = vjp(jnp.asarray(w))
    np.testing.assert_allclose(loss.numpy(), np.asarray(ref), rtol=1e-5)
    for row in range(b):  # each row at its own scale: an infeasible row's gradient is LOG_0 arithmetic's
        g, r = grad[row].numpy().astype(np.float64), np.asarray(ref_grad[row], np.float64)
        assert np.abs(g - r).max() <= 1e-5 * np.abs(r).max(), f"row {row}"


def test_ctc_kernel_refuses_more_than_1024_states():
    """S = 2U + 1 > 1024 (U > 511) raises before any launch: one lane per state, at most 32 warps a sweep."""
    with pytest.raises(ValueError, match="1024"):
        ctk.ctc_kernel(torch.zeros((1, 3, 1025)), torch.zeros((1, 1025)), torch.tensor([3]), torch.tensor([512]))


# ---------------------------------- log-probability rows --------------------------------- #


LP_CHUNKS = 8  # csrc/rnnt_rows.cu: 16-byte chunks a lane loads in one pass


def _tile_rows_reduce(x: torch.Tensor, lanes: int, per: int, labels: torch.Tensor):
    """Rows [R, V] reduced as the tile kernel does, ``lanes`` lanes a row and
    ``per`` values a chunk: per pass, lane q loads chunks base + q + lanes·i
    (i < 8; -inf past the row), the group's max m_p; the running max
    m = max(m, m_p), each lane's sum rescaled to it and the pass's terms
    added in two chains (even and odd i); the lanes' sums combined in the
    shuffles' butterfly order. ``labels`` [R] (any value): x[label] taken
    from the chunk of the lane (label chunk mod lanes), the pass and the
    position that loaded it. Returns (m, s, x0, xl) per row."""
    r, v = x.shape
    chunks = v // per
    c = x.view(r, chunks, per)
    neg = torch.full((r, per), float("-inf"))
    m = torch.full((r,), -torch.finfo(torch.float32).max)
    s = torch.zeros((r, lanes))
    lc = torch.where((labels >= 0) & (labels < v), labels // per, torch.zeros((), dtype=labels.dtype))
    xl = torch.zeros(r)
    for base in range(0, chunks, lanes * LP_CHUNKS):
        held = [[c[:, ch] if (ch := base + q + lanes * i) < chunks else neg for i in range(LP_CHUNKS)] for q in range(lanes)]
        nm = torch.maximum(m, torch.stack([torch.stack(h, 1).amax(dim=(1, 2)) for h in held], 1).amax(1))
        terms = [[torch.exp(h - nm[:, None]).sum(-1) for h in held[q]] for q in range(lanes)]
        add = torch.stack([sum(t[0::2], torch.zeros(r)) + sum(t[1::2], torch.zeros(r)) for t in terms], 1)
        s = s * torch.exp(m - nm)[:, None] + add
        m = nm
        for row in range(r):  # the label's chunk: lane lc mod lanes, position (lc − base) div lanes of this pass
            at = int(lc[row]) - base
            if 0 <= at < lanes * LP_CHUNKS and 0 <= int(labels[row]) < v:  # other labels: the kernel's pick is unused
                xl[row] = held[at % lanes][at // lanes][row, int(labels[row]) - int(lc[row]) * per]
    o = lanes // 2
    while o:
        s = s + s[:, torch.arange(lanes) ^ o]
        o //= 2
    return m, s[:, 0], c[:, 0, 0], xl


def emulate_logprobs(logits: torch.Tensor, labels: torch.Tensor):
    """(lp_blank, lp_emit, lse) by the kernel's schedule for the form
    ``logprobs_plan`` picks: the tiles (rows → (b, u) in int32 per tile,
    one label a lane, each row by its group of lanes), or the one-element
    form (32 lanes a row, one value a chunk)."""
    b, t, u1, v = logits.shape
    x = logits.float().reshape(-1, v)
    rows = x.shape[0]
    plan = rk.logprobs_plan(v, logits.element_size())
    if plan.route == "scalar":
        tile_rows, lanes, per = 1, 32, 1
    else:
        tile_rows, lanes, per = plan.tile_rows, plan.lanes, 16 // logits.element_size()
    tiles = -(-rows // tile_rows)
    lab_all = torch.zeros(rows, dtype=torch.int64)
    lab_flat = labels.to(torch.int32).reshape(-1)
    i32 = np.int32
    for tile in range(tiles):  # one label a lane, in 32-bit arithmetic
        r0 = i32(tile * tile_rows)
        n = min(tile_rows, rows - int(r0))
        rr = r0 + np.arange(n, dtype=i32)
        bt = rr // i32(u1)
        u = rr - bt * i32(u1)
        bb = bt // i32(t)
        assert rr.dtype == u.dtype == bb.dtype == np.int32
        lab = np.full(n, -1, np.int64)
        has = u < u1 - 1
        lab[has] = lab_flat[torch.tensor(bb * i32(u1 - 1) + u)[torch.tensor(has)]].numpy()
        lab_all[int(r0):int(r0) + n] = torch.tensor(lab)
    m, s, x0, xl = _tile_rows_reduce(x, lanes, per, lab_all)
    lse = m + torch.log(s)
    lpb = x0 - lse
    lpe = torch.where(lab_all < 0, torch.tensor(LOG_0), torch.where(lab_all < v, xl, torch.zeros(())) - lse)
    shape = (b, t, u1)
    return lpb.view(shape), lpe.view(shape), lse.view(shape)


@pytest.mark.parametrize("v,elt,route,tile_rows,lanes", [(256, 2, "tiles", 8, 4), (256, 4, "tiles", 4, 8), (1000, 2, "tiles", 2, 16),
                                                          (1000, 4, "tiles", 1, 32), (29, 4, "scalar", 0, 0), (12, 2, "scalar", 0, 0),
                                                          (8, 2, "tiles", 32, 1), (240, 2, "tiles", 8, 4), (6144, 4, "tiles", 1, 32),
                                                          (6148, 4, "tiles", 1, 32)])
def test_logprobs_plan(v, elt, route, tile_rows, lanes):
    assert rk.logprobs_plan(v, elt) == (route, tile_rows, lanes)
    assert rk.logprobs_plan(v, elt, aligned=False).route == "scalar"


# (B, T, U, V): tiles that cross a batch row (U + 1 = 5 and 3 rows of a lattice column against tiles of 8, 4, 2 or 1
# rows), a tail tile (105 and 30 rows), rows over 4 KB (V 3000: 2 passes in bf16, 3 in f32)
ROW_CASES = [(3, 7, 4, 256), (2, 5, 2, 1000), (3, 7, 4, 29), (2, 3, 2, 3000)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("b,t,u,v", ROW_CASES)
def test_logprobs_schedule_matches_plain_and_jax(b, t, u, v, dtype):
    rng = np.random.default_rng(b * 1000 + v)
    logits = (rng.standard_normal((b, t, u + 1, v)) * 2.0).astype(np.float32)
    labels = rng.integers(0, v, (b, u)).astype(np.int32)
    labels[-1, 1] = -(-v // 128) * 128 + 3  # a label ≥ V picks 0 (past JAX's lane padding of V, which holds LOG_0)
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jx = jnp.asarray(logits).astype(jdt)
    tx = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(tdt)
    got = emulate_logprobs(tx, torch.tensor(labels))
    plain = logits_to_logprobs_plain(tx, torch.tensor(labels))
    ref = jlogprobs(jx, jnp.asarray(labels), True)
    for name, g, p, r in zip(("lp_blank", "lp_emit", "lse"), got, plain, ref):
        np.testing.assert_allclose(g.numpy(), p.numpy(), rtol=1e-5, atol=1e-5, err_msg=f"{name} vs plain")
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5, err_msg=f"{name} vs JAX")
    assert float(got[1][-1, 0, 1]) == float(-got[2][-1, 0, 1])  # the label ≥ V picked 0
    assert np.all(got[1].numpy()[..., u] == LOG_0)
