"""What the redesigned kernel A and fused decode compute in Python, on the
CPU: kernel A's row statistics (the max m and sum l its forward returns for
the backward) against JAX's ``_softmax_rows``; the decode cluster's
partition of the weights and its shared-memory plan; and the wrappers'
CPU dispatch, which takes the plain versions and launches nothing.

Tolerances: the statistics are f32 sums of the same f32 scores in another
order on the two sides: 1e-5 relative (m and l are O(1)–O(S), or −1e9 on a
masked row).
"""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowasr_tpu.ops.pallas import attention_kernel as jak
from tensorflowasr_tpu_torch.ops.cuda import attention_kernel as ak
from tensorflowasr_tpu_torch.ops.cuda import decode_kernel as dk
from tensorflowasr_tpu_torch.utils.tracing import launches

SEED = 4242


def _attention_inputs(rng, bh, t, s, d, bias_bh):
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for shape in ((bh, t, d), (bh, s, d), (bh, s, d)))
    bias = (rng.standard_normal((bias_bh, t, s)) * 0.5).astype(np.float32)
    bias[..., t - 2:, :] = -1e9  # Keras-masked query rows: −1e9 on every column
    return q, k, v, bias


# (B·H, T, S, D, bias B·H): a head of 36, a broadcast bias, key lengths padded to JAX's 128 lanes
STATS_CASES = [(6, 13, 13, 8, 6), (4, 9, 21, 36, 1), (2, 5, 130, 36, 2)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,t,s,d,bias_bh", STATS_CASES)
def test_attention_row_stats_equal_jax_softmax_rows(dtype, bh, t, s, d, bias_bh):
    """``fused_attention_plain_stats`` against the m and l of JAX
    ``_softmax_rows`` over ``_fwd_kernel``'s scores: q·kᵀ in f32 from the
    inputs' dtype plus the bias, the padded key columns at NEG_PAD."""
    q, k, _, bias = _attention_inputs(np.random.default_rng(SEED + d), bh, t, s, d, bias_bh)
    jdt = jnp.dtype(dtype)
    sp = jak._lanes(s)
    m_ref, l_ref = np.zeros((bh, t), np.float32), np.zeros((bh, t), np.float32)
    for i in range(bh):
        ki = jnp.pad(jnp.asarray(k[i], jdt), ((0, sp - s), (0, 0)))
        bi = jnp.pad(jnp.asarray(bias[i % bias_bh], jdt), ((0, 0), (0, sp - s)))
        sc = jnp.dot(jnp.asarray(q[i], jdt), ki.T, preferred_element_type=jnp.float32) + bi.astype(jnp.float32)
        sc = jnp.where(jnp.arange(sp)[None, :] < s, sc, jak.NEG_PAD)
        _, m, l = jak._softmax_rows(sc)
        m_ref[i], l_ref[i] = np.asarray(m)[:, 0], np.asarray(l)[:, 0]
    tdt = getattr(torch, dtype)
    stats = ak.fused_attention_plain_stats(torch.tensor(q).to(tdt), torch.tensor(k).to(tdt), torch.tensor(bias).to(tdt))
    assert stats.dtype == torch.float32 and tuple(stats.shape) == (2, bh, t)
    np.testing.assert_allclose(stats[0].numpy(), m_ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(stats[1].numpy(), l_ref, rtol=1e-5, atol=1e-5)


def test_attention_stats_normalise_the_plain_probabilities():
    """pn = exp(s − m) / l with the returned statistics is the plain softmax."""
    q, k, _, bias = (torch.tensor(a) for a in _attention_inputs(np.random.default_rng(SEED), 3, 7, 11, 16, 1))
    stats = ak.fused_attention_plain_stats(q, k, bias)
    scores = q @ k.transpose(1, 2) + bias
    pn, _ = ak._attention_probs(q, k, bias, 0, 0.0)
    torch.testing.assert_close(torch.exp(scores - stats[0][..., None]) / stats[1][..., None], pn, rtol=1e-6, atol=1e-7)


# ----------------------------------- the decode cluster's plan ----------------------------------- #

# (E, H, P, J, V, layers): the card tests' nets at the flagship's widths (DECODE_CASES: one LSTM with LayerNorm; two with a
# projection of 11; a projection of 8 and V 1000) and the canary's small nets (test_torch_fused_decode.CONFIGS)
NETS = [(320, 320, 0, 320, 256, 1), (320, 320, 11, 320, 256, 2), (320, 320, 8, 320, 1000, 1), (12, 10, 0, 14, 16, 1), (12, 10, 8, 14, 16, 1),
        (12, 10, 11, 14, 16, 2)]
FLAGSHIP = NETS[0]


@pytest.mark.parametrize("cluster", [8, 16])
@pytest.mark.parametrize("net", NETS)
def test_every_row_is_owned_once(net, cluster):
    e, h, p, j, v, layers = net
    for m in dk.matrices(e, h, p, j, v, layers):
        owners = collections.Counter(row for r in range(cluster) for row in dk.owned_rows(m, h, cluster, r))
        assert sorted(owners) == list(range(m.rows)), m.name
        assert set(owners.values()) <= {1}, m.name


@pytest.mark.parametrize("cluster", [8, 16])
@pytest.mark.parametrize("net", NETS)
def test_a_units_four_gate_rows_sit_in_one_block(net, cluster):
    e, h, p, j, v, layers = net
    for m in dk.matrices(e, h, p, j, v, layers):
        if not m.gate:
            continue
        for r in range(cluster):
            rows = dk.owned_rows(m, h, cluster, r)
            units = {row % h for row in rows}
            assert set(rows) == {g * h + u for g in range(4) for u in units}, (m.name, r)
            u0, nu = dk.split(h, cluster, r)
            assert rows == [g * h + u for g in range(4) for u in range(u0, u0 + nu)]  # local row = gate · nu + unit, the kernel's order


@pytest.mark.parametrize("elt", [2, 4])
@pytest.mark.parametrize("cluster", [8, 16])
@pytest.mark.parametrize("net", NETS)
def test_resident_bytes_fit_and_follow_the_order(net, cluster, elt):
    """The plan fits 227 KB, keeps no more rows than a block owns, and a
    matrix is cut short only where not one more of its rows fits."""
    plan = dk.decode_plan(*net, cluster, elt)
    assert plan.smem_bytes <= dk.SMEM_LIMIT - dk.SMEM_RESERVE <= 227 * 1024
    a16 = lambda b: (b + 15) & ~15
    left = dk.SMEM_LIMIT - dk.SMEM_RESERVE - (plan.smem_bytes - sum(a16(r * m.k * elt) for r, m in zip(plan.resident, plan.matrices)))
    for rows, res, m in zip(plan.rows, plan.resident, plan.matrices):
        e, h, _, _, _, _ = net
        assert rows == max(len(dk.owned_rows(m, h, cluster, r)) for r in range(cluster))
        assert 0 <= res <= rows
        left -= a16(res * m.k * elt)
        if res < rows:
            assert a16((res + 1) * m.k * elt) - a16(res * m.k * elt) > left, m.name
    assert left >= 0
    assert plan.resident_bytes == sum(r * m.k * elt for r, m in zip(plan.resident, plan.matrices)) <= plan.slice_bytes


def test_flagship_bf16_in_clusters_of_16_is_wholly_resident():
    plan = dk.decode_plan(*FLAGSHIP, 16, 2)
    assert plan.whole and plan.resident_bytes == plan.slice_bytes == (16 + 20) * 320 * 2 + 2 * 80 * 320 * 2
    f32 = dk.decode_plan(*FLAGSHIP, 16, 4)  # f32 keeps Wv, Wp and Whh whole and part of Wih
    assert not f32.whole and f32.resident[:3] == f32.rows[:3] and 0 < f32.resident[3] < f32.rows[3]


@pytest.mark.parametrize("batch,occupancy,want", [(8, {16: 8, 8: 16}, 16), (8, {16: 7, 8: 16}, 8), (1, {16: 7, 8: 16}, 16), (13, {16: 7, 8: 16}, 8),
                                                  (20, {16: 8, 8: 8}, 16), (4, {16: 0, 8: 16}, 8), (4, {16: 3, 8: 0}, 16)])
def test_cluster_size_rule(batch, occupancy, want):
    assert dk.choose_cluster(batch, occupancy) == want


def test_cluster_size_rule_raises_when_neither_launches():
    with pytest.raises(RuntimeError, match="neither"):
        dk.choose_cluster(8, {16: 0, 8: 0})


# ---------------------------------------- CPU dispatch ---------------------------------------- #


def test_cpu_attention_takes_the_plain_versions():
    """On CPU tensors ``fused_attention`` is the plain forward and backward, bit for bit, and launches nothing."""
    q, k, v, bias = (torch.tensor(a) for a in _attention_inputs(np.random.default_rng(SEED + 1), 4, 9, 12, 16, 4))
    dout = torch.tensor(np.random.default_rng(SEED + 2).standard_normal((4, 9, 16)).astype(np.float32))
    before = (launches["kernel.attention.fwd"], launches["kernel.attention.bwd"])
    leaves = [a.clone().requires_grad_(True) for a in (q, k, v, bias)]
    out = ak.fused_attention(*leaves, SEED, 0.1)
    out.backward(dout)
    assert torch.equal(out.detach(), ak.fused_attention_plain(q, k, v, bias, SEED, 0.1))
    for got, want in zip((x.grad for x in leaves), ak.fused_attention_plain_bwd(q, k, v, bias, dout, SEED, 0.1)):
        assert torch.equal(got, want)
    assert (launches["kernel.attention.fwd"], launches["kernel.attention.bwd"]) == before


def _decode_params(rng, e=12, h=10, j=14, v=16, enc=9):
    f = lambda *shape: torch.tensor(rng.standard_normal(shape).astype(np.float32) * 0.5)
    layer = dk.FusedLayer(f(4 * h, e), f(4 * h, h), f(4 * h), torch.stack([1 + f(h) * 0.1, f(h) * 0.1]), None)
    return dk.FusedDecodeParams(f(v, e), (layer,), f(j, h), f(j), f(v, j), f(v), f(j, enc), f(j), h, 1e-3)


def test_cpu_decode_takes_the_plain_version():
    """On CPU tensors ``fused_greedy_decode`` is the plain version and launches nothing."""
    rng = np.random.default_rng(SEED + 3)
    params = _decode_params(rng)
    enc = torch.tensor(rng.standard_normal((3, 11, 9)).astype(np.float32))
    lens, tok0 = torch.tensor([11, 6, 1]), torch.tensor([0, 3, 5])
    states = ((torch.zeros(3, 10), torch.zeros(3, 10)),)
    before, plan = launches["kernel.decode"], dk.last_launch
    got = dk.fused_greedy_decode(enc, lens, params, tok0, states)
    want = dk.fused_greedy_decode_plain(enc, lens, params, tok0, states)
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g, w)
    for (gc, gh), (wc, wh) in zip(got[3], want[3]):
        assert torch.equal(gc, wc) and torch.equal(gh, wh)
    assert launches["kernel.decode"] == before and dk.last_launch is plan
