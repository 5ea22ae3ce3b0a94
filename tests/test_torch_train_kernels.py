"""The training kernels' plain PyTorch forward and backward vs ``jax.vjp``
of the JAX Pallas kernels (interpret mode on the CPU), and vs torch
autograd of the plain forward; and the dropout mask.

Inputs are made with numpy from a seed and given to both sides, f32. The
Pallas FF and conv kernels index their dropout masks per TPU grid step; the
sizes here run one grid step (FF N ≤ 1024; conv B ∈ {2, 8}, 16 | T,
B·T ≤ 4096), where that index equals the port's global row, so the
rate-0.1 cases hold the same masks on both sides. Tolerances: f32
summation order. Outputs are unit scale (1e-5); gradients sum up to a few
hundred terms of unit scale, so 1e-4 absolute and relative. The CUDA
kernels are held against these plain versions on the card
(``tests/test_torch_cuda.py`` and ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowasr_tpu.ops.pallas import attention_kernel as jak
from tensorflowasr_tpu.ops.pallas import conv_kernel as jck
from tensorflowasr_tpu.ops.pallas import ff_kernel as jfk
from tensorflowasr_tpu_torch.ops import dropout as dr
from tensorflowasr_tpu_torch.ops.cuda import attention_kernel as ak
from tensorflowasr_tpu_torch.ops.cuda import conv_kernel as ck
from tensorflowasr_tpu_torch.ops.cuda import ff_kernel as fk

OUT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
SEED = 1234567


def _close(got, ref, tol, msg=""):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(ref, np.float32), **tol, err_msg=msg)


def _autograd(fn, inputs, dout):
    """Gradients of ``(fn(*inputs) * dout).sum()`` w.r.t. every input."""
    leaves = [torch.tensor(a, requires_grad=True) for a in inputs]
    out = fn(*leaves)
    out.backward(torch.tensor(dout))
    return out, [x.grad for x in leaves]


# ----------------------------------------- mask ----------------------------------------- #


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_keep_mask_equals_jax_bit_for_bit(rate):
    for seed in (0, 40499 * 3 + 7, 2**31 - 2):
        ref = np.asarray(jak._dropout_mask(jnp.int32(seed), (37, 53), rate))
        got = dr.row_col_mask(seed, 37, 53, rate).numpy()
        np.testing.assert_array_equal(got, ref)


def test_keep_mask_rate_and_scale():
    """The kept share is 1 − rate within ±1% of the rate over 10⁶ draws; kept values are 1/(1 − rate)."""
    m = dr.row_col_mask(99, 1000, 1000, 0.1)
    dropped = (m == 0).double().mean().item()
    assert abs(dropped - 0.1) < 0.001
    assert torch.all((m == 0) | (m == torch.tensor(1.0 / 0.9, dtype=torch.float32)))


def test_attention_mask_salts_each_head():
    got = ak.dropout_mask(SEED, 3, 5, 7, 0.1)
    for bh in range(3):
        ref = np.asarray(jak._dropout_mask(jnp.int32(SEED) + bh * jnp.int32(40499), (5, 7), 0.1))
        np.testing.assert_array_equal(got[bh].numpy(), ref)


def test_plain_dropout_draws_from_the_generator():
    x = torch.ones(200, 300)
    a = dr.dropout(x, 0.1, torch.Generator().manual_seed(5))
    b = dr.dropout(x, 0.1, torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and abs((a == 0).float().mean().item() - 0.1) < 0.01
    assert torch.equal(dr.dropout(x, 0.1, None), x) and torch.equal(dr.dropout(x, 0.0, torch.Generator()), x)


# ------------------------------------------- FF ------------------------------------------- #


def _ff_arrays(rng, n=48, d=16, f=64):
    return [
        rng.standard_normal((n, d)).astype(np.float32),
        (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32),
        (0.1 * rng.standard_normal(d)).astype(np.float32),
        (rng.standard_normal((d, f)) / np.sqrt(d)).astype(np.float32),
        (0.1 * rng.standard_normal(f)).astype(np.float32),
        (rng.standard_normal((f, d)) / np.sqrt(f)).astype(np.float32),
        (0.1 * rng.standard_normal(d)).astype(np.float32),
    ]


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_ff_plain_fwd_bwd_match_jax_vjp(rate):
    rng = np.random.default_rng(21)
    arrs = _ff_arrays(rng)
    dout = rng.standard_normal(arrs[0].shape).astype(np.float32)
    ref, vjp = jax.vjp(lambda *a: jfk.fused_ff(*a, jnp.int32(SEED), rate, 0.5, 1e-3, True), *map(jnp.asarray, arrs))
    ref_grads = vjp(jnp.asarray(dout))
    t = [torch.tensor(a) for a in arrs]
    _close(fk.fused_ff_plain(*t, SEED, rate), ref, OUT_TOL)
    got = fk.fused_ff_plain_bwd(*t[:6], torch.tensor(dout), SEED, rate)
    for name, g, r in zip(("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2"), got, ref_grads):
        _close(g, r, GRAD_TOL, f"ff {name} rate {rate}")


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_ff_plain_bwd_equals_autograd(rate):
    rng = np.random.default_rng(22)
    arrs = _ff_arrays(rng, n=40, d=8, f=24)
    dout = rng.standard_normal(arrs[0].shape).astype(np.float32)
    out, grads = _autograd(lambda *a: fk.fused_ff_plain(*a, SEED, rate), arrs, dout)
    got = fk.fused_ff_plain_bwd(*(torch.tensor(a) for a in arrs[:6]), torch.tensor(dout), SEED, rate)
    for g, r in zip(got, grads):
        torch.testing.assert_close(g, r, **GRAD_TOL)
    # the module entry point routes CPU tensors through the explicit backward
    _, via_fn = _autograd(lambda *a: fk.fused_ff(*a, SEED, rate), arrs, dout)
    for g, r in zip(via_fn, grads):
        torch.testing.assert_close(g, r, **GRAD_TOL)


# ------------------------------------------ conv ------------------------------------------ #


def _conv_arrays(rng, b, t, d):
    vec = lambda s=0.1, off=0.0: (off + s * rng.standard_normal(d)).astype(np.float32)
    mat = lambda: (rng.standard_normal((d, d)) / np.sqrt(d)).astype(np.float32)
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    front = [x, vec(off=1.0), vec(), mat(), vec(), mat(), vec()]
    y1 = rng.standard_normal((b, t, d)).astype(np.float32)
    back = [x, y1, vec(), np.abs(vec(off=1.0)), vec(off=1.0), vec(), mat(), vec()]
    return front, back


@pytest.mark.parametrize("b", [2, 8])
def test_conv_front_plain_fwd_bwd_match_jax_vjp(b):
    rng = np.random.default_rng(23)
    front, _ = _conv_arrays(rng, b, 16, 16)
    dout = rng.standard_normal(front[0].shape).astype(np.float32)
    ref, vjp = jax.vjp(lambda *a: jck.conv_front(*a, 1e-3, True), *map(jnp.asarray, front))
    ref_grads = vjp(jnp.asarray(dout))
    t = [torch.tensor(a) for a in front]
    _close(ck.conv_front_plain(*t), ref, OUT_TOL)
    got = ck.conv_front_plain_bwd(*t, torch.tensor(dout))
    for name, g, r in zip(("dx", "dgamma", "dbeta", "dwa", "dba", "dwb", "dbb"), got, ref_grads):
        _close(g, r, GRAD_TOL, f"conv_front {name} B {b}")


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("b", [2, 8])
def test_conv_back_plain_fwd_bwd_match_jax_vjp(b, rate):
    rng = np.random.default_rng(24)
    _, back = _conv_arrays(rng, b, 16, 16)
    dout = rng.standard_normal(back[0].shape).astype(np.float32)
    ref, vjp = jax.vjp(lambda *a: jck.conv_back(*a, jnp.int32(SEED), rate, 1.0, 1e-3, True), *map(jnp.asarray, back))
    ref_grads = vjp(jnp.asarray(dout))
    t = [torch.tensor(a) for a in back]
    _close(ck.conv_back_plain(*t, SEED, rate), ref, OUT_TOL)
    got = ck.conv_back_plain_bwd(*t[1:7], torch.tensor(dout), SEED, rate)
    _close(torch.tensor(dout), ref_grads[0], dict(rtol=0, atol=0), "skip gradient is the identity")
    for name, g, r in zip(("dy1", "dmean", "dvar", "dscale", "dbias", "dw2", "db2"), got, ref_grads[1:]):
        _close(g, r, GRAD_TOL, f"conv_back {name} B {b} rate {rate}")


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_conv_plain_bwd_equals_autograd(rate):
    rng = np.random.default_rng(25)
    front, back = _conv_arrays(rng, 2, 9, 8)
    dout = rng.standard_normal(front[0].shape).astype(np.float32)
    _, grads = _autograd(ck.conv_front_plain, front, dout)
    for g, r in zip(ck.conv_front_plain_bwd(*(torch.tensor(a) for a in front), torch.tensor(dout)), grads):
        torch.testing.assert_close(g, r, **GRAD_TOL)
    _, via_fn = _autograd(ck.conv_front, front, dout)
    for g, r in zip(via_fn, grads):
        torch.testing.assert_close(g, r, **GRAD_TOL)
    _, grads = _autograd(lambda *a: ck.conv_back_plain(*a, SEED, rate), back, dout)
    got = ck.conv_back_plain_bwd(*(torch.tensor(a) for a in back[1:7]), torch.tensor(dout), SEED, rate)
    for g, r in zip((torch.tensor(dout),) + got, grads):
        torch.testing.assert_close(g, r, **GRAD_TOL)
    _, via_fn = _autograd(lambda *a: ck.conv_back(*a, SEED, rate), back, dout)
    for g, r in zip(via_fn, grads):
        torch.testing.assert_close(g, r, **GRAD_TOL)


# ------------------------------------ relative attention ------------------------------------ #

# (T, S, R, heads, kv_bias, q_len, causal, pe_causal): ragged query lengths,
# a key-column mask, and the extra > 0 relpe shift
REL_BWD_CASES = {
    "ragged_q_len": (12, 12, 23, 2, False, True, False, False),
    "kv_bias_causal": (12, 12, 23, 2, True, True, True, False),
    "long_relpe_extra": (10, 10, 27, 2, False, True, False, False),
    "causal_pe_extra": (10, 10, 16, 2, False, True, True, True),
}


def _rel_arrays(rng, t, s, r, heads, with_kvb, with_qlen, b=2, d=8):
    bh = b * heads
    arrs = [rng.standard_normal(shape).astype(np.float32) * sc for shape, sc in (((bh, t, d), 0.5), ((bh, t, d), 0.5), ((bh, s, d), 1.0), ((bh, s, d), 1.0), ((bh, r, d), 1.0))]
    kvb = np.where(np.arange(s)[None, :] >= np.array([0, s // 3])[:, None], 0.0, -1e9).astype(np.float32)[:, None, :] if with_kvb else None
    q_len = np.array([t, t - 5], np.int32) if with_qlen else None
    return arrs, kvb, q_len


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("case", sorted(REL_BWD_CASES))
def test_rel_attention_plain_fwd_bwd_match_jax_vjp(case, rate):
    t, s, r, heads, with_kvb, with_qlen, causal, pe_causal = REL_BWD_CASES[case]
    rng = np.random.default_rng(26)
    arrs, kvb, q_len = _rel_arrays(rng, t, s, r, heads, with_kvb, with_qlen)
    dout = rng.standard_normal(arrs[0].shape).astype(np.float32)
    jkvb = None if kvb is None else jnp.asarray(kvb)
    jql = None if q_len is None else jnp.asarray(q_len)
    ref, vjp = jax.vjp(lambda *a: jak.fused_rel_attention(*a, jkvb, jql, jnp.int32(SEED), rate, causal, None, None, True, pe_causal), *map(jnp.asarray, arrs))
    ref_grads = vjp(jnp.asarray(dout))
    tt = [torch.tensor(a) for a in arrs]
    tkvb = None if kvb is None else torch.tensor(kvb)
    tql = None if q_len is None else torch.tensor(q_len)
    _close(ak.fused_rel_attention_plain(*tt, tkvb, tql, SEED, rate, causal, None, None, pe_causal), ref, OUT_TOL, case)
    got = ak.fused_rel_attention_plain_bwd(*tt, tkvb, tql, torch.tensor(dout), SEED, rate, causal, None, None, pe_causal)
    for name, g, rg in zip(("dqc", "dqp", "dk", "dv", "dpos"), got, ref_grads):
        _close(g, rg, GRAD_TOL, f"{case} {name} rate {rate}")


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_rel_attention_plain_bwd_equals_autograd(rate):
    rng = np.random.default_rng(27)
    arrs, kvb, q_len = _rel_arrays(rng, 10, 10, 27, 2, True, True)
    dout = rng.standard_normal(arrs[0].shape).astype(np.float32)
    kw = dict(kv_bias=torch.tensor(kvb), q_len=torch.tensor(q_len), seed=SEED, rate=rate, causal=True)
    _, grads = _autograd(lambda *a: ak.fused_rel_attention_plain(*a, **kw), arrs, dout)
    got = ak.fused_rel_attention_plain_bwd(*(torch.tensor(a) for a in arrs), kw["kv_bias"], kw["q_len"], torch.tensor(dout), SEED, rate, True)
    for g, r in zip(got, grads):
        torch.testing.assert_close(g, r, **GRAD_TOL)
    _, via_fn = _autograd(lambda *a: ak.fused_rel_attention(*a, **kw), arrs, dout)
    for g, r in zip(via_fn, grads):
        torch.testing.assert_close(g, r, **GRAD_TOL)


def test_rel_attention_dropout_masks_probabilities():
    """With a mask that drops a whole row's probabilities the output row is 0 —
    the mask lands on the probabilities, after the softmax."""
    rng = np.random.default_rng(28)
    arrs, _, _ = _rel_arrays(rng, 6, 6, 11, 1, False, False, b=1)
    tt = [torch.tensor(a) for a in arrs]
    full = ak.fused_rel_attention_plain(*tt, None, None, 0, 0.0)
    dropped = ak.fused_rel_attention_plain(*tt, None, None, 0, 0.999)
    assert torch.isfinite(dropped).all() and not torch.equal(full, dropped)
