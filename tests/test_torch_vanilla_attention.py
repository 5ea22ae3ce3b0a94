"""Kernel A (``fused_attention``, plain version), the vanilla
``MultiHeadAttention``, the post-norm ``MHSAModule`` and the absolute
``SinusoidalPositionalEncoding`` vs the JAX package, on the CPU.

Kernel A's plain forward and backward (dq, dk, dv, dbias) are held against
``jax.vjp`` of the JAX Pallas kernel (interpret mode), with a [BH, T, S]
and a broadcast [1, T, S] bias, f32 and bf16, at rate 0 and 0.1: the
dropout masks equal JAX ``_dropout_mask`` bit for bit, so the dropped
outputs agree too. The layers take the JAX modules' weights through
``bridge.py``. Tolerances: f32 summation order, 1e-5 on unit-scale outputs
and 1e-4 of each gradient's largest magnitude; bf16 rounds at the same
places on both sides, so one bf16 ulp (2^-8) of the output's and each
gradient's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowasr_tpu.models.encoders.conformer import MHSAModule as JMHSAModule
from tensorflowasr_tpu.models.layers import attention as jatt
from tensorflowasr_tpu.models.layers.positional import SinusoidalPositionalEncoding as JPE
from tensorflowasr_tpu.ops.pallas import attention_kernel as jak
from tensorflowasr_tpu_torch import bridge
from tensorflowasr_tpu_torch.models.encoders.conformer import MHSAModule
from tensorflowasr_tpu_torch.models.layers.attention import MultiHeadAttention
from tensorflowasr_tpu_torch.models.layers.positional import SinusoidalPositionalEncoding
from tensorflowasr_tpu_torch.ops.cuda import attention_kernel as ak

SEED = 987654


def _scaled(got, ref, rel, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err, scale = np.abs(got - ref).max(initial=0.0), np.abs(ref).max(initial=0.0)
    assert err <= rel * scale, f"{what}: max abs err {err} > {rel} x {scale}"


def _inputs(rng, bh=6, t=13, s=13, d=8, bias_bh=6):
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for shape in ((bh, t, d), (bh, s, d), (bh, s, d)))
    bias = (rng.standard_normal((bias_bh, t, s)) * 0.5).astype(np.float32)
    bias[..., t - 3:, :] = -1e9  # Keras-masked query rows: −1e9 on every column
    dout = rng.standard_normal((bh, t, d)).astype(np.float32)
    return q, k, v, bias, dout


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_mask_equals_jax_bit_for_bit(rate):
    bh, t, s = 5, 17, 23
    got = ak.dropout_mask(SEED, bh, t, s, rate).numpy()
    for i in range(bh):
        ref = np.asarray(jak._dropout_mask(jnp.int32(SEED) + i * jnp.int32(40499), (t, s), rate))
        np.testing.assert_array_equal(got[i], ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias_bh", [6, 1])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_fused_attention_plain_fwd_bwd_match_jax(dtype, bias_bh, rate):
    q, k, v, bias, dout = _inputs(np.random.default_rng(0), bias_bh=bias_bh)
    jdt = jnp.dtype(dtype)
    jargs = [jnp.asarray(a).astype(jdt) for a in (q, k, v, bias)]
    ref, vjp = jax.vjp(lambda q_, k_, v_, b_: jak.fused_attention(q_, k_, v_, b_, jnp.int32(SEED), rate), *jargs)
    jd = jnp.asarray(dout).astype(jdt)
    ref_grads = vjp(jd)
    tdt = getattr(torch, dtype)
    targs = [torch.tensor(np.asarray(a.astype(jnp.float32))).to(tdt) for a in jargs]
    leaves = [a.clone().requires_grad_(True) for a in targs]
    out = ak.fused_attention(*leaves, SEED, rate)
    out.backward(torch.tensor(np.asarray(jd.astype(jnp.float32))).to(tdt))
    rel_out, rel_grad = (1e-5, 1e-4) if dtype == "float32" else (2 ** -8, 2 ** -8)
    assert out.dtype == tdt
    _scaled(out.float().detach().numpy(), np.asarray(ref.astype(jnp.float32)), rel_out, "out")
    for name, got, want in zip(("dq", "dk", "dv", "dbias"), (x.grad for x in leaves), ref_grads):
        assert got.dtype == tdt and tuple(got.shape) == tuple(want.shape), name
        _scaled(got.float().numpy(), np.asarray(want.astype(jnp.float32)), rel_grad, name)
    if dtype == "bfloat16":
        return  # autograd through the plain forward rounds ds elsewhere than the kernel's formulas
    # the explicit backward equals autograd through the plain forward
    plain = [a.clone().requires_grad_(True) for a in targs]
    ak.fused_attention_plain(*plain, SEED, rate).backward(torch.tensor(np.asarray(jd.astype(jnp.float32))).to(tdt))
    for name, got, want in zip(("dq", "dk", "dv", "dbias"), (x.grad for x in leaves), (x.grad for x in plain)):
        _scaled(got.float().numpy(), want.float().numpy(), rel_grad, f"{name} vs autograd")


def test_fused_attention_skips_dbias_for_a_constant_bias():
    q, k, v, bias, dout = _inputs(np.random.default_rng(1), bias_bh=1)
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    ak.fused_attention(*leaves, torch.tensor(bias), SEED, 0.1).backward(torch.tensor(dout))
    assert all(x.grad is not None for x in leaves)
    _, _, _, dbias = ak.fused_attention_plain_bwd(*(torch.tensor(a) for a in (q, k, v, bias, dout)), SEED, 0.1, bias_grad=False)
    assert dbias is None


def _mask(lengths, t):
    return np.arange(t)[None, :] < np.asarray(lengths)[:, None]


@pytest.mark.parametrize("use_causal_mask", [False, True])
def test_multihead_attention_matches_jax(use_causal_mask):
    rng = np.random.default_rng(2)
    b, t, d, n, h = 3, 11, 16, 2, 8
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    mask = _mask([11, 7, 4], t)
    jm = jatt.MultiHeadAttention(num_heads=n, key_dim=h, output_dim=d)
    v = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(x)))
    v["params"] = jax.tree_util.tree_map(lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32), v["params"])  # non-zero biases
    ref, _ = jm.apply(v, jnp.asarray(x), jnp.asarray(x), query_mask=jnp.asarray(mask), use_causal_mask=use_causal_mask)
    tm = MultiHeadAttention(d, n, h, output_dim=d)
    tm.load_state_dict(bridge.state_dict_from_flax(v), strict=True)
    with torch.no_grad():
        got, _ = tm(torch.tensor(x), torch.tensor(x), query_mask=torch.tensor(mask), use_causal_mask=use_causal_mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("norm_position", ["pre", "post"])
def test_mhsa_module_vanilla_matches_jax(norm_position):
    rng = np.random.default_rng(3)
    b, t, d, n, h = 3, 11, 16, 4, 4
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    mask = jnp.asarray(_mask([11, 9, 5], t))
    jm = JMHSAModule(dmodel=d, head_size=h, num_heads=n, mha_type="mha", norm_position=norm_position)
    v = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(1), jnp.asarray(x), None, mask=mask))
    v["params"] = jax.tree_util.tree_map(lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32), v["params"])
    ref, _ = jm.apply(v, jnp.asarray(x), None, mask=mask)
    tm = MHSAModule(d, h, n, mha_type="mha", norm_position=norm_position)
    tm.load_state_dict(bridge.state_dict_from_flax(v), strict=True)
    with torch.no_grad():
        got, _ = tm(torch.tensor(x), None, mask=torch.tensor(np.asarray(mask)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("interleave,scale", [(True, 512 ** 0.5), (False, None)])
def test_sinusoidal_positional_encoding_matches_jax(interleave, scale):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 19, 12)).astype(np.float32)
    lengths = np.array([19, 10, 1], np.int32)
    ref_out, ref_pe = JPE(scale=scale, interleave=interleave).apply({}, jnp.asarray(x), jnp.asarray(lengths))
    out, pe = SinusoidalPositionalEncoding(scale=scale, interleave=interleave)(torch.tensor(x), torch.tensor(lengths))
    np.testing.assert_allclose(pe.numpy(), np.broadcast_to(np.asarray(ref_pe), pe.shape), rtol=0, atol=1e-6)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), rtol=1e-6, atol=1e-5)
    assert float(pe[2, 1:].abs().max()) == 0.0
