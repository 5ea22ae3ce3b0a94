"""Relative attention beyond the Conformer's path vs the JAX package, on the
CPU, at f32: kernel B's plain version at head 128, relative MHA with an
explicit ``attention_mask`` (kernel A's plain version with the positional
scores as its bias), and the relative-PE Transformer encoder in a tiny
Transformer-CTC.

- Kernel B at head 128: the plain forward and backward (dqc, dqp, dk, dv,
  dpos) against ``jax.vjp`` of the JAX Pallas kernel in interpret mode,
  with and without ``pe_causal`` (R = T), the chunk/history mask and
  dropout at 0.1 (masks equal JAX's bit for bit): 1e-5 on unit-scale
  outputs, 1e-4 of each gradient's largest magnitude (f32 summation order).
- Relative MHA with an explicit mask (causal and not, with and without a KV
  memory): the output and the gradient of every input and parameter against
  ``jax.grad`` of JAX's layer, which takes its kernel-A fallback (Pallas in
  interpret mode): the same tolerances, plus 1e-6 of the largest parameter
  gradient for the key bias, whose gradient is zero in exact arithmetic.
- The relmha Transformer-CTC at 2 blocks (``relmha_causal`` true and
  false, chunk and history, ``use_attention_bias``): logits to 1e-4 of
  their largest magnitude, greedy tokens equal; for the streaming example's
  layout also the ``xla`` training step (loss, ``grad_norm``, every
  gradient and 3 Adam steps) with the checks of ``test_torch_train_slice.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowasr_tpu.models.ctc.transformer import TransformerCtc as JTransformerCtc
from tensorflowasr_tpu.models.layers import attention as jatt
from tensorflowasr_tpu.models.layers.positional import RelativeSinusoidalPositionalEncoding as JRelPE
from tensorflowasr_tpu.ops.pallas import attention_kernel as jak
from tensorflowasr_tpu_torch import bridge
from tensorflowasr_tpu_torch.models.ctc.transformer import TransformerCtc
from tensorflowasr_tpu_torch.models.layers.attention import MultiHeadRelativeAttention
from tensorflowasr_tpu_torch.models.layers.positional import RelativeSinusoidalPositionalEncoding
from tensorflowasr_tpu_torch.ops.cuda import attention_kernel as ak
from tests.test_torch_ctc_slice import _COMMON, _both
from tests.test_torch_train_slice import _close_scaled, check_first_step_loss_and_grad_norm, check_k_adam_steps, run_both


def _scaled(got, ref, rel, what, floor=0.0):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err, scale = np.abs(got - ref).max(initial=0.0), np.abs(ref).max(initial=0.0)
    assert err <= rel * scale + floor, f"{what}: max abs err {err} > {rel} x {scale} + {floor}"


# (T, S, R, pe_causal, chunk, history, rate): the non-causal relpe (R = 2T − 1), the causal one (R = T) under the chunk mask
HEAD128 = {"noncausal": (6, 6, 11, False, None, None, 0.0), "causal_chunk_dropout": (7, 7, 7, True, 2, 2, 0.1)}


@pytest.mark.parametrize("case", sorted(HEAD128))
def test_kernel_b_plain_at_head_128_matches_jax(case):
    t, s, r, pe_causal, chunk, hist, rate = HEAD128[case]
    b, h, d = 2, 2, 128
    rng = np.random.default_rng(3)
    qc, qp = (rng.standard_normal((b * h, t, d)).astype(np.float32) * 0.2 for _ in range(2))
    k, v = (rng.standard_normal((b * h, s, d)).astype(np.float32) for _ in range(2))
    pos = rng.standard_normal((b * h, r, d)).astype(np.float32)
    q_len = np.array([t, t - 2], np.int32)
    dout = rng.standard_normal((b * h, t, d)).astype(np.float32)
    seed = 77
    jfn = lambda qc_, qp_, k_, v_, pos_: jak.fused_rel_attention(qc_, qp_, k_, v_, pos_, None, jnp.asarray(q_len), jnp.int32(seed), rate, False,
                                                              chunk, hist, pe_causal=pe_causal)
    ref, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in (qc, qp, k, v, pos)))
    ref_grads = vjp(jnp.asarray(dout))
    tin = [torch.tensor(a) for a in (qc, qp, k, v, pos)]
    args = (None, torch.tensor(q_len), seed, rate, False, chunk, hist, pe_causal)
    got = ak.fused_rel_attention_plain(*tin, *args)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    grads = ak.fused_rel_attention_plain_bwd(*tin, args[0], args[1], torch.tensor(dout), *args[2:])
    for name, g, rg in zip(("dqc", "dqp", "dk", "dv", "dpos"), grads, ref_grads):
        _scaled(g.numpy(), np.asarray(rg), 1e-4, name)


# (causal, memory_length)
MASKED = [(False, None), (True, None), (False, 3), (True, 3)]


@pytest.mark.parametrize("causal,memory", MASKED, ids=[f"causal{c}-mem{m}" for c, m in MASKED])
def test_relative_mha_with_an_explicit_mask_matches_jax(causal, memory):
    b, t, dm, n, hd = 2, 6, 16, 2, 8
    m = memory or 0
    s = t + m
    rng = np.random.default_rng(5)
    x = rng.standard_normal((b, t, dm)).astype(np.float32)
    lengths = np.array([t, t - 2], np.int32)
    attn = rng.random((b, t, s)) < 0.7
    attn[:, np.arange(t), m + np.arange(t)] = True  # every query row sees its own frame
    qmask = np.arange(t)[None, :] < lengths[:, None]
    mem = {"k": rng.standard_normal((b, m, dm)).astype(np.float32), "v": rng.standard_normal((b, m, dm)).astype(np.float32),
           "mask": rng.random((b, m)) < 0.8} if memory else None
    jpe = JRelPE(memory_length=memory, causal=causal)
    _, relpe = jpe.apply({}, jnp.asarray(x), jnp.asarray(lengths))
    jlayer = jatt.MultiHeadRelativeAttention(num_heads=n, key_dim=hd, output_dim=dm, memory_length=memory, causal=causal, use_attention_bias=True)
    kw = dict(query_mask=jnp.asarray(qmask), attention_mask=jnp.asarray(attn))
    jmem = None if mem is None else {k_: jnp.asarray(v_) for k_, v_ in mem.items()}
    params = jlayer.init(jax.random.PRNGKey(2), jnp.asarray(x), jnp.asarray(x), relpe=relpe, memory_state=jmem, **kw)["params"]
    params = jax.tree_util.tree_map(lambda a: a + 0.1 * jnp.asarray(rng.standard_normal(a.shape), jnp.float32), params)  # nonzero biases
    w_out = rng.standard_normal((b, t, dm)).astype(np.float32)

    def jloss(p, x_, rel_):
        out, _ = jlayer.apply({"params": p}, x_, x_, relpe=rel_, memory_state=jmem, **kw)
        return jnp.sum(out * w_out), out

    (_, jout), (jgp, jgx, jgr) = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(params, jnp.asarray(x), relpe)
    layer = MultiHeadRelativeAttention(dm, n, hd, dm, causal=causal, use_attention_bias=True, memory_length=memory)
    layer.load_state_dict(bridge.state_dict_from_flax({"params": jax.tree_util.tree_map(np.asarray, params)}), strict=True)
    tx, trel = torch.tensor(x, requires_grad=True), torch.tensor(np.asarray(relpe), requires_grad=True)
    tmem = None if mem is None else {k_: torch.tensor(v_) for k_, v_ in mem.items()}
    out, _ = layer(tx, tx, relpe=trel, query_mask=torch.tensor(qmask), attention_mask=torch.tensor(attn), memory_state=tmem)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=0, atol=1e-5)
    (out * torch.tensor(w_out)).sum().backward()
    _scaled(tx.grad.numpy(), np.asarray(jgx), 1e-4, "d query")
    _scaled(trel.grad.numpy(), np.asarray(jgr), 1e-4, "d relpe")
    ref = bridge.state_dict_from_flax({"params": jax.tree_util.tree_map(np.asarray, jgp)})
    floor = 1e-6 * max(np.abs(g.numpy()).max() for g in ref.values())  # key.bias: zero in exact arithmetic, f32 noise on both sides
    for name, p in layer.named_parameters():
        _scaled(p.grad.numpy(), ref[name].numpy(), 1e-4, name, floor)


def test_relative_pe_of_the_causal_transformer_is_t_long():
    """With ``relmha_causal`` and no memory the relative PE has R = T rows, which kernel B's shift takes (extra 0)."""
    x, lengths = torch.zeros(2, 9, 16), torch.tensor([9, 5])
    _, relpe = RelativeSinusoidalPositionalEncoding(causal=True)(x, lengths)
    assert relpe.shape == (2, 9, 16) and ak._shift_extra(9, 9, 9, True) == 0


RELMHA_CFG = {**_COMMON, "encoder_dmodel": 16, "encoder_dff": 24, "encoder_num_blocks": 2, "encoder_head_size": 8, "encoder_num_heads": 2,
              "encoder_mha_type": "relmha", "encoder_norm_position": "post", "encoder_residual_factor": 1.0, "encoder_pwffn_activation": "relu"}
# the streaming example's layout (relmha_causal, chunk 16 → 4, history 64 → 8) with per-block biases, and the non-causal one without
RELMHA_CASES = {
    "causal_chunk_bias": {**RELMHA_CFG, "encoder_relmha_causal": True, "encoder_chunk_size": 4, "encoder_history_size": 8,
                          "encoder_use_attention_bias": True},
    "noncausal": RELMHA_CFG,
}


@pytest.mark.parametrize("case", sorted(RELMHA_CASES))
def test_relmha_transformer_ctc_forward_matches_jax(case, monkeypatch):
    import tests.test_torch_ctc_slice as slice_

    monkeypatch.setitem(slice_.MODELS, "relmha", (JTransformerCtc, TransformerCtc, RELMHA_CASES[case]))
    jm, v, tm, arrs = _both("relmha")
    sig, lens = arrs[0], arrs[1]
    ref, ref_len, _ = jax.jit(lambda v_, s_, l_: jm.apply(v_, s_, l_, method=jm.encode))(v, jnp.asarray(sig), jnp.asarray(lens))
    tm.eval()
    with torch.inference_mode():
        got, got_len, _ = tm.encode(torch.tensor(sig), torch.tensor(lens))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(ref_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-4 * np.abs(np.asarray(ref)).max())
    np.testing.assert_array_equal(got.argmax(-1).numpy(), np.asarray(ref).argmax(-1))


@pytest.fixture(scope="module")
def relmha_runs():
    return run_both("xla", cfg=RELMHA_CASES["causal_chunk_bias"], jax_cls=JTransformerCtc, port_cls=TransformerCtc)


def test_relmha_train_step_loss_and_grad_norm_match_jax(relmha_runs):
    check_first_step_loss_and_grad_norm(relmha_runs)


def test_relmha_train_step_every_gradient_matches_jax(relmha_runs):
    """Every gradient as ``check_first_step_every_gradient`` holds it; the
    encoding bias is not among the gradients that vanish here: under the
    causal relative PE some columns read no position (their term is 0, not
    qp·b), so qp·b is no per-row constant."""
    jax_steps, _, torch_steps, _, _ = relmha_runs
    ref = bridge.state_dict_from_flax({"params": jax_steps[0][2]})
    got = torch_steps[0][2]
    assert set(got) == {k for k in ref if not k.endswith(("running_mean", "running_var"))}
    gmax = max(np.abs(r.numpy()).max() for r in ref.values())
    for name, g in got.items():
        _close_scaled(g.numpy(), ref[name].numpy(), floor=1e-6 * gmax, what=name)
    assert np.abs(ref["encoder.block_0.mhsa_module.mhsa.encoding.bias"].numpy()).max() > 1e-4 * gmax


def test_relmha_k_adam_steps_match_jax(relmha_runs):
    check_k_adam_steps(relmha_runs)
