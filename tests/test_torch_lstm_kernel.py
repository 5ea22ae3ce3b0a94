"""TPU kernel row 12, the whole-sequence LSTM, vs the JAX package, on the CPU.

``ops/cuda/lstm_kernel.py``'s plain forward and its explicit backward
(what a CPU tensor runs) against JAX ``lstm_core`` and ``jax.vjp``
(Pallas, interpret mode); ``lstm_layer_fused`` against JAX's on the same
flax cell parameters carried by ``bridge.py`` (lengths with a 0:
post-length outputs zeroed, the initial carry kept); the port's
``RNN(rnn_impl="pallas")`` against JAX's ``RNN`` under
``TFASR_RNN_IMPL=pallas`` and against the port's own ``"auto"`` loop,
within lengths and through a masked loss's gradients (as
``tests/test_fused_lstm.py`` holds the Pallas kernel to the scan); the bf16
output dtype.

Tolerances: f32, summation order only: 2e-5 on values, 2e-4 on gradients.
bf16 (the same rounding points on both sides: xg, y, the cell sequence and
the gates stored in bf16, the recurrent product's operands rounded to bf16
with f32 accumulation): 2e-2 on values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowasr_tpu.models.layers.rnn import RNN as JRNN
from tensorflowasr_tpu.ops.pallas.lstm_kernel import lstm_core as jlstm_core
from tensorflowasr_tpu.ops.pallas.lstm_kernel import lstm_layer_fused as jlstm_layer
from tensorflowasr_tpu_torch import bridge
from tensorflowasr_tpu_torch.models.layers.rnn import RNN
from tensorflowasr_tpu_torch.ops.cuda import lstm_kernel as lk

VAL, GRAD = dict(rtol=2e-5, atol=2e-5), dict(rtol=2e-4, atol=2e-4)


def _core_inputs(rng, b, t, h):
    xg = rng.standard_normal((b, t, 4 * h)).astype(np.float32)
    wh = (rng.standard_normal((h, 4 * h)) / np.sqrt(h)).astype(np.float32)
    h0, c0 = ((rng.standard_normal((b, h)) * 0.3).astype(np.float32) for _ in range(2))
    dy, dc = rng.standard_normal((b, t, h)).astype(np.float32), (rng.standard_normal((b, t, h)) * 0.3).astype(np.float32)
    return (xg, wh, h0, c0), (dy, dc)


@pytest.mark.parametrize("b,t,h", [(3, 17, 24), (2, 33, 32)])
def test_lstm_core_plain_matches_jax(b, t, h):
    """Forward (y, cseq) and the explicit backward (dxg, dWh, dh0, dc0)."""
    inputs, (dy, dc) = _core_inputs(np.random.default_rng(0), b, t, h)
    ref, vjp = jax.vjp(lambda *a: jlstm_core(*a, True), *map(jnp.asarray, inputs))
    ref_grads = vjp((jnp.asarray(dy), jnp.asarray(dc)))
    leaves = [torch.tensor(a, requires_grad=True) for a in inputs]
    y, cseq = lk.lstm_core(*leaves)
    torch.autograd.backward((y, cseq), (torch.tensor(dy), torch.tensor(dc)))
    for name, g, r in zip(("y", "cseq"), (y, cseq), ref):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r), **VAL, err_msg=name)
    for name, leaf, r in zip(("dxg", "dwh", "dh0", "dc0"), leaves, ref_grads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(r), **GRAD, err_msg=name)


def test_lstm_core_bf16_matches_jax():
    """bf16 in, bf16 out, at the same rounding points."""
    inputs, (dy, dc) = _core_inputs(np.random.default_rng(1), 3, 17, 24)
    ref = jlstm_core(*(jnp.asarray(a).astype(jnp.bfloat16) for a in inputs), True)
    got = lk.lstm_core(*(torch.tensor(a).to(torch.bfloat16) for a in inputs))
    for name, g, r in zip(("y", "cseq"), got, ref):
        assert g.dtype == torch.bfloat16 and r.dtype == jnp.bfloat16
        np.testing.assert_allclose(g.float().numpy(), np.asarray(r, np.float32), rtol=0, atol=2e-2, err_msg=name)


def _cell(rng, e, h):
    """flax ``OptimizedLSTMCell`` parameters: ii..io kernels [E, H], hi..ho kernels [H, H] with biases."""
    cell = {f"i{g}": {"kernel": (rng.standard_normal((e, h)) / np.sqrt(e)).astype(np.float32)} for g in "ifgo"}
    cell.update({f"h{g}": {"kernel": (rng.standard_normal((h, h)) / np.sqrt(h)).astype(np.float32),
                           "bias": (rng.standard_normal(h) * 0.1).astype(np.float32)} for g in "ifgo"})
    return cell


def test_lstm_layer_fused_matches_jax_with_lengths():
    """Lengths 7, 0 and 3 of 7: y zeroed past each length, the carry at
    length − 1, the length-0 row keeping (c0, h0); values and the gradients
    of the cell parameters (carried through ``bridge.py``), x, h0 and c0."""
    rng = np.random.default_rng(2)
    b, t, e, h = 3, 7, 10, 12
    cell = _cell(rng, e, h)
    x = rng.standard_normal((b, t, e)).astype(np.float32)
    h0, c0 = ((rng.standard_normal((b, h)) * 0.3).astype(np.float32) for _ in range(2))
    lengths = np.array([7, 0, 3], np.int32)
    gy, gc, gh = rng.standard_normal((b, t, h)).astype(np.float32), rng.standard_normal((b, h)).astype(np.float32), rng.standard_normal((b, h)).astype(np.float32)

    def jloss(cell, x, h0, c0):
        y, (c_t, h_t) = jlstm_layer(x, cell, h0, c0, jnp.asarray(lengths), interpret=True)
        return jnp.sum(y * gy) + jnp.sum(c_t * gc) + jnp.sum(h_t * gh), (y, c_t, h_t)

    (_, (jy, jc, jh)), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True)(cell, jnp.asarray(x), jnp.asarray(h0), jnp.asarray(c0))
    params = {k: torch.tensor(v, requires_grad=True) for k, v in bridge._lstm_cell(cell).items()}
    tx, th0, tc0 = (torch.tensor(a, requires_grad=True) for a in (x, h0, c0))
    y, (c_t, h_t) = lk.lstm_layer_fused(tx, params["weight_ih"], params["weight_hh"], params["bias"], th0, tc0, torch.tensor(lengths))
    ((y * torch.tensor(gy)).sum() + (c_t * torch.tensor(gc)).sum() + (h_t * torch.tensor(gh)).sum()).backward()
    for name, g, r in zip(("y", "c_T", "h_T"), (y, c_t, h_t), (jy, jc, jh)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r), **VAL, err_msg=name)
    assert float(y.detach()[1].abs().max()) == 0.0 and float(y.detach()[2, 3:].abs().max()) == 0.0
    np.testing.assert_array_equal(c_t[1].detach().numpy(), c0[1])
    np.testing.assert_array_equal(h_t[1].detach().numpy(), h0[1])
    ref_params = bridge._lstm_cell(jax.tree_util.tree_map(np.asarray, jgrads[0]))
    for name, p in params.items():
        np.testing.assert_allclose(p.grad.numpy(), ref_params[name], **GRAD, err_msg=name)
    for name, leaf, r in zip(("x", "h0", "c0"), (tx, th0, tc0), jgrads[1:]):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(r), **GRAD, err_msg=name)


def _rnn_pair(monkeypatch, x, lengths, units, dtype=jnp.float32):
    """JAX ``RNN`` (params and a forward under ``TFASR_RNN_IMPL=pallas``) and
    the port's ``RNN(rnn_impl="pallas")`` and ``"auto"`` with the same weights."""
    monkeypatch.setenv("TFASR_RNN_IMPL", "pallas")
    jm = JRNN(units=units, rnn_type="lstm", dtype=dtype)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(lengths))
    sd = bridge.state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params))
    tdtype = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    ports = {}
    for impl in ("pallas", "auto"):
        ports[impl] = RNN(x.shape[-1], units, dtype=tdtype, rnn_impl=impl)
        ports[impl].load_state_dict(sd, strict=True)
    return jm, params, ports


@pytest.mark.parametrize("b,t,e,h", [(3, 17, 12, 24), (2, 33, 20, 32)])
def test_rnn_pallas_matches_jax_and_auto(monkeypatch, b, t, e, h):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((b, t, e)) * 0.5).astype(np.float32)
    lengths = rng.integers(1, t + 1, size=(b,)).astype(np.int32)
    lengths[0] = t
    jm, params, ports = _rnn_pair(monkeypatch, x, lengths, h)
    jy, (jc, jh) = jm.apply(params, jnp.asarray(x), jnp.asarray(lengths))
    with torch.no_grad():
        y, (c, hh) = ports["pallas"](torch.tensor(x), torch.tensor(lengths))
        ya, (ca, ha) = ports["auto"](torch.tensor(x), torch.tensor(lengths))
    for name, g, r in zip(("y", "c", "h"), (y, c, hh), (jy, jc, jh)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **VAL, err_msg=name)
    # the loop runs past each length and the fused path zeroes there: compare within lengths
    mask = torch.tensor(np.arange(t)[None, :, None] < lengths[:, None, None])
    torch.testing.assert_close(y * mask, ya * mask, **VAL)
    torch.testing.assert_close((c, hh), (ca, ha), **VAL)


def test_rnn_pallas_grads_match_auto(monkeypatch):
    """Gradients of the weights, x and the initial state through a masked
    loss, the pallas path against the port's loop (``test_fused_lstm.py:63-87``)."""
    rng = np.random.default_rng(4)
    b, t, e, h = 4, 21, 16, 24
    x = (rng.standard_normal((b, t, e)) * 0.5).astype(np.float32)
    lengths = np.array([21, 13, 1, 7], np.int32)
    mask = torch.tensor(np.arange(t)[None, :, None] < lengths[:, None, None]).float()
    gy, gc = torch.tensor(rng.standard_normal((b, t, h)).astype(np.float32)), torch.tensor(rng.standard_normal((b, h)).astype(np.float32))
    c0, h0 = (torch.tensor((rng.standard_normal((b, h)) * 0.3).astype(np.float32)) for _ in range(2))
    _, _, ports = _rnn_pair(monkeypatch, x, lengths, h)
    grads = {}
    for impl, m in ports.items():
        leaves = [torch.tensor(x, requires_grad=True), c0.clone().requires_grad_(True), h0.clone().requires_grad_(True)]
        y, (c, hh) = m(leaves[0], torch.tensor(lengths), (leaves[1], leaves[2]))
        ((y * mask * gy).sum() + (c * gc).sum() + (hh * gc).sum()).backward()
        grads[impl] = [p.grad for p in m.parameters()] + [l.grad for l in leaves]
    for got, ref in zip(grads["pallas"], grads["auto"]):
        torch.testing.assert_close(got, ref, **GRAD)


def test_rnn_pallas_bf16_output_dtype(monkeypatch):
    """bf16: the fused path returns bf16 outputs (the loop promotes to f32,
    as flax's scan does), equal to JAX's fused path."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((4, 20, 32)) * 0.5).astype(np.float32)
    lengths = np.array([20, 11, 3, 16], np.int32)
    jm, params, ports = _rnn_pair(monkeypatch, x, lengths, 32, dtype=jnp.bfloat16)
    jy, _ = jm.apply(params, jnp.asarray(x), jnp.asarray(lengths))
    with torch.no_grad():
        y, _ = ports["pallas"](torch.tensor(x), torch.tensor(lengths))
        ya, _ = ports["auto"](torch.tensor(x), torch.tensor(lengths))
    assert y.dtype == torch.bfloat16 and jy.dtype == jnp.bfloat16 and ya.dtype == torch.float32
    np.testing.assert_allclose(y.float().numpy(), np.asarray(jy, np.float32), rtol=0, atol=2e-2)


def test_rnn_impl_is_checked():
    with pytest.raises(ValueError, match="rnn_impl"):
        RNN(4, 8, rnn_impl="fused")
