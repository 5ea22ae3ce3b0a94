"""The plain versions of the two loss kernels vs the JAX package, on the CPU.

Row 9, the RNN-T DP over log-probabilities
(``ops/rnnt_loss.py:rnnt_loss_from_logprobs_plain`` behind
``ops/cuda/rnnt_kernel.py:rnnt_loss_from_logprobs``), against JAX
``rnnt_loss_from_logprobs`` (Pallas, interpret mode) and against JAX
``rnnt_loss`` (the scan DP, through the log-softmax of logits): the loss
and both gradients through ``jax.vjp``, f32, 1e-5 relative (gradients: of
each tensor's largest magnitude). Ragged lengths, a row without labels, a
row of one frame, and a row with more labels than frames.

Row 8, the fused joint+loss (``ops/cuda/joint_loss_kernel.py``), against
JAX ``rnnt_loss_fused_joint`` (interpret mode): at f32 the loss to 1e-5 and
the four gradients to 2e-4 relative, as ``tests/test_fused_joint_loss.py``
holds the JAX kernel to its unfused composition; at bf16 inputs, with the
same rounding points (bf16 add and tanh, bf16 product operands with f32
accumulation), the loss to 1e-3 relative and the gradients to 2e-2 of each
tensor's scale: the two frameworks' bf16 tanh may round one value in a few
hundred the other way, which moves the sums by about that much.

Inputs are made with numpy from a seed and given to both sides. The CUDA
kernels are held against these plain versions on the card
(``tests/test_torch_cuda.py`` and ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowasr_tpu.ops.pallas.joint_loss_kernel import rnnt_loss_fused_joint as jfused
from tensorflowasr_tpu.ops.pallas.rnnt_kernel import rnnt_loss_from_logprobs as jdp
from tensorflowasr_tpu.ops.rnnt_loss import rnnt_loss as jrnnt_loss
from tensorflowasr_tpu.utils.math_util import LOG_0
from tensorflowasr_tpu_torch.ops.cuda import joint_loss_kernel as jk
from tensorflowasr_tpu_torch.ops.cuda import rnnt_kernel as rk

B, T, U = 4, 7, 5
T_LEN = np.array([7, 5, 1, 3], np.int32)  # row 2: one frame
U_LEN = np.array([5, 0, 3, 5], np.int32)  # row 1: no labels; row 3: more labels than frames
COT = np.array([0.5, 1.0, -2.0, 1.3], np.float32)  # upstream cotangent per row


def _scaled_close(got, ref, rel, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err, scale = np.abs(got - ref).max(initial=0.0), np.abs(ref).max(initial=0.0)
    assert err <= rel * scale, f"{what}: max abs err {err} > {rel} x {scale}"


def _logprobs(rng):
    lp = np.log(rng.dirichlet(np.ones(4), size=(B, T, U + 1))).astype(np.float32)
    lpe = lp[..., 1].copy()
    lpe[..., U] = LOG_0
    return lp[..., 0].copy(), lpe


def _torch_vjp(fn, inputs, cot):
    leaves = [torch.tensor(x, requires_grad=True) for x in inputs]
    out = fn(*leaves)
    out.backward(torch.tensor(cot))
    return out.detach().numpy(), [x.grad.numpy() for x in leaves]


# ------------------------------------------- row 9 ------------------------------------------- #


def test_dp_matches_jax_kernel():
    lpb, lpe = _logprobs(np.random.default_rng(0))
    ref, vjp = jax.vjp(lambda a, b: jdp(a, b, jnp.asarray(T_LEN), jnp.asarray(U_LEN), True), jnp.asarray(lpb), jnp.asarray(lpe))
    ref_grads = vjp(jnp.asarray(COT))
    got, grads = _torch_vjp(lambda a, b: rk.rnnt_loss_from_logprobs(a, b, torch.tensor(T_LEN), torch.tensor(U_LEN)), (lpb, lpe), COT)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5)
    for name, g, r in zip(("d lp_blank", "d lp_emit"), grads, ref_grads):
        _scaled_close(g, r, 1e-5, name)


def test_dp_gradients_vanish_outside_each_lattice():
    lpb, lpe = _logprobs(np.random.default_rng(1))
    _, gbl, gem = rk.loss_and_grads(torch.tensor(lpb), torch.tensor(lpe), torch.tensor(T_LEN), torch.tensor(U_LEN))
    t, u = np.arange(T)[None, :, None], np.arange(U + 1)[None, None, :]
    outside = (t >= T_LEN[:, None, None]) | (u > U_LEN[:, None, None])
    assert np.all(gbl.numpy()[outside] == 0.0) and np.all(gem.numpy()[outside] == 0.0)
    # each row's blank and emit occupancies sum to the lattice's T_b + U_b transitions
    np.testing.assert_allclose(-(gbl + gem).sum((1, 2)).numpy(), T_LEN + U_LEN, rtol=1e-5)


def test_dp_matches_jax_scan_loss_through_log_softmax():
    rng = np.random.default_rng(2)
    v = 6
    logits = rng.standard_normal((B, T, U + 1, v)).astype(np.float32)
    labels = rng.integers(1, v, (B, U)).astype(np.int32)
    ref, vjp = jax.vjp(lambda x: jrnnt_loss(x, jnp.asarray(T_LEN), jnp.asarray(labels), jnp.asarray(U_LEN)), jnp.asarray(logits))
    (ref_grad,) = vjp(jnp.asarray(COT))

    def port(x):
        lp = torch.log_softmax(x, dim=-1)
        lpe = torch.gather(lp[:, :, :U], 3, torch.tensor(labels, dtype=torch.int64)[:, None, :, None].expand(B, T, U, 1))[..., 0]
        lpe = torch.cat([lpe, torch.full((B, T, 1), LOG_0)], dim=2)
        return rk.rnnt_loss_from_logprobs(lp[..., 0], lpe, torch.tensor(T_LEN), torch.tensor(U_LEN))

    got, (grad,) = _torch_vjp(port, (logits,), COT)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5)
    _scaled_close(grad, ref_grad, 1e-5, "d logits")


# ------------------------------------------- row 8 ------------------------------------------- #


def _joint_case(seed, j=8, v=12):
    r = np.random.default_rng(seed)
    enc_p = r.standard_normal((B, T, j)).astype(np.float32)
    pred_p = r.standard_normal((B, U + 1, j)).astype(np.float32)
    wv = (r.standard_normal((v, j)) * 0.7).astype(np.float32)  # the port's layout [V, J]
    bv = (r.standard_normal(v) * 0.1).astype(np.float32)
    labels = r.integers(1, v, (B, U)).astype(np.int32)
    return enc_p, pred_p, wv, bv, labels


def _jax_fused(enc_p, pred_p, wv, bv, labels, dtype):
    args = [jnp.asarray(x).astype(dtype) for x in (enc_p, pred_p, wv.T)] + [jnp.asarray(bv)]
    ref, vjp = jax.vjp(lambda e, p, w, b: jfused(e, p, w, b, jnp.asarray(T_LEN), jnp.asarray(labels), jnp.asarray(U_LEN), 0, True), *args)
    de, dp, dw, db = vjp(jnp.asarray(COT))
    return np.asarray(ref, np.float32), [np.asarray(g, np.float32) for g in (de, dp, jnp.transpose(dw), db)]


def _port_fused(enc_p, pred_p, wv, bv, labels, dtype):
    leaves = [torch.tensor(x).to(dtype).requires_grad_(True) for x in (enc_p, pred_p, wv)] + [torch.tensor(bv, requires_grad=True)]
    loss = jk.rnnt_loss_fused_joint(*leaves, torch.tensor(T_LEN), torch.tensor(labels), torch.tensor(U_LEN))
    loss.backward(torch.tensor(COT))
    return loss.detach().numpy(), [x.grad.float().numpy() for x in leaves]


@pytest.mark.parametrize("j,v", [(8, 12), (5, 7)])
def test_fused_joint_matches_jax_f32(j, v):
    case = _joint_case(3, j, v)
    ref, ref_grads = _jax_fused(*case, jnp.float32)
    got, grads = _port_fused(*case, torch.float32)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    for name, g, r in zip(("d enc_p", "d pred_p", "d wv", "d bv"), grads, ref_grads):
        np.testing.assert_allclose(g, r, rtol=2e-4, atol=1e-6, err_msg=name)


def test_fused_joint_matches_jax_bf16():
    case = _joint_case(4, 16, 20)
    ref, ref_grads = _jax_fused(*case, jnp.bfloat16)
    got, grads = _port_fused(*case, torch.bfloat16)
    np.testing.assert_allclose(got, ref, rtol=1e-3)
    for name, g, r in zip(("d enc_p", "d pred_p", "d wv", "d bv"), grads, ref_grads):
        _scaled_close(g, r, 2e-2, name)


def test_fused_joint_plain_backward_equals_autograd():
    """The explicit backward equals torch autograd through the plain joint
    statistics and the DP's saved gradients (f32, summation order: 1e-5 of
    each gradient's scale)."""
    enc_p, pred_p, wv, bv, labels = _joint_case(5)

    def unfused(e, p, w, b):
        lpb, lpe, _ = jk.joint_logprobs_plain(e, p, w, b, torch.tensor(labels))
        return rk.rnnt_loss_from_logprobs(lpb, lpe, torch.tensor(T_LEN), torch.tensor(U_LEN))

    _, ref_grads = _torch_vjp(unfused, (enc_p, pred_p, wv, bv), COT)
    _, grads = _port_fused(enc_p, pred_p, wv, bv, labels, torch.float32)
    for name, g, r in zip(("d enc_p", "d pred_p", "d wv", "d bv"), grads, ref_grads):
        _scaled_close(g, r, 1e-5, name)
