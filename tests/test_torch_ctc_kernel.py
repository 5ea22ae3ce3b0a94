"""The port's CTC loss, CTC kernel (plain version), loss dispatch and
greedy decode vs the JAX package, on the CPU.

- ``ctc_occupancy_plain`` (the CTC kernel's plain version) vs JAX
  ``_ctc_pallas_call`` in Pallas interpret mode: occupancy and loss;
- ``ctc_loss_pallas`` (the kernel's ``autograd.Function`` on the CPU) vs
  JAX ``ctc_loss_pallas``: values and gradients at f32 and bf16, with a
  repeated label, a row of no labels, an infeasible row (too few frames for
  its labels and repeats: JAX's finite LOG_0-based loss, not inf) and,
  through ``masked_mean``, a row with no frames;
- the plain ``ctc_loss`` (autograd) vs JAX ``ctc_loss``;
- ``get_ctc_loss_fn`` for the four ``loss_impl`` values;
- ``ctc_greedy_decode`` vs JAX: tokens and lengths equal.

Tolerances: f32 values to 1e-5 relative (the two sides sum in another
order); gradients to 1e-5 of their largest magnitude. bf16 logits are
upcast on both sides before any arithmetic; the gradient comes back in
bf16, so one bf16 ulp (2^-8 relative) of its largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowasr_tpu.ops import ctc_decode as jdecode
from tensorflowasr_tpu.ops import ctc_loss as jctc
from tensorflowasr_tpu.ops import losses as jlosses
from tensorflowasr_tpu.ops.pallas import ctc_kernel as jk
from tensorflowasr_tpu_torch.ops import losses
from tensorflowasr_tpu_torch.ops.ctc_decode import ctc_greedy_decode
from tensorflowasr_tpu_torch.ops.ctc_loss import LOG_0, ctc_loss, ctc_occupancy_plain, ctc_prep
from tensorflowasr_tpu_torch.ops.cuda.ctc_kernel import ctc_loss_pallas


def _close_scaled(got, ref, rel, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err, scale = np.abs(got - ref).max(initial=0.0), np.abs(ref).max(initial=0.0)
    assert err <= rel * scale, f"{what}: max abs err {err} > {rel} x {scale}"


def _inputs(rng, dtype=np.float32):
    """Row 0: a repeated label; row 1: shorter; row 2: no labels; row 3:
    infeasible (3 frames for the labels 2, 2, 2, which need 5)."""
    b, t, u, v = 4, 9, 4, 7
    logits = (rng.standard_normal((b, t, v)) * 2.0).astype(np.float32)
    labels = np.array([[3, 3, 5, 2], [1, 6, 0, 0], [0, 0, 0, 0], [2, 2, 2, 0]], np.int32)
    label_length = np.array([4, 2, 0, 3], np.int32)
    logit_length = np.array([9, 6, 5, 3], np.int32)
    return logits, logit_length, labels, label_length


def test_plain_kernel_matches_jax_kernel():
    logits, tl, labels, ll = _inputs(np.random.default_rng(0))
    lp_ext, skip, _, _ = jk._prep(jnp.asarray(logits), jnp.asarray(labels), 0)
    occ_ref = np.asarray(jk._ctc_pallas_call(lp_ext, skip, jnp.asarray(tl), jnp.asarray(ll), True))
    s = 2 * labels.shape[1] + 1
    got_lp, got_skip, _ = ctc_prep(torch.tensor(logits), torch.tensor(labels))
    np.testing.assert_allclose(got_lp.numpy(), np.asarray(lp_ext)[..., :s], rtol=1e-6)  # lse: summation order
    np.testing.assert_array_equal(got_skip.numpy(), np.asarray(skip)[:, 0, :s])
    occ, loss = ctc_occupancy_plain(got_lp, got_skip, torch.tensor(tl), torch.tensor(ll))
    np.testing.assert_allclose(loss.numpy(), occ_ref[:, -1, 0], rtol=1e-5)
    _close_scaled(occ.numpy(), occ_ref[:, :-1, :s], 1e-5, "occupancy")
    assert np.all(np.isfinite(loss.numpy())) and loss[3] > 1e29  # the infeasible row: finite, LOG_0-based


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ctc_loss_pallas_values_and_grads_match_jax(dtype):
    logits, tl, labels, ll = _inputs(np.random.default_rng(1))
    jx = jnp.asarray(logits).astype(dtype)
    ref, vjp = jax.vjp(lambda x: jk.ctc_loss_pallas(x, jnp.asarray(tl), jnp.asarray(labels), jnp.asarray(ll)), jx)
    x = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype)).requires_grad_(True)
    got = ctc_loss_pallas(x, torch.tensor(tl), torch.tensor(labels), torch.tensor(ll))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-5)
    w = np.array([0.7, -1.3, 0.4, 0.5], np.float32)
    got.backward(torch.tensor(w))
    (ref_grad,) = vjp(jnp.asarray(w))
    assert x.grad.dtype == x.dtype
    for row in range(4):  # each row at its own scale: the infeasible row's gradient is LOG_0 arithmetic's, not a distribution's
        _close_scaled(x.grad[row].float().numpy(), np.asarray(ref_grad[row].astype(jnp.float32)), 1e-5 if dtype == "float32" else 2 ** -8,
                      f"dlogits row {row}")


def test_masked_mean_with_a_frameless_row_matches_jax():
    logits, tl, labels, ll = _inputs(np.random.default_rng(2))
    tl = np.array([9, 6, 0, 7], np.int32)  # row 2 has no frames: left out of the mean
    labels[3] = [2, 4, 2, 0]
    jfn = jlosses.masked_mean(jk.ctc_loss_pallas)
    ref, grad = jax.value_and_grad(lambda x: jfn(x, jnp.asarray(tl), jnp.asarray(labels), jnp.asarray(ll)))(jnp.asarray(logits))
    x = torch.tensor(logits, requires_grad=True)
    got = losses.get_ctc_loss_fn("auto")(x, torch.tensor(tl), torch.tensor(labels), torch.tensor(ll))
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)
    _close_scaled(x.grad.numpy(), np.asarray(grad), 1e-5, "dlogits")
    assert float(x.grad[2].abs().max()) == 0.0


def test_plain_ctc_loss_matches_jax():
    logits, tl, labels, ll = _inputs(np.random.default_rng(3))
    ok = slice(0, 3)  # the feasible rows (autodiff through LOG_0 arithmetic is not compared)
    args = (jnp.asarray(tl[ok]), jnp.asarray(labels[ok]), jnp.asarray(ll[ok]))
    ref, vjp = jax.vjp(lambda x: jctc.ctc_loss(x, *args), jnp.asarray(logits[ok]))
    x = torch.tensor(logits[ok], requires_grad=True)
    got = ctc_loss(x, torch.tensor(tl[ok]), torch.tensor(labels[ok]), torch.tensor(ll[ok]))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-5)
    w = np.array([0.7, -1.3, 0.4], np.float32)
    got.backward(torch.tensor(w))
    _close_scaled(x.grad.numpy(), np.asarray(vjp(jnp.asarray(w))[0]), 1e-5, "dlogits")
    full = ctc_loss(torch.tensor(logits), torch.tensor(tl), torch.tensor(labels), torch.tensor(ll))
    np.testing.assert_allclose(full.numpy(), np.asarray(jctc.ctc_loss(jnp.asarray(logits), jnp.asarray(tl), jnp.asarray(labels), jnp.asarray(ll))),
                               rtol=1e-5)
    assert full[3] > -0.5 * LOG_0  # the infeasible row


@pytest.mark.parametrize("loss_impl,kernel", [("auto", True), ("pallas", True), ("xla", False), ("fused-joint", False)])
def test_ctc_loss_dispatch(loss_impl, kernel):
    fn = losses.get_ctc_loss_fn(loss_impl)
    assert fn.__name__ == ("ctc_loss_pallas_masked_mean" if kernel else "ctc_loss_masked_mean")
    logits, tl, labels, ll = (torch.tensor(a) for a in _inputs(np.random.default_rng(4)))
    ref = losses.masked_mean(ctc_loss)(logits[:3], tl[:3], labels[:3], ll[:3])
    np.testing.assert_allclose(fn(logits[:3], tl[:3], labels[:3], ll[:3]).item(), ref.item(), rtol=1e-5)
    with pytest.raises(ValueError):
        losses.get_ctc_loss_fn("tpu")


def test_greedy_decode_matches_jax():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((4, 23, 5)).astype(np.float32)
    logits[:, :, 0] += 0.8  # blanks between tokens, and repeats
    lengths = np.array([23, 17, 1, 0], np.int32)
    ref_tokens, ref_len = jdecode.ctc_greedy_decode(jnp.asarray(logits), jnp.asarray(lengths))
    tokens, lens = ctc_greedy_decode(torch.tensor(logits), torch.tensor(lengths))
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(ref_tokens))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(ref_len))
    assert lens[0] > 3 and lens[3] == 0
