"""TPU kernel row 10, the unfused Pallas RNN-T loss, vs the JAX package, on the CPU.

The plain versions of the two row kernels (``ops/rnnt_loss.py``:
``logits_to_logprobs_plain`` and ``dlogits_assemble_plain``) against JAX's
``_logits_to_logprobs`` and ``_dlogits_assemble`` (Pallas, interpret mode),
at an unaligned V (29) and V = 256, in f32 and bf16; and the port's
``rnnt_loss_pallas`` (``ops/cuda/rnnt_kernel.py``: those two around the DP)
against JAX's ``rnnt_loss_pallas`` and ``jax.vjp``, per row and through
``masked_mean`` with an invalid row (logit length 0) whose gradient is 0.

Tolerances: f32, summation order only: 1e-5 relative (gradients: of each
tensor's largest magnitude). bf16 logits: both sides upcast the same bf16
values and compute in f32, but the gradient is rounded to bf16, where a
summation-order difference can flip one rounding: 2e-2 absolute.

Inputs are made with numpy from a seed and given to both sides. The CUDA
kernels are held against these plain versions on the card
(``tests/test_torch_cuda.py`` and ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowasr_tpu.ops import losses as jlosses
from tensorflowasr_tpu.ops.pallas.rnnt_kernel import _dlogits_assemble, _logits_to_logprobs
from tensorflowasr_tpu.ops.pallas.rnnt_kernel import rnnt_loss_pallas as jrnnt_pallas
from tensorflowasr_tpu_torch.ops import losses
from tensorflowasr_tpu_torch.ops.cuda import rnnt_kernel as rk
from tensorflowasr_tpu_torch.ops.rnnt_loss import dlogits_assemble_plain, logits_to_logprobs_plain

B, T, U = 3, 5, 3
T_LEN = np.array([5, 3, 2], np.int32)
U_LEN = np.array([3, 1, 3], np.int32)  # row 2: more labels than frames
COT = np.array([0.5, -1.5, 1.2], np.float32)
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _close(got, ref, dtype, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err, scale = np.abs(got - ref).max(initial=0.0), np.abs(ref).max(initial=0.0)
    allowed = 1e-5 * scale if dtype == "f32" else 2e-2
    assert err <= allowed, f"{what} ({dtype}): max abs err {err} > {allowed}"


def _case(seed, v, b=B, t=T, u=U):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((b, t, u + 1, v)) * 2.0).astype(np.float32)
    labels = rng.integers(1, v, (b, u)).astype(np.int32)
    return logits, labels


def _both(logits, dtype):
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(logits).astype(jdt), torch.tensor(logits).to(tdt)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("v", [29, 256])
def test_logprobs_plain_matches_jax_kernel(dtype, v):
    logits, labels = _case(0, v)
    jx, tx = _both(logits, dtype)
    ref = _logits_to_logprobs(jx, jnp.asarray(labels), True)
    got = logits_to_logprobs_plain(tx, torch.tensor(labels))
    for name, g, r in zip(("lp_blank", "lp_emit", "lse"), got, ref):
        assert g.dtype == torch.float32
        _close(g.numpy(), r, dtype, name)
    assert np.all(got[1].numpy()[..., U] == -1e30)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("v", [29, 256])
def test_dlogits_plain_matches_jax_kernel(dtype, v):
    logits, labels = _case(1, v)
    rng = np.random.default_rng(2)
    gbl, gem = (-rng.random((B, T, U + 1)).astype(np.float32) for _ in range(2))
    jx, tx = _both(logits, dtype)
    _, _, lse = _logits_to_logprobs(jx, jnp.asarray(labels), True)
    ref = _dlogits_assemble(jx, lse, jnp.asarray(gbl), jnp.asarray(gem), jnp.asarray(labels), jnp.asarray(COT), True)
    got = dlogits_assemble_plain(tx, torch.tensor(np.asarray(lse)), torch.tensor(gbl), torch.tensor(gem), torch.tensor(labels), torch.tensor(COT))
    assert got.dtype == tx.dtype and ref.dtype == jx.dtype
    _close(got.float().numpy(), np.asarray(ref, np.float32), dtype, "d logits")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rnnt_loss_pallas_matches_jax(dtype):
    """Per-row loss and d logits under a per-row cotangent."""
    logits, labels = _case(3, 29)
    jx, tx = _both(logits, dtype)
    ref, vjp = jax.vjp(lambda x: jrnnt_pallas(x, jnp.asarray(T_LEN), jnp.asarray(labels), jnp.asarray(U_LEN), 0, True), jx)
    (ref_grad,) = vjp(jnp.asarray(COT))
    x = tx.clone().requires_grad_(True)
    got = rk.rnnt_loss_pallas(x, torch.tensor(T_LEN), torch.tensor(labels), torch.tensor(U_LEN))
    got.backward(torch.tensor(COT))
    assert np.isfinite(got.detach().numpy()).all()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-5)
    assert x.grad.dtype == tx.dtype
    _close(x.grad.float().numpy(), np.asarray(ref_grad, np.float32), dtype, "d logits")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_masked_mean_pallas_matches_jax(dtype):
    """The batch mean over valid rows: row 1 has no frames, is left out of the
    mean, and its gradient is 0; row 2's label length clamps its frames."""
    logits, labels = _case(4, 12)
    t_len = np.array([5, 0, 2], np.int32)
    jx, tx = _both(logits, dtype)
    jfn = jlosses.masked_mean(jrnnt_pallas)
    ref, ref_grad = jax.value_and_grad(lambda x: jfn(x, jnp.asarray(t_len), jnp.asarray(labels), jnp.asarray(U_LEN)))(jx)
    fn = losses.get_rnnt_loss_fn("pallas")
    assert fn.__name__ == "rnnt_loss_pallas_masked_mean"
    x = tx.clone().requires_grad_(True)
    got = fn(x, torch.tensor(t_len), torch.tensor(labels), torch.tensor(U_LEN))
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)
    _close(x.grad.float().numpy(), np.asarray(ref_grad, np.float32), dtype, "d logits")
    assert float(x.grad[1].abs().max()) == 0.0


def test_loss_dispatch():
    """``get_rnnt_loss_fn`` mirrors JAX's: ``xla`` takes the plain DP, every
    other value the unfused Pallas loss; an unknown name is refused."""
    assert losses.get_rnnt_loss_fn("xla").__name__ == "rnnt_loss_masked_mean"
    for impl in ("auto", "fused-joint", "pallas"):
        assert losses.get_rnnt_loss_fn(impl).__name__ == "rnnt_loss_pallas_masked_mean"
    with pytest.raises(ValueError, match="loss_impl"):
        losses.get_rnnt_loss_fn("fused")
