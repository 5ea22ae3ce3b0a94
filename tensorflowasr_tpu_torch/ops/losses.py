"""RNN-T and CTC loss dispatch (counterpart of ``tensorflowasr_tpu/ops/losses.py``).

``loss_impl`` takes the values of the JAX package's ``TFASR_LOSS_IMPL``, as
an argument instead of an environment variable. For a loss over
materialised logits (the evaluation step, and the training steps that do
not take the fused joint+loss):

- ``"xla"``: the plain anti-diagonal DP with autograd (``ops/rnnt_loss.py:rnnt_loss``);
- ``"auto"`` (the default), ``"fused-joint"`` and ``"pallas"``: the
  unfused Pallas loss (``ops/cuda/rnnt_kernel.py:rnnt_loss_pallas``: the
  log-probability row kernel, the DP kernel, and the d_logits row kernel
  in the backward).

For a CTC model (:func:`get_ctc_loss_fn`, JAX ``get_ctc_loss_fn``):
``"auto"`` and ``"pallas"`` take the CTC kernel
(``ops/cuda/ctc_kernel.py:ctc_loss_pallas``); ``"xla"`` and
``"fused-joint"`` (a transducer-only path, which JAX maps to the scan for a
CTC model) take the plain α recursion with autograd
(``ops/ctc_loss.py:ctc_loss``).

The kernels' routes check their shapes at each call: a label length the
DP kernel refuses (U+1 above 1024, ``rnnt_kernel.supported``) or the CTC
kernel refuses (2U+1 above 1024, ``ctc_kernel.supported``) takes the plain
loss, recorded in ``ops/routes.py``.
"""

from __future__ import annotations

import functools

from tensorflowasr_tpu_torch.ops import routes
from tensorflowasr_tpu_torch.ops.ctc_loss import ctc_loss
from tensorflowasr_tpu_torch.ops.cuda import ctc_kernel, rnnt_kernel
from tensorflowasr_tpu_torch.ops.cuda.ctc_kernel import ctc_loss_pallas
from tensorflowasr_tpu_torch.ops.cuda.rnnt_kernel import rnnt_loss_pallas
from tensorflowasr_tpu_torch.ops.rnnt_loss import rnnt_loss, sanitize_lengths, valid_mean

LOSS_IMPLS = ("auto", "fused-joint", "xla", "pallas")


def masked_mean(loss_fn, group=None):
    """Batch mean over valid rows only: rows with ``logit_length <= 0`` are
    left out, and the lengths are sanitised first (:func:`sanitize_lengths`)
    so the per-row DP stays finite. Under a data-parallel ``group``, this
    rank's share of the mean over every rank's valid rows (:func:`valid_mean`)."""

    def fn(logits, logit_length, labels, label_length, blank: int = 0):
        valid, safe_t, safe_u = sanitize_lengths(logit_length.to(logits.device), label_length, logits.shape[1])
        return valid_mean(loss_fn(logits, safe_t, labels, safe_u, blank), valid, group)

    fn.__name__ = f"{getattr(loss_fn, '__name__', 'loss')}_masked_mean"
    return fn


def _check(loss_impl: str) -> None:
    if loss_impl not in LOSS_IMPLS:
        raise ValueError(f"loss_impl {loss_impl!r} is not one of {LOSS_IMPLS}")


def _routed(kernel_fn, plain_fn, name: str, ok):
    """``kernel_fn`` (whose name it keeps) where ``ok(logits, labels)``, else ``plain_fn``."""

    @functools.wraps(kernel_fn)
    def fn(logits, logit_length, labels, label_length, blank: int = 0):
        loss = kernel_fn if routes.take(name, ok(logits, labels)) else plain_fn
        return loss(logits, logit_length, labels, label_length, blank)

    return fn


# the unfused loss kernels where the DP takes U+1 = logits.shape[2], else the plain DP
rnnt_loss_routed = _routed(rnnt_loss_pallas, rnnt_loss, "rnnt_dp", lambda logits, labels: rnnt_kernel.supported(logits.shape[2]))
# the CTC kernel where it takes S = 2U+1, else the plain α recursion
ctc_loss_routed = _routed(ctc_loss_pallas, ctc_loss, "ctc_loss", lambda logits, labels: ctc_kernel.supported(2 * labels.shape[1] + 1))


def get_rnnt_loss_fn(loss_impl: str = "auto", group=None):
    """The masked-mean RNN-T loss over logits for ``loss_impl`` (``group``: :func:`masked_mean`)."""
    _check(loss_impl)
    return masked_mean(rnnt_loss if loss_impl == "xla" else rnnt_loss_routed, group)


def get_ctc_loss_fn(loss_impl: str = "auto", group=None):
    """The masked-mean CTC loss over logits [B, T, V] for ``loss_impl`` (``group``: :func:`masked_mean`)."""
    _check(loss_impl)
    return masked_mean(ctc_loss_routed if loss_impl in ("auto", "pallas") else ctc_loss, group)
