"""RNN-T (transducer) loss: the anti-diagonal DP in log space (counterpart
of ``tensorflowasr_tpu/ops/rnnt_loss.py``, the JAX ``TFASR_LOSS_IMPL=xla``
loss), and the batch mean over valid rows (``ops/losses.py:masked_mean``).

Plain PyTorch with autograd: one Python step per anti-diagonal (T+U−1
steps), each vectorised over the batch and the label axis. Autograd through
the steps gives the gradient, as XLA autodiff through the JAX scan does.
The DP is eager and host-bound (a handful of small launches per diagonal);
its kernel (the JAX package's ``rnnt_kernel.py``) is still to be ported.

Conventions (reference parity): blank is 0; ``logits`` are the joint
outputs [B, T, U+1, V]; bf16 logits are cast to f32 for the DP.
"""

from __future__ import annotations

import torch

LOG_0 = -1e30  # practical -inf that survives bf16->f32 casts without NaN


def rnnt_loss(logits: torch.Tensor, logit_length: torch.Tensor, labels: torch.Tensor, label_length: torch.Tensor, blank: int = 0) -> torch.Tensor:
    """Negative log-likelihood per example, [B] f32.

    logits: [B, T, U+1, V]; logit_length: [B] valid encoder frames;
    labels: [B, U]; label_length: [B] valid labels.
    """
    if blank != 0:
        raise ValueError("blank is fixed to 0 (reference parity)")
    logits = logits.float()
    batch, max_t, u1, _ = logits.shape
    max_u = u1 - 1
    if labels.shape[1] != max_u:
        raise ValueError(f"labels U={labels.shape[1]} must equal logits U+1-1={max_u}")
    dev = logits.device
    logit_length = logit_length.to(dev, torch.int64)
    label_length = label_length.to(dev, torch.int64)

    log_probs = torch.log_softmax(logits, dim=-1)  # [B, T, U+1, V]
    lp_blank = log_probs[..., blank]  # [B, T, U+1]
    lp_emit = torch.gather(log_probs[:, :, :max_u, :], 3, labels.to(dev, torch.int64)[:, None, :, None].expand(batch, max_t, max_u, 1))[..., 0]
    neg = torch.full((), LOG_0, dtype=torch.float32, device=dev)
    # emit term of cell u reads emit[(t, u−1)]: shift the label axis right by one
    lp_emit_shift = torch.cat([neg.expand(batch, max_t, 1), lp_emit], dim=2)  # [B, T, U+1]

    u_idx = torch.arange(u1, device=dev)
    bt = torch.arange(batch, device=dev)[:, None]

    def gather_t(mat, t_per_u):
        """mat[:, t(u), u] for each u: [B, U+1]."""
        return mat[bt, t_per_u.clamp(0, max_t - 1)[None, :], u_idx[None, :]]

    u_ok = u_idx[None, :] <= label_length[:, None]
    emit_u_ok = (u_idx >= 1)[None, :] & ((u_idx - 1)[None, :] < label_length[:, None])
    alpha = torch.where(u_idx[None, :] == 0, torch.zeros((), device=dev), neg).expand(batch, u1)  # alpha[0, 0] = 0
    alphas = [alpha]
    # A_d[u] = alpha[t = d − u, u] = LSE(A_{d−1}[u] + blank[d−1−u, u], A_{d−1}[u−1] + emit[d−u, u−1])
    for d in range(1, max_t + max_u):
        t_blank = d - 1 - u_idx
        t_emit = d - u_idx
        blank_ok = (t_blank >= 0)[None, :] & (t_blank[None, :] < logit_length[:, None])
        blank_term = torch.where(blank_ok, alpha + gather_t(lp_blank, t_blank), neg)
        alpha_shift = torch.cat([neg.expand(batch, 1), alpha[:, :-1]], dim=1)
        t_ok = (t_emit >= 0)[None, :] & (t_emit[None, :] < logit_length[:, None])
        emit_term = torch.where(emit_u_ok & t_ok, alpha_shift + gather_t(lp_emit_shift, t_emit), neg)
        m = torch.maximum(blank_term, emit_term)
        new_alpha = m + torch.log(torch.exp(blank_term - m) + torch.exp(emit_term - m))
        alpha = torch.where(t_ok & u_ok, new_alpha, neg)
        alphas.append(alpha)
    alphas = torch.stack(alphas)  # [D, B, U+1]

    rows = torch.arange(batch, device=dev)
    final_alpha = alphas[logit_length - 1 + label_length, rows, label_length]
    final_blank = lp_blank[rows, logit_length - 1, label_length]
    return -(final_alpha + final_blank)


def masked_mean(loss_fn):
    """Batch mean over VALID rows only (JAX ``ops/losses.py:masked_mean``):
    rows with ``logit_length <= 0`` are left out of the mean, and lengths are
    sanitised first so the per-row DP stays finite. As the reference
    (``base_loss.py:36``) does, a row whose labels outnumber its frames has
    its logit length raised to its label length, bounded by the array's T."""

    def fn(logits, logit_length, labels, label_length, blank: int = 0):
        dev = logits.device
        logit_length = logit_length.to(dev, torch.int64)
        valid = logit_length > 0
        safe_t = logit_length.clamp(min=1)
        safe_u = torch.where(valid, label_length.to(dev, torch.int64), torch.zeros((), dtype=torch.int64, device=dev))
        safe_t = torch.minimum(torch.maximum(safe_t, safe_u), torch.tensor(logits.shape[1], device=dev))
        per = loss_fn(logits, safe_t, labels, safe_u, blank)
        per = torch.where(valid, per, torch.zeros((), device=dev))
        return per.sum() / valid.float().sum().clamp(min=1.0)

    fn.__name__ = f"{getattr(loss_fn, '__name__', 'loss')}_masked_mean"
    return fn


rnnt_loss_masked_mean = masked_mean(rnnt_loss)
