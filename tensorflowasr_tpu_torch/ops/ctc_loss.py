"""CTC loss: the log-space α recursion over time on the extended labels
(counterpart of ``tensorflowasr_tpu/ops/ctc_loss.py``, the JAX
``TFASR_LOSS_IMPL=xla`` CTC loss), and the plain version of the CTC
kernel's function (``ops/cuda/ctc_kernel.py``).

:func:`ctc_loss` is plain PyTorch with autograd: one Python step per frame,
vectorised over the batch and the 2U+1 extended states. Autograd through
the steps gives the gradient, as XLA autodiff through the JAX scan does.

:func:`ctc_occupancy_plain` is the plain version of ``csrc/ctc.cu``: α
forward and β backward over the per-state log-probabilities, the occupancy
gradient −exp(α+β−ll) and the loss −ll, explicit, not autograd, with the
length semantics of the Pallas ``_ctc_kernel``.

Conventions (reference parity, ``losses/base_loss.py:24-36``): blank is 0;
``logit_length`` is clamped to ≥ ``label_length``; bf16/f16 logits are cast
to f32; LOG_0 = −1e30 stands for −inf, so a row whose frames are too few
for its labels (an infeasible row) gives a finite loss of ~1e30, as in JAX.
"""

from __future__ import annotations

import torch

LOG_0 = -1e30  # practical -inf that survives bf16->f32 casts without NaN


def _lse3(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """log(eᵃ + eᵇ + eᶜ) as the JAX code forms it (finite at three LOG_0s)."""
    m = torch.maximum(torch.maximum(a, b), c)
    return m + torch.log(torch.exp(a - m) + torch.exp(b - m) + torch.exp(c - m))


def _shift(x: torch.Tensor, k: int) -> torch.Tensor:
    """x[..., s − k], LOG_0 where s − k falls outside the last axis (k ≠ 0)."""
    n = x.shape[-1]
    m = min(abs(k), n)
    pad = torch.full((*x.shape[:-1], m), LOG_0, dtype=x.dtype, device=x.device)
    return torch.cat([pad, x[..., :n - m]], dim=-1) if k > 0 else torch.cat([x[..., m:], pad], dim=-1)


def _extend_labels(labels: torch.Tensor) -> torch.Tensor:
    """[B, U] → [B, 2U+1] with blanks interleaved: b, y1, b, y2, ..., b."""
    b, u = labels.shape
    ext = torch.zeros((b, 2 * u + 1), dtype=torch.int64, device=labels.device)
    ext[:, 1::2] = labels.to(torch.int64)
    return ext


def ctc_loss(logits: torch.Tensor, logit_length: torch.Tensor, labels: torch.Tensor, label_length: torch.Tensor, blank: int = 0) -> torch.Tensor:
    """Negative log-likelihood per example, [B] f32.

    logits: [B, T, V] unnormalised scores; logit_length: [B] valid frames;
    labels: [B, U] (0 is blank and padding, never a label); label_length: [B].
    """
    if blank != 0:
        raise ValueError("blank is fixed to 0 (reference parity)")
    logits = logits.float()
    batch, max_t, _ = logits.shape
    dev = logits.device
    label_length = label_length.to(dev, torch.int64)
    logit_length = torch.maximum(logit_length.to(dev, torch.int64), label_length)
    neg = torch.full((), LOG_0, device=dev)

    log_probs = torch.log_softmax(logits, dim=-1)
    ext = _extend_labels(labels.to(dev))  # [B, S]
    s = ext.shape[1]
    lp_ext = torch.gather(log_probs, 2, ext[:, None, :].expand(batch, max_t, s))  # [B, T, S]
    ext_prev2 = torch.cat([torch.full((batch, 2), -1, dtype=torch.int64, device=dev), ext[:, :-2]], dim=1)
    allow_skip = (ext != blank) & (ext != ext_prev2)
    state_valid = torch.arange(s, device=dev)[None, :] < 2 * label_length[:, None] + 1

    alpha = torch.full((batch, s), LOG_0, device=dev)
    alpha[:, 0] = lp_ext[:, 0, 0]
    if s > 1:
        alpha[:, 1] = torch.where(label_length > 0, lp_ext[:, 0, 1], neg)
    alpha = torch.where(state_valid, alpha, neg)
    for t in range(1, max_t):
        a2 = torch.where(allow_skip, _shift(alpha, 2), neg)
        new = torch.where(state_valid, _lse3(alpha, _shift(alpha, 1), a2) + lp_ext[:, t, :], neg)
        # frames past logit_length leave alpha unchanged
        alpha = torch.where((t < logit_length)[:, None], new, alpha)

    u2 = 2 * label_length
    last = torch.gather(alpha, 1, u2[:, None])[:, 0]
    second = torch.where(u2 > 0, torch.gather(alpha, 1, (u2 - 1).clamp(min=0)[:, None])[:, 0], neg)
    m = torch.maximum(last, second)
    return -(m + torch.log(torch.exp(last - m) + torch.exp(second - m)))


def ctc_loss_mean(logits, logit_length, labels, label_length, blank: int = 0) -> torch.Tensor:
    """Batch-mean CTC loss."""
    return ctc_loss(logits, logit_length, labels, label_length, blank).mean()


def ctc_prep(logits: torch.Tensor, labels: torch.Tensor, blank: int = 0):
    """(lp_ext [B, T, S], skip_add [B, S], lse [B, T]) in f32 from logits
    [B, T, V] (upcast) and labels [B, U], S = 2U+1 (JAX ``ctc_kernel._prep``
    without its lane padding): lse = logsumexp over V; lp_ext holds the
    blank's log-probability at even states and the label's at odd ones (a
    gather, where JAX takes a one-hot GEMM at HIGHEST precision: both give
    the f32 logit exactly); skip_add is 0 at an odd state whose label
    differs from the one before and is not blank, LOG_0 elsewhere."""
    x = logits.float()
    b, t, _ = x.shape
    u = labels.shape[1]
    s = 2 * u + 1
    lab = labels.to(x.device, torch.int64)
    lse = torch.logsumexp(x, dim=-1)
    lp_ext = torch.empty((b, t, s), dtype=torch.float32, device=x.device)
    lp_ext[:, :, 0::2] = (x[..., blank] - lse)[..., None]
    lp_ext[:, :, 1::2] = torch.gather(x, 2, lab[:, None, :].expand(b, t, u)) - lse[..., None]
    prev = torch.cat([torch.full((b, 1), -1, dtype=torch.int64, device=x.device), lab[:, :-1]], dim=1)
    skip = torch.full((b, s), LOG_0, dtype=torch.float32, device=x.device)
    skip[:, 1::2] = torch.where((lab != prev) & (lab != blank), 0.0, LOG_0)
    return lp_ext, skip, lse


def ctc_occupancy_plain(lp_ext: torch.Tensor, skip_add: torch.Tensor, logit_length: torch.Tensor, label_length: torch.Tensor):
    """(occupancy gradient [B, T, S], loss [B]) in f32: the plain version of
    the CTC kernel (JAX ``ctc_kernel._ctc_kernel``), one Python step per
    lattice row (frame), vectorised over the batch and the states.

      α[t, s] = lp[t, s] + LSE(α[t−1, s], α[t−1, s−1], α[t−1, s−2] + skip[s])
      β[t, s] = LSE(β[t+1, s] + lp[t+1, s], β[t+1, s+1] + lp[t+1, s+1], β[t+1, s+2] + lp[t+1, s+2] + skip[s+2])
      ll = LSE(α[T_b−1, 2U_b], α[T_b−1, 2U_b−1]) (state 2U_b alone when U_b = 0)
      occ[t, s] = −exp(α[t, s] + β[t, s] − ll), loss = −ll

    Past ``t_len`` α is carried and β is LOG_0; states past 2U_b are LOG_0;
    the occupancy is 0 past ``t_len`` and past state 2U_b. ``logit_length``
    is taken as given (1 ≤ T_b ≤ T; the callers clamp it)."""
    b, t_total, s = lp_ext.shape
    dev = lp_ext.device
    lp, skip = lp_ext.float(), skip_add.float()
    t_len = logit_length.to(dev, torch.int64)[:, None]  # [B, 1]
    s_last = 2 * label_length.to(dev, torch.int64)[:, None]
    idx = torch.arange(s, device=dev)[None, :]
    neg = torch.full((), LOG_0, device=dev)
    state_ok = idx <= s_last
    fin_mask = (idx == s_last) | ((idx == s_last - 1) & (s_last > 0))

    a = torch.where(state_ok & (idx < 2), lp[:, 0], neg)
    alphas = [a]
    for t in range(1, t_total):
        new = torch.where(state_ok, _lse3(a, _shift(a, 1), _shift(a, 2) + skip) + lp[:, t], neg)
        a = torch.where(t < t_len, new, a)  # past t_len, carried
        alphas.append(a)
    alpha = torch.stack(alphas, dim=1)  # [B, T, S]
    fin = alpha[torch.arange(b, device=dev), t_len[:, 0] - 1]  # α at t_len − 1
    last = torch.gather(fin, 1, s_last)[:, 0]
    prev = torch.where(s_last[:, 0] > 0, torch.gather(fin, 1, (s_last - 1).clamp(min=0))[:, 0], neg)
    ll = _lse3(last, prev, neg.expand(b))[:, None]

    skip2 = _shift(skip, -2)  # skip allowed at the target state s+2
    last_row = torch.where(fin_mask, 0.0, neg)
    occ = torch.zeros((b, t_total, s), dtype=torch.float32, device=dev)
    b_next, lp_next = torch.full((b, s), LOG_0, device=dev), lp[:, t_total - 1]
    for t in range(t_total - 1, -1, -1):
        term0 = b_next + lp_next
        beta = _lse3(term0, _shift(term0, -1), _shift(term0, -2) + skip2)
        beta = torch.where(t == t_len - 1, last_row, beta)
        beta = torch.where(t > t_len - 1, neg, beta)
        beta = torch.where(state_ok, beta, neg)
        occ[:, t] = torch.where(state_ok & (t < t_len), -torch.exp(alpha[:, t] + beta - ll), torch.zeros((), device=dev))
        b_next, lp_next = beta, lp[:, t]
    return occ, -ll[:, 0]
