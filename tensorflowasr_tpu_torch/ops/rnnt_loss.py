"""RNN-T (transducer) loss: the anti-diagonal DP in log space (counterpart
of ``tensorflowasr_tpu/ops/rnnt_loss.py``, the JAX ``TFASR_LOSS_IMPL=xla``
loss), the length sanitation of the batch mean over valid rows
(``ops/losses.py:masked_mean``), and the plain versions of the unfused
Pallas loss's kernels: the DP over log-probabilities and the two row
passes over the logits.

:func:`rnnt_loss` is plain PyTorch with autograd: one Python step per
anti-diagonal (T+U−1 steps), each vectorised over the batch and the label
axis. Autograd through the steps gives the gradient, as XLA autodiff
through the JAX scan does. It is the ``xla`` configuration's loss.

:func:`rnnt_loss_from_logprobs_plain` is the plain version of the DP kernel
(``ops/cuda/rnnt_kernel.py``, the JAX ``rnnt_kernel.py``): α forward along
the anti-diagonals, then β backward with the occupancy gradients of the
log-probabilities, explicit, not autograd. :func:`logits_to_logprobs_plain`
and :func:`dlogits_assemble_plain` are the plain versions of the row
kernels around it (``csrc/rnnt_rows.cu``).

Conventions (reference parity): blank is 0; ``logits`` are the joint
outputs [B, T, U+1, V]; bf16 logits are cast to f32 for the DP.
"""

from __future__ import annotations

import torch

from tensorflowasr_tpu_torch.parallel.collectives import sum_no_grad

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


def _logaddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """log(eᵃ + eᵇ) as the JAX kernel forms it (finite at two LOG_0s)."""
    m = torch.maximum(a, b)
    return m + torch.log1p(torch.exp(-(a - b).abs()))


def _skew(x: torch.Tensor, num_diags: int) -> torch.Tensor:
    """[B, T, U1] → [B, D, U1] with out[b, d, u] = x[b, d − u, u] (LOG_0 off the lattice)."""
    _, t, u1 = x.shape
    tt = torch.arange(num_diags, device=x.device)[:, None] - torch.arange(u1, device=x.device)[None, :]
    g = x[:, tt.clamp(0, t - 1), torch.arange(u1, device=x.device)[None, :]]
    return torch.where((tt >= 0) & (tt < t), g, torch.full((), LOG_0, device=x.device))


def _unskew(g: torch.Tensor, t: int) -> torch.Tensor:
    """[B, D, U1] → [B, T, U1] with out[b, t, u] = g[b, t + u, u]."""
    u = torch.arange(g.shape[2], device=g.device)[None, :]
    return g[:, torch.arange(t, device=g.device)[:, None] + u, u]


def rnnt_loss_from_logprobs_plain(lp_blank: torch.Tensor, lp_emit: torch.Tensor, logit_length: torch.Tensor, label_length: torch.Tensor):
    """Loss [B] and its gradients ``gbl``, ``gem`` [B, T, U+1] with respect
    to ``lp_blank`` and ``lp_emit``, in f32 (JAX ``rnnt_kernel.py:11-20``).

    lp_blank, lp_emit: [B, T, U+1] log-probabilities of blank and of the
    next label at each lattice cell (``lp_emit[..., U]`` is LOG_0: no label
    is left to emit); lengths [B], 1 ≤ T_b ≤ T, 0 ≤ U_b ≤ U.

      α[t, u] = LSE(α[t−1, u] + lp_blank[t−1, u], α[t, u−1] + lp_emit[t, u−1]), α[0, 0] = 0
      β[t, u] = LSE(lp_blank[t, u] + β[t+1, u], lp_emit[t, u] + β[t, u+1]), β = 0 at the exit after (T_b−1, U_b)
      ll = α[T_b−1, U_b] + lp_blank[T_b−1, U_b]; loss = −ll
      gbl = −exp(α + lp_blank + β[t+1, u] − ll), gem = −exp(α + lp_emit + β[t, u+1] − ll)

    Each sweep is one Python step per anti-diagonal d = t + u, vectorised
    over the batch and u; cells outside t < T_b, u ≤ U_b hold 0 in the
    gradients."""
    dev = lp_blank.device
    b, t, u1 = lp_blank.shape
    d_total = t + u1  # diagonals 0..T−1+U, and the exit's row T+U
    t_len = logit_length.to(dev, torch.int64)[:, None]
    u_len = label_length.to(dev, torch.int64)[:, None]
    d_final = t_len - 1 + u_len  # [B, 1]
    u_row = torch.arange(u1, device=dev)[None, :]
    neg = torch.full((), LOG_0, device=dev)
    bl = _skew(lp_blank.float(), d_total)  # BL[d, u] = lp_blank[d−u, u]
    em2 = _skew(lp_emit.float(), d_total)  # EM2[d, u] = lp_emit[d−u, u]

    def valid(d):
        tt = d - u_row
        return (tt >= 0) & (tt < t_len) & (u_row <= u_len)

    def shift_right(row):  # row[..., u − 1], LOG_0 at u = 0
        return torch.cat([neg.expand(*row.shape[:-1], 1), row[..., :-1]], dim=-1)

    def shift_left(row):  # row[..., u + 1], LOG_0 at u = U
        return torch.cat([row[..., 1:], neg.expand(*row.shape[:-1], 1)], dim=-1)

    a = torch.where((u_row == 0) & valid(0), torch.zeros((), device=dev), neg)
    alphas = [a]
    for d in range(1, d_total):
        a = torch.where(valid(d), _logaddexp(a + bl[:, d - 1], shift_right(a) + shift_right(em2[:, d - 1])), neg)
        alphas.append(a)
    alpha = torch.stack(alphas, dim=1)  # [B, D, U1]
    rows = torch.arange(b, device=dev)
    ll = (alpha[rows, d_final[:, 0], u_len[:, 0]] + bl[rows, d_final[:, 0], u_len[:, 0]])[:, None, None]

    seed = torch.where(u_row == u_len, torch.zeros((), device=dev), neg)
    b_next = torch.where(d_final + 1 == d_total - 1, seed, neg)  # β on row D−1
    nexts = [b_next]
    for d in range(d_total - 2, -1, -1):
        row = torch.where(valid(d) & (d <= d_final), _logaddexp(bl[:, d] + b_next, em2[:, d] + shift_left(b_next)), neg)
        b_next = torch.where(d == d_final + 1, seed, row)
        nexts.append(b_next)
    beta_next = torch.stack(nexts[::-1][1:] + [neg.expand(b, u1)], dim=1)  # [B, D, U1]: β on row d + 1
    ok = torch.stack([valid(d) for d in range(d_total)], dim=1)
    zero = torch.zeros((), device=dev)
    gbl = torch.where(ok, -torch.exp(alpha + bl + beta_next - ll), zero)
    gem = torch.where(ok, -torch.exp(alpha + em2 + shift_left(beta_next) - ll), zero)
    return -ll[:, 0, 0], _unskew(gbl, t), _unskew(gem, t)


def sanitize_lengths(logit_length: torch.Tensor, label_length: torch.Tensor, max_t: int):
    """(valid, safe_t, safe_u) [B] int64 (JAX ``ops/losses.py:masked_mean``):
    rows with ``logit_length <= 0`` are invalid and get 1 frame and 0
    labels, so the per-row DP stays finite; as the reference
    (``base_loss.py:36``) does, a row whose labels outnumber its frames has
    its logit length raised to its label length, bounded by ``max_t``."""
    dev = logit_length.device
    logit_length = logit_length.to(torch.int64)
    valid = logit_length > 0
    safe_u = torch.where(valid, label_length.to(dev, torch.int64), torch.zeros((), dtype=torch.int64, device=dev))
    safe_t = torch.minimum(torch.maximum(logit_length.clamp(min=1), safe_u), torch.tensor(max_t, device=dev))
    return valid, safe_t, safe_u


def valid_mean(per: torch.Tensor, valid: torch.Tensor, group=None) -> torch.Tensor:
    """Mean of ``per`` over the valid rows (0 with none). Under a data-parallel
    ``group``: this rank's share of the mean over every rank's valid rows,
    Σ(its valid rows) / (the group's valid count), so that the ranks' shares
    add up to the global masked mean (JAX ``ops/losses.py:33-51`` under GSPMD)."""
    count = valid.float().sum()
    if group is not None:
        count = sum_no_grad(count, group)
    return torch.where(valid, per, torch.zeros((), device=per.device)).sum() / count.clamp(min=1.0)


def labels_per_cell(labels: torch.Tensor, u1: int) -> torch.Tensor:
    """[B, U] → [B, U+1] int64 with −1 at u = U (no label left to emit there)."""
    lab = labels.to(torch.int64)
    return torch.cat([lab, torch.full((lab.shape[0], 1), -1, dtype=torch.int64, device=lab.device)], dim=1)[:, :u1]


def logits_to_logprobs_plain(logits: torch.Tensor, labels: torch.Tensor):
    """(lp_blank, lp_emit, lse) [B, T, U+1] f32 of logits [B, T, U+1, V]
    (f32 or bf16, upcast) and labels [B, U] (JAX ``rnnt_kernel.py:_logits_to_logprobs``):
    lse = logsumexp over V, lp_blank = logits[..., 0] − lse, lp_emit =
    logits[..., labels[b, u]] − lse and LOG_0 at u = U. A label outside
    [0, V) selects 0, as the Pallas kernel's select-and-sum does."""
    x = logits.float()
    b, t, u1, v = x.shape
    lse = torch.logsumexp(x, dim=-1)
    lab = labels_per_cell(labels.to(x.device), u1)[:, None, :]  # [B, 1, U+1]
    sel = torch.gather(x, 3, lab.clamp(0, v - 1).expand(b, t, u1)[..., None])[..., 0]
    sel = torch.where(lab < v, sel, torch.zeros((), device=x.device))
    lpe = torch.where(lab >= 0, sel - lse, torch.full((), LOG_0, device=x.device))
    return x[..., 0] - lse, lpe, lse


def dlogits_assemble_plain(logits: torch.Tensor, lse: torch.Tensor, gbl: torch.Tensor, gem: torch.Tensor, labels: torch.Tensor,
                           g: torch.Tensor) -> torch.Tensor:
    """d loss / d logits [B, T, U+1, V] in the logits' dtype (JAX
    ``rnnt_kernel.py:_dlogits_assemble``): (1[v=0]·gbl + 1[v=lab]·gem −
    softmax·(gbl+gem))·g[b], computed in f32 from the f32 lse, gbl, gem
    [B, T, U+1] and the upstream cotangent g [B]."""
    x = logits.float()
    v_idx = torch.arange(x.shape[-1], device=x.device)
    lab = labels_per_cell(labels.to(x.device), x.shape[2])[:, None, :, None]
    gb, ge = gbl.float()[..., None], gem.float()[..., None]
    zero = torch.zeros((), device=x.device)
    d = torch.where(v_idx == 0, gb, zero) + torch.where(v_idx == lab, ge, zero) - torch.exp(x - lse[..., None]) * (gb + ge)
    return (d * g.float()[:, None, None, None]).to(logits.dtype)
