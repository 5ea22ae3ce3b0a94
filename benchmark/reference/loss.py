"""RNN-T loss, greedy decoding and the served-token gap, in plain PyTorch.

``rnnt_losses`` is the transducer loss of each row, −log P(labels | audio)
summed over every alignment of the (T × U+1) lattice, by the forward
recursion over anti-diagonals (differentiable by autograd).

``served_gap`` judges a served token sequence against the reference's
logits: over every alignment of the served tokens through the lattice, the
smallest possible largest gap by which a decision (blank at (t, u), or the
next served token at (t, u)) lies below the reference's best logit there.
A greedy decoder that computes what the reference computes reads 0; one
that rounds differently reads the size of its near-ties; a wrong token, a
missing one or one too many reads the size of a real mistake.

``greedy_decode`` is frame-synchronous greedy decoding (as many symbols a
frame as the joint emits, at most ``2·T + 1`` a row), the decoder that the
control puts in the program's place.
"""

from __future__ import annotations

import torch

from . import model as rm


LOG0 = -1e30  # log 0 in the recursion: finite, so that no gradient of a log-add-exp of two log-zeros is 0/0


def _skew(x: torch.Tensor, fill: float) -> torch.Tensor:
    """[B, T, U1] → [B, T+U1−1, U1] with out[b, d, u] = x[b, d − u, u] (``fill`` off the lattice)."""
    b, t, u1 = x.shape
    d = torch.arange(t + u1 - 1, device=x.device)[:, None]
    u = torch.arange(u1, device=x.device)[None, :]
    tt = d - u
    ok = (tt >= 0) & (tt < t)
    g = torch.gather(x, 1, tt.clamp(0, t - 1)[None].expand(b, -1, -1))
    return torch.where(ok[None], g, torch.full((), fill, device=x.device))


def rnnt_losses(logits: torch.Tensor, labels: torch.Tensor, t_len: torch.Tensor, u_len: torch.Tensor, blank: int = 0) -> torch.Tensor:
    """Per-row loss [B] of logits [B, T, U+1, V] (any float; taken in f32),
    labels [B, U], lengths [B]."""
    b, t, u1, _ = logits.shape
    lp = torch.log_softmax(logits.float(), dim=-1)
    lp_blank = lp[..., blank]
    lab = torch.cat([labels.long(), torch.zeros(b, 1, dtype=torch.long, device=labels.device)], dim=1)[:, :u1]
    lp_emit = torch.gather(lp, 3, lab[:, None, :, None].expand(b, t, u1, 1))[..., 0]
    sb, se = _skew(lp_blank, LOG0), _skew(lp_emit, LOG0)  # [B, D, U1]
    ninf = torch.full((b, 1), LOG0, device=logits.device)
    alpha = torch.cat([torch.zeros(b, 1, device=logits.device), ninf.expand(b, u1 - 1)], dim=1)  # diagonal 0
    alphas = [alpha]
    for d in range(1, t + u1 - 1):
        from_blank = alpha + sb[:, d - 1]  # (t−1, u) → (t, u): blank at (t−1, u)
        from_emit = torch.cat([ninf, (alpha + se[:, d - 1])[:, :-1]], dim=1)  # (t, u−1) → (t, u): emit at (t, u−1)
        alpha = torch.logaddexp(from_blank, from_emit)
        alphas.append(alpha)
    alphas = torch.stack(alphas, dim=1)  # [B, D, U1]
    rows = torch.arange(b, device=logits.device)
    tl, ul = t_len.long().to(logits.device), u_len.long().to(logits.device)
    last = tl - 1 + ul
    return -(alphas[rows, last, ul] + sb[rows, last, ul])


def served_gap(logits: torch.Tensor, tokens: torch.Tensor, t_len: int, budget: int, blank: int = 0) -> float:
    """The least, over alignments of ``tokens`` [U] through logits [T, U+1, V]
    (f32, the reference's, over this row's ``t_len`` frames), of the largest
    gap of a decision along it. At u = ``budget`` (the decoder's token
    limit) blank is forced and costs nothing."""
    u = tokens.shape[0]
    lg = logits[:t_len, :u + 1].float()
    best = lg.amax(dim=-1)
    gap_b = best - lg[..., blank]  # [T, U+1]
    if u >= budget:
        gap_b[:, budget] = 0.0
    gap_e = best[:, :u] - torch.gather(lg[:, :u], 2, tokens.long().view(1, u, 1).expand(t_len, u, 1))[..., 0]  # [T, U]
    inf = float("inf")
    sb = _skew(gap_b[None], inf)[0]  # +inf off the lattice
    se = _skew(torch.cat([gap_e, torch.full((t_len, 1), inf, device=lg.device)], dim=1)[None], inf)[0]
    cost = torch.full((u + 1,), inf, device=lg.device)
    cost[0] = 0.0
    # nodes (t, u) with t in [0, T] — node (T, U) is reached by the blank at (T−1, U)
    for d in range(1, t_len + u + 1):
        from_blank = torch.maximum(cost, sb[d - 1]) if d - 1 < sb.shape[0] else torch.full_like(cost, inf)
        from_emit = torch.cat([torch.full((1,), inf, device=lg.device), torch.maximum(cost, se[d - 1])[:-1]]) if d - 1 < se.shape[0] else torch.full_like(cost, inf)
        cost = torch.minimum(from_blank, from_emit)
        if d - u == t_len:
            return float(cost[u])
    raise AssertionError("unreachable")


@torch.no_grad()
def greedy_decode(a: rm.Arch, w, enc: torch.Tensor, enc_len: torch.Tensor, q: rm.Operands = rm.F32) -> list[torch.Tensor]:
    """Frame-synchronous greedy decoding of [B, T, D] encodings: the token rows (host int64)."""
    b, t_max, _ = enc.shape
    dev = enc.device
    enc_p = rm.project_encoder(w, enc, q)
    budget = 2 * t_max + 1
    emb = w["prediction.embedding.embeddings.weight"]
    state = (torch.zeros(b, a.rnn_units, device=dev), torch.zeros(b, a.rnn_units, device=dev))

    def pred_out(tok, st):
        st = rm.lstm_cell(w, emb[tok], st, q)
        return rm.project_prediction(w, rm.layer_norm(st[1], w, "prediction.ln_0"), q), st

    prev = torch.full((b,), a.blank, dtype=torch.long, device=dev)
    pp, state = pred_out(prev, state)
    t = torch.zeros(b, dtype=torch.long, device=dev)
    n = torch.zeros(b, dtype=torch.long, device=dev)
    out = torch.zeros(b, budget, dtype=torch.long, device=dev)
    tl = enc_len.to(dev).long()
    rows = torch.arange(b, device=dev)
    while bool((t < tl).any()):
        live = t < tl
        logits = rm.joint_logits(w, enc_p[rows, t.clamp(max=t_max - 1)], pp, q)
        ids = logits.argmax(dim=-1)
        emit = live & (ids != a.blank) & (n < budget)
        out[rows[emit], n[emit]] = ids[emit]
        n = n + emit.long()
        t = torch.where(live & ~emit, t + 1, t)
        if bool(emit.any()):
            new_pp, new_state = pred_out(torch.where(emit, ids, prev), state)
            pp = torch.where(emit[:, None], new_pp, pp)
            state = tuple(torch.where(emit[:, None], ns, s) for ns, s in zip(new_state, state))
            prev = torch.where(emit, ids, prev)
    return [out[i, :int(n[i])].cpu() for i in range(b)]
