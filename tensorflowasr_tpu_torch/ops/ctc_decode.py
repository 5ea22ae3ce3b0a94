"""CTC decoding (counterpart of ``tensorflowasr_tpu/ops/ctc_decode.py``).

Greedy: vectorised, with no loop over frames: argmax per frame, repeats
collapsed, blanks dropped, and the kept tokens left-packed into a dense
[B, T] tensor padded with blank, with their lengths.

Beam: JAX's batched prefix beam search, a Python loop over frames of
batched tensor ops on the logits' device (no TPU kernel computes it, so
it stays library ops). Every top-k is a stable descending sort, which
puts the lower index first among equal scores as ``jax.lax.top_k`` does:
dead hypotheses all sit at ``LOG_0`` and tie, and which of them survives
decides the tokens.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from tensorflowasr_tpu_torch.ops.ctc_loss import LOG_0


def ctc_greedy_decode(logits: torch.Tensor, logits_length: torch.Tensor, blank: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """logits [B, T, V] and valid frames [B] → (tokens [B, T] int64
    left-packed, padded with ``blank``; lengths [B] int64)."""
    batch, max_t, _ = logits.shape
    dev = logits.device
    ids = logits.argmax(dim=-1)  # [B, T]
    valid = torch.arange(max_t, device=dev)[None, :] < logits_length.to(dev, torch.int64)[:, None]
    prev = torch.cat([torch.full((batch, 1), blank, dtype=ids.dtype, device=dev), ids[:, :-1]], dim=1)
    keep = (ids != blank) & (ids != prev) & valid
    pos = torch.cumsum(keep.to(torch.int64), dim=1) - 1  # left-packed position of each kept token
    lengths = (pos.max(dim=1).values + 1).clamp(min=0) if max_t > 0 else torch.zeros(batch, dtype=torch.int64, device=dev)
    tokens = torch.full((batch, max_t + 1), blank, dtype=torch.int64, device=dev)  # column T takes the dropped frames
    tokens.scatter_(1, torch.where(keep, pos, max_t), torch.where(keep, ids, blank))
    return tokens[:, :max_t], lengths


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest values and their
    indices, the lower index first among equal values."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def ctc_beam_search_decode(logits: torch.Tensor, logits_length: torch.Tensor, beam_width: int = 8, blank: int = 0, prune_vocab: int = 16,
                           lm_score_fn: Optional[Callable] = None, lm_weight: float = 0.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched CTC prefix beam search (JAX ``ctc_beam_search_decode``).

    Per frame each of the W prefixes either stays (blank, or the repeat of
    its last token) or is extended by one of the frame's top
    k = min(``prune_vocab``, V − 1) non-blank tokens; the best W of the W
    stay and W·K extend candidates survive (equal prefixes are not merged,
    as in JAX). ``lm_score_fn(tokens [B, W, T], lengths [B, W], ids [B, K])
    → [B, W, K]`` times ``lm_weight`` is added to the extensions. Frames
    past ``logits_length`` keep the state. Returns the best hypothesis:
    (tokens [B, T] padded with blank, lengths [B]), int64."""
    batch, max_t, vocab = logits.shape
    dev = logits.device
    w, k = beam_width, min(prune_vocab, vocab - 1)
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    neg = torch.tensor(LOG_0, dtype=torch.float32, device=dev)
    lengths_in = logits_length.to(dev, torch.int64)
    rows, cols = torch.arange(batch, device=dev)[:, None], torch.arange(w, device=dev)[None, :]

    tokens = torch.full((batch, w, max_t), blank, dtype=torch.int64, device=dev)
    lengths = torch.zeros((batch, w), dtype=torch.int64, device=dev)
    p_blank = torch.cat([torch.zeros((batch, 1), device=dev), neg.expand(batch, w - 1)], dim=1)
    p_nonblank = neg.expand(batch, w).clone()
    last_token = torch.full((batch, w), -1, dtype=torch.int64, device=dev)

    for t in range(max_t):
        lp = log_probs[:, t, :]  # [B, V]
        active = (t < lengths_in)[:, None]  # [B, 1]
        topk_lp, topk_ids = top_k(lp.index_fill(1, torch.tensor([blank], device=dev), LOG_0), k)  # [B, K]
        p_total = torch.logaddexp(p_blank, p_nonblank)
        stay_pb = p_total + lp[:, blank][:, None]
        stay_pnb = torch.where(last_token >= 0, p_nonblank + torch.gather(lp, 1, last_token.clamp(min=0)), neg)
        same_as_last = topk_ids[:, None, :] == last_token[:, :, None]  # [B, W, K]
        ext_pnb = torch.where(same_as_last, p_blank[:, :, None], p_total[:, :, None]) + topk_lp[:, None, :]
        if lm_score_fn is not None and lm_weight != 0.0:
            ext_pnb = ext_pnb + lm_weight * lm_score_fn(tokens, lengths, topk_ids)
        cand = torch.cat([torch.logaddexp(stay_pb, stay_pnb), ext_pnb.reshape(batch, w * k)], dim=1)  # [B, W + W·K]
        top_scores, top_idx = top_k(cand, w)

        is_stay = top_idx < w
        parent = torch.where(is_stay, top_idx, (top_idx - w) // k)
        new_token = torch.gather(topk_ids, 1, torch.where(is_stay, 0, (top_idx - w) % k))
        par_tokens = torch.gather(tokens, 1, parent[:, :, None].expand(batch, w, max_t))
        par_len = torch.gather(lengths, 1, parent)
        pos = par_len.clamp(max=max_t - 1)
        new_tokens = par_tokens.clone()
        new_tokens[rows, cols, pos] = torch.where(is_stay, par_tokens[rows, cols, pos], new_token)
        new_lengths = torch.where(is_stay, par_len, (par_len + 1).clamp(max=max_t))
        new_pb = torch.where(is_stay, torch.gather(stay_pb, 1, parent), neg)
        new_pnb = torch.where(is_stay, torch.gather(stay_pnb, 1, parent), top_scores)
        new_last = torch.where(is_stay, torch.gather(last_token, 1, parent), new_token)

        tokens = torch.where(active[:, :, None], new_tokens, tokens)
        lengths = torch.where(active, new_lengths, lengths)
        p_blank = torch.where(active, new_pb, p_blank)
        p_nonblank = torch.where(active, new_pnb, p_nonblank)
        last_token = torch.where(active, new_last, last_token)

    best = torch.logaddexp(p_blank, p_nonblank).argmax(dim=1)  # [B]
    return tokens[torch.arange(batch, device=dev), best], lengths[torch.arange(batch, device=dev), best]
