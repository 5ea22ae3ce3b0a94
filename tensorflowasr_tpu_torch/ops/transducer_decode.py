"""Transducer greedy and beam decoding (counterpart of ``tensorflowasr_tpu/ops/transducer_decode.py``).

The decoders are Python loops over batched tensor ops, with the JAX
loops' exact semantics: the static token budget ``factor·T + 1``, the
iteration cap ``(factor+1)·T + 1``, and the carry-out convention
("last token not yet consumed"). Each greedy iteration reads one flag back
to the host for the loop condition, except under ``torch.export``, which
cannot trace that read: there the loop runs to the iteration cap (an
iteration after every row finished changes nothing); the beam runs a fixed number of rounds
(``max_symbols_per_frame`` a frame) and reads nothing back. The beam's
top-k is the stable sort of ``ops/ctc_decode.top_k`` (the lower index first
among equal scores, as ``jax.lax.top_k``).

Decoder states are (nested) tuples of tensors with a leading batch
dimension: one carry per RNN of the prediction network, ``(c, h)`` for an
LSTM, a bare ``h`` for a GRU and ``(h,)`` for a simple RNN.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from tensorflowasr_tpu_torch.ops.ctc_decode import top_k


def _map(fn, *trees):
    """``fn`` over the tensors of (nested) tuples of equal structure."""
    if isinstance(trees[0], (tuple, list)):
        return type(trees[0])(_map(fn, *leaves) for leaves in zip(*trees))
    return fn(*trees)


def _select(mask: torch.Tensor, new, old):
    """Per-row select over a (nested) tuple of [B, ...] tensors."""
    return _map(lambda n, o: torch.where(mask.reshape((-1,) + (1,) * (n.dim() - 1)), n, o), new, old)


def transducer_greedy_decode(
    encoded: torch.Tensor,
    encoded_length: torch.Tensor,
    step_fn: Callable,
    initial_tokens: torch.Tensor,
    initial_states,
    blank: int = 0,
    max_token_factor: int = 2,
    max_symbols_per_frame: Optional[int] = None,
):
    """Frame-synchronous greedy decode.

    step_fn(enc_frame [B, E], prev_tokens [B], states) → (logits [B, V], states).
    Returns (tokens [B, factor·T+1], lengths [B], next_tokens [B], next_states).
    """
    batch, max_frames, _ = encoded.shape
    dev = encoded.device
    max_tokens = max_token_factor * max_frames + 1
    nframes = encoded_length.to(dev, torch.int64)
    rows = torch.arange(batch, device=dev)

    frame_idx = torch.zeros(batch, dtype=torch.int64, device=dev)
    prev_tokens = initial_tokens.to(dev, torch.int64)
    states = initial_states
    tokens = torch.full((batch, max_tokens + 1), blank, dtype=torch.int64, device=dev)  # last column: write sink
    token_idx = torch.zeros(batch, dtype=torch.int64, device=dev)
    frame_symbols = torch.zeros(batch, dtype=torch.int64, device=dev)
    step, exporting = 0, torch.compiler.is_exporting()
    while step < (max_token_factor + 1) * max_frames + 1 and (exporting or bool(((frame_idx < nframes).any() & (token_idx < max_tokens).any()).item())):
        enc_frame = encoded[rows, frame_idx.clamp(max=max_frames - 1)]
        logits, new_states = step_fn(enc_frame, prev_tokens, states)
        current = logits.argmax(dim=-1)
        is_blank = (current == blank) | (frame_idx >= nframes) | (token_idx >= max_tokens)
        if max_symbols_per_frame is not None:
            is_blank = is_blank | (frame_symbols >= max_symbols_per_frame)
        write_pos = torch.where(is_blank, max_tokens, token_idx.clamp(max=max_tokens - 1))
        tokens[rows, write_pos] = torch.where(is_blank, blank, current)
        token_idx = torch.where(is_blank, token_idx, (token_idx + 1).clamp(max=max_tokens))
        frame_idx = torch.where(is_blank, frame_idx + 1, frame_idx)
        frame_symbols = torch.where(is_blank, 0, frame_symbols + 1)
        prev_tokens = torch.where(is_blank, prev_tokens, current)
        states = _select(~is_blank, new_states, states)
        step += 1
    return tokens[:, :max_tokens], token_idx, prev_tokens, states


def transducer_beam_search_decode(
    encoded: torch.Tensor,
    encoded_length: torch.Tensor,
    step_fn: Callable,
    initial_tokens: torch.Tensor,
    initial_states,
    beam_width: int = 4,
    blank: int = 0,
    max_symbols_per_frame: int = 3,
):
    """Time-synchronous beam search with fixed expansions (JAX
    ``transducer_beam_search_decode``).

    Per frame, ``max_symbols_per_frame`` rounds: each round runs
    ``step_fn`` on the B·W hypotheses flattened into rows; each still open
    hypothesis offers two candidates, closing the frame (score + log
    p(blank)) or emitting its best non-blank token (score + log p(token)),
    and the best W of the 2W candidates survive; a hypothesis that closed
    stops expanding this frame. Frames past ``encoded_length`` change
    nothing. Returns (best tokens [B, 2T+1], lengths [B], next_tokens [B],
    next_states): the winner's last token and prediction-net states, so
    that chunked streaming continues from it."""
    batch, max_frames, enc_dim = encoded.shape
    dev = encoded.device
    w = beam_width
    max_tokens = 2 * max_frames + 1
    nframes = encoded_length.to(dev, torch.int64)
    rows, cols = torch.arange(batch, device=dev)[:, None], torch.arange(w, device=dev)[None, :]
    neg = torch.tensor(-1e30, dtype=torch.float32, device=dev)

    tokens = torch.full((batch, w, max_tokens), blank, dtype=torch.int64, device=dev)
    lengths = torch.zeros((batch, w), dtype=torch.int64, device=dev)
    scores = torch.cat([torch.zeros((batch, 1), device=dev), neg.expand(batch, w - 1)], dim=1)
    prev_tokens = initial_tokens.to(dev, torch.int64).reshape(batch, 1).expand(batch, w)
    states = _map(lambda x: x[:, None].expand((batch, w) + x.shape[1:]), initial_states)

    def by_parent(x: torch.Tensor, parent: torch.Tensor) -> torch.Tensor:
        return torch.gather(x, 1, parent.reshape((batch, w) + (1,) * (x.dim() - 2)).expand_as(x))

    def keep(mask: torch.Tensor, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
        return torch.where(mask.reshape(mask.shape + (1,) * (new.dim() - mask.dim())), new, old)

    for t in range(max_frames):
        active = (t < nframes)[:, None]  # [B, 1]
        enc_frame = encoded[:, min(t, max_frames - 1)][:, None].expand(batch, w, enc_dim).reshape(batch * w, enc_dim)
        open_mask = active.expand(batch, w)
        for _ in range(max_symbols_per_frame):
            logits, new_states = step_fn(enc_frame, prev_tokens.reshape(batch * w), _map(lambda x: x.reshape((batch * w,) + x.shape[2:]), states))
            lp = torch.log_softmax(logits.float(), dim=-1).reshape(batch, w, -1)
            new_states = _map(lambda x: x.reshape((batch, w) + x.shape[1:]), new_states)
            lp_blank = lp[..., blank]
            lp_tok = lp.index_fill(2, torch.tensor([blank], device=dev), -1e30)
            best_tok = lp_tok.argmax(dim=-1)  # the lower index among equal values
            best_lp = torch.gather(lp_tok, 2, best_tok[..., None])[..., 0]
            cand = torch.stack([scores + torch.where(open_mask, lp_blank, 0.0),
                                torch.where(open_mask & (lengths < max_tokens), scores + best_lp, neg)], dim=2).reshape(batch, 2 * w)
            top_scores, top_idx = top_k(cand, w)
            parent, emitted = top_idx // 2, (top_idx % 2) == 1

            par_tokens = by_parent(tokens, parent)
            par_len = by_parent(lengths, parent)
            tok = by_parent(best_tok, parent)
            pos = par_len.clamp(max=max_tokens - 1)
            new_tokens = par_tokens.clone()
            new_tokens[rows, cols, pos] = torch.where(emitted, tok, par_tokens[rows, cols, pos])
            sel_states = _map(lambda ns, os: keep(emitted, by_parent(ns, parent), by_parent(os, parent)), new_states, states)
            tokens = keep(active, new_tokens, tokens)
            lengths = keep(active, torch.where(emitted, (par_len + 1).clamp(max=max_tokens), par_len), lengths)
            scores = keep(active, top_scores, scores)
            prev_tokens = keep(active, torch.where(emitted, tok, by_parent(prev_tokens, parent)), prev_tokens)
            states = _map(lambda n, o: keep(active, n, o), sel_states, states)
            open_mask = by_parent(open_mask, parent) & emitted & active

    best = scores.argmax(dim=1)
    b = torch.arange(batch, device=dev)
    return tokens[b, best], lengths[b, best], prev_tokens[b, best], _map(lambda x: x[b, best], states)


def transducer_greedy_decode_wind(
    encoded: torch.Tensor,
    encoded_length: torch.Tensor,
    pred_step_fn: Callable,
    joint_window_fn: Callable,
    initial_tokens: torch.Tensor,
    initial_states,
    blank: int = 0,
    window: int = 16,
    max_token_factor: int = 2,
):
    """WIND greedy decode (windowed non-blank detection): exactly the
    frame-synchronous greedy result, but each iteration scores a window of
    frames under the cached prediction output and jumps to the first
    non-blank frame.

    pred_step_fn(prev_tokens [B], states) → (pred_out [B, P], states);
    joint_window_fn(enc_window [B, K, E], pred_out [B, P]) → logits [B, K, V].
    Returns (tokens [B, factor·T+1], lengths [B], next_tokens [B], lag_states).
    """
    batch, max_frames, enc_dim = encoded.shape
    dev = encoded.device
    k = min(window, max_frames)
    max_tokens = max_token_factor * max_frames + 1
    nframes = encoded_length.to(dev, torch.int64)
    rows = torch.arange(batch, device=dev)
    ar = torch.arange(k, device=dev)

    prev_tokens = initial_tokens.to(dev, torch.int64)
    pred_out, states = pred_step_fn(prev_tokens, initial_states)
    lag_states = initial_states
    frame_idx = torch.zeros(batch, dtype=torch.int64, device=dev)
    tokens = torch.full((batch, max_tokens + 1), blank, dtype=torch.int64, device=dev)  # last column: write sink
    token_idx = torch.zeros(batch, dtype=torch.int64, device=dev)
    step, exporting = 0, torch.compiler.is_exporting()
    while step < (max_token_factor + 1) * max_frames + 1 and (exporting or bool(((frame_idx < nframes).any() & (token_idx < max_tokens).any()).item())):
        start = frame_idx.clamp(max=max(max_frames - k, 0))
        offs = start[:, None] + ar[None, :]  # [B, K]
        enc_win = torch.gather(encoded, 1, offs.clamp(max=max_frames - 1)[:, :, None].expand(batch, k, enc_dim))
        ids = joint_window_fn(enc_win, pred_out).argmax(dim=-1)  # [B, K]
        frame_valid = (offs >= frame_idx[:, None]) & (offs < nframes[:, None])
        budget = token_idx < max_tokens
        nonblank = (ids != blank) & frame_valid & budget[:, None]
        any_nb = nonblank.any(dim=1)
        first = torch.where(any_nb, nonblank.to(torch.int8).argmax(dim=1), k)
        advance_to = torch.where(any_nb, start + first, torch.minimum(start + k, nframes))
        advance_to = torch.maximum(advance_to, frame_idx)
        done = frame_idx >= nframes
        emits = any_nb & ~done & budget
        tok = ids[rows, first.clamp(max=k - 1)]
        write_pos = torch.where(emits, token_idx.clamp(max=max_tokens - 1), max_tokens)
        tokens[rows, write_pos] = torch.where(emits, tok, blank)
        token_idx = torch.where(emits, (token_idx + 1).clamp(max=max_tokens), token_idx)
        prev_tokens = torch.where(emits, tok, prev_tokens)
        frame_idx = torch.where(done, frame_idx, advance_to)
        # prediction step where a token was emitted; the pre-step states
        # become that row's lagged carry-out
        new_pred, new_states = pred_step_fn(prev_tokens, states)
        pred_out = _select(emits, new_pred, pred_out)
        lag_states = _select(emits, states, lag_states)
        states = _select(emits, new_states, states)
        step += 1
    return tokens[:, :max_tokens], token_idx, prev_tokens, lag_states
