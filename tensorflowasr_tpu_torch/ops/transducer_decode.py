"""Transducer greedy decoding (counterpart of ``tensorflowasr_tpu/ops/transducer_decode.py``).

Both decoders are Python loops over batched tensor ops, with the JAX
loops' exact semantics: the static token budget ``factor·T + 1``, the
iteration cap ``(factor+1)·T + 1``, and the carry-out convention
("last token not yet consumed"). Each iteration reads one flag back to the
host for the loop condition. Beam search is not ported yet.

Decoder states are tuples of tensors with a leading batch dimension
(one ``(c, h)`` pair per LSTM for the prediction network).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def _select(mask: torch.Tensor, new, old):
    """Per-row select over a (nested) tuple of [B, ...] tensors."""
    if isinstance(new, (tuple, list)):
        return type(new)(_select(mask, n, o) for n, o in zip(new, old))
    return torch.where(mask.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)


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
    step = 0
    while step < (max_token_factor + 1) * max_frames + 1 and bool(((frame_idx < nframes).any() & (token_idx < max_tokens).any()).item()):
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
    step = 0
    while step < (max_token_factor + 1) * max_frames + 1 and bool(((frame_idx < nframes).any() & (token_idx < max_tokens).any()).item()):
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
