"""CTC greedy decoding (counterpart of ``tensorflowasr_tpu/ops/ctc_decode.py:ctc_greedy_decode``).

Vectorised, with no loop over frames: argmax per frame, repeats
collapsed, blanks dropped, and the kept tokens left-packed into a dense
[B, T] tensor padded with blank, with their lengths. Beam search
(``ctc_beam_search_decode``) and LM fusion are not ported yet (ROADMAP
Queue 1, "Beam search and the LM").
"""

from __future__ import annotations

import torch


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
