"""Label encoders for the transducer prediction network (counterpart of
``models/layers/embedding.py``): ``Embedding``, a table lookup in
``dtype``, and ``OneHotBlank``, a one-hot over the vocabulary with the
blank mapped to the zero vector; both zero the positions at or past a
row's length when lengths are given."""

from __future__ import annotations

import torch
import torch.nn as nn


class Embedding(nn.Module):
    def __init__(self, vocab_size: int, embed_dim: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.embeddings = nn.Embedding(vocab_size, embed_dim)

    def forward(self, tokens: torch.Tensor, lengths: torch.Tensor | None = None) -> torch.Tensor:
        out = self.embeddings.weight.to(self.dtype)[tokens.long()]
        if lengths is not None:
            valid = torch.arange(tokens.shape[1], device=tokens.device)[None, :] < lengths.to(tokens.device)[:, None]
            out = out * valid[..., None].to(out.dtype)
        return out


class OneHotBlank(nn.Module):
    """[B, U] tokens → [B, U, V] one-hot in ``dtype``, the blank's row all zeros; no parameters."""

    def __init__(self, vocab_size: int, blank: int = 0, dtype=torch.float32):
        super().__init__()
        self.vocab_size, self.blank, self.dtype = vocab_size, blank, dtype

    def forward(self, tokens: torch.Tensor, lengths: torch.Tensor | None = None) -> torch.Tensor:
        tokens = tokens.long()
        keep = tokens != self.blank
        if lengths is not None:
            keep = keep & (torch.arange(tokens.shape[1], device=tokens.device)[None, :] < lengths.to(tokens.device)[:, None])
        # out-of-range ids (negative, ≥ V) one-hot to zeros, as jax.nn.one_hot
        valid = keep & (tokens >= 0) & (tokens < self.vocab_size)
        out = torch.nn.functional.one_hot(torch.where(valid, tokens, 0), self.vocab_size)
        return (out * valid[..., None]).to(self.dtype)
