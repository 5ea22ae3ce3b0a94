"""Label embedding for the transducer prediction network (counterpart of
``models/layers/embedding.py:Embedding``): a table lookup in ``dtype``,
with positions at or past a row's length zeroed when lengths are given."""

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
