"""Label embedding for the transducer prediction network (counterpart of
``models/layers/embedding.py:Embedding``): a table lookup in ``dtype``.
Zeroing positions past a length (the training forward) is not ported yet."""

from __future__ import annotations

import torch
import torch.nn as nn


class Embedding(nn.Module):
    def __init__(self, vocab_size: int, embed_dim: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.embeddings = nn.Embedding(vocab_size, embed_dim)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.embeddings.weight.to(self.dtype)[tokens.long()]
