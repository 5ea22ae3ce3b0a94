"""Transformer-XL relative multi-head attention (counterpart of
``models/layers/attention.py:MultiHeadRelativeAttention``).

Projections are the JAX ``DenseGeneral`` layers flattened to ``Dense``:
query/key/value/encoding [D → N·H], output [N·H → D]. The score, shift,
mask and softmax chain runs in the fused kernel
(``ops/cuda/attention_kernel.fused_rel_attention``; plain version on the
CPU). The XLA-semantics helpers ``rel_left_shift``, the mask builders and
``_merge_masks`` are kept as plain torch for the tests and for the
explicit ``attention_mask`` argument, which the kernel does not take.
Streaming (``call_next``) and KV memory states are not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from tensorflowasr_tpu_torch.models.layers.general import Dense
from tensorflowasr_tpu_torch.ops.cuda.attention_kernel import fused_rel_attention


def rel_left_shift(x: torch.Tensor, causal: bool = False) -> torch.Tensor:
    """Relative shift [B, N, T, R] (Transformer-XL trick, JAX pad/reshape form)."""
    b, n, t, r = x.shape
    if causal:
        x = F.pad(x, (1, 0)).reshape(b, n, -1)
        x = F.pad(x, (r - t, 0)).reshape(b, n, 1 + t, r)
        return x[:, :, 1:, :]
    x = F.pad(x, (0, 1)).reshape(b, n, -1)
    x = F.pad(x, (0, r - t)).reshape(b, n, 1 + t, r)
    return x[:, :, :t, t - 1:]


def compute_causal_mask(t: int, s: int, device=None) -> torch.Tensor:
    return torch.ones((t, s), dtype=torch.bool, device=device).tril(diagonal=s - t)


def compute_streaming_mask(chunk_size: int, history_size: int, t: int, s: int, device=None) -> torch.Tensor:
    hist = s if history_size < 0 else history_size
    chunk_start = (torch.arange(t, device=device) // chunk_size) * chunk_size
    cols = torch.arange(s, device=device) - (s - t)
    return (cols[None, :] >= (chunk_start - hist)[:, None]) & (cols[None, :] < (chunk_start + chunk_size)[:, None])


def _merge_masks(t: int, s: int, query_mask, kv_mask, attention_mask, use_causal_mask: bool, chunk_size, history_size, device=None) -> Optional[torch.Tensor]:
    """AND of all masks → [B|1, 1, T, S] bool, or None."""
    mask = None

    def land(a, b):
        return b if a is None else (a & b)

    if query_mask is not None:
        mask = land(mask, query_mask[:, None, :, None])
    if kv_mask is not None:
        mask = land(mask, kv_mask[:, None, None, :])
    if use_causal_mask:
        mask = land(mask, compute_causal_mask(t, s, device)[None, None])
    if chunk_size is not None and history_size is not None:
        mask = land(mask, compute_streaming_mask(chunk_size, history_size, t, s, device)[None, None])
    if attention_mask is not None:
        mask = land(mask, attention_mask if attention_mask.dim() == 4 else attention_mask[:, None])
    return mask


class MultiHeadRelativeAttention(nn.Module):
    def __init__(self, input_dim: int, num_heads: int, key_dim: int, output_dim: Optional[int] = None, causal: bool = False,
                 chunk_size: Optional[int] = None, history_size: Optional[int] = None, dtype=torch.float32):
        super().__init__()
        self.num_heads, self.key_dim, self.causal, self.dtype = num_heads, key_dim, causal, dtype
        self.chunk_size, self.history_size = chunk_size, history_size
        inner = num_heads * key_dim
        self.query = Dense(input_dim, inner, dtype)
        self.key = Dense(input_dim, inner, dtype)
        self.value = Dense(input_dim, inner, dtype)
        self.encoding = Dense(input_dim, inner, dtype)
        self.output = Dense(inner, output_dim or input_dim, dtype)

    def forward(self, query: torch.Tensor, value: torch.Tensor, *, relpe: torch.Tensor, content_attention_bias=None, positional_attention_bias=None,
                query_mask: Optional[torch.Tensor] = None, kv_mask: Optional[torch.Tensor] = None, attention_mask: Optional[torch.Tensor] = None,
                use_causal_mask: bool = False) -> torch.Tensor:
        if attention_mask is not None:
            raise NotImplementedError("an explicit attention_mask is not ported (the fused kernel rebuilds visibility from its parameters)")
        b, t = query.shape[:2]
        n, hd = self.num_heads, self.key_dim
        heads = lambda x: x.reshape(b, x.shape[1], n, hd)
        q = heads(self.query(query))
        k = heads(self.key(value))
        v = heads(self.value(value))
        pos = heads(self.encoding(relpe.to(self.dtype)))
        zeros = torch.zeros((n, hd), device=q.device)
        cbias = content_attention_bias if content_attention_bias is not None else zeros
        pbias = positional_attention_bias if positional_attention_bias is not None else zeros
        scale = torch.tensor(1.0 / math.sqrt(hd), dtype=q.dtype)
        content_q = (q + cbias.to(q.dtype)) * scale
        positional_q = (q + pbias.to(q.dtype)) * scale

        fold = lambda x: x.transpose(1, 2).reshape(b * n, x.shape[1], hd).contiguous()
        kv_bias = None
        if kv_mask is not None:
            kv_bias = ((~kv_mask).float() * -1e9)[:, None, :].contiguous()
        q_len = query_mask.sum(dim=1, dtype=torch.int32) if query_mask is not None else None
        out = fused_rel_attention(fold(content_q), fold(positional_q), fold(k), fold(v), fold(pos), kv_bias, q_len, 0, 0.0,
                                  bool(use_causal_mask), self.chunk_size, self.history_size, bool(self.causal))
        out = out.reshape(b, n, t, hd).transpose(1, 2).reshape(b, t, n * hd)
        return self.output(out)
