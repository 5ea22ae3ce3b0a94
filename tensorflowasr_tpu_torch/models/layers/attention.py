"""Multi-head attention: vanilla and Transformer-XL relative (counterpart
of ``models/layers/attention.py``: ``MultiHeadAttention`` and
``MultiHeadRelativeAttention``).

Projections are the JAX ``DenseGeneral`` layers flattened to ``Dense``:
query/key/value/encoding [D → N·H], output [N·H → D]. Vanilla attention
merges its masks into the Keras-parity additive bias (−1e9 where masked, in
q's dtype, broadcast to [B·N, T, S] as JAX's ``_fused_attend`` does) and
runs the score, softmax and P·V chain in kernel A
(``ops/cuda/attention_kernel.fused_attention``); relative attention runs
its score, shift, mask and softmax chain in kernel B
(``fused_rel_attention``). Each kernel's plain version runs on the CPU.
The XLA-semantics helpers ``rel_left_shift``, the mask builders and
``_merge_masks`` are plain torch. Kernel B rebuilds visibility from its
parameters, so relative attention with an explicit ``attention_mask``
takes JAX's fallback: the positional scores ``qp·posᵀ`` in plain torch,
``rel_left_shift`` and the last S columns, then kernel A with the bias
``positional + (1 − mask)·(−1e9)`` (its gradient flows back to ``qp`` and
``pos`` through kernel A's bias gradient).

Streaming: with ``memory_length`` M and a ``memory_state`` (``MemoryState``:
the last M raw key/value inputs and their mask), both modules prepend the
memory to the key/value inputs before projection, concatenate the memory
mask before the key mask, and return the last M positions as the new
memory (detached when training), so the kernels run with S = M + T keys;
the memory columns sit at negative frame coordinates of the causal and
chunk masks. Both forwards return ``(out, new_memory)`` as JAX's do.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from tensorflowasr_tpu_torch.models.layers.general import Dense
from tensorflowasr_tpu_torch.ops import dropout as dr
from tensorflowasr_tpu_torch.ops import routes
from tensorflowasr_tpu_torch.ops.cuda import attention_kernel
from tensorflowasr_tpu_torch.ops.cuda.attention_kernel import fused_attention, fused_attention_plain, fused_rel_attention, fused_rel_attention_plain


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


class MemoryState:
    """The KV memory of one attention layer (JAX ``MemoryState``): a dict
    ``{"k": [B, M, D], "v": [B, M, D], "mask": [B, M] bool}``."""

    @staticmethod
    def init(batch: int, memory_length: int, dmodel: int, dtype=torch.float32, device=None) -> dict:
        zeros = lambda: torch.zeros((batch, memory_length, dmodel), dtype=dtype, device=device)
        return {"k": zeros(), "v": zeros(), "mask": torch.zeros((batch, memory_length), dtype=torch.bool, device=device)}


def _apply_memory(memory_length: Optional[int], key, value, kv_mask, memory_state, train: bool):
    """Prepend the memory to the raw key/value inputs (JAX ``_apply_memory``):
    (key, value, kv_mask, new memory), the new memory the last M positions."""
    if memory_length is None or memory_state is None:
        return key, value, kv_mask, None
    mem_k, mem_v, mem_mask = memory_state["k"].to(key.dtype), memory_state["v"].to(value.dtype), memory_state["mask"].to(key.device)
    if train:
        mem_k, mem_v = mem_k.detach(), mem_v.detach()
    key, value = torch.cat([mem_k, key], dim=1), torch.cat([mem_v, value], dim=1)
    if kv_mask is None:
        kv_mask = torch.ones(key.shape[0], key.shape[1] - mem_k.shape[1], dtype=torch.bool, device=key.device)
    kv_mask = torch.cat([mem_mask, kv_mask.to(torch.bool)], dim=1)
    m = memory_length
    return key, value, kv_mask, {"k": key[:, -m:], "v": value[:, -m:], "mask": kv_mask[:, -m:]}


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


def _fused_attend(q, k, v, bias, rate: float, generator: Optional[torch.Generator]):
    """[B, T, N, H] q (scaled), [B, S, N, H] k/v and an additive bias [B|1, N|1, T, S]
    → [B, T, N, H] through kernel A (JAX ``_fused_attend``): the bias folded
    to [B·N, T, S] (or [1, T, S] when it broadcasts), one dropout seed drawn
    from ``generator`` when ``rate`` > 0. Where kernel A refuses the head
    size or key length (``attention_kernel.supported``), its plain version
    with autograd, the same arithmetic."""
    b, t, n, h = q.shape
    s = k.shape[1]
    attend = fused_attention if routes.take("fused_attention", attention_kernel.supported(h, s, q.dtype)) else fused_attention_plain
    if bias.shape[0] == 1 and bias.shape[1] == 1:
        bias = bias.reshape(1, t, s)
    else:
        bias = bias.expand(b, n, t, s).reshape(b * n, t, s)
    fold = lambda x: x.transpose(1, 2).reshape(b * n, x.shape[1], h).contiguous()
    seed = dr.draw_seed(generator) if rate > 0.0 else 0
    out = attend(fold(q), fold(k), fold(v), bias.contiguous(), seed, rate)
    return out.reshape(b, n, t, h).transpose(1, 2)


class MultiHeadAttention(nn.Module):
    """Vanilla MHA (JAX ``MultiHeadAttention``): ``forward(query, value,
    key=None, ...) → ([B, T, output_dim], new_memory)``. ``train`` with a
    ``generator``: probability dropout at the layer's rate, in-kernel, under
    one seed drawn from the generator."""

    def __init__(self, input_dim: int, num_heads: int, key_dim: int, output_dim: Optional[int] = None, dropout: float = 0.0,
                 chunk_size: Optional[int] = None, history_size: Optional[int] = None, dtype=torch.float32, memory_length: Optional[int] = None):
        super().__init__()
        self.num_heads, self.key_dim, self.dropout, self.dtype = num_heads, key_dim, float(dropout), dtype
        self.chunk_size, self.history_size, self.memory_length = chunk_size, history_size, memory_length
        inner = num_heads * key_dim
        self.query = Dense(input_dim, inner, dtype)
        self.key = Dense(input_dim, inner, dtype)
        self.value = Dense(input_dim, inner, dtype)
        self.output = Dense(inner, output_dim or input_dim, dtype)

    def _attend(self, q, k, v, mask, train: bool, generator: Optional[torch.Generator]):
        """[B, T, N, H] q, [B, S, N, H] k/v and the merged mask → [B, T, N, H]
        through kernel A, with the Keras-parity bias (JAX ``_attend`` and ``_fused_attend``)."""
        t, s = q.shape[1], k.shape[1]
        scale = torch.tensor(1.0 / math.sqrt(self.key_dim), dtype=q.dtype)
        if mask is None:
            bias = torch.zeros((1, 1, t, s), dtype=q.dtype, device=q.device)
        else:
            bias = ((1.0 - mask.float()) * -1e9).expand(*mask.shape[:2], t, s).to(q.dtype)
        return _fused_attend(q * scale, k, v, bias, dr.active_rate(self.dropout, train, generator), generator)

    def forward(self, query: torch.Tensor, value: torch.Tensor, key: Optional[torch.Tensor] = None, *, query_mask: Optional[torch.Tensor] = None,
                kv_mask: Optional[torch.Tensor] = None, attention_mask: Optional[torch.Tensor] = None, use_causal_mask: bool = False,
                memory_state: Optional[dict] = None, train: bool = False, generator: Optional[torch.Generator] = None):
        key = value if key is None else key
        key, value, kv_mask, new_memory = _apply_memory(self.memory_length, key, value, kv_mask, memory_state, train)
        b, t = query.shape[:2]
        n, h = self.num_heads, self.key_dim
        q = self.query(query).reshape(b, t, n, h)
        k = self.key(key).reshape(b, key.shape[1], n, h)
        v = self.value(value).reshape(b, value.shape[1], n, h)
        mask = _merge_masks(t, key.shape[1], query_mask, kv_mask, attention_mask, use_causal_mask, self.chunk_size, self.history_size, query.device)
        out = self._attend(q, k, v, mask, train, generator)
        return self.output(out.reshape(b, t, n * h)), new_memory

    def init_memory(self, batch: int, dmodel: int, device=None) -> Optional[dict]:
        return None if self.memory_length is None else MemoryState.init(batch, self.memory_length, dmodel, device=device)


class MultiHeadRelativeAttention(nn.Module):
    """Transformer-XL relative MHA. The content/positional biases [N, H] are
    the layer's own parameters with ``use_attention_bias`` (JAX
    ``attention.py:345-350``), else passed in (encoder-global) or zero."""

    def __init__(self, input_dim: int, num_heads: int, key_dim: int, output_dim: Optional[int] = None, causal: bool = False,
                 chunk_size: Optional[int] = None, history_size: Optional[int] = None, dropout: float = 0.0, dtype=torch.float32,
                 use_attention_bias: bool = False, memory_length: Optional[int] = None):
        super().__init__()
        self.num_heads, self.key_dim, self.causal, self.dropout, self.dtype = num_heads, key_dim, causal, float(dropout), dtype
        self.chunk_size, self.history_size, self.memory_length = chunk_size, history_size, memory_length
        inner = num_heads * key_dim
        self.query = Dense(input_dim, inner, dtype)
        self.key = Dense(input_dim, inner, dtype)
        self.value = Dense(input_dim, inner, dtype)
        self.encoding = Dense(input_dim, inner, dtype)
        self.output = Dense(inner, output_dim or input_dim, dtype)
        self.use_attention_bias = use_attention_bias
        if use_attention_bias:
            self.content_attention_bias = nn.Parameter(torch.zeros(num_heads, key_dim))
            self.positional_attention_bias = nn.Parameter(torch.zeros(num_heads, key_dim))

    def forward(self, query: torch.Tensor, value: torch.Tensor, *, relpe: torch.Tensor, content_attention_bias=None, positional_attention_bias=None,
                query_mask: Optional[torch.Tensor] = None, kv_mask: Optional[torch.Tensor] = None, attention_mask: Optional[torch.Tensor] = None,
                use_causal_mask: bool = False, memory_state: Optional[dict] = None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """Returns ``(out, new_memory)``. ``train`` with a ``generator``:
        probability dropout at the layer's rate, in-kernel, under one seed
        drawn from the generator. An ``attention_mask`` ([B, T, S] or [B, 1,
        T, S] bool) takes kernel A (see the module docstring)."""
        key, value, kv_mask, new_memory = _apply_memory(self.memory_length, value, value, kv_mask, memory_state, train)
        b, t = query.shape[:2]
        n, hd = self.num_heads, self.key_dim
        heads = lambda x: x.reshape(b, x.shape[1], n, hd)
        q = heads(self.query(query))
        k = heads(self.key(key))
        v = heads(self.value(value))
        pos = heads(self.encoding(relpe.to(self.dtype)))
        zeros = torch.zeros((n, hd), device=q.device)
        if self.use_attention_bias:
            cbias, pbias = self.content_attention_bias, self.positional_attention_bias
        else:
            cbias = content_attention_bias if content_attention_bias is not None else zeros
            pbias = positional_attention_bias if positional_attention_bias is not None else zeros
        scale = torch.tensor(1.0 / math.sqrt(hd), dtype=q.dtype)
        content_q = (q + cbias.to(q.dtype)) * scale
        positional_q = (q + pbias.to(q.dtype)) * scale

        rate = dr.active_rate(self.dropout, train, generator)
        if attention_mask is not None:
            s = k.shape[1]
            positional = rel_left_shift(torch.einsum("btnh,brnh->bntr", positional_q, pos), causal=self.causal)
            positional = positional[..., positional.shape[-1] - s:]
            mask = _merge_masks(t, s, query_mask, kv_mask, attention_mask, use_causal_mask, self.chunk_size, self.history_size, query.device)
            bias = positional if mask is None else positional + ((1.0 - mask.float()) * -1e9).to(positional.dtype)
            out = _fused_attend(content_q, k, v, bias, rate, generator).reshape(b, t, n * hd)
            return self.output(out), new_memory
        fold = lambda x: x.transpose(1, 2).reshape(b * n, x.shape[1], hd).contiguous()
        kv_bias = None
        if kv_mask is not None:
            kv_bias = ((~kv_mask).float() * -1e9)[:, None, :].contiguous()
        q_len = query_mask.sum(dim=1, dtype=torch.int32) if query_mask is not None else None
        seed = dr.draw_seed(generator) if rate > 0.0 else 0
        # kernel B where it takes the head size and key length, else its plain version with autograd
        attend = fused_rel_attention if routes.take("fused_rel_attention", attention_kernel.rel_supported(hd, k.shape[1], q.dtype)) else fused_rel_attention_plain
        out = attend(fold(content_q), fold(positional_q), fold(k), fold(v), fold(pos), kv_bias, q_len, seed, rate, bool(use_causal_mask), self.chunk_size,
                     self.history_size, bool(self.causal))
        out = out.reshape(b, n, t, hd).transpose(1, 2).reshape(b, t, n * hd)
        return self.output(out), new_memory
