"""Transformer encoder (counterpart of ``tensorflowasr_tpu/models/encoders/transformer.py``).

subsampling → linear → dropout → the positional encoding → N ×
TransformerBlock, each block the MHSA module and a pointwise FFN (plain
Dense layers: JAX has no kernel there), with LayerNorm before
(``norm_position="pre"``) or after (``"post"``) each, and the query mask
from the lengths. ``mha_type="mha"``: the activations scaled by √dmodel plus
the absolute sinusoidal PE, vanilla MHA through kernel A
(``ops/cuda/attention_kernel.fused_attention``). ``"relmha"``: the unscaled
relative sinusoidal PE (``relmha_causal`` its causal length convention,
R = T + M), Transformer-XL attention through kernel B
(``fused_rel_attention``) with ``relmha_causal`` and, under
``use_attention_bias``, each block's own content and positional biases
(zero biases otherwise: the Transformer has no encoder-global ones). With
``memory_length`` each block's attention keeps a KV memory (``init_state``,
``forward(initial_state=...)``; the kernels then run with S = M + T keys).
Parameter names mirror the JAX tree, so ``bridge.py`` maps one onto the
other.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from tensorflowasr_tpu_torch.models.encoders.conformer import MHSAModule, build_subsampling
from tensorflowasr_tpu_torch.models.layers.attention import MemoryState
from tensorflowasr_tpu_torch.models.layers.general import Dense, LayerNorm, get_activation
from tensorflowasr_tpu_torch.models.layers.positional import RelativeSinusoidalPositionalEncoding, SinusoidalPositionalEncoding
from tensorflowasr_tpu_torch.models.layers.residual import residual
from tensorflowasr_tpu_torch.ops import dropout as dr
from tensorflowasr_tpu_torch.utils import math_util


class PointwiseFFN(nn.Module):
    """Dense(dff) → activation → Dense(dmodel) → dropout, LayerNorm pre or post, residual."""

    def __init__(self, dmodel: int, dff: int, activation: str = "relu", dropout: float = 0.1, norm_position: str = "post", residual_factor: float = 1.0,
                 dtype=torch.float32):
        super().__init__()
        if norm_position not in ("pre", "post"):
            raise ValueError(f"norm_position {norm_position!r} must be pre or post")
        self.act, self.dropout, self.norm_position, self.residual_factor = get_activation(activation), float(dropout), norm_position, residual_factor
        self.ln = LayerNorm(dmodel, dtype=dtype)
        self.ffn_1 = Dense(dmodel, dff, dtype)
        self.ffn_2 = Dense(dff, dmodel, dtype)

    def forward(self, x: torch.Tensor, train: bool = False, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        out = self.ln(x) if self.norm_position == "pre" else x
        out = self.ffn_2(self.act(self.ffn_1(out)))
        out = dr.dropout(out, dr.active_rate(self.dropout, train, generator), generator)
        if self.norm_position == "post":
            out = self.ln(out)
        return residual(x, out, self.residual_factor)


class TransformerBlock(nn.Module):
    def __init__(self, dmodel: int, dff: int, num_heads: int, head_size: int, norm_position: str = "post", residual_factor: float = 1.0,
                 pwffn_activation: str = "relu", dropout: float = 0.1, chunk_size: Optional[int] = None, history_size: Optional[int] = None,
                 dtype=torch.float32, memory_length: Optional[int] = None, mha_type: str = "mha", relmha_causal: bool = False,
                 use_attention_bias: bool = False):
        super().__init__()
        self.mhsa_module = MHSAModule(dmodel, head_size, num_heads, residual_factor, relmha_causal, chunk_size, history_size, dropout, dtype,
                                      mha_type, norm_position, use_attention_bias, memory_length)
        self.pwffn = PointwiseFFN(dmodel, dff, pwffn_activation, dropout, norm_position, residual_factor, dtype)

    def forward(self, x, relpe=None, mask=None, memory_state=None, use_causal_mask: bool = False, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """Returns ``(out, new_memory)``; ``relpe`` [B, R, D] under ``relmha``."""
        x, new_memory = self.mhsa_module(x, relpe, mask=mask, memory_state=memory_state, use_causal_mask=use_causal_mask, train=train,
                                         generator=generator)
        return self.pwffn(x, train, generator), new_memory


class TransformerEncoder(nn.Module):
    """``forward(features [B, T, F], lengths, initial_state=None) → (encoded
    [B, T', D], lengths', new_states)`` (``new_states`` as the Conformer's)."""

    def __init__(self, subsampling: dict, in_features: int, num_blocks: int = 6, dmodel: int = 512, dff: int = 1024, num_heads: int = 4,
                 head_size: int = 128, dropout: float = 0.1, mha_type: str = "mha", relmha_causal: bool = False, norm_position: str = "post",
                 residual_factor: float = 1.0, interleave_relpe: bool = True, use_attention_causal_mask: bool = False,
                 use_attention_auto_mask: bool = True, use_attention_bias: bool = False, pwffn_activation: str = "relu",
                 memory_length: Optional[int] = None, history_size: Optional[int] = None, chunk_size: Optional[int] = None, dtype=torch.float32):
        super().__init__()
        if mha_type not in ("mha", "relmha"):
            raise ValueError(f"mha_type {mha_type!r} must be mha or relmha")
        self.num_blocks, self.dropout, self.dmodel, self.memory_length = num_blocks, float(dropout), dmodel, memory_length
        self.use_attention_causal_mask, self.use_attention_auto_mask = use_attention_causal_mask, use_attention_auto_mask
        self.subsampling = build_subsampling(subsampling, in_features, dtype)
        self.linear = Dense(self.subsampling.output_dim, dmodel, dtype)
        if mha_type == "relmha":
            self.pe = RelativeSinusoidalPositionalEncoding(interleave=interleave_relpe, memory_length=memory_length, causal=relmha_causal, dtype=dtype)
        else:
            self.pe = SinusoidalPositionalEncoding(scale=float(dmodel) ** 0.5, interleave=interleave_relpe)
        for i in range(num_blocks):
            self.add_module(f"block_{i}", TransformerBlock(dmodel, dff, num_heads, head_size, norm_position, residual_factor, pwffn_activation,
                                                           dropout, chunk_size, history_size, dtype, memory_length, mha_type, relmha_causal,
                                                           use_attention_bias))

    @property
    def time_reduction_factor(self) -> int:
        return self.subsampling.time_reduction_factor

    def init_state(self, batch: int, device=None) -> Optional[list]:
        """One zero KV memory per block (JAX ``init_state``); None without ``memory_length``."""
        if self.memory_length is None:
            return None
        return [MemoryState.init(batch, self.memory_length, self.dmodel, device=device) for _ in range(self.num_blocks)]

    def forward(self, features: torch.Tensor, features_length: torch.Tensor, initial_state: Optional[list] = None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """``train``: the training branch; dropout needs a ``generator`` too (without one it is off)."""
        if features.dim() == 3:
            features = features[..., None]
        x, lengths = self.subsampling(features, features_length, train=train)
        x = self.linear(x)
        x = dr.dropout(x, dr.active_rate(self.dropout, train, generator), generator)
        x, relpe = self.pe(x, lengths)
        mask = math_util.sequence_mask(lengths, x.shape[1]) if self.use_attention_auto_mask else None
        new_states = []
        for i in range(self.num_blocks):
            mem = None if initial_state is None else initial_state[i]
            x, new_mem = getattr(self, f"block_{i}")(x, relpe, mask, mem, self.use_attention_causal_mask, train, generator)
            if new_mem is not None:
                new_states.append(new_mem)
        return x, lengths, (new_states or None)
