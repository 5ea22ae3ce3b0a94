"""Sinusoidal positional encodings (counterpart of
``models/layers/positional.py``): absolute (``SinusoidalPositionalEncoding``,
the Transformer encoder's) and relative
(``RelativeSinusoidalPositionalEncoding``, the Conformer's).

The encoding runs over reversed positions (T+M−1 … −(T−1)), and each
batch row is rolled by its own length and masked past ``2·len+M−1``
(``len+M`` causal), so relative distance 0 lands at the same slot for
every sequence of a padded batch. ``relpe`` is therefore per batch row.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn


def compute_sinusoid_position_encoding(position: torch.Tensor, dmodel: int, interleave: bool = False, dtype=torch.float32) -> torch.Tensor:
    """positions [L] → PE [L, dmodel] (computed in f32)."""
    position = position.float()
    dev = position.device
    if interleave:
        timescales = torch.pow(torch.tensor(1e-4, device=dev), (2.0 * (torch.arange(dmodel, device=dev) // 2)) / dmodel)
        angles = position[:, None] * timescales[None, :]
        cos_mask = (torch.arange(dmodel, device=dev) % 2).float()
        pe = torch.sin(angles) * (1.0 - cos_mask) + torch.cos(angles) * cos_mask
    else:
        timescales = torch.pow(torch.tensor(1e-4, device=dev), torch.arange(0, dmodel, 2, device=dev).float() / dmodel)
        angles = position[:, None] * timescales[None, :]
        pe = torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)
    return pe.to(dtype)


class SinusoidalPositionalEncoding(nn.Module):
    """forward(outputs [B, T, D], lengths [B]) → (outputs·scale + pe, pe):
    the absolute PE in the outputs' dtype, zero past each row's length."""

    def __init__(self, scale: Optional[float] = None, interleave: bool = False):
        super().__init__()
        self.scale, self.interleave = scale, interleave

    def forward(self, outputs: torch.Tensor, outputs_length: torch.Tensor):
        if self.scale is not None:
            outputs = outputs * torch.tensor(self.scale, dtype=outputs.dtype)
        _, length, dmodel = outputs.shape
        dev = outputs.device
        pe = compute_sinusoid_position_encoding(torch.arange(length, device=dev), dmodel, self.interleave, outputs.dtype)
        valid = (torch.arange(length, device=dev)[None, :] < outputs_length.to(dev, torch.int64)[:, None]).to(pe.dtype)
        pe = pe[None] * valid[:, :, None]
        return outputs + pe, pe


class RelativeSinusoidalPositionalEncoding(nn.Module):
    """forward(outputs [B, T, D], lengths [B]) → (outputs, relpe [B, R, D]),
    R = 2T+M−1 (or T+M causal)."""

    def __init__(self, interleave: bool = False, memory_length: Optional[int] = None, causal: bool = False, dtype=torch.float32):
        super().__init__()
        self.interleave, self.memory_length, self.causal, self.dtype = interleave, memory_length, causal, dtype

    def forward(self, outputs: torch.Tensor, outputs_length: torch.Tensor):
        _, length, dmodel = outputs.shape
        m = self.memory_length or 0
        dev = outputs.device
        position = torch.arange(length + m - 1, -length, -1, device=dev)
        pe = compute_sinusoid_position_encoding(position, dmodel, self.interleave, outputs.dtype)  # [2T+M-1, D]
        out_len = (length + m) if self.causal else (2 * length + m - 1)
        lengths = outputs_length.to(dev, torch.int64)
        # rolled[j] = pe[(j + T − len) mod L]: jnp.roll(pe, −(T − len))
        idx = (torch.arange(out_len, device=dev)[None, :] + (length - lengths)[:, None]) % pe.shape[0]
        valid_n = (lengths + m) if self.causal else (2 * lengths + m - 1)
        mask = torch.arange(out_len, device=dev)[None, :] < valid_n[:, None]
        relpe = pe[idx] * mask[..., None].to(pe.dtype)
        return outputs, relpe
