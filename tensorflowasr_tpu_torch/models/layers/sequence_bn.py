"""Sequence-wise batch normalisation (Laurent et al. 2016; counterpart of
``models/layers/sequence_bn.py``): statistics over batch and time jointly,
computed on every call (no running averages). With ``lengths`` the
moments cover the valid frames only (the divisor at least 1). Parameters
``gamma`` (ones) and ``beta`` (zeros), as the JAX module names them. No
model calls this layer.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn


class SequenceBatchNorm(nn.Module):
    def __init__(self, features: int, time_major: bool = False, epsilon: float = 1e-3, dtype=torch.float32):
        super().__init__()
        self.time_major, self.epsilon, self.dtype = time_major, epsilon, dtype
        self.beta = nn.Parameter(torch.zeros(features))
        self.gamma = nn.Parameter(torch.ones(features))

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, T, C] ([T, B, C] when ``time_major``)."""
        axes = (0, 1)
        if lengths is not None:
            t_axis = 0 if self.time_major else 1
            mask = torch.arange(x.shape[t_axis], device=x.device)[None, :] < lengths.to(x.device, torch.int64)[:, None]
            if self.time_major:
                mask = mask.t()
            m = mask[..., None].to(x.dtype)
            denom = torch.clamp(m.sum(dim=axes), min=1.0)
            mean = (x * m).sum(dim=axes) / denom
            var = (((x - mean) ** 2) * m).sum(dim=axes) / denom
        else:
            mean = x.mean(dim=axes)
            var = x.var(dim=axes, unbiased=False)
        return (x - mean) * torch.rsqrt(var + self.epsilon) * self.gamma.to(x.dtype) + self.beta.to(x.dtype)
