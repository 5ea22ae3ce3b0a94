"""Time subsampling (counterpart of ``models/layers/subsampling.py``:
``TimeReduction`` and ``Conv2dSubsampling``).

``TimeReduction``: time padded with zeros to a multiple of the factor, then
each ``factor`` adjacent frames stacked into the feature axis (frame-major:
[B, T/f, f·D]); lengths → ceil(length / f).

``Conv2dSubsampling``: each layer Conv2D → Norm → activation; lengths
follow ``conv_output_length`` on the time axis; the output merges
[B, T', F', C'] → [B, T', F'·C'] with C fastest.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from tensorflowasr_tpu_torch.models.layers.convolution import Conv2D
from tensorflowasr_tpu_torch.models.layers.general import BatchNorm, get_activation, make_norm
from tensorflowasr_tpu_torch.utils import math_util


def _pair(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (v, v)


class TimeReduction(nn.Module):
    """[B, T, D] → ([B, ceil(T/f), f·D], ceil(lengths/f)); no parameters."""

    def __init__(self, factor: int):
        super().__init__()
        self.factor = factor

    @property
    def time_reduction_factor(self) -> int:
        return self.factor

    def forward(self, x: torch.Tensor, lengths: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        b, t, d = x.shape
        pad = (-t) % self.factor
        if pad:
            x = F.pad(x, (0, 0, 0, pad))
        return x.reshape(b, (t + pad) // self.factor, d * self.factor), math_util.get_reduced_length(lengths, self.factor)


class Conv2dSubsampling(nn.Module):
    def __init__(self, in_features: int, filters: Sequence[int], strides=((2, 1), (2, 1)), kernels=((3, 3), (3, 3)), paddings=("causal", "causal"),
                 norms=("none", "none"), activations=("relu", "relu"), in_channels: int = 1, dtype=torch.float32):
        super().__init__()
        n = len(filters)
        if not n == len(strides) == len(kernels) == len(paddings) == len(norms) == len(activations):
            raise ValueError("subsampling options must have one entry per conv")
        self.strides = [_pair(s) for s in strides]
        self.kernels = [_pair(k) for k in kernels]
        self.paddings = list(paddings)
        self.activations = [get_activation(a) for a in activations]
        freq, cin = in_features, in_channels
        for i in range(n):
            self.add_module(f"conv_{i}", Conv2D(cin, filters[i], self.kernels[i], self.strides[i], self.paddings[i], dtype=dtype))
            self.add_module(f"norm_{i}", make_norm(norms[i], filters[i], dtype=dtype))
            freq = math_util.conv_output_length(freq, self.kernels[i][1], self.paddings[i], self.strides[i][1])
            cin = filters[i]
        self.num_layers = n
        self.output_dim = freq * cin

    @property
    def time_reduction_factor(self) -> int:
        out = 1
        for s in self.strides:
            out *= s[0]
        return out

    def output_length(self, length):
        for i in range(self.num_layers):
            length = math_util.conv_output_length(length, self.kernels[i][0], self.paddings[i], self.strides[i][0])
        return length

    def forward(self, x: torch.Tensor, lengths: torch.Tensor, train: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
        """x: [B, T, F, C] → ([B, T', F'·C'], lengths'). ``train``: BatchNorm
        takes the batch statistics and updates its running ones."""
        for i in range(self.num_layers):
            x = getattr(self, f"conv_{i}")(x)
            norm = getattr(self, f"norm_{i}")
            x = norm(x, train=train) if isinstance(norm, BatchNorm) else norm(x)
            x = self.activations[i](x)
        return math_util.merge_two_last_dims(x), self.output_length(lengths)
