"""Time subsampling (counterpart of ``models/layers/subsampling.py``:
``TimeReduction``, ``Conv2dSubsampling``, ``Conv1dSubsampling`` and
``VggSubsampling``).

``TimeReduction``: time padded with zeros to a multiple of the factor, then
each ``factor`` adjacent frames stacked into the feature axis (frame-major:
[B, T/f, f·D]); lengths → ceil(length / f).

``Conv2dSubsampling``: each layer Conv2D → Norm → activation; lengths
follow ``conv_output_length`` on the time axis; the output merges
[B, T', F', C'] → [B, T', F'·C'] with C fastest.

``Conv1dSubsampling``: [B, T, F, C] merged to [B, T, F·C] first, then each
layer Conv1D → Norm → activation over time, lengths as above.

``VggSubsampling``: per block two ``same`` Conv2Ds with the activation,
then a max pool over (time, frequency) with XLA's SAME padding (pad with
−inf, the smaller half on the left); lengths follow the pool's
``conv_output_length``; the output merges the last two dims.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from tensorflowasr_tpu_torch.models.layers.convolution import Conv1D, Conv2D, _flat, _pads
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


class Conv1dSubsampling(nn.Module):
    def __init__(self, in_features: int, filters: Sequence[int], strides=(2, 2), kernels=(3, 3), paddings=("causal", "causal"), norms=("none", "none"),
                 activations=("relu", "relu"), in_channels: int = 1, dtype=torch.float32):
        super().__init__()
        n = len(filters)
        if not n == len(strides) == len(kernels) == len(paddings) == len(norms) == len(activations):
            raise ValueError("subsampling options must have one entry per conv")
        self.strides, self.kernels, self.paddings = list(strides), list(kernels), list(paddings)
        self.activations = [get_activation(a) for a in activations]
        cin = in_features * in_channels
        for i in range(n):
            self.add_module(f"conv_{i}", Conv1D(cin, filters[i], self.kernels[i], self.strides[i], self.paddings[i], dtype=dtype))
            self.add_module(f"norm_{i}", make_norm(norms[i], filters[i], dtype=dtype))
            cin = filters[i]
        self.num_layers = n
        self.output_dim = cin

    @property
    def time_reduction_factor(self) -> int:
        out = 1
        for s in self.strides:
            out *= s
        return out

    def output_length(self, length):
        for i in range(self.num_layers):
            length = math_util.conv_output_length(length, self.kernels[i], self.paddings[i], self.strides[i])
        return length

    def forward(self, x: torch.Tensor, lengths: torch.Tensor, train: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
        """x: [B, T, F, C] (or [B, T, F·C]) → ([B, T', filters[-1]], lengths')."""
        if x.dim() == 4:
            x = math_util.merge_two_last_dims(x)
        for i in range(self.num_layers):
            x = getattr(self, f"conv_{i}")(x)
            norm = getattr(self, f"norm_{i}")
            x = norm(x, train=train) if isinstance(norm, BatchNorm) else norm(x)
            x = self.activations[i](x)
        return x, self.output_length(lengths)


class VggSubsampling(nn.Module):
    def __init__(self, in_features: int, filters: Sequence[int] = (32, 64), kernel_size: int = 3, pool_size: int = 2, strides: int = 2,
                 padding: str = "same", activation: str = "relu", in_channels: int = 1, dtype=torch.float32):
        super().__init__()
        self.filters, self.pool_size, self.strides = tuple(filters), pool_size, strides
        self.activation = get_activation(activation)
        cin, freq = in_channels, in_features
        for blk, f in enumerate(self.filters):
            for ci in range(2):
                self.add_module(f"conv_{blk}_{ci}", Conv2D(cin, f, (kernel_size, kernel_size), padding=padding, dtype=dtype))
                cin = f
            freq = math_util.conv_output_length(freq, pool_size, "same", strides)
        self.output_dim = freq * cin

    @property
    def time_reduction_factor(self) -> int:
        return self.strides * self.strides

    def output_length(self, length):
        for _ in self.filters:
            length = math_util.conv_output_length(length, self.pool_size, "same", self.strides)
        return length

    def _pool(self, x: torch.Tensor) -> torch.Tensor:
        """flax ``max_pool`` over (time, frequency) of [B, T, F, C], SAME padding."""
        k, s = (self.pool_size,) * 2, (self.strides,) * 2
        x = x.permute(0, 3, 1, 2)
        x = F.pad(x, _flat(_pads("same", x.shape[2:], k, s, (1, 1))), value=float("-inf"))
        return F.max_pool2d(x, k, s).permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor, train: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
        """x: [B, T, F, C] → ([B, T', F'·C'], lengths'). ``train`` changes nothing (no norm)."""
        del train
        for blk in range(len(self.filters)):
            for ci in range(2):
                x = self.activation(getattr(self, f"conv_{blk}_{ci}")(x))
            x = self._pool(x)
        return math_util.merge_two_last_dims(x), self.output_length(lengths)
