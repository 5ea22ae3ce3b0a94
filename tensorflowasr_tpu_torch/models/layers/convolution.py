"""Convolutions with the reference's padding semantics (counterpart of
``models/layers/convolution.py``).

Layouts stay the JAX package's at the module boundary — [B, T, C] for 1-D,
[B, T, F, C] for 2-D — and ``causal`` left-pads EVERY spatial axis by
``dilation·(k−1)``: for ``Conv2D`` that is time AND frequency. ``same``
follows XLA's SAME (total pad ``max((ceil(n/s)−1)·s + k_eff − n, 0)``,
the smaller half on the left). Weights are f32 (OIHW / OIW), compute in
``dtype``. The strided-GEMM lowerings of the JAX module (TPU experiments)
are not ported. ``SeparableConv1D`` is a depthwise conv without bias then a
pointwise (k = 1) conv, under the JAX child names ``depthwise`` and
``pointwise``. ``DepthwiseConv2D`` convolves each channel of [B, T, F, C]
with its own ``depth_multiplier`` filters (weight [C·m, 1, kt, kf]).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


def _pads(padding: str, sizes: Sequence[int], kernel: Sequence[int], strides: Sequence[int], dilation: Sequence[int]) -> list[tuple[int, int]]:
    out = []
    for n, k, s, d in zip(sizes, kernel, strides, dilation):
        keff = d * (k - 1) + 1
        if padding == "causal":
            out.append((keff - 1, 0))
        elif padding == "same":
            total = max((-(-n // s) - 1) * s + keff - n, 0)
            out.append((total // 2, total - total // 2))
        elif padding == "valid":
            out.append((0, 0))
        else:
            raise ValueError(f"unknown padding {padding!r}")
    return out


def _flat(pads: list[tuple[int, int]]) -> tuple[int, ...]:
    # F.pad lists the LAST axis first
    return tuple(p for pair in reversed(pads) for p in pair)


class Conv2D(nn.Module):
    """[B, T, F, Cin] → [B, T', F', Cout]."""

    def __init__(self, in_channels: int, filters: int, kernel_size=(3, 3), strides=(1, 1), padding: str = "same", dilation=(1, 1), dtype=torch.float32):
        super().__init__()
        self.kernel_size, self.strides, self.padding, self.dilation, self.dtype = tuple(kernel_size), tuple(strides), padding, tuple(dilation), dtype
        self.weight = nn.Parameter(torch.empty(filters, in_channels, *self.kernel_size))
        self.bias = nn.Parameter(torch.zeros(filters))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = x.to(dt).permute(0, 3, 1, 2)  # NCHW, H = time, W = frequency
        x = F.pad(x, _flat(_pads(self.padding, x.shape[2:], self.kernel_size, self.strides, self.dilation)))
        y = F.conv2d(x, self.weight.to(dt), self.bias.to(dt), stride=self.strides, dilation=self.dilation)
        return y.permute(0, 2, 3, 1)


class Conv1D(nn.Module):
    """[B, T, Cin] → [B, T', Cout]; ``groups`` for grouped/depthwise convs;
    ``use_bias=False`` holds no bias (DeepSpeech2's RowConv)."""

    def __init__(self, in_channels: int, filters: int, kernel_size: int, strides: int = 1, padding: str = "same", dilation: int = 1, groups: int = 1,
                 dtype=torch.float32, use_bias: bool = True):
        super().__init__()
        self.kernel_size, self.strides, self.padding, self.dilation, self.groups, self.dtype = kernel_size, strides, padding, dilation, groups, dtype
        self.weight = nn.Parameter(torch.empty(filters, in_channels // groups, kernel_size))
        self.bias = nn.Parameter(torch.zeros(filters)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = x.to(dt).transpose(1, 2)
        x = F.pad(x, _flat(_pads(self.padding, x.shape[2:], (self.kernel_size,), (self.strides,), (self.dilation,))))
        bias = None if self.bias is None else self.bias.to(dt)
        y = F.conv1d(x, self.weight.to(dt), bias, stride=self.strides, dilation=self.dilation, groups=self.groups)
        return y.transpose(1, 2)


class DepthwiseConv1D(Conv1D):
    """Depthwise [B, T, C] conv (depth multiplier 1): weight [C, 1, K]."""

    def __init__(self, channels: int, kernel_size: int, strides: int = 1, padding: str = "same", dilation: int = 1, dtype=torch.float32,
                 use_bias: bool = True):
        super().__init__(channels, channels, kernel_size, strides, padding, dilation, groups=channels, dtype=dtype, use_bias=use_bias)


class SeparableConv1D(nn.Module):
    """[B, T, Cin] → [B, T', filters]: ``depthwise`` (no bias, the stride and
    padding) then ``pointwise`` (1 × 1, with bias when ``use_bias``)."""

    def __init__(self, in_channels: int, filters: int, kernel_size: int, strides: int = 1, padding: str = "same", dilation: int = 1,
                 use_bias: bool = True, dtype=torch.float32):
        super().__init__()
        self.depthwise = DepthwiseConv1D(in_channels, kernel_size, strides, padding, dilation, dtype=dtype, use_bias=False)
        self.pointwise = Conv1D(in_channels, filters, 1, dtype=dtype, use_bias=use_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pointwise(self.depthwise(x))


class DepthwiseConv2D(nn.Module):
    """[B, T, F, C] → [B, T', F', C·depth_multiplier] (JAX ``DepthwiseConv2D``:
    ``nn.Conv`` with ``feature_group_count=C``; output channel c·m + j is
    input channel c's j-th filter)."""

    def __init__(self, channels: int, kernel_size=(3, 3), strides=(1, 1), padding: str = "same", dilation=(1, 1), depth_multiplier: int = 1,
                 use_bias: bool = True, dtype=torch.float32):
        super().__init__()
        self.kernel_size, self.strides, self.padding, self.dilation, self.dtype = tuple(kernel_size), tuple(strides), padding, tuple(dilation), dtype
        self.groups = channels
        self.weight = nn.Parameter(torch.empty(channels * depth_multiplier, 1, *self.kernel_size))
        self.bias = nn.Parameter(torch.zeros(channels * depth_multiplier)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = x.to(dt).permute(0, 3, 1, 2)
        x = F.pad(x, _flat(_pads(self.padding, x.shape[2:], self.kernel_size, self.strides, self.dilation)))
        bias = None if self.bias is None else self.bias.to(dt)
        y = F.conv2d(x, self.weight.to(dt), bias, stride=self.strides, dilation=self.dilation, groups=self.groups)
        return y.permute(0, 2, 3, 1)
