"""ContextNet encoder (counterpart of ``tensorflowasr_tpu/models/encoders/contextnet.py``):
blocks C0…C(N−1) of separable convs with BatchNorm and an activation, a
squeeze-and-excite, and a conv residual.

- ``ConvModule``: ``SeparableConv1D`` (depthwise without bias, then
  pointwise) → BatchNorm (ε 1e-3, momentum 0.99) → activation; lengths
  follow ``conv_output_length(…, padding, stride)``.
- ``SEModule``: a stride-1 ``ConvModule``, then the mean over each row's
  valid frames (a sum over them divided by max(count, 1)) → ``fc1``
  (filters // 8) → activation → ``fc2`` → sigmoid, scaling every frame.
- ``ConvBlock``: ``nlayers`` ConvModules (the last one strided), the SE,
  and with ``residual`` a linear ``ConvModule`` of the block's input (its
  own lengths, the same stride) added; then the activation. α scales every
  filter count (``int(filters · α)``); the SE's ``fc1`` is a width // 8 of
  the scaled width.

As in flax, padding frames are never masked between blocks: they enter
every BatchNorm's batch statistics over all B·T frames. ContextNet does
not stream (``init_state`` is None). Parameter names follow the JAX tree
(``block_i.conv_module_j.conv.depthwise``, ``….pointwise``, ``….bn``,
``block_i.se.conv_module``, ``block_i.se.fc1``, ``block_i.residual``), so
``bridge.py`` maps one onto the other.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from tensorflowasr_tpu_torch.models.layers.convolution import SeparableConv1D
from tensorflowasr_tpu_torch.models.layers.general import BatchNorm, Dense, get_activation
from tensorflowasr_tpu_torch.utils import math_util


class ConvModule(nn.Module):
    def __init__(self, in_channels: int, kernel_size: int = 3, strides: int = 1, filters: int = 256, activation: str = "silu", padding: str = "causal",
                 dtype=torch.float32):
        super().__init__()
        self.kernel_size, self.strides, self.padding = kernel_size, strides, padding
        self.conv = SeparableConv1D(in_channels, filters, kernel_size, strides, padding, dtype=dtype)
        self.bn = BatchNorm(filters, dtype=dtype)
        self.act = get_activation(activation)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor, train: bool = False):
        lengths = math_util.conv_output_length(lengths, self.kernel_size, padding=self.padding, stride=self.strides)
        return self.act(self.bn(self.conv(x), train)), lengths


class SEModule(nn.Module):
    """Squeeze-and-excite over the valid frames of a stride-1 ``ConvModule``'s output."""

    def __init__(self, in_channels: int, kernel_size: int = 3, filters: int = 256, activation: str = "silu", padding: str = "causal",
                 dtype=torch.float32):
        super().__init__()
        self.conv_module = ConvModule(in_channels, kernel_size, 1, filters, activation, padding, dtype)
        self.fc1 = Dense(filters, filters // 8, dtype)
        self.fc2 = Dense(filters // 8, filters, dtype)
        self.act = get_activation(activation)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor, train: bool = False):
        x, lengths = self.conv_module(x, lengths, train)
        mask = math_util.sequence_mask(lengths, x.shape[1]).to(x.dtype)  # [B, T]
        denom = mask.sum(dim=1, keepdim=True).clamp(min=1.0)
        se = (x * mask[..., None]).sum(dim=1) / denom  # [B, C], the mean over valid frames
        se = torch.sigmoid(self.fc2(self.act(self.fc1(se))))
        return x * se[:, None, :], lengths


class ConvBlock(nn.Module):
    def __init__(self, in_channels: int, nlayers: int = 3, kernel_size: int = 3, filters: int = 256, strides: int = 1, residual: bool = True,
                 activation: str = "silu", alpha: float = 1.0, padding: str = "causal", dtype=torch.float32):
        super().__init__()
        self.nlayers, self.strides, self.has_residual = nlayers, strides, residual
        self.dmodel = int(filters * alpha)
        channels = in_channels
        for i in range(nlayers):
            stride = strides if i == nlayers - 1 else 1
            self.add_module(f"conv_module_{i}", ConvModule(channels, kernel_size, stride, self.dmodel, activation, padding, dtype))
            channels = self.dmodel
        self.se = SEModule(self.dmodel, kernel_size, self.dmodel, activation, padding, dtype)
        if residual:
            self.residual = ConvModule(in_channels, kernel_size, strides, self.dmodel, "linear", padding, dtype)
        self.act = get_activation(activation)

    @property
    def time_reduction_factor(self) -> int:
        return self.strides

    def forward(self, x: torch.Tensor, lengths: torch.Tensor, train: bool = False):
        in_x, in_lengths = x, lengths
        for i in range(self.nlayers):
            x, lengths = getattr(self, f"conv_module_{i}")(x, lengths, train)
        x, lengths = self.se(x, lengths, train)
        if self.has_residual:
            x = x + self.residual(in_x, in_lengths, train)[0]
        return self.act(x), lengths


class ContextNetEncoder(nn.Module):
    """``forward(features [B, T, F], lengths) → (encoded [B, T', dmodel], lengths', None)``."""

    def __init__(self, in_features: int, blocks: Sequence[dict] = (), alpha: float = 1.0, dtype=torch.float32):
        super().__init__()
        self.blocks = tuple(dict(b) for b in blocks)
        channels = in_features
        for i, cfg in enumerate(self.blocks):
            block = ConvBlock(channels, cfg.get("nlayers", 3), cfg.get("kernel_size", 3), cfg.get("filters", 256), cfg.get("strides", 1),
                              cfg.get("residual", True), cfg.get("activation", "silu"), alpha, cfg.get("padding", "causal"), dtype)
            self.add_module(f"block_{i}", block)
            channels = block.dmodel
        self.dmodel = channels

    @property
    def time_reduction_factor(self) -> int:
        out = 1
        for b in self.blocks:
            out *= b.get("strides", 1)
        return out

    def output_length(self, length):
        for b in self.blocks:
            length = math_util.conv_output_length(length, b.get("kernel_size", 3), padding=b.get("padding", "causal"), stride=b.get("strides", 1))
        return length

    def init_state(self, batch: int, device=None) -> None:
        """None: ContextNet does not stream (JAX ``init_state``)."""
        return None

    def forward(self, features: torch.Tensor, features_length: torch.Tensor, initial_state=None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """``train``: BatchNorm on batch statistics (padding frames included).
        ``initial_state`` and ``generator`` are taken for the common encoder
        signature: there is no state and no dropout."""
        x = math_util.merge_two_last_dims(features) if features.dim() == 4 else features
        lengths = features_length
        for i in range(len(self.blocks)):
            x, lengths = getattr(self, f"block_{i}")(x, lengths, train)
        return x, lengths, None
