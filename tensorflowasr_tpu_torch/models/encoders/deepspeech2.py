"""DeepSpeech2 encoder (counterpart of ``tensorflowasr_tpu/models/encoders/deepspeech2.py``):
conv blocks → RNN stack (LSTM, GRU or simple RNN by ``rnn_type``;
bidirectional, or unidirectional with RowConv) → FC stack.

``ConvBlock`` is a Conv2D (on [B, T, F, C]) or Conv1D with the reference's
padding (``causal`` pads time and frequency both), BatchNorm at ε 1e-3 and
momentum 0.99, and the activation; its lengths follow
``conv_output_length``. Each RNN layer is ``models/layers/rnn.RNN``
(``rnn_impl`` as the transducer's: ``"pallas"`` runs the LSTM kernels for
each direction of an LSTM; a GRU or simple RNN runs its cell loop),
followed on a unidirectional layer by ``RowConv1D`` when
``rnn_rowconv`` > 0 (a causal depthwise conv of width 2·fw + 1 without
bias, BatchNorm and the activation) and then dropout. The FC layers are
Dense, activation and dropout; the output is zero past each length.
Streaming (unidirectional only, as in JAX): ``init_state`` holds one
carry per layer (``(c, h)``, a GRU's ``h`` or a simple RNN's ``(h,)``),
and ``forward(initial_state=...)`` returns the new carries. Parameter names follow the JAX tree (``conv_block_i``,
``rnn_i.cell`` / ``cell_bwd``, ``rowconv_i``, ``fc_i``), so ``bridge.py``
maps one onto the other.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from tensorflowasr_tpu_torch.models.layers.convolution import Conv1D, Conv2D, DepthwiseConv1D
from tensorflowasr_tpu_torch.models.layers.general import BatchNorm, Dense, get_activation, mask_sequence
from tensorflowasr_tpu_torch.models.layers.rnn import RNN
from tensorflowasr_tpu_torch.ops import dropout as dr
from tensorflowasr_tpu_torch.utils import math_util


def _first(v):
    """The time entry of a kernel or stride given as a pair, or the value itself."""
    return v[0] if isinstance(v, (list, tuple)) else v


class RowConv1D(nn.Module):
    """Causal depthwise conv of width ``2·future_width + 1`` (no bias) → BatchNorm → activation."""

    def __init__(self, channels: int, future_width: int = 2, activation: str = "relu", dtype=torch.float32):
        super().__init__()
        self.conv = DepthwiseConv1D(channels, future_width * 2 + 1, padding="causal", dtype=dtype, use_bias=False)
        self.bn = BatchNorm(channels, dtype=dtype)
        self.act = get_activation(activation)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.act(self.bn(self.conv(x), train))


class ConvBlock(nn.Module):
    """Conv2D (``conv2d``, [B, T, F, C] → [B, T', F', filters]) or Conv1D → BatchNorm → activation, with the output lengths."""

    def __init__(self, in_channels: int, conv_type: str = "conv2d", kernels=(11, 41), strides=(2, 2), filters: int = 32, padding: str = "same",
                 activation: str = "relu", dtype=torch.float32):
        super().__init__()
        if conv_type == "conv2d":
            self.conv2d = Conv2D(in_channels, filters, tuple(kernels), tuple(strides), padding, dtype=dtype)
        elif conv_type == "conv1d":
            self.conv1d = Conv1D(in_channels, filters, _first(kernels), _first(strides), padding, dtype=dtype)
        else:
            raise ValueError(f"conv_type {conv_type!r} must be conv2d or conv1d")
        self.conv_type, self.kernel, self.stride, self.padding = conv_type, _first(kernels), _first(strides), padding
        self.bn = BatchNorm(filters, dtype=dtype)
        self.act = get_activation(activation)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor, train: bool = False):
        x = self.conv2d(x) if self.conv_type == "conv2d" else self.conv1d(x)
        x = self.act(self.bn(x, train))
        return x, math_util.conv_output_length(lengths, self.kernel, padding=self.padding, stride=self.stride)


class DeepSpeech2Encoder(nn.Module):
    """``forward(features [B, T, F], lengths, initial_state=None) → (encoded
    [B, T', D], lengths', new_states)``; ``new_states`` the per-layer carries
    when ``initial_state`` is given, else None."""

    def __init__(self, in_features: int, conv_type: str = "conv2d", conv_kernels: Sequence = ((11, 41), (11, 21), (11, 21)),
                 conv_strides: Sequence = ((2, 2), (1, 2), (1, 2)), conv_filters: Sequence[int] = (32, 32, 96), conv_padding: str = "same",
                 conv_activation: str = "relu", rnn_nlayers: int = 5, rnn_type: str = "lstm", rnn_units: int = 1024, rnn_bidirectional: bool = True,
                 rnn_unroll: bool = False, rnn_rowconv: int = 0, rnn_rowconv_activation: str = "relu", rnn_dropout: float = 0.1, fc_nlayers: int = 0,
                 fc_units: int = 1024, fc_activation: str = "relu", fc_dropout: float = 0.1, dtype=torch.float32, rnn_impl: str = "auto"):
        super().__init__()
        del rnn_unroll  # a compile-time knob of the JAX scan
        self.conv_type, self.conv_kernels, self.conv_strides, self.conv_padding = conv_type, conv_kernels, conv_strides, conv_padding
        self.rnn_nlayers, self.rnn_units, self.rnn_bidirectional = rnn_nlayers, rnn_units, rnn_bidirectional
        self.rnn_rowconv, self.rnn_dropout = rnn_rowconv, float(rnn_dropout)
        self.fc_nlayers, self.fc_dropout, self.fc_act = fc_nlayers, float(fc_dropout), get_activation(fc_activation)
        channels, freq = (1, in_features) if conv_type == "conv2d" else (in_features, 1)
        for i, filters in enumerate(conv_filters):
            self.add_module(f"conv_block_{i}", ConvBlock(channels, conv_type, conv_kernels[i], conv_strides[i], filters, conv_padding, conv_activation,
                                                         dtype))
            if conv_type == "conv2d":
                freq = math_util.conv_output_length(freq, conv_kernels[i][1], padding=conv_padding, stride=conv_strides[i][1])
            channels = filters
        width = channels * freq
        for i in range(rnn_nlayers):
            self.add_module(f"rnn_{i}", RNN(width, rnn_units, rnn_type, dtype, rnn_impl, bidirectional=rnn_bidirectional))
            width = rnn_units * (2 if rnn_bidirectional else 1)
            if rnn_rowconv > 0 and not rnn_bidirectional:
                self.add_module(f"rowconv_{i}", RowConv1D(width, rnn_rowconv, rnn_rowconv_activation, dtype))
        for i in range(fc_nlayers):
            self.add_module(f"fc_{i}", Dense(width, fc_units, dtype))
            width = fc_units
        self.output_dim = width

    @property
    def time_reduction_factor(self) -> int:
        out = 1
        for s in self.conv_strides:
            out *= _first(s)
        return out

    def output_length(self, length):
        for k, s in zip(self.conv_kernels, self.conv_strides):
            length = math_util.conv_output_length(length, _first(k), padding=self.conv_padding, stride=_first(s))
        return length

    def init_state(self, batch: int, device=None) -> Optional[list]:
        """One zero carry per layer in the cell's structure (JAX ``init_state``); None when bidirectional."""
        if self.rnn_bidirectional:
            return None
        return [getattr(self, f"rnn_{i}").init_state(batch, device) for i in range(self.rnn_nlayers)]

    def forward(self, features: torch.Tensor, features_length: torch.Tensor, initial_state: Optional[list] = None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """``train``: BatchNorm on batch statistics; dropout needs a ``generator`` too (without one it is off)."""
        x, lengths = features, features_length
        if self.conv_type == "conv2d" and x.dim() == 3:
            x = x[..., None]
        if self.conv_type == "conv1d" and x.dim() == 4:
            x = math_util.merge_two_last_dims(x)
        for i in range(len(self.conv_kernels)):
            x, lengths = getattr(self, f"conv_block_{i}")(x, lengths, train)
        if x.dim() == 4:
            x = math_util.merge_two_last_dims(x)
        new_states = [] if initial_state is not None else None
        for i in range(self.rnn_nlayers):
            x, state = getattr(self, f"rnn_{i}")(x, lengths, None if initial_state is None else initial_state[i])
            if self.rnn_rowconv > 0 and not self.rnn_bidirectional:
                x = getattr(self, f"rowconv_{i}")(x, train)
            x = dr.dropout(x, dr.active_rate(self.rnn_dropout, train, generator), generator)
            if new_states is not None:
                new_states.append(state)
        for i in range(self.fc_nlayers):
            x = self.fc_act(getattr(self, f"fc_{i}")(x))
            x = dr.dropout(x, dr.active_rate(self.fc_dropout, train, generator), generator)
        return mask_sequence(x, lengths), lengths, new_states
