"""Jasper encoder (counterpart of ``tensorflowasr_tpu/models/encoders/jasper.py``):
deep 1-D conv blocks with (dense) residuals.

``JasperSubBlock`` is Conv1D → BatchNorm (ε 1e-3, momentum 0.99) → the
residuals added → ReLU → dropout; ``JasperResidual`` a pointwise Conv1D →
BatchNorm; ``JasperBlock`` ``nsubblocks`` sub-blocks, the last taking the
residuals of the block inputs (every earlier block's output in ``dense``
mode, ``nresiduals = i + 1``; the current input otherwise). The encoder is
the first block at stride 2, the blocks, and the (dilated) second and
third blocks; lengths follow ``get_reduced_length`` and the output is zero
past them. Between blocks nothing is masked: BatchNorm's training
statistics cover the padded frames, as in JAX. Parameter names follow the
JAX tree (``first_block``, ``block_i.subordinate_j``, ``block_i.residual_k``,
``second_block``, ``third_block``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from tensorflowasr_tpu_torch.models.layers.convolution import Conv1D
from tensorflowasr_tpu_torch.models.layers.general import BatchNorm, mask_sequence
from tensorflowasr_tpu_torch.ops import dropout as dr
from tensorflowasr_tpu_torch.utils import math_util


class JasperSubBlock(nn.Module):
    def __init__(self, in_channels: int, channels: int = 256, kernels: int = 11, strides: int = 1, dropout: float = 0.1, padding: str = "causal",
                 dilation: int = 1, dtype=torch.float32):
        super().__init__()
        self.dropout = float(dropout)
        self.conv1d = Conv1D(in_channels, channels, kernels, strides, padding, dilation, dtype=dtype)
        self.bn = BatchNorm(channels, dtype=dtype)

    def forward(self, x: torch.Tensor, residuals: Sequence[torch.Tensor] = (), train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.bn(self.conv1d(x), train)
        for r in residuals:  # already projected and normalised; they join before the activation
            x = x + r
        return dr.dropout(F.relu(x), dr.active_rate(self.dropout, train, generator), generator)


class JasperResidual(nn.Module):
    def __init__(self, in_channels: int, channels: int = 256, padding: str = "causal", dtype=torch.float32):
        super().__init__()
        self.pointwise_conv1d = Conv1D(in_channels, channels, 1, padding=padding, dtype=dtype)
        self.bn = BatchNorm(channels, dtype=dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.bn(self.pointwise_conv1d(x), train)


class JasperBlock(nn.Module):
    """``input_channels``: the channels of the block inputs the residuals read (the first ``nresiduals``)."""

    def __init__(self, in_channels: int, input_channels: Sequence[int], nsubblocks: int = 3, channels: int = 256, kernels: int = 11,
                 dropout: float = 0.1, padding: str = "causal", dense: bool = False, nresiduals: int = 1, dtype=torch.float32):
        super().__init__()
        self.nsubblocks, self.nresiduals, self.dense = nsubblocks, nresiduals, dense
        for i in range(nsubblocks):
            self.add_module(f"subordinate_{i}", JasperSubBlock(in_channels if i == 0 else channels, channels, kernels, dropout=dropout, padding=padding,
                                                               dtype=dtype))
        for i in range(nresiduals):
            self.add_module(f"residual_{i}", JasperResidual(input_channels[i], channels, padding, dtype))

    def forward(self, x: torch.Tensor, block_inputs: list, train: bool = False, generator: Optional[torch.Generator] = None):
        """(output, the next block's inputs: every output so far in ``dense`` mode, else this one)."""
        for i in range(self.nsubblocks - 1):
            x = getattr(self, f"subordinate_{i}")(x, train=train, generator=generator)
        residuals = [getattr(self, f"residual_{i}")(block_inputs[i], train) for i in range(self.nresiduals)]
        x = getattr(self, f"subordinate_{self.nsubblocks - 1}")(x, residuals, train, generator)
        return x, (list(block_inputs) + [x] if self.dense else [x])


class JasperEncoder(nn.Module):
    """``forward(features [B, T, F], lengths) → (encoded [B, T', D], lengths', None)``."""

    def __init__(self, in_features: int, dense: bool = False, padding: str = "causal", first_additional_block_channels: int = 256,
                 first_additional_block_kernels: int = 11, first_additional_block_strides: int = 2, first_additional_block_dilation: int = 1,
                 first_additional_block_dropout: float = 0.2, nsubblocks: int = 5, block_channels: Sequence[int] = (256, 384, 512, 640, 768),
                 block_kernels: Sequence[int] = (11, 13, 17, 21, 25), block_dropout: Sequence[float] = (0.2, 0.2, 0.2, 0.3, 0.3),
                 second_additional_block_channels: int = 896, second_additional_block_kernels: int = 1, second_additional_block_strides: int = 1,
                 second_additional_block_dilation: int = 2, second_additional_block_dropout: float = 0.4, third_additional_block_channels: int = 1024,
                 third_additional_block_kernels: int = 1, third_additional_block_strides: int = 1, third_additional_block_dilation: int = 1,
                 third_additional_block_dropout: float = 0.4, dtype=torch.float32):
        super().__init__()
        self.num_blocks = len(block_channels)
        self.reduction = first_additional_block_strides * second_additional_block_strides * third_additional_block_strides
        self.first_block = JasperSubBlock(in_features, first_additional_block_channels, first_additional_block_kernels, first_additional_block_strides,
                                          first_additional_block_dropout, padding, first_additional_block_dilation, dtype)
        inputs, width = [first_additional_block_channels], first_additional_block_channels
        for i, channels in enumerate(block_channels):
            nres = i + 1 if dense else 1
            self.add_module(f"block_{i}", JasperBlock(width, inputs, nsubblocks, channels, block_kernels[i], block_dropout[i], padding, dense, nres, dtype))
            inputs, width = (inputs + [channels] if dense else [channels]), channels
        self.second_block = JasperSubBlock(width, second_additional_block_channels, second_additional_block_kernels, second_additional_block_strides,
                                           second_additional_block_dropout, padding, second_additional_block_dilation, dtype)
        self.third_block = JasperSubBlock(second_additional_block_channels, third_additional_block_channels, third_additional_block_kernels,
                                          third_additional_block_strides, third_additional_block_dropout, padding, third_additional_block_dilation,
                                          dtype)
        self.output_dim = third_additional_block_channels

    @property
    def time_reduction_factor(self) -> int:
        return self.reduction

    def output_length(self, length):
        return math_util.get_reduced_length(length, self.reduction)

    def init_state(self, batch: int, device=None) -> None:
        return None

    def forward(self, features: torch.Tensor, features_length: torch.Tensor, initial_state=None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """``train``: BatchNorm on batch statistics; dropout needs a ``generator`` too (without one it is off)."""
        if features.dim() == 4:
            features = math_util.merge_two_last_dims(features)
        x = self.first_block(features, train=train, generator=generator)
        block_inputs = [x]
        for i in range(self.num_blocks):
            x, block_inputs = getattr(self, f"block_{i}")(x, block_inputs, train, generator)
        x = self.second_block(x, train=train, generator=generator)
        x = self.third_block(x, train=train, generator=generator)
        lengths = math_util.get_reduced_length(features_length, self.reduction)
        return mask_sequence(x, lengths), lengths, None
