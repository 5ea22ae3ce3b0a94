"""RNN-Transducer encoder (counterpart of ``tensorflowasr_tpu/models/encoders/rnnt.py``):
stacked blocks of RNN (LSTM by default; GRU or simple RNN by
``rnn_type``) → LayerNorm → projection, each with an optional
``TimeReduction`` before (``pre``) or after (``post``) it.

Each RNN is ``models/layers/rnn.RNN`` (``rnn_impl`` as DeepSpeech2's:
``"pallas"`` runs the LSTM kernels, the default of a model built on the
card; a GRU or simple RNN runs its cell loop), its input the previous
block's output stacked by that block's reduction: 80 → 960 → 320 → 640 in
the published small config (post reductions [3, 0, 2, 0], dmodel 320). The
output is zero past each length (``mask_sequence``). Streaming:
``init_state`` holds one carry per block in the cell's structure
(``(c, h)``, ``h`` or ``(h,)``), and ``forward(initial_state=...)``
returns the new carries; each chunk pads under its reductions as a whole
utterance does. Parameter names follow the JAX tree (``block_i.rnn.cell``,
``block_i.ln``, ``block_i.projection``), so ``bridge.py`` maps one onto the
other.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from tensorflowasr_tpu_torch.models.layers.general import Dense, LayerNorm, mask_sequence
from tensorflowasr_tpu_torch.models.layers.rnn import RNN
from tensorflowasr_tpu_torch.models.layers.subsampling import TimeReduction
from tensorflowasr_tpu_torch.utils import math_util


class RnnTransducerBlock(nn.Module):
    def __init__(self, in_features: int, reduction_position: str = "pre", reduction_factor: int = 0, dmodel: int = 640, rnn_type: str = "lstm",
                 rnn_units: int = 2048, layer_norm: bool = True, dtype=torch.float32, rnn_impl: str = "auto"):
        super().__init__()
        if reduction_position not in ("pre", "post"):
            raise ValueError(f"reduction_position {reduction_position!r} must be pre or post")
        self.reduction_position, self.reduction_factor, self.layer_norm = reduction_position, reduction_factor, layer_norm
        factor = max(reduction_factor, 1)
        self.reduction = TimeReduction(reduction_factor) if reduction_factor > 0 else None
        self.rnn = RNN(in_features * (factor if reduction_position == "pre" else 1), rnn_units, rnn_type, dtype, rnn_impl)
        if layer_norm:
            self.ln = LayerNorm(rnn_units, dtype=dtype)
        self.projection = Dense(rnn_units, dmodel, dtype)
        self.output_dim = dmodel * (factor if reduction_position == "post" else 1)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor, initial_state=None):
        if self.reduction is not None and self.reduction_position == "pre":
            x, lengths = self.reduction(x, lengths)
        x, new_state = self.rnn(x, lengths, initial_state)
        if self.layer_norm:
            x = self.ln(x)
        x = self.projection(x)
        if self.reduction is not None and self.reduction_position == "post":
            x, lengths = self.reduction(x, lengths)
        return x, lengths, new_state


class RnnTransducerEncoder(nn.Module):
    """``forward(features [B, T, F], lengths, initial_state=None) → (encoded
    [B, T', dmodel], lengths', new_states)``; ``new_states`` the per-block
    carries when ``initial_state`` is given, else None."""

    def __init__(self, in_features: int, reduction_positions: Sequence[str] = ("pre",) * 8, reduction_factors: Sequence[int] = (6, 0, 0, 0, 0, 0, 0, 0),
                 dmodel: int = 640, nlayers: int = 8, rnn_type: str = "lstm", rnn_units: int = 2048, rnn_unroll: bool = False,
                 layer_norm: bool = True, dtype=torch.float32, rnn_impl: str = "auto"):
        super().__init__()
        del rnn_unroll  # a compile-time knob of the JAX scan
        if not len(reduction_positions) == len(reduction_factors) == nlayers:
            raise ValueError("reduction_positions and reduction_factors need one entry per layer")
        self.reduction_factors, self.nlayers = tuple(reduction_factors), nlayers
        width = in_features
        for i in range(nlayers):
            block = RnnTransducerBlock(width, reduction_positions[i], reduction_factors[i], dmodel, rnn_type, rnn_units, layer_norm, dtype, rnn_impl)
            self.add_module(f"block_{i}", block)
            width = block.output_dim

    @property
    def time_reduction_factor(self) -> int:
        out = 1
        for f in self.reduction_factors:
            out *= max(f, 1)
        return out

    def output_length(self, length):
        return math_util.get_reduced_length(length, self.time_reduction_factor)

    def init_state(self, batch: int, device=None) -> list:
        """One zero carry per block in the cell's structure (JAX ``init_state``)."""
        return [getattr(self, f"block_{i}").rnn.init_state(batch, device) for i in range(self.nlayers)]

    def forward(self, features: torch.Tensor, features_length: torch.Tensor, initial_state: Optional[list] = None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """``train`` and ``generator`` are taken for the common encoder signature: the encoder has no dropout or BatchNorm."""
        x = math_util.merge_two_last_dims(features) if features.dim() == 4 else features
        lengths = features_length
        new_states = [] if initial_state is not None else None
        for i in range(self.nlayers):
            x, lengths, state = getattr(self, f"block_{i}")(x, lengths, None if initial_state is None else initial_state[i])
            if new_states is not None:
                new_states.append(state)
        return mask_sequence(x, lengths), lengths, new_states
