"""LSTM for the transducer prediction network (counterpart of
``models/layers/rnn.py``, LSTM only).

Flax ``OptimizedLSTMCell`` semantics: gates i, f, g, o from
``x·W_ih`` (input projections carry NO bias) plus ``h·W_hh + b`` (hidden
projections carry the bias), each product in ``dtype``;
``c' = f·c + i·g``, ``h' = o·tanh(c')``; the carry is ``(c, h)``. As in
JAX, a bf16 gate times an f32 carry promotes to f32, so the carry stays
f32. ``step`` is the single-step path the decode loop uses; ``forward``
scans a sequence with per-row lengths: the state stops at each row's
length, and outputs past it are not meaningful.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


class LSTMCell(nn.Module):
    def __init__(self, input_size: int, units: int, dtype=torch.float32):
        super().__init__()
        self.units, self.dtype = units, dtype
        self.weight_ih = nn.Parameter(torch.empty(4 * units, input_size))
        self.weight_hh = nn.Parameter(torch.empty(4 * units, units))
        self.bias = nn.Parameter(torch.zeros(4 * units))

    def forward(self, state, x: torch.Tensor):
        c, h = state
        dt = self.dtype
        gates = F.linear(x.to(dt), self.weight_ih.to(dt)) + F.linear(h.to(dt), self.weight_hh.to(dt), self.bias.to(dt))
        i, f, g, o = gates.chunk(4, dim=-1)
        new_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        new_h = torch.sigmoid(o) * torch.tanh(new_c)
        return (new_c, new_h), new_h


class RNN(nn.Module):
    """Unidirectional LSTM layer: ``forward(x [B,T,D], lengths) → (y, state)``,
    ``step(x_t [B,D], state) → (y [B,U], state)``."""

    def __init__(self, input_size: int, units: int, rnn_type: str = "lstm", dtype=torch.float32):
        super().__init__()
        if rnn_type != "lstm":
            raise NotImplementedError(f"rnn_type {rnn_type!r} is not ported yet (lstm only)")
        self.units = units
        self.cell = LSTMCell(input_size, units, dtype)

    def init_state(self, batch: int, device=None):
        zero = torch.zeros((batch, self.units), device=device)
        return (zero, zero)

    def step(self, x_t: torch.Tensor, state):
        new_state, y = self.cell(state, x_t)
        return y, new_state

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None, initial_state=None):
        b, t = x.shape[:2]
        state = initial_state if initial_state is not None else self.init_state(b, x.device)
        ys = []
        for i in range(t):
            new_state, y = self.cell(state, x[:, i])
            if lengths is not None:
                keep = (i < lengths.to(x.device))[:, None]
                new_state = tuple(torch.where(keep, n, o) for n, o in zip(new_state, state))
            state = new_state
            ys.append(y)
        return torch.stack(ys, dim=1), state
