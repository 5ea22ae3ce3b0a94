"""LSTM for the transducer prediction network (counterpart of
``models/layers/rnn.py``, LSTM only).

Flax ``OptimizedLSTMCell`` semantics: gates i, f, g, o from
``x·W_ih`` (input projections carry NO bias) plus ``h·W_hh + b`` (hidden
projections carry the bias), each product in ``dtype``;
``c' = f·c + i·g``, ``h' = o·tanh(c')``; the carry is ``(c, h)``. As in
JAX, a bf16 gate times an f32 carry promotes to f32, so the carry stays
f32. ``step`` is the single-step path the decode loop uses; ``forward``
runs a whole sequence (the prediction net's training forward).

``rnn_impl`` mirrors the JAX package's ``TFASR_RNN_IMPL`` as an argument:
``"auto"`` (the default) and ``"xla"`` scan the sequence as a Python loop
over the cell, as JAX's ``nn.RNN`` scan does (JAX's ``auto`` keeps the
scan); ``"pallas"`` runs the whole-sequence LSTM kernels
(``ops/cuda/lstm_kernel.py:lstm_layer_fused``, JAX's fused path) with its
length semantics. JAX also falls back to the scan where its kernel's VMEM
budget does not fit; the port has no such gate: the kernel's wrapper
raises for a width it cannot take.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from tensorflowasr_tpu_torch.ops.cuda.lstm_kernel import lstm_layer_fused

RNN_IMPLS = ("auto", "xla", "pallas")

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

    def __init__(self, input_size: int, units: int, rnn_type: str = "lstm", dtype=torch.float32, rnn_impl: str = "auto"):
        super().__init__()
        if rnn_type != "lstm":
            raise NotImplementedError(f"rnn_type {rnn_type!r} is not ported yet (lstm only)")
        if rnn_impl not in RNN_IMPLS:
            raise ValueError(f"rnn_impl {rnn_impl!r} is not one of {RNN_IMPLS}")
        self.units, self.rnn_impl = units, rnn_impl
        self.cell = LSTMCell(input_size, units, dtype)

    def init_state(self, batch: int, device=None):
        zero = torch.zeros((batch, self.units), device=device)
        return (zero, zero)

    def step(self, x_t: torch.Tensor, state):
        new_state, y = self.cell(state, x_t)
        return y, new_state

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None, initial_state=None):
        """``"auto"``/``"xla"``: flax ``nn.RNN`` semantics: the scan runs over
        every step (so outputs past a row's length are those of the continued
        scan), and with ``lengths`` the returned state is the one after step
        ``length − 1`` of each row. ``"pallas"``: :func:`lstm_layer_fused`'s."""
        b, t = x.shape[:2]
        state = initial_state if initial_state is not None else self.init_state(b, x.device)
        if self.rnn_impl == "pallas":
            c0, h0 = state
            return lstm_layer_fused(x, self.cell.weight_ih, self.cell.weight_hh, self.cell.bias, h0, c0, lengths, dtype=self.cell.dtype)
        ys, states = [], []
        for i in range(t):
            state, y = self.cell(state, x[:, i])
            ys.append(y)
            states.append(state)
        if lengths is not None and t > 0:
            last = (lengths.to(x.device).long() - 1) % t  # a zero length takes the last step, as flax's index −1 does
            rows = torch.arange(b, device=x.device)
            state = tuple(torch.stack(parts)[last, rows] for parts in zip(*states))
        return torch.stack(ys, dim=1), state
