"""Recurrent layers: the transducer prediction network's, DeepSpeech2's and
the RNN-T encoder's unidirectional and bidirectional stacks of LSTM, GRU
or simple-RNN cells (counterpart of ``models/layers/rnn.py``).

The cells and their carries are JAX's: an LSTM carries ``(c, h)``, a GRU a
bare ``h``, a simple RNN the 1-tuple ``(h,)``.

Flax ``OptimizedLSTMCell`` semantics: gates i, f, g, o from
``x·W_ih`` (input projections carry NO bias) plus ``h·W_hh + b`` (hidden
projections carry the bias), each product in ``dtype``;
``c' = f·c + i·g``, ``h' = o·tanh(c')``; the carry is ``(c, h)``. As in
JAX, a bf16 gate times an f32 carry promotes to f32, so the carry stays
f32. ``step`` is the single-step path the decode loop uses; ``forward``
runs a whole sequence (the prediction net's training forward).

Flax ``GRUCell`` semantics (:class:`GRUCell`): r = σ(x·W_ir + b_ir +
h·W_hr), z = σ(x·W_iz + b_iz + h·W_hz) (no hidden bias on r and z), n =
tanh(x·W_in + b_in + r ⊙ (h·W_hn + b_hn)), h' = (1 − z)·n + z·h; as with
the LSTM, z times an f32 carry keeps the carry f32. The simple RNN
(:class:`SimpleRNNCell`, JAX ``SimpleRNNCell``): h' = tanh(x·W_i + b_i +
h·W_h + b_h), in ``dtype``. JAX runs both through ``lax.scan`` and has no
kernel for either, so the port runs them, on the card too, as a loop of
the cell over PyTorch ops: the input products for the whole sequence in
one GEMM, then one hidden-side GEMM a step.

``rnn_impl`` mirrors the JAX package's ``TFASR_RNN_IMPL`` as an argument
and applies to the LSTM only (JAX ``_use_fused_lstm``):
``"auto"`` (the default) and ``"xla"`` scan the sequence as a Python loop
over the cell, as JAX's ``nn.RNN`` scan does (JAX's ``auto`` keeps the
scan); ``"pallas"`` runs the whole-sequence LSTM kernels
(``ops/cuda/lstm_kernel.py:lstm_layer_fused``, JAX's fused path) with its
length semantics. JAX also falls back to the scan where its kernel's VMEM
budget does not fit; the port has no such gate: the kernel's wrapper
raises for a width it cannot take.

``bidirectional=True`` adds a second cell, ``cell_bwd`` (JAX's parameter
names), that reads each row's valid frames in reverse, as flax's
``nn.RNN(reverse=True, keep_order=True)`` does with ``flip_sequences``:
index j reads frame (T − 1 − j + L) mod T, so the valid frames are
reversed and the padding, reversed too, follows them; the same map puts
the outputs back in order. The layer returns ``concat([y_fwd, y_bwd])`` and
the carries ``(carry_fwd, carry_bwd)``. Under ``"pallas"`` each direction
runs the LSTM kernels (the flip a gather around the call): JAX keeps its
scan for a bidirectional layer, so the outputs agree with it on every
valid frame and are 0 past each row's length, as on JAX's fused path.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from tensorflowasr_tpu_torch.ops import routes
from tensorflowasr_tpu_torch.ops.cuda import lstm_kernel
from tensorflowasr_tpu_torch.ops.cuda.lstm_kernel import lstm_layer_fused

RNN_IMPLS = ("auto", "xla", "pallas")
RNN_TYPES = ("lstm", "gru", "rnn")


def default_rnn_impl(device) -> str:
    """``"pallas"`` (the LSTM kernels) for a model built on a CUDA device
    (``None``: the card), ``"auto"`` (JAX's default scan) elsewhere. An
    LSTM stack is the compute of DeepSpeech2 and the RNN-T encoder (5
    layers × 2 directions × ~800 steps, or 4 layers of 1024 units from 1600
    steps, at 16 s); JAX's scan is one compiled loop, the port's a Python
    loop of cell calls."""
    return "pallas" if device is None or torch.device(device).type == "cuda" else "auto"


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

    def init_carry(self, batch: int, device=None):
        zeros = lambda: torch.zeros((batch, self.units), device=device)
        return (zeros(), zeros())  # two tensors: a carry whose c and h alias misleads torch.export


class GRUCell(nn.Module):
    """flax ``nn.GRUCell``: ``weight_ih [3U, E]`` and ``bias_ih [3U]`` (the
    input sides ``ir``, ``iz``, ``in``), ``weight_hh [3U, U]`` (``hr``,
    ``hz``, ``hn``) and ``bias_hn [U]``; the carry is ``h``."""

    def __init__(self, input_size: int, units: int, dtype=torch.float32):
        super().__init__()
        self.units, self.dtype = units, dtype
        self.weight_ih = nn.Parameter(torch.empty(3 * units, input_size))
        self.bias_ih = nn.Parameter(torch.zeros(3 * units))
        self.weight_hh = nn.Parameter(torch.empty(3 * units, units))
        self.bias_hn = nn.Parameter(torch.zeros(units))

    def input_gates(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.linear(x.to(dt), self.weight_ih.to(dt), self.bias_ih.to(dt))

    def recur(self, h: torch.Tensor, gi: torch.Tensor):
        """One step from the input side's products ``gi`` [B, 3U]."""
        dt = self.dtype
        gh = F.linear(h.to(dt), self.weight_hh.to(dt))
        ir, iz, in_ = gi.chunk(3, dim=-1)
        hr, hz, hn = gh.chunk(3, dim=-1)
        r, z = torch.sigmoid(ir + hr), torch.sigmoid(iz + hz)
        n = torch.tanh(in_ + r * (hn + self.bias_hn.to(dt)))
        new_h = (1.0 - z) * n + z * h
        return new_h, new_h

    def forward(self, h, x: torch.Tensor):
        return self.recur(h, self.input_gates(x))

    def init_carry(self, batch: int, device=None):
        return torch.zeros((batch, self.units), device=device)


class SimpleRNNCell(nn.Module):
    """JAX ``SimpleRNNCell``: ``weight_ih``/``bias_ih`` (Dense ``i``) and
    ``weight_hh``/``bias_hh`` (Dense ``h``), h' = tanh(i(x) + h(h)) in
    ``dtype``; the carry is ``(h,)``."""

    def __init__(self, input_size: int, units: int, dtype=torch.float32):
        super().__init__()
        self.units, self.dtype = units, dtype
        self.weight_ih = nn.Parameter(torch.empty(units, input_size))
        self.bias_ih = nn.Parameter(torch.zeros(units))
        self.weight_hh = nn.Parameter(torch.empty(units, units))
        self.bias_hh = nn.Parameter(torch.zeros(units))

    def input_gates(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.linear(x.to(dt), self.weight_ih.to(dt), self.bias_ih.to(dt))

    def recur(self, carry, gi: torch.Tensor):
        (h,) = carry
        dt = self.dtype
        new_h = torch.tanh(gi + F.linear(h.to(dt), self.weight_hh.to(dt), self.bias_hh.to(dt)))
        return (new_h,), new_h

    def forward(self, carry, x: torch.Tensor):
        return self.recur(carry, self.input_gates(x))

    def init_carry(self, batch: int, device=None):
        return (torch.zeros((batch, self.units), device=device),)


_CELLS = {"lstm": LSTMCell, "gru": GRUCell, "rnn": SimpleRNNCell}


def flip_sequences(x: torch.Tensor, lengths: Optional[torch.Tensor]) -> torch.Tensor:
    """flax ``flip_sequences`` on [B, T, ...]: position j of row b takes frame
    (T − 1 − j + L_b) mod T (a plain reversal without ``lengths``). The map
    is its own inverse."""
    t = x.shape[1]
    if lengths is None:
        return x.flip(1)
    idx = (torch.arange(t - 1, -1, -1, device=x.device)[None, :] + lengths.to(x.device, torch.int64)[:, None]) % max(t, 1)
    return torch.gather(x, 1, idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand_as(x))


class RNN(nn.Module):
    """Recurrent layer: ``forward(x [B,T,D], lengths) → (y [B,T,U(·2)], state)``,
    ``step(x_t [B,D], state) → (y [B,U], state)`` (unidirectional only)."""

    def __init__(self, input_size: int, units: int, rnn_type: str = "lstm", dtype=torch.float32, rnn_impl: str = "auto", bidirectional: bool = False):
        super().__init__()
        if rnn_type not in RNN_TYPES:
            raise ValueError(f"rnn_type must be in {RNN_TYPES}")
        if rnn_impl not in RNN_IMPLS:
            raise ValueError(f"rnn_impl {rnn_impl!r} is not one of {RNN_IMPLS}")
        self.units, self.rnn_type, self.rnn_impl, self.bidirectional = units, rnn_type, rnn_impl, bidirectional
        self.cell = _CELLS[rnn_type](input_size, units, dtype)
        if bidirectional:
            self.cell_bwd = _CELLS[rnn_type](input_size, units, dtype)

    def init_state(self, batch: int, device=None):
        """Zero carries: the cell's, or ``(carry_fwd, carry_bwd)`` when bidirectional."""
        carry = self.cell.init_carry(batch, device)
        return (carry, self.cell_bwd.init_carry(batch, device)) if self.bidirectional else carry

    def step(self, x_t: torch.Tensor, state):
        if self.bidirectional:
            raise ValueError("the single-step path is unidirectional only")
        new_state, y = self.cell(state, x_t)
        return y, new_state

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None, initial_state=None):
        """``"auto"``/``"xla"``: flax ``nn.RNN`` semantics: the scan runs over
        every step (so outputs past a row's length are those of the continued
        scan), and with ``lengths`` the returned state is the one after step
        ``length − 1`` of each row. ``"pallas"``: :func:`lstm_layer_fused`'s
        where the LSTM kernels take the width (``lstm_kernel.supported``),
        else the cell loop, as JAX's scan where its kernel declines.
        Bidirectional: ``initial_state`` and the returned state are pairs
        ``(carry_fwd, carry_bwd)``."""
        if not self.bidirectional:
            return self._direction(self.cell, x, lengths, initial_state)
        init_f, init_b = initial_state if initial_state is not None else (None, None)
        y_f, carry_f = self._direction(self.cell, x, lengths, init_f)
        y_b, carry_b = self._direction(self.cell_bwd, flip_sequences(x, lengths), lengths, init_b)
        return torch.cat([y_f, flip_sequences(y_b, lengths)], dim=-1), (carry_f, carry_b)

    def _direction(self, cell: nn.Module, x: torch.Tensor, lengths: Optional[torch.Tensor], state):
        b, t = x.shape[:2]
        if state is None:
            state = cell.init_carry(b, x.device)
        if self.rnn_type == "lstm" and self.rnn_impl == "pallas" and routes.take("lstm", lstm_kernel.supported(cell.units, cell.dtype)):
            c0, h0 = state
            return lstm_layer_fused(x, cell.weight_ih, cell.weight_hh, cell.bias, h0, c0, lengths, dtype=cell.dtype)
        if self.rnn_type == "lstm":
            step = lambda carry, i: cell(carry, x[:, i])
        else:
            gi = cell.input_gates(x)  # every step's input products in one GEMM
            step = lambda carry, i: cell.recur(carry, gi[:, i])
        ys, states = [], []
        for i in range(t):
            state, y = step(state, i)
            ys.append(y)
            states.append(state)
        if lengths is not None and t > 0:
            last = (lengths.to(x.device).long() - 1) % t  # a zero length takes the last step, as flax's index −1 does
            rows = torch.arange(b, device=x.device)
            pick = lambda parts: torch.stack(parts)[last, rows]
            state = pick(states) if self.rnn_type == "gru" else tuple(pick(parts) for parts in zip(*states))
        return torch.stack(ys, dim=1), state
