"""Whole-sequence LSTM layer, forward and backward (``csrc/lstm_mma.cu`` in bf16, ``csrc/lstm.cu`` in f32).

Replaces ``tensorflowasr_tpu/ops/pallas/lstm_kernel.py``: :func:`lstm_core`
(the recurrence over a full sequence, ``_fwd_kernel`` and ``_bwd_kernel``
under a ``custom_vjp``) and :func:`lstm_layer_fused` (the input
projection as one matrix product, the recurrence, and JAX's fused-path
length semantics). Gate order i, f, g, o; ``c' = σ(f)·c + σ(i)·tanh(g)``,
``h' = σ(o)·tanh(c')``, flax ``OptimizedLSTMCell``'s.

The forward saves the activated gates and the cell sequence (no
recompute); the backward runs BPTT over them and returns d(pre-activation)
``dxg`` in f32 with dh0 and dc0; the weight gradient ``hprevᵀ·dxg`` over
all B·T rows is one f32 matrix product outside the kernels, as JAX leaves
it to XLA. h (and the backward's dxg row) enters the recurrent product
rounded to the input dtype, with f32 accumulation; the carries stay f32;
y, cseq and the gates are stored in the input dtype; cotangents come back
in the primal dtypes.

Two designs, chosen by dtype. bf16 runs on the tensor cores
(``csrc/lstm_mma.cu``): one thread-block cluster of C blocks per 16 batch
rows, each block holding its hidden units' slice of Wh in shared memory
for the whole sequence, one ``mma.sync`` product per warp and step, h (or
the backward's bf16 dxg row) exchanged through distributed shared memory;
the library plans C and how much of each slice stays on chip
(:func:`lstm_mma_plan`), streams the rest from L2 above H 448 and refuses
H above 1024. f32 (parity runs only) keeps the CUDA-core cooperative grid of
``csrc/lstm.cu``, one grid-wide barrier per step, ``units`` hidden units per
block (:func:`_units`).

What bounds the kernels on the card: the chain of T dependent steps each
way, not the recurrent products (1.7 GFLOP at B 16, T 129, H 320) or their
~13 MB of traffic. The plain versions (:func:`lstm_fwd_plain`,
:func:`lstm_bwd_plain`) repeat the kernels' arithmetic as Python loops
over the steps.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from tensorflowasr_tpu_torch.ops.cuda import _build
from tensorflowasr_tpu_torch.utils import tracing

MAX_UNITS = 8  # csrc/lstm.cu (f32): hidden units per block; the grid holds ceil(H / units) co-resident blocks


@dataclass(frozen=True)
class LstmMmaPlan:
    """The bf16 kernels' layout at width H, as ``csrc/lstm_mma.cu``'s
    ``lm_plan`` picks it: ``cluster`` (C) blocks per 16 batch rows; the H
    units in groups of 8, at most ``groups_per_block`` (one warp each) a
    block; of the forward's ``fwd_ksteps`` k-steps of 16 the first
    ``fwd_resident`` stay in shared memory, of the backward's ``bwd_chunks``
    chunks of 32 gate columns the first ``bwd_resident``; the rest are read
    each step from packed copies of ``fwd_pack_bytes`` / ``bwd_pack_bytes``
    in L2; ``bwd_buffers`` dxg exchange buffers (1: a cluster barrier per
    step); each block's dynamic shared memory forward and backward."""

    cluster: int
    groups_per_block: int
    fwd_ksteps: int
    fwd_resident: int
    bwd_chunks: int
    bwd_resident: int
    bwd_buffers: int
    fwd_smem_bytes: int
    bwd_smem_bytes: int
    fwd_pack_bytes: int
    bwd_pack_bytes: int


@functools.cache
def lstm_mma_plan(h: int) -> LstmMmaPlan:
    """The bf16 kernels' plan at width ``h``, read from the library. The rule:
    C is the smallest of 1, 2, 4, 8, 16 for which a block holds at most 8
    groups and both kernels keep their whole Wh slices and two exchange
    buffers in 227 KB of shared memory; where none does (H above 448), C 16,
    the slices' first k-steps / chunks that fit resident and the rest
    streamed from L2, and one backward buffer where two do not fit (H above
    896). H above 1024 (more than 16 × 8 groups) raises."""
    out = (ctypes.c_longlong * 11)()
    if _build.build().tfasr_lstm_mma_plan(h, out):
        raise ValueError(f"bf16 LSTM kernel: H = {h} is wider than a cluster of 16 blocks of 8 groups of 8 units runs (H ≤ 1024)")
    return LstmMmaPlan(*out)


MAX_BF16_UNITS, H100_SMS = 1024, 132


def supported(h: int, dtype: torch.dtype) -> bool:
    """Whether the kernels (forward and backward) take ``h`` hidden units in
    ``dtype``: bf16 up to 1024 (a cluster of 16 blocks of 8 groups of 8
    units, :func:`lstm_mma_plan`); f32 up to 8 units a block on one block per
    SM of the H100's 132 (1,056). A pure function of the shapes; the LSTM
    layer runs its cell loop at any other."""
    if dtype == torch.bfloat16:
        return 1 <= h <= MAX_BF16_UNITS
    return dtype == torch.float32 and 1 <= h <= MAX_UNITS * H100_SMS


def _split(g: torch.Tensor):
    return g.chunk(4, dim=-1)


def lstm_fwd_plain(xg: torch.Tensor, wh: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor):
    """(y, cseq [B, T, H], gates [B, T, 4H]) in xg's dtype from xg [B, T, 4H],
    wh [H, 4H], h0, c0 [B, H], all in one dtype (JAX ``_fwd_kernel``)."""
    dt = xg.dtype
    whf = wh.float()
    h, c = h0.float(), c0.float()
    ys, cs, gs = [], [], []
    for t in range(xg.shape[1]):
        a = xg[:, t].float() + h.to(dt).float() @ whf
        ai, af, ag, ao = _split(a)
        ig, fg, gg, og = torch.sigmoid(ai), torch.sigmoid(af), torch.tanh(ag), torch.sigmoid(ao)
        c = fg * c + ig * gg
        h = og * torch.tanh(c)
        ys.append(h.to(dt))
        cs.append(c.to(dt))
        gs.append(torch.cat([ig, fg, gg, og], dim=-1).to(dt))
    return torch.stack(ys, 1), torch.stack(cs, 1), torch.stack(gs, 1)


def lstm_bwd_plain(gates: torch.Tensor, cseq: torch.Tensor, c0: torch.Tensor, wh: torch.Tensor, dy: torch.Tensor, dcseq: torch.Tensor):
    """(dxg [B, T, 4H], dh0, dc0 [B, H]) in f32: BPTT over the saved gates and
    cell sequence (JAX ``_bwd_kernel``), given the cotangents dy, dcseq of
    y and cseq. The recurrent product takes dxg rounded to the saved dtype."""
    dt = cseq.dtype
    whf = wh.float()
    dh = dc = torch.zeros(cseq.shape[0], cseq.shape[2], device=cseq.device)
    dxg = []
    for t in range(cseq.shape[1] - 1, -1, -1):
        ig, fg, gg, og = _split(gates[:, t].float())
        tc = torch.tanh(cseq[:, t].float())
        dh = dy[:, t].float() + dh
        do = dh * tc
        dct = dh * og * (1.0 - tc * tc) + dc + dcseq[:, t].float()
        cprev = (cseq[:, t - 1] if t > 0 else c0.to(dt)).float()
        da = torch.cat([dct * gg * ig * (1.0 - ig), dct * cprev * fg * (1.0 - fg), dct * ig * (1.0 - gg * gg), do * og * (1.0 - og)], dim=-1)
        dxg.append(da)
        dh = da.to(dt).float() @ whf.t()
        dc = dct * fg
    return torch.stack(dxg[::-1], 1), dh, dc


def weight_grad(y: torch.Tensor, h0: torch.Tensor, dxg: torch.Tensor) -> torch.Tensor:
    """dWh [H, 4H] f32 = hprevᵀ·dxg over all B·T rows, hprev = (h0, y[:, :-1]) in y's dtype."""
    hprev = torch.cat([h0.to(y.dtype)[:, None], y[:, :-1]], dim=1).float()
    return hprev.reshape(-1, hprev.shape[-1]).t() @ dxg.reshape(-1, dxg.shape[-1])


def _units(h: int, dev: torch.device, units: int | None) -> int:
    """Hidden units per block: ``units``, or by default the fewest that keep
    the grid of ceil(H / units) co-resident blocks within one block per SM
    (3 at H 320 on 132 SMs; each block's product phase grows with its units)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    units = units or -(-h // sms)
    if units > MAX_UNITS or -(-h // units) > sms:
        raise ValueError(f"H = {h} at {units} hidden units per block needs {-(-h // units)} blocks on {sms} SMs; the kernel takes at most "
                         f"{MAX_UNITS} units per block and one block per SM")
    return units


def _check(xg, wh, h0, c0, units=None):
    """(b, t, h, dtype code, f32 units per block or None, bf16 plan or None)."""
    if xg.dim() != 3 or xg.shape[2] % 4:
        raise ValueError("xg must be [B, T, 4H]")
    b, t, g4 = xg.shape
    h = g4 // 4
    code = _build.compute_dtype(xg, "xg")
    for name, x, shape in (("xg", xg, (b, t, g4)), ("wh", wh, (h, g4)), ("h0", h0, (b, h)), ("c0", c0, (b, h))):
        _build.require(x, name, device=xg.device, dtype=xg.dtype, shape=shape)
    if b * t * h == 0:
        raise ValueError(f"empty LSTM input [B, T, 4H] = {tuple(xg.shape)}")
    if not supported(h, xg.dtype):
        raise ValueError(f"an LSTM of H = {h} units in {xg.dtype} is not supported by the kernel (bf16 H ≤ {MAX_BF16_UNITS})")
    if xg.dtype == torch.bfloat16:
        if units is not None:
            raise ValueError("units applies to the f32 kernel; the bf16 kernel's blocks follow lstm_mma_plan")
        return b, t, h, code, None, lstm_mma_plan(h)
    return b, t, h, code, _units(h, xg.device, units), None


def _pack(nbytes: int, dev: torch.device):
    """The packed copy of the streamed part of Wh (see :class:`LstmMmaPlan`), or None where nothing streams."""
    return torch.empty(nbytes, dtype=torch.uint8, device=dev) if nbytes else None


def lstm_fwd_kernel(xg, wh, h0, c0, units: int | None = None):
    """The forward kernel on CUDA tensors: (y, cseq, gates) as :func:`lstm_fwd_plain`.
    bf16: the cluster kernel as :func:`lstm_mma_plan` lays it out; f32: the
    cooperative grid, ``units`` hidden units per block (default as
    :func:`_units` picks)."""
    b, t, h, code, units, plan = _check(xg, wh, h0, c0, units)
    lib = _build.build()
    with tracing.kernel("kernel.lstm.fwd", xg, wh), torch.cuda.device(xg.device):
        y, cseq = torch.empty((b, t, h), dtype=xg.dtype, device=xg.device), torch.empty((b, t, h), dtype=xg.dtype, device=xg.device)
        gates = torch.empty_like(xg)
        if plan is not None:
            pack = _pack(plan.fwd_pack_bytes, xg.device)
            err = lib.tfasr_lstm_mma_fwd(xg.data_ptr(), wh.data_ptr(), h0.data_ptr(), c0.data_ptr(), y.data_ptr(), cseq.data_ptr(), gates.data_ptr(),
                                         pack.data_ptr() if pack is not None else None, b, t, h, _build.stream_of(xg))
        else:
            counter = torch.zeros(1, dtype=torch.int32, device=xg.device)
            vec = int(h * xg.element_size() % 16 == 0 and h0.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0)  # 16-byte loads of h rows
            err = lib.tfasr_lstm_fwd(xg.data_ptr(), wh.data_ptr(), h0.data_ptr(), c0.data_ptr(), y.data_ptr(), cseq.data_ptr(), gates.data_ptr(),
                                     counter.data_ptr(), b, t, h, units, code, vec, _build.stream_of(xg))
        _build.check(err, "lstm_fwd")
    return y, cseq, gates


def lstm_bwd_kernel(gates, cseq, c0, wh, dy, dcseq, units: int | None = None):
    """The backward kernel on CUDA tensors: (dxg, dh0, dc0) as :func:`lstm_bwd_plain`.
    ``units`` as :func:`lstm_fwd_kernel`."""
    b, t, h, code, units, plan = _check(gates, wh, c0, c0, units)
    _build.require(cseq, "cseq", device=gates.device, dtype=gates.dtype, shape=(b, t, h))
    dy, dcseq = dy.float().contiguous(), dcseq.float().contiguous()
    for name, x in (("dy", dy), ("dcseq", dcseq)):
        _build.require(x, name, device=gates.device, dtype=torch.float32, shape=(b, t, h))
    lib = _build.build()
    with tracing.kernel("kernel.lstm.bwd", gates, wh), torch.cuda.device(gates.device):
        f32 = dict(dtype=torch.float32, device=gates.device)
        dxg, dh0, dc0 = torch.empty((b, t, 4 * h), **f32), torch.empty((b, h), **f32), torch.empty((b, h), **f32)
        ins = (dy.data_ptr(), dcseq.data_ptr(), gates.data_ptr(), cseq.data_ptr(), c0.data_ptr(), wh.data_ptr())
        outs = (dxg.data_ptr(), dh0.data_ptr(), dc0.data_ptr())
        if plan is not None:
            pack = _pack(plan.bwd_pack_bytes, gates.device)
            err = lib.tfasr_lstm_mma_bwd(*ins, pack.data_ptr() if pack is not None else None, *outs, b, t, h, _build.stream_of(gates))
        else:
            counter = torch.zeros(1, dtype=torch.int32, device=gates.device)
            err = lib.tfasr_lstm_bwd(*ins, *outs, counter.data_ptr(), b, t, h, units, code, _build.stream_of(gates))
        _build.check(err, "lstm_bwd")
    return dxg, dh0, dc0


class _LSTMCore(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xg, wh, h0, c0):
        dt = xg.dtype
        whc, h0c, c0c = wh.to(dt).contiguous(), h0.to(dt).contiguous(), c0.to(dt).contiguous()
        fwd = lstm_fwd_plain if xg.device.type == "cpu" else lstm_fwd_kernel
        y, cseq, gates = fwd(xg.contiguous(), whc, h0c, c0c)
        ctx.save_for_backward(y, cseq, gates, whc, h0c, c0c)
        ctx.dtypes = (xg.dtype, wh.dtype, h0.dtype, c0.dtype)
        return y, cseq

    @staticmethod
    def backward(ctx, dy, dcseq):
        y, cseq, gates, whc, h0c, c0c = ctx.saved_tensors
        bwd = lstm_bwd_plain if y.device.type == "cpu" else lstm_bwd_kernel
        dxg, dh0, dc0 = bwd(gates, cseq, c0c, whc, dy, dcseq)
        dwh = weight_grad(y, h0c, dxg)
        return tuple(g.to(dt) for g, dt in zip((dxg, dwh, dh0, dc0), ctx.dtypes))


def lstm_core(xg: torch.Tensor, wh: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor):
    """The LSTM recurrence over a full sequence (JAX argument order minus
    ``interpret``): xg [B, T, 4H] = x·Wx + b (gate order i, f, g, o), wh
    [H, 4H], h0, c0 [B, H]. Returns (y, cseq) [B, T, H] in xg's dtype: the
    hidden and cell sequences. Differentiable in all four inputs. A CUDA
    tensor launches the kernels; a CPU tensor takes the plain versions.
    Under ``torch.export`` the call is the custom operator ``tfasr::lstm``
    (``ops/cuda/library.py``), the forward only."""
    if torch.compiler.is_exporting():
        from tensorflowasr_tpu_torch.ops.cuda import library

        if not supported(wh.shape[0], xg.dtype):
            raise ValueError(f"an LSTM of {wh.shape[0]} units in {xg.dtype} is not supported by the kernel")
        dt = xg.dtype
        return library.lstm(xg.contiguous(), wh.to(dt).contiguous(), h0.to(dt).contiguous(), c0.to(dt).contiguous())
    if xg.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no LSTM kernel for device {xg.device}")
    return _LSTMCore.apply(xg, wh, h0, c0)


def lstm_layer_fused(x: torch.Tensor, weight_ih: torch.Tensor, weight_hh: torch.Tensor, bias: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor,
                     lengths: torch.Tensor | None = None, dtype=torch.float32):
    """A full LSTM layer on the port's ``LSTMCell`` parameters (weight_ih
    [4H, E], weight_hh [4H, H], bias [4H] on the hidden side): xg = x·Wx + b
    as one product in ``dtype`` (the weights and bias cast to it first, as
    JAX does), then :func:`lstm_core`. Returns (y [B, T, H], (c_T, h_T)).

    JAX's fused semantics, not flax's scan's: with ``lengths``, outputs
    past each row's length are 0, the final carry is the one at
    ``length − 1``, and a row of length 0 keeps (c0, h0)."""
    wx, wh, b = weight_ih.t().to(dtype), weight_hh.t().to(dtype), bias.to(dtype)
    xg = torch.matmul(x.to(dtype), wx) + b
    y, cseq = lstm_core(xg, wh, h0.to(dtype), c0.to(dtype))
    if lengths is None:
        return y, (cseq[:, -1], y[:, -1])
    t = x.shape[1]
    lens = lengths.to(x.device, torch.int64)
    steps = torch.arange(t, device=x.device)[None, :]
    onehot = (steps == (lens - 1)[:, None]).to(y.dtype)
    empty = (lens == 0)[:, None]
    zero = torch.zeros((), dtype=y.dtype, device=x.device)
    h_t = torch.einsum("bt,bth->bh", onehot, y) + torch.where(empty, h0.to(y.dtype), zero)
    c_t = torch.einsum("bt,bth->bh", onehot, cseq) + torch.where(empty, c0.to(y.dtype), zero)
    return torch.where((steps < lens[:, None])[..., None], y, zero), (c_t, h_t)
