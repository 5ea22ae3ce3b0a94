"""Operations and bytes of one call of a hand-written kernel, from the shapes
and dtypes its span recorded (``tensorflowasr_tpu_torch/utils/tracing.py``:
each ``kernel.<kernel>.<pass>`` span holds the wrapper's input tensors).

Work, not implementation: each input read once and each output written
once (weight gradients in f32), products at 2 operations a multiply-add,
the same arithmetic as ``chip_smoke.py``'s ``cost_*`` functions, so the
bound of a call is the same whatever kernel implements it. Its least time
is the larger of the bytes at 3.35 TB/s and the operations at 989 TFLOP/s
(bf16, the tensor cores) or 67 TFLOP/s (f32).

What the shapes cannot give, and how it is counted:

- the RNN-T DP (``kernel.rnnt_dp``), the CTC sweeps (``kernel.ctc``) and
  the fused decode (``kernel.decode``) do work that follows the lengths
  and the emitted tokens, which no shape holds: they have no work here
  and are left out of every roofline sum (:func:`work` returns None);
- the fused joint's backward counts every cell of the padded lattice: the
  kernel skips the all-zero tiles of cells outside each row's lattice,
  whose count follows the lengths (443,428 of 825,600 cells at the
  flagship's kernel-table inputs: the count over every cell is 1.9× that
  work);
- the attention products count every key of a row, the masks unknown;
- the frontend counts its bytes alone (the FFT size is a table's, not an
  input's; its operations at 67 TFLOP/s take less time at every nfft the
  port runs).
"""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense tensor-core bf16; f32 outside the tensor cores
ELT = {"bfloat16": 2, "float16": 2, "float32": 4}
UNCOUNTED = ("kernel.rnnt_dp", "kernel.ctc", "kernel.decode")  # work follows lengths and tokens


def cost_frontend(b: int, n: int, frames: int, mels: int):
    """f32 signal read, log-mel written; operations not counted (see the module docstring)."""
    return 4 * (b * n + b * frames * mels), 0.0


def cost_attention(bh: int, t: int, s: int, r: int, d: int, elt: int, bwd: bool):
    """Kernel B. fwd: qc, qp, k, v, pos → out; QKᵀ, the relative term and PV over every key. bwd: + out, dout → five
    gradients; 16 products of that size."""
    io = (2 * t + 2 * s + r) * bh * d * elt
    return (2 * io + 2 * bh * t * d * elt, 16 * bh * t * s * d) if bwd else (io + bh * t * d * elt, 6 * bh * t * s * d)


def cost_vanilla_attention(bh: int, t: int, s: int, d: int, elt: int, bias_bytes: int, bwd: bool):
    """Kernel A. fwd: q, k, v, bias → out; QKᵀ and PV. bwd: q, k, v, bias, out, dout → dq, dk, dv (the bias's gradient,
    where the call makes one, not counted); QKᵀ recomputed, do·vᵀ, dv, dq, dk."""
    if bwd:
        return (4 * t + 4 * s) * bh * d * elt + bias_bytes, 10 * bh * t * s * d
    return (2 * t + 2 * s) * bh * d * elt + bias_bytes, 4 * bh * t * s * d


def cost_ff(n: int, d: int, f: int, elt: int, bwd: bool):
    """fwd: x → out, two products. bwd: x, dout → dx and f32 weight gradients; five products (h, da, dW2, dW1, dy)."""
    params = 8 * d + (2 * d * f + f + d) * elt
    if bwd:
        return 3 * n * d * elt + params + 4 * (3 * d + 2 * d * f + f), 10 * n * d * f
    return 2 * n * d * elt + params, 4 * n * d * f


def cost_conv_front(n: int, d: int, elt: int, bwd: bool):
    """fwd: LN, two D×D products, GLU. bwd: six D×D products (ha, hb, dy from both halves, dWa, dWb)."""
    params = 8 * d + (2 * d * d + 2 * d) * elt
    if bwd:
        return 3 * n * d * elt + params + 4 * (4 * d + 2 * d * d), 12 * n * d * d
    return 2 * n * d * elt + params, 4 * n * d * d


def cost_conv_back(n: int, d: int, elt: int, bwd: bool):
    """fwd: x, y1 → out, one D×D product. bwd: y1, dout → dy1 and f32 gradients; two products (da, dW2)."""
    params = 16 * d + (d * d + d) * elt
    if bwd:
        return 3 * n * d * elt + params + 4 * (5 * d + d * d), 4 * n * d * d
    return 3 * n * d * elt + params, 2 * n * d * d


def cost_joint(b: int, t: int, u1: int, j: int, v: int, elt: int, bwd: bool):
    """fwd: enc_p, pred_p, Wv, bv, labels → lse, lp_blank, lp_emit; the vocabulary product, add + tanh a (cell, j), ~3 a
    logit for the log-sum-exp. bwd: + lse, gbl, gem → d_enc_p, d_pred_p and f32 dWv, dbv; three products (the logits, da,
    dWv) and ~5 a logit for d_logits, over every cell."""
    cells = b * t * u1
    params = v * j * elt + 4 * v
    inputs = (b * t + b * u1) * j * elt + params + 4 * b * (u1 - 1)
    if bwd:
        return inputs + 12 * cells + (b * t + b * u1) * j * elt + 4 * (v * j + v), 6.0 * cells * j * v + 2.0 * cells * j + 5.0 * cells * v
    return inputs + 12 * cells, 2.0 * cells * j * v + 2.0 * cells * j + 3.0 * cells * v


def cost_rows(rows: int, v: int, b: int, u: int, elt: int, bwd: bool):
    """The unfused loss's row kernels over [rows, V] logits. fwd: → lp_blank, lp_emit, lse (f32); ~4 operations a
    logit. bwd: + lse, gbl, gem, g → d_logits in the logits' dtype; ~6 a logit."""
    if bwd:
        return 2 * rows * v * elt + 12 * rows + 4 * b * u + 4 * b, 6.0 * rows * v
    return rows * v * elt + 4 * b * u + 12 * rows, 4.0 * rows * v


def cost_lstm(b: int, t: int, h: int, elt: int, bwd: bool):
    """The LSTM recurrence. fwd: xg, Wh, h0, c0 → y, cseq, gates; the recurrent product and ~10 operations a cell and
    step. bwd: dy, dc (f32), gates, cseq, c0, Wh → dxg (f32), dh0, dc0; da·Whᵀ and ~20 a cell and step."""
    if bwd:
        return 8 * b * t * h + 5 * b * t * h * elt + (b * h + 4 * h * h) * elt + 16 * b * t * h + 8 * b * h, 8.0 * b * t * h * h + 20.0 * b * t * h
    return 4 * b * t * h * elt + 4 * h * h * elt + 2 * b * h * elt + 6 * b * t * h * elt, 8.0 * b * t * h * h + 10.0 * b * t * h


def work(name: str, shapes: list, dtypes: list):
    """(bytes, operations, dtype) of one call of the kernel span ``name`` from its recorded input shapes and dtypes, or
    None for a kernel whose work the shapes do not give (``UNCOUNTED``) or a name this file does not know."""
    if name in UNCOUNTED or not shapes:
        return None
    dt = dtypes[0]
    elt, bwd = ELT.get(dt, 4), name.endswith(".bwd")
    base = name[: -len(".bwd")] if bwd else name[: -len(".fwd")] if name.endswith(".fwd") else name
    s0 = shapes[0]
    rows, width = math.prod(s0[:-1]), s0[-1]  # the row kernels' [..., D] input: every leading axis is rows
    if base == "kernel.ff":
        moved, ops = cost_ff(rows, width, shapes[1][1], elt, bwd)
    elif base == "kernel.conv_front":
        moved, ops = cost_conv_front(rows, width, elt, bwd)
    elif base == "kernel.conv_back":
        moved, ops = cost_conv_back(rows, width, elt, bwd)
    elif base == "kernel.rel_attention":
        (bh, t, d), s, r = s0, shapes[2][1], shapes[4][1]
        moved, ops = cost_attention(bh, t, s, r, d, elt, bwd)
    elif base == "kernel.attention":
        (bh, t, d), s = s0, shapes[2][1]
        moved, ops = cost_vanilla_attention(bh, t, s, d, elt, math.prod(shapes[3]) * ELT.get(dtypes[3], 4), bwd)
    elif base == "kernel.joint_loss":
        (b, t, j), u1, v = s0, shapes[1][1], shapes[2][0]
        moved, ops = cost_joint(b, t, u1, j, v, elt, bwd)
    elif base in ("kernel.rnnt_logprobs", "kernel.rnnt_dlogits"):
        b, t, u1, v = s0
        moved, ops = cost_rows(b * t * u1, v, b, u1 - 1, elt, base == "kernel.rnnt_dlogits")
    elif base == "kernel.lstm":
        b, t, g4 = s0
        moved, ops = cost_lstm(b, t, g4 // 4, elt, bwd)
    elif base == "kernel.frontend":
        (b, n), (_, frames, mels) = s0, shapes[1]
        moved, ops = cost_frontend(b, n, frames, mels)
    else:
        return None
    return float(moved), float(ops), dt


def least_s(name: str, shapes: list, dtypes: list):
    """The least time of one call in seconds (the larger of its bytes at the HBM rate and its operations at the dtype's
    peak), or None where :func:`work` gives none."""
    w = work(name, shapes, dtypes)
    if w is None:
        return None
    moved, ops, dt = w
    return max(moved / HBM_BYTES_PER_S, ops / PEAK_FLOPS.get(dt, PEAK_FLOPS["float32"]))
