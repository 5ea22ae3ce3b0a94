"""Chip smoke test of the PyTorch port on one CUDA card: serving, training and evaluation
of the Conformer-Transducer and the CTC models.

Run from the repository root on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

Phases, each printing its lines: device; kernel build (nvcc, from
``tensorflowasr_tpu_torch/csrc``); each forward kernel against its plain
PyTorch version at the serving shapes (f32 with TF32 off, and bf16), with
times; each forward kernel at rate 0.1 and each backward kernel against its
plain version at the flagship training shapes (f32 and bf16), with times
and bounds, the loss kernels (the RNN-T DP, the fused joint forward and
backward, the unfused loss's log-probability and d_logits row kernels) at
the flagship loss shapes (B 16, T 400, U+1 129, J 320, V 256, ragged
lengths), and the LSTM forward and backward kernels at the prediction
net's shape (B 16, T 129, H 320) beside cuDNN's ``torch.nn.LSTM``; three
served requests of 8 utterances through ``recognize`` on the flagship
Conformer-Transducer Small (random weights from a seed, bf16 compute), with
the kernels' launch counts; six training steps of the flagship in the
default configuration (``loss_impl="auto"``: the fused joint+loss; bf16,
dropout 0.1, Adam 1e-4, 16 utterances of up to 16 s, one fixed batch)
through ``Trainer.train_step``, with per-step times, loss, gradient norm,
peak memory and launch counts, and one profiled step for the card's busy
share; two steps of the ``loss_impl="xla"`` configuration (logits and the
plain DP); three eval steps (``Trainer.eval_step``, default ``loss_impl``:
logits, the log-probability row kernel and the DP) against the plain-DP
eval; two steps of ``loss_impl="pallas"`` with ``rnn_impl="pallas"`` (the
unfused loss and the LSTM kernels) and two ``auto`` steps with
``rnn_impl="pallas"``; f32 encoder parity and f32 training-step parity
(loss and every gradient; the ``auto`` step and the ``pallas`` step with
the LSTM kernels) between the card (kernels) and a CPU copy (plain
versions), and the f32 fused-path and unfused-path losses against the
``xla``-path loss on the card. Then the CTC family: the CTC loss kernel
(TPU kernel row 11) at the CTC training shapes (B 16, T 400, U_b 40–128,
V 256) beside ``F.ctc_loss``, kernel A (row 4, vanilla attention; bf16 on
the tensor cores) forward and backward at the Transformer-CTC training
shape (B·H 64, T = S 400, head 128, the padded-row bias of a ragged batch)
against its plain version at rate 0.1, its row statistics, and its times
beside ``F.scaled_dot_product_attention`` at rate 0 and at rate 0.1 on the
same inputs, and the four encoder kernels at
Conformer-CTC Small's widths (D 176, head 44); three greedy requests of 8
utterances through each CTC model's ``recognize`` (Conformer-CTC Small and
Transformer-CTC base at full width); four default (``auto``) training steps
of each (one profiled), one ``xla`` step from the same start held to the
first ``auto`` loss, three eval steps held to the ``xla`` eval; and the f32
card/CPU parity of each 2-block CTC model's step. Then the fused greedy
decode (TPU kernel row 13, one thread-block cluster per utterance): the
kernel, its plain version and the eager WIND loop on the real encoder
output of one flagship request (8 × 6–10 s, f32 and bf16), with times and
bound, the chosen cluster size with its occupancy and resident weight
bytes, and the time at each cluster size; the flagship's served requests decode
through it (one launch per request), every served request is watched for
outliers (garbage collection, device allocations; six more requests at new
lengths run under the profiler); streaming at bench.py's shape (batch 1,
16 chunks of 16 feature frames, 160 ms each, tokens, decoder and encoder
states carried) for the flagship and for the small-streaming example with a
64-frame KV memory, in bf16 with ms per chunk and launches per chunk (one
fused decode each), and in f32 card against CPU chunk by chunk; and the
Transformer-CTC referee (its f32 step at the published init, card and CPU,
against a float64 CPU run). Kernel B (row 3) and the fused FF (row 5) run
bf16 on the tensor cores: at both widths they print their times at rate 0
and 0.1 beside the earlier CUDA-core kernels' (PERF.md), kernel B's
chunked KV-memory case (S = M + T, kv_bias, chunk mask) forward and
backward, both kernels' bf16 results against a float64 run, and their
blocks per SM (the card's occupancy beside the shared-memory plan, whose
byte counts must equal the kernels'), registers and spills. The fused
joint + RNN-T loss (row 8) and ``conv_front`` (row 6) run bf16 on the
tensor cores too: beside their earlier kernels' times they print the
joint backward by pass (rows, weight, sums; profiler), the joint at V 1000
(the small-streaming vocabulary) against its plain version, conv_front's
backward by pass, the accuracy of both against float64, and their
occupancy (against what the shared memory the library reports allows),
registers and spills. After each phase's set-up and warm-up the garbage
collector runs once and freezes the survivors (``gc.freeze``); every
timed step and request records its gen-2 collections, summed in a ``gc
watch`` line. Every kernel must launch on at least one driven path; its
launches are recorded per path. Any failure raises. The last two lines
are the kernels' JSON summary and ``{"ok": true, "device": {...}}``.
Without a card it exits non-zero.

``python3 chip_smoke.py --compare-parent DIR`` runs only the step numbers
(:func:`phase_steps`) of this checkout and of the package under DIR (a
checkout of another commit), each in its own process, in turns.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import json
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

SEED = 0
WARMUP, ITERS = 3, 20
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}  # dense tensor-core bf16; f32 outside the tensor cores


def _need_card() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test runs on a CUDA card", file=sys.stderr)
        sys.exit(2)


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def time_ms(fn, *args) -> float:
    """Mean device time of ``fn(*args)`` over ITERS launches (CUDA events, after
    warm-up). The card first spins for ~50 ms, so that the host has queued all
    ITERS calls before the start event runs: the interval holds the calls'
    device work back to back, not the host's time to issue them."""
    for _ in range(WARMUP):
        fn(*args)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)  # cycles: ~50 ms at the H100's ~2 GHz
    start.record()
    for _ in range(ITERS):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def bound(moved: float, flops: float, kind: str) -> tuple[float, str]:
    """Least time (ms) for the work: the bytes moved (each input read once and
    each output written once) at the memory rate, or the operations at the peak rate."""
    t_bytes, t_ops = moved / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# (bytes, operations) of each kernel's work: each input read once, each output
# written once (weight gradients in f32); products at 2 operations per MAC.
def cost_frontend(b: int, n: int, frames: int, nfft: int, mels: int):
    """A real FFT per frame (2.5·n·log2 n), the power spectrum and the mel product, f32."""
    return 4 * (b * n + b * frames * mels), b * frames * (2.5 * nfft * np.log2(nfft) + 3 * (nfft // 2 + 1) + 2 * (nfft // 2 + 1) * mels)


def cost_attention(bh: int, t: int, s: int, r: int, d: int, elt: int, bwd: bool):
    """fwd: qc, qp, k, v, pos → out; QKᵀ, the rel term and PV. bwd: + out, dout → five grads; 16 products of that size."""
    io = (2 * t + 2 * s + r) * bh * d * elt
    return (2 * io + 2 * bh * t * d * elt, 16 * bh * t * s * d) if bwd else (io + bh * t * d * elt, 6 * bh * t * s * d)


def cost_ff(n: int, d: int, f: int, elt: int, bwd: bool):
    """fwd: x → out, two products. bwd: x, dout → dx and f32 weight grads; five products (h, da, dW2, dW1, dy)."""
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
    """fwd: x, y1 → out, one D×D product. bwd: y1, dout → dy1 and f32 grads; two products (da, dW2)."""
    params = 16 * d + (d * d + d) * elt
    if bwd:
        return 3 * n * d * elt + params + 4 * (5 * d + d * d), 4 * n * d * d
    return 3 * n * d * elt + params, 2 * n * d * d


def cost_rnnt_dp(t_len: np.ndarray, u_len: np.ndarray, t: int, u1: int):
    """lp_blank and lp_emit read over each row's lattice (T_b·(U_b+1) cells),
    gbl, gem [B, T, U+1] and the loss written, f32; per lattice cell two
    log-add-exps (7 operations each) and two gradient exponentials (5 each)."""
    cells = float(np.sum(t_len * (u_len + 1)))
    return 8 * cells + 8 * len(t_len) * t * u1 + 4 * len(t_len), 24 * cells


def cost_joint(b: int, t: int, u1: int, j: int, v: int, elt: int, bwd: bool, active: int | None = None):
    """fwd: enc_p, pred_p, Wv, bv, labels → lse, lp_blank, lp_emit; the vocab
    product, add + tanh per (cell, j), ~3 per logit for the log-sum-exp.
    bwd: + lse, gbl, gem → d_enc_p, d_pred_p and f32 dWv, dbv; three products
    (the logits, da, dWv) and ~5 per logit for d_logits, over the ``active``
    cells only (those with a nonzero gbl or gem: every other cell's d_logits
    is 0, so this run's data needs no work there)."""
    cells = b * t * u1
    params = v * j * elt + 4 * v
    inputs = (b * t + b * u1) * j * elt + params + 4 * b * (u1 - 1)
    if bwd:
        act = cells if active is None else active
        return inputs + 12 * cells + (b * t + b * u1) * j * elt + 4 * (v * j + v), 6.0 * act * j * v + 2.0 * act * j + 5.0 * act * v
    return inputs + 12 * cells, 2.0 * cells * j * v + 2.0 * cells * j + 3.0 * cells * v


def cost_rows(rows: int, v: int, b: int, u: int, elt: int, bwd: bool):
    """The unfused loss's row kernels over [rows, V] logits. fwd: logits and
    labels → lp_blank, lp_emit, lse (f32); ~4 operations per logit (max,
    subtract, exp, add). bwd: + lse, gbl, gem, g → d_logits in the logits'
    dtype; ~6 per logit."""
    if bwd:
        return 2 * rows * v * elt + 12 * rows + 4 * b * u + 4 * b, 6.0 * rows * v
    return rows * v * elt + 4 * b * u + 12 * rows, 4.0 * rows * v


def cost_lstm(b: int, t: int, h: int, elt: int, bwd: bool):
    """The LSTM recurrence. fwd: xg, Wh, h0, c0 → y, cseq, gates; the
    recurrent product (2·B·T·H·4H) and ~10 operations per cell and step.
    bwd: dy, dc (f32), gates, cseq, c0, Wh → dxg (f32), dh0, dc0; the
    product da·Whᵀ and ~20 per cell and step. (The kernels are bound by
    their 2·T dependent steps, not by either count.)"""
    if bwd:
        return 8 * b * t * h + 5 * b * t * h * elt + (b * h + 4 * h * h) * elt + 16 * b * t * h + 8 * b * h, 8.0 * b * t * h * h + 20.0 * b * t * h
    return 4 * b * t * h * elt + 4 * h * h * elt + 2 * b * h * elt + 6 * b * t * h * elt, 8.0 * b * t * h * h + 10.0 * b * t * h


def _close(name: str, got: torch.Tensor, ref: torch.Tensor, atol: float, rtol: float) -> float:
    got, ref = got.float(), ref.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got - ref).abs()
    bad = err > atol + rtol * ref.abs()
    if bad.any():
        raise AssertionError(f"{name}: max abs err {err.max().item()} exceeds atol {atol} + rtol {rtol}·|ref| at {int(bad.sum())} elements")
    return err.max().item()


def _grads_close(name: str, got, ref, rel: float) -> float:
    """Each gradient within ``rel`` of its largest reference magnitude (the
    weight gradients are sums over all rows, where an elementwise relative
    bound fails on the elements that cancel); returns the max abs error."""
    worst = 0.0
    for i, (g, r) in enumerate(zip(got, ref)):
        g, r = g.float(), r.float()
        if not torch.isfinite(g).all():
            raise AssertionError(f"{name} output {i}: non-finite")
        err, scale = (g - r).abs().max().item(), r.abs().max().item()
        if err > rel * max(scale, 1e-6):
            raise AssertionError(f"{name} output {i}: max abs err {err} > {rel} x {scale}")
        worst = max(worst, err)
    return worst


def _randn(gen, shape, scale=1.0, dtype=torch.float32, dev="cuda"):
    return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)


# Tolerances. f32 (TF32 off): kernel and plain differ only in summation
# order (~1e-6 relative), so 1e-4 absolute on unit-scale outputs. bf16: a
# summation-order difference can flip the bf16 rounding of an operand or
# of the output by one ulp (2^-8 relative), so atol 0.02 + rtol 0.02. The
# log-mel frontend is f32 only: direct DFT vs FFT, 1e-3 absolute in log.
# Backward, relative to each gradient's largest magnitude: f32 1e-4; bf16
# 3e-2 (a flipped bf16 rounding of ds/dh/dz propagates into the sums).
TOL = {"f32": (1e-4, 1e-4), "bf16": (2e-2, 2e-2)}
GRAD_REL = {"f32": 1e-4, "bf16": 3e-2}
DTYPES = (("f32", torch.float32), ("bf16", torch.bfloat16))

SOURCES = {
    "log_mel_spectrogram": ("tensorflowasr_tpu_torch/csrc/frontend.cu", "tensorflowasr_tpu/ops/pallas/frontend_kernel.py:80"),
    "fused_rel_attention": ("tensorflowasr_tpu_torch/csrc/rel_attention_mma.cu", "tensorflowasr_tpu/ops/pallas/attention_kernel.py:453"),
    "fused_rel_attention_bwd": ("tensorflowasr_tpu_torch/csrc/rel_attention_mma.cu", "tensorflowasr_tpu/ops/pallas/attention_kernel.py:588"),
    "fused_ff": ("tensorflowasr_tpu_torch/csrc/ff_mma.cu", "tensorflowasr_tpu/ops/pallas/ff_kernel.py:189"),
    "fused_ff_bwd": ("tensorflowasr_tpu_torch/csrc/ff_mma.cu", "tensorflowasr_tpu/ops/pallas/ff_kernel.py:229"),
    "conv_front": ("tensorflowasr_tpu_torch/csrc/conv_mma.cu", "tensorflowasr_tpu/ops/pallas/conv_kernel.py:160"),
    "conv_front_bwd": ("tensorflowasr_tpu_torch/csrc/conv_mma.cu", "tensorflowasr_tpu/ops/pallas/conv_kernel.py:194"),
    "conv_back": ("tensorflowasr_tpu_torch/csrc/conv_module.cu", "tensorflowasr_tpu/ops/pallas/conv_kernel.py:329"),
    "conv_back_bwd": ("tensorflowasr_tpu_torch/csrc/conv_module.cu", "tensorflowasr_tpu/ops/pallas/conv_kernel.py:375"),
    "rnnt_dp": ("tensorflowasr_tpu_torch/csrc/rnnt_dp.cu", "tensorflowasr_tpu/ops/pallas/rnnt_kernel.py:310"),
    "rnnt_fused_joint": ("tensorflowasr_tpu_torch/csrc/joint_loss_mma.cu", "tensorflowasr_tpu/ops/pallas/joint_loss_kernel.py:351"),
    "rnnt_fused_joint_bwd": ("tensorflowasr_tpu_torch/csrc/joint_loss_mma.cu", "tensorflowasr_tpu/ops/pallas/joint_loss_kernel.py:329"),
    "rnnt_logprobs": ("tensorflowasr_tpu_torch/csrc/rnnt_rows.cu", "tensorflowasr_tpu/ops/pallas/rnnt_kernel.py:413"),
    "rnnt_dlogits": ("tensorflowasr_tpu_torch/csrc/rnnt_rows.cu", "tensorflowasr_tpu/ops/pallas/rnnt_kernel.py:438"),
    "lstm": ("tensorflowasr_tpu_torch/csrc/lstm.cu", "tensorflowasr_tpu/ops/pallas/lstm_kernel.py:178"),
    "lstm_bwd": ("tensorflowasr_tpu_torch/csrc/lstm.cu", "tensorflowasr_tpu/ops/pallas/lstm_kernel.py:237"),
    "ctc_loss": ("tensorflowasr_tpu_torch/csrc/ctc.cu", "tensorflowasr_tpu/ops/pallas/ctc_kernel.py:242"),
    "fused_attention": ("tensorflowasr_tpu_torch/csrc/attention.cu", "tensorflowasr_tpu/ops/pallas/attention_kernel.py:175"),
    "fused_attention_bwd": ("tensorflowasr_tpu_torch/csrc/attention.cu", "tensorflowasr_tpu/ops/pallas/attention_kernel.py:242"),
    "fused_decode": ("tensorflowasr_tpu_torch/csrc/decode.cu", "scripts_dev/decode_kernel.py:435"),
}


def phase_kernels(dev) -> dict:
    """Forward kernels at the serving shapes (batch 8 × 10 s): (max err f32, max err bf16, ms, plain ms) by name."""
    from tensorflowasr_tpu_torch.ops import frontend
    from tensorflowasr_tpu_torch.ops.cuda import attention_kernel as ak
    from tensorflowasr_tpu_torch.ops.cuda import conv_kernel as ck
    from tensorflowasr_tpu_torch.ops.cuda import ff_kernel as fk
    from tensorflowasr_tpu_torch.ops.cuda import frontend_kernel as fek

    gen = torch.Generator(device=dev).manual_seed(SEED)
    res = {}

    # frontend: B=8 utterances of 10 s at 16 kHz
    cfg = frontend.FrontendConfig()
    sig = frontend.preemphasis_signal(_randn(gen, (8, 160000), 0.1), cfg).contiguous()
    err = _close("frontend f32", fek.log_mel_spectrogram_pallas(sig, cfg), fek.log_mel_spectrogram_plain(sig, cfg), 1e-3, 0.0)
    ms, plain_ms = time_ms(fek.log_mel_spectrogram_pallas, sig, cfg), time_ms(fek.log_mel_spectrogram_plain, sig, cfg)
    b = bound(*cost_frontend(8, 160000, cfg.get_nframes(160000), cfg.fft_length, cfg.num_feature_bins), "f32")
    print(f"kernel frontend (serve): [8, 160000] f32 max_abs_err {err:.3e} (tol 1e-3) kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
          f"bound {b[0]:.4f} ms ({b[1]})")
    res["log_mel_spectrogram"] = (err, None, ms, plain_ms)

    # attention: B·H = 32, T = S = 250, R = 499, dh = 36; q_len < T on some rows
    b, h, t, d = 8, 4, 250, 36
    q_len = torch.tensor([250, 250, 240, 200, 180, 150, 250, 160], dtype=torch.int32, device=dev)
    cases = {
        "flagship": dict(s=t, r=2 * t - 1, kv_bias=None, chunk=None, hist=None),
        "chunked": dict(s=t + 64, r=64 + 2 * t - 1, kv_bias=True, chunk=16, hist=64),
    }
    att = {}
    for case, c in cases.items():
        for tag, dt in DTYPES:
            qc, qp = _randn(gen, (b * h, t, d), 0.3, dt), _randn(gen, (b * h, t, d), 0.3, dt)
            k, v = _randn(gen, (b * h, c["s"], d), 1.0, dt), _randn(gen, (b * h, c["s"], d), 1.0, dt)
            pos = _randn(gen, (b * h, c["r"], d), 1.0, dt)
            kvb = None
            if c["kv_bias"]:
                mem_valid = torch.arange(c["s"], device=dev)[None, :] >= torch.tensor([0, 10, 30, 64, 0, 5, 64, 20], device=dev)[:, None]
                kvb = torch.where(mem_valid, 0.0, -1e9).float()[:, None, :].contiguous()
            args = (qc, qp, k, v, pos, kvb, q_len, 0, 0.0, False, c["chunk"], c["hist"], False)
            err = _close(f"attention {case} {tag}", ak.fused_rel_attention(*args), ak.fused_rel_attention_plain(*args), *TOL[tag])
            ms, plain_ms = time_ms(ak.fused_rel_attention, *args), time_ms(ak.fused_rel_attention_plain, *args)
            bd = bound(*cost_attention(b * h, t, c["s"], c["r"], d, qc.element_size(), False), tag)
            print(f"kernel rel_attention {case} {tag} (serve): BH {b*h} T {t} S {c['s']} R {c['r']} dh {d} max_abs_err {err:.3e} (tol {TOL[tag]}) "
                  f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound {bd[0]:.4f} ms ({bd[1]})")
            att[(case, tag)] = (err, ms, plain_ms)
    res["fused_rel_attention"] = (att[("flagship", "f32")][0], att[("flagship", "bf16")][0], *att[("flagship", "bf16")][1:])

    # FF: N = 8·250 rows, 144 → 576 → 144
    n, dm, f = 8 * 250, 144, 576
    ff = {}
    for tag, dt in DTYPES:
        x = _randn(gen, (n, dm), 1.0, dt)
        gamma, beta = 1.0 + _randn(gen, (dm,), 0.1), _randn(gen, (dm,), 0.1)
        w1, b1 = _randn(gen, (dm, f), dm ** -0.5, dt), _randn(gen, (f,), 0.1, dt)
        w2, b2 = _randn(gen, (f, dm), f ** -0.5, dt), _randn(gen, (dm,), 0.1, dt)
        args = (x, gamma, beta, w1, b1, w2, b2, 0, 0.0, 0.5, 1e-3)
        err = _close(f"ff {tag}", fk.fused_ff(*args), fk.fused_ff_plain(*args), *TOL[tag])
        ff[tag] = (err, time_ms(fk.fused_ff, *args), time_ms(fk.fused_ff_plain, *args))
        bd = bound(*cost_ff(n, dm, f, x.element_size(), False), tag)
        print(f"kernel fused_ff {tag} (serve): N {n} D {dm} F {f} max_abs_err {err:.3e} (tol {TOL[tag]}) kernel {ff[tag][1]:.4f} ms plain {ff[tag][2]:.4f} ms "
              f"bound {bd[0]:.4f} ms ({bd[1]})")
        if tag == "bf16":
            ff_row_tiles(args, "serve")
    res["fused_ff"] = (ff["f32"][0], ff["bf16"][0], *ff["bf16"][1:])

    # conv module halves: [8, 250, 144]
    front, back = {}, {}
    for tag, dt in DTYPES:
        x = _randn(gen, (8, 250, dm), 1.0, dt)
        gamma, beta = 1.0 + _randn(gen, (dm,), 0.1), _randn(gen, (dm,), 0.1)
        wa, wb = _randn(gen, (dm, dm), dm ** -0.5, dt), _randn(gen, (dm, dm), dm ** -0.5, dt)
        ba, bb = _randn(gen, (dm,), 0.1, dt), _randn(gen, (dm,), 0.1, dt)
        args = (x, gamma, beta, wa, ba, wb, bb, 1e-3)
        err = _close(f"conv_front {tag}", ck.conv_front(*args), ck.conv_front_plain(*args), *TOL[tag])
        front[tag] = (err, time_ms(ck.conv_front, *args), time_ms(ck.conv_front_plain, *args))
        y1 = _randn(gen, (8, 250, dm), 1.0, dt)
        mean, var = _randn(gen, (dm,), 0.1), 1.0 + torch.rand((dm,), generator=gen, device=dev)
        scale, bias = 1.0 + _randn(gen, (dm,), 0.1), _randn(gen, (dm,), 0.1)
        w2, b2 = _randn(gen, (dm, dm), dm ** -0.5, dt), _randn(gen, (dm,), 0.1, dt)
        args = (x, y1, mean, var, scale, bias, w2, b2, 0, 0.0, 1.0, 1e-3)
        err = _close(f"conv_back {tag}", ck.conv_back(*args), ck.conv_back_plain(*args), *TOL[tag])
        back[tag] = (err, time_ms(ck.conv_back, *args), time_ms(ck.conv_back_plain, *args))
        bf, bb_ = bound(*cost_conv_front(2000, dm, x.element_size(), False), tag), bound(*cost_conv_back(2000, dm, x.element_size(), False), tag)
        print(f"kernel conv_front {tag} (serve): [8, 250, {dm}] max_abs_err {front[tag][0]:.3e} kernel {front[tag][1]:.4f} ms plain {front[tag][2]:.4f} ms "
              f"bound {bf[0]:.4f} ms ({bf[1]})" + (f" (the earlier CUDA-core kernel, PERF.md row 6: {EARLIER_MS[('conv_front', 'serve')][0]:.4f} ms)"
                                                  if tag == "bf16" else "") + f"; conv_back {tag}: max_abs_err {back[tag][0]:.3e} kernel {back[tag][1]:.4f} ms plain {back[tag][2]:.4f} ms "
              f"bound {bb_[0]:.4f} ms ({bb_[1]}) (tol {TOL[tag]})")
    res["conv_front"] = (front["f32"][0], front["bf16"][0], *front["bf16"][1:])
    res["conv_back"] = (back["f32"][0], back["bf16"][0], *back["bf16"][1:])
    return res


# ---------------------------------- training shapes ---------------------------------- #

# the flagship train step: 16 utterances, array width 16 s → 1600 frames → T = 400 encoder frames
TRAIN_B, TRAIN_SECS, TRAIN_U = 16, 16.0, 128
T_ENC, D_MODEL, HEADS, HEAD, FF_DIM = 400, 144, 4, 36, 576
JOINT, VOCAB = 320, 256
TRAIN_RATE = 0.1


def _row(name: str, errs: dict, ms: float, plain_ms: float, b: tuple[float, str]) -> dict:
    src, replaces = SOURCES[name]
    return dict(name=name, route="cuda", source=src, replaces=replaces, launches=0, max_abs_err=errs["f32"], max_abs_err_bf16=errs.get("bf16"),
                ms=ms, plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1], library_ms=None, dtype="bfloat16" if "bf16" in errs else "float32")


def _check_fwd_bwd(name, fwd, fwd_plain, bwd, bwd_plain, make, cost, what: str = f"train, rate {TRAIN_RATE}", bwd_name: str | None = None,
                   fwd_tol: dict = TOL) -> list[dict]:
    """Forward (rate 0.1: the kernel's mask equals the plain one) and backward
    kernel vs plain at one shape, f32 and bf16; times and bounds in bf16.
    ``cost(elt, bwd)`` gives the (bytes, operations) of the work; the
    backward's row is ``bwd_name`` (default ``name + "_bwd"``)."""
    errs_f, errs_b, times = {}, {}, {}
    for tag, dt in DTYPES:
        fargs, bargs = make(dt)
        errs_f[tag] = _close(f"{name} fwd {tag} ({what})", fwd(*fargs), fwd_plain(*fargs), *fwd_tol[tag])
        errs_b[tag] = _grads_close(f"{name} bwd {tag} ({what})", bwd(*bargs), bwd_plain(*bargs), GRAD_REL[tag])
        if tag == "bf16":
            times = dict(fwd=(time_ms(fwd, *fargs), time_ms(fwd_plain, *fargs)), bwd=(time_ms(bwd, *bargs), time_ms(bwd_plain, *bargs)))
            bounds = dict(fwd=bound(*cost(2, False), "bf16"), bwd=bound(*cost(2, True), "bf16"))
    rows = []
    for part, errs, row_name in (("fwd", errs_f, name), ("bwd", errs_b, bwd_name or f"{name}_bwd")):
        ms, plain_ms = times[part]
        b = bounds[part]
        print(f"kernel {row_name} ({what}): max_abs_err f32 {errs['f32']:.3e} bf16 {errs['bf16']:.3e} "
              f"(tol {fwd_tol if part == 'fwd' else GRAD_REL}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound {b[0]:.4f} ms ({b[1]}) bf16")
        rows.append(_row(row_name, errs, ms, plain_ms, b))
    return rows


# the kernels rows 3, 5, 6 and 8 had before their tensor-core redesign (PERF.md §6: bf16, rate 0.1, forward and backward ms), by width; printed
# beside this run's times, never written to the kernels' JSON line
EARLIER_MS = {("fused_rel_attention", 36): (0.5629, 1.7223), ("fused_rel_attention", 44): (0.7083, 2.0996), ("fused_ff", 144): (0.1133, 1.5137),
              ("fused_ff", 176): (0.1509, 3.0285), ("conv_front", 144): (0.1326, 0.4727), ("conv_front", 176): (0.1722, 0.7880),
              ("conv_front", "serve"): (0.0587, None), ("rnnt_fused_joint", 320): (2.8144, 17.4508)}


def rate0_times(rows: list[dict], make, fwd, bwd, what: str, width: int) -> None:
    """The bf16 forward and backward at rate 0 on fresh inputs, beside the rate-0.1 times of ``rows`` and the earlier kernels' times."""
    fargs, bargs = make()
    ms_f, ms_b = time_ms(fwd, *fargs), time_ms(bwd, *bargs)
    rows[0]["ms_rate0"], rows[1]["ms_rate0"] = ms_f, ms_b
    old = EARLIER_MS.get((rows[0]["name"], width))
    print(f"kernel {rows[0]['name']}[_bwd] bf16 ({what}): rate 0.1 forward {rows[0]['ms']:.4f} ms backward {rows[1]['ms']:.4f} ms; rate 0 forward "
          f"{ms_f:.4f} ms backward {ms_b:.4f} ms; plain {rows[0]['plain_ms']:.4f} / {rows[1]['plain_ms']:.4f} ms; bound {rows[0]['bound_ms']:.4f} / "
          f"{rows[1]['bound_ms']:.4f} ms" + (f"; the earlier CUDA-core kernels (PERF.md, rate 0.1) {old[0]:.4f} / {old[1]:.4f} ms" if old else ""))


def accuracy_parts(names, kern, plain, refs, steps: bool = True) -> str:
    """Per output: where kernel and plain differ (and, for bf16 results, by
    more than one final rounding), and each one's distance to the float64
    reference (max and rms)."""
    parts = []
    for name, g, p, r in zip(names, kern, plain, refs):
        g, p, r = g.float(), p.float(), r.detach()
        diff = (g - p).abs()
        head = f"{name}: {100.0 * (diff > 0).float().mean().item():.3f}% of elements differ"
        if steps:
            over = diff > bf16_spacing(torch.maximum(g.abs(), p.abs()))  # more than one final rounding apart
            head += (f", {100.0 * over.float().mean().item():.3f}% by more than one bf16 step (largest such |result| "
                     f"{torch.maximum(g.abs(), p.abs())[over].max().item() if over.any() else 0.0:.3g})")
        parts.append(f"{head}; max abs diff {diff.max().item():.3e} (|result| <= {r.abs().max().item():.3g}); vs float64 max abs err kernel "
                     f"{(g.double() - r).abs().max().item():.3e} plain {(p.double() - r).abs().max().item():.3e}, rms kernel "
                     f"{(g.double() - r).pow(2).mean().sqrt().item():.3e} plain {(p.double() - r).pow(2).mean().sqrt().item():.3e}")
    return "; ".join(parts)


def rel_attention_accuracy(fargs: tuple, bargs: tuple, what: str) -> None:
    """Kernel B in bf16 against its plain version, and both against a float64
    run of the same function on the same inputs, masks and keep mask (the
    scores pass through f32 as the function defines them)."""
    from tensorflowasr_tpu_torch.ops.cuda import attention_kernel as ak

    qc, qp, k, v, pos, kvb, ql, seed, rate, causal, chunk, hist, pe_causal = fargs
    out, stats, dout = bargs[7], bargs[8], bargs[9]
    bh, t, _ = qc.shape
    s, r = k.shape[1], pos.shape[1]
    zero = torch.zeros_like(qc)
    add, idx = ak._scores(zero, zero, k, pos, kvb, ql, causal, chunk, hist, pe_causal)  # the mask terms alone (content and rel 0)
    keep = ak.dropout_mask(seed, bh, t, s, rate, qc.device).double() if rate > 0 else 1.0
    x64 = [x.double().requires_grad_(True) for x in (qc, qp, k, v, pos)]
    rel = torch.gather(x64[1] @ x64[4].transpose(1, 2), 2, idx.clamp(max=r - 1).expand(bh, t, s)) * (idx < r)
    scores = (x64[0] @ x64[2].transpose(1, 2) + rel + add.double()).float().double()
    ref = (torch.softmax(scores, dim=-1) * keep) @ x64[3]
    refs = (ref, *torch.autograd.grad(ref, x64, dout.double()))
    kern = (ak.fused_rel_attention_kernel(*fargs), *ak.fused_rel_attention_bwd_kernel(*fargs[:7], out, dout, *fargs[7:], stats=stats))
    plain = (ak.fused_rel_attention_plain(*fargs), *ak.fused_rel_attention_plain_bwd(*fargs[:7], dout, *fargs[7:]))
    print(f"kernel fused_rel_attention bf16 accuracy ({what}, BH {bh} T {t} S {s} R {r} head {qc.shape[2]}): "
          + accuracy_parts(("out", "dqc", "dqp", "dk", "dv", "dpos"), kern, plain, refs))


def ff_accuracy(fargs: tuple, bargs: tuple, what: str) -> None:
    """The fused FF in bf16: kernel and plain version against float64 (the
    parameter gradients before their final cast, so that the weight
    gradients' bf16 high/low split shows against the plain f32 products)."""
    from tensorflowasr_tpu_torch.ops.cuda import ff_kernel as fk

    x, gamma, beta, w1, b1, w2, b2, seed, rate, factor, eps = fargs
    dout = bargs[6]
    keep1, keep2 = fk._masks(seed, rate, x.shape[0], x.shape[1], w1.shape[1], x.device)
    p64 = [a.double().requires_grad_(True) for a in (x, gamma, beta, w1, b1, w2, b2)]
    xx, g, bb, W1, B1, W2, B2 = p64
    cx = xx - xx.mean(dim=-1, keepdim=True)
    y = cx * torch.rsqrt((cx * cx).mean(dim=-1, keepdim=True) + eps) * g + bb
    h = y @ W1 + B1
    a = h * torch.sigmoid(h)
    z = (a if keep1 is None else a * keep1.double()) @ W2 + B2
    ref = xx + factor * (z if keep2 is None else z * keep2.double())
    refs = torch.autograd.grad(ref, p64, dout.double())
    kern = fk.fused_ff_bwd_kernel_f32(*bargs)
    plain = fk.fused_ff_plain_bwd_f32(*bargs)
    plain = (plain[0].to(x.dtype), *plain[1:])  # dx leaves both in x's dtype
    print(f"kernel fused_ff_bwd bf16 accuracy ({what}, N {x.shape[0]} D {x.shape[1]} F {w1.shape[1]}; dx in bf16, the rest f32): "
          + accuracy_parts(("dx",), kern[:1], plain[:1], refs[:1]) + "; "
          + accuracy_parts(("dgamma", "dbeta", "dW1", "db1", "dW2", "db2"), kern[1:], plain[1:], refs[1:], steps=False))


def ptxas_usage(log: str) -> dict:
    """Registers and spill bytes of each kernel in an ``nvcc -Xptxas -v`` log, by mangled name."""
    usage, cur = {}, None
    for line in log.splitlines():
        if "Function properties for " in line:
            cur = line.split("Function properties for ")[1].strip()
            usage[cur] = {}
        elif cur and "spill stores" in line:
            parts = line.replace(",", "").split()
            usage[cur]["spill_stores"], usage[cur]["spill_loads"] = int(parts[4]), int(parts[8])
        elif cur and "Used " in line and " registers" in line:
            usage[cur]["registers"] = int(line.split("Used ")[1].split()[0])
    return usage


def mma_occupancy(rows: list[dict], d_model: int, head: int, ff_dim: int, n: int) -> None:
    """For the tensor-core kernels of rows 3 and 5 at these widths (the FF
    forward at the row tile it takes for N rows): blocks per SM on this card
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor), which must be at least 1
    and at most the shared-memory plan's (whose byte counts must equal the
    kernels'); and their registers and spills from ptxas when this process
    ran the build (a cached library has no log of it)."""
    from tensorflowasr_tpu_torch.ops.cuda import _build
    from tensorflowasr_tpu_torch.ops.cuda import attention_kernel as ak
    from tensorflowasr_tpu_torch.ops.cuda import ff_kernel as fk

    lib = _build.build()
    fwd_rows = fk.ff_fwd_rows(n, fk.one_wave_blocks(0, d_model))
    ffp, relp = fk.ff_mma_plan(d_model, ff_dim, fwd_rows), ak.rel_mma_plan(head)
    dmax = next(m for m in (64, 128, 160, 192, 256) if ffp.padded_d <= m)
    kernels = {}  # name: (row index, mangled-name fragment, smem by the kernel, smem by the plan, plan's blocks per SM, card's blocks per SM)
    for which, name in enumerate(("fwd", "dq", "dkv", "dpos")):
        kernels[f"rel_mma_{name}"] = (min(which, 1), f"rel_mma_{name}ILi64", lib.tfasr_rel_mma_smem(head, which), relp[name]["smem_bytes"],
                                      relp[name]["blocks_per_sm"], lib.tfasr_rel_mma_occupancy(head, which))
    kernels[f"ff_mma_fwd ({fwd_rows} rows)"] = (2, f"ff_mma_fwdILi{dmax}ELi{fwd_rows // 16}ELi{128 // fwd_rows}E", lib.tfasr_ff_mma_smem(d_model, fwd_rows),
                                                ffp.fwd_smem_bytes, ffp.fwd_blocks_per_sm, lib.tfasr_ff_mma_occupancy(d_model, fwd_rows))
    kernels["ff_mma_bwd_rows"] = (3, f"ff_mma_bwd_rowsILi{dmax}", lib.tfasr_ff_mma_smem(d_model, 0), ffp.bwd_smem_bytes, ffp.bwd_blocks_per_sm,
                                  lib.tfasr_ff_mma_occupancy(d_model, 0))
    kernels["ff_mma_atb"] = (3, "ff_mma_atb", None, None, None, None)  # static shared memory, no plan
    occupancy_report(rows, kernels, f"D {d_model} F {ff_dim}, head {head}, FF rows N {n}")


def occupancy_report(rows: list[dict], kernels: dict, what: str) -> None:
    """For each kernel (name: (row index, mangled-name fragment, shared memory
    by the kernel, by the plan, the plan's blocks per SM, the card's)): the
    kernel's shared memory must equal the plan's and the card's blocks per
    SM lie in [1, plan]; registers and spills from this process's ptxas log
    when it ran the build. Recorded under ``mma`` on the kernel's row."""
    from tensorflowasr_tpu_torch.ops.cuda import _build

    usage = ptxas_usage(_build.build_log)
    parts = []
    for name, (i, frag, smem, plan_smem, plan_blocks, blocks) in kernels.items():
        if smem != plan_smem:
            raise AssertionError(f"{name}: the kernel takes {smem} bytes of shared memory, the plan {plan_smem}")
        if blocks is not None and not 1 <= blocks <= plan_blocks:
            raise AssertionError(f"{name}: the card runs {blocks} blocks per SM, the plan allows {plan_blocks}")
        use = next((u for m, u in usage.items() if frag in m), {}) if usage else {}
        if usage and not use:
            raise AssertionError(f"{name}: no ptxas record of {frag} in this build's log")
        info = dict(use)
        if blocks is not None:
            info.update(smem_bytes=smem, blocks_per_sm=blocks)
        rows[i].setdefault("mma", {})[name] = info
        parts.append(f"{name}" + (f" {smem} B smem, {blocks} blocks/SM (plan {plan_blocks})" if blocks is not None else "")
                     + (f", {use.get('registers')} registers, {use.get('spill_stores')}/{use.get('spill_loads')} B spilled" if use
                        else ", registers not read (the library was built by another process)"))
    print(f"kernel occupancy ({what}): " + "; ".join(parts))


def ff_row_tiles(args: tuple, what: str) -> dict:
    """The bf16 FF forward at each row tile on the same inputs: each against
    the plain version (TOL), and its time; returns ms by rows and the tile
    ``ff_fwd_rows`` picks for this N on this card."""
    from tensorflowasr_tpu_torch.ops.cuda import ff_kernel as fk

    plain = fk.fused_ff_plain(*args)
    ms = {}
    for rows in fk.FWD_ROWS:
        _close(f"ff bf16 forward, {rows} rows a block ({what})", fk.fused_ff_kernel(*args, rows=rows), plain, *TOL["bf16"])
        ms[rows] = time_ms(lambda *a: fk.fused_ff_kernel(*a, rows=rows), *args)
    chosen = fk.ff_fwd_rows(args[0].shape[0], fk.one_wave_blocks(0, args[0].shape[1]))
    print(f"kernel fused_ff bf16 forward by row tile ({what}, N {args[0].shape[0]} D {args[0].shape[1]} F {args[3].shape[1]}): "
          + ", ".join(f"{rows} rows {t:.4f} ms ({-(-args[0].shape[0] // rows)} blocks)" for rows, t in ms.items()) + f"; ff_fwd_rows takes {chosen}")
    return dict(chosen=chosen, ms_by_rows={str(r): t for r, t in ms.items()})


def device_ms_by_kernel(fn, args: tuple, groups: dict) -> dict:
    """Device ms per call of the kernels ``fn(*args)`` launches, summed by
    group (name: a fragment of the kernel's name; "all": every kernel), from
    the profiler over ITERS calls after warm-up; a group it did not see is None."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(WARMUP):
        fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(ITERS):
            fn(*args)
        torch.cuda.synchronize()
    out = {g: None for g in (*groups, "all")}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or e.is_user_annotation:
            continue
        for g, frag in (*groups.items(), ("all", "")):
            if frag in e.key:
                out[g] = (out[g] or 0.0) + e.self_device_time_total / 1e3 / ITERS
    return out


def _fmt_ms(d: dict) -> str:
    return ", ".join(f"{k} {'not measured' if v is None else f'{v:.4f} ms'}" for k, v in d.items())


def conv_front_accuracy(fargs: tuple, bargs: tuple, what: str) -> None:
    """conv_front's bf16 backward: kernel and plain version against a float64
    run of the same function on the same inputs (the parameter gradients
    before their final cast, so that the weight gradients' bf16 high/low
    split shows against the plain f32 products)."""
    from tensorflowasr_tpu_torch.ops.cuda import conv_kernel as ck

    x, eps, dout = fargs[0], fargs[7], bargs[7]
    p64 = [a.double().requires_grad_(True) for a in fargs[:7]]
    xx, g, bt, wa, ba, wb, bb = p64
    cx = xx - xx.mean(dim=-1, keepdim=True)
    y = cx * torch.rsqrt((cx * cx).mean(dim=-1, keepdim=True) + eps) * g + bt
    ref = (y @ wa + ba) * torch.sigmoid(y @ wb + bb)
    refs = torch.autograd.grad(ref, p64, dout.double())
    kern = ck.conv_front_bwd_kernel_f32(*bargs)
    plain = ck.conv_front_plain_bwd_f32(*bargs)
    plain = (plain[0].to(x.dtype), *plain[1:])  # dx leaves both in x's dtype
    print(f"kernel conv_front_bwd bf16 accuracy ({what}, N {x.shape[0] * x.shape[1]} D {x.shape[2]}; dx in bf16, the rest f32): "
          + accuracy_parts(("dx",), kern[:1], plain[:1], refs[:1]) + "; "
          + accuracy_parts(("dgamma", "dbeta", "dWa", "dba", "dWb", "dbb"), kern[1:], plain[1:], refs[1:], steps=False))


def smem_blocks_per_sm(smem: int, threads: int = 256) -> int:
    """Blocks per SM of the H100 SXM (228 KB of shared memory, 1 KB reserved a block, 2048 threads) as a kernel's shared memory and threads allow."""
    return min(228 * 1024 // (smem + 1024), 2048 // threads)


def conv_front_extras(make, rows: list[dict], d_model: int, n: int, what: str) -> None:
    """conv_front in bf16 on the tensor cores: this run's times beside the
    earlier CUDA-core kernels', the backward by pass, the backward against
    float64, and the two kernels' occupancy (against what their shared
    memory, as the library reports it, allows), registers and spills."""
    from tensorflowasr_tpu_torch.ops.cuda import _build
    from tensorflowasr_tpu_torch.ops.cuda import conv_kernel as ck

    fargs, bargs = make(torch.bfloat16)
    old = EARLIER_MS.get(("conv_front", d_model))
    passes = device_ms_by_kernel(ck.conv_front_bwd_kernel, bargs, {"rows": "cm_bwd_rows", "weight": "ff_mma_atb", "sums": "sum_partials"})
    rows[1]["passes_ms"] = passes
    print(f"kernel conv_front[_bwd] bf16 ({what}): forward {rows[0]['ms']:.4f} ms backward {rows[1]['ms']:.4f} ms (by pass, profiler: "
          f"{_fmt_ms(passes)}); plain {rows[0]['plain_ms']:.4f} / {rows[1]['plain_ms']:.4f} ms; bound {rows[0]['bound_ms']:.4f} / {rows[1]['bound_ms']:.4f} ms"
          + (f"; the earlier CUDA-core kernels (PERF.md row 6) {old[0]:.4f} / {old[1]:.4f} ms" if old else ""))
    conv_front_accuracy(fargs, bargs, what)
    lib = _build.build()
    dmax = next(m for m in (64, 128, 160, 192, 256) if -(-d_model // 16) * 16 <= m)
    kernels = {}
    for which, name, frag in ((0, "cm_fwd (32 rows)", "cm_fwdE"), (1, "cm_bwd_rows", f"cm_bwd_rowsILi{dmax}E")):
        smem = lib.tfasr_conv_mma_smem(d_model, which)
        kernels[name] = (which, frag, smem, smem, smem_blocks_per_sm(smem), lib.tfasr_conv_mma_occupancy(d_model, which))
    occupancy_report(rows, kernels, f"conv_front D {d_model}, N {n}")


def joint_accuracy(fargs: tuple, bargs: tuple, what: str) -> None:
    """The fused joint in bf16: kernel and plain version against a float64
    run of the same function on the same inputs (a = tanh(enc_p + pred_p)
    unrounded, its own lse; the backward from the same gbl, gem), the
    gradients before their final cast; per utterance to bound the float64
    memory."""
    from tensorflowasr_tpu_torch.ops.cuda import joint_loss_kernel as jk
    from tensorflowasr_tpu_torch.ops.rnnt_loss import labels_per_cell

    enc_p, pred_p, wv, bv, labels = fargs
    gbl, gem = bargs[6], bargs[7]
    b, t, j = enc_p.shape
    u1, v = pred_p.shape[1], wv.shape[0]
    w64, bv64 = wv.double(), bv.double()
    lab = labels_per_cell(labels, u1)
    f64 = dict(dtype=torch.float64, device=enc_p.device)
    lse, lpb, lpe = (torch.empty((b, t, u1), **f64) for _ in range(3))
    denc, dpred, dwv, dbv = torch.empty((b, t, j), **f64), torch.empty((b, u1, j), **f64), torch.zeros((v, j), **f64), torch.zeros(v, **f64)
    vid = torch.arange(v, device=enc_p.device)
    for i in range(b):
        a = torch.tanh(enc_p[i].double()[:, None, :] + pred_p[i].double()[None, :, :])
        lg = a @ w64.t() + bv64
        lse[i] = torch.logsumexp(lg, -1)
        lpb[i] = lg[..., 0] - lse[i]
        lpe[i] = torch.gather(lg, 2, lab[i].clamp(min=0)[None, :, None].expand(t, u1, 1))[..., 0] - lse[i]
        gb, ge = gbl[i].double()[..., None], gem[i].double()[..., None]
        dlog = (vid == 0) * gb + (vid == lab[i][None, :, None]) * ge - torch.exp(lg - lse[i][..., None]) * (gb + ge)
        dwv += dlog.reshape(-1, v).t() @ a.reshape(-1, j)
        dbv += dlog.sum((0, 1))
        dz = (dlog @ w64) * (1.0 - a * a)
        denc[i], dpred[i] = dz.sum(1), dz.sum(0)
    kern, plain = jk.joint_logprobs_kernel(*fargs), jk.joint_logprobs_plain(*fargs)
    rows = lambda x: (x[2], x[0], x[1][..., : u1 - 1])  # lse, lp_blank, lp_emit where a label is left
    print(f"kernel rnnt_fused_joint bf16 accuracy ({what}): " + accuracy_parts(("lse", "lp_blank", "lp_emit"), rows(kern), rows(plain),
                                                                                (lse, lpb, lpe[..., : u1 - 1]), steps=False))
    kern_g, plain_g = jk.rnnt_loss_fused_joint_bwd_kernel_f32(*bargs), jk.rnnt_loss_fused_joint_plain_bwd_f32(*bargs)
    print(f"kernel rnnt_fused_joint_bwd bf16 accuracy ({what}, f32 gradients): "
          + accuracy_parts(("d_enc_p", "d_pred_p", "dWv", "dbv"), kern_g, plain_g, (denc, dpred, dwv, dbv), steps=False))


def joint_extras(make, rows: list[dict], active: int, cells: int, dev) -> None:
    """The fused joint in bf16 on the tensor cores: this run's times beside
    the earlier kernels', the backward by pass, accuracy against float64,
    V 1000 (the small-streaming config's vocabulary) against the plain
    version, and the four kernels' occupancy (against what their shared
    memory, as the library reports it, allows), registers and spills."""
    from tensorflowasr_tpu_torch.ops.cuda import _build
    from tensorflowasr_tpu_torch.ops.cuda import joint_loss_kernel as jk

    fargs, bargs = make(torch.bfloat16)
    old = EARLIER_MS[("rnnt_fused_joint", JOINT)]
    passes = device_ms_by_kernel(jk.rnnt_loss_fused_joint_bwd_kernel, bargs, {"rows": "jm_bwd_rows", "weight": "jm_bwd_weight", "sums": "sum_partials"})
    rows[1].update(passes_ms=passes, active_cells=active, cells=cells)
    print(f"kernel rnnt_fused_joint[_bwd] bf16 (train loss): forward {rows[0]['ms']:.4f} ms backward {rows[1]['ms']:.4f} ms (by pass, profiler: "
          f"{_fmt_ms(passes)}); {active} of {cells} cells have a nonzero gbl or gem "
          f"(the backward's bound counts those); plain {rows[0]['plain_ms']:.4f} / {rows[1]['plain_ms']:.4f} ms; bound {rows[0]['bound_ms']:.4f} / "
          f"{rows[1]['bound_ms']:.4f} ms; the earlier WMMA kernels (PERF.md row 8) {old[0]:.4f} / {old[1]:.4f} ms")
    joint_accuracy(fargs, bargs, f"train loss, [{TRAIN_B}, {T_ENC}, {TRAIN_U + 1}] cells, J {JOINT}, V {VOCAB}")

    # V 1000: the small-streaming config's vocabulary (Wv 640 KB streams through shared memory)
    b, v = 4, 1000
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    t_np, u_np = loss_lengths(np.random.default_rng(SEED + 3), b)
    t_len, u_len = torch.tensor(t_np, device=dev), torch.tensor(u_np, device=dev)
    labels = torch.randint(1, v, (b, TRAIN_U), generator=gen, device=dev)
    labels[torch.arange(TRAIN_U, device=dev)[None, :] >= u_len[:, None]] = 0
    res = {}
    for tag, dt in DTYPES:
        enc_p, pred_p = _randn(gen, (b, T_ENC, JOINT), 1.0, dt), _randn(gen, (b, TRAIN_U + 1, JOINT), 1.0, dt)
        wv, bv = _randn(gen, (v, JOINT), JOINT ** -0.5, dt), _randn(gen, (v,), 0.1)
        fa = (enc_p, pred_p, wv, bv, labels)
        _, lse, gbl, gem = jk.rnnt_loss_fused_joint_plain(*fa[:4], t_len, labels, u_len)
        ba = (*fa, lse, gbl / b, gem / b)
        err_f = _close(f"rnnt_fused_joint V {v} {tag}", torch.stack(jk.joint_logprobs_kernel(*fa)), torch.stack(jk.joint_logprobs_plain(*fa)), *TOL[tag])
        err_b = _grads_close(f"rnnt_fused_joint_bwd V {v} {tag}", jk.rnnt_loss_fused_joint_bwd_kernel(*ba), jk.rnnt_loss_fused_joint_plain_bwd(*ba),
                             GRAD_REL[tag])
        res[tag] = (err_f, err_b)
    act = int(((gbl != 0) | (gem != 0)).sum())
    ms_f, ms_b = time_ms(jk.joint_logprobs_kernel, *fa), time_ms(jk.rnnt_loss_fused_joint_bwd_kernel, *ba)
    bf, bb = bound(*cost_joint(b, T_ENC, TRAIN_U + 1, JOINT, v, 2, False), "bf16"), bound(*cost_joint(b, T_ENC, TRAIN_U + 1, JOINT, v, 2, True, act), "bf16")
    print(f"kernel rnnt_fused_joint[_bwd] at V {v} (B {b}, T {T_ENC}, U+1 {TRAIN_U + 1}, J {JOINT}): max_abs_err fwd f32 {res['f32'][0]:.3e} bf16 "
          f"{res['bf16'][0]:.3e}, bwd f32 {res['f32'][1]:.3e} bf16 {res['bf16'][1]:.3e} (tol {TOL} / {GRAD_REL}); bf16 forward {ms_f:.4f} ms "
          f"(bound {bf[0]:.4f}, {bf[1]}), backward {ms_b:.4f} ms (bound {bb[0]:.4f}, {bb[1]})")
    rows[0]["v1000"] = dict(ms=ms_f, bound_ms=bf[0], errs=[res["f32"][0], res["bf16"][0]])
    rows[1]["v1000"] = dict(ms=ms_b, bound_ms=bb[0], errs=[res["f32"][1], res["bf16"][1]])

    lib = _build.build()
    nh = {128: 8, 256: 16, 320: 20, 384: 24}[next(m for m in (128, 256, 320, 384) if -(-JOINT // 16) * 16 <= m)]
    kernels = {}  # which: (name, row, mangled-name fragment, threads, the plan's blocks per SM where not set by shared memory)
    for which, (name, i, frag, threads, plan_blocks) in {0: ("jm_fwd (Wv streamed, V 1000)", 0, "jm_fwdE", 256, None),
                                                         3: ("jm_fwd_res (Wv resident)", 0, "jm_fwd_resILi16E", 512, 1),  # a persistent grid
                                                         1: ("jm_bwd_rows", 1, f"jm_bwd_rowsILi{nh // 4}E", 512, None),
                                                         2: ("jm_bwd_weight", 1, f"jm_bwd_weightILi{nh}E", 256, None)}.items():
        if which == 3 and lib.tfasr_joint_mma_fwd_resident(JOINT, VOCAB) != 256:
            continue
        smem = lib.tfasr_joint_mma_smem(JOINT, which)
        kernels[name] = (i, frag, smem, smem, plan_blocks or smem_blocks_per_sm(smem, threads), lib.tfasr_joint_mma_occupancy(JOINT, which))
    occupancy_report(rows, kernels, f"joint J {JOINT}")


def phase_train_kernels(dev) -> list[dict]:
    """Every kernel of the training step at its flagship training shapes."""
    from tensorflowasr_tpu_torch.ops import frontend
    from tensorflowasr_tpu_torch.ops.cuda import frontend_kernel as fek

    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    rows = []

    # frontend: [16, 256000] f32 → [16, 1600, 80]
    cfg = frontend.FrontendConfig()
    sig = frontend.preemphasis_signal(_randn(gen, (TRAIN_B, int(TRAIN_SECS * 16000)), 0.1), cfg).contiguous()
    got = fek.log_mel_spectrogram_pallas(sig, cfg)
    err = _close("frontend f32 (train)", got, fek.log_mel_spectrogram_plain(sig, cfg), 1e-3, 0.0)
    ms, plain_ms = time_ms(fek.log_mel_spectrogram_pallas, sig, cfg), time_ms(fek.log_mel_spectrogram_plain, sig, cfg)
    b = bound(*cost_frontend(sig.shape[0], sig.shape[1], got.shape[1], cfg.fft_length, got.shape[2]), "f32")
    print(f"kernel log_mel_spectrogram (train): {tuple(sig.shape)} → {tuple(got.shape)} f32 max_abs_err {err:.3e} (tol 1e-3) kernel {ms:.4f} ms "
          f"plain {plain_ms:.4f} ms bound {b[0]:.4f} ms ({b[1]})")
    rows.append(_row("log_mel_spectrogram", {"f32": err}, ms, plain_ms, b))

    return rows + encoder_kernel_rows(dev, gen, D_MODEL, HEAD, FF_DIM) + phase_loss_kernels(dev)


def encoder_kernel_rows(dev, gen, d_model: int, head: int, ff_dim: int, what: str = f"train, rate {TRAIN_RATE}") -> list[dict]:
    """The four encoder kernels forward (rate 0.1) and backward at the training
    batch (16 × 400 frames) and the given widths, f32 and bf16."""
    from tensorflowasr_tpu_torch.ops.cuda import attention_kernel as ak
    from tensorflowasr_tpu_torch.ops.cuda import conv_kernel as ck
    from tensorflowasr_tpu_torch.ops.cuda import ff_kernel as fk

    rows = []
    # attention: B·H = 64, T = S = 400, R = 799; ragged query lengths
    bh, t, r = TRAIN_B * HEADS, T_ENC, 2 * T_ENC - 1
    q_len = torch.tensor([max(40, T_ENC - 23 * i) for i in range(TRAIN_B)], dtype=torch.int32, device=dev)

    def att_make(dt, rate=TRAIN_RATE, kvb=None, case=(t, r, None, None)):
        s_, r_, chunk, hist = case
        qc, qp = _randn(gen, (bh, t, head), 0.3, dt), _randn(gen, (bh, t, head), 0.3, dt)
        k, v, pos = _randn(gen, (bh, s_, head), 1.0, dt), _randn(gen, (bh, s_, head), 1.0, dt), _randn(gen, (bh, r_, head), 1.0, dt)
        cfg_ = (11, rate, False, chunk, hist, False)
        res = ak.fused_rel_attention_kernel(qc, qp, k, v, pos, kvb, q_len, *cfg_, with_stats=dt == torch.bfloat16)
        out, stats = res if dt == torch.bfloat16 else (res, None)
        dout = _randn(gen, (bh, t, head), 1.0, dt)
        return (qc, qp, k, v, pos, kvb, q_len, *cfg_), (qc, qp, k, v, pos, kvb, q_len, out, stats, dout, *cfg_)

    def att_bwd(qc, qp, k, v, pos, kvb, ql, out, stats, dout, *cfg_):
        return ak.fused_rel_attention_bwd_kernel(qc, qp, k, v, pos, kvb, ql, out, dout, *cfg_, stats=stats)

    def att_bwd_plain(qc, qp, k, v, pos, kvb, ql, out, stats, dout, *cfg_):
        return ak.fused_rel_attention_plain_bwd(qc, qp, k, v, pos, kvb, ql, dout, *cfg_)

    rows += _check_fwd_bwd("fused_rel_attention", ak.fused_rel_attention_kernel, ak.fused_rel_attention_plain, att_bwd, att_bwd_plain, att_make,
                           lambda elt, bwd: cost_attention(bh, t, t, r, head, elt, bwd), what)
    # the streaming case of the training batch: a KV memory of 64 frames (S = M + T), its kv_bias row and the chunk mask, forward and backward
    mem = 64
    mem_valid = torch.arange(t + mem, device=dev)[None, :] >= torch.tensor([(7 * i) % (mem + 1) for i in range(TRAIN_B)], device=dev)[:, None]
    kvb = torch.where(mem_valid, 0.0, -1e9).float()[:, None, :].contiguous()
    chunked = (t + mem, mem + 2 * t - 1, 16, 64)
    errs = {}
    for tag, dt in DTYPES:
        fargs, bargs = att_make(dt, kvb=kvb, case=chunked)
        errs[tag] = (_close(f"fused_rel_attention fwd {tag} (chunked memory, {what})", ak.fused_rel_attention_kernel(*fargs),
                            ak.fused_rel_attention_plain(*fargs), *TOL[tag]),
                     _grads_close(f"fused_rel_attention bwd {tag} (chunked memory, {what})", att_bwd(*bargs), att_bwd_plain(*bargs), GRAD_REL[tag]))
    ms_f, ms_b = time_ms(ak.fused_rel_attention_kernel, *fargs), time_ms(att_bwd, *bargs)
    print(f"kernel fused_rel_attention[_bwd] chunked KV memory ({what}): BH {bh} T {t} S {t + mem} R {mem + 2 * t - 1} head {head}, kv_bias, chunk 16 "
          f"history 64; max_abs_err fwd f32 {errs['f32'][0]:.3e} bf16 {errs['bf16'][0]:.3e}, bwd f32 {errs['f32'][1]:.3e} bf16 {errs['bf16'][1]:.3e}; "
          f"bf16 forward {ms_f:.4f} ms, backward {ms_b:.4f} ms")
    rows[-2]["chunked"], rows[-1]["chunked"] = dict(ms=ms_f, errs=[e[0] for e in errs.values()]), dict(ms=ms_b, errs=[e[1] for e in errs.values()])
    rate0_times(rows[-2:], lambda: att_make(torch.bfloat16, rate=0.0), ak.fused_rel_attention_kernel, att_bwd, what, head)
    rel_attention_accuracy(*att_make(torch.bfloat16), what)

    # FF: N = 16·400 rows, D → F → D
    n = TRAIN_B * T_ENC

    def ff_make(dt, rate=TRAIN_RATE):
        x = _randn(gen, (n, d_model), 1.0, dt)
        gamma, beta = 1.0 + _randn(gen, (d_model,), 0.1), _randn(gen, (d_model,), 0.1)
        w1, b1 = _randn(gen, (d_model, ff_dim), d_model ** -0.5, dt), _randn(gen, (ff_dim,), 0.1, dt)
        w2, b2 = _randn(gen, (ff_dim, d_model), ff_dim ** -0.5, dt), _randn(gen, (d_model,), 0.1, dt)
        dout = _randn(gen, (n, d_model), 1.0, dt)
        return (x, gamma, beta, w1, b1, w2, b2, 13, rate, 0.5, 1e-3), (x, gamma, beta, w1, b1, w2, dout, 13, rate, 0.5, 1e-3)

    rows += _check_fwd_bwd("fused_ff", fk.fused_ff_kernel, fk.fused_ff_plain, fk.fused_ff_bwd_kernel, fk.fused_ff_plain_bwd, ff_make,
                           lambda elt, bwd: cost_ff(n, d_model, ff_dim, elt, bwd), what)
    rate0_times(rows[-2:], lambda: ff_make(torch.bfloat16, rate=0.0), fk.fused_ff_kernel, fk.fused_ff_bwd_kernel, what, d_model)
    ff_accuracy(*ff_make(torch.bfloat16), what)
    rows[-2]["row_tiles"] = ff_row_tiles(ff_make(torch.bfloat16)[0], what)
    mma_occupancy(rows[-4:], d_model, head, ff_dim, n)

    # conv module halves: [16, 400, D]
    shape = (TRAIN_B, T_ENC, d_model)

    def front_make(dt):
        x = _randn(gen, shape, 1.0, dt)
        p = (1.0 + _randn(gen, (d_model,), 0.1), _randn(gen, (d_model,), 0.1), _randn(gen, (d_model, d_model), d_model ** -0.5, dt),
             _randn(gen, (d_model,), 0.1, dt), _randn(gen, (d_model, d_model), d_model ** -0.5, dt), _randn(gen, (d_model,), 0.1, dt))
        return (x, *p, 1e-3), (x, *p, _randn(gen, shape, 1.0, dt), 1e-3)

    rows += _check_fwd_bwd("conv_front", ck.conv_front_kernel, ck.conv_front_plain, ck.conv_front_bwd_kernel, ck.conv_front_plain_bwd, front_make,
                           lambda elt, bwd: cost_conv_front(n, d_model, elt, bwd), what)
    conv_front_extras(front_make, rows[-2:], d_model, n, what)

    def back_make(dt):
        x, y1 = _randn(gen, shape, 1.0, dt), _randn(gen, shape, 1.0, dt)
        stats = (_randn(gen, (d_model,), 0.1), 1.0 + torch.rand((d_model,), generator=gen, device=dev), 1.0 + _randn(gen, (d_model,), 0.1),
                 _randn(gen, (d_model,), 0.1))
        w2, b2 = _randn(gen, (d_model, d_model), d_model ** -0.5, dt), _randn(gen, (d_model,), 0.1, dt)
        cfg_ = (17, TRAIN_RATE, 1.0, 1e-3)
        return (x, y1, *stats, w2, b2, *cfg_), (y1, *stats, w2, _randn(gen, shape, 1.0, dt), *cfg_)

    rows += _check_fwd_bwd("conv_back", ck.conv_back_kernel, ck.conv_back_plain, ck.conv_back_bwd_kernel, ck.conv_back_plain_bwd, back_make,
                           lambda elt, bwd: cost_conv_back(n, d_model, elt, bwd), what)
    return rows


# the DP (f32 only) chains T+U log-add-exps: loss to 1e-5 relative; the
# gradients (occupancies in [−1, 0]) to 1e-5 absolute
DP_LOSS_TOL, DP_GRAD_TOL = (1e-5, 1e-5), (1e-5, 0.0)


def loss_lengths(rng, batch: int):
    """Ragged lattice lengths as :func:`train_batch` draws them: T_b the
    encoder frames of each utterance (10 ms frames, 4× subsampling), U_b its
    8 tokens per second."""
    secs = np.clip(rng.lognormal(mean=np.log(12.0), sigma=0.35, size=batch), 1.5, TRAIN_SECS)
    return np.clip(np.ceil(secs * 25.0).astype(np.int64), 1, T_ENC), np.clip((secs * 8.0).astype(np.int64), 1, TRAIN_U)


def phase_loss_kernels(dev) -> list[dict]:
    """The loss kernels at the flagship loss shapes: the RNN-T DP (f32), the
    fused joint forward and backward, and the unfused loss's two row kernels
    (f32 and bf16)."""
    from tensorflowasr_tpu_torch.ops.cuda import joint_loss_kernel as jk
    from tensorflowasr_tpu_torch.ops.cuda import rnnt_kernel as rk
    from tensorflowasr_tpu_torch.ops.rnnt_loss import LOG_0, dlogits_assemble_plain, logits_to_logprobs_plain, rnnt_loss_from_logprobs_plain

    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    t_np, u_np = loss_lengths(np.random.default_rng(SEED + 2), TRAIN_B)
    t_len, u_len = torch.tensor(t_np, device=dev), torch.tensor(u_np, device=dev)
    u1 = TRAIN_U + 1

    lp = torch.log_softmax(_randn(gen, (TRAIN_B, T_ENC, u1, 3), 2.0), dim=-1)
    lpb, lpe = lp[..., 0].contiguous(), lp[..., 1].contiguous()
    lpe[..., TRAIN_U] = LOG_0
    got, ref = rk.rnnt_dp_kernel(lpb, lpe, t_len, u_len), rnnt_loss_from_logprobs_plain(lpb, lpe, t_len, u_len)
    err = max(_close("rnnt_dp loss", got[0], ref[0], *DP_LOSS_TOL), _close("rnnt_dp gbl", got[1], ref[1], *DP_GRAD_TOL),
              _close("rnnt_dp gem", got[2], ref[2], *DP_GRAD_TOL))
    ms, plain_ms = time_ms(rk.rnnt_dp_kernel, lpb, lpe, t_len, u_len), time_ms(rnnt_loss_from_logprobs_plain, lpb, lpe, t_len, u_len)
    b = bound(*cost_rnnt_dp(t_np, u_np, T_ENC, u1), "f32")
    print(f"kernel rnnt_dp (train loss): [{TRAIN_B}, {T_ENC}, {u1}] f32, T_b {t_np.min()}-{t_np.max()}, U_b {u_np.min()}-{u_np.max()}, "
          f"diagonals per row ≤ {int((t_np + u_np).max())}; max_abs_err {err:.3e} (loss tol {DP_LOSS_TOL}, gradients {DP_GRAD_TOL}) "
          f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound {b[0]:.4f} ms ({b[1]})")
    rows = [_row("rnnt_dp", {"f32": err}, ms, plain_ms, b)]

    labels = torch.randint(1, VOCAB, (TRAIN_B, TRAIN_U), generator=gen, device=dev)
    labels[torch.arange(TRAIN_U, device=dev)[None, :] >= u_len[:, None]] = 0

    active = {}  # cells with a nonzero gbl or gem, of the last inputs made

    def joint_make(dt):
        enc_p, pred_p = _randn(gen, (TRAIN_B, T_ENC, JOINT), 1.0, dt), _randn(gen, (TRAIN_B, u1, JOINT), 1.0, dt)
        wv, bv = _randn(gen, (VOCAB, JOINT), JOINT ** -0.5, dt), _randn(gen, (VOCAB,), 0.1)
        fargs = (enc_p, pred_p, wv, bv, labels)
        _, lse, gbl, gem = jk.rnnt_loss_fused_joint_plain(*fargs[:4], t_len, labels, u_len)
        active["cells"] = int(((gbl != 0) | (gem != 0)).sum())
        return fargs, (*fargs, lse, gbl / TRAIN_B, gem / TRAIN_B)  # the masked mean's cotangent

    def stats(fn):
        return lambda *a: torch.stack(fn(*a))

    rows += _check_fwd_bwd("rnnt_fused_joint", stats(jk.joint_logprobs_kernel), stats(jk.joint_logprobs_plain), jk.rnnt_loss_fused_joint_bwd_kernel,
                           jk.rnnt_loss_fused_joint_plain_bwd, joint_make,
                           lambda elt, bwd: cost_joint(TRAIN_B, T_ENC, u1, JOINT, VOCAB, elt, bwd, active["cells"]),
                           what=f"train loss, [{TRAIN_B}, {T_ENC}, {u1}] cells, J {JOINT}, V {VOCAB}")
    joint_extras(joint_make, rows[-2:], active["cells"], TRAIN_B * T_ENC * u1, dev)

    # the unfused loss's row kernels over materialised logits [16, 400, 129, 256]
    def rows_make(dt):
        logits = _randn(gen, (TRAIN_B, T_ENC, u1, VOCAB), 2.0, dt)
        lpb, lpe, lse = logits_to_logprobs_plain(logits, labels)
        _, gbl, gem = rnnt_loss_from_logprobs_plain(lpb, lpe, t_len, u_len)
        g = torch.full((TRAIN_B,), 1.0 / TRAIN_B, device=dev)  # the masked mean's cotangent
        return (logits, labels), (logits, lse, gbl, gem, labels, g)

    rows += _check_fwd_bwd("rnnt_logprobs", stats(rk.logits_to_logprobs_kernel), stats(logits_to_logprobs_plain), lambda *a: (rk.dlogits_assemble_kernel(*a),),
                           lambda *a: (dlogits_assemble_plain(*a),), rows_make,
                           lambda elt, bwd: cost_rows(TRAIN_B * T_ENC * u1, VOCAB, TRAIN_B, TRAIN_U, elt, bwd),
                           what=f"eval/pallas loss, logits [{TRAIN_B}, {T_ENC}, {u1}, {VOCAB}]", bwd_name="rnnt_dlogits", fwd_tol=ROWS_TOL)
    return rows


# the log-probability row kernel computes in f32 from the same inputs in either dtype: summation order only
ROWS_TOL = {"f32": (1e-4, 1e-4), "bf16": (1e-4, 1e-4)}
LSTM_B, LSTM_T, LSTM_H = TRAIN_B, TRAIN_U + 1, 320  # the prediction net at the flagship: U+1 = 129 steps, embedding = units = 320


def _pack_cudnn_weights(lstm: torch.nn.LSTM) -> str:
    """Packs an ``nn.LSTM``'s weights into cuDNN's single buffer.
    ``flatten_parameters()`` returns without packing bf16 weights
    (``torch.backends.cudnn.is_acceptable`` takes half, float and double
    only), and cuDNN then copies them into a packed buffer on every call,
    warning that they are "not part of single contiguous chunk of memory".
    For such weights this calls the packing routine that
    ``flatten_parameters()`` calls for the dtypes it accepts."""
    lstm.flatten_parameters()
    if len({w.untyped_storage().data_ptr() for w in lstm._flat_weights}) == 1:
        return "packed by flatten_parameters()"
    import torch.backends.cudnn.rnn as cudnn_rnn

    with torch.no_grad():
        torch._cudnn_rnn_flatten_weight(lstm._flat_weights, 4, lstm.input_size, cudnn_rnn.get_cudnn_mode(lstm.mode), lstm.hidden_size, lstm.proj_size,
                                        lstm.num_layers, lstm.batch_first, bool(lstm.bidirectional))
    if len({w.untyped_storage().data_ptr() for w in lstm._flat_weights}) != 1:
        raise AssertionError(f"nn.LSTM {lstm._flat_weights[0].dtype}: the weights are still not one buffer after packing")
    return f"packed by torch._cudnn_rnn_flatten_weight: flatten_parameters() skips {lstm._flat_weights[0].dtype}"


def phase_lstm_kernels(dev) -> list[dict]:
    """The LSTM forward and backward kernels at the prediction net's flagship
    shape (B 16, T 129, H 320), f32 and bf16, against their plain versions;
    and cuDNN's ``torch.nn.LSTM`` over x [16, 129, 320] at the same shape as
    the library yardstick (its time includes the x·Wx product, which the
    kernel row's input xg already holds)."""
    from tensorflowasr_tpu_torch.ops.cuda import lstm_kernel as lk

    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    b, t, h = LSTM_B, LSTM_T, LSTM_H

    def make(dt):
        xg, wh = _randn(gen, (b, t, 4 * h), 1.0, dt), _randn(gen, (h, 4 * h), h ** -0.5, dt)
        h0, c0 = _randn(gen, (b, h), 0.3, dt), _randn(gen, (b, h), 0.3, dt)
        _, cseq, gates = lk.lstm_fwd_plain(xg, wh, h0, c0)
        dy, dc = _randn(gen, (b, t, h), 1.0 / b, dt), _randn(gen, (b, t, h), 0.1 / b, dt)
        return (xg, wh, h0, c0), (gates, cseq, c0, wh, dy, dc)

    def flat(fn):
        return lambda *a: torch.cat([x.float().flatten() for x in fn(*a)])

    rows = _check_fwd_bwd("lstm", flat(lk.lstm_fwd_kernel), flat(lk.lstm_fwd_plain), lk.lstm_bwd_kernel, lk.lstm_bwd_plain, make,
                          lambda elt, bwd: cost_lstm(b, t, h, elt, bwd), what=f"pallas rnn, B {b} T {t} H {h}")
    print(f"kernel lstm (pallas rnn): the chain bounds it: 2 x {t} dependent steps, one grid barrier each")
    fargs, bargs = make(torch.bfloat16)
    sweep = [f"{u}: fwd {time_ms(lambda: lk.lstm_fwd_kernel(*fargs, units=u)):.4f} ms, bwd {time_ms(lambda: lk.lstm_bwd_kernel(*bargs, units=u)):.4f} ms"
             for u in (3, 4, 8)]
    print(f"kernel lstm (pallas rnn) by hidden units per block, bf16: {'; '.join(sweep)} (the default takes {lk._units(h, dev, None)})")

    library = {}
    for tag, dt in DTYPES:
        lstm = torch.nn.LSTM(h, h, batch_first=True).to(dev, dt)
        packing = _pack_cudnn_weights(lstm)
        x = _randn(gen, (b, t, h), 1.0, dt).requires_grad_(True)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out, _ = lstm(x)
        repacked = [str(w.message).splitlines()[0] for w in caught if "contiguous chunk" in str(w.message)]
        if repacked:
            raise AssertionError(f"library torch.nn.LSTM {tag}: cuDNN still re-packs the weights every call: {repacked[0]}")
        dout = torch.randn_like(out)
        inputs = [x, *lstm.parameters()]
        library[tag] = (time_ms(lambda: lstm(x)), time_ms(lambda: torch.autograd.grad(out, inputs, dout, retain_graph=True)))
        print(f"library torch.nn.LSTM (cuDNN) {tag}: x [{b}, {t}, {h}] forward {library[tag][0]:.4f} ms, backward {library[tag][1]:.4f} ms "
              f"(weights {packing}; no re-packing warning)")
    lib = library.get("bf16")
    for row, part in zip(rows, (0, 1)):
        row["library_ms"] = None if lib is None else lib[part]
        row["library_ms_f32"] = library["f32"][part] if "f32" in library else None
    return rows


# ---------------------------------- the fused greedy decode ---------------------------------- #

DECODE_WINDOW = 16
DECODE_EARLIER_MS = {"bf16": 27.5624, "f32": 21.2730}  # the earlier one-block-per-utterance kernel (PERF.md row 13), for the printout
DECODE_GAP = 2.0 ** -6  # a bf16 token may differ only where the plain version's top-two logit gap is within this share of the logit scale


def cost_decode(t_len: np.ndarray, u_len: np.ndarray, t: int, e: int, h: int, j: int, v: int, elt: int):
    """bytes: enc_p [B, T, J] and the weights (embedding, the LSTM's two
    kernels, the prejoint and vocabulary kernels) read once in the compute
    dtype, biases and the states (f32) read, tokens (int32) and states
    written. operations, from this run's data: a greedy decision is one
    joint row (2·J·V for the product, 2·J for add and tanh) and each row
    needs T_b + U_b of them (a blank moves to the next frame, a token stays
    on it); each emission (and the first step) is one prediction step:
    2·(E + H)·4H for the gates, ~10·H for the cell, 2·H·J for the prejoint."""
    b = len(t_len)
    decisions, steps = float(np.sum(t_len + u_len)), float(np.sum(u_len) + b)
    weights = (v * e + 4 * h * (e + h) + j * h + v * j) * elt + 4 * (4 * h + 2 * h + j + v)
    moved = b * t * j * elt + weights + 4 * b * (2 * t + 1) + 2 * 2 * 4 * b * h
    return moved, decisions * (2.0 * j * v + 2.0 * j) + steps * (2.0 * (e + h) * 4 * h + 10.0 * h + 2.0 * h * j)


def wall_ms(fn, reps: int = 3) -> float:
    """Mean host-clock time of ``fn()`` over ``reps`` calls after one warm-up,
    each ending in a synchronise (for host-driven loops: the plain version,
    the eager WIND loop)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def _first_difference(a: torch.Tensor, b: torch.Tensor, len_a: torch.Tensor, len_b: torch.Tensor) -> list[int | None]:
    """Per row, the first token position where two decodes differ (None where they are equal)."""
    out = []
    for r in range(a.shape[0]):
        n = int(max(len_a[r], len_b[r]))
        diff = (a[r, :n] != b[r, :n]).nonzero()
        out.append(int(diff[0]) if len(diff) else (None if int(len_a[r]) == int(len_b[r]) else min(int(len_a[r]), int(len_b[r]))))
    return out


def phase_decode_kernel(dev) -> dict:
    """Row 13, the fused greedy decode, at the flagship serve shape on the
    real encoder output of one request (8 × 6–10 s): in f32 the kernel, its
    plain version and the eager WIND loop give equal tokens, lengths and
    next tokens, and the kernel's states equal the plain version's to 1e-5;
    in bf16, on the raw encoding and on the sharpened one (×3, +2 on column
    0, the canary's: most decisions far from a tie), the kernel's tokens
    differ from the plain version's only where the plain version's decision
    was within DECODE_GAP of the logit scale (bf16 states differ by an
    occasional rounding, so a near-tie may flip). Times of all three on the
    same input."""
    from tensorflowasr_tpu_torch.ops import transducer_decode
    from tensorflowasr_tpu_torch.ops.cuda import decode_kernel as dk

    audio, lens = make_request(np.random.default_rng(SEED + 5), 8, 6.0, 10.0, dev)
    res, times = {}, {}
    for tag, dt in DTYPES:
        model = flagship(dt, dev).eval()
        params = model.decode_params()
        with torch.inference_mode():
            enc, enc_len, _ = model.encode(audio, lens)
            b = enc.shape[0]
            start, states = torch.zeros(b, dtype=torch.int64, device=dev), model.init_decoder_states(b, dev)
            kernel = lambda x, c=None: dk.fused_greedy_decode_kernel(x, enc_len, params, start, states, window=DECODE_WINDOW, cluster=c)
            plain = lambda x, **kw: dk.fused_greedy_decode_plain(x, enc_len, params, start, states, window=DECODE_WINDOW, **kw)
            eager = lambda x: transducer_decode.transducer_greedy_decode_wind(x, enc_len, model.pred_step, model.joint_window, start, states,
                                                                                window=DECODE_WINDOW)
            got, ref = kernel(enc), plain(enc, gaps=True)
            torch.cuda.synchronize()
            auto = dict(dk.last_launch)
            for c in dk.CLUSTER_SIZES:  # each cluster size gives the same decode
                other = kernel(enc, c)
                if not all(torch.equal(x, y) for x, y in zip(got[:3], other[:3])):
                    raise AssertionError(f"decode {tag}: clusters of {c} give other tokens than the chosen {auto['cluster']}")
            state_err = max((x - y).abs().max().item() for g, r in zip(got[3], ref[3]) for x, y in zip(g, r))
            if tag == "f32":
                eag = eager(enc)
                for name, other in (("plain version", ref), ("eager WIND loop", eag)):
                    if not all(torch.equal(x, y) for x, y in zip(got[:3], other[:3])):
                        raise AssertionError(f"decode f32: kernel tokens/lengths/next tokens differ from the {name}: rows "
                                             f"{_first_difference(got[0], other[0], got[1], other[1])}")
                eager_err = max((x - y).abs().max().item() for g, r in zip(got[3], eag[3]) for x, y in zip(g, r))
                if state_err > 1e-5 or eager_err > 1e-5:
                    raise AssertionError(f"decode f32: states differ from the plain version by {state_err}, from the eager loop by {eager_err} (tol 1e-5)")
                note = f"tokens, lengths, next tokens equal to the plain version's and the eager loop's; states max_abs_err {state_err:.3e} / {eager_err:.3e} (tol 1e-5)"
            else:
                sharp = enc.float() * 3.0
                sharp[..., 0] += 2.0
                sharp = sharp.to(dt)
                pred0, _ = dk._pred_step(params, start, states)
                notes = []
                for what, x, (g_, r_) in (("sharpened", sharp, (kernel(sharp), plain(sharp, gaps=True))), ("raw", enc, (got, ref))):
                    z0 = torch.tanh(dk.project_encoder(x, params).float() + pred0[:, None, :]).to(dt)
                    scale = torch.nn.functional.linear(z0.float(), params.wv.float(), params.bv).abs().max().item()
                    report = []
                    for r, pos in enumerate(_first_difference(g_[0], r_[0], g_[1], r_[1])):
                        if pos is None:
                            continue
                        g = r_[4][r, pos].item()
                        report.append(f"row {r}: position {pos}, plain top-two gap {g:.4g}")
                        if g > DECODE_GAP * scale:
                            raise AssertionError(f"decode bf16 ({what}): row {r} differs at position {pos} where the plain version's top-two logit gap "
                                                 f"{g} exceeds {DECODE_GAP} x the logit scale {scale}")
                    notes.append(f"{what}: {8 - len(report)} of 8 rows equal, " + ("; ".join(report) or "no difference")
                                 + f" (allowed where the gap <= 2^-6 x logit scale {scale:.3g})")
                note = "; ".join(notes)
            times[tag] = (time_ms(kernel, enc), wall_ms(lambda: plain(enc)), wall_ms(lambda: eager(enc)))
            by_cluster = {}
            for c in dk.CLUSTER_SIZES:
                by_cluster[c] = dict(ms=time_ms(kernel, enc, c), **{key: dk.last_launch[key] for key in ("smem_bytes", "resident_bytes", "slice_bytes", "whole")})
        t_np, u_np = enc_len.cpu().numpy(), got[1].cpu().numpy()
        res[tag] = dict(err=state_err, t_np=t_np, u_np=u_np, t=enc.shape[1], auto=auto, by_cluster=by_cluster)
        print(f"kernel fused_decode {tag} (serve decode, B {b} T {enc.shape[1]} (T_b {t_np.min()}-{t_np.max()}), E 144 J 320 H 320 V 256, window "
              f"{DECODE_WINDOW}): tokens per row {u_np.min()}-{u_np.max()} of {2 * enc.shape[1] + 1}; {note}; kernel {times[tag][0]:.4f} ms plain "
              f"{times[tag][1]:.1f} ms eager WIND loop {times[tag][2]:.1f} ms; the earlier one-block kernel (PERF.md row 13): "
              f"{DECODE_EARLIER_MS[tag]} ms")
        print(f"kernel fused_decode {tag} cluster: chosen C {auto['cluster']} for B {b} (co-resident clusters by size {auto['occupancy']}), "
              f"{auto['resident_bytes']} of {auto['slice_bytes']} weight bytes resident per block, {auto['smem_bytes']} bytes of shared memory; "
              + "; ".join(f"C {c}: {r['ms']:.4f} ms, {r['resident_bytes']} of {r['slice_bytes']} bytes resident" for c, r in by_cluster.items()))
    r32 = res["f32"]
    bounds = {tag: bound(*cost_decode(res[tag]["t_np"], res[tag]["u_np"], res[tag]["t"], 320, 320, 320, 256, 4 if tag == "f32" else 2), tag)
              for tag, _ in DTYPES}
    iters = r32["t_np"] + r32["u_np"]
    print(f"kernel fused_decode: bound bf16 {bounds['bf16'][0]:.4f} ms ({bounds['bf16'][1]}), f32 {bounds['f32'][0]:.4f} ms ({bounds['f32'][1]}); "
          f"the chain bounds it: greedy decisions per row T_b + U_b {iters.min()}-{iters.max()}, of which U_b {r32['u_np'].min()}-{r32['u_np'].max()} "
          f"dependent prediction steps; library: none (no one PyTorch call decodes), eager WIND loop bf16 {times['bf16'][2]:.1f} ms")
    row = _row("fused_decode", {"f32": res["f32"]["err"], "bf16": res["bf16"]["err"]}, times["bf16"][0], times["bf16"][1], bounds["bf16"])
    row.update(eager_loop_ms=times["bf16"][2], ms_f32=times["f32"][0], plain_ms_f32=times["f32"][1], eager_loop_ms_f32=times["f32"][2],
               bound_ms_f32=bounds["f32"][0], decisions_per_row=[int(iters.min()), int(iters.max())],
               cluster={tag: {"chosen": res[tag]["auto"]["cluster"], "occupancy": res[tag]["auto"]["occupancy"],
                              "by_size": res[tag]["by_cluster"]} for tag, _ in DTYPES})
    return row


# --------------------------------------- counts --------------------------------------- #

# launches per served request of the 16-block flagship: frontend once, one
# attention per block, two FF modules per block, one conv module per block;
# no backward kernel, no loss kernel, no sequence LSTM (decode steps the cell)
ENCODER_FWD = {"log_mel_spectrogram": 1, "fused_rel_attention": 16, "fused_ff": 32, "conv_front": 16, "conv_back": 16}
ENCODER_BWD = {"fused_rel_attention_bwd": 16, "fused_ff_bwd": 32, "conv_front_bwd": 16, "conv_back_bwd": 16}
KERNELS = ("log_mel_spectrogram", "fused_rel_attention", "fused_rel_attention_bwd", "fused_ff", "fused_ff_bwd", "conv_front", "conv_front_bwd",
           "conv_back", "conv_back_bwd", "rnnt_dp", "rnnt_fused_joint", "rnnt_fused_joint_bwd", "rnnt_logprobs", "rnnt_dlogits", "lstm", "lstm_bwd",
           "ctc_loss", "fused_attention", "fused_attention_bwd", "fused_decode")


def _per(**counts) -> dict:
    return {k: counts.get(k, 0) for k in KERNELS}


def _launched(counts: dict) -> dict:
    """The kernels of ``counts`` that launched."""
    return {k: v for k, v in counts.items() if v}


# ... and the fused greedy decode once
PER_REQUEST = _per(**ENCODER_FWD, fused_decode=1)
# per default (auto) training step: the encoder's forwards, each one's
# backward, and the fused joint forward, the DP and the fused joint backward once each
PER_STEP = _per(**ENCODER_FWD, **ENCODER_BWD, rnnt_dp=1, rnnt_fused_joint=1, rnnt_fused_joint_bwd=1)
# per xla step: the encoder's kernels; the loss is the plain DP over the logits
PER_STEP_XLA = _per(**ENCODER_FWD, **ENCODER_BWD)
# per eval step (default loss_impl): the encoder's forwards, the log-probability row kernel and the DP
PER_EVAL = _per(**ENCODER_FWD, rnnt_logprobs=1, rnnt_dp=1)
# per pallas step with rnn_impl="pallas": the unfused loss (log-probabilities, DP, d_logits) and the LSTM forward and backward
PER_STEP_PALLAS = _per(**ENCODER_FWD, **ENCODER_BWD, rnnt_logprobs=1, rnnt_dp=1, rnnt_dlogits=1, lstm=1, lstm_bwd=1)
# per auto step with rnn_impl="pallas": the default step's kernels and the LSTM forward and backward
PER_STEP_AUTO_LSTM = {**PER_STEP, "lstm": 1, "lstm_bwd": 1}


def launch_counts() -> dict:
    from tensorflowasr_tpu_torch.ops.cuda import attention_kernel as ak, conv_kernel as ck, ctc_kernel as ctk, ff_kernel as fk, frontend_kernel as fek
    from tensorflowasr_tpu_torch.ops.cuda import decode_kernel as dk, joint_loss_kernel as jk, lstm_kernel as lk, rnnt_kernel as rk

    return {"log_mel_spectrogram": fek.launches, "fused_rel_attention": ak.launches, "fused_rel_attention_bwd": ak.bwd_launches, "fused_ff": fk.launches,
            "fused_ff_bwd": fk.bwd_launches, "conv_front": ck.front_launches, "conv_front_bwd": ck.front_bwd_launches, "conv_back": ck.back_launches,
            "conv_back_bwd": ck.back_bwd_launches, "rnnt_dp": rk.launches, "rnnt_fused_joint": jk.launches, "rnnt_fused_joint_bwd": jk.bwd_launches,
            "rnnt_logprobs": rk.logprobs_launches, "rnnt_dlogits": rk.dlogits_launches, "lstm": lk.launches, "lstm_bwd": lk.bwd_launches,
            "ctc_loss": ctk.launches, "fused_attention": ak.attention_launches, "fused_attention_bwd": ak.attention_bwd_launches,
            "fused_decode": dk.launches}


def reset_launch_counts() -> None:
    from tensorflowasr_tpu_torch.ops.cuda import attention_kernel as ak, conv_kernel as ck, ctc_kernel as ctk, ff_kernel as fk, frontend_kernel as fek
    from tensorflowasr_tpu_torch.ops.cuda import decode_kernel as dk, joint_loss_kernel as jk, lstm_kernel as lk, rnnt_kernel as rk

    fek.launches = ak.launches = ak.bwd_launches = fk.launches = fk.bwd_launches = 0
    ck.front_launches = ck.front_bwd_launches = ck.back_launches = ck.back_bwd_launches = 0
    rk.launches = jk.launches = jk.bwd_launches = rk.logprobs_launches = rk.dlogits_launches = lk.launches = lk.bwd_launches = 0
    ctk.launches = ak.attention_launches = ak.attention_bwd_launches = dk.launches = 0


def flagship(dtype, device, num_blocks: int = 16, dropout: float = 0.1, rnn_impl: str = "auto") -> torch.nn.Module:
    from tensorflowasr_tpu_torch.models.transducer.conformer import Conformer, conformer_small_config

    model = Conformer.from_config(conformer_small_config(num_blocks=num_blocks, dropout=dropout), dtype=dtype, device=device, rnn_impl=rnn_impl)
    model.reset_parameters(torch.Generator().manual_seed(SEED))
    return model


def make_request(rng, batch: int, lo_s: float, hi_s: float, dev):
    lens = rng.integers(int(lo_s * 16000), int(hi_s * 16000) + 1, size=batch)
    audio = (rng.standard_normal((batch, int(lens.max()))) * 0.1).astype(np.float32)
    audio[np.arange(audio.shape[1])[None, :] >= lens[:, None]] = 0.0
    return torch.tensor(audio, device=dev), torch.tensor(lens, device=dev)


GC_WATCH = {"watched": 0, "gen2": 0, "gen2_ms": 0.0}  # over every RequestWatch of the run


def settle() -> None:
    """After a phase's set-up and warm-up: one collection, then the survivors
    frozen (``gc.freeze``), so that no gen-2 collection over the objects of
    earlier phases lands inside a timed step or request."""
    gc.collect()
    gc.freeze()


class RequestWatch:
    """Host events inside one request or training step: the time Python's garbage collector
    ran (and its gen-2 collections), and the device allocations (cudaMalloc) and allocator retries of
    PyTorch's caching allocator."""

    def __enter__(self):
        self.gc_ms, self._t, self.gen2, self.gen2_ms = 0.0, None, 0, 0.0
        gc.callbacks.append(self._gc)
        stats = torch.cuda.memory_stats()
        self._start = (stats.get("num_device_alloc", 0), stats.get("num_alloc_retries", 0))
        return self

    def _gc(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            ms = (time.perf_counter() - self._t) * 1e3
            self.gc_ms += ms
            if info.get("generation") == 2:
                self.gen2 += 1
                self.gen2_ms += ms
            self._t = None

    def __exit__(self, *exc):
        gc.callbacks.remove(self._gc)
        GC_WATCH["watched"] += 1
        GC_WATCH["gen2"] += self.gen2
        GC_WATCH["gen2_ms"] += self.gen2_ms
        stats = torch.cuda.memory_stats()
        self.device_allocs = stats.get("num_device_alloc", 0) - self._start[0]
        self.alloc_retries = stats.get("num_alloc_retries", 0) - self._start[1]
        return False

    def __str__(self):
        return (f"gc {self.gc_ms:.1f} ms ({self.gen2} gen-2, {self.gen2_ms:.1f} ms), device allocations {self.device_allocs}, "
                f"allocator retries {self.alloc_retries}")


OUTLIER = 3.0  # a request over this multiple of its phase's median wall is an outlier


def flag_outliers(tag: str, walls: list[float], watches: list) -> None:
    med = float(np.median(walls))
    for r, (wall, w) in enumerate(zip(walls, watches)):
        if wall > OUTLIER * med:
            print(f"{tag} request {r}: OUTLIER {wall * 1e3:.1f} ms > {OUTLIER} x the median {med * 1e3:.1f} ms; {w}")


def outlier_hunt(tag: str, model, recognize_fn, rng, dev, n: int = 6) -> None:
    """``n`` more requests of 8 × 6–10 s at new lengths (new shapes), each
    under the profiler; for a request over OUTLIER × the median wall, the
    profiler's summary of that request (host time by operator, with the
    CUDA runtime calls) and its garbage-collector and allocator events."""
    from torch.profiler import ProfilerActivity, profile

    from tensorflowasr_tpu_torch import schemas

    walls, runs = [], []
    settle()
    for _ in range(n):
        audio, lens = make_request(rng, 8, 6.0, 10.0, dev)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, RequestWatch() as watch:
            t0 = time.perf_counter()
            recognize_fn(model, schemas.PredictInput(audio, lens))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        runs.append((prof, watch, audio.shape[1]))
    med = float(np.median(walls))
    print(f"{tag} outlier hunt: {n} requests at new lengths under the profiler, walls " + ", ".join(f"{w * 1e3:.1f}" for w in walls)
          + f" ms (median {med * 1e3:.1f})")
    for wall, (prof, watch, samples) in zip(walls, runs):
        if wall > OUTLIER * med:
            print(f"{tag} outlier: {wall * 1e3:.1f} ms for {samples} samples; {watch}; profiler summary of that request:")
            print(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=12, max_name_column_width=60))


def phase_serve(dev) -> dict:
    from tensorflowasr_tpu_torch import schemas
    from tensorflowasr_tpu_torch.models.transducer.base import recognize
    from tensorflowasr_tpu_torch.ops import transducer_decode
    from tensorflowasr_tpu_torch.ops.cuda.decode_kernel import fused_greedy_decode

    model = flagship(torch.bfloat16, dev).eval()
    rng = np.random.default_rng(SEED)
    requests = [make_request(rng, 8, 6.0, 10.0, dev) for _ in range(3)]
    recognize(model, schemas.PredictInput(*make_request(rng, 8, 6.0, 10.0, dev)))  # warm-up request, not counted
    torch.cuda.synchronize()
    settle()

    reset_launch_counts()
    walls, watches = [], []
    for r, (audio, lens) in enumerate(requests):
        before = launch_counts()
        with RequestWatch() as watch:
            t0 = time.perf_counter()
            out = recognize(model, schemas.PredictInput(audio, lens))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        watches.append(watch)
        after = launch_counts()
        delta = {k: after[k] - before[k] for k in after}
        if delta != PER_REQUEST:
            raise AssertionError(f"request {r}: kernel launches {delta}, expected {PER_REQUEST}")
        t_enc = int(model.encoder.output_length(-(-audio.shape[1] // 160)))
        if tuple(out.tokens.shape) != (8, 2 * t_enc + 1):
            raise AssertionError(f"request {r}: tokens {tuple(out.tokens.shape)}, expected (8, {2 * t_enc + 1})")
        if not ((out.tokens >= 0) & (out.tokens < model.vocab_size)).all():
            raise AssertionError(f"request {r}: token ids outside the vocabulary")
    counts = launch_counts()
    flag_outliers("serve", walls, watches)

    # encode and decode timed apart, on the same requests (after the counted run): the decode kernel, then the eager loop on the same encoding
    for r, (audio, lens) in enumerate(requests):
        with torch.inference_mode():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            enc, enc_len, _ = model.encode(audio, lens)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            states = model.init_decoder_states(8, dev)
            start = torch.zeros(8, dtype=torch.int64, device=dev)
            tokens, ntok, _, _ = fused_greedy_decode(enc, enc_len, model.decode_params(), start, states)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            transducer_decode.transducer_greedy_decode_wind(enc, enc_len, model.pred_step, model.joint_window, start, states)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
        if not torch.isfinite(enc.float()).all():
            raise AssertionError(f"request {r}: non-finite encoder output")
        audio_s = lens.sum().item() / 16000.0
        print(f"serve request {r}: batch 8, audio {audio_s:.2f} s (max {audio.shape[1] / 16000:.2f} s), encoder frames {enc.shape[1]}, "
              f"recognize {walls[r] * 1e3:.3f} ms ({watches[r]}), encode {(t1 - t0) * 1e3:.3f} ms, decode {(t2 - t1) * 1e3:.3f} ms (the fused decode "
              f"kernel; the eager WIND loop on the same encoding {(t3 - t2) * 1e3:.3f} ms), RTF {walls[r] / audio_s:.6f} (wall / audio seconds), "
              f"tokens emitted mean {ntok.float().mean().item():.1f}")
    print(f"serve launches over 3 requests: {counts} (per request {PER_REQUEST}); bf16 compute, f32 params, TF32 off")
    outlier_hunt("serve", model, recognize, np.random.default_rng(SEED + 9), dev)
    return counts


def train_batch(rng, batch: int, max_secs: float, max_u: int, vocab: int):
    """Ragged lengths as the JAX package's benchmark draws them (bench.py:149-157):
    lognormal around 12 s clipped to [1.5 s, max], 8 tokens per second."""
    from tensorflowasr_tpu_torch import schemas

    secs = np.clip(rng.lognormal(mean=np.log(12.0), sigma=0.35, size=batch), 1.5, max_secs)
    lens = (secs * 16000).astype(np.int64)
    u = np.clip((secs * 8.0).astype(np.int64), 1, max_u)
    audio = (rng.standard_normal((batch, int(max_secs * 16000))) * 0.1).astype(np.float32)
    audio[np.arange(audio.shape[1])[None, :] >= lens[:, None]] = 0.0
    labels = rng.integers(1, vocab, (batch, max_u))
    labels[np.arange(max_u)[None, :] >= u[:, None]] = 0
    preds = np.concatenate([np.zeros((batch, 1), np.int64), labels], axis=1)
    t = torch.tensor
    return schemas.TrainData(schemas.TrainInput(t(audio), t(lens), t(preds), t(u + 1)), schemas.TrainLabel(t(labels), t(u)))


TRAIN_STEPS, XLA_STEPS, HOST_STEPS = 6, 2, 8


def run_train(dev, loss_impl: str, steps: int, per_step: dict, tag: str, rnn_impl: str = "auto", model=None, lr: float = 1e-4):
    """``steps`` training steps of ``model`` (default: the flagship) through
    ``Trainer.train_step`` (bf16, dropout 0.1, Adam at ``lr``, one fixed batch)
    with launch counts set to 0 just before and read just after; each step's
    launches must equal ``per_step``. Returns (counts, losses, walls,
    trainer, state, batch, splits), ``splits`` the (forward, loss,
    backward+update) ms of each step."""
    from tensorflowasr_tpu_torch.training.trainer import Trainer

    events = {}

    def mark(phase):
        events[phase] = torch.cuda.Event(enable_timing=True)
        events[phase].record()

    model = model or flagship(torch.bfloat16, dev, dropout=TRAIN_RATE, rnn_impl=rnn_impl)
    trainer = Trainer(model, {"class_name": "Adam", "config": {"learning_rate": lr}}, device=dev, on_phase=mark, loss_impl=loss_impl)
    state = trainer.init_state(seed=SEED)
    batch = train_batch(np.random.default_rng(SEED + 2), TRAIN_B, TRAIN_SECS, TRAIN_U, model.vocab_size).to(dev)
    print(f"{tag} batch: {TRAIN_B} utterances, audio {batch.inputs.inputs_length.sum().item() / 16000:.2f} s "
          f"(lengths {batch.inputs.inputs_length.min().item() / 16000:.2f}-{batch.inputs.inputs_length.max().item() / 16000:.2f} s, array {TRAIN_SECS} s), "
          f"labels {batch.labels.labels_length.min().item()}-{batch.labels.labels_length.max().item()} (array {TRAIN_U}); loss_impl {loss_impl!r}, "
          f"rnn_impl {rnn_impl!r}, Adam lr {lr:g}")
    torch.cuda.synchronize()
    settle()

    reset_launch_counts()
    losses, walls, splits = [], [], []
    for step in range(steps):
        before = launch_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        with RequestWatch() as watch:
            t0 = time.perf_counter()
            state, metrics = trainer.train_step(state, batch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        loss, gnorm = metrics["loss"].item(), metrics["grad_norm"].item()
        after = launch_counts()
        delta = {k: after[k] - before[k] for k in after}
        if delta != per_step:
            raise AssertionError(f"{tag} step {step}: kernel launches {delta}, expected {per_step}")
        fwd, los, upd = start.elapsed_time(events["forward"]), events["forward"].elapsed_time(events["loss"]), events["loss"].elapsed_time(events["update"])
        peak = torch.cuda.max_memory_allocated(dev) / 2**20
        print(f"{tag} step {step}: {wall:.1f} ms (host clock, ends in a synchronise; {watch}); forward {fwd:.1f} ms, loss {los:.1f} ms, "
              f"backward+update {upd:.1f} ms (CUDA events); loss {loss:.4f} grad_norm {gnorm:.4f}; peak memory {peak:.0f} MiB")
        if not (np.isfinite(loss) and np.isfinite(gnorm)):
            raise AssertionError(f"{tag} step {step}: non-finite loss {loss} or grad_norm {gnorm}")
        losses.append(loss)
        walls.append(wall)
        splits.append((fwd, los, upd))
    counts = launch_counts()
    print(f"{tag} launches over {steps} steps: {counts} (per step {per_step})")
    return counts, losses, walls, trainer, state, batch, splits


def profile_step(trainer, state, batch, walls, tag: str, top: int = 15) -> tuple[float, float]:
    """One more step under the profiler: the card's kernel time in a step, its
    share of the unprofiled steps' median wall, and the kernels by time.
    Returns (kernel ms, share in %)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    steady = float(np.median(walls[1:]))
    print(f"{tag} profile: card kernel time {busy_ms:.1f} ms in one step ({len(kernels)} kernel names) → card busy {100 * busy_ms / steady:.1f}% of the "
          f"median unprofiled step ({steady:.1f} ms; {wall:.1f} ms under the profiler)")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:top]:
        print(f"  {e.self_device_time_total / 1e3:8.2f} ms  {e.count:6d} calls  {e.key[:100]}")
    return busy_ms, 100 * busy_ms / steady


def phase_train(dev):
    """The default (auto: fused joint+loss) flagship training step, 6 steps,
    then one profiled step; then 2 steps of the xla configuration. Returns
    the launch counts of both paths and the auto run's (losses, walls, splits)."""
    counts, losses, walls, trainer, state, batch, splits = run_train(dev, "auto", TRAIN_STEPS, PER_STEP, "train")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"training loss did not fall over {TRAIN_STEPS} steps: {losses}")

    profile_step(trainer, state, batch, walls, "train")
    del trainer, state

    # the xla configuration stays driven: logits and the plain DP
    xla_counts, xla_losses, *_ = run_train(dev, "xla", XLA_STEPS, PER_STEP_XLA, "train xla")
    if abs(xla_losses[0] - losses[0]) > 1e-2 * abs(losses[0]):
        raise AssertionError(f"first step loss: xla {xla_losses[0]} vs auto {losses[0]} (bf16, same weights and batch)")
    return {"train": counts, "train_xla": xla_counts}, (losses, walls, splits)


EVAL_STEPS, PALLAS_STEPS = 3, 2


def phase_eval(dev) -> dict:
    """Three flagship eval steps through ``Trainer.eval_step`` with the
    default ``loss_impl`` (bf16, the training batch): the inference forward to
    logits, the log-probability row kernel and the DP; wall, peak memory and
    launches per step; the loss against the plain-DP (xla) eval of the same batch."""
    from tensorflowasr_tpu_torch.training.trainer import Trainer, make_eval_step

    model = flagship(torch.bfloat16, dev, dropout=TRAIN_RATE)
    trainer = Trainer(model, {"class_name": "Adam", "config": {"learning_rate": 1e-4}}, device=dev)
    state = trainer.init_state(seed=SEED)
    batch = train_batch(np.random.default_rng(SEED + 2), TRAIN_B, TRAIN_SECS, TRAIN_U, model.vocab_size).to(dev)
    torch.cuda.synchronize()
    reset_launch_counts()
    losses = []
    for step in range(EVAL_STEPS):
        before = launch_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        loss = trainer.eval_step(state, batch)["loss"].item()
        wall = (time.perf_counter() - t0) * 1e3
        after = launch_counts()
        delta = {k: after[k] - before[k] for k in after}
        if delta != PER_EVAL:
            raise AssertionError(f"eval step {step}: kernel launches {delta}, expected {PER_EVAL}")
        if not np.isfinite(loss):
            raise AssertionError(f"eval step {step}: non-finite loss {loss}")
        print(f"eval step {step}: {wall:.1f} ms (host clock, ends in the loss's .item()); loss {loss:.6f}; "
              f"peak memory {torch.cuda.max_memory_allocated(dev) / 2**20:.0f} MiB")
        losses.append(loss)
    counts = launch_counts()
    print(f"eval launches over {EVAL_STEPS} steps: {counts} (per step {PER_EVAL})")
    t0 = time.perf_counter()
    xla = make_eval_step(model, "xla")(state, batch)["loss"].item()
    xla_wall = (time.perf_counter() - t0) * 1e3
    if not abs(losses[0] - xla) <= 1e-5 * abs(xla):
        raise AssertionError(f"eval loss: default (kernels) {losses[0]} vs xla (plain DP) {xla}")
    print(f"eval loss default (row kernel + DP kernel) {losses[0]:.6f} vs xla (plain DP) {xla:.6f} (rel {abs(losses[0] - xla) / abs(xla):.2e}, "
          f"tol 1e-5); the xla eval step took {xla_wall:.1f} ms")
    return counts


def phase_pallas(dev, auto: tuple) -> dict:
    """Two flagship steps of ``loss_impl="pallas"`` with ``rnn_impl="pallas"``
    (the unfused loss and the LSTM kernels), the first loss within 1e-2 of
    the auto step's; then two auto steps with ``rnn_impl="pallas"`` and the
    split of their wall against the auto step's."""
    auto_losses, auto_walls, auto_splits = auto
    counts, losses, *_ = run_train(dev, "pallas", PALLAS_STEPS, PER_STEP_PALLAS, "train pallas", rnn_impl="pallas")
    if abs(losses[0] - auto_losses[0]) > 1e-2 * abs(auto_losses[0]):
        raise AssertionError(f"first step loss: pallas {losses[0]} vs auto {auto_losses[0]} (bf16, same weights and batch)")
    lstm_counts, lstm_losses, walls, _, _, _, splits = run_train(dev, "auto", PALLAS_STEPS, PER_STEP_AUTO_LSTM, "train auto+lstm", rnn_impl="pallas")
    if abs(lstm_losses[0] - auto_losses[0]) > 1e-2 * abs(auto_losses[0]):
        raise AssertionError(f"first step loss: auto with the LSTM kernels {lstm_losses[0]} vs auto {auto_losses[0]}")

    def median_split(w, sp):
        return float(np.median(w[1:])), *(float(np.median([x[i] for x in sp[1:]])) for i in range(3))

    a, k = median_split(auto_walls, auto_splits), median_split(walls, splits)
    print(f"train auto step, median after the first: wall {a[0]:.1f} ms (forward {a[1]:.1f}, loss {a[2]:.1f}, backward+update {a[3]:.1f}) with the LSTM "
          f"loop; {k[0]:.1f} ms (forward {k[1]:.1f}, loss {k[2]:.1f}, backward+update {k[3]:.1f}) with the LSTM kernels (rnn_impl 'pallas')")
    return {"train_pallas": counts, "train_auto_lstm": lstm_counts}


# f32, card vs CPU: summation-order differences (~1e-6 per op) compound over
# the blocks (encoder) and through the DP loss and the backward (training
# step); the LayerNorm'd encoder outputs are of unit scale.
PARITY_ATOL = 2e-3
TRAIN_PARITY_REL = 1e-3  # of each gradient's largest magnitude
TRAIN_PARITY_FLOOR = 1e-5  # of the model's largest gradient: gradients that are zero in exact arithmetic are f32 noise


def phase_parity(dev) -> None:
    model = flagship(torch.float32, "cpu").eval()
    cpu_model = copy.deepcopy(model)
    model = model.to(dev)
    audio, lens = make_request(np.random.default_rng(SEED + 1), 2, 4.0, 4.0, "cpu")
    lens[1] = 3 * 16000
    with torch.inference_mode():
        enc_gpu, len_gpu, _ = model.encode(audio.to(dev), lens.to(dev))
        enc_cpu, len_cpu, _ = cpu_model.encode(audio, lens)
    err = _close("f32 encoder card vs CPU", enc_gpu.cpu(), enc_cpu, PARITY_ATOL, 0.0)
    if not torch.equal(len_gpu.cpu(), len_cpu):
        raise AssertionError("encoder lengths differ between card and CPU")
    print(f"parity f32 encoder card (kernels) vs CPU (plain): shape {tuple(enc_cpu.shape)} max_abs_err {err:.3e} (tol {PARITY_ATOL}), TF32 off")


def _step_parity(dev, loss_impl: str, rnn_impl: str, cpu_model=None, what: str = ""):
    """One f32 training step's loss and gradients, card (kernels) vs CPU
    (plain versions), 2 blocks at full width (``cpu_model``, default the
    flagship), batch 2 × ≤ 4 s, dropout 0. Returns the card model and its batch."""
    from tensorflowasr_tpu_torch.training.trainer import make_train_loss

    cpu_model = cpu_model or flagship(torch.float32, "cpu", num_blocks=2, dropout=0.0, rnn_impl=rnn_impl)
    model = copy.deepcopy(cpu_model).to(dev)
    batch = train_batch(np.random.default_rng(SEED + 3), 2, 4.0, 32, cpu_model.vocab_size)
    train_loss = make_train_loss(cpu_model, loss_impl)
    results = []
    for m, b in ((model, batch.to(dev)), (cpu_model, batch)):
        loss = train_loss(m, b.inputs, b.labels)
        loss.backward()
        results.append((loss.item(), {n: p.grad.detach().cpu() for n, p in m.named_parameters()}))
    (loss_gpu, g_gpu), (loss_cpu, g_cpu) = results
    what = what or f"{loss_impl}, rnn_impl {rnn_impl}"
    if not abs(loss_gpu - loss_cpu) <= 1e-4 * abs(loss_cpu):
        raise AssertionError(f"{what}: loss card {loss_gpu} vs CPU {loss_cpu}")
    gmax = max(g.abs().max().item() for g in g_cpu.values())
    worst = worst_rel = (0.0, "")
    for name, ref in g_cpu.items():
        err, scale = (g_gpu[name] - ref).abs().max().item(), ref.abs().max().item()
        allowed = TRAIN_PARITY_REL * scale + TRAIN_PARITY_FLOOR * gmax
        if err > allowed:
            raise AssertionError(f"f32 train parity ({what}) {name}: max abs err {err} > {TRAIN_PARITY_REL} x {scale} + {TRAIN_PARITY_FLOOR} x {gmax}")
        worst = max(worst, (err / allowed, name))
        if scale > TRAIN_PARITY_FLOOR * gmax:
            worst_rel = max(worst_rel, (err / scale, name))
    print(f"parity f32 train step ({what}) card (kernels) vs CPU (plain): 2 blocks, batch 2 x <= 4 s; loss {loss_gpu:.6f} vs "
          f"{loss_cpu:.6f}; {len(g_cpu)} gradients within {TRAIN_PARITY_REL} of their scale + {TRAIN_PARITY_FLOOR} x {gmax:.3e} (largest share of that "
          f"allowance {worst[0]:.3f} at {worst[1]}; largest error relative to scale among gradients above the floor {worst_rel[0]:.3e} at {worst_rel[1]}), "
          f"TF32 off")
    return model, batch.to(dev)


def phase_train_parity(dev) -> None:
    """The f32 default (auto) step and the pallas step with the LSTM kernels,
    card vs CPU; and on the card the fused path's loss and the unfused
    (pallas) loss against the xla path's on the same batch and logits."""
    from tensorflowasr_tpu_torch.ops.losses import get_rnnt_loss_fn
    from tensorflowasr_tpu_torch.training.trainer import fused_joint_loss

    model, b = _step_parity(dev, "auto", "auto")
    with torch.no_grad():
        out = model(b.inputs, train=True)
        xla = get_rnnt_loss_fn("xla")(out.logits, out.logits_length, b.labels.labels, b.labels.labels_length).item()
        fused = fused_joint_loss(model, b.inputs, b.labels).item()
    if not abs(fused - xla) <= 1e-5 * abs(xla):
        raise AssertionError(f"f32 loss on the card: fused joint {fused} vs xla {xla}")
    print(f"parity f32 loss on the card, fused joint+loss (kernels) vs xla (logits, plain DP): {fused:.6f} vs {xla:.6f} "
          f"(rel {abs(fused - xla) / abs(xla):.2e}, tol 1e-5)")

    model, b = _step_parity(dev, "pallas", "pallas")
    with torch.no_grad():
        out = model(b.inputs, train=True)
        args = (out.logits, out.logits_length, b.labels.labels, b.labels.labels_length)
        xla, pallas = get_rnnt_loss_fn("xla")(*args).item(), get_rnnt_loss_fn("pallas")(*args).item()
    if not abs(pallas - xla) <= 1e-5 * abs(xla):
        raise AssertionError(f"f32 loss on the card: pallas {pallas} vs xla {xla}")
    print(f"parity f32 loss on the card, unfused pallas loss (row kernels + DP kernel) vs xla (plain DP) over the same logits: {pallas:.6f} vs "
          f"{xla:.6f} (rel {abs(pallas - xla) / abs(xla):.2e}, tol 1e-5)")

# ----------------------------------------- streaming ----------------------------------------- #

# bench.py:355 bench_streaming: batch 1, 16 feature frames per chunk (2800 samples, a 2560-sample step: 160 ms), 16 chunks
STREAM_FRAMES, STREAM_CHUNKS, STREAM_PASSES, STREAM_MEMORY = 16, 16, 3, 64
STREAM_MODELS = ("flagship", "streaming")
PER_CHUNK = _per(**ENCODER_FWD, fused_decode=1)
STREAM_STATE_TOL = 1e-4  # f32 decoder states card vs CPU: the LSTM steps' summation order, over up to 16 x 9 steps


def streaming_model(name: str, dtype, device) -> torch.nn.Module:
    """"flagship": the flagship as bench.py streams it (no memory);
    "streaming": ``conformer_small_streaming_config(memory_length=64)``, the
    small-streaming example (causal rel-MHSA, chunk 16, history 64, V 1000)
    with the JAX encoder's KV memory of 64 frames."""
    from tensorflowasr_tpu_torch.models.transducer.conformer import Conformer, conformer_small_streaming_config

    if name == "flagship":
        return flagship(dtype, device).eval()
    model = Conformer.from_config(conformer_small_streaming_config(memory_length=STREAM_MEMORY), dtype=dtype, device=device)
    model.reset_parameters(torch.Generator().manual_seed(SEED))
    return model.eval()


def stream_chunks(model, seed: int, device):
    """(chunks [1, 2800] each, samples per chunk, step) of one random stream cut by the frontend's chunk math."""
    from tensorflowasr_tpu_torch.ops import frontend

    size, step = frontend.FrontendConfig(**model.speech_config).get_signal_chunk_size_and_step(STREAM_FRAMES)
    audio = (np.random.default_rng(seed).standard_normal((1, (STREAM_CHUNKS - 1) * step + size)) * 0.1).astype(np.float32)
    return [torch.tensor(audio[:, i * step: i * step + size], device=device) for i in range(STREAM_CHUNKS)], size, step


def run_stream(model, chunks, size: int, device, per_chunk: dict | None = None) -> list:
    """One pass over the chunks through ``recognize``, carrying the next
    tokens, decoder states and encoder states from chunk to chunk; with
    ``per_chunk``, each chunk's kernel launches must equal it."""
    from tensorflowasr_tpu_torch import schemas
    from tensorflowasr_tpu_torch.models.transducer.base import recognize

    enc_states, tokens, dec_states = model.init_encoder_states(1, device), None, None
    n = torch.tensor([size], device=device)
    outs = []
    for i, chunk in enumerate(chunks):
        before = launch_counts()
        out = recognize(model, schemas.PredictInput(chunk, n, tokens, enc_states, dec_states))
        if per_chunk is not None:
            delta = {k: v - before[k] for k, v in launch_counts().items()}
            if delta != per_chunk:
                raise AssertionError(f"stream chunk {i}: kernel launches {delta}, expected {per_chunk}")
        tokens, enc_states, dec_states = out.next_tokens, out.next_encoder_states, out.next_decoder_states
        outs.append(out)
    return outs


def phase_streaming(dev) -> dict:
    """Both streaming models in bf16: a warm-up pass, one counted pass (each
    chunk's launches checked: the encoder's and one fused decode), then
    STREAM_PASSES timed passes; ms per chunk (median pass / chunks) and RTF."""
    paths = {}
    for name in STREAM_MODELS:
        model = streaming_model(name, torch.bfloat16, dev)
        chunks, size, step = stream_chunks(model, SEED + 21, dev)
        run_stream(model, chunks, size, dev)
        torch.cuda.synchronize()
        reset_launch_counts()
        outs = run_stream(model, chunks, size, dev, PER_CHUNK)
        torch.cuda.synchronize()
        paths[f"stream_{name}"] = counts = launch_counts()
        per_pass = []
        for _ in range(STREAM_PASSES):
            t0 = time.perf_counter()
            run_stream(model, chunks, size, dev)
            torch.cuda.synchronize()
            per_pass.append((time.perf_counter() - t0) / STREAM_CHUNKS * 1e3)
        ms, chunk_ms = float(np.median(per_pass)), step / 16.0
        emitted = sum(int((o.tokens != model.blank).sum()) for o in outs)
        mem = getattr(model.encoder, "memory_length", None)
        print(f"stream {name}: batch 1, {STREAM_CHUNKS} chunks of {STREAM_FRAMES} feature frames ({size} samples, step {step}: {chunk_ms:.0f} ms of audio), "
              f"encoder frames per chunk {outs[0].tokens.shape[1] // 2}, memory {mem}, vocabulary {model.vocab_size}; {ms:.3f} ms per chunk (median of "
              f"{STREAM_PASSES} passes: " + ", ".join(f"{p:.3f}" for p in per_pass) + f"), RTF per chunk {ms / chunk_ms:.4f} (wall / audio), "
              f"{chunk_ms / ms:.2f}x real time; launches per chunk {_launched(PER_CHUNK)}; tokens emitted over the stream {emitted}")
        print(f"stream {name} launches over {STREAM_CHUNKS} chunks: {_launched(counts)}")
    return paths


def phase_stream_parity(dev) -> None:
    """Both streaming models in f32: the 16-chunk stream on the card
    (kernels) and on a CPU copy (plain versions) from the same weights; each
    chunk's tokens and next token equal, its carried decoder states within
    STREAM_STATE_TOL and its encoder memories within PARITY_ATOL."""
    for name in STREAM_MODELS:
        cpu_model = streaming_model(name, torch.float32, "cpu")
        model = copy.deepcopy(cpu_model).to(dev)
        chunks, size, _ = stream_chunks(cpu_model, SEED + 22, "cpu")
        got, ref = run_stream(model, [c.to(dev) for c in chunks], size, dev), run_stream(cpu_model, chunks, size, "cpu")
        worst_dec = worst_mem = 0.0
        for i, (g, r) in enumerate(zip(got, ref)):
            if not (torch.equal(g.tokens.cpu(), r.tokens) and torch.equal(g.next_tokens.cpu(), r.next_tokens)):
                raise AssertionError(f"stream parity {name} chunk {i}: tokens card {g.tokens.tolist()} vs CPU {r.tokens.tolist()}")
            for x, y in zip(g.next_decoder_states, r.next_decoder_states):
                worst_dec = max(worst_dec, _close(f"stream parity {name} chunk {i} decoder state", torch.stack(x).cpu(), torch.stack(y), STREAM_STATE_TOL, 0.0))
            for x, y in zip(g.next_encoder_states or [], r.next_encoder_states or []):
                if not torch.equal(x["mask"].cpu(), y["mask"]):
                    raise AssertionError(f"stream parity {name} chunk {i}: memory masks differ")
                worst_mem = max(worst_mem, _close(f"stream parity {name} chunk {i} memory", torch.stack([x["k"], x["v"]]).cpu(), torch.stack([y["k"], y["v"]]),
                                                  PARITY_ATOL, 0.0))
        print(f"parity f32 stream {name}: {STREAM_CHUNKS} chunks card (kernels) vs CPU (plain): tokens and next tokens equal on every chunk "
              f"({sum(int((o.tokens != 0).sum()) for o in ref)} tokens); carried decoder states max_abs_err {worst_dec:.3e} (tol {STREAM_STATE_TOL}), "
              f"encoder memories {worst_mem:.3e} (tol {PARITY_ATOL}), TF32 off")


# ------------------------------------- the CTC models ------------------------------------- #

CTC_MODELS = ("conformer_ctc", "transformer_ctc")
CTC_D_MODEL, CTC_HEAD, CTC_FF_DIM = 176, 44, 704  # Conformer-CTC Small
TCTC_HEADS, TCTC_HEAD = 4, 128  # Transformer-CTC base
# the CTC DP (f32 only) chains 2·T log-sum-exps of three: loss to 1e-5 relative; occupancies (in [−1, 0]) to 1e-5 absolute
CTC_LOSS_TOL, CTC_OCC_TOL = (0.0, 1e-5), (1e-5, 0.0)


def ctc_model(name: str, dtype, device, num_blocks: int | None = None, dropout: float = TRAIN_RATE, conditioned: bool = False) -> torch.nn.Module:
    """A CTC model at its published widths, random weights from SEED. With
    ``conditioned`` (the card/CPU parity) the Transformer's input linear is
    drawn 1/√dmodel smaller: its output is scaled by √dmodel before the PE,
    and with lecun-normal weights the attention scores are otherwise O(500),
    the softmax near one-hot and the gradients ill-conditioned (a 1e-6
    input change moves them by 5e-3 on the CPU alone)."""
    from tensorflowasr_tpu_torch.models.ctc.conformer import ConformerCtc, conformer_ctc_small_config
    from tensorflowasr_tpu_torch.models.ctc.transformer import TransformerCtc, transformer_ctc_base_config

    cls, make_cfg = {"conformer_ctc": (ConformerCtc, conformer_ctc_small_config), "transformer_ctc": (TransformerCtc, transformer_ctc_base_config)}[name]
    cfg = make_cfg(dropout=dropout, **({} if num_blocks is None else {"num_blocks": num_blocks}))
    model = cls.from_config(cfg, dtype=dtype, device=device)
    model.reset_parameters(torch.Generator().manual_seed(SEED))
    if conditioned and name == "transformer_ctc":
        with torch.no_grad():
            model.encoder.linear.weight.mul_(cfg["encoder_dmodel"] ** -0.5)
    return model


def cost_ctc(t_len: np.ndarray, u_len: np.ndarray, t: int, s: int):
    """lp_ext read over each row's lattice (T_b·(2U_b+1) cells) and the skip
    row, the occupancy [B, T, S] and the loss written, f32; per lattice cell
    two log-sum-exps of three (~12 operations each) and the occupancy's
    exponential (~4)."""
    cells = float(np.sum(t_len * (2 * u_len + 1)))
    b = len(t_len)
    return 4 * cells + 4 * b * s + 4 * b * t * s + 4 * b, 28 * cells


def cost_vanilla_attention(bh: int, t: int, s: int, d: int, elt: int, bias_bytes: int, bwd: bool):
    """fwd: q, k, v, bias → out; QKᵀ and PV (4·BH·T·S·D). bwd: q, k, v, bias,
    out, dout → dq, dk, dv (no dbias: the path's bias is a constant mask);
    QKᵀ recomputed, do·vᵀ, dv, dq, dk (10·BH·T·S·D)."""
    if bwd:
        return (4 * t + 4 * s) * bh * d * elt + bias_bytes, 10 * bh * t * s * d
    return (2 * t + 2 * s) * bh * d * elt + bias_bytes, 4 * bh * t * s * d


def bf16_spacing(x: torch.Tensor) -> torch.Tensor:
    """The gap between adjacent bf16 values at |x| (8 significant bits)."""
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), torch.frexp(x.float().abs()).exponent - 8)


def attention_accuracy(fargs: tuple, bargs: tuple, bwd_kernel, bwd_plain) -> None:
    """Kernel A in bf16 against its plain version, and both against a float64
    run of the same function on the same inputs and keep mask (no rounding
    inside): where the two bf16 versions differ, where they differ by more
    than one final rounding, and whether the kernel lies farther from the
    exact result than the plain version does."""
    from tensorflowasr_tpu_torch.ops.cuda import attention_kernel as ak

    q, k, v, bias, seed, rate = fargs
    dout = bargs[6]
    keep = ak.dropout_mask(seed, q.shape[0], q.shape[1], k.shape[1], rate, q.device).double() if rate > 0 else 1.0
    x64 = [x.double().requires_grad_(True) for x in (q, k, v)]
    # the scores pass through f32 as the function defines them: a -1e9 row bias swallows q.k^T there (a uniform row)
    scores = (x64[0] @ x64[1].transpose(1, 2) + bias.double()).float().double()
    ref = (torch.softmax(scores, dim=-1) * keep) @ x64[2]
    refs = (ref.detach(), *torch.autograd.grad(ref, x64, dout.double()))
    kern = (ak.fused_attention_kernel(*fargs), *bwd_kernel(*bargs))
    plain = (ak.fused_attention_plain(*fargs), *bwd_plain(*bargs))
    print(f"kernel fused_attention bf16 accuracy (rate {rate}, BH {q.shape[0]} T = S {q.shape[1]} head {q.shape[2]}): "
          + accuracy_parts(("out", "dq", "dk", "dv"), kern, plain, refs))


def phase_ctc_kernels(dev, rows: list[dict]) -> list[dict]:
    """The CTC kernel (row 11) and kernel A (row 4) at the CTC training
    shapes, with their library yardsticks; and the four encoder kernels at
    Conformer-CTC's widths (D 176, head 44), whose numbers go onto the
    existing rows under ``conformer_ctc``. Returns the new rows."""
    import torch.nn.functional as F

    from tensorflowasr_tpu_torch.ops.ctc_loss import ctc_occupancy_plain, ctc_prep
    from tensorflowasr_tpu_torch.ops.cuda import attention_kernel as ak
    from tensorflowasr_tpu_torch.ops.cuda import ctc_kernel as ctk

    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    t_np, u_np = loss_lengths(np.random.default_rng(SEED + 2), TRAIN_B)
    t_len, u_len = torch.tensor(t_np, device=dev), torch.tensor(u_np, device=dev)
    labels = torch.randint(1, VOCAB, (TRAIN_B, TRAIN_U), generator=gen, device=dev)
    labels[torch.arange(TRAIN_U, device=dev)[None, :] >= u_len[:, None]] = 0
    s = 2 * TRAIN_U + 1
    occ_err, loss_err = {}, {}
    for tag, dt in DTYPES:
        logits = _randn(gen, (TRAIN_B, T_ENC, VOCAB), 2.0, dt)
        lp_ext, skip, _ = ctc_prep(logits, labels)
        occ, loss = ctk.ctc_kernel(lp_ext, skip, t_len, u_len)
        ref_occ, ref_loss = ctc_occupancy_plain(lp_ext, skip, t_len, u_len)
        occ_err[tag] = _close(f"ctc occupancy {tag}", occ, ref_occ, *CTC_OCC_TOL)
        _close(f"ctc loss {tag}", loss, ref_loss, *CTC_LOSS_TOL)
        loss_err[tag] = ((loss - ref_loss).abs() / ref_loss.abs()).max().item()
    ms, plain_ms = time_ms(ctk.ctc_kernel, lp_ext, skip, t_len, u_len), time_ms(ctc_occupancy_plain, lp_ext, skip, t_len, u_len)
    bd = bound(*cost_ctc(t_np, u_np, T_ENC, s), "f32")
    # the library yardstick: F.ctc_loss over log_softmax output, per row (reduction none), forward and forward+backward
    lp = torch.log_softmax(logits.float(), dim=-1).transpose(0, 1).contiguous().requires_grad_(True)
    lib = lambda: F.ctc_loss(lp, labels, t_len, u_len, blank=0, reduction="none")
    with torch.no_grad():
        lib_loss = lib()
    lib_fwd = time_ms(lambda: lib().detach())
    lib_fb = time_ms(lambda: torch.autograd.grad(lib().sum(), lp))
    x = logits.detach().requires_grad_(True)
    op_fwd = time_ms(lambda: ctk.ctc_loss_pallas(x, t_len, labels, u_len).detach())
    op_fb = time_ms(lambda: torch.autograd.grad(ctk.ctc_loss_pallas(x, t_len, labels, u_len).sum(), x))
    lib_rel = ((lib_loss - loss) / loss).abs().max().item()
    print(f"kernel ctc_loss (ctc train loss): lp_ext [{TRAIN_B}, {T_ENC}, {s}] f32 from V {VOCAB} logits, T_b {t_np.min()}-{t_np.max()}, U_b "
          f"{u_np.min()}-{u_np.max()}; occupancy max_abs_err f32 {occ_err['f32']:.3e} bf16 {occ_err['bf16']:.3e} (tol {CTC_OCC_TOL}), loss rel err "
          f"{max(loss_err.values()):.3e} (tol {CTC_LOSS_TOL}); kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound {bd[0]:.4f} ms ({bd[1]})")
    print(f"library F.ctc_loss (ctc train loss, bf16 logits' log_softmax, reduction none): forward {lib_fwd:.4f} ms, forward+backward {lib_fb:.4f} ms "
          f"(loss rel diff to the kernel {lib_rel:.2e}); the port's whole ctc_loss_pallas on the logits (prep, kernel, softmax − occupancy): forward "
          f"{op_fwd:.4f} ms, forward+backward {op_fb:.4f} ms")
    row = _row("ctc_loss", {"f32": occ_err["f32"], "bf16": occ_err["bf16"]}, ms, plain_ms, bd)
    row.update(dtype="float32", loss_rel_err=max(loss_err.values()), library_ms=lib_fb, library_fwd_ms=lib_fwd, op_fwd_ms=op_fwd, op_fwd_bwd_ms=op_fb)
    new = [row]

    # kernel A at the Transformer-CTC training shape: B·H 64, T = S = 400, head 128, rate 0.1, the padded-row bias of a ragged batch
    bh, t, d = TRAIN_B * TCTC_HEADS, T_ENC, TCTC_HEAD
    valid = torch.arange(t, device=dev)[None, :] < t_len.repeat_interleave(TCTC_HEADS)[:, None]  # [BH, T]

    def att_make(dt, rate=TRAIN_RATE):
        q, k, v = _randn(gen, (bh, t, d), 0.3, dt), _randn(gen, (bh, t, d), 1.0, dt), _randn(gen, (bh, t, d), 1.0, dt)
        bias = torch.where(valid, 0.0, -1e9)[:, :, None].expand(bh, t, t).to(dt).contiguous()
        cfg_ = (19, rate)
        out, stats = ak.fused_attention_kernel(q, k, v, bias, *cfg_, with_stats=True)
        return (q, k, v, bias, *cfg_), (q, k, v, bias, out, stats, _randn(gen, (bh, t, d), 1.0, dt), *cfg_)

    def bwd_kernel(q, k, v, bias, out, stats, dout, seed, rate):
        return ak.fused_attention_bwd_kernel(q, k, v, bias, out, dout, seed, rate, bias_grad=False, stats=stats)[:3]

    def bwd_plain(q, k, v, bias, out, stats, dout, seed, rate):
        return ak.fused_attention_plain_bwd(q, k, v, bias, dout, seed, rate, bias_grad=False)[:3]

    att = _check_fwd_bwd("fused_attention", ak.fused_attention_kernel, ak.fused_attention_plain, bwd_kernel, bwd_plain, att_make,
                         lambda elt, bwd: cost_vanilla_attention(bh, t, t, d, elt, bh * t * t * elt, bwd),
                         what=f"transformer-ctc train, BH {bh} T = S {t} head {d}, rate {TRAIN_RATE}")
    stat_err = {}
    for tag, dt in DTYPES:  # the row statistics the forward returns for the backward, against the plain ones (f32 sums in another order)
        (q, k, v, bias, *_), (_, _, _, _, _, stats, *_) = att_make(dt)
        stat_err[tag] = _close(f"fused_attention stats {tag}", stats, ak.fused_attention_plain_stats(q, k, bias), 1e-5, 1e-5)
    # kernel and SDPA on the same bf16 inputs at rate 0 and at rate 0.1 (SDPA's own dropout, under autograd); SDPA with scale 1:
    # the kernel takes q already scaled
    times = {}
    for rate in (0.0, TRAIN_RATE):
        fargs, bargs = att_make(torch.bfloat16, rate)
        q, k, v, bias = fargs[:4]
        qs, ks, vs = (a.detach().clone().requires_grad_(True) for a in (q, k, v))
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, attn_mask=bias, dropout_p=rate, scale=1.0)
        out = sdpa()
        dout = bargs[6]
        times[rate] = dict(fwd=time_ms(ak.fused_attention_kernel, *fargs), bwd=time_ms(bwd_kernel, *bargs),
                           sdpa_fwd=time_ms(lambda: sdpa().detach()), sdpa_bwd=time_ms(lambda: torch.autograd.grad(out, (qs, ks, vs), dout, retain_graph=True)))
        r = times[rate]
        print(f"kernel fused_attention bf16 at rate {rate} (transformer-ctc train, BH {bh} T = S {t} head {d}): forward {r['fwd']:.4f} ms, backward "
              f"{r['bwd']:.4f} ms; library F.scaled_dot_product_attention (attn_mask = the bias, dropout_p {rate}, scale 1): forward "
              f"{r['sdpa_fwd']:.4f} ms, backward {r['sdpa_bwd']:.4f} ms; the earlier CUDA-core kernels (PERF.md row 4, rate 0.1): forward 1.2695 ms, "
              f"backward 3.3333 ms")
    print(f"kernel fused_attention row statistics (m, l): max_abs_err f32 {stat_err['f32']:.3e} bf16 {stat_err['bf16']:.3e} (tol 1e-5 + 1e-5 rel)")
    attention_accuracy(*att_make(torch.bfloat16), bwd_kernel, bwd_plain)
    att[0]["library_ms"], att[1]["library_ms"] = times[TRAIN_RATE]["sdpa_fwd"], times[TRAIN_RATE]["sdpa_bwd"]
    att[0].update(ms_rate0=times[0.0]["fwd"], library_ms_rate0=times[0.0]["sdpa_fwd"], stats_max_abs_err=stat_err)
    att[1].update(ms_rate0=times[0.0]["bwd"], library_ms_rate0=times[0.0]["sdpa_bwd"])
    new += att

    ctc_width = encoder_kernel_rows(dev, gen, CTC_D_MODEL, CTC_HEAD, CTC_FF_DIM, f"conformer-ctc train, D {CTC_D_MODEL} head {CTC_HEAD}, rate {TRAIN_RATE}")
    by_name = {r["name"]: r for r in rows}
    for r in ctc_width:
        by_name[r["name"]]["conformer_ctc"] = {k: r[k] for k in ("max_abs_err", "max_abs_err_bf16", "ms", "plain_ms", "bound_ms", "bound_by")}
    return new


PER_REQUEST_CTC = {"conformer_ctc": _per(**ENCODER_FWD), "transformer_ctc": _per(log_mel_spectrogram=1, fused_attention=6)}
PER_STEP_CTC_XLA = {"conformer_ctc": _per(**ENCODER_FWD, **ENCODER_BWD),
                    "transformer_ctc": _per(log_mel_spectrogram=1, fused_attention=6, fused_attention_bwd=6)}
PER_STEP_CTC = {name: {**counts, "ctc_loss": 1} for name, counts in PER_STEP_CTC_XLA.items()}
PER_EVAL_CTC = {name: {**counts, "ctc_loss": 1} for name, counts in PER_REQUEST_CTC.items()}
CTC_STEPS = 4
# Adam without warm-up: the post-norm Transformer-CTC with random weights diverges at 1e-4 (its input is scaled by √dmodel;
# a CPU probe at 6 blocks, 4 × 4 s: 2293 → 3684 over 4 steps at 1e-4, 2293 → 1894 at 1e-5). Its published recipe warms up over 10k steps.
CTC_LR = {"conformer_ctc": 1e-4, "transformer_ctc": 1e-5}


def phase_ctc_serve(dev) -> dict:
    """Each CTC model at full width (bf16): 3 requests of 8 × 6–10 s through
    greedy ``recognize``, launches checked per request; wall, encode and
    decode ms."""
    from tensorflowasr_tpu_torch import schemas
    from tensorflowasr_tpu_torch.models.ctc.base import recognize
    from tensorflowasr_tpu_torch.ops.ctc_decode import ctc_greedy_decode

    paths = {}
    for name in CTC_MODELS:
        model = ctc_model(name, torch.bfloat16, dev).eval()
        rng = np.random.default_rng(SEED)
        requests = [make_request(rng, 8, 6.0, 10.0, dev) for _ in range(3)]
        recognize(model, schemas.PredictInput(*make_request(rng, 8, 6.0, 10.0, dev)))  # warm-up request, not counted
        torch.cuda.synchronize()
        settle()
        reset_launch_counts()
        walls, outs, watches = [], [], []
        for r, (audio, lens) in enumerate(requests):
            before = launch_counts()
            with RequestWatch() as watch:
                t0 = time.perf_counter()
                outs.append(recognize(model, schemas.PredictInput(audio, lens)))
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            watches.append(watch)
            delta = {k: v - before[k] for k, v in launch_counts().items()}
            if delta != PER_REQUEST_CTC[name]:
                raise AssertionError(f"ctc serve {name} request {r}: kernel launches {delta}, expected {PER_REQUEST_CTC[name]}")
        counts = launch_counts()
        flag_outliers(f"ctc serve {name}", walls, watches)
        # encode and decode timed apart, on the same requests (after the counted run)
        for r, ((audio, lens), out) in enumerate(zip(requests, outs)):
            with torch.inference_mode():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, logits_len, _ = model.encode(audio, lens)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                tokens, ntok = ctc_greedy_decode(logits, logits_len)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
            if not torch.isfinite(logits.float()).all():
                raise AssertionError(f"ctc serve {name} request {r}: non-finite logits")
            if tuple(out.tokens.shape) != tuple(logits.shape[:2]) or not torch.equal(out.tokens, tokens):
                raise AssertionError(f"ctc serve {name} request {r}: tokens {tuple(out.tokens.shape)} differ from the greedy decode of the logits")
            if not ((out.tokens >= 0) & (out.tokens < model.vocab_size)).all() or (ntok > logits_len).any():
                raise AssertionError(f"ctc serve {name} request {r}: token ids outside the vocabulary or more tokens than frames")
            audio_s = lens.sum().item() / 16000.0
            print(f"ctc serve {name} request {r}: batch {audio.shape[0]}, audio {audio_s:.2f} s (max {audio.shape[1] / 16000:.2f} s), encoder frames "
                  f"{logits.shape[1]}, recognize {walls[r] * 1e3:.3f} ms ({watches[r]}), encode {(t1 - t0) * 1e3:.3f} ms, decode {(t2 - t1) * 1e3:.3f} ms, "
                  f"RTF {walls[r] / audio_s:.6f}, tokens mean {ntok.float().mean().item():.1f}")
        paths[f"ctc_serve_{name}"] = counts
        print(f"ctc serve {name} launches over 3 requests: {counts} (per request {PER_REQUEST_CTC[name]})")
        outlier_hunt(f"ctc serve {name}", model, recognize, np.random.default_rng(SEED + 9), dev)
    return paths


def phase_ctc_train(dev) -> dict:
    """Each CTC model at full width: CTC_STEPS default (auto) steps of the
    training batch (16 × ≤ 16 s, labels 40–128, bf16, dropout 0.1, Adam at
    CTC_LR), the loss falling, one profiled step; one xla step (the plain α
    recursion) from the same weights and generator seed, its loss held to
    the first auto step's (1e-4 relative); then 3 eval steps (default
    loss_impl) against the xla eval (1e-5 relative)."""
    from tensorflowasr_tpu_torch.training.trainer import make_eval_step

    paths = {}
    for name in CTC_MODELS:
        tag = f"ctc train {name}"
        counts, losses, walls, trainer, state, batch, splits = run_train(dev, "auto", CTC_STEPS, PER_STEP_CTC[name], tag,
                                                                         model=ctc_model(name, torch.bfloat16, dev), lr=CTC_LR[name])
        if not losses[-1] < losses[0]:
            raise AssertionError(f"{tag}: loss did not fall over {CTC_STEPS} steps: {losses}")
        profile_step(trainer, state, batch, walls, tag, top=10)
        paths[f"ctc_train_{name}"] = counts
        del trainer, state
        xla_counts, xla_losses, *_ = run_train(dev, "xla", 1, PER_STEP_CTC_XLA[name], f"{tag} xla", model=ctc_model(name, torch.bfloat16, dev),
                                               lr=CTC_LR[name])
        rel = abs(xla_losses[0] - losses[0]) / abs(losses[0])
        if rel > 1e-4:
            raise AssertionError(f"{tag}: first step loss xla {xla_losses[0]} vs auto {losses[0]} (rel {rel:.2e} > 1e-4)")
        print(f"{tag}: first step loss auto (CTC kernel) {losses[0]:.4f} vs xla (plain α recursion) {xla_losses[0]:.4f}, rel {rel:.2e} (tol 1e-4)")
        paths[f"ctc_train_{name}_xla"] = xla_counts

        # evaluation: the default loss_impl (the CTC kernel) against the plain α recursion
        from tensorflowasr_tpu_torch.training.trainer import Trainer

        model = ctc_model(name, torch.bfloat16, dev)
        trainer = Trainer(model, {"class_name": "Adam", "config": {"learning_rate": 1e-4}}, device=dev)
        state = trainer.init_state(seed=SEED)
        torch.cuda.synchronize()
        reset_launch_counts()
        eval_losses = []
        for step in range(EVAL_STEPS):
            before = launch_counts()
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            loss = trainer.eval_step(state, batch)["loss"].item()
            wall = (time.perf_counter() - t0) * 1e3
            delta = {k: v - before[k] for k, v in launch_counts().items()}
            if delta != PER_EVAL_CTC[name] or not np.isfinite(loss):
                raise AssertionError(f"ctc eval {name} step {step}: launches {delta} (expected {PER_EVAL_CTC[name]}), loss {loss}")
            print(f"ctc eval {name} step {step}: {wall:.1f} ms (host clock, ends in the loss's .item()); loss {loss:.6f}; "
                  f"peak memory {torch.cuda.max_memory_allocated(dev) / 2**20:.0f} MiB")
            eval_losses.append(loss)
        paths[f"ctc_eval_{name}"] = launch_counts()
        t0 = time.perf_counter()
        xla = make_eval_step(model, "xla")(state, batch)["loss"].item()
        xla_wall = (time.perf_counter() - t0) * 1e3
        if not abs(eval_losses[0] - xla) <= 1e-5 * abs(xla):
            raise AssertionError(f"ctc eval {name}: default (CTC kernel) {eval_losses[0]} vs xla {xla}")
        print(f"ctc eval {name} loss default (CTC kernel) {eval_losses[0]:.6f} vs xla (plain α recursion) {xla:.6f} "
              f"(rel {abs(eval_losses[0] - xla) / abs(xla):.2e}, tol 1e-5); the xla eval step took {xla_wall:.1f} ms")
        del trainer, state, model
    return paths


def phase_ctc_parity(dev) -> None:
    """The f32 auto step of each 2-block CTC model, card vs CPU; and on the
    card the CTC kernel's loss against the plain α recursion's over the same logits."""
    from tensorflowasr_tpu_torch.ops.losses import get_ctc_loss_fn

    for name in CTC_MODELS:
        model, b = _step_parity(dev, "auto", "auto", cpu_model=ctc_model(name, torch.float32, "cpu", num_blocks=2, dropout=0.0, conditioned=True),
                                what=f"{name}, auto")
        with torch.no_grad():
            out = model(b.inputs, train=True)
            args = (out.logits, out.logits_length, b.labels.labels, b.labels.labels_length)
            xla, kernel = get_ctc_loss_fn("xla")(*args).item(), get_ctc_loss_fn("auto")(*args).item()
        if not abs(kernel - xla) <= 1e-5 * abs(xla):
            raise AssertionError(f"f32 CTC loss on the card: kernel {kernel} vs xla {xla}")
        print(f"parity f32 loss on the card ({name}), CTC kernel vs xla (plain α recursion) over the same logits: {kernel:.6f} vs {xla:.6f} "
              f"(rel {abs(kernel - xla) / abs(xla):.2e}, tol 1e-5)")



@contextlib.contextmanager
def plain_attention():
    """Within the block, vanilla attention runs kernel A's plain forward under autograd, on any device."""
    from tensorflowasr_tpu_torch.models.layers import attention
    from tensorflowasr_tpu_torch.ops.cuda import attention_kernel as ak

    fused = attention.fused_attention
    attention.fused_attention = ak.fused_attention_plain
    try:
        yield
    finally:
        attention.fused_attention = fused


@contextlib.contextmanager
def float64_plain_path():
    """Within the block, float64 is the default dtype, ``Tensor.float()``
    leaves float64 tensors as they are (the port's modules compute their
    statistics, softmaxes and losses after ``.float()``, which would round a
    float64 run to float32 there), and vanilla attention takes the plain
    path (kernel A's explicit plain backward computes in float32)."""
    to_float, default = torch.Tensor.float, torch.get_default_dtype()
    torch.Tensor.float = lambda self, *a, **k: self if self.dtype == torch.float64 else to_float(self, *a, **k)
    torch.set_default_dtype(torch.float64)
    try:
        with plain_attention():
            yield
    finally:
        torch.Tensor.float = to_float
        torch.set_default_dtype(default)


def ctc_referee_grads(devices) -> dict:
    """The Transformer-CTC step of ``phase_ctc_parity`` at the published
    lecun init (the input linear not shrunk): 2 blocks, batch 2 × ≤ 4 s,
    dropout 0, from the same log-mel features (the CPU frontend's, f32) on
    every run, so that only the encoder, the vocabulary projection and the
    loss differ. Returns {name: (loss, gradients by parameter)} for each
    (name, device, dtype, loss_impl, plain) in ``devices`` (``plain``: the
    attention through kernel A's plain version); the float64 run goes
    through the plain path under ``float64_plain_path``."""
    from tensorflowasr_tpu_torch.ops.losses import get_ctc_loss_fn

    base = ctc_model("transformer_ctc", torch.float32, "cpu", num_blocks=2, dropout=0.0)
    batch = train_batch(np.random.default_rng(SEED + 3), 2, 4.0, 32, base.vocab_size)
    with torch.no_grad():
        feats, flens = base.feature_extraction(batch.inputs.inputs, batch.inputs.inputs_length)
    out = {}
    for name, device, dtype, loss_impl, plain in devices:
        if dtype == torch.float64:
            model = ctc_model("transformer_ctc", torch.float64, "cpu", num_blocks=2, dropout=0.0).double()
            model.load_state_dict(base.state_dict())
        else:
            model = copy.deepcopy(base).to(device)
        with float64_plain_path() if dtype == torch.float64 else plain_attention() if plain else contextlib.nullcontext():
            enc, elens, _ = model.encoder(feats.to(device, dtype), flens.to(device), train=True)
            loss = get_ctc_loss_fn(loss_impl)(model.vocab(enc), elens, batch.labels.labels.to(device), batch.labels.labels_length.to(device))
            loss.backward()
        out[name] = (loss.item(), {n: p.grad.detach().cpu().double() for n, p in model.named_parameters() if p.grad is not None})
    return out


def phase_ctc_referee(dev) -> None:
    """Queue 3 item 1: the Transformer-CTC f32 step at the published init on
    the card (kernels) and on the CPU (plain versions), from the same
    features, each held to the CPU plain path in float64. Conditioning
    moves both f32 runs about equally far from float64; a kernel A fault
    moves the card's alone."""
    runs = ctc_referee_grads([("card f32", dev, torch.float32, "auto", False), ("card f32 plain attention", dev, torch.float32, "auto", True),
                              ("cpu f32", "cpu", torch.float32, "auto", False), ("cpu f64", "cpu", torch.float64, "xla", True)])
    ref_loss, ref = runs["cpu f64"]
    floor = TRAIN_PARITY_FLOOR * max(g.abs().max().item() for g in ref.values())  # gradients that are zero in exact arithmetic (the key biases)
    dist = {}
    for name in ("card f32", "card f32 plain attention", "cpu f32"):
        loss, grads = runs[name]
        rel = {n: ((grads[n] - g).abs().max() / (g.abs().max() + floor)).item() for n, g in ref.items()}
        worst = max(rel, key=rel.get)
        dist[name] = (rel, worst)
        print(f"ctc referee (transformer-ctc, 2 blocks, lecun init, batch 2 x <= 4 s): {name} loss {loss:.10g} vs f64 {ref_loss:.10g} "
              f"(rel {abs(loss - ref_loss) / abs(ref_loss):.2e}); gradients vs f64, max abs error over (scale + {TRAIN_PARITY_FLOOR} x the largest "
              f"gradient): median {np.median(list(rel.values())):.3e}, largest {rel[worst]:.3e} at {worst}")
    card, plain, cpu = (dist[n][0] for n in ("card f32", "card f32 plain attention", "cpu f32"))
    ratio = {n: card[n] / max(plain[n], 1e-30) for n in card}
    worst = max(ratio, key=ratio.get)
    verdict = "conditioning" if max(card.values()) <= 4.0 * max(plain.values()) else f"kernel A fault (the card's {worst} gradient)"
    print(f"ctc referee verdict: {verdict}: kernel A / plain attention distance ratio on the card median {np.median(list(ratio.values())):.3g}, "
          f"largest {ratio[worst]:.3g} at {worst}; largest distances: card with kernel A {max(card.values()):.3e}, card with plain attention "
          f"{max(plain.values()):.3e}, CPU {max(cpu.values()):.3e}")


def host_profile(trainer, state, batch, steps: int = HOST_STEPS, top: int = 12) -> tuple[dict, list]:
    """Where the host spends a training step: over ``steps`` more steps the
    median wall (host clock, ends in a synchronise), the median time until
    ``train_step`` returns (the host's enqueue; the step reads no value back)
    and the main thread's CPU time over that span (``time.thread_time``);
    then one step under the CPU profiler, its ops by self CPU time (ms per
    step, calls)."""
    from torch.profiler import ProfilerActivity, profile

    wall, enqueue, cpu = [], [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        c0, t0 = time.thread_time(), time.perf_counter()
        state, _ = trainer.train_step(state, batch)
        c1, t1 = time.thread_time(), time.perf_counter()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        enqueue.append((t1 - t0) * 1e3)
        cpu.append((c1 - c0) * 1e3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.train_step(state, batch)
        torch.cuda.synchronize()
    ops = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total, reverse=True)[:top]
    nums = dict(wall_ms=float(np.median(wall)), enqueue_ms=float(np.median(enqueue)), host_cpu_ms=float(np.median(cpu)))
    return nums, [(e.key, e.self_cpu_time_total / 1e3, e.count) for e in ops]


def phase_steps(dev) -> dict:
    """The end-to-end numbers a kernel change should move, in one process:
    the flagship ``auto`` step (median wall after the first of TRAIN_STEPS,
    the card's kernel time in one profiled step with its busy share, and the
    host's share from :func:`host_profile`), the ``auto`` step with the LSTM
    kernels, the Conformer-CTC step (wall, kernel time, busy share), the
    flagship's served request (median of 3 after a warm-up) and its
    streaming ms per chunk (median pass; then one pass's main-thread CPU
    time and one profiled pass's card kernel time, per chunk; the same two
    for one more served request). Every run checks its launches as the full
    phases do. The host profile's ops go under ``"host_top"``."""
    from tensorflowasr_tpu_torch import schemas
    from tensorflowasr_tpu_torch.models.transducer.base import recognize

    res = {}
    _, _, walls, trainer, state, batch, _ = run_train(dev, "auto", TRAIN_STEPS, PER_STEP, "steps train")
    res["flagship_auto_ms"] = float(np.median(walls[1:]))
    res["flagship_auto_kernel_ms"], res["flagship_auto_busy_pct"] = profile_step(trainer, state, batch, walls, "steps train", top=5)
    host, res["host_top"] = host_profile(trainer, state, batch)
    res.update({f"flagship_auto_{k}": v for k, v in host.items()})
    del trainer, state
    _, _, walls, *_ = run_train(dev, "auto", 4, PER_STEP_AUTO_LSTM, "steps train auto+lstm", rnn_impl="pallas")
    res["flagship_auto_lstm_ms"] = float(np.median(walls[1:]))
    name = "conformer_ctc"
    _, _, walls, trainer, state, batch, _ = run_train(dev, "auto", TRAIN_STEPS, PER_STEP_CTC[name], f"steps ctc train {name}",
                                                     model=ctc_model(name, torch.bfloat16, dev), lr=CTC_LR[name])
    res["conformer_ctc_ms"] = float(np.median(walls[1:]))
    res["conformer_ctc_kernel_ms"], res["conformer_ctc_busy_pct"] = profile_step(trainer, state, batch, walls, f"steps ctc train {name}", top=5)
    del trainer, state
    model = flagship(torch.bfloat16, dev).eval()
    rng = np.random.default_rng(SEED)
    requests = [make_request(rng, 8, 6.0, 10.0, dev) for _ in range(4)]
    walls = []
    settle()
    for audio, lens in requests:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        recognize(model, schemas.PredictInput(audio, lens))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    res["serve_request_ms"] = float(np.median(walls[1:]))
    from torch.profiler import ProfilerActivity, profile

    audio, lens = requests[1]
    c0 = time.thread_time()
    recognize(model, schemas.PredictInput(audio, lens))
    torch.cuda.synchronize()
    res["serve_host_cpu_ms"] = (time.thread_time() - c0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        recognize(model, schemas.PredictInput(audio, lens))
        torch.cuda.synchronize()
    res["serve_kernel_ms"] = sum(e.self_device_time_total for e in prof.key_averages()
                                 if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation) / 1e3
    model = streaming_model("flagship", torch.bfloat16, dev)
    chunks, size, _ = stream_chunks(model, SEED + 21, dev)
    per_pass = []
    for _ in range(STREAM_PASSES + 1):
        t0 = time.perf_counter()
        run_stream(model, chunks, size, dev)
        torch.cuda.synchronize()
        per_pass.append((time.perf_counter() - t0) / STREAM_CHUNKS * 1e3)
    res["stream_ms_per_chunk"] = float(np.median(per_pass[1:]))
    c0 = time.thread_time()
    run_stream(model, chunks, size, dev)
    torch.cuda.synchronize()
    res["stream_host_cpu_ms_per_chunk"] = (time.thread_time() - c0) / STREAM_CHUNKS * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_stream(model, chunks, size, dev)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    res["stream_kernel_ms_per_chunk"] = sum(e.self_device_time_total for e in kernels) / 1e3 / STREAM_CHUNKS
    return res


TURNS = ("parent", "this", "this", "parent", "parent", "this")


def compare_steps(parent: str) -> None:
    """The step numbers of the package in ``parent`` (a checkout of another
    commit) and of this one, on this card in ``TURNS``, each in its own
    process (``--steps``)."""
    runs = []
    for who in TURNS:
        cmd = [sys.executable, __file__, "--steps"] + (["--package", parent] if who == "parent" else [])
        proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise AssertionError(f"{who} steps run failed ({proc.returncode}):\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        runs.append((who, json.loads(proc.stdout.strip().splitlines()[-1])["steps"]))
        print(f"steps host_top ({who}, flagship auto step, ms of self CPU time in one step, calls): "
              + "; ".join(f"{name} {ms:.2f} ({n})" for name, ms, n in runs[-1][1].pop("host_top")))
    for key in runs[0][1]:
        vals = {w: [r[key] for who, r in runs if who == w] for w in ("parent", "this")}
        print(f"steps {key}: parent " + " / ".join(f"{x:.3f}" for x in vals["parent"]) + ", this commit " + " / ".join(f"{x:.3f}" for x in vals["this"])
              + f" (in turns: {', '.join(TURNS)})")


def main(argv: list[str]) -> int:
    """No arguments: every phase (the check). ``--steps [--package DIR]``: only
    :func:`phase_steps`, of the package under DIR when given, as one JSON line.
    ``--compare-parent DIR``: :func:`compare_steps` against the package under DIR."""
    _need_card()
    if "--package" in argv:
        sys.path.insert(0, argv[argv.index("--package") + 1])
    from tensorflowasr_tpu_torch.ops.cuda import _build  # fails here when the package is absent, before any output

    if "--steps" in argv:
        _no_tf32()
        print(json.dumps({"steps": phase_steps(torch.device("cuda", 0)), "package": str(_build.CSRC.parent)}))
        return 0
    if "--compare-parent" in argv:
        compare_steps(argv[argv.index("--compare-parent") + 1])
        return 0

    _no_tf32()
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, check=True).stdout.strip()
    print(f"device: {name}; count {torch.cuda.device_count()}; torch {torch.__version__} cuda {torch.version.cuda}; TF32 off (matmul and cuDNN)")
    print(smi.splitlines()[0])

    _build.build()
    print(f"build: {_build.build_seconds:.2f} s (nvcc, {len(_build.SOURCES)} sources compiled in parallel, one link)")

    serve_kernels = phase_kernels(dev)
    rows = phase_train_kernels(dev) + phase_lstm_kernels(dev)
    rows += phase_ctc_kernels(dev, rows)
    rows.append(phase_decode_kernel(dev))
    paths = {"serve": phase_serve(dev)}
    paths.update(phase_streaming(dev))
    train_paths, auto = phase_train(dev)
    paths.update(train_paths)
    paths["eval"] = phase_eval(dev)
    paths.update(phase_pallas(dev, auto))
    paths.update(phase_ctc_serve(dev))
    paths.update(phase_ctc_train(dev))
    for row in rows:
        row["launches_by_path"] = {path: counts[row["name"]] for path, counts in paths.items()}
        row["launches"] = sum(row["launches_by_path"].values())
        if row["name"] in serve_kernels:
            row["serve_ms"], row["serve_plain_ms"] = serve_kernels[row["name"]][2:]
        if row["launches"] == 0:
            raise AssertionError(f"{row['name']}: no launch on any driven path")
    if {row["name"] for row in rows} != set(KERNELS):
        raise AssertionError(f"kernel rows {sorted(row['name'] for row in rows)} differ from the counted kernels {sorted(KERNELS)}")
    print("launches by path (" + ", ".join(paths) + "): " + "; ".join(f"{row['name']} {list(row['launches_by_path'].values())}" for row in rows))
    phase_parity(dev)
    phase_train_parity(dev)
    phase_ctc_parity(dev)
    phase_stream_parity(dev)
    phase_ctc_referee(dev)
    print(f"gc watch: {GC_WATCH['watched']} timed steps and requests watched (gc.collect() and gc.freeze() after each phase's set-up and "
          f"warm-up); gen-2 collections inside them: {GC_WATCH['gen2']} ({GC_WATCH['gen2_ms']:.1f} ms)")
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    print(smi.splitlines()[0])
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
