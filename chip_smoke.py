"""Chip smoke test of the PyTorch port on one CUDA card: serving, training and evaluation
of the Conformer-Transducer and the CTC models, from tensors and from audio files.

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
lengths; the DP bit for bit), and the LSTM forward and backward kernels at
the prediction net's shape (B 16, T 129, H 320; bf16 as one thread-block
cluster per 16 batch rows, with its cluster plan, also at B 64 and 128 with
µs per dependent step) beside cuDNN's ``torch.nn.LSTM`` at each batch; three
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
against a float64 CPU run). The published recipes (``phase_recipe``): the
flagship with its learning_config (TransformerSchedule, AdamW, ga_steps 8,
SpecAugment, TerminateOnNaN, ModelCheckpoint and TensorBoard into a
temporary directory) through ``Trainer.fit`` for 16 micro-steps of batch 4
and an epoch-end eval, with each update's learning rate against the closed
form, micro-step walls, the checkpoint's bytes and save and restore times,
SpecAugment's time and launches, and a micro-step's launches with the
one-pass gradient norm and the per-tensor one; the callbacks' cost per
micro-step; a resumed run against two straight ones; a NaN batch stopping
``fit``; Conformer-CTC Small and Transformer-CTC base for one update of
their recipes; and the whole chain in f32, card against CPU. Kernel B (row 3) and the fused FF (row 5) run
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
registers and spills. ``conv_back`` (row 7) runs bf16 on the tensor cores
as well: at both widths its times beside the earlier CUDA-core kernels', its
backward by pass, forward and backward against float64, occupancy, registers
and spills. The log-mel frontend (rows 1-2) runs as an FFT in shared memory
for nfft 512: against the plain rfft chain and float64 at the training,
serving and one-chunk shapes, and the direct-DFT kernel that any other nfft
takes (nfft None) at the serving shape. Kernels A's and B's bf16 dv and
the FF's db2 must sit within 1.1× and 1.5× of the plain version's rms
distance to float64, and every other column sum that goes through
``sum_partials`` within 1.1×. ``Trainer.fit`` runs 30 steps in a
fresh process (``--fit-gc``), as shipped (it freezes the collector's
survivors after step 1) and with that freeze undone, with the gen-2
collections inside steps 2-30. Another fresh process (``--gc-probe``)
builds the flagship, both CTC models and the memory-64 streaming model and
serves 200 flagship requests, half after ``gc.freeze()`` and half after
``gc.unfreeze()``, with the gen-2 pauses of each half and its host RSS and
card memory, which may not grow by more than 5% from the 50th request to
the last. The data path (``phase_data``) writes a corpus
of 32 training and 16 evaluation utterances of 5.1–16 s (every sixth
FLAC, the rest WAV; each character of the transcript voiced as its own
pair of tones) at the manifest paths of
``examples/datasets/librispeech/characters/char.yml.j2`` in a temporary
directory, loads that config through the port's ``Config`` with
``datadir`` there, builds the char tokenizer (V 29) and the models through
``build_model``, and drives: host decode ms (WAV, FLAC native and
Python), ``create``'s ms a batch at 0 and 4 decode workers; the flagship
(bf16, ``auto``) through ``Trainer.fit`` for 2 epochs × 2 steps of 16 fed
by ``create`` with the training set as ``eval_data``, its first loss
bit-equal to ``train_step`` on the same batch, and step walls fed from
the dataset against a fixed batch; ``evaluate_dataset`` at batch 8 over
the evaluation manifests and over a TFRecord copy (equal reports,
utterances a second, RTF, one fused decode a batch) with WER and CER
three ways (the accumulator, ``metrics.wer``/``cer`` over the rows,
``wer_on_device``); Conformer-CTC Small through ``fit`` and
``evaluate_dataset``; a 2-block Conformer-T at the flagship's widths
trained until ``evaluate_dataset`` reads WER 0 on 4 utterances (at most
400 steps and 60 s); and its weights in f32 evaluated on the card and on
the CPU, hypothesis for hypothesis. The kernels this path runs at V 29 are
held to their plain versions on its own inputs: the fused joint forward
and backward on the first data-fed batch's prejoint outputs, the
log-probability row kernel's one-element form (its own kernel row,
``rnnt_logprobs_scalar``: rows of 29 values are no multiple of 16 bytes)
on that batch's eval logits, and the bf16 fused decode on the encoding of
the first evaluation batch and of the overfit utterances. ``--data`` runs
the build and this phase alone. The rest of the CTC family
(``phase_ctc_family``), each model built from its example config through
the port's ``Config`` and ``build_model`` at its published widths (bf16,
random weights from the seed): DeepSpeech2 base (5 bidirectional LSTM
layers at H 512 through the LSTM kernels) and Jasper base serving 3 requests
of 8 × 6–10 s and training 3 steps of 8 × ≤ 16 s with char labels at ~12 a
second (V 29); DeepSpeech2 uni streaming 16 chunks of 160 ms with its
carried LSTM states; the streaming Transformer-CTC (relative PE, chunk 16,
history 64: kernel B at head 128) serving and training at 16 × ≤ 16 s; the
streaming Conformer-CTC Small serving; relative MHA with an explicit
``attention_mask`` (kernel A with the bias gradient) against kernel B's
route on the same visibility; a 2-layer DeepSpeech2 overfit to WER 0 on
the data phase's four utterances; and before them the kernels at these
shapes against their plain versions (kernel B at head 128 with its
accuracy, occupancy, registers and spills; the LSTM at B 8, T 801, H 512
beside cuDNN's bidirectional layer; kernel A with the bias gradient; the
CTC kernel at T 801), as sub-entries of their rows; and the f32 card/CPU
step parity of a 2-layer DeepSpeech2, a 2-block Jasper and a 2-block
streaming Transformer-CTC. After each phase's set-up and warm-up the garbage
collector runs once and freezes the survivors (``gc.freeze``); every
timed step and request records its gen-2 collections, summed in a ``gc
watch`` line. Every kernel must launch on at least one driven path; its
launches are recorded per path. Any failure raises. The last two lines
are the kernels' JSON summary and ``{"ok": true, "device": {...}}``.
Without a card it exits non-zero.

The command line (``phase_cli``): on the data phase's corpus with a config
of the flagship at its published widths (4 blocks) and the char tokenizer, each
subcommand of ``python -m tensorflowasr_tpu_torch`` as its own process:
``utils create_datasets_metadata`` and ``create_tfrecords``, ``train`` (3
steps, bf16), ``test`` (greedy and beam 4), ``save`` and ``export`` (f32,
bs 1), each with its wall; then ``export.py`` for the flagship at bf16
and the small-streaming transducer with its carried states (4 blocks
each), Transformer-CTC base and RNN-T small; each ``.pt2`` loaded in a fresh process
(``--cli-child``) and held against eager ``recognize`` on the same
weights: tokens, the kernel launches of a call (equal, and no plain
version run), device operations a call, walls per request and the
program's bytes. ``--cli`` runs
the build and this phase alone.

Data and tensor parallelism (``phase_parallel``, also alone with
``--parallel``): the flagship at full width and depth, 16 × 5.1–16 s, SGD
1e-2, f32 with TF32 off and dropout 0: the data-parallel ``Trainer`` step
over an NCCL group of world 1 against the plain step; two gloo ranks
spawned on the one card (8 rows each) against the plain step on the 16
rows, the ranks' parameters bit-equal, after a check that gloo takes the
collectives the slice runs on CUDA tensors; the vocab-sharded loss (data 1
× model 2) at the loss shapes against the unsharded loss, and the TP step
against the plain step (the RNN-T DP once a rank a step, the fused joint
never); bf16 steps of both at dropout 0.1; and ``train`` under
``torchrun --nproc_per_node 1``. Walls there are gloo on one card, not a
scaling figure; NCCL across cards is not exercised.

The layers the port took last (``phase_layers``, also alone with
``--layers``): kernel A at head 36 (l1's B·H 64, T = S 400, the auto
mask, forward and backward, f32 and bf16, beside SDPA and against
float64) and both frontend kernels below the frame length (nfft 256 and
300 at 25 ms frames, directly and through ``FeatureExtraction``) against
their plain versions; then three paths in bf16 with random weights: l1,
the flagship at full width and depth with 80 MFCCs, VGG subsampling,
vanilla MHA (kernel A in every block), a one-hot label encoder and a
GRU-320 prediction net, serving 3 requests of 8 × 10 s (the eager WIND
loop), training 3 steps of 16 × ≤ 16 s and 2 eval steps; l2, 4 blocks
with log-gammatone features, Conv1d subsampling, post-norm modules under
a pre-norm block, a grouped depthwise conv with LayerNorm, trainable
residual factors, no auto mask (kernel B; the FF and conv modules on
their plain route, as in JAX) and a simple-RNN net, serving and training
3 steps; l3, DeepSpeech2 base with 2 bidirectional GRU-512 layers,
serving 8 × 16 s and training 3 steps on the CTC kernel, and its uni
layout streaming 4 chunks with the GRU carries; and each path 2 deep in
f32, card against CPU (encoder output, greedy tokens).

A model that the JAX package wrote (``phase_jax_checkpoint``, also alone
with ``--jax-checkpoint``): the orbax checkpoint under
``tests/data/jax_orbax_conformer_t`` (a one-block Conformer-T that JAX's
``save`` wrote, OCDBT and zstd) read by the port's native zstd decoder and
OCDBT/zarr reader (build, read ms and MB/s on the host), loaded through
``common.load_weights`` and served in f32 through ``recognize`` on the card
(the frontend, the block's encoder kernels and the fused decode), its
greedy tokens equal to the ones JAX recorded and its encoder output within
2e-3 of max(1, scale) of JAX's.

``python3 chip_smoke.py --compare-parent DIR`` runs only row 10a's times
(:func:`rows_child`: the call alone and with the stack of its outputs) and
the step numbers (:func:`phase_steps`) of this checkout and of the package
under DIR (a checkout of another commit), each in its own process, in
turns. ``--rows``, ``--steps`` and ``--fit-gc`` are child processes' modes;
``--recipe`` runs the kernel build and the recipes alone, ``--data`` the
build and the data path, ``--ctc-family`` the build and the rest of the CTC
family (:func:`phase_ctc_family`, its kernels and its parity).
"""

from __future__ import annotations

import contextlib
import copy
import gc
import json
import os
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
def cost_frontend(b: int, n: int, frames: int, nfft: int, mels: int, mel_nnz: int):
    """A real FFT per frame (2.5·n·log2 n), the power spectrum and the mel
    product over the filters' ``mel_nnz`` nonzero weights (the rest are
    zeros the function never needs), f32."""
    return 4 * (b * n + b * frames * mels), b * frames * (2.5 * nfft * np.log2(nfft) + 3 * (nfft // 2 + 1) + 2 * mel_nnz)


def cost_attention(bh: int, t: int, s: int, r: int, d: int, elt: int, bwd: bool, keys: float | None = None):
    """fwd: qc, qp, k, v, pos → out; QKᵀ, the rel term and PV. bwd: + out, dout → five grads; 16 products of that size.
    ``keys``: the mean number of keys a query row sees under the masks (the products' work there; default every key)."""
    io = (2 * t + 2 * s + r) * bh * d * elt
    k = s if keys is None else keys
    return (2 * io + 2 * bh * t * d * elt, 16 * bh * t * k * d) if bwd else (io + bh * t * d * elt, 6 * bh * t * k * d)


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
    "conv_back": ("tensorflowasr_tpu_torch/csrc/conv_mma.cu", "tensorflowasr_tpu/ops/pallas/conv_kernel.py:329"),
    "conv_back_bwd": ("tensorflowasr_tpu_torch/csrc/conv_mma.cu", "tensorflowasr_tpu/ops/pallas/conv_kernel.py:375"),
    "rnnt_dp": ("tensorflowasr_tpu_torch/csrc/rnnt_dp.cu", "tensorflowasr_tpu/ops/pallas/rnnt_kernel.py:310"),
    "rnnt_fused_joint": ("tensorflowasr_tpu_torch/csrc/joint_loss_mma.cu", "tensorflowasr_tpu/ops/pallas/joint_loss_kernel.py:351"),
    "rnnt_fused_joint_bwd": ("tensorflowasr_tpu_torch/csrc/joint_loss_mma.cu", "tensorflowasr_tpu/ops/pallas/joint_loss_kernel.py:329"),
    "rnnt_logprobs": ("tensorflowasr_tpu_torch/csrc/rnnt_rows.cu", "tensorflowasr_tpu/ops/pallas/rnnt_kernel.py:413"),
    "rnnt_logprobs_scalar": ("tensorflowasr_tpu_torch/csrc/rnnt_rows.cu", "tensorflowasr_tpu/ops/pallas/rnnt_kernel.py:413"),
    "rnnt_dlogits": ("tensorflowasr_tpu_torch/csrc/rnnt_rows.cu", "tensorflowasr_tpu/ops/pallas/rnnt_kernel.py:438"),
    "lstm": ("tensorflowasr_tpu_torch/csrc/lstm_mma.cu", "tensorflowasr_tpu/ops/pallas/lstm_kernel.py:178"),
    "lstm_bwd": ("tensorflowasr_tpu_torch/csrc/lstm_mma.cu", "tensorflowasr_tpu/ops/pallas/lstm_kernel.py:237"),
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
    err, ms, plain_ms, _ = frontend_line(sig, cfg, "serve")
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
              f"bound {bb_[0]:.4f} ms ({bb_[1]})" + (f" (the earlier CUDA-core kernel, PERF.md row 7: {EARLIER_MS[('conv_back', 'serve')][0]:.4f} ms)"
                                                    if tag == "bf16" else "") + f" (tol {TOL[tag]})")
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


# the kernels rows 3, 5, 6, 7 and 8 had before their tensor-core redesign (PERF.md §6: bf16, rate 0.1, forward and backward ms), by width, and
# the direct-DFT frontend of rows 1-2 before its FFT (f32 ms); printed beside this run's times, never written to the kernels' JSON line
EARLIER_MS = {("fused_rel_attention", 36): (0.5629, 1.7223), ("fused_rel_attention", 44): (0.7083, 2.0996), ("fused_ff", 144): (0.1133, 1.5137),
              ("fused_ff", 176): (0.1509, 3.0285), ("conv_front", 144): (0.1326, 0.4727), ("conv_front", 176): (0.1722, 0.7880),
              ("conv_front", "serve"): (0.0587, None), ("rnnt_fused_joint", 320): (2.8144, 17.4508), ("conv_back", 144): (0.0763, 0.1992),
              ("conv_back", 176): (0.0996, 0.2643), ("conv_back", "serve"): (0.0467, None), ("log_mel_spectrogram", "train"): (0.6614, None),
              ("log_mel_spectrogram", "serve"): (0.2243, None)}


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


# The kernels' results against float64, as a share of the plain version's rms distance: kernels A's and B's dv (pd as bf16
# hi + lo, as JAX's f32 pd) and the FF's db2 (the column-sum partials as a fixed tree) must sit within these; every other
# column sum that goes through sum_partials within COLSUM_RMS of the plain version's (each sat at 0.98-1.001 x before the
# partials were summed as a tree, one H100 run of the parent tree).
RMS_LIMITS = {"dv": 1.1, "db2": 1.5}
COLSUM_RMS = 1.1


def hold_rms(what: str, names, kern, plain, refs, limits: dict) -> str:
    """Each named result's rms distance to float64 over the plain version's,
    held to ``limits[name]``; the ratios as text."""
    parts = []
    for name, g, p, r in zip(names, kern, plain, refs):
        if name not in limits:
            continue
        rk_, rp = (g.double() - r).pow(2).mean().sqrt().item(), (p.double() - r).pow(2).mean().sqrt().item()
        ratio = rk_ / max(rp, 1e-300)
        if ratio > limits[name]:
            raise AssertionError(f"{what} {name}: rms against float64 {rk_:.3e} is {ratio:.3f} x the plain version's {rp:.3e} (> {limits[name]})")
        parts.append(f"{name} {ratio:.3f} (limit {limits[name]})")
    return "rms vs float64, kernel / plain: " + ", ".join(parts)


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
    names = ("out", "dqc", "dqp", "dk", "dv", "dpos")
    print(f"kernel fused_rel_attention bf16 accuracy ({what}, BH {bh} T {t} S {s} R {r} head {qc.shape[2]}): "
          + accuracy_parts(names, kern, plain, refs) + "; " + hold_rms("fused_rel_attention_bwd", names, kern, plain, refs, RMS_LIMITS))


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
    names = ("dgamma", "dbeta", "dW1", "db1", "dW2", "db2")
    print(f"kernel fused_ff_bwd bf16 accuracy ({what}, N {x.shape[0]} D {x.shape[1]} F {w1.shape[1]}; dx in bf16, the rest f32): "
          + accuracy_parts(("dx",), kern[:1], plain[:1], refs[:1]) + "; "
          + accuracy_parts(names, kern[1:], plain[1:], refs[1:], steps=False) + "; "
          + hold_rms("fused_ff_bwd", names, kern[1:], plain[1:], refs[1:], {"dgamma": COLSUM_RMS, "dbeta": COLSUM_RMS, "db1": COLSUM_RMS, **RMS_LIMITS}))


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
    names = ("dgamma", "dbeta", "dWa", "dba", "dWb", "dbb")
    print(f"kernel conv_front_bwd bf16 accuracy ({what}, N {x.shape[0] * x.shape[1]} D {x.shape[2]}; dx in bf16, the rest f32): "
          + accuracy_parts(("dx",), kern[:1], plain[:1], refs[:1]) + "; "
          + accuracy_parts(names, kern[1:], plain[1:], refs[1:], steps=False) + "; "
          + hold_rms("conv_front_bwd", names, kern[1:], plain[1:], refs[1:], dict.fromkeys(("dgamma", "dbeta", "dba", "dbb"), COLSUM_RMS)))


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


def conv_back_accuracy(fargs: tuple, bargs: tuple, what: str) -> None:
    """conv_back in bf16: the forward and the backward, kernel and plain
    version, against a float64 run of the same function on the same inputs
    and keep mask (a = swish(bn) unrounded; the parameter gradients before
    their final cast, so that dW2's bf16 high/low split shows against the
    plain f32 product)."""
    from tensorflowasr_tpu_torch.ops.cuda import conv_kernel as ck

    x, y1, mean, var, scale, bias, w2, b2, seed, rate, factor, eps = fargs
    dout = bargs[6]
    keep = ck._back_mask(seed, rate, y1)
    p64 = [a.double().requires_grad_(True) for a in (y1, mean, var, scale, bias, w2, b2)]
    yy, mu, vv, sc, bi, ww, bb = p64
    bn = (yy - mu) * torch.rsqrt(vv + eps) * sc + bi
    z = (bn * torch.sigmoid(bn)) @ ww + bb
    ref = x.double() + factor * (z if keep is None else z * keep.double())
    refs = torch.autograd.grad(ref, p64, dout.double())
    kern = ck.conv_back_bwd_kernel_f32(*bargs)
    plain = ck.conv_back_plain_bwd_f32(*bargs)
    plain = (plain[0].to(y1.dtype), *plain[1:])  # dy1 leaves both in y1's dtype
    names = ("dmean", "dvar", "dscale", "dbias", "dW2", "db2")
    print(f"kernel conv_back[_bwd] bf16 accuracy ({what}, N {y1.shape[0] * y1.shape[1]} D {y1.shape[2]}; out and dy1 in bf16, the rest f32): "
          + accuracy_parts(("out",), (ck.conv_back_kernel(*fargs),), (ck.conv_back_plain(*fargs),), (ref.detach(),)) + "; "
          + accuracy_parts(("dy1",), kern[:1], plain[:1], refs[:1]) + "; "
          + accuracy_parts(names, kern[1:], plain[1:], refs[1:], steps=False) + "; "
          + hold_rms("conv_back_bwd", names, kern[1:], plain[1:], refs[1:], dict.fromkeys(("dmean", "dvar", "dscale", "dbias", "db2"), COLSUM_RMS)))


def conv_back_extras(make, rows: list[dict], d_model: int, n: int, what: str) -> None:
    """conv_back in bf16 on the tensor cores: this run's times beside the
    earlier CUDA-core kernels', the backward by pass, both against float64,
    and the two kernels' occupancy (against what their shared memory, as
    the library reports it, allows), registers and spills."""
    from tensorflowasr_tpu_torch.ops.cuda import _build
    from tensorflowasr_tpu_torch.ops.cuda import conv_kernel as ck

    fargs, bargs = make(torch.bfloat16)
    old = EARLIER_MS[("conv_back", d_model)]
    passes = device_ms_by_kernel(ck.conv_back_bwd_kernel, bargs, {"rows": "cb_bwd_rows", "weight": "ff_mma_atb", "sums": "sum_partials",
                                                                  "bn": "bn_stat_grads"})
    rows[1]["passes_ms"] = passes
    print(f"kernel conv_back[_bwd] bf16 ({what}): forward {rows[0]['ms']:.4f} ms backward {rows[1]['ms']:.4f} ms (by pass, profiler: "
          f"{_fmt_ms(passes)}); plain {rows[0]['plain_ms']:.4f} / {rows[1]['plain_ms']:.4f} ms; bound {rows[0]['bound_ms']:.4f} / {rows[1]['bound_ms']:.4f} ms"
          f"; the earlier CUDA-core kernels (PERF.md row 7) {old[0]:.4f} / {old[1]:.4f} ms")
    conv_back_accuracy(fargs, bargs, what)
    lib = _build.build()
    kernels = {}
    for which, name, frag in ((2, "cb_fwd (32 rows)", "cb_fwdE"), (3, "cb_bwd_rows (32 rows)", "cb_bwd_rowsE")):
        smem = lib.tfasr_conv_mma_smem(d_model, which)
        kernels[name] = (which - 2, frag, smem, smem, smem_blocks_per_sm(smem), lib.tfasr_conv_mma_occupancy(d_model, which))
    occupancy_report(rows, kernels, f"conv_back D {d_model}, N {n}")


def frontend_float64(sig: torch.Tensor, cfg) -> torch.Tensor:
    """The log-mel function in float64 on the card: windowed pad_end frames, rfft, power, the dense mel product, log."""
    from tensorflowasr_tpu_torch.ops import frontend

    s = sig.double()
    n = np.arange(cfg.frame_length)
    window = torch.tensor(0.5 - 0.5 * np.cos(2.0 * np.pi * n / cfg.frame_length), dtype=torch.float64, device=sig.device)
    frames = frontend.frame_signal(s, cfg.frame_length, cfg.frame_step, cfg.pad_end) * window
    power = torch.fft.rfft(frames, n=cfg.fft_length, dim=-1).abs().square()
    mel = frontend.linear_to_mel_weight_matrix(cfg.num_feature_bins, power.shape[-1], cfg.sample_rate, cfg.lower_edge_hertz, cfg.upper_edge_hertz)
    return torch.log(power @ torch.tensor(mel, dtype=torch.float64, device=sig.device) + cfg.epsilon)


def frontend_line(sig: torch.Tensor, cfg, what: str) -> tuple:
    """The frontend kernel for ``cfg`` (the FFT kernel for a power-of-two
    nfft, else the direct DFT) against its plain version (1e-3 in log), both
    against float64, their times, the bound, and the earlier kernel's time
    at this shape where PERF.md has one. Returns (err, ms, plain ms, bound)."""
    from tensorflowasr_tpu_torch.ops.cuda import frontend_kernel as fek

    fft = fek.uses_fft(cfg.fft_length)
    before = (fek.launches, fek.dft_launches)
    got = fek.log_mel_spectrogram_pallas(sig, cfg)
    if (fek.launches - before[0], fek.dft_launches - before[1]) != ((1, 0) if fft else (0, 1)):
        raise AssertionError(f"frontend ({what}): launched FFT {fek.launches - before[0]}, DFT {fek.dft_launches - before[1]} times")
    plain = fek.log_mel_spectrogram_plain(sig, cfg)
    err = _close(f"frontend f32 ({what})", got, plain, 1e-3, 0.0)
    ref = frontend_float64(sig, cfg)
    dist = {k: ((v.double() - ref).abs().max().item(), (v.double() - ref).pow(2).mean().sqrt().item()) for k, v in (("kernel", got), ("plain", plain))}
    ms, plain_ms = time_ms(fek.log_mel_spectrogram_pallas, sig, cfg), time_ms(fek.log_mel_spectrogram_plain, sig, cfg)
    nnz = int(fek.mel_ranges(fek.frontend.linear_to_mel_weight_matrix(cfg.num_feature_bins, cfg.fft_length // 2 + 1, cfg.sample_rate,
                                                                      cfg.lower_edge_hertz, cfg.upper_edge_hertz))[2][-1])
    b = bound(*cost_frontend(sig.shape[0], sig.shape[1], got.shape[1], cfg.fft_length, got.shape[2], nnz), "f32")
    old = EARLIER_MS.get(("log_mel_spectrogram", what)) if fft else None
    print(f"kernel log_mel_spectrogram {'FFT' if fft else 'DFT'} ({what}, nfft {cfg.fft_length}): {tuple(sig.shape)} → {tuple(got.shape)} f32 "
          f"max_abs_err {err:.3e} (tol 1e-3); vs float64 max abs / rms kernel {dist['kernel'][0]:.3e} / {dist['kernel'][1]:.3e}, plain "
          f"{dist['plain'][0]:.3e} / {dist['plain'][1]:.3e}; kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound {b[0]:.4f} ms ({b[1]}; {nnz} mel "
          f"weights)" + (f"; the earlier direct-DFT kernel (PERF.md row 1) {old[0]:.4f} ms" if old else ""))
    return err, ms, plain_ms, b


def frontend_extras(gen) -> dict:
    """The frontend at a streaming chunk's shape (one block's launch sets
    its time) and the direct-DFT kernel (nfft None: 400 points) at the
    serving shape, each against its plain version."""
    from tensorflowasr_tpu_torch.ops import frontend

    cfg = frontend.FrontendConfig()
    size, _ = cfg.get_signal_chunk_size_and_step(16)
    chunk = frontend.preemphasis_signal(_randn(gen, (1, size), 0.1), cfg).contiguous()
    out = {"chunk": dict(zip(("err", "ms", "plain_ms"), frontend_line(chunk, cfg, "chunk")[:3]))}
    cfg_dft = frontend.FrontendConfig(nfft=None)
    sig = frontend.preemphasis_signal(_randn(gen, (8, 160000), 0.1), cfg_dft).contiguous()
    out["dft"] = dict(zip(("err", "ms", "plain_ms"), frontend_line(sig, cfg_dft, "serve, nfft None")[:3]))
    return out


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
    names = ("d_enc_p", "d_pred_p", "dWv", "dbv")
    print(f"kernel rnnt_fused_joint_bwd bf16 accuracy ({what}, f32 gradients): "
          + accuracy_parts(names, kern_g, plain_g, (denc, dpred, dwv, dbv), steps=False) + "; "
          + hold_rms("rnnt_fused_joint_bwd", names, kern_g, plain_g, (denc, dpred, dwv, dbv), dict.fromkeys(("d_pred_p", "dWv", "dbv"), COLSUM_RMS)))


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
    err, ms, plain_ms, b = frontend_line(sig, cfg, "train")
    rows.append(_row("log_mel_spectrogram", {"f32": err}, ms, plain_ms, b))
    rows[-1]["extras"] = frontend_extras(gen)

    return rows + encoder_kernel_rows(dev, gen, D_MODEL, HEAD, FF_DIM) + phase_loss_kernels(dev)


def rel_att_bwd(qc, qp, k, v, pos, kvb, ql, out, stats, dout, *cfg):
    """Kernel B's backward on the backward arguments the checks build (the forward's output and statistics among them)."""
    from tensorflowasr_tpu_torch.ops.cuda import attention_kernel as ak

    return ak.fused_rel_attention_bwd_kernel(qc, qp, k, v, pos, kvb, ql, out, dout, *cfg, stats=stats)


def rel_att_bwd_plain(qc, qp, k, v, pos, kvb, ql, out, stats, dout, *cfg):
    """The plain twin of :func:`rel_att_bwd` (it recomputes the forward)."""
    from tensorflowasr_tpu_torch.ops.cuda import attention_kernel as ak

    return ak.fused_rel_attention_plain_bwd(qc, qp, k, v, pos, kvb, ql, dout, *cfg)


def flat_outputs(fn):
    """``fn`` with its tuple of outputs concatenated into one flat f32 tensor (for the forward checks of multi-output kernels)."""
    return lambda *a: torch.cat([x.float().flatten() for x in fn(*a)])


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

    att_bwd, att_bwd_plain = rel_att_bwd, rel_att_bwd_plain
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
    fargs, bargs = att_make(torch.bfloat16)
    passes = {**device_ms_by_kernel(ak.fused_rel_attention_kernel, fargs, {"forward": "rel_mma_fwd"}),
              **device_ms_by_kernel(att_bwd, bargs, {"dq": "rel_mma_dq", "dk/dv": "rel_mma_dkv", "dpos": "rel_mma_dpos"})}
    passes.pop("all")
    print(f"kernel fused_rel_attention[_bwd] bf16 by pass ({what}, head {head}; profiler): {_fmt_ms(passes)} (the dk/dv pass stages pd's hi and lo "
          f"planes; recomputing pd there would repeat the scores and the rel band the forward and the dq pass form)")

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

    def back_make(dt, rate=TRAIN_RATE):
        x, y1 = _randn(gen, shape, 1.0, dt), _randn(gen, shape, 1.0, dt)
        stats = (_randn(gen, (d_model,), 0.1), 1.0 + torch.rand((d_model,), generator=gen, device=dev), 1.0 + _randn(gen, (d_model,), 0.1),
                 _randn(gen, (d_model,), 0.1))
        w2, b2 = _randn(gen, (d_model, d_model), d_model ** -0.5, dt), _randn(gen, (d_model,), 0.1, dt)
        cfg_ = (17, rate, 1.0, 1e-3)
        return (x, y1, *stats, w2, b2, *cfg_), (y1, *stats, w2, _randn(gen, shape, 1.0, dt), *cfg_)

    rows += _check_fwd_bwd("conv_back", ck.conv_back_kernel, ck.conv_back_plain, ck.conv_back_bwd_kernel, ck.conv_back_plain_bwd, back_make,
                           lambda elt, bwd: cost_conv_back(n, d_model, elt, bwd), what)
    rate0_times(rows[-2:], lambda: back_make(torch.bfloat16, rate=0.0), ck.conv_back_kernel, ck.conv_back_bwd_kernel, what, d_model)
    conv_back_extras(back_make, rows[-2:], d_model, n, what)
    return rows


# the DP (f32 only) chains T+U log-add-exps: loss to 1e-5 relative; the
# gradients (occupancies in [−1, 0]) to 1e-5 absolute
DP_EARLIER_MS = 0.3997  # the one-block-per-row DP with two sweeps in series (PERF.md row 9), for the printout


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
    from tensorflowasr_tpu_torch.ops.rnnt_loss import LOG_0, rnnt_loss_from_logprobs_plain

    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    t_np, u_np = loss_lengths(np.random.default_rng(SEED + 2), TRAIN_B)
    t_len, u_len = torch.tensor(t_np, device=dev), torch.tensor(u_np, device=dev)
    u1 = TRAIN_U + 1

    lp = torch.log_softmax(_randn(gen, (TRAIN_B, T_ENC, u1, 3), 2.0), dim=-1)
    lpb, lpe = lp[..., 0].contiguous(), lp[..., 1].contiguous()
    lpe[..., TRAIN_U] = LOG_0
    got, ref = rk.rnnt_dp_kernel(lpb, lpe, t_len, u_len), rnnt_loss_from_logprobs_plain(lpb, lpe, t_len, u_len)
    err = max((g - r).abs().max().item() for g, r in zip(got, ref))
    if err != 0.0 or not all(torch.isfinite(g).all() for g in got):
        raise AssertionError(f"rnnt_dp: max abs err {err} against the plain version, which it repeats operation for operation (0 expected)")
    ms, plain_ms = time_ms(rk.rnnt_dp_kernel, lpb, lpe, t_len, u_len), time_ms(rnnt_loss_from_logprobs_plain, lpb, lpe, t_len, u_len)
    b = bound(*cost_rnnt_dp(t_np, u_np, T_ENC, u1), "f32")
    chain = int((t_np + u_np).max())
    print(f"kernel rnnt_dp (train loss): [{TRAIN_B}, {T_ENC}, {u1}] f32, T_b {t_np.min()}-{t_np.max()}, U_b {u_np.min()}-{u_np.max()}, "
          f"diagonals per row ≤ {chain} (α and β sweeps side by side, {rk.dp_warps(u1)} warps each); max_abs_err {err:.3e} "
          f"(0 required) kernel {ms:.4f} ms ({1e3 * ms / chain:.3f} µs per diagonal of the longest row) plain {plain_ms:.4f} ms bound {b[0]:.4f} ms "
          f"({b[1]}); the earlier kernel (PERF.md) {DP_EARLIER_MS:.4f} ms")
    passes = device_ms_by_kernel(rk.rnnt_dp_kernel, (lpb, lpe, t_len, u_len), {"skew": "rnnt_dp_skew", "sweeps": "rnnt_dp_sweep", "grads": "rnnt_dp_grads"})
    print(f"kernel rnnt_dp (train loss) by pass (profiler): {_fmt_ms(passes)}")
    rows = [_row("rnnt_dp", {"f32": err}, ms, plain_ms, b)]
    rows[0]["passes_ms"] = passes

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

    rows += _check_fwd_bwd("rnnt_fused_joint", _stacked(jk.joint_logprobs_kernel), _stacked(jk.joint_logprobs_plain), jk.rnnt_loss_fused_joint_bwd_kernel,
                           jk.rnnt_loss_fused_joint_plain_bwd, joint_make,
                           lambda elt, bwd: cost_joint(TRAIN_B, T_ENC, u1, JOINT, VOCAB, elt, bwd, active["cells"]),
                           what=f"train loss, [{TRAIN_B}, {T_ENC}, {u1}] cells, J {JOINT}, V {VOCAB}")
    joint_extras(joint_make, rows[-2:], active["cells"], TRAIN_B * T_ENC * u1, dev)

    return rows + unfused_rows_kernels(dev, gen, labels, t_len, u_len)


def unfused_rows_kernels(dev, gen, labels, t_len, u_len) -> list[dict]:
    """The unfused loss's two row kernels (rows 10a, 10b) over materialised
    logits [16, 400, 129, 256], f32 and bf16, then row 10a in both dtypes:
    the call alone beside the call with the stack of its three outputs (the
    JSON row's ``ms``, as the check line times it and as the first design
    was timed), achieved TB/s and share of the bytes bound, its plan, and
    ``torch.logsumexp`` on the same logits as a yardstick (the same bytes
    read, one of the three outputs)."""
    from tensorflowasr_tpu_torch.ops.cuda import rnnt_kernel as rk
    from tensorflowasr_tpu_torch.ops.rnnt_loss import dlogits_assemble_plain, logits_to_logprobs_plain, rnnt_loss_from_logprobs_plain

    u1 = TRAIN_U + 1
    n_rows = TRAIN_B * T_ENC * u1

    def rows_make(dt):
        logits = _randn(gen, (TRAIN_B, T_ENC, u1, VOCAB), 2.0, dt)
        lpb, lpe, lse = logits_to_logprobs_plain(logits, labels)
        _, gbl, gem = rnnt_loss_from_logprobs_plain(lpb, lpe, t_len, u_len)
        g = torch.full((TRAIN_B,), 1.0 / TRAIN_B, device=dev)  # the masked mean's cotangent
        return (logits, labels), (logits, lse, gbl, gem, labels, g)

    rows = _check_fwd_bwd("rnnt_logprobs", _stacked(rk.logits_to_logprobs_kernel), _stacked(logits_to_logprobs_plain),
                          lambda *a: (rk.dlogits_assemble_kernel(*a),), lambda *a: (dlogits_assemble_plain(*a),), rows_make,
                          lambda elt, bwd: cost_rows(n_rows, VOCAB, TRAIN_B, TRAIN_U, elt, bwd),
                          what=f"eval/pallas loss, logits [{TRAIN_B}, {T_ENC}, {u1}, {VOCAB}]", bwd_name="rnnt_dlogits", fwd_tol=ROWS_TOL)
    print(f"kernel rnnt_dlogits (eval/pallas loss): bf16 {rows[1]['ms']:.4f} ms, the first design (PERF.md row 10b) {ROWS_EARLIER_MS[1]:.4f} ms "
          f"(not redesigned; {100.0 * (rows[1]['ms'] / ROWS_EARLIER_MS[1] - 1):+.1f}%)")
    for tag, dt in DTYPES:
        (logits, _), _ = rows_make(dt)
        elt = logits.element_size()
        plan = rk.logprobs_plan(VOCAB, elt)
        times = rows_times(rk, logits, labels)
        ms = times["alone_ms"]
        lse_ms = time_ms(torch.logsumexp, logits, -1)
        moved, ops = cost_rows(n_rows, VOCAB, TRAIN_B, TRAIN_U, elt, False)
        bd = bound(moved, ops, "f32")
        print(f"kernel rnnt_logprobs {tag} (eval/pallas loss, [{TRAIN_B}, {T_ENC}, {u1}, {VOCAB}], {moved / 1e6:.1f} MB moved): the call alone {ms:.4f} ms, "
              f"{moved / ms / 1e9:.3f} TB/s, {100.0 * bd[0] / ms:.1f}% of the bytes bound {bd[0]:.4f} ms; with the stack of its three outputs "
              f"{times['stacked_ms']:.4f} ms; one warp a tile of {plan.tile_rows} rows, {plan.lanes} lanes a row, "
              f"{VOCAB * elt // 16 // plan.lanes} chunks of 16 bytes a lane; library torch.logsumexp (one output of three, same logits) "
              f"{lse_ms:.4f} ms; the first design (PERF.md row 10a, with the stack) "
              + (f"{ROWS_EARLIER_MS[0]:.4f} ms" if tag == "bf16" else "not measured in f32"))
        rows[0][f"kernel_only_ms_{tag}"], rows[0][f"stacked_ms_{tag}"] = ms, times["stacked_ms"]
        rows[0][f"yardstick_logsumexp_ms_{tag}"] = lse_ms
        rows[0][f"tb_per_s_{tag}"], rows[0][f"bound_share_{tag}"] = moved / ms / 1e9, bd[0] / ms
    rows[0]["kernel_only_ms"] = rows[0]["kernel_only_ms_bf16"]
    return rows


def _stacked(fn):
    """``fn``'s outputs as one tensor: the form in which the check lines compare and time a kernel of several outputs."""
    return lambda *a: torch.stack(fn(*a))


def rows_times(rk, logits, labels) -> dict:
    """Row 10a's call (``rk.logits_to_logprobs_kernel``) alone and with the
    stack of its three outputs, in ms (:func:`time_ms`)."""
    return {"alone_ms": time_ms(rk.logits_to_logprobs_kernel, logits, labels),
            "stacked_ms": time_ms(_stacked(rk.logits_to_logprobs_kernel), logits, labels)}


def rows_child(dev) -> dict:
    """Row 10a of the package on ``sys.path`` at the flagship's logits
    [16, 400, 129, 256] in bf16 and f32 (int64 labels, as the check phase
    passes them): :func:`rows_times` of each dtype (``--rows``)."""
    from tensorflowasr_tpu_torch.ops.cuda import rnnt_kernel as rk

    gen = torch.Generator(device=dev).manual_seed(0)
    labels = torch.randint(1, VOCAB, (TRAIN_B, TRAIN_U), generator=gen, device=dev)
    res = {}
    for tag, dt in DTYPES:
        logits = _randn(gen, (TRAIN_B, T_ENC, TRAIN_U + 1, VOCAB), 2.0, dt)
        res.update({f"{key}_{tag}": ms for key, ms in rows_times(rk, logits, labels).items()})
    return res


# rows 10a and 10b before the redesign of 10a (PERF.md §6, bf16), for the printout
ROWS_EARLIER_MS = (0.3097, 0.3199)


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

    rows = _check_fwd_bwd("lstm", flat_outputs(lk.lstm_fwd_kernel), flat_outputs(lk.lstm_fwd_plain), lk.lstm_bwd_kernel, lk.lstm_bwd_plain, make,
                          lambda elt, bwd: cost_lstm(b, t, h, elt, bwd), what=f"pallas rnn, B {b} T {t} H {h}")
    plan = lk.lstm_mma_plan(h)
    print(f"kernel lstm (pallas rnn) cluster plan, bf16: {lstm_plan_text(plan, h)}; the chain bounds it: 2 x {t} dependent steps, one cluster "
          f"exchange each; f32 keeps the cooperative grid ({lk._units(h, dev, None)} units per block)")
    rows[0]["library_ms"], rows[1]["library_ms"] = lstm_library(gen, b, t, h, torch.bfloat16)
    rows[0]["library_ms_f32"], rows[1]["library_ms_f32"] = lstm_library(gen, b, t, h, torch.float32)
    fargs, bargs = make(torch.bfloat16)
    # the per-step loads and stores one element at a time: xg and dy one element off their alignment
    xg_off = torch.cat([fargs[0].new_zeros(1), fargs[0].flatten()])[1:].view(fargs[0].shape)
    dy_off = torch.cat([bargs[4].new_zeros(1).float(), bargs[4].float().flatten()])[1:].view(bargs[4].shape)
    times = {}
    for tag, fa, ba in (("paired", fargs, bargs), ("one element", (xg_off, *fargs[1:]), (*bargs[:4], dy_off, bargs[5]))):
        times[tag] = (time_ms(lk.lstm_fwd_kernel, *fa), time_ms(lk.lstm_bwd_kernel, *ba))
    print(f"kernel lstm (pallas rnn) per-step loads and stores, bf16, B {b}: two units a thread as one access {times['paired'][0]:.4f} / "
          f"{times['paired'][1]:.4f} ms, one element at a time (xg, dy a view one element off) {times['one element'][0]:.4f} / "
          f"{times['one element'][1]:.4f} ms (forward / backward)")
    for hw in LSTM_WIDE:  # part of each Wh slice streamed from L2: TransducerPrediction's default rnn_units, and the widest
        xg, wh = _randn(gen, (b, t, 4 * hw), 1.0, torch.bfloat16), _randn(gen, (hw, 4 * hw), hw ** -0.5, torch.bfloat16)
        h0, c0 = _randn(gen, (b, hw), 0.3, torch.bfloat16), _randn(gen, (b, hw), 0.3, torch.bfloat16)
        ref = lk.lstm_fwd_plain(xg, wh, h0, c0)
        for name, x, r in zip(("y", "cseq", "gates"), lk.lstm_fwd_kernel(xg, wh, h0, c0), ref):
            _close(f"lstm fwd bf16 H {hw} {name}", x, r, *TOL["bf16"])
        dy, dc = _randn(gen, (b, t, hw), 1.0 / b, torch.bfloat16), _randn(gen, (b, t, hw), 0.1 / b, torch.bfloat16)
        bargs_w = (ref[2], ref[1], c0, wh, dy, dc)
        _grads_close(f"lstm bwd bf16 H {hw}", lk.lstm_bwd_kernel(*bargs_w), lk.lstm_bwd_plain(*bargs_w), GRAD_REL["bf16"])
        ms_f, ms_b = time_ms(lk.lstm_fwd_kernel, xg, wh, h0, c0), time_ms(lk.lstm_bwd_kernel, *bargs_w)
        lib_f, lib_b = lstm_library(gen, b, t, hw, torch.bfloat16)
        bd_f, bd_b = bound(*cost_lstm(b, t, hw, 2, False), "bf16"), bound(*cost_lstm(b, t, hw, 2, True), "bf16")
        print(f"kernel lstm[_bwd] bf16 (pallas rnn, B {b} T {t} H {hw}; {lstm_plan_text(lk.lstm_mma_plan(hw), hw)}): forward {ms_f:.4f} ms "
              f"({1e3 * ms_f / t:.3f} µs per step), backward {ms_b:.4f} ms ({1e3 * ms_b / t:.3f} µs per step); cuDNN nn.LSTM bf16 {lib_f:.4f} / "
              f"{lib_b:.4f} ms; bound {bd_f[0]:.4f} / {bd_b[0]:.4f} ms; values within the bf16 tolerances of plain")
        rows[0].setdefault("by_width", {})[hw] = dict(ms=ms_f, bwd_ms=ms_b, library_ms=lib_f, library_bwd_ms=lib_b, bound_ms=bd_f[0],
                                                      bwd_bound_ms=bd_b[0])
    by_batch = {}
    for bb in LSTM_BATCHES:
        xg, wh = _randn(gen, (bb, t, 4 * h), 1.0, torch.bfloat16), _randn(gen, (h, 4 * h), h ** -0.5, torch.bfloat16)
        h0, c0 = _randn(gen, (bb, h), 0.3, torch.bfloat16), _randn(gen, (bb, h), 0.3, torch.bfloat16)
        fwd = lk.lstm_fwd_kernel(xg, wh, h0, c0)
        ref = lk.lstm_fwd_plain(xg, wh, h0, c0)
        for name, x, r in zip(("y", "cseq", "gates"), fwd, ref):
            _close(f"lstm fwd bf16 B {bb} {name}", x, r, *TOL["bf16"])
        dy, dc = _randn(gen, (bb, t, h), 1.0 / bb, torch.bfloat16), _randn(gen, (bb, t, h), 0.1 / bb, torch.bfloat16)
        bargs_b = (ref[2], ref[1], c0, wh, dy, dc)
        _grads_close(f"lstm bwd bf16 B {bb}", lk.lstm_bwd_kernel(*bargs_b), lk.lstm_bwd_plain(*bargs_b), GRAD_REL["bf16"])
        ms_f, ms_b = time_ms(lk.lstm_fwd_kernel, xg, wh, h0, c0), time_ms(lk.lstm_bwd_kernel, *bargs_b)
        lib_f, lib_b = lstm_library(gen, bb, t, h, torch.bfloat16)
        bd_f, bd_b = bound(*cost_lstm(bb, t, h, 2, False), "bf16"), bound(*cost_lstm(bb, t, h, 2, True), "bf16")
        by_batch[bb] = dict(ms=ms_f, bwd_ms=ms_b, library_ms=lib_f, library_bwd_ms=lib_b, bound_ms=bd_f[0], bwd_bound_ms=bd_b[0],
                            clusters=-(-bb // 16))
        print(f"kernel lstm[_bwd] bf16 (pallas rnn, B {bb} T {t} H {h}, {by_batch[bb]['clusters']} clusters of {plan.cluster}): forward {ms_f:.4f} ms "
              f"({1e3 * ms_f / t:.3f} µs per step), backward {ms_b:.4f} ms ({1e3 * ms_b / t:.3f} µs per step); cuDNN nn.LSTM bf16 {lib_f:.4f} / "
              f"{lib_b:.4f} ms; bound {bd_f[0]:.4f} / {bd_b[0]:.4f} ms; the earlier cooperative-grid kernel at B 16 (PERF.md) "
              f"{LSTM_EARLIER_MS[0]:.4f} / {LSTM_EARLIER_MS[1]:.4f} ms")
    rows[0]["by_batch"] = by_batch
    return rows


LSTM_BATCHES = (16, 64, 128)  # bench.py:149-157's training batch sizes
LSTM_WIDE = (512, 1000)  # bf16 widths whose Wh slices do not fit on chip


def lstm_plan_text(plan, h: int) -> str:
    return (f"C {plan.cluster} blocks per cluster of 16 batch rows, up to {8 * plan.groups_per_block} units ({plan.groups_per_block} groups of 8, "
            f"one warp each) per block, shared memory per block forward {plan.fwd_smem_bytes} B, backward {plan.bwd_smem_bytes} B; Wh resident: "
            f"forward {plan.fwd_resident} of {plan.fwd_ksteps} k-steps, backward {plan.bwd_resident} of {plan.bwd_chunks} chunks (the rest from L2: "
            f"{plan.fwd_pack_bytes} / {plan.bwd_pack_bytes} B packed); {plan.bwd_buffers} backward dxg buffers")
LSTM_EARLIER_MS = (1.6334, 1.8755)  # the cooperative-grid bf16 kernels at B 16 (PERF.md row 12), for the printout


def lstm_library(gen, b: int, t: int, h: int, dt, width: int | None = None, bidirectional: bool = False) -> tuple[float, float]:
    """cuDNN's ``torch.nn.LSTM`` over x [b, t, width] (default h; its time
    includes the x·Wx product, which the kernel row's input xg already
    holds; ``bidirectional``: both directions), weights packed: (forward,
    backward) ms. Fails if cuDNN warns that it re-packs the weights."""
    tag = ("bf16" if dt == torch.bfloat16 else "f32") + (" bidirectional" if bidirectional else "")
    width = width or h
    lstm = torch.nn.LSTM(width, h, batch_first=True, bidirectional=bidirectional).to(gen.device, dt)
    packing = _pack_cudnn_weights(lstm)
    x = _randn(gen, (b, t, width), 1.0, dt).requires_grad_(True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out, _ = lstm(x)
    repacked = [str(w.message).splitlines()[0] for w in caught if "contiguous chunk" in str(w.message)]
    if repacked:
        raise AssertionError(f"library torch.nn.LSTM {tag}: cuDNN still re-packs the weights every call: {repacked[0]}")
    dout = torch.randn_like(out)
    inputs = [x, *lstm.parameters()]
    res = (time_ms(lambda: lstm(x)), time_ms(lambda: torch.autograd.grad(out, inputs, dout, retain_graph=True)))
    print(f"library torch.nn.LSTM (cuDNN) {tag}: x [{b}, {t}, {width}] H {h} forward {res[0]:.4f} ms, backward {res[1]:.4f} ms (weights {packing}; no re-packing "
          f"warning)")
    return res


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


def decode_bf16_agreement(params, start, states, x, got, ref, what: str) -> str:
    """Where the bf16 fused decode ``got`` and its plain version ``ref``
    (decoded with ``gaps=True``) of the encoding ``x`` differ: only where the
    plain version's top-two logit gap is within DECODE_GAP of the logit
    scale (the largest |logit| of the first step's joint rows), else raises.
    Returns the note for the check line."""
    from tensorflowasr_tpu_torch.ops.cuda import decode_kernel as dk

    pred0, _ = dk._pred_step(params, start, states)
    z0 = torch.tanh(dk.project_encoder(x, params).float() + pred0[:, None, :]).to(x.dtype)
    scale = torch.nn.functional.linear(z0.float(), params.wv.float(), params.bv).abs().max().item()
    report = []
    for r, pos in enumerate(_first_difference(got[0], ref[0], got[1], ref[1])):
        if pos is None:
            continue
        g = ref[4][r, pos].item()
        report.append(f"row {r}: position {pos}, plain top-two gap {g:.4g}")
        if g > DECODE_GAP * scale:
            raise AssertionError(f"decode bf16 ({what}): row {r} differs at position {pos} where the plain version's top-two logit gap "
                                 f"{g} exceeds {DECODE_GAP} x the logit scale {scale}")
    n = got[0].shape[0]
    return f"{what}: {n - len(report)} of {n} rows equal, " + ("; ".join(report) or "no difference") + f" (allowed where the gap <= 2^-6 x logit scale {scale:.3g})"


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
                note = "; ".join(decode_bf16_agreement(params, start, states, x, g_, r_, what)
                                 for what, x, (g_, r_) in (("sharpened", sharp, (kernel(sharp), plain(sharp, gaps=True))), ("raw", enc, (got, ref))))
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
           "ctc_loss", "fused_attention", "fused_attention_bwd", "fused_decode", "rnnt_logprobs_scalar")


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
# ... at a vocabulary whose logit rows are no multiple of 16 bytes (the char vocabulary, V 29): the row kernel's one-element form
PER_EVAL_SCALAR = {**PER_EVAL, "rnnt_logprobs": 0, "rnnt_logprobs_scalar": 1}
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
            "rnnt_logprobs": rk.logprobs_launches - rk.logprobs_scalar_launches, "rnnt_dlogits": rk.dlogits_launches, "lstm": lk.launches,
            "lstm_bwd": lk.bwd_launches, "ctc_loss": ctk.launches, "fused_attention": ak.attention_launches,
            "fused_attention_bwd": ak.attention_bwd_launches, "fused_decode": dk.launches, "rnnt_logprobs_scalar": rk.logprobs_scalar_launches}


def reset_launch_counts() -> None:
    from tensorflowasr_tpu_torch.ops.cuda import attention_kernel as ak, conv_kernel as ck, ctc_kernel as ctk, ff_kernel as fk, frontend_kernel as fek
    from tensorflowasr_tpu_torch.ops.cuda import decode_kernel as dk, joint_loss_kernel as jk, lstm_kernel as lk, rnnt_kernel as rk

    fek.launches = ak.launches = ak.bwd_launches = fk.launches = fk.bwd_launches = 0
    ck.front_launches = ck.front_bwd_launches = ck.back_launches = ck.back_bwd_launches = 0
    rk.launches = jk.launches = jk.bwd_launches = rk.logprobs_launches = rk.logprobs_scalar_launches = rk.dlogits_launches = 0
    lk.launches = lk.bwd_launches = 0
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
    """The flagship (bf16): :func:`serve_transducer`'s 3 requests, then the outlier hunt."""
    from tensorflowasr_tpu_torch.models.transducer.base import recognize

    model = flagship(torch.bfloat16, dev).eval()
    counts, _ = serve_transducer(dev, "flagship", model, PER_REQUEST, tag="serve")
    outlier_hunt("serve", model, recognize, np.random.default_rng(SEED + 9), dev)
    return counts


def train_batch(rng, batch: int, max_secs: float, max_u: int, vocab: int, tokens_per_s: float = 8.0):
    """Ragged lengths as the JAX package's benchmark draws them (bench.py:149-157):
    lognormal around 12 s clipped to [1.5 s, max], 8 tokens per second (or ``tokens_per_s``)."""
    from tensorflowasr_tpu_torch import schemas

    secs = np.clip(rng.lognormal(mean=np.log(12.0), sigma=0.35, size=batch), 1.5, max_secs)
    lens = (secs * 16000).astype(np.int64)
    u = np.clip((secs * tokens_per_s).astype(np.int64), 1, max_u)
    audio = (rng.standard_normal((batch, int(max_secs * 16000))) * 0.1).astype(np.float32)
    audio[np.arange(audio.shape[1])[None, :] >= lens[:, None]] = 0.0
    labels = rng.integers(1, vocab, (batch, max_u))
    labels[np.arange(max_u)[None, :] >= u[:, None]] = 0
    preds = np.concatenate([np.zeros((batch, 1), np.int64), labels], axis=1)
    t = torch.tensor
    return schemas.TrainData(schemas.TrainInput(t(audio), t(lens), t(preds), t(u + 1)), schemas.TrainLabel(t(labels), t(u)))


TRAIN_STEPS, XLA_STEPS, HOST_STEPS = 6, 2, 8


def run_train(dev, loss_impl: str, steps: int, per_step: dict, tag: str, rnn_impl: str = "auto", model=None, lr: float = 1e-4, batch=None):
    """``steps`` training steps of ``model`` (default: the flagship) through
    ``Trainer.train_step`` (bf16, dropout 0.1, Adam at ``lr``, one fixed batch:
    ``batch``, default the training batch of 16 × ≤ 16 s)
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
    batch = (batch or train_batch(np.random.default_rng(SEED + 2), TRAIN_B, TRAIN_SECS, TRAIN_U, model.vocab_size)).to(dev)
    print(f"{tag} batch: {batch.inputs.inputs.shape[0]} utterances, audio {batch.inputs.inputs_length.sum().item() / 16000:.2f} s "
          f"(lengths {batch.inputs.inputs_length.min().item() / 16000:.2f}-{batch.inputs.inputs_length.max().item() / 16000:.2f} s, array "
          f"{batch.inputs.inputs.shape[1] / 16000:g} s), labels {batch.labels.labels_length.min().item()}-{batch.labels.labels_length.max().item()} "
          f"(array {batch.labels.labels.shape[1]}); loss_impl {loss_impl!r}, "
          f"rnn_impl {getattr(model, 'rnn_impl', rnn_impl)!r}, Adam lr {lr:g}")
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


def port_kernel_ms(kernels) -> dict:
    """The port's own kernels (``namespace tfasr``) among profiler events: device ms by kernel function name."""
    import re

    out = {}
    for e in kernels:
        m = re.search(r"tfasr::(?:\(anonymous namespace\)::)?(\w+)", e.key) or re.search(r"tfasr\d+_GLOBAL__N__\w+?_\d+(\D\w*?)I", e.key)
        if m:
            out[m.group(1)] = out.get(m.group(1), 0.0) + e.self_device_time_total / 1e3
    return out


def profile_step(trainer, state, batch, walls, tag: str, top: int = 15, by_kernel: dict | None = None) -> tuple[float, float]:
    """One more step under the profiler: the card's kernel time in a step, its
    share of the unprofiled steps' median wall, and the kernels by time (the
    port's own, by function name, into ``by_kernel`` where given).
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
    if by_kernel is not None:
        by_kernel.update(port_kernel_ms(kernels))
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
    """Three flagship eval steps of the training batch (:func:`transducer_eval`)."""
    model = flagship(torch.bfloat16, dev, dropout=TRAIN_RATE)
    batch = train_batch(np.random.default_rng(SEED + 2), TRAIN_B, TRAIN_SECS, TRAIN_U, model.vocab_size)
    return transducer_eval(dev, "eval", model, batch, PER_EVAL)


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
    what = what or f"{loss_impl}, rnn_impl {rnn_impl}"
    print(f"parity f32 train step ({what}) card (kernels) vs CPU (plain): 2 blocks, batch 2 x <= 4 s; {hold_step(what, *results)}, TF32 off")
    return model, batch.to(dev)


def hold_step(what: str, run: tuple, ref: tuple, rel: float = TRAIN_PARITY_REL) -> str:
    """Holds one step's (loss, gradients by name) ``run`` to ``ref``: the loss
    within 1e-4 of it, each gradient within ``rel`` of its largest magnitude
    plus TRAIN_PARITY_FLOOR of the model's largest gradient. Returns the
    summary the parity lines print."""
    (loss, grads), (ref_loss, ref_grads) = run, ref
    if not abs(loss - ref_loss) <= 1e-4 * abs(ref_loss):
        raise AssertionError(f"{what}: loss {loss} vs {ref_loss}")
    gmax = max(g.abs().max().item() for g in ref_grads.values())
    worst = worst_rel = (0.0, "")
    for name, g in ref_grads.items():
        err, scale = (grads[name] - g).abs().max().item(), g.abs().max().item()
        allowed = rel * scale + TRAIN_PARITY_FLOOR * gmax
        if err > allowed:
            raise AssertionError(f"f32 train parity ({what}) {name}: max abs err {err} > {rel} x {scale} + {TRAIN_PARITY_FLOOR} x {gmax}")
        worst = max(worst, (err / allowed, name))
        if scale > TRAIN_PARITY_FLOOR * gmax:
            worst_rel = max(worst_rel, (err / scale, name))
    return (f"loss {loss:.6f} vs {ref_loss:.6f}; {len(ref_grads)} gradients within {rel} of their scale + {TRAIN_PARITY_FLOOR} x {gmax:.3e} "
            f"(largest share of that allowance {worst[0]:.3f} at {worst[1]}; largest error relative to scale among gradients above the floor "
            f"{worst_rel[0]:.3e} at {worst_rel[1]})")


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
    size, step = model.feature_extraction.config.get_signal_chunk_size_and_step(STREAM_FRAMES)
    audio = (np.random.default_rng(seed).standard_normal((1, (STREAM_CHUNKS - 1) * step + size)) * 0.1).astype(np.float32)
    return [torch.tensor(audio[:, i * step: i * step + size], device=device) for i in range(STREAM_CHUNKS)], size, step


def run_stream(model, chunks, size: int, device, per_chunk: dict | None = None, recognize=None) -> list:
    """One pass over the chunks through ``recognize`` (default the
    transducer's), carrying the next tokens, decoder states and encoder
    states from chunk to chunk; with ``per_chunk``, each chunk's kernel
    launches must equal it."""
    from tensorflowasr_tpu_torch import schemas
    from tensorflowasr_tpu_torch.models.transducer import base

    recognize = recognize or base.recognize

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


def stream_path(dev, name: str, model, per_chunk: dict, recognize=None, note: str = "") -> tuple[dict, list]:
    """``model`` (bf16) streaming batch 1 through ``recognize`` (default the
    transducer's): a warm-up pass, one counted pass (each chunk's launches
    equal to ``per_chunk``), then STREAM_PASSES timed passes; ms per chunk
    (median pass / chunks) and RTF. Returns the launch counts and the
    counted pass's outputs."""
    chunks, size, step = stream_chunks(model, SEED + 21, dev)
    run_stream(model, chunks, size, dev, recognize=recognize)
    torch.cuda.synchronize()
    reset_launch_counts()
    outs = run_stream(model, chunks, size, dev, per_chunk, recognize)
    torch.cuda.synchronize()
    counts = launch_counts()
    per_pass = []
    for _ in range(STREAM_PASSES):
        t0 = time.perf_counter()
        run_stream(model, chunks, size, dev, recognize=recognize)
        torch.cuda.synchronize()
        per_pass.append((time.perf_counter() - t0) / STREAM_CHUNKS * 1e3)
    ms, chunk_ms = float(np.median(per_pass)), step / 16.0
    frames = outs[0].tokens.shape[1] // 2 if recognize is None else outs[0].tokens.shape[1]  # a transducer's budget is 2T + 1 tokens
    emitted = sum(int((o.tokens != model.blank).sum()) for o in outs)
    print(f"stream {name}: batch 1, {STREAM_CHUNKS} chunks of {STREAM_FRAMES} feature frames ({size} samples, step {step}: {chunk_ms:.0f} ms of audio), "
          f"encoder frames per chunk {frames}, {note}; {ms:.3f} ms per chunk (median of {STREAM_PASSES} passes: " + ", ".join(f"{p:.3f}" for p in per_pass)
          + f"), RTF per chunk {ms / chunk_ms:.4f} (wall / audio), {chunk_ms / ms:.2f}x real time; launches per chunk {_launched(per_chunk)}; tokens "
          f"emitted over the stream {emitted}")
    print(f"stream {name} launches over {STREAM_CHUNKS} chunks: {_launched(counts)}")
    return counts, outs


def phase_streaming(dev) -> dict:
    """Both streaming models (:func:`stream_path`), each chunk's launches
    the encoder's and one fused decode."""
    paths = {}
    for name in STREAM_MODELS:
        model = streaming_model(name, torch.bfloat16, dev)
        note = f"memory {getattr(model.encoder, 'memory_length', None)}, vocabulary {model.vocab_size}"
        paths[f"stream_{name}"], _ = stream_path(dev, name, model, PER_CHUNK, note=note)
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


def ctc_model(name: str, dtype, device, num_blocks: int | None = None, dropout: float = TRAIN_RATE, conditioned: bool = False,
              augment: bool = False) -> torch.nn.Module:
    """A CTC model at its published widths, random weights from SEED
    (``augment``: with the example's SpecAugment). With ``conditioned``
    (the card/CPU parity from raw audio) the Transformer's input linear is
    drawn 1/√dmodel smaller: its output is scaled by √dmodel before the PE,
    and with lecun-normal weights the attention scores are otherwise O(500)
    and the softmax near one-hot, so that the two frontends' ~1e-5
    differences move the query weights' gradient by 2.2e-3 of its scale
    (PERF.md §6, PR 16). From the same features and with one FFN ReLU
    pattern, the published init holds (:func:`phase_ctc_referee`)."""
    from tensorflowasr_tpu_torch.models.ctc.conformer import ConformerCtc, conformer_ctc_small_config
    from tensorflowasr_tpu_torch.models.ctc.transformer import TransformerCtc, transformer_ctc_base_config

    cls, make_cfg = {"conformer_ctc": (ConformerCtc, conformer_ctc_small_config), "transformer_ctc": (TransformerCtc, transformer_ctc_base_config)}[name]
    cfg = make_cfg(dropout=dropout, augment=augment, **({} if num_blocks is None else {"num_blocks": num_blocks}))
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


def cost_vanilla_attention(bh: int, t: int, s: int, d: int, elt: int, bias_bytes: int, bwd: bool, dbias: bool = False):
    """fwd: q, k, v, bias → out; QKᵀ and PV (4·BH·T·S·D). bwd: q, k, v, bias,
    out, dout → dq, dk, dv (and, with ``dbias``, the bias's gradient, f32
    [BH, T, S]; the Transformer's bias is a constant mask); QKᵀ recomputed,
    do·vᵀ, dv, dq, dk (10·BH·T·S·D)."""
    if bwd:
        return (4 * t + 4 * s) * bh * d * elt + bias_bytes + (4 * bh * t * s if dbias else 0), 10 * bh * t * s * d
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
    names = ("out", "dq", "dk", "dv")
    print(f"kernel fused_attention bf16 accuracy (rate {rate}, BH {q.shape[0]} T = S {q.shape[1]} head {q.shape[2]}): "
          + accuracy_parts(names, kern, plain, refs) + "; " + hold_rms("fused_attention_bwd", names, kern, plain, refs, RMS_LIMITS))


def ctc_kernel_row(dev, gen, b: int = TRAIN_B, t: int = T_ENC, max_u: int = TRAIN_U, vocab: int = VOCAB, lengths=None,
                   what: str = "ctc train loss") -> dict:
    """Row 11 at the CTC training shape (B 16, T 400, S 257, ragged T_b and
    U_b; or ``b``, ``t``, ``max_u``, ``vocab`` and the (T_b, U_b) arrays
    ``lengths``): occupancy and loss against the plain version (max abs error 0
    required: the kernel repeats its operations), the kernel's time (the
    whole ``ctc_kernel`` call), its two passes (profiler), µs per dependent
    row update of the longest row, ``F.ctc_loss`` forward and
    forward+backward, and the port's whole ``ctc_loss_pallas``."""
    import torch.nn.functional as F

    from tensorflowasr_tpu_torch.ops.ctc_loss import ctc_occupancy_plain, ctc_prep
    from tensorflowasr_tpu_torch.ops.cuda import ctc_kernel as ctk

    t_np, u_np = lengths if lengths is not None else loss_lengths(np.random.default_rng(SEED + 2), b)
    t_len, u_len = torch.tensor(t_np, device=dev), torch.tensor(u_np, device=dev)
    labels = torch.randint(1, vocab, (b, max_u), generator=gen, device=dev)
    labels[torch.arange(max_u, device=dev)[None, :] >= u_len[:, None]] = 0
    s = 2 * max_u + 1
    occ_err, loss_err = {}, {}
    for tag, dt in DTYPES:
        logits = _randn(gen, (b, t, vocab), 2.0, dt)
        lp_ext, skip, _ = ctc_prep(logits, labels)
        occ, loss = ctk.ctc_kernel(lp_ext, skip, t_len, u_len)
        ref_occ, ref_loss = ctc_occupancy_plain(lp_ext, skip, t_len, u_len)
        occ_err[tag] = _close(f"ctc occupancy {tag}", occ, ref_occ, *CTC_OCC_TOL)
        _close(f"ctc loss {tag}", loss, ref_loss, *CTC_LOSS_TOL)
        loss_err[tag] = ((loss - ref_loss).abs() / ref_loss.abs()).max().item()
        if not (torch.equal(occ, ref_occ) and torch.equal(loss, ref_loss)):
            raise AssertionError(f"ctc_loss {tag}: occupancy max abs err {occ_err[tag]}, loss rel err {loss_err[tag]} against the plain version, "
                                 "which it repeats operation for operation (0 expected)")
    ms, plain_ms = time_ms(ctk.ctc_kernel, lp_ext, skip, t_len, u_len), time_ms(ctc_occupancy_plain, lp_ext, skip, t_len, u_len)
    bd = bound(*cost_ctc(t_np, u_np, t, s), "f32")
    passes = device_ms_by_kernel(ctk.ctc_kernel, (lp_ext, skip, t_len, u_len), {"sweeps": "ctc_sweep", "occupancy": "ctc_occupancy"})
    chain = int(t_np.max())
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
    print(f"kernel ctc_loss ({what}): lp_ext [{b}, {t}, {s}] f32 from V {vocab} logits, T_b {t_np.min()}-{t_np.max()}, U_b "
          f"{u_np.min()}-{u_np.max()}; occupancy max_abs_err f32 {occ_err['f32']:.3e} bf16 {occ_err['bf16']:.3e} (0 required), loss rel err "
          f"{max(loss_err.values()):.3e} (0 required); kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound {bd[0]:.4f} ms ({bd[1]}); the first design "
          f"(PERF.md row 11) {CTC_EARLIER_MS:.4f} ms")
    print(f"kernel ctc_loss ({what}) by pass (profiler): {_fmt_ms(passes)}; {1e3 * ms / chain:.3f} µs per dependent row update of the "
          f"longest row ({chain}; α and β sweeps side by side, {-(-s // 32)} warps each)")
    print(f"library F.ctc_loss ({what}, bf16 logits' log_softmax, reduction none): forward {lib_fwd:.4f} ms, forward+backward {lib_fb:.4f} ms "
          f"(loss rel diff to the kernel {lib_rel:.2e}); the port's whole ctc_loss_pallas on the logits (prep, kernel, softmax − occupancy): forward "
          f"{op_fwd:.4f} ms, forward+backward {op_fb:.4f} ms")
    row = _row("ctc_loss", {"f32": occ_err["f32"], "bf16": occ_err["bf16"]}, ms, plain_ms, bd)
    row.update(dtype="float32", loss_rel_err=max(loss_err.values()), library_ms=lib_fb, library_fwd_ms=lib_fwd, op_fwd_ms=op_fwd, op_fwd_bwd_ms=op_fb,
               passes_ms=passes, us_per_row_update=1e3 * ms / chain)
    return row


CTC_EARLIER_MS = 0.3248  # the one-block-per-row kernel with α then β (PERF.md row 11), for the printout


def phase_ctc_kernels(dev, rows: list[dict]) -> list[dict]:
    """The CTC kernel (row 11) and kernel A (row 4) at the CTC training
    shapes, with their library yardsticks; and the four encoder kernels at
    Conformer-CTC's widths (D 176, head 44), whose numbers go onto the
    existing rows under ``conformer_ctc``. Returns the new rows."""
    from tensorflowasr_tpu_torch.ops.cuda import attention_kernel as ak

    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    t_np, _ = loss_lengths(np.random.default_rng(SEED + 2), TRAIN_B)
    t_len = torch.tensor(t_np, device=dev)
    new = [ctc_kernel_row(dev, gen)]

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
    paths = {}
    for name in CTC_MODELS:
        paths[f"ctc_serve_{name}"] = serve_ctc(dev, name, ctc_model(name, torch.bfloat16, dev).eval(), PER_REQUEST_CTC[name])
    return paths


def serve_ctc(dev, name: str, model, per_request: dict, hunt: bool = True) -> dict:
    """3 requests of 8 × 6–10 s through a CTC model's greedy ``recognize``
    (after one warm-up request), each request's launches equal to
    ``per_request``; wall, encode, decode ms and RTF; with ``hunt`` the
    outlier hunt. Returns the launch counts of the 3 requests."""
    from tensorflowasr_tpu_torch import schemas
    from tensorflowasr_tpu_torch.models.ctc.base import recognize
    from tensorflowasr_tpu_torch.ops.ctc_decode import ctc_greedy_decode

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
        if delta != per_request:
            raise AssertionError(f"ctc serve {name} request {r}: kernel launches {delta}, expected {per_request}")
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
    print(f"ctc serve {name} launches over 3 requests: {_launched(counts)} (per request {_launched(per_request)})")
    if hunt:
        outlier_hunt(f"ctc serve {name}", model, recognize, np.random.default_rng(SEED + 9), dev)
    return counts


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


def referee_grads(build, runs) -> dict:
    """One CTC training step of the model ``build(dtype)`` (built on the CPU,
    dropout 0) for each run (name, device, dtype, loss_impl, context): batch
    2 × ≤ 4 s, from the same features (the CPU frontend's, f32) on every
    run, so that only the encoder, the vocabulary projection and the loss
    differ; encoder → vocabulary → CTC loss → backward within
    ``context(model)``, and a float64 run also within
    ``float64_plain_path`` from the f32 model's weights. Returns {name:
    (loss, gradients by parameter)}."""
    from tensorflowasr_tpu_torch.ops.losses import get_ctc_loss_fn

    base = build(torch.float32)
    batch = train_batch(np.random.default_rng(SEED + 3), 2, 4.0, 32, base.vocab_size)
    with torch.no_grad():
        feats, flens = base.feature_extraction(batch.inputs.inputs, batch.inputs.inputs_length)
    out = {}
    for name, device, dtype, loss_impl, context in runs:
        if dtype == torch.float64:
            model = build(torch.float64).double()
            model.load_state_dict(base.state_dict())
        else:
            model = copy.deepcopy(base)
        model.to(device)
        with float64_plain_path() if dtype == torch.float64 else contextlib.nullcontext(), context(model):
            enc, elens, _ = model.encoder(feats.to(device, dtype), flens.to(device), train=True)
            loss = get_ctc_loss_fn(loss_impl)(model.vocab(enc), elens, batch.labels.labels.to(device), batch.labels.labels_length.to(device))
            loss.backward()
        out[name] = (loss.item(), {n: p.grad.detach().cpu().double() for n, p in model.named_parameters() if p.grad is not None})
    return out


@contextlib.contextmanager
def ffn_relu_masks(model, masks: dict, replay: bool):
    """Within the block, each pointwise FFN of ``model`` (the Transformer's
    ``ffn_1`` → ReLU) records the sign pattern of its ReLU's input into
    ``masks`` by module name or, with ``replay``, takes the pattern recorded
    there as its ReLU's (x · mask), as :func:`jasper_relu_masks` does for Jasper."""
    from tensorflowasr_tpu_torch.models.encoders import transformer
    from tensorflowasr_tpu_torch.models.layers.residual import residual
    from tensorflowasr_tpu_torch.ops import dropout as dr

    names = {m: n for n, m in model.named_modules()}
    forward = transformer.PointwiseFFN.forward

    def masked(self, x, train=False, generator=None):
        out = self.ln(x) if self.norm_position == "pre" else x
        hidden = self.ffn_1(out)
        if replay:
            hidden = hidden * masks[names[self]].to(hidden.device, hidden.dtype)
        else:
            masks[names[self]] = (hidden > 0).detach().cpu()
            hidden = torch.relu(hidden)
        out = dr.dropout(self.ffn_2(hidden), dr.active_rate(self.dropout, train, generator), generator)
        if self.norm_position == "post":
            out = self.ln(out)
        return residual(x, out, self.residual_factor)

    transformer.PointwiseFFN.forward = masked
    try:
        yield
    finally:
        transformer.PointwiseFFN.forward = forward


def phase_ctc_referee(dev) -> None:
    """Queue 3 item 1: the Transformer-CTC f32 step at the published init on
    the card (kernels) and on the CPU (plain versions), from the same
    features, each held to the CPU plain path in float64. Conditioning
    moves both f32 runs about equally far from float64; a kernel A fault
    moves the card's alone. Then the same runs with float64's ReLU sign
    pattern replayed in every FFN (:func:`ffn_relu_masks`): what distance is
    left is not a ReLU input on its kink; and the card's f32 step held to
    the CPU's with the CPU's own pattern on both (:func:`hold_step`)."""
    build = lambda dtype: ctc_model("transformer_ctc", dtype, "cpu", num_blocks=2, dropout=0.0)
    kernels, plain = (lambda model: contextlib.nullcontext()), (lambda model: plain_attention())
    f64_masks, cpu_masks = {}, {}
    record, replay = (lambda masks: lambda model: ffn_relu_masks(model, masks, False)), (lambda masks: lambda model: ffn_relu_masks(model, masks, True))
    runs = referee_grads(build, [("card f32", dev, torch.float32, "auto", kernels), ("card f32 plain attention", dev, torch.float32, "auto", plain),
                                 ("cpu f32", "cpu", torch.float32, "auto", kernels), ("cpu f64", "cpu", torch.float64, "xla", record(f64_masks)),
                                 ("card f32, f64 pattern", dev, torch.float32, "auto", replay(f64_masks)),
                                 ("cpu f32, f64 pattern", "cpu", torch.float32, "auto", replay(f64_masks)),
                                 ("cpu f32 own pattern", "cpu", torch.float32, "auto", record(cpu_masks)),
                                 ("card f32, cpu pattern", dev, torch.float32, "auto", replay(cpu_masks))])
    ref_loss, ref = runs["cpu f64"]
    floor = TRAIN_PARITY_FLOOR * max(g.abs().max().item() for g in ref.values())  # gradients that are zero in exact arithmetic (the key biases)
    dist = {}
    for name in ("card f32", "card f32 plain attention", "cpu f32", "card f32, f64 pattern", "cpu f32, f64 pattern"):
        loss, grads = runs[name]
        rel = {n: ((grads[n] - g).abs().max() / (g.abs().max() + floor)).item() for n, g in ref.items()}
        worst = max(rel, key=rel.get)
        dist[name] = (rel, worst)
        ffn = max((n for n in rel if n.endswith("pwffn.ffn_1.weight")), key=rel.get)
        print(f"ctc referee (transformer-ctc, 2 blocks, lecun init, batch 2 x <= 4 s): {name} loss {loss:.10g} vs f64 {ref_loss:.10g} "
              f"(rel {abs(loss - ref_loss) / abs(ref_loss):.2e}); gradients vs f64, max abs error over (scale + {TRAIN_PARITY_FLOOR} x the largest "
              f"gradient): median {np.median(list(rel.values())):.3e}, largest {rel[worst]:.3e} at {worst}, at {ffn} {rel[ffn]:.3e}")
    card, plain_, cpu = (dist[n][0] for n in ("card f32", "card f32 plain attention", "cpu f32"))
    ratio = {n: card[n] / max(plain_[n], 1e-30) for n in card}
    worst = max(ratio, key=ratio.get)
    verdict = "conditioning" if max(card.values()) <= 4.0 * max(plain_.values()) else f"kernel A fault (the card's {worst} gradient)"
    print(f"ctc referee verdict: {verdict}: kernel A / plain attention distance ratio on the card median {np.median(list(ratio.values())):.3g}, "
          f"largest {ratio[worst]:.3g} at {worst}; largest distances: card with kernel A {max(card.values()):.3e}, card with plain attention "
          f"{max(plain_.values()):.3e}, CPU {max(cpu.values()):.3e}")
    flips = {n: int((cpu_masks[n] != m).sum()) for n, m in f64_masks.items()}
    ffn = {n: max(v for k, v in dist[n][0].items() if "pwffn" in k) for n in dist}  # the FFN weights', which a ReLU input on the kink moves
    held = hold_step("transformer-ctc, 2 deep, lecun init, the CPU's ReLU pattern", runs["card f32, cpu pattern"], runs["cpu f32 own pattern"])
    print(f"ctc referee ReLU kink: FFN ReLU inputs on another side of 0 in the CPU's f32 run than in float64: {sum(flips.values())} of "
          f"{sum(m.numel() for m in f64_masks.values())} ({ {n.removeprefix('encoder.'): f for n, f in flips.items() if f} }); with float64's pattern "
          f"replayed the FFN gradients' largest distance to float64 falls from {ffn['cpu f32']:.3e} to {ffn['cpu f32, f64 pattern']:.3e} on the CPU and "
          f"from {ffn['card f32']:.3e} to {ffn['card f32, f64 pattern']:.3e} on the card (the largest left: {dist['card f32, f64 pattern'][1]}, a "
          f"gradient that is zero in exact arithmetic where it is one); card vs CPU f32 with the CPU's pattern on both: {held}")


# ------------------------------------ the rest of the CTC family ------------------------------------ #

FAMILY_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples", "models", "ctc")
FAMILY_CONFIGS = {"deepspeech2": "deepspeech2/base.yml.j2", "deepspeech2_uni": "deepspeech2/uni.yml.j2", "jasper": "jasper/base.yml.j2",
                  "transformer_ctc_streaming": "transformer/base-streaming.yml.j2", "conformer_ctc_streaming": "conformer/small-streaming.yml.j2"}
CHAR_V = 29  # the char vocabulary (examples/datasets/librispeech/characters/english.vocab and the blank)
FAMILY_B, FAMILY_CHARS_PER_S, FAMILY_STEPS = 8, 12.0, 3  # the DeepSpeech2 and Jasper recipes' batch; ~12 characters a second of speech
FAMILY_U = int(TRAIN_SECS * FAMILY_CHARS_PER_S)  # 192 labels at 16 s: S = 2U + 1 = 385 CTC states
# Adam without warm-up, as the CTC phase: the published recipes' rates (DeepSpeech2 3e-4, Jasper 1e-3) or warm-up schedules are for trained starts
FAMILY_LR = {"deepspeech2": 1e-4, "jasper": 1e-4, "transformer_ctc_streaming": 1e-5}
DS2_LSTMS, DS2_UNI_LSTMS = 10, 5  # deepspeech2/base.yml.j2: 5 bidirectional layers; uni.yml.j2: 5 unidirectional ones
DS2_T, DS2_H, DS2_WIDTH = 801, 512, 1280  # the LSTM at 16 s (1600 frames at stride 2, and one more), H 512, 32 filters × 40 bins into the first layer
PER_REQUEST_FAMILY = {"deepspeech2": _per(lstm=DS2_LSTMS), "jasper": _per(), "conformer_ctc_streaming": _per(**ENCODER_FWD),
                      "transformer_ctc_streaming": _per(log_mel_spectrogram=1, fused_rel_attention=6)}
PER_STEP_FAMILY = {"deepspeech2": _per(lstm=DS2_LSTMS, lstm_bwd=DS2_LSTMS, ctc_loss=1), "jasper": _per(ctc_loss=1),
                   "transformer_ctc_streaming": _per(log_mel_spectrogram=1, fused_rel_attention=6, fused_rel_attention_bwd=6, ctc_loss=1)}
PER_CHUNK_DS2_UNI = _per(lstm=DS2_UNI_LSTMS)
# the 2-layer DeepSpeech2 overfit: JAX's DeepSpeech2 overfit test's rate (tests/test_overfit.py:56); CTC takes more steps than the
# transducer's 100 to settle its spaces (an f32 CPU run of this model stood at WER 0.14 at 400 steps and 2e-3)
DS2_OVERFIT_LR, DS2_OVERFIT_STEPS, DS2_OVERFIT_SECONDS = 3e-3, 800, 120.0
PER_CALL_EXPLICIT_MASK = _per(fused_attention=1, fused_attention_bwd=1)
EXPLICIT_MASK_CALLS = 2


def family_model(name: str, dtype, device, tmp: str, depth: int | None = None, dropout: float | None = None, overrides: dict | None = None,
                 **kwargs) -> torch.nn.Module:
    """The example's model through the port's ``Config`` and ``build_model``
    at its published widths (DeepSpeech2's LSTMs on the route its default
    takes for ``device``, unless ``kwargs`` name ``rnn_impl``), random
    weights from SEED; cut to ``depth`` LSTM layers, Jasper blocks or
    Transformer blocks, and with every dropout at ``dropout`` and no
    SpecAugment, when given; ``overrides`` replace keys of the model
    config (``rnn_type``)."""
    from tensorflowasr_tpu_torch import pipeline
    from tensorflowasr_tpu_torch.models import build_model

    config = pipeline.load_config(os.path.join(FAMILY_DIR, FAMILY_CONFIGS[name]), modeldir=tmp)
    mc = copy.deepcopy(config.model_config)
    c = mc["config"]
    c.update(overrides or {})
    if depth is not None:
        if name.startswith("deepspeech2"):
            c["rnn_nlayers"] = depth
        elif name == "jasper":
            for key in ("block_channels", "block_kernels", "block_dropout"):
                c[key] = c[key][:depth]
        else:
            c["encoder_num_blocks"] = depth
    if dropout is not None:
        for key in [k for k in c if k.endswith("dropout")]:
            c[key] = [dropout] * len(c[key]) if isinstance(c[key], list) else dropout
        c["speech_config"].pop("augmentation_config", None)
    vocab = CHAR_V if config.decoder_config.type == "characters" else config.decoder_config.vocab_size
    model = build_model(mc, vocab_size=vocab, dtype=dtype, device=device, **kwargs)
    model.reset_parameters(torch.Generator().manual_seed(SEED))
    return model


def family_kernels(dev, rows: list[dict]) -> None:
    """The kernels of the rest of the CTC family at the shapes its models
    give them, each against its plain version (f32 and bf16) with times and
    bounds in bf16, as sub-entries of their rows: kernel B at head 128 (the
    streaming Transformer-CTC's training shape: B·H 64, T = S = R 400 under
    the causal relative PE, chunk 16 history 64; rate 0.1) with its
    accuracy against float64, blocks per SM, registers and spills; the LSTM
    at DeepSpeech2's (B 8, T 801, H 512, one direction) beside cuDNN's
    unidirectional ``torch.nn.LSTM`` (``library_ms``), and both directions
    beside cuDNN's bidirectional layer over the first layer's input [8,
    801, 1280]; kernel A with the bias gradient (relative MHA's explicit-mask
    route at head 128: the positional scores plus the mask as its bias);
    and the CTC kernel at T 801 with char labels (B 8, S 385)."""
    from tensorflowasr_tpu_torch.models.layers.attention import compute_streaming_mask
    from tensorflowasr_tpu_torch.ops.cuda import _build
    from tensorflowasr_tpu_torch.ops.cuda import attention_kernel as ak
    from tensorflowasr_tpu_torch.ops.cuda import lstm_kernel as lk

    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    by_name = {r["name"]: r for r in rows}
    keys = ("max_abs_err", "max_abs_err_bf16", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    sub = lambda r, **extra: {k: r[k] for k in keys} | extra

    # kernel B at head 128
    bh, t, d, chunk, hist = TRAIN_B * TCTC_HEADS, T_ENC, TCTC_HEAD, 16, 64
    q_len = torch.tensor([max(40, t - 23 * i) for i in range(TRAIN_B)], dtype=torch.int32, device=dev)
    seen = float(compute_streaming_mask(chunk, hist, t, t, dev).sum(dim=1).float().mean())
    what = f"transformer-ctc streaming train, BH {bh} T = S = R {t} head {d}, causal PE, chunk {chunk} history {hist}, rate {TRAIN_RATE}"

    def att_make(dt, rate=TRAIN_RATE):
        qc, qp = _randn(gen, (bh, t, d), 0.3, dt), _randn(gen, (bh, t, d), 0.3, dt)
        k, v, pos = (_randn(gen, (bh, t, d), 1.0, dt) for _ in range(3))
        cfg_ = (11, rate, False, chunk, hist, True)
        res = ak.fused_rel_attention_kernel(qc, qp, k, v, pos, None, q_len, *cfg_, with_stats=dt == torch.bfloat16)
        out, stats = res if dt == torch.bfloat16 else (res, None)
        return (qc, qp, k, v, pos, None, q_len, *cfg_), (qc, qp, k, v, pos, None, q_len, out, stats, _randn(gen, (bh, t, d), 1.0, dt), *cfg_)

    head = _check_fwd_bwd("fused_rel_attention", ak.fused_rel_attention_kernel, ak.fused_rel_attention_plain, rel_att_bwd, rel_att_bwd_plain, att_make,
                          lambda elt, bwd: cost_attention(bh, t, t, t, d, elt, bwd, keys=seen), what)
    full = [bound(*cost_attention(bh, t, t, t, d, 2, bwd), "bf16")[0] for bwd in (False, True)]
    print(f"kernel fused_rel_attention[_bwd] head {d}: the bound counts the {seen:.1f} keys a row sees under the causal chunk mask (of {t}; over "
          f"every key {full[0]:.4f} / {full[1]:.4f} ms); the kernel computes every key tile and skips none")
    rel_attention_accuracy(*att_make(torch.bfloat16), what)
    lib, plan = _build.build(), ak.rel_mma_plan(d)
    kernels = {f"rel_mma_{n} (head {d})": (min(w, 1), f"rel_mma_{n}ILi{d}", lib.tfasr_rel_mma_smem(d, w), plan[n]["smem_bytes"], plan[n]["blocks_per_sm"],
                                           lib.tfasr_rel_mma_occupancy(d, w)) for w, n in enumerate(("fwd", "dq", "dkv", "dpos"))}
    occupancy_report(head, kernels, f"kernel B, head {d}: DMAX {d}, the dq pass in 2 column blocks of 64")
    for r in head:
        by_name[r["name"]]["head128"] = sub(r, shape=what, visible_keys=seen, bound_every_key_ms=full[r["name"].endswith("_bwd")], mma=r.get("mma"))

    # the LSTM at DeepSpeech2's shape
    b, tl, h = FAMILY_B, DS2_T, DS2_H

    def lstm_make(dt):
        xg, wh = _randn(gen, (b, tl, 4 * h), 1.0, dt), _randn(gen, (h, 4 * h), h ** -0.5, dt)
        h0, c0 = _randn(gen, (b, h), 0.3, dt), _randn(gen, (b, h), 0.3, dt)
        _, cseq, gates = lk.lstm_fwd_plain(xg, wh, h0, c0)
        return (xg, wh, h0, c0), (gates, cseq, c0, wh, _randn(gen, (b, tl, h), 1.0 / b, dt), _randn(gen, (b, tl, h), 0.1 / b, dt))

    what = f"deepspeech2 train, B {b} T {tl} H {h}, one direction"
    ls = _check_fwd_bwd("lstm", flat_outputs(lk.lstm_fwd_kernel), flat_outputs(lk.lstm_fwd_plain), lk.lstm_bwd_kernel, lk.lstm_bwd_plain, lstm_make,
                        lambda elt, bwd: cost_lstm(b, tl, h, elt, bwd), what)
    # library_ms: cuDNN's one direction, as the flagship's row; beside it both directions of the layer, the kernel's and cuDNN's bidirectional layer's
    ls[0]["library_ms"], ls[1]["library_ms"] = lstm_library(gen, b, tl, h, torch.bfloat16)
    bi = lstm_library(gen, b, tl, h, torch.bfloat16, width=DS2_WIDTH, bidirectional=True)
    fwd_k, (fa, ba), (fa2, ba2) = flat_outputs(lk.lstm_fwd_kernel), lstm_make(torch.bfloat16), lstm_make(torch.bfloat16)
    both = (time_ms(lambda: (fwd_k(*fa), fwd_k(*fa2))), time_ms(lambda: (lk.lstm_bwd_kernel(*ba), lk.lstm_bwd_kernel(*ba2))))
    print(f"kernel lstm[_bwd] bf16 ({what}; {lstm_plan_text(lk.lstm_mma_plan(h), h)}): {1e3 * ls[0]['ms'] / tl:.3f} / {1e3 * ls[1]['ms'] / tl:.3f} µs "
          f"per step; one direction {ls[0]['ms']:.4f} / {ls[1]['ms']:.4f} ms against cuDNN's unidirectional layer {ls[0]['library_ms']:.4f} / "
          f"{ls[1]['library_ms']:.4f} ms; both directions {both[0]:.4f} / {both[1]:.4f} ms against cuDNN's bidirectional layer over the first "
          f"layer's input [{b}, {tl}, {DS2_WIDTH}] {bi[0]:.4f} / {bi[1]:.4f} ms (cuDNN's times include x·Wx)")
    for r, m2, lib2 in zip(ls, both, bi):
        by_name[r["name"]]["deepspeech2"] = sub(r, shape=what, us_per_step=1e3 * r["ms"] / tl, library=f"cuDNN torch.nn.LSTM, one direction, x [{b}, {tl}, {h}]",
                                                ms_both_directions=m2, library_bidirectional_ms=lib2,
                                                library_bidirectional=f"cuDNN torch.nn.LSTM, bidirectional, x [{b}, {tl}, {DS2_WIDTH}]")

    # kernel A with the bias gradient: the positional scores plus the chunk mask's −1e9 as a [B·H, T, S] bias
    mask_bias = torch.where(compute_streaming_mask(chunk, hist, t, t, dev), 0.0, -1e9)

    def a_make(dt, rate=TRAIN_RATE):
        q, k, v = _randn(gen, (bh, t, d), 0.3, dt), _randn(gen, (bh, t, d), 1.0, dt), _randn(gen, (bh, t, d), 1.0, dt)
        bias = (_randn(gen, (bh, t, t), 1.0) + mask_bias).to(dt)
        cfg_ = (23, rate)
        out, stats = ak.fused_attention_kernel(q, k, v, bias, *cfg_, with_stats=True)
        return (q, k, v, bias, *cfg_), (q, k, v, bias, out, stats, _randn(gen, (bh, t, d), 1.0, dt), *cfg_)

    def a_bwd(q, k, v, bias, out, stats, dout, seed, rate):
        return ak.fused_attention_bwd_kernel(q, k, v, bias, out, dout, seed, rate, bias_grad=True, stats=stats)

    def a_bwd_plain(q, k, v, bias, out, stats, dout, seed, rate):
        return ak.fused_attention_plain_bwd(q, k, v, bias, dout, seed, rate, bias_grad=True)

    what = f"relative MHA with an explicit mask, BH {bh} T = S {t} head {d}, bias [BH, T, S] with its gradient, rate {TRAIN_RATE}"
    att = _check_fwd_bwd("fused_attention", ak.fused_attention_kernel, ak.fused_attention_plain, a_bwd, a_bwd_plain, a_make,
                         lambda elt, bwd: cost_vanilla_attention(bh, t, t, d, elt, bh * t * t * elt, bwd, dbias=True), what)
    for r in att:
        by_name[r["name"]]["bias_grad"] = sub(r, shape=what)

    # the CTC kernel at DeepSpeech2's encoder length with char labels
    secs = np.clip(np.random.default_rng(SEED + 33).lognormal(mean=np.log(12.0), sigma=0.35, size=FAMILY_B), 1.5, TRAIN_SECS)
    secs[0] = TRAIN_SECS
    t_np = np.minimum(np.ceil(secs * 50.0).astype(np.int64) + 1, DS2_T)
    u_np = np.clip((secs * FAMILY_CHARS_PER_S).astype(np.int64), 1, FAMILY_U)
    row = ctc_kernel_row(dev, gen, FAMILY_B, DS2_T, FAMILY_U, CHAR_V, (t_np, u_np), f"deepspeech2 train loss, T {DS2_T}, char labels")
    by_name["ctc_loss"]["t801"] = sub(row, shape=f"B {FAMILY_B} T {DS2_T} S {2 * FAMILY_U + 1} V {CHAR_V}", library_fwd_ms=row["library_fwd_ms"],
                                      us_per_row_update=row["us_per_row_update"])


def family_train(dev, name: str, model, batch) -> tuple[dict, float]:
    """FAMILY_STEPS default (auto) training steps of ``model`` on ``batch``
    (its config's dropout and SpecAugment, Adam at FAMILY_LR), each step's
    launches checked, the loss falling; one profiled step for the busy
    share. Returns the launch counts and the busy share."""
    tag = f"ctc train {name}"
    counts, losses, walls, trainer, state, batch, _ = run_train(dev, "auto", FAMILY_STEPS, PER_STEP_FAMILY[name], tag, model=model,
                                                                lr=FAMILY_LR[name], batch=batch)
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{tag}: loss did not fall over {FAMILY_STEPS} steps: {losses}")
    _, busy = profile_step(trainer, state, batch, walls, tag, top=8)
    print(f"{tag}: loss {losses[0]:.4f} → {losses[-1]:.4f} over {FAMILY_STEPS} steps; median step {float(np.median(walls[1:])):.1f} ms, busy "
          f"{busy:.1f}%")
    return counts, busy


def family_stream(dev, tmp: str) -> dict:
    """DeepSpeech2 uni (bf16, the LSTM kernels) through :func:`stream_path`,
    each layer's (c, h) carried. Returns the launch counts."""
    from tensorflowasr_tpu_torch.models.ctc.base import recognize

    model = family_model("deepspeech2_uni", torch.bfloat16, dev, tmp).eval()
    counts, outs = stream_path(dev, "deepspeech2_uni", model, PER_CHUNK_DS2_UNI, recognize, note=f"{DS2_UNI_LSTMS} LSTM layers' (c, h) carried")
    carried = [tuple(h.shape) for _, h in outs[-1].next_encoder_states]
    if carried != [(1, DS2_H)] * DS2_UNI_LSTMS:
        raise AssertionError(f"stream deepspeech2_uni: carried states {carried}")
    return counts


def explicit_mask_path(dev) -> dict:
    """Relative MHA with an explicit ``attention_mask`` (kernel A with the
    positional scores as its bias and the bias gradient) at the streaming
    Transformer-CTC's widths (D 512, 4 × 128), B 16 × T 400 ragged, f32:
    EXPLICIT_MASK_CALLS forward and backward calls, each launching kernel
    A's forward and backward once; the output and the input's gradient equal
    kernel B's route on the same visibility (the chunk mask as parameters,
    1e-4 of scale, on the valid query rows). The relative PE is the
    non-causal one: under the causal PE (R = T) the Transformer-XL shift of
    the explicit route reads a wrapped position for a key past the query,
    which the chunk mask leaves visible, where kernel B reads 0 (JAX's two
    routes differ there alike). Returns the launch counts."""
    from tensorflowasr_tpu_torch.models.layers.attention import MultiHeadRelativeAttention, compute_streaming_mask
    from tensorflowasr_tpu_torch.models.layers.general import random_init
    from tensorflowasr_tpu_torch.models.layers.positional import RelativeSinusoidalPositionalEncoding
    from tensorflowasr_tpu_torch.utils import math_util

    dm, t, chunk, hist = 512, T_ENC, 16, 64
    layer = MultiHeadRelativeAttention(dm, TCTC_HEADS, TCTC_HEAD, dm, use_attention_bias=True).to(dev)
    random_init(layer, torch.Generator().manual_seed(SEED))
    gen = torch.Generator(device=dev).manual_seed(SEED + 35)
    x = _randn(gen, (TRAIN_B, t, dm), 1.0, dev=dev).requires_grad_(True)
    lengths = torch.tensor([max(40, t - 23 * i) for i in range(TRAIN_B)], device=dev)
    _, relpe = RelativeSinusoidalPositionalEncoding()(x, lengths)
    qmask = math_util.sequence_mask(lengths, t)
    attn = compute_streaming_mask(chunk, hist, t, t, dev)[None].expand(TRAIN_B, t, t)
    dout = _randn(gen, (TRAIN_B, t, dm), 1.0, dev=dev) * qmask[..., None]  # padded query rows take no gradient: their near-uniform rows differ in rounding
    torch.cuda.synchronize()
    reset_launch_counts()
    for i in range(EXPLICIT_MASK_CALLS):
        before = launch_counts()
        out, _ = layer(x, x, relpe=relpe, query_mask=qmask, attention_mask=attn)
        (dx,) = torch.autograd.grad(out, x, dout)
        delta = {k: v - before[k] for k, v in launch_counts().items()}
        if delta != PER_CALL_EXPLICIT_MASK:
            raise AssertionError(f"relmha explicit mask call {i}: kernel launches {delta}, expected {PER_CALL_EXPLICIT_MASK}")
    counts = launch_counts()
    layer.chunk_size, layer.history_size = chunk, hist  # the same visibility through kernel B's parameters
    ref, _ = layer(x, x, relpe=relpe, query_mask=qmask)
    (ref_dx,) = torch.autograd.grad(ref, x, dout)
    valid = qmask[..., None]
    err = _close("relmha explicit mask vs kernel B, output", out * valid, ref * valid, 1e-4 * ref.abs().max().item(), 0.0)
    err_dx = _grads_close("relmha explicit mask vs kernel B, d query", [dx], [ref_dx], 1e-4)
    print(f"relmha explicit mask (D {dm}, {TCTC_HEADS} x {TCTC_HEAD}, non-causal PE, B {TRAIN_B} T {t}, the chunk-{chunk} history-{hist} mask given as "
          f"attention_mask, f32): {EXPLICIT_MASK_CALLS} forward + backward calls, launches per call {_launched(PER_CALL_EXPLICIT_MASK)}; against kernel "
          f"B's route on the same visibility: output max abs err {err:.3e} on valid rows, d query {err_dx:.3e} (1e-4 of scale)")
    return counts


def family_overfit(dev, tmp: str) -> tuple[dict, dict]:
    """A 2-layer bidirectional DeepSpeech2 (the base layout at its widths,
    the LSTM kernels, bf16, dropout 0, no SpecAugment) fitted to the data
    phase's four overfit utterances until ``evaluate_dataset`` reads WER 0
    (:func:`run_overfit`'s caps), then evaluated with beam search, without
    and with a bigram LM of the four transcripts (:func:`beam_overfit`).
    Returns the launch counts of the overfit and of the beam evaluations."""
    from tensorflowasr_tpu_torch import pipeline
    from tensorflowasr_tpu_torch.data import datasets
    from tensorflowasr_tpu_torch.lm import NGramLM

    tok = pipeline.build_tokenizer(pipeline.load_config(CHAR_CONFIG, datadir=tmp))
    if tok.num_classes != CHAR_V:
        raise AssertionError(f"the char tokenizer has {tok.num_classes} classes, not {CHAR_V}")
    manifest = overfit_corpus(os.path.join(tmp, "overfit"))
    model = family_model("deepspeech2", torch.bfloat16, dev, tmp, depth=2, dropout=0.0)
    torch.cuda.synchronize()
    settle()
    reset_launch_counts()
    steps, seconds, report, _ = run_overfit(dev, tok, manifest, lr=DS2_OVERFIT_LR, time_cap=DS2_OVERFIT_SECONDS, model=model,
                                            step_cap=DS2_OVERFIT_STEPS)
    counts = launch_counts()
    if counts["lstm_bwd"] != 4 * steps or counts["ctc_loss"] != steps:
        raise AssertionError(f"deepspeech2 overfit: launches {_launched(counts)} over {steps} steps (4 LSTM backward and 1 CTC a step expected)")
    print(f"ctc overfit deepspeech2 (2 bidirectional LSTM layers at H {DS2_H}, the LSTM kernels, bf16, dropout 0, Adam {DS2_OVERFIT_LR:g}, the 4 "
          f"overfit utterances of 1-3 s as one batch): WER 0 after {steps} steps in {seconds:.1f} s (caps {DS2_OVERFIT_STEPS} steps, "
          f"{DS2_OVERFIT_SECONDS:.0f} s); "
          f"rows {[r[2] for r in report['rows']]}; launches {_launched(counts)}")
    test = datasets.ASRSliceDataset(tok, stage="test", data_paths=[manifest], indefinite=False, drop_remainder=False)
    test.compute_metadata()
    beam = beam_overfit(dev, model.eval(), tok, test, "deepspeech2 (2 layers)", lm=NGramLM.from_text_corpus(OVERFIT_TEXTS, tok, order=2))
    return counts, beam


def phase_ctc_family(dev) -> dict:
    """The rest of the CTC family at its published widths in bf16 with random
    weights from the seed, each built from its example config: DeepSpeech2
    base (bidirectional, the LSTM kernels) serving 3 requests of 8 × 6–10 s
    and training FAMILY_STEPS steps of 8 × ≤ 16 s with char labels at ~12 a
    second (V 29); DeepSpeech2 uni streaming 16 chunks of 160 ms with its
    carried LSTM states; Jasper base serving and training at the same
    shapes; the streaming Transformer-CTC (relative PE, kernel B at head
    128) serving and training at 16 × ≤ 16 s; the streaming Conformer-CTC
    Small serving; relative MHA with an explicit mask (kernel A with the bias
    gradient); and a 2-layer DeepSpeech2 overfit to WER 0. Returns the
    launch counts by path."""
    import tempfile

    t0 = time.perf_counter()
    paths = {}
    with tempfile.TemporaryDirectory(prefix="tfasr-family-") as tmp:
        char_batch = train_batch(np.random.default_rng(SEED + 2), FAMILY_B, TRAIN_SECS, FAMILY_U, CHAR_V, FAMILY_CHARS_PER_S)
        for name in ("deepspeech2", "jasper", "transformer_ctc_streaming"):
            model = family_model(name, torch.bfloat16, dev, tmp)
            if name == "transformer_ctc_streaming":
                heads = {m.mhsa.key_dim for m in model.modules() if type(m).__name__ == "MHSAModule"}
                if heads != {TCTC_HEAD} or not model.encoder.pe.causal:
                    raise AssertionError(f"{name}: head sizes {heads}, causal relative PE {model.encoder.pe.causal}")
                batch = train_batch(np.random.default_rng(SEED + 2), TRAIN_B, TRAIN_SECS, TRAIN_U, model.vocab_size)
            else:
                batch = char_batch
            if name == "deepspeech2" and model.rnn_impl != "pallas":
                raise AssertionError(f"{name} built from its config on the card takes rnn_impl {model.rnn_impl!r}, not the LSTM kernels")
            paths[f"ctc_serve_{name}"] = serve_ctc(dev, name, model.eval(), PER_REQUEST_FAMILY[name], hunt=False)
            paths[f"ctc_train_{name}"], _ = family_train(dev, name, model.train(), batch)
            del model
        paths["stream_deepspeech2_uni"] = family_stream(dev, tmp)
        paths["ctc_serve_conformer_ctc_streaming"] = serve_ctc(dev, "conformer_ctc_streaming", family_model("conformer_ctc_streaming", torch.bfloat16, dev,
                                                                                                             tmp).eval(),
                                                               PER_REQUEST_FAMILY["conformer_ctc_streaming"], hunt=False)
        paths["relmha_explicit_mask"] = explicit_mask_path(dev)
        paths["ctc_overfit_deepspeech2"], paths["beam_overfit_deepspeech2"] = family_overfit(dev, tmp)
    print(f"ctc_family phase: {time.perf_counter() - t0:.1f} s")
    return paths


def phase_ctc_family_parity(dev) -> None:
    """One f32 default (auto) training step, card (kernels) vs CPU (plain
    versions), of a 2-layer DeepSpeech2 (bidirectional, the LSTM kernels)
    and a 2-block streaming Transformer-CTC (kernel B at head 128), each at
    its published widths, dropout 0: the loss and every gradient; and a
    2-block Jasper's (:func:`jasper_parity`)."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="tfasr-family-") as tmp:
        for name, kwargs in (("deepspeech2", {"rnn_impl": "pallas"}), ("transformer_ctc_streaming", {})):
            _step_parity(dev, "auto", "pallas", cpu_model=family_model(name, torch.float32, "cpu", tmp, depth=2, dropout=0.0, **kwargs),
                         what=f"{name}, 2 deep, auto")
        jasper_parity(dev, tmp)


@contextlib.contextmanager
def jasper_relu_masks(model, masks: dict, replay: bool):
    """Within the block, each Jasper sub-block of ``model`` records the sign
    pattern of its ReLU's input (x > 0) into ``masks`` by module name or,
    with ``replay``, takes the pattern recorded there as its ReLU's (x ·
    mask): every run that replays one pattern computes one piecewise-linear
    function."""
    from tensorflowasr_tpu_torch.models.encoders import jasper
    from tensorflowasr_tpu_torch.ops import dropout as dr

    names = {m: n for n, m in model.named_modules()}
    forward = jasper.JasperSubBlock.forward

    def masked(self, x, residuals=(), train=False, generator=None):
        x = self.bn(self.conv1d(x), train)
        for r in residuals:
            x = x + r
        if replay:
            x = x * masks[names[self]].to(x.device, x.dtype)
        else:
            masks[names[self]] = (x > 0).detach().cpu()
            x = torch.relu(x)
        return dr.dropout(x, dr.active_rate(self.dropout, train, generator), generator)

    jasper.JasperSubBlock.forward = masked
    try:
        yield
    finally:
        jasper.JasperSubBlock.forward = forward


JASPER_F64_REL = 1e-9  # card float64 vs CPU float64, the same ReLU pattern: the same code gives float64 rounding only


def jasper_parity(dev, tmp: str) -> None:
    """A 2-block Jasper's training step at its published widths (dropout 0,
    BatchNorm on batch statistics), :func:`referee_grads`' runs. A ReLU
    whose input lies within rounding of 0 takes another side on another
    device, and changes its element's gradient by the whole of it; BatchNorm
    on batch statistics spreads that over the channel, so that a handful of
    such elements sets a run's distance to float64
    (``scripts_torch/jasper_step_numerics.py`` measures it layer by layer).
    So the runs share ReLU patterns: held to :func:`hold_step`, the card
    (the CTC kernel, cuDNN's convolutions) with the CPU's pattern against
    the CPU's f32 step, and the card with its own pattern against the CPU
    with the card's; the card's float64 step against the CPU's, both with
    the CPU's f32 pattern, within JASPER_F64_REL. Printed: the elements
    whose side differs, and each f32 run's distance to float64."""
    cpu_masks, card_masks = {}, {}
    build = lambda dtype: family_model("jasper", dtype, "cpu", tmp, depth=2, dropout=0.0)
    record, replay = (lambda masks: lambda model: jasper_relu_masks(model, masks, False)), (lambda masks: lambda model: jasper_relu_masks(model, masks, True))
    runs = referee_grads(build, [("cpu f32", "cpu", torch.float32, "auto", record(cpu_masks)),
                                 ("card f32", dev, torch.float32, "auto", replay(cpu_masks)),
                                 ("card f32 own pattern", dev, torch.float32, "auto", record(card_masks)),
                                 ("cpu f32 card pattern", "cpu", torch.float32, "auto", replay(card_masks)),
                                 ("cpu f64", "cpu", torch.float64, "xla", replay(cpu_masks)),
                                 ("card f64", dev, torch.float64, "xla", replay(cpu_masks))])
    held = hold_step("jasper, 2 deep, the CPU's ReLU pattern", runs["card f32"], runs["cpu f32"])
    held_own = hold_step("jasper, 2 deep, the card's ReLU pattern", runs["card f32 own pattern"], runs["cpu f32 card pattern"])
    ref_loss, ref = runs["cpu f64"]
    gmax = max(g.abs().max().item() for g in ref.values())
    dist = {run: max((runs[run][1][n] - r).abs().max().item() / r.abs().max().item() for n, r in ref.items() if r.abs().max().item() > TRAIN_PARITY_FLOOR * gmax)
            for run in ("card f64", "card f32", "cpu f32", "card f32 own pattern")}
    if not dist["card f64"] <= JASPER_F64_REL:
        raise AssertionError(f"jasper parity: the card's float64 step lies {dist['card f64']:.3e} from the CPU's (> {JASPER_F64_REL})")
    flips = {n: int((card_masks[n] != m).sum()) for n, m in cpu_masks.items()}
    print(f"parity f32 train step (jasper, 2 deep, BatchNorm on batch statistics, auto) card (kernels) vs CPU (plain), the same features, the CPU's ReLU "
          f"pattern on both: {held}; the card's own pattern on both: {held_own}; TF32 off. ReLU inputs on another side on the card: "
          f"{sum(flips.values())} of {sum(m.numel() for m in cpu_masks.values())} ({ {n.removeprefix('encoder.'): f for n, f in flips.items() if f} }); "
          f"the largest gradient distance to float64 relative to scale: card f64 {dist['card f64']:.3e} (tol {JASPER_F64_REL}), card f32 "
          f"{dist['card f32']:.3e}, CPU f32 {dist['cpu f32']:.3e} (the CPU's pattern), card f32 with its own pattern {dist['card f32 own pattern']:.3e}")


# --------------------------------- the other transducers, beam search --------------------------------- #

TRANSDUCER_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples", "models", "transducer")
TRANSDUCER_CONFIGS = {"transformer_t": "transformer/base.yml.j2", "rnnt": "rnnt/small.yml.j2", "contextnet": "contextnet/small.yml.j2"}
TRANSDUCERS = tuple(TRANSDUCER_CONFIGS)
# transformer/base.yml.j2: 8 relmha blocks of 4 × 64 (kernel B each); rnnt/small.yml.j2: 4 LSTM-1024 layers and an LSTM-1024 prediction net, all on the
# LSTM kernels (the default on the card); contextnet/small.yml.j2: cuDNN's convolutions only. Each: the frontend and one fused decode a request.
RNNT_LAYERS, RNNT_H = 4, 1024
PER_REQUEST_T = {"transformer_t": _per(log_mel_spectrogram=1, fused_rel_attention=8, fused_decode=1),
                 "rnnt": _per(log_mel_spectrogram=1, lstm=RNNT_LAYERS, fused_decode=1), "contextnet": _per(log_mel_spectrogram=1, fused_decode=1)}
_LOSS = dict(rnnt_dp=1, rnnt_fused_joint=1, rnnt_fused_joint_bwd=1)
PER_STEP_T = {"transformer_t": _per(log_mel_spectrogram=1, fused_rel_attention=8, fused_rel_attention_bwd=8, **_LOSS),
              "rnnt": _per(log_mel_spectrogram=1, lstm=RNNT_LAYERS + 1, lstm_bwd=RNNT_LAYERS + 1, **_LOSS), "contextnet": _per(log_mel_spectrogram=1, **_LOSS)}
PER_EVAL_T = {"transformer_t": _per(log_mel_spectrogram=1, fused_rel_attention=8, rnnt_logprobs=1, rnnt_dp=1),
              "rnnt": _per(log_mel_spectrogram=1, lstm=RNNT_LAYERS + 1, rnnt_logprobs=1, rnnt_dp=1),
              "contextnet": _per(log_mel_spectrogram=1, rnnt_logprobs=1, rnnt_dp=1)}
PER_CHUNK_RNNT = PER_REQUEST_T["rnnt"]
T_STEPS = 3
# Adam without warm-up, as the CTC phases: the post-norm Transformer at 1e-5 (the Transformer-CTC diverges at 1e-4), the others at 1e-4
T_LR = {"transformer_t": 1e-5, "rnnt": 1e-4, "contextnet": 1e-4}
BEAM = 4
T_PARITY_ATOL = 2e-3  # f32 encoder outputs card vs CPU, relative to max(1, their scale)


def transducer_model(name: str, dtype, device, tmp: str, depth: int | None = None, dropout: float | None = None, **kwargs) -> torch.nn.Module:
    """The example's transducer through the port's ``Config`` and
    ``build_model`` at its published widths (the RNN-T's LSTMs on the route
    its default takes for ``device``), random weights from SEED; cut to
    ``depth`` Transformer blocks, RNN-T layers or ContextNet blocks (the
    first ones), and with dropout at ``dropout`` and no SpecAugment, when given."""
    from tensorflowasr_tpu_torch import pipeline
    from tensorflowasr_tpu_torch.models import build_model

    config = pipeline.load_config(os.path.join(TRANSDUCER_DIR, TRANSDUCER_CONFIGS[name]), modeldir=tmp)
    mc = copy.deepcopy(config.model_config)
    c = mc["config"]
    if depth is not None:
        if name == "transformer_t":
            c["encoder_num_blocks"] = depth
        elif name == "rnnt":
            c.update(encoder_nlayers=depth, encoder_reduction_positions=c["encoder_reduction_positions"][:depth],
                     encoder_reduction_factors=c["encoder_reduction_factors"][:depth])
        else:
            c["encoder_blocks"] = c["encoder_blocks"][:depth]
    if dropout is not None:
        for key in [k for k in c if k.endswith("dropout")]:
            c[key] = dropout
        c["speech_config"].pop("augmentation_config", None)
    model = build_model(mc, vocab_size=config.decoder_config.vocab_size, dtype=dtype, device=device, **kwargs)
    model.reset_parameters(torch.Generator().manual_seed(SEED))
    return model


def rnnt_lstm_lengths() -> list[int]:
    """The RNN-T encoder's LSTM lengths at 16 s: layer 0 on the frames, layers 1–2 after the ×3 reduction, layer 3 after the ×2."""
    t0 = 1 + (int(TRAIN_SECS * 16000) - 400) // 160
    return [t0, -(-t0 // 3), -(-t0 // 6)]


def transducer_kernels(dev, rows: list[dict]) -> None:
    """The kernels the three transducers run at shapes the port had not run,
    each against its plain version (f32 and bf16), times and bounds in bf16,
    as sub-entries of their rows: kernel B at head 64 (the Transformer-T's
    training shape: B·H 64, T = S 400, R 799, rate 0.1); the LSTM at H 1024,
    B 16 over the RNN-T's 16 s layers (T 1598, 533, 267) beside cuDNN's
    ``torch.nn.LSTM`` over each layer's input width; the fused joint and loss
    at V 1000, B 16, T 400; and the fused greedy decode at the RNN-T's
    prediction net (embedding 512, LSTM-1024, J 320, V 256) and at the V 1000
    nets (the Transformer-T's), on a request's real encoding, beside the
    plain version and the eager WIND loop."""
    import tempfile

    from tensorflowasr_tpu_torch.ops.cuda import attention_kernel as ak
    from tensorflowasr_tpu_torch.ops.cuda import joint_loss_kernel as jk
    from tensorflowasr_tpu_torch.ops.cuda import lstm_kernel as lk

    gen = torch.Generator(device=dev).manual_seed(SEED + 41)
    by_name = {r["name"]: r for r in rows}
    keys = ("max_abs_err", "max_abs_err_bf16", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    sub = lambda r, **extra: {k: r[k] for k in keys} | extra

    # kernel B at head 64
    bh, t, d = TRAIN_B * 4, T_ENC, 64
    r_len = 2 * t - 1
    q_len = torch.tensor([max(40, t - 23 * i) for i in range(TRAIN_B)], dtype=torch.int32, device=dev)
    what = f"transformer-t train, BH {bh} T = S {t} R {r_len} head {d}, rate {TRAIN_RATE}"

    def att_make(dt, rate=TRAIN_RATE):
        qc, qp = _randn(gen, (bh, t, d), 0.3, dt), _randn(gen, (bh, t, d), 0.3, dt)
        k, v, pos = _randn(gen, (bh, t, d), 1.0, dt), _randn(gen, (bh, t, d), 1.0, dt), _randn(gen, (bh, r_len, d), 1.0, dt)
        cfg_ = (11, rate, False, None, None, False)
        res = ak.fused_rel_attention_kernel(qc, qp, k, v, pos, None, q_len, *cfg_, with_stats=dt == torch.bfloat16)
        out, stats = res if dt == torch.bfloat16 else (res, None)
        return (qc, qp, k, v, pos, None, q_len, *cfg_), (qc, qp, k, v, pos, None, q_len, out, stats, _randn(gen, (bh, t, d), 1.0, dt), *cfg_)

    head = _check_fwd_bwd("fused_rel_attention", ak.fused_rel_attention_kernel, ak.fused_rel_attention_plain, rel_att_bwd, rel_att_bwd_plain, att_make,
                          lambda elt, bwd: cost_attention(bh, t, t, r_len, d, elt, bwd), what)
    for r in head:
        by_name[r["name"]]["head64"] = sub(r, shape=what)

    # the LSTM at H 1024 over the RNN-T encoder's layers (16 s)
    b, h = TRAIN_B, RNNT_H
    widths = {0: 80, 1: 960, 3: 640}  # each timed layer's input width (cuDNN's x): 80 mel bins, 3 × 320 stacked, 2 × 320 stacked
    entries = {}
    for layer, tl in zip((0, 1, 3), rnnt_lstm_lengths()):
        errs = {}
        for tag, dt in DTYPES:
            xg, wh = _randn(gen, (b, tl, 4 * h), 1.0, dt), _randn(gen, (h, 4 * h), h ** -0.5, dt)
            h0, c0 = _randn(gen, (b, h), 0.3, dt), _randn(gen, (b, h), 0.3, dt)
            ref = lk.lstm_fwd_plain(xg, wh, h0, c0)
            err_f = max(_close(f"lstm fwd {tag} H {h} T {tl} {n}", x, y, *TOL[tag]) for n, x, y in zip(("y", "cseq", "gates"), lk.lstm_fwd_kernel(xg, wh, h0, c0), ref))
            bargs = (ref[2], ref[1], c0, wh, _randn(gen, (b, tl, h), 1.0 / b, dt), _randn(gen, (b, tl, h), 0.1 / b, dt))
            errs[tag] = (err_f, _grads_close(f"lstm bwd {tag} H {h} T {tl}", lk.lstm_bwd_kernel(*bargs), lk.lstm_bwd_plain(*bargs), GRAD_REL[tag]))
        fargs = (xg, wh, h0, c0)
        ms_f, ms_b = time_ms(lk.lstm_fwd_kernel, *fargs), time_ms(lk.lstm_bwd_kernel, *bargs)
        plain = (wall_ms(lambda: lk.lstm_fwd_plain(*fargs), reps=1), wall_ms(lambda: lk.lstm_bwd_plain(*bargs), reps=1)) if layer == 0 else (None, None)
        lib = lstm_library(gen, b, tl, h, torch.bfloat16, width=widths[layer])
        bd = [bound(*cost_lstm(b, tl, h, 2, bwd), "bf16") for bwd in (False, True)]
        entries[tl] = [dict(max_abs_err=errs["f32"][i], max_abs_err_bf16=errs["bf16"][i], ms=m, plain_ms=p, bound_ms=q[0], bound_by=q[1], library_ms=lb,
                            us_per_step=1e3 * m / tl, layer=layer, library=f"cuDNN torch.nn.LSTM, x [{b}, {tl}, {widths[layer]}]")
                       for i, (m, p, q, lb) in enumerate(zip((ms_f, ms_b), plain, bd, lib))]
        print(f"kernel lstm[_bwd] bf16 (rnnt encoder layer {layer}, B {b} T {tl} H {h}; {lstm_plan_text(lk.lstm_mma_plan(h), h)}): max_abs_err fwd f32 "
              f"{errs['f32'][0]:.3e} bf16 {errs['bf16'][0]:.3e}, bwd f32 {errs['f32'][1]:.3e} bf16 {errs['bf16'][1]:.3e}; forward {ms_f:.4f} ms "
              f"({1e3 * ms_f / tl:.3f} µs per step), backward {ms_b:.4f} ms ({1e3 * ms_b / tl:.3f} µs per step); cuDNN torch.nn.LSTM bf16 over x "
              f"[{b}, {tl}, {widths[layer]}] {lib[0]:.4f} / {lib[1]:.4f} ms; bound {bd[0][0]:.4f} / {bd[1][0]:.4f} ms"
              + (f"; plain (host loop) {plain[0]:.1f} / {plain[1]:.1f} ms" if plain[0] else ""))
    for i, name in enumerate(("lstm", "lstm_bwd")):
        by_name[name]["rnnt_h1024"] = {str(tl): e[i] for tl, e in entries.items()}

    # the fused joint and loss at V 1000, B 16, T 400
    v, u1 = 1000, TRAIN_U + 1
    t_np, u_np = loss_lengths(np.random.default_rng(SEED + 43), TRAIN_B)
    t_len, u_len = torch.tensor(t_np, device=dev), torch.tensor(u_np, device=dev)
    labels = torch.randint(1, v, (TRAIN_B, TRAIN_U), generator=gen, device=dev)
    labels[torch.arange(TRAIN_U, device=dev)[None, :] >= u_len[:, None]] = 0
    active = {}

    def joint_make(dt):
        enc_p, pred_p = _randn(gen, (TRAIN_B, T_ENC, JOINT), 1.0, dt), _randn(gen, (TRAIN_B, u1, JOINT), 1.0, dt)
        wv, bv = _randn(gen, (v, JOINT), JOINT ** -0.5, dt), _randn(gen, (v,), 0.1)
        fargs = (enc_p, pred_p, wv, bv, labels)
        _, lse, gbl, gem = jk.rnnt_loss_fused_joint_plain(*fargs[:4], t_len, labels, u_len)
        active["cells"] = int(((gbl != 0) | (gem != 0)).sum())
        return fargs, (*fargs, lse, gbl / TRAIN_B, gem / TRAIN_B)

    what = f"transformer-t / contextnet train loss, [{TRAIN_B}, {T_ENC}, {u1}] cells, J {JOINT}, V {v}"
    joint = _check_fwd_bwd("rnnt_fused_joint", _stacked(jk.joint_logprobs_kernel), _stacked(jk.joint_logprobs_plain), jk.rnnt_loss_fused_joint_bwd_kernel,
                           jk.rnnt_loss_fused_joint_plain_bwd, joint_make,
                           lambda elt, bwd: cost_joint(TRAIN_B, T_ENC, u1, JOINT, v, elt, bwd, active["cells"]), what)
    for r in joint:
        by_name[r["name"]]["v1000_b16"] = sub(r, shape=what, active_cells=active["cells"])

    # the fused decode at the RNN-T's prediction net and at V 1000
    with tempfile.TemporaryDirectory(prefix="tfasr-transducers-") as tmp:
        for name in ("rnnt", "transformer_t"):
            by_name["fused_decode"][f"{name}_net"] = transducer_decode_check(dev, name, tmp)


def transducer_decode_check(dev, name: str, tmp: str) -> dict:
    """Row 13 at ``name``'s prediction net and joint, on the real encoding of
    one request (8 × 6–10 s) of the full model: in f32 the kernel's tokens,
    lengths and next tokens equal the plain version's and the eager WIND
    loop's, its states the plain version's within 1e-5; in bf16 a token
    differs from the plain version's only within DECODE_GAP of the logit
    scale. Times (kernel by CUDA events, the host loops by wall), the
    cluster, resident bytes, and the bound. Returns the sub-entry."""
    from tensorflowasr_tpu_torch.ops import transducer_decode
    from tensorflowasr_tpu_torch.ops.cuda import decode_kernel as dk

    audio, lens = make_request(np.random.default_rng(SEED + 5), 8, 6.0, 10.0, dev)
    out = {}
    for tag, dt in DTYPES:
        model = transducer_model(name, dt, dev, tmp).eval()
        params = model.decode_params()
        if params is None:
            raise AssertionError(f"decode {name}: extract_decode_params does not take the config")
        pc, jc = model.prediction_config, model.joint_config
        e, h, j, v = pc["embed_dim"], pc["rnn_units"], jc["joint_dim"], model.vocab_size
        with torch.inference_mode():
            enc, enc_len, _ = model.encode(audio, lens)
            b = enc.shape[0]
            start, states = torch.zeros(b, dtype=torch.int64, device=dev), model.init_decoder_states(b, dev)
            kernel = lambda x: dk.fused_greedy_decode_kernel(x, enc_len, params, start, states, window=DECODE_WINDOW)
            plain = lambda x, **kw: dk.fused_greedy_decode_plain(x, enc_len, params, start, states, window=DECODE_WINDOW, **kw)
            eager = lambda x: transducer_decode.transducer_greedy_decode_wind(x, enc_len, model.pred_step, model.joint_window, start, states,
                                                                                window=DECODE_WINDOW)
            got, ref = kernel(enc), plain(enc, gaps=True)
            torch.cuda.synchronize()
            launch = dict(dk.last_launch)
            state_err = max((x - y).abs().max().item() for g, r in zip(got[3], ref[3]) for x, y in zip(g, r))
            # the cell state c is unbounded: over up to 2T dependent steps it grows past 1, and f32 summation order scales with it
            state_tol = 1e-5 * max(1.0, max(y.abs().max().item() for r in ref[3] for y in r))
            if tag == "f32":
                eag = eager(enc)
                for other_name, other in (("plain version", ref), ("eager WIND loop", eag)):
                    if not all(torch.equal(x, y) for x, y in zip(got[:3], other[:3])):
                        raise AssertionError(f"decode f32 ({name} net): kernel tokens/lengths/next tokens differ from the {other_name}: rows "
                                             f"{_first_difference(got[0], other[0], got[1], other[1])}")
                if state_err > state_tol:
                    raise AssertionError(f"decode f32 ({name} net): states differ from the plain version by {state_err} (tol {state_tol})")
                note = (f"tokens, lengths, next tokens equal to the plain version's and the eager loop's; states max_abs_err {state_err:.3e} (tol 1e-5 "
                        f"of max(1, the states' largest magnitude): {state_tol:.3e})")
            else:
                note = decode_bf16_agreement(params, start, states, enc, got, ref, "raw encoding")
            ms, plain_ms, eager_ms = time_ms(kernel, enc), wall_ms(lambda: plain(enc), reps=1), wall_ms(lambda: eager(enc), reps=1)
        t_np, u_np = enc_len.cpu().numpy(), got[1].cpu().numpy()
        bd = bound(*cost_decode(t_np, u_np, enc.shape[1], e, h, j, v, 4 if tag == "f32" else 2), tag)
        out[tag] = dict(err=state_err, ms=ms, plain_ms=plain_ms, eager_ms=eager_ms, bound=bd, tokens=[int(u_np.min()), int(u_np.max())])
        print(f"kernel fused_decode {tag} ({name} net: B {b} T {enc.shape[1]} (T_b {t_np.min()}-{t_np.max()}), E {model.encoder_output_dim} embedding "
              f"{e} H {h} J {j} V {v}, window {DECODE_WINDOW}): tokens per row {u_np.min()}-{u_np.max()}; {note}; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.1f} ms, eager WIND loop {eager_ms:.1f} ms; bound {bd[0]:.4f} ms ({bd[1]}); cluster C {launch['cluster']} (co-resident "
              f"clusters by size {launch['occupancy']}), {launch['resident_bytes']} of {launch['slice_bytes']} weight bytes resident per block, "
              f"{launch['smem_bytes']} bytes of shared memory")
        if tag == "bf16":
            out["cluster"] = {k: launch[k] for k in ("cluster", "occupancy", "resident_bytes", "slice_bytes", "smem_bytes")}
        del model
    bf = out["bf16"]
    return dict(max_abs_err=out["f32"]["err"], max_abs_err_bf16=bf["err"], ms=bf["ms"], plain_ms=bf["plain_ms"], bound_ms=bf["bound"][0],
                bound_by=bf["bound"][1], library_ms=None, eager_loop_ms=bf["eager_ms"], ms_f32=out["f32"]["ms"], tokens_per_row=bf["tokens"],
                cluster=out["cluster"])


def serve_transducer(dev, name: str, model, per_request: dict, recognize_kwargs: dict | None = None, tag: str | None = None) -> tuple[dict, list]:
    """3 requests of 8 × 6–10 s through the transducer ``recognize`` (greedy
    WIND: the fused decode; or as ``recognize_kwargs`` say) after one
    warm-up request, each request's launches equal to ``per_request``; then,
    for greedy, encode and decode timed apart on the same requests (the
    eager WIND loop beside the fused decode on request 0). Returns the launch
    counts and the walls (s)."""
    from tensorflowasr_tpu_torch import schemas
    from tensorflowasr_tpu_torch.models.transducer.base import recognize
    from tensorflowasr_tpu_torch.ops import transducer_decode
    from tensorflowasr_tpu_torch.ops.cuda.decode_kernel import fused_greedy_decode

    kw = recognize_kwargs or {}
    tag = tag or f"transducer serve {name}" + (f" beam {kw['beam_width']}" if kw.get("beam_width") else "")
    rng = np.random.default_rng(SEED)
    requests = [make_request(rng, 8, 6.0, 10.0, dev) for _ in range(3)]
    recognize(model, schemas.PredictInput(*make_request(rng, 8, 6.0, 10.0, dev)), **kw)  # warm-up request, not counted
    torch.cuda.synchronize()
    settle()
    reset_launch_counts()
    walls, watches, outs = [], [], []
    for r, (audio, lens) in enumerate(requests):
        before = launch_counts()
        with RequestWatch() as watch:
            t0 = time.perf_counter()
            outs.append(recognize(model, schemas.PredictInput(audio, lens), **kw))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        watches.append(watch)
        delta = {k: v - before[k] for k, v in launch_counts().items()}
        if delta != per_request:
            raise AssertionError(f"{tag} request {r}: kernel launches {delta}, expected {per_request}")
        if not ((outs[-1].tokens >= 0) & (outs[-1].tokens < model.vocab_size)).all():
            raise AssertionError(f"{tag} request {r}: token ids outside the vocabulary")
    counts = launch_counts()
    flag_outliers(tag, walls, watches)
    for r, ((audio, lens), out) in enumerate(zip(requests, outs)):
        audio_s = lens.sum().item() / 16000.0
        with torch.inference_mode():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            enc, enc_len, _ = model.encode(audio, lens)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            dec = ""
            if not kw:
                start, states = torch.zeros(enc.shape[0], dtype=torch.int64, device=dev), model.init_decoder_states(enc.shape[0], dev)
                tokens, ntok, _, _ = fused_greedy_decode(enc, enc_len, model.decode_params(), start, states)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                if not torch.equal(tokens, out.tokens):
                    raise AssertionError(f"{tag} request {r}: recognize's tokens differ from the fused decode of its encoding")
                dec = f", decode {(t2 - t1) * 1e3:.3f} ms (the fused decode kernel"
                if r == 0:
                    transducer_decode.transducer_greedy_decode_wind(enc, enc_len, model.pred_step, model.joint_window, start, states)
                    torch.cuda.synchronize()
                    dec += f"; the eager WIND loop on the same encoding {(time.perf_counter() - t2) * 1e3:.3f} ms"
                dec += f"), tokens emitted mean {ntok.float().mean().item():.1f}"
        if not torch.isfinite(enc.float()).all():
            raise AssertionError(f"{tag} request {r}: non-finite encoder output")
        if tuple(out.tokens.shape) != (audio.shape[0], 2 * enc.shape[1] + 1):
            raise AssertionError(f"{tag} request {r}: tokens {tuple(out.tokens.shape)}, expected ({audio.shape[0]}, {2 * enc.shape[1] + 1})")
        print(f"{tag} request {r}: batch {audio.shape[0]}, audio {audio_s:.2f} s (max {audio.shape[1] / 16000:.2f} s), encoder frames {enc.shape[1]}, recognize "
              f"{walls[r] * 1e3:.3f} ms ({watches[r]}), encode {(t1 - t0) * 1e3:.3f} ms{dec}, RTF {walls[r] / audio_s:.6f} (wall / audio seconds)")
    print(f"{tag} launches over 3 requests: {_launched(counts)} (per request {_launched(per_request)}); bf16 compute, f32 params, TF32 off")
    return counts, walls


def transducer_eval(dev, tag: str, model, batch, per_eval: dict) -> dict:
    """EVAL_STEPS eval steps of ``model`` on ``batch`` with the default
    ``loss_impl`` (the log-probability row kernel and the DP), each step's
    launches equal to ``per_eval``, wall and peak memory; the loss against
    the plain-DP (xla) eval's to 1e-5. Returns the launch counts."""
    from tensorflowasr_tpu_torch.training.trainer import Trainer, make_eval_step

    trainer = Trainer(model, {"class_name": "Adam", "config": {"learning_rate": 1e-4}}, device=dev)
    state = trainer.init_state(seed=SEED)
    batch = batch.to(dev)
    torch.cuda.synchronize()
    reset_launch_counts()
    losses = []
    for step in range(EVAL_STEPS):
        before = launch_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        loss = trainer.eval_step(state, batch)["loss"].item()
        wall = (time.perf_counter() - t0) * 1e3
        delta = {k: v - before[k] for k, v in launch_counts().items()}
        if delta != per_eval:
            raise AssertionError(f"{tag} step {step}: kernel launches {delta}, expected {per_eval}")
        if not np.isfinite(loss):
            raise AssertionError(f"{tag} step {step}: non-finite loss {loss}")
        print(f"{tag} step {step}: {wall:.1f} ms (host clock, ends in the loss's .item()); loss {loss:.6f}; peak memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2**20:.0f} MiB")
        losses.append(loss)
    counts = launch_counts()
    t0 = time.perf_counter()
    xla = make_eval_step(model, "xla")(state, batch)["loss"].item()
    xla_wall = (time.perf_counter() - t0) * 1e3
    if not abs(losses[0] - xla) <= 1e-5 * abs(xla):
        raise AssertionError(f"{tag}: default (kernels) loss {losses[0]} vs xla (plain DP) {xla}")
    print(f"{tag} launches per step {_launched(per_eval)}; loss default (row kernel + DP kernel) {losses[0]:.6f} vs xla (plain DP) {xla:.6f} (rel "
          f"{abs(losses[0] - xla) / abs(xla):.2e}, tol 1e-5); the xla eval step took {xla_wall:.1f} ms")
    return counts


def rnnt_stream(dev, tmp: str) -> dict:
    """The RNN-T (bf16, the LSTM kernels) through :func:`stream_path`, each
    block's (c, h), the prediction net's state and the token carried (each
    chunk pads under the ×3 and ×2 reductions as a whole utterance does).
    Returns the launch counts."""
    model = transducer_model("rnnt", torch.bfloat16, dev, tmp).eval()
    counts, outs = stream_path(dev, "rnnt", model, PER_CHUNK_RNNT, note=f"{RNNT_LAYERS} LSTM-{RNNT_H} layers' (c, h) carried")
    carried = [tuple(h.shape) for _, h in outs[-1].next_encoder_states]
    if carried != [(1, RNNT_H)] * RNNT_LAYERS:
        raise AssertionError(f"stream rnnt: carried encoder states {carried}")
    return counts


def phase_transducers(dev) -> dict:
    """The three transducers at their published widths in bf16, each built
    from its example config through ``Config`` and ``build_model`` with
    random weights from the seed and the example's dropout and SpecAugment:
    serving 3 requests of 8 × 6–10 s (greedy WIND through the fused
    decode), T_STEPS default (auto) training steps of 16 × ≤ 16 s with Adam
    (the loss falling, one profiled step for the busy share) and EVAL_STEPS
    eval steps of the same batch; the RNN-T also streaming 16 chunks of
    160 ms. Returns the launch counts by path."""
    import tempfile

    t0 = time.perf_counter()
    paths = {}
    with tempfile.TemporaryDirectory(prefix="tfasr-transducers-") as tmp:
        for name in TRANSDUCERS:
            model = transducer_model(name, torch.bfloat16, dev, tmp)
            if name == "rnnt" and model.rnn_impl != "pallas":
                raise AssertionError(f"rnnt built from its config on the card takes rnn_impl {model.rnn_impl!r}, not the LSTM kernels")
            if model.decode_params() is None:
                raise AssertionError(f"{name}: the fused decode does not take the config")
            n_params = sum(p.numel() for p in model.parameters())
            print(f"transducer {name}: {TRANSDUCER_CONFIGS[name]} through Config and build_model, {type(model).__name__}, {n_params} parameters, "
                  f"V {model.vocab_size}, encoder reduction x{model.time_reduction_factor}")
            paths[f"t_serve_{name}"], _ = serve_transducer(dev, name, model.eval(), PER_REQUEST_T[name])
            batch = train_batch(np.random.default_rng(SEED + 2), TRAIN_B, TRAIN_SECS, TRAIN_U, model.vocab_size)
            tag = f"transducer train {name}"
            counts, losses, walls, trainer, state, batch, _ = run_train(dev, "auto", T_STEPS, PER_STEP_T[name], tag, model=model.train(),
                                                                        lr=T_LR[name], batch=batch)
            if not losses[-1] < losses[0]:
                raise AssertionError(f"{tag}: loss did not fall over {T_STEPS} steps: {losses}")
            _, busy = profile_step(trainer, state, batch, walls, tag, top=8)
            print(f"{tag}: loss {losses[0]:.4f} → {losses[-1]:.4f} over {T_STEPS} steps; median step {float(np.median(walls[1:])):.1f} ms, busy {busy:.1f}%")
            paths[f"t_train_{name}"] = counts
            del trainer, state
            paths[f"t_eval_{name}"] = transducer_eval(dev, f"transducer eval {name}", model.eval(), batch, PER_EVAL_T[name])
            del model
            torch.cuda.empty_cache()
        paths["t_stream_rnnt"] = rnnt_stream(dev, tmp)
    print(f"transducers phase: {time.perf_counter() - t0:.1f} s")
    return paths


def parity_request(cpu_model, dev, what: str, beam: bool = True, **beam_kwargs) -> str:
    """One request of 2 × ≤ 4 s through an f32 model on the card (kernels)
    and a CPU copy (plain versions): the encoder output within
    T_PARITY_ATOL of max(1, its scale), the lengths, greedy tokens and (with
    ``beam``) beam tokens at width BEAM equal. Returns the note."""
    from tensorflowasr_tpu_torch import schemas
    from tensorflowasr_tpu_torch.models.ctc import base as ctc_base
    from tensorflowasr_tpu_torch.models.transducer import base as transducer_base

    recognize = transducer_base.recognize if isinstance(cpu_model, transducer_base.Transducer) else ctc_base.recognize
    cpu_model = cpu_model.eval()
    model = copy.deepcopy(cpu_model).to(dev)
    audio, lens = make_request(np.random.default_rng(SEED + 1), 2, 4.0, 4.0, "cpu")
    lens[1] = 3 * 16000
    with torch.inference_mode():
        enc, enc_len, _ = model.encode(audio.to(dev), lens.to(dev))
        ref, ref_len, _ = cpu_model.encode(audio, lens)
    scale = max(1.0, ref.abs().max().item())
    err = _close(f"parity f32 {what} encoder", enc.cpu(), ref, T_PARITY_ATOL * scale, 0.0)
    if not torch.equal(enc_len.cpu(), ref_len):
        raise AssertionError(f"parity f32 {what}: encoder lengths differ")
    notes = [f"encoder output max_abs_err {err:.3e} (tol {T_PARITY_ATOL} x {scale:.3g})"]
    for kind, kw in (("greedy", {}), *((("beam", {"beam_width": BEAM, **beam_kwargs}),) if beam else ())):
        got = recognize(model, schemas.PredictInput(audio.to(dev), lens.to(dev)), **kw)
        want = recognize(cpu_model, schemas.PredictInput(audio, lens), **kw)
        if not torch.equal(got.tokens.cpu(), want.tokens):
            raise AssertionError(f"parity f32 {what}: {kind} tokens card {got.tokens.tolist()} vs CPU {want.tokens.tolist()}")
        notes.append(f"{kind} tokens equal ({int((want.tokens != 0).sum())} tokens)")
    return "; ".join(notes)


def phase_transducer_parity(dev) -> None:
    """Each transducer 2 deep (2 Transformer blocks, 2 RNN-T layers on the
    LSTM kernels, ContextNet's C0 and C1) at its published widths in f32,
    dropout 0: one request card vs CPU (:func:`parity_request`: encoder
    output, greedy and beam tokens) and one default (auto) training step's
    loss and every gradient (:func:`_step_parity`)."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="tfasr-transducers-") as tmp:
        for name in TRANSDUCERS:
            kwargs = {"rnn_impl": "pallas"} if name == "rnnt" else {}
            build = lambda: transducer_model(name, torch.float32, "cpu", tmp, depth=2, dropout=0.0, **kwargs)
            print(f"parity f32 request ({name}, 2 deep) card (kernels) vs CPU (plain), 2 x <= 4 s: {parity_request(build(), dev, name)}, TF32 off")
            _step_parity(dev, "auto", kwargs.get("rnn_impl", "auto"), cpu_model=build(), what=f"{name}, 2 deep, auto")


def beam_overfit(dev, model, tok, dataset, tag: str, lm=None) -> dict:
    """``evaluate_dataset`` of an overfit model over its utterances greedy and
    with beam search at width BEAM (and, with ``lm``, a CTC model's beam
    with the bigram LM fused at the default weight): WER 0 required greedy
    and under beam. Returns the launch counts of the beam evaluations."""
    from tensorflowasr_tpu_torch.training.evaluation import evaluate_dataset

    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    report = evaluate_dataset(model, dataset, tok, batch_size=len(OVERFIT_TEXTS), beam_width=BEAM, collect_rows=True, num_workers=0)
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    line = (f"beam overfit {tag} (evaluate_dataset over the {len(report['rows'])} overfit utterances, one batch, greedy then beam {BEAM} "
            f"in {seconds * 1e3:.1f} ms): greedy WER {report['greedy']['wer']:.4f} CER {report['greedy']['cer']:.4f}; beam WER {report['beam']['wer']:.4f} "
            f"CER {report['beam']['cer']:.4f}; beam rows {[r[3] for r in report['rows']]}")
    if report["greedy"]["wer"] != 0.0 or report["beam"]["wer"] != 0.0:
        raise AssertionError(f"{line}: WER 0 required greedy and under beam")
    if lm is not None:
        with_lm = evaluate_dataset(model, dataset, tok, batch_size=len(OVERFIT_TEXTS), beam_width=BEAM, lm=lm, collect_rows=True, num_workers=0)
        line += (f"; beam {BEAM} + bigram LM (NGramLM.from_text_corpus of the 4 transcripts, weight 0.5) WER {with_lm['beam']['wer']:.4f} CER "
                 f"{with_lm['beam']['cer']:.4f}, rows {[r[3] for r in with_lm['rows']]}")
    print(line + f"; launches {_launched(counts)}")
    return counts


def phase_beam(dev) -> dict:
    """Beam search at width BEAM beside greedy on the serving requests (3 of
    8 × 6–10 s, bf16) for the flagship and the RNN-T: walls, RTF, the port's
    kernel launches and the device operations of a request; and the f32 card
    vs CPU beam tokens of a 2-block flagship and a 2-block Conformer-CTC
    with a bigram LM (the transducers' 2-deep ones are in
    :func:`phase_transducer_parity`). Returns the beam requests' launch counts."""
    import tempfile

    from tensorflowasr_tpu_torch import schemas
    from tensorflowasr_tpu_torch.lm import NGramLM
    from tensorflowasr_tpu_torch.models.transducer.base import recognize

    paths = {}
    with tempfile.TemporaryDirectory(prefix="tfasr-beam-") as tmp:
        for name in ("flagship", "rnnt"):
            model = (flagship(torch.bfloat16, dev) if name == "flagship" else transducer_model(name, torch.bfloat16, dev, tmp)).eval()
            greedy_counts = PER_REQUEST if name == "flagship" else PER_REQUEST_T[name]
            beam_counts = {**greedy_counts, "fused_decode": 0}
            _, greedy = serve_transducer(dev, name, model, greedy_counts)
            paths[f"beam_serve_{name}"], beam = serve_transducer(dev, name, model, beam_counts, {"beam_width": BEAM})
            audio, lens = make_request(np.random.default_rng(SEED), 8, 6.0, 10.0, dev)
            ops = {kind: device_launches(lambda: recognize(model, schemas.PredictInput(audio, lens), **kw))
                   for kind, kw in (("greedy", {}), ("beam", {"beam_width": BEAM}))}
            audio_s = lens.sum().item() / 16000.0
            g, b = float(np.median(greedy)), float(np.median(beam))
            print(f"beam vs greedy ({name}, bf16, 8 x 6-10 s requests): median wall greedy {g * 1e3:.1f} ms, beam {BEAM} {b * 1e3:.1f} ms ({b / g:.1f}x); "
                  f"RTF of request 0 greedy {greedy[0] / audio_s:.6f}, beam {beam[0] / audio_s:.6f}; device operations per request greedy "
                  f"{ops['greedy'][0]} ({ops['greedy'][1]:.1f} ms of device time), beam {ops['beam'][0]} ({ops['beam'][1]:.1f} ms)")
            del model
        text = ["the cat sat", "a dog ran home", "blue sky", "we went out to sea"]
        cpu_model = flagship(torch.float32, "cpu", num_blocks=2, dropout=0.0)
        print(f"parity f32 request (flagship, 2 blocks) card (kernels) vs CPU (plain), 2 x <= 4 s: {parity_request(cpu_model, dev, 'flagship')}, TF32 off")
        ctc = ctc_model("conformer_ctc", torch.float32, "cpu", num_blocks=2, dropout=0.0)
        lm = NGramLM.from_token_corpus([[1 + (ord(c) % (ctc.vocab_size - 1)) for c in t] for t in text], ctc.vocab_size, order=2)
        print(f"parity f32 request (conformer_ctc, 2 blocks, beam {BEAM} with a bigram LM over V {ctc.vocab_size}) card vs CPU: "
              f"{parity_request(ctc, dev, 'conformer_ctc', lm=lm)}, TF32 off")
    return paths


# ----------------------------------------- recipes ----------------------------------------- #

RECIPE_MICRO = 16  # the flagship's micro-steps: 2 applied updates at its ga_steps 8
RECIPE_CALLBACK_STEPS = 8  # micro-steps timed per run with and without the callbacks
RECIPE_RESUME = 8  # micro-steps before and after the checkpoint
RECIPE_TIMED = 20  # SpecAugment calls timed


def noam_closed_form(schedule: dict, count: int) -> float:
    """A recipe's TransformerSchedule written out in float64: scale · d^-0.5 ·
    min(s^-0.5, s · warmup^-1.5) with s = max(count, 1), at most max_lr."""
    c = schedule["config"]
    s = max(count, 1)
    lr = c.get("scale", 1.0) * c["dmodel"] ** -0.5 * min(s ** -0.5, s * c["warmup_steps"] ** -1.5)
    if "max_lr" in c:
        lr = min(lr, float(eval(str(c["max_lr"]), {"__builtins__": {}})))  # noqa: S307 (the recipe's own numeric string)
    return lr


def recipe_model(device, dtype=torch.bfloat16, num_blocks: int = 16, dropout: float = TRAIN_RATE, seed: int = SEED) -> torch.nn.Module:
    """The flagship with the SpecAugment of its published recipe, random weights from ``seed``."""
    from tensorflowasr_tpu_torch.models.transducer.conformer import Conformer, conformer_small_config

    model = Conformer.from_config(conformer_small_config(num_blocks=num_blocks, dropout=dropout, augment=True), dtype=dtype, device=device)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model


def recipe_trainer(model, lc: dict, device, **kwargs):
    """A ``Trainer`` with a recipe's optimizer chain: schedule, ga_steps, gradient and weight noise as the learning_config says."""
    from tensorflowasr_tpu_torch.training.trainer import Trainer

    return Trainer(model, lc["optimizer_config"], device=device, ga_steps=lc["ga_steps"], gradn_config=lc["gradn_config"], gwn_config=lc["gwn_config"],
                   **kwargs)


def recipe_batches(seed: int, n: int, batch: int, vocab: int, dev) -> list:
    rng = np.random.default_rng(seed)
    return [train_batch(rng, batch, TRAIN_SECS, TRAIN_U, vocab).to(dev) for _ in range(n)]


def check_learning_rates(tag: str, updates: list, schedule: dict) -> None:
    """Each applied update's learning rate (as the chain set it) against the closed form, 1e-6 relative (f32 vs float64)."""
    for step, count, lr in updates:
        ref = noam_closed_form(schedule, count)
        if not abs(lr - ref) <= 1e-6 * ref:
            raise AssertionError(f"{tag}: update {count} (micro-step {step}) learning rate {lr!r} vs the closed form {ref!r}")
        print(f"{tag} update {count} (after micro-step {step}): learning rate {lr:.6e}, closed form {ref:.6e} (rel {abs(lr - ref) / ref:.1e}, tol 1e-6)")


def device_launches(fn) -> tuple[int, float]:
    """(CUDA device operations, their device ms) of one call of ``fn`` under
    the profiler, tracing the device only: a beam request's hundreds of
    thousands of host events would take the profiler longer than the request."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    return sum(e.count for e in events), sum(e.self_device_time_total for e in events) / 1e3


def per_tensor_global_norm(grads) -> torch.Tensor:
    """The earlier form of the trainer's global norm, the yardstick of the one-pass
    ``torch._foreach_norm``: a product, a sum and an add per gradient."""
    return torch.sqrt(sum((g.float() * g.float()).sum() for g in grads))


def recipe_flagship(dev, lc: dict, tmp: str) -> dict:
    """The flagship with its published recipe through ``Trainer.fit``:
    RECIPE_MICRO micro-steps at batch 4 (bench.py lengths, ≤ 16 s), the
    recipe's callbacks (TerminateOnNaN, ModelCheckpoint, TensorBoard into
    ``tmp``) and one epoch-end eval; launches counted over the run. Then the
    checkpoint's bytes and save and restore times, SpecAugment's time and
    launches, and the launches of a micro-step with the one-pass norm and
    with the per-tensor one. Returns the run's launch counts."""
    from tensorflowasr_tpu_torch.optimizers.optimizers import global_norm
    from tensorflowasr_tpu_torch.training import callbacks

    class UpdateLog(callbacks.Callback):
        """(micro-step, update count, learning rate) after each applied update."""

        def __init__(self):
            self.updates = []

        def on_train_batch_end(self, trainer, state, metrics):
            if state.optimizer.mini_step == 0:
                self.updates.append((state.step, state.optimizer.count - 1, state.optimizer.param_groups[0]["lr"]))

    tag = "recipe flagship"
    model = recipe_model(dev)
    log = UpdateLog()
    cbs = callbacks.deserialize(lc["callbacks"]) + [log]
    ckpt_dir = os.path.join(tmp, "checkpoints")
    trainer = recipe_trainer(model, lc, dev, checkpoint_dir=ckpt_dir, callbacks=cbs)
    state = trainer.init_state(seed=SEED)
    batches = recipe_batches(SEED + 40, RECIPE_MICRO + 1, lc["batch_size"], VOCAB, dev)
    eval_batch = batches.pop()
    audio = sum(b.inputs.inputs_length.sum().item() for b in batches) / 16000
    marks = []

    def data():
        for b in batches:
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            yield b
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    print(f"{tag}: {[type(c).__name__ for c in cbs]}; {RECIPE_MICRO} micro-steps of batch {lc['batch_size']} ({audio:.1f} s of audio, arrays of "
          f"{TRAIN_SECS} s), ga_steps {lc['ga_steps']}, SpecAugment {model.feature_extraction.augmentation.feature_augmentations and 'on'}, "
          f"optimizer {lc['optimizer_config']}")
    torch.cuda.synchronize()
    settle()
    reset_launch_counts()
    with RequestWatch() as watch:
        state = trainer.fit(state, data(), epochs=1, eval_data=[eval_batch], log_every=10 ** 9)
        torch.cuda.synchronize()
    counts = launch_counts()
    expected = {k: RECIPE_MICRO * PER_STEP[k] + PER_EVAL[k] for k in KERNELS}
    if counts != expected:
        raise AssertionError(f"{tag}: launches {counts}, expected {RECIPE_MICRO} x {PER_STEP} + {PER_EVAL}")
    if state.step != RECIPE_MICRO or state.optimizer.count != RECIPE_MICRO // lc["ga_steps"]:
        raise AssertionError(f"{tag}: step {state.step}, updates {state.optimizer.count}")
    check_learning_rates(tag, log.updates, lc["optimizer_config"]["config"]["learning_rate"])
    if [u[:2] for u in log.updates] != [(lc["ga_steps"] * (k + 1), k) for k in range(RECIPE_MICRO // lc["ga_steps"])]:
        raise AssertionError(f"{tag}: updates applied at {log.updates}")
    lines = [json.loads(line) for line in open(os.path.join(tmp, "tensorboard", "metrics.jsonl"))]
    epoch = lines[-1]
    if not (np.isfinite(epoch.get("epoch_loss", np.nan)) and np.isfinite(epoch.get("epoch_val_loss", np.nan))) or trainer.checkpoint_steps() != [RECIPE_MICRO]:
        raise AssertionError(f"{tag}: TensorBoard's last line {epoch}, checkpoints {trainer.checkpoint_steps()}")
    walls = np.diff(marks) * 1e3
    applied = [i for i in range(RECIPE_MICRO) if (i + 1) % lc["ga_steps"] == 0]
    plain = [walls[i] for i in range(1, RECIPE_MICRO) if i not in applied]
    print(f"{tag}: micro-step wall median {np.median(plain):.1f} ms (host clock, each ends in a synchronise; micro-steps 2-{RECIPE_MICRO} without an "
          f"update; first {walls[0]:.1f} ms with fit's gc.freeze), applied micro-steps {[round(float(walls[i]), 1) for i in applied]} ms: "
          f"the update adds {np.mean([walls[i] for i in applied]) - np.median(plain):.1f} ms; {watch}; loss {epoch['epoch_loss']:.4f}, "
          f"val_loss {epoch['epoch_val_loss']:.4f} (epoch-end eval, 1 batch); launches {_launched(counts)}")

    path = os.path.join(ckpt_dir, str(state.step), "state.pt")
    size = os.path.getsize(path)
    os.remove(path)
    os.rmdir(os.path.dirname(path))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.save(state)
    save_ms = (time.perf_counter() - t0) * 1e3
    fresh = recipe_trainer(recipe_model(dev, seed=SEED + 1), lc, dev, checkpoint_dir=ckpt_dir)
    restored = fresh.init_state(seed=SEED + 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fresh.restore(restored)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    want, got = model.state_dict(), restored.model.state_dict()
    if any(not torch.equal(want[k], got[k]) for k in want) or restored.step != state.step:
        raise AssertionError(f"{tag}: the restored module differs from the saved one")
    print(f"{tag} checkpoint: {size / 2**20:.1f} MiB (module with BatchNorm statistics, Adam moments, accumulation buffers, generators), "
          f"save {save_ms:.1f} ms, restore {restore_ms:.1f} ms (torch.load weights_only, into a fresh model on the card)")
    del fresh, restored

    aug = model.feature_extraction.augmentation
    b = batches[0]
    with torch.no_grad():
        feats, flens = model.feature_extraction(b.inputs.inputs, b.inputs.inputs_length)
    feats = feats.float()
    gen = torch.Generator().manual_seed(SEED)
    for _ in range(WARMUP):
        aug.feature_augment(feats, flens, gen)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(RECIPE_TIMED):
        aug.feature_augment(feats, flens, gen)
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / RECIPE_TIMED
    ops, ops_ms = device_launches(lambda: aug.feature_augment(feats, flens, gen))
    print(f"{tag} SpecAugment ({[type(m).__name__ for m in aug.feature_augmentations]}, features {tuple(feats.shape)} f32): "
          f"{start.elapsed_time(end) / RECIPE_TIMED:.4f} ms a call (CUDA events over {RECIPE_TIMED} calls; host {host_ms:.3f} ms a call), "
          f"{ops} device operations a micro-step ({ops_ms:.4f} ms of device time, profiler)")

    # one micro-step that accumulates, with the one-pass norm (shipped) and the per-tensor yardstick on its gradients
    step_ops, step_ms = device_launches(lambda: trainer.train_step(state, batches[1]))
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    new_ops, new_ms = device_launches(lambda: global_norm(grads))
    old_ops, old_ms = device_launches(lambda: per_tensor_global_norm(grads))
    new, old = global_norm(grads).item(), per_tensor_global_norm(grads).item()
    if not abs(new - old) <= 1e-5 * old:
        raise AssertionError(f"{tag}: one-pass norm {new} vs per-tensor {old}")
    print(f"{tag} launches per micro-step (profiler, device operations): {step_ops} with the one-pass norm ({new_ops} for the norm, "
          f"{new_ms:.3f} ms), {step_ops - new_ops + old_ops} with the per-tensor norm ({old_ops} for the norm over {len(grads)} gradients, "
          f"{old_ms:.3f} ms); norms {new:.6f} vs {old:.6f}; card time in the micro-step {step_ms:.1f} ms")

    # the optimizer chain's own time per micro-step over one accumulation cycle: accumulating, and the applied update
    chain, times = state.optimizer, []
    chain_step = chain.step

    def timed_step(grad_norm=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        applied = chain_step(grad_norm=grad_norm)
        torch.cuda.synchronize()
        times.append(((time.perf_counter() - t0) * 1e3, applied))
        return applied

    chain.step = timed_step
    try:
        for b in batches[:lc["ga_steps"]]:
            trainer.train_step(state, b)
    finally:
        del chain.step
    acc = [ms for ms, applied in times if not applied]
    upd = [ms for ms, applied in times if applied]
    print(f"{tag} optimizer chain (host clock between synchronises): accumulating {np.median(acc):.3f} ms a micro-step (median of {len(acc)}), "
          f"the applied update {upd[0]:.3f} ms (mean gradient, AdamW over {len(chain.params)} tensors, buffers zeroed): "
          f"{upd[0] - np.median(acc):.3f} ms more")
    return counts


def recipe_callback_cost(dev, lc: dict, tmp: str) -> None:
    """Micro-steps through ``fit`` with the recipe's callbacks and without,
    in turns (off, on, on, off): ms per micro-step over RECIPE_CALLBACK_STEPS
    (a synchronise at both ends only, so TerminateOnNaN's loss read is the
    one sync a step)."""
    from tensorflowasr_tpu_torch.training import callbacks

    model = recipe_model(dev)
    batches = recipe_batches(SEED + 41, RECIPE_CALLBACK_STEPS + 1, lc["batch_size"], VOCAB, dev)
    lc = {**lc, "callbacks": [c for c in lc["callbacks"] if not c["class_name"].endswith("ModelCheckpoint")]}
    res = {"on": [], "off": []}
    for mode in ("off", "on", "on", "off"):
        cbs = callbacks.deserialize(lc["callbacks"]) if mode == "on" else []
        trainer = recipe_trainer(model, lc, dev, callbacks=cbs)
        window = []

        def data():
            for i, b in enumerate(batches):
                if i == 1:
                    torch.cuda.synchronize()
                    window.append(time.perf_counter())
                yield b
            torch.cuda.synchronize()
            window.append(time.perf_counter())

        trainer.fit(trainer.init_state(seed=SEED), data(), log_every=10 ** 9)
        res[mode].append((window[1] - window[0]) * 1e3 / RECIPE_CALLBACK_STEPS)
    on, off = np.mean(res["on"]), np.mean(res["off"])
    print(f"recipe callbacks: ms per micro-step over {RECIPE_CALLBACK_STEPS} (off, on, on, off) {res['off'][0]:.1f}, {res['on'][0]:.1f}, "
          f"{res['on'][1]:.1f}, {res['off'][1]:.1f}: with {[c['class_name'].split('>')[-1] for c in lc['callbacks']]} {on:.1f}, without {off:.1f} "
          f"(TerminateOnNaN's loss read syncs once a step: {on - off:+.1f} ms)")


def _stateful_tensors(state) -> dict:
    """The module's tensors, Adam's moments and the accumulation buffers of a training state."""
    out = {f"module {k}": v for k, v in state.model.state_dict().items()}
    for i, s in enumerate(state.optimizer.base.state.values()):
        out.update({f"adam {i} {k}": v for k, v in s.items() if k != "step"})
    if state.optimizer.accumulated is not None:
        out.update({f"accumulated {i}": a for i, a in enumerate(state.optimizer.accumulated)})
    return out


def _max_diff(a: dict, b: dict) -> float:
    return max(float((a[k].float() - b[k].float()).abs().max()) for k in a)


def recipe_resume(dev, lc: dict, tmp: str) -> None:
    """RECIPE_RESUME micro-steps, save, RECIPE_RESUME more (straight run 1);
    a second straight run from the same start; a fresh Trainer over a model
    from another seed restores the checkpoint and runs the same
    RECIPE_RESUME. The resumed run is held to the difference the two
    straight runs show (to 2× it; bit-equal where they are)."""
    batches = recipe_batches(SEED + 42, 2 * RECIPE_RESUME, lc["batch_size"], VOCAB, dev)
    ckpt_dir = os.path.join(tmp, "resume")

    def run(trainer, state, part):
        return [trainer.train_step(state, b)[1]["loss"].item() for b in part]

    t1 = recipe_trainer(recipe_model(dev), lc, dev, checkpoint_dir=ckpt_dir)
    s1 = t1.init_state(seed=SEED)
    first = run(t1, s1, batches[:RECIPE_RESUME])
    t1.save(s1)
    second = run(t1, s1, batches[RECIPE_RESUME:])
    ref = _stateful_tensors(s1)
    del t1
    t2 = recipe_trainer(recipe_model(dev), lc, dev)
    s2 = t2.init_state(seed=SEED)
    straight = run(t2, s2, batches)
    straight_diff = _max_diff(ref, _stateful_tensors(s2))
    del t2, s2
    t3 = recipe_trainer(recipe_model(dev, seed=SEED + 7), lc, dev, checkpoint_dir=ckpt_dir)
    s3 = t3.restore(t3.init_state(seed=SEED + 7))
    resumed = run(t3, s3, batches[RECIPE_RESUME:])
    resumed_diff = _max_diff(ref, _stateful_tensors(s3))
    loss_straight = max(abs(a - b) for a, b in zip(first + second, straight))
    loss_resumed = max(abs(a - b) for a, b in zip(second, resumed))
    print(f"recipe resume: {RECIPE_RESUME} micro-steps, save, {RECIPE_RESUME} more (updates {s1.optimizer.count}); largest difference from run 1 "
          f"over the module, Adam's moments and the accumulation buffers: a second straight run {straight_diff:.3e}, the resumed run "
          f"{resumed_diff:.3e}; losses: straight {loss_straight:.3e}, resumed {loss_resumed:.3e} (run 1's last losses {[round(x, 4) for x in second]})")
    if straight_diff == 0.0 and loss_straight == 0.0:
        if resumed_diff != 0.0 or loss_resumed != 0.0:
            raise AssertionError("recipe resume: two straight runs are bit-equal, the resumed run is not")
    elif resumed_diff > 2 * straight_diff or loss_resumed > 2 * loss_straight:
        raise AssertionError(f"recipe resume: the resumed run differs by {resumed_diff} (losses {loss_resumed}), two straight runs by "
                             f"{straight_diff} ({loss_straight})")


def recipe_ctc(dev) -> dict:
    """Conformer-CTC Small and Transformer-CTC base, each with its published
    recipe (SpecAugment, its schedule, batch and ga_steps) for one applied
    update; launches checked per micro-step. Returns the launch counts of each."""
    from tensorflowasr_tpu_torch.models.ctc.conformer import conformer_ctc_small_learning_config
    from tensorflowasr_tpu_torch.models.ctc.transformer import transformer_ctc_base_learning_config

    paths = {}
    for name, learning in (("conformer_ctc", conformer_ctc_small_learning_config), ("transformer_ctc", transformer_ctc_base_learning_config)):
        tag = f"recipe {name}"
        lc = learning()
        model = ctc_model(name, torch.bfloat16, dev, augment=True)
        trainer = recipe_trainer(model, lc, dev)
        state = trainer.init_state(seed=SEED)
        batches = recipe_batches(SEED + 43, lc["ga_steps"], lc["batch_size"], model.vocab_size, dev)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        torch.cuda.synchronize()
        settle()
        reset_launch_counts()
        walls, losses = [], []
        for i, b in enumerate(batches):
            c0 = launch_counts()
            t0 = time.perf_counter()
            _, metrics = trainer.train_step(state, b)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            losses.append(metrics["loss"].item())
            delta = {k: v - c0[k] for k, v in launch_counts().items()}
            if delta != PER_STEP_CTC[name] or not np.isfinite(losses[-1]):
                raise AssertionError(f"{tag} micro-step {i}: launches {delta} (expected {PER_STEP_CTC[name]}), loss {losses[-1]}")
        paths[f"recipe_{name}"] = launch_counts()
        if state.optimizer.count != 1 or not any(not torch.equal(v, before[k]) for k, v in model.state_dict().items()):
            raise AssertionError(f"{tag}: {state.optimizer.count} updates, or no parameter moved")
        check_learning_rates(tag, [(state.step, 0, state.optimizer.param_groups[0]["lr"])], lc["optimizer_config"]["config"]["learning_rate"])
        print(f"{tag}: {lc['ga_steps']} micro-steps of batch {lc['batch_size']} (one update): walls {[round(w, 1) for w in walls]} ms, "
              f"losses {[round(x, 3) for x in losses]}")
        del trainer, state, model
    return paths


def recipe_parity(dev) -> None:
    """The whole chain in f32, card (kernels) vs CPU (plain versions): a
    2-block flagship, batch 2 × ≤ 4 s, dropout 0, 4 micro-steps at ga_steps
    2 of AdamW under a TransformerSchedule with a short warm-up, clipped at
    1, SpecAugment from the CPU stream on both sides (the same masks),
    weight noise and gradient noise drawn on the CPU and handed to both.
    The step-parity tolerances: each micro-step's loss to 1e-4 relative
    and each of its gradients (as the chain receives them) to
    TRAIN_PARITY_REL of its scale plus TRAIN_PARITY_FLOOR of the largest;
    the running statistics to TRAIN_PARITY_REL of their scale. Each
    parameter's change is held to TRAIN_PARITY_REL of its tensor's change
    plus TRAIN_PARITY_FLOOR of the largest, except where Adam divides
    nearly cancelled moments and so magnifies the gradients' f32
    differences: those elements (under 1% of all) are held to Adam's own
    bound, 2 · updates · the largest learning rate (as
    ``tests/test_torch_train_slice.py`` holds noise-level weights)."""
    tag = "parity f32 recipe"
    # max_lr 1e-4: the noise-led first update moves every weight by about the learning rate, and at the flagship recipe's
    # 4.2e-3 cap (8% of a typical weight) the next micro-step's gradients sat 1.1x the step-parity bound from the CPU's
    opt = {"class_name": "Adam", "config": {"learning_rate": {"class_name": "TransformerSchedule", "config": {"dmodel": 144, "warmup_steps": 2,
                                                                                                              "max_lr": "1e-4"}},
                                            "beta_2": 0.98, "epsilon": 1e-9, "weight_decay": 1e-6}}
    lc = {"optimizer_config": opt, "ga_steps": 2, "gradn_config": {"eta": 1e-4}, "gwn_config": {"stddev": 0.01, "step": 1, "modules": ["encoder", "prediction"]}}
    cpu_model = recipe_model("cpu", torch.float32, num_blocks=2, dropout=0.0)
    card_model = copy.deepcopy(cpu_model).to(dev)
    start = {k: v.clone() for k, v in cpu_model.state_dict().items()}
    batch = train_batch(np.random.default_rng(SEED + 44), 2, 4.0, 32, cpu_model.vocab_size)
    runs = []
    for model, device in ((card_model, dev), (cpu_model, torch.device("cpu"))):
        trainer = recipe_trainer(model, lc, device, clip_norm=1.0)
        state = trainer.init_state(seed=SEED)
        named = trainer.weight_noise.named
        trainer.weight_noise.draw = lambda generator, st=state, named=named: [
            (0.01 * torch.randn(p.shape, generator=torch.Generator().manual_seed(1000 + st.step))).to(p.device) for _, p in named]
        chain, grads = state.optimizer, []
        chain.gradient_noise.draw = lambda gs, noise=chain.gradient_noise: [
            torch.randn(g.shape, generator=torch.Generator().manual_seed(2000 + noise.count)).to(g.device) for g in gs]

        def recording_step(grad_norm=None, chain_step=chain.step, model=model, grads=grads):
            grads.append({n: p.grad.detach().cpu().clone() for n, p in model.named_parameters() if p.grad is not None})
            return chain_step(grad_norm=grad_norm)

        chain.step = recording_step
        metrics = [trainer.train_step(state, batch.to(device))[1] for _ in range(4)]
        lr_max = max(chain.learning_rate(c) for c in range(chain.count))
        runs.append(([m["loss"].item() for m in metrics], grads, {k: v.detach().cpu() for k, v in model.state_dict().items()}, chain.count, lr_max))
    (card_l, card_g, card_sd, card_n, lr_max), (cpu_l, cpu_g, cpu_sd, cpu_n, _) = runs
    if card_n != 2 or cpu_n != 2:
        raise AssertionError(f"{tag}: updates card {card_n}, CPU {cpu_n}")
    worst = (0.0, "")
    for k, (lg, lc_, gg, gc_) in enumerate(zip(card_l, cpu_l, card_g, cpu_g)):
        if not abs(lg - lc_) <= 1e-4 * abs(lc_):
            raise AssertionError(f"{tag} micro-step {k}: loss card {lg} vs CPU {lc_}")
        gmax = max(g.abs().max().item() for g in gc_.values())
        for name, ref in gc_.items():
            err, allowed = (gg[name] - ref).abs().max().item(), TRAIN_PARITY_REL * ref.abs().max().item() + TRAIN_PARITY_FLOOR * gmax
            if err > allowed:
                raise AssertionError(f"{tag} micro-step {k} gradient {name}: max abs err {err} > {allowed}")
            worst = max(worst, (err / allowed, f"{name} at micro-step {k}"))
    params = {n for n, _ in cpu_model.named_parameters()}
    dmax = max((cpu_sd[n] - start[n]).abs().max().item() for n in params)
    sensitive = total = 0
    for name, ref in cpu_sd.items():
        err = (card_sd[name] - ref).abs()
        if name not in params:
            if err.max().item() > TRAIN_PARITY_REL * ref.abs().max().item():
                raise AssertionError(f"{tag} {name}: card vs CPU max abs err {err.max().item()} > {TRAIN_PARITY_REL} x {ref.abs().max().item()}")
            continue
        change = ref - start[name]
        over = err > TRAIN_PARITY_REL * change.abs().max().item() + TRAIN_PARITY_FLOOR * dmax
        if err.max().item() > 2 * card_n * lr_max:
            raise AssertionError(f"{tag} {name}: card vs CPU max abs err {err.max().item()} > Adam's bound 2 x {card_n} x {lr_max}")
        sensitive += int(over.sum())
        total += ref.numel()
    if sensitive >= 0.01 * total:
        raise AssertionError(f"{tag}: {sensitive} of {total} parameter elements outside {TRAIN_PARITY_REL} of their tensor's change")
    print(f"{tag} card (kernels) vs CPU (plain): 2 blocks, batch 2 x <= 4 s, 4 micro-steps, 2 updates (schedule, AdamW, clip 1, SpecAugment, "
          f"weight and gradient noise); losses card {[round(x, 5) for x in card_l]} vs CPU {[round(x, 5) for x in cpu_l]} (tol 1e-4 rel); every "
          f"micro-step's gradients within {TRAIN_PARITY_REL} of their scale + {TRAIN_PARITY_FLOOR} of the largest (largest share {worst[0]:.3f}, "
          f"{worst[1]}); running statistics within {TRAIN_PARITY_REL}; parameter changes within {TRAIN_PARITY_REL} of their tensor's change + "
          f"{TRAIN_PARITY_FLOOR} x {dmax:.3e} but {sensitive} of {total} elements ({100 * sensitive / total:.3f}%, held to Adam's bound "
          f"2 x {card_n} x {lr_max:.3e}), TF32 off")


def recipe_nan_stop(dev, lc: dict) -> None:
    """A NaN batch stops ``fit`` through TerminateOnNaN after that batch."""
    from tensorflowasr_tpu_torch.training import callbacks

    stop = callbacks.TerminateOnNaN()
    trainer = recipe_trainer(recipe_model(dev, num_blocks=2), lc, dev, callbacks=[stop])
    good = train_batch(np.random.default_rng(SEED + 45), 2, 4.0, 32, VOCAB).to(dev)
    bad = copy.deepcopy(good)
    bad.inputs.inputs.fill_(float("nan"))
    state = trainer.fit(trainer.init_state(seed=SEED), [good, bad, good, good], epochs=2, log_every=10 ** 9)
    if state.step != 2 or not stop.stop_training:
        raise AssertionError(f"recipe NaN stop: fit ran {state.step} micro-steps (stop_training {stop.stop_training}), expected to stop after 2")
    print(f"recipe NaN stop: fit over [finite, NaN, finite, finite] x 2 epochs stopped after micro-step {state.step} (TerminateOnNaN)")


def phase_recipe(dev) -> dict:
    """The published recipes on the card (``recipe_*`` above), in a temporary
    directory for the checkpoints and TensorBoard. Returns the launch
    counts of the flagship's and the CTC models' recipe runs."""
    import tempfile

    from tensorflowasr_tpu_torch.models.transducer.conformer import conformer_small_learning_config

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="tfasr-recipe-") as tmp:
        lc = conformer_small_learning_config(modeldir=tmp)
        paths = {"recipe": recipe_flagship(dev, lc, tmp)}
        recipe_callback_cost(dev, lc, tmp)
        recipe_resume(dev, lc, tmp)
        recipe_nan_stop(dev, lc)
    paths.update(recipe_ctc(dev))
    recipe_parity(dev)
    print(f"recipe phase: {time.perf_counter() - t0:.1f} s")
    return paths


# ----------------------------- the data path ------------------------------ #

CHAR_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples", "datasets", "librispeech", "characters", "char.yml.j2")
DATA_LAYOUT = (("train-clean-100", 16), ("train-clean-360", 8), ("train-other-500", 8), ("dev-clean", 8), ("dev-other", 8))
DATA_SECS = (5.1, 16.0)  # bench.py:149-157's lognormal around 12 s, clipped to these
DATA_B, DATA_EVAL_B, DATA_CHARS_PER_S = 16, 8, 12.0
DATA_FLAC_EVERY = 6  # every 6th utterance is written as FLAC, the rest as WAV
DATA_SENTENCES = (
    "he hoped there would be stew for dinner turnips and carrots and bruised potatoes and fat mutton pieces",
    "stuff it into you his belly counselled him",
    "after early nightfall the yellow lamps would light up here and there the squalid quarter of the brothels",
    "hello bertie any good in your mind",
    "number ten fresh nelly is waiting on you good night husband",
    "the music came nearer and he recalled the words the words of shelley's fragment upon the moon wandering companionless",
    "we are not saying that it's wrong only that it takes a long time to learn the way the river runs",
    "she wore a blue dress and carried a small basket of apples down to the old mill by the water",
    "in the morning the fog lifted and the ships came slowly into the harbour one after another",
    "it was the best of times it was the worst of times it was the age of wisdom",
)
OVERFIT_TEXTS = ("the cat sat", "a dog ran home", "blue sky", "we went out to sea")
OVERFIT_ROUND, OVERFIT_STEP_CAP, OVERFIT_TIME_CAP, OVERFIT_LR = 25, 400, 60.0, 2e-3


def data_transcript(rng, secs: float, chars_per_s: float = DATA_CHARS_PER_S) -> str:
    """Words from the sentence pool, about ``chars_per_s`` characters a second (read speech)."""
    target, words = max(int(chars_per_s * secs), 3), []
    while len(" ".join(words)) < target:
        words += DATA_SENTENCES[rng.integers(len(DATA_SENTENCES))].split()
    text = words[0]
    for w in words[1:]:
        if len(text) + 1 + len(w) > target:
            break
        text += " " + w
    return text


def data_audio(rng, n: int, text: str) -> np.ndarray:
    """Audio that carries its transcript, as speech does: each character a
    segment of equal length under a Hann window, voiced with two tones of its
    own (a formant-like pair picked by the character) over a random pitch; a
    space is a pause; noise throughout."""
    t = np.arange(n) / 16000
    f0, bounds = rng.uniform(90, 250), np.linspace(0, n, len(text) + 1).astype(int)
    x = np.zeros(n)
    for ch, a, b in zip(text, bounds[:-1], bounds[1:]):
        if ch != " " and b > a:
            k, seg = ord(ch) % 32, t[a:b]
            x[a:b] = np.hanning(b - a) * (np.sin(2 * np.pi * (300 + 45 * k) * seg) + 0.6 * np.sin(2 * np.pi * (1200 + 110 * k) * seg)
                                          + 0.3 * np.sin(2 * np.pi * f0 * seg))
    return np.clip(0.12 * x + 0.02 * rng.standard_normal(n), -0.45, 0.45).astype(np.float32)


def write_manifest(path: str, rows: list) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        f.write("PATH\tDURATION\tTRANSCRIPT\n" + "".join(f"{p}\t{d}\t{t}\n" for p, d, t in rows))


def data_corpus(root: str) -> dict:
    """The corpus under ``root`` at the manifest paths ``char.yml.j2`` names
    with ``datadir=root``: 32 training and 16 evaluation utterances of
    5.1–16 s, every ``DATA_FLAC_EVERY``-th as FLAC, the rest as WAV.
    Returns the audio seconds and the paths by format."""
    from tensorflowasr_tpu_torch.data import audio

    rng = np.random.default_rng(SEED + 14)
    out, k = {"wav": [], "flac": [], "secs": {"train": 0.0, "eval": 0.0}}, 0
    for split, n in DATA_LAYOUT:
        rows = []
        for _ in range(n):
            secs = float(np.clip(rng.lognormal(mean=np.log(12.0), sigma=0.35), *DATA_SECS))
            fmt = "flac" if k % DATA_FLAC_EVERY == DATA_FLAC_EVERY - 1 else "wav"
            path = os.path.join(root, split, f"utt{k:03d}.{fmt}")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            text = data_transcript(rng, secs)
            (audio.write_flac if fmt == "flac" else audio.write_wav)(path, data_audio(rng, int(secs * 16000), text), 16000)
            rows.append((path, audio.audio_duration(path), text))
            out[fmt].append(path)
            out["secs"]["train" if split.startswith("train") else "eval"] += rows[-1][1]
            k += 1
        write_manifest(os.path.join(root, split, "transcripts.tsv"), rows)
    return out


def data_config(root: str):
    """``char.yml.j2`` loaded through the port's ``Config`` with ``datadir`` at
    the temporary corpus (its metadata path inside the repository is only
    read, and holds nothing: metadata is computed in memory)."""
    from tensorflowasr_tpu_torch import pipeline

    config = pipeline.load_config(CHAR_CONFIG, datadir=root)
    if config.data_config.train_dataset_config.data_paths[0] != os.path.join(root, "train-clean-100", "transcripts.tsv"):
        raise AssertionError(f"char.yml.j2 names {config.data_config.train_dataset_config.data_paths}, not the corpus under {root}")
    return config


def data_model(config, tok, dev, family: str = "transducer", dtype=torch.bfloat16, **kw) -> torch.nn.Module:
    """A model of the char config's vocabulary built through ``build_model`` from
    its config dict (the flagship, or Conformer-CTC Small), random weights from the seed."""
    from tensorflowasr_tpu_torch import pipeline
    from tensorflowasr_tpu_torch.models.ctc.conformer import conformer_ctc_small_config
    from tensorflowasr_tpu_torch.models.transducer.conformer import conformer_small_config

    if family == "transducer":
        config.model_config = {"class_name": "tensorflow_asr.models.transducer.conformer>Conformer", "config": conformer_small_config(vocab_size=29, **kw)}
    else:
        config.model_config = {"class_name": "tensorflow_asr.models.ctc.conformer>Conformer", "config": conformer_ctc_small_config(vocab_size=29, **kw)}
    model = pipeline.build_model_from_config(config, tok, mxp="strict" if dtype == torch.bfloat16 else "none", device=dev)
    model.reset_parameters(torch.Generator().manual_seed(SEED))
    return model


def loss_record(tag: str):
    """A ``fit`` callback keeping each step's loss (read on the host) and wall since the previous batch's end."""
    from tensorflowasr_tpu_torch.training import callbacks

    class LossRecord(callbacks.Callback):
        def __init__(self):
            self.losses, self.walls, self._t = [], [], None

        def on_train_begin(self, trainer):
            self._t = time.perf_counter()

        def on_epoch_begin(self, trainer, epoch):
            self._t = time.perf_counter()

        def on_train_batch_end(self, trainer, state, metrics):
            self.losses.append(metrics["loss"].item())
            now = time.perf_counter()
            self.walls.append((now - self._t) * 1e3)
            self._t = now

        def on_epoch_end(self, trainer, state, epoch, logs):
            print(f"{tag} epoch {epoch}: " + ", ".join(f"{k} {v:.4f}" for k, v in logs.items()))

    return LossRecord()


def host_decode_ms(corpus: dict) -> None:
    """Host ms to decode one utterance: the longest WAV, and the longest FLAC
    through the native decoder and the pure-Python one."""
    from tensorflowasr_tpu_torch.data import audio

    def ms(fn, path, reps):
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn(path)
            walls.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(walls))

    wav, flac = (max(corpus[f], key=audio.audio_duration) for f in ("wav", "flac"))
    print(f"data decode (host, one utterance, median): WAV {audio.audio_duration(wav):.2f} s {ms(audio.read_wav, wav, 5):.2f} ms; FLAC "
          f"{audio.audio_duration(flac):.2f} s native {ms(audio.read_flac, flac, 5):.2f} ms, Python {ms(audio.read_flac_python, flac, 1):.1f} ms")


def create_ms(dataset, shapes: dict) -> None:
    """Host ms per batch of ``create`` (16 utterances decoded, tokenized,
    padded and pinned), after its first batch, at num_workers 0 and 4."""
    for workers in (0, 4):
        it = dataset.create(DATA_B, shapes["padded_input_length"], shapes["padded_label_length"], num_workers=workers, pin_memory=True)
        next(it)
        t0 = time.perf_counter()
        for _ in range(3):
            next(it)
        print(f"data create: {(time.perf_counter() - t0) * 1e3 / 3:.1f} ms per batch of {DATA_B} at num_workers {workers} (host, 3 batches after the first)")
        it.close()


def fed_vs_fixed(trainer, state, dataset, shapes: dict, steps: int = 4) -> None:
    """Step walls fed from the dataset (``next`` on ``create`` inside the
    wall) against the same number of steps on one fixed batch already on
    the card: whether the card waits on input."""
    it = dataset.create(DATA_B, shapes["padded_input_length"], shapes["padded_label_length"], num_workers=4, pin_memory=True)
    fixed = next(it).to(trainer.device)
    walls = {"fed": [], "fixed": []}
    torch.cuda.synchronize()
    settle()
    for kind in ("fed", "fixed"):
        for _ in range(steps):
            t0 = time.perf_counter()
            state, _ = trainer.train_step(state, next(it) if kind == "fed" else fixed)
            torch.cuda.synchronize()
            walls[kind].append((time.perf_counter() - t0) * 1e3)
    it.close()
    print("data step wall (host clock, ends in a synchronise): fed from create " + ", ".join(f"{w:.1f}" for w in walls["fed"])
          + f" ms (median {np.median(walls['fed']):.1f}); fixed batch on the card " + ", ".join(f"{w:.1f}" for w in walls["fixed"])
          + f" ms (median {np.median(walls['fixed']):.1f})")


def phase_data_train(dev, config, tok, corpus: dict, tmp: str):
    """The flagship (V 29, bf16, ``auto``) trained by ``Trainer.fit`` for 2
    epochs × 2 steps of batch 16 fed by ``create`` (padded to the metadata,
    4 decode workers, pinned), the training set as ``eval_data``; the
    first step's loss against ``train_step`` on the same batch from the same
    start, bit for bit. Returns (counts, model, datasets, shapes, the first data-fed batch)."""
    import random

    from tensorflowasr_tpu_torch import pipeline
    from tensorflowasr_tpu_torch.data import datasets
    from tensorflowasr_tpu_torch.training.trainer import Trainer

    random.seed(SEED)  # the config shuffles the training and evaluation entries
    data = pipeline.build_datasets(config, tok)
    train, train_eval = data["train"], pipeline.build_datasets(config, tok, stages=("train",))["train"]
    meta = train.compute_metadata()
    train_eval.compute_metadata()
    train_eval.indefinite = False
    shapes = datasets.get_global_shape(config, train, batch_size=DATA_B)
    print(f"data corpus: {meta['num_entries']} training utterances ({corpus['secs']['train']:.1f} s), {sum(n for s, n in DATA_LAYOUT if s.startswith('dev'))} evaluation "
          f"({corpus['secs']['eval']:.1f} s), {len(corpus['flac'])} FLAC / {len(corpus['wav'])} WAV; metadata {meta}; padded shapes {shapes}; "
          f"tokenizer {type(tok).__name__} V {tok.num_classes}")
    host_decode_ms(corpus)
    create_ms(train, shapes)

    adam = {"class_name": "Adam", "config": {"learning_rate": 1e-4}}
    model = data_model(config, tok, dev, dropout=TRAIN_RATE)
    record = loss_record("data train")
    trainer = Trainer(model, adam, device=dev, loss_impl="auto", checkpoint_dir=os.path.join(tmp, "checkpoints"), keep_checkpoints=1,
                      callbacks=[record])
    state = trainer.init_state(seed=SEED)
    eval_batches = list(train_eval.create(DATA_B, shapes["padded_input_length"], shapes["padded_label_length"], prefetch=0, pin_memory=True))
    first = []

    def feed():
        for batch in train.create(DATA_B, shapes["padded_input_length"], shapes["padded_label_length"], num_workers=4, pin_memory=True):
            if not first:
                first.append(batch)
            yield batch

    batches = feed()
    torch.cuda.synchronize()
    settle()
    reset_launch_counts()
    t0 = time.perf_counter()
    state = trainer.fit(state, batches, epochs=2, steps_per_epoch=2, eval_data=eval_batches)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = launch_counts()
    batches.close()
    want = {k: 4 * PER_STEP[k] + len(eval_batches) * 2 * PER_EVAL_SCALAR[k] for k in KERNELS}
    if counts != want:
        raise AssertionError(f"data train launches {_launched(counts)}, expected {_launched(want)}")
    if not all(np.isfinite(record.losses)) or len(record.losses) != 4 or trainer.checkpoint_steps() != [4]:
        raise AssertionError(f"data train: losses {record.losses}, checkpoints {trainer.checkpoint_steps()}")
    print(f"data train (flagship, fit 2 epochs x 2 steps of {DATA_B}, {len(eval_batches)} eval batches an epoch): {fit_s:.2f} s; step walls "
          + ", ".join(f"{w:.1f}" for w in record.walls) + " ms (host, from the previous batch's end, the first includes the epoch start); losses "
          + ", ".join(f"{x:.4f}" for x in record.losses) + f"; launches {_launched(counts)}")

    replay = Trainer(data_model(config, tok, dev, dropout=TRAIN_RATE), adam, device=dev, loss_impl="auto")
    _, metrics = replay.train_step(replay.init_state(seed=SEED), first[0])
    if metrics["loss"].item() != record.losses[0]:
        raise AssertionError(f"data train: the first data-fed loss {record.losses[0]!r} differs from train_step on its batch {metrics['loss'].item()!r}")
    print(f"data train: first data-fed step's loss {record.losses[0]!r} equals train_step on the same collated batch from the same start, bit for bit")
    del replay
    fed_vs_fixed(trainer, state, train, shapes)
    return counts, model, data, shapes, first[0]


def data_train_kernels(dev, model, batch) -> dict:
    """Rows 8 and 10a at the shapes the data-fed training gives them (the
    char vocabulary, V 29, and labels padded to the metadata): the fused
    joint forward and backward on the trained flagship's prejoint outputs
    of the first data-fed batch ([16, T, U+1] cells, J 320 → V 29), and the
    log-probability row kernel on the eval logits [16, T, U+1, 29] of the
    same batch, whose rows of 58 (bf16) or 116 (f32) bytes take its
    one-element form (route "scalar", a ``__global__`` of its own). Each
    against its plain version in f32 (the same inputs upcast) and bf16 with
    the check phase's tolerances; times and bounds in bf16. Returns the
    joint's two results by row name and the scalar form's kernel row."""
    from tensorflowasr_tpu_torch.ops.cuda import joint_loss_kernel as jk
    from tensorflowasr_tpu_torch.ops.cuda import rnnt_kernel as rk
    from tensorflowasr_tpu_torch.ops.rnnt_loss import logits_to_logprobs_plain, sanitize_lengths

    batch = batch.to(dev)
    labels = batch.labels.labels
    with torch.no_grad():
        enc_p, pred_p, elens = model.forward_joint_inputs(batch.inputs)
        logits = model(batch.inputs).logits
    _, t_len, u_len = sanitize_lengths(elens, batch.labels.labels_length, enc_p.shape[1])
    wv, bv = model.joint.vocab.weight.detach(), model.joint.vocab.bias.detach().float()
    b, t, u1, v = enc_p.shape[0], enc_p.shape[1], pred_p.shape[1], wv.shape[0]
    shape = f"data train, [{b}, {t}, {u1}] cells, J {enc_p.shape[2]}, V {v}"
    active = {}

    def joint_make(dt):
        fargs = (enc_p.to(dt).contiguous(), pred_p.to(dt).contiguous(), wv.to(dt).contiguous(), bv, labels)
        _, lse, gbl, gem = jk.rnnt_loss_fused_joint_plain(*fargs[:4], t_len, labels, u_len)
        active["cells"] = int(((gbl != 0) | (gem != 0)).sum())
        return fargs, (*fargs, lse, gbl / b, gem / b)  # the masked mean's cotangent

    joint = _check_fwd_bwd("rnnt_fused_joint", _stacked(jk.joint_logprobs_kernel), _stacked(jk.joint_logprobs_plain), jk.rnnt_loss_fused_joint_bwd_kernel,
                           jk.rnnt_loss_fused_joint_plain_bwd, joint_make,
                           lambda elt, bwd: cost_joint(b, t, u1, enc_p.shape[2], v, elt, bwd, active["cells"]), what=shape)
    out = {row["name"]: {k: row[k] for k in ("max_abs_err", "max_abs_err_bf16", "ms", "plain_ms", "bound_ms", "bound_by")} | {"shape": shape}
           for row in joint}

    errs = {}
    for tag, dt in DTYPES:
        x = logits.to(dt).contiguous()
        plan, before = rk.logprobs_plan(v, x.element_size(), x.data_ptr() % 16 == 0), rk.logprobs_scalar_launches
        got = torch.stack(rk.logits_to_logprobs_kernel(x, labels))
        if plan.route != "scalar" or rk.logprobs_scalar_launches != before + 1:
            raise AssertionError(f"rnnt_logprobs_scalar {tag} (V {v}): route {plan.route!r}, {rk.logprobs_scalar_launches - before} scalar launches")
        errs[tag] = _close(f"rnnt_logprobs_scalar {tag} ({shape})", got, torch.stack(logits_to_logprobs_plain(x, labels)), *ROWS_TOL[tag])
    ms, plain_ms = time_ms(_stacked(rk.logits_to_logprobs_kernel), x, labels), time_ms(_stacked(logits_to_logprobs_plain), x, labels)
    lse_ms = time_ms(torch.logsumexp, x, -1)  # the library yardstick, as row 10a's tiled form has it: one output of three, same logits
    bd = bound(*cost_rows(b * t * u1, v, b, u1 - 1, x.element_size(), False), "f32")
    print(f"kernel rnnt_logprobs_scalar (data train's eval step, logits [{b}, {t}, {u1}, {v}], rows of {v * 2} / {v * 4} bytes: the one-element "
          f"form): max_abs_err f32 {errs['f32']:.3e} bf16 {errs['bf16']:.3e} (tol {ROWS_TOL}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
          f"bound {bd[0]:.4f} ms ({bd[1]}) bf16, with the stack of its three outputs; library torch.logsumexp (one output of three, same "
          f"logits) {lse_ms:.4f} ms")
    out["rnnt_logprobs_scalar"] = _row("rnnt_logprobs_scalar", errs, ms, plain_ms, bd) | {"shape": shape, "library_ms": lse_ms}
    return out


def data_decode_kernel(dev, model, ds, what: str) -> dict:
    """Row 13 in bf16 at V 29 on the encoding of ``ds``'s first batch of
    ``DATA_EVAL_B`` (as ``evaluate_dataset`` pads it) by ``model``: the
    kernel against its plain version on the raw encoding and on the
    sharpened one, as :func:`phase_decode_kernel` holds them
    (:func:`decode_bf16_agreement`); times and bound. Returns the results."""
    from tensorflowasr_tpu_torch.ops.cuda import decode_kernel as dk

    batches = ds.labelled_batches(DATA_EVAL_B, num_workers=0)
    batch, _ = next(batches)
    batches.close()
    with torch.inference_mode():
        enc, enc_len, _ = model.encode(batch.inputs.inputs.to(dev), batch.inputs.inputs_length.to(dev))
        b, params = enc.shape[0], model.decode_params()
        start, states = torch.zeros(b, dtype=torch.int64, device=dev), model.init_decoder_states(b, dev)
        kernel = lambda x: dk.fused_greedy_decode_kernel(x, enc_len, params, start, states, window=DECODE_WINDOW)
        plain = lambda x, **kw: dk.fused_greedy_decode_plain(x, enc_len, params, start, states, window=DECODE_WINDOW, **kw)
        sharp = enc.float() * 3.0
        sharp[..., 0] += 2.0
        sharp = sharp.to(enc.dtype)
        got = kernel(enc)
        note = "; ".join(decode_bf16_agreement(params, start, states, x, kernel(x), plain(x, gaps=True), name)
                         for name, x in (("sharpened", sharp), ("raw", enc)))
        ref = plain(enc)
        state_err = max((x - y).abs().max().item() for g, r in zip(got[3], ref[3]) for x, y in zip(g, r))
        ms, plain_ms = time_ms(kernel, enc), wall_ms(lambda: plain(enc))
    v = params.wv.shape[0]
    t_np, u_np = enc_len.cpu().numpy(), got[1].cpu().numpy()
    bd = bound(*cost_decode(t_np, u_np, enc.shape[1], 320, 320, 320, v, 2), "bf16")
    print(f"kernel fused_decode bf16 ({what}, B {b} T {enc.shape[1]} (T_b {t_np.min()}-{t_np.max()}), V {v}): tokens per row {u_np.min()}-{u_np.max()}; "
          f"{note}; states max_abs_err {state_err:.3e}; kernel {ms:.4f} ms plain {plain_ms:.1f} ms bound {bd[0]:.4f} ms ({bd[1]})")
    return dict(max_abs_err_bf16=state_err, ms=ms, plain_ms=plain_ms, bound_ms=bd[0], bound_by=bd[1], tokens=[int(u_np.min()), int(u_np.max())],
                shape=f"{what}, B {b} T {enc.shape[1]} V {v}")


def data_error_rates(report: dict, tok, dev, tag: str = "data eval") -> None:
    """WER and CER three ways: the accumulator's, ``metrics.wer``/``cer`` from
    the rows, and ``wer_on_device`` over the char ids and over word ids."""
    from tensorflowasr_tpu_torch.ops.edit_distance import wer_on_device
    from tensorflowasr_tpu_torch.training import metrics

    truths, hyps = [r[1] for r in report["rows"]], [r[2] for r in report["rows"]]
    words = {w: i + 1 for i, w in enumerate(sorted({w for t in truths + hyps for w in t.split()}))}

    def on_device(seqs_ref, seqs_hyp):
        def pad(seqs):
            out = np.zeros((len(seqs), max(1, max(len(s) for s in seqs))), np.int64)
            for i, s in enumerate(seqs):
                out[i, : len(s)] = s
            return torch.tensor(out, device=dev), torch.tensor([len(s) for s in seqs], device=dev)

        num, den = wer_on_device(*pad(seqs_ref), *pad(seqs_hyp))
        return int(num) / int(den)

    ways = {
        "wer": (report["greedy"]["wer"], metrics.wer(truths, hyps), on_device([[words[w] for w in t.split()] for t in truths],
                                                                             [[words[w] for w in h.split()] for h in hyps])),
        "cer": (report["greedy"]["cer"], metrics.cer(truths, hyps), on_device([list(tok.tokenize(t)) for t in truths], [list(tok.tokenize(h)) for h in hyps])),
    }
    for name, (acc, rows, device) in ways.items():
        if not acc == rows == device:
            raise AssertionError(f"{tag} {name}: accumulator {acc!r}, from the rows {rows!r}, wer_on_device {device!r}")
    print(f"{tag}: WER {ways['wer'][0]!r} and CER {ways['cer'][0]!r} agree three ways (accumulator, metrics.wer/cer from the rows, "
          f"wer_on_device over word and char ids on the card; {sum(len(r[2]) for r in report['rows'])} hypothesis characters)")


def phase_data_eval(dev, model, config, tok, data: dict, corpus: dict, tmp: str) -> dict:
    """``evaluate_dataset`` of the trained flagship over the evaluation
    manifests (WAV and FLAC files) and over a TFRecord copy, batch 8:
    equal reports, WER and CER three ways, utterances per second, RTF and
    one fused decode a batch. Returns the two paths' counts."""
    from tensorflowasr_tpu_torch import pipeline
    from tensorflowasr_tpu_torch.training.evaluation import evaluate_dataset

    evals, paths = {}, {}
    tfr = pipeline.build_datasets(config, tok, dataset_type="tfrecord", stages=("eval",))["eval"]
    t0 = time.perf_counter()
    tfr.create_tfrecords()
    print(f"data eval: TFRecord copy of the evaluation set in {tfr.tfrecords_shards} GZIP shards under the temporary datadir "
          f"({time.perf_counter() - t0:.2f} s to write)")
    for name, ds in (("data_eval", data["eval"]), ("data_eval_tfrecord", tfr)):
        ds.compute_metadata()
        torch.cuda.synchronize()
        settle()
        reset_launch_counts()
        t0 = time.perf_counter()
        report = evaluate_dataset(model, ds, tok, batch_size=DATA_EVAL_B, collect_rows=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        paths[name] = counts = launch_counts()
        n = len(report["rows"])
        batches = -(-n // DATA_EVAL_B)
        if counts["fused_decode"] != batches or counts["log_mel_spectrogram"] != batches:
            raise AssertionError(f"{name}: launches {_launched(counts)}, expected one frontend and one fused decode a batch ({batches})")
        print(f"{name}: {n} utterances in {batches} batches of {DATA_EVAL_B}: {wall:.2f} s, {n / wall:.1f} utterances/s, RTF {wall / corpus['secs']['eval']:.4f} "
              f"(host clock over decode, batching and recognize); WER {report['greedy']['wer']:.4f} CER {report['greedy']['cer']:.4f}; "
              f"launches {_launched(counts)}")
        evals[name] = report
    wav, rec = evals["data_eval"], evals["data_eval_tfrecord"]
    if sorted(wav["rows"]) != sorted(rec["rows"]) or wav["greedy"] != rec["greedy"]:
        raise AssertionError(f"data eval: the WAV and TFRecord reports differ: {wav['greedy']} vs {rec['greedy']}")
    print(f"data eval: the audio-file and TFRecord reports are equal ({len(wav['rows'])} rows by path, WER and CER); "
          f"first row {wav['rows'][0][1][:40]!r} -> {wav['rows'][0][2][:40]!r}")
    data_error_rates(wav, tok, dev)
    return paths


def phase_data_ctc(dev, config, tok, data: dict, shapes: dict) -> dict:
    """Conformer-CTC Small (D 176, V 29, bf16) through the same path: ``fit``
    1 epoch × 2 steps fed by ``create``, then ``evaluate_dataset``."""
    from tensorflowasr_tpu_torch.training.evaluation import evaluate_dataset
    from tensorflowasr_tpu_torch.training.trainer import Trainer

    model = data_model(config, tok, dev, family="ctc", dropout=TRAIN_RATE)
    record = loss_record("data ctc")
    trainer = Trainer(model, {"class_name": "Adam", "config": {"learning_rate": 1e-4}}, device=dev, loss_impl="auto", callbacks=[record])
    state = trainer.init_state(seed=SEED)
    batches = data["train"].create(DATA_B, shapes["padded_input_length"], shapes["padded_label_length"], num_workers=4, pin_memory=True)
    torch.cuda.synchronize()
    settle()
    reset_launch_counts()
    t0 = time.perf_counter()
    trainer.fit(state, batches, epochs=1, steps_per_epoch=2)
    report = evaluate_dataset(model, data["eval"], tok, batch_size=DATA_EVAL_B, collect_rows=True)
    torch.cuda.synchronize()
    counts = launch_counts()
    batches.close()
    if counts["ctc_loss"] != 2 or counts["fused_decode"] != 0 or not all(np.isfinite(record.losses)):
        raise AssertionError(f"data ctc: launches {_launched(counts)}, losses {record.losses}")
    print(f"data ctc (Conformer-CTC Small, fit 1 epoch x 2 steps of {DATA_B}, then evaluate_dataset): {time.perf_counter() - t0:.2f} s; losses "
          + ", ".join(f"{x:.4f}" for x in record.losses) + f"; WER {report['greedy']['wer']:.4f} CER {report['greedy']['cer']:.4f}; "
          f"launches {_launched(counts)}")
    data_error_rates(report, tok, dev, "data ctc")
    return counts


def overfit_corpus(root: str, signal=data_audio):
    """Four utterances of 1–3 s with the short ``OVERFIT_TEXTS``, WAV and FLAC,
    their audio made by ``signal(rng, samples, text)``."""
    from tensorflowasr_tpu_torch.data import audio

    rng = np.random.default_rng(SEED + 15)
    rows = []
    for i, text in enumerate(OVERFIT_TEXTS):
        secs = 1.0 + 2.0 * i / (len(OVERFIT_TEXTS) - 1)
        path = os.path.join(root, f"overfit{i}.{'flac' if i % 2 else 'wav'}")
        os.makedirs(root, exist_ok=True)
        (audio.write_flac if i % 2 else audio.write_wav)(path, signal(rng, int(secs * 16000), text), 16000)
        rows.append((path, audio.audio_duration(path), text))
    write_manifest(os.path.join(root, "transcripts.tsv"), rows)
    return os.path.join(root, "transcripts.tsv")


class OverfitCapReached(AssertionError):
    """The overfit reached its step or time cap short of WER 0; ``steps`` and ``report`` (the last evaluation's) say where it stood."""

    def __init__(self, msg: str, steps: int, report: dict):
        super().__init__(msg)
        self.steps, self.report = steps, report


def run_overfit(dev, tok, manifest: str, dtype=torch.bfloat16, lr: float = OVERFIT_LR, time_cap: float = OVERFIT_TIME_CAP, model=None,
                step_cap: int = OVERFIT_STEP_CAP) -> tuple:
    """``model`` (default a 2-block Conformer-T at the flagship's widths,
    dropout 0) trained by ``fit`` in rounds of ``OVERFIT_ROUND`` steps over
    the four utterances (one batch) until ``evaluate_dataset`` reads WER 0;
    raises :class:`OverfitCapReached` at ``step_cap`` steps or ``time_cap``
    s. Returns (steps, seconds, report, model)."""
    import gc as gc_

    from tensorflowasr_tpu_torch.data import datasets
    from tensorflowasr_tpu_torch.models.transducer.conformer import Conformer, conformer_small_config
    from tensorflowasr_tpu_torch.models import build_model
    from tensorflowasr_tpu_torch.training.evaluation import evaluate_dataset
    from tensorflowasr_tpu_torch.training.trainer import Trainer

    if model is None:
        model = build_model({"class_name": "Conformer", "config": conformer_small_config(vocab_size=29, num_blocks=2, dropout=0.0)}, vocab_size=29,
                            dtype=dtype, device=dev)
        if type(model) is not Conformer:
            raise AssertionError(f"build_model gave a {type(model).__name__} for the name Conformer")
        model.reset_parameters(torch.Generator().manual_seed(SEED))
    train, test = (datasets.ASRSliceDataset(tok, stage=stage, data_paths=[manifest]) for stage in ("train", "test"))
    train.compute_metadata()
    test.compute_metadata()
    trainer = Trainer(model, {"class_name": "Adam", "config": {"learning_rate": lr}}, device=dev)
    state = trainer.init_state(seed=SEED)
    batches = train.create(len(OVERFIT_TEXTS), num_workers=0, pin_memory=dev.type == "cuda")
    t0 = time.perf_counter()
    try:
        while True:
            state = trainer.fit(state, batches, epochs=1, steps_per_epoch=OVERFIT_ROUND)
            report = evaluate_dataset(model, test, tok, batch_size=len(OVERFIT_TEXTS), collect_rows=True, num_workers=0)
            seconds = time.perf_counter() - t0
            if report["greedy"]["wer"] == 0.0:
                return state.step, seconds, report, model
            if state.step >= step_cap or seconds > time_cap:
                raise OverfitCapReached(f"overfit: WER {report['greedy']['wer']} after {state.step} steps and {seconds:.1f} s: {report['rows']}",
                                        state.step, report)
    finally:
        batches.close()
        gc_.unfreeze()
        gc_.freeze()


def phase_data_overfit(dev, tok, tmp: str) -> tuple:
    """The overfit on the card; returns its counts, the trained model and its manifest."""
    manifest = overfit_corpus(os.path.join(tmp, "overfit"))
    torch.cuda.synchronize()
    settle()
    reset_launch_counts()
    steps, seconds, report, model = run_overfit(dev, tok, manifest)
    counts = launch_counts()
    if counts["fused_decode"] == 0 or counts["rnnt_fused_joint"] != steps:
        raise AssertionError(f"overfit: launches {_launched(counts)} over {steps} steps")
    print(f"data overfit (2-block Conformer-T at the flagship's widths, bf16, dropout 0, Adam {OVERFIT_LR:g}, 4 utterances of 1-3 s, one batch): WER 0 after "
          f"{steps} steps in {seconds:.1f} s (fit in rounds of {OVERFIT_ROUND}, evaluate_dataset after each; caps {OVERFIT_STEP_CAP} steps, "
          f"{OVERFIT_TIME_CAP:.0f} s); rows {[r[2] for r in report['rows']]}; launches {_launched(counts)}")
    return counts, model, manifest


def phase_data_parity(dev, overfit_model, tok, data: dict, overfit) -> None:
    """``evaluate_dataset`` of the overfit 2-block Conformer-T's weights in f32
    (TF32 off) over its four utterances and the evaluation set, greedy and
    with beam search at width BEAM, on the card (kernels) and on a CPU copy
    (plain versions): the same hypotheses for every utterance, and WER and
    CER three ways on both reports."""
    from tensorflowasr_tpu_torch.models import build_model
    from tensorflowasr_tpu_torch.models.transducer.conformer import conformer_small_config
    from tensorflowasr_tpu_torch.training.evaluation import evaluate_dataset

    cpu_model = build_model({"class_name": "Conformer", "config": conformer_small_config(vocab_size=29, num_blocks=2, dropout=0.0)}, vocab_size=29,
                            device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in overfit_model.state_dict().items()})
    model = copy.deepcopy(cpu_model).to(dev)
    for name, ds in (("overfit utterances", overfit), ("evaluation set", data["eval"])):
        ds.compute_metadata()
        reports = [evaluate_dataset(m, ds, tok, batch_size=DATA_EVAL_B, beam_width=BEAM, collect_rows=True) for m in (model, cpu_model)]
        gpu, cpu = (sorted(r["rows"]) for r in reports)
        differ = [g[0] for g, c in zip(gpu, cpu) if g != c]
        if differ or len(gpu) != len(cpu) or len(gpu) != ds.num_entries or any(reports[0][k] != reports[1][k] for k in ("greedy", "beam")):
            raise AssertionError(f"parity f32 eval ({name}): hypotheses differ between card and CPU for {differ} ({len(gpu)} and {len(cpu)} rows)")
        chars = sum(len(r[2]) for r in gpu)
        if chars == 0:
            raise AssertionError(f"parity f32 eval ({name}): every hypothesis is empty, nothing was compared")
        print(f"parity f32 eval (the overfit 2-block Conformer-T's weights in f32, evaluate_dataset over {len(gpu)} utterances, the {name}): card (kernels) and "
              f"CPU (plain) hypotheses, greedy and beam {BEAM}, equal for every utterance ({chars} characters greedy, {sum(len(r[3]) for r in gpu)} beam); "
              f"WER {reports[0]['greedy']['wer']:.4f} CER {reports[0]['greedy']['cer']:.4f}, beam WER {reports[0]['beam']['wer']:.4f} CER "
              f"{reports[0]['beam']['cer']:.4f}, TF32 off")
        data_error_rates(reports[0], tok, dev, f"parity f32 eval ({name})")


def phase_data(dev) -> tuple[dict, dict]:
    """The data path on the card (``phase_data_*`` above), in a temporary
    directory that holds the corpus, the TFRecords and the checkpoints, and
    the kernels it runs at V 29 against their plain versions on its own
    inputs (:func:`data_train_kernels`, :func:`data_decode_kernel`).
    Returns the launch counts of the data-fed training, the two
    evaluations, the CTC run and the overfit, and those checks' results by
    kernel row (the scalar form of row 10a as a kernel row of its own)."""
    import tempfile

    from tensorflowasr_tpu_torch import pipeline
    from tensorflowasr_tpu_torch.data import datasets

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="tfasr-data-") as tmp:
        corpus = data_corpus(tmp)
        config = data_config(tmp)
        tok = pipeline.build_tokenizer(config)
        print(f"data config: {CHAR_CONFIG} with datadir {tmp} through Config (PyYAML and Jinja2); corpus written in {time.perf_counter() - t0:.2f} s")
        counts, model, data, shapes, first = phase_data_train(dev, config, tok, corpus, tmp)
        paths = {"data_train": counts}
        checks = data_train_kernels(dev, model, first)
        paths.update(phase_data_eval(dev, model, config, tok, data, corpus, tmp))
        checks["fused_decode"] = data_decode_kernel(dev, model, data["eval"], "data eval's first batch, the data-trained flagship")
        del model
        paths["data_ctc"] = phase_data_ctc(dev, config, tok, data, shapes)
        paths["data_overfit"], overfit_model, manifest = phase_data_overfit(dev, tok, tmp)
        overfit = datasets.ASRSliceDataset(tok, stage="test", data_paths=[manifest], indefinite=False, drop_remainder=False)
        overfit.compute_metadata()
        checks["fused_decode_overfit"] = data_decode_kernel(dev, overfit_model, overfit, "the overfit utterances, the overfit model")
        phase_data_parity(dev, overfit_model, tok, data, overfit)
        paths["beam_overfit_conformer_t"] = beam_overfit(dev, overfit_model.eval(), tok, overfit, "conformer_t (2 blocks)")
    print(f"data phase: {time.perf_counter() - t0:.1f} s")
    return paths, checks


# ------------------------------ the command line ------------------------------ #

CLI_TRAIN_SPLITS, CLI_EVAL_SPLITS, CLI_TEST_SPLITS = ("train-clean-100",), ("dev-clean",), ("dev-other",)  # 16, 8 and 8 of the corpus's utterances
CLI_BS, CLI_STEPS, CLI_TEST_BS, CLI_BEAM, CLI_SHARDS = 4, 3, 8, 4, 4
CLI_BLOCKS = 4  # the Conformers' depth here (published widths): the CLI's flagship, the bf16 flagship and the streaming transducer
CLI_NSAMPLES, CLI_REQUESTS = 16000, 5  # the export's 1 s signature (scripts/export.py); requests timed per program
# the programs held against eager recognize in a fresh process: name -> (compute dtype, streaming signature)
CLI_PROGRAMS = {"cli_flagship_f32": (torch.float32, False), "flagship_bf16": (torch.bfloat16, False), "streaming_f32": (torch.float32, True),
                "transformer_ctc_f32": (torch.float32, False), "rnnt_bf16": (torch.bfloat16, False)}
CLI_STREAM_CHUNKS = 4
# the plain versions the serving operators fall back to on the CPU (ops/cuda/library.py): none may run on the card
CLI_PLAIN = (("frontend_kernel", "log_mel_spectrogram_plain"), ("attention_kernel", "fused_rel_attention_plain"), ("attention_kernel", "fused_attention_plain"),
             ("ff_kernel", "fused_ff_plain"), ("conv_kernel", "conv_front_plain"), ("conv_kernel", "conv_back_plain"), ("lstm_kernel", "lstm_fwd_plain"),
             ("decode_kernel", "fused_greedy_decode_plain"))


def cli_config(root: str) -> str:
    """``root/cli.yml.j2``: the flagship at its published widths, cut to
    CLI_BLOCKS blocks, with the example's SpecAugment, the char tokenizer
    (V 29) and the data phase's corpus under ``{{datadir}}`` (train
    train-clean-100's 16, eval dev-clean's 8, test dev-other's 8
    utterances; metadata under ``{{modeldir}}``; TFRecords in CLI_SHARDS
    shards), and the example's learning_config at batch CLI_BS with
    ``ga_steps`` 1 (each of the CLI_STEPS steps applies an update)."""
    from tensorflowasr_tpu_torch.models.transducer.conformer import conformer_small_config, conformer_small_learning_config

    def dataset(stage: str, splits: tuple, **kw) -> dict:
        return {"enabled": True, "stage": stage, "data_paths": [f"{{{{datadir}}}}/{s}/transcripts.tsv" for s in splits], "metadata": "{{modeldir}}/metadata.json",
                "tfrecords_dir": "{{datadir}}/tfrecords", "tfrecords_shards": CLI_SHARDS, **kw}

    lc = {**conformer_small_learning_config("{{modeldir}}"), "batch_size": CLI_BS, "ga_steps": 1}
    cfg = {"decoder_config": {"type": "characters", "blank_index": 0, "beam_width": 0},
           "model_config": {"class_name": "tensorflow_asr.models.transducer.conformer>Conformer", "config": conformer_small_config(vocab_size=29, num_blocks=CLI_BLOCKS, augment=True)},
           "data_config": {"train_dataset_config": dataset("train", CLI_TRAIN_SPLITS, shuffle=True), "eval_dataset_config": dataset("eval", CLI_EVAL_SPLITS),
                           "test_dataset_configs": [dataset("test", CLI_TEST_SPLITS, name="dev-other", drop_remainder=False, indefinite=False)]},
           "learning_config": lc}
    path = os.path.join(root, "cli.yml.j2")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(cfg, f, indent=1)  # JSON is YAML; Jinja fills {{datadir}} and {{modeldir}}
    return path


def cli_program_model(name: str, dev, root: str):
    """(model, tokenizer or None, example inputs) of program ``name``, random
    weights from SEED but for the CLI's flagship, whose weights are those
    ``save`` wrote after ``train``; the Conformers CLI_BLOCKS deep."""
    from tensorflowasr_tpu_torch import pipeline
    from tensorflowasr_tpu_torch.models.transducer.conformer import Conformer, conformer_small_config, conformer_small_streaming_config

    dtype, streaming = CLI_PROGRAMS[name]
    tok = None
    if name == "cli_flagship_f32":
        config = pipeline.load_config(os.path.join(root, "cli.yml.j2"), training=False, datadir=root, modeldir=os.path.join(root, "model"))
        tok = pipeline.build_tokenizer(config)
        model = pipeline.build_model_from_config(config, tok, mxp="none", device=dev)
        model.load_state_dict(torch.load(os.path.join(root, "model", "final.pt"), map_location=dev, weights_only=True))
    elif name == "flagship_bf16":
        config = pipeline.load_config(os.path.join(root, "cli.yml.j2"), training=False, datadir=root, modeldir=os.path.join(root, "model"))
        tok = pipeline.build_tokenizer(config)
        model = Conformer.from_config(conformer_small_config(vocab_size=tok.num_classes, num_blocks=CLI_BLOCKS), dtype=dtype, device=dev)
        model.reset_parameters(torch.Generator().manual_seed(SEED))
    elif name == "streaming_f32":
        model = Conformer.from_config(conformer_small_streaming_config(num_blocks=CLI_BLOCKS, memory_length=STREAM_MEMORY), dtype=dtype, device=dev)
        model.reset_parameters(torch.Generator().manual_seed(SEED))
    elif name == "transformer_ctc_f32":
        model = ctc_model("transformer_ctc", dtype, dev)
    else:
        model = transducer_model("rnnt", dtype, dev, os.path.join(root, "model"))
    model.eval()
    if streaming:
        size, _ = model.feature_extraction.config.get_signal_chunk_size_and_step(STREAM_FRAMES)
        example = (torch.zeros((1, size), device=dev), torch.full((1,), size, dtype=torch.int32, device=dev), torch.zeros((1,), dtype=torch.int64, device=dev),
                   model.init_encoder_states(1, dev), model.init_decoder_states(1, dev))
    else:
        example = (torch.zeros((1, CLI_NSAMPLES), device=dev), torch.full((1,), CLI_NSAMPLES, dtype=torch.int32, device=dev))
    return model, tok, example


def cli_run(tag: str, argv: list, walls: dict) -> str:
    """``python -m tensorflowasr_tpu_torch argv`` from the checkout's root, its wall in ``walls[tag]``; raises unless it exits 0."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "tensorflowasr_tpu_torch", *argv], cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                          text=True, timeout=600)
    walls[tag] = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"cli {tag}: exit {proc.returncode}\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return proc.stderr


def phase_cli(dev) -> dict:
    """The command line and the inference programs: on the data phase's
    corpus with ``cli.yml.j2`` (:func:`cli_config`), each subcommand as its
    own process (``python -m tensorflowasr_tpu_torch``): ``utils
    create_datasets_metadata`` and ``create_tfrecords``, ``train`` for
    CLI_STEPS steps (bf16), ``test`` (greedy and beam CLI_BEAM, the TSV and
    its WER/CER), ``save``, ``export`` (f32, bs 1); then ``export.py``
    directly for the flagship at bf16 and the small-streaming transducer
    with its carried states (CLI_BLOCKS deep), Transformer-CTC base and
    RNN-T small; then every
    ``.pt2`` loaded in a fresh process (:func:`cli_child`) and held against
    eager ``recognize`` on the same weights. Returns the programs' launch
    counts (the counted call of each)."""
    import tempfile

    from tensorflowasr_tpu_torch import export

    t0 = time.perf_counter()
    walls, sizes = {}, {}
    with tempfile.TemporaryDirectory(prefix="tfasr-cli-") as root:
        data_corpus(root)
        config, mdir, programs = cli_config(root), os.path.join(root, "model"), os.path.join(root, "programs")
        os.makedirs(programs)
        common = ["--config-path", config, "--datadir", root, "--modeldir", mdir]
        cli_run("utils create_datasets_metadata", ["utils", "create_datasets_metadata", *common], walls)
        cli_run("utils create_tfrecords", ["utils", "create_tfrecords", *common, "--dataset-type", "tfrecord"], walls)
        shards = sorted(os.listdir(os.path.join(root, "tfrecords")))
        if len(shards) != 3 * CLI_SHARDS:
            raise AssertionError(f"cli create_tfrecords: shards {shards}, expected {CLI_SHARDS} for each of train, eval and test")
        cli_run("train", ["train", *common, "--bs", str(CLI_BS), "--epochs", "1", "--steps-per-epoch", str(CLI_STEPS), "--mxp", "strict"], walls)
        if os.listdir(os.path.join(mdir, "checkpoints")) != [str(CLI_STEPS)]:
            raise AssertionError(f"cli train: checkpoints {os.listdir(os.path.join(mdir, 'checkpoints'))}, expected step {CLI_STEPS}")
        tsv = os.path.join(mdir, "test.tsv")
        log = cli_run("test", ["test", *common, "--bs", str(CLI_TEST_BS), "--beam-width", str(CLI_BEAM), "--output", tsv], walls)
        rows = [line.split("\t") for line in open(tsv, encoding="utf-8").read().splitlines()]
        if rows[0] != ["PATH", "GROUNDTRUTH", "GREEDY", "BEAMSEARCH"] or len(rows) != 1 + 8 or any(len(r) != 4 for r in rows):
            raise AssertionError(f"cli test: the TSV has {len(rows)} lines, expected a header and 8 rows of 4 columns")
        report = [line.split("tensorflowasr_tpu_torch: ")[-1] for line in log.splitlines() if ": {'wer'" in line]
        cli_run("save", ["save", *common, "--output", os.path.join(mdir, "final.pt")], walls)
        cli_run("export", ["export", *common, "--output", os.path.join(programs, "cli_flagship_f32.pt2")], walls)
        for name in list(CLI_PROGRAMS)[1:]:
            model, tok, example = cli_program_model(name, dev, root)
            t1 = time.perf_counter()
            export.export_program(export.make_inference_fn(model, tok), example, os.path.join(programs, f"{name}.pt2"))
            walls[f"export.py {name}"] = time.perf_counter() - t1
            del model
        torch.cuda.empty_cache()
        for name in CLI_PROGRAMS:
            sizes[name] = os.path.getsize(os.path.join(programs, f"{name}.pt2"))
        print("cli walls (s, each subcommand its own process): " + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()))
        print(f"cli test (dev-other, 8 utterances, bs {CLI_TEST_BS}, beam {CLI_BEAM}; weights after {CLI_STEPS} steps): " + " | ".join(report))
        t1 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--cli-child", root], capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise AssertionError(f"cli child: exit {proc.returncode}\n{proc.stdout[-3000:]}\n{proc.stderr[-4000:]}")
        child = json.loads(proc.stdout.strip().splitlines()[-1])["cli_child"]
        print(f"cli child (a fresh process: build the models, load the programs, eager against loaded): {time.perf_counter() - t1:.1f} s")
    for name, r in child["programs"].items():
        (eager_ops, eager_dev), (program_ops, program_dev) = r["device"]["eager"], r["device"]["program"]
        print(f"cli program {name}: {sizes[name]} bytes; wall per request eager {r['eager_ms']:.2f} ms, loaded program {r['program_ms']:.2f} ms; "
              f"device operations a call (profiler) eager {eager_ops} in {eager_dev:.2f} ms, program {program_ops} in {program_dev:.2f} ms; "
              f"tokens {r['tokens']}; launches per call eager {_launched(r['eager_launches'])}, program {_launched(r['program_launches'])} (equal); "
              f"plain versions run: 0")
    print(f"cli phase: {time.perf_counter() - t0:.1f} s")
    return {"cli": child["launches"]}


def _count_plain_calls(calls: dict) -> None:
    """Wraps each plain version of CLI_PLAIN so that a call adds one to ``calls``."""
    import importlib

    for mod_name, fn_name in CLI_PLAIN:
        mod = importlib.import_module(f"tensorflowasr_tpu_torch.ops.cuda.{mod_name}")
        fn = getattr(mod, fn_name)

        def counted(*args, _fn=fn, _name=fn_name, **kwargs):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*args, **kwargs)

        setattr(mod, fn_name, counted)


def _requests(name: str, model, example, dev) -> list:
    """The inputs of CLI_REQUESTS requests (1 s of random audio each), or of CLI_STREAM_CHUNKS chunks of one stream."""
    rng = np.random.default_rng(SEED + 31)
    if not CLI_PROGRAMS[name][1]:
        return [(torch.tensor((rng.standard_normal(tuple(example[0].shape)) * 0.1).astype(np.float32), device=dev), example[1]) for _ in range(CLI_REQUESTS)]
    chunks, _, _ = stream_chunks(model, SEED + 31, dev)
    return [(c, example[1]) for c in chunks[:CLI_STREAM_CHUNKS]]


def cli_child(dev, root: str) -> dict:
    """In a fresh process: each program of :func:`phase_cli` loaded with
    ``export.load_program`` and its model rebuilt (:func:`cli_program_model`);
    per request (a stream's chunks in order, each carrying the previous
    outputs' tokens and states) the program's tokens against eager
    ``recognize``'s: equal at f32, and at bf16 equal or differing only where
    the plain decode's top-two logit gap is within DECODE_GAP of the logit
    scale; the kernel launches of one call equal, no plain version run;
    walls per request (after a warm-up pass, each request synchronised)."""
    from tensorflowasr_tpu_torch import export, schemas
    from tensorflowasr_tpu_torch.models.ctc import base as ctc_base
    from tensorflowasr_tpu_torch.models.transducer import base as transducer_base
    from tensorflowasr_tpu_torch.ops.cuda import decode_kernel as dk

    plain_calls: dict = {}
    _count_plain_calls(plain_calls)
    out, total = {}, _per()
    for name, (dtype, streaming) in CLI_PROGRAMS.items():
        model, _, example = cli_program_model(name, dev, root)
        program = export.load_program(os.path.join(root, "programs", f"{name}.pt2"))
        is_transducer = isinstance(model, transducer_base.Transducer)
        recognize = transducer_base.recognize if is_transducer else ctc_base.recognize
        requests = _requests(name, model, example, dev)

        def run_all(call):
            carry, outs = tuple(example[2:]), []
            for sig, n in requests:
                res = call(sig, n, *carry)
                outs.append(res)
                if streaming:
                    carry = (res.next_tokens, res.next_encoder_states, res.next_decoder_states)
            torch.cuda.synchronize()
            return outs

        eager = lambda sig, n, *carry: recognize(model, schemas.PredictInput(sig, n, *carry))
        reset_launch_counts()
        eager(*requests[0], *example[2:])
        eager_counts = launch_counts()
        reset_launch_counts()
        program(*requests[0], *example[2:])
        program_counts = launch_counts()
        if program_counts != eager_counts or not any(program_counts.values()):
            raise AssertionError(f"cli program {name}: launches per call {_launched(program_counts)}, eager recognize {_launched(eager_counts)}")
        total = {k: total[k] + program_counts[k] for k in KERNELS}
        device = {tag: device_launches(lambda: call(*requests[0], *example[2:])) for tag, call in (("eager", eager), ("program", program))}
        walls = {}
        for tag, call in (("eager", eager), ("program", program)):
            outs = run_all(call)
            t0 = time.perf_counter()
            run_all(call)
            walls[tag] = (time.perf_counter() - t0) / len(requests) * 1e3
            walls[f"{tag}_outs"] = outs
        notes = []
        for i, (e, p) in enumerate(zip(walls["eager_outs"], walls["program_outs"])):
            if torch.equal(e.tokens, p.tokens):
                continue
            if dtype != torch.bfloat16 or not is_transducer:
                raise AssertionError(f"cli program {name}: request {i} tokens differ from eager recognize's")
            sig, n = requests[i]
            enc, enc_len, _ = model.encode(sig, n)
            params = model.decode_params()
            start, states = torch.zeros((1,), dtype=torch.int64, device=dev), model.init_decoder_states(1, dev)
            ref = dk.fused_greedy_decode_plain(enc, enc_len, params, start, states, gaps=True)
            got = (p.tokens, (p.tokens != model.blank).sum(dim=1))
            notes.append(decode_bf16_agreement(params, start, states, enc, got, ref, f"{name} request {i}"))
        out[name] = {"eager_ms": walls["eager"], "program_ms": walls["program"], "eager_launches": eager_counts, "program_launches": program_counts,
                     "device": device,
                     "tokens": "; ".join(notes) if notes else f"equal on all {len(requests)} {'chunks' if streaming else 'requests'}"}
        del model, program
        torch.cuda.empty_cache()
    if plain_calls:
        raise AssertionError(f"cli: plain versions ran on the card: {plain_calls}")
    return {"programs": out, "launches": total}


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
    res["flagship_auto_port_kernels"] = {}
    res["flagship_auto_kernel_ms"], res["flagship_auto_busy_pct"] = profile_step(trainer, state, batch, walls, "steps train", top=5,
                                                                                by_kernel=res["flagship_auto_port_kernels"])
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


FIT_STEPS = 30


def fit_gc_child(dev) -> dict:
    """In a fresh process (``--fit-gc``), whose objects the smoke never froze:
    the flagship through the port's own ``Trainer.fit`` (bf16, dropout 0.1,
    Adam 1e-4, the training batch) for FIT_STEPS steps, as shipped (fit
    freezes the collector's survivors after step 1), then FIT_STEPS more
    with that freeze undone (``gc.unfreeze()`` when batch 2 is drawn): the
    gen-2 collections and their ms inside steps 2..FIT_STEPS of each, and
    the step walls (host clock between batch draws, each after a
    synchronise)."""
    from tensorflowasr_tpu_torch.training.trainer import Trainer

    model = flagship(torch.bfloat16, dev, dropout=TRAIN_RATE)
    batch = train_batch(np.random.default_rng(SEED + 2), TRAIN_B, TRAIN_SECS, TRAIN_U, model.vocab_size).to(dev)
    res = {}
    for undo in (False, True):
        trainer = Trainer(model, {"class_name": "Adam", "config": {"learning_rate": 1e-4}}, device=dev)
        marks, gen2, t_gc = [], [], [None]

        def watch(phase, info):
            if phase == "start":
                t_gc[0] = time.perf_counter()
            elif info.get("generation") == 2 and t_gc[0] is not None:
                gen2.append((len(marks), (time.perf_counter() - t_gc[0]) * 1e3))

        def data():
            for i in range(FIT_STEPS):
                torch.cuda.synchronize()
                marks.append(time.perf_counter())
                if undo and i == 1:
                    gc.unfreeze()
                yield batch

        gc.callbacks.append(watch)
        try:
            trainer.fit(trainer.init_state(seed=SEED), data(), log_every=10 ** 9)
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
        finally:
            gc.callbacks.remove(watch)
        walls = np.diff(marks) * 1e3
        inside = [ms for step, ms in gen2 if step >= 2]  # step k runs after the k-th batch is drawn
        res["freeze undone" if undo else "as shipped"] = dict(steps=FIT_STEPS, gen2=len(inside), gen2_ms=float(sum(inside)),
                                                              gen2_ms_max=float(max(inside, default=0.0)), step_ms_median=float(np.median(walls[1:])),
                                                              step_ms_max=float(walls[1:].max()), frozen_objects=gc.get_freeze_count())
    return res


def phase_fit_gc() -> dict:
    """:func:`fit_gc_child` in its own process; prints a line per run."""
    proc = subprocess.run([sys.executable, __file__, "--fit-gc"], capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise AssertionError(f"fit gc run failed ({proc.returncode}):\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])["fit_gc"]
    for run, r in res.items():
        print(f"fit gc ({run}; Trainer.fit in a fresh process, flagship, {r['steps']} steps): gen-2 collections inside steps 2-{r['steps']}: "
              f"{r['gen2']} ({r['gen2_ms']:.1f} ms, longest {r['gen2_ms_max']:.1f} ms); step wall median {r['step_ms_median']:.1f} ms, longest "
              f"{r['step_ms_max']:.1f} ms; objects frozen at the end {r['frozen_objects']}")
    return res


GC_PROBE_REQUESTS = 200  # two halves: the first after gc.freeze(), the second after gc.unfreeze()
GC_PROBE_GROWTH = 0.05  # host RSS and card memory may grow at most this share from a half's 50th request to its last


def _rss_bytes() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def gc_probe_child(dev) -> dict:
    """In a fresh process (``--gc-probe``): the flagship, Conformer-CTC Small,
    Transformer-CTC base and the memory-64 streaming model built side by
    side (bf16), one warm-up request, then GC_PROBE_REQUESTS flagship
    requests of 8 × 6–10 s through ``recognize``: the first half after
    ``gc.collect(); gc.freeze()``, the second after ``gc.unfreeze()``. Per
    half: the gen-2 collections inside it and each one's pause (through
    ``gc.callbacks``), host RSS and ``torch.cuda.memory_allocated()`` at its
    start, after its 50th request and at its end, and the request walls."""
    from tensorflowasr_tpu_torch import schemas
    from tensorflowasr_tpu_torch.models.transducer.base import recognize

    models = {"flagship": flagship(torch.bfloat16, dev).eval(), "conformer_ctc": ctc_model("conformer_ctc", torch.bfloat16, dev).eval(),
              "transformer_ctc": ctc_model("transformer_ctc", torch.bfloat16, dev).eval(), "streaming": streaming_model("streaming", torch.bfloat16, dev)}
    model, rng = models["flagship"], np.random.default_rng(SEED + 21)
    recognize(model, schemas.PredictInput(*make_request(rng, 8, 6.0, 10.0, dev)))
    torch.cuda.synchronize()
    pauses, t_gc = [], [None]

    def watch(phase, info):
        if phase == "start":
            t_gc[0] = time.perf_counter()
        elif info.get("generation") == 2 and t_gc[0] is not None:
            pauses.append((time.perf_counter() - t_gc[0]) * 1e3)

    def snapshot():
        return _rss_bytes(), torch.cuda.memory_allocated(dev)

    res = {}
    gc.callbacks.append(watch)
    try:
        for half in ("frozen", "unfrozen"):
            if half == "frozen":
                gc.collect()
                gc.freeze()
            else:
                gc.unfreeze()
            first, marks, walls = len(pauses), [snapshot()], []
            for r in range(GC_PROBE_REQUESTS // 2):
                audio, lens = make_request(rng, 8, 6.0, 10.0, dev)
                t0 = time.perf_counter()
                out = recognize(model, schemas.PredictInput(audio, lens))
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
                if not ((out.tokens >= 0) & (out.tokens < model.vocab_size)).all():
                    raise AssertionError(f"gc probe {half} request {r}: token ids outside the vocabulary")
                if r == 49:
                    marks.append(snapshot())
            marks.append(snapshot())
            res[half] = dict(requests=GC_PROBE_REQUESTS // 2, gen2=len(pauses) - first, pauses_ms=pauses[first:], rss=[m[0] for m in marks],
                             allocated=[m[1] for m in marks], wall_ms_median=float(np.median(walls)), wall_ms_max=float(max(walls)),
                             frozen_objects=gc.get_freeze_count())
    finally:
        gc.callbacks.remove(watch)
    res["models"] = sorted(models)
    return res


def phase_gc_probe() -> dict:
    """:func:`gc_probe_child` in its own process; prints a line per half and
    fails if host RSS or card memory grew by more than GC_PROBE_GROWTH from a
    half's 50th request to its last."""
    proc = subprocess.run([sys.executable, __file__, "--gc-probe"], capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise AssertionError(f"gc probe failed ({proc.returncode}):\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])["gc_probe"]
    for half in ("frozen", "unfrozen"):
        r = res[half]
        mb = lambda xs: " / ".join(f"{x / 2 ** 20:.1f}" for x in xs)
        print(f"gc probe ({half}; one process with {', '.join(res['models'])} built, flagship requests of 8 x 6-10 s): {r['requests']} requests, "
              f"gen-2 collections {r['gen2']} (pauses {', '.join(f'{p:.1f}' for p in r['pauses_ms']) or 'none'} ms); host RSS {mb(r['rss'])} MiB and card "
              f"memory allocated {mb(r['allocated'])} MiB at the half's start / 50th request / end; request wall median {r['wall_ms_median']:.1f} ms, "
              f"longest {r['wall_ms_max']:.1f} ms; objects frozen {r['frozen_objects']}")
        for name, xs in (("host RSS", r["rss"]), ("card memory", r["allocated"])):
            if xs[2] > (1.0 + GC_PROBE_GROWTH) * xs[1]:
                raise AssertionError(f"gc probe {half}: {name} grew from {xs[1]} to {xs[2]} bytes between the 50th and the last request "
                                     f"(> {GC_PROBE_GROWTH:.0%})")
    return res


TURNS = ("parent", "this", "this", "parent", "parent", "this")


# ------------------------------------ parallel ------------------------------------ #

PAR_SGD = {"class_name": "SGD", "config": {"learning_rate": 1e-2}}
PAR_ADAM = {"class_name": "Adam", "config": {"learning_rate": 1e-4}}  # the bf16 steps at dropout 0.1, as the train phase's
# f32, against the single-process step: the loss and grad_norm within PAR_REL of theirs; each parameter's and running
# statistic's update (its value after the step less its value before: at SGD 1e-2 and a grad_norm of thousands the
# update outweighs the weight) within the f32 train-step parity bounds (TRAIN_PARITY_REL of its tensor's largest update,
# plus TRAIN_PARITY_FLOOR of the largest update of all for the updates that are f32 noise: the conv biases ahead of a
# BatchNorm). Measured in PR 18 (PERF.md): the ranks' weight gradients, summed in other orders (8 rows a rank, the
# E[x²] − E[x]² of the BatchNorm statistics from two ranks' sums), part by up to 5.4e-4 of a tensor's update.
PAR_REL = 1e-5
# d loss / d logits of the vocab-sharded loss against the unsharded one, of scale: each cell's occupancy exp(α + β − ll) carries
# the f32 rounding of α and β, sums along paths of up to T + U dependent diagonals, which a sum of exponentials in two halves moves
PAR_DLOGITS_REL = 1e-3
PAR_WORLD = 2  # gloo ranks on the one card
PAR_CLI_STEPS = 2
# per TP step: the encoder's kernels and the DP once (tp_rnnt_loss); the fused joint cannot run on a vocab shard
PER_STEP_TP = _per(**ENCODER_FWD, **ENCODER_BWD, rnnt_dp=1)
PAR_NOTE = "gloo on one card, not a scaling figure"


def _smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def parallel_batch(dev=None):
    """The flagship training batch (16 × 5.1–16 s, bench.py:149-157's lengths), on ``dev`` when given."""
    batch = train_batch(np.random.default_rng(SEED + 2), TRAIN_B, TRAIN_SECS, TRAIN_U, VOCAB)
    return batch.to(dev) if dev is not None else batch


def parallel_rows(batch, rank: int, world: int):
    """Rows ``rank``·B/world … of ``batch`` (this rank's share of the global batch)."""
    from tensorflowasr_tpu_torch import schemas

    n = batch.inputs.inputs.shape[0] // world
    take = lambda t: t[rank * n:(rank + 1) * n]
    return schemas.TrainData(schemas.TrainInput(*map(take, batch.inputs)), schemas.TrainLabel(*map(take, batch.labels)))


def _cpu_state(module: torch.nn.Module) -> dict:
    return {k: v.detach().float().cpu() for k, v in module.state_dict().items()}


def timed_step(step_fn, state, batch) -> tuple:
    """(state, loss, grad_norm, host ms, launches): one step, its launches counted from 0."""
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    state, metrics = step_fn(state, batch)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    return state, metrics["loss"].item(), metrics["grad_norm"].item(), wall, launch_counts()


def trainer_step(dev, batch, dtype=torch.float32, dropout: float = 0.0, mesh=None, steps: int = 1, optimizer: dict = PAR_SGD) -> list:
    """``steps`` steps of a fresh flagship ``Trainer`` (f32 parity runs: SGD, dropout 0, no SpecAugment): [(state, loss, grad_norm, ms, launches)]."""
    from tensorflowasr_tpu_torch.training.trainer import Trainer

    trainer = Trainer(flagship(dtype, dev, dropout=dropout), optimizer, device=dev, mesh=mesh)
    state, out = trainer.init_state(seed=SEED), []
    for _ in range(steps):
        state, *rest = timed_step(trainer.train_step, state, batch)
        out.append((state, *rest))
    return out


def tp_step(dev, mesh, batch, dtype=torch.float32, dropout: float = 0.0, steps: int = 1, optimizer: dict = PAR_SGD) -> list:
    """``steps`` steps of the vocab-sharded flagship over ``mesh``: [(state, loss, grad_norm, ms, launches)]."""
    from tensorflowasr_tpu_torch.parallel import tp

    state = tp.init_tp_state(flagship(dtype, dev, dropout=dropout), optimizer, mesh, seed=SEED)
    step, out = tp.make_tp_train_step(state.model, mesh), []
    for _ in range(steps):
        state, *rest = timed_step(step, state, batch)
        out.append((state, *rest))
    return out


def gloo_cuda_check(dev) -> list:
    """The collectives this slice runs, on CUDA tensors of a gloo group: all-reduce SUM and MAX, broadcast, barrier. Raises on a refusal or a wrong value."""
    import torch.distributed as dist

    rank, world = dist.get_rank(), dist.get_world_size()
    checks = []
    for name, run, want in (("all_reduce SUM", lambda x: dist.all_reduce(x, op=dist.ReduceOp.SUM), sum(range(1, world + 1))),
                            ("all_reduce MAX", lambda x: dist.all_reduce(x, op=dist.ReduceOp.MAX), world),
                            ("broadcast", lambda x: dist.broadcast(x, src=0), 1)):
        x = torch.full((1 << 20,), float(rank + 1), device=dev)
        try:
            run(x)
        except RuntimeError as e:
            raise RuntimeError(f"gloo refuses {name} on CUDA tensors: {e}") from e
        if not bool((x == want).all()):
            raise AssertionError(f"gloo {name} on CUDA tensors gave {x[0].item()}, expected {want}")
        checks.append(name)
    dist.barrier()
    return checks + ["barrier"]


def parallel_child(device_type: str) -> dict:
    """One gloo rank on the card (``parallel.spawn``; ``device_type`` "cpu"
    rehearses it on the CPU at a small size): the collective check,
    the data-parallel f32 step on its 8 rows, ``tp_rnnt_loss`` (data 1 ×
    model 2) at the loss shapes against the unsharded ``rnnt_loss_pallas``,
    the TP f32 step on all 16 rows, and two bf16 steps of each at the
    example's dropout 0.1."""
    from tensorflowasr_tpu_torch import parallel
    from tensorflowasr_tpu_torch.ops.cuda.rnnt_kernel import rnnt_loss_pallas
    from tensorflowasr_tpu_torch.parallel import tp

    _no_tf32()
    dev = torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda" else torch.device(device_type)
    rank, world = parallel.process_index(), parallel.process_count()
    out = {"collectives": gloo_cuda_check(dev)}
    batch = parallel_batch(dev)
    mine = parallel_rows(batch, rank, world)
    state, loss, gnorm, wall, counts = trainer_step(dev, mine)[0]
    out["dp"] = {"loss": loss, "grad_norm": gnorm, "ms": wall, "launches": counts, "state": _cpu_state(state.model)}
    del state
    mesh = tp.make_dp_tp_mesh(world, dev)

    t_len, u_len = loss_lengths(np.random.default_rng(SEED + 5), TRAIN_B)
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    logits = torch.randn((TRAIN_B, T_ENC, TRAIN_U + 1, VOCAB), generator=gen, device=dev)
    labels = torch.randint(1, VOCAB, (TRAIN_B, TRAIN_U), generator=gen, device=dev)
    t_len, u_len = torch.tensor(t_len, device=dev), torch.tensor(u_len, device=dev)
    full = logits.clone().requires_grad_(True)
    ref = rnnt_loss_pallas(full, t_len, labels, u_len)
    ref.sum().backward()
    n, index = tp.model_coords(mesh)
    local = logits.chunk(n, -1)[index].clone().requires_grad_(True)
    torch.cuda.synchronize()
    reset_launch_counts()
    per = tp.tp_rnnt_loss(local, t_len, labels, u_len, VOCAB, mesh.get_group("model"))
    per.sum().backward()
    torch.cuda.synchronize()
    out["tp_loss"] = {"loss_err": (per - ref).abs().max().item(), "loss_scale": ref.abs().max().item(), "launches": launch_counts(),
                      "dlogits_err": (local.grad - full.grad.chunk(n, -1)[index]).abs().max().item(), "dlogits_scale": full.grad.abs().max().item()}
    del logits, full, local, ref, per
    torch.cuda.empty_cache()

    state, loss, gnorm, wall, counts = tp_step(dev, mesh, batch)[0]
    gathered = tp.gather_tp_state(state.model.state_dict(), mesh)  # a collective: every rank takes part
    out["tp"] = {"loss": loss, "grad_norm": gnorm, "ms": wall, "launches": counts, "vocab_rows": state.model.joint.vocab.weight.shape[0],
                 "state": {k: v.float().cpu() for k, v in gathered.items()} if rank == 0 else None}
    del state
    torch.cuda.empty_cache()
    out["bf16_dp"] = [(loss, wall, counts) for _, loss, _, wall, counts in trainer_step(dev, mine, torch.bfloat16, TRAIN_RATE, steps=2, optimizer=PAR_ADAM)]
    out["bf16_tp"] = [(loss, wall, counts) for _, loss, _, wall, counts in tp_step(dev, mesh, batch, torch.bfloat16, TRAIN_RATE, steps=2, optimizer=PAR_ADAM)]
    return out


def hold_state(what: str, got: dict, ref: dict, init: dict, failures: list) -> str:
    """Holds the updates of state ``got`` against those of ``ref`` (both from
    ``init``) within TRAIN_PARITY_REL of each tensor's largest update plus
    TRAIN_PARITY_FLOOR of the largest update of all; a tensor beyond its bound
    goes into ``failures``. Returns the summary the parallel lines print, with
    the largest distance relative to its tensor's update."""
    top = max((ref[k] - init[k]).abs().max().item() for k in ref)
    worst = worst_rel = (0.0, "")
    equal = True
    for k, r in ref.items():
        g = got[k].float()
        err, scale = (g - r).abs().max().item(), (r - init[k]).abs().max().item()
        if err > TRAIN_PARITY_REL * scale + TRAIN_PARITY_FLOOR * top:
            failures.append(f"{what}: {k} distance {err:.3e} > {TRAIN_PARITY_REL} x {scale:.3e} + {TRAIN_PARITY_FLOOR} x {top:.3e}")
        worst, equal = max(worst, (err, k)), equal and torch.equal(g, r)
        if scale > TRAIN_PARITY_FLOOR * top:
            worst_rel = max(worst_rel, (err / scale, k))
    return (f"parameters and running statistics: largest distance {worst[0]:.3e} ({worst[1]}), largest relative to its tensor's update "
            f"{worst_rel[0]:.3e} ({worst_rel[1]}; bound {TRAIN_PARITY_REL} of it + {TRAIN_PARITY_FLOOR} x {top:.3e}); bit-equal {equal}")


def hold_scalar(what: str, got: float, ref: float, failures: list) -> float:
    if not abs(got - ref) <= PAR_REL * abs(ref):
        failures.append(f"{what}: {got} vs {ref}, beyond {PAR_REL} of it")
    return abs(got - ref)


def parallel_cli(dev, smi: str) -> dict:
    """``train`` under ``python -m torch.distributed.run --nproc_per_node 1`` (NCCL, world 1)
    for PAR_CLI_STEPS steps on the data phase's corpus (``cli.yml.j2``, CLI_BLOCKS blocks):
    rank 0 writes the one checkpoint. Returns its wall."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="tfasr-par-") as root:
        data_corpus(root)
        config, mdir = cli_config(root), os.path.join(root, "model")
        common = ["--config-path", config, "--datadir", root, "--modeldir", mdir]  # no metadata file: train computes the lengths itself
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1", "-m", "tensorflowasr_tpu_torch",
                               "train", *common, "--device", dev.type, "--bs", str(CLI_BS), "--epochs", "1", "--steps-per-epoch", str(PAR_CLI_STEPS), "--mxp", "strict"],
                              cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"parallel cli: torchrun train exit {proc.returncode}\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        steps = os.listdir(os.path.join(mdir, "checkpoints"))
        if steps != [str(PAR_CLI_STEPS)]:
            raise AssertionError(f"parallel cli: checkpoints {steps}, expected step {PAR_CLI_STEPS} written once")
    print(f"parallel cli: torchrun --nproc_per_node 1 train ({CLI_BLOCKS} blocks, bf16, bs {CLI_BS}, {PAR_CLI_STEPS} steps, NCCL world 1): exit 0 in "
          f"{wall:.1f} s (one process to reach the card), checkpoints {steps} written by rank 0 [{smi}]")
    return {"wall_s": wall}


def phase_parallel(dev) -> dict:
    """Data and tensor parallelism (``parallel/``) on the one card, the
    flagship at full width and depth (16 blocks, D 144, V 256), 16 × 5.1–16 s,
    SGD 1e-2, f32 with TF32 off, dropout 0, no SpecAugment:

    1. the data-parallel ``Trainer`` step over an NCCL group of world 1 (in
       this process) against the plain ``Trainer`` step on the same batch;
    2. two gloo ranks on the card (:func:`parallel_child`, spawned; the
       kernels are built here first), 8 rows each, against the plain step on
       the 16 rows, the ranks' parameters held equal;
    3. the TP loss (data 1 × model 2) against the unsharded loss and the TP
       step against the plain step, row 9 once a rank a step, row 8 never;
    4. bf16 steps of 2 and 3 at dropout 0.1;
    5. ``train`` under ``torchrun --nproc_per_node 1`` (:func:`parallel_cli`).

    NCCL across cards is not exercised (one card; NCCL puts no two ranks on
    one device). Returns the launch counts by path."""
    import torch.distributed as dist

    from tensorflowasr_tpu_torch import parallel
    from tensorflowasr_tpu_torch.parallel.sharding import _free_port

    t0 = time.perf_counter()
    smi, failures = _smi(), []
    batch = parallel_batch(dev)
    init = _cpu_state(flagship(torch.float32, dev, dropout=0.0))
    ref_state, ref_loss, ref_gnorm, ref_ms, ref_counts = trainer_step(dev, batch)[0]
    if ref_counts != PER_STEP:
        raise AssertionError(f"parallel plain step: launches {ref_counts}, expected {PER_STEP}")
    ref = _cpu_state(ref_state.model)
    del ref_state
    print(f"parallel plain step (f32, 16 rows, one process): loss {ref_loss:.6f} grad_norm {ref_gnorm:.6f}, {ref_ms:.1f} ms [{smi}]")
    again, loss, gnorm, wall, _ = trainer_step(dev, batch)[0]
    print(f"parallel plain step again (the run-to-run floor: cuDNN's convolution backward may sum in any order): loss and grad_norm bit-equal "
          f"{loss == ref_loss and gnorm == ref_gnorm}; {hold_state('parallel plain step again', _cpu_state(again.model), ref, init, failures)}; "
          f"{wall:.1f} ms [{smi}]")
    del again

    parallel.init_process_group(dev, None, 0, 1, f"tcp://localhost:{_free_port()}")  # NCCL on the card
    try:
        state, loss, gnorm, wall, nccl_counts = trainer_step(dev, batch, mesh=parallel.make_data_parallel_mesh(dev))[0]
        nccl = _cpu_state(state.model)
        del state
    finally:
        dist.destroy_process_group()
    if nccl_counts != PER_STEP:
        raise AssertionError(f"parallel NCCL world-1 step: launches {nccl_counts}, expected {PER_STEP}")
    print(f"parallel dp NCCL world 1 vs plain step: loss {loss:.6f} (distance {hold_scalar('NCCL loss', loss, ref_loss, failures):.3e}), grad_norm "
          f"{gnorm:.6f} (distance {hold_scalar('NCCL grad_norm', gnorm, ref_gnorm, failures):.3e}); "
          f"{hold_state('parallel NCCL world-1 step', nccl, ref, init, failures)}; loss and grad_norm bit-equal "
          f"{loss == ref_loss and gnorm == ref_gnorm}; {wall:.1f} ms [{smi}]")

    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    ranks = parallel.spawn(parallel_child, PAR_WORLD, dev.type, device=dev.type, backend="gloo", timeout=900)
    spawn_s = time.perf_counter() - t1
    print(f"parallel gloo check: {ranks[0]['collectives']} take CUDA tensors on every rank [{smi}]")
    for r, res in enumerate(ranks):
        dp = res["dp"]
        if dp["launches"] != PER_STEP:
            failures.append(f"parallel gloo rank {r}: launches {dp['launches']}, expected {PER_STEP}")
        print(f"parallel dp gloo rank {r} of {PAR_WORLD} (8 rows) vs plain step (16 rows): loss {dp['loss']:.6f} (distance "
              f"{hold_scalar('gloo loss', dp['loss'], ref_loss, failures):.3e}), grad_norm {dp['grad_norm']:.6f} (distance "
              f"{hold_scalar('gloo grad_norm', dp['grad_norm'], ref_gnorm, failures):.3e}); {hold_state(f'parallel gloo rank {r}', dp['state'], ref, init, failures)}; "
              f"step {dp['ms']:.1f} ms ({PAR_NOTE}); launches {_launched(dp['launches'])} [{smi}]")
    between = max((ranks[0]["dp"]["state"][k] - ranks[1]["dp"]["state"][k]).abs().max().item() for k in ref)
    if between != 0.0:
        failures.append(f"parallel gloo: the ranks' parameters differ by {between}")
    print(f"parallel dp gloo: the two ranks' parameters and statistics differ by {between}")

    for r, res in enumerate(ranks):
        tl = res["tp_loss"]
        if tl["loss_err"] > PAR_REL * tl["loss_scale"] or tl["dlogits_err"] > PAR_DLOGITS_REL * tl["dlogits_scale"]:
            failures.append(f"parallel tp_rnnt_loss rank {r}: {tl}")
        if tl["launches"] != _per(rnnt_dp=1):
            failures.append(f"parallel tp_rnnt_loss rank {r}: launches {tl['launches']}, expected rnnt_dp 1")
        print(f"parallel tp_rnnt_loss rank {r} (model {r} of 2; B {TRAIN_B} T {T_ENC} U+1 {TRAIN_U + 1} V {VOCAB}, f32) vs unsharded rnnt_loss_pallas: "
              f"loss max distance {tl['loss_err']:.3e} (scale {tl['loss_scale']:.3e}; bound {PAR_REL} of it), dlogits {tl['dlogits_err']:.3e} (scale "
              f"{tl['dlogits_scale']:.3e}; bound {PAR_DLOGITS_REL} of it); launches {_launched(tl['launches'])} [{smi}]")
    for r, res in enumerate(ranks):
        t = res["tp"]
        if t["launches"] != PER_STEP_TP:
            failures.append(f"parallel tp rank {r}: launches {t['launches']}, expected {PER_STEP_TP}")
        print(f"parallel tp step rank {r} (data 1 x model 2, {t['vocab_rows']} vocab rows a rank, 16 rows) vs plain step: loss {t['loss']:.6f} "
              f"(distance {hold_scalar(f'tp rank {r} loss', t['loss'], ref_loss, failures):.3e}), grad_norm {t['grad_norm']:.6f} (distance "
              f"{hold_scalar(f'tp rank {r} grad_norm', t['grad_norm'], ref_gnorm, failures):.3e}); step {t['ms']:.1f} ms ({PAR_NOTE}); launches "
              f"{_launched(t['launches'])} (rnnt_dp 1, rnnt_fused_joint 0) [{smi}]")
    print(f"parallel tp step, the vocab slices gathered back vs plain step: {hold_state('parallel tp step', ranks[0]['tp']['state'], ref, init, failures)}")
    for kind in ("bf16_dp", "bf16_tp"):
        for r, res in enumerate(ranks):
            losses = [loss for loss, _, _ in res[kind]]
            if not all(np.isfinite(losses)):
                failures.append(f"parallel {kind} rank {r}: losses {losses}")
            want = PER_STEP if kind == "bf16_dp" else PER_STEP_TP
            if any(c != want for _, _, c in res[kind]):
                failures.append(f"parallel {kind} rank {r}: launches {[c for _, _, c in res[kind]]}, expected {want}")
            print(f"parallel {kind} rank {r} (dropout {TRAIN_RATE}, Adam 1e-4, 2 steps): losses {', '.join(f'{x:.4f}' for x in losses)}; walls "
                  f"{', '.join(f'{w:.1f}' for _, w, _ in res[kind])} ms ({PAR_NOTE}) [{smi}]")
    if failures:
        raise AssertionError("parallel phase:\n" + "\n".join(failures))
    cli = parallel_cli(dev, smi)
    print(f"parallel phase: {time.perf_counter() - t0:.1f} s (the two gloo ranks {spawn_s:.1f} s, the torchrun train {cli['wall_s']:.1f} s) [{smi}]")
    paths = {"parallel_dp_nccl": nccl_counts}
    for r, res in enumerate(ranks):
        paths[f"parallel_dp_gloo_{r}"] = res["dp"]["launches"]
        paths[f"parallel_tp_{r}"] = res["tp"]["launches"]
    return paths


# ------------------------------------ the layers the port took last ------------------------------------ #

LAYERS_VGG = {"class_name": "tensorflow_asr.models.layers.subsampling>VggSubsampling",
              "config": {"filters": [32, 64], "kernel_size": 3, "pool_size": 2, "strides": 2}}
LAYERS_CONV1D = {"class_name": "tensorflow_asr.models.layers.subsampling>Conv1dSubsampling",
                 "config": {"filters": [D_MODEL, D_MODEL], "strides": [2, 2], "kernels": [3, 3], "paddings": ["causal", "causal"], "norms": ["batch", "batch"],
                            "activations": ["swish", "swish"]}}
L2_BLOCKS, L3_LAYERS, L3_STREAM_CHUNKS = 4, 2, 4
LAYERS_STEPS = {"l1": 3, "l2": 3, "l3": 3}  # the first step of a model is cold (allocations, cuDNN's choices)
LAYERS_EVALS = 2
_ENC_L1 = dict(fused_attention=16, fused_ff=32, conv_front=16, conv_back=16)
PER_REQUEST_LAYERS = {"l1": _per(**_ENC_L1), "l2": _per(fused_rel_attention=L2_BLOCKS), "l3": _per()}
PER_STEP_LAYERS = {"l1": _per(**_ENC_L1, fused_attention_bwd=16, fused_ff_bwd=32, conv_front_bwd=16, conv_back_bwd=16, **_LOSS),
                   "l2": _per(fused_rel_attention=L2_BLOCKS, fused_rel_attention_bwd=L2_BLOCKS, **_LOSS), "l3": _per(ctc_loss=1)}
PER_EVAL_LAYERS = {"l1": _per(**_ENC_L1, rnnt_logprobs=1, rnnt_dp=1)}
# a request of 8 utterances: the flagship's serving shape (bench.py's decode cell) for the transducers, 16 s for DeepSpeech2
LAYERS_REQUEST_S = {"l1": (10.0, 10.0), "l2": (10.0, 10.0), "l3": (16.0, 16.0)}


def layers_config(name: str, num_blocks: int | None = None, dropout: float = TRAIN_RATE) -> dict:
    """The flagship Conformer-Transducer Small (its published widths) with the
    layers the port took last. ``l1``: 80 MFCCs, VGG subsampling (32, 64),
    vanilla MHA (kernel A at head 36), a one-hot label encoder and a GRU-320
    prediction net with LayerNorm. ``l2`` (4 blocks): 80 log-gammatone bins,
    Conv1d subsampling [144, 144] (strides 2, 2, kernels 3, causal, batch
    norm, swish), post-norm modules under a pre-norm block, a grouped
    depthwise conv with LayerNorm, trainable residual factors, no attention
    auto mask, relative MHA (kernel B) and a simple-RNN-320 prediction net."""
    from tensorflowasr_tpu_torch.models.transducer.conformer import conformer_small_config

    cfg = conformer_small_config(num_blocks=num_blocks or (16 if name == "l1" else L2_BLOCKS), dropout=dropout)
    if name == "l1":
        cfg["speech_config"]["feature_type"] = "mfcc"
        cfg.update(encoder_subsampling=LAYERS_VGG, encoder_mha_type="mha", prediction_label_encode_mode="one_hot", prediction_rnn_type="gru")
    else:
        cfg["speech_config"]["feature_type"] = "log_gammatone_spectrogram"
        cfg.update(encoder_subsampling=LAYERS_CONV1D, encoder_module_norm_position="post", encoder_block_norm_position="pre",
                   encoder_convm_use_group_conv=True, encoder_convm_dw_norm_type="layer", encoder_ffm_residual_factor="trainable",
                   encoder_mhsam_residual_factor="trainable", encoder_convm_residual_factor="trainable", encoder_use_attention_auto_mask=False,
                   prediction_rnn_type="rnn")
    return cfg


def layers_model(name: str, dtype, device, tmp: str, depth: int | None = None, dropout: float | None = None, uni: bool = False) -> torch.nn.Module:
    """``l1``/``l2`` (:func:`layers_config`; dropout TRAIN_RATE unless
    given) or ``l3``: DeepSpeech2 base (or uni) from its example with GRU
    layers, cut to ``depth`` (default L3_LAYERS) of its 5, the example's
    dropout and SpecAugment unless ``dropout`` is given; random weights
    from SEED."""
    from tensorflowasr_tpu_torch.models.transducer.conformer import Conformer

    if name == "l3":
        ds2 = "deepspeech2_uni" if uni else "deepspeech2"
        return family_model(ds2, dtype, device, tmp, depth=depth or L3_LAYERS, dropout=dropout, overrides={"rnn_type": "gru"})
    model = Conformer.from_config(layers_config(name, depth, TRAIN_RATE if dropout is None else dropout), dtype=dtype, device=device)
    model.reset_parameters(torch.Generator().manual_seed(SEED))
    return model


def layers_kernels(dev, rows: list[dict]) -> None:
    """Kernel A (row 4) at head 36, l1's attention shape: B·H 64, T = S 400,
    the auto mask of a ragged batch as the padded-row bias, rate 0.1, forward
    and backward against its plain version (f32 and bf16, the kernel-A
    tolerances), times and bound, its bf16 accuracy against float64, and
    SDPA on the same inputs at rate 0 and 0.1; and both frontend kernels
    (rows 1-2) below the frame length: the FFT at nfft 256 and the direct
    DFT at nfft 300, 25 ms frames of 400 samples, against the plain rfft
    chain (which crops each frame to nfft), also through
    ``FeatureExtraction``. Sub-entries ``head36`` and
    ``nfft256_frame400`` / ``nfft300_frame400`` of their rows."""
    from tensorflowasr_tpu_torch.models.layers.feature_extraction import FeatureExtraction
    from tensorflowasr_tpu_torch.ops import frontend
    from tensorflowasr_tpu_torch.ops.cuda import attention_kernel as ak
    from tensorflowasr_tpu_torch.ops.cuda import frontend_kernel as fek

    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    t_np, _ = loss_lengths(np.random.default_rng(SEED + 2), TRAIN_B)
    bh, t, d = TRAIN_B * HEADS, T_ENC, HEAD
    valid = torch.arange(t, device=dev)[None, :] < torch.tensor(t_np, device=dev).repeat_interleave(HEADS)[:, None]
    what = f"layers l1 train, BH {bh} T = S {t} head {d}, auto mask, rate {TRAIN_RATE}"

    def att_make(dt, rate=TRAIN_RATE):
        q, k, v = _randn(gen, (bh, t, d), 1.0 / d ** 0.5, dt), _randn(gen, (bh, t, d), 1.0, dt), _randn(gen, (bh, t, d), 1.0, dt)
        bias = torch.where(valid, 0.0, -1e9)[:, :, None].expand(bh, t, t).to(dt).contiguous()
        cfg_ = (23, rate)
        out, stats = ak.fused_attention_kernel(q, k, v, bias, *cfg_, with_stats=True)
        return (q, k, v, bias, *cfg_), (q, k, v, bias, out, stats, _randn(gen, (bh, t, d), 1.0, dt), *cfg_)

    def bwd_kernel(q, k, v, bias, out, stats, dout, seed, rate):
        return ak.fused_attention_bwd_kernel(q, k, v, bias, out, dout, seed, rate, bias_grad=False, stats=stats)[:3]

    def bwd_plain(q, k, v, bias, out, stats, dout, seed, rate):
        return ak.fused_attention_plain_bwd(q, k, v, bias, dout, seed, rate, bias_grad=False)[:3]

    att = _check_fwd_bwd("fused_attention", ak.fused_attention_kernel, ak.fused_attention_plain, bwd_kernel, bwd_plain, att_make,
                         lambda elt, bwd: cost_vanilla_attention(bh, t, t, d, elt, bh * t * t * elt, bwd), what=what)
    times = {}
    for rate in (0.0, TRAIN_RATE):
        fargs, bargs = att_make(torch.bfloat16, rate)
        q, k, v, bias = fargs[:4]
        qs, ks, vs = (a.detach().clone().requires_grad_(True) for a in (q, k, v))
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, attn_mask=bias, dropout_p=rate, scale=1.0)
        out = sdpa()
        times[rate] = dict(fwd=time_ms(ak.fused_attention_kernel, *fargs), bwd=time_ms(bwd_kernel, *bargs),
                           sdpa_fwd=time_ms(lambda: sdpa().detach()), sdpa_bwd=time_ms(lambda: torch.autograd.grad(out, (qs, ks, vs), bargs[6], retain_graph=True)))
        r = times[rate]
        print(f"kernel fused_attention bf16 at rate {rate} (layers l1, BH {bh} T = S {t} head {d}): forward {r['fwd']:.4f} ms, backward "
              f"{r['bwd']:.4f} ms; library F.scaled_dot_product_attention (attn_mask = the bias, dropout_p {rate}, scale 1): forward "
              f"{r['sdpa_fwd']:.4f} ms, backward {r['sdpa_bwd']:.4f} ms")
    attention_accuracy(*att_make(torch.bfloat16), bwd_kernel, bwd_plain)
    by_name = {r["name"]: r for r in rows}
    for part, row in zip(("fwd", "bwd"), att):
        sub = {k: row[k] for k in ("max_abs_err", "max_abs_err_bf16", "ms", "plain_ms", "bound_ms", "bound_by")}
        sub.update(library_ms=times[TRAIN_RATE][f"sdpa_{part}"], ms_rate0=times[0.0][part], library_ms_rate0=times[0.0][f"sdpa_{part}"])
        by_name[row["name"]]["head36"] = sub

    # the frontend kernels below the frame length (25 ms: 400 samples)
    fe = by_name["log_mel_spectrogram"]
    for nfft, shape, tag in ((256, (TRAIN_B, int(TRAIN_SECS * 16000)), "nfft256_frame400"), (300, (8, 160000), "nfft300_frame400")):
        cfg = frontend.FrontendConfig(nfft=nfft)
        sig = frontend.preemphasis_signal(_randn(gen, shape, 0.1), cfg).contiguous()
        err, ms, plain_ms, b = frontend_line(sig, cfg, f"{'train' if shape[0] == TRAIN_B else 'serve'}, frame 400 cropped to nfft {nfft}")
        fe[tag] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1], kernel="fft" if fek.uses_fft(nfft) else "dft")
        module = FeatureExtraction(**{"sample_rate": 16000, "frame_ms": 25, "stride_ms": 10, "nfft": nfft, "num_feature_bins": 80}).to(dev)
        lens = torch.full((shape[0],), shape[1], device=dev)
        before = (fek.launches, fek.dft_launches)
        feats, _ = module(sig, lens)
        launched = (fek.launches - before[0], fek.dft_launches - before[1])
        plain, _ = frontend.extract_features(sig, lens, cfg)
        ferr = _close(f"FeatureExtraction nfft {nfft}", feats, plain, 1e-3, 0.0)
        if launched != ((1, 0) if fek.uses_fft(nfft) else (0, 1)):
            raise AssertionError(f"FeatureExtraction nfft {nfft}: launched FFT {launched[0]}, DFT {launched[1]} times")
        print(f"layers FeatureExtraction (log-mel, nfft {nfft}, 25 ms frames of 400 samples): {'FFT' if launched[0] else 'DFT'} kernel launched once, "
              f"max_abs_err vs the plain chain {ferr:.3e} (tol 1e-3)")


def layers_profiled(fn) -> tuple[float, float]:
    """``fn()`` once under the profiler, device activity only: (card kernel
    ms, wall ms). The host's operator events of an eager GRU or decode loop
    (10^4–10^5 a call) would take the profiler far longer to sort than the
    call itself."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    return sum(e.self_device_time_total for e in kernels) / 1e3, wall


def layers_serve(dev, name: str, model, recognize_fn) -> dict:
    """3 requests of 8 utterances (LAYERS_REQUEST_S) through ``recognize``
    after a warm-up request, each request's launches equal to its
    PER_REQUEST_LAYERS entry (set to 0 just before, read just after); walls,
    RTF and, on one more profiled request, the card's busy share. Returns
    the launch counts."""
    from tensorflowasr_tpu_torch import schemas

    tag = f"layers serve {name}"
    lo, hi = LAYERS_REQUEST_S[name]
    rng = np.random.default_rng(SEED + 5)
    requests = [make_request(rng, 8, lo, hi, dev) for _ in range(3)]
    recognize_fn(model, schemas.PredictInput(*make_request(rng, 8, lo, hi, dev)))
    torch.cuda.synchronize()
    settle()
    reset_launch_counts()
    walls = []
    for r, (audio, lens) in enumerate(requests):
        before = launch_counts()
        with RequestWatch() as watch:
            t0 = time.perf_counter()
            out = recognize_fn(model, schemas.PredictInput(audio, lens))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        delta = {k: v - before[k] for k, v in launch_counts().items()}
        if delta != PER_REQUEST_LAYERS[name]:
            raise AssertionError(f"{tag} request {r}: kernel launches {delta}, expected {PER_REQUEST_LAYERS[name]}")
        if not ((out.tokens >= 0) & (out.tokens < model.vocab_size)).all():
            raise AssertionError(f"{tag} request {r}: token ids outside the vocabulary")
        audio_s = lens.sum().item() / 16000.0
        print(f"{tag} request {r}: batch 8, audio {audio_s:.2f} s, recognize {walls[-1] * 1e3:.3f} ms ({watch}), RTF {walls[-1] / audio_s:.6f}, "
              f"tokens {tuple(out.tokens.shape)}, nonblank {int((out.tokens != 0).sum())}")
    counts = launch_counts()
    busy_ms, wall = layers_profiled(lambda: recognize_fn(model, schemas.PredictInput(*requests[0])))
    print(f"{tag}: launches per request {_launched(PER_REQUEST_LAYERS[name])}; median wall {float(np.median(walls)) * 1e3:.3f} ms; profiled request: "
          f"card kernel time {busy_ms:.1f} ms of {wall:.1f} ms (busy {100 * busy_ms / wall:.1f}% under the profiler)")
    return counts


def layers_train(dev, name: str, model, batch, lr: float = 1e-4) -> tuple[dict, tuple]:
    """LAYERS_STEPS default (auto) bf16 training steps (each step's launches
    checked by :func:`run_train`), the loss falling, one profiled step
    (:func:`layers_profiled`) for the busy share. Returns the launch counts
    and (trainer, state, batch)."""
    tag, steps = f"layers train {name}", LAYERS_STEPS[name]
    counts, losses, walls, trainer, state, batch, _ = run_train(dev, "auto", steps, PER_STEP_LAYERS[name], tag, model=model, lr=lr, batch=batch)
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{tag}: loss did not fall over {steps} steps: {losses}")
    busy_ms, wall = layers_profiled(lambda: trainer.train_step(state, batch))
    steady = float(np.median(walls[1:]))
    print(f"{tag}: losses {', '.join(f'{x:.4f}' for x in losses)}; median step after the first {steady:.1f} ms; profiled step: card kernel time "
          f"{busy_ms:.1f} ms ({wall:.1f} ms under the profiler) → busy {100 * busy_ms / steady:.1f}% of the median step")
    return counts, (trainer, state, batch)


def layers_eval(dev, model, trainer, state, batch) -> dict:
    """l1's eval step (default loss_impl: the log-probability rows and the
    DP), LAYERS_EVALS steps, launches checked; the loss against the plain-DP
    eval's to 1e-5. Returns the launch counts."""
    from tensorflowasr_tpu_torch.training.trainer import make_eval_step

    torch.cuda.synchronize()
    reset_launch_counts()
    for step in range(LAYERS_EVALS):
        before = launch_counts()
        t0 = time.perf_counter()
        loss = trainer.eval_step(state, batch)["loss"].item()
        wall = (time.perf_counter() - t0) * 1e3
        delta = {k: v - before[k] for k, v in launch_counts().items()}
        if delta != PER_EVAL_LAYERS["l1"]:
            raise AssertionError(f"layers eval l1 step {step}: kernel launches {delta}, expected {PER_EVAL_LAYERS['l1']}")
        print(f"layers eval l1 step {step}: {wall:.1f} ms; loss {loss:.6f}")
    counts = launch_counts()
    xla = make_eval_step(model, "xla")(state, batch)["loss"].item()
    if not abs(loss - xla) <= 1e-5 * abs(xla):
        raise AssertionError(f"layers eval l1: default loss {loss} vs xla {xla}")
    print(f"layers eval l1: default (row kernel + DP kernel) {loss:.6f} vs xla (plain DP) {xla:.6f}")
    return counts


def layers_stream(dev, tmp: str) -> dict:
    """DeepSpeech2 uni with GRU layers (bf16, L3_LAYERS deep) streaming
    L3_STREAM_CHUNKS chunks of 160 ms through the CTC ``recognize``, each
    layer's bare ``h`` carried: no kernel on this path (the GRU is a loop of
    PyTorch ops, the frontend the plain spectrogram chain); the carried
    states' shapes checked. Returns the launch counts."""
    from tensorflowasr_tpu_torch.models.ctc.base import recognize

    model = layers_model("l3", torch.bfloat16, dev, tmp, uni=True).eval()
    chunks, size, step = stream_chunks(model, SEED + 23, dev)
    chunks = chunks[:L3_STREAM_CHUNKS]
    run_stream(model, chunks, size, dev, recognize=recognize)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    outs = run_stream(model, chunks, size, dev, _per(), recognize)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / len(chunks) * 1e3
    carried = [tuple(h.shape) for h in outs[-1].next_encoder_states]
    if carried != [(1, DS2_H)] * L3_LAYERS:
        raise AssertionError(f"layers stream l3: carried GRU states {carried}")
    print(f"layers stream l3 (deepspeech2 uni, {L3_LAYERS} GRU-{DS2_H} layers, bare h carried {carried}): {len(chunks)} chunks of {step / 16:.0f} ms, "
          f"{ms:.3f} ms per chunk, RTF {ms / (step / 16.0):.4f}; no kernel launched (as counted)")
    return launch_counts()


def phase_layers(dev, rows: list[dict]) -> dict:
    """The layers the port took last on three paths, bf16 with random
    weights from the seed: l1 (:func:`layers_config`, 16 blocks) serving 3
    requests of 8 × 10 s through ``recognize`` (eager WIND: the fused decode
    declines a GRU and a one-hot net), 3 training steps of 16 × ≤ 16 s,
    U 128 (Adam, dropout 0.1, the fused joint and the DP) and an eval step;
    l2 (4 blocks) serving and 3 training steps; l3 (DeepSpeech2 base with 2
    bidirectional GRU-512 layers, the example's dropout and SpecAugment)
    serving 8 × 16 s and 3 steps through the CTC kernel (8 × ≤ 16 s, char
    labels), and its uni layout streaming. Then each path's
    f32 request (2 deep, TF32 off, dropout 0) card vs CPU (plain versions):
    encoder output and greedy tokens. The kernels first
    (:func:`layers_kernels`). Returns the launch counts by path."""
    import tempfile

    from tensorflowasr_tpu_torch.models.ctc.base import recognize as ctc_recognize
    from tensorflowasr_tpu_torch.models.transducer.base import recognize

    t0 = time.perf_counter()
    parts = []

    def part(name: str) -> None:
        parts.append((name, time.perf_counter()))

    layers_kernels(dev, rows)
    part("kernels")
    paths = {}
    with tempfile.TemporaryDirectory(prefix="tfasr-layers-") as tmp:
        for name in ("l1", "l2", "l3"):
            model = layers_model(name, torch.bfloat16, dev, tmp)
            n_params = sum(p.numel() for p in model.parameters())
            frames = model.encoder.output_length(model.feature_extraction.get_nframes(int(TRAIN_SECS * 16000)))
            print(f"layers {name}: {type(model).__name__}, {n_params} parameters, V {model.vocab_size}, features "
                  f"{model.feature_extraction.config.feature_type} ({model.feature_extraction.config.num_feature_bins}), encoder frames at "
                  f"{TRAIN_SECS:g} s {frames}")
            if name != "l3" and model.decode_params() is not None:
                raise AssertionError(f"layers {name}: the fused decode took a prediction net it does not take in JAX")
            paths[f"layers_serve_{name}"] = layers_serve(dev, name, model.eval(), ctc_recognize if name == "l3" else recognize)
            if name == "l3":
                batch = train_batch(np.random.default_rng(SEED + 2), FAMILY_B, TRAIN_SECS, FAMILY_U, model.vocab_size, FAMILY_CHARS_PER_S)
            else:
                batch = train_batch(np.random.default_rng(SEED + 2), TRAIN_B, TRAIN_SECS, TRAIN_U, model.vocab_size)
            paths[f"layers_train_{name}"], (trainer, state, batch) = layers_train(dev, name, model.train(), batch)
            if name == "l1":
                paths["layers_eval_l1"] = layers_eval(dev, model.eval(), trainer, state, batch)
            del model, trainer, state
            torch.cuda.empty_cache()
            part(name)
        paths["layers_stream_l3"] = layers_stream(dev, tmp)
        part("stream")
        for name in ("l1", "l2", "l3"):
            cpu_model = layers_model(name, torch.float32, "cpu", tmp, depth=2, dropout=0.0)
            print(f"parity f32 request (layers {name}, 2 deep) card (kernels) vs CPU (plain), 2 x <= 4 s: {parity_request(cpu_model, dev, name, beam=False)}, "
                  f"TF32 off")
        part("parity")
    split = ", ".join(f"{name} {t - (parts[i - 1][1] if i else t0):.1f} s" for i, (name, t) in enumerate(parts))
    print(f"layers phase: {time.perf_counter() - t0:.1f} s ({split})")
    return paths


def compare_steps(parent: str) -> None:
    """Row 10a's times (``--rows``) and then the step numbers (``--steps``)
    of the package in ``parent`` (a checkout of another commit) and of this
    one, on this card in ``TURNS``, each run in its own process."""
    def child(mode, who):
        cmd = [sys.executable, __file__, mode] + (["--package", parent] if who == "parent" else [])
        proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise AssertionError(f"{who} {mode} run failed ({proc.returncode}):\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        return json.loads(proc.stdout.strip().splitlines()[-1])[mode[2:]]

    def line(key, vals):
        print(f"steps {key}: parent " + " / ".join(f"{x:.4f}" for x in vals["parent"]) + ", this commit " + " / ".join(f"{x:.4f}" for x in vals["this"])
              + f" (in turns: {', '.join(TURNS)})")

    rows = [(who, child("--rows", who)) for who in TURNS]
    for key in rows[0][1]:
        line(f"rnnt_logprobs {key}", {w: [r[key] for who, r in rows if who == w] for w in ("parent", "this")})
    runs = []
    for who in TURNS:
        runs.append((who, child("--steps", who)))
        print(f"steps host_top ({who}, flagship auto step, ms of self CPU time in one step, calls): "
              + "; ".join(f"{name} {ms:.2f} ({n})" for name, ms, n in runs[-1][1].pop("host_top")))
    for key in runs[0][1]:
        if isinstance(runs[0][1][key], dict):  # device ms in the profiled step by port kernel; a name one commit lacks counts 0
            names = sorted({n for _, r in runs for n in r[key]})
            for n in names:
                line(f"{key} {n}", {w: [r[key].get(n, 0.0) for who, r in runs if who == w] for w in ("parent", "this")})
            continue
        line(key, {w: [r[key] for who, r in runs if who == w] for w in ("parent", "this")})


JAX_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data", "jax_orbax_conformer_t")
PER_REQUEST_JAX_FIXTURE = _per(log_mel_spectrogram=1, fused_rel_attention=1, fused_ff=2, conv_front=1, conv_back=1, fused_decode=1)  # its one block
JAX_FIXTURE_ATOL = 2e-3  # of max(1, the recorded encoder output's largest magnitude)
JAX_READS = 5


def phase_jax_checkpoint(dev) -> dict:
    """A model that the JAX package wrote (``tests/data/jax_orbax_conformer_t``:
    its ``save`` command's orbax OCDBT directory, zstd-coded, and the encoder
    output and greedy tokens that JAX computed on the CPU for a seeded 2 × 1 s
    batch) read by the port and served in f32 on the card through the entry
    points a user calls: the native zstd decoder's build, the read (array
    bytes over the read's wall, JAX_READS reads, and the decoder's own bytes
    out over its time), ``common.build_model`` and ``common.load_weights``
    with ``--checkpoint`` the JAX directory, then ``recognize`` (one frontend,
    the block's encoder kernels, one ``fused_decode``). The tokens must equal
    JAX's and the encoder output lie within JAX_FIXTURE_ATOL of max(1, scale)
    of JAX's. Returns the request's launch counts."""
    import types

    from tensorflowasr_tpu_torch import pipeline, schemas
    from tensorflowasr_tpu_torch.convert import orbax
    from tensorflowasr_tpu_torch.models.transducer.base import recognize
    from tensorflowasr_tpu_torch.native import zstd
    from tensorflowasr_tpu_torch.scripts import common

    t0 = time.perf_counter()
    zstd.lib()
    built = time.perf_counter() - t0
    decoded = {"bytes": 0, "s": 0.0}

    def counted(data: bytes) -> bytes:
        t = time.perf_counter()
        out = zstd.zstd_decode(data)
        decoded["s"] += time.perf_counter() - t
        decoded["bytes"] += len(out)
        return out

    orbax.zstd_decode = counted
    try:
        walls = []
        for _ in range(JAX_READS):
            t = time.perf_counter()
            tree = orbax.read_checkpoint(JAX_FIXTURE)
            walls.append(time.perf_counter() - t)
    finally:
        orbax.zstd_decode = zstd.zstd_decode

    def leaves(node):
        for v in node.values():
            yield from (leaves(v) if isinstance(v, dict) else [v])

    arrays = list(leaves(tree))
    nbytes = sum(a.nbytes for a in arrays)
    read_s = float(np.median(walls))
    print(f"jax checkpoint read ({os.path.relpath(JAX_FIXTURE)}): {len(arrays)} arrays, {nbytes} bytes, native zstd decoder built or loaded in {built:.2f} s; "
          f"read median {read_s * 1e3:.2f} ms of {JAX_READS} ({nbytes / read_s / 1e6:.1f} MB/s of arrays); zstd {decoded['bytes'] // JAX_READS} bytes out a read "
          f"at {decoded['bytes'] / decoded['s'] / 1e6:.1f} MB/s (host CPU)")

    config = pipeline.load_config(os.path.join(JAX_FIXTURE, "config.yml.j2"), training=False)
    tokenizer = pipeline.build_tokenizer(config)
    args = types.SimpleNamespace(device=str(dev), checkpoint=JAX_FIXTURE)
    model = common.load_weights(common.build_model(config, tokenizer, args), args)
    expected = np.load(os.path.join(JAX_FIXTURE, "expected.npz"))
    sig = torch.tensor(expected["pcm"].astype(np.float32) / 32768.0, device=dev)
    lens = torch.tensor(expected["lengths"], dtype=torch.int64, device=dev)
    with torch.inference_mode():
        recognize(model, schemas.PredictInput(inputs=sig, inputs_length=lens))  # warm-up
        torch.cuda.synchronize()
        reset_launch_counts()
        t = time.perf_counter()
        out = recognize(model, schemas.PredictInput(inputs=sig, inputs_length=lens))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = launch_counts()
        enc, enc_len, _ = model.encode(sig, lens)
    if counts != PER_REQUEST_JAX_FIXTURE:
        raise AssertionError(f"jax checkpoint request launched {_launched(counts)}, expected {_launched(PER_REQUEST_JAX_FIXTURE)}")
    tokens = out.tokens.cpu().numpy()
    if tokens.shape != expected["tokens"].shape or not np.array_equal(tokens, expected["tokens"]):
        raise AssertionError(f"jax checkpoint: tokens differ from JAX's recorded ones\n{tokens}\n{expected['tokens']}")
    if not np.array_equal(enc_len.cpu().numpy(), expected["encoded_length"]):
        raise AssertionError("jax checkpoint: encoder lengths differ from JAX's")
    ref = torch.tensor(expected["encoded"])
    err = float((enc.cpu() - ref).abs().max())
    tol = JAX_FIXTURE_ATOL * max(1.0, float(ref.abs().max()))
    if not err <= tol:
        raise AssertionError(f"jax checkpoint: encoder output {err:.3e} from JAX's (tol {tol:.3e})")
    print(f"jax checkpoint serve (f32, batch 2 × 1 s, the card's kernels): tokens equal to JAX's {tokens.shape}, encoder max_abs_err {err:.3e} "
          f"(tol {tol:.3e}), request {wall * 1e3:.2f} ms, launches {_launched(counts)}")
    return {"jax_checkpoint": counts}


def main(argv: list[str]) -> int:
    """No arguments: every phase (the check). ``--steps [--package DIR]``: only
    :func:`phase_steps`, of the package under DIR when given, as one JSON line.
    ``--fit-gc``: only :func:`fit_gc_child`, as one JSON line.
    ``--gc-probe``: only :func:`gc_probe_child`, as one JSON line.
    ``--rows [--package DIR]``: only :func:`rows_child`, as one JSON line.
    ``--recipe``: only :func:`phase_recipe`, its launch counts as one JSON line.
    ``--data``: only :func:`phase_data`, its launch counts as one JSON line.
    ``--cli``: only :func:`phase_cli`, its launch counts as one JSON line.
    ``--cli-child ROOT``: only :func:`cli_child` on the programs under ROOT, as one JSON line.
    ``--ctc-family``: only :func:`family_kernels`, :func:`phase_ctc_family`
    and :func:`phase_ctc_family_parity`, the sub-entries and launch counts as one JSON line.
    ``--transducers``: only :func:`transducer_kernels`, :func:`phase_transducers`,
    :func:`phase_beam`, :func:`phase_transducer_parity` and :func:`phase_ctc_referee`,
    the sub-entries and launch counts as one JSON line.
    ``--parallel``: only :func:`phase_parallel`, its launch counts as one JSON line.
    ``--layers``: only :func:`phase_layers` (with :func:`layers_kernels`), the sub-entries and launch counts as one JSON line.
    ``--jax-checkpoint``: only :func:`phase_jax_checkpoint`, its launch counts as one JSON line.
    ``--compare-parent DIR``: :func:`compare_steps` against the package under DIR."""
    _need_card()
    if "--package" in argv:
        sys.path.insert(0, argv[argv.index("--package") + 1])
    from tensorflowasr_tpu_torch.ops.cuda import _build  # fails here when the package is absent, before any output

    if "--fit-gc" in argv:
        _no_tf32()
        print(json.dumps({"fit_gc": fit_gc_child(torch.device("cuda", 0))}))
        return 0
    if "--gc-probe" in argv:
        _no_tf32()
        print(json.dumps({"gc_probe": gc_probe_child(torch.device("cuda", 0))}))
        return 0
    if "--steps" in argv:
        _no_tf32()
        print(json.dumps({"steps": phase_steps(torch.device("cuda", 0)), "package": str(_build.CSRC.parent)}))
        return 0
    if "--rows" in argv:
        _no_tf32()
        print(json.dumps({"rows": rows_child(torch.device("cuda", 0)), "package": str(_build.CSRC.parent)}))
        return 0
    if "--compare-parent" in argv:
        compare_steps(argv[argv.index("--compare-parent") + 1])
        return 0
    if "--recipe" in argv:
        _no_tf32()
        _build.build()
        print(json.dumps({"recipe": phase_recipe(torch.device("cuda", 0))}))
        return 0
    if "--cli-child" in argv:
        _no_tf32()
        print(json.dumps({"cli_child": cli_child(torch.device("cuda", 0), argv[argv.index("--cli-child") + 1])}))
        return 0
    if "--cli" in argv:
        _no_tf32()
        _build.build()
        print(json.dumps({"cli": phase_cli(torch.device("cuda", 0))}))
        return 0
    if "--parallel" in argv:
        _no_tf32()
        _build.build()  # here, before any rank is spawned: two ranks building into _build/ at once would race
        print(json.dumps({"parallel": phase_parallel(torch.device("cuda", 0))}))
        return 0
    if "--layers" in argv:
        _no_tf32()
        _build.build()
        rows = [{"name": name} for name in KERNELS]
        paths = phase_layers(torch.device("cuda", 0), rows)
        print(json.dumps({"layers": paths, "rows": [r for r in rows if len(r) > 1]}))
        return 0
    if "--jax-checkpoint" in argv:
        _no_tf32()
        _build.build()
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, check=True).stdout.strip())
        print(json.dumps({"jax_checkpoint": phase_jax_checkpoint(torch.device("cuda", 0))}))
        return 0
    if "--data" in argv:
        _no_tf32()
        _build.build()
        paths, checks = phase_data(torch.device("cuda", 0))
        print(json.dumps({"data": paths, "checks": checks}))
        return 0
    if "--ctc-family" in argv:
        _no_tf32()
        _build.build()
        dev = torch.device("cuda", 0)
        rows = [{"name": name} for name in KERNELS]
        family_kernels(dev, rows)
        paths = phase_ctc_family(dev)
        phase_ctc_family_parity(dev)
        print(json.dumps({"ctc_family": paths, "rows": [r for r in rows if len(r) > 1]}))
        return 0
    if "--transducers" in argv:
        _no_tf32()
        _build.build()
        dev = torch.device("cuda", 0)
        rows = [{"name": name} for name in KERNELS]
        transducer_kernels(dev, rows)
        paths = phase_transducers(dev)
        paths.update(phase_beam(dev))
        phase_transducer_parity(dev)
        phase_ctc_referee(dev)
        print(json.dumps({"transducers": paths, "rows": [r for r in rows if len(r) > 1]}))
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

    marks = [("build", time.perf_counter())]

    def mark(name: str) -> None:
        marks.append((name, time.perf_counter()))

    serve_kernels = phase_kernels(dev)
    rows = phase_train_kernels(dev) + phase_lstm_kernels(dev)
    rows += phase_ctc_kernels(dev, rows)
    rows.append(phase_decode_kernel(dev))
    mark("kernels")
    family_kernels(dev, rows)
    mark("family kernels")
    transducer_kernels(dev, rows)
    mark("transducer kernels")
    paths = {"serve": phase_serve(dev)}
    paths.update(phase_streaming(dev))
    train_paths, auto = phase_train(dev)
    paths.update(train_paths)
    paths["eval"] = phase_eval(dev)
    paths.update(phase_pallas(dev, auto))
    mark("flagship paths")
    paths.update(phase_ctc_serve(dev))
    paths.update(phase_ctc_train(dev))
    mark("ctc paths")
    paths.update(phase_ctc_family(dev))
    mark("ctc family")
    paths.update(phase_transducers(dev))
    mark("transducers")
    paths.update(phase_beam(dev))
    mark("beam")
    paths.update(phase_recipe(dev))
    mark("recipe")
    data_paths, data_checks = phase_data(dev)
    paths.update(data_paths)
    rows.append(data_checks.pop("rnnt_logprobs_scalar"))
    for row in rows:
        if row["name"] in data_checks:
            row["data_v29"] = data_checks[row["name"]]
    next(row for row in rows if row["name"] == "fused_decode")["data_v29_overfit"] = data_checks["fused_decode_overfit"]
    mark("data")
    paths.update(phase_cli(dev))
    mark("cli")
    paths.update(phase_parallel(dev))
    mark("parallel")
    paths.update(phase_layers(dev, rows))
    mark("layers")
    paths.update(phase_jax_checkpoint(dev))
    mark("jax checkpoint")
    phase_fit_gc()
    phase_gc_probe()
    mark("gc")
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
    phase_ctc_family_parity(dev)
    phase_transducer_parity(dev)
    phase_stream_parity(dev)
    mark("parity")
    phase_ctc_referee(dev)
    mark("referee")
    print("phase walls: " + ", ".join(f"{name} {t - marks[i][1]:.1f} s" for i, (name, t) in enumerate(marks[1:])))
    print(f"gc watch: {GC_WATCH['watched']} timed steps and requests watched (gc.collect() and gc.freeze() after each phase's set-up and "
          f"warm-up); gen-2 collections inside them: {GC_WATCH['gen2']} ({GC_WATCH['gen2_ms']:.1f} ms)")
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    print(smi.splitlines()[0])
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
