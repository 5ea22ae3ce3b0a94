"""Chip smoke test of the PyTorch port on one CUDA card: serving and training.

Run from the repository root on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

Phases, each printing its lines: device; kernel build (nvcc, from
``tensorflowasr_tpu_torch/csrc``); each forward kernel against its plain
PyTorch version at the serving shapes (f32 with TF32 off, and bf16), with
times; each forward kernel at rate 0.1 and each backward kernel against its
plain version at the flagship training shapes (f32 and bf16), with times
and bounds, and the loss kernels (the RNN-T DP, the fused joint forward and
backward) at the flagship loss shapes (B 16, T 400, U+1 129, J 320, V 256,
ragged lengths); three served requests of 8 utterances through
``recognize`` on the flagship Conformer-Transducer Small (random weights
from a seed, bf16 compute), with the kernels' launch counts; six training
steps of the flagship in the default configuration (``loss_impl="auto"``:
the fused joint+loss; bf16, dropout 0.1, Adam 1e-4, 16 utterances of up to
16 s, one fixed batch) through ``Trainer.train_step``, with per-step times,
loss, gradient norm, peak memory and launch counts, and one profiled step
for the card's busy share; two steps of the ``loss_impl="xla"``
configuration (logits and the plain DP) with their own launch counts; f32
encoder parity and f32 training-step parity (loss and every gradient)
between the card (kernels) and a CPU copy (plain versions), and the f32
fused-path loss against the ``xla``-path loss on the card. Any failure
raises. The last two lines are the kernels' JSON
summary and ``{"ok": true, "device": {...}}``. Without a card it exits
non-zero.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time

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


def cost_joint(b: int, t: int, u1: int, j: int, v: int, elt: int, bwd: bool):
    """fwd: enc_p, pred_p, Wv, bv, labels → lse, lp_blank, lp_emit; the vocab
    product, add + tanh per (cell, j), ~3 per logit for the log-sum-exp.
    bwd: + lse, gbl, gem → d_enc_p, d_pred_p and f32 dWv, dbv; three products
    (the logits, da, dWv) and ~5 per logit for d_logits."""
    cells = b * t * u1
    params = v * j * elt + 4 * v
    inputs = (b * t + b * u1) * j * elt + params + 4 * b * (u1 - 1)
    if bwd:
        return inputs + 12 * cells + (b * t + b * u1) * j * elt + 4 * (v * j + v), 6.0 * cells * j * v + 2.0 * cells * j + 5.0 * cells * v
    return inputs + 12 * cells, 2.0 * cells * j * v + 2.0 * cells * j + 3.0 * cells * v


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
    "fused_rel_attention": ("tensorflowasr_tpu_torch/csrc/rel_attention.cu", "tensorflowasr_tpu/ops/pallas/attention_kernel.py:453"),
    "fused_rel_attention_bwd": ("tensorflowasr_tpu_torch/csrc/rel_attention.cu", "tensorflowasr_tpu/ops/pallas/attention_kernel.py:588"),
    "fused_ff": ("tensorflowasr_tpu_torch/csrc/ff.cu", "tensorflowasr_tpu/ops/pallas/ff_kernel.py:189"),
    "fused_ff_bwd": ("tensorflowasr_tpu_torch/csrc/ff.cu", "tensorflowasr_tpu/ops/pallas/ff_kernel.py:229"),
    "conv_front": ("tensorflowasr_tpu_torch/csrc/conv_module.cu", "tensorflowasr_tpu/ops/pallas/conv_kernel.py:160"),
    "conv_front_bwd": ("tensorflowasr_tpu_torch/csrc/conv_module.cu", "tensorflowasr_tpu/ops/pallas/conv_kernel.py:194"),
    "conv_back": ("tensorflowasr_tpu_torch/csrc/conv_module.cu", "tensorflowasr_tpu/ops/pallas/conv_kernel.py:329"),
    "conv_back_bwd": ("tensorflowasr_tpu_torch/csrc/conv_module.cu", "tensorflowasr_tpu/ops/pallas/conv_kernel.py:375"),
    "rnnt_dp": ("tensorflowasr_tpu_torch/csrc/rnnt_dp.cu", "tensorflowasr_tpu/ops/pallas/rnnt_kernel.py:310"),
    "rnnt_fused_joint": ("tensorflowasr_tpu_torch/csrc/joint_loss.cu", "tensorflowasr_tpu/ops/pallas/joint_loss_kernel.py:351"),
    "rnnt_fused_joint_bwd": ("tensorflowasr_tpu_torch/csrc/joint_loss.cu", "tensorflowasr_tpu/ops/pallas/joint_loss_kernel.py:329"),
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
              f"bound {bf[0]:.4f} ms ({bf[1]}); conv_back {tag}: max_abs_err {back[tag][0]:.3e} kernel {back[tag][1]:.4f} ms plain {back[tag][2]:.4f} ms "
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


def _check_fwd_bwd(name, fwd, fwd_plain, bwd, bwd_plain, make, cost, what: str = f"train, rate {TRAIN_RATE}") -> list[dict]:
    """Forward (rate 0.1: the kernel's mask equals the plain one) and backward
    kernel vs plain at one shape, f32 and bf16; times and bounds in bf16.
    ``cost(elt, bwd)`` gives the (bytes, operations) of the work."""
    errs_f, errs_b, times = {}, {}, {}
    for tag, dt in DTYPES:
        fargs, bargs = make(dt)
        errs_f[tag] = _close(f"{name} fwd {tag} ({what})", fwd(*fargs), fwd_plain(*fargs), *TOL[tag])
        errs_b[tag] = _grads_close(f"{name} bwd {tag} ({what})", bwd(*bargs), bwd_plain(*bargs), GRAD_REL[tag])
        if tag == "bf16":
            times = dict(fwd=(time_ms(fwd, *fargs), time_ms(fwd_plain, *fargs)), bwd=(time_ms(bwd, *bargs), time_ms(bwd_plain, *bargs)))
            bounds = dict(fwd=bound(*cost(2, False), "bf16"), bwd=bound(*cost(2, True), "bf16"))
    rows = []
    for part, errs, row_name in (("fwd", errs_f, name), ("bwd", errs_b, f"{name}_bwd")):
        ms, plain_ms = times[part]
        b = bounds[part]
        print(f"kernel {row_name} ({what}): max_abs_err f32 {errs['f32']:.3e} bf16 {errs['bf16']:.3e} "
              f"(tol {TOL if part == 'fwd' else GRAD_REL}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound {b[0]:.4f} ms ({b[1]}) bf16")
        rows.append(_row(row_name, errs, ms, plain_ms, b))
    return rows


def phase_train_kernels(dev) -> list[dict]:
    """Every kernel of the training step at its flagship training shapes."""
    from tensorflowasr_tpu_torch.ops import frontend
    from tensorflowasr_tpu_torch.ops.cuda import attention_kernel as ak
    from tensorflowasr_tpu_torch.ops.cuda import conv_kernel as ck
    from tensorflowasr_tpu_torch.ops.cuda import ff_kernel as fk
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

    # attention: B·H = 64, T = S = 400, R = 799, dh 36; ragged query lengths
    bh, t, r = TRAIN_B * HEADS, T_ENC, 2 * T_ENC - 1
    q_len = torch.tensor([max(40, T_ENC - 23 * i) for i in range(TRAIN_B)], dtype=torch.int32, device=dev)

    def att_make(dt):
        qc, qp = _randn(gen, (bh, t, HEAD), 0.3, dt), _randn(gen, (bh, t, HEAD), 0.3, dt)
        k, v, pos = _randn(gen, (bh, t, HEAD), 1.0, dt), _randn(gen, (bh, t, HEAD), 1.0, dt), _randn(gen, (bh, r, HEAD), 1.0, dt)
        cfg_ = (11, TRAIN_RATE, False, None, None, False)
        out = ak.fused_rel_attention_kernel(qc, qp, k, v, pos, None, q_len, *cfg_)
        dout = _randn(gen, (bh, t, HEAD), 1.0, dt)
        return (qc, qp, k, v, pos, None, q_len, *cfg_), (qc, qp, k, v, pos, None, q_len, out, dout, *cfg_)

    def att_bwd_plain(qc, qp, k, v, pos, kvb, ql, out, dout, *cfg_):
        return ak.fused_rel_attention_plain_bwd(qc, qp, k, v, pos, kvb, ql, dout, *cfg_)

    rows += _check_fwd_bwd("fused_rel_attention", ak.fused_rel_attention_kernel, ak.fused_rel_attention_plain, ak.fused_rel_attention_bwd_kernel,
                           att_bwd_plain, att_make, lambda elt, bwd: cost_attention(bh, t, t, r, HEAD, elt, bwd))

    # FF: N = 16·400 rows, 144 → 576 → 144
    n = TRAIN_B * T_ENC

    def ff_make(dt):
        x = _randn(gen, (n, D_MODEL), 1.0, dt)
        gamma, beta = 1.0 + _randn(gen, (D_MODEL,), 0.1), _randn(gen, (D_MODEL,), 0.1)
        w1, b1 = _randn(gen, (D_MODEL, FF_DIM), D_MODEL ** -0.5, dt), _randn(gen, (FF_DIM,), 0.1, dt)
        w2, b2 = _randn(gen, (FF_DIM, D_MODEL), FF_DIM ** -0.5, dt), _randn(gen, (D_MODEL,), 0.1, dt)
        dout = _randn(gen, (n, D_MODEL), 1.0, dt)
        return (x, gamma, beta, w1, b1, w2, b2, 13, TRAIN_RATE, 0.5, 1e-3), (x, gamma, beta, w1, b1, w2, dout, 13, TRAIN_RATE, 0.5, 1e-3)

    rows += _check_fwd_bwd("fused_ff", fk.fused_ff_kernel, fk.fused_ff_plain, fk.fused_ff_bwd_kernel, fk.fused_ff_plain_bwd, ff_make,
                           lambda elt, bwd: cost_ff(n, D_MODEL, FF_DIM, elt, bwd))

    # conv module halves: [16, 400, 144]
    shape = (TRAIN_B, T_ENC, D_MODEL)

    def front_make(dt):
        x = _randn(gen, shape, 1.0, dt)
        p = (1.0 + _randn(gen, (D_MODEL,), 0.1), _randn(gen, (D_MODEL,), 0.1), _randn(gen, (D_MODEL, D_MODEL), D_MODEL ** -0.5, dt),
             _randn(gen, (D_MODEL,), 0.1, dt), _randn(gen, (D_MODEL, D_MODEL), D_MODEL ** -0.5, dt), _randn(gen, (D_MODEL,), 0.1, dt))
        return (x, *p, 1e-3), (x, *p, _randn(gen, shape, 1.0, dt), 1e-3)

    rows += _check_fwd_bwd("conv_front", ck.conv_front_kernel, ck.conv_front_plain, ck.conv_front_bwd_kernel, ck.conv_front_plain_bwd, front_make,
                           lambda elt, bwd: cost_conv_front(n, D_MODEL, elt, bwd))

    def back_make(dt):
        x, y1 = _randn(gen, shape, 1.0, dt), _randn(gen, shape, 1.0, dt)
        stats = (_randn(gen, (D_MODEL,), 0.1), 1.0 + torch.rand((D_MODEL,), generator=gen, device=dev), 1.0 + _randn(gen, (D_MODEL,), 0.1),
                 _randn(gen, (D_MODEL,), 0.1))
        w2, b2 = _randn(gen, (D_MODEL, D_MODEL), D_MODEL ** -0.5, dt), _randn(gen, (D_MODEL,), 0.1, dt)
        cfg_ = (17, TRAIN_RATE, 1.0, 1e-3)
        return (x, y1, *stats, w2, b2, *cfg_), (y1, *stats, w2, _randn(gen, shape, 1.0, dt), *cfg_)

    rows += _check_fwd_bwd("conv_back", ck.conv_back_kernel, ck.conv_back_plain, ck.conv_back_bwd_kernel, ck.conv_back_plain_bwd, back_make,
                           lambda elt, bwd: cost_conv_back(n, D_MODEL, elt, bwd))
    return rows + phase_loss_kernels(dev)


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
    """The loss kernels at the flagship loss shapes: the RNN-T DP (f32) and
    the fused joint forward and backward (f32 and bf16)."""
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

    def joint_make(dt):
        enc_p, pred_p = _randn(gen, (TRAIN_B, T_ENC, JOINT), 1.0, dt), _randn(gen, (TRAIN_B, u1, JOINT), 1.0, dt)
        wv, bv = _randn(gen, (VOCAB, JOINT), JOINT ** -0.5, dt), _randn(gen, (VOCAB,), 0.1)
        fargs = (enc_p, pred_p, wv, bv, labels)
        _, lse, gbl, gem = jk.rnnt_loss_fused_joint_plain(*fargs[:4], t_len, labels, u_len)
        return fargs, (*fargs, lse, gbl / TRAIN_B, gem / TRAIN_B)  # the masked mean's cotangent

    def stats(fn):
        return lambda *a: torch.stack(fn(*a))

    rows += _check_fwd_bwd("rnnt_fused_joint", stats(jk.joint_logprobs_kernel), stats(jk.joint_logprobs_plain), jk.rnnt_loss_fused_joint_bwd_kernel,
                           jk.rnnt_loss_fused_joint_plain_bwd, joint_make, lambda elt, bwd: cost_joint(TRAIN_B, T_ENC, u1, JOINT, VOCAB, elt, bwd),
                           what=f"train loss, [{TRAIN_B}, {T_ENC}, {u1}] cells, J {JOINT}, V {VOCAB}")
    return rows


# --------------------------------------- counts --------------------------------------- #

# launches per served request of the 16-block flagship: frontend once, one
# attention per block, two FF modules per block, one conv module per block;
# no backward kernel
PER_REQUEST = {"log_mel_spectrogram": 1, "fused_rel_attention": 16, "fused_rel_attention_bwd": 0, "fused_ff": 32, "fused_ff_bwd": 0,
               "conv_front": 16, "conv_front_bwd": 0, "conv_back": 16, "conv_back_bwd": 0, "rnnt_dp": 0, "rnnt_fused_joint": 0,
               "rnnt_fused_joint_bwd": 0}
# per default (auto) training step: the same forwards, each encoder kernel's
# backward once per forward, and the fused joint forward, the DP and the
# fused joint backward once each
PER_STEP = {"log_mel_spectrogram": 1, "fused_rel_attention": 16, "fused_rel_attention_bwd": 16, "fused_ff": 32, "fused_ff_bwd": 32,
            "conv_front": 16, "conv_front_bwd": 16, "conv_back": 16, "conv_back_bwd": 16, "rnnt_dp": 1, "rnnt_fused_joint": 1,
            "rnnt_fused_joint_bwd": 1}
# per xla step: the encoder's kernels; the loss is the plain DP over the logits
PER_STEP_XLA = {**PER_STEP, "rnnt_dp": 0, "rnnt_fused_joint": 0, "rnnt_fused_joint_bwd": 0}


def launch_counts() -> dict:
    from tensorflowasr_tpu_torch.ops.cuda import attention_kernel as ak, conv_kernel as ck, ff_kernel as fk, frontend_kernel as fek
    from tensorflowasr_tpu_torch.ops.cuda import joint_loss_kernel as jk, rnnt_kernel as rk

    return {"log_mel_spectrogram": fek.launches, "fused_rel_attention": ak.launches, "fused_rel_attention_bwd": ak.bwd_launches, "fused_ff": fk.launches,
            "fused_ff_bwd": fk.bwd_launches, "conv_front": ck.front_launches, "conv_front_bwd": ck.front_bwd_launches, "conv_back": ck.back_launches,
            "conv_back_bwd": ck.back_bwd_launches, "rnnt_dp": rk.launches, "rnnt_fused_joint": jk.launches, "rnnt_fused_joint_bwd": jk.bwd_launches}


def reset_launch_counts() -> None:
    from tensorflowasr_tpu_torch.ops.cuda import attention_kernel as ak, conv_kernel as ck, ff_kernel as fk, frontend_kernel as fek
    from tensorflowasr_tpu_torch.ops.cuda import joint_loss_kernel as jk, rnnt_kernel as rk

    fek.launches = ak.launches = ak.bwd_launches = fk.launches = fk.bwd_launches = 0
    ck.front_launches = ck.front_bwd_launches = ck.back_launches = ck.back_bwd_launches = 0
    rk.launches = jk.launches = jk.bwd_launches = 0


def flagship(dtype, device, num_blocks: int = 16, dropout: float = 0.1) -> torch.nn.Module:
    from tensorflowasr_tpu_torch.models.transducer.conformer import Conformer, conformer_small_config

    model = Conformer.from_config(conformer_small_config(num_blocks=num_blocks, dropout=dropout), dtype=dtype, device=device)
    model.reset_parameters(torch.Generator().manual_seed(SEED))
    return model


def make_request(rng, batch: int, lo_s: float, hi_s: float, dev):
    lens = rng.integers(int(lo_s * 16000), int(hi_s * 16000) + 1, size=batch)
    audio = (rng.standard_normal((batch, int(lens.max()))) * 0.1).astype(np.float32)
    audio[np.arange(audio.shape[1])[None, :] >= lens[:, None]] = 0.0
    return torch.tensor(audio, device=dev), torch.tensor(lens, device=dev)


def phase_serve(dev) -> dict:
    from tensorflowasr_tpu_torch import schemas
    from tensorflowasr_tpu_torch.models.transducer.base import recognize
    from tensorflowasr_tpu_torch.ops import transducer_decode

    model = flagship(torch.bfloat16, dev).eval()
    rng = np.random.default_rng(SEED)
    requests = [make_request(rng, 8, 6.0, 10.0, dev) for _ in range(3)]
    recognize(model, schemas.PredictInput(*make_request(rng, 8, 6.0, 10.0, dev)))  # warm-up request, not counted
    torch.cuda.synchronize()

    reset_launch_counts()
    walls = []
    for r, (audio, lens) in enumerate(requests):
        before = launch_counts()
        t0 = time.perf_counter()
        out = recognize(model, schemas.PredictInput(audio, lens))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
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

    # encode and decode timed apart, on the same requests (after the counted run)
    for r, (audio, lens) in enumerate(requests):
        with torch.inference_mode():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            enc, enc_len, _ = model.encode(audio, lens)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            states = model.init_decoder_states(8, dev)
            start = torch.zeros(8, dtype=torch.int64, device=dev)
            tokens, ntok, _, _ = transducer_decode.transducer_greedy_decode_wind(enc, enc_len, model.pred_step, model.joint_window, start, states)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        if not torch.isfinite(enc.float()).all():
            raise AssertionError(f"request {r}: non-finite encoder output")
        audio_s = lens.sum().item() / 16000.0
        print(f"serve request {r}: batch 8, audio {audio_s:.2f} s (max {audio.shape[1] / 16000:.2f} s), encoder frames {enc.shape[1]}, "
              f"recognize {walls[r] * 1e3:.3f} ms, encode {(t1 - t0) * 1e3:.3f} ms, decode {(t2 - t1) * 1e3:.3f} ms, "
              f"RTF {walls[r] / audio_s:.6f} (wall / audio seconds), tokens emitted mean {ntok.float().mean().item():.1f}")
    print(f"serve launches over 3 requests: {counts} (per request {PER_REQUEST}); bf16 compute, f32 params, TF32 off")
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


TRAIN_STEPS, XLA_STEPS = 6, 2


def run_train(dev, loss_impl: str, steps: int, per_step: dict, tag: str):
    """``steps`` flagship training steps through ``Trainer.train_step`` (bf16,
    dropout 0.1, Adam 1e-4, one fixed batch) with launch counts set to 0
    just before and read just after; each step's launches must equal
    ``per_step``. Returns (counts, losses, walls, trainer, state, batch)."""
    from tensorflowasr_tpu_torch.training.trainer import Trainer

    events = {}

    def mark(phase):
        events[phase] = torch.cuda.Event(enable_timing=True)
        events[phase].record()

    model = flagship(torch.bfloat16, dev, dropout=TRAIN_RATE)
    trainer = Trainer(model, {"class_name": "Adam", "config": {"learning_rate": 1e-4}}, device=dev, on_phase=mark, loss_impl=loss_impl)
    state = trainer.init_state(seed=SEED)
    batch = train_batch(np.random.default_rng(SEED + 2), TRAIN_B, TRAIN_SECS, TRAIN_U, model.vocab_size).to(dev)
    print(f"{tag} batch: {TRAIN_B} utterances, audio {batch.inputs.inputs_length.sum().item() / 16000:.2f} s "
          f"(lengths {batch.inputs.inputs_length.min().item() / 16000:.2f}-{batch.inputs.inputs_length.max().item() / 16000:.2f} s, array {TRAIN_SECS} s), "
          f"labels {batch.labels.labels_length.min().item()}-{batch.labels.labels_length.max().item()} (array {TRAIN_U}); loss_impl {loss_impl!r}")
    torch.cuda.synchronize()

    reset_launch_counts()
    losses, walls = [], []
    for step in range(steps):
        before = launch_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        start = torch.cuda.Event(enable_timing=True)
        start.record()
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
        print(f"{tag} step {step}: {wall:.1f} ms (host clock, ends in a synchronise); forward {fwd:.1f} ms, loss {los:.1f} ms, backward+update {upd:.1f} ms "
              f"(CUDA events); loss {loss:.4f} grad_norm {gnorm:.4f}; peak memory {peak:.0f} MiB")
        if not (np.isfinite(loss) and np.isfinite(gnorm)):
            raise AssertionError(f"{tag} step {step}: non-finite loss {loss} or grad_norm {gnorm}")
        losses.append(loss)
        walls.append(wall)
    counts = launch_counts()
    print(f"{tag} launches over {steps} steps: {counts} (per step {per_step})")
    return counts, losses, walls, trainer, state, batch


def phase_train(dev) -> dict:
    """The default (auto: fused joint+loss) flagship training step, 6 steps,
    then one profiled step; then 2 steps of the xla configuration."""
    counts, losses, walls, trainer, state, batch = run_train(dev, "auto", TRAIN_STEPS, PER_STEP, "train")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"training loss did not fall over {TRAIN_STEPS} steps: {losses}")

    # one more step under the profiler: the card's kernel time in a step, its
    # share of the unprofiled steps' median wall, and the kernels by time
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
    print(f"train profile: card kernel time {busy_ms:.1f} ms in one step ({len(kernels)} kernel names) → card busy {100 * busy_ms / steady:.1f}% of the "
          f"median unprofiled step ({steady:.1f} ms; {wall:.1f} ms under the profiler)")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:15]:
        print(f"  {e.self_device_time_total / 1e3:8.2f} ms  {e.count:6d} calls  {e.key[:100]}")
    del trainer, state

    # the xla configuration stays driven: logits and the plain DP
    _, xla_losses, _, _, _, _ = run_train(dev, "xla", XLA_STEPS, PER_STEP_XLA, "train xla")
    if abs(xla_losses[0] - losses[0]) > 1e-2 * abs(losses[0]):
        raise AssertionError(f"first step loss: xla {xla_losses[0]} vs auto {losses[0]} (bf16, same weights and batch)")
    return counts


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


def phase_train_parity(dev) -> None:
    """One f32 default (auto) training step's loss and gradients, card vs
    CPU, 2 blocks at full width, batch 2 × ≤ 4 s, dropout 0; and on the card
    the fused path's loss against the xla path's on the same batch."""
    from tensorflowasr_tpu_torch.ops.rnnt_loss import rnnt_loss_masked_mean
    from tensorflowasr_tpu_torch.training.trainer import fused_joint_loss

    cpu_model = flagship(torch.float32, "cpu", num_blocks=2, dropout=0.0)
    model = copy.deepcopy(cpu_model).to(dev)
    batch = train_batch(np.random.default_rng(SEED + 3), 2, 4.0, 32, cpu_model.vocab_size)
    results = []
    for m, b in ((model, batch.to(dev)), (cpu_model, batch)):
        loss = fused_joint_loss(m, b.inputs, b.labels)
        loss.backward()
        results.append((loss.item(), {n: p.grad.detach().cpu() for n, p in m.named_parameters()}))
    (loss_gpu, g_gpu), (loss_cpu, g_cpu) = results
    if not abs(loss_gpu - loss_cpu) <= 1e-4 * abs(loss_cpu):
        raise AssertionError(f"f32 train parity: loss card {loss_gpu} vs CPU {loss_cpu}")
    gmax = max(g.abs().max().item() for g in g_cpu.values())
    worst = worst_rel = (0.0, "")
    for name, ref in g_cpu.items():
        err, scale = (g_gpu[name] - ref).abs().max().item(), ref.abs().max().item()
        allowed = TRAIN_PARITY_REL * scale + TRAIN_PARITY_FLOOR * gmax
        if err > allowed:
            raise AssertionError(f"f32 train parity {name}: max abs err {err} > {TRAIN_PARITY_REL} x {scale} + {TRAIN_PARITY_FLOOR} x {gmax}")
        worst = max(worst, (err / allowed, name))
        if scale > TRAIN_PARITY_FLOOR * gmax:
            worst_rel = max(worst_rel, (err / scale, name))
    print(f"parity f32 train step (auto) card (kernels) vs CPU (plain): 2 blocks, batch 2 x <= 4 s; loss {loss_gpu:.6f} vs {loss_cpu:.6f}; "
          f"{len(g_cpu)} gradients within {TRAIN_PARITY_REL} of their scale + {TRAIN_PARITY_FLOOR} x {gmax:.3e} (largest share of that allowance "
          f"{worst[0]:.3f} at {worst[1]}; largest error relative to scale among gradients above the floor {worst_rel[0]:.3e} at {worst_rel[1]}), TF32 off")

    b = batch.to(dev)
    with torch.no_grad():
        out = model(b.inputs, train=True)
        xla = rnnt_loss_masked_mean(out.logits, out.logits_length, b.labels.labels, b.labels.labels_length).item()
        fused = fused_joint_loss(model, b.inputs, b.labels).item()
    if not abs(fused - xla) <= 1e-5 * abs(xla):
        raise AssertionError(f"f32 loss on the card: fused joint {fused} vs xla {xla}")
    print(f"parity f32 loss on the card, fused joint+loss (kernels) vs xla (logits, plain DP): {fused:.6f} vs {xla:.6f} "
          f"(rel {abs(fused - xla) / abs(xla):.2e}, tol 1e-5)")


def main() -> int:
    _need_card()
    from tensorflowasr_tpu_torch.ops.cuda import _build  # fails here when the package is absent, before any output

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
    rows = phase_train_kernels(dev)
    serve_counts = phase_serve(dev)
    train_counts = phase_train(dev)
    for row in rows:
        row["launches"] = train_counts[row["name"]]
        row["serve_launches"] = serve_counts[row["name"]]
        if row["name"] in serve_kernels:
            row["serve_ms"], row["serve_plain_ms"] = serve_kernels[row["name"]][2:]
        if row["launches"] == 0:
            raise AssertionError(f"{row['name']}: no launch on the training path")
    phase_parity(dev)
    phase_train_parity(dev)
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    print(smi.splitlines()[0])
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
