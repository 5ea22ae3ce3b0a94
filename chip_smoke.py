"""Chip smoke test of the PyTorch port's serving path on one CUDA card.

Run from the repository root on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

Phases, each printing one line: device; kernel build (nvcc, from
``tensorflowasr_tpu_torch/csrc``); each kernel against its plain PyTorch
version at the flagship shapes (f32 with TF32 off, and bf16), with times;
three served requests of 8 utterances through ``recognize`` on the
flagship Conformer-Transducer Small (random weights from a seed, bf16
compute), with the kernels' launch counts; f32 encoder parity between the
card (kernels) and a CPU copy (plain versions). Any failure raises. The
last two lines are the kernels' JSON summary and
``{"ok": true, "device": {...}}``. Without a card it exits non-zero.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
WARMUP, ITERS = 3, 20


def _need_card() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test runs on a CUDA card", file=sys.stderr)
        sys.exit(2)


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def time_ms(fn, *args) -> float:
    """Mean device time of ``fn(*args)`` over ITERS launches (CUDA events, after warm-up)."""
    for _ in range(WARMUP):
        fn(*args)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(ITERS):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def _close(name: str, got: torch.Tensor, ref: torch.Tensor, atol: float, rtol: float) -> float:
    got, ref = got.float(), ref.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got - ref).abs()
    bad = err > atol + rtol * ref.abs()
    if bad.any():
        raise AssertionError(f"{name}: max abs err {err.max().item()} exceeds atol {atol} + rtol {rtol}·|ref| at {int(bad.sum())} elements")
    return err.max().item()


def _randn(gen, shape, scale=1.0, dtype=torch.float32, dev="cuda"):
    return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)


# Tolerances. f32 (TF32 off): kernel and plain differ only in summation
# order (~1e-6 relative), so 1e-4 absolute on unit-scale outputs. bf16: a
# summation-order difference can flip the bf16 rounding of an operand or
# of the output by one ulp (2^-8 relative), so atol 0.02 + rtol 0.02. The
# log-mel frontend is f32 only: direct DFT vs FFT, 1e-3 absolute in log.
TOL = {"f32": (1e-4, 1e-4), "bf16": (2e-2, 2e-2)}


def phase_kernels(dev) -> list[dict]:
    from tensorflowasr_tpu_torch.ops import frontend
    from tensorflowasr_tpu_torch.ops.cuda import attention_kernel as ak
    from tensorflowasr_tpu_torch.ops.cuda import conv_kernel as ck
    from tensorflowasr_tpu_torch.ops.cuda import ff_kernel as fk
    from tensorflowasr_tpu_torch.ops.cuda import frontend_kernel as fek

    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = []

    # frontend: B=8 utterances of 10 s at 16 kHz
    cfg = frontend.FrontendConfig()
    sig = frontend.preemphasis_signal(_randn(gen, (8, 160000), 0.1), cfg).contiguous()
    got = fek.log_mel_spectrogram_pallas(sig, cfg)
    ref = fek.log_mel_spectrogram_plain(sig, cfg)
    err = _close("frontend f32", got, ref, 1e-3, 0.0)
    ms, plain_ms = time_ms(fek.log_mel_spectrogram_pallas, sig, cfg), time_ms(fek.log_mel_spectrogram_plain, sig, cfg)
    print(f"kernel frontend: shape {tuple(got.shape)} f32 max_abs_err {err:.3e} (tol 1e-3) kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
    rows.append(dict(name="log_mel_spectrogram", route="cuda", source="tensorflowasr_tpu_torch/csrc/frontend.cu",
                     replaces="tensorflowasr_tpu/ops/pallas/frontend_kernel.py:80", max_abs_err=err, ms=ms, plain_ms=plain_ms, dtype="float32"))

    # attention: B·H = 32, T = S = 250, R = 499, dh = 36; q_len < T on some rows
    b, h, t, d = 8, 4, 250, 36
    q_len = torch.tensor([250, 250, 240, 200, 180, 150, 250, 160], dtype=torch.int32, device=dev)
    cases = {
        "flagship": dict(s=t, r=2 * t - 1, kv_bias=None, chunk=None, hist=None),
        "chunked": dict(s=t + 64, r=64 + 2 * t - 1, kv_bias=True, chunk=16, hist=64),
    }
    att = {}
    for case, c in cases.items():
        for tag, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            qc, qp = _randn(gen, (b * h, t, d), 0.3, dt), _randn(gen, (b * h, t, d), 0.3, dt)
            k, v = _randn(gen, (b * h, c["s"], d), 1.0, dt), _randn(gen, (b * h, c["s"], d), 1.0, dt)
            pos = _randn(gen, (b * h, c["r"], d), 1.0, dt)
            kvb = None
            if c["kv_bias"]:
                mem_valid = torch.arange(c["s"], device=dev)[None, :] >= torch.tensor([0, 10, 30, 64, 0, 5, 64, 20], device=dev)[:, None]
                kvb = torch.where(mem_valid, 0.0, -1e9).float()[:, None, :].contiguous()
            args = (qc, qp, k, v, pos, kvb, q_len, 0, 0.0, False, c["chunk"], c["hist"], False)
            got, ref = ak.fused_rel_attention(*args), ak.fused_rel_attention_plain(*args)
            err = _close(f"attention {case} {tag}", got, ref, *TOL[tag])
            ms, plain_ms = time_ms(ak.fused_rel_attention, *args), time_ms(ak.fused_rel_attention_plain, *args)
            print(f"kernel rel_attention {case} {tag}: BH {b*h} T {t} S {c['s']} R {c['r']} dh {d} max_abs_err {err:.3e} (tol {TOL[tag]}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
            att[(case, tag)] = (err, ms, plain_ms)
    e32, _, _ = att[("flagship", "f32")]
    e16, ms, plain_ms = att[("flagship", "bf16")]
    rows.append(dict(name="fused_rel_attention", route="cuda", source="tensorflowasr_tpu_torch/csrc/rel_attention.cu",
                     replaces="tensorflowasr_tpu/ops/pallas/attention_kernel.py:453", max_abs_err=e32, max_abs_err_bf16=e16,
                     max_abs_err_chunked_bf16=att[("chunked", "bf16")][0], ms=ms, plain_ms=plain_ms, dtype="bfloat16"))

    # FF: N = 8·250 rows, 144 → 576 → 144
    n, dm, f = 8 * 250, 144, 576
    ffres = {}
    for tag, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        x = _randn(gen, (n, dm), 1.0, dt)
        gamma, beta = 1.0 + _randn(gen, (dm,), 0.1), _randn(gen, (dm,), 0.1)
        w1, b1 = _randn(gen, (dm, f), dm ** -0.5, dt), _randn(gen, (f,), 0.1, dt)
        w2, b2 = _randn(gen, (f, dm), f ** -0.5, dt), _randn(gen, (dm,), 0.1, dt)
        args = (x, gamma, beta, w1, b1, w2, b2, 0, 0.0, 0.5, 1e-3)
        got, ref = fk.fused_ff(*args), fk.fused_ff_plain(*args)
        err = _close(f"ff {tag}", got, ref, *TOL[tag])
        ms, plain_ms = time_ms(fk.fused_ff, *args), time_ms(fk.fused_ff_plain, *args)
        print(f"kernel fused_ff {tag}: N {n} D {dm} F {f} max_abs_err {err:.3e} (tol {TOL[tag]}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
        ffres[tag] = (err, ms, plain_ms)
    rows.append(dict(name="fused_ff", route="cuda", source="tensorflowasr_tpu_torch/csrc/ff.cu", replaces="tensorflowasr_tpu/ops/pallas/ff_kernel.py:189",
                     max_abs_err=ffres["f32"][0], max_abs_err_bf16=ffres["bf16"][0], ms=ffres["bf16"][1], plain_ms=ffres["bf16"][2], dtype="bfloat16"))

    # conv module halves: [8, 250, 144]
    front, back = {}, {}
    for tag, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        x = _randn(gen, (8, 250, dm), 1.0, dt)
        gamma, beta = 1.0 + _randn(gen, (dm,), 0.1), _randn(gen, (dm,), 0.1)
        wa, wb = _randn(gen, (dm, dm), dm ** -0.5, dt), _randn(gen, (dm, dm), dm ** -0.5, dt)
        ba, bb = _randn(gen, (dm,), 0.1, dt), _randn(gen, (dm,), 0.1, dt)
        args = (x, gamma, beta, wa, ba, wb, bb, 1e-3)
        got, ref = ck.conv_front(*args), ck.conv_front_plain(*args)
        err = _close(f"conv_front {tag}", got, ref, *TOL[tag])
        front[tag] = (err, time_ms(ck.conv_front, *args), time_ms(ck.conv_front_plain, *args))
        y1 = _randn(gen, (8, 250, dm), 1.0, dt)
        mean, var = _randn(gen, (dm,), 0.1), 1.0 + torch.rand((dm,), generator=gen, device=dev)
        scale, bias = 1.0 + _randn(gen, (dm,), 0.1), _randn(gen, (dm,), 0.1)
        w2, b2 = _randn(gen, (dm, dm), dm ** -0.5, dt), _randn(gen, (dm,), 0.1, dt)
        args = (x, y1, mean, var, scale, bias, w2, b2, 0, 0.0, 1.0, 1e-3)
        got, ref = ck.conv_back(*args), ck.conv_back_plain(*args)
        err = _close(f"conv_back {tag}", got, ref, *TOL[tag])
        back[tag] = (err, time_ms(ck.conv_back, *args), time_ms(ck.conv_back_plain, *args))
        print(f"kernel conv_front {tag}: [8, 250, {dm}] max_abs_err {front[tag][0]:.3e} kernel {front[tag][1]:.4f} ms plain {front[tag][2]:.4f} ms; "
              f"conv_back {tag}: max_abs_err {back[tag][0]:.3e} kernel {back[tag][1]:.4f} ms plain {back[tag][2]:.4f} ms (tol {TOL[tag]})")
    rows.append(dict(name="conv_front", route="cuda", source="tensorflowasr_tpu_torch/csrc/conv_module.cu", replaces="tensorflowasr_tpu/ops/pallas/conv_kernel.py:160",
                     max_abs_err=front["f32"][0], max_abs_err_bf16=front["bf16"][0], ms=front["bf16"][1], plain_ms=front["bf16"][2], dtype="bfloat16"))
    rows.append(dict(name="conv_back", route="cuda", source="tensorflowasr_tpu_torch/csrc/conv_module.cu", replaces="tensorflowasr_tpu/ops/pallas/conv_kernel.py:329",
                     max_abs_err=back["f32"][0], max_abs_err_bf16=back["bf16"][0], ms=back["bf16"][1], plain_ms=back["bf16"][2], dtype="bfloat16"))
    return rows


# launches per served request of the 16-block flagship: frontend once, one
# attention per block, two FF modules per block, one conv module per block
PER_REQUEST = {"log_mel_spectrogram": 1, "fused_rel_attention": 16, "fused_ff": 32, "conv_front": 16, "conv_back": 16}


def launch_counts() -> dict:
    from tensorflowasr_tpu_torch.ops.cuda import attention_kernel, conv_kernel, ff_kernel, frontend_kernel

    return {"log_mel_spectrogram": frontend_kernel.launches, "fused_rel_attention": attention_kernel.launches, "fused_ff": ff_kernel.launches,
            "conv_front": conv_kernel.front_launches, "conv_back": conv_kernel.back_launches}


def reset_launch_counts() -> None:
    from tensorflowasr_tpu_torch.ops.cuda import attention_kernel, conv_kernel, ff_kernel, frontend_kernel

    frontend_kernel.launches = attention_kernel.launches = ff_kernel.launches = 0
    conv_kernel.front_launches = conv_kernel.back_launches = 0


def flagship(dtype) -> torch.nn.Module:
    from tensorflowasr_tpu_torch.models.transducer.conformer import Conformer, conformer_small_config

    model = Conformer.from_config(conformer_small_config(), dtype=dtype)
    model.reset_parameters(torch.Generator().manual_seed(SEED))
    return model.eval()


def make_request(rng, batch: int, lo_s: float, hi_s: float, dev):
    lens = rng.integers(int(lo_s * 16000), int(hi_s * 16000) + 1, size=batch)
    audio = (rng.standard_normal((batch, int(lens.max()))) * 0.1).astype(np.float32)
    audio[np.arange(audio.shape[1])[None, :] >= lens[:, None]] = 0.0
    return torch.tensor(audio, device=dev), torch.tensor(lens, device=dev)


def phase_serve(dev) -> dict:
    from tensorflowasr_tpu_torch import schemas
    from tensorflowasr_tpu_torch.models.transducer.base import recognize
    from tensorflowasr_tpu_torch.ops import transducer_decode

    model = flagship(torch.bfloat16).to(dev)
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


def phase_parity(dev) -> None:
    import copy

    model = flagship(torch.float32)
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


# f32 encoder, card vs CPU: summation-order differences (~1e-6 per op)
# compound over 16 blocks; the LayerNorm'd outputs are of unit scale.
PARITY_ATOL = 2e-3


def main() -> int:
    _need_card()
    from tensorflowasr_tpu_torch.ops.cuda import _build  # fails here when the package is absent, before any output

    _no_tf32()
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, check=True).stdout.strip()
    print(f"device: {name}; count {torch.cuda.device_count()}; torch {torch.__version__} cuda {torch.version.cuda}; TF32 off (matmul and cuDNN)")
    print(smi.splitlines()[0])

    _build.build()
    print(f"build: {_build.build_seconds:.2f} s (nvcc, {len(_build.SOURCES)} sources, one call)")

    rows = phase_kernels(dev)
    counts = phase_serve(dev)
    for row in rows:
        row["launches"] = counts[row["name"]]
    phase_parity(dev)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
