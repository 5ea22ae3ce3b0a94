"""Fused log-mel frontend kernel (``csrc/frontend.cu``).

Replaces ``tensorflowasr_tpu/ops/pallas/frontend_kernel.py``:
``log_mel_spectrogram_pallas`` (v1, XLA framing) and
``log_mel_spectrogram_pallas_v2`` (in-kernel framing) — this one kernel
frames in-kernel, so it is the counterpart of both.

What bounds it on the card: the DFT is ~0.8 MFLOP per frame (400 samples
× 257 bins × cos and sin), f32 on the CUDA cores, since the reference pins
its products to HIGHEST and TF32 would round the raw samples. The
[B·T, 400] framed signal (4× the audio, every sample in ~2.5 frames) is
the device-memory traffic the design removes: each block copies its
frames' samples from the signal by index arithmetic into shared memory,
keeps one (re, im) pair per frame and bin in registers while the windowed
bases stream from L2, and forms the power spectrum and mel product in
shared memory. Only the signal is read and only the features written.
"""

from __future__ import annotations

import numpy as np
import torch

from tensorflowasr_tpu_torch.ops import frontend
from tensorflowasr_tpu_torch.ops.cuda import _build

launches = 0  # kernel launches since the last reset (set to 0 to reset)

_BASES: dict = {}  # (device, frame_length, nfft, mel args) → device tensors


def _dft_bases(frame_length: int, nfft: int) -> tuple[np.ndarray, np.ndarray]:
    """Hann-windowed DFT bases [frame_length, nfft//2+1]: cos and -sin."""
    nbins = nfft // 2 + 1
    n = np.arange(frame_length)[:, None]
    ang = 2.0 * np.pi * n * np.arange(nbins)[None, :] / nfft
    window = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(frame_length) / frame_length)
    return (np.cos(ang) * window[:, None]).astype(np.float32), (-np.sin(ang) * window[:, None]).astype(np.float32)


def _device_constants(config: frontend.FrontendConfig, device: torch.device):
    nbins = config.fft_length // 2 + 1
    key = (device, config.frame_length, config.fft_length, config.num_feature_bins, config.sample_rate, config.lower_edge_hertz, config.upper_edge_hertz)
    if key not in _BASES:
        cos_b, sin_b = _dft_bases(config.frame_length, config.fft_length)
        mel = frontend.linear_to_mel_weight_matrix(config.num_feature_bins, nbins, config.sample_rate, config.lower_edge_hertz, config.upper_edge_hertz)
        _BASES[key] = tuple(torch.tensor(a, device=device) for a in (cos_b, sin_b, mel))
    return _BASES[key]


def _check_config(config: frontend.FrontendConfig) -> None:
    if config.use_librosa_like_stft or not config.pad_end or config.log_base != "e" or config.feature_type != "log_mel_spectrogram":
        raise ValueError("the fused frontend takes pad_end framing, natural log, log-mel features only")
    if config.fft_length < config.frame_length:
        raise ValueError("nfft must be at least frame_length")


def log_mel_spectrogram_plain(signal: torch.Tensor, config: frontend.FrontendConfig) -> torch.Tensor:
    """Plain PyTorch version: rfft framing chain of ``ops/frontend.py``."""
    _check_config(config)
    return frontend.log_mel_spectrogram(signal, config)


def log_mel_spectrogram_pallas(signal: torch.Tensor, config: frontend.FrontendConfig) -> torch.Tensor:
    """[B, N] f32 (preemphasised) → [B, T, num_feature_bins] f32 log-mel,
    T = ceil(N / frame_step). A CUDA tensor launches the kernel; a CPU
    tensor takes :func:`log_mel_spectrogram_plain`."""
    global launches
    _check_config(config)
    if signal.device.type == "cpu":
        return log_mel_spectrogram_plain(signal, config)
    if signal.device.type != "cuda":
        raise ValueError(f"no frontend kernel for device {signal.device}")
    if signal.dim() != 2:
        raise ValueError("signal must be [B, N]")
    b, n = signal.shape
    _build.require(signal, "signal", device=signal.device, dtype=torch.float32, shape=(b, n))
    t = config.get_nframes(n)
    nmel = config.num_feature_bins
    out = torch.empty((b, t, nmel), dtype=torch.float32, device=signal.device)
    if b == 0 or t == 0:
        return out
    cos_b, sin_b, mel = _device_constants(config, signal.device)
    lib = _build.build()
    with torch.cuda.device(signal.device):
        err = lib.tfasr_log_mel(
            signal.data_ptr(), cos_b.data_ptr(), sin_b.data_ptr(), mel.data_ptr(), out.data_ptr(),
            b, n, t, config.frame_length, config.frame_step, cos_b.shape[1], nmel, float(config.epsilon), _build.stream_of(signal),
        )
    _build.check(err, "log_mel_spectrogram_pallas")
    launches += 1
    return out
