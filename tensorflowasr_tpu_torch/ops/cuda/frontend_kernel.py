"""Fused log-mel frontend kernels (``csrc/frontend.cu``).

Replaces ``tensorflowasr_tpu/ops/pallas/frontend_kernel.py``:
``log_mel_spectrogram_pallas`` (v1, XLA framing) and
``log_mel_spectrogram_pallas_v2`` (in-kernel framing). The kernels frame
in-kernel, so they are the counterpart of both. The JAX kernels take the
DFT as dense products against [frame_length, nfft/2+1] bases because the
MXU is the TPU's only fast unit; the card has no such constraint.

Which kernel runs is decided by the shape, here, never by a failure:

- a power-of-two ``nfft`` from 256 to 2048 (:data:`FFT_SIZES`; every
  example config takes 512) takes the FFT kernel: one warp per frame windows
  the frame into nfft/2 complex points, runs a radix-2/4 FFT in shared
  memory with twiddles from a table built here in float64
  (:func:`twiddles`), splits it into the nfft/2+1 real bins, and sums each
  mel filter over its nonzero bins only (:func:`mel_ranges`);
- any other ``nfft`` (``nfft=None`` is the frame_length-point case) takes
  the direct-DFT kernel against the Hann-windowed bases of
  :func:`_dft_bases`, with the same sparse mel stage.

An ``nfft`` below the frame length (nfft 256 at 25 ms frames of 400
samples) crops each Hann-windowed frame to its first nfft samples, as
``torch.fft.rfft(frames, n=nfft)`` and JAX's XLA chain do: both kernels
read :func:`kernel_frame_length` samples a frame (the DFT bases have that
many rows). JAX's Pallas bases take all frame_length rows at angle
2πnk/nfft instead (the DFT of the wrapped frame), so JAX's kernel and its
XLA chain disagree there; the port follows the XLA chain.

What bounds them on the card: the FFT kernel does ~12 kFLOP a frame at
nfft 512, so its bound is the signal read once and the features written
once; the DFT is ~0.8 MFLOP a frame (400 samples × 257 bins × cos and sin,
f32 on the CUDA cores, since the reference pins its products to HIGHEST).
Only the signal is read and only the features written: each block copies
its frames' samples from the signal by index arithmetic into shared
memory. Times on one NVIDIA H100 80GB HBM3 at 700 W: PERF.md section 6,
rows 1 and 2.
"""

from __future__ import annotations

import numpy as np
import torch

from tensorflowasr_tpu_torch.ops import frontend
from tensorflowasr_tpu_torch.ops.cuda import _build
from tensorflowasr_tpu_torch.utils import tracing

FFT_SIZES = (256, 512, 1024, 2048)  # the nfft the FFT kernel takes

_CONSTS: dict = {}  # (device, kernel, config fields) → device tensors


def uses_fft(nfft: int) -> bool:
    """Whether ``nfft`` takes the FFT kernel (else the direct-DFT kernel)."""
    return nfft in FFT_SIZES


def twiddles(nfft: int) -> np.ndarray:
    """W_n^k = exp(−2πik/nfft) for k < nfft, computed in float64 and cast: [nfft, 2] f32 (re, im)."""
    ang = 2.0 * np.pi * np.arange(nfft, dtype=np.float64) / nfft
    return np.stack([np.cos(ang), -np.sin(ang)], axis=1).astype(np.float32)


def mel_ranges(mel: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The mel filters' nonzero bins: (weights f32 [nnz], first bin int32
    [nmel], offsets int32 [nmel + 1]); filter m's weights are
    weights[off[m]:off[m+1]] for bins lo[m] onwards (an all-zero filter has
    none)."""
    weights, lo, off = [], [], [0]
    for m in range(mel.shape[1]):
        nz = np.flatnonzero(mel[:, m])
        first, last = (int(nz[0]), int(nz[-1]) + 1) if nz.size else (0, 0)
        weights.append(mel[first:last, m])
        lo.append(first)
        off.append(off[-1] + last - first)
    return np.concatenate(weights).astype(np.float32), np.asarray(lo, np.int32), np.asarray(off, np.int32)


def kernel_frame_length(config: frontend.FrontendConfig) -> int:
    """The samples of each frame the kernels read: the frame, cropped to nfft."""
    return min(config.frame_length, config.fft_length)


def _dft_bases(frame_length: int, nfft: int) -> tuple[np.ndarray, np.ndarray]:
    """Hann-windowed DFT bases [min(frame_length, nfft), nfft//2+1]: cos and
    -sin (the window is frame_length's; a longer frame is cropped to nfft)."""
    nbins = nfft // 2 + 1
    n = np.arange(min(frame_length, nfft))[:, None]
    ang = 2.0 * np.pi * n * np.arange(nbins)[None, :] / nfft
    window = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(frame_length) / frame_length)
    window = window[: n.shape[0], None]
    return (np.cos(ang) * window).astype(np.float32), (-np.sin(ang) * window).astype(np.float32)


def _device_constants(config: frontend.FrontendConfig, device: torch.device) -> tuple:
    """The kernel's tables on ``device``: FFT (twiddles, window, mel weights,
    first bins, offsets) or DFT (cos, sin, mel weights, first bins, offsets)."""
    nfft = config.fft_length
    key = (device, uses_fft(nfft), config.frame_length, nfft, config.num_feature_bins, config.sample_rate, config.lower_edge_hertz,
           config.upper_edge_hertz)
    if key not in _CONSTS:
        mel = frontend.linear_to_mel_weight_matrix(config.num_feature_bins, nfft // 2 + 1, config.sample_rate, config.lower_edge_hertz,
                                                   config.upper_edge_hertz)
        if uses_fft(nfft):
            head = (twiddles(nfft), frontend.hann_window(config.frame_length).numpy())
        else:
            head = _dft_bases(config.frame_length, nfft)
        _CONSTS[key] = tuple(torch.tensor(a, device=device) for a in (*head, *mel_ranges(mel)))
    return _CONSTS[key]


def _check_config(config: frontend.FrontendConfig) -> None:
    if config.use_librosa_like_stft or not config.pad_end or config.log_base != "e" or config.feature_type != "log_mel_spectrogram":
        raise ValueError("the fused frontend takes pad_end framing, natural log, log-mel features only")


def log_mel_spectrogram_plain(signal: torch.Tensor, config: frontend.FrontendConfig) -> torch.Tensor:
    """Plain PyTorch version: rfft framing chain of ``ops/frontend.py``."""
    _check_config(config)
    return frontend.log_mel_spectrogram(signal, config)


def log_mel_spectrogram_pallas(signal: torch.Tensor, config: frontend.FrontendConfig) -> torch.Tensor:
    """[B, N] f32 (preemphasised) → [B, T, num_feature_bins] f32 log-mel,
    T = ceil(N / frame_step). A CUDA tensor launches the FFT kernel (nfft in
    :data:`FFT_SIZES`) or the direct-DFT kernel (any other nfft); a CPU
    tensor takes :func:`log_mel_spectrogram_plain`. Under ``torch.export``
    the call is the custom operator ``tfasr::log_mel_spectrogram``
    (``ops/cuda/library.py``), which does the same at run time."""
    if torch.compiler.is_exporting():
        from tensorflowasr_tpu_torch.ops.cuda import library

        return library.log_mel_spectrogram_op(signal, config)
    _check_config(config)
    if signal.device.type == "cpu":
        return log_mel_spectrogram_plain(signal, config)
    if signal.device.type != "cuda":
        raise ValueError(f"no frontend kernel for device {signal.device}")
    return log_mel_spectrogram_kernel(signal, config)


def log_mel_spectrogram_kernel(signal: torch.Tensor, config: frontend.FrontendConfig) -> torch.Tensor:
    """The FFT or direct-DFT kernel on a CUDA tensor (see :func:`log_mel_spectrogram_pallas`)."""
    _check_config(config)
    if signal.dim() != 2:
        raise ValueError("signal must be [B, N]")
    b, n = signal.shape
    _build.require(signal, "signal", device=signal.device, dtype=torch.float32, shape=(b, n))
    t = config.get_nframes(n)
    nmel, nfft = config.num_feature_bins, config.fft_length
    out = torch.empty((b, t, nmel), dtype=torch.float32, device=signal.device)
    if b == 0 or t == 0:
        return out
    consts = _device_constants(config, signal.device)
    lib = _build.build()
    fft = uses_fft(nfft)
    sizes = (nfft, nmel, consts[2].numel()) if fft else (nfft // 2 + 1, nmel)
    with tracing.kernel("kernel.frontend", signal, out), torch.cuda.device(signal.device):
        launch = lib.tfasr_log_mel_fft if fft else lib.tfasr_log_mel_dft
        err = launch(signal.data_ptr(), *(c.data_ptr() for c in consts), out.data_ptr(), b, n, t, kernel_frame_length(config), config.frame_step, *sizes,
                     float(config.epsilon), _build.stream_of(signal))
        _build.check(err, "log_mel_spectrogram_pallas")
    if not fft:
        tracing.launches["kernel.frontend.dft"] += 1
    return out
