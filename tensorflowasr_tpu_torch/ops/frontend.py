"""Audio frontend: framing, Hann window, |STFT|², HTK mel filterbank, log,
MFCC and the gammatone filterbank (counterpart of
``tensorflowasr_tpu/ops/frontend.py``).

This is the plain PyTorch chain (``torch.fft.rfft``; an nfft below the
frame length crops each windowed frame to its first nfft samples, as
``rfft(frames, n=nfft)`` does in both packages). A natural-log log-mel
configuration runs the fused kernel in ``ops/cuda/frontend_kernel.py`` on a
card instead; this module is that kernel's reference and the CPU path, and
every other configuration's path on the card too (as in JAX). The
``spectrogram`` feature type is the log of |STFT|² cut to its first
``num_feature_bins`` bins (DeepSpeech2's); ``mfcc`` is the orthonormally
scaled DCT-II of the log-mel features (tf.signal's MFCC scaling); and
``log_gammatone_spectrogram`` is the log of |STFT|² through the ERB-space
gammatone filterbank. Both filterbanks and the DCT matrix are numpy copies
of the JAX module's, computed once per configuration on the host.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from tensorflowasr_tpu_torch.utils import math_util

FEATURE_TYPES = ("spectrogram", "log_mel_spectrogram", "mfcc", "log_gammatone_spectrogram")


def hann_window(length: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Periodic Hann window (tf.signal.hann_window(periodic=True))."""
    n = np.arange(length)
    return torch.tensor(0.5 - 0.5 * np.cos(2.0 * np.pi * n / length), dtype=dtype, device=device)


def frame_signal(signal: torch.Tensor, frame_length: int, frame_step: int, pad_end: bool = True) -> torch.Tensor:
    """[B, N] → [B, T, frame_length]; with ``pad_end`` T = ceil(N/step) and
    the signal is zero-padded so every frame is complete."""
    b, n = signal.shape
    if pad_end:
        nframes = math_util.cdiv(n, frame_step)
        target = (nframes - 1) * frame_step + frame_length
        if target > n:
            signal = F.pad(signal, (0, target - n))
    else:
        nframes = max(0, 1 + (n - frame_length) // frame_step)
    if nframes == 0:
        return signal.new_zeros((b, 0, frame_length))
    return signal.unfold(1, frame_length, frame_step)[:, :nframes]


def _hertz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


@functools.lru_cache(maxsize=None)
def linear_to_mel_weight_matrix(
    num_mel_bins: int = 80,
    num_spectrogram_bins: int = 257,
    sample_rate: int = 16000,
    lower_edge_hertz: float = 0.0,
    upper_edge_hertz: float = 8000.0,
) -> np.ndarray:
    """HTK mel filterbank (tf.signal.linear_to_mel_weight_matrix): float32
    [num_spectrogram_bins, num_mel_bins] with a zero DC row. Read-only."""
    freqs = np.linspace(0.0, sample_rate / 2.0, num_spectrogram_bins)[1:]
    bins_mel = _hertz_to_mel(freqs)[:, None]
    edges = np.linspace(_hertz_to_mel(lower_edge_hertz), _hertz_to_mel(upper_edge_hertz), num_mel_bins + 2)
    lower, center, upper = edges[:-2][None, :], edges[1:-1][None, :], edges[2:][None, :]
    weights = np.maximum(0.0, np.minimum((bins_mel - lower) / (center - lower), (upper - bins_mel) / (upper - center)))
    out = np.pad(weights, [[1, 0], [0, 0]]).astype(np.float32)
    out.flags.writeable = False
    return out


def _erb_space(low_freq: float, high_freq: float, n: int) -> np.ndarray:
    """Center frequencies on an ERB scale (Glasberg & Moore), high to low."""
    ear_q, min_bw = 9.26449, 24.7
    return -ear_q * min_bw + np.exp(np.arange(1, n + 1) * (-np.log(high_freq + ear_q * min_bw) + np.log(low_freq + ear_q * min_bw)) / n) * (
        high_freq + ear_q * min_bw
    )


@functools.lru_cache(maxsize=None)
def gammatone_fft_weights(nfft: int, sample_rate: int, num_bins: int, width: float = 1.0, fmin: float = 0.0, fmax: float = 8000.0,
                          maxlen: Optional[int] = None) -> np.ndarray:
    """ERB-space gammatone filterbank in the FFT domain (the Patterson-
    Holdsworth/Slaney filterbank of Apple TR #35): each 4th-order filter's
    magnitude response at the FFT bin frequencies, over its analytic gain.
    float32 [maxlen (default nfft//2+1), num_bins], columns from low to high
    center frequency. Read-only."""
    ear_q, min_bw = 9.26449, 24.7
    maxlen = nfft // 2 + 1 if maxlen is None else int(maxlen)
    n_bins = nfft // 2 + 1
    cf = _erb_space(float(fmin), float(fmax), num_bins)[::-1]
    t = 1.0 / sample_rate
    b = 1.019 * 2.0 * np.pi * width * ((cf / ear_q) + min_bw)
    arg = 2.0 * cf * np.pi * t
    vec = np.exp(2j * arg)
    rt_pos, rt_neg = np.sqrt(3.0 + 2.0**1.5), np.sqrt(3.0 - 2.0**1.5)
    common = -t * np.exp(-b * t)
    k11, k12 = np.cos(arg) + rt_pos * np.sin(arg), np.cos(arg) - rt_pos * np.sin(arg)
    k13, k14 = np.cos(arg) + rt_neg * np.sin(arg), np.cos(arg) - rt_neg * np.sin(arg)
    exp_bt = np.exp(b * t)
    term = lambda k: -2.0 * vec * t + 2.0 * np.exp(1j * arg) / exp_bt * t * k
    gain = np.abs(term(k12) * term(k11) * term(k14) * term(k13) / (-2.0 / np.exp(2.0 * b * t) - 2.0 * vec + 2.0 * (1.0 + vec) / exp_bt) ** 4)
    ucirc = np.exp(1j * 2.0 * np.pi * np.arange(n_bins) / nfft)[None, :]
    pole = (np.sqrt(np.exp(-2.0 * b * t)) * np.exp(1j * arg))[:, None]
    weights = (
        np.abs(ucirc + (common * k11)[:, None] * sample_rate)
        * np.abs(ucirc + (common * k12)[:, None] * sample_rate)
        * np.abs(ucirc + (common * k13)[:, None] * sample_rate)
        * np.abs(ucirc + (common * k14)[:, None] * sample_rate)
        * np.abs(sample_rate * (pole - ucirc) * (np.conj(pole) - ucirc)) ** (-4.0)
        / gain[:, None]
    )
    out = np.ascontiguousarray(weights[:, :maxlen].T).astype(np.float32)
    out.flags.writeable = False
    return out


@functools.lru_cache(maxsize=None)
def dct_type2_matrix(n: int) -> np.ndarray:
    """The DCT-II over ``n`` bins scaled by 1/√(2n) (tf.signal's MFCC
    scaling), as a float64 [n, n] matrix that right-multiplies. Read-only."""
    k = np.arange(n)
    out = 2.0 * np.cos(np.pi * (2.0 * k[:, None] + 1.0) * k[None, :] / (2.0 * n)) / np.sqrt(2.0 * n)
    out.flags.writeable = False
    return out


def dct_type2_ortho_scaled(x: torch.Tensor) -> torch.Tensor:
    """tf.signal.mfccs_from_log_mel_spectrograms over the last axis."""
    return torch.matmul(x, torch.tensor(dct_type2_matrix(x.shape[-1]), dtype=x.dtype, device=x.device))


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    sample_rate: int = 16000
    frame_ms: int = 25
    stride_ms: int = 10
    num_feature_bins: int = 80
    feature_type: str = "log_mel_spectrogram"
    preemphasis: float = 0.97
    pad_end: bool = True
    use_librosa_like_stft: bool = False
    epsilon: float = 1e-6
    lower_edge_hertz: float = 0.0
    upper_edge_hertz: float = 8000.0
    log_base: str = "e"
    nfft: Optional[int] = 512
    normalize_signal: bool = False
    normalize_zscore: bool = False
    normalize_min_max: bool = False
    padding: int = 0

    def __post_init__(self):
        if self.feature_type not in FEATURE_TYPES:
            raise ValueError(f"feature_type {self.feature_type!r} must be one of {FEATURE_TYPES}")
        if self.log_base not in ("10", "e"):
            raise ValueError("log_base must be '10' or 'e'")
        if not 1e-9 < self.epsilon <= 0.001:
            raise ValueError("epsilon must lie in (1e-9, 1e-3]")

    @property
    def frame_length(self) -> int:
        return int(round(self.sample_rate * self.frame_ms / 1000.0))

    @property
    def frame_step(self) -> int:
        return int(round(self.sample_rate * self.stride_ms / 1000.0))

    @property
    def fft_length(self) -> int:
        return self.frame_length if self.nfft is None else self.nfft

    def get_nframes(self, nsamples):
        return math_util.get_nframes(
            nsamples, self.frame_length, self.frame_step, pad_end=self.pad_end, use_librosa_like_stft=self.use_librosa_like_stft, nfft=self.fft_length
        )

    def get_signal_chunk_size_and_step(self, nframes: int) -> tuple[int, int]:
        """(samples per chunk, samples between chunk starts) for streaming
        ``nframes`` feature frames per chunk whose STFT frames equal the
        full signal's (the reference's chunk math)."""
        return (nframes - 1) * self.frame_step + self.frame_length, nframes * self.frame_step


def _logarithm(s: torch.Tensor, config: FrontendConfig) -> torch.Tensor:
    s = torch.log(s + config.epsilon)
    return s / np.log(10.0) if config.log_base == "10" else s


def stft_magnitude_squared(signal: torch.Tensor, config: FrontendConfig) -> torch.Tensor:
    """|STFT|² of [B, N] → [B, T, nfft//2+1], in float32."""
    signal = signal.float()
    nfft = config.fft_length
    window = hann_window(config.frame_length, device=signal.device)
    if config.use_librosa_like_stft:
        left = (nfft - config.frame_length) // 2
        window = F.pad(window, (left, nfft - config.frame_length - left))
        frames = frame_signal(signal, nfft, config.frame_step, config.pad_end) * window
    else:
        frames = frame_signal(signal, config.frame_length, config.frame_step, config.pad_end) * window
    return torch.fft.rfft(frames, n=nfft, dim=-1).abs().square()


def normalize_signal(signal: torch.Tensor, config: FrontendConfig) -> torch.Tensor:
    if not config.normalize_signal:
        return signal
    return signal / (signal.abs().amax(dim=1, keepdim=True) + config.epsilon)


def preemphasis_signal(signal: torch.Tensor, config: FrontendConfig) -> torch.Tensor:
    if not config.preemphasis or config.preemphasis <= 0.0:
        return signal
    return torch.cat([signal[:, :1], signal[:, 1:] - config.preemphasis * signal[:, :-1]], dim=-1)


def normalize_audio_features(features: torch.Tensor, config: FrontendConfig) -> torch.Tensor:
    if config.normalize_zscore:
        mean = features.mean(dim=1, keepdim=True)
        std = torch.sqrt(features.var(dim=1, keepdim=True, unbiased=False) + config.epsilon)
        return (features - mean) / std
    if config.normalize_min_max:
        if config.feature_type.startswith("log_") or config.feature_type == "spectrogram":
            min_value = _logarithm(features.new_zeros(()), config)
        else:
            min_value = features.amin(dim=1, keepdim=True)
        return (features - min_value) / (features.amax(dim=1, keepdim=True) - min_value)
    return features


def log_mel_spectrogram(signal: torch.Tensor, config: FrontendConfig) -> torch.Tensor:
    s = stft_magnitude_squared(signal, config)
    mel = linear_to_mel_weight_matrix(config.num_feature_bins, s.shape[-1], config.sample_rate, config.lower_edge_hertz, config.upper_edge_hertz)
    return _logarithm(torch.matmul(s, torch.tensor(mel, device=s.device)), config)


def spectrogram(signal: torch.Tensor, config: FrontendConfig) -> torch.Tensor:
    """log(|STFT|² + ε) of the first ``num_feature_bins`` bins, [B, T, F]."""
    return _logarithm(stft_magnitude_squared(signal, config), config)[:, :, : config.num_feature_bins]


def mfcc(signal: torch.Tensor, config: FrontendConfig) -> torch.Tensor:
    return dct_type2_ortho_scaled(log_mel_spectrogram(signal, config))


def log_gammatone_spectrogram(signal: torch.Tensor, config: FrontendConfig) -> torch.Tensor:
    s = stft_magnitude_squared(signal, config)
    nfft = config.fft_length
    gtone = gammatone_fft_weights(nfft, config.sample_rate, config.num_feature_bins, 1.0, config.lower_edge_hertz, config.upper_edge_hertz, nfft // 2 + 1)
    return _logarithm(torch.matmul(s, torch.tensor(gtone, device=s.device)), config)


_EXTRACT = {"spectrogram": spectrogram, "log_mel_spectrogram": log_mel_spectrogram, "mfcc": mfcc, "log_gammatone_spectrogram": log_gammatone_spectrogram}


def prepare_signal(signal: torch.Tensor, config: FrontendConfig) -> torch.Tensor:
    """Signal-stage prep shared by both paths: end padding, peak
    normalisation, preemphasis."""
    if config.padding > 0:
        signal = F.pad(signal, (0, config.padding))
    return preemphasis_signal(normalize_signal(signal, config), config)


def extract_features(signal: torch.Tensor, signal_length: torch.Tensor, config: FrontendConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, N] raw audio → ([B, T, F] features, [B] frame lengths)."""
    features = normalize_audio_features(_EXTRACT[config.feature_type](prepare_signal(signal, config), config), config)
    return features, config.get_nframes(signal_length.to(torch.int64))
