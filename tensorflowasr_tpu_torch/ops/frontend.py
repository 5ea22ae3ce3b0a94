"""Audio frontend: framing, Hann window, |STFT|², HTK mel filterbank, log
(counterpart of ``tensorflowasr_tpu/ops/frontend.py``: the log-mel and
spectrogram chains).

This is the plain PyTorch chain (``torch.fft.rfft``). A natural-log log-mel
configuration runs the fused kernel in ``ops/cuda/frontend_kernel.py`` on a
card instead; this module is that kernel's reference and the CPU path, and
every other configuration's path on the card too (as in JAX). The
``spectrogram`` feature type is the log of |STFT|² cut to its first
``num_feature_bins`` bins (DeepSpeech2's). ``mfcc`` and
``log_gammatone_spectrogram`` are not ported yet and raise.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from tensorflowasr_tpu_torch.utils import math_util

FEATURE_TYPES = ("log_mel_spectrogram", "spectrogram")


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
            raise ValueError(f"feature_type {self.feature_type!r} is not ported yet; the port has {FEATURE_TYPES}")
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
        min_value = _logarithm(features.new_zeros(()), config)
        return (features - min_value) / (features.amax(dim=1, keepdim=True) - min_value)
    return features


def log_mel_spectrogram(signal: torch.Tensor, config: FrontendConfig) -> torch.Tensor:
    s = stft_magnitude_squared(signal, config)
    mel = linear_to_mel_weight_matrix(config.num_feature_bins, s.shape[-1], config.sample_rate, config.lower_edge_hertz, config.upper_edge_hertz)
    return _logarithm(torch.matmul(s, torch.tensor(mel, device=s.device)), config)


def spectrogram(signal: torch.Tensor, config: FrontendConfig) -> torch.Tensor:
    """log(|STFT|² + ε) of the first ``num_feature_bins`` bins, [B, T, F]."""
    return _logarithm(stft_magnitude_squared(signal, config), config)[:, :, : config.num_feature_bins]


def prepare_signal(signal: torch.Tensor, config: FrontendConfig) -> torch.Tensor:
    """Signal-stage prep shared by both paths: end padding, peak
    normalisation, preemphasis."""
    if config.padding > 0:
        signal = F.pad(signal, (0, config.padding))
    return preemphasis_signal(normalize_signal(signal, config), config)


def extract_features(signal: torch.Tensor, signal_length: torch.Tensor, config: FrontendConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, N] raw audio → ([B, T, F] features, [B] frame lengths)."""
    extract = spectrogram if config.feature_type == "spectrogram" else log_mel_spectrogram
    features = normalize_audio_features(extract(prepare_signal(signal, config), config), config)
    return features, config.get_nframes(signal_length.to(torch.int64))
