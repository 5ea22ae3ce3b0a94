"""In-model feature extraction with train-time augmentation (counterpart
of ``models/layers/feature_extraction.py:FeatureExtraction``).

Raw audio [B, N] → features [B, T, F] in ``dtype`` (the frontend itself
runs in f32). Configurations the fused kernel takes (log-mel, pad_end
framing, natural log, no librosa-style window) run
``ops/cuda/frontend_kernel.log_mel_spectrogram_pallas`` after the
signal-stage prep (any nfft: below the frame length the kernels crop
each frame to nfft, as the plain chain does); others (the spectrogram,
MFCC, log-gammatone, base-10 log-mel) run the plain chain of
``ops/frontend.py``, as in JAX.
In training, the config's ``augmentation_config`` (``augmentations/``)
runs as in JAX: the signal augmentations before the frontend (their
output feeds the kernel or the plain chain), the feature augmentations
(SpecAugment) after ``normalize_audio_features`` and before the cast to
``dtype``, drawing from the ``augment_generator`` the caller passes.
Inference never augments.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from tensorflowasr_tpu_torch.augmentations import Augmentation
from tensorflowasr_tpu_torch.ops import frontend
from tensorflowasr_tpu_torch.ops.cuda import frontend_kernel


def fused_frontend_supported(cfg: frontend.FrontendConfig) -> bool:
    return cfg.feature_type == "log_mel_spectrogram" and not cfg.use_librosa_like_stft and cfg.pad_end and cfg.log_base == "e"


class FeatureExtraction(nn.Module):
    def __init__(self, dtype=torch.float32, **speech_config):
        super().__init__()
        names = {f.name for f in dataclasses.fields(frontend.FrontendConfig)}
        unknown = set(speech_config) - names - {"augmentation_config"}
        if unknown:
            raise ValueError(f"unknown speech_config keys {sorted(unknown)}")
        self.config = frontend.FrontendConfig(**{k: v for k, v in speech_config.items() if k in names})
        self.augmentation = Augmentation(speech_config.get("augmentation_config"))
        self.dtype = dtype

    @property
    def time_reduction_factor(self) -> int:
        return 1

    def get_nframes(self, nsamples):
        return self.config.get_nframes(nsamples)

    def forward(self, signals: torch.Tensor, signals_length: torch.Tensor, train: bool = False,
                augment_generator: torch.Generator | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        """[B, N] raw audio → ([B, T, F] features in ``dtype``, [B] lengths).
        ``train`` augments as the config says, drawing from
        ``augment_generator`` (a CPU generator), which it then requires."""
        aug = self.augmentation
        augment = train and bool(aug.signal_augmentations or aug.feature_augmentations)
        if augment and augment_generator is None:
            raise ValueError("training with an augmentation_config needs an augment_generator")
        cfg = self.config
        signals = signals.float()
        if augment:
            signals, signals_length = aug.signal_augment(signals, signals_length, augment_generator)
        if fused_frontend_supported(cfg):
            sig = frontend.prepare_signal(signals, cfg).contiguous()
            features = frontend.normalize_audio_features(frontend_kernel.log_mel_spectrogram_pallas(sig, cfg), cfg)
            lengths = cfg.get_nframes(signals_length.to(torch.int64))
        else:
            features, lengths = frontend.extract_features(signals, signals_length, cfg)
        if augment:
            features, lengths = aug.feature_augment(features, lengths, augment_generator)
        return features.to(self.dtype), lengths
