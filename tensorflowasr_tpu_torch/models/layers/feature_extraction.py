"""In-model feature extraction, inference path (counterpart of
``models/layers/feature_extraction.py:FeatureExtraction``).

Raw audio [B, N] → features [B, T, F] in ``dtype`` (the frontend itself
runs in f32). Configurations the fused kernel takes (log-mel, pad_end
framing, natural log, no librosa-style window) run
``ops/cuda/frontend_kernel.log_mel_spectrogram_pallas`` after the
signal-stage prep; others run the plain chain of ``ops/frontend.py``.
Train-time augmentation (SpecAugment and the signal augmentations) is not
ported yet: ``forward(..., train=True)`` raises when the config holds one,
rather than return features JAX would have augmented.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

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
        aug = dict(speech_config.get("augmentation_config") or {})
        self.augmentations = sorted(k for k in ("signal_augment", "feature_augment") if aug.get(k))
        self.dtype = dtype

    @property
    def time_reduction_factor(self) -> int:
        return 1

    def get_nframes(self, nsamples):
        return self.config.get_nframes(nsamples)

    def forward(self, signals: torch.Tensor, signals_length: torch.Tensor, train: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
        """[B, N] raw audio → ([B, T, F] features in ``dtype``, [B] lengths).
        ``train`` with augmentations in the config raises (JAX augments there)."""
        if train and self.augmentations:
            raise NotImplementedError(f"train-time augmentation ({', '.join(self.augmentations)}) is not ported yet "
                                      "(ROADMAP Queue 1, \"The rest of training\")")
        cfg = self.config
        if fused_frontend_supported(cfg):
            sig = frontend.prepare_signal(signals.float(), cfg).contiguous()
            features = frontend.normalize_audio_features(frontend_kernel.log_mel_spectrogram_pallas(sig, cfg), cfg)
            lengths = cfg.get_nframes(signals_length.to(torch.int64))
        else:
            features, lengths = frontend.extract_features(signals.float(), signals_length, cfg)
        return features.to(self.dtype), lengths
