"""Config-keyed augmentation registry (counterpart of
``tensorflowasr_tpu/augmentations/augmentation.py``).

``signal_augment`` runs on raw [B, N] audio before the frontend,
``feature_augment`` on [B, T, F] features after it; both only in
training. Methods run in sorted key order (``freq_masking`` before
``time_masking``), each on the whole batch, drawing from one CPU generator.
"""

from __future__ import annotations

from typing import List

import torch

from tensorflowasr_tpu_torch.augmentations.methods import AugmentationMethod, FreqMasking, GaussNoise, TimeMasking

AUGMENTATIONS = {
    "gauss_noise": GaussNoise,
    "freq_masking": FreqMasking,
    "time_masking": TimeMasking,
}


class Augmentation:
    def __init__(self, config: dict | None = None):
        _config = dict(config or {})
        self.signal_augmentations = self.parse(_config.pop("signal_augment", {}) or {})
        self.feature_augmentations = self.parse(_config.pop("feature_augment", {}) or {})

    @staticmethod
    def parse(config: dict) -> List[AugmentationMethod]:
        augmentations = []
        for key, value in sorted(config.items(), key=lambda kv: kv[0]):
            if key not in AUGMENTATIONS:
                raise KeyError(f"No augmentation named: {key}\nAvailable: {list(AUGMENTATIONS)}")
            augmentations.append(AUGMENTATIONS[key](**(value or {})))
        return augmentations

    @staticmethod
    def _augment_batch(inputs: torch.Tensor, inputs_length: torch.Tensor, generator: torch.Generator, augmentations: List[AugmentationMethod]):
        for au in augmentations:
            inputs = au(inputs, inputs_length, generator)
        return inputs, inputs_length

    def signal_augment(self, inputs: torch.Tensor, inputs_length: torch.Tensor, generator: torch.Generator):
        """[B, N] raw signals → augmented, same shapes and lengths."""
        return self._augment_batch(inputs, inputs_length, generator, self.signal_augmentations)

    def feature_augment(self, inputs: torch.Tensor, inputs_length: torch.Tensor, generator: torch.Generator):
        """[B, T, F] features → augmented, same shapes and lengths."""
        return self._augment_batch(inputs, inputs_length, generator, self.feature_augmentations)
