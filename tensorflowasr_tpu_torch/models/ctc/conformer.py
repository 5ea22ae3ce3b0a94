"""Conformer-CTC (counterpart of ``tensorflowasr_tpu/models/ctc/conformer.py``),
and the Conformer-CTC Small configuration."""

from __future__ import annotations

import inspect

import torch

from tensorflowasr_tpu_torch.models.config_utils import filter_kwargs, learning_config, strip_prefix, with_spec_augment
from tensorflowasr_tpu_torch.models.ctc.base import CtcModel
from tensorflowasr_tpu_torch.models.encoders.conformer import ConformerEncoder

_ENC_KEYS = set(inspect.signature(ConformerEncoder.__init__).parameters) - {"self", "in_features", "dtype"}


def conformer_ctc_small_config(vocab_size: int = 256, num_blocks: int = 16, dropout: float = 0.1, augment: bool = False) -> dict:
    """Conformer-CTC Small (``examples/models/ctc/conformer/small.yml.j2``),
    every encoder width as published: 80 mel bins, Conv2d ×4 subsampling
    176/176 with BatchNorm and swish, D 176, 16 blocks, 4 heads of 44,
    rel-MHA with per-layer attention biases, 31-tap causal conv, dropout
    0.1, blank 0, V 256. ``augment`` adds the example's ``augmentation_config``
    (SpecAugment)."""
    config = {
        "speech_config": {"sample_rate": 16000, "frame_ms": 25, "stride_ms": 10, "nfft": 512, "num_feature_bins": 80,
                          "feature_type": "log_mel_spectrogram"},
        "encoder_subsampling": {
            "class_name": "tensorflow_asr.models.layers.subsampling>Conv2dSubsampling",
            "config": {"filters": [176, 176], "kernels": [3, 3], "strides": [2, 2], "paddings": ["causal", "causal"], "norms": ["batch", "batch"],
                       "activations": ["swish", "swish"]},
        },
        "encoder_dmodel": 176,
        "encoder_num_blocks": num_blocks,
        "encoder_head_size": 44,
        "encoder_num_heads": 4,
        "encoder_mha_type": "relmha",
        "encoder_interleave_relpe": True,
        "encoder_mhsam_use_attention_bias": True,
        "encoder_kernel_size": 31,
        "encoder_dropout": dropout,
        "encoder_padding": "causal",
        "blank": 0,
        "vocab_size": vocab_size,
    }
    return with_spec_augment(config) if augment else config


def conformer_ctc_small_learning_config() -> dict:
    """The example's ``learning_config`` as parsed: Adam under
    TransformerSchedule(dmodel 176, warm-up 10,000, max_lr
    ``"0.05/(176**0.5)"``, scale 2), batch 8, ``ga_steps`` 4, TerminateOnNaN."""
    return learning_config(176, 2.0, batch_size=8, ga_steps=4, max_lr="0.05/(176**0.5)")


class ConformerCtc(CtcModel):
    def make_encoder(self) -> ConformerEncoder:
        return ConformerEncoder(in_features=self.feature_extraction.config.num_feature_bins, dtype=self.dtype, **self.encoder_config)

    @property
    def encoder_output_dim(self) -> int:
        return self.encoder_config.get("dmodel", 144)

    @classmethod
    def from_config(cls, config: dict, vocab_size: int | None = None, dtype=torch.float32, device=None) -> "ConformerCtc":
        """Build from a reference-style config dict on ``device`` (None: the CUDA card)."""
        return cls(
            speech_config=dict(config.get("speech_config", {})),
            encoder_config=filter_kwargs(strip_prefix(config, "encoder_"), _ENC_KEYS),
            blank=config.get("blank", 0),
            vocab_size=vocab_size or config.get("vocab_size", 29),
            dtype=dtype,
            device=device,
        )
