"""Transformer-CTC (counterpart of ``tensorflowasr_tpu/models/ctc/transformer.py``),
and the Transformer-CTC base configuration."""

from __future__ import annotations

import inspect

import torch

from tensorflowasr_tpu_torch.models.config_utils import filter_kwargs, learning_config, strip_prefix, with_spec_augment
from tensorflowasr_tpu_torch.models.ctc.base import CtcModel
from tensorflowasr_tpu_torch.models.encoders.transformer import TransformerEncoder

_ENC_KEYS = set(inspect.signature(TransformerEncoder.__init__).parameters) - {"self", "in_features", "dtype"}


def transformer_ctc_base_config(vocab_size: int = 256, num_blocks: int = 6, dropout: float = 0.1, augment: bool = False) -> dict:
    """Transformer-CTC base (``examples/models/ctc/transformer/base.yml.j2``):
    80 mel bins, Conv2d ×4 subsampling 512/512 with BatchNorm and swish,
    D 512, dff 1024, 6 blocks, 4 heads of 128, vanilla MHA, post-norm,
    residual factor 1, ReLU FFN, absolute PE, dropout 0.1, blank 0, V 256.
    ``augment`` adds the example's ``augmentation_config`` (SpecAugment)."""
    config = {
        "speech_config": {"sample_rate": 16000, "frame_ms": 25, "stride_ms": 10, "nfft": 512, "num_feature_bins": 80,
                          "feature_type": "log_mel_spectrogram"},
        "encoder_subsampling": {
            "class_name": "tensorflow_asr.models.layers.subsampling>Conv2dSubsampling",
            "config": {"filters": [512, 512], "kernels": [3, 3], "strides": [2, 2], "paddings": ["causal", "causal"], "norms": ["batch", "batch"],
                       "activations": ["swish", "swish"]},
        },
        "encoder_dmodel": 512,
        "encoder_dff": 1024,
        "encoder_num_blocks": num_blocks,
        "encoder_head_size": 128,
        "encoder_num_heads": 4,
        "encoder_mha_type": "mha",
        "encoder_norm_position": "post",
        "encoder_residual_factor": 1.0,
        "encoder_pwffn_activation": "relu",
        "encoder_dropout": dropout,
        "blank": 0,
        "vocab_size": vocab_size,
    }
    return with_spec_augment(config) if augment else config


def transformer_ctc_base_learning_config() -> dict:
    """The example's ``learning_config`` as parsed: Adam under
    TransformerSchedule(dmodel 512, warm-up 10,000, scale 1, no max_lr),
    batch 4, ``ga_steps`` 8, TerminateOnNaN."""
    return learning_config(512, 1.0, batch_size=4, ga_steps=8)


class TransformerCtc(CtcModel):
    def make_encoder(self) -> TransformerEncoder:
        return TransformerEncoder(in_features=self.feature_extraction.config.num_feature_bins, dtype=self.dtype, **self.encoder_config)

    @property
    def encoder_output_dim(self) -> int:
        return self.encoder_config.get("dmodel", 512)

    @classmethod
    def from_config(cls, config: dict, vocab_size: int | None = None, dtype=torch.float32, device=None) -> "TransformerCtc":
        """Build from a reference-style config dict on ``device`` (None: the CUDA card)."""
        return cls(
            speech_config=dict(config.get("speech_config", {})),
            encoder_config=filter_kwargs(strip_prefix(config, "encoder_"), _ENC_KEYS),
            blank=config.get("blank", 0),
            vocab_size=vocab_size or config.get("vocab_size", 29),
            dtype=dtype,
            device=device,
        )
