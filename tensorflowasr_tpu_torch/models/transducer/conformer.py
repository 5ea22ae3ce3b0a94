"""Conformer Transducer (counterpart of ``tensorflowasr_tpu/models/transducer/conformer.py``),
and the flagship Conformer-Transducer Small configuration."""

from __future__ import annotations

import inspect

import torch

from tensorflowasr_tpu_torch.models.config_utils import filter_kwargs, parse_joint_config, parse_prediction_config, strip_prefix
from tensorflowasr_tpu_torch.models.encoders.conformer import _UNPORTED, ConformerEncoder
from tensorflowasr_tpu_torch.models.transducer.base import Transducer

_ENC_KEYS = (set(inspect.signature(ConformerEncoder.__init__).parameters) | set(_UNPORTED)) - {"self", "in_features", "dtype", "options"}


def conformer_small_config(vocab_size: int = 256, num_blocks: int = 16, dmodel: int = 144, dropout: float = 0.1) -> dict:
    """The flagship Conformer-Transducer Small (``__graft_entry__._conformer_small``):
    80 mel bins, Conv2d ×4 subsampling with BatchNorm and swish, D=144,
    4 heads of 36, rel-MHA, 31-tap causal conv, embedding 320, one
    LSTM-320 with LayerNorm, add/tanh joint of 320, blank 0."""
    return {
        "speech_config": {"sample_rate": 16000, "frame_ms": 25, "stride_ms": 10, "nfft": 512, "num_feature_bins": 80},
        "encoder_subsampling": {
            "class_name": "tensorflow_asr.models.layers.subsampling>Conv2dSubsampling",
            "config": {
                "filters": [dmodel, dmodel],
                "kernels": [3, 3],
                "strides": [2, 2],
                "paddings": ["causal", "causal"],
                "norms": ["batch", "batch"],
                "activations": ["swish", "swish"],
            },
        },
        "encoder_dmodel": dmodel,
        "encoder_num_blocks": num_blocks,
        "encoder_head_size": dmodel // 4,
        "encoder_num_heads": 4,
        "encoder_mha_type": "relmha",
        "encoder_kernel_size": 31,
        "encoder_dropout": dropout,
        "encoder_padding": "causal",
        "prediction_label_encode_mode": "embedding",
        "prediction_embed_dim": 320,
        "prediction_num_rnns": 1,
        "prediction_rnn_units": 320,
        "prediction_rnn_type": "lstm",
        "prediction_layer_norm": True,
        "joint_dim": 320,
        "joint_activation": "tanh",
        "joint_mode": "add",
        "blank": 0,
        "vocab_size": vocab_size,
    }


class Conformer(Transducer):
    def make_encoder(self) -> ConformerEncoder:
        return ConformerEncoder(in_features=self.feature_extraction.config.num_feature_bins, dtype=self.dtype, **self.encoder_config)

    @property
    def encoder_output_dim(self) -> int:
        return self.encoder_config.get("dmodel", 144)

    @classmethod
    def from_config(cls, config: dict, vocab_size: int | None = None, dtype=torch.float32) -> "Conformer":
        enc = filter_kwargs(strip_prefix(config, "encoder_"), _ENC_KEYS)
        return cls(
            speech_config=dict(config.get("speech_config", {})),
            encoder_config=enc,
            prediction_config=parse_prediction_config(config),
            joint_config=parse_joint_config(config),
            blank=config.get("blank", 0),
            vocab_size=vocab_size or config.get("vocab_size", 1000),
            dtype=dtype,
        )
