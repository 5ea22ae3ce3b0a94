"""Transformer Transducer (counterpart of ``tensorflowasr_tpu/models/transducer/transformer.py``):
the port's Transformer encoder (``models/encoders/transformer.py``; the
published base config runs relative MHA through kernel B at head 64) under
the transducer's prediction net and joint."""

from __future__ import annotations

import inspect

import torch

from tensorflowasr_tpu_torch.models.config_utils import transducer_kwargs
from tensorflowasr_tpu_torch.models.encoders.transformer import TransformerEncoder
from tensorflowasr_tpu_torch.models.transducer.base import Transducer

_ENC_KEYS = set(inspect.signature(TransformerEncoder.__init__).parameters) - {"self", "in_features", "dtype"}


class TransformerTransducer(Transducer):
    def make_encoder(self) -> TransformerEncoder:
        return TransformerEncoder(in_features=self.feature_extraction.config.num_feature_bins, dtype=self.dtype, **self.encoder_config)

    @property
    def encoder_output_dim(self) -> int:
        return self.encoder_config.get("dmodel", 512)

    @classmethod
    def from_config(cls, config: dict, vocab_size: int | None = None, dtype=torch.float32, device=None, rnn_impl: str = "auto") -> "TransformerTransducer":
        """Build from a reference-style config dict on ``device`` (None: the
        CUDA card), with the prediction net's LSTM as ``rnn_impl`` selects."""
        return cls(**transducer_kwargs(config, _ENC_KEYS, vocab_size, dtype, device, rnn_impl))
