"""ContextNet Transducer (counterpart of ``tensorflowasr_tpu/models/transducer/contextnet.py``):
the SE-conv encoder (``models/encoders/contextnet.py``) under the
transducer's prediction net and joint."""

from __future__ import annotations

import inspect

import torch

from tensorflowasr_tpu_torch.models.config_utils import transducer_kwargs
from tensorflowasr_tpu_torch.models.encoders.contextnet import ContextNetEncoder
from tensorflowasr_tpu_torch.models.transducer.base import Transducer

_ENC_KEYS = set(inspect.signature(ContextNetEncoder.__init__).parameters) - {"self", "in_features", "dtype"}


class ContextNet(Transducer):
    def make_encoder(self) -> ContextNetEncoder:
        return ContextNetEncoder(in_features=self.feature_extraction.config.num_feature_bins, dtype=self.dtype, **self.encoder_config)

    @property
    def encoder_output_dim(self) -> int:
        return int(self.encoder_config["blocks"][-1].get("filters", 256) * self.encoder_config.get("alpha", 1.0))

    @classmethod
    def from_config(cls, config: dict, vocab_size: int | None = None, dtype=torch.float32, device=None, rnn_impl: str = "auto") -> "ContextNet":
        """Build from a reference-style config dict on ``device`` (None: the
        CUDA card), with the prediction net's LSTM as ``rnn_impl`` selects."""
        return cls(**transducer_kwargs(config, _ENC_KEYS, vocab_size, dtype, device, rnn_impl))
