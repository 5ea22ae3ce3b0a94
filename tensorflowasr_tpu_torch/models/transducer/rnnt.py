"""RNN Transducer (counterpart of ``tensorflowasr_tpu/models/transducer/rnnt.py``):
the LSTM encoder with time reductions (``models/encoders/rnnt.py``) under
the transducer's prediction net and joint."""

from __future__ import annotations

import inspect

import torch

from tensorflowasr_tpu_torch.models.config_utils import transducer_kwargs
from tensorflowasr_tpu_torch.models.encoders.rnnt import RnnTransducerEncoder
from tensorflowasr_tpu_torch.models.layers.rnn import default_rnn_impl
from tensorflowasr_tpu_torch.models.transducer.base import Transducer

_ENC_KEYS = set(inspect.signature(RnnTransducerEncoder.__init__).parameters) - {"self", "in_features", "dtype", "rnn_impl"}


class RnnTransducer(Transducer):
    """``rnn_impl`` selects every LSTM of the model, the encoder's and the
    prediction net's (``"auto"``/``"xla"``: the loop over the cell,
    ``"pallas"``: the LSTM kernels); ``None`` (the default) takes
    :func:`default_rnn_impl` of the device the model is built on, as
    DeepSpeech2 does."""

    def __init__(self, *args, rnn_impl: str | None = None, **kwargs):
        self.rnn_impl = rnn_impl or default_rnn_impl(kwargs.get("device"))
        super().__init__(*args, rnn_impl=self.rnn_impl, **kwargs)

    def make_encoder(self) -> RnnTransducerEncoder:
        return RnnTransducerEncoder(in_features=self.feature_extraction.config.num_feature_bins, dtype=self.dtype, rnn_impl=self.rnn_impl,
                                    **self.encoder_config)

    @property
    def encoder_output_dim(self) -> int:
        return self.encoder_config.get("dmodel", 640)

    @classmethod
    def from_config(cls, config: dict, vocab_size: int | None = None, dtype=torch.float32, device=None, rnn_impl: str | None = None) -> "RnnTransducer":
        """Build from a reference-style config dict on ``device`` (None: the CUDA card)."""
        return cls(**transducer_kwargs(config, _ENC_KEYS, vocab_size, dtype, device, rnn_impl))
