"""DeepSpeech2-CTC (counterpart of ``tensorflowasr_tpu/models/ctc/deepspeech2.py``)."""

from __future__ import annotations

import inspect

import torch

from tensorflowasr_tpu_torch.models.config_utils import filter_kwargs
from tensorflowasr_tpu_torch.models.ctc.base import CtcModel
from tensorflowasr_tpu_torch.models.encoders.deepspeech2 import DeepSpeech2Encoder
from tensorflowasr_tpu_torch.models.layers.rnn import default_rnn_impl

_ENC_KEYS = set(inspect.signature(DeepSpeech2Encoder.__init__).parameters) - {"self", "in_features", "dtype", "rnn_impl"}


def _tuples(value):
    """Config lists (YAML) as tuples: ``[[11, 41], [11, 21]]`` → ``((11, 41), (11, 21))``."""
    return tuple(tuple(v) if isinstance(v, (list, tuple)) else v for v in value)


class DeepSpeech2(CtcModel):
    """DeepSpeech2 encoder + CTC. ``rnn_impl`` as the transducer's:
    ``"auto"``/``"xla"`` scan the LSTMs, ``"pallas"`` runs the LSTM kernels
    for every layer and direction; ``None`` (the default) takes
    :func:`default_rnn_impl` of the device the model is built on."""

    def __init__(self, *args, rnn_impl: str | None = None, **kwargs):
        self.rnn_impl = rnn_impl or default_rnn_impl(kwargs.get("device", args[5] if len(args) > 5 else None))  # CtcModel's sixth argument
        super().__init__(*args, **kwargs)

    def make_encoder(self) -> DeepSpeech2Encoder:
        return DeepSpeech2Encoder(in_features=self.feature_extraction.config.num_feature_bins, dtype=self.dtype, rnn_impl=self.rnn_impl,
                                  **self.encoder_config)

    @property
    def encoder_output_dim(self) -> int:
        return self.encoder.output_dim

    @classmethod
    def from_config(cls, config: dict, vocab_size: int | None = None, dtype=torch.float32, device=None, rnn_impl: str | None = None) -> "DeepSpeech2":
        """Build from a reference-style config (the encoder's ``conv_*``,
        ``rnn_*`` and ``fc_*`` keys unprefixed) on ``device`` (None: the CUDA card)."""
        enc = filter_kwargs(config, _ENC_KEYS)
        for key in ("conv_kernels", "conv_strides", "conv_filters"):
            if key in enc:
                enc[key] = _tuples(enc[key])
        return cls(
            speech_config=dict(config.get("speech_config", {})),
            encoder_config=enc,
            blank=config.get("blank", 0),
            vocab_size=vocab_size or config.get("vocab_size", 29),
            dtype=dtype,
            device=device,
            rnn_impl=rnn_impl,
        )
