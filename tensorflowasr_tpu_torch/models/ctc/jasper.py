"""Jasper-CTC (counterpart of ``tensorflowasr_tpu/models/ctc/jasper.py``)."""

from __future__ import annotations

import inspect

import torch

from tensorflowasr_tpu_torch.models.config_utils import filter_kwargs
from tensorflowasr_tpu_torch.models.ctc.base import CtcModel
from tensorflowasr_tpu_torch.models.encoders.jasper import JasperEncoder

_ENC_KEYS = set(inspect.signature(JasperEncoder.__init__).parameters) - {"self", "in_features", "dtype"}


class Jasper(CtcModel):
    def make_encoder(self) -> JasperEncoder:
        return JasperEncoder(in_features=self.feature_extraction.config.num_feature_bins, dtype=self.dtype, **self.encoder_config)

    @property
    def encoder_output_dim(self) -> int:
        return self.encoder.output_dim

    @classmethod
    def from_config(cls, config: dict, vocab_size: int | None = None, dtype=torch.float32, device=None) -> "Jasper":
        """Build from a reference-style config (the encoder's keys unprefixed) on ``device`` (None: the CUDA card)."""
        enc = filter_kwargs(config, _ENC_KEYS)
        for key in ("block_channels", "block_kernels", "block_dropout"):
            if key in enc:
                enc[key] = tuple(enc[key])
        return cls(
            speech_config=dict(config.get("speech_config", {})),
            encoder_config=enc,
            blank=config.get("blank", 0),
            vocab_size=vocab_size or config.get("vocab_size", 29),
            dtype=dtype,
            device=device,
        )
