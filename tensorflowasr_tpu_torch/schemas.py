"""Typed inference IO (counterpart of ``tensorflowasr_tpu/schemas.py``)."""

from __future__ import annotations

import typing

import torch


class PredictInput(typing.NamedTuple):
    inputs: torch.Tensor  # [B, nsamples] raw audio
    inputs_length: torch.Tensor  # [B]
    previous_tokens: typing.Optional[torch.Tensor] = None
    previous_encoder_states: typing.Optional[typing.Any] = None
    previous_decoder_states: typing.Optional[typing.Any] = None


class PredictOutput(typing.NamedTuple):
    tokens: torch.Tensor
    next_tokens: torch.Tensor
    next_encoder_states: typing.Optional[typing.Any] = None
    next_decoder_states: typing.Optional[typing.Any] = None
