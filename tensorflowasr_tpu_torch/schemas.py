"""Typed IO (counterpart of ``tensorflowasr_tpu/schemas.py``)."""

from __future__ import annotations

import typing

import torch


class TrainInput(typing.NamedTuple):
    inputs: torch.Tensor  # [B, nsamples] raw audio
    inputs_length: torch.Tensor  # [B]
    predictions: torch.Tensor  # [B, U+1] blank-prepended labels
    predictions_length: torch.Tensor  # [B]


class TrainOutput(typing.NamedTuple):
    logits: torch.Tensor  # [B, T, U+1, V]
    logits_length: torch.Tensor  # [B]


class TrainLabel(typing.NamedTuple):
    labels: torch.Tensor  # [B, U]
    labels_length: torch.Tensor  # [B]


class TrainData(typing.NamedTuple):
    inputs: TrainInput
    labels: TrainLabel

    def to(self, device) -> "TrainData":
        """Every tensor of the batch on ``device``; copies to the card from
        pinned host memory do not block the host (a copy to the host does)."""
        to_card = torch.device(device).type == "cuda"
        move = lambda t: t.to(device, non_blocking=to_card)
        return TrainData(TrainInput(*map(move, self.inputs)), TrainLabel(*map(move, self.labels)))


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


class PredictOutputWithTranscript(typing.NamedTuple):
    transcript: torch.Tensor  # [B, max_tokens, max_chars] unicode codepoints (0-padded), or the tokens without a tokenizer
    tokens: torch.Tensor
    next_tokens: torch.Tensor
    next_encoder_states: typing.Optional[typing.Any] = None
    next_decoder_states: typing.Optional[typing.Any] = None
