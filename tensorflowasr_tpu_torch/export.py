"""Model export: one raw-audio → tokens and transcript inference program
(counterpart of ``tensorflowasr_tpu/export.py``).

:func:`make_inference_fn` wraps a model as a module with a fixed signature
that carries the streaming state (previous tokens, encoder and decoder
states) through and detokenizes in the graph, to unicode codepoints
gathered from the tokenizer's table (``Tokenizer.upoints``), so the
artifact needs no Python tokenizer.

:func:`export_program` traces it with ``torch.export`` and saves a ``.pt2``
(the counterpart of JAX's StableHLO artifact); :func:`load_program` loads
one. The traced graph holds the serving kernels as the custom operators of
``ops/cuda/library.py``: run on the card, the program launches the same
kernels as eager ``recognize``; run on the CPU, their plain versions.
:func:`convert_tflite` is the TFLite route, which needs TensorFlow: the
port has none, so it warns and returns False, as JAX's does without
TensorFlow.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import numpy as np
import torch

from tensorflowasr_tpu_torch import schemas
from tensorflowasr_tpu_torch.models.ctc import base as ctc_base
from tensorflowasr_tpu_torch.models.transducer import base as transducer_base

logger = logging.getLogger("tensorflowasr_tpu_torch")

# the program's output type, by name in a saved .pt2 (the error torch raises without it names this hook)
torch.utils._pytree._register_namedtuple(schemas.PredictOutputWithTranscript,
                                         serialized_type_name="tensorflowasr_tpu_torch.schemas.PredictOutputWithTranscript")


class InferenceModule(torch.nn.Module):
    """``forward(signals, signals_length, previous_tokens=None,
    previous_encoder_states=None, previous_decoder_states=None) →
    PredictOutputWithTranscript``: greedy, or beam search with ``beam_width``
    > 0, through the undecorated body of the model's ``recognize`` (the
    decorated one runs under ``torch.inference_mode``, which
    ``torch.export`` does not trace)."""

    def __init__(self, model: torch.nn.Module, tokenizer=None, beam_width: int = 0):
        super().__init__()
        self.model = model.eval()
        self.beam_width = int(beam_width)
        is_transducer = isinstance(model, transducer_base.Transducer)
        self._recognize = (transducer_base.recognize if is_transducer else ctc_base.recognize).__wrapped__
        device = next(model.parameters()).device
        upoints = None if tokenizer is None else torch.tensor(np.asarray(tokenizer.upoints), dtype=torch.int32, device=device)
        self.register_buffer("upoints", upoints, persistent=False)

    def forward(self, signals: torch.Tensor, signals_length: torch.Tensor, previous_tokens: Optional[torch.Tensor] = None, previous_encoder_states=None,
                previous_decoder_states=None) -> schemas.PredictOutputWithTranscript:
        pin = schemas.PredictInput(signals, signals_length, previous_tokens, previous_encoder_states, previous_decoder_states)
        out = self._recognize(self.model, pin, beam_width=self.beam_width)
        transcript = out.tokens if self.upoints is None else self.upoints[out.tokens.clamp(0, self.upoints.shape[0] - 1)]
        return schemas.PredictOutputWithTranscript(transcript=transcript, tokens=out.tokens, next_tokens=out.next_tokens,
                                                   next_encoder_states=out.next_encoder_states, next_decoder_states=out.next_decoder_states)


def make_inference_fn(model: torch.nn.Module, tokenizer=None, beam_width: int = 0) -> InferenceModule:
    """The model's inference module (JAX ``make_inference_fn`` minus
    ``variables``: the module holds its weights); the transcript is
    codepoints [B, max_tokens, max_chars] with a ``tokenizer``, else the
    tokens."""
    return InferenceModule(model, tokenizer=tokenizer, beam_width=beam_width)


def codepoints_to_text(pts) -> str:
    """Host-side helper: codepoint tensor → string (0 = padding)."""
    return "".join(chr(c) for c in np.asarray(pts).reshape(-1) if c != 0).strip()


def export_program(fn: torch.nn.Module, example_args, path: str) -> torch.export.ExportedProgram:
    """Traces ``fn`` at the example's shapes (every shape static) with
    ``torch.export`` and saves the program to ``path`` (``.pt2``); returns it."""
    with torch.no_grad():
        program = torch.export.export(fn, tuple(example_args))
    torch.export.save(program, path)
    logger.info("exported the program to %s (%d bytes)", path, os.path.getsize(path))
    return program


def load_program(path: str) -> torch.nn.Module:
    """The callable of a ``.pt2`` saved by :func:`export_program` (its
    weights frozen: it serves); registers the port's custom operators
    first, which the program names."""
    from tensorflowasr_tpu_torch.ops.cuda import library  # noqa: F401  (registers the operators)

    return torch.export.load(path).module().requires_grad_(False)


def convert_tflite(fn, example_args, output: str) -> bool:
    """TFLite conversion needs TensorFlow, which the port does not use:
    warns and returns False (JAX ``convert_tflite`` without TensorFlow)."""
    del fn, example_args
    logger.warning("TensorFlow not available — skipping TFLite export to %s", output)
    return False
