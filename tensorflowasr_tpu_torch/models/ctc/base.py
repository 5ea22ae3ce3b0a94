"""CTC model (counterpart of ``tensorflowasr_tpu/models/ctc/base.py``).

``CtcModel``: feature extraction → encoder → ``vocab`` Dense, with the
training forward (``forward`` → [B, T, V] logits), ``encode`` and the
``recognize`` entry point (greedy, or prefix beam search with an optional
n-gram LM: ``ops/ctc_decode.py``, ``lm.py``; a streaming encoder's KV
memories carried through ``previous_encoder_states``). The model is built
on the card unless ``device="cpu"`` is given.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from tensorflowasr_tpu_torch import schemas
from tensorflowasr_tpu_torch.models.layers.feature_extraction import FeatureExtraction
from tensorflowasr_tpu_torch.models.layers.general import Dense, random_init
from tensorflowasr_tpu_torch.ops import ctc_decode
from tensorflowasr_tpu_torch.utils import device as device_util
from tensorflowasr_tpu_torch.utils import tracing


class CtcModel(nn.Module):
    """Generic CTC over any encoder; subclasses provide ``make_encoder``
    and ``encoder_output_dim``. Built on ``device`` (None: the CUDA card,
    raising without one; ``"cpu"`` runs the kernels' plain versions)."""

    def __init__(self, speech_config: dict, encoder_config: dict, blank: int = 0, vocab_size: int = 29, dtype=torch.float32, device=None):
        super().__init__()
        dev = device_util.resolve(device)
        self.blank, self.vocab_size, self.dtype = blank, vocab_size, dtype
        self.speech_config, self.encoder_config = dict(speech_config), dict(encoder_config)
        self.feature_extraction = FeatureExtraction(dtype=dtype, **self.speech_config)
        self.encoder = self.make_encoder()
        self.vocab = Dense(self.encoder_output_dim, vocab_size, dtype)
        self.to(dev)

    def make_encoder(self) -> nn.Module:
        raise NotImplementedError

    @property
    def encoder_output_dim(self) -> int:
        raise NotImplementedError

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Random weights from ``generator`` (``general.random_init``)."""
        random_init(self, generator)

    def forward(self, inputs: schemas.TrainInput, train: bool = False, generator: torch.Generator | None = None,
                augment_generator: torch.Generator | None = None) -> schemas.TrainOutput:
        """Training forward (JAX ``CtcModel.__call__``): raw audio → logits
        [B, T, V] and their lengths. ``train``: BatchNorm on batch
        statistics (updating the running ones), with a ``generator`` the
        encoder's dropout, and the config's augmentations drawn from
        ``augment_generator``."""
        feats, flens = self.feature_extraction(inputs.inputs, inputs.inputs_length, train=train, augment_generator=augment_generator)
        enc, elens, _ = self.encoder(feats, flens, train=train, generator=generator)
        return schemas.TrainOutput(logits=self.vocab(enc), logits_length=elens)

    def encode(self, signals: torch.Tensor, signals_length: torch.Tensor, initial_state=None):
        """Raw audio → (logits [B, T, V], logits_length, next_encoder_states):
        the encoder's KV memories when ``initial_state`` is given and the
        encoder keeps a memory, else None."""
        feats, flens = self.feature_extraction(signals, signals_length)
        enc, elens, states = self.encoder(feats, flens, initial_state=initial_state)
        return self.vocab(enc), elens, states

    def init_encoder_states(self, batch: int, device=None):
        """The encoder's initial streaming states (one KV memory per block), or None without a memory."""
        return self.encoder.init_state(batch, device)


@torch.inference_mode()
def recognize(model: CtcModel, inputs: schemas.PredictInput, beam_width: int = 0, lm=None, lm_weight: float = 0.5) -> schemas.PredictOutput:
    """Greedy (or, with ``beam_width`` > 0, prefix beam) CTC decode of raw
    audio (JAX ``recognize`` minus ``variables``: the module holds its
    weights): tokens [B, T] left-packed and padded with blank;
    ``next_tokens`` all blank. ``lm``, an ``NGramLM``, adds ``lm_weight``
    times its score to the beam's extensions (shallow fusion). Spans
    (``utils/tracing.py``): ``recognize`` ⊃ ``recognize.encode``, ``recognize.decode``."""
    with tracing.span("recognize", inputs.inputs):
        with tracing.span("recognize.encode", inputs.inputs):
            logits, logits_length, next_encoder_states = model.encode(inputs.inputs, inputs.inputs_length,
                                                                      initial_state=inputs.previous_encoder_states)
        with tracing.span("recognize.decode", logits):
            if beam_width and beam_width > 0:
                tokens, _ = ctc_decode.ctc_beam_search_decode(logits, logits_length, beam_width=beam_width, blank=model.blank,
                                                              lm_score_fn=lm.beam_score_fn() if lm is not None else None,
                                                              lm_weight=lm_weight if lm is not None else 0.0)
            else:
                tokens, _ = ctc_decode.ctc_greedy_decode(logits, logits_length, blank=model.blank)
            next_tokens = torch.full((tokens.shape[0],), model.blank, dtype=torch.int64, device=tokens.device)
    return schemas.PredictOutput(tokens=tokens, next_tokens=next_tokens, next_encoder_states=next_encoder_states, next_decoder_states=None)
