"""Transducer (RNN-T) model (counterpart of
``tensorflowasr_tpu/models/transducer/base.py``).

``TransducerPrediction`` (embedding → LSTM → LayerNorm, over whole label
sequences or one ``step``), ``TransducerJoint`` (add/mul merge,
activation, vocab projection), ``Transducer`` with the training forward
(``forward`` → [B, T, U+1, V] logits), ``encode``, ``pred_step``,
``joint_window``, ``decode_step`` and ``init_decoder_states``, the fused
loss's ``forward_joint_inputs`` (→ the prejoint projections), and the
``recognize`` entry point (greedy WIND or frame-synchronous). The model is
built on the card unless ``device="cpu"`` is given. Beam search is not
ported yet.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from tensorflowasr_tpu_torch import schemas
from tensorflowasr_tpu_torch.models.layers.embedding import Embedding
from tensorflowasr_tpu_torch.models.layers.feature_extraction import FeatureExtraction
from tensorflowasr_tpu_torch.models.layers.general import Dense, LayerNorm, get_activation
from tensorflowasr_tpu_torch.models.layers.rnn import RNN
from tensorflowasr_tpu_torch.ops import transducer_decode
from tensorflowasr_tpu_torch.utils import device as device_util

JOINT_MODES = ("add", "mul")


class TransducerPrediction(nn.Module):
    def __init__(self, blank: int, vocab_size: int, label_encoder_mode: str = "embedding", embed_dim: int = 0, num_rnns: int = 1, rnn_units: int = 512,
                 rnn_type: str = "lstm", rnn_unroll: bool = False, layer_norm: bool = True, projection_units: int = 0, dtype=torch.float32):
        super().__init__()
        if label_encoder_mode != "embedding":
            raise NotImplementedError(f"label_encoder_mode {label_encoder_mode!r} is not ported yet")
        del rnn_unroll  # a compile-time knob of the JAX scan
        self.num_rnns, self.layer_norm, self.projection_units = num_rnns, layer_norm, projection_units
        self.embedding = Embedding(vocab_size, embed_dim, dtype)
        dim = embed_dim
        for i in range(num_rnns):
            self.add_module(f"rnn_{i}", RNN(dim, rnn_units, rnn_type, dtype))
            dim = rnn_units
            if layer_norm:
                self.add_module(f"ln_{i}", LayerNorm(rnn_units, dtype=dtype))
            if projection_units > 0:
                self.add_module(f"projection_{i}", Dense(rnn_units, projection_units, dtype))
                dim = projection_units

    def _post(self, i: int, x: torch.Tensor) -> torch.Tensor:
        if self.layer_norm:
            x = getattr(self, f"ln_{i}")(x)
        if self.projection_units > 0:
            x = getattr(self, f"projection_{i}")(x)
        return x

    def forward(self, tokens: torch.Tensor, lengths: torch.Tensor | None = None) -> torch.Tensor:
        """[B, U] tokens → [B, U, P]; positions at or past ``lengths`` embed to 0."""
        x = self.embedding(tokens, lengths)
        for i in range(self.num_rnns):
            x, _ = getattr(self, f"rnn_{i}")(x, lengths)
            x = self._post(i, x)
        return x

    def step(self, token: torch.Tensor, states):
        """[B] token + states → ([B, P], new states)."""
        x = self.embedding(token[:, None])[:, 0]
        new_states = []
        for i in range(self.num_rnns):
            x, st = getattr(self, f"rnn_{i}").step(x, states[i])
            new_states.append(st)
            x = self._post(i, x)
        return x, tuple(new_states)


class TransducerJoint(nn.Module):
    def __init__(self, vocab_size: int, enc_dim: int, pred_dim: int, joint_dim: int = 1024, activation: str = "tanh", prejoint_encoder_linear: bool = True,
                 prejoint_prediction_linear: bool = True, postjoint_linear: bool = False, joint_mode: str = "add", dtype=torch.float32):
        super().__init__()
        if joint_mode not in JOINT_MODES:
            raise ValueError(f"joint_mode must be in {JOINT_MODES}")
        self.joint_mode, self.act = joint_mode, get_activation(activation)
        self.enc = Dense(enc_dim, joint_dim, dtype) if prejoint_encoder_linear else None
        self.pred = Dense(pred_dim, joint_dim, dtype) if prejoint_prediction_linear else None
        self.ffn = Dense(joint_dim, joint_dim, dtype) if postjoint_linear else None
        self.vocab = Dense(joint_dim, vocab_size, dtype)

    def project_encoder(self, enc: torch.Tensor) -> torch.Tensor:
        return enc if self.enc is None else self.enc(enc)

    def project_prediction(self, pred: torch.Tensor) -> torch.Tensor:
        return pred if self.pred is None else self.pred(pred)

    def merge(self, enc_p: torch.Tensor, pred_p: torch.Tensor) -> torch.Tensor:
        out = enc_p + pred_p if self.joint_mode == "add" else enc_p * pred_p
        if self.ffn is not None:
            out = self.ffn(out)
        return self.vocab(self.act(out))

    def forward(self, enc: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
        """[B, T, E] × [B, U, P] → [B, T, U, V]."""
        return self.merge(self.project_encoder(enc)[:, :, None, :], self.project_prediction(pred)[:, None, :, :])

    def step(self, enc_frame: torch.Tensor, pred_step: torch.Tensor) -> torch.Tensor:
        """[B, E] × [B, P] → [B, V]."""
        return self.merge(self.project_encoder(enc_frame), self.project_prediction(pred_step))


class Transducer(nn.Module):
    """Generic transducer; subclasses provide ``make_encoder``. Built on
    ``device`` (None: the CUDA card, raising without one; ``"cpu"`` runs the
    kernels' plain versions)."""

    def __init__(self, speech_config: dict, encoder_config: dict, prediction_config: dict, joint_config: dict, blank: int = 0, vocab_size: int = 1000,
                 dtype=torch.float32, device=None):
        super().__init__()
        dev = device_util.resolve(device)
        self.blank, self.vocab_size, self.dtype = blank, vocab_size, dtype
        self.speech_config, self.encoder_config = dict(speech_config), dict(encoder_config)
        self.prediction_config, self.joint_config = dict(prediction_config), dict(joint_config)
        self.feature_extraction = FeatureExtraction(dtype=dtype, **self.speech_config)
        self.encoder = self.make_encoder()
        self.prediction = TransducerPrediction(blank=blank, vocab_size=vocab_size, dtype=dtype, **self.prediction_config)
        pc = self.prediction_config
        pred_dim = pc.get("projection_units", 0) or pc.get("rnn_units", 512)
        self.joint = TransducerJoint(vocab_size, self.encoder_output_dim, pred_dim, dtype=dtype, **self.joint_config)
        self.to(dev)

    def make_encoder(self) -> nn.Module:
        raise NotImplementedError

    @property
    def encoder_output_dim(self) -> int:
        raise NotImplementedError

    @property
    def time_reduction_factor(self) -> int:
        return self.encoder.time_reduction_factor

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Random weights from ``generator``: lecun-normal matrices and
        conv kernels (std 1/√fan_in), standard-normal embeddings, unit norm
        scales, zero biases; BatchNorm running stats mean 0, var 1."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if p.dim() >= 2 and name.endswith("embeddings.weight"):
                p.copy_(torch.randn(p.shape, generator=generator))
            elif p.dim() >= 2 and not name.endswith("attention_bias"):
                fan_in = math.prod(p.shape[1:])
                p.copy_(torch.randn(p.shape, generator=generator) / math.sqrt(fan_in))
            elif leaf == "weight" and p.dim() == 1:
                p.fill_(1.0)
            else:
                p.zero_()
        for name, b in self.named_buffers():
            b.fill_(1.0 if name.endswith("running_var") else 0.0)

    # ------------------------------- training ------------------------------- #

    def forward(self, inputs: schemas.TrainInput, train: bool = False, generator: torch.Generator | None = None) -> schemas.TrainOutput:
        """Training forward (JAX ``Transducer.__call__``): raw audio and
        blank-prepended labels [B, U+1] → logits [B, T, U+1, V] and their
        lengths. ``train``: BatchNorm on batch statistics (updating the
        running ones) and, with a ``generator``, the encoder's dropout."""
        feats, flens = self.feature_extraction(inputs.inputs, inputs.inputs_length)
        enc, elens = self.encoder(feats, flens, train=train, generator=generator)
        pred = self.prediction(inputs.predictions, inputs.predictions_length)
        return schemas.TrainOutput(logits=self.joint(enc, pred), logits_length=elens)

    def forward_joint_inputs(self, inputs: schemas.TrainInput, train: bool = False, generator: torch.Generator | None = None):
        """Training forward that stops before the joint's merge (JAX
        ``Transducer.forward_joint_inputs``): (enc_p [B, T, J], pred_p
        [B, U+1, J], logits_length), the inputs of the fused joint+loss
        (``ops/cuda/joint_loss_kernel.py``), which never materialises the
        [B, T, U+1, V] logits. ``train`` and ``generator`` as in :meth:`forward`."""
        feats, flens = self.feature_extraction(inputs.inputs, inputs.inputs_length)
        enc, elens = self.encoder(feats, flens, train=train, generator=generator)
        pred = self.prediction(inputs.predictions, inputs.predictions_length)
        return self.joint.project_encoder(enc), self.joint.project_prediction(pred), elens

    # ------------------------------ inference ------------------------------- #

    def encode(self, signals: torch.Tensor, signals_length: torch.Tensor, initial_state=None):
        """Raw audio → (encoded, encoded_length, next_encoder_states)."""
        if initial_state is not None:
            raise NotImplementedError("streaming encoder states are not ported yet")
        feats, flens = self.feature_extraction(signals, signals_length)
        encoded, lengths = self.encoder(feats, flens)
        return encoded, lengths, None

    def decode_step(self, enc_frame: torch.Tensor, prev_tokens: torch.Tensor, states):
        pred, new_states = self.prediction.step(prev_tokens, states)
        return self.joint.step(enc_frame, pred), new_states

    def pred_step(self, prev_tokens: torch.Tensor, states):
        return self.prediction.step(prev_tokens, states)

    def joint_window(self, enc_window: torch.Tensor, pred_out: torch.Tensor) -> torch.Tensor:
        """([B, K, E], [B, P]) → [B, K, V]."""
        return self.joint.merge(self.joint.project_encoder(enc_window), self.joint.project_prediction(pred_out)[:, None, :])

    def init_decoder_states(self, batch: int, device=None):
        units = self.prediction_config.get("rnn_units", 512)
        zeros = lambda: torch.zeros((batch, units), device=device)
        return tuple((zeros(), zeros()) for _ in range(self.prediction_config.get("num_rnns", 1)))


@torch.inference_mode()
def recognize(model: Transducer, inputs: schemas.PredictInput, beam_width: int = 0, max_token_factor: int = 2, max_symbols_per_frame=None,
              decode_mode: str = "wind", window: int = 16) -> schemas.PredictOutput:
    """Greedy decode of raw audio (JAX ``recognize`` minus ``variables``:
    the module holds its weights). ``decode_mode`` "wind" (default) or
    "sync"; WIND falls back to sync when ``max_symbols_per_frame`` is set."""
    if beam_width and beam_width > 0:
        raise NotImplementedError("beam search is not ported yet")
    encoded, encoded_length, next_encoder_states = model.encode(inputs.inputs, inputs.inputs_length, initial_state=inputs.previous_encoder_states)
    batch, dev = encoded.shape[0], encoded.device
    prev_tokens = inputs.previous_tokens
    prev_tokens = torch.full((batch,), model.blank, dtype=torch.int64, device=dev) if prev_tokens is None else prev_tokens.reshape(batch).to(dev)
    states = inputs.previous_decoder_states
    if states is None:
        states = model.init_decoder_states(batch, dev)
    if decode_mode == "wind" and max_symbols_per_frame is None:
        tokens, _, next_tokens, next_states = transducer_decode.transducer_greedy_decode_wind(
            encoded, encoded_length, model.pred_step, model.joint_window, prev_tokens, states, blank=model.blank, window=window,
            max_token_factor=max_token_factor,
        )
    else:
        tokens, _, next_tokens, next_states = transducer_decode.transducer_greedy_decode(
            encoded, encoded_length, model.decode_step, prev_tokens, states, blank=model.blank, max_token_factor=max_token_factor,
            max_symbols_per_frame=max_symbols_per_frame,
        )
    return schemas.PredictOutput(tokens=tokens, next_tokens=next_tokens, next_encoder_states=next_encoder_states, next_decoder_states=next_states)
