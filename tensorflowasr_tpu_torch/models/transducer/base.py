"""Transducer (RNN-T) model (counterpart of
``tensorflowasr_tpu/models/transducer/base.py``).

``TransducerPrediction`` (embedding or one-hot label encoder → LSTM, GRU
or simple RNN → LayerNorm, over whole label sequences or one ``step``), ``TransducerJoint`` (add/mul merge,
activation, vocab projection), ``Transducer`` with the training forward
(``forward`` → [B, T, U+1, V] logits), ``encode``, ``pred_step``,
``joint_window``, ``decode_step`` and ``init_decoder_states``, the fused
loss's ``forward_joint_inputs`` (→ the prejoint projections), and the
``recognize`` entry point (greedy WIND or frame-synchronous, or beam
search, with the streaming carry of tokens, decoder and encoder states).
WIND decoding runs the fused decode kernel (``ops/cuda/decode_kernel.py``)
for every configuration it takes (:func:`extract_decode_params`), else the
eager loop; beam search runs ``decode_step`` on B·W rows a round. The model
is built on the card unless ``device="cpu"`` is given.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from tensorflowasr_tpu_torch import schemas
from tensorflowasr_tpu_torch.models.layers.embedding import Embedding, OneHotBlank
from tensorflowasr_tpu_torch.models.layers.feature_extraction import FeatureExtraction
from tensorflowasr_tpu_torch.models.layers.general import Dense, LayerNorm, get_activation, random_init
from tensorflowasr_tpu_torch.models.layers.rnn import RNN
from tensorflowasr_tpu_torch.ops import routes, transducer_decode
from tensorflowasr_tpu_torch.ops.cuda import decode_kernel
from tensorflowasr_tpu_torch.ops.cuda.decode_kernel import FusedDecodeParams, FusedLayer, fused_greedy_decode
from tensorflowasr_tpu_torch.utils import device as device_util
from tensorflowasr_tpu_torch.utils import tracing

JOINT_MODES = ("add", "mul")


class TransducerPrediction(nn.Module):
    def __init__(self, blank: int, vocab_size: int, label_encoder_mode: str = "embedding", embed_dim: int = 0, num_rnns: int = 1, rnn_units: int = 512,
                 rnn_type: str = "lstm", rnn_unroll: bool = False, layer_norm: bool = True, projection_units: int = 0, dtype=torch.float32,
                 rnn_impl: str = "auto"):
        super().__init__()
        if label_encoder_mode not in ("embedding", "one_hot"):
            raise ValueError(f"label_encoder_mode {label_encoder_mode!r} must be embedding or one_hot")
        del rnn_unroll  # a compile-time knob of the JAX scan
        self.num_rnns, self.layer_norm, self.projection_units, self.label_encoder_mode = num_rnns, layer_norm, projection_units, label_encoder_mode
        if label_encoder_mode == "embedding":
            self.embedding = Embedding(vocab_size, embed_dim, dtype)
            dim = embed_dim
        else:  # no parameters; the RNN's input width becomes V
            self.one_hot = OneHotBlank(vocab_size, blank, dtype)
            dim = vocab_size
        for i in range(num_rnns):
            self.add_module(f"rnn_{i}", RNN(dim, rnn_units, rnn_type, dtype, rnn_impl))
            dim = rnn_units
            if layer_norm:
                self.add_module(f"ln_{i}", LayerNorm(rnn_units, dtype=dtype))
            if projection_units > 0:
                self.add_module(f"projection_{i}", Dense(rnn_units, projection_units, dtype))
                dim = projection_units

    @property
    def label_encoder(self) -> nn.Module:
        return self.embedding if self.label_encoder_mode == "embedding" else self.one_hot

    def _post(self, i: int, x: torch.Tensor) -> torch.Tensor:
        if self.layer_norm:
            x = getattr(self, f"ln_{i}")(x)
        if self.projection_units > 0:
            x = getattr(self, f"projection_{i}")(x)
        return x

    def forward(self, tokens: torch.Tensor, lengths: torch.Tensor | None = None) -> torch.Tensor:
        """[B, U] tokens → [B, U, P]; positions at or past ``lengths`` encode to 0."""
        x = self.label_encoder(tokens, lengths)
        for i in range(self.num_rnns):
            x, _ = getattr(self, f"rnn_{i}")(x, lengths)
            x = self._post(i, x)
        return x

    def step(self, token: torch.Tensor, states):
        """[B] token + states → ([B, P], new states)."""
        x = self.label_encoder(token[:, None])[:, 0]
        new_states = []
        for i in range(self.num_rnns):
            x, st = getattr(self, f"rnn_{i}").step(x, states[i])
            new_states.append(st)
            x = self._post(i, x)
        return x, tuple(new_states)

    def init_state(self, batch: int, device=None) -> tuple:
        """One zero carry per RNN, in the cell's structure (JAX ``init_state``)."""
        return tuple(getattr(self, f"rnn_{i}").init_state(batch, device) for i in range(self.num_rnns))


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
    kernels' plain versions). ``rnn_impl`` selects the prediction net's
    sequence LSTM (``models/layers/rnn.py``: ``"auto"``, ``"xla"`` or
    ``"pallas"``, the JAX package's ``TFASR_RNN_IMPL``)."""

    def __init__(self, speech_config: dict, encoder_config: dict, prediction_config: dict, joint_config: dict, blank: int = 0, vocab_size: int = 1000,
                 dtype=torch.float32, device=None, rnn_impl: str = "auto"):
        super().__init__()
        dev = device_util.resolve(device)
        self.blank, self.vocab_size, self.dtype = blank, vocab_size, dtype
        self.speech_config, self.encoder_config = dict(speech_config), dict(encoder_config)
        self.prediction_config, self.joint_config = dict(prediction_config), dict(joint_config)
        self.feature_extraction = FeatureExtraction(dtype=dtype, **self.speech_config)
        self.encoder = self.make_encoder()
        self.prediction = TransducerPrediction(blank=blank, vocab_size=vocab_size, dtype=dtype, rnn_impl=rnn_impl, **self.prediction_config)
        pc = self.prediction_config
        pred_dim = pc.get("projection_units", 0) or pc.get("rnn_units", 512)
        jc = dict(self.joint_config)
        # the joint may own a local vocab shard (parallel/tp.py) while the embedding keeps the global vocab (labels are global ids)
        joint_vocab = jc.pop("vocab_size", vocab_size)
        self.joint = TransducerJoint(joint_vocab, self.encoder_output_dim, pred_dim, dtype=dtype, **jc)
        self.to(dev)

    def make_encoder(self) -> nn.Module:
        raise NotImplementedError

    @property
    def encoder_output_dim(self) -> int:
        raise NotImplementedError

    @property
    def time_reduction_factor(self) -> int:
        return self.encoder.time_reduction_factor

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Random weights from ``generator`` (``general.random_init``)."""
        random_init(self, generator)

    # ------------------------------- training ------------------------------- #

    def forward(self, inputs: schemas.TrainInput, train: bool = False, generator: torch.Generator | None = None,
                augment_generator: torch.Generator | None = None) -> schemas.TrainOutput:
        """Training forward (JAX ``Transducer.__call__``): raw audio and
        blank-prepended labels [B, U+1] → logits [B, T, U+1, V] and their
        lengths. ``train``: BatchNorm on batch statistics (updating the
        running ones), with a ``generator`` the encoder's dropout, and the
        config's augmentations drawn from ``augment_generator``."""
        feats, flens = self.feature_extraction(inputs.inputs, inputs.inputs_length, train=train, augment_generator=augment_generator)
        enc, elens, _ = self.encoder(feats, flens, train=train, generator=generator)
        pred = self.prediction(inputs.predictions, inputs.predictions_length)
        return schemas.TrainOutput(logits=self.joint(enc, pred), logits_length=elens)

    def forward_joint_inputs(self, inputs: schemas.TrainInput, train: bool = False, generator: torch.Generator | None = None,
                             augment_generator: torch.Generator | None = None):
        """Training forward that stops before the joint's merge (JAX
        ``Transducer.forward_joint_inputs``): (enc_p [B, T, J], pred_p
        [B, U+1, J], logits_length), the inputs of the fused joint+loss
        (``ops/cuda/joint_loss_kernel.py``), which never materialises the
        [B, T, U+1, V] logits. ``train``, ``generator`` and
        ``augment_generator`` as in :meth:`forward`."""
        feats, flens = self.feature_extraction(inputs.inputs, inputs.inputs_length, train=train, augment_generator=augment_generator)
        enc, elens, _ = self.encoder(feats, flens, train=train, generator=generator)
        pred = self.prediction(inputs.predictions, inputs.predictions_length)
        return self.joint.project_encoder(enc), self.joint.project_prediction(pred), elens

    # ------------------------------ inference ------------------------------- #

    def encode(self, signals: torch.Tensor, signals_length: torch.Tensor, initial_state=None):
        """Raw audio → (encoded, encoded_length, next_encoder_states): the
        encoder's KV memories when ``initial_state`` is given and the encoder
        keeps a memory, else None."""
        feats, flens = self.feature_extraction(signals, signals_length)
        return self.encoder(feats, flens, initial_state=initial_state)

    def decode_step(self, enc_frame: torch.Tensor, prev_tokens: torch.Tensor, states):
        pred, new_states = self.prediction.step(prev_tokens, states)
        return self.joint.step(enc_frame, pred), new_states

    def pred_step(self, prev_tokens: torch.Tensor, states):
        return self.prediction.step(prev_tokens, states)

    def joint_window(self, enc_window: torch.Tensor, pred_out: torch.Tensor) -> torch.Tensor:
        """([B, K, E], [B, P]) → [B, K, V]."""
        return self.joint.merge(self.joint.project_encoder(enc_window), self.joint.project_prediction(pred_out)[:, None, :])

    def init_decoder_states(self, batch: int, device=None):
        """The prediction net's zero carries: per RNN ``(c, h)`` (LSTM), ``h`` (GRU) or ``(h,)`` (simple RNN)."""
        return self.prediction.init_state(batch, device)

    def init_encoder_states(self, batch: int, device=None):
        """The encoder's initial streaming states (one KV memory per block), or None without a memory."""
        return self.encoder.init_state(batch, device)

    def decode_params(self) -> FusedDecodeParams | None:
        """:func:`extract_decode_params` in the model's dtype, cached until a
        prediction or joint parameter changes (``load_state_dict``,
        ``reset_parameters``, an in-place update or a move to another device).
        Under ``torch.export`` the parameters are traced, so nothing is cached."""
        if torch.compiler.is_exporting():
            return extract_decode_params(self, self.dtype)
        key = tuple((p.device, p.data_ptr(), p._version) for p in (*self.prediction.parameters(), *self.joint.parameters()))
        cached = getattr(self, "_decode_params_cache", None)
        if cached is None or cached[0] != key:
            with torch.no_grad():
                cached = (key, extract_decode_params(self, self.dtype))
            self._decode_params_cache = cached
        return cached[1]


def decode_config_taken(model) -> bool:
    """The configurations the fused decode takes, as JAX's: an embedding label
    encoder, an LSTM net, an add/tanh joint with both prejoint linears and
    no post-joint linear."""
    pc, jc = model.prediction_config, model.joint_config
    if pc.get("label_encoder_mode", "embedding") != "embedding" or pc.get("rnn_type", "lstm") != "lstm":
        return False
    if jc.get("joint_mode", "add") != "add" or jc.get("activation", "tanh") != "tanh" or jc.get("postjoint_linear", False):
        return False
    return bool(jc.get("prejoint_encoder_linear", True) and jc.get("prejoint_prediction_linear", True))


def extract_decode_params(model: Transducer, compute_dtype=torch.float32) -> FusedDecodeParams | None:
    """The prediction net's and joint's weights in the fused decode kernel's
    layout and ``compute_dtype`` (JAX ``scripts_dev/decode_kernel.py:93``).
    None for the configurations the kernel does not take, as JAX's: a label
    encoder other than the embedding, an RNN other than the LSTM, a joint
    other than add/tanh, a post-joint linear, a prejoint linear off; and
    for the nets whose shapes it refuses (``decode_kernel.supported``: more
    than 4 LSTM layers, or vectors beyond a block's shared memory), where
    JAX's ``recognize``, plain XLA for any net, has no such limit."""
    if not decode_config_taken(model):
        return None
    pred, joint = model.prediction, model.joint
    cell0 = getattr(pred, "rnn_0").cell
    e, hidden, p = pred.embedding.embeddings.weight.shape[1], cell0.units, pred.projection_units
    if not decode_kernel.supported(e, hidden, p, joint.vocab.weight.shape[1], joint.vocab.weight.shape[0], pred.num_rnns):
        return None
    dt, f32 = compute_dtype, torch.float32
    cast = lambda w: w.detach().to(dt).contiguous()
    layers = []
    for i in range(pred.num_rnns):
        cell = getattr(pred, f"rnn_{i}").cell
        ln = getattr(pred, f"ln_{i}") if pred.layer_norm else None
        proj = getattr(pred, f"projection_{i}") if pred.projection_units > 0 else None
        layers.append(FusedLayer(
            w_ih=cast(cell.weight_ih), w_hh=cast(cell.weight_hh), b=cell.bias.detach().to(dt).to(f32).contiguous(),
            ln=None if ln is None else torch.stack([ln.weight.detach(), ln.bias.detach()]).to(f32).contiguous(),
            proj=None if proj is None else (cast(proj.weight), proj.bias.detach().to(f32).contiguous()),
        ))
    eps = getattr(pred, "ln_0").eps if pred.layer_norm else 1e-3
    return FusedDecodeParams(
        embed=cast(pred.embedding.embeddings.weight), layers=tuple(layers), wp=cast(joint.pred.weight), bp=joint.pred.bias.detach().to(f32).contiguous(),
        wv=cast(joint.vocab.weight), bv=joint.vocab.bias.detach().to(f32).contiguous(), w_enc=cast(joint.enc.weight),
        b_enc=joint.enc.bias.detach().to(f32).contiguous(), hidden=cell.units, ln_eps=float(eps),
    )


@torch.inference_mode()
def recognize(model: Transducer, inputs: schemas.PredictInput, beam_width: int = 0, max_token_factor: int = 2, max_symbols_per_frame=None,
              decode_mode: str = "wind", window: int = 16) -> schemas.PredictOutput:
    """Greedy (or, with ``beam_width`` > 0, beam) decode of raw audio (JAX
    ``recognize`` minus ``variables``: the module holds its weights),
    carrying ``previous_tokens``, ``previous_decoder_states`` and
    ``previous_encoder_states`` into the output's ``next_*`` for streaming.
    Greedy: ``decode_mode`` "wind" (default) or "sync"; WIND falls back to
    sync when ``max_symbols_per_frame`` is set. WIND runs the fused decode
    (one kernel launch on the card, its plain version on the CPU) for every
    configuration :func:`extract_decode_params` takes, else the eager loop.
    Beam: ``transducer_beam_search_decode`` over ``decode_step`` (3 rounds a
    frame, as in JAX; the other options do not apply). Spans (``utils/tracing.py``):
    ``recognize`` ⊃ ``recognize.encode`` (``model.encode``), ``recognize.decode`` (the rest)."""
    with tracing.span("recognize", inputs.inputs):
        with tracing.span("recognize.encode", inputs.inputs):
            encoded, encoded_length, next_encoder_states = model.encode(inputs.inputs, inputs.inputs_length,
                                                                        initial_state=inputs.previous_encoder_states)
        with tracing.span("recognize.decode", encoded):
            return _decode(model, inputs, encoded, encoded_length, next_encoder_states, beam_width, max_token_factor, max_symbols_per_frame,
                           decode_mode, window)


def _decode(model: Transducer, inputs: schemas.PredictInput, encoded, encoded_length, next_encoder_states, beam_width: int, max_token_factor: int,
            max_symbols_per_frame, decode_mode: str, window: int) -> schemas.PredictOutput:
    """:func:`recognize` after the encoder: the decoder's states and the greedy or beam decode."""
    batch, dev = encoded.shape[0], encoded.device
    prev_tokens = inputs.previous_tokens
    prev_tokens = torch.full((batch,), model.blank, dtype=torch.int64, device=dev) if prev_tokens is None else prev_tokens.reshape(batch).to(dev)
    states = inputs.previous_decoder_states
    if states is None:
        states = model.init_decoder_states(batch, dev)
    if beam_width and beam_width > 0:
        tokens, _, next_tokens, next_states = transducer_decode.transducer_beam_search_decode(
            encoded, encoded_length, model.decode_step, prev_tokens, states, beam_width=beam_width, blank=model.blank)
        return schemas.PredictOutput(tokens=tokens, next_tokens=next_tokens, next_encoder_states=next_encoder_states, next_decoder_states=next_states)
    params = model.decode_params() if decode_mode == "wind" and max_symbols_per_frame is None else None
    if decode_mode == "wind" and max_symbols_per_frame is None and decode_config_taken(model):
        routes.take("fused_decode", params is not None)
    if params is not None:
        tokens, _, next_tokens, next_states = fused_greedy_decode(encoded, encoded_length, params, prev_tokens, states, blank=model.blank, window=window,
                                                                  max_token_factor=max_token_factor)
    elif decode_mode == "wind" and max_symbols_per_frame is None:
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
