"""Conformer Transducer (counterpart of ``tensorflowasr_tpu/models/transducer/conformer.py``),
and the flagship Conformer-Transducer Small configuration."""

from __future__ import annotations

import inspect

import torch

from tensorflowasr_tpu_torch.models.config_utils import learning_config, transducer_kwargs, with_spec_augment
from tensorflowasr_tpu_torch.models.encoders.conformer import ConformerEncoder
from tensorflowasr_tpu_torch.models.transducer.base import Transducer

_ENC_KEYS = set(inspect.signature(ConformerEncoder.__init__).parameters) - {"self", "in_features", "dtype"}


def conformer_small_config(vocab_size: int = 256, num_blocks: int = 16, dmodel: int = 144, dropout: float = 0.1, augment: bool = False) -> dict:
    """The flagship Conformer-Transducer Small (``__graft_entry__._conformer_small``):
    80 mel bins, Conv2d ×4 subsampling with BatchNorm and swish, D=144,
    4 heads of 36, rel-MHA, 31-tap causal conv, embedding 320, one
    LSTM-320 with LayerNorm, add/tanh joint of 320, blank 0. ``augment``
    adds the SpecAugment of ``examples/models/transducer/conformer/small.yml.j2``."""
    config = {
        "speech_config": {"sample_rate": 16000, "frame_ms": 25, "stride_ms": 10, "nfft": 512, "num_feature_bins": 80},
        "encoder_subsampling": {
            "class_name": "tensorflow_asr.models.layers.subsampling>Conv2dSubsampling",
            "config": {
                "filters": [dmodel, dmodel],
                "kernels": [3, 3],
                "strides": [2, 2],
                "paddings": ["causal", "causal"],
                "norms": ["batch", "batch"],
                "activations": ["swish", "swish"],
            },
        },
        "encoder_dmodel": dmodel,
        "encoder_num_blocks": num_blocks,
        "encoder_head_size": dmodel // 4,
        "encoder_num_heads": 4,
        "encoder_mha_type": "relmha",
        "encoder_kernel_size": 31,
        "encoder_dropout": dropout,
        "encoder_padding": "causal",
        "prediction_label_encode_mode": "embedding",
        "prediction_embed_dim": 320,
        "prediction_num_rnns": 1,
        "prediction_rnn_units": 320,
        "prediction_rnn_type": "lstm",
        "prediction_layer_norm": True,
        "joint_dim": 320,
        "joint_activation": "tanh",
        "joint_mode": "add",
        "blank": 0,
        "vocab_size": vocab_size,
    }
    return with_spec_augment(config) if augment else config


def conformer_small_learning_config(modeldir: str = "models") -> dict:
    """The ``learning_config`` of ``examples/models/transducer/conformer/small.yml.j2``
    as parsed: Adam with weight decay 1e-6 under TransformerSchedule(dmodel
    144, warm-up 10,000, max_lr ``"0.05/(144**0.5)"``, scale 2), batch 4,
    ``ga_steps`` 8, TerminateOnNaN, ModelCheckpoint and TensorBoard into
    ``modeldir``/tensorboard."""
    return learning_config(144, 2.0, batch_size=4, ga_steps=8, max_lr="0.05/(144**0.5)", weight_decay=1e-06,
                           callbacks=[{"class_name": "tensorflow_asr.callbacks>ModelCheckpoint", "config": {}},
                                      {"class_name": "tensorflow_asr.callbacks>TensorBoard", "config": {"log_dir": f"{modeldir}/tensorboard"}}])


def conformer_small_streaming_config(vocab_size: int = 1000, num_blocks: int = 16, dropout: float = 0.1, memory_length: int | None = None,
                                     augment: bool = False) -> dict:
    """The streaming Conformer-Transducer Small
    (``examples/models/transducer/conformer/small-streaming.yml.j2``), every
    width as published: the flagship's frontend, subsampling, D 144, 16
    blocks of 4×36 heads, 31-tap causal conv, LSTM-320 and joint 320, with
    causal relative MHSA (``mhsam_causal``) under the chunk mask (chunk 16,
    history 64) and V 1000. ``augment`` adds its SpecAugment. ``memory_length``
    (the JAX encoder's KV-memory option; the example leaves it unset) keeps
    the last M frames of every block's attention input as streaming state."""
    config = conformer_small_config(vocab_size=vocab_size, num_blocks=num_blocks, dropout=dropout, augment=augment)
    config["speech_config"]["feature_type"] = "log_mel_spectrogram"
    config.update(encoder_interleave_relpe=True, encoder_mhsam_causal=True, encoder_chunk_size=16, encoder_history_size=64)
    if memory_length is not None:
        config["encoder_memory_length"] = memory_length
    return config


def conformer_small_streaming_learning_config() -> dict:
    """The ``learning_config`` of ``examples/models/transducer/conformer/small-streaming.yml.j2``
    as parsed: the flagship's schedule without weight decay, batch 4, ``ga_steps`` 8, TerminateOnNaN."""
    return learning_config(144, 2.0, batch_size=4, ga_steps=8, max_lr="0.05/(144**0.5)")


CONFORMER_L_SOURCE = ("Gulati et al., Conformer: Convolution-augmented Transformer for Speech Recognition, Interspeech 2020, "
                      "Table 1, Conformer (L): 17 blocks, D 512, 8 heads, conv kernel 32, 1-layer LSTM-640 decoder")


def conformer_large_config(vocab_size: int = 1024, num_blocks: int = 17, dropout: float = 0.1) -> dict:
    """Conformer-Transducer L (:data:`CONFORMER_L_SOURCE`): the flagship's
    80 log-mel bins at nfft 512, Conv2d ×4 subsampling with filters [512,
    512], BatchNorm and swish, D 512, 17 blocks of 8 relative-MHA heads of
    64, a 32-tap causal conv, FF factor 4 (2048) with residual 0.5, dropout
    0.1; embedding 640, one LSTM-640 with LayerNorm; an add/tanh joint of
    640 over V 1024 (the paper's 1k word pieces), blank 0. ``num_blocks``
    cuts depth only."""
    config = conformer_small_config(vocab_size=vocab_size, num_blocks=num_blocks, dmodel=512, dropout=dropout)
    config.update(encoder_head_size=64, encoder_num_heads=8, encoder_kernel_size=32, encoder_ffm_scale_factor=4, encoder_ffm_residual_factor=0.5,
                  prediction_embed_dim=640, prediction_rnn_units=640, joint_dim=640)
    return config


class Conformer(Transducer):
    def make_encoder(self) -> ConformerEncoder:
        return ConformerEncoder(in_features=self.feature_extraction.config.num_feature_bins, dtype=self.dtype, **self.encoder_config)

    @property
    def encoder_output_dim(self) -> int:
        return self.encoder_config.get("dmodel", 144)

    @classmethod
    def from_config(cls, config: dict, vocab_size: int | None = None, dtype=torch.float32, device=None, rnn_impl: str = "auto") -> "Conformer":
        """Build from a reference-style config dict on ``device`` (None: the
        CUDA card), with the prediction net's LSTM as ``rnn_impl`` selects."""
        return cls(**transducer_kwargs(config, _ENC_KEYS, vocab_size, dtype, device, rnn_impl))
