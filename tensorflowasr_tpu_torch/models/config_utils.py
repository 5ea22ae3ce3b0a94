"""Reference-style flat model configs → module kwargs (counterpart of
``tensorflowasr_tpu/models/config_utils.py``): ``encoder_*`` and
``prediction_*`` prefixes and the joint-level keys of e.g.
``examples/models/transducer/conformer/small.yml.j2``."""

from __future__ import annotations

from tensorflowasr_tpu_torch.configs import LearningConfig


def strip_prefix(config: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in config.items() if k.startswith(prefix)}


def parse_prediction_config(config: dict) -> dict:
    p = strip_prefix(config, "prediction_")
    out = {}
    if "label_encode_mode" in p:
        out["label_encoder_mode"] = p["label_encode_mode"]
    for k in ("embed_dim", "num_rnns", "rnn_units", "rnn_type", "rnn_unroll", "layer_norm", "projection_units"):
        if k in p:
            out[k] = p[k]
    return out


def parse_joint_config(config: dict) -> dict:
    out = {}
    if "joint_dim" in config:
        out["joint_dim"] = config["joint_dim"]
    if "joint_activation" in config:
        out["activation"] = config["joint_activation"]
    if "joint_mode" in config:
        out["joint_mode"] = config["joint_mode"]
    for k in ("prejoint_encoder_linear", "prejoint_prediction_linear", "postjoint_linear"):
        if k in config:
            out[k] = config[k]
    return out


def filter_kwargs(config: dict, allowed) -> dict:
    return {k: v for k, v in config.items() if k in allowed}


def transducer_kwargs(config: dict, encoder_keys, vocab_size: int | None, dtype, device, rnn_impl) -> dict:
    """A reference-style transducer config as the ``Transducer`` constructor's
    arguments: the ``encoder_*`` keys the encoder takes, the prediction and
    joint sections, blank and the vocabulary (1000 when neither names one)."""
    return dict(
        speech_config=dict(config.get("speech_config", {})),
        encoder_config=filter_kwargs(strip_prefix(config, "encoder_"), encoder_keys),
        prediction_config=parse_prediction_config(config),
        joint_config=parse_joint_config(config),
        blank=config.get("blank", 0),
        vocab_size=vocab_size or config.get("vocab_size", 1000),
        dtype=dtype,
        device=device,
        rnn_impl=rnn_impl,
    )


# The published examples' train-time augmentation (every example the port builds uses this one)
SPEC_AUGMENT = {
    "feature_augment": {
        "time_masking": {"prob": 1.0, "num_masks": 10, "mask_factor": -1, "p_upperbound": 0.05, "mask_value": 0},
        "freq_masking": {"prob": 1.0, "num_masks": 1, "mask_factor": 27, "mask_value": 0},
    }
}


def with_spec_augment(config: dict) -> dict:
    """``config`` with the examples' ``augmentation_config`` in its ``speech_config``."""
    return {**config, "speech_config": {**config["speech_config"], "augmentation_config": SPEC_AUGMENT}}


def learning_config(dmodel: int, scale: float, batch_size: int, ga_steps: int, max_lr: str | None = None, weight_decay: float | None = None,
                    callbacks: list | None = None) -> dict:
    """An example's ``learning_config`` as ``configs.LearningConfig`` reads
    it: Adam (β₁ 0.9, β₂ 0.98, ε 1e-9) under a ``TransformerSchedule``
    (warm-up 10,000; ``max_lr`` kept a string), 300 epochs,
    ``TerminateOnNaN`` first among the callbacks, and the class's defaults
    (no gradient or weight noise, no pretrained weights)."""
    schedule = {"dmodel": dmodel, "warmup_steps": 10000, **({"max_lr": max_lr} if max_lr else {}), "scale": scale}
    optimizer = {"learning_rate": {"class_name": "tensorflow_asr.optimizers.schedules>TransformerSchedule", "config": schedule},
                 "beta_1": 0.9, "beta_2": 0.98, "epsilon": 1e-09, **({"weight_decay": weight_decay} if weight_decay else {})}
    return LearningConfig({"optimizer_config": {"class_name": "Adam", "config": optimizer}, "batch_size": batch_size, "ga_steps": ga_steps,
                           "num_epochs": 300,
                           "callbacks": [{"class_name": "tensorflow_asr.callbacks>TerminateOnNaN", "config": {}}, *(callbacks or [])]}).to_dict()
