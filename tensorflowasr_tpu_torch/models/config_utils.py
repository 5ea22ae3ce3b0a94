"""Reference-style flat model configs → module kwargs (counterpart of
``tensorflowasr_tpu/models/config_utils.py``): ``encoder_*`` and
``prediction_*`` prefixes and the joint-level keys of e.g.
``examples/models/transducer/conformer/small.yml.j2``."""

from __future__ import annotations


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
