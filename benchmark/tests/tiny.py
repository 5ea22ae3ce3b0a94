"""A tiny configuration and traffic for the CPU tests: every layer of the
cells' Conformer-Transducer at small widths, f32 compute."""

from __future__ import annotations

import copy

import torch

from benchmark.harness import common
from benchmark.run import Context

SPEC = {"feature_augment": {"freq_masking": {"prob": 1.0, "num_masks": 1, "mask_factor": 27, "mask_value": 0},
                            "time_masking": {"prob": 1.0, "num_masks": 10, "mask_factor": -1, "p_upperbound": 0.05, "mask_value": 0}}}


def config(dtype: str = "float32", dropout: float = 0.1) -> dict:
    c = copy.deepcopy(common.load("configs", "conformer_l"))
    m = c["model_config"]["config"]
    m.update(encoder_dmodel=32, encoder_num_blocks=2, encoder_head_size=8, encoder_num_heads=4, encoder_kernel_size=5, encoder_dropout=dropout,
             prediction_embed_dim=24, prediction_rnn_units=20, joint_dim=28, vocab_size=16)
    m["encoder_subsampling"]["config"]["filters"] = [8, 8]
    m["speech_config"]["augmentation_config"] = SPEC
    c.update(compute_dtype=dtype, rnn_impl="auto", blank_bias=1.0, reference_rows=2, serve_model={"weights_seed": 11, "blank_bias": 0.0, "blank_row_scale": 4.0})
    c["optimizer"]["config"]["learning_rate"]["config"].update(dmodel=32, warmup_steps=2, max_lr=1e-3)
    return c


TRAIN = {"driver": "train", "batch": 3, "pool": 4, "layout_seed": 1, "sample_rate": 16000,
         "lengths_s": {"median": 0.7, "sigma": 0.35, "min": 0.3, "max": 1.0}, "pad_s": 1.0, "tokens_per_s": 4.0, "max_labels": 5, "amplitude": 0.1}
SERVE = {"driver": "serve", "batch": 3, "requests": 4, "layout_seed": 2, "sample_rate": 16000,
         "lengths_s": {"median": 0.7, "sigma": 0.6, "min": 0.3, "max": 1.5}, "amplitude": 0.1, "check_requests": 2,
         "envelope": {"segment_s": 0.2, "level_db": 40.0, "tilt": 0.9}}


def context(traffic: dict, seed: int = 12345, cfg: dict | None = None, seconds: float = 0.5, plant=None) -> Context:
    ctx = Context({"name": "tiny", "chips": 1}, cfg or config(), traffic, seed, seconds, False, 0.0, torch.device("cpu"),
                  common.PEAKS["NVIDIA H100 80GB HBM3"])
    if plant is not None:
        ctx.plant = plant
    return ctx
