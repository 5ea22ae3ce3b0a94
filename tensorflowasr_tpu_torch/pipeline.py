"""Config → tokenizer → model → datasets (counterpart of
``tensorflowasr_tpu/scripts/common.py``), as plain functions: what a
training or test script assembles before ``Trainer.fit`` and
``evaluate_dataset``. The command line (``scripts/``) is built on them.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from tensorflowasr_tpu_torch.configs import Config

def load_config(config_path: str, training: bool = True, datadir: Optional[str] = None, modeldir: Optional[str] = None) -> Config:
    """The ``.yml.j2`` config with ``datadir`` and ``modeldir`` (absolute) as template variables when given."""
    custom_vars = {k: os.path.abspath(v) for k, v in (("datadir", datadir), ("modeldir", modeldir)) if v}
    return Config(config_path, training=training, **custom_vars)


def build_tokenizer(config: Config):
    """The config's tokenizer, made (its vocabulary loaded)."""
    from tensorflowasr_tpu_torch import tokenizers

    tokenizer = tokenizers.get(config)
    tokenizer.make()
    return tokenizer


def build_model_from_config(config: Config, tokenizer, mxp: str = "none", device=None, **kwargs) -> torch.nn.Module:
    """The config's model at the tokenizer's vocabulary size on ``device``,
    computing in the dtype of ``utils.env_util.setup_mxp(mxp)``: bf16 for
    "strict" (f32 parameters, as JAX's ``mixed_bfloat16``), f32 for "none",
    and for "auto" bf16 on the card and f32 on the CPU."""
    from tensorflowasr_tpu_torch.models import build_model
    from tensorflowasr_tpu_torch.utils import env_util

    dtype = env_util.setup_mxp(mxp, device)
    return build_model(config.model_config, vocab_size=tokenizer.num_classes, dtype=dtype, device=device, **kwargs)


def build_datasets(config: Config, tokenizer, dataset_type: str = "slice", stages=("train", "eval"), rank: int = 0, world: int = 1) -> dict:
    """``{"train": ..., "eval": ... or None, "test": [...]}`` for the stages asked
    for: the eval dataset only when it names manifests, the enabled test sets."""
    from tensorflowasr_tpu_torch.data import datasets

    def get(dc):
        return datasets.get(tokenizer, dc, dataset_type, rank=rank, world=world)

    data = config.data_config
    out = {}
    if "train" in stages:
        out["train"] = get(data.train_dataset_config)
    if "eval" in stages:
        out["eval"] = get(data.eval_dataset_config) if data.eval_dataset_config.data_paths else None
    if "test" in stages:
        out["test"] = [get(dc) for dc in data.test_dataset_configs if dc.enabled]
    return out
