"""Shared script plumbing (counterpart of ``tensorflowasr_tpu/scripts/common.py``):
the config with ``TFASR_DATADIR``/``TFASR_MODELDIR`` set, the model on the
chosen device, and its weights from a checkpoint."""

from __future__ import annotations

import logging
import os

import torch

from tensorflowasr_tpu_torch import pipeline
from tensorflowasr_tpu_torch.configs import Config
from tensorflowasr_tpu_torch.training import pretrained
from tensorflowasr_tpu_torch.utils import device as device_util

logger = logging.getLogger("tensorflowasr_tpu_torch")

INIT_SEED = 0  # the weights without a checkpoint (JAX: model.init with PRNGKey(0))


def load_config(args, training: bool) -> Config:
    """The config, its ``datadir``/``modeldir`` absolute and exported as
    ``TFASR_DATADIR``/``TFASR_MODELDIR`` (JAX ``scripts/common.py:16-24``)."""
    if args.datadir:
        os.environ["TFASR_DATADIR"] = os.path.abspath(args.datadir)
    if args.modeldir:
        os.environ["TFASR_MODELDIR"] = os.path.abspath(args.modeldir)
    return pipeline.load_config(args.config_path, training=training, datadir=args.datadir, modeldir=args.modeldir)


def checkpoint_dir() -> str:
    """``{{modeldir}}/checkpoints``, where ``train`` writes and ``test``/``save``/``export`` read."""
    return os.path.join(os.environ.get("TFASR_MODELDIR", "models"), "checkpoints")


def build_model(config: Config, tokenizer, args, mxp: str = "none", seed: int = INIT_SEED) -> torch.nn.Module:
    """The config's model on ``--device`` (raising without a card unless it is ``cpu``), random weights from ``seed``."""
    model = pipeline.build_model_from_config(config, tokenizer, mxp=mxp, device=device_util.resolve(args.device))
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model


def load_weights(model: torch.nn.Module, args) -> torch.nn.Module:
    """Weights from ``--checkpoint``, else from the newest checkpoint under
    :func:`checkpoint_dir`, else as initialised; every entry is required
    (strict). A checkpoint is the port's (a ``Trainer`` checkpoint
    directory or step, its ``state.pt``, or a ``state_dict`` file) or the
    JAX package's orbax directory (a ``save.py`` or ``convert_checkpoint``
    artifact, a ``Trainer`` directory or step), whose ``params`` and
    ``batch_stats`` map onto the model (``training/pretrained.py``)."""
    path = getattr(args, "checkpoint", None)
    if not path and os.path.isdir(checkpoint_dir()) and any(d.isdigit() for d in os.listdir(checkpoint_dir())):
        path = checkpoint_dir()
    if path:
        model.load_state_dict(pretrained.load_state_dict(path), strict=True)
        logger.info("restored the weights from %s", path)
    return model.eval()
