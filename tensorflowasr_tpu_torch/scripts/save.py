"""``save`` subcommand (counterpart of ``tensorflowasr_tpu/scripts/save.py``):
the newest training checkpoint's (or ``--checkpoint``'s) inference
weights, parameters and BatchNorm statistics, saved as one ``state_dict``
file with ``torch.save``, then reloaded into the model as a check."""

from __future__ import annotations

import logging
import os

import torch

from tensorflowasr_tpu_torch import pipeline
from tensorflowasr_tpu_torch.scripts import common

logger = logging.getLogger("tensorflowasr_tpu_torch")


def main(args):
    config = common.load_config(args, training=False)
    tokenizer = pipeline.build_tokenizer(config)
    model = common.load_weights(common.build_model(config, tokenizer, args), args)
    output = os.path.abspath(args.output)
    os.makedirs(os.path.dirname(output), exist_ok=True)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save(state, output)
    restored = torch.load(output, map_location="cpu", weights_only=True)
    model.load_state_dict(restored, strict=True)
    if restored.keys() != state.keys() or not all(torch.equal(restored[k], v) for k, v in state.items()):
        raise RuntimeError(f"the weights reloaded from {output} differ from those saved")
    logger.info("saved + verified %d arrays at %s", len(restored), output)
    return 0
