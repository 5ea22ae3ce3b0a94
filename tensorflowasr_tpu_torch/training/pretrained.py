"""Pretrained warm start: by-name, shape-checked weight loading
(counterpart of ``tensorflowasr_tpu/training/pretrained.py``).

Every entry of the model's ``state_dict`` (parameters and BatchNorm
running statistics) whose name exists in the source with the same shape
is loaded; everything else keeps its initialisation, with a warning for a
shape mismatch, so a smaller or older checkpoint can seed a bigger model.
Nothing loaded raises.

Accepted ``path`` layouts (read with ``torch.load(weights_only=True)``):
  - a ``Trainer`` checkpoint directory (numbered step directories; the
    newest is read), or one step directory of it;
  - a file saved by ``Trainer.save`` (``state.pt``) or a bare
    ``state_dict`` saved with ``torch.save``.

A JAX/orbax artifact is not read here (the port does not import orbax).
"""

from __future__ import annotations

import logging
import os

import torch

logger = logging.getLogger("tensorflowasr_tpu_torch")


def _source_file(path: str) -> str:
    path = os.path.abspath(path)
    if os.path.isdir(path):
        steps = [d for d in os.listdir(path) if d.isdigit()]
        if steps:
            path = os.path.join(path, str(max(int(s) for s in steps)))
        path = os.path.join(path, "state.pt")
    return path


def load_state_dict(path: str) -> dict:
    """The module ``state_dict`` stored at ``path`` (see the module docstring)."""
    obj = torch.load(_source_file(path), map_location="cpu", weights_only=True)
    return obj["model"] if isinstance(obj, dict) and isinstance(obj.get("model"), dict) else obj


def merge_by_name(model: torch.nn.Module, source: dict) -> tuple[int, int]:
    """Copies every same-named, same-shaped tensor of ``source`` into
    ``model``'s ``state_dict``; returns (loaded, kept from init)."""
    target = model.state_dict()
    merged, loaded, skipped = {}, 0, 0
    for name, value in target.items():
        src = source.get(name)
        if src is not None and tuple(src.shape) == tuple(value.shape):
            merged[name] = src.to(dtype=value.dtype)
            loaded += 1
        else:
            if src is not None:
                logger.warning("pretrained: shape mismatch at %s (%s vs %s) — skipped", name, tuple(src.shape), tuple(value.shape))
            skipped += 1
    model.load_state_dict(merged, strict=False)
    return loaded, skipped


def warm_start(state, path: str):
    """Loads pretrained weights and BatchNorm statistics into ``state.model`` by name and shape; returns ``state``."""
    loaded, skipped = merge_by_name(state.model, load_state_dict(path))
    if loaded == 0:
        raise ValueError(f"pretrained checkpoint at {path} shares no same-shaped weights with the model")
    logger.info("pretrained warm start from %s: %d tensors loaded, %d kept from init", path, loaded, skipped)
    return state
