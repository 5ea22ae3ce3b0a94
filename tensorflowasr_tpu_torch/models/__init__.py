"""Models of the port, and their construction from a config
(counterpart of ``tensorflowasr_tpu/models/__init__.py``)."""

from __future__ import annotations

import torch

from tensorflowasr_tpu_torch import registry


def build_model(model_config: dict, vocab_size: int | None = None, dtype=torch.float32, device=None, **kwargs) -> torch.nn.Module:
    """The model a config's ``model_config`` names (``class_name`` and a flat
    ``config``), on ``device`` (None: the CUDA card) with ``dtype`` compute,
    its weights not yet set (``reset_parameters`` or ``load_state_dict``).
    ``name`` and the Keras regularizers are dropped: weight decay lives in
    the optimizer. ``kwargs`` go to the class's ``from_config`` (a
    transducer's ``rnn_impl``)."""
    cls = registry.get(model_config["class_name"])
    cfg = {k: v for k, v in model_config.get("config", {}).items() if k not in ("name", "kernel_regularizer", "bias_regularizer")}
    return cls.from_config(cfg, vocab_size=vocab_size, dtype=dtype, device=device, **kwargs)
