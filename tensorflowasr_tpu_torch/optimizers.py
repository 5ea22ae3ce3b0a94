"""Optimizer construction from reference-style configs (counterpart of
``tensorflowasr_tpu/optimizers/optimizers.py``), Adam and AdamW only.

``{"class_name": "Adam", "config": {"learning_rate": 1e-4}}`` with the
Keras defaults of the JAX package: beta_1 0.9, beta_2 0.999, epsilon 1e-7;
a ``weight_decay`` makes it AdamW (decoupled, as ``optax.adamw``).
``torch.optim.Adam`` updates as optax does: p −= lr·m̂ / (√v̂ + eps).
Learning-rate schedules, gradient clipping, gradient noise and gradient
accumulation are not ported yet and raise.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch


def build_optimizer(optimizer_config: dict, params: Iterable[torch.nn.Parameter], ga_steps: Optional[int] = None, gradn_config: Optional[dict] = None,
                    clip_norm: Optional[float] = None) -> torch.optim.Optimizer:
    """The training optimizer over ``params``."""
    if ga_steps and ga_steps > 1:
        raise NotImplementedError("gradient accumulation is not ported yet")
    if gradn_config:
        raise NotImplementedError("gradient noise is not ported yet")
    if clip_norm:
        raise NotImplementedError("gradient clipping is not ported yet")
    cfg = dict(optimizer_config or {})
    name = cfg.pop("class_name", "Adam").split(">")[-1].lower()
    conf = dict(cfg.pop("config", {}))
    if name not in ("adam", "adamw"):
        raise NotImplementedError(f"optimizer {name!r} is not ported yet (Adam and AdamW are)")
    lr = conf.pop("learning_rate", 1e-3)
    if not isinstance(lr, (int, float)):
        raise NotImplementedError("learning-rate schedules are not ported yet; give a number")
    kwargs = dict(lr=float(lr), betas=(conf.pop("beta_1", 0.9), conf.pop("beta_2", 0.999)), eps=conf.pop("epsilon", 1e-7))
    weight_decay = conf.pop("weight_decay", None)
    if weight_decay:
        return torch.optim.AdamW(params, weight_decay=float(weight_decay), **kwargs)
    return torch.optim.Adam(params, **kwargs)
