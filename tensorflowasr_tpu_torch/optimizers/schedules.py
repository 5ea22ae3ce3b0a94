"""Learning-rate schedules (counterpart of ``tensorflowasr_tpu/optimizers/schedules.py``).

A schedule maps the count of applied updates to a learning rate, evaluated
on the host in float32 as the JAX package evaluates it
(``jnp.asarray(step, float32)``, Python constants taken at float32). The
count starts at 0 and is clamped to ≥ 1, so updates 0 and 1 both take
``lr(1)``; under gradient accumulation it advances once per applied
update, not per micro-step.

- ``TransformerSchedule`` (Noam): scale · d^-0.5 · min(step^-0.5,
  step · warmup^-1.5), clamped to [min_lr, max_lr]; a string bound such as
  ``"0.05/(144**0.5)"`` is evaluated with a numeric-only ``eval``.
- ``CyclicTransformerSchedule``: triangular cycling around the √ decay.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import numpy as np

_F32 = np.float32


def _eval_lr(v: Union[str, float, None]) -> Optional[float]:
    """A number, or a numeric expression string such as ``"0.05/(144**0.5)"``
    (evaluated without builtins, with ``math`` in scope)."""
    if v is None:
        return None
    if isinstance(v, str):
        return float(eval(v, {"__builtins__": {}}, {"math": math}))  # noqa: S307
    return float(v)


def _step(count) -> np.float32:
    return np.maximum(_F32(count), _F32(1.0))


def _rsqrt(x) -> np.float32:
    return _F32(x) ** _F32(-0.5)


class TransformerSchedule:
    def __init__(self, dmodel, scale=1.0, warmup_steps=4000, max_lr=None, min_lr=None):
        self.dmodel = float(dmodel)
        self.scale = float(scale)
        self.warmup_steps = float(warmup_steps)
        self.max_lr = _eval_lr(max_lr)
        self.min_lr = _eval_lr(min_lr)

    def __call__(self, count) -> float:
        step = _step(count)
        lr = _F32(self.dmodel**-0.5) * np.minimum(step ** _F32(-0.5), step * _F32(self.warmup_steps**-1.5))
        lr = _F32(self.scale) * lr
        if self.max_lr is not None:
            lr = np.minimum(_F32(self.max_lr), lr)
        if self.min_lr is not None:
            lr = np.maximum(_F32(self.min_lr), lr)
        return float(lr)


class CyclicTransformerSchedule:
    def __init__(self, dmodel, step_size, max_lr, warmup_steps=4000):
        self.dmodel = float(dmodel)
        self.warmup_steps = float(warmup_steps)
        self.max_lr = _eval_lr(max_lr)
        self.step_size = float(step_size)

    def __call__(self, count) -> float:
        step = _step(count)
        warmup = step * _F32(self.warmup_steps**-1.5)
        lr = _F32(2.0) * _rsqrt(step)
        lr = _rsqrt(self.dmodel) * np.minimum(lr, warmup)
        lr = np.minimum(_F32(self.max_lr), lr)
        cycle = np.floor(_F32(1) + step / _F32(2 * self.step_size))
        x = np.abs(step / _F32(self.step_size) - _F32(2) * cycle + _F32(1))
        lr = lr * (_F32(0.5) + np.maximum(_F32(0.0), x))
        return float(np.minimum(_F32(self.max_lr), np.minimum(lr, warmup)))


SCHEDULES = {
    "TransformerSchedule": TransformerSchedule,
    "tensorflow_asr.optimizers.schedules>TransformerSchedule": TransformerSchedule,
    "tensorflowasr_tpu.optimizers.schedules>TransformerSchedule": TransformerSchedule,
    "CyclicTransformerSchedule": CyclicTransformerSchedule,
    "tensorflow_asr.optimizers.schedules>CyclicTransformerSchedule": CyclicTransformerSchedule,
    "tensorflowasr_tpu.optimizers.schedules>CyclicTransformerSchedule": CyclicTransformerSchedule,
}


def build_schedule(config: Union[dict, float, str]):
    """A learning-rate config (a number, a numeric string, or
    ``{class_name, config}``) → a float or a schedule ``count → lr``."""
    if isinstance(config, (int, float)):
        return float(config)
    if isinstance(config, str):
        return _eval_lr(config)
    cls = SCHEDULES[config["class_name"]]
    return cls(**config.get("config", {}))
