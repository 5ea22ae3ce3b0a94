"""The training recipe's optimizer in plain PyTorch: the Transformer (Noam)
schedule evaluated in float32, and Adam, decoupled weight decay when the
configuration sets it (``torch.optim.AdamW``'s update, written out)."""

from __future__ import annotations

import math

import numpy as np
import torch

_F32 = np.float32


def _bound(v):
    if v is None or isinstance(v, (int, float)):
        return v
    return float(eval(str(v), {"__builtins__": {}}, {"math": math}))  # a numeric expression such as "0.05/(512**0.5)"


def transformer_lr(cfg: dict, count: int) -> float:
    """scale · d^−0.5 · min(step^−0.5, step · warmup^−1.5) at step = max(count, 1), clamped to max_lr, in float32."""
    step = _F32(max(count, 1))
    lr = _F32(float(cfg["dmodel"]) ** -0.5) * np.minimum(step ** _F32(-0.5), step * _F32(float(cfg.get("warmup_steps", 4000)) ** -1.5))
    lr = _F32(cfg.get("scale", 1.0)) * lr
    if cfg.get("max_lr") is not None:
        lr = np.minimum(_F32(_bound(cfg["max_lr"])), lr)
    return float(lr)


class Adam:
    """Adam over a dict of leaves from an ``optimizer_config`` ({"class_name":
    "Adam", "config": {learning_rate: a number or a TransformerSchedule,
    beta_1, beta_2, epsilon, weight_decay}})."""

    def __init__(self, optimizer_config: dict):
        c = optimizer_config["config"]
        self.lr_cfg = c["learning_rate"]
        self.b1, self.b2, self.eps = float(c.get("beta_1", 0.9)), float(c.get("beta_2", 0.999)), float(c.get("epsilon", 1e-7))
        self.wd = float(c.get("weight_decay") or 0.0)
        self.m, self.v, self.count = {}, {}, 0

    def lr(self, count: int) -> float:
        lr = self.lr_cfg
        if isinstance(lr, dict):
            if lr["class_name"].split(">")[-1] != "TransformerSchedule":
                raise ValueError(f"the reference implements the TransformerSchedule only, not {lr['class_name']}")
            return transformer_lr(lr["config"], count)
        return float(lr)

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        lr = self.lr(self.count)
        self.count += 1
        t = self.count
        for name, p in params.items():
            g = grads.get(name)
            if g is None:
                continue
            if name not in self.m:
                self.m[name], self.v[name] = torch.zeros_like(p), torch.zeros_like(p)
            m, v = self.m[name], self.v[name]
            if self.wd:
                p.mul_(1.0 - lr * self.wd)
            m.lerp_(g, 1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = (v.sqrt() / math.sqrt(1.0 - self.b2**t)).add_(self.eps)
            p.addcdiv_(m, denom, value=-lr / (1.0 - self.b1**t))
