"""Activations, dense and norm layers (counterpart of
``tensorflowasr_tpu/models/layers/general.py``).

Parameters are f32 and the compute runs in ``dtype`` (bf16 for the
flagship), as flax does with ``param_dtype=f32, dtype=...``: a dense layer
casts input, weight and bias to ``dtype`` (the product accumulates in
f32); norms take f32 statistics and return ``dtype``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

ACTIVATIONS: dict[str, Callable] = {
    "linear": lambda x: x,
    "none": lambda x: x,
    "relu": F.relu,
    "swish": F.silu,
    "silu": F.silu,
    "tanh": torch.tanh,
}


def get_activation(name: Optional[str]) -> Callable:
    if name is None:
        return ACTIVATIONS["linear"]
    try:
        return ACTIVATIONS[name.lower()]
    except KeyError as e:
        raise KeyError(f"Unknown activation {name!r}; available: {sorted(ACTIVATIONS)}") from e


class Dense(nn.Module):
    """``nn.Dense`` counterpart: y = x·Wᵀ + b in ``dtype`` (weight [out, in])."""

    def __init__(self, in_features: int, out_features: int, dtype=torch.float32, bias: bool = True):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt), None if self.bias is None else self.bias.to(dt))


class LayerNorm(nn.Module):
    """``nn.LayerNorm(epsilon=1e-3)`` counterpart: f32 statistics, output in ``dtype``."""

    def __init__(self, dim: int, eps: float = 1e-3, dtype=torch.float32):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), x.shape[-1:], self.weight, self.bias, self.eps).to(self.dtype)


class BatchNorm(nn.Module):
    """Inference BatchNorm over the last (channel) axis with running
    statistics (``nn.BatchNorm(use_running_average=True, epsilon=1e-3)``):
    f32 math, output in ``dtype``. Training statistics arrive with the
    training slice."""

    def __init__(self, features: int, eps: float = 1e-3, dtype=torch.float32):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return ((x.float() - self.running_mean) * mul + self.bias).to(self.dtype)


def make_norm(kind: Optional[str], features: int, dtype=torch.float32) -> nn.Module:
    """Config-selected normalization: "batch" | "layer" | "none" (the
    module itself, so parameter names match the JAX tree once ``bridge``
    drops flax's inner ``BatchNorm_0`` scope)."""
    if kind == "batch":
        return BatchNorm(features, dtype=dtype)
    if kind == "layer":
        return LayerNorm(features, dtype=dtype)
    if kind in ("none", None):
        return nn.Identity()
    raise ValueError(f"Unknown norm kind {kind!r}")
