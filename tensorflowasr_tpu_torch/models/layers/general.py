"""Activations, dense and norm layers (counterpart of
``tensorflowasr_tpu/models/layers/general.py``).

Parameters are f32 and the compute runs in ``dtype`` (bf16 for the
flagship), as flax does with ``param_dtype=f32, dtype=...``: a dense layer
casts input, weight and bias to ``dtype`` (the product accumulates in
f32); norms take f32 statistics and return ``dtype``.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from tensorflowasr_tpu_torch.parallel.collectives import psum

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
    """BatchNorm over the last (channel) axis (flax ``nn.BatchNorm``,
    momentum 0.99, epsilon 1e-3): f32 math, output in ``dtype``.

    Inference normalises with the running statistics. Training normalises
    with the batch statistics over every other axis (padding included) —
    the fast variance E[x²] − E[x]², clipped at 0 — and updates the running
    statistics in place as flax does, with the biased variance:
    ``running = m·running + (1 − m)·batch``. (``torch.nn.BatchNorm`` keeps
    the unbiased variance, so it is not used.)

    ``group`` (set by ``parallel.sharding.sync_batch_norm``; None: this
    process's rows) is the data-parallel process group whose ranks' rows the
    batch statistics cover, as GSPMD's are over the global batch."""

    def __init__(self, features: int, eps: float = 1e-3, momentum: float = 0.99, dtype=torch.float32):
        super().__init__()
        self.eps, self.momentum, self.dtype = eps, momentum, dtype
        self.group = None
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def batch_stats(self, x: torch.Tensor, clip: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
        """(mean, var) over all axes but the last, in f32, from the sums [Σx,
        Σx², count]; updates the running statistics. Under a ``group`` the sums
        are all-reduced first (``parallel.psum``: each rank's rows are
        normalised by them, so the backward sums the cotangents too); one
        rank's group gives what no group gives, bit for bit."""
        x32 = x.float()
        axes, c = tuple(range(x.dim() - 1)), x.shape[-1]
        sums = torch.cat([x32.sum(dim=axes), (x32 * x32).sum(dim=axes), torch.full((1,), float(x32.numel() // c), device=x.device)])
        if self.group is not None:
            sums = psum(sums, self.group)
        mean = sums[:c] / sums[-1]
        var = sums[c:2 * c] / sums[-1] - mean * mean
        if clip:
            var = torch.clamp(var, min=0.0)
        self.update_running(mean, var)
        return mean, var

    @torch.no_grad()
    def update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        m = self.momentum
        self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean.detach())
        self.running_var.copy_(m * self.running_var + (1.0 - m) * var.detach())

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        mean, var = self.batch_stats(x) if train else (self.running_mean, self.running_var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x.float() - mean) * mul + self.bias).to(self.dtype)


def mask_sequence(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Zero the features at padded time positions of [B, T, ...] (JAX ``mask_sequence``)."""
    m = torch.arange(x.shape[1], device=x.device)[None, :] < lengths.to(x.device, torch.int64)[:, None]
    return x * m.reshape(m.shape + (1,) * (x.dim() - 2)).to(x.dtype)


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


@torch.no_grad()
def random_init(module: nn.Module, generator: torch.Generator) -> None:
    """Random weights from ``generator``: lecun-normal matrices and conv
    kernels (std 1/√fan_in), standard-normal embeddings, unit norm scales,
    zero biases and attention biases, trainable residual factors 1 (JAX's
    ``ones``); BatchNorm running stats mean 0, var 1."""
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if p.dim() >= 2 and name.endswith("embeddings.weight"):
            p.copy_(torch.randn(p.shape, generator=generator))
        elif p.dim() >= 2 and not name.endswith("attention_bias"):
            fan_in = math.prod(p.shape[1:])
            p.copy_(torch.randn(p.shape, generator=generator) / math.sqrt(fan_in))
        elif (leaf == "weight" and p.dim() == 1) or leaf == "factor":
            p.fill_(1.0)
        else:
            p.zero_()
    for name, b in module.named_buffers():
        b.fill_(1.0 if name.endswith("running_var") else 0.0)
