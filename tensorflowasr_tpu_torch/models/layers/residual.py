"""Weighted residual connection (counterpart of ``models/layers/residual.py``):
``skip + factor · branch`` in the branch's dtype. The factor is a number,
or ``"trainable"``: a scalar parameter ``factor`` (f32, initialised to 1),
cast to the branch's dtype, as JAX's ``Residual``."""

from __future__ import annotations

from typing import Union

import torch
import torch.nn as nn


def residual(skip: torch.Tensor, branch: torch.Tensor, factor: float) -> torch.Tensor:
    return skip + branch * float(factor)


def is_trainable(factor: Union[float, str]) -> bool:
    return isinstance(factor, str)


class Residual(nn.Module):
    def __init__(self, factor: Union[float, str] = 1.0):
        super().__init__()
        if is_trainable(factor):
            if factor != "trainable":
                raise ValueError(f"residual factor {factor!r} must be a number or 'trainable'")
            self.factor = nn.Parameter(torch.ones(()))
        else:
            self.value = float(factor)

    def forward(self, skip: torch.Tensor, branch: torch.Tensor) -> torch.Tensor:
        if hasattr(self, "factor"):
            return skip + self.factor.to(branch.dtype) * branch
        return residual(skip, branch, self.value)
