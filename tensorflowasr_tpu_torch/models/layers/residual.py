"""Weighted residual connection (counterpart of ``models/layers/residual.py``):
``skip + factor · branch`` in the branch's dtype."""

from __future__ import annotations

import torch


def residual(skip: torch.Tensor, branch: torch.Tensor, factor: float) -> torch.Tensor:
    return skip + branch * float(factor)
