"""Gated linear unit (counterpart of ``models/layers/glu.py``): split the
last axis in half and gate the first half with the sigmoid of the second."""

from __future__ import annotations

import torch


def glu(x: torch.Tensor) -> torch.Tensor:
    a, b = x.chunk(2, dim=-1)
    return a * torch.sigmoid(b)
