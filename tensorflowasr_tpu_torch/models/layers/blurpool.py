"""Anti-aliased (blur) pooling, Zhang 2019 "Making Convolutions Shift-Invariant
Again" (counterpart of ``models/layers/blurpool.py``): a strided
convolution with a fixed, normalised binomial low-pass kernel, per channel.

As in the JAX module: the padding (``reflect``, ``symmetric``, ``constant``
or ``valid``) splits k − 1 as floor / ceil between the two sides (the
reference's ``blurpool.py:40-47``), and the blur is depthwise, as in the
upstream antialiased-cnns. The reference's TF port sums all input channels
into every output channel (it drops ``groups=channels``); the JAX module
documents that as a port bug it does not reproduce, and neither does this
one. No model calls these layers; they have no parameters.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

_BINOMIAL = {1: [1.0], 2: [1.0, 1.0], 3: [1.0, 2.0, 1.0], 4: [1.0, 3.0, 3.0, 1.0], 5: [1.0, 4.0, 6.0, 4.0, 1.0], 6: [1.0, 5.0, 10.0, 10.0, 5.0, 1.0],
             7: [1.0, 6.0, 15.0, 20.0, 15.0, 6.0, 1.0]}
PADDINGS = ("reflect", "symmetric", "constant", "valid")


def _pad_amounts(kernel_size: int) -> tuple[int, int]:
    return (kernel_size - 1) // 2, kernel_size // 2


def _pad(x: torch.Tensor, axes: tuple[int, ...], lo: int, hi: int, mode: str) -> torch.Tensor:
    """numpy ``pad`` of ``x`` along ``axes`` in ``mode`` (``symmetric``
    repeats the edge sample, ``reflect`` does not)."""
    for axis in axes:
        n = x.shape[axis]
        if mode == "constant":
            idx = None
        elif mode == "reflect":
            idx = [abs(i) if i < 0 else (2 * (n - 1) - i if i >= n else i) for i in range(-lo, n + hi)]
        else:
            idx = [-1 - i if i < 0 else (2 * n - 1 - i if i >= n else i) for i in range(-lo, n + hi)]
        if idx is None:
            pads = [0, 0] * (x.dim() - 1 - axis) + [lo, hi]
            x = F.pad(x, pads)
        else:
            x = torch.index_select(x, axis, torch.tensor(idx, device=x.device))
    return x


class _BlurPool(nn.Module):
    def __init__(self, kernel_size: int = 4, strides: int = 2, padding: str = "reflect", dtype=torch.float32):
        super().__init__()
        if padding not in PADDINGS:
            raise ValueError(f"padding {padding!r} must be one of {PADDINGS}")
        self.kernel_size, self.strides, self.padding, self.dtype = kernel_size, strides, padding, dtype

    def _taps(self) -> np.ndarray:
        return np.asarray(_BINOMIAL[self.kernel_size])

    def _prepare(self, x: torch.Tensor, axes: tuple[int, ...]) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.padding != "valid":
            x = _pad(x, axes, *_pad_amounts(self.kernel_size), self.padding)
        return x


class BlurPool1D(_BlurPool):
    """[B, T, C] → [B, T', C]."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self._taps()
        c = x.shape[-1]
        w = torch.tensor((k / k.sum()).astype(np.float32), dtype=self.dtype, device=x.device)
        x = self._prepare(x, (1,)).transpose(1, 2)
        return F.conv1d(x, w.reshape(1, 1, -1).expand(c, 1, -1), stride=self.strides, groups=c).transpose(1, 2)


class BlurPool2D(_BlurPool):
    """[B, H, W, C] → [B, H', W', C]."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self._taps()
        k2 = np.outer(k, k)
        c = x.shape[-1]
        w = torch.tensor((k2 / k2.sum()).astype(np.float32), dtype=self.dtype, device=x.device)
        x = self._prepare(x, (1, 2)).permute(0, 3, 1, 2)
        return F.conv2d(x, w[None, None].expand(c, 1, *w.shape), stride=self.strides, groups=c).permute(0, 2, 3, 1)
