"""Dropout for the training path.

``keep_mask`` is the plain PyTorch twin of the kernels' in-kernel mask
(``csrc/common.cuh:dropout_keep``), itself the counter hash of
``tensorflowasr_tpu/ops/pallas/attention_kernel.py:_dropout_mask``: the
murmur3 finaliser over ``(row·2654435761) ^ (col·97538843) ^ seed`` in
uint32, kept iff the hash ≥ ``rate·2³²``, kept values scaled by
``1/(1 − rate)``. The same (seed, row, column) give the same mask on the
CPU, on the card, and in the JAX kernels.

``draw_seed`` takes one kernel seed from the training step's
``torch.Generator``; ``dropout`` is the plain dropout of the sites that run
outside a kernel (flax ``nn.Dropout``), its mask drawn from a generator on
the tensor's device seeded from that generator.
"""

from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF
SALT_BH = 40499  # attention: per-(b·h) seed offset
SALT_SITE2 = 7919  # feed-forward: second dropout site


def keep_params(rate: float) -> tuple[int, float]:
    """(uint32 threshold, f32 keep scale) of a dropout rate in [0, 1)."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate} must be in [0, 1)")
    thresh = min(int(rate * 4294967296.0), 4294967295)
    return thresh, float(np.float32(1.0) / np.float32(1.0 - rate))


def kernel_args(seed: int, rate: float) -> tuple[int, int, float, int]:
    """(seed, threshold, keep scale, on) as the C entry points take them."""
    thresh, scale = keep_params(rate)
    return int(seed) & _M32, thresh, scale, int(rate > 0.0)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x · c) mod 2³² for int64 x in [0, 2³²), without int64 overflow."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _hash(seed: torch.Tensor | int, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    x = _mul32(rows, 2654435761) ^ _mul32(cols, 97538843) ^ (torch.as_tensor(seed, dtype=torch.int64, device=rows.device) & _M32)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def keep_mask(seed, rows: torch.Tensor, cols: torch.Tensor, rate: float) -> torch.Tensor:
    """f32 keep factors (0 or 1/(1−rate)) at broadcast (seed, row, col):
    ``rows`` and ``cols`` are int64 index tensors that broadcast together
    (and with ``seed`` when it is a tensor)."""
    thresh, _ = keep_params(rate)
    keep = (_hash(seed, rows, cols) >= thresh).to(torch.float32)
    return keep / torch.tensor(1.0 - rate, dtype=torch.float32)


def row_col_mask(seed: int, n: int, m: int, rate: float, device=None) -> torch.Tensor:
    """[n, m] keep factors indexed by (row, column)."""
    rows = torch.arange(n, dtype=torch.int64, device=device)[:, None]
    cols = torch.arange(m, dtype=torch.int64, device=device)[None, :]
    return keep_mask(seed, rows, cols, rate)


def active_rate(rate: float, train: bool, generator: torch.Generator | None) -> float:
    """The rate in effect at a dropout site: the configured one when
    training with a generator, else 0 (inference, or no randomness given)."""
    return rate if train and generator is not None else 0.0


def draw_seed(generator: torch.Generator) -> int:
    """One int32 seed in [0, 2³¹ − 1) from a CPU generator (no device sync)."""
    return int(torch.randint(0, 2**31 - 1, (), generator=generator))


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None) -> torch.Tensor:
    """Plain inverted dropout (flax ``nn.Dropout``); identity at rate 0 or
    without a generator (inference)."""
    if rate <= 0.0 or generator is None:
        return x
    g = torch.Generator(device=x.device)
    g.manual_seed(draw_seed(generator))
    keep = torch.rand(x.shape, generator=g, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))
