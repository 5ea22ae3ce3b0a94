"""Augmentation methods: SpecAugment (frequency and time masking) and
gaussian signal noise (counterpart of
``tensorflowasr_tpu/augmentations/methods.py``).

JAX augments one example at a time under ``vmap``; here each method
augments the whole batch at once. ``draw(x, lengths, generator)`` takes
every random number of the batch from a CPU generator in one call (a few
hundred uniforms, the same on the CPU and on the card; the gaussian noise,
which is signal-sized, is drawn on the tensor's device from a generator
seeded from that stream) and returns the method's parameters on ``x``'s
device; ``apply(x, lengths, params)`` builds the mask with broadcast
compares and applies it in one ``where``. Tests inject JAX's draws into
``apply``. The semantics, as JAX's:

- The mask value (``mean``/``min``/``max``/``zero``/a number) comes from
  the whole example, padded frames included, once per method before its
  masks.
- Frequency: f ∈ [0, max(mask_factor, 1)), then min(f, F), then
  f0 ∈ [0, max(F − f, 1)).
- Time: bound = floor(length · p_upperbound) in float32, t ∈ [0,
  max(bound, 1)), then min(t, length), then t0 ∈ [0, max(length − t, 1));
  ``mask_factor`` is ignored.
- ``prob`` gates each mask (a gated-off mask has width and start 0).
  Lengths never change.

An integer in [0, n) is floor(u · n) of a float32 uniform u (a multiple of
2⁻²⁴), computed in float64, where the product is exact and below n.
"""

from __future__ import annotations

from typing import Union

import torch

MASK_VALUES = ("mean", "min", "max", "zero")


def _check_mask_value(mask_value) -> None:
    if mask_value not in MASK_VALUES and not isinstance(mask_value, (int, float)):
        raise ValueError(f"mask_value must be in {MASK_VALUES} or a number")


def _to(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host tensor on ``device``: to the card by one copy from pinned memory, which does not wait for the card."""
    return t.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else t


def _masked(x: torch.Tensor, cond: torch.Tensor, mask_value: Union[str, float]) -> torch.Tensor:
    """``x`` with ``cond`` set to the mask value of each example (its
    statistic over the whole example, padding included)."""
    if isinstance(mask_value, (int, float)) or mask_value == "zero":
        return x.masked_fill(cond, 0.0 if mask_value == "zero" else float(mask_value))
    dims = tuple(range(1, x.ndim))
    if mask_value == "mean":
        value = x.mean(dim=dims, keepdim=True)
    elif mask_value == "min":
        value = x.amin(dim=dims, keepdim=True)
    else:
        value = x.amax(dim=dims, keepdim=True)
    return torch.where(cond, value, x)


def _spans(index: torch.Tensor, start: torch.Tensor, width: torch.Tensor) -> torch.Tensor:
    """[B, n] True where some mask m covers the position: start[b, m] ≤ i < start[b, m] + width[b, m]."""
    i = index.view(1, 1, -1)
    return ((i >= start[..., None]) & (i < (start + width)[..., None])).any(dim=1)


class AugmentationMethod:
    """A batched augmentation: ``draw`` then ``apply``."""

    def __init__(self, prob: float = 1.0):
        self.prob = prob

    def draw(self, x: torch.Tensor, lengths: torch.Tensor, generator: torch.Generator):
        raise NotImplementedError

    def apply(self, x: torch.Tensor, lengths: torch.Tensor, params) -> torch.Tensor:
        raise NotImplementedError

    def __call__(self, x: torch.Tensor, lengths: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        return self.apply(x, lengths, self.draw(x, lengths, generator))


class FreqMasking(AugmentationMethod):
    """Mask up to ``mask_factor`` frequency bins of [B, T, F] features, ``num_masks`` times."""

    def __init__(self, num_masks: int = 1, mask_factor: int = 27, prob: float = 1.0, mask_value="zero"):
        super().__init__(prob=prob)
        self.num_masks = num_masks
        self.mask_factor = int(mask_factor)
        self.mask_value = mask_value
        _check_mask_value(mask_value)

    def draw(self, x, lengths, generator):
        """(f0, f): [B, num_masks] float64 starts and widths on ``x``'s device
        (they depend only on F, so they are computed before the copy)."""
        freq_len = x.shape[2]
        u = torch.rand((3, x.shape[0], self.num_masks), generator=generator).double()
        on = (u[0] <= self.prob).double()
        f = torch.clamp_max(torch.floor(u[1] * max(self.mask_factor, 1)), freq_len) * on
        f0 = torch.floor(u[2] * torch.clamp_min(freq_len - f, 1)) * on
        params = _to(torch.stack([f0, f]), x.device)
        return params[0], params[1]

    def apply(self, x, lengths, params):
        f0, f = params
        cond = _spans(torch.arange(x.shape[2], device=x.device, dtype=f0.dtype), f0, f)
        return _masked(x, cond[:, None, :], self.mask_value)


class TimeMasking(AugmentationMethod):
    """Mask up to ``p_upperbound · length`` frames of [B, T, F] features, ``num_masks`` times."""

    def __init__(self, num_masks: int = 1, mask_factor: int = 100, p_upperbound: float = 1.0, prob: float = 1.0, mask_value="zero"):
        super().__init__(prob=prob)
        self.num_masks = num_masks
        self.mask_factor = int(mask_factor)  # kept for config parity; the bound comes from p_upperbound
        self.p_upperbound = p_upperbound
        self.mask_value = mask_value
        _check_mask_value(mask_value)

    def draw(self, x, lengths, generator):
        """(t0, t): [B, num_masks] float64 starts and widths on ``x``'s device."""
        u = torch.rand((3, x.shape[0], self.num_masks), generator=generator).double()
        on = (u[0] <= self.prob).double()
        u = _to(torch.stack([u[1] * on, u[2] * on]), x.device)  # a gated-off mask draws width 0 at start 0
        length = lengths.to(torch.float32)
        bound = torch.clamp_min_(torch.floor_(length * self.p_upperbound), 1.0).double()[:, None]
        length = length.double()[:, None]
        t = torch.floor_(u[0] * bound).clamp_max_(length)
        t0 = torch.floor_(torch.clamp_min_(length - t, 1.0).mul_(u[1]))
        return t0, t

    def apply(self, x, lengths, params):
        t0, t = params
        cond = _spans(torch.arange(x.shape[1], device=x.device, dtype=t0.dtype), t0, t)
        return _masked(x, cond[:, :, None], self.mask_value)


class GaussNoise(AugmentationMethod):
    """Additive gaussian noise on [B, N] signals, on the valid samples only."""

    def __init__(self, mean: float = 0.0, stddev: float = 0.075, prob: float = 0.5):
        super().__init__(prob=prob)
        self.mean = mean
        self.stddev = stddev

    def draw(self, x, lengths, generator):
        """(on [B] in x's dtype, noise [B, N] = mean + stddev·N(0, 1))."""
        on = (torch.rand((x.shape[0],), generator=generator) <= self.prob).to(x.dtype)
        seed = int(torch.randint(0, 2**31 - 1, (), generator=generator))
        g = torch.Generator(device=x.device)
        g.manual_seed(seed)
        noise = torch.randn(x.shape, generator=g, dtype=x.dtype, device=x.device).mul_(self.stddev).add_(self.mean)
        return _to(on, x.device), noise

    def apply(self, x, lengths, params):
        on, noise = params
        valid = (torch.arange(x.shape[1], device=x.device) < lengths[:, None]).to(x.dtype)
        return x + noise * valid * on[:, None]
