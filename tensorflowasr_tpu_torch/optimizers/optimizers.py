"""Optimizer construction from reference-style configs (counterpart of
``tensorflowasr_tpu/optimizers/optimizers.py``).

``build_optimizer`` returns the training chain of the JAX package's optax
transformation, in its order: clip by global norm → gradient noise → the
base optimizer → gradient accumulation (optax ``MultiSteps``).

- The base optimizers take the JAX defaults: Adam (beta_1 0.9, beta_2
  0.999, epsilon 1e-7), AdamW when ``weight_decay`` is set (decoupled, as
  ``optax.adamw``), SGD (momentum, nesterov), RMSprop (rho 0.9, epsilon
  1e-7, momentum) and Adadelta (rho 0.95, epsilon 1e-7). ``torch.optim``'s
  Adam, AdamW, SGD and Adadelta update as optax's do; optax's RMSprop does
  not (ε inside the square root, the learning rate applied before the
  momentum trace), so :class:`RMSprop` writes it out.
- The learning rate is a number, a numeric string or a schedule
  (``schedules.py``); a schedule is evaluated at the count of applied
  updates before each one.
- Clipping follows ``optax.clip_by_global_norm``: ``g`` when the norm is
  below ``max_norm``, else ``g / norm · max_norm``.
- Gradient noise (``GradientNoise``) adds N(0, eta / (1 + count)^gamma) from
  its own stream, seeded 42 as JAX's, once ``count >= start_step``.
- Accumulation sums each micro-step's gradients into buffers and divides
  once when every ``ga_steps``-th micro-step applies the inner chain to the
  mean; between applied updates the parameters and every count and moment
  stay as they are.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

import numpy as np
import torch

from tensorflowasr_tpu_torch.optimizers.schedules import build_schedule


class RMSprop(torch.optim.Optimizer):
    """optax ``rmsprop(lr, decay, eps, momentum)`` (``eps_in_sqrt=True``, not
    centered): ν ← decay·ν + (1 − decay)·g², u ← −lr · g / √(ν + ε), and with
    momentum a trace t ← u + momentum·t applied in place of u."""

    def __init__(self, params, lr: float = 1e-3, rho: float = 0.9, eps: float = 1e-7, momentum: float = 0.0):
        super().__init__(params, dict(lr=lr, rho=rho, eps=eps, momentum=momentum))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            for p in params:
                if not self.state[p]:
                    self.state[p]["nu"] = torch.zeros_like(p)
                    if group["momentum"]:
                        self.state[p]["trace"] = torch.zeros_like(p)
            nu = [self.state[p]["nu"] for p in params]
            torch._foreach_mul_(nu, group["rho"])
            torch._foreach_addcmul_(nu, grads, grads, value=1.0 - group["rho"])
            denom = torch._foreach_add(nu, group["eps"])
            torch._foreach_sqrt_(denom)
            updates = torch._foreach_div(grads, denom)
            torch._foreach_mul_(updates, -group["lr"])
            if group["momentum"]:
                trace = [self.state[p]["trace"] for p in params]
                torch._foreach_mul_(trace, group["momentum"])
                torch._foreach_add_(trace, updates)
                updates = trace
            torch._foreach_add_(params, updates)


def build_base_optimizer(optimizer_config: dict, params: Sequence[torch.nn.Parameter]):
    """(optimizer, learning rate: a float or a schedule) from
    ``{"class_name": ..., "config": {...}}`` (JAX ``build_base_optimizer``)."""
    cfg = dict(optimizer_config or {})
    name = cfg.pop("class_name", "Adam").split(">")[-1].lower()
    conf = dict(cfg.pop("config", {}))
    if name in ("adam", "adamw"):
        lr = build_schedule(conf.pop("learning_rate", 1e-3))
        kwargs = dict(betas=(conf.pop("beta_1", 0.9), conf.pop("beta_2", 0.999)), eps=conf.pop("epsilon", 1e-7))
        weight_decay = conf.pop("weight_decay", None)
        if weight_decay:
            return torch.optim.AdamW(params, lr=0.0, weight_decay=float(weight_decay), **kwargs), lr
        return torch.optim.Adam(params, lr=0.0, **kwargs), lr
    if name == "sgd":
        lr = build_schedule(conf.pop("learning_rate", 1e-2))
        momentum = conf.pop("momentum", 0.0)
        # without momentum optax's nesterov trace is the gradient itself; torch refuses the flag there
        return torch.optim.SGD(params, lr=0.0, momentum=momentum, nesterov=bool(momentum and conf.pop("nesterov", False))), lr
    if name == "rmsprop":
        lr = build_schedule(conf.pop("learning_rate", 1e-3))
        return RMSprop(params, rho=conf.pop("rho", 0.9), eps=conf.pop("epsilon", 1e-7), momentum=conf.pop("momentum", 0.0)), lr
    if name == "adadelta":
        lr = build_schedule(conf.pop("learning_rate", 1.0))
        return torch.optim.Adadelta(params, lr=0.0, rho=conf.pop("rho", 0.95), eps=conf.pop("epsilon", 1e-7)), lr
    raise KeyError(f"Unknown optimizer {name!r}")


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """√(Σ g²) over every gradient in f32 (``optax.global_norm``): one
    ``torch._foreach_norm`` over the list, then the norm of the norms. On
    the CPU each tensor's norm is taken in f64 and rounded to f32: PyTorch's
    f32 CPU norm of a 1M-element tensor (Conformer-L's FF and joint weights)
    is off by up to 3e-4 relative."""
    if grads and grads[0].device.type == "cpu":
        return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g.double()) for g in grads])).float()
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm([g.float() for g in grads])))


def clip_by_global_norm(grads: list[torch.Tensor], norm: torch.Tensor, max_norm: float) -> None:
    """In place, as ``optax.clip_by_global_norm``: ``g`` when ``norm`` is
    below ``max_norm``, else ``g / norm · max_norm`` (no host sync)."""
    below = norm < max_norm
    one = torch.ones((), dtype=norm.dtype, device=norm.device)
    torch._foreach_div_(grads, torch.where(below, one, norm))
    torch._foreach_mul_(grads, torch.where(below, one, torch.full_like(norm, max_norm)))


def unit_normals(tensors: Sequence[torch.Tensor], generator: torch.Generator) -> list[torch.Tensor]:
    """N(0, 1) draws shaped like ``tensors``, drawn on their device from a
    generator there seeded from the CPU ``generator`` (as ``ops/dropout.py``)."""
    if not tensors:
        return []
    seed = int(torch.randint(0, 2**31 - 1, (), generator=generator))
    g = torch.Generator(device=tensors[0].device)
    g.manual_seed(seed)
    return [torch.randn(t.shape, generator=g, dtype=t.dtype, device=t.device) for t in tensors]


class GradientNoise:
    """Time-decaying gaussian gradient noise (JAX ``gradient_noise``):
    stddev = √(eta / (1 + count)^gamma), added once ``count >= start_step``;
    ``count`` counts applied updates. Its stream is a CPU generator seeded
    42, independent of the training seed; one seed is taken from it per
    noised update. ``draw(grads)`` returns the unit normals (tests replace it)."""

    def __init__(self, gamma: float = 0.55, eta: float = 1.0, start_step: int = 0):
        self.gamma, self.eta, self.start_step = float(gamma), float(eta), int(start_step)
        self.generator = torch.Generator().manual_seed(42)
        self.count = 0

    def draw(self, grads: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        return unit_normals(grads, self.generator)

    def stddev(self, count: int) -> float:
        f32 = np.float32
        return float(np.sqrt(f32(self.eta) / np.power(f32(1.0) + f32(count), f32(self.gamma))))

    def __call__(self, grads: list[torch.Tensor]) -> None:
        if self.count >= self.start_step:
            torch._foreach_add_(grads, torch._foreach_mul(self.draw(grads), self.stddev(self.count)))
        self.count += 1


class OptimizerChain:
    """clip → gradient noise → base optimizer → accumulation over
    ``params``, with the ``torch.optim.Optimizer`` surface the trainer uses:
    ``zero_grad``, ``step``, ``state_dict``, ``load_state_dict``.

    ``step(grad_norm)`` is called once per micro-step, after the backward;
    ``grad_norm``, when given, is the global norm of this micro-step's
    gradients of exactly ``params`` (clipping then reuses it where no
    accumulation changes the gradients). It returns True when it applied
    an update. ``count`` is the number of applied updates, the argument of
    the schedule."""

    def __init__(self, base: torch.optim.Optimizer, lr, params: Sequence[torch.nn.Parameter], ga_steps: int = 1,
                 clip_norm: Optional[float] = None, gradient_noise: Optional[GradientNoise] = None):
        self.base, self.lr, self.params = base, lr, list(params)
        self.ga_steps = max(int(ga_steps or 1), 1)
        self.clip_norm = float(clip_norm) if clip_norm else None
        self.gradient_noise = gradient_noise
        self.count = 0
        self.mini_step = 0
        self.accumulated: Optional[list[torch.Tensor]] = None

    @property
    def param_groups(self):
        return self.base.param_groups

    def learning_rate(self, count: Optional[int] = None) -> float:
        """The learning rate of update ``count`` (default: the next one)."""
        count = self.count if count is None else count
        return self.lr(count) if callable(self.lr) else self.lr

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.base.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def step(self, grad_norm: Optional[torch.Tensor] = None) -> bool:
        params = [p for p in self.params if p.grad is not None]
        grads = [p.grad for p in params]
        if self.ga_steps > 1:
            if self.accumulated is None:
                self.accumulated = [torch.zeros_like(p) for p in self.params]
            index = {id(p): i for i, p in enumerate(self.params)}
            acc = [self.accumulated[index[id(p)]] for p in params]
            torch._foreach_add_(acc, grads)
            self.mini_step += 1
            if self.mini_step < self.ga_steps:
                return False
            params, grads, grad_norm = self.params, self.accumulated, None
            torch._foreach_div_(grads, float(self.ga_steps))
            for p, g in zip(params, grads):
                p.grad = g
        if self.clip_norm is not None:
            clip_by_global_norm(grads, global_norm(grads) if grad_norm is None else grad_norm, self.clip_norm)
        if self.gradient_noise is not None:
            self.gradient_noise(grads)
        lr = self.learning_rate()
        for group in self.base.param_groups:
            group["lr"] = lr
        self.base.step()
        self.count += 1
        if self.ga_steps > 1:
            for p in self.params:
                p.grad = None
            torch._foreach_zero_(self.accumulated)
            self.mini_step = 0
        return True

    def state_dict(self) -> dict:
        out = {"base": self.base.state_dict(), "count": self.count, "mini_step": self.mini_step}
        if self.accumulated is not None:
            out["accumulated"] = list(self.accumulated)
        if self.gradient_noise is not None:
            out["gradient_noise"] = {"count": self.gradient_noise.count, "generator": self.gradient_noise.generator.get_state()}
        return out

    def load_state_dict(self, state: dict) -> None:
        self.base.load_state_dict(state["base"])
        self.count, self.mini_step = int(state["count"]), int(state["mini_step"])
        if "accumulated" in state:
            self.accumulated = [a.to(device=p.device, dtype=p.dtype).clone() for a, p in zip(state["accumulated"], self.params)]
        if self.gradient_noise is not None:
            self.gradient_noise.count = int(state["gradient_noise"]["count"])
            self.gradient_noise.generator.set_state(state["gradient_noise"]["generator"])


def build_optimizer(optimizer_config: dict, params: Iterable[torch.nn.Parameter], ga_steps: Optional[int] = None, gradn_config: Optional[dict] = None,
                    clip_norm: Optional[float] = None) -> OptimizerChain:
    """The training chain over ``params`` (JAX ``build_optimizer``):
    [clip] → [gradient noise] → optimizer → [accumulation over ``ga_steps``]."""
    params = list(params)
    base, lr = build_base_optimizer(optimizer_config, params)
    noise = None
    if gradn_config:
        noise = GradientNoise(gamma=gradn_config.get("gamma", 0.55), eta=gradn_config.get("eta", 1.0),
                              start_step=gradn_config.get("step_start", gradn_config.get("start_step", 0)))
    return OptimizerChain(base, lr, params, ga_steps=ga_steps or 1, clip_norm=clip_norm, gradient_noise=noise)

