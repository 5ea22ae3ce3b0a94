"""Training step and loop on one card (counterpart of
``tensorflowasr_tpu/training/trainer.py``, the JAX ``TFASR_LOSS_IMPL=xla``
configuration).

``make_train_step`` builds ``step_fn(state, batch) → (state, metrics)``:
the training forward to [B, T, U+1, V] logits (dropout from the state's
generator, BatchNorm on batch statistics with its running-statistics
update), the RNN-T loss by the plain anti-diagonal DP with its masked
batch mean, the backward (through the kernels' backward passes on the
card), and one optimizer step; metrics are ``loss`` and ``grad_norm``
(the global L2 norm of the gradients, as ``optax.global_norm``).

One device: no mesh, no data parallelism, no checkpoints, no gaussian
weight noise, no callbacks — each raises or is absent; they are listed in
ROADMAP.md.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Iterable, Optional

import torch

from tensorflowasr_tpu_torch import schemas
from tensorflowasr_tpu_torch.models.transducer.base import Transducer
from tensorflowasr_tpu_torch.ops.rnnt_loss import rnnt_loss_masked_mean
from tensorflowasr_tpu_torch.optimizers import build_optimizer
from tensorflowasr_tpu_torch.utils import device as device_util

logger = logging.getLogger("tensorflowasr_tpu_torch")


@dataclasses.dataclass
class TrainState:
    """The module (its parameters and BatchNorm running statistics), the
    optimizer (its moments), the step count and the dropout generator."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int
    generator: torch.Generator


def global_norm(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """√(Σ g²) over every gradient, in f32."""
    return torch.sqrt(sum((g.float() * g.float()).sum() for g in grads))


def make_train_step(model: torch.nn.Module, on_phase: Optional[Callable[[str], None]] = None) -> Callable:
    """Returns ``step_fn(state, batch: TrainData) -> (state, metrics)``; the
    state is updated in place and returned. ``on_phase`` (for timing) is
    called with "forward", "loss" and "update" as each phase is enqueued."""
    if not isinstance(model, Transducer):
        raise NotImplementedError("only transducer models train in the port yet")
    loss_fn = rnnt_loss_masked_mean
    mark = on_phase or (lambda phase: None)

    def step_fn(state: TrainState, batch: schemas.TrainData):
        state.optimizer.zero_grad(set_to_none=True)
        out = state.model(batch.inputs, train=True, generator=state.generator)
        mark("forward")
        loss = loss_fn(out.logits, out.logits_length, batch.labels.labels, batch.labels.labels_length)
        mark("loss")
        loss.backward()
        grad_norm = global_norm(p.grad for p in state.model.parameters() if p.grad is not None)
        state.optimizer.step()
        mark("update")
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": grad_norm.detach()}

    return step_fn


def make_eval_step(model: torch.nn.Module) -> Callable:
    def step_fn(state: TrainState, batch: schemas.TrainData):
        with torch.no_grad():
            out = state.model(batch.inputs, train=False)
            return {"loss": rnnt_loss_masked_mean(out.logits, out.logits_length, batch.labels.labels, batch.labels.labels_length)}

    return step_fn


class Trainer:
    """Step/epoch orchestrator on one device (None: the CUDA card, raising
    without one; ``"cpu"`` runs the kernels' plain versions). The model is
    moved to the device; batches are moved there at each step."""

    def __init__(self, model: torch.nn.Module, optimizer_config: dict, device=None, on_phase: Optional[Callable[[str], None]] = None):
        self.device = device_util.resolve(device)
        self.model = model.to(self.device)
        self.optimizer_config = dict(optimizer_config)
        self._train_step = make_train_step(self.model, on_phase)
        self._eval_step = make_eval_step(self.model)

    def init_state(self, seed: int = 42) -> TrainState:
        """A fresh optimizer over the model's parameters and a dropout generator seeded with ``seed``."""
        return TrainState(self.model, build_optimizer(self.optimizer_config, self.model.parameters()), 0, torch.Generator().manual_seed(seed))

    def train_step(self, state: TrainState, batch: schemas.TrainData):
        return self._train_step(state, batch.to(self.device))

    def eval_step(self, state: TrainState, batch: schemas.TrainData):
        return self._eval_step(state, batch.to(self.device))

    def fit(self, state: TrainState, train_data: Iterable, epochs: int = 1, steps_per_epoch: Optional[int] = None, eval_data: Optional[Iterable] = None,
            log_every: int = 100) -> TrainState:
        for epoch in range(epochs):
            t0, n, metrics = time.time(), 0, None
            for batch in train_data:
                state, metrics = self.train_step(state, batch)
                n += 1
                if n % log_every == 0:
                    logger.info("epoch %d step %d loss %.4f (%.2f steps/s)", epoch, n, float(metrics["loss"]), n / (time.time() - t0))
                if steps_per_epoch and n >= steps_per_epoch:
                    break
            if eval_data is not None:
                losses = [float(self.eval_step(state, b)["loss"]) for b in eval_data]
                logger.info("epoch %d loss %.4f val_loss %.4f", epoch, float(metrics["loss"]) if metrics else float("nan"),
                            sum(losses) / len(losses) if losses else float("nan"))
        return state
