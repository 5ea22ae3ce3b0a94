"""Training step and loop, on one card a process (counterpart of
``tensorflowasr_tpu/training/trainer.py``).

``make_train_step`` builds ``step_fn(state, batch) → (state, metrics)``,
one micro-step: the training forward (dropout from the state's generator,
the config's augmentations from its augment generator, BatchNorm on batch
statistics with its running-statistics update), the RNN-T loss with its
masked batch mean over valid rows, the backward (through the kernels'
backward passes on the card), and one step of the optimizer chain; metrics
are ``loss`` and ``grad_norm`` (the global L2 norm of the gradients, as
``optax.global_norm``).

``loss_impl`` takes the values of the JAX package's ``TFASR_LOSS_IMPL``,
as an argument instead of an environment variable:

- ``"auto"`` (the default) and ``"fused-joint"``: the forward stops at the
  joint's prejoint projections (``Transducer.forward_joint_inputs``) and
  the fused joint+loss (``ops/cuda/joint_loss_kernel.py``) computes the
  loss without the [B, T, U+1, V] logits — for the add/tanh joint with
  both prejoint linears. Any other joint takes the unfused Pallas loss, as
  in JAX.
- ``"xla"``: the forward to [B, T, U+1, V] logits and the plain
  anti-diagonal DP with autograd (``ops/rnnt_loss.py``).
- ``"pallas"``: the forward to logits and the unfused Pallas loss
  (``ops/cuda/rnnt_kernel.py:rnnt_loss_pallas``).

``make_eval_step`` computes the loss over logits as ``get_rnnt_loss_fn``
(``ops/losses.py``) dispatches it: the plain DP for ``"xla"``, the
unfused Pallas loss for every other value.

A CTC model (``models/ctc``) trains and evaluates on the CTC loss over its
[B, T, V] logits that ``get_ctc_loss_fn(loss_impl)`` selects: the CTC
kernel for ``"auto"`` and ``"pallas"``, the plain α recursion for
``"xla"`` and ``"fused-joint"``; the fused joint+loss is transducer-only.

The optimizer is the chain of ``optimizers/`` (schedule, clipping,
gradient noise, accumulation over ``ga_steps`` micro-steps); the step
passes it the micro-step's global norm, computed once with
``torch._foreach_norm``, which is also the ``grad_norm`` metric (before
clipping, as JAX ``trainer.py:198``). Gaussian weight noise (``gwn_config``,
JAX ``_apply_gwn``) takes the loss and gradients at ``params + stddev·N(0,
1)`` on the selected top-level modules from micro-step ``gwn_config["step"]``
on, and applies the gradients to the clean parameters.

Random streams, each its own CPU generator in the ``TrainState``: dropout
(``generator``, seeded with the seed), augmentation and weight noise
(seeded from the seed and a stream offset); the gradient noise's lives in
the optimizer chain (seeded 42, as JAX's). Device-sized noise is drawn on
the device from a generator seeded from its CPU stream.

``Trainer`` saves numbered step checkpoints under ``checkpoint_dir`` (the
module's ``state_dict`` with BatchNorm statistics, the chain's state with
its accumulation buffers and mini-step, the step, every generator's state),
keeps the newest ``keep_checkpoints``, and restores the newest; ``fit``
runs the callbacks (``training/callbacks.py``) as JAX's does.

Data parallelism (JAX: a ``data`` mesh over every device, the batch
sharded along it, GSPMD's all-reduces): one process a card in one
``torch.distributed`` group (``parallel/sharding.py``). ``Trainer`` is
data-parallel under a 1-D ``mesh`` (default: one over the group when it
has more than one rank), and each rank's step then equals the one-device
step on the global batch: the BatchNorm statistics are taken over every
rank's rows (``parallel.sharding.sync_batch_norm``), each rank's loss is
Σ(its valid rows' losses) / (the global valid count), the gradients are
summed over the ranks in one flat bucket before the chain's norm,
clipping and noise, and the reported loss is the ranks' sum. Every rank
starts from rank 0's weights and ends each step with the same parameters,
statistics and optimizer state. The dropout and augmentation generators
fold in the rank (each rank's rows draw their own masks); the weight-noise
and gradient-noise streams do not (the parameters must stay equal).
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import logging
import os
import shutil
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

from tensorflowasr_tpu_torch import schemas
from tensorflowasr_tpu_torch.models.ctc.base import CtcModel
from tensorflowasr_tpu_torch.models.transducer.base import Transducer
from tensorflowasr_tpu_torch.ops import routes
from tensorflowasr_tpu_torch.ops.cuda import joint_loss_kernel, rnnt_kernel
from tensorflowasr_tpu_torch.ops.cuda.joint_loss_kernel import rnnt_loss_fused_joint
from tensorflowasr_tpu_torch.ops.losses import get_ctc_loss_fn, get_rnnt_loss_fn
from tensorflowasr_tpu_torch.ops.rnnt_loss import rnnt_loss, sanitize_lengths, valid_mean
from tensorflowasr_tpu_torch.optimizers import OptimizerChain, build_optimizer
from tensorflowasr_tpu_torch.optimizers.optimizers import global_norm, unit_normals
from tensorflowasr_tpu_torch.parallel import sharding
from tensorflowasr_tpu_torch.parallel.collectives import all_reduce_, pmax, sum_no_grad
from tensorflowasr_tpu_torch.utils import device as device_util
from tensorflowasr_tpu_torch.utils import tracing

logger = logging.getLogger("tensorflowasr_tpu_torch")


AUGMENT_STREAM, WEIGHT_NOISE_STREAM = 2**32, 2**33  # seed offsets of the augmentation and weight-noise generators
RANK_STREAM = 2**40  # × the data-parallel rank: the dropout and augmentation seeds' offset


@dataclasses.dataclass
class TrainState:
    """The module (its parameters and BatchNorm running statistics), the
    optimizer chain (its moments, counts and accumulation buffers), the
    micro-step count and the CPU generators of dropout, augmentation and
    weight noise."""

    model: torch.nn.Module
    optimizer: OptimizerChain
    step: int
    generator: torch.Generator
    augment_generator: Optional[torch.Generator] = None
    weight_noise_generator: Optional[torch.Generator] = None

    def generators(self) -> dict:
        return {"dropout": self.generator, "augment": self.augment_generator, "weight_noise": self.weight_noise_generator}


def make_state(model: torch.nn.Module, optimizer: OptimizerChain, seed: int, rank: int = 0) -> TrainState:
    """A state at step 0: the dropout generator seeded with ``seed``, the
    augmentation and weight-noise generators with ``seed`` plus their stream
    offsets, the first two also with ``rank``'s (:data:`RANK_STREAM`)."""
    fold = rank * RANK_STREAM
    return TrainState(model, optimizer, 0, torch.Generator().manual_seed(seed + fold), torch.Generator().manual_seed(AUGMENT_STREAM + seed + fold),
                      torch.Generator().manual_seed(WEIGHT_NOISE_STREAM + seed))


class WeightNoise:
    """Gaussian weight noise (JAX ``trainer._apply_gwn``): ``stddev·N(0, 1)``
    on every parameter of the top-level modules ``modules`` (None: all),
    from micro-step ``step`` on. JAX names the modules by their flax names,
    which ``bridge.py``'s rules leave unchanged at the top level
    (``encoder``, ``prediction``, ``joint``, ``vocab``). BatchNorm statistics
    are buffers and never noised. ``draw(generator)`` returns the noise
    (tests replace it)."""

    def __init__(self, model: torch.nn.Module, gwn_config: dict):
        self.stddev = float(gwn_config.get("stddev", 0.075))
        self.start = int(gwn_config.get("step", 0))
        modules = gwn_config.get("modules")
        self.named = [(n, p) for n, p in model.named_parameters() if modules is None or n.split(".")[0] in modules]

    def draw(self, generator: torch.Generator) -> list[torch.Tensor]:
        return torch._foreach_mul(unit_normals([p for _, p in self.named], generator), self.stddev)

    @torch.no_grad()
    def perturb(self, generator: torch.Generator) -> list[torch.Tensor]:
        """Adds the noise in place; returns the clean values, which
        :meth:`restore` copies back (``p + n − n`` is not ``p`` in floating point)."""
        params = [p for _, p in self.named]
        saved = [p.detach().clone() for p in params]
        torch._foreach_add_(params, self.draw(generator))
        return saved

    @torch.no_grad()
    def restore(self, saved: list[torch.Tensor]) -> None:
        torch._foreach_copy_([p for _, p in self.named], saved)


def fused_joint_supported(model: torch.nn.Module) -> bool:
    """The joint the fused joint+loss takes (JAX ``trainer._fused_joint_supported``):
    add merge, tanh, no postjoint linear, both prejoint linears."""
    if not isinstance(model, Transducer):
        return False
    jc = model.joint_config
    return (jc.get("joint_mode", "add") == "add" and jc.get("activation", "tanh") == "tanh" and not jc.get("postjoint_linear", False)
            and jc.get("prejoint_encoder_linear", True) and jc.get("prejoint_prediction_linear", True))


def fused_joint_loss(model: Transducer, inputs: schemas.TrainInput, labels: schemas.TrainLabel, generator=None, mark=lambda phase: None,
                     augment_generator=None, group=None):
    """The fused path's masked-mean loss (JAX ``trainer.py:142-173``): the
    forward to the prejoint projections, the lengths sanitised as
    ``masked_mean`` does, the fused joint+loss on this rank's rows, and the
    mean over valid rows (under a data-parallel ``group``, this rank's share
    of the global one: ``valid_mean``). ``mark("forward")`` is called after the forward.
    Where the kernels refuse the joint width (``joint_loss_kernel.supported``)
    or the DP the label positions (``rnnt_kernel.supported``), the joint's
    plain logits and the plain DP, with autograd (JAX's fused joint has no
    shape guard: the plain route is the port's, recorded in ``ops/routes.py``)."""
    enc_p, pred_p, elens = model.forward_joint_inputs(inputs, train=True, generator=generator, augment_generator=augment_generator)
    mark("forward")
    valid, safe_t, safe_u = sanitize_lengths(elens.to(enc_p.device), labels.labels_length, enc_p.shape[1])
    wv, bv = model.joint.vocab.weight.to(enc_p.dtype), model.joint.vocab.bias.float()
    if routes.take("rnnt_fused_joint", joint_loss_kernel.supported(enc_p.shape[-1], enc_p.dtype) and rnnt_kernel.supported(pred_p.shape[1])):
        loss = rnnt_loss_fused_joint(enc_p, pred_p, wv, bv, safe_t, labels.labels, safe_u)
    else:
        loss = rnnt_loss(joint_loss_kernel.joint_logits_plain(enc_p, pred_p, wv, bv), safe_t, labels.labels, safe_u)
    return valid_mean(loss, valid, group)


def _loss_for(model: torch.nn.Module, loss_impl: str, group=None) -> Callable:
    """The masked-mean loss over logits (JAX ``trainer._loss_for``) that
    ``loss_impl`` selects for the model's family: RNN-T for a
    ``Transducer``, CTC for a ``CtcModel`` (``group``: ``ops.losses.masked_mean``)."""
    if isinstance(model, Transducer):
        return get_rnnt_loss_fn(loss_impl, group)
    if isinstance(model, CtcModel):
        return get_ctc_loss_fn(loss_impl, group)
    raise TypeError(f"no loss for a {type(model).__name__}: a Transducer or a CtcModel trains")


def make_train_loss(model: torch.nn.Module, loss_impl: str = "auto", group=None) -> Callable:
    """``loss(model, inputs, labels, generator=None, mark=..., augment_generator=None)``: the
    training forward and the masked-mean loss of one batch, as the train step
    computes it (JAX ``trainer.py:119-187``): the fused joint+loss for
    ``"auto"``/``"fused-joint"`` with a joint it takes, else the loss over
    the logits that :func:`_loss_for` selects. ``mark("forward")`` is called
    after the forward. Under a data-parallel ``group``: this rank's share of
    the global masked mean."""
    loss_fn = _loss_for(model, loss_impl, group)
    if loss_impl in ("auto", "fused-joint") and fused_joint_supported(model):
        return functools.partial(fused_joint_loss, group=group)

    def loss(model, inputs: schemas.TrainInput, labels: schemas.TrainLabel, generator=None, mark=lambda phase: None, augment_generator=None):
        out = model(inputs, train=True, generator=generator, augment_generator=augment_generator)
        mark("forward")
        return loss_fn(out.logits, out.logits_length, labels.labels, labels.labels_length)

    return loss


def _same(a: list, b: list) -> bool:
    return len(a) == len(b) and all(x is y for x, y in zip(a, b))


def make_train_step(model: torch.nn.Module, on_phase: Optional[Callable[[str], None]] = None, loss_impl: str = "auto",
                    weight_noise: Optional[WeightNoise] = None, group=None) -> Callable:
    """Returns ``step_fn(state, batch: TrainData) -> (state, metrics)``, one
    micro-step; the state is updated in place and returned. ``on_phase``
    (for timing) is called with "forward", "loss" and "update" as each
    phase is enqueued; the spans ``train.step`` ⊃ ``train.zero_grad``,
    ``train.forward``, ``train.loss``, ``train.backward``, ``train.update``
    (``utils/tracing.py``) follow the same marks. ``loss_impl``: see the
    module docstring.
    ``weight_noise``: the loss and gradients are taken at noised parameters
    from micro-step ``weight_noise.start`` on (JAX gates on ``state.step``).
    ``group``: data-parallel over its ranks (the module docstring); the
    model's BatchNorms must take their statistics over it too."""
    train_loss = make_train_loss(model, loss_impl, group)
    mark = on_phase or (lambda phase: None)

    def step_fn(state: TrainState, batch: schemas.TrainData):
        with tracing.span("train.step", batch.inputs.inputs, batch.labels.labels):
            with tracing.span("train.zero_grad"):
                state.optimizer.zero_grad(set_to_none=True)
            phases = tracing.Phases(on_phase, "train.forward", {"forward": "train.loss"})
            try:
                clean = weight_noise.perturb(state.weight_noise_generator) if weight_noise and state.step >= weight_noise.start else None
                loss = train_loss(state.model, batch.inputs, batch.labels, state.generator, phases.mark, state.augment_generator)
                phases.mark("loss")
            finally:
                phases.close()
            with tracing.span("train.backward"):
                loss.backward()
                if clean is not None:
                    weight_noise.restore(clean)
            with tracing.span("train.update"):
                params = [p for p in state.model.parameters() if p.grad is not None]
                if group is not None:
                    all_reduce_([p.grad for p in params], group)
                    loss = sum_no_grad(loss, group)
                grad_norm = global_norm([p.grad for p in params])
                state.optimizer.step(grad_norm=grad_norm if _same(params, [p for p in state.optimizer.params if p.grad is not None]) else None)
            mark("update")
            state.step += 1
            return state, {"loss": loss.detach(), "grad_norm": grad_norm.detach()}

    return step_fn


def make_eval_step(model: torch.nn.Module, loss_impl: str = "auto", group=None) -> Callable:
    """The loss without gradients (JAX ``make_eval_step``): the inference
    forward to logits and the masked-mean loss that :func:`_loss_for`
    selects — by default, for a transducer, the unfused Pallas loss (TPU
    kernel row 10 and the DP kernel on the card), and for a CTC model the
    CTC kernel (row 11). Under a data-parallel ``group``: the global masked mean."""
    loss_fn = _loss_for(model, loss_impl, group)

    def step_fn(state: TrainState, batch: schemas.TrainData):
        with torch.no_grad():
            out = state.model(batch.inputs, train=False)
            loss = loss_fn(out.logits, out.logits_length, batch.labels.labels, batch.labels.labels_length)
            return {"loss": loss if group is None else sum_no_grad(loss, group)}

    return step_fn


class Trainer:
    """Step/epoch orchestrator on one device a process (None: the CUDA card,
    raising without one; ``"cpu"`` runs the kernels' plain versions). The
    model is moved to the device; batches are moved there at each step.
    ``mesh``: a 1-D ``DeviceMesh`` over the ranks to train data-parallel
    across (the module docstring; None: one over the process group when it
    has more than one rank, else one device). The model then takes rank 0's
    weights, checkpoints are written by rank 0, and ``fit`` needs
    ``steps_per_epoch`` (every rank must take the same number of steps).
    ``loss_impl`` as :func:`make_train_step`, for the train and the eval
    step. ``ga_steps``, ``gradn_config`` and ``clip_norm`` configure the
    optimizer chain (``optimizers.build_optimizer``), ``gwn_config`` the
    gaussian weight noise, as JAX's ``Trainer`` and ``scripts/train.py``
    take them; ``checkpoint_dir`` and ``keep_checkpoints`` the checkpoints;
    ``callbacks`` the ``training/callbacks.py`` objects ``fit`` runs."""

    def __init__(self, model: torch.nn.Module, optimizer_config: dict, device=None, on_phase: Optional[Callable[[str], None]] = None,
                 loss_impl: str = "auto", ga_steps: Optional[int] = None, gradn_config: Optional[dict] = None, clip_norm: Optional[float] = None,
                 gwn_config: Optional[dict] = None, checkpoint_dir: Optional[str] = None, keep_checkpoints: int = 5, callbacks: Optional[list] = None,
                 mesh=None):
        self.device = device_util.resolve(device)
        self.model = model.to(self.device)
        if mesh is None and sharding.process_count() > 1:
            mesh = sharding.make_data_parallel_mesh(self.device)
        if mesh is not None and mesh.ndim != 1:
            raise ValueError(f"Trainer takes a 1-D data mesh, not {mesh.ndim}-D (the vocab-sharded step is parallel/tp.py's)")
        self.mesh = mesh
        self.group = mesh.get_group() if mesh is not None else None
        self.rank = mesh.get_local_rank() if mesh is not None else 0
        if self.group is not None:
            if dist.get_backend(self.group) == "nccl" and self.device.type != "cuda":
                raise ValueError(f"an NCCL group trains on CUDA devices, not {self.device}")
            sharding.replicate(sharding.sync_batch_norm(self.model, self.group), self.group)
        self.optimizer_config = dict(optimizer_config)
        self.ga_steps, self.gradn_config, self.clip_norm = ga_steps, gradn_config, clip_norm
        self.weight_noise = WeightNoise(self.model, gwn_config) if gwn_config else None
        self.checkpoint_dir = os.path.abspath(checkpoint_dir) if checkpoint_dir else None
        self.keep_checkpoints = keep_checkpoints
        self.callbacks = list(callbacks or [])
        self._train_step = make_train_step(self.model, on_phase, loss_impl, self.weight_noise, self.group)
        self._eval_step = make_eval_step(self.model, loss_impl, self.group)

    def init_state(self, seed: int = 42) -> TrainState:
        """A fresh optimizer chain over the model's parameters; the dropout
        generator seeded with ``seed``, the augmentation and weight-noise
        generators with ``seed`` plus their stream offsets; the first two
        also with the data-parallel rank's (:data:`RANK_STREAM`)."""
        optimizer = build_optimizer(self.optimizer_config, self.model.parameters(), ga_steps=self.ga_steps, gradn_config=self.gradn_config,
                                    clip_norm=self.clip_norm)
        return make_state(self.model, optimizer, seed, self.rank)

    # ------------------------------ checkpoints ------------------------------ #

    def checkpoint_steps(self) -> list[int]:
        """The steps of the checkpoints under ``checkpoint_dir``, oldest first."""
        if not self.checkpoint_dir or not os.path.isdir(self.checkpoint_dir):
            return []
        return sorted(int(d) for d in os.listdir(self.checkpoint_dir) if d.isdigit())

    def save(self, state: TrainState) -> Optional[str]:
        """Writes ``checkpoint_dir/<step>/state.pt`` (through a temporary
        directory renamed into place; a step already saved is not written
        again) and deletes all but the newest ``keep_checkpoints``; returns
        its path (None without a ``checkpoint_dir``). Data-parallel: rank 0
        writes, and every rank returns after it has."""
        if not self.checkpoint_dir:
            return None
        final = os.path.join(self.checkpoint_dir, str(state.step))
        if self.rank == 0:
            self._write(state, final)
        if self.group is not None:
            dist.barrier(group=self.group)
        return final

    def _write(self, state: TrainState, final: str) -> None:
        if os.path.isdir(final):
            return
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        torch.save({"model": state.model.state_dict(), "optimizer": state.optimizer.state_dict(), "step": state.step,
                    "generators": {k: g.get_state() for k, g in state.generators().items() if g is not None}}, os.path.join(tmp, "state.pt"))
        os.replace(tmp, final)
        for step in self.checkpoint_steps()[:-self.keep_checkpoints]:
            shutil.rmtree(os.path.join(self.checkpoint_dir, str(step)))

    def restore(self, state: TrainState) -> TrainState:
        """The newest checkpoint loaded into ``state`` (in place), or ``state`` as it is without one."""
        steps = self.checkpoint_steps()
        if not steps:
            return state
        ckpt = torch.load(os.path.join(self.checkpoint_dir, str(steps[-1]), "state.pt"), map_location="cpu", weights_only=True)
        state.model.load_state_dict(ckpt["model"])
        state.optimizer.load_state_dict(ckpt["optimizer"])
        state.step = int(ckpt["step"])
        for name, g in state.generators().items():
            if g is not None and name in ckpt["generators"]:
                g.set_state(ckpt["generators"][name])
        logger.info("restored the checkpoint of step %d", state.step)
        return state

    # --------------------------------- loops --------------------------------- #

    def train_step(self, state: TrainState, batch: schemas.TrainData):
        """One micro-step on this process's rows of the global batch."""
        return self._train_step(state, sharding.shard_batch(batch, self.device))

    def eval_step(self, state: TrainState, batch: schemas.TrainData):
        return self._eval_step(state, sharding.shard_batch(batch, self.device))

    def fit(self, state: TrainState, train_data: Iterable, epochs: int = 1, steps_per_epoch: Optional[int] = None, eval_data: Optional[Iterable] = None,
            log_every: int = 100) -> TrainState:
        """Train ``epochs`` passes over ``train_data`` (at most
        ``steps_per_epoch`` steps each), logging every ``log_every`` steps,
        evaluating on ``eval_data`` and saving a checkpoint after each
        epoch, with the callbacks' hooks as JAX's ``fit`` calls them: a
        callback's ``stop_training`` ends the epoch after the batch that
        set it (and the run after that epoch's end), or the run after the
        epoch whose end set it.

        After the first step (the warm-up: the model, the optimizer's
        moments and the allocator's blocks exist by then) it runs
        ``gc.collect(); gc.freeze()`` once, so that Python's gen-2 collector
        no longer walks the long-lived objects inside later steps (in a long
        process those collections took 0.5–0.9 s inside a step). The price:
        the objects alive at that point are never collected by the cycle
        collector again, so a cycle among them that becomes garbage later
        stays in memory (reference counting still frees the rest).

        Data-parallel: every rank takes ``steps_per_epoch`` steps (required)
        and the first batches of ``eval_data`` that every rank has; at the end
        the ranks' parameters and buffers are held equal bit for bit
        (``parallel.sharding.check_replicated``, which raises otherwise)."""
        if self.group is not None and not steps_per_epoch:
            raise ValueError("a data-parallel fit needs steps_per_epoch: a rank with a batch more than another would wait at its first collective")
        if self.group is not None and eval_data is not None:
            eval_data = list(eval_data)
            eval_data = eval_data[:int(-pmax(torch.tensor(-len(eval_data), device=self.device), self.group).item())]
        for cb in self.callbacks:
            cb.on_train_begin(self)
        frozen = stop = False
        metrics = None
        for epoch in range(epochs):
            if stop:
                break
            for cb in self.callbacks:
                cb.on_epoch_begin(self, epoch)
            t0, n, metrics = time.time(), 0, None
            for batch in train_data:
                state, metrics = self.train_step(state, batch)
                n += 1
                if not frozen:
                    gc.collect()
                    gc.freeze()
                    frozen = True
                if n % log_every == 0:
                    logger.info("epoch %d step %d loss %.4f (%.2f steps/s)", epoch, n, float(metrics["loss"]), n / (time.time() - t0))
                for cb in self.callbacks:
                    cb.on_train_batch_end(self, state, metrics)
                    stop = stop or cb.stop_training
                if stop or (steps_per_epoch and n >= steps_per_epoch):
                    break
            logs = {"loss": float(metrics["loss"]) if metrics is not None else float("nan")}
            if eval_data is not None:
                losses = [float(self.eval_step(state, b)["loss"]) for b in eval_data]
                logs["val_loss"] = float(np.mean(losses)) if losses else float("nan")
                logger.info("epoch %d loss %.4f val_loss %.4f", epoch, logs["loss"], logs["val_loss"])
            self.save(state)
            for cb in self.callbacks:
                cb.on_epoch_end(self, state, epoch, logs)
                stop = stop or cb.stop_training
        for cb in self.callbacks:
            cb.on_train_end(self, state)
        if self.group is not None:
            fp = sharding.check_replicated(self.model, self.group)
            logger.info("data-parallel over %d ranks: step %d, loss %.6f, parameters and buffers equal on every rank (fingerprint %d)",
                        self.group.size(), state.step, float(metrics["loss"]) if metrics is not None else float("nan"), fp)
        return state
