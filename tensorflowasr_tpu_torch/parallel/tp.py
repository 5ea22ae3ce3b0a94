"""Tensor-parallel (vocab-sharded) transducer training over a 2-D
``("data", "model")`` mesh (counterpart of ``tensorflowasr_tpu/parallel/tp.py``).

The transducer's largest tensor is the joint's logits [B, T, U+1, V]. Its
vocab projection (``joint.vocab``: weight [V, J], bias [V]) is split by
rows over the ``model`` axis, so that each rank holds [B_local, T, U+1,
V/m] logits; everything else, the embedding's global vocabulary included,
is replicated, and the batch is split over ``data``.

- :func:`tp_rnnt_loss`: the global log-sum-exp from the shards (the max
  with a MAX all-reduce under ``no_grad``: a shift that moves neither value
  nor gradient), the blank logit from shard 0 and each label's logit from
  the shard that owns it, summed over ``model`` in one
  :func:`~tensorflowasr_tpu_torch.parallel.collectives.psum_replicated`
  (the loss counts once, so the backward is the identity), then the RNN-T
  DP (``ops/cuda/rnnt_kernel.py:rnnt_loss_from_logprobs``, TPU kernel row
  9), replicated over ``model``.
- :func:`make_tp_train_step`, as JAX's ``shard_map`` step: BatchNorm on
  each data shard's rows, its running statistics averaged over ``data``;
  the loss each shard's masked mean, averaged over ``data``; gradients
  averaged over ``data`` and, for every parameter but the vocab slice
  (whose gradient on a rank is the part through its own columns), summed
  over ``model``; ``grad_norm`` with the vocab slices' squares summed over
  ``model``. The fused joint + loss (row 8) cannot run here: its
  log-sum-exp needs the whole vocabulary.

The chain's clipping takes that global ``grad_norm``. A rank's ``model``
coordinate is the inner one (rank = data · m + model), as in JAX.
"""

from __future__ import annotations

import copy
from typing import Optional

import torch
import torch.distributed as dist

from tensorflowasr_tpu_torch import schemas
from tensorflowasr_tpu_torch.models.layers.general import BatchNorm, Dense
from tensorflowasr_tpu_torch.models.transducer.base import Transducer
from tensorflowasr_tpu_torch.ops import routes
from tensorflowasr_tpu_torch.ops.cuda import rnnt_kernel
from tensorflowasr_tpu_torch.ops.cuda.rnnt_kernel import rnnt_loss_from_logprobs
from tensorflowasr_tpu_torch.ops.rnnt_loss import LOG_0, rnnt_loss_from_logprobs_plain, sanitize_lengths, valid_mean
from tensorflowasr_tpu_torch.optimizers import build_optimizer
from tensorflowasr_tpu_torch.parallel.collectives import all_reduce_, pmax, psum_replicated, sum_no_grad
from tensorflowasr_tpu_torch.parallel.sharding import replicate
from tensorflowasr_tpu_torch.utils.env_util import setup_mesh

VOCAB_PARAMS = ("joint.vocab.weight", "joint.vocab.bias")  # split along dim 0 (the vocab rows) over "model"


def make_dp_tp_mesh(n_model: int, device=None):
    """The ("data", "model") ``DeviceMesh`` over every rank, ``model`` innermost."""
    world = dist.get_world_size()
    if world % n_model:
        raise ValueError(f"{world} ranks are not divisible by model={n_model}")
    return setup_mesh(("data", "model"), (world // n_model, n_model), device)


def model_coords(mesh) -> tuple[int, int]:
    """(ranks along ``model``, this rank's index along it)."""
    return mesh["model"].size(), mesh.get_local_rank("model")


def param_specs(model: torch.nn.Module) -> dict:
    """Parameter name → the dim split over ``model`` (0 for the vocab projection), or None (replicated)."""
    return {name: 0 if name in VOCAB_PARAMS else None for name, _ in model.named_parameters()}


def _slice(t: torch.Tensor, n_model: int, index: int) -> torch.Tensor:
    if t.shape[0] % n_model:
        raise ValueError(f"vocab {t.shape[0]} is not divisible by model={n_model}")
    return t.chunk(n_model)[index].clone()


def shard_tp_state(state: dict, n_model: int, index: int, param_names: Optional[list] = None) -> dict:
    """Model rank ``index``'s slice of a full state: of a module's
    ``state_dict``, the rows of :data:`VOCAB_PARAMS`; of a ``Trainer``
    checkpoint (``{"model", "optimizer", ...}``), also the optimizer state
    of those parameters (Adam's moments, the accumulation buffers), found by
    their index in ``param_names`` (the chain's parameter order, that of
    ``model.named_parameters()``)."""
    if "model" not in state:
        return {k: _slice(v, n_model, index) if k in VOCAB_PARAMS else v for k, v in state.items()}
    sharded = {i for i, name in enumerate(param_names or []) if name in VOCAB_PARAMS}
    cut = lambda i, v: _slice(v, n_model, index) if i in sharded and torch.is_tensor(v) and v.dim() > 0 else v
    opt = dict(state["optimizer"])
    base = dict(opt["base"])
    base["state"] = {i: {k: cut(i, v) for k, v in s.items()} for i, s in base["state"].items()}
    opt["base"] = base
    if "accumulated" in opt:
        opt["accumulated"] = [cut(i, a) for i, a in enumerate(opt["accumulated"])]
    return {**state, "model": shard_tp_state(state["model"], n_model, index), "optimizer": opt}


@torch.no_grad()
def gather_tp_state(state_dict: dict, mesh) -> dict:
    """The full ``state_dict`` from every model rank's slice (the inverse of
    :func:`shard_tp_state` on a module's): each vocab slice written into its
    rows of a zero tensor, summed over ``model``."""
    n, index = model_coords(mesh)
    out = dict(state_dict)
    for name in VOCAB_PARAMS:
        local = state_dict[name]
        full = local.new_zeros((local.shape[0] * n,) + tuple(local.shape[1:]))
        full[index * local.shape[0]:(index + 1) * local.shape[0]] = local
        dist.all_reduce(full, group=mesh.get_group("model"))
        out[name] = full
    return out


def local_vocab_model(model: Transducer, mesh) -> Transducer:
    """A copy of ``model`` whose joint owns this rank's rows of the vocab
    projection (``joint_config["vocab_size"]`` = V / m, as JAX's
    ``model.clone``); the embedding keeps the global vocabulary."""
    n, index = model_coords(mesh)
    local = copy.deepcopy(model)
    vocab = model.joint.vocab
    local.joint_config = {**model.joint_config, "vocab_size": model.vocab_size // n}
    local.joint.vocab = Dense(vocab.weight.shape[1], model.vocab_size // n, vocab.dtype).to(vocab.weight.device)
    local.load_state_dict(shard_tp_state(model.state_dict(), n, index))
    return local


def init_tp_state(model: Transducer, optimizer_config: dict, mesh, seed: int = 42, **chain_kwargs):
    """The TP ``TrainState``: rank 0's weights on every rank, this rank's
    vocab slice (:func:`local_vocab_model`), a fresh optimizer chain over
    the local parameters (so its state is of the slice), and the generators
    of this rank's ``data`` index (the model ranks of one data shard draw
    the same masks on the same rows)."""
    from tensorflowasr_tpu_torch.training.trainer import make_state

    local = local_vocab_model(replicate(model), mesh)
    return make_state(local, build_optimizer(optimizer_config, local.parameters(), **chain_kwargs), seed, mesh.get_local_rank("data"))


class _PlainLossFromLogprobs(torch.autograd.Function):
    """The DP's plain version with the gradients it returns: the route where
    the DP kernel refuses U+1 (``rnnt_kernel.supported``)."""

    @staticmethod
    def forward(ctx, lp_blank, lp_emit, logit_length, label_length):
        loss, gbl, gem = rnnt_loss_from_logprobs_plain(lp_blank, lp_emit, logit_length, label_length)
        ctx.save_for_backward(gbl, gem)
        return loss

    @staticmethod
    def backward(ctx, g):
        gbl, gem = ctx.saved_tensors
        scale = g.float()[:, None, None]
        return gbl * scale, gem * scale, None, None


def tp_rnnt_loss(local_logits: torch.Tensor, logit_length: torch.Tensor, labels: torch.Tensor, label_length: torch.Tensor, vocab_size: int,
                 group=None) -> torch.Tensor:
    """Per-row RNN-T loss [B] (replicated over ``group``, the ``model`` axis)
    from vocab-sharded logits [B, T, U+1, V/m] (JAX ``tp_rnnt_loss``); the
    DP kernel where it takes U+1, else its plain version (recorded in
    ``ops/routes.py``)."""
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    b, t, u1, v_local = local_logits.shape
    if v_local * n != vocab_size:
        raise ValueError(f"a shard of {v_local} over {n} ranks is not the vocab {vocab_size}")
    x = local_logits.float()
    gmax = pmax(x.max(dim=-1).values, group)
    sumexp = torch.exp(x - gmax[..., None]).sum(dim=-1)
    blank = x[..., 0] if rank == 0 else torch.zeros_like(x[..., 0])
    local_id = labels.to(x.device, torch.int64) - rank * v_local  # [B, U]
    owned = ((local_id >= 0) & (local_id < v_local))[:, None, :]
    idx = local_id.clamp(0, v_local - 1)[:, None, :, None].expand(b, t, u1 - 1, 1)
    sel = torch.where(owned, torch.gather(x[:, :, :u1 - 1], 3, idx)[..., 0], torch.zeros((), device=x.device))
    sel = torch.cat([sel, torch.zeros_like(sel[..., :1])], dim=-1)
    sumexp, blank, sel = psum_replicated(torch.stack([sumexp, blank, sel]), group).unbind(0)
    lse = gmax + torch.log(sumexp)
    lp_emit = torch.cat([sel[..., :u1 - 1] - lse[..., :u1 - 1], torch.full_like(lse[..., :1], LOG_0)], dim=-1)
    loss = rnnt_loss_from_logprobs if routes.take("rnnt_dp", rnnt_kernel.supported(u1)) else _PlainLossFromLogprobs.apply
    return loss(blank - lse, lp_emit, logit_length, label_length)


def make_tp_train_step(model: Transducer, mesh):
    """``step_fn(state, batch) -> (state, metrics)`` over ``mesh`` (JAX
    ``make_tp_train_step``) for the state of :func:`init_tp_state`: the
    forward to this rank's logits, :func:`tp_rnnt_loss`, the backward, the
    gradient and statistics reductions of the module docstring and one
    step of the chain; ``batch`` is this data shard's rows."""
    data_group, model_group = mesh.get_group("data"), mesh.get_group("model")
    n_data = mesh["data"].size()
    if mesh.size() != dist.get_world_size():
        raise ValueError("the TP mesh must cover every rank")
    sharded = [p for name, p in model.named_parameters() if name in VOCAB_PARAMS]
    replicated = [p for name, p in model.named_parameters() if name not in VOCAB_PARAMS]
    stats = [t for m in model.modules() if isinstance(m, BatchNorm) for t in (m.running_mean, m.running_var)]
    device = next(model.parameters()).device

    def sq(grads: list) -> torch.Tensor:
        return torch.stack(torch._foreach_norm([g.float() for g in grads])).square().sum() if grads else torch.zeros((), device=device)

    def step_fn(state, batch: schemas.TrainData):
        batch = batch.to(device)
        state.optimizer.zero_grad(set_to_none=True)
        out = state.model(batch.inputs, train=True, generator=state.generator, augment_generator=state.augment_generator)
        valid, safe_t, safe_u = sanitize_lengths(out.logits_length.to(device), batch.labels.labels_length, out.logits.shape[1])
        loss = valid_mean(tp_rnnt_loss(out.logits, safe_t, batch.labels.labels, safe_u, model.vocab_size, model_group), valid)
        loss.backward()
        rep_grads = [p.grad for p in replicated if p.grad is not None]
        vocab_grads = [p.grad for p in sharded if p.grad is not None]
        all_reduce_(rep_grads, None, divisor=n_data)  # mean over data, sum over model
        all_reduce_(vocab_grads, data_group, divisor=n_data)
        if stats:
            all_reduce_(stats, data_group, divisor=n_data)
        grad_norm = torch.sqrt(sq(rep_grads) + sum_no_grad(sq(vocab_grads), model_group))
        state.optimizer.step(grad_norm=grad_norm)
        state.step += 1
        return state, {"loss": sum_no_grad(loss, data_group) / n_data, "grad_norm": grad_norm.detach()}

    return step_fn
