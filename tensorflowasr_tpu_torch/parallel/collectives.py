"""Collectives with the gradients the data- and tensor-parallel steps need.

JAX differentiates through ``jax.lax.psum`` by its own rules: under GSPMD
the gradient all-reduce is inserted by XLA, and under ``shard_map`` with
``check_vma=False`` the transpose of ``psum`` is ``psum`` again, which
``parallel/tp.py:_psum_rep`` replaces by the identity. The port states the
two rules as two ``autograd.Function``s:

- :func:`psum`: an all-reduce whose backward is an all-reduce too. Right
  where every rank consumes the sum in a loss term of its own, which the
  ranks' terms then add up: the global BatchNorm statistics of the
  data-parallel step (each rank's rows are normalised by them).
- :func:`psum_replicated`: an all-reduce whose backward is the identity
  (JAX ``_psum_rep``). Right where the sum feeds a loss that is counted
  once, not once per rank: the vocab-sharded loss of ``tp.py``, replicated
  over ``model``.

``torch.distributed.nn.functional.all_reduce`` is not used: its backward is
the all-reduce again, which is :func:`psum`'s rule and would scale every
gradient through the vocab-sharded loss by the group's size.

Every collective here is a SUM or MAX all-reduce, a broadcast or a
barrier: the four a gloo group also takes on CUDA tensors.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


class _PsumReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Σ over the ranks of ``group`` (None: every rank); the backward sums the cotangents over the group."""
    return _Psum.apply(x, group)


def psum_replicated(x: torch.Tensor, group=None) -> torch.Tensor:
    """Σ over the ranks of ``group``; the backward keeps each rank's own cotangent (JAX ``tp._psum_rep``)."""
    return _PsumReplicated.apply(x, group)


@torch.no_grad()
def pmax(x: torch.Tensor, group=None) -> torch.Tensor:
    """The elementwise max over the ranks of ``group``, without a gradient."""
    out = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


@torch.no_grad()
def sum_no_grad(x: torch.Tensor, group=None) -> torch.Tensor:
    """Σ over the ranks of ``group``, without a gradient (a reported metric, a count)."""
    out = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


@torch.no_grad()
def flat_apply(tensors: Sequence[torch.Tensor], fn: Callable[[torch.Tensor], None]) -> None:
    """``fn`` on one flat buffer per dtype holding every tensor of ``tensors``
    (in order), then the buffer copied back: one collective a dtype, not one
    a tensor."""
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        fn(flat)
        torch._foreach_copy_(group, [v.view_as(t) for v, t in zip(flat.split([t.numel() for t in group]), group)])


def all_reduce_(tensors: Sequence[torch.Tensor], group=None, divisor: Optional[int] = None) -> None:
    """In place: each tensor becomes its Σ over ``group`` (over ``divisor`` when
    given: JAX ``pmean``), in one flat bucket a dtype."""

    def reduce(flat: torch.Tensor) -> None:
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        if divisor is not None:
            flat.div_(divisor)

    flat_apply(tensors, reduce)


def broadcast_(tensors: Sequence[torch.Tensor], group=None) -> None:
    """In place: every rank's tensors become those of the group's first rank."""
    src = 0 if group is None else dist.get_global_rank(group, 0)
    flat_apply(tensors, lambda flat: dist.broadcast(flat, src=src, group=group))
