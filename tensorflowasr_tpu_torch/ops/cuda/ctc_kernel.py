"""The CTC loss kernel (``csrc/ctc.cu``) and the CTC loss built on it.

Replaces ``tensorflowasr_tpu/ops/pallas/ctc_kernel.py:ctc_loss_pallas``
and its ``custom_vjp``. The forward builds the kernel's inputs in PyTorch
as ``_prep`` does (``ops/ctc_loss.py:ctc_prep``: the f32 lse, the
per-state log-probabilities lp_ext [B, T, 2U+1] and the skip addend
[B, 2U+1]), then one kernel launch computes α, β, the occupancy gradient
−exp(α+β−ll) and the per-row loss −ll (``_ctc_kernel``). The backward is
softmax − occupancy (``_ctc_bwd``), PyTorch ops as JAX leaves it to XLA:
the label occupancies go into their vocabulary bins by ``scatter_add``
(a repeated label sums into one bin, as JAX's one-hot GEMM does), and the
gradient comes out in the logits' dtype.

The kernel runs the α and β sweeps side by side, a block of
``ceil(S / 32)`` warps each per batch row (one extended state per lane, a
named barrier a step), into α (the occupancy buffer) and β (a scratch
[B, T, S]); a parallel pass then forms the occupancy of every cell. What
bounds it on the card: the chain of T_b dependent row updates per row, not
the 13 MB it reads and writes at B 16, T 400, S 257. None of the TPU
kernel's lane packing (``_pack_grid``, G lane groups, ``_padded_lanes``,
scalar prefetch) is carried over. :func:`ctc_occupancy_plain`
(``ops/ctc_loss.py``) is its plain twin, operation for operation: the two
agree bit for bit.
"""

from __future__ import annotations

import torch

from tensorflowasr_tpu_torch.ops.ctc_loss import ctc_occupancy_plain, ctc_prep
from tensorflowasr_tpu_torch.ops.cuda import _build
from tensorflowasr_tpu_torch.utils import tracing

MAX_STATES = 1024  # one lane per extended state, at most 32 warps a sweep


def supported(s: int) -> bool:
    """Whether the kernel takes ``s`` = 2U+1 extended states (up to 1024: a
    lane each, at most 32 warps a sweep). A pure function of the shapes."""
    return s <= MAX_STATES


def ctc_kernel(lp_ext: torch.Tensor, skip_add: torch.Tensor, logit_length: torch.Tensor, label_length: torch.Tensor):
    """The kernel on CUDA tensors: (occupancy [B, T, S], loss [B]), f32; no
    autograd. Lengths are clamped to the lattice (1 ≤ T_b ≤ T, 2U_b+1 ≤ S).
    One call, one count in ``tracing.launches["kernel.ctc"]`` (its two
    launches: the sweeps and the occupancy pass)."""
    if lp_ext.dim() != 3:
        raise ValueError("lp_ext must be [B, T, S]")
    b, t, s = lp_ext.shape
    dev = lp_ext.device
    _build.require(lp_ext, "lp_ext", device=dev, dtype=torch.float32, shape=(b, t, s))
    _build.require(skip_add, "skip_add", device=dev, dtype=torch.float32, shape=(b, s))
    if not supported(s):
        raise ValueError(f"S = 2U+1 = {s} > {MAX_STATES} extended states is not supported by the kernel")
    t_len = logit_length.to(dev, torch.int32).contiguous()
    u_len = label_length.to(dev, torch.int32).contiguous()
    for name, x in (("logit_length", t_len), ("label_length", u_len)):
        _build.require(x, name, device=dev, dtype=torch.int32, shape=(b,))
    if b * t * s == 0:
        return torch.zeros_like(lp_ext), torch.zeros(b, dtype=torch.float32, device=dev)
    lib = _build.build()
    with tracing.kernel("kernel.ctc", lp_ext, skip_add), torch.cuda.device(dev):
        occ = torch.empty_like(lp_ext)
        loss = torch.empty(b, dtype=torch.float32, device=dev)
        beta = torch.empty_like(lp_ext)  # the β rows
        err = lib.tfasr_ctc(lp_ext.data_ptr(), skip_add.data_ptr(), t_len.data_ptr(), u_len.data_ptr(), occ.data_ptr(), loss.data_ptr(), beta.data_ptr(),
                            b, t, s, _build.stream_of(lp_ext))
        _build.check(err, "ctc")
    return occ, loss


def ctc_occupancy(lp_ext, skip_add, logit_length, label_length):
    """(occupancy, loss): the kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if lp_ext.device.type == "cpu":
        t = lp_ext.shape[1]
        return ctc_occupancy_plain(lp_ext, skip_add, logit_length.clamp(1, max(t, 1)), label_length.clamp(min=0))
    if lp_ext.device.type != "cuda":
        raise ValueError(f"no CTC kernel for device {lp_ext.device}")
    return ctc_kernel(lp_ext.contiguous(), skip_add.contiguous(), logit_length, label_length)


class _CtcLossPallas(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, logit_length, labels, label_length):
        label_length = label_length.to(logits.device, torch.int64)
        logit_length = torch.maximum(logit_length.to(logits.device, torch.int64), label_length)
        lp_ext, skip_add, lse = ctc_prep(logits, labels)
        occ, loss = ctc_occupancy(lp_ext, skip_add, logit_length, label_length)
        ctx.save_for_backward(logits, lse, occ, labels)
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, lse, occ, labels = ctx.saved_tensors
        x = logits.float()
        g_blank = occ[..., 0::2].sum(dim=-1)  # [B, T]
        g_lab = occ[..., 1::2]  # [B, T, U]
        gsum = g_blank + g_lab.sum(dim=-1)
        d = torch.zeros_like(x)
        d.scatter_add_(2, labels.to(x.device, torch.int64)[:, None, :].expand_as(g_lab), g_lab)
        d[..., 0] += g_blank
        d = (d - torch.exp(x - lse[..., None]) * gsum[..., None]) * g.float()[:, None, None]
        return d.to(logits.dtype), None, None, None


def ctc_loss_pallas(logits: torch.Tensor, logit_length: torch.Tensor, labels: torch.Tensor, label_length: torch.Tensor, blank: int = 0) -> torch.Tensor:
    """Per-row CTC loss [B] f32 through the kernel (the JAX ``ctc_loss_pallas``);
    differentiable in ``logits`` [B, T, V] (f32 or bf16). Conventions as
    ``ops/ctc_loss.py:ctc_loss``: blank 0, ``logit_length`` raised to
    ``label_length``, bf16 logits upcast. A CUDA tensor launches the kernel,
    a CPU tensor takes :func:`ctc_occupancy_plain`."""
    if blank != 0:
        raise ValueError("blank is fixed to 0 (reference parity)")
    return _CtcLossPallas.apply(logits, logit_length, labels, label_length)
