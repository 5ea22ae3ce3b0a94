"""The RNN-T loss kernels: the DP over per-cell log-probabilities
(``csrc/rnnt_dp.cu``) and, for the unfused loss over materialised logits,
the two row kernels around it (``csrc/rnnt_rows.cu``).

The DP replaces ``tensorflowasr_tpu/ops/pallas/rnnt_kernel.py:rnnt_loss_from_logprobs``
(the α/β anti-diagonal DP kernel, ``_rnnt_kernel``): the loss per row and,
in the same call, the gradients ``gbl``/``gem`` of the loss with respect
to ``lp_blank``/``lp_emit`` in natural (t, u) coordinates. The autograd
backward only scales them by the upstream cotangent, as the JAX VJP
(``_rnnt_bwd``) does. A parallel pass copies the operands into
diagonal-major order; the α and β sweeps then run at the same time, a
block of :func:`dp_warps` warps each per row (one label position per lane),
one diagonal per step, into diagonal-major scratch; a parallel pass forms
the gradients. What bounds it on the card: the chain of T_b + U_b
dependent diagonals per row, not the 13 MB it reads and writes at the
flagship (B 16, T 400, U+1 129).
:func:`rnnt_loss_from_logprobs_plain` (``ops/rnnt_loss.py``) is its plain
twin, operation for operation: the two agree bit for bit.

:func:`rnnt_loss_pallas` replaces the JAX ``rnnt_loss_pallas`` and its
``custom_vjp``: the forward turns the logits [B, T, U+1, V] into
lp_blank, lp_emit and lse (``_logits_to_logprobs``; one warp a tile of
rows, their 16-byte chunks loaded straight into registers,
:func:`logprobs_plan`) and runs the DP on them directly, in natural
coordinates (no skew); it keeps the logits in their own dtype, lse, gbl
and gem for the backward, which assembles the dense d_logits in the logits' dtype
(``_dlogits_assemble``). Both row kernels are bound by bytes: 423 MB of
bf16 logits read at the flagship (0.13 ms at 3.35 TB/s), and as much again
written by the backward. :func:`logits_to_logprobs_plain` and
:func:`dlogits_assemble_plain` are their plain twins.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tensorflowasr_tpu_torch.ops.cuda import _build
from tensorflowasr_tpu_torch.ops.rnnt_loss import dlogits_assemble_plain, logits_to_logprobs_plain, rnnt_loss_from_logprobs_plain
from tensorflowasr_tpu_torch.utils import tracing

MAX_U1 = 1024  # label positions: 32 warps of 32 lanes per sweep

LP_TILE_BYTES = 4096  # a warp's tile: as many whole rows as fit, at most 32 (at least one)


def supported(u1: int) -> bool:
    """Whether the DP kernel takes ``u1`` = U+1 label positions (up to 1024,
    one lane each over at most 32 warps a sweep), and with it the unfused
    loss's row kernels (any V). A pure function of the shapes."""
    return u1 <= MAX_U1


def dp_warps(u1: int) -> int:
    """Warps per sweep at U+1 = ``u1``: one label position per lane."""
    if not supported(u1):
        raise ValueError(f"U+1 = {u1} > {MAX_U1} label positions is not supported by the kernel")
    return -(-u1 // 32)


def rnnt_dp_kernel(lp_blank: torch.Tensor, lp_emit: torch.Tensor, logit_length: torch.Tensor, label_length: torch.Tensor):
    """The kernel on CUDA tensors: (loss [B], gbl, gem [B, T, U+1]), f32; no autograd."""
    if lp_blank.dim() != 3:
        raise ValueError("lp_blank must be [B, T, U+1]")
    b, t, u1 = lp_blank.shape
    dev = lp_blank.device
    for name, x in (("lp_blank", lp_blank), ("lp_emit", lp_emit)):
        _build.require(x, name, device=dev, dtype=torch.float32, shape=(b, t, u1))
    w = dp_warps(u1)
    t_len = logit_length.to(dev, torch.int32).contiguous()
    u_len = label_length.to(dev, torch.int32).contiguous()
    for name, x in (("logit_length", t_len), ("label_length", u_len)):
        _build.require(x, name, device=dev, dtype=torch.int32, shape=(b,))
    if b * t * u1 == 0:
        return torch.zeros(b, dtype=torch.float32, device=dev), torch.zeros_like(lp_blank), torch.zeros_like(lp_blank)
    lib = _build.build()
    with tracing.kernel("kernel.rnnt_dp", lp_blank, lp_emit), torch.cuda.device(dev):
        loss = torch.empty(b, dtype=torch.float32, device=dev)
        gbl, gem = torch.empty_like(lp_blank), torch.empty_like(lp_blank)
        # the skewed operands (3) and the α and β lattices, each [B, T + U, 32·W] f32
        scratch = torch.empty(5 * b * (t + u1 - 1) * 32 * w, dtype=torch.float32, device=dev)
        err = lib.tfasr_rnnt_dp(lp_blank.data_ptr(), lp_emit.data_ptr(), t_len.data_ptr(), u_len.data_ptr(), loss.data_ptr(), gbl.data_ptr(),
                                gem.data_ptr(), scratch.data_ptr(), b, t, u1, _build.stream_of(lp_blank))
        _build.check(err, "rnnt_dp")
    return loss, gbl, gem


def loss_and_grads(lp_blank, lp_emit, logit_length, label_length):
    """(loss, gbl, gem): the kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if lp_blank.device.type == "cpu":
        return rnnt_loss_from_logprobs_plain(lp_blank, lp_emit, logit_length, label_length)
    if lp_blank.device.type != "cuda":
        raise ValueError(f"no RNN-T DP kernel for device {lp_blank.device}")
    return rnnt_dp_kernel(lp_blank.float().contiguous(), lp_emit.float().contiguous(), logit_length, label_length)


class _RnntLossFromLogprobs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lp_blank, lp_emit, logit_length, label_length):
        loss, gbl, gem = loss_and_grads(lp_blank, lp_emit, logit_length, label_length)
        ctx.save_for_backward(gbl, gem)
        ctx.dtypes = (lp_blank.dtype, lp_emit.dtype)
        return loss

    @staticmethod
    def backward(ctx, g):
        gbl, gem = ctx.saved_tensors
        scale = g.float()[:, None, None]
        return (gbl * scale).to(ctx.dtypes[0]), (gem * scale).to(ctx.dtypes[1]), None, None


def rnnt_loss_from_logprobs(lp_blank: torch.Tensor, lp_emit: torch.Tensor, logit_length: torch.Tensor, label_length: torch.Tensor) -> torch.Tensor:
    """Per-row RNN-T loss [B] f32 from lp_blank, lp_emit [B, T, U+1]
    (``lp_emit[..., U]`` = LOG_0) and lengths [B] (1 ≤ T_b ≤ T, 0 ≤ U_b ≤ U);
    differentiable with respect to both log-probabilities. JAX argument
    order minus ``interpret``. A CUDA tensor launches the kernel; a CPU
    tensor takes the plain version."""
    return _RnntLossFromLogprobs.apply(lp_blank, lp_emit, logit_length, label_length)


class LogprobsPlan(NamedTuple):
    """How the log-probability row kernel reads logits [rows, V]: ``route``
    "tiles" (one warp a tile of ``tile_rows`` consecutive rows, ``lanes``
    lanes a row, 16-byte loads into registers) or "scalar" (one warp a row,
    one element a load)."""
    route: str
    tile_rows: int
    lanes: int


def logprobs_plan(v: int, elt: int, aligned: bool = True) -> LogprobsPlan:
    """The row kernel's form by shape. A row of 16-byte aligned bytes
    (``v·elt`` a multiple of 16 and an ``aligned`` base) takes the tiles:
    ``tile_rows`` = the largest power of two of rows that fits
    :data:`LP_TILE_BYTES` (1 to 32; one row when a row is longer), and
    ``32 / tile_rows`` lanes a row, each loading 8 chunks of 16 bytes a
    pass, so that a row of at most 4 KB takes one pass (V 256 bf16: 8
    rows, 4 lanes a row). Any other row takes the one-element form."""
    row = v * elt
    if not aligned or row % 16:
        return LogprobsPlan("scalar", 0, 0)
    tile_rows = 1 << (min(32, max(1, LP_TILE_BYTES // row)).bit_length() - 1)
    return LogprobsPlan("tiles", tile_rows, 32 // tile_rows)


def _check_logits(logits: torch.Tensor, labels: torch.Tensor):
    if logits.dim() != 4:
        raise ValueError("logits must be [B, T, U+1, V]")
    b, t, u1, v = logits.shape
    code = _build.compute_dtype(logits, "logits")
    _build.require(logits, "logits", device=logits.device, dtype=logits.dtype, shape=(b, t, u1, v))
    if tuple(labels.shape) != (b, u1 - 1):
        raise ValueError(f"labels: shape {tuple(labels.shape)}, expected {(b, u1 - 1)}")
    # 16-byte loads need 16-byte aligned rows; other rows take the kernel's one-element loads
    vec = int(logits.data_ptr() % 16 == 0 and v * logits.element_size() % 16 == 0)
    return b, t, u1, v, code, vec, labels.to(logits.device, torch.int32).contiguous()


def logits_to_logprobs_kernel(logits: torch.Tensor, labels: torch.Tensor):
    """The log-probability row kernel on CUDA tensors: (lp_blank, lp_emit, lse)
    as :func:`logits_to_logprobs_plain`, in the form :func:`logprobs_plan`
    picks by shape: the tiles for 16-byte aligned rows, the one-element
    kernel for any other row."""
    b, t, u1, v, code, vec, lab = _check_logits(logits, labels)
    plan = logprobs_plan(v, logits.element_size(), bool(vec))
    lpb, lpe, lse = (torch.empty((b, t, u1), dtype=torch.float32, device=logits.device) for _ in range(3))
    if b * t * u1 == 0:
        return lpb, lpe, lse
    lib = _build.build()
    with tracing.kernel("kernel.rnnt_logprobs", logits), torch.cuda.device(logits.device):
        err = lib.tfasr_rnnt_logprobs(logits.data_ptr(), lab.data_ptr(), lpb.data_ptr(), lpe.data_ptr(), lse.data_ptr(), b, t, u1, v, code,
                                      plan.tile_rows, _build.stream_of(logits))
        _build.check(err, "rnnt_logprobs")
    if plan.route == "scalar":
        tracing.launches["kernel.rnnt_logprobs.scalar"] += 1
    return lpb, lpe, lse


def dlogits_assemble_kernel(logits, lse, gbl, gem, labels, g):
    """The d_logits row kernel on CUDA tensors: as :func:`dlogits_assemble_plain`."""
    b, t, u1, v, code, vec, lab = _check_logits(logits, labels)
    for name, x in (("lse", lse), ("gbl", gbl), ("gem", gem)):
        _build.require(x, name, device=logits.device, dtype=torch.float32, shape=(b, t, u1))
    gs = g.to(logits.device, torch.float32).contiguous()
    _build.require(gs, "g", device=logits.device, dtype=torch.float32, shape=(b,))
    out = torch.empty_like(logits)
    if b * t * u1 == 0:
        return out
    lib = _build.build()
    with tracing.kernel("kernel.rnnt_dlogits", logits), torch.cuda.device(logits.device):
        err = lib.tfasr_rnnt_dlogits(logits.data_ptr(), lse.data_ptr(), gbl.data_ptr(), gem.data_ptr(), lab.data_ptr(), gs.data_ptr(), out.data_ptr(),
                                     b, t, u1, v, code, vec, _build.stream_of(logits))
        _build.check(err, "rnnt_dlogits")
    return out


class _RnntLossPallas(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, logit_length, labels, label_length):
        if logits.device.type == "cpu":
            lpb, lpe, lse = logits_to_logprobs_plain(logits, labels)
            loss, gbl, gem = rnnt_loss_from_logprobs_plain(lpb, lpe, logit_length, label_length)
        else:
            lpb, lpe, lse = logits_to_logprobs_kernel(logits, labels)
            loss, gbl, gem = rnnt_dp_kernel(lpb, lpe, logit_length, label_length)
        ctx.save_for_backward(logits, lse, gbl, gem, labels)  # the logits in their own dtype, no f32 copy
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, lse, gbl, gem, labels = ctx.saved_tensors
        assemble = dlogits_assemble_plain if logits.device.type == "cpu" else dlogits_assemble_kernel
        return assemble(logits, lse, gbl, gem, labels, g), None, None, None


def rnnt_loss_pallas(logits: torch.Tensor, logit_length: torch.Tensor, labels: torch.Tensor, label_length: torch.Tensor, blank: int = 0) -> torch.Tensor:
    """Per-row RNN-T loss [B] f32 from joint logits [B, T, U+1, V] (f32 or
    bf16), labels [B, U] and lengths [B] (1 ≤ T_b ≤ T, 0 ≤ U_b ≤ U);
    differentiable in the logits, whose gradient comes back in their dtype.
    JAX argument order minus ``interpret``. A CUDA tensor launches the
    kernels (log-probabilities and DP forward, d_logits under autograd); a
    CPU tensor takes the plain versions."""
    if blank != 0:
        raise ValueError("blank is fixed to 0 (reference parity)")
    if logits.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no RNN-T loss kernel for device {logits.device}")
    return _RnntLossPallas.apply(logits, logit_length, labels, label_length)
