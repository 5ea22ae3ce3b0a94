"""RNN-T loss over per-cell log-probabilities, with its gradients
(``csrc/rnnt_dp.cu``).

Replaces ``tensorflowasr_tpu/ops/pallas/rnnt_kernel.py:rnnt_loss_from_logprobs``
(the α/β anti-diagonal DP kernel, ``_rnnt_kernel``): the loss per row and,
in the same call, the gradients ``gbl``/``gem`` of the loss with respect
to ``lp_blank``/``lp_emit`` in natural (t, u) coordinates. The autograd
backward only scales them by the upstream cotangent, as the JAX VJP
(``_rnnt_bwd``) does.

What bounds it on the card: the chain of dependent diagonals (2·(T_b+U_b)
barriers per row, one block per row), not the 13 MB it reads and writes at
the flagship (B 16, T 400, U+1 129). :func:`rnnt_loss_from_logprobs_plain`
(``ops/rnnt_loss.py``) is its plain twin.
"""

from __future__ import annotations

import torch

from tensorflowasr_tpu_torch.ops.cuda import _build
from tensorflowasr_tpu_torch.ops.rnnt_loss import rnnt_loss_from_logprobs_plain

launches = 0  # kernel launches since the last reset (set to 0 to reset)

MAX_U1 = 1024  # one thread per label position


def rnnt_dp_kernel(lp_blank: torch.Tensor, lp_emit: torch.Tensor, logit_length: torch.Tensor, label_length: torch.Tensor):
    """The kernel on CUDA tensors: (loss [B], gbl, gem [B, T, U+1]), f32; no autograd."""
    global launches
    if lp_blank.dim() != 3:
        raise ValueError("lp_blank must be [B, T, U+1]")
    b, t, u1 = lp_blank.shape
    dev = lp_blank.device
    for name, x in (("lp_blank", lp_blank), ("lp_emit", lp_emit)):
        _build.require(x, name, device=dev, dtype=torch.float32, shape=(b, t, u1))
    if u1 > MAX_U1:
        raise ValueError(f"U+1 = {u1} > {MAX_U1} label positions is not supported by the kernel")
    t_len = logit_length.to(dev, torch.int32).contiguous()
    u_len = label_length.to(dev, torch.int32).contiguous()
    for name, x in (("logit_length", t_len), ("label_length", u_len)):
        _build.require(x, name, device=dev, dtype=torch.int32, shape=(b,))
    loss = torch.empty(b, dtype=torch.float32, device=dev)
    gbl, gem = torch.empty_like(lp_blank), torch.empty_like(lp_blank)
    if b * t * u1 == 0:
        return loss.zero_(), gbl.zero_(), gem.zero_()
    alpha = torch.empty_like(lp_blank)
    lib = _build.build()
    with torch.cuda.device(dev):
        err = lib.tfasr_rnnt_dp(lp_blank.data_ptr(), lp_emit.data_ptr(), t_len.data_ptr(), u_len.data_ptr(), loss.data_ptr(), gbl.data_ptr(),
                                gem.data_ptr(), alpha.data_ptr(), b, t, u1, _build.stream_of(lp_blank))
    _build.check(err, "rnnt_dp")
    launches += 1
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
