"""Fused Conformer convolution-module kernels, forward and backward
(bf16: ``csrc/conv_mma.cu``, on the tensor cores; f32: ``csrc/conv_module.cu``).

Replaces ``tensorflowasr_tpu/ops/pallas/conv_kernel.py:conv_front`` (LN →
two D×D pointwise products → GLU) and ``:conv_back`` (BatchNorm apply with
the given mean/var → swish → pointwise → dropout → ``x + factor·z``), with
their ``custom_vjp``s. The 31-tap depthwise conv between them stays a
library op (:func:`depthwise_conv1d`, ``F.conv1d`` with groups=D), as the
reference leaves it to XLA.

What bounds them on the card: per module ~0.3 GFLOP of products per 2000
rows, small for the card; a plain version makes ~8 device-memory passes
over [B·T, 2D] and [B·T, D] tensors (LN, the 2D pointwise output, GLU, BN,
swish, pointwise, residual). Each forward kernel reads its row tile once
and writes once: a block keeps the normalised (front) or activated (back)
tile in shared memory and stages the D×D weights 64 output columns at a
time. In bf16 both halves run on the tensor cores (``mma.sync``, the weight
chunks double-buffered with cp.async; ``conv_front`` 32 rows a block
forward, 64 backward); their f32 parity path keeps the CUDA-core kernels
(16 rows a block). Elementwise math and accumulation are f32; product
operands are rounded to the weights' type as in the reference. Above D
256, to Conformer-L's 512, ``conv_front`` takes its wide bf16 kernels
(forward 64 rows with 32-column weight chunks; backward 32 rows, the dy
accumulator split over four warps: :func:`front_wide_smem`) and its f32
kernels 32-column chunks; ``conv_back``'s tiles hold at 512 as they are.
:func:`supported` says which widths the kernels take; the Conformer's
``ConvModule`` runs its plain modules at any other.
``conv_back``'s dropout runs in-kernel from the counter hash of
``ops/dropout.py`` indexed by (global row b·T + t, column).

The backwards (:class:`_ConvFront`, :class:`_ConvBack`) save the inputs
and recompute, as the Pallas VJPs do; their kernels write the row
gradients and the activations the weight gradients need, and a
deterministic row reduction forms the parameter gradients (in bf16: from
bf16 high and low parts on the tensor cores, as the fused FF's; the column
sums from one partial row per 16 rows, summed in order). ``conv_back``
emits dmean and dvar, which autograd carries into the batch-statistics
path; its skip gradient is the identity. :func:`conv_front_plain_bwd` and
:func:`conv_back_plain_bwd` are the plain twins with the explicit formulas
of the Pallas backwards.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tensorflowasr_tpu_torch.ops import dropout as dr
from tensorflowasr_tpu_torch.ops.cuda import _build
from tensorflowasr_tpu_torch.ops.cuda.ff_kernel import _ln_parts, dot_as, layer_norm_f32, ln_backward
from tensorflowasr_tpu_torch.utils import tracing

MAX_D = 512  # both halves, both dtypes
_PAD, _WIDE_CC = 8, 32  # csrc/conv_mma.cu: bf16 row padding; the wide kernels' weight-chunk columns



def supported(d: int, dtype: torch.dtype) -> bool:
    """Whether the kernels of both halves (forward and backward) take model
    width ``d`` in ``dtype``: f32 or bf16, 1 ≤ D ≤ 512 (bf16: D padded to 16
    within the wide kernels' 512; f32: conv_front's backward keeps 16 rows ×
    D within 256 threads × 32 accumulators). A pure function of the shapes."""
    return dtype in (torch.float32, torch.bfloat16) and 1 <= d <= MAX_D


def front_wide_smem(d: int) -> tuple[int, int]:
    """Dynamic shared memory (bytes) of conv_front's wide bf16 kernels
    (``csrc/conv_mma.cu``, padded width above 256): the forward's 64 rows of
    the LN output beside two 32-column chunks of Wa and Wb ([Dp][40] each),
    and the backward's 32 rows, those chunks, dha and dhb [32][40], the row
    mean, rstd and the LayerNorm row sums [2][4][32] in f32."""
    dp = -(-d // 16) * 16
    ldd, ldc = dp + _PAD, _WIDE_CC + _PAD
    return 2 * (64 * ldd + 4 * dp * ldc), 2 * (32 * ldd + 4 * dp * ldc + 2 * 32 * ldc) + 4 * (2 * 32 + 8 * 32)


def _width(d: int, dtype: torch.dtype) -> None:
    if not supported(d, dtype):
        raise ValueError(f"model width {d} > {MAX_D} is not supported by the kernels")


def _rows(x: torch.Tensor, name: str) -> tuple[int, int]:
    if x.dim() != 3:
        raise ValueError(f"{name} must be [B, T, D]")
    return x.shape[0] * x.shape[1], x.shape[2]


def _cuda(x: torch.Tensor) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no conv-module kernel for device {x.device}")


# ---------------------------------- conv_front ---------------------------------- #


def conv_front_plain(x, gamma, beta, wa, ba, wb, bb, eps: float = 1e-3):
    """Plain PyTorch version of :func:`conv_front` (same arguments; differentiable by autograd)."""
    y = layer_norm_f32(x, gamma, beta, eps)
    ha = dot_as(y, wa) + ba.float()
    hb = dot_as(y, wb) + bb.float()
    return (ha * torch.sigmoid(hb)).to(x.dtype)


def conv_front_plain_bwd(x, gamma, beta, wa, ba, wb, bb, dout, eps: float = 1e-3):
    """Gradients (dx, dγ, dβ, dWa, dba, dWb, dbb) of :func:`conv_front` with
    the explicit formulas of the Pallas ``_front_bwd_kernel`` (conv_kernel.py:92-127)."""
    return _front_as_inputs(conv_front_plain_bwd_f32(x, gamma, beta, wa, ba, wb, bb, dout, eps), x, wa, ba, wb, bb)


def _front_as_inputs(grads, x, wa, ba, wb, bb):
    dx, dg, db, dwa, dba, dwb, dbb = grads
    return dx.to(x.dtype), dg, db, dwa.to(wa.dtype), dba.to(ba.dtype), dwb.to(wb.dtype), dbb.to(bb.dtype)


def conv_front_plain_bwd_f32(x, gamma, beta, wa, ba, wb, bb, dout, eps: float = 1e-3):
    """:func:`conv_front_plain_bwd` before the final casts: every gradient in f32."""
    y, xhat, rstd = _ln_parts(x, gamma, beta, eps)
    ha = dot_as(y, wa) + ba.float()
    hb = dot_as(y, wb) + bb.float()
    sigb = torch.sigmoid(hb)
    dg = dout.float()
    dha = dg * sigb
    dhb = dg * ha * sigb * (1.0 - sigb)
    rows = lambda t: t.reshape(-1, t.shape[-1])
    y2, dha2, dhb2 = rows(y), rows(dha), rows(dhb)
    dy = dot_as(dha, wa.t()) + dot_as(dhb, wb.t())
    dx, dgam, dbet = ln_backward(rows(dy), rows(xhat), rows(rstd), gamma)
    return dx.reshape(x.shape), dgam, dbet, y2.t() @ dha2, dha2.sum(0), y2.t() @ dhb2, dhb2.sum(0)


def _check_front(x, gamma, beta, wa, ba, wb, bb):
    n, d = _rows(x, "x")
    dev, dt = x.device, x.dtype
    code = _build.compute_dtype(x, "x")
    _build.require(x, "x", device=dev, dtype=dt, shape=tuple(x.shape))
    for name, p in (("gamma", gamma), ("beta", beta)):
        _build.require(p, name, device=dev, dtype=torch.float32, shape=(d,))
    for name, p, shape in (("wa", wa, (d, d)), ("ba", ba, (d,)), ("wb", wb, (d, d)), ("bb", bb, (d,))):
        _build.require(p, name, device=dev, dtype=dt, shape=shape)
    _width(d, dt)
    return n, d, code


def conv_front_kernel(x, gamma, beta, wa, ba, wb, bb, eps: float = 1e-3):
    """The conv_front forward kernel on CUDA tensors (no autograd)."""
    n, d, code = _check_front(x, gamma, beta, wa, ba, wb, bb)
    out = torch.empty_like(x)
    if n == 0:
        return out
    lib = _build.build()
    with tracing.kernel("kernel.conv_front.fwd", x, wa), torch.cuda.device(x.device):
        err = lib.tfasr_conv_front(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), wa.data_ptr(), ba.data_ptr(), wb.data_ptr(), bb.data_ptr(), out.data_ptr(),
            n, d, float(eps), code, _build.stream_of(x),
        )
        _build.check(err, "conv_front")
    return out


def conv_front_bwd_kernel(x, gamma, beta, wa, ba, wb, bb, dout, eps: float = 1e-3):
    """The conv_front backward kernel on CUDA tensors: same results as :func:`conv_front_plain_bwd`."""
    return _front_as_inputs(conv_front_bwd_kernel_f32(x, gamma, beta, wa, ba, wb, bb, dout, eps), x, wa, ba, wb, bb)


def conv_front_bwd_kernel_f32(x, gamma, beta, wa, ba, wb, bb, dout, eps: float = 1e-3):
    """:func:`conv_front_bwd_kernel` before the final casts: dx in x's dtype, the parameter gradients in f32."""
    n, d, code = _check_front(x, gamma, beta, wa, ba, wb, bb)
    _build.require(dout, "dout", device=x.device, dtype=x.dtype, shape=tuple(x.shape))
    lib = _build.build() if n > 0 else None
    with tracing.kernel("kernel.conv_front.bwd", x, wa, dout) if n > 0 else tracing.NULL:
        f32 = dict(dtype=torch.float32, device=x.device)
        dx = torch.empty_like(x)
        cols = torch.zeros(4 * d, **f32)  # dba, dbb, dgamma, dbeta: the bf16 kernels write them as one row
        dba, dbb, dg, db = cols.split(d)
        dwa, dwb = torch.zeros((d, d), **f32), torch.zeros((d, d), **f32)
        if n > 0:
            floats = lib.tfasr_conv_front_mma_scratch(n, d) if x.dtype == torch.bfloat16 else lib.tfasr_conv_bwd_scratch(n, d)
            scratch = torch.empty(int(floats), **f32)
            with torch.cuda.device(x.device):
                err = lib.tfasr_conv_front_bwd(
                    x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), wa.data_ptr(), ba.data_ptr(), wb.data_ptr(), bb.data_ptr(), dout.data_ptr(),
                    dx.data_ptr(), dg.data_ptr(), db.data_ptr(), dwa.data_ptr(), dba.data_ptr(), dwb.data_ptr(), dbb.data_ptr(), scratch.data_ptr(),
                    n, d, float(eps), code, _build.stream_of(x),
                )
            _build.check(err, "conv_front backward")
    return dx, dg, db, dwa, dba, dwb, dbb


class _ConvFront(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, wa, ba, wb, bb, eps):
        ctx.save_for_backward(x, gamma, beta, wa, ba, wb, bb)
        ctx.eps = eps
        if x.device.type == "cpu":
            return conv_front_plain(x, gamma, beta, wa, ba, wb, bb, eps)
        return conv_front_kernel(x, gamma, beta, wa, ba, wb, bb, eps)

    @staticmethod
    def backward(ctx, dout):
        saved = ctx.saved_tensors
        dout = dout.to(saved[0].dtype).contiguous()
        bwd = conv_front_plain_bwd if saved[0].device.type == "cpu" else conv_front_bwd_kernel
        return (*bwd(*saved, dout, ctx.eps), None)


def conv_front(x, gamma, beta, wa, ba, wb, bb, eps: float = 1e-3):
    """GLU([LN(x)·Wa + ba, LN(x)·Wb + bb]): the conv module up to the
    depthwise conv; differentiable. x: [B, T, D]; gamma/beta [D] f32;
    wa/wb: [D, D] ([in, out]) and ba/bb [D] in x's dtype. Returns
    [B, T, D] in x.dtype. A CUDA tensor launches the kernels; a CPU tensor
    takes :func:`conv_front_plain` and :func:`conv_front_plain_bwd`. Under
    ``torch.export`` the call is the custom operator ``tfasr::conv_front``
    (``ops/cuda/library.py``), the forward only, at the widths
    :func:`supported` takes."""
    if torch.compiler.is_exporting():
        from tensorflowasr_tpu_torch.ops.cuda import library

        _width(x.shape[-1], x.dtype)
        return library.conv_front(x, gamma, beta, wa, ba, wb, bb, float(eps))
    _cuda(x)
    return _ConvFront.apply(x, gamma, beta, wa, ba, wb, bb, float(eps))


def depthwise_conv1d(g: torch.Tensor, wd: torch.Tensor, bd: torch.Tensor, padding: str) -> torch.Tensor:
    """Library depthwise conv. g: [B, T, D]; wd: [D, 1, K] taps; causal
    (left pad K−1) or same padding."""
    k = wd.shape[-1]
    pad = (k - 1, 0) if padding == "causal" else ((k - 1) // 2, k // 2)
    y = F.conv1d(F.pad(g.transpose(1, 2), pad), wd.to(g.dtype), bd.to(g.dtype), groups=g.shape[-1])
    return y.transpose(1, 2)


# ---------------------------------- conv_back ---------------------------------- #


def _back_mask(seed, rate, y1):
    if rate <= 0.0:
        return None
    n, d = _rows(y1, "y1")
    return dr.row_col_mask(seed, n, d, rate, y1.device).reshape(y1.shape)


def conv_back_plain(x, y1, mean, var, scale, bias, w2, b2, seed=0, rate: float = 0.0, factor: float = 1.0, eps: float = 1e-3):
    """Plain PyTorch version of :func:`conv_back` (same arguments; differentiable by autograd)."""
    rstd = torch.rsqrt(var.float() + eps)
    bn = (y1.float() - mean.float()) * rstd * scale.float() + bias.float()
    z = dot_as(bn * torch.sigmoid(bn), w2) + b2.float()
    keep = _back_mask(seed, rate, y1)
    if keep is not None:
        z = z * keep
    return (x.float() + factor * z).to(x.dtype)


def conv_back_plain_bwd(y1, mean, var, scale, bias, w2, dout, seed=0, rate: float = 0.0, factor: float = 1.0, eps: float = 1e-3):
    """Gradients (dy1, dmean, dvar, dscale, dbias, dW2, db2) of
    :func:`conv_back` (the skip gradient is ``dout`` itself) with the
    explicit formulas of the Pallas ``_back_bwd_kernel`` (conv_kernel.py:273-305)."""
    return _back_as_inputs(conv_back_plain_bwd_f32(y1, mean, var, scale, bias, w2, dout, seed, rate, factor, eps), y1, mean, var, scale, bias, w2)


def _back_as_inputs(grads, y1, mean, var, scale, bias, w2):
    dy1, dmean, dvar, dscale, dbias, dw2, db2 = grads
    return (dy1.to(y1.dtype), dmean.to(mean.dtype), dvar.to(var.dtype), dscale.to(scale.dtype), dbias.to(bias.dtype), dw2.to(w2.dtype),
            db2.to(w2.dtype))


def conv_back_plain_bwd_f32(y1, mean, var, scale, bias, w2, dout, seed=0, rate: float = 0.0, factor: float = 1.0, eps: float = 1e-3):
    """:func:`conv_back_plain_bwd` before the final casts: every gradient in f32."""
    rstd = torch.rsqrt(var.float() + eps)
    xhat = (y1.float() - mean.float()) * rstd
    bn = xhat * scale.float() + bias.float()
    sig = torch.sigmoid(bn)
    a = bn * sig
    dz = factor * dout.float()
    keep = _back_mask(seed, rate, y1)
    if keep is not None:
        dz = dz * keep
    rows = lambda t: t.reshape(-1, t.shape[-1])
    da = dot_as(dz, w2.t())
    dbn = da * (sig + bn * sig * (1.0 - sig))
    dxhat = dbn * scale.float()
    dy1 = dxhat * rstd
    dmean = rows(-dxhat * rstd).sum(0)
    dvar = rows(dxhat * xhat).sum(0) * -0.5 * rstd * rstd
    return dy1, dmean, dvar, rows(dbn * xhat).sum(0), rows(dbn).sum(0), rows(a).t() @ rows(dz), rows(dz).sum(0)


def _check_back(x, y1, mean, var, scale, bias, w2, b2):
    n, d = _rows(x, "x")
    dev, dt = x.device, x.dtype
    code = _build.compute_dtype(x, "x")
    for name, t in (("x", x), ("y1", y1)):
        _build.require(t, name, device=dev, dtype=dt, shape=tuple(x.shape))
    for name, p in (("mean", mean), ("var", var), ("scale", scale), ("bias", bias)):
        _build.require(p, name, device=dev, dtype=torch.float32, shape=(d,))
    _build.require(w2, "w2", device=dev, dtype=dt, shape=(d, d))
    _build.require(b2, "b2", device=dev, dtype=dt, shape=(d,))
    _width(d, dt)
    return n, d, code


def conv_back_kernel(x, y1, mean, var, scale, bias, w2, b2, seed=0, rate: float = 0.0, factor: float = 1.0, eps: float = 1e-3):
    """The conv_back forward kernel on CUDA tensors (no autograd)."""
    n, d, code = _check_back(x, y1, mean, var, scale, bias, w2, b2)
    out = torch.empty_like(x)
    if n == 0:
        return out
    lib = _build.build()
    with tracing.kernel("kernel.conv_back.fwd", x, y1, w2), torch.cuda.device(x.device):
        err = lib.tfasr_conv_back(
            x.data_ptr(), y1.data_ptr(), mean.data_ptr(), var.data_ptr(), scale.data_ptr(), bias.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            out.data_ptr(), n, d, float(eps), float(factor), *dr.kernel_args(seed, rate), code, _build.stream_of(x),
        )
        _build.check(err, "conv_back")
    return out


def conv_back_bwd_kernel(y1, mean, var, scale, bias, w2, dout, seed=0, rate: float = 0.0, factor: float = 1.0, eps: float = 1e-3):
    """The conv_back backward kernel on CUDA tensors: same results as :func:`conv_back_plain_bwd`."""
    return _back_as_inputs(conv_back_bwd_kernel_f32(y1, mean, var, scale, bias, w2, dout, seed, rate, factor, eps), y1, mean, var, scale, bias, w2)


def conv_back_bwd_kernel_f32(y1, mean, var, scale, bias, w2, dout, seed=0, rate: float = 0.0, factor: float = 1.0, eps: float = 1e-3):
    """:func:`conv_back_bwd_kernel` before the final casts: dy1 in y1's dtype, the parameter gradients in f32."""
    n, d, code = _check_back(y1, y1, mean, var, scale, bias, w2, w2[0])
    _build.require(dout, "dout", device=y1.device, dtype=y1.dtype, shape=tuple(y1.shape))
    lib = _build.build() if n > 0 else None
    with tracing.kernel("kernel.conv_back.bwd", y1, w2, dout) if n > 0 else tracing.NULL:
        f32 = dict(dtype=torch.float32, device=y1.device)
        dy1 = torch.empty_like(y1)
        cols = torch.zeros(3 * d, **f32)  # db2, dbias, dscale: the bf16 kernels write them as one row
        db2, dbias, dscale = cols.split(d)
        dmean, dvar = torch.zeros(d, **f32), torch.zeros(d, **f32)
        dw2 = torch.zeros((d, d), **f32)
        if n > 0:
            floats = lib.tfasr_conv_back_mma_scratch(n, d) if y1.dtype == torch.bfloat16 else lib.tfasr_conv_bwd_scratch(n, d)
            scratch = torch.empty(int(floats), **f32)
            with torch.cuda.device(y1.device):
                err = lib.tfasr_conv_back_bwd(
                    y1.data_ptr(), mean.data_ptr(), var.data_ptr(), scale.data_ptr(), bias.data_ptr(), w2.data_ptr(), dout.data_ptr(), dy1.data_ptr(),
                    dmean.data_ptr(), dvar.data_ptr(), dscale.data_ptr(), dbias.data_ptr(), dw2.data_ptr(), db2.data_ptr(), scratch.data_ptr(),
                    n, d, float(eps), float(factor), *dr.kernel_args(seed, rate), code, _build.stream_of(y1),
                )
            _build.check(err, "conv_back backward")
    return dy1, dmean, dvar, dscale, dbias, dw2, db2


class _ConvBack(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y1, mean, var, scale, bias, w2, b2, seed, rate, factor, eps):
        ctx.save_for_backward(y1, mean, var, scale, bias, w2)
        ctx.cfg = (seed, rate, factor, eps)
        if x.device.type == "cpu":
            return conv_back_plain(x, y1, mean, var, scale, bias, w2, b2, seed, rate, factor, eps)
        return conv_back_kernel(x, y1, mean, var, scale, bias, w2, b2, seed, rate, factor, eps)

    @staticmethod
    def backward(ctx, dout):
        saved = ctx.saved_tensors
        dout_t = dout.to(saved[0].dtype).contiguous()
        bwd = conv_back_plain_bwd if saved[0].device.type == "cpu" else conv_back_bwd_kernel
        return (dout, *bwd(*saved, dout_t, *ctx.cfg), None, None, None, None)


def conv_back(x, y1, mean, var, scale, bias, w2, b2, seed=0, rate: float = 0.0, factor: float = 1.0, eps: float = 1e-3):
    """x + factor · drop(swish((y1 − mean)·rsqrt(var + eps)·scale + bias) · W2 + b2),
    JAX argument order minus ``interpret``; differentiable, including in
    ``mean`` and ``var``. x/y1: [B, T, D]; mean/var/scale/bias [D] f32; w2
    [D, D] ([in, out]) and b2 [D] in x's dtype. A CUDA tensor launches the
    kernels; a CPU tensor takes :func:`conv_back_plain` and
    :func:`conv_back_plain_bwd`. Under ``torch.export`` the call is the
    custom operator ``tfasr::conv_back`` (``ops/cuda/library.py``), the
    forward only, at the widths :func:`supported` takes."""
    if torch.compiler.is_exporting():
        from tensorflowasr_tpu_torch.ops.cuda import library

        _width(x.shape[-1], x.dtype)
        return library.conv_back(x, y1, mean, var, scale, bias, w2, b2, int(seed), float(rate), float(factor), float(eps))
    _cuda(x)
    dr.keep_params(rate)
    return _ConvBack.apply(x, y1, mean, var, scale, bias, w2, b2, int(seed), float(rate), float(factor), float(eps))
