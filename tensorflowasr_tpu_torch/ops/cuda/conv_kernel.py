"""Fused Conformer convolution-module kernels, forward (``csrc/conv_module.cu``).

Replaces ``tensorflowasr_tpu/ops/pallas/conv_kernel.py:conv_front`` (LN →
two D×D pointwise products → GLU) and ``:conv_back`` (BatchNorm apply with
the given mean/var → swish → pointwise → ``x + factor·z``) on the serving
path. The 31-tap depthwise conv between them stays a library op
(:func:`depthwise_conv1d`, ``F.conv1d`` with groups=D), as the reference
leaves it to XLA.

What bounds them on the card: per module ~0.3 GFLOP of products at the
flagship ([8, 250, 144]), small for the card; a plain version makes ~8
device-memory passes over [B·T, 2D] and [B·T, D] tensors (LN, the 2D
pointwise output, GLU, BN, swish, pointwise, residual). Each kernel reads
its row tile once and writes once: one block per 16 rows keeps the
normalised (front) or activated (back) tile in shared memory and stages the
D×D weights 64 output columns at a time. Elementwise math and accumulation
are f32; product operands are rounded to the weights' type as in the
reference.

Dropout (``rate > 0``) is a training feature and arrives with the backward
kernels; ``conv_back`` raises on it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tensorflowasr_tpu_torch.ops.cuda import _build
from tensorflowasr_tpu_torch.ops.cuda.ff_kernel import dot_as, layer_norm_f32

front_launches = 0  # conv_front kernel launches since the last reset
back_launches = 0  # conv_back kernel launches since the last reset


def _rows(x: torch.Tensor, name: str) -> tuple[int, int]:
    if x.dim() != 3:
        raise ValueError(f"{name} must be [B, T, D]")
    return x.shape[0] * x.shape[1], x.shape[2]


def conv_front_plain(x, gamma, beta, wa, ba, wb, bb, eps: float = 1e-3):
    """Plain PyTorch version of :func:`conv_front` (same arguments)."""
    y = layer_norm_f32(x, gamma, beta, eps)
    ha = dot_as(y, wa) + ba.float()
    hb = dot_as(y, wb) + bb.float()
    return (ha * torch.sigmoid(hb)).to(x.dtype)


def conv_front(x, gamma, beta, wa, ba, wb, bb, eps: float = 1e-3):
    """GLU([LN(x)·Wa + ba, LN(x)·Wb + bb]): the conv module up to the
    depthwise conv. x: [B, T, D]; gamma/beta [D] f32; wa/wb: [D, D] ([in,
    out]) and ba/bb [D] in x's dtype. Returns [B, T, D] in x.dtype. A CUDA
    tensor launches the kernel; a CPU tensor takes :func:`conv_front_plain`."""
    global front_launches
    if x.device.type == "cpu":
        return conv_front_plain(x, gamma, beta, wa, ba, wb, bb, eps)
    if x.device.type != "cuda":
        raise ValueError(f"no conv-module kernel for device {x.device}")
    n, d = _rows(x, "x")
    dev, dt = x.device, x.dtype
    code = _build.compute_dtype(x, "x")
    _build.require(x, "x", device=dev, dtype=dt, shape=tuple(x.shape))
    for name, p in (("gamma", gamma), ("beta", beta)):
        _build.require(p, name, device=dev, dtype=torch.float32, shape=(d,))
    for name, p, shape in (("wa", wa, (d, d)), ("ba", ba, (d,)), ("wb", wb, (d, d)), ("bb", bb, (d,))):
        _build.require(p, name, device=dev, dtype=dt, shape=shape)
    out = torch.empty_like(x)
    if n == 0:
        return out
    lib = _build.build()
    with torch.cuda.device(dev):
        err = lib.tfasr_conv_front(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), wa.data_ptr(), ba.data_ptr(), wb.data_ptr(), bb.data_ptr(), out.data_ptr(),
            n, d, float(eps), code, _build.stream_of(x),
        )
    _build.check(err, "conv_front")
    front_launches += 1
    return out


def depthwise_conv1d(g: torch.Tensor, wd: torch.Tensor, bd: torch.Tensor, padding: str) -> torch.Tensor:
    """Library depthwise conv. g: [B, T, D]; wd: [D, 1, K] taps; causal
    (left pad K−1) or same padding."""
    k = wd.shape[-1]
    pad = (k - 1, 0) if padding == "causal" else ((k - 1) // 2, k // 2)
    y = F.conv1d(F.pad(g.transpose(1, 2), pad), wd.to(g.dtype), bd.to(g.dtype), groups=g.shape[-1])
    return y.transpose(1, 2)


def _check_rate(rate: float) -> None:
    if rate > 0.0:
        raise ValueError("conv-module dropout (rate > 0) is a training feature; the forward kernel takes rate == 0")


def conv_back_plain(x, y1, mean, var, scale, bias, w2, b2, seed=0, rate: float = 0.0, factor: float = 1.0, eps: float = 1e-3):
    """Plain PyTorch version of :func:`conv_back` (same arguments)."""
    _check_rate(rate)
    rstd = torch.rsqrt(var.float() + eps)
    bn = (y1.float() - mean.float()) * rstd * scale.float() + bias.float()
    z = dot_as(bn * torch.sigmoid(bn), w2) + b2.float()
    return (x.float() + factor * z).to(x.dtype)


def conv_back(x, y1, mean, var, scale, bias, w2, b2, seed=0, rate: float = 0.0, factor: float = 1.0, eps: float = 1e-3):
    """x + factor · (swish((y1 − mean)·rsqrt(var + eps)·scale + bias) · W2 + b2),
    JAX argument order minus ``interpret``. x/y1: [B, T, D]; mean/var/
    scale/bias [D] f32; w2 [D, D] ([in, out]) and b2 [D] in x's dtype.
    A CUDA tensor launches the kernel; a CPU tensor takes
    :func:`conv_back_plain`."""
    global back_launches
    _check_rate(rate)
    if x.device.type == "cpu":
        return conv_back_plain(x, y1, mean, var, scale, bias, w2, b2, seed, rate, factor, eps)
    if x.device.type != "cuda":
        raise ValueError(f"no conv-module kernel for device {x.device}")
    n, d = _rows(x, "x")
    dev, dt = x.device, x.dtype
    code = _build.compute_dtype(x, "x")
    for name, t in (("x", x), ("y1", y1)):
        _build.require(t, name, device=dev, dtype=dt, shape=tuple(x.shape))
    for name, p in (("mean", mean), ("var", var), ("scale", scale), ("bias", bias)):
        _build.require(p, name, device=dev, dtype=torch.float32, shape=(d,))
    _build.require(w2, "w2", device=dev, dtype=dt, shape=(d, d))
    _build.require(b2, "b2", device=dev, dtype=dt, shape=(d,))
    out = torch.empty_like(x)
    if n == 0:
        return out
    lib = _build.build()
    with torch.cuda.device(dev):
        err = lib.tfasr_conv_back(
            x.data_ptr(), y1.data_ptr(), mean.data_ptr(), var.data_ptr(), scale.data_ptr(), bias.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            out.data_ptr(), n, d, float(eps), float(factor), code, _build.stream_of(x),
        )
    _build.check(err, "conv_back")
    back_launches += 1
    return out
