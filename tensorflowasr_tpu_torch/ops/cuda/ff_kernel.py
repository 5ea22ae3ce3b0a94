"""Fused Conformer feed-forward module kernel, forward (``csrc/ff.cu``).

Replaces ``tensorflowasr_tpu/ops/pallas/ff_kernel.py:fused_ff`` on the
serving path: ``x + factor·(W2·swish(W1·LN(x) + b1) + b2)``, LN eps 1e-3.

What bounds it on the card: at the flagship (N = 8·250 rows, D=144,
F=576) the two products are ~0.7 GFLOP, small for the card; a plain
version is bound by device-memory passes over the [N, 576] activation
(W1 output, swish, its cast) and the [N, 144] LN/residual tensors. The
kernel keeps the [rows, F] intermediate out of device memory: one block
per 16 rows holds the LN output in shared memory and walks F in 64-wide
chunks, staging each chunk's W1 and W2 slices, forming the swish
activation in shared memory and accumulating its W2 product in registers.
LN statistics and the residual are f32; product operands are rounded to
the weights' type as in the reference. In bf16 with 16 | D (the serving
path) both products run on the tensor cores (WMMA 16×16×16 bf16, f32
accumulation); the CUDA-core version of the same tiling, which measured
slower than the plain version, serves f32 and other widths.

Dropout (``rate > 0``) is a training feature and arrives with the backward
kernel; this forward raises on it.
"""

from __future__ import annotations

import torch

from tensorflowasr_tpu_torch.ops.cuda import _build

launches = 0  # kernel launches since the last reset (set to 0 to reset)

_RT, _THREADS, _Z_PER_THREAD = 16, 256, 16  # csrc/ff.cu


def _check_rate(rate: float) -> None:
    if rate > 0.0:
        raise ValueError("feed-forward dropout (rate > 0) is a training feature; the forward kernel takes rate == 0")


def layer_norm_f32(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float) -> torch.Tensor:
    """Row LayerNorm with f32 statistics (ff_kernel._ln_fwd): returns f32."""
    x32 = x.float()
    cx = x32 - x32.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt((cx * cx).mean(dim=-1, keepdim=True) + eps)
    return cx * rstd * gamma.float() + beta.float()


def dot_as(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a`` rounded to ``w``'s type, times ``w``, accumulated in f32."""
    return torch.matmul(a.to(w.dtype).float(), w.float())


def fused_ff_plain(x, gamma, beta, w1, b1, w2, b2, seed=0, rate: float = 0.0, factor: float = 0.5, eps: float = 1e-3):
    """Plain PyTorch version of :func:`fused_ff` (same arguments)."""
    _check_rate(rate)
    y = layer_norm_f32(x, gamma, beta, eps)
    h = dot_as(y, w1) + b1.float()
    z = dot_as(h * torch.sigmoid(h), w2) + b2.float()
    return (x.float() + factor * z).to(x.dtype)


def fused_ff(x, gamma, beta, w1, b1, w2, b2, seed=0, rate: float = 0.0, factor: float = 0.5, eps: float = 1e-3):
    """x + factor · (W2 · swish(W1 · LN(x) + b1) + b2), JAX argument order
    minus ``interpret``.

    x: [N, D]; gamma/beta: [D] f32 LN params; w1: [D, F], b1: [F],
    w2: [F, D], b2: [D] in x's dtype. Returns [N, D] in x.dtype. A CUDA
    tensor launches the kernel; a CPU tensor takes :func:`fused_ff_plain`.
    """
    global launches
    _check_rate(rate)
    if x.device.type == "cpu":
        return fused_ff_plain(x, gamma, beta, w1, b1, w2, b2, seed, rate, factor, eps)
    if x.device.type != "cuda":
        raise ValueError(f"no feed-forward kernel for device {x.device}")
    if x.dim() != 2 or w1.dim() != 2:
        raise ValueError("x must be [N, D] and w1 [D, F]")
    n, d = x.shape
    f = w1.shape[1]
    dev, dt = x.device, x.dtype
    code = _build.compute_dtype(x, "x")
    _build.require(x, "x", device=dev, dtype=dt, shape=(n, d))
    for name, p in (("gamma", gamma), ("beta", beta)):
        _build.require(p, name, device=dev, dtype=torch.float32, shape=(d,))
    for name, p, shape in (("w1", w1, (d, f)), ("b1", b1, (f,)), ("w2", w2, (f, d)), ("b2", b2, (d,))):
        _build.require(p, name, device=dev, dtype=dt, shape=shape)
    if _RT * d > _THREADS * _Z_PER_THREAD:
        raise ValueError(f"model width {d} > {_THREADS * _Z_PER_THREAD // _RT} is not supported by the kernel")
    out = torch.empty_like(x)
    if n == 0:
        return out
    lib = _build.build()
    with torch.cuda.device(dev):
        err = lib.tfasr_fused_ff(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
            n, d, f, float(eps), float(factor), code, _build.stream_of(x),
        )
    _build.check(err, "fused_ff")
    launches += 1
    return out
