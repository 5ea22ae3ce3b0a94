"""Fused Conformer feed-forward module kernel, forward and backward (``csrc/ff.cu``).

Replaces ``tensorflowasr_tpu/ops/pallas/ff_kernel.py:fused_ff``:
``x + factor·drop₂(W2·drop₁(swish(W1·LN(x) + b1)) + b2)``, LN eps 1e-3,
with its ``custom_vjp``.

What bounds it on the card: at the flagship (N = 8·250 rows served, 16·400
trained; D=144, F=576) the two products are ~0.7 GFLOP per 2000 rows,
small for the card; a plain version is bound by device-memory passes over
the [N, 576] activation (W1 output, swish, masks, casts) and the [N, 144]
LN/residual tensors. The forward kernel keeps the [rows, F] intermediate
out of device memory: one block per 16 rows holds the LN output in shared
memory and walks F in 64-wide chunks, staging each chunk's W1 and W2
slices, forming the swish activation in shared memory and accumulating its
W2 product in registers. In bf16 with 16 | D both products run on the
tensor cores (WMMA); the CUDA-core version of the same tiling serves f32
and other widths. Both dropout sites run in-kernel from the counter hash of
``ops/dropout.py`` (site 1 with ``seed``, site 2 with ``seed + 7919``,
indexed by global row and column), regenerated in the backward.

The backward (:class:`_FusedFF`) saves the inputs only and recomputes LN,
h, swish and the masks, as the Pallas VJP does; its kernel writes dx and
the row activations, and a deterministic row reduction forms the weight
gradients (see ``csrc/ff.cu``). :func:`fused_ff_plain_bwd` is its plain
twin with the explicit formulas of the Pallas ``_bwd_kernel``.
"""

from __future__ import annotations

import torch

from tensorflowasr_tpu_torch.ops import dropout as dr
from tensorflowasr_tpu_torch.ops.cuda import _build

launches = 0  # forward kernel launches since the last reset (set to 0 to reset)
bwd_launches = 0  # backward kernel launches since the last reset

_RT, _THREADS, _Z_PER_THREAD = 16, 256, 16  # csrc/ff.cu


def layer_norm_f32(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float) -> torch.Tensor:
    """Row LayerNorm with f32 statistics (ff_kernel._ln_fwd): returns f32."""
    return _ln_parts(x, gamma, beta, eps)[0]


def _ln_parts(x, gamma, beta, eps):
    """(y, xhat, rstd) of the f32 row LayerNorm."""
    x32 = x.float()
    cx = x32 - x32.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt((cx * cx).mean(dim=-1, keepdim=True) + eps)
    xhat = cx * rstd
    return xhat * gamma.float() + beta.float(), xhat, rstd


def ln_backward(dy: torch.Tensor, xhat: torch.Tensor, rstd: torch.Tensor, gamma: torch.Tensor):
    """LayerNorm backward (y = xhat·γ + β): (dx, dγ, dβ) with f32 sums over rows."""
    dxn = dy * gamma.float()
    m1 = dxn.mean(dim=-1, keepdim=True)
    m2 = (dxn * xhat).mean(dim=-1, keepdim=True)
    return rstd * (dxn - m1 - xhat * m2), (dy * xhat).sum(0), dy.sum(0)


def dot_as(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a`` rounded to ``w``'s type, times ``w``, accumulated in f32."""
    return torch.matmul(a.to(w.dtype).float(), w.float())


def _masks(seed: int, rate: float, n: int, d: int, f: int, device):
    if rate <= 0.0:
        return None, None
    return dr.row_col_mask(seed, n, f, rate, device), dr.row_col_mask(seed + dr.SALT_SITE2, n, d, rate, device)


def fused_ff_plain(x, gamma, beta, w1, b1, w2, b2, seed=0, rate: float = 0.0, factor: float = 0.5, eps: float = 1e-3):
    """Plain PyTorch version of :func:`fused_ff` (same arguments; differentiable by autograd)."""
    keep1, keep2 = _masks(seed, rate, x.shape[0], x.shape[1], w1.shape[1], x.device)
    y = layer_norm_f32(x, gamma, beta, eps)
    h = dot_as(y, w1) + b1.float()
    a = h * torch.sigmoid(h)
    if keep1 is not None:
        a = a * keep1
    z = dot_as(a, w2) + b2.float()
    if keep2 is not None:
        z = z * keep2
    return (x.float() + factor * z).to(x.dtype)


def fused_ff_plain_bwd(x, gamma, beta, w1, b1, w2, dout, seed=0, rate: float = 0.0, factor: float = 0.5, eps: float = 1e-3):
    """Gradients (dx, dγ, dβ, dW1, db1, dW2, db2) of :func:`fused_ff` with
    the explicit formulas of the Pallas ``_bwd_kernel`` (ff_kernel.py:114-159),
    recomputing the forward; each returned in its input's dtype."""
    keep1, keep2 = _masks(seed, rate, x.shape[0], x.shape[1], w1.shape[1], x.device)
    y, xhat, rstd = _ln_parts(x, gamma, beta, eps)
    h = dot_as(y, w1) + b1.float()
    sig = torch.sigmoid(h)
    a = h * sig
    ad = a if keep1 is None else a * keep1
    do = dout.float()
    dz = factor * do
    if keep2 is not None:
        dz = dz * keep2
    db2, dw2 = dz.sum(0), ad.t() @ dz
    da = dot_as(dz, w2.t())
    if keep1 is not None:
        da = da * keep1
    dh = da * (sig + h * sig * (1.0 - sig))
    db1, dw1 = dh.sum(0), y.t() @ dh
    dy = dot_as(dh, w1.t())
    dx_ln, dg, db = ln_backward(dy, xhat, rstd, gamma)
    return ((do + dx_ln).to(x.dtype), dg.to(gamma.dtype), db.to(beta.dtype), dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype),
            db2.to(w2.dtype))


def _check(x, gamma, beta, w1, b1, w2, b2):
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
    return n, d, f, code


def fused_ff_kernel(x, gamma, beta, w1, b1, w2, b2, seed=0, rate: float = 0.0, factor: float = 0.5, eps: float = 1e-3):
    """The forward kernel on CUDA tensors (no autograd)."""
    global launches
    n, d, f, code = _check(x, gamma, beta, w1, b1, w2, b2)
    out = torch.empty_like(x)
    if n == 0:
        return out
    lib = _build.build()
    with torch.cuda.device(x.device):
        err = lib.tfasr_fused_ff(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
            n, d, f, float(eps), float(factor), *dr.kernel_args(seed, rate), code, _build.stream_of(x),
        )
    _build.check(err, "fused_ff")
    launches += 1
    return out


def fused_ff_bwd_kernel(x, gamma, beta, w1, b1, w2, dout, seed=0, rate: float = 0.0, factor: float = 0.5, eps: float = 1e-3):
    """The backward kernel on CUDA tensors: same results as :func:`fused_ff_plain_bwd`."""
    global bwd_launches
    n, d, f, code = _check(x, gamma, beta, w1, b1, w2, b1.new_empty(x.shape[1]))
    _build.require(dout, "dout", device=x.device, dtype=x.dtype, shape=(n, d))
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dg, db, db2 = (torch.zeros(d, **f32) for _ in range(3))
    dw1, db1, dw2 = torch.zeros((d, f), **f32), torch.zeros(f, **f32), torch.zeros((f, d), **f32)
    if n > 0:
        lib = _build.build()
        scratch = torch.empty(int(lib.tfasr_fused_ff_bwd_scratch(n, d, f)), **f32)
        with torch.cuda.device(x.device):
            err = lib.tfasr_fused_ff_bwd(
                x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), dout.data_ptr(), dx.data_ptr(),
                dg.data_ptr(), db.data_ptr(), dw1.data_ptr(), db1.data_ptr(), dw2.data_ptr(), db2.data_ptr(), scratch.data_ptr(),
                n, d, f, float(eps), float(factor), *dr.kernel_args(seed, rate), code, _build.stream_of(x),
            )
        _build.check(err, "fused_ff backward")
        bwd_launches += 1
    return dx, dg, db, dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype), db2.to(w2.dtype)


class _FusedFF(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, w1, b1, w2, b2, seed, rate, factor, eps):
        ctx.save_for_backward(x, gamma, beta, w1, b1, w2)
        ctx.cfg = (seed, rate, factor, eps)
        if x.device.type == "cpu":
            return fused_ff_plain(x, gamma, beta, w1, b1, w2, b2, seed, rate, factor, eps)
        return fused_ff_kernel(x, gamma, beta, w1, b1, w2, b2, seed, rate, factor, eps)

    @staticmethod
    def backward(ctx, dout):
        x, gamma, beta, w1, b1, w2 = ctx.saved_tensors
        dout = dout.to(x.dtype).contiguous()
        bwd = fused_ff_plain_bwd if x.device.type == "cpu" else fused_ff_bwd_kernel
        return (*bwd(x, gamma, beta, w1, b1, w2, dout, *ctx.cfg), None, None, None, None)


def fused_ff(x, gamma, beta, w1, b1, w2, b2, seed=0, rate: float = 0.0, factor: float = 0.5, eps: float = 1e-3):
    """x + factor · drop₂(W2 · drop₁(swish(W1 · LN(x) + b1)) + b2), JAX
    argument order minus ``interpret``; differentiable.

    x: [N, D]; gamma/beta: [D] f32 LN params; w1: [D, F], b1: [F],
    w2: [F, D], b2: [D] in x's dtype; seed: int for both dropout sites,
    rate in [0, 1). Returns [N, D] in x.dtype. A CUDA tensor launches the
    kernels (forward, and backward under autograd); a CPU tensor takes
    :func:`fused_ff_plain` and :func:`fused_ff_plain_bwd`.
    """
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no feed-forward kernel for device {x.device}")
    dr.keep_params(rate)
    return _FusedFF.apply(x, gamma, beta, w1, b1, w2, b2, int(seed), float(rate), float(factor), float(eps))
