"""Fused Conformer feed-forward module kernel, forward and backward (``csrc/ff.cu``).

Replaces ``tensorflowasr_tpu/ops/pallas/ff_kernel.py:fused_ff``:
``x + factor·drop₂(W2·drop₁(swish(W1·LN(x) + b1)) + b2)``, LN eps 1e-3,
with its ``custom_vjp``.

What bounds it on the card: at the flagship (N = 8·250 rows served, 16·400
trained; D=144, F=576) the two products are ~0.7 GFLOP per 2000 rows,
small for the card; a plain version is bound by device-memory passes over
the [N, 576] activation (W1 output, swish, masks, casts) and the [N, 144]
LN/residual tensors. The kernels keep the [rows, F] intermediate out of
device memory: a block holds its rows' LN output in shared memory and walks
F in 64-wide chunks, staging each chunk's W1 and W2 slices. bf16 runs on the
tensor cores (``csrc/ff_mma.cu``: mma.sync, 64 rows per block backward
and 64 or 32 forward by :func:`ff_fwd_rows`, the weight chunks
double-buffered with cp.async, any width padded in shared memory; above D
256, to Conformer-L's D 512, F 2048, the wide kernels: the forward 32 or 64
rows a block (by :func:`ff_fwd_rows` as the narrow forward), 32-column F
chunks, the output columns split over four warps; the backward's rows pass
on wgmma with TMA-fed rings (a row prologue, a persistent products pass over
[128 × 128] tiles, a dy pass of 64-row blocks); :func:`ff_mma_plan` gives
the tiles and shared memory); f32 keeps the
CUDA-core kernels of ``csrc/ff.cu`` (16 rows per block; TF32 would break
the f32 card/CPU parity). :func:`supported` says which widths the kernels
take; the Conformer's ``FFModule`` runs its plain modules at any other. Both dropout sites run in-kernel from the counter
hash of ``ops/dropout.py`` (site 1 with ``seed``, site 2 with ``seed +
7919``, indexed by global row and column), regenerated in the backward.

The backward (:class:`_FusedFF`) saves the inputs only and recomputes LN,
h, swish and the masks, as the Pallas VJP does; its row kernel writes dx
and the row activations, and a deterministic reduction over a fixed row
split forms the weight gradients (in bf16 from f32 operands split into
bf16 high and low parts, three tensor-core products each; see
``csrc/ff_mma.cu``). :func:`fused_ff_plain_bwd` is its plain twin with the
explicit formulas of the Pallas ``_bwd_kernel``.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from tensorflowasr_tpu_torch.ops import dropout as dr
from tensorflowasr_tpu_torch.ops.cuda import _build
from tensorflowasr_tpu_torch.utils import tracing

_MMA_ROWS, _MMA_THREADS, _MMA_FC, _MMA_PAD = 64, 256, 64, 8  # csrc/ff_mma.cu (the bf16 kernels)
FWD_ROWS = (64, 32)  # the bf16 forward's row tiles: 4 row groups of 16 with each chunk split over 2 warps, or 2 over 4
NARROW_D, MAX_D = 256, 512  # padded widths of the narrow bf16 kernels; widths the kernels take (both dtypes)
_WIDE_FC = 32  # csrc/ff_mma.cu's wide forward: F columns a chunk
# csrc/ff_mma.cu's wide backward: a producer and two consumer warpgroups, the ring's stages, the products' tile (rows, F
# columns), the dy pass's rows a block (and a column-sum partial's), k columns a stage, the ring's alignment
_WB_THREADS, _WB_STAGES, _WB_TILE, _WB_DY_ROWS, _WB_BK, _WB_ALIGN = 384, 3, (128, 128), 64, 64, 1024


def supported(d: int, f: int, dtype: torch.dtype) -> bool:
    """Whether the kernels (forward and backward) take model width ``d`` and
    inner width ``f`` in ``dtype``: f32 or bf16, 1 ≤ D ≤ 512 (f32: 16 rows ×
    D within 256 threads × 32 accumulators; bf16: D padded to 16 within the
    wide kernels' 512), any F ≥ 1. A pure function of the shapes."""
    return dtype in (torch.float32, torch.bfloat16) and 1 <= d <= MAX_D and f >= 1
SM_SHARED_BYTES, BLOCK_RESERVED_BYTES, MAX_BLOCK_SHARED_BYTES, SMS = 228 * 1024, 1024, 227 * 1024, 132  # H100 SXM


@dataclasses.dataclass(frozen=True)
class FFPlan:
    """The bf16 tensor-core kernels' tile and shared memory at one width."""

    rows: int  # rows per backward block
    threads: int
    fwd_rows: int  # rows per forward block: 64 or 32 (8 warps either way)
    chunk: int  # F columns per chunk (split over 2 warps, or 4 in the 32-row forward)
    padded_d: int  # D rounded up to 16 in shared memory
    chunks: int
    fwd_smem_bytes: int
    bwd_smem_bytes: int
    fwd_blocks_per_sm: int  # as shared memory allows (the card's occupancy also counts registers)
    bwd_blocks_per_sm: int


def ff_mma_plan(d: int, f: int, fwd_rows: int = _MMA_ROWS) -> FFPlan:
    """Tile and dynamic shared memory of ``csrc/ff_mma.cu`` at width D and
    inner width F, with the forward at ``fwd_rows`` rows a block: the LN
    output (and, backward, dz) as bf16 rows of Dp + 8, two W1 chunks
    [Dp][72] and two W2 chunks [64][Dp + 8] in bf16, and the backward's row
    mean and rstd in f32. Above Dp 256 the wide kernels: ``fwd_rows`` rows
    forward (8 warps a 16-row group: 512 threads at 64 rows), two W1 chunks
    [Dp][40], two W2 chunks [32][Dp + 8] and the chunk's activation
    [rows][40]; the backward's rows pass on wgmma (``rows`` 64, the dy
    pass's and a column-sum partial's; 384 threads), ``bwd_smem_bytes`` the
    larger of its two kernels' rings of 3 stages of [rows][64] bf16 tiles
    behind 1,024 bytes of alignment slack with a full and an empty barrier a
    stage: the products pass's [128][64] tiles of y, dz, W1ᵀ and W2 (64 KB a
    stage) with its two warpgroups' [64][128] bf16 staging tiles of the
    outputs, and the dy pass's dh [64][64] and W1 [512][64] (72 KB a
    stage)."""
    if fwd_rows not in FWD_ROWS:
        raise ValueError(f"the forward takes {FWD_ROWS} rows a block, not {fwd_rows}")
    dp = -(-d // 16) * 16
    ldd = dp + _MMA_PAD
    per_sm = lambda b, threads: min(SM_SHARED_BYTES // (b + BLOCK_RESERVED_BYTES), 2048 // threads, 32)
    if dp > NARROW_D:
        ldf = _WIDE_FC + _MMA_PAD
        fwd_at = lambda rows: 2 * (rows * ldd + 2 * dp * ldf + 2 * _WIDE_FC * ldd + rows * ldf)
        tile_rows, tile_f = _WB_TILE
        barriers = 2 * _WB_STAGES * 8
        products = _WB_ALIGN + _WB_STAGES * 4 * tile_rows * _WB_BK * 2 + 2 * _WB_DY_ROWS * tile_f * 2 + barriers
        dy = _WB_ALIGN + _WB_STAGES * (_WB_DY_ROWS + MAX_D) * _WB_BK * 2 + barriers
        bwd = max(products, dy)
        return FFPlan(_WB_DY_ROWS, _WB_THREADS, fwd_rows, _WIDE_FC, dp, -(-f // _WIDE_FC), fwd_at(fwd_rows), bwd,
                      per_sm(fwd_at(fwd_rows), 8 * fwd_rows), per_sm(bwd, _WB_THREADS))
    weights = 2 * dp * (_MMA_FC + _MMA_PAD) + 2 * _MMA_FC * ldd
    fwd = 2 * (fwd_rows * ldd + weights)
    bwd = 2 * (_MMA_ROWS * ldd + weights) + 2 * _MMA_ROWS * ldd + 4 * 2 * _MMA_ROWS
    return FFPlan(_MMA_ROWS, _MMA_THREADS, fwd_rows, _MMA_FC, dp, -(-f // _MMA_FC), fwd, bwd, per_sm(fwd, _MMA_THREADS),
                  per_sm(bwd, _MMA_THREADS))


def ff_fwd_rows(n: int, wave: int) -> int:
    """The bf16 forward's rows per block for N rows, where ``wave`` 32-row
    blocks run at once on the card (:func:`one_wave_blocks`): 32 when their
    grid fits in one wave, else 64, which reads the weights half as often.
    A block's time is its warps' chain over the F chunks, shorter at 32 rows
    (each chunk split over 4 warps, not 2): the serving N = 2000 and the
    training N = 6400 at D 144 take 32, N = 6400 at D 176 (one 32-row block
    per SM) takes 64."""
    return 32 if -(-n // 32) <= wave else 64


@functools.lru_cache(maxsize=None)
def one_wave_blocks(index: int, d: int) -> int:
    """32-row forward blocks card ``index`` runs at once at width D: its SMs
    times the kernel's blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    lib = _build.build()
    with torch.cuda.device(index):
        per_sm = lib.tfasr_ff_mma_occupancy(d, 32)
    if per_sm < 1:
        raise RuntimeError(f"the card runs no 32-row FF forward block at width {d} (occupancy {per_sm})")
    return torch.cuda.get_device_properties(index).multi_processor_count * per_sm


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
    grads = fused_ff_plain_bwd_f32(x, gamma, beta, w1, b1, w2, dout, seed, rate, factor, eps)
    return _as_inputs(grads, x, gamma, beta, w1, b1, w2)


def fused_ff_plain_bwd_f32(x, gamma, beta, w1, b1, w2, dout, seed=0, rate: float = 0.0, factor: float = 0.5, eps: float = 1e-3):
    """:func:`fused_ff_plain_bwd` before the final casts: dx and every parameter gradient in f32."""
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
    return do + dx_ln, dg, db, dw1, db1, dw2, db2


def _as_inputs(grads, x, gamma, beta, w1, b1, w2):
    """(dx, dγ, dβ, dW1, db1, dW2, db2) cast to their inputs' dtypes (db2 to w2's)."""
    dx, dg, db, dw1, db1, dw2, db2 = grads
    return dx.to(x.dtype), dg.to(gamma.dtype), db.to(beta.dtype), dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype), db2.to(w2.dtype)


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
    if not supported(d, f, dt):
        raise ValueError(f"model width {d} > {MAX_D} is not supported by the kernel")
    return n, d, f, code


def fused_ff_kernel(x, gamma, beta, w1, b1, w2, b2, seed=0, rate: float = 0.0, factor: float = 0.5, eps: float = 1e-3, rows: int | None = None):
    """The forward kernel on CUDA tensors (no autograd). ``rows``: the bf16
    forward's rows per block (one of ``FWD_ROWS``; default
    :func:`ff_fwd_rows` for this N and card)."""
    n, d, f, code = _check(x, gamma, beta, w1, b1, w2, b2)
    if n == 0:
        return torch.empty_like(x)
    if rows is None:
        rows = ff_fwd_rows(n, one_wave_blocks(x.device.index if x.device.index is not None else torch.cuda.current_device(), d))
    elif rows not in FWD_ROWS:
        raise ValueError(f"the forward takes {FWD_ROWS} rows a block, not {rows}")
    lib = _build.build()
    with tracing.kernel("kernel.ff.fwd", x, w1), torch.cuda.device(x.device):
        out = torch.empty_like(x)
        err = lib.tfasr_fused_ff(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
            n, d, f, int(rows), float(eps), float(factor), *dr.kernel_args(seed, rate), code, _build.stream_of(x),
        )
        _build.check(err, "fused_ff")
    return out


def fused_ff_bwd_kernel(x, gamma, beta, w1, b1, w2, dout, seed=0, rate: float = 0.0, factor: float = 0.5, eps: float = 1e-3):
    """The backward kernel on CUDA tensors: same results as :func:`fused_ff_plain_bwd`."""
    grads = fused_ff_bwd_kernel_f32(x, gamma, beta, w1, b1, w2, dout, seed, rate, factor, eps)
    return _as_inputs(grads, x, gamma, beta, w1, b1, w2)


def fused_ff_bwd_kernel_f32(x, gamma, beta, w1, b1, w2, dout, seed=0, rate: float = 0.0, factor: float = 0.5, eps: float = 1e-3):
    """:func:`fused_ff_bwd_kernel` before the final casts: dx in x's dtype, the parameter gradients in f32."""
    n, d, f, code = _check(x, gamma, beta, w1, b1, w2, b1.new_empty(x.shape[1]))
    _build.require(dout, "dout", device=x.device, dtype=x.dtype, shape=(n, d))
    lib = _build.build() if n > 0 else None
    with tracing.kernel("kernel.ff.bwd", x, w1, dout) if n > 0 else tracing.NULL:
        f32 = dict(dtype=torch.float32, device=x.device)
        dx = torch.empty_like(x)
        cols = torch.zeros(f + 3 * d, **f32)  # db1, db2, dgamma, dbeta: the bf16 kernels write them as one row
        db1, db2, dg, db = cols.split((f, d, d, d))
        dw1, dw2 = torch.zeros((d, f), **f32), torch.zeros((f, d), **f32)
        if n > 0:
            scratch = torch.empty(int(lib.tfasr_fused_ff_bwd_scratch(n, d, f, code)), **f32)
            with torch.cuda.device(x.device):
                err = lib.tfasr_fused_ff_bwd(
                    x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), dout.data_ptr(), dx.data_ptr(),
                    dg.data_ptr(), db.data_ptr(), dw1.data_ptr(), db1.data_ptr(), dw2.data_ptr(), db2.data_ptr(), scratch.data_ptr(),
                    n, d, f, float(eps), float(factor), *dr.kernel_args(seed, rate), code, _build.stream_of(x),
                )
            _build.check(err, "fused_ff backward")
            if lib.tfasr_fused_ff_bwd_wide(d, code):
                tracing.launches["kernel.ff.bwd.wide"] += 1  # the library took the rows pass on wgmma
    return dx, dg, db, dw1, db1, dw2, db2


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
    :func:`fused_ff_plain` and :func:`fused_ff_plain_bwd`. Under
    ``torch.export`` the call is the custom operator ``tfasr::fused_ff``
    (``ops/cuda/library.py``), the forward only, at the widths
    :func:`supported` takes (a caller routes any other to its plain modules).
    """
    if torch.compiler.is_exporting():
        from tensorflowasr_tpu_torch.ops.cuda import library

        if not supported(x.shape[-1], w1.shape[-1], x.dtype):
            raise ValueError(f"model width {x.shape[-1]} > {MAX_D} is not supported by the kernel")
        return library.fused_ff(x, gamma, beta, w1, b1, w2, b2, int(seed), float(rate), float(factor), float(eps))
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no feed-forward kernel for device {x.device}")
    dr.keep_params(rate)
    return _FusedFF.apply(x, gamma, beta, w1, b1, w2, b2, int(seed), float(rate), float(factor), float(eps))
