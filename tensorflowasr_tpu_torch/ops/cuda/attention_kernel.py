"""The fused attention kernels, forward and backward: relative-position
attention (kernel B, ``csrc/rel_attention.cu``) and attention with an
additive bias (kernel A, ``csrc/attention.cu``, at the end of this module).

Replaces ``tensorflowasr_tpu/ops/pallas/attention_kernel.py:fused_rel_attention``
(kernel B) with its ``custom_vjp``: content scores ``qc·kᵀ``, the
Transformer-XL term ``qp·posᵀ`` read at its relative column, the Keras
−1e9 mask merge, f32 softmax, probability dropout and P·V.

What bounds it on the card: at the flagship (B·H=64, T=S=400, dh=36 in
training) the products are ~0.8 GFLOP per call, far below the card's rate;
the cost is the score-shaped intermediates a plain version writes to device
memory (content scores, the [T, R] positional product, the shifted copy,
masks, the f32 softmax — ~10 passes of B·H·T·S floats). The kernels keep
them on chip: a block stages key tiles and exactly the window of relative
positions its rows read, so the rel shift is index arithmetic (no [T, R]
product, no barrel shift as on the TPU), and the normalised probabilities
(times the dropout keep factor) are rounded to v's type before P·V as in
the reference. bf16 runs on the tensor cores (``csrc/rel_attention_mma.cu``:
mma.sync, 64 query rows per block, the relative term as one [16 × 80] band
product per warp and key tile read back at its skewed column, two forward
sweeps that keep the rows' softmax statistics for the backward;
:func:`rel_mma_plan` gives its shared memory; heads up to 64 run one
instantiation, heads up to 128 another, whose dq pass splits the head into
two column blocks); f32 keeps the CUDA-core kernels of
``csrc/rel_attention.cu`` (16 rows per block, whole score rows resident,
4 or 8 outputs a thread by head size). Heads above 128 raise. Dropout uses the counter hash of ``ops/dropout.py`` indexed by
(b·h, row, column) under the seed ``seed + b·h·40499``, so its masks equal
JAX's bit for bit.

The backward (:class:`_RelAttention`) saves the inputs, the output and (bf16)
the statistics; three kernel passes recompute the probabilities, write ds and
the dropped probabilities once to device memory, and form dqc, dqp, dk, dv
and dpos (see ``csrc/rel_attention_mma.cu`` and ``csrc/rel_attention.cu``).
:func:`fused_rel_attention_plain_bwd` is its plain twin with the explicit
formulas of the Pallas ``_rel_bwd_kernel``.
"""

from __future__ import annotations

import torch

from tensorflowasr_tpu_torch.ops import dropout as dr
from tensorflowasr_tpu_torch.ops.cuda import _build
from tensorflowasr_tpu_torch.utils import tracing

_TQ, _KT, _THREADS = 16, 64, 256  # csrc/rel_attention.cu (the f32 kernels)
_REL_MAX_D = 128  # both routes: the f32 kernels' accumulators and the bf16 kernels' DMAX 128 instantiation
_MAX_SMEM = 227 * 1024
# csrc/rel_attention_mma.cu (the bf16 kernels): rows (or keys, positions) per block, key tile, query tile of
# the dk/dv and dpos passes, pos window rows, f32 band row stride, bf16 row padding, threads
_RB_BLOCK, _RB_KT, _RB_QT, _RB_WIN, _RB_BLD, _RB_PAD, _RB_THREADS = 64, 64, 32, 128, 84, 8, 128
_SM_SHARED, _BLOCK_RESERVED = 228 * 1024, 1024  # H100 SXM


def _rel_f32_smem(d: int, s: int) -> int:
    """Shared memory of kernel B's f32 backward at head size d and s keys (bf16 holds no score row)."""
    sp = -(-s // _KT) * _KT
    return 4 * (2 * _TQ * d + _KT * (d + 1) + (_KT + _TQ - 1) * (d + 1) + _TQ * sp) + 4 * (_TQ * d + _TQ)


def rel_supported(d: int, s: int, dtype: torch.dtype) -> bool:
    """Whether kernel B (forward and backward) takes head size ``d`` over
    ``s`` keys in ``dtype``: heads up to 128; in f32 also a key row whose
    scores fit the backward's shared memory (227 KB: s up to ~2,600 at head
    128). A pure function of the shapes; the relative attention layers run
    the plain attention at any other."""
    if dtype not in (torch.float32, torch.bfloat16) or not 1 <= d <= _REL_MAX_D:
        return False
    return dtype == torch.bfloat16 or _rel_f32_smem(d, s) <= _MAX_SMEM


def _attention_f32_smem(d: int, s: int) -> int:
    """Shared memory of kernel A's f32 backward at head size d and s keys (bf16 needs no S-sized buffer)."""
    sp = -(-s // _FA_KT) * _FA_KT
    return 4 * (_FA_TQ * d + _FA_KT * (d + 1) + _FA_TQ * sp + _FA_TQ * d + _FA_TQ)


def supported(d: int, s: int, dtype: torch.dtype) -> bool:
    """Whether kernel A (forward and backward) takes head size ``d`` over
    ``s`` keys in ``dtype``, as :func:`rel_supported` says for kernel B."""
    if dtype not in (torch.float32, torch.bfloat16) or not 1 <= d <= _FA_MAX_D:
        return False
    return dtype == torch.bfloat16 or _attention_f32_smem(d, s) <= _MAX_SMEM


def rel_mma_plan(d: int) -> dict:
    """Dynamic shared memory (bytes) and blocks per SM, as shared memory
    allows, of the bf16 kernels at head size D (``csrc/rel_attention_mma.cu``;
    the card checks the kernels' own byte counts): the forward and the dq,
    dk/dv and dpos passes. The head is padded to a multiple of 16 in shared
    memory and rows to Dp + 8; none depends on T, S or R."""
    ld = -(-d // 16) * 16 + _RB_PAD
    fwd = 2 * (2 * _RB_BLOCK + 4 * _RB_KT + 2 * _RB_WIN) * ld + 4 * 4 * 16 * _RB_BLD
    smem = dict(fwd=fwd, dq=fwd + 2 * _RB_BLOCK * ld + 4 * _RB_BLOCK, dkv=2 * (6 * _RB_QT * (_RB_KT + _RB_PAD) + 4 * _RB_QT * ld),
                dpos=2 * (_RB_QT * (_RB_KT + _RB_PAD) + _RB_QT * ld))
    return {name: dict(smem_bytes=b, blocks_per_sm=min(_SM_SHARED // (b + _BLOCK_RESERVED), 2048 // _RB_THREADS)) for name, b in smem.items()}


def _shift_extra(t: int, s: int, r: int, pe_causal: bool) -> int:
    extra = (r - s) if pe_causal else (r - t + 1 - s)
    if extra < 0:
        raise ValueError(f"relpe of length {r} is too short for T={t}, S={s} (pe_causal={pe_causal})")
    return extra


def _heads(bh: int, kv_bias, q_len) -> int:
    b = kv_bias.shape[0] if kv_bias is not None else (q_len.shape[0] if q_len is not None else bh)
    if bh % max(1, b):
        raise ValueError(f"B·H={bh} is not a multiple of the batch {b}")
    return max(1, bh // max(1, b))


def dropout_mask(seed: int, bh: int, t: int, s: int, rate: float, device=None) -> torch.Tensor:
    """[BH, T, S] keep factors: row/column hash under ``seed + b·h·40499``."""
    seeds = (int(seed) + torch.arange(bh, dtype=torch.int64, device=device) * dr.SALT_BH)[:, None, None]
    rows = torch.arange(t, dtype=torch.int64, device=device)[None, :, None]
    cols = torch.arange(s, dtype=torch.int64, device=device)[None, None, :]
    return dr.keep_mask(seeds, rows, cols, rate)


def _scores(qc, qp, k, pos, kv_bias, q_len, causal, chunk_size, history_size, pe_causal):
    """f32 scores [BH, T, S] (attention_kernel._rel_scores) and the relative
    index map (idx [T, S], the positional column row i reads at key s)."""
    bh, t, _ = qc.shape
    s, r = k.shape[1], pos.shape[1]
    extra = _shift_extra(t, s, r, pe_causal)
    heads = _heads(bh, kv_bias, q_len)
    dev = qc.device
    f32 = torch.float32
    scores = torch.matmul(qc.to(f32), k.to(f32).transpose(1, 2))  # [BH, T, S]
    w = torch.matmul(qp.to(f32), pos.to(f32).transpose(1, 2))  # [BH, T, R]
    rows = torch.arange(t, device=dev)[:, None]
    cols = torch.arange(s, device=dev)[None, :]
    idx = cols + (t - 1 - rows) + extra  # [T, S]
    rel = torch.gather(w, 2, idx.clamp(max=r - 1).expand(bh, t, s))
    scores = scores + torch.where(idx < r, rel, torch.zeros((), dtype=f32, device=dev))

    qvalid = None
    if q_len is not None:
        qvalid = rows[None] < q_len.to(dev).repeat_interleave(heads)[:, None, None]  # [BH, T, 1]
    add = None
    if kv_bias is not None:
        add = kv_bias.to(f32).repeat_interleave(heads, dim=0)  # [BH, 1, S]
    if causal or (chunk_size is not None and history_size is not None):
        frame = cols - (s - t)
        allowed = torch.ones((t, s), dtype=torch.bool, device=dev)
        if causal:
            allowed = frame <= rows
        if chunk_size is not None and history_size is not None:
            hist = s if history_size < 0 else history_size
            start = (rows // chunk_size) * chunk_size
            allowed = allowed & (frame >= start - hist) & (frame < start + chunk_size)
        visb = torch.where(allowed, 0.0, -1e9).to(f32)
        add = visb if add is None else add + visb
    if add is not None:
        add = torch.clamp(add, min=-1e9).expand(bh, t, s)
        if qvalid is not None:
            add = torch.where(qvalid, add, torch.full((), -1e9, dtype=f32, device=dev))
        scores = scores + add
    elif qvalid is not None:
        scores = scores + torch.where(qvalid, 0.0, -1e9).to(f32)
    return scores, idx


def _softmax(scores):
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    return p / p.sum(dim=-1, keepdim=True)


def fused_rel_attention_plain(qc, qp, k, v, pos, kv_bias, q_len, seed=0, rate: float = 0.0, causal: bool = False, chunk_size=None, history_size=None, pe_causal: bool = False):
    """Plain PyTorch version of :func:`fused_rel_attention` (same arguments; differentiable by autograd)."""
    scores, _ = _scores(qc, qp, k, pos, kv_bias, q_len, causal, chunk_size, history_size, pe_causal)
    pn = _softmax(scores)
    if rate > 0.0:
        pn = pn * dropout_mask(seed, qc.shape[0], qc.shape[1], k.shape[1], rate, qc.device)
    out = torch.matmul(pn.to(v.dtype).float(), v.float())
    return out.to(qc.dtype)


def fused_rel_attention_plain_bwd(qc, qp, k, v, pos, kv_bias, q_len, dout, seed=0, rate: float = 0.0, causal: bool = False, chunk_size=None,
                                  history_size=None, pe_causal: bool = False):
    """Gradients (dqc, dqp, dk, dv, dpos) of :func:`fused_rel_attention` with
    the explicit formulas of the Pallas ``_rel_bwd_kernel``
    (attention_kernel.py:406-449), recomputing the forward; each returned in
    its input's dtype."""
    f32 = torch.float32
    bh, t, _ = qc.shape
    s, r = k.shape[1], pos.shape[1]
    scores, idx = _scores(qc, qp, k, pos, kv_bias, q_len, causal, chunk_size, history_size, pe_causal)
    pn = _softmax(scores)
    keep = dropout_mask(seed, bh, t, s, rate, qc.device) if rate > 0.0 else None
    pd = pn if keep is None else pn * keep
    do = dout.to(f32)
    dv = pd.transpose(1, 2) @ do
    dpn = do @ v.to(f32).transpose(1, 2)
    if keep is not None:
        dpn = dpn * keep
    o = (pd.to(v.dtype).to(f32) @ v.to(f32)).to(qc.dtype).to(f32)  # the forward's output, recomputed
    delta = (do * o).sum(dim=-1, keepdim=True)
    ds = pn * (dpn - delta)
    dsc = ds.to(qc.dtype).to(f32)  # every product reads ds rounded to the input type
    dqc = dsc @ k.to(f32)
    dk = dsc.transpose(1, 2) @ qc.to(f32)
    # rel term: dW[i, idx[i, s]] = ds[i, s] where idx < R (the reverse shift)
    in_r = idx < r
    dw = torch.zeros((bh, t, r), dtype=f32, device=qc.device)
    dw.scatter_add_(2, idx.clamp(max=r - 1).expand(bh, t, s), torch.where(in_r, dsc, torch.zeros((), dtype=f32, device=qc.device)))
    dqp = dw @ pos.to(f32)
    dpos = dw.transpose(1, 2) @ qp.to(f32)
    return dqc.to(qc.dtype), dqp.to(qp.dtype), dk.to(k.dtype), dv.to(v.dtype), dpos.to(pos.dtype)


def _check(qc, qp, k, v, pos, kv_bias, q_len, chunk_size, history_size, pe_causal):
    """Validate kernel inputs; returns the launch arguments shared by both kernels."""
    if qc.dim() != 3 or k.dim() != 3 or pos.dim() != 3:
        raise ValueError("qc/qp/k/v/pos must be [BH, ·, D]")
    bh, t, d = qc.shape
    s, r = k.shape[1], pos.shape[1]
    dev, dt = qc.device, qc.dtype
    code = _build.compute_dtype(qc, "qc")
    for name, x, shape in (("qc", qc, (bh, t, d)), ("qp", qp, (bh, t, d)), ("k", k, (bh, s, d)), ("v", v, (bh, s, d)), ("pos", pos, (bh, r, d))):
        _build.require(x, name, device=dev, dtype=dt, shape=shape)
    extra = _shift_extra(t, s, r, pe_causal)
    heads = _heads(bh, kv_bias, q_len)
    b = bh // heads
    if kv_bias is not None:
        _build.require(kv_bias, "kv_bias", device=dev, dtype=torch.float32, shape=(b, 1, s))
    if q_len is not None:
        _build.require(q_len, "q_len", device=dev, dtype=torch.int32, shape=(b,))
    if d > _REL_MAX_D:
        raise ValueError(f"head size {d} > {_REL_MAX_D} is not supported by the kernel")
    if not rel_supported(d, s, dt):
        raise ValueError(f"key length {s} needs {_rel_f32_smem(d, s)} bytes of shared memory (> {_MAX_SMEM})")
    has_chunk = chunk_size is not None and history_size is not None
    if has_chunk and chunk_size <= 0:
        raise ValueError("chunk_size must be positive")
    if s == 0 and bh * t > 0:
        raise ValueError("attention over zero keys")
    return (bh, heads, t, s, r, d, extra), has_chunk, code


def fused_rel_attention_kernel(qc, qp, k, v, pos, kv_bias, q_len, seed=0, rate: float = 0.0, causal: bool = False, chunk_size=None, history_size=None,
                               pe_causal: bool = False, with_stats: bool = False):
    """The forward kernel on CUDA tensors (no autograd): the output, and with
    ``with_stats`` (bf16 only) also the rows' softmax statistics [2, BH, T]
    f32 (max m, sum l), which the bf16 backward reads."""
    dims, has_chunk, code = _check(qc, qp, k, v, pos, kv_bias, q_len, chunk_size, history_size, pe_causal)
    if with_stats and qc.dtype != torch.bfloat16:
        raise ValueError("only the bf16 kernels return the row statistics (f32 recomputes them)")
    out = torch.empty_like(qc)
    stats = torch.empty((2, dims[0], dims[2]), dtype=torch.float32, device=qc.device) if with_stats else None
    if out.numel() > 0:
        lib = _build.build()
        with tracing.kernel("kernel.rel_attention.fwd", qc, qp, k, v, pos), torch.cuda.device(qc.device):
            err = lib.tfasr_rel_attention(
                qc.data_ptr(), qp.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(), _build.ptr(kv_bias), _build.ptr(q_len), out.data_ptr(),
                _build.ptr(stats), *dims, int(bool(causal)), int(has_chunk), int(chunk_size or 0), int(history_size if has_chunk else 0),
                *dr.kernel_args(seed, rate), code, _build.stream_of(qc),
            )
            _build.check(err, "fused_rel_attention")
    return (out, stats) if with_stats else out


def fused_rel_attention_bwd_kernel(qc, qp, k, v, pos, kv_bias, q_len, out, dout, seed=0, rate: float = 0.0, causal: bool = False, chunk_size=None,
                                   history_size=None, pe_causal: bool = False, stats=None):
    """The backward kernel on CUDA tensors: ``out`` is the forward's output
    and ``stats`` its row statistics (required for bf16; f32 recomputes
    them); same results as :func:`fused_rel_attention_plain_bwd`."""
    dims, has_chunk, code = _check(qc, qp, k, v, pos, kv_bias, q_len, chunk_size, history_size, pe_causal)
    for name, x in (("out", out), ("dout", dout)):
        _build.require(x, name, device=qc.device, dtype=qc.dtype, shape=tuple(qc.shape))
    bh, _, t, s, _, _, _ = dims
    bf16 = qc.dtype == torch.bfloat16
    if bf16:
        if stats is None:
            raise ValueError("the bf16 backward reads the forward's row statistics: pass stats from fused_rel_attention_kernel(..., with_stats=True)")
        _build.require(stats, "stats", device=qc.device, dtype=torch.float32, shape=(2, bh, t))
    elif stats is not None:
        raise ValueError("the f32 backward recomputes the row statistics: pass no stats")
    if qc.numel() == 0:
        return tuple(torch.zeros_like(x) for x in (qc, qp, k, v, pos))
    lib = _build.build()
    with tracing.kernel("kernel.rel_attention.bwd", qc, qp, k, v, pos), torch.cuda.device(qc.device):
        grads = [torch.zeros_like(x) for x in (qc, qp, k, v, pos)]
        if bf16:  # the tensor-core kernels: bf16 ds and pd (hi and lo planes) with rows padded to 8 columns
            sp = -(-s // 8) * 8
            ds, pd = (torch.empty((n, bh, t, sp), dtype=torch.bfloat16, device=qc.device) for n in (1, 2))
        else:
            ds = torch.empty((bh, t, s), dtype=qc.dtype, device=qc.device)
            pd = torch.empty((bh, t, s), dtype=torch.float32, device=qc.device)
        err = lib.tfasr_rel_attention_bwd(
            qc.data_ptr(), qp.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(), _build.ptr(kv_bias), _build.ptr(q_len), out.data_ptr(),
            dout.data_ptr(), _build.ptr(stats), ds.data_ptr(), pd.data_ptr(), *(g.data_ptr() for g in grads),
            *dims, int(bool(causal)), int(has_chunk), int(chunk_size or 0), int(history_size if has_chunk else 0),
            *dr.kernel_args(seed, rate), code, _build.stream_of(qc),
        )
        _build.check(err, "fused_rel_attention backward")
    return tuple(grads)


class _RelAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qc, qp, k, v, pos, kv_bias, q_len, seed, rate, causal, chunk_size, history_size, pe_causal):
        ctx.cfg = (seed, rate, causal, chunk_size, history_size, pe_causal)
        stats = None
        if qc.device.type == "cpu":
            out = fused_rel_attention_plain(qc, qp, k, v, pos, kv_bias, q_len, *ctx.cfg)
        elif qc.dtype == torch.bfloat16 and any(ctx.needs_input_grad[:5]):  # only the bf16 backward reads the statistics
            out, stats = fused_rel_attention_kernel(qc, qp, k, v, pos, kv_bias, q_len, *ctx.cfg, with_stats=True)
        else:
            out = fused_rel_attention_kernel(qc, qp, k, v, pos, kv_bias, q_len, *ctx.cfg)
        ctx.save_for_backward(qc, qp, k, v, pos, kv_bias, q_len, out, stats)
        return out

    @staticmethod
    def backward(ctx, dout):
        qc, qp, k, v, pos, kv_bias, q_len, out, stats = ctx.saved_tensors
        dout = dout.to(qc.dtype).contiguous()
        if qc.device.type == "cpu":
            grads = fused_rel_attention_plain_bwd(qc, qp, k, v, pos, kv_bias, q_len, dout, *ctx.cfg)
        else:
            grads = fused_rel_attention_bwd_kernel(qc, qp, k, v, pos, kv_bias, q_len, out, dout, *ctx.cfg, stats=stats)
        return (*grads,) + (None,) * 8


def fused_rel_attention(qc, qp, k, v, pos, kv_bias, q_len, seed=0, rate: float = 0.0, causal: bool = False, chunk_size=None, history_size=None,
                        pe_causal: bool = False):
    """Transformer-XL relative attention, fused (JAX argument order minus
    ``interpret``); differentiable in qc, qp, k, v and pos.

    qc/qp: [BH, T, D] content/positional queries (bias-added, scaled);
    k/v: [BH, S, D]; pos: [BH, R, D] projected relative PE (R = M+2T−1
    non-causal, M+T with ``pe_causal``); kv_bias: [B, 1, S] additive f32
    or None; q_len: int [B] query valid lengths (rows ≥ q_len[b] get −1e9
    on every column) or None; seed: int for the probability dropout, rate
    in [0, 1). Visibility (causal, chunk_size/history_size streaming) is
    rebuilt in-kernel. Returns [BH, T, D] in qc.dtype. A CUDA tensor
    launches the kernels (forward, and backward under autograd); a CPU
    tensor takes :func:`fused_rel_attention_plain` and
    :func:`fused_rel_attention_plain_bwd`. Under ``torch.export`` the call
    is the custom operator ``tfasr::fused_rel_attention``
    (``ops/cuda/library.py``), the forward only.
    """
    if torch.compiler.is_exporting():
        from tensorflowasr_tpu_torch.ops.cuda import library

        if not rel_supported(qc.shape[-1], k.shape[1], qc.dtype):
            raise ValueError(f"head size {qc.shape[-1]} over {k.shape[1]} keys in {qc.dtype} is not supported by the kernel")
        return library.fused_rel_attention(qc, qp, k, v, pos, kv_bias, q_len, int(seed), float(rate), bool(causal), chunk_size, history_size, bool(pe_causal))
    if qc.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no attention kernel for device {qc.device}")
    dr.keep_params(rate)
    return _RelAttention.apply(qc, qp, k, v, pos, kv_bias, q_len, int(seed), float(rate), bool(causal), chunk_size, history_size, bool(pe_causal))


# --------------------------------------------------------------------------- #
# Kernel A: softmax(q·kᵀ + bias)·v with an additive bias operand
#
# Replaces ``tensorflowasr_tpu/ops/pallas/attention_kernel.py:fused_attention``
# (``_fwd_kernel``, ``_bwd_kernel``), the vanilla multi-head attention of the
# Transformer encoders: scores accumulate in f32 and take the bias (read in
# its own dtype) in f32, a whole-row f32 softmax, the normalised
# probabilities dropped (the counter hash under ``seed + b·h·40499``, indexed
# by (row, column), so the masks equal JAX's bit for bit) and rounded to v's
# dtype before P·V. The backward recomputes the probabilities as the Pallas
# ``_bwd_kernel`` does: dv = pdᵀ·do with the f32 dropped probabilities,
# dpn = (do·vᵀ)·keep, delta = Σ do·out (from the saved output, which equals
# JAX's recomputation), ds = pn·(dpn − delta), dq and dk from ds rounded to
# the input dtype, and dbias = ds in f32 (summed over b·h for a broadcast
# bias) only when the bias needs a gradient.
#
# The forward also returns the rows' softmax statistics (max m and sum l,
# [2, BH, T] f32), which the bf16 backward reads instead of recomputing them.
#
# What bounds it on the card: at the Transformer-CTC training shape (b·h 64,
# T = S = 400, head 128) the products, 4·b·h·T·S·D operations forward and
# 10 backward. bf16 runs them on the tensor cores (``csrc/attention_mma.cu``:
# mma.sync, two forward sweeps so that the probabilities round where JAX's
# do, a three-launch backward with no score-shaped scratch); f32 keeps the
# CUDA-core kernels of ``csrc/attention.cu`` (TF32 would break the f32
# card/CPU parity).
# --------------------------------------------------------------------------- #

_FA_TQ, _FA_KT, _FA_MAX_D = 16, 64, 128  # csrc/attention.cu (the f32 kernels)


def _attention_probs(q, k, bias, seed, rate):
    """(pn, keep): the f32 softmax of q·kᵀ + bias [BH, T, S] and the dropout keep factors (None at rate 0)."""
    scores = torch.matmul(q.float(), k.float().transpose(1, 2)) + bias.float()
    pn = _softmax(scores)
    keep = dropout_mask(seed, q.shape[0], q.shape[1], k.shape[1], rate, q.device) if rate > 0.0 else None
    return pn, keep


def fused_attention_plain_stats(q, k, bias):
    """The rows' softmax statistics [2, BH, T] f32 that the kernel's forward
    returns: the max m and the sum l = Σ exp(s − m) of s = q·kᵀ + bias (JAX
    ``_softmax_rows``' m and l)."""
    scores = torch.matmul(q.float(), k.float().transpose(1, 2)) + bias.float()
    m = scores.amax(dim=-1)
    return torch.stack([m, torch.exp(scores - m[..., None]).sum(dim=-1)])


def fused_attention_plain(q, k, v, bias, seed=0, rate: float = 0.0):
    """Plain PyTorch version of :func:`fused_attention` (same arguments; differentiable by autograd)."""
    pn, keep = _attention_probs(q, k, bias, seed, rate)
    if keep is not None:
        pn = pn * keep
    return torch.matmul(pn.to(v.dtype).float(), v.float()).to(q.dtype)


def fused_attention_plain_bwd(q, k, v, bias, dout, seed=0, rate: float = 0.0, bias_grad: bool = True):
    """Gradients (dq, dk, dv, dbias) of :func:`fused_attention` with the
    explicit formulas of the Pallas ``_bwd_kernel`` (attention_kernel.py
    :118-160), recomputing the forward; dq, dk, dv in their inputs' dtypes,
    dbias (None unless ``bias_grad``) in the bias's shape and dtype."""
    f32 = torch.float32
    pn, keep = _attention_probs(q, k, bias, seed, rate)
    pd = pn if keep is None else pn * keep
    do = dout.to(f32)
    dv = pd.transpose(1, 2) @ do
    dpn = do @ v.to(f32).transpose(1, 2)
    if keep is not None:
        dpn = dpn * keep
    o = (pd.to(v.dtype).to(f32) @ v.to(f32)).to(q.dtype).to(f32)  # the forward's output, recomputed
    delta = (do * o).sum(dim=-1, keepdim=True)
    ds = pn * (dpn - delta)
    dq = ds.to(k.dtype).to(f32) @ k.to(f32)
    dk = ds.to(q.dtype).to(f32).transpose(1, 2) @ q.to(f32)
    dbias = None
    if bias_grad:
        dbias = (ds.sum(dim=0, keepdim=True) if bias.shape[0] == 1 else ds).to(bias.dtype)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias


def _attention_check(q, k, v, bias):
    """Validate kernel A's inputs; returns (bh, t, s, d, dtype code)."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3 or bias.dim() != 3:
        raise ValueError("q/k/v must be [BH, ·, D] and bias [BH|1, T, S]")
    bh, t, d = q.shape
    s = k.shape[1]
    dev = q.device
    code = _build.compute_dtype(q, "q") + 2 * _build.compute_dtype(bias, "bias")
    _build.require(k, "k", device=dev, dtype=q.dtype, shape=(bh, s, d))
    _build.require(v, "v", device=dev, dtype=q.dtype, shape=(bh, s, d))
    _build.require(q, "q", device=dev, dtype=q.dtype, shape=(bh, t, d))
    if bias.shape[0] not in (1, bh):
        raise ValueError(f"bias leading dimension {bias.shape[0]} must be 1 or B·H={bh}")
    _build.require(bias, "bias", device=dev, dtype=bias.dtype, shape=(bias.shape[0], t, s))
    if d > _FA_MAX_D:
        raise ValueError(f"head size {d} > {_FA_MAX_D} is not supported by the kernel")
    if not supported(d, s, q.dtype):
        raise ValueError(f"key length {s} needs {_attention_f32_smem(d, s)} bytes of shared memory (> {_MAX_SMEM})")
    if s == 0 and bh * t > 0:
        raise ValueError("attention over zero keys")
    return bh, t, s, d, code


def fused_attention_kernel(q, k, v, bias, seed=0, rate: float = 0.0, with_stats: bool = False):
    """Kernel A's forward on CUDA tensors (no autograd): the output, and with
    ``with_stats`` also the rows' statistics [2, BH, T] f32 (as
    :func:`fused_attention_plain_stats`), which the bf16 backward reads;
    without it the kernel computes no statistics."""
    bh, t, s, d, code = _attention_check(q, k, v, bias)
    out = torch.empty_like(q)
    stats = torch.empty((2, bh, t), dtype=torch.float32, device=q.device) if with_stats else None
    if out.numel() > 0:
        lib = _build.build()
        with tracing.kernel("kernel.attention.fwd", q, k, v, bias), torch.cuda.device(q.device):
            err = lib.tfasr_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(), _build.ptr(stats), bh, t, s, d,
                                      bias.shape[0], *dr.kernel_args(seed, rate), code, _build.stream_of(q))
            _build.check(err, "fused_attention")
    return (out, stats) if with_stats else out


def fused_attention_bwd_kernel(q, k, v, bias, out, dout, seed=0, rate: float = 0.0, bias_grad: bool = True, stats=None):
    """Kernel A's backward on CUDA tensors: ``out`` is the forward's output
    and ``stats`` its row statistics (required for bf16; f32 recomputes
    them); same results as :func:`fused_attention_plain_bwd`."""
    bh, t, s, d, code = _attention_check(q, k, v, bias)
    for name, x in (("out", out), ("dout", dout)):
        _build.require(x, name, device=q.device, dtype=q.dtype, shape=tuple(q.shape))
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        if stats is None:
            raise ValueError("the bf16 backward reads the forward's row statistics: pass stats from fused_attention_kernel(..., with_stats=True)")
        _build.require(stats, "stats", device=q.device, dtype=torch.float32, shape=(2, bh, t))
    if q.numel() == 0:
        dbias = torch.zeros((bh, t, s), dtype=torch.float32, device=q.device) if bias_grad else None
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v), None if dbias is None else dbias[:bias.shape[0]].to(bias.dtype)
    lib = _build.build()
    with tracing.kernel("kernel.attention.bwd", q, k, v, bias), torch.cuda.device(q.device):
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        dbias = torch.zeros((bh, t, s), dtype=torch.float32, device=q.device) if bias_grad else None
        if bf16:  # the tensor-core kernels: a [BH, T] delta, no score-shaped scratch
            delta, ds, pd = torch.empty((bh, t), dtype=torch.float32, device=q.device), None, None
        else:
            delta, ds = None, torch.empty((bh, t, s), dtype=q.dtype, device=q.device)
            pd = torch.empty((bh, t, s), dtype=torch.float32, device=q.device)
        err = lib.tfasr_attention_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(), dout.data_ptr(), _build.ptr(stats),
                                      _build.ptr(delta), _build.ptr(ds), _build.ptr(pd), _build.ptr(dbias), dq.data_ptr(), dk.data_ptr(),
                                      dv.data_ptr(), bh, t, s, d, bias.shape[0], *dr.kernel_args(seed, rate), code, _build.stream_of(q))
        _build.check(err, "fused_attention backward")
    if dbias is not None:
        dbias = (dbias.sum(dim=0, keepdim=True) if bias.shape[0] == 1 else dbias).to(bias.dtype)
    return dq, dk, dv, dbias


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, seed, rate):
        ctx.cfg = (seed, rate)
        if q.device.type == "cpu":
            out, stats = fused_attention_plain(q, k, v, bias, seed, rate), None
        else:
            # only the bf16 backward reads the statistics (f32 recomputes them)
            with_stats = q.dtype == torch.bfloat16 and any(ctx.needs_input_grad[:4])
            res = fused_attention_kernel(q, k, v, bias, seed, rate, with_stats=with_stats)
            out, stats = res if with_stats else (res, None)
        ctx.save_for_backward(q, k, v, bias, out, stats)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, out, stats = ctx.saved_tensors
        dout = dout.to(q.dtype).contiguous()
        bias_grad = ctx.needs_input_grad[3]
        if q.device.type == "cpu":
            grads = fused_attention_plain_bwd(q, k, v, bias, dout, *ctx.cfg, bias_grad=bias_grad)
        else:
            grads = fused_attention_bwd_kernel(q, k, v, bias, out, dout, *ctx.cfg, bias_grad=bias_grad, stats=stats)
        return (*grads, None, None)


def fused_attention(q, k, v, bias, seed=0, rate: float = 0.0):
    """softmax(q·kᵀ + bias)·v per leading b·h index (the JAX ``fused_attention``
    minus ``interpret``); differentiable in q, k, v and bias.

    q: [BH, T, D]; k/v: [BH, S, D] (D ≤ 128 on the card); bias: [BH|1, T, S]
    additive (a leading 1 broadcasts); seed: int for the probability
    dropout, rate in [0, 1). Returns [BH, T, D] in q.dtype. A CUDA tensor
    launches the kernels (forward, and backward under autograd) or raises
    on a shape they do not take; a CPU tensor takes
    :func:`fused_attention_plain` and :func:`fused_attention_plain_bwd`.
    Under ``torch.export`` the call is the custom operator
    ``tfasr::fused_attention`` (``ops/cuda/library.py``), the forward only.
    """
    if torch.compiler.is_exporting():
        from tensorflowasr_tpu_torch.ops.cuda import library

        if not supported(q.shape[-1], k.shape[1], q.dtype):
            raise ValueError(f"head size {q.shape[-1]} over {k.shape[1]} keys in {q.dtype} is not supported by the kernel")
        return library.fused_attention(q, k, v, bias, int(seed), float(rate))
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no attention kernel for device {q.device}")
    dr.keep_params(rate)
    return _Attention.apply(q, k, v, bias, int(seed), float(rate))
