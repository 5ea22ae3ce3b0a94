"""Fused relative-position attention kernel, forward (``csrc/rel_attention.cu``).

Replaces ``tensorflowasr_tpu/ops/pallas/attention_kernel.py:fused_rel_attention``
(kernel B) on the serving path: content scores ``qc·kᵀ``, the
Transformer-XL term ``qp·posᵀ`` read at its relative column, the Keras
−1e9 mask merge, f32 softmax and P·V.

What bounds it on the card: at the flagship (B·H=32, T=S=250, dh=36) the
products are ~0.3 GFLOP per call, far below the card's rate; the cost
is the score-shaped intermediates a plain version writes to device memory
(content scores, the [T, R] positional product, the shifted copy, masks,
the f32 softmax — ~10 passes of B·H·T·S floats). The kernel keeps them all
in shared memory: one block per (b·h, 16 query rows) stages key tiles and
exactly the window of relative positions those rows read, so the rel
shift is index arithmetic (no [T, R] product, no barrel shift as on the
TPU), and the row's scores stay resident for a two-pass softmax whose
normalised probabilities are rounded to v's type before P·V as in the
reference. Only q/k/v/pos are read and the context written.

Dropout (``rate > 0``) is a training feature and arrives with the backward
kernel; this forward raises on it.
"""

from __future__ import annotations

import torch

from tensorflowasr_tpu_torch.ops.cuda import _build

launches = 0  # kernel launches since the last reset (set to 0 to reset)

NEG_PAD = -1e30
_TQ, _KT, _OUT_PER_THREAD, _THREADS = 16, 64, 4, 256  # csrc/rel_attention.cu
_MAX_SMEM = 227 * 1024


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


def _check_rate(rate: float) -> None:
    if rate > 0.0:
        raise ValueError("attention dropout (rate > 0) is a training feature; the forward kernel takes rate == 0")


def fused_rel_attention_plain(qc, qp, k, v, pos, kv_bias, q_len, seed=0, rate: float = 0.0, causal: bool = False, chunk_size=None, history_size=None, pe_causal: bool = False):
    """Plain PyTorch version of :func:`fused_rel_attention` (same arguments)."""
    _check_rate(rate)
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

    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    pn = p / p.sum(dim=-1, keepdim=True)
    out = torch.matmul(pn.to(v.dtype).to(f32), v.to(f32))
    return out.to(qc.dtype)


def fused_rel_attention(qc, qp, k, v, pos, kv_bias, q_len, seed=0, rate: float = 0.0, causal: bool = False, chunk_size=None, history_size=None, pe_causal: bool = False):
    """Transformer-XL relative attention, fused (JAX argument order minus
    ``interpret``).

    qc/qp: [BH, T, D] content/positional queries (bias-added, scaled);
    k/v: [BH, S, D]; pos: [BH, R, D] projected relative PE (R = M+2T−1
    non-causal, M+T with ``pe_causal``); kv_bias: [B, 1, S] additive f32
    or None; q_len: int [B] query valid lengths (rows ≥ q_len[b] get −1e9
    on every column) or None; seed: unused at rate 0. Visibility (causal,
    chunk_size/history_size streaming) is rebuilt in-kernel. Returns
    [BH, T, D] in qc.dtype. A CUDA tensor launches the kernel; a CPU tensor
    takes :func:`fused_rel_attention_plain`.
    """
    global launches
    _check_rate(rate)
    if qc.device.type == "cpu":
        return fused_rel_attention_plain(qc, qp, k, v, pos, kv_bias, q_len, seed, rate, causal, chunk_size, history_size, pe_causal)
    if qc.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {qc.device}")
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
    if _TQ * d > _THREADS * _OUT_PER_THREAD:
        raise ValueError(f"head size {d} > {_THREADS * _OUT_PER_THREAD // _TQ} is not supported by the kernel")
    sp = -(-s // _KT) * _KT
    smem = 4 * (2 * _TQ * d + _KT * (d + 1) + (_KT + _TQ - 1) * (d + 1) + _TQ * sp)
    if smem > _MAX_SMEM:
        raise ValueError(f"key length {s} needs {smem} bytes of shared memory (> {_MAX_SMEM})")
    has_chunk = chunk_size is not None and history_size is not None
    if has_chunk and chunk_size <= 0:
        raise ValueError("chunk_size must be positive")
    out = torch.empty((bh, t, d), dtype=dt, device=dev)
    if bh == 0 or t == 0:
        return out
    if s == 0:
        raise ValueError("attention over zero keys")
    lib = _build.build()
    with torch.cuda.device(dev):
        err = lib.tfasr_rel_attention(
            qc.data_ptr(), qp.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(), _build.ptr(kv_bias), _build.ptr(q_len), out.data_ptr(),
            bh, heads, t, s, r, d, extra, int(bool(causal)), int(has_chunk), int(chunk_size or 0), int(history_size if has_chunk else 0),
            code, _build.stream_of(qc),
        )
    _build.check(err, "fused_rel_attention")
    launches += 1
    return out
