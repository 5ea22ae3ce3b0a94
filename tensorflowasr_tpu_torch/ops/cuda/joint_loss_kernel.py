"""Fused transducer joint + RNN-T loss, forward and backward
(``csrc/joint_loss_mma.cu`` for bf16, ``csrc/joint_loss.cu`` for f32, with
the DP of ``csrc/rnnt_dp.cu``).

Replaces ``tensorflowasr_tpu/ops/pallas/joint_loss_kernel.py:rnnt_loss_fused_joint``
for the add/tanh joint with both prejoint linears: from the projected
encoder and prediction features, ``logits = tanh(enc_p[t] + pred_p[u])·Wvᵀ
+ bv`` is reduced, tile by tile, to lse, lp_blank and lp_emit per lattice
cell (``_joint_logprobs``); the DP turns those into the loss and its
gradients gbl/gem; the backward recomputes the logits and contracts
``d_logits`` at once into the four input gradients (``_joint_backward``).
The [B, T, U+1, V] logits never reach device memory.

The vocab weight ``wv`` is [V, J], the port's ``joint.vocab.weight`` (the
Pallas kernel's ``WvT``); its gradient comes back in the same layout.

What bounds it on the card: the products (forward 2·B·T·(U+1)·J·V =
1.35e11 operations at the flagship B 16, T 400, U+1 129, J 320, V 256;
backward 4.06e11), run on the tensor cores in bf16: ``mma.sync`` over
64-cell tiles of 8 frames × 8 label positions, the logits and dlog kept in
registers; the forward keeps Wv resident in a persistent grid where it fits
(V ≤ 256 at J 320), else streams it, as the backward does, in vocabulary
chunks; joint widths above 384 (to Conformer-L's 640) take their own
instantiations, whose rows pass holds one Wv chunk at a time. f32 inputs (the parity path) run the CUDA-core kernels of
``csrc/joint_loss.cu``. The forward saves lse, gbl and gem [B, T, U+1] f32
(9.9 MB) for the backward.

:func:`rnnt_loss_fused_joint_plain` and :func:`rnnt_loss_fused_joint_plain_bwd`
are the plain twins, with the JAX kernel's rounding points.
"""

from __future__ import annotations

import torch

from tensorflowasr_tpu_torch.ops.cuda import _build
from tensorflowasr_tpu_torch.ops.cuda import rnnt_kernel
from tensorflowasr_tpu_torch.ops.rnnt_loss import labels_per_cell, logits_to_logprobs_plain, rnnt_loss_from_logprobs_plain
from tensorflowasr_tpu_torch.utils import tracing

MAX_J = 640  # both routes: the shared-memory tiles hold [rows, J] (bf16 above 384: one Wv chunk in the rows pass); J a multiple of 8


def supported(j: int, dtype: torch.dtype) -> bool:
    """Whether the kernels (forward and backward) take joint width ``j`` in
    ``dtype``: f32 or bf16, J a multiple of 8 from 8 to 640 (any V, B, T,
    U+1; the loss's DP takes U+1 ≤ 1024, :func:`rnnt_kernel.supported`). A
    pure function of the shapes."""
    return dtype in (torch.float32, torch.bfloat16) and 8 <= j <= MAX_J and j % 8 == 0


def _activations(enc_p: torch.Tensor, pred_p: torch.Tensor) -> torch.Tensor:
    """a = tanh(enc_p[:, t] + pred_p[:, u]) [B, T, U+1, J] in the inputs' dtype
    (bf16 add and tanh round to bf16, as the Pallas kernel's do)."""
    return torch.tanh(enc_p[:, :, None, :] + pred_p[:, None, :, :])


def _logits(a: torch.Tensor, wv: torch.Tensor, bv: torch.Tensor) -> torch.Tensor:
    """a in wv's dtype times wvᵀ, accumulated in f32, plus f32 bv: [B, T, U+1, V] f32."""
    return torch.matmul(a.float(), wv.float().t()) + bv.float()


def joint_logits_plain(enc_p, pred_p, wv, bv):
    """The joint's logits [B, T, U+1, V] f32 with the kernel's rounding
    points (differentiable by autograd): the plain route where the kernel
    refuses the joint width, fed to the plain DP."""
    return _logits(_activations(enc_p, pred_p), wv, bv)


def joint_logprobs_plain(enc_p, pred_p, wv, bv, labels):
    """(lp_blank, lp_emit, lse) [B, T, U+1] f32 of the joint's logits; lp_emit is LOG_0 at u = U."""
    return logits_to_logprobs_plain(_logits(_activations(enc_p, pred_p), wv, bv), labels)


def rnnt_loss_fused_joint_plain(enc_p, pred_p, wv, bv, logit_length, labels, label_length):
    """Plain version of the forward: (loss [B], lse, gbl, gem [B, T, U+1]), f32."""
    lpb, lpe, lse = joint_logprobs_plain(enc_p, pred_p, wv, bv, labels)
    loss, gbl, gem = rnnt_loss_from_logprobs_plain(lpb, lpe, logit_length, label_length)
    return loss, lse, gbl, gem


def rnnt_loss_fused_joint_plain_bwd(enc_p, pred_p, wv, bv, labels, lse, gbl, gem):
    """Gradients (d_enc_p, d_pred_p, d_wv, d_bv) with the explicit formulas of
    the Pallas ``_bwd_kernel`` (joint_loss_kernel.py:173-228): recompute the
    tile, d_logits = 1[v=0]·gbl + 1[v=lab]·gem − softmax·(gbl+gem); dWv takes
    d_logits rounded to a's dtype; da = d_logits·Wv in f32; dz = da·(1−a²).
    gbl, gem are already scaled by the upstream cotangent. Each gradient in
    its input's dtype."""
    return _as_inputs(rnnt_loss_fused_joint_plain_bwd_f32(enc_p, pred_p, wv, bv, labels, lse, gbl, gem), enc_p, pred_p, wv, bv)


def _as_inputs(grads, enc_p, pred_p, wv, bv):
    return tuple(g.to(x.dtype) for g, x in zip(grads, (enc_p, pred_p, wv, bv)))


def rnnt_loss_fused_joint_plain_bwd_f32(enc_p, pred_p, wv, bv, labels, lse, gbl, gem):
    """:func:`rnnt_loss_fused_joint_plain_bwd` before the final casts: every gradient in f32."""
    a = _activations(enc_p, pred_p)
    logits = _logits(a, wv, bv)
    gsum = (gbl + gem)[..., None]
    v_idx = torch.arange(logits.shape[-1], device=logits.device)
    lab = labels_per_cell(labels, logits.shape[2])[:, None, :, None]
    zero = torch.zeros((), device=logits.device)
    dlog = (torch.where(v_idx == 0, gbl[..., None], zero) + torch.where(v_idx == lab, gem[..., None], zero)
            - torch.exp(logits - lse[..., None]) * gsum)
    rows, a_rows = dlog.reshape(-1, dlog.shape[-1]), a.reshape(-1, a.shape[-1])
    dwv = rows.to(a.dtype).float().t() @ a_rows.float()  # [V, J]
    dbv = rows.sum(0)
    a32 = a.float()
    dz = torch.matmul(dlog, wv.float()) * (1.0 - a32 * a32)
    return dz.sum(2), dz.sum(1), dwv, dbv


def _check(enc_p, pred_p, wv, bv, labels):
    if enc_p.dim() != 3 or pred_p.dim() != 3 or wv.dim() != 2:
        raise ValueError("enc_p must be [B, T, J], pred_p [B, U+1, J] and wv [V, J]")
    b, t, j = enc_p.shape
    u1, v = pred_p.shape[1], wv.shape[0]
    dev, dt = enc_p.device, enc_p.dtype
    code = _build.compute_dtype(enc_p, "enc_p")
    _build.require(enc_p, "enc_p", device=dev, dtype=dt, shape=(b, t, j))
    _build.require(pred_p, "pred_p", device=dev, dtype=dt, shape=(b, u1, j))
    _build.require(wv, "wv", device=dev, dtype=dt, shape=(v, j))
    _build.require(bv, "bv", device=dev, dtype=torch.float32, shape=(v,))
    if tuple(labels.shape) != (b, u1 - 1):
        raise ValueError(f"labels: shape {tuple(labels.shape)}, expected {(b, u1 - 1)} (pred_p must be U+1 rows)")
    if not supported(j, dt):
        raise ValueError(f"joint width {j}: the kernel takes a multiple of 8 up to {MAX_J}")
    for name, x in (("enc_p", enc_p), ("pred_p", pred_p), ("wv", wv)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel reads 16-byte vectors and needs a 16-byte aligned tensor")
    return b, t, u1, j, v, code


def joint_logprobs_kernel(enc_p, pred_p, wv, bv, labels):
    """The forward kernel on CUDA tensors: (lp_blank, lp_emit, lse) as :func:`joint_logprobs_plain`."""
    b, t, u1, j, v, code = _check(enc_p, pred_p, wv, bv, labels)
    f32 = dict(dtype=torch.float32, device=enc_p.device)
    lpb, lpe, lse = (torch.empty((b, t, u1), **f32) for _ in range(3))
    if b * t * u1 == 0:
        return lpb, lpe, lse
    lab = labels.to(torch.int32).contiguous()
    lib = _build.build()
    with tracing.kernel("kernel.joint_loss.fwd", enc_p, pred_p, wv), torch.cuda.device(enc_p.device):
        err = lib.tfasr_joint_fwd(enc_p.data_ptr(), pred_p.data_ptr(), wv.data_ptr(), bv.data_ptr(), lab.data_ptr(), lpb.data_ptr(), lpe.data_ptr(),
                                  lse.data_ptr(), b, t, u1, j, v, code, _build.stream_of(enc_p))
        _build.check(err, "joint_logprobs")
    return lpb, lpe, lse


def rnnt_loss_fused_joint_bwd_kernel(enc_p, pred_p, wv, bv, labels, lse, gbl, gem):
    """The backward kernel on CUDA tensors: same results as :func:`rnnt_loss_fused_joint_plain_bwd`."""
    return _as_inputs(rnnt_loss_fused_joint_bwd_kernel_f32(enc_p, pred_p, wv, bv, labels, lse, gbl, gem), enc_p, pred_p, wv, bv)


def rnnt_loss_fused_joint_bwd_kernel_f32(enc_p, pred_p, wv, bv, labels, lse, gbl, gem):
    """:func:`rnnt_loss_fused_joint_bwd_kernel` before the final casts: every gradient in f32."""
    b, t, u1, j, v, code = _check(enc_p, pred_p, wv, bv, labels)
    for name, x in (("lse", lse), ("gbl", gbl), ("gem", gem)):
        _build.require(x, name, device=enc_p.device, dtype=torch.float32, shape=(b, t, u1))
    launched = b * t * u1 > 0
    lib = _build.build() if launched else None
    with tracing.kernel("kernel.joint_loss.bwd", enc_p, pred_p, wv) if launched else tracing.NULL:
        f32 = dict(dtype=torch.float32, device=enc_p.device)
        denc, dpred = torch.zeros((b, t, j), **f32), torch.zeros((b, u1, j), **f32)
        dwv, dbv = torch.zeros((v, j), **f32), torch.zeros(v, **f32)
        if launched:
            lab = labels.to(torch.int32).contiguous()
            scratch = torch.empty(int(lib.tfasr_joint_bwd_scratch(b, t, u1, j, v, code)), **f32)
            with torch.cuda.device(enc_p.device):
                err = lib.tfasr_joint_bwd(enc_p.data_ptr(), pred_p.data_ptr(), wv.data_ptr(), bv.data_ptr(), lab.data_ptr(), lse.data_ptr(),
                                          gbl.data_ptr(), gem.data_ptr(), denc.data_ptr(), dpred.data_ptr(), dwv.data_ptr(), dbv.data_ptr(),
                                          scratch.data_ptr(), b, t, u1, j, v, code, _build.stream_of(enc_p))
            _build.check(err, "joint backward")
    return denc, dpred, dwv, dbv


class _FusedJointLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, enc_p, pred_p, wv, bv, logit_length, labels, label_length):
        if enc_p.device.type == "cpu":
            loss, lse, gbl, gem = rnnt_loss_fused_joint_plain(enc_p, pred_p, wv, bv, logit_length, labels, label_length)
        else:
            lpb, lpe, lse = joint_logprobs_kernel(enc_p, pred_p, wv, bv, labels)
            loss, gbl, gem = rnnt_kernel.rnnt_dp_kernel(lpb, lpe, logit_length, label_length)
        ctx.save_for_backward(enc_p, pred_p, wv, bv, labels, lse, gbl, gem)
        return loss

    @staticmethod
    def backward(ctx, g):
        enc_p, pred_p, wv, bv, labels, lse, gbl, gem = ctx.saved_tensors
        scale = g.float()[:, None, None]
        bwd = rnnt_loss_fused_joint_plain_bwd if enc_p.device.type == "cpu" else rnnt_loss_fused_joint_bwd_kernel
        return (*bwd(enc_p, pred_p, wv, bv, labels, lse, (gbl * scale).contiguous(), (gem * scale).contiguous()), None, None, None)


def rnnt_loss_fused_joint(enc_p, pred_p, wv, bv, logit_length, labels, label_length):
    """Per-row RNN-T loss [B] f32 of the add/tanh joint, JAX argument order
    minus ``blank`` (0) and ``interpret``; differentiable in enc_p, pred_p,
    wv and bv.

    enc_p: [B, T, J] and pred_p: [B, U+1, J] after the prejoint linears, and
    wv: [V, J] (the port's vocab weight), all in one dtype (f32 or bf16);
    bv: [V] f32; labels [B, U]; lengths [B] (1 ≤ T_b ≤ T, 0 ≤ U_b ≤ U). A
    CUDA tensor launches the kernels (joint statistics and DP forward,
    joint backward under autograd); a CPU tensor takes the plain versions."""
    if enc_p.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no fused joint+loss kernel for device {enc_p.device}")
    return _FusedJointLoss.apply(enc_p, pred_p, wv, bv, logit_length, labels, label_length)
