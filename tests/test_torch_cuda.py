"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card and skips without one. The module
imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: f32 with TF32 off differs from the plain version only in
summation order (1e-4 absolute on unit-scale outputs); bf16 may flip one
rounding of an operand or output (2^-8 relative), so 2e-2; the log-mel
frontend compares a direct DFT with an FFT in f32, 1e-3 in log. The RNN-T
DP (f32 only) chains T+U log-add-exps: its loss to 1e-5 relative, its
gradients (occupancies in [−1, 0]) to 1e-5 absolute.
"""

import copy

import numpy as np
import pytest
import torch

from tensorflowasr_tpu_torch import schemas
from tensorflowasr_tpu_torch.models.transducer.base import recognize
from tensorflowasr_tpu_torch.models.transducer.conformer import Conformer, conformer_small_config
from tensorflowasr_tpu_torch.ops import frontend
from tensorflowasr_tpu_torch.ops.cuda import attention_kernel as ak
from tensorflowasr_tpu_torch.ops.cuda import conv_kernel as ck
from tensorflowasr_tpu_torch.ops.cuda import ff_kernel as fk
from tensorflowasr_tpu_torch.ops.cuda import frontend_kernel as fek
from tensorflowasr_tpu_torch.ops.cuda import joint_loss_kernel as jk
from tensorflowasr_tpu_torch.ops.cuda import rnnt_kernel as rk
from tensorflowasr_tpu_torch.ops.rnnt_loss import LOG_0, rnnt_loss_from_logprobs_plain

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4), torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _gen(dev, seed=0):
    return torch.Generator(device=dev).manual_seed(seed)


def _r(gen, dev, shape, scale=1.0, dtype=torch.float32):
    return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)


@pytest.mark.parametrize("shape", [(8, 160000), (1, 16123), (3, 400), (2, 100)])
def test_frontend_kernel(dev, shape):
    cfg = frontend.FrontendConfig()
    sig = _r(_gen(dev), dev, shape, 0.3)
    before = fek.launches
    got = fek.log_mel_spectrogram_pallas(sig, cfg)
    assert fek.launches == before + 1
    torch.testing.assert_close(got, fek.log_mel_spectrogram_plain(sig, cfg), rtol=0, atol=1e-3)


# (B, H, T, S, R, d, kv_bias, q_len, causal, chunk, history, pe_causal)
ATT_CASES = {
    "flagship": (8, 4, 250, 250, 499, 36, False, True, False, None, None, False),
    "kv_bias_causal": (2, 4, 70, 70, 139, 36, True, True, True, None, None, False),
    "chunked_memory": (2, 4, 50, 66, 115, 36, True, True, False, 16, 16, False),
    "extra_shift": (2, 2, 33, 33, 80, 8, False, True, False, None, None, False),
    "causal_pe": (2, 2, 33, 33, 33, 16, False, False, True, None, None, True),
    "no_masks": (1, 4, 17, 17, 33, 64, False, False, False, None, None, False),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(ATT_CASES))
def test_rel_attention_kernel(dev, case, dtype):
    b, h, t, s, r, d, with_kvb, with_qlen, causal, chunk, hist, pe_causal = ATT_CASES[case]
    g = _gen(dev, 1)
    qc, qp = _r(g, dev, (b * h, t, d), 0.3, dtype), _r(g, dev, (b * h, t, d), 0.3, dtype)
    k, v, pos = _r(g, dev, (b * h, s, d), 1.0, dtype), _r(g, dev, (b * h, s, d), 1.0, dtype), _r(g, dev, (b * h, r, d), 1.0, dtype)
    kvb = None
    if with_kvb:
        valid = torch.arange(s, device=dev)[None, :] >= torch.arange(b, device=dev)[:, None] * 7
        kvb = torch.where(valid, 0.0, -1e9).float()[:, None, :].contiguous()
    q_len = torch.tensor([t - 9 * i for i in range(b)], dtype=torch.int32, device=dev) if with_qlen else None
    args = (qc, qp, k, v, pos, kvb, q_len, 0, 0.0, causal, chunk, hist, pe_causal)
    before = ak.launches
    got = ak.fused_rel_attention(*args)
    assert ak.launches == before + 1
    torch.testing.assert_close(got, ak.fused_rel_attention_plain(*args), **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
# bf16 takes the tensor cores iff 16 | D and 8 | F (and aligned weights): (5, 144, 104) does with a
# partial F chunk, (5, 144, 100) and (9, 24, 40) take the CUDA-core kernel
@pytest.mark.parametrize("n,d,f", [(2000, 144, 576), (37, 16, 64), (5, 144, 104), (5, 144, 100), (9, 24, 40)])
def test_ff_kernel(dev, dtype, n, d, f):
    g = _gen(dev, 2)
    args = (_r(g, dev, (n, d), 1.0, dtype), 1.0 + _r(g, dev, (d,), 0.1), _r(g, dev, (d,), 0.1), _r(g, dev, (d, f), d ** -0.5, dtype),
            _r(g, dev, (f,), 0.1, dtype), _r(g, dev, (f, d), f ** -0.5, dtype), _r(g, dev, (d,), 0.1, dtype), 0, 0.0, 0.5, 1e-3)
    torch.testing.assert_close(fk.fused_ff(*args), fk.fused_ff_plain(*args), **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,t,d", [(8, 250, 144), (3, 17, 16), (1, 5, 100)])
def test_conv_kernels(dev, dtype, b, t, d):
    g = _gen(dev, 3)
    x = _r(g, dev, (b, t, d), 1.0, dtype)
    front = (x, 1.0 + _r(g, dev, (d,), 0.1), _r(g, dev, (d,), 0.1), _r(g, dev, (d, d), d ** -0.5, dtype), _r(g, dev, (d,), 0.1, dtype),
             _r(g, dev, (d, d), d ** -0.5, dtype), _r(g, dev, (d,), 0.1, dtype))
    torch.testing.assert_close(ck.conv_front(*front), ck.conv_front_plain(*front), **TOL[dtype])
    back = (x, _r(g, dev, (b, t, d), 1.0, dtype), _r(g, dev, (d,), 0.1), 1.0 + torch.rand((d,), generator=g, device=dev),
            1.0 + _r(g, dev, (d,), 0.1), _r(g, dev, (d,), 0.1), _r(g, dev, (d, d), d ** -0.5, dtype), _r(g, dev, (d,), 0.1, dtype), 0, 0.0, 1.0)
    torch.testing.assert_close(ck.conv_back(*back), ck.conv_back_plain(*back), **TOL[dtype])


def _grads_close(got, ref, rel: float, what: str) -> None:
    """Each gradient within ``rel`` of its largest reference magnitude: the
    weight gradients are sums over all rows, where an elementwise relative
    bound would fail on the elements that cancel to ~0."""
    for i, (g, r) in enumerate(zip(got, ref)):
        g, r = g.float(), r.float()
        assert torch.isfinite(g).all(), f"{what} grad {i}: non-finite"
        err, scale = (g - r).abs().max().item(), r.abs().max().item()
        assert err <= rel * max(scale, 1e-6), f"{what} grad {i}: max abs err {err} > {rel} x {scale}"


# backward: f32 differs from the plain version in summation order only; bf16
# rounds ds/dh/dz operands at the same places, so a summation-order flip of
# one bf16 rounding (2^-8) propagates into the sums
GRAD_REL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


def _ff_args(dev, dtype, n, d, f, seed=2):
    g = _gen(dev, seed)
    return (_r(g, dev, (n, d), 1.0, dtype), 1.0 + _r(g, dev, (d,), 0.1), _r(g, dev, (d,), 0.1), _r(g, dev, (d, f), d ** -0.5, dtype),
            _r(g, dev, (f,), 0.1, dtype), _r(g, dev, (f, d), f ** -0.5, dtype), _r(g, dev, (d,), 0.1, dtype)), _r(g, dev, (n, d), 1.0, dtype)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,d,f", [(6400, 144, 576), (37, 16, 64), (5, 144, 100)])
def test_ff_backward_kernel(dev, dtype, n, d, f, rate):
    args, dout = _ff_args(dev, dtype, n, d, f)
    torch.testing.assert_close(fk.fused_ff(*args, 77, rate), fk.fused_ff_plain(*args, 77, rate), **TOL[dtype])
    before = fk.bwd_launches
    got = fk.fused_ff_bwd_kernel(*args[:6], dout, 77, rate)
    assert fk.bwd_launches == before + 1
    _grads_close(got, fk.fused_ff_plain_bwd(*args[:6], dout, 77, rate), GRAD_REL[dtype], f"ff {n}x{d}x{f}")


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,t,d", [(16, 400, 144), (3, 17, 16), (1, 5, 100)])
def test_conv_backward_kernels(dev, dtype, b, t, d, rate):
    g = _gen(dev, 5)
    x, dout = _r(g, dev, (b, t, d), 1.0, dtype), _r(g, dev, (b, t, d), 1.0, dtype)
    front = (x, 1.0 + _r(g, dev, (d,), 0.1), _r(g, dev, (d,), 0.1), _r(g, dev, (d, d), d ** -0.5, dtype), _r(g, dev, (d,), 0.1, dtype),
             _r(g, dev, (d, d), d ** -0.5, dtype), _r(g, dev, (d,), 0.1, dtype))
    before = ck.front_bwd_launches
    got = ck.conv_front_bwd_kernel(*front, dout)
    assert ck.front_bwd_launches == before + 1
    _grads_close(got, ck.conv_front_plain_bwd(*front, dout), GRAD_REL[dtype], "conv_front")
    back = (_r(g, dev, (b, t, d), 1.0, dtype), _r(g, dev, (d,), 0.1), 1.0 + torch.rand((d,), generator=g, device=dev),
            1.0 + _r(g, dev, (d,), 0.1), _r(g, dev, (d,), 0.1), _r(g, dev, (d, d), d ** -0.5, dtype))
    b2 = _r(g, dev, (d,), 0.1, dtype)
    torch.testing.assert_close(ck.conv_back(x, *back, b2, 9, rate), ck.conv_back_plain(x, *back, b2, 9, rate), **TOL[dtype])
    before = ck.back_bwd_launches
    got = ck.conv_back_bwd_kernel(*back, dout, 9, rate)
    assert ck.back_bwd_launches == before + 1
    _grads_close(got, ck.conv_back_plain_bwd(*back, dout, 9, rate), GRAD_REL[dtype], "conv_back")


ATT_BWD_CASES = {
    "flagship_train": (16, 4, 400, 400, 799, 36, False, True, False, None, None, False),
    "kv_bias_causal": ATT_CASES["kv_bias_causal"],
    "chunked_memory": ATT_CASES["chunked_memory"],
    "extra_shift": ATT_CASES["extra_shift"],
    "causal_pe": ATT_CASES["causal_pe"],
}


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(ATT_BWD_CASES))
def test_rel_attention_backward_kernel(dev, case, dtype, rate):
    b, h, t, s, r, d, with_kvb, with_qlen, causal, chunk, hist, pe_causal = ATT_BWD_CASES[case]
    g = _gen(dev, 6)
    qc, qp = _r(g, dev, (b * h, t, d), 0.3, dtype), _r(g, dev, (b * h, t, d), 0.3, dtype)
    k, v, pos = _r(g, dev, (b * h, s, d), 1.0, dtype), _r(g, dev, (b * h, s, d), 1.0, dtype), _r(g, dev, (b * h, r, d), 1.0, dtype)
    dout = _r(g, dev, (b * h, t, d), 1.0, dtype)
    kvb = None
    if with_kvb:
        valid = torch.arange(s, device=dev)[None, :] >= torch.arange(b, device=dev)[:, None] * 7
        kvb = torch.where(valid, 0.0, -1e9).float()[:, None, :].contiguous()
    q_len = torch.tensor([max(1, t - 17 * i) for i in range(b)], dtype=torch.int32, device=dev) if with_qlen else None
    inputs, cfg = (qc, qp, k, v, pos, kvb, q_len), (123, rate, causal, chunk, hist, pe_causal)
    out = ak.fused_rel_attention_kernel(*inputs, *cfg)
    torch.testing.assert_close(out, ak.fused_rel_attention_plain(*inputs, *cfg), **TOL[dtype])
    before = ak.bwd_launches
    got = ak.fused_rel_attention_bwd_kernel(*inputs, out, dout, *cfg)
    assert ak.bwd_launches == before + 1
    _grads_close(got, ak.fused_rel_attention_plain_bwd(*inputs, dout, *cfg), GRAD_REL[dtype], f"attention {case}")


def test_autograd_routes_cuda_tensors_through_the_kernels(dev):
    """Under autograd a CUDA tensor launches the forward and the backward kernel once each."""
    args, dout = _ff_args(dev, torch.float32, 40, 16, 64)
    leaves = [a.clone().requires_grad_(True) for a in args]
    f0, b0 = fk.launches, fk.bwd_launches
    fk.fused_ff(*leaves, 3, 0.1).backward(dout)
    assert (fk.launches, fk.bwd_launches) == (f0 + 1, b0 + 1)
    _grads_close([x.grad for x in leaves[:6]], fk.fused_ff_plain_bwd(*args[:6], dout, 3, 0.1), GRAD_REL[torch.float32], "ff autograd")


def test_ff_kernel_misaligned_weights(dev):
    """Weights that are contiguous but not 16-byte aligned take the CUDA-core kernel."""
    g = _gen(dev, 4)
    d, f, bf16 = 144, 576, torch.bfloat16
    w1 = _r(g, dev, (d * f + 1,), d ** -0.5, bf16)[1:].view(d, f)
    w2 = _r(g, dev, (f * d + 1,), f ** -0.5, bf16)[1:].view(f, d)
    args = (_r(g, dev, (40, d), 1.0, bf16), 1.0 + _r(g, dev, (d,), 0.1), _r(g, dev, (d,), 0.1), w1, _r(g, dev, (f,), 0.1, bf16), w2,
            _r(g, dev, (d,), 0.1, bf16))
    torch.testing.assert_close(fk.fused_ff(*args), fk.fused_ff_plain(*args), **TOL[bf16])


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.randn(4, 8, device=dev)
    v, w = torch.randn(8, device=dev), torch.randn(8, 16, device=dev)
    with pytest.raises(ValueError, match="dtype"):
        fk.fused_ff(x.half(), v, v, w.half(), torch.randn(16, device=dev).half(), w.t().contiguous().half(), v.half())
    with pytest.raises(ValueError, match="contiguous"):
        fk.fused_ff(x, v, v, torch.randn(16, 8, device=dev).t(), torch.randn(16, device=dev), w.t().contiguous(), v)
    q = torch.randn(2, 4, 72, device=dev)
    with pytest.raises(ValueError, match="head size"):
        ak.fused_rel_attention(q, q, q, q, torch.randn(2, 7, 72, device=dev), None, None)
    q = torch.randn(2, 4, 8, device=dev)
    with pytest.raises(ValueError, match="kv_bias"):
        ak.fused_rel_attention(q, q, q, q, torch.randn(2, 7, 8, device=dev), torch.zeros(2, 1, 5, device=dev), None)
    with pytest.raises(ValueError, match="on cpu"):
        ck.conv_front(q, v.cpu(), v, torch.randn(8, 8, device=dev), v, torch.randn(8, 8, device=dev), v)


def test_flagship_encoder_card_matches_cpu(dev):
    """f32, TF32 off: the encoder through the kernels equals the CPU copy
    through the plain versions, 2 blocks of the flagship widths."""
    model = Conformer.from_config(conformer_small_config(num_blocks=2), device="cpu")
    model.reset_parameters(torch.Generator().manual_seed(0))
    cpu_model = copy.deepcopy(model).eval()
    model = model.to(dev).eval()
    sig = torch.tensor((np.random.default_rng(0).standard_normal((2, 32000)) * 0.1).astype(np.float32))
    lens = torch.tensor([32000, 20000])
    with torch.inference_mode():
        enc, enc_len, _ = model.encode(sig.to(dev), lens.to(dev))
        ref, ref_len, _ = cpu_model.encode(sig, lens)
        out = recognize(model, schemas.PredictInput(sig.to(dev), lens.to(dev)))
    torch.testing.assert_close(enc.cpu(), ref, rtol=0, atol=1e-4)
    assert torch.equal(enc_len.cpu(), ref_len)
    assert tuple(out.tokens.shape) == (2, 2 * enc.shape[1] + 1)


# (B, T, U, J, V): the flagship training shapes, then ragged and odd sizes (U ≥ T, U = 0, J and V off the tiles)
LOSS_CASES = [(16, 400, 128, 320, 256), (3, 13, 6, 16, 20), (2, 37, 50, 40, 70), (1, 1, 0, 8, 5)]


def _lengths(dev, b, t, u, seed):
    g = torch.Generator().manual_seed(seed)
    t_len = torch.randint(1, t + 1, (b,), generator=g)
    u_len = torch.randint(0, u + 1, (b,), generator=g)
    t_len[0], u_len[0] = t, u
    return t_len.to(dev), u_len.to(dev)


@pytest.mark.parametrize("b,t,u,j,v", LOSS_CASES)
def test_rnnt_dp_kernel(dev, b, t, u, j, v):
    g = _gen(dev, 7)
    lp = torch.log_softmax(_r(g, dev, (b, t, u + 1, 3), 2.0), dim=-1)
    lpb, lpe = lp[..., 0].contiguous(), lp[..., 1].contiguous()
    lpe[..., u] = LOG_0
    t_len, u_len = _lengths(dev, b, t, u, 1)
    before = rk.launches
    loss, gbl, gem = rk.rnnt_dp_kernel(lpb, lpe, t_len, u_len)
    assert rk.launches == before + 1
    ref_loss, ref_gbl, ref_gem = rnnt_loss_from_logprobs_plain(lpb, lpe, t_len, u_len)
    torch.testing.assert_close(loss, ref_loss, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(gbl, ref_gbl, rtol=0, atol=1e-5)
    torch.testing.assert_close(gem, ref_gem, rtol=0, atol=1e-5)


def _joint_args(dev, dtype, b, t, u, j, v, seed=8):
    g = _gen(dev, seed)
    enc_p, pred_p = _r(g, dev, (b, t, j), 1.0, dtype), _r(g, dev, (b, u + 1, j), 1.0, dtype)
    wv, bv = _r(g, dev, (v, j), j ** -0.5, dtype), _r(g, dev, (v,), 0.1)
    labels = torch.randint(1, v, (b, u), generator=torch.Generator().manual_seed(seed)).to(dev)
    return enc_p, pred_p, wv, bv, labels


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,t,u,j,v", LOSS_CASES)
def test_joint_loss_kernels(dev, dtype, b, t, u, j, v):
    args = _joint_args(dev, dtype, b, t, u, j, v)
    before = jk.launches
    got = jk.joint_logprobs_kernel(*args)
    assert jk.launches == before + 1
    for name, x, r in zip(("lp_blank", "lp_emit", "lse"), got, jk.joint_logprobs_plain(*args)):
        torch.testing.assert_close(x, r, **TOL[dtype], msg=name)
    t_len, u_len = _lengths(dev, b, t, u, 2)
    _, lse, gbl, gem = jk.rnnt_loss_fused_joint_plain(*args[:4], t_len, args[4], u_len)
    scale = torch.linspace(0.5, 1.5, b, device=dev)[:, None, None]
    bargs = (*args, lse, (gbl * scale).contiguous(), (gem * scale).contiguous())
    before = jk.bwd_launches
    grads = jk.rnnt_loss_fused_joint_bwd_kernel(*bargs)
    assert jk.bwd_launches == before + 1
    _grads_close(grads, jk.rnnt_loss_fused_joint_plain_bwd(*bargs), GRAD_REL[dtype], f"joint {b}x{t}x{u + 1}x{j}x{v}")


def test_fused_joint_loss_autograd_runs_the_three_kernels(dev):
    """Under autograd a CUDA tensor launches the joint forward, the DP and the joint backward once each."""
    b, t, u, j, v = 3, 13, 6, 16, 20
    args = _joint_args(dev, torch.float32, b, t, u, j, v)
    t_len, u_len = _lengths(dev, b, t, u, 3)
    leaves = [a.clone().requires_grad_(True) for a in args[:4]]
    counts = (jk.launches, rk.launches, jk.bwd_launches)
    loss = jk.rnnt_loss_fused_joint(*leaves, t_len, args[4], u_len)
    loss.sum().backward()
    assert (jk.launches, rk.launches, jk.bwd_launches) == tuple(c + 1 for c in counts)
    ref_loss, lse, gbl, gem = jk.rnnt_loss_fused_joint_plain(*args[:4], t_len, args[4], u_len)
    torch.testing.assert_close(loss, ref_loss, rtol=1e-5, atol=1e-5)
    _grads_close([x.grad for x in leaves], jk.rnnt_loss_fused_joint_plain_bwd(*args, lse, gbl, gem), GRAD_REL[torch.float32], "fused joint autograd")
