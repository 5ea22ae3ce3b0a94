"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card and skips without one. The module
imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: f32 with TF32 off differs from the plain version only in
summation order (1e-4 absolute on unit-scale outputs); bf16 may flip one
rounding of an operand or output (2^-8 relative), so 2e-2; the log-mel
frontend compares a direct DFT with an FFT in f32, 1e-3 in log. The RNN-T
DP (f32 only) chains T+U log-add-exps: its loss to 1e-5 relative, its
gradients (occupancies in [−1, 0]) to 1e-5 absolute. The log-probability
row kernel computes in f32 from the same inputs as its plain version in
either dtype: 1e-4. The LSTM kernels chain T steps; bf16 rounds y, the
cell sequence and the gates at the same places on both sides, so a
summation-order flip of one rounding carries into later steps: 2e-2
forward, 3e-2 of each gradient's scale backward. The CTC kernel (f32
only) chains 2·T log-sum-exps of three: its loss to 1e-5 relative, its
occupancies (in [−1, 0]) to 1e-5 absolute. Kernel A, like kernel B: 1e-4
/ 2e-2 forward, 1e-4 / 3e-2 of each gradient's scale backward.
"""

import copy

import numpy as np
import pytest
import torch

from tensorflowasr_tpu_torch import schemas
from tensorflowasr_tpu_torch.models.transducer.base import recognize
from tensorflowasr_tpu_torch.models.transducer.conformer import Conformer, conformer_small_config
from tensorflowasr_tpu_torch.ops import frontend
from tensorflowasr_tpu_torch.ops.cuda import _build
from tensorflowasr_tpu_torch.ops.cuda import attention_kernel as ak
from tensorflowasr_tpu_torch.ops.cuda import conv_kernel as ck
from tensorflowasr_tpu_torch.ops.cuda import ctc_kernel as ctk
from tensorflowasr_tpu_torch.ops.cuda import ff_kernel as fk
from tensorflowasr_tpu_torch.ops.cuda import frontend_kernel as fek
from tensorflowasr_tpu_torch.ops.cuda import joint_loss_kernel as jk
from tensorflowasr_tpu_torch.ops.cuda import lstm_kernel as lk
from tensorflowasr_tpu_torch.ops.cuda import rnnt_kernel as rk
from tensorflowasr_tpu_torch.models.ctc.conformer import ConformerCtc, conformer_ctc_small_config
from tensorflowasr_tpu_torch.models.ctc.transformer import TransformerCtc, transformer_ctc_base_config
from tensorflowasr_tpu_torch.ops.ctc_loss import ctc_occupancy_plain, ctc_prep
from tensorflowasr_tpu_torch.ops.rnnt_loss import LOG_0, dlogits_assemble_plain, logits_to_logprobs_plain, rnnt_loss_from_logprobs_plain

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
# bf16 always takes the tensor cores (csrc/ff_mma.cu): (5, 144, 104) with a partial F chunk, (5, 144, 100) and
# (9, 24, 40) with element staging and D or F padded in shared memory; (2000, 176, 704) at Conformer-CTC's width
@pytest.mark.parametrize("n,d,f", [(2000, 144, 576), (2000, 176, 704), (37, 16, 64), (5, 144, 104), (5, 144, 100), (9, 24, 40)])
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
@pytest.mark.parametrize("n,d,f", [(6400, 144, 576), (6400, 176, 704), (37, 16, 64), (5, 144, 100), (70, 40, 136)])
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
    "ctc_width_train": (16, 4, 400, 400, 799, 44, False, True, False, None, None, False),
    "streaming_memory": (8, 4, 250, 314, 563, 36, True, True, False, 16, 64, False),
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
    bf16 = dtype == torch.bfloat16
    out, stats = ak.fused_rel_attention_kernel(*inputs, *cfg, with_stats=True) if bf16 else (ak.fused_rel_attention_kernel(*inputs, *cfg), None)
    torch.testing.assert_close(out, ak.fused_rel_attention_plain(*inputs, *cfg), **TOL[dtype])
    before = ak.bwd_launches
    got = ak.fused_rel_attention_bwd_kernel(*inputs, out, dout, *cfg, stats=stats)
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
    """Weights that are contiguous but not 16-byte aligned: the bf16 kernels stage them element by element."""
    g = _gen(dev, 4)
    d, f, bf16 = 144, 576, torch.bfloat16
    w1 = _r(g, dev, (d * f + 1,), d ** -0.5, bf16)[1:].view(d, f)
    w2 = _r(g, dev, (f * d + 1,), f ** -0.5, bf16)[1:].view(f, d)
    args = (_r(g, dev, (40, d), 1.0, bf16), 1.0 + _r(g, dev, (d,), 0.1), _r(g, dev, (d,), 0.1), w1, _r(g, dev, (f,), 0.1, bf16), w2,
            _r(g, dev, (d,), 0.1, bf16))
    torch.testing.assert_close(fk.fused_ff(*args), fk.fused_ff_plain(*args), **TOL[bf16])
    dout = _r(g, dev, (40, d), 1.0, bf16)
    _grads_close(fk.fused_ff_bwd_kernel(*args[:6], dout), fk.fused_ff_plain_bwd(*args[:6], dout), GRAD_REL[bf16], "ff misaligned")


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("n,d,f", [(6400, 144, 576), (6400, 176, 704)])
def test_ff_bf16_backward_is_deterministic(dev, n, d, f, rate):
    """Two runs of the bf16 backward give the same bits: a fixed row split, partials summed in order, no atomics."""
    args, dout = _ff_args(dev, torch.bfloat16, n, d, f, seed=8)
    first = fk.fused_ff_bwd_kernel(*args[:6], dout, 5, rate)
    second = fk.fused_ff_bwd_kernel(*args[:6], dout, 5, rate)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("case", ["flagship_train", "streaming_memory"])
def test_rel_attention_bf16_backward_is_deterministic(dev, case, rate):
    b, h, t, s, r, d, with_kvb, _, causal, chunk, hist, pe_causal = ATT_BWD_CASES[case]
    g = _gen(dev, 9)
    bf16 = torch.bfloat16
    inputs = [_r(g, dev, (b * h, n, d), sc, bf16) for n, sc in ((t, 0.3), (t, 0.3), (s, 1.0), (s, 1.0), (r, 1.0))]
    kvb = torch.where(torch.arange(s, device=dev)[None, :] >= torch.arange(b, device=dev)[:, None] * 7, 0.0, -1e9).float()[:, None, :].contiguous() \
        if with_kvb else None
    q_len = torch.tensor([max(1, t - 17 * i) for i in range(b)], dtype=torch.int32, device=dev)
    cfg = (31, rate, causal, chunk, hist, pe_causal)
    out, stats = ak.fused_rel_attention_kernel(*inputs, kvb, q_len, *cfg, with_stats=True)
    dout = _r(g, dev, (b * h, t, d), 1.0, bf16)
    first = ak.fused_rel_attention_bwd_kernel(*inputs, kvb, q_len, out, dout, *cfg, stats=stats)
    second = ak.fused_rel_attention_bwd_kernel(*inputs, kvb, q_len, out, dout, *cfg, stats=stats)
    for x, y in zip(first, second):
        assert torch.equal(x, y)


@pytest.mark.parametrize("fwd_rows", fk.FWD_ROWS)
@pytest.mark.parametrize("d,f", [(144, 576), (176, 704), (40, 136), (256, 1024)])
def test_ff_mma_plan_matches_the_kernels(dev, d, f, fwd_rows):
    """The shared-memory plan of the bf16 FF kernels equals the kernels' own
    count (the forward at each row tile; rows 0 is the backward), and the
    card fits the planned blocks."""
    lib = _build.build()
    plan = fk.ff_mma_plan(d, f, fwd_rows)
    assert lib.tfasr_ff_mma_smem(d, fwd_rows) == plan.fwd_smem_bytes and lib.tfasr_ff_mma_smem(d, 0) == plan.bwd_smem_bytes
    for rows, want in ((fwd_rows, plan.fwd_blocks_per_sm), (0, plan.bwd_blocks_per_sm)):
        got = lib.tfasr_ff_mma_occupancy(d, rows)
        assert 1 <= got <= want, (rows, got, want)


@pytest.mark.parametrize("rows", fk.FWD_ROWS)
@pytest.mark.parametrize("n,d,f", [(2000, 144, 576), (6400, 176, 704), (37, 40, 136)])
def test_ff_bf16_forward_at_each_row_tile(dev, n, d, f, rows):
    """The bf16 forward at 64 and 32 rows a block equals the plain version (rate 0.1), the same bits on two runs."""
    args, _ = _ff_args(dev, torch.bfloat16, n, d, f, seed=12)
    got = fk.fused_ff_kernel(*args, 5, 0.1, rows=rows)
    torch.testing.assert_close(got, fk.fused_ff_plain(*args, 5, 0.1), **TOL[torch.bfloat16])
    assert torch.equal(got, fk.fused_ff_kernel(*args, 5, 0.1, rows=rows))


def test_mma_index_maps_match_the_plain_index(dev):
    """The library's own index maps of the tensor-core kernels: kernel B's
    window base plus band column reaches the plain relative index s + (T−1−i)
    + extra for every row and key (T not a multiple of 16, with and without a
    KV memory); its dpos row range holds exactly the rows that reach the
    block's positions; the FF weight-gradient split covers the rows once, in
    order, in whole 32-row stages."""
    import ctypes

    lib = _build.build()
    for t, s, r, pe_causal in ((70, 70, 139, False), (37, 57, 57, True), (37, 57, 93, False), (150, 150, 299, False)):
        extra = ak._shift_extra(t, s, r, pe_causal)
        for i0 in range(0, t, 64):
            for j in range(-(-s // 64)):
                base = lib.tfasr_rel_mma_window_base(j, i0, t, extra)
                for w in range(4):
                    for i in range(i0 + 16 * w, min(t, i0 + 16 * w + 16)):
                        for sk in range(j * 64, min(s, j * 64 + 64)):
                            col = lib.tfasr_rel_mma_band_column(sk - j * 64, i - i0 - 16 * w)
                            assert 0 <= col < 80 and base + (3 - w) * 16 + col == sk + (t - 1 - i) + extra, (t, i, sk)
        for p0 in range(0, r, 64):
            hi = ctypes.c_int()
            lo = lib.tfasr_rel_mma_dpos_rows(p0, t, s, extra, ctypes.byref(hi))
            reach = {i for i in range(t) for sk in range(s) if p0 <= sk + (t - 1 - i) + extra < p0 + 64}
            assert reach <= set(range(lo, hi.value)) and (not reach or (min(reach), max(reach) + 1) == (lo, hi.value)), (t, p0)
    for n, m, k in ((6400, 144, 576), (6400, 576, 144), (6400, 176, 704), (37, 16, 64), (300, 40, 136)):
        per = ctypes.c_int()
        splits = lib.tfasr_ff_mma_splits(n, m, k, ctypes.byref(per))
        assert splits >= 1 and per.value % 32 == 0 and (splits - 1) * per.value < n <= splits * per.value, (n, m, k)


@pytest.mark.parametrize("d", [36, 44, 64, 8])
def test_rel_mma_plan_matches_the_kernels(dev, d):
    lib = _build.build()
    plan = ak.rel_mma_plan(d)
    for which, name in enumerate(("fwd", "dq", "dkv", "dpos")):
        assert lib.tfasr_rel_mma_smem(d, which) == plan[name]["smem_bytes"], name
        assert 1 <= lib.tfasr_rel_mma_occupancy(d, which) <= plan[name]["blocks_per_sm"], name


def _conv_front_args(dev, dtype, b, t, d, seed=13):
    g = _gen(dev, seed)
    return (_r(g, dev, (b, t, d), 1.0, dtype), 1.0 + _r(g, dev, (d,), 0.1), _r(g, dev, (d,), 0.1), _r(g, dev, (d, d), d ** -0.5, dtype),
            _r(g, dev, (d,), 0.1, dtype), _r(g, dev, (d, d), d ** -0.5, dtype), _r(g, dev, (d,), 0.1, dtype)), _r(g, dev, (b, t, d), 1.0, dtype)


@pytest.mark.parametrize("b,t,d", [(8, 250, 144), (16, 400, 176), (3, 17, 256), (1, 5, 100)])
def test_conv_front_bf16_forward_at_each_row_tile(dev, b, t, d):
    """conv_front's bf16 forward (32 rows a block) equals the plain version, the same bits on two runs."""
    args, _ = _conv_front_args(dev, torch.bfloat16, b, t, d)
    got = ck.conv_front_kernel(*args)
    torch.testing.assert_close(got, ck.conv_front_plain(*args), **TOL[torch.bfloat16])
    assert torch.equal(got, ck.conv_front_kernel(*args))


@pytest.mark.parametrize("b,t,d", [(16, 400, 144), (16, 400, 176), (2, 33, 256)])
def test_conv_front_bf16_backward_is_deterministic(dev, b, t, d):
    """Two runs of conv_front's bf16 backward give the same bits (partials summed in a fixed order, no atomics), within GRAD_REL of the plain version."""
    args, dout = _conv_front_args(dev, torch.bfloat16, b, t, d, seed=14)
    first = ck.conv_front_bwd_kernel(*args, dout)
    for x, y in zip(first, ck.conv_front_bwd_kernel(*args, dout)):
        assert torch.equal(x, y)
    _grads_close(first, ck.conv_front_plain_bwd(*args, dout), GRAD_REL[torch.bfloat16], f"conv_front {d}")


@pytest.mark.parametrize("d", [144, 176, 256, 100, 16])
def test_conv_mma_plan_matches_the_kernels(dev, d):
    """The library's shared memory of conv_front's bf16 kernels (which 0: the
    forward, 1: the backward rows pass) equals the plan copied in
    tests/test_torch_joint_conv_mma.py, and the card fits the planned blocks."""
    from tests.test_torch_joint_conv_mma import _conv_plan

    lib = _build.build()
    plan = _conv_plan(d)
    for which, name in enumerate(("fwd", "bwd")):
        assert lib.tfasr_conv_mma_smem(d, which) == getattr(plan, f"{name}_smem_bytes"), name
        assert 1 <= lib.tfasr_conv_mma_occupancy(d, which) <= getattr(plan, f"{name}_blocks_per_sm"), name


@pytest.mark.parametrize("j", [320, 384, 40, 8])
def test_joint_mma_plan_and_layout_match_the_kernels(dev, j):
    """The library's shared memory of the joint's bf16 kernels equals the
    plan copied in tests/test_torch_joint_conv_mma.py and the card fits the
    planned blocks; the library's cell-tile map and weight split are 8
    frames x 8 label positions, ceil(T/8) x ceil((U+1)/8) tiles an
    utterance and about one weight block per SM (the copies there walk them)."""
    import ctypes

    from tests.test_torch_joint_conv_mma import _joint_plan

    lib = _build.build()
    plan = _joint_plan(j, 256)
    for which, name in enumerate(("fwd", "rows", "weight")):
        assert lib.tfasr_joint_mma_smem(j, which) == getattr(plan, f"{name}_smem_bytes"), name
        assert 1 <= lib.tfasr_joint_mma_occupancy(j, which) <= getattr(plan, f"{name}_blocks_per_sm"), name
    for v in (256, 1000, 100, 20):
        assert lib.tfasr_joint_mma_fwd_resident(j, v) == _joint_plan(j, v).fwd_resident_vocab, v
    if plan.fwd_resident_vocab == 256:
        assert lib.tfasr_joint_mma_smem(j, 3) == plan.fwd_resident_smem_bytes
        assert lib.tfasr_joint_mma_occupancy(j, 3) == 1
    for b, t, u1, v in ((16, 400, 129, 256), (16, 400, 129, 1000), (3, 13, 7, 20), (1, 1, 1, 5)):
        out = (ctypes.c_int * 5)()
        assert lib.tfasr_joint_mma_layout(b, t, u1, j, v, out) == 0
        tiles = b * -(-t // 8) * -(-u1 // 8)
        per_sm = 2 if -(-j // 16) <= 20 else 1  # the weight pass's blocks per SM
        assert list(out) == [8, 8, -(-t // 8), -(-u1 // 8), max(1, min(tiles, 132 * per_sm // -(-v // 64)))]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,t,u,j,v", [(4, 120, 48, 320, 1000), (2, 37, 50, 384, 300)])
def test_joint_loss_kernels_large_vocabulary(dev, dtype, b, t, u, j, v):
    """The fused joint at V 1000 (the small-streaming config's vocabulary; Wv
    640 KB streams through shared memory) and at J 384."""
    args = _joint_args(dev, dtype, b, t, u, j, v)
    for name, x, r in zip(("lp_blank", "lp_emit", "lse"), jk.joint_logprobs_kernel(*args), jk.joint_logprobs_plain(*args)):
        torch.testing.assert_close(x, r, **TOL[dtype], msg=name)
    t_len, u_len = _lengths(dev, b, t, u, 3)
    _, lse, gbl, gem = jk.rnnt_loss_fused_joint_plain(*args[:4], t_len, args[4], u_len)
    bargs = (*args, lse, gbl, gem)
    _grads_close(jk.rnnt_loss_fused_joint_bwd_kernel(*bargs), jk.rnnt_loss_fused_joint_plain_bwd(*bargs), GRAD_REL[dtype], f"joint V {v}")


@pytest.mark.parametrize("b,t,u,j,v", [(16, 400, 128, 320, 256), (4, 120, 48, 320, 1000)])
def test_joint_bf16_backward_is_deterministic(dev, b, t, u, j, v):
    """Two runs of the joint's bf16 backward give the same bits: fixed-order partials, no atomics."""
    args = _joint_args(dev, torch.bfloat16, b, t, u, j, v, seed=21)
    t_len, u_len = _lengths(dev, b, t, u, 4)
    _, lse, gbl, gem = jk.rnnt_loss_fused_joint_plain(*args[:4], t_len, args[4], u_len)
    first = jk.rnnt_loss_fused_joint_bwd_kernel(*args, lse, gbl, gem)
    for x, y in zip(first, jk.rnnt_loss_fused_joint_bwd_kernel(*args, lse, gbl, gem)):
        assert torch.equal(x, y)


def test_joint_and_conv_front_refuse_what_the_kernels_do_not_take(dev):
    with pytest.raises(ValueError, match="joint width"):
        jk.joint_logprobs_kernel(*_joint_args(dev, torch.bfloat16, 2, 5, 3, 392, 20))
    with pytest.raises(ValueError, match="model width"):
        ck.conv_front_kernel(*_conv_front_args(dev, torch.bfloat16, 1, 3, 264)[0])


def test_rel_attention_bf16_autograd_reads_the_forward_stats(dev):
    """Under autograd a bf16 CUDA tensor launches the forward (with statistics) and the backward kernel once each."""
    g = _gen(dev, 10)
    bf16 = torch.bfloat16
    inputs = [_r(g, dev, (8, n, 36), sc, bf16).requires_grad_(True) for n, sc in ((50, 0.3), (50, 0.3), (50, 1.0), (50, 1.0), (99, 1.0))]
    dout = _r(g, dev, (8, 50, 36), 1.0, bf16)
    f0, b0 = ak.launches, ak.bwd_launches
    ak.fused_rel_attention(*inputs, None, None, 4, 0.1).backward(dout)
    assert (ak.launches, ak.bwd_launches) == (f0 + 1, b0 + 1)
    ref = ak.fused_rel_attention_plain_bwd(*(x.detach() for x in inputs), None, None, dout, 4, 0.1)
    _grads_close([x.grad for x in inputs], ref, GRAD_REL[bf16], "rel attention bf16 autograd")


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
    with pytest.raises(ValueError, match="model width"):
        x, w = torch.randn(4, 272, device=dev, dtype=torch.bfloat16), torch.randn(272, 16, device=dev, dtype=torch.bfloat16)
        fk.fused_ff(x, torch.ones(272, device=dev), torch.zeros(272, device=dev), w, w[0], w.t().contiguous(), x[0])
    with pytest.raises(ValueError, match="row statistics"):
        ak.fused_rel_attention_kernel(q, q, q, q, torch.randn(2, 7, 8, device=dev), None, None, with_stats=True)
    with pytest.raises(ValueError, match="rows a block"):
        fk.fused_ff_kernel(torch.randn(4, 8, device=dev), torch.ones(8, device=dev), torch.zeros(8, device=dev), torch.randn(8, 16, device=dev), torch.randn(16, device=dev),
                           torch.randn(16, 8, device=dev), torch.randn(8, device=dev), rows=48)
    qb = q.bfloat16()
    with pytest.raises(ValueError, match="row statistics"):
        ak.fused_rel_attention_bwd_kernel(qb, qb, qb, qb, torch.randn(2, 7, 8, device=dev).bfloat16(), None, None, qb, qb)


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


# (B, T, U, V): V = 29 and 12 take the one-element loads in bf16 (29 also in f32), 256 the 16-byte ones; U = 0
ROW_CASES = [(2, 5, 3, 29), (3, 7, 4, 256), (2, 4, 3, 12), (1, 3, 0, 8)]


def _row_args(dev, dtype, b, t, u, v, seed=9):
    g = _gen(dev, seed)
    logits = _r(g, dev, (b, t, u + 1, v), 2.0, dtype)
    labels = torch.randint(0, v, (b, u), generator=torch.Generator().manual_seed(seed)).to(dev)
    return logits, labels


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,t,u,v", ROW_CASES)
def test_rnnt_row_kernels(dev, dtype, b, t, u, v):
    logits, labels = _row_args(dev, dtype, b, t, u, v)
    before = rk.logprobs_launches
    got = rk.logits_to_logprobs_kernel(logits, labels)
    assert rk.logprobs_launches == before + 1
    ref = logits_to_logprobs_plain(logits, labels)
    for name, x, r in zip(("lp_blank", "lp_emit", "lse"), got, ref):
        torch.testing.assert_close(x, r, **TOL[torch.float32], msg=name)
    t_len, u_len = _lengths(dev, b, t, u, 4)
    _, gbl, gem = rnnt_loss_from_logprobs_plain(*ref[:2], t_len, u_len)
    cot = torch.linspace(0.5, 1.5, b, device=dev)
    before = rk.dlogits_launches
    d = rk.dlogits_assemble_kernel(logits, ref[2], gbl, gem, labels, cot)
    assert rk.dlogits_launches == before + 1 and d.dtype == dtype
    torch.testing.assert_close(d, dlogits_assemble_plain(logits, ref[2], gbl, gem, labels, cot), **TOL[dtype])


def test_rnnt_loss_pallas_autograd_runs_the_three_kernels(dev):
    """Under autograd a CUDA tensor launches the log-probability kernel, the
    DP and the d_logits kernel once each, and equals the plain path on the CPU."""
    b, t, u, v = 3, 11, 5, 29
    logits, labels = _row_args(dev, torch.float32, b, t, u, v)
    t_len, u_len = _lengths(dev, b, t, u, 5)
    x = logits.clone().requires_grad_(True)
    counts = (rk.logprobs_launches, rk.launches, rk.dlogits_launches)
    loss = rk.rnnt_loss_pallas(x, t_len, labels, u_len)
    loss.sum().backward()
    assert (rk.logprobs_launches, rk.launches, rk.dlogits_launches) == tuple(c + 1 for c in counts)
    xc = logits.cpu().requires_grad_(True)
    ref = rk.rnnt_loss_pallas(xc, t_len.cpu(), labels.cpu(), u_len.cpu())
    ref.sum().backward()
    torch.testing.assert_close(loss.detach().cpu(), ref.detach(), rtol=1e-5, atol=1e-5)
    _grads_close([x.grad.cpu()], [xc.grad], GRAD_REL[torch.float32], "rnnt_loss_pallas autograd")


# (B, T, H): unaligned, the prediction net's flagship shape, a width that takes 8 units per block,
# and H = 20, whose bf16 rows (40 bytes) take the one-element staging loads
LSTM_CASES = [(3, 17, 24), (2, 33, 32), (16, 129, 320), (2, 9, 1000), (3, 11, 20)]


def _lstm_args(dev, dtype, b, t, h, seed=10):
    g = _gen(dev, seed)
    xg, wh = _r(g, dev, (b, t, 4 * h), 1.0, dtype), _r(g, dev, (h, 4 * h), h ** -0.5, dtype)
    h0, c0 = _r(g, dev, (b, h), 0.3, dtype), _r(g, dev, (b, h), 0.3, dtype)
    dy, dc = _r(g, dev, (b, t, h), 1.0, dtype), _r(g, dev, (b, t, h), 0.1, dtype)
    return (xg, wh, h0, c0), (dy, dc)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,t,h", LSTM_CASES)
def test_lstm_kernels(dev, dtype, b, t, h):
    (xg, wh, h0, c0), (dy, dc) = _lstm_args(dev, dtype, b, t, h)
    before = lk.launches
    got = lk.lstm_fwd_kernel(xg, wh, h0, c0)
    assert lk.launches == before + 1
    ref = lk.lstm_fwd_plain(xg, wh, h0, c0)
    for name, x, r in zip(("y", "cseq", "gates"), got, ref):
        assert x.dtype == dtype
        torch.testing.assert_close(x, r, **TOL[dtype], msg=name)
    _, cseq, gates = ref
    before = lk.bwd_launches
    grads = lk.lstm_bwd_kernel(gates, cseq, c0, wh, dy, dc)
    assert lk.bwd_launches == before + 1
    _grads_close(grads, lk.lstm_bwd_plain(gates, cseq, c0, wh, dy, dc), GRAD_REL[dtype], f"lstm {b}x{t}x{h}")


def test_lstm_layer_autograd_runs_the_kernels(dev):
    """Under autograd a CUDA tensor launches the LSTM forward and backward
    kernels once each; values and every gradient equal the CPU plain path
    (f32), lengths 0 and past-length zeros included."""
    b, t, e, h = 3, 13, 20, 24
    g = torch.Generator().manual_seed(11)
    params = [torch.randn(4 * h, e, generator=g) * e ** -0.5, torch.randn(4 * h, h, generator=g) * h ** -0.5, torch.randn(4 * h, generator=g) * 0.1]
    x, h0, c0 = torch.randn(b, t, e, generator=g), torch.randn(b, h, generator=g) * 0.3, torch.randn(b, h, generator=g) * 0.3
    lengths = torch.tensor([13, 0, 6])
    results = []
    for d in (dev, torch.device("cpu")):
        leaves = [a.to(d).requires_grad_(True) for a in (x, *params, h0, c0)]
        counts = (lk.launches, lk.bwd_launches)
        y, (c_t, h_t) = lk.lstm_layer_fused(*leaves, lengths.to(d))
        (y.square().sum() + (c_t * h_t).sum()).backward()
        if d.type == "cuda":
            assert (lk.launches, lk.bwd_launches) == (counts[0] + 1, counts[1] + 1)
        results.append([y.detach().cpu(), c_t.detach().cpu(), h_t.detach().cpu()] + [a.grad.cpu() for a in leaves])
    for got, ref in zip(*results):
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


# ------------------------------------------ CTC ------------------------------------------ #

# (B, T, U, V): the CTC training shape, small ragged ones, a lattice of one frame and no labels
CTC_CASES = [(16, 400, 128, 256), (3, 13, 4, 20), (2, 37, 50, 70), (1, 1, 0, 5)]


def _ctc_args(dev, b, t, u, v, seed=12):
    g = _gen(dev, seed)
    logits = _r(g, dev, (b, t, v), 2.0)
    labels = torch.randint(1, v, (b, u), generator=g, device=dev)
    u_len = torch.randint(0, u + 1, (b,), generator=g, device=dev)
    t_len = torch.randint(1, t + 1, (b,), generator=g, device=dev)
    if b > 1 and u > 1:
        labels[0, 1] = labels[0, 0]  # a repeated label
        u_len[0], t_len[0] = u, t
        u_len[1], t_len[1] = 0, t  # no labels
    if b > 2:
        u_len[2], t_len[2] = min(u, 3), 1  # infeasible
    labels[torch.arange(u, device=dev)[None, :] >= u_len[:, None]] = 0
    return logits, t_len, labels, u_len


@pytest.mark.parametrize("b,t,u,v", CTC_CASES)
def test_ctc_kernel(dev, b, t, u, v):
    logits, t_len, labels, u_len = _ctc_args(dev, b, t, u, v)
    lp_ext, skip, _ = ctc_prep(logits, labels)
    before = ctk.launches
    occ, loss = ctk.ctc_kernel(lp_ext, skip, t_len, u_len)
    assert ctk.launches == before + 1
    ref_occ, ref_loss = ctc_occupancy_plain(lp_ext, skip, t_len, u_len)
    assert torch.isfinite(loss).all() and torch.isfinite(occ).all()
    torch.testing.assert_close(loss, ref_loss, rtol=1e-5, atol=0)
    torch.testing.assert_close(occ, ref_occ, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ctc_loss_autograd_runs_the_kernel(dev, dtype):
    """A CUDA tensor launches the CTC kernel once per forward; the loss and
    the gradient (in the logits' dtype) equal the CPU plain path's."""
    logits, t_len, labels, u_len = _ctc_args(dev, 4, 29, 7, 33, seed=13)
    x = logits.to(dtype).requires_grad_(True)
    before = ctk.launches
    loss = ctk.ctc_loss_pallas(x, t_len, labels, u_len)
    (loss[:2].sum() + 0.5 * loss[3]).backward()
    assert ctk.launches == before + 1 and x.grad.dtype == dtype
    xc = x.detach().cpu().requires_grad_(True)
    ref = ctk.ctc_loss_pallas(xc, t_len.cpu(), labels.cpu(), u_len.cpu())
    (ref[:2].sum() + 0.5 * ref[3]).backward()
    torch.testing.assert_close(loss.detach().cpu(), ref.detach(), rtol=1e-5, atol=0)
    _grads_close([x.grad.cpu()], [xc.grad], GRAD_REL[dtype], "ctc_loss_pallas autograd")


# --------------------------------- kernel A (vanilla MHA) --------------------------------- #


def _attention_args(dev, dtype, bh, t, s, d, bias_bh, seed=14):
    g = _gen(dev, seed)
    q, k, v = _r(g, dev, (bh, t, d), 0.3, dtype), _r(g, dev, (bh, s, d), 1.0, dtype), _r(g, dev, (bh, s, d), 1.0, dtype)
    # the Keras query-row mask of a ragged batch (−1e9 on every column of a padded row) plus a term
    valid = torch.arange(t, device=dev)[None, :] < torch.randint(1, t + 1, (bias_bh,), generator=g, device=dev)[:, None]
    bias = (torch.where(valid, 0.0, -1e9)[:, :, None] + _r(g, dev, (bias_bh, t, s), 0.5)).to(dtype)
    return q, k, v, bias, _r(g, dev, (bh, t, d), 1.0, dtype)


# (B·H, T, S, D, bias B·H): head sizes 16, 36, 44, 64, 96 and 128, a broadcast bias, lengths that are not multiples of the 64-row tiles
ATTN_CASES = [(64, 400, 400, 128, 64), (8, 250, 250, 36, 1), (6, 77, 93, 64, 6), (3, 5, 130, 128, 1), (2, 17, 17, 44, 2), (4, 100, 150, 16, 4),
              (3, 65, 129, 96, 1)]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bh,t,s,d,bias_bh", ATTN_CASES)
def test_attention_kernels(dev, bh, t, s, d, bias_bh, dtype, rate):
    """Forward (and its row statistics, 1e-5 relative: the same f32 sums in
    another order) and backward against the plain versions; the dropout
    masks are the same hash on both sides."""
    q, k, v, bias, dout = _attention_args(dev, dtype, bh, t, s, d, bias_bh)
    before = (ak.attention_launches, ak.attention_bwd_launches)
    out, stats = ak.fused_attention_kernel(q, k, v, bias, 31, rate, with_stats=True)
    assert out.dtype == dtype
    torch.testing.assert_close(out, ak.fused_attention_plain(q, k, v, bias, 31, rate), **TOL[dtype])
    torch.testing.assert_close(stats, ak.fused_attention_plain_stats(q, k, bias), rtol=1e-5, atol=1e-5)
    grads = ak.fused_attention_bwd_kernel(q, k, v, bias, out, dout, 31, rate, stats=stats)
    assert (ak.attention_launches, ak.attention_bwd_launches) == (before[0] + 1, before[1] + 1)
    _grads_close(grads, ak.fused_attention_plain_bwd(q, k, v, bias, dout, 31, rate), GRAD_REL[dtype], f"attention {bh}x{t}x{s}x{d}")


def test_attention_bf16_backward_needs_the_forward_stats(dev):
    q, k, v, bias, dout = _attention_args(dev, torch.bfloat16, 2, 9, 11, 16, 1)
    out = ak.fused_attention_kernel(q, k, v, bias)
    with pytest.raises(ValueError, match="statistics"):
        ak.fused_attention_bwd_kernel(q, k, v, bias, out, dout)


@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_forward_without_stats(dev, dtype):
    """Without ``with_stats`` the forward computes no statistics and returns
    the same output; through autograd (statistics only for bf16: the f32
    backward recomputes them) the gradients match the plain ones."""
    q, k, v, bias, dout = _attention_args(dev, dtype, 3, 65, 129, 96, 1)
    out = ak.fused_attention_kernel(q, k, v, bias, 31, 0.1)
    assert isinstance(out, torch.Tensor)
    assert torch.equal(out, ak.fused_attention_kernel(q, k, v, bias, 31, 0.1, with_stats=True)[0])
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    got = ak.fused_attention(*leaves, bias, 31, 0.1)
    grads = torch.autograd.grad(got, leaves, dout)
    _grads_close(grads, ak.fused_attention_plain_bwd(q, k, v, bias, dout, 31, 0.1)[:3], GRAD_REL[dtype], "attention autograd")


def test_attention_wrapper_refuses_what_the_kernel_does_not_take(dev):
    q, k, v, bias, _ = _attention_args(dev, torch.float32, 2, 5, 7, 160, 1)
    with pytest.raises(ValueError, match="head size"):
        ak.fused_attention(q, k, v, bias)
    q, k, v, bias, _ = _attention_args(dev, torch.float32, 2, 5, 7, 16, 1)
    with pytest.raises(ValueError, match="bias"):
        ak.fused_attention(q, k, v, bias.expand(3, 5, 7).contiguous())


# ------------------------------------- CTC train step ------------------------------------- #


@pytest.mark.parametrize("name", ["conformer", "transformer"])
def test_ctc_train_step_on_the_card(dev, name):
    """One f32 auto step of a 2-block CTC model at full width on the card
    (kernels) and on a CPU copy (plain versions): loss to 1e-4 relative,
    every gradient to 1e-3 of its scale plus 1e-5 of the largest; the CTC
    kernel launches once, kernel A twice forward and twice backward (the
    Transformer), kernel B twice each way (the Conformer). The Transformer's
    input linear is drawn 1/√dmodel smaller: with random weights the ×√dmodel
    PE scale otherwise makes the attention scores O(500), and its gradients
    then move by 5e-3 under a 1e-6 input perturbation (on the CPU alone),
    more than any card/CPU tolerance can hold."""
    from tensorflowasr_tpu_torch.training.trainer import make_train_loss

    cls, cfg = {"conformer": (ConformerCtc, conformer_ctc_small_config(num_blocks=2, dropout=0.0)),
                "transformer": (TransformerCtc, transformer_ctc_base_config(num_blocks=2, dropout=0.0))}[name]
    cpu_model = cls.from_config(cfg, device="cpu")
    cpu_model.reset_parameters(torch.Generator().manual_seed(0))
    if name == "transformer":
        with torch.no_grad():
            cpu_model.encoder.linear.weight.mul_(cfg["encoder_dmodel"] ** -0.5)
    model = copy.deepcopy(cpu_model).to(dev)
    rng = np.random.default_rng(1)
    lens = np.array([64000, 48000])
    audio = (rng.standard_normal((2, 64000)) * 0.1).astype(np.float32)
    audio[1, 48000:] = 0.0
    labels = rng.integers(1, 256, (2, 30))
    labels[1, 20:] = 0
    t = torch.tensor
    batch = schemas.TrainData(schemas.TrainInput(t(audio), t(lens), t(labels), t([30, 20])), schemas.TrainLabel(t(labels), t([30, 20])))
    train_loss = make_train_loss(cpu_model, "auto")
    results = []
    for m, b in ((model, batch.to(dev)), (cpu_model, batch)):
        counts = (ctk.launches, ak.attention_launches, ak.attention_bwd_launches, ak.launches, ak.bwd_launches)
        loss = train_loss(m, b.inputs, b.labels)
        loss.backward()
        if b.labels.labels.device.type == "cuda":
            heads = (2, 2, 0, 0) if name == "transformer" else (0, 0, 2, 2)
            assert tuple(c - c0 for c, c0 in zip((ctk.launches, ak.attention_launches, ak.attention_bwd_launches, ak.launches, ak.bwd_launches),
                                                   counts)) == (1, *heads)
        results.append((loss.item(), {n: p.grad.detach().cpu() for n, p in m.named_parameters()}))
    (loss_gpu, g_gpu), (loss_cpu, g_cpu) = results
    assert abs(loss_gpu - loss_cpu) <= 1e-4 * abs(loss_cpu), (loss_gpu, loss_cpu)
    gmax = max(g.abs().max().item() for g in g_cpu.values())
    for n, ref in g_cpu.items():
        err = (g_gpu[n] - ref).abs().max().item()
        assert err <= 1e-3 * ref.abs().max().item() + 1e-5 * gmax, (n, err)


# ------------------------------------ fused greedy decode ------------------------------------ #


def _decode_model(dev, dtype, num_rnns=1, layer_norm=True, proj=0, vocab=256, seed=0):
    """A flagship-shaped Conformer-T (2 blocks) with the given prediction net, random weights."""
    cfg = conformer_small_config(num_blocks=2, vocab_size=vocab)
    cfg.update(prediction_num_rnns=num_rnns, prediction_layer_norm=layer_norm, prediction_projection_units=proj)
    model = Conformer.from_config(cfg, dtype=dtype, device="cpu")
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(dev).eval()


# (B, T, layers, LayerNorm, projection, vocab): the flagship serve shape, the canary's nets, a large vocabulary, one frame, and more
# utterances than clusters of 16 the card holds at once (they run in waves)
DECODE_CASES = [(8, 250, 1, True, 0, 256), (3, 37, 2, True, 11, 256), (2, 20, 1, False, 8, 1000), (1, 1, 1, True, 0, 256),
                (13, 60, 1, True, 0, 256)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,t,layers,ln,proj,vocab", DECODE_CASES)
def test_decode_kernel(dev, b, t, layers, ln, proj, vocab, dtype):
    """The decode kernel against its plain version on the card, from ragged
    lengths, a carried token and carried states. Tokens, lengths and next
    tokens equal (the encoder output sharpened as the canary does at bf16,
    so no decision sits near a tie); states to 1e-5 at f32, 1e-2 at bf16
    (an occasional flipped bf16 rounding of h carried through the cell)."""
    from tensorflowasr_tpu_torch.ops.cuda import decode_kernel as dk

    model = _decode_model(dev, dtype, layers, ln, proj, vocab)
    params = model.decode_params()
    gen = _gen(dev, 21)
    enc = _r(gen, dev, (b, t, 144))
    if dtype == torch.bfloat16:
        enc = enc * 3.0
        enc[..., 0] += 2.0
    lens = torch.randint(0, t + 1, (b,), generator=torch.Generator().manual_seed(3)).to(dev)
    lens[0] = t
    tok0 = torch.randint(0, vocab, (b,), generator=torch.Generator().manual_seed(4)).to(dev)
    states = tuple((_r(gen, dev, (b, 320), 0.5), _r(gen, dev, (b, 320), 0.5)) for _ in range(layers))
    before = dk.launches
    got = dk.fused_greedy_decode(enc.to(dtype), lens, params, tok0, states)
    assert dk.launches == before + 1
    ref = dk.fused_greedy_decode_plain(enc.to(dtype), lens, params, tok0, states)
    torch.cuda.synchronize()
    for g, r in zip(got[:3], ref[:3]):
        assert torch.equal(g, r)
    tol = dict(rtol=0, atol=1e-5 if dtype == torch.float32 else 1e-2)
    for (gc, gh), (rc, rh) in zip(got[3], ref[3]):
        torch.testing.assert_close(gc, rc, **tol)
        torch.testing.assert_close(gh, rh, **tol)


def test_recognize_launches_the_decode_kernel(dev):
    """``recognize`` on the card decodes through one kernel launch per call,
    and its f32 tokens equal the eager WIND loop's on the same encoding."""
    from tensorflowasr_tpu_torch.ops import transducer_decode
    from tensorflowasr_tpu_torch.ops.cuda import decode_kernel as dk

    model = _decode_model(dev, torch.float32)
    sig = torch.tensor((np.random.default_rng(5).standard_normal((2, 48000)) * 0.1).astype(np.float32), device=dev)
    lens = torch.tensor([48000, 30000], device=dev)
    before = dk.launches
    out = recognize(model, schemas.PredictInput(sig, lens))
    assert dk.launches == before + 1
    with torch.inference_mode():
        enc, enc_len, _ = model.encode(sig, lens)
        eager = transducer_decode.transducer_greedy_decode_wind(enc, enc_len, model.pred_step, model.joint_window,
                                                                 torch.zeros(2, dtype=torch.int64, device=dev), model.init_decoder_states(2, dev))
    assert torch.equal(out.tokens, eager[0]) and torch.equal(out.next_tokens, eager[2])


@pytest.mark.parametrize("cluster", [8, 16])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_kernel_cluster_sizes(dev, cluster, dtype):
    """Both cluster sizes (8: part of each slice read from L2) give the plain
    version's tokens, lengths and next tokens, states as above; 13
    utterances in clusters of 16 are more than the card holds at once, so
    they run in waves."""
    from tensorflowasr_tpu_torch.ops.cuda import decode_kernel as dk

    model = _decode_model(dev, dtype)
    params = model.decode_params()
    gen = _gen(dev, 22)
    enc = _r(gen, dev, (13, 120, 144))
    if dtype == torch.bfloat16:
        enc = enc * 3.0
        enc[..., 0] += 2.0
    lens = torch.randint(1, 121, (13,), generator=torch.Generator().manual_seed(5)).to(dev)
    lens[0] = 120
    tok0 = torch.zeros(13, dtype=torch.int64, device=dev)
    states = model.init_decoder_states(13, dev)
    got = dk.fused_greedy_decode_kernel(enc.to(dtype), lens, params, tok0, states, cluster=cluster)
    assert dk.last_launch["cluster"] == cluster
    ref = dk.fused_greedy_decode_plain(enc.to(dtype), lens, params, tok0, states)
    for g, r in zip(got[:3], ref[:3]):
        assert torch.equal(g, r)
    tol = dict(rtol=0, atol=1e-5 if dtype == torch.float32 else 1e-2)
    for (gc, gh), (rc, rh) in zip(got[3], ref[3]):
        torch.testing.assert_close(gc, rc, **tol)
        torch.testing.assert_close(gh, rh, **tol)


def test_decode_kernel_chunk_by_chunk(dev):
    """Batch 1 decoded in chunks of 5 frames (a streaming chunk), the token and
    the states carried: one launch per chunk, each chunk equal to the plain
    version's at f32."""
    from tensorflowasr_tpu_torch.ops.cuda import decode_kernel as dk

    model = _decode_model(dev, torch.float32)
    params = model.decode_params()
    enc = _r(_gen(dev, 23), dev, (1, 80, 144))
    tok_k = tok_p = torch.zeros(1, dtype=torch.int64, device=dev)
    st_k = st_p = model.init_decoder_states(1, dev)
    for c in range(16):
        chunk = enc[:, 5 * c:5 * c + 5].contiguous()
        lens = torch.tensor([5], device=dev)
        before = dk.launches
        got = dk.fused_greedy_decode(chunk, lens, params, tok_k, st_k)
        assert dk.launches == before + 1
        ref = dk.fused_greedy_decode_plain(chunk, lens, params, tok_p, st_p)
        for g, r in zip(got[:3], ref[:3]):
            assert torch.equal(g, r), c
        for (gc, gh), (rc, rh) in zip(got[3], ref[3]):
            torch.testing.assert_close(gc, rc, rtol=0, atol=1e-5)
            torch.testing.assert_close(gh, rh, rtol=0, atol=1e-5)
        tok_k, st_k, tok_p, st_p = got[2], got[3], ref[2], ref[3]


def test_decode_wrapper_raises_on_a_cluster_the_card_cannot_launch(dev):
    """A cluster of 32 blocks is beyond the card's limit: the wrapper raises
    and launches nothing (no fallback)."""
    from tensorflowasr_tpu_torch.ops.cuda import decode_kernel as dk

    model = _decode_model(dev, torch.float32)
    enc = _r(_gen(dev, 24), dev, (2, 10, 144))
    before = dk.launches
    with pytest.raises(RuntimeError, match="cannot launch"):
        dk.fused_greedy_decode_kernel(enc, torch.tensor([10, 7], device=dev), model.decode_params(), torch.zeros(2, dtype=torch.int64, device=dev),
                                      model.init_decoder_states(2, dev), cluster=32)
    assert dk.launches == before


@pytest.mark.parametrize("cluster", [8, 16])
@pytest.mark.parametrize("layers,proj,elt", [(1, 0, 2), (1, 0, 4), (2, 11, 2), (1, 8, 4)])
def test_decode_plan_matches_the_kernel_layout(dev, cluster, layers, proj, elt):
    """The Python plan's shared-memory bytes equal the kernel's own count."""
    import ctypes

    from tensorflowasr_tpu_torch.ops.cuda import _build
    from tensorflowasr_tpu_torch.ops.cuda import decode_kernel as dk

    plan = dk.decode_plan(320, 320, proj, 320, 256, layers, cluster, elt)
    res = (ctypes.c_int * len(plan.resident))(*plan.resident)
    got = _build.build().tfasr_decode_smem_bytes(320, 320, proj, 320, layers, cluster, ctypes.addressof(res), 1 if elt == 2 else 0)
    assert got == plan.smem_bytes
    assert dk.cluster_occupancy(dev, 1 if elt == 2 else 0, plan) >= 1
