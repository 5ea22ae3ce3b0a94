"""Port kernels' plain PyTorch versions vs the JAX Pallas kernels (interpret mode).

Inputs are made with numpy from a seed and given to both sides. f32
tolerances are summation-order tolerances (1e-5 absolute on unit-scale
outputs); the bf16 cases allow one bf16 ulp of the outputs (2^-8
relative), since a summation-order difference can flip a rounding. The
CUDA kernels themselves are held against these plain versions on the card
(``tests/test_torch_cuda.py`` and ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowasr_tpu.models.layers import attention as jattn
from tensorflowasr_tpu.ops.pallas import attention_kernel as jak
from tensorflowasr_tpu.ops.pallas import conv_kernel as jck
from tensorflowasr_tpu.ops.pallas import ff_kernel as jfk
from tensorflowasr_tpu_torch.models.layers import attention as tattn
from tensorflowasr_tpu_torch.ops.cuda import attention_kernel as ak
from tensorflowasr_tpu_torch.ops.cuda import conv_kernel as ck
from tensorflowasr_tpu_torch.ops.cuda import ff_kernel as fk
from tensorflowasr_tpu_torch.utils.tracing import launches

F32_TOL = dict(rtol=1e-5, atol=1e-5)


def _both(a: np.ndarray, dtype=np.float32):
    """The same numpy data as a JAX array and a torch tensor."""
    if dtype == "bf16":
        return jnp.asarray(a, jnp.bfloat16), torch.tensor(a).to(torch.bfloat16)
    return jnp.asarray(a.astype(dtype)), torch.tensor(a.astype(dtype))


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32))


# ------------------------------ relative attention ------------------------------ #

# (T, S, R, heads, kv_bias, q_len, causal, chunk, history, pe_causal)
REL_CASES = {
    "plain": (12, 12, 23, 2, False, False, False, None, None, False),
    "q_len_padded_rows": (12, 12, 23, 2, False, True, False, None, None, False),
    "kv_bias": (12, 12, 23, 2, True, True, False, None, None, False),
    "causal": (12, 12, 23, 2, False, True, True, None, None, False),
    "chunked": (16, 16, 31, 2, False, True, False, 4, 4, False),
    "chunked_unlimited_history": (16, 16, 31, 2, False, False, False, 4, -1, False),
    "long_relpe_extra": (10, 10, 27, 2, False, True, False, None, None, False),
    "causal_pe": (12, 12, 12, 2, False, False, True, None, None, True),
    "causal_pe_extra": (10, 10, 16, 2, False, True, True, None, None, True),
    "memory_prepended": (10, 16, 25, 2, True, True, False, 5, 6, False),
}


def _rel_inputs(rng, t, s, r, heads, with_kvb, with_qlen, b=2, d=8):
    bh = b * heads
    arrs = [rng.standard_normal(shape).astype(np.float32) * sc for shape, sc in (((bh, t, d), 0.5), ((bh, t, d), 0.5), ((bh, s, d), 1.0), ((bh, s, d), 1.0), ((bh, r, d), 1.0))]
    kvb = None
    if with_kvb:
        valid = np.arange(s)[None, :] >= np.array([0, s // 3])[:, None]
        kvb = np.where(valid, 0.0, -1e9).astype(np.float32)[:, None, :]
    q_len = np.array([t, t - 5], np.int32) if with_qlen else None
    return arrs, kvb, q_len


@pytest.mark.parametrize("case", sorted(REL_CASES))
def test_rel_attention_plain_matches_pallas(case):
    t, s, r, heads, with_kvb, with_qlen, causal, chunk, hist, pe_causal = REL_CASES[case]
    rng = np.random.default_rng(7)
    arrs, kvb, q_len = _rel_inputs(rng, t, s, r, heads, with_kvb, with_qlen)
    j = [jnp.asarray(a) for a in arrs]
    tt = [torch.tensor(a) for a in arrs]
    ref = jak.fused_rel_attention(
        *j, None if kvb is None else jnp.asarray(kvb), None if q_len is None else jnp.asarray(q_len), jnp.zeros((), jnp.int32),
        0.0, causal, chunk, hist, True, pe_causal,
    )
    got = ak.fused_rel_attention(
        *tt, None if kvb is None else torch.tensor(kvb), None if q_len is None else torch.tensor(q_len), 0, 0.0, causal, chunk, hist, pe_causal
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32_TOL, err_msg=case)


def test_rel_attention_plain_bf16_matches_pallas():
    rng = np.random.default_rng(8)
    arrs, kvb, q_len = _rel_inputs(rng, 12, 12, 23, 2, False, True)
    j = [jnp.asarray(a, jnp.bfloat16) for a in arrs]
    tt = [torch.tensor(a).to(torch.bfloat16) for a in arrs]
    ref = jak.fused_rel_attention(*j, None, jnp.asarray(q_len), jnp.zeros((), jnp.int32), 0.0, False, None, None, True, False)
    got = ak.fused_rel_attention(*tt, None, torch.tensor(q_len))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(ref), rtol=2 ** -7, atol=2 ** -7)


@pytest.mark.parametrize("causal", [False, True])
def test_rel_left_shift_matches_jax(causal):
    rng = np.random.default_rng(3)
    t = 6
    x = rng.standard_normal((2, 3, t, t if causal else 2 * t - 1)).astype(np.float32)
    np.testing.assert_array_equal(tattn.rel_left_shift(torch.tensor(x), causal).numpy(), np.asarray(jattn.rel_left_shift(jnp.asarray(x), causal)))


def test_merge_masks_matches_jax():
    t, s = 6, 9
    qm = np.arange(t)[None, :] < np.array([6, 4])[:, None]
    km = np.arange(s)[None, :] < np.array([9, 5])[:, None]
    ref = jattn._merge_masks(2, t, s, jnp.asarray(qm), jnp.asarray(km), None, True, 2, 3)
    got = tattn._merge_masks(t, s, torch.tensor(qm), torch.tensor(km), None, True, 2, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_fused_rel_attention_equals_xla_chain():
    """The plain kernel version equals the XLA-semantics chain built from
    ``rel_left_shift`` and the merged boolean mask (Keras −1e9 add)."""
    rng = np.random.default_rng(4)
    b, h, t, d = 2, 2, 8, 4
    qc, qp, k, v = (torch.tensor(rng.standard_normal((b * h, t, d)).astype(np.float32)) for _ in range(4))
    pos = torch.tensor(rng.standard_normal((b * h, 2 * t - 1, d)).astype(np.float32))
    q_len = torch.tensor([t, 5], dtype=torch.int32)
    got = ak.fused_rel_attention(qc, qp, k, v, pos, None, q_len, causal=True)
    w = torch.einsum("ntd,nrd->ntr", qp, pos).reshape(b, h, t, -1)
    scores = torch.einsum("ntd,nsd->nts", qc, k).reshape(b, h, t, t) + tattn.rel_left_shift(w)[..., -t:]
    qmask = torch.arange(t)[None, :] < q_len[:, None].long()
    mask = tattn._merge_masks(t, t, qmask, None, None, True, None, None)
    probs = torch.softmax(scores + (~mask).float() * -1e9, dim=-1)
    want = torch.einsum("bhts,bhsd->bhtd", probs, v.reshape(b, h, t, d)).reshape(b * h, t, d)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32_TOL)


# ---------------------------------- FF and conv ---------------------------------- #


def _ff_arrays(rng, n=40, d=16, f=64):
    return dict(
        x=rng.standard_normal((n, d)).astype(np.float32),
        gamma=(1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32),
        beta=(0.1 * rng.standard_normal(d)).astype(np.float32),
        w1=(rng.standard_normal((d, f)) / np.sqrt(d)).astype(np.float32),
        b1=(0.1 * rng.standard_normal(f)).astype(np.float32),
        w2=(rng.standard_normal((f, d)) / np.sqrt(f)).astype(np.float32),
        b2=(0.1 * rng.standard_normal(d)).astype(np.float32),
    )


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fused_ff_plain_matches_pallas(dtype):
    a = _ff_arrays(np.random.default_rng(11))
    dt = np.float32 if dtype == "f32" else "bf16"
    (jx, tx), (jw1, tw1), (jb1, tb1), (jw2, tw2), (jb2, tb2) = (_both(a[k], dt) for k in ("x", "w1", "b1", "w2", "b2"))
    ref = jfk.fused_ff(jx, jnp.asarray(a["gamma"]), jnp.asarray(a["beta"]), jw1, jb1, jw2, jb2, jnp.zeros((), jnp.int32), 0.0, 0.5, 1e-3, True)
    got = fk.fused_ff(tx, torch.tensor(a["gamma"]), torch.tensor(a["beta"]), tw1, tb1, tw2, tb2, 0, 0.0, 0.5, 1e-3)
    assert got.dtype == tx.dtype
    tol = F32_TOL if dtype == "f32" else dict(rtol=2 ** -7, atol=2 ** -6)
    np.testing.assert_allclose(_np(got), _np(ref), **tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_conv_front_back_plain_match_pallas(dtype):
    rng = np.random.default_rng(12)
    b, t, d = 2, 13, 16
    dt = np.float32 if dtype == "f32" else "bf16"
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    y1 = rng.standard_normal((b, t, d)).astype(np.float32)
    vec = lambda s=0.1, off=0.0: (off + s * rng.standard_normal(d)).astype(np.float32)
    mat = lambda: (rng.standard_normal((d, d)) / np.sqrt(d)).astype(np.float32)
    gamma, beta, mean, var, scale, bias = vec(off=1.0), vec(), vec(), np.abs(vec(off=1.0)), vec(off=1.0), vec()
    wa, ba, wb, bb, w2, b2 = mat(), vec(), mat(), vec(), mat(), vec()
    (jx, tx), (jwa, twa), (jba, tba), (jwb, twb), (jbb, tbb) = (_both(v, dt) for v in (x, wa, ba, wb, bb))
    ref = jck.conv_front(jx, jnp.asarray(gamma), jnp.asarray(beta), jwa, jba, jwb, jbb, 1e-3, True)
    got = ck.conv_front(tx, torch.tensor(gamma), torch.tensor(beta), twa, tba, twb, tbb)
    tol = F32_TOL if dtype == "f32" else dict(rtol=2 ** -7, atol=2 ** -6)
    np.testing.assert_allclose(_np(got), _np(ref), **tol)

    (jy1, ty1), (jw2, tw2), (jb2, tb2) = (_both(v, dt) for v in (y1, w2, b2))
    stats = [jnp.asarray(v) for v in (mean, var, scale, bias)]
    ref = jck.conv_back(jx, jy1, *stats, jw2, jb2, jnp.zeros((), jnp.int32), 0.0, 1.0, 1e-3, True)
    got = ck.conv_back(tx, ty1, *(torch.tensor(v) for v in (mean, var, scale, bias)), tw2, tb2, 0, 0.0, 1.0)
    np.testing.assert_allclose(_np(got), _np(ref), **tol)


def test_depthwise_conv1d_matches_jax():
    rng = np.random.default_rng(13)
    g = rng.standard_normal((2, 11, 6)).astype(np.float32)
    wd = rng.standard_normal((7, 6)).astype(np.float32)  # JAX layout [K, D]
    bd = rng.standard_normal(6).astype(np.float32)
    for padding in ("causal", "same"):
        ref = jck.depthwise_conv1d(jnp.asarray(g), jnp.asarray(wd), jnp.asarray(bd), padding)
        got = ck.depthwise_conv1d(torch.tensor(g), torch.tensor(wd.T[:, None, :].copy()), torch.tensor(bd), padding)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32_TOL, err_msg=padding)


# ------------------------------ wrapper contracts ------------------------------ #


def _small_calls():
    x2, x3 = torch.randn(4, 8), torch.randn(1, 4, 8)
    v, m = torch.randn(8), torch.randn(8, 8)
    att = (torch.randn(2, 4, 8),) * 4 + (torch.randn(2, 7, 8),)
    return {
        "fused_rel_attention": lambda rate: ak.fused_rel_attention(*att, None, None, 0, rate),
        "fused_ff": lambda rate: fk.fused_ff(x2, v, v, torch.randn(8, 16), torch.randn(16), torch.randn(16, 8), v, 0, rate),
        "conv_back": lambda rate: ck.conv_back(x3, x3, v, v.abs(), v, v, m, v, 0, rate),
    }


@pytest.mark.parametrize("name", ["fused_rel_attention", "fused_ff", "conv_back"])
def test_dropout_rate_raises(name):
    """Dropout rates in [0, 1) run (the kernels take training dropout); others raise."""
    call = _small_calls()[name]
    assert torch.isfinite(call(0.0)).all()
    assert torch.isfinite(call(0.1)).all()
    for bad in (1.0, -0.1):
        with pytest.raises(ValueError, match="dropout"):
            call(bad)


def _counts():
    return tuple(launches[f"kernel.{k}.{p}"] for k in ("rel_attention", "ff", "conv_front", "conv_back") for p in ("fwd", "bwd"))


def test_cpu_tensors_take_plain_path_without_counting():
    before = _counts()
    for call in _small_calls().values():
        call(0.0)
    ck.conv_front(torch.randn(1, 4, 8), torch.ones(8), torch.zeros(8), torch.randn(8, 8), torch.zeros(8), torch.randn(8, 8), torch.zeros(8))
    x = torch.randn(4, 8, requires_grad=True)
    fk.fused_ff(x, torch.ones(8), torch.zeros(8), torch.randn(8, 16), torch.zeros(16), torch.randn(16, 8), torch.zeros(8), 0, 0.1).sum().backward()
    assert x.grad is not None and _counts() == before
