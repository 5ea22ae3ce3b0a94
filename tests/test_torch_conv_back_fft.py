"""What the tensor-core kernels of ``conv_back`` (``csrc/conv_mma.cu``:
``cb_fwd``, ``cb_bwd_rows``) and the FFT log-mel frontend
(``csrc/frontend.cu``: ``log_mel_fft_kernel``) compute, in Python on the
CPU, with JAX as the reference where it has the function; and the
collect-and-freeze of ``Trainer.fit``.

conv_back: the kernels' shared-memory plan is checked at every width the
bf16 kernels take; the forward's and the backward rows pass's row tiles are
walked to show that every output element and every column-sum partial is
written once for ragged N; the rows pass's column sums (db2, dbias,
dscale), one partial row per 16 rows summed in order, and dmean / dvar
formed from them as ``bn_stat_grads_kernel`` does, are held against JAX's
``conv_back`` backward in interpret mode; and the bf16 high + low parts of
the weight gradient's operands a and dz, and their three-term product, are
held against float64.

The frontend: the FFT kernel's schedule (the float64-built twiddle table,
a radix-2 stage where log2(nfft/2) is odd, radix-4 stages, the digit-reversed
output positions, the real split, each mel filter over its nonzero bins) is
emulated in torch f32 in the kernel's order, and held against a numpy
float64 rfft and against JAX's ``log_mel_spectrogram_pallas`` and ``_v2``
in interpret mode at nfft 512, 1024 and 256; the direct-DFT kernel that any
other nfft takes (nfft = None: 400 points) is emulated the same way. The
wrappers' CPU dispatch takes the plain versions and launches nothing.

The plans are copied here (private to this file); the card tests in
``tests/test_torch_cuda.py`` hold the library's own shared memory and
occupancy against them. JAX and the tiny training config are imported
inside the tests that use them, so that those card tests can import this
file on a machine without JAX.

Tolerances: column sums in another order, 1e-5 of each sum's scale. hi + lo
keeps an f32 value to 2^-16 relative (two bf16 roundings), the three-term
product to 1e-5 of its scale. The f32 FFT and the float64 rfft differ by
rounding (~1e-6 relative in a bin's power), so 1e-4 absolute in log-mel
against float64 and the plain chain's 1e-3 against JAX's f32 DFT kernels;
the emulation must also sit no farther from float64 than twice the plain
torch.fft.rfft chain does (rms).
"""

import dataclasses
import gc

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tensorflowasr_tpu_torch.ops import frontend
from tensorflowasr_tpu_torch.ops.cuda import _build
from tensorflowasr_tpu_torch.ops.cuda import conv_kernel as ck
from tensorflowasr_tpu_torch.ops.cuda import frontend_kernel as fek
from tensorflowasr_tpu_torch.utils.tracing import launches

SEED = 1010
CB_ROWS, CB_CC, PAD = 32, 64, 8  # csrc/conv_mma.cu: rows a block of cb_fwd and cb_bwd_rows, W2 columns per chunk, row padding
SM_SHARED_BYTES, BLOCK_RESERVED_BYTES, MAX_BLOCK_SHARED_BYTES = 228 * 1024, 1024, 227 * 1024  # H100 SXM
LOG_TOL = 1e-3  # log-mel against JAX's f32 DFT kernels
FFT_WARPS = 8  # csrc/frontend.cu FE_WARPS: frames (warps) per block of the FFT kernel


def _blocks_per_sm(smem: int, threads: int = 256) -> int:
    """Blocks per SM as shared memory and threads allow (the card's occupancy also counts registers)."""
    return min(SM_SHARED_BYTES // (smem + BLOCK_RESERVED_BYTES), 2048 // threads)


@dataclasses.dataclass(frozen=True)
class ConvBackPlan:
    """conv_back's bf16 tensor-core kernels' dynamic shared memory at one width."""

    padded_d: int  # D rounded up to 16 in shared memory
    chunks: int  # 64-column (forward) or 64-row (backward) chunks of W2
    fwd_smem_bytes: int  # a [32][Dp + 8] and two chunks of W2[:, chunk] [Dp][72], bf16; mean, rstd, scale, bias [Dp] f32
    bwd_smem_bytes: int  # y1 and dz [32][Dp + 8] and two chunks of W2[chunk, :] [64][Dp + 8], bf16; the same four vectors
    fwd_blocks_per_sm: int
    bwd_blocks_per_sm: int


def _conv_back_plan(d: int) -> ConvBackPlan:
    """Shared memory of csrc/conv_mma.cu's cb_fwd and cb_bwd_rows at width D (cb_fwd_smem, cb_bwd_smem)."""
    dp = -(-d // 16) * 16
    vectors = 4 * 4 * dp
    fwd = 2 * (CB_ROWS * (dp + PAD) + 2 * dp * (CB_CC + PAD)) + vectors
    bwd = 2 * (2 * CB_ROWS * (dp + PAD) + 2 * CB_CC * (dp + PAD)) + vectors
    return ConvBackPlan(dp, -(-d // CB_CC), fwd, bwd, _blocks_per_sm(fwd), _blocks_per_sm(bwd))


@pytest.mark.parametrize("d", [144, 176, 256, 100, 16, 8, 64, 200])
def test_conv_back_plan_fits_the_card(d):
    """Both kernels fit a block at every D <= 256; at the flagship's and
    Conformer-CTC's widths each fits three or more blocks per SM by shared
    memory (the 200 blocks of N 6400 in one wave on 132 SMs)."""
    plan = _conv_back_plan(d)
    assert plan.fwd_smem_bytes <= MAX_BLOCK_SHARED_BYTES and plan.bwd_smem_bytes <= MAX_BLOCK_SHARED_BYTES
    assert plan.fwd_blocks_per_sm >= 1 and plan.bwd_blocks_per_sm >= 1 and plan.padded_d % 16 == 0
    assert plan.chunks == -(-d // 64)
    if d in (144, 176):
        assert plan.bwd_blocks_per_sm >= 3 and plan.fwd_blocks_per_sm >= 3


def _tile_map(rows_per_block: int, n: int, d: int):
    """(row, column, 16-row group) of every element a grid of 8-warp blocks
    of ``rows_per_block`` rows writes: warp (rg, fq) of RG x FQ (FQ = 8 / RG)
    owns rows 16 rg + g and 16 rg + g + 8 of its block and the columns
    fq * 64 / FQ + 8 nt + 2 tig (+1) of each 64-column chunk."""
    rg_n = rows_per_block // 16
    fq_n, blocks, nch = 8 // rg_n, -(-n // rows_per_block), -(-d // CB_CC)
    nt_n = CB_CC // fq_n // 8
    rg, fq, nt, g, tig, hf, q = np.meshgrid(*(np.arange(k) for k in (rg_n, fq_n, nt_n, 8, 4, 2, 2)), indexing="ij")
    rows = (rg * 16 + g + 8 * hf).ravel()
    cols = (fq * (CB_CC // fq_n) + nt * 8 + 2 * tig + q).ravel()
    groups = rg.ravel()
    blk = np.arange(blocks)[:, None, None]
    chunk = np.arange(nch)[None, :, None]
    row = np.broadcast_to(blk * rows_per_block + rows, (blocks, nch, rows.size)).ravel()
    col = np.broadcast_to(chunk * CB_CC + cols, (blocks, nch, rows.size)).ravel()
    group = np.broadcast_to(blk * rg_n + groups, (blocks, nch, rows.size)).ravel()
    keep = (row < n) & (col < d)
    return row[keep], col[keep], group[keep], blocks * rg_n


@pytest.mark.parametrize("d,n", [(144, 6400), (144, 2000), (176, 6400), (144, 16), (256, 6400), (100, 37), (24, 5)])
def test_conv_back_tiles_write_every_element_once(d, n):
    """cb_fwd's and cb_bwd_rows' 32-row map (warps of 2 row groups x 4
    column parts) writes every element of [N, D] (out, dy1) once and none
    past N or D, and each row's elements land in the column-sum partial row
    of its 16-row group (block * 2 + rg), every column of every partial row written by
    the warps of that group (training N 6400 and serving N 2000 at the
    Conformers' widths, a 16-frame streaming chunk, the widest D, ragged
    D and N)."""
    row, col, group, n_groups = _tile_map(CB_ROWS, n, d)
    written = np.zeros((n, d), np.int64)
    np.add.at(written, (row, col), 1)
    assert (written == 1).all()
    assert (group == row // 16).all()
    covered = np.zeros((n_groups, d), bool)
    covered[group, col] = True
    assert covered[: -(-n // 16)].all()
    assert n_groups * 16 - n < CB_ROWS


def _conv_back_inputs(seed, b, t, d):
    r = np.random.default_rng(seed)
    f = lambda *s: r.standard_normal(s).astype(np.float32)
    y1, dout = f(b, t, d), f(b, t, d)
    mean, var = 0.1 * f(d), (1.0 + r.random(d)).astype(np.float32)
    scale, bias = 1.0 + 0.1 * f(d), 0.1 * f(d)
    w2, b2 = f(d, d) * d ** -0.5, 0.1 * f(d)
    return y1, dout, mean, var, scale, bias, w2, b2


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_conv_back_column_sums_by_16_rows_match_jax(rate):
    """The rows pass's column sums (db2, dbias, dscale), one partial row per
    16 rows summed in row order and then in partial order as
    sum_partials_kernel does, and dmean, dvar formed from them as
    bn_stat_grads_kernel does, against JAX's conv_back backward (interpret
    mode) at f32; dropout at rate 0.1 (B 2, T 32: JAX's one grid step, so
    its mask is indexed by the global row, as the kernel's)."""
    b, t, d, seed, factor, eps = 2, 32, 24, 7, 0.5, 1e-3
    y1, dout, mean, var, scale, bias, w2, b2 = _conv_back_inputs(SEED, b, t, d)
    tt = lambda a: torch.tensor(a)
    rstd = torch.rsqrt(tt(var) + eps)
    xhat = (tt(y1) - tt(mean)) * rstd
    bn = xhat * tt(scale) + tt(bias)
    sig = torch.sigmoid(bn)
    dz = factor * tt(dout)
    keep = ck._back_mask(seed, rate, tt(y1))
    if keep is not None:
        dz = dz * keep
    da = ck.dot_as(dz, tt(w2).t())
    dbn = da * (sig + bn * sig * (1 - sig))
    cols = torch.cat([dz, dbn, dbn * xhat], -1).reshape(-1, 3 * d)  # [N, 3D] per row
    got = torch.zeros(3 * d)
    for part in torch.stack([c.sum(0) for c in cols.split(16)]):  # one partial row per 16 rows, in order
        got = got + part
    db2, dbias, dscale = got.split(d)
    dmean = -(dbias * tt(scale)) * rstd
    dvar = dscale * tt(scale) * -0.5 * rstd * rstd

    import jax
    import jax.numpy as jnp

    from tensorflowasr_tpu.ops.pallas import conv_kernel as jck

    x = np.zeros_like(y1)
    jargs = [jnp.asarray(a) for a in (x, y1, mean, var, scale, bias, w2, b2)]
    _, vjp = jax.vjp(lambda *a: jck.conv_back(*a, seed, rate, factor, eps, True), *jargs)
    ref = vjp(jnp.asarray(dout))
    for name, g, r in (("dmean", dmean, ref[2]), ("dvar", dvar, ref[3]), ("dscale", dscale, ref[4]), ("dbias", dbias, ref[5]), ("db2", db2, ref[7])):
        r = np.asarray(r, np.float64)
        assert np.abs(g.double().numpy() - r).max() <= 1e-5 * np.abs(r).max(), name


def _split(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """bf16 hi = round(v), lo = round(v - hi): mma.cuh put_split."""
    hi = v.to(torch.bfloat16)
    return hi, (v - hi.float()).to(torch.bfloat16)


@pytest.mark.parametrize("b,t,d", [(2, 40, 24), (1, 70, 144)])
def test_conv_back_split_operands_match_float64(b, t, d):
    """The weight gradient's f32 operands a = swish(bn) and dz, written as
    bf16 hi + lo by the rows pass, keep each value to 2^-16 relative, and
    their product as launch_split_atb forms it (hi.hi + hi.lo + lo.hi, f32
    accumulation) is dW2 = a^T dz to 1e-5 of its scale in float64; one term
    (hi.hi) misses by ~2^-9."""
    y1, dout, mean, var, scale, bias, w2, _ = _conv_back_inputs(SEED + 1, b, t, d)
    rstd = 1.0 / np.sqrt(var.astype(np.float64) + 1e-3)
    bn = (y1.astype(np.float64) - mean) * rstd * scale + bias
    a64 = (bn / (1.0 + np.exp(-bn))).reshape(-1, d)
    dz64 = dout.astype(np.float64).reshape(-1, d)
    ref = a64.T @ dz64
    a32, dz32 = torch.tensor(a64, dtype=torch.float32), torch.tensor(dz64, dtype=torch.float32)
    (ah, al), (zh, zl) = _split(a32), _split(dz32)
    for v, (h, lo) in ((a32, (ah, al)), (dz32, (zh, zl))):
        err = (h.double() + lo.double() - v.double()).abs()
        assert (err <= 2.0 ** -16 * v.double().abs()).all()
    mm = lambda x, y: x.float().t() @ y.float()
    got = (mm(ah, zh) + mm(ah, zl) + mm(al, zh)).double().numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    assert np.abs(mm(ah, zh).double().numpy() - ref).max() > 1e-4 * np.abs(ref).max()


# ---------------------------------- the frontend ---------------------------------- #


def fft_positions(m: int) -> np.ndarray:
    """Where the kernel's decimation-in-frequency FFT of ``m`` points leaves
    frequency k (csrc/frontend.cu ``fe_position``): a radix-2 stage first
    where log2 m is odd, then radix-4 stages; the first stage's digit, k's
    lowest, has the largest weight."""
    k, pos, span = np.arange(m), np.zeros(m, np.int64), m
    if int(np.log2(m)) % 2:
        span //= 2
        pos += (k & 1) * span
        k = k >> 1
    while span > 1:
        span //= 4
        pos += (k & 3) * span
        k = k >> 2
    return pos


def _pad(i: int) -> int:
    """csrc/frontend.cu fe_pad: one complex pad slot after every 16."""
    return i + (i >> 4)


def _fft_smem_bytes(nfft: int, fl: int, fs: int, nmel: int, nnz: int) -> int:
    """Dynamic shared memory of log_mel_fft_kernel (fe_fft_smem): the twiddles
    and 8 frames of nfft/2 complex points at padded slots, the window and the
    block's samples (each rounded up to even), 8 power rows of nfft/2 + 1,
    the mel weights, first bins and offsets."""
    m, span = nfft // 2, (FFT_WARPS - 1) * fs + fl
    even = lambda k: (k + 1) // 2 * 2
    return 8 * (_pad(nfft) + FFT_WARPS * _pad(m)) + 4 * (even(fl) + even(span) + FFT_WARPS * (m + 1) + nnz) + 4 * (2 * nmel + 1)


@pytest.mark.parametrize("nfft", [256, 512, 1024, 2048])
def test_fft_plan_fits_the_card(nfft):
    """At every FFT size the kernel's shared memory fits a block (at 80 mels
    and 25 ms frames), and at nfft 512 four or more blocks of 8 frames fit an SM."""
    mel = frontend.linear_to_mel_weight_matrix(80, nfft // 2 + 1, 16000)
    smem = _fft_smem_bytes(nfft, 400, 160, 80, len(fek.mel_ranges(mel)[0]))
    assert smem <= MAX_BLOCK_SHARED_BYTES
    if nfft == 512:
        assert _blocks_per_sm(smem) >= 4


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def _dif_fft(re, im, tw_re, tw_im):
    """The kernel's in-place DIF FFT over the last axis (M points), in the
    dtype of re/im with the twiddle table W_n^k (n = 2M): a radix-2 stage
    first where log2 M is odd, then radix-4 stages; output in
    :func:`fft_positions` order."""
    re, im = re.clone(), im.clone()
    m = re.shape[-1]
    nfft = 2 * m
    span = m
    if int(np.log2(m)) % 2:
        s = span // 2
        base = (torch.arange(m // span)[:, None] * span + torch.arange(s)[None, :]).reshape(-1)
        j = base % span
        x0r, x0i, x1r, x1i = re[..., base], im[..., base], re[..., base + s], im[..., base + s]
        w = j * (nfft // span)
        re[..., base], im[..., base] = x0r + x1r, x0i + x1i
        re[..., base + s], im[..., base + s] = _cmul(x0r - x1r, x0i - x1i, tw_re[w], tw_im[w])
        span //= 2
    while span >= 4:
        s = span // 4
        base = (torch.arange(m // span)[:, None] * span + torch.arange(s)[None, :]).reshape(-1)
        j = base % span
        x = [(re[..., base + r * s], im[..., base + r * s]) for r in range(4)]
        a0 = (x[0][0] + x[2][0], x[0][1] + x[2][1])
        a1 = (x[0][0] - x[2][0], x[0][1] - x[2][1])
        a2 = (x[1][0] + x[3][0], x[1][1] + x[3][1])
        dd = (x[1][0] - x[3][0], x[1][1] - x[3][1])
        a3 = (dd[1], -dd[0])  # -i (x1 - x3)
        y = [(a0[0] + a2[0], a0[1] + a2[1]), (a1[0] + a3[0], a1[1] + a3[1]), (a0[0] - a2[0], a0[1] - a2[1]), (a1[0] - a3[0], a1[1] - a3[1])]
        for q in range(4):
            w = q * j * (nfft // span)
            yr, yi = (y[q] if q == 0 else _cmul(y[q][0], y[q][1], tw_re[w], tw_im[w]))
            re[..., base + q * s], im[..., base + q * s] = yr, yi
        span //= 4
    return re, im


def _mel_sparse(power: torch.Tensor, mel: np.ndarray) -> torch.Tensor:
    """Each filter summed over its nonzero bins in ascending order (fe_mel_log before the log)."""
    w, lo, off = fek.mel_ranges(mel)
    w, lo, off = torch.tensor(w), torch.tensor(lo).long(), torch.tensor(off).long()
    cnt = off[1:] - off[:-1]
    acc = torch.zeros((*power.shape[:-1], len(lo)), dtype=power.dtype)
    for q in range(int(cnt.max()) if len(cnt) else 0):
        valid = q < cnt
        k = torch.where(valid, lo + q, 0)
        acc = acc + torch.where(valid, power[..., k] * w[torch.where(valid, off[:-1] + q, 0)].to(power.dtype), 0.0)
    return acc


def _frames(sig: np.ndarray, cfg, dtype=torch.float32) -> torch.Tensor:
    """pad_end frames [B, T, frame_length], zero past N (the kernels' index arithmetic)."""
    b, n = sig.shape
    t = cfg.get_nframes(n)
    idx = torch.arange(t)[:, None] * cfg.frame_step + torch.arange(cfg.frame_length)[None, :]
    s = torch.tensor(sig, dtype=dtype)
    return F.pad(s, (0, max(0, int(idx.max()) + 1 - n)))[:, idx]


def emulate_fft_log_mel(sig: np.ndarray, cfg) -> torch.Tensor:
    """log_mel_fft_kernel in torch f32, in the kernel's order."""
    nfft, fl = cfg.fft_length, cfg.frame_length
    m = nfft // 2
    x = F.pad(_frames(sig, cfg) * frontend.hann_window(fl), (0, nfft - fl))
    tw = torch.tensor(fek.twiddles(nfft))
    re, im = _dif_fft(x[..., 0::2], x[..., 1::2], tw[:, 0], tw[:, 1])
    pos = torch.tensor(fft_positions(m))
    k = torch.arange(m + 1)
    pk, pm = pos[k & (m - 1)], pos[(m - k) & (m - 1)]
    zkr, zki, zmr, zmi = re[..., pk], im[..., pk], re[..., pm], im[..., pm]
    er, ei = 0.5 * (zkr + zmr), 0.5 * (zki - zmi)
    orr, oi = 0.5 * (zki + zmi), -0.5 * (zkr - zmr)
    wr, wi = _cmul(tw[: m + 1, 0], tw[: m + 1, 1], orr, oi)
    xr, xi = er + wr, ei + wi
    mel = frontend.linear_to_mel_weight_matrix(cfg.num_feature_bins, m + 1, cfg.sample_rate, cfg.lower_edge_hertz, cfg.upper_edge_hertz)
    return torch.log(_mel_sparse(xr * xr + xi * xi, mel) + cfg.epsilon)


def emulate_dft_log_mel(sig: np.ndarray, cfg) -> torch.Tensor:
    """log_mel_dft_kernel in torch f32: the direct DFT against the windowed bases, the sparse mel stage."""
    cos_b, sin_b = (torch.tensor(a) for a in fek._dft_bases(cfg.frame_length, cfg.fft_length))
    fr = _frames(sig, cfg)
    power = (fr @ cos_b) ** 2 + (fr @ sin_b) ** 2
    mel = frontend.linear_to_mel_weight_matrix(cfg.num_feature_bins, cos_b.shape[1], cfg.sample_rate, cfg.lower_edge_hertz, cfg.upper_edge_hertz)
    return torch.log(_mel_sparse(power, mel) + cfg.epsilon)


def log_mel_float64(sig: np.ndarray, cfg) -> np.ndarray:
    """The function in float64: numpy rfft of the windowed pad_end frames, the dense mel product, log."""
    fr = _frames(sig, cfg, torch.float64).numpy()
    n = np.arange(cfg.frame_length)
    window = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / cfg.frame_length)
    power = np.abs(np.fft.rfft(fr * window, n=cfg.fft_length, axis=-1)) ** 2
    mel = frontend.linear_to_mel_weight_matrix(cfg.num_feature_bins, power.shape[-1], cfg.sample_rate, cfg.lower_edge_hertz, cfg.upper_edge_hertz)
    return np.log(power @ mel.astype(np.float64) + cfg.epsilon)


def _signal(shape, seed):
    cfg = frontend.FrontendConfig()
    sig = torch.tensor((np.random.default_rng(seed).standard_normal(shape) * 0.1).astype(np.float32))
    return frontend.preemphasis_signal(sig, cfg).numpy()


@pytest.mark.parametrize("m", [128, 256, 512, 1024])
def test_fft_schedule_and_positions_match_numpy_in_float64(m):
    """The stage schedule and the output positions, run in float64 with a
    float64 twiddle table, are the DFT (numpy) to 1e-10 of the scale, and
    the positions are a permutation."""
    pos = fft_positions(m)
    assert sorted(pos.tolist()) == list(range(m))
    r = np.random.default_rng(m)
    z = r.standard_normal((3, m)) + 1j * r.standard_normal((3, m))
    ang = 2.0 * np.pi * np.arange(2 * m) / (2 * m)
    re, im = _dif_fft(torch.tensor(z.real), torch.tensor(z.imag), torch.tensor(np.cos(ang)), torch.tensor(-np.sin(ang)))
    got = re.numpy()[:, pos] + 1j * im.numpy()[:, pos]
    ref = np.fft.fft(z, axis=-1)
    assert np.abs(got - ref).max() <= 1e-10 * np.abs(ref).max()


@pytest.mark.parametrize("nmel,nbins", [(80, 257), (40, 257), (80, 129), (80, 513), (80, 1025), (80, 201)])
def test_mel_ranges_cover_every_nonzero(nmel, nbins):
    """The sparse filters rebuild linear_to_mel_weight_matrix exactly: every
    nonzero lies in its filter's range, and the ranges hold ~2 weights per
    bin (not nbins per filter)."""
    mel = frontend.linear_to_mel_weight_matrix(nmel, nbins, 16000)
    w, lo, off = fek.mel_ranges(mel)
    rebuilt = np.zeros_like(mel)
    for m in range(nmel):
        rebuilt[lo[m] : lo[m] + off[m + 1] - off[m], m] = w[off[m] : off[m + 1]]
        assert lo[m] + off[m + 1] - off[m] <= nbins
    np.testing.assert_array_equal(rebuilt, mel)
    assert off[-1] <= 2 * nbins + nmel and off[-1] == len(w)


FFT_CASES = {
    "nfft512_train": (dict(), (2, 4000)),
    "nfft512_ragged": (dict(), (1, 3123)),
    "nfft512_short": (dict(), (2, 300)),
    "nfft1024": (dict(nfft=1024), (1, 3123)),
    "nfft256": (dict(nfft=256, frame_ms=15), (2, 2000)),
}


@pytest.mark.parametrize("case", sorted(FFT_CASES))
def test_fft_log_mel_emulation_matches_float64_and_jax(case):
    """The FFT kernel's schedule in f32 against float64 (1e-4 in log-mel,
    and no farther in rms than twice the plain rfft chain) and against
    JAX's v1 and v2 kernels in interpret mode (1e-3): nfft 512 (radix-4
    only), 1024 and 256 (a radix-2 stage first); N not a multiple of the
    stride, and N below one frame."""
    kw, shape = FFT_CASES[case]
    cfg = frontend.FrontendConfig(**kw)
    assert fek.uses_fft(cfg.fft_length)
    sig = _signal(shape, SEED + len(case))
    got = emulate_fft_log_mel(sig, cfg)
    ref = log_mel_float64(sig, cfg)
    plain = fek.log_mel_spectrogram_plain(torch.tensor(sig), cfg).double().numpy()
    err = np.abs(got.double().numpy() - ref)
    assert got.shape == (shape[0], cfg.get_nframes(shape[1]), cfg.num_feature_bins)
    assert err.max() <= 1e-4, err.max()
    assert np.sqrt((err ** 2).mean()) <= 2 * np.sqrt(((plain - ref) ** 2).mean()) + 1e-7

    import jax.numpy as jnp

    from tensorflowasr_tpu.ops import frontend as jfrontend
    from tensorflowasr_tpu.ops.pallas import frontend_kernel as jfk

    jcfg = jfrontend.FrontendConfig(**kw)
    for fn in (jfk.log_mel_spectrogram_pallas, jfk.log_mel_spectrogram_pallas_v2):
        np.testing.assert_allclose(got.numpy(), np.asarray(fn(jnp.asarray(sig), jcfg, interpret=True)), rtol=0, atol=LOG_TOL)


@pytest.mark.parametrize("shape", [(2, 4000), (1, 3123)])
def test_dft_choice_emulation_matches_float64_and_jax(shape):
    """nfft = None (400 points, not a power of two) takes the direct-DFT
    kernel; its arithmetic with the sparse mel stage against float64 and
    JAX's v1 and v2 kernels in interpret mode."""
    cfg = frontend.FrontendConfig(nfft=None)
    assert cfg.fft_length == 400 and not fek.uses_fft(cfg.fft_length)
    sig = _signal(shape, SEED + 40)
    got = emulate_dft_log_mel(sig, cfg)
    assert np.abs(got.double().numpy() - log_mel_float64(sig, cfg)).max() <= LOG_TOL

    import jax.numpy as jnp

    from tensorflowasr_tpu.ops import frontend as jfrontend
    from tensorflowasr_tpu.ops.pallas import frontend_kernel as jfk

    for fn in (jfk.log_mel_spectrogram_pallas, jfk.log_mel_spectrogram_pallas_v2):
        np.testing.assert_allclose(got.numpy(), np.asarray(fn(jnp.asarray(sig), jfrontend.FrontendConfig(nfft=None), interpret=True)), rtol=0,
                                   atol=LOG_TOL)


def test_kernel_choice_is_by_nfft():
    """Power-of-two nfft from 256 to 2048 take the FFT kernel, every other nfft the direct DFT."""
    assert [n for n in range(200, 4200) if fek.uses_fft(n)] == [256, 512, 1024, 2048]
    for n in fek.FFT_SIZES:  # each twiddle is its float64 value rounded once to f32
        exact = np.exp(-2j * np.pi * np.arange(n) / n)
        tw = fek.twiddles(n).astype(np.float64)
        assert np.abs(tw[:, 0] - exact.real).max() <= 2.0 ** -25 and np.abs(tw[:, 1] - exact.imag).max() <= 2.0 ** -25


class _Reiterable:
    """An iterable that calls ``make()`` for each pass (each epoch)."""

    def __init__(self, make):
        self.make = make

    def __iter__(self):
        return self.make()


def test_fit_freezes_once_after_the_first_step(monkeypatch):
    """Trainer.fit runs gc.collect(); gc.freeze() once, between the first
    step and the drawing of the second batch (four steps, two epochs): the
    freeze count is unchanged when the first batch is drawn and has grown
    when the second is; gc.freeze is called once in all (later counts only
    fall, as frozen objects die)."""
    from tensorflowasr_tpu_torch import schemas
    from tensorflowasr_tpu_torch.models.transducer.conformer import Conformer
    from tensorflowasr_tpu_torch.training.trainer import Trainer
    from tests.test_torch_slice import TINY_CFG

    model = Conformer.from_config(TINY_CFG, device="cpu")
    model.reset_parameters(torch.Generator().manual_seed(8))
    trainer = Trainer(model, {"class_name": "Adam", "config": {"learning_rate": 1e-3}}, device="cpu")
    r = np.random.default_rng(9)
    audio = torch.tensor((r.standard_normal((2, 4000)) * 0.1).astype(np.float32))
    labels = torch.tensor(r.integers(1, model.vocab_size, (2, 3)))
    preds = torch.cat([torch.zeros((2, 1), dtype=torch.int64), labels], 1)
    batch = schemas.TrainData(schemas.TrainInput(audio, torch.tensor([4000, 3000]), preds, torch.tensor([4, 3])),
                              schemas.TrainLabel(labels, torch.tensor([3, 2])))
    seen = []

    def data():
        for _ in range(2):
            seen.append(gc.get_freeze_count())
            yield batch

    calls, freeze = [], gc.freeze
    monkeypatch.setattr(gc, "freeze", lambda: (calls.append(len(seen)), freeze()))
    start = gc.get_freeze_count()
    try:
        state = trainer.fit(trainer.init_state(seed=1), _Reiterable(data), epochs=2)
        assert state.step == 4 and len(seen) == 4
        assert calls == [1]
        assert seen[0] == start and seen[1] > start and max(seen[2:]) <= seen[1]
    finally:
        gc.unfreeze()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_conv_back_and_frontend_take_the_plain_versions(dtype):
    """On CPU tensors conv_back (with autograd) and the frontend equal their
    plain versions bit for bit and launch no kernel (no library is built)."""
    before = tuple(launches[n] for n in ("kernel.conv_back.fwd", "kernel.conv_back.bwd", "kernel.frontend", "kernel.frontend.dft"))
    y1, dout, mean, var, scale, bias, w2, b2 = _conv_back_inputs(SEED + 2, 2, 7, 24)
    x = torch.tensor(_conv_back_inputs(SEED + 3, 2, 7, 24)[0]).to(dtype).requires_grad_(True)
    leaves = [torch.tensor(y1).to(dtype)] + [torch.tensor(a) for a in (mean, var, scale, bias)] + [torch.tensor(a).to(dtype) for a in (w2, b2)]
    leaves = [p.requires_grad_(True) for p in leaves]
    out = ck.conv_back(x, *leaves, 5, 0.1, 0.5)
    out.backward(torch.tensor(dout).to(dtype))
    plain = [p.detach() for p in leaves]
    assert torch.equal(out.detach(), ck.conv_back_plain(x.detach(), *plain, 5, 0.1, 0.5))
    ref = ck.conv_back_plain_bwd(*plain[:6], torch.tensor(dout).to(dtype), 5, 0.1, 0.5)
    assert torch.equal(x.grad, torch.tensor(dout).to(dtype))
    for g, r in zip([p.grad for p in leaves[:6]] + [leaves[6].grad], ref):
        assert torch.equal(g, r)
    for kw in (dict(), dict(nfft=None)):
        cfg = frontend.FrontendConfig(**kw)
        sig = torch.tensor(_signal((1, 3200), SEED + 4))
        assert torch.equal(fek.log_mel_spectrogram_pallas(sig, cfg), fek.log_mel_spectrogram_plain(sig, cfg))
    assert tuple(launches[n] for n in ("kernel.conv_back.fwd", "kernel.conv_back.bwd", "kernel.frontend", "kernel.frontend.dft")) == before
    assert _build._lib is None
