"""What the tensor-core kernels of kernel B (``csrc/rel_attention_mma.cu``)
and the fused FF (``csrc/ff_mma.cu``) compute in Python, on the CPU, with
JAX as the reference where it has the function.

Kernel B reads its relative term from a [16 × 80] band product per warp and
key tile, at a skewed column, and scatters ds back through the same band
(dqp) or gathers it along the diagonals (dpos); the emulations here walk
the kernels' blocks, warps and tiles with the kernels' index maps. The FF
kernels' shared-memory plan, the weight gradients' fixed row split and
their bf16 high/low split product are checked as planned. The wrappers'
CPU dispatch takes the plain versions and launches nothing.

Tolerances: the band and the plain term sum the same f32 products over D in
another order (1e-5); JAX's barrel shift moves the same f32 products
(1e-5). The split product keeps ~2⁻¹⁶ of each operand: 1e-5 of the sum's
scale; one bf16 pass misses by ~2⁻⁹.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from tensorflowasr_tpu.ops.pallas import attention_kernel as jak
from tensorflowasr_tpu_torch.ops.cuda import attention_kernel as ak
from tensorflowasr_tpu_torch.ops.cuda import ff_kernel as fk
from tensorflowasr_tpu_torch.utils.tracing import launches

SEED = 808
KT, BLOCK, WIN, BAND = 64, 64, 128, 80  # csrc/rel_attention_mma.cu: key tile, rows per block, pos window, band columns


# The kernels' index maps, as csrc/rel_attention_mma.cu (rb_window_base, rb_band_col, rb_dpos_rows) and csrc/ff_mma.cu
# (fm_splits, fm_rows_per_split) compute them; the card holds the library's own maps against the plain index and the
# row split's invariants (tests/test_torch_cuda.py).
def _window_base(j: int, i0: int, t: int, extra: int) -> int:
    """First pos row of the 128-row window a block of query rows i0..i0+63 stages for key tile j."""
    return j * KT + (t - 1 - (i0 + BLOCK - 1)) + extra


def _band_column(i: int, s: int) -> int:
    """The column of a warp's [16 × 80] band at which query row i reads key s:
    (s − s0) + 15 − (i − i0) for the warp's first row i0 and the tile's first key s0."""
    return (s % KT) + 15 - (i % 16)


def _dpos_rows(p0: int, t: int, s: int, extra: int) -> range:
    """The query rows whose relative positions reach p0..p0+63 at some key in [0, S): the rows a dpos block walks."""
    return range(max(0, t - 1 + extra - (p0 + BLOCK - 1)), min(t, t - 1 + extra - p0 + s))


def _weight_grad_splits(n: int, m: int, k: int) -> int:
    """The fixed row split of the weight-gradient product [M, K] over N rows:
    about two 64 × 64 output tiles per SM, at least 256 rows per split."""
    tiles = -(-m // 64) * -(-k // 64)
    return max(1, min(-(-264 // tiles), -(-n // 256)))


def _split_rows(n: int, splits: int) -> list[range]:
    """The rows each split sums, in order: ceil(n / splits) rounded up to the 32-row stage."""
    per = -(-(-(-n // splits)) // 32) * 32
    return [range(i * per, min(n, (i + 1) * per)) for i in range(splits)]

# (name, T, S, R, pe_causal): the non-causal encoder (R = 2T − 1), causal relative PE (R = M + T) and a KV
# memory of M = 20 frames (S = M + T), T not a multiple of 16
CASES = [("noncausal", 70, 70, 139, False), ("pe_causal_memory", 37, 57, 57, True), ("memory", 37, 57, 93, False), ("long", 150, 150, 299, False)]


def _inputs(t, s, r, d=12, bh=3, seed=SEED):
    rng = np.random.default_rng(seed + t + r)
    return (rng.standard_normal((bh, t, d)).astype(np.float32), rng.standard_normal((bh, r, d)).astype(np.float32),
            rng.standard_normal((bh, t, s)).astype(np.float32))


def _extra(t, s, r, pe_causal):
    return (r - s) if pe_causal else (r - t + 1 - s)


def _plain_rel(qp, pos, t, s, r, pe_causal):
    """The port's plain relative term: ``_scores`` with the content and every mask off."""
    bh, _, d = qp.shape
    zq, zk = torch.zeros((bh, t, d)), torch.zeros((bh, s, d))
    scores, idx = ak._scores(zq, torch.tensor(qp), zk, torch.tensor(pos), None, None, False, None, None, pe_causal)
    return scores, idx


def _jax_rel(qp, pos, t, s, r, extra):
    """JAX ``_rel_scores`` (barrel shift ``_rel_shift``) in interpret mode, content and masks off."""
    bh, _, d = qp.shape
    rp = jak._lanes(r)
    posp = np.pad(pos, ((0, 0), (0, rp - r), (0, 0)))

    def kern(qc_ref, qp_ref, k_ref, pos_ref, o_ref):
        o_ref[0] = jak._rel_scores(qc_ref, qp_ref, k_ref, pos_ref, None, None, t=t, s_true=s, r_true=r, extra=extra, causal=False, chunk_size=None,
                                   history_size=None)

    spec = lambda n, m: pl.BlockSpec((1, n, m), lambda i: (i, 0, 0))
    out = pl.pallas_call(kern, grid=(bh,), in_specs=[spec(t, d), spec(t, d), spec(s, d), spec(rp, d)], out_specs=spec(t, s),
                         out_shape=jax.ShapeDtypeStruct((bh, t, s), jnp.float32), interpret=True)(
        jnp.zeros((bh, t, d)), jnp.asarray(qp), jnp.zeros((bh, s, d)), jnp.asarray(posp))
    return np.asarray(out)


def _tiles(t, s, r, extra):
    """Every (warp rows, key tile keys, the warp's 80 pos rows with their validity) the bf16 kernels visit."""
    for i0 in range(0, t, BLOCK):
        for j in range(-(-s // KT)):
            base = _window_base(j, i0, t, extra)
            for w in range(4):
                rows = torch.arange(i0 + 16 * w, i0 + 16 * w + 16)
                p = base + (3 - w) * 16 + torch.arange(BAND)
                keys = torch.arange(j * KT, min(s, (j + 1) * KT))
                yield rows, keys, p, (p >= 0) & (p < r)


def _band_rel(qp, pos, t, s, r, extra):
    """The forward's relative term assembled from the bands as the kernel reads them."""
    qp, pos = torch.tensor(qp), torch.tensor(pos)
    bh = qp.shape[0]
    out = torch.full((bh, t, s), float("nan"))
    for rows, keys, p, ok in _tiles(t, s, r, extra):
        qpw = torch.where((rows < t)[None, :, None], qp[:, rows.clamp(max=t - 1)], 0.0)
        posw = torch.where(ok[None, :, None], pos[:, p.clamp(0, r - 1)], 0.0)
        band = qpw @ posw.transpose(1, 2)  # [bh, 16, 80]
        for il, i in enumerate(rows.tolist()):
            if i < t:
                cols = torch.tensor([_band_column(i, sk) for sk in keys.tolist()])
                assert int(cols.min()) >= 0 and int(cols.max()) < BAND
                out[:, i, keys] = band[:, il, cols]
    return out


@pytest.mark.parametrize("name,t,s,r,pe_causal", CASES)
def test_band_reads_the_plain_relative_term(name, t, s, r, pe_causal):
    """Every relative term the kernel reads from its skewed band equals the
    port's plain ``_scores`` term, itself equal to JAX ``_rel_scores``."""
    qp, pos, _ = _inputs(t, s, r)
    extra = _extra(t, s, r, pe_causal)
    plain, _ = _plain_rel(qp, pos, t, s, r, pe_causal)
    band = _band_rel(qp, pos, t, s, r, extra)
    assert not torch.isnan(band).any()
    np.testing.assert_allclose(band.numpy(), plain.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(plain.numpy(), _jax_rel(qp, pos, t, s, r, extra), rtol=1e-5, atol=1e-5)


def _plain_dw(ds, idx, r):
    """The plain backward's reverse shift (``fused_rel_attention_plain_bwd``): dW[i, idx[i, s]] += ds[i, s] where idx < R."""
    bh, t, s = ds.shape
    dw = torch.zeros((bh, t, r))
    dw.scatter_add_(2, idx.clamp(max=r - 1).expand(bh, t, s), torch.where(idx < r, ds, torch.zeros(())))
    return dw


@pytest.mark.parametrize("name,t,s,r,pe_causal", CASES)
def test_band_scatter_gives_the_plain_dqp(name, t, s, r, pe_causal):
    """dqp as the dq pass forms it: ds scattered into each warp's band at the
    skewed column, times the warp's pos window; against dW·pos of the plain scatter."""
    qp, pos, ds = _inputs(t, s, r)
    extra = _extra(t, s, r, pe_causal)
    _, idx = _plain_rel(qp, pos, t, s, r, pe_causal)
    ds, pos_t = torch.tensor(ds), torch.tensor(pos)
    want = _plain_dw(ds, idx, r) @ pos_t
    got = torch.zeros_like(want)
    for rows, keys, p, ok in _tiles(t, s, r, extra):
        band = torch.zeros((ds.shape[0], 16, BAND))
        for il, i in enumerate(rows.tolist()):
            if i < t:
                band[:, il, [_band_column(i, sk) for sk in keys.tolist()]] = ds[:, i, keys]
        contrib = band @ torch.where(ok[None, :, None], pos_t[:, p.clamp(0, r - 1)], 0.0)
        valid = rows < t
        got[:, rows[valid]] += contrib[:, valid]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name,t,s,r,pe_causal", CASES)
def test_diagonal_gather_gives_the_plain_dpos(name, t, s, r, pe_causal):
    """dpos as the dpos pass forms it: per block of 64 positions, ds gathered
    along the diagonals over the query rows ``_dpos_rows`` names (in
    32-row tiles from the one holding its first row), times qp; against
    dWᵀ·qp of the plain scatter. The rows it skips hold no term of those positions."""
    qp, pos, ds = _inputs(t, s, r)
    extra = _extra(t, s, r, pe_causal)
    _, idx = _plain_rel(qp, pos, t, s, r, pe_causal)
    ds, qp_t = torch.tensor(ds), torch.tensor(qp)
    dw = _plain_dw(ds, idx, r)
    want = dw.transpose(1, 2) @ qp_t
    got = torch.zeros_like(want)
    for p0 in range(0, r, BLOCK):
        rows = _dpos_rows(p0, t, s, extra)
        p = torch.arange(p0, min(r, p0 + BLOCK))
        outside = [i for i in range(t) if i not in rows]
        assert not dw[:, outside][:, :, p].any(), "a skipped row holds a term of these positions"
        for q0 in range(rows.start // 32 * 32, rows.stop, 32):
            i = torch.arange(q0, min(t, q0 + 32))
            sk = p[None, :] - (t - 1 - i[:, None]) - extra  # [rows, positions]
            ok = (sk >= 0) & (sk < s)
            g = torch.where(ok[None], torch.gather(ds[:, i], 2, sk.clamp(0, s - 1)[None].expand(ds.shape[0], -1, -1)), 0.0)
            got[:, p] += g.transpose(1, 2) @ qp_t[:, i]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


# ------------------------------------------- the FF kernels -------------------------------------------- #


@pytest.mark.parametrize("fwd_rows", fk.FWD_ROWS)
@pytest.mark.parametrize("d,f", [(144, 576), (176, 704), (256, 1024), (40, 136), (16, 64)])
def test_ff_plan_fits_the_card(d, f, fwd_rows):
    plan = fk.ff_mma_plan(d, f, fwd_rows)
    assert plan.padded_d % 16 == 0 and plan.padded_d - d < 16
    assert plan.chunks * plan.chunk >= f and plan.fwd_rows == fwd_rows
    for b, blocks in ((plan.fwd_smem_bytes, plan.fwd_blocks_per_sm), (plan.bwd_smem_bytes, plan.bwd_blocks_per_sm)):
        assert 0 < b <= fk.MAX_BLOCK_SHARED_BYTES and blocks >= 1
        assert blocks * (b + fk.BLOCK_RESERVED_BYTES) <= fk.SM_SHARED_BYTES
    if fwd_rows < plan.rows:  # a smaller forward tile fits at least as many blocks
        assert plan.fwd_blocks_per_sm >= fk.ff_mma_plan(d, f).fwd_blocks_per_sm


@pytest.mark.parametrize("n,wave,want", [(2000, 264, 32), (6400, 264, 32), (6400, 132, 64), (8448, 264, 32), (8449, 264, 64), (4, 132, 32),
                                         (2000, 16, 64)])
def test_ff_forward_row_tile_follows_the_wave(n, wave, want):
    """The forward takes 32 rows a block where that grid runs in one wave on the card, else 64."""
    rows = fk.ff_fwd_rows(n, wave)
    assert rows == want and rows in fk.FWD_ROWS
    assert (-(-n // 32) <= wave) == (rows == 32)
    with pytest.raises(ValueError, match="rows a block"):
        fk.ff_mma_plan(144, 576, 16)


def test_ff_backward_has_no_occupancy_cliff_at_conformer_ctc_width():
    """The backward takes at least as many blocks per SM at D 176 as at D 144,
    and at N 6400 both grids fit on the card in one wave."""
    flagship, ctc = fk.ff_mma_plan(144, 576), fk.ff_mma_plan(176, 704)
    assert ctc.bwd_blocks_per_sm >= flagship.bwd_blocks_per_sm
    for plan in (flagship, ctc):
        assert -(-6400 // plan.rows) <= fk.SMS * min(plan.fwd_blocks_per_sm, plan.bwd_blocks_per_sm)


@pytest.mark.parametrize("d,f", [(512, 2048), (500, 1000), (264, 1056), (257, 64)])
def test_wide_ff_backward_plan_fits_the_card(d, f):
    """The wide backward's rows pass (csrc/ff_mma.cu, on wgmma): the larger of
    its two rings of 3 stages (the products pass's [128][64] tiles of y, dz,
    W1ᵀ and W2 with its two [64][128] staging tiles; the dy pass's dh [64][64]
    and W1 [512][64]), each behind 1,024 bytes of alignment slack with two
    barriers a stage, fits a block's shared memory, one block of 384 threads
    per SM of 64-row dy blocks; a function of the padded width's range only."""
    plan = fk.ff_mma_plan(d, f)
    assert plan.padded_d > fk.NARROW_D and (plan.threads, plan.rows) == (384, 64)
    products = 1024 + 3 * 4 * 128 * 64 * 2 + 2 * 64 * 128 * 2 + 2 * 3 * 8
    dy = 1024 + 3 * (64 + 512) * 64 * 2 + 2 * 3 * 8
    assert plan.bwd_smem_bytes == max(products, dy) == products == 230448
    assert plan.bwd_smem_bytes <= fk.MAX_BLOCK_SHARED_BYTES == 232448
    assert plan.bwd_blocks_per_sm == 1


@pytest.mark.parametrize("n,m,k", [(6400, 144, 576), (6400, 576, 144), (6400, 176, 704), (37, 16, 64), (5, 144, 100), (300, 40, 136)])
def test_weight_gradient_split_is_fixed_and_covers_every_row_once(n, m, k):
    splits = _weight_grad_splits(n, m, k)
    assert splits == _weight_grad_splits(n, m, k) >= 1
    parts = _split_rows(n, splits)
    assert len(parts) == splits
    assert [i for r in parts for i in r] == list(range(n))  # in order, each row once
    assert all(len(r) % 32 == 0 for r in parts[:-1])  # whole 32-row stages
    tiles = -(-m // 64) * -(-k // 64)
    assert splits == 1 or tiles * splits <= 264 + tiles  # about two output tiles per SM


def _split(x: torch.Tensor):
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


@pytest.mark.parametrize("n,m,k", [(6400, 144, 576), (640, 176, 64)])
def test_split_bf16_product_keeps_f32_accuracy(n, m, k):
    """Aᵀ·B from bf16 hi + lo parts (hi·hi + hi·lo + lo·hi, exact bf16
    products accumulated in f32, in the kernel's row split) against float64:
    within f32 accumulation's reach (1e-5 of the sum's scale; the card
    measures it against the plain f32 product); a single bf16 pass is 30×
    farther."""
    rng = np.random.default_rng(SEED + n)
    a64, b64 = rng.standard_normal((n, m)), rng.standard_normal((n, k)) * 0.1
    a, b = torch.tensor(a64, dtype=torch.float32), torch.tensor(b64, dtype=torch.float32)
    ref = torch.tensor(a64.T @ b64)
    (ah, al), (bh, bl) = _split(a), _split(b)
    got = torch.zeros((m, k))
    for rows in _split_rows(n, _weight_grad_splits(n, m, k)):
        i = torch.tensor(list(rows))
        got += ah[i].t() @ bh[i] + ah[i].t() @ bl[i] + al[i].t() @ bh[i]
    scale = ref.abs().max().item()
    err = got.double().sub(ref).abs().max().item()
    assert err <= 1e-5 * scale, (err, scale)
    one_pass = (ah.t() @ bh).double().sub(ref).abs().max().item()
    assert one_pass > 30 * err


# ------------------------------------------- CPU dispatch -------------------------------------------- #


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_rel_attention_and_ff_take_the_plain_versions(dtype):
    """On CPU tensors ``fused_rel_attention`` and ``fused_ff`` are the plain
    forward and backward, bit for bit, and launch nothing."""
    rng = np.random.default_rng(SEED + 5)
    f = lambda *shape: torch.tensor(rng.standard_normal(shape).astype(np.float32)).to(dtype)
    t, d = 9, 12
    att = [f(4, t, d), f(4, t, d), f(4, t, d), f(4, t, d), f(4, 2 * t - 1, d)]
    dout = f(4, t, d)
    before = tuple(launches[n] for n in ("kernel.rel_attention.fwd", "kernel.rel_attention.bwd", "kernel.ff.fwd", "kernel.ff.bwd"))
    leaves = [a.clone().requires_grad_(True) for a in att]
    out = ak.fused_rel_attention(*leaves, None, None, SEED, 0.1)
    out.backward(dout)
    assert torch.equal(out.detach(), ak.fused_rel_attention_plain(*att, None, None, SEED, 0.1))
    for got, want in zip((x.grad for x in leaves), ak.fused_rel_attention_plain_bwd(*att, None, None, dout, SEED, 0.1)):
        assert torch.equal(got, want)
    ff = [f(7, d), 1 + f(d).float() * 0.1, f(d).float() * 0.1, f(d, 20), f(20), f(20, d), f(d)]
    leaves = [a.clone().requires_grad_(True) for a in ff]
    out = fk.fused_ff(*leaves, SEED, 0.1)
    dout = f(7, d)
    out.backward(dout)
    assert torch.equal(out.detach(), fk.fused_ff_plain(*ff, SEED, 0.1))
    for got, want in zip((x.grad for x in leaves), fk.fused_ff_plain_bwd(*ff[:6], dout, SEED, 0.1)):
        assert torch.equal(got, want)
    assert tuple(launches[n] for n in ("kernel.rel_attention.fwd", "kernel.rel_attention.bwd", "kernel.ff.fwd", "kernel.ff.bwd")) == before
