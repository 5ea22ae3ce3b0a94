"""What the tensor-core kernels of the fused joint + RNN-T loss
(``csrc/joint_loss_mma.cu``) and of ``conv_front`` (``csrc/conv_mma.cu``)
compute in Python, on the CPU, with JAX as the reference where it has the
function.

The joint kernels walk 64-cell tiles of 8 frames × 8 label positions: the
forward one tile a block, the rows pass 8 frames a block over all their
label-position tiles, the weight pass a fixed interleaved set of tiles per
vocabulary chunk. Here the tile map and the weight pass's split are walked
to show that every lattice cell is covered once; the forward's register
row statistics (online max and sum of exp per thread, quad butterflies, the
two warps of a row group merged at the end) are emulated in the kernel's
order against a float64 log-sum-exp and JAX's kernel in interpret mode; the
da product's split of dlog into bf16 terms is emulated against float64; and
the backward's skipping of tiles whose gbl and gem are all zero is shown to
be exact. conv_front's shared-memory plan is checked, its forward's
32-row tiles are walked to show that every output element is written once,
and its column sums, taken per 16 rows and summed in order, are held
against JAX's backward. The wrappers' CPU dispatch takes the plain versions
and launches nothing.

The kernels' index maps and shared-memory plans are copied here (private to
this file); the card tests in ``tests/test_torch_cuda.py`` hold the
library's own layout (``tfasr_joint_mma_layout``), shared-memory counts and
occupancy against them. JAX is imported inside the two tests that use it,
so that those card tests can import this file on a machine without JAX.

Tolerances: the emulated statistics sum the same f32 exponentials as a
float64 log-sum-exp in another order (2e-6 relative); JAX's kernel forms
the same f32 logits in another order (1e-5). The split product keeps ~2⁻¹⁷
of each dlog with two terms (2e-5 of the product's scale), one term misses
by ~2⁻⁹. Column sums in another order: 1e-5 of each sum's scale.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tensorflowasr_tpu_torch.ops.cuda import _build
from tensorflowasr_tpu_torch.ops.cuda import conv_kernel as ck
from tensorflowasr_tpu_torch.ops.cuda import joint_loss_kernel as jk
from tensorflowasr_tpu_torch.utils.tracing import launches

SEED = 909
TILE_T, TILE_U, FWD_CHUNK, BWD_CHUNK, SMS = 8, 8, 32, 64, 132  # csrc/joint_loss_mma.cu
DA_TERMS = 2  # csrc/joint_loss_mma.cu JM_SPLITS: bf16 terms of dlog in the rows pass's da product
CONV_FWD_ROWS, CONV_BWD_ROWS, CONV_CC = 32, 64, 64  # csrc/conv_mma.cu: rows a block of the forward and backward, columns per weight chunk
PAD = 8  # shared-memory row padding of both (AM_PAD)
SM_SHARED_BYTES, BLOCK_RESERVED_BYTES, MAX_BLOCK_SHARED_BYTES = 228 * 1024, 1024, 227 * 1024  # H100 SXM


def _blocks_per_sm(smem: int, threads: int = 256) -> int:
    """Blocks per SM as shared memory and threads allow (the card's occupancy also counts registers)."""
    return min(SM_SHARED_BYTES // (smem + BLOCK_RESERVED_BYTES), 2048 // threads)


@dataclasses.dataclass(frozen=True)
class JointPlan:
    """The joint's bf16 tensor-core kernels' tile and dynamic shared memory at one joint width."""

    tile: tuple[int, int]  # (frames, label positions) of a 64-cell tile
    padded_j: int  # J rounded up to 16 in shared memory
    fwd_smem_bytes: int  # the tile's a, two 32-row Wv chunks (the second holds the tile's 16 input rows first), the row statistics of a warp pair
    rows_smem_bytes: int  # a, two 64-row Wv chunks, the tile's 16 input rows, the 16 warps' dlog fragments, d_enc_p of 8 frames
    weight_smem_bytes: int  # the block's 64-row Wv chunk, a, the tile's 16 input rows, dlog [64][72] bf16, dbv of 4 row groups
    fwd_blocks_per_sm: int
    rows_blocks_per_sm: int
    weight_blocks_per_sm: int
    fwd_resident_vocab: int  # Wv rows the forward keeps resident at this V (64, 128 or 256), 0: the streaming forward runs
    fwd_resident_smem_bytes: int  # Wv, the tile's a and input rows, the row statistics; 0 where it does not fit


def _joint_plan(j: int, v: int = 256) -> JointPlan:
    """Tile and dynamic shared memory of csrc/joint_loss_mma.cu at joint
    width J and vocabulary V (jm_fwd_smem, jm_rows_smem, jm_weight_smem,
    jm_fwd_res_smem, jm_fwd_resident). The forward keeps Wv resident in a
    persistent grid where its rows, rounded up to 64, 128 or 256, fit beside
    the tile, else it streams Wv in 32-row chunks."""
    jp = -(-j // 16) * 16
    lda = jp + PAD
    rows = TILE_T * TILE_U
    fwd = 2 * (rows + 2 * FWD_CHUNK) * lda + 4 * rows * 4
    bwd_rows = 2 * (rows + 2 * BWD_CHUNK + 2 * TILE_T) * lda + 4 * 16 * DA_TERMS * 4 * 32 + 4 * TILE_T * jp
    weight = 2 * (BWD_CHUNK + rows + 2 * TILE_T) * lda + 2 * rows * (BWD_CHUNK + PAD) + 4 * 4 * BWD_CHUNK
    vp = next((n for n in (64, 128, 256) if v <= n), 0)
    resident = 2 * (vp + rows + 2 * TILE_T) * lda + 3 * 4 * rows * 4 if vp else 0
    if resident > MAX_BLOCK_SHARED_BYTES:
        vp, resident = 0, 0
    return JointPlan((TILE_T, TILE_U), jp, fwd, bwd_rows, weight, _blocks_per_sm(fwd), _blocks_per_sm(bwd_rows, 512), _blocks_per_sm(weight), vp, resident)


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """conv_front's bf16 tensor-core kernels' shared memory at one width."""

    padded_d: int  # D rounded up to 16 in shared memory
    chunks: int  # 64-column chunks of Wa and Wb
    fwd_smem_bytes: int  # the LN output [32][Dp + 8] and two chunks each of Wa and Wb [Dp][72], bf16
    bwd_smem_bytes: int  # the same at 64 rows, and the rows' mean and rstd in f32
    fwd_blocks_per_sm: int
    bwd_blocks_per_sm: int


def _conv_plan(d: int) -> ConvPlan:
    """Shared memory of csrc/conv_mma.cu at width D (cm_fwd_smem, cm_bwd_smem)."""
    dp = -(-d // 16) * 16
    weights = 4 * dp * (CONV_CC + PAD)
    fwd = 2 * (CONV_FWD_ROWS * (dp + PAD) + weights)
    bwd = 2 * (CONV_BWD_ROWS * (dp + PAD) + weights) + 4 * 2 * CONV_BWD_ROWS
    return ConvPlan(dp, -(-d // CONV_CC), fwd, bwd, _blocks_per_sm(fwd), _blocks_per_sm(bwd))


# The joint kernels' maps, as csrc/joint_loss_mma.cu computes them (jm_args, jm_build_a's row map, jm_ranges).
def _tiles(t: int, u1: int) -> tuple[int, int]:
    """Frame tiles and label-position tiles per utterance."""
    return -(-t // TILE_T), -(-u1 // TILE_U)


def _tile_cells(t0: int, u0: int, t: int, u1: int) -> list[tuple[int, int]]:
    """The lattice cells (frame, label position) of a tile's 64 rows, row i at
    (t0 + i // 8, u0 + i % 8); rows outside [T, U+1] hold no cell."""
    cells = [(t0 + i // TILE_U, u0 + i % TILE_U) for i in range(TILE_T * TILE_U)]
    return [(ti, ui) for ti, ui in cells if ti < t and ui < u1]


def _weight_blocks_per_sm(j: int) -> int:
    """Blocks per SM the weight pass is built for: two where its register tile fits 128 registers (J <= 320)."""
    return 2 if -(-j // 16) <= 20 else 1


def _weight_ranges(b: int, t: int, u1: int, j: int, v: int) -> int:
    """The weight pass's fixed split: about the blocks the SMs hold at once, over the 64-row vocabulary chunks."""
    n_tt, n_ut = _tiles(t, u1)
    return max(1, min(b * n_tt * n_ut, SMS * _weight_blocks_per_sm(j) // -(-v // BWD_CHUNK)))


SHAPES = [(16, 400, 129), (3, 13, 7), (2, 37, 51), (1, 1, 1), (5, 9, 17), (2, 8, 8)]


@pytest.mark.parametrize("b,t,u1", SHAPES)
def test_cell_tiles_cover_every_cell_once(b, t, u1):
    """The forward's grid (one tile a block) and the rows pass's (8 frames a
    block, every label-position tile in turn) each cover every lattice cell
    of a ragged [B, T, U+1] exactly once, with U+1 off the tile; the rows
    pass owns each frame's d_enc_p in one block and writes d_pred_p's
    partial t // 8."""
    n_tt, n_ut = _tiles(t, u1)
    fwd = np.zeros((b, t, u1), np.int64)
    for bi in range(b):
        for blk in range(n_tt * n_ut):  # jm_fwd: blockIdx.x = tt * n_ut + ut
            for ti, ui in _tile_cells((blk // n_ut) * TILE_T, (blk % n_ut) * TILE_U, t, u1):
                fwd[bi, ti, ui] += 1
    assert (fwd == 1).all()
    rows, owner = np.zeros((b, t, u1), np.int64), np.full((b, t), -1)
    for bi in range(b):
        for tt in range(n_tt):  # jm_bwd_rows: grid (n_tt, B)
            for ut in range(n_ut):
                for ti, ui in _tile_cells(tt * TILE_T, ut * TILE_U, t, u1):
                    rows[bi, ti, ui] += 1
                    assert owner[bi, ti] in (-1, tt) and ti // TILE_T == tt
                    owner[bi, ti] = tt
    assert (rows == 1).all() and (owner >= 0).all()


@pytest.mark.parametrize("j", [320, 384])
@pytest.mark.parametrize("b,t,u1,v", [(16, 400, 129, 256), (16, 400, 129, 1000), (3, 13, 7, 20), (1, 1, 1, 5), (2, 37, 51, 70)])
def test_weight_pass_split_covers_every_tile_once(b, t, u1, j, v):
    """Range r of the weight pass takes tiles r, r + ranges, ...: every tile
    once per vocabulary chunk, about as many blocks as the SMs hold at once
    (two per SM at J 320, one at J 384), a function of the shapes only."""
    n_tt, n_ut = _tiles(t, u1)
    n_tiles, ranges, nv = b * n_tt * n_ut, _weight_ranges(b, t, u1, j, v), -(-v // BWD_CHUNK)
    slots = SMS * _weight_blocks_per_sm(j)
    seen = np.zeros(n_tiles, np.int64)
    for r in range(ranges):
        seen[list(range(r, n_tiles, ranges))] += 1
    assert (seen == 1).all()
    assert nv * ranges <= max(slots, nv)
    if n_tiles >= slots:
        assert nv * ranges > slots - nv  # no more than one vocabulary chunk's worth of block slots left idle


RESIDENT = {(320, 256): 256, (384, 256): 0, (320, 1000): 0, (384, 1000): 0, (16, 20): 64, (40, 70): 128, (8, 5): 64, (256, 256): 256, (128, 64): 64,
            (320, 128): 128, (200, 300): 0, (384, 64): 64, (64, 1000): 0, (96, 33): 64}


@pytest.mark.parametrize("j,v", sorted(RESIDENT))
def test_joint_plan_fits_the_card(j, v):
    """The kernels' shared memory fits a block at every J <= 384; the
    backward's and the streaming forward's do not grow with V: Wv streams in
    chunks (at V 1000 it is 640 KB, more than a block's shared memory); the
    streaming forward fits two blocks per SM."""
    plan = _joint_plan(j, v)
    for name in ("fwd", "rows", "weight", "fwd_resident"):
        assert getattr(plan, f"{name}_smem_bytes") <= MAX_BLOCK_SHARED_BYTES, name
        assert name == "fwd_resident" or getattr(plan, f"{name}_blocks_per_sm") >= 1, name
    # Wv stays resident in the forward where its rows (rounded up to 64, 128, 256) fit beside the tile: V 256 at J 320, not at J 384 or V 1000
    assert plan.fwd_resident_vocab == RESIDENT[(j, v)]
    assert (plan.fwd_resident_smem_bytes > 0) == (plan.fwd_resident_vocab > 0)
    assert plan.fwd_blocks_per_sm >= 2 and plan.padded_j % 16 == 0 and plan.tile == (TILE_T, TILE_U)
    assert plan.rows_smem_bytes == _joint_plan(j, 1000).rows_smem_bytes and plan.weight_smem_bytes == _joint_plan(j, 1000).weight_smem_bytes
    if v == 1000 and j >= 320:
        assert v * j * 2 > MAX_BLOCK_SHARED_BYTES


def _joint_inputs(seed, b=2, t=11, u=9, j=16, v=70):
    r = np.random.default_rng(seed)
    enc_p = r.standard_normal((b, t, j)).astype(np.float32)
    pred_p = r.standard_normal((b, u + 1, j)).astype(np.float32)
    wv = (r.standard_normal((v, j)) * 1.5).astype(np.float32)
    bv = (r.standard_normal(v) * 0.5).astype(np.float32)
    labels = r.integers(1, v, (b, u)).astype(np.int32)
    return enc_p, pred_p, wv, bv, labels


def _emulated_row_stats(x: np.ndarray) -> np.ndarray:
    """The forward's log-sum-exp of one row of f32 logits [V], in the
    kernel's order: per 32-row chunk, warp vh of the row group takes
    columns 16 vh.., its lane tig the columns 8 nt + 2 tig + q (k = 2 nt +
    q in order); the quad's max, each lane's sum of exp in k order, the
    quad butterfly (xor 1, then xor 2), the running rescale; at the end the
    two warps merge."""
    f32 = np.float32
    v = x.shape[0]
    ms, ss = [], []
    for vh in range(2):
        m, s = f32(-3.0e38), f32(0.0)
        for c in range(-(-v // FWD_CHUNK)):
            cols = [[c * FWD_CHUNK + vh * 16 + (k >> 1) * 8 + 2 * tig + (k & 1) for k in range(4)] for tig in range(4)]
            vals = [[x[col] if col < v else None for col in lane] for lane in cols]
            cmax = max([f32(-3.0e38)] + [val for lane in vals for val in lane if val is not None])
            mn = max(m, cmax)
            ps = []
            for lane in vals:
                p = f32(0.0)
                for val in lane:
                    if val is not None:
                        p = f32(p + np.exp(f32(val - mn), dtype=f32))
                ps.append(p)
            quad = f32(f32(ps[0] + ps[1]) + f32(ps[2] + ps[3]))
            s = f32(f32(s * np.exp(f32(m - mn), dtype=f32)) + quad)
            m = mn
        ms.append(m)
        ss.append(s)
    mm = max(ms)
    sm = f32(f32(ss[0] * np.exp(f32(ms[0] - mm), dtype=f32)) + f32(ss[1] * np.exp(f32(ms[1] - mm), dtype=f32)))
    return f32(mm + np.log(sm, dtype=f32))


def _emulated_resident_stats(x: np.ndarray, vp: int) -> np.ndarray:
    """The same log-sum-exp in the order of the forward with Wv resident (vp
    rows): warp q of the row group takes columns vp / 4 · q.., its lane tig
    the columns 8 nt + 2 tig + e (nt < vp / 32, e in order); the quad's max
    and butterfly sum; the four warps merged in order."""
    f32 = np.float32
    v = x.shape[0]
    ms, ss = [], []
    for wq in range(4):
        lanes = [[x[c] for nt in range(vp // 32) for e in range(2) if (c := wq * vp // 4 + nt * 8 + 2 * tig + e) < v] for tig in range(4)]
        m = max([f32(-3.0e38)] + [val for lane in lanes for val in lane])
        ps = []
        for lane in lanes:
            p = f32(0.0)
            for val in lane:
                p = f32(p + np.exp(f32(val - m), dtype=f32))
            ps.append(p)
        ms.append(m)
        ss.append(f32(f32(ps[0] + ps[1]) + f32(ps[2] + ps[3])))
    mm = max(ms)
    sm = f32(ss[0] * np.exp(f32(ms[0] - mm), dtype=f32))
    for k in range(1, 4):
        sm = f32(sm + f32(ss[k] * np.exp(f32(ms[k] - mm), dtype=f32)))
    return f32(mm + np.log(sm, dtype=f32))


@pytest.mark.parametrize("kernel", ["streaming", "resident"])
@pytest.mark.parametrize("v", [70, 5, 256])
def test_row_statistics_merge_order_matches_float64(v, kernel):
    """The forward's register statistics, emulated in f32 in each forward
    kernel's order (Wv streamed in 32-row chunks with a running rescale, or
    resident), give the float64 log-sum-exp of the same f32 logits to 2e-6
    relative, and JAX's kernel (interpret mode) to 1e-5; so do its lp_blank
    and lp_emit."""
    enc_p, pred_p, wv, bv, labels = _joint_inputs(SEED + v, v=v)
    a = np.tanh(enc_p[:, :, None, :] + pred_p[:, None, :, :])
    logits = (a @ wv.T + bv).astype(np.float32)  # [B, T, U+1, V]
    import jax.numpy as jnp

    from tensorflowasr_tpu.ops.pallas import joint_loss_kernel as jjk

    vp = _joint_plan(16, v).fwd_resident_vocab
    stats = _emulated_row_stats if kernel == "streaming" else lambda x: _emulated_resident_stats(x, vp)
    got = np.vectorize(lambda *idx: stats(logits[idx]), otypes=[np.float32])(*np.indices(logits.shape[:3]))
    x64 = logits.astype(np.float64)
    mx = x64.max(-1, keepdims=True)
    ref64 = (mx + np.log(np.exp(x64 - mx).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(got, ref64, rtol=2e-6, atol=2e-6)
    jlpb, jlpe, jlse = jjk._joint_logprobs(jnp.asarray(enc_p), jnp.asarray(pred_p), jnp.asarray(wv.T), jnp.asarray(bv), jnp.asarray(labels), True)
    np.testing.assert_allclose(got, np.asarray(jlse), rtol=1e-5, atol=1e-5)
    u1 = pred_p.shape[1]
    lab = np.concatenate([labels, np.zeros((labels.shape[0], 1), np.int32)], 1)[:, None, :, None]
    lpe = np.take_along_axis(logits, lab, -1)[..., 0] - got
    np.testing.assert_allclose(logits[..., 0] - got, np.asarray(jlpb), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lpe[..., : u1 - 1], np.asarray(jlpe)[..., : u1 - 1], rtol=1e-5, atol=1e-5)


def _bf16_terms(x: torch.Tensor, n: int) -> list[torch.Tensor]:
    """x as n bf16 terms (each the rounding of what the earlier ones left), as f32."""
    terms, rest = [], x.clone()
    for _ in range(n):
        t = rest.to(torch.bfloat16).float()
        terms.append(t)
        rest = rest - t
    return terms


def test_da_split_terms_keep_f32_accuracy():
    """da = dlog · Wv with Wv bf16-exact and dlog split into bf16 terms, each
    term's product accumulated in f32 (as the tensor cores do), against
    float64: two terms (hi + lo) stay within 2e-5 of the product's scale and
    within 4× the plain f32 product's error; one term misses by ~2⁻⁹; three
    terms reach the f32 product's accuracy."""
    g = torch.Generator().manual_seed(SEED)
    rows, v, j = 512, 256, 320
    logits = torch.randn(rows, v, generator=g) * 3.0
    p = torch.softmax(logits, -1)
    gb, ge = -torch.rand(rows, 1, generator=g), -torch.rand(rows, 1, generator=g)
    lab = torch.randint(1, v, (rows, 1), generator=g)
    onehot = torch.zeros(rows, v).scatter_(1, lab, 1.0)
    dlog = torch.zeros(rows, v)
    dlog[:, :1] = gb
    dlog = dlog + onehot * ge - p * (gb + ge)
    wv = (torch.randn(v, j, generator=g) * j ** -0.5).to(torch.bfloat16).float()
    ref = dlog.double() @ wv.double()
    scale = ref.abs().max().item()
    err = {n: (sum(t @ wv for t in _bf16_terms(dlog, n)).double() - ref).abs().max().item() / scale for n in (1, 2, 3)}
    plain = ((dlog @ wv).double() - ref).abs().max().item() / scale
    assert err[1] > 1e-3
    assert err[2] < 2e-5 and err[2] < 4 * max(plain, 2 ** -20)
    assert err[3] < 2 * max(plain, 2 ** -24)


def test_backward_tile_skip_is_exact():
    """A tile whose cells all have gbl = gem = 0 (outside every row's
    lattice) has dlog = 0 exactly, so skipping it leaves every gradient sum
    unchanged; in a ragged batch such tiles are common."""
    b, t, u, j, v = 4, 29, 21, 16, 30
    enc_p, pred_p, wv, bv, labels = (torch.tensor(x) for x in _joint_inputs(SEED + 1, b, t, u, j, v))
    t_len, u_len = torch.tensor([29, 17, 9, 3]), torch.tensor([21, 12, 4, 0])
    _, lse, gbl, gem = jk.rnnt_loss_fused_joint_plain(enc_p, pred_p, wv, bv, t_len, labels, u_len)
    a = torch.tanh(enc_p[:, :, None, :] + pred_p[:, None, :, :])
    logits = a @ wv.t() + bv
    gsum = (gbl + gem)[..., None]
    vid = torch.arange(v)
    lab = torch.cat([labels, torch.full((b, 1), -1)], 1)[:, None, :, None]
    dlog = torch.where(vid == 0, gbl[..., None], 0.0) + torch.where(vid == lab, gem[..., None], 0.0) - torch.exp(logits - lse[..., None]) * gsum
    n_tt, n_ut = _tiles(t, u + 1)
    skipped = 0
    for bi in range(b):
        for tt in range(n_tt):
            for ut in range(n_ut):
                cells = _tile_cells(tt * TILE_T, ut * TILE_U, t, u + 1)
                if all(gbl[bi, ti, ui] == 0 and gem[bi, ti, ui] == 0 for ti, ui in cells):
                    skipped += 1
                    assert all((dlog[bi, ti, ui] == 0).all() for ti, ui in cells)
    assert skipped > b * n_tt * n_ut // 4


@pytest.mark.parametrize("d", [144, 176, 256, 100, 16, 8, 64, 128, 192, 200])
def test_conv_plan_fits_the_card(d):
    """conv_front's bf16 kernels fit a block at every D <= 256; at the
    flagship's and Conformer-CTC's widths the 32-row forward fits two
    blocks per SM by shared memory."""
    plan = _conv_plan(d)
    assert plan.fwd_smem_bytes <= MAX_BLOCK_SHARED_BYTES and plan.bwd_smem_bytes <= MAX_BLOCK_SHARED_BYTES
    assert plan.fwd_blocks_per_sm >= 1 and plan.bwd_blocks_per_sm >= 1 and plan.padded_d % 16 == 0
    assert plan.chunks == -(-d // 64)
    if d in (144, 176):
        assert plan.fwd_blocks_per_sm == 2


@pytest.mark.parametrize("d,n", [(144, 2000), (144, 6400), (176, 2000), (176, 6400), (256, 6400), (100, 37)])
def test_conv_forward_tiles_write_every_element_once(d, n):
    """cm_fwd's map: block k owns rows 32 k..; warp (rg, fq) of 2 x 4 the
    rows 16 rg + g and 16 rg + g + 8 of its block and the columns
    16 fq + 8 nt + 2 tig (+1) of each 64-column chunk. Over the grid every
    element of [N, D] is written exactly once, and no row past N or column
    past D (the serving N 2000 and training N 6400 at the Conformers'
    widths, the widest D and a ragged D and N)."""
    blocks, nch = -(-n // CONV_FWD_ROWS), -(-d // CONV_CC)
    rg, fq, nt, g, tig, hf, q = np.meshgrid(*(np.arange(k) for k in (2, 4, 2, 8, 4, 2, 2)), indexing="ij")
    rows = (rg * 16 + g + 8 * hf).ravel()
    cols = (fq * 16 + nt * 8 + 2 * tig + q).ravel()
    row = (np.arange(blocks)[:, None, None] * CONV_FWD_ROWS + rows).repeat(nch, 1).ravel()
    col = (np.arange(nch)[None, :, None] * CONV_CC + cols).repeat(blocks, 0).ravel()
    keep = (row < n) & (col < d)
    written = np.zeros((n, d), np.int64)
    np.add.at(written, (row[keep], col[keep]), 1)
    assert (written == 1).all()
    assert keep.sum() == n * d and blocks * CONV_FWD_ROWS - n < CONV_FWD_ROWS


def _conv_inputs(seed, b, t, d):
    r = np.random.default_rng(seed)
    x = r.standard_normal((b, t, d)).astype(np.float32)
    p = (1.0 + 0.1 * r.standard_normal(d), 0.1 * r.standard_normal(d), r.standard_normal((d, d)) * d ** -0.5, 0.1 * r.standard_normal(d),
         r.standard_normal((d, d)) * d ** -0.5, 0.1 * r.standard_normal(d))
    return x, [np.asarray(a, np.float32) for a in p], r.standard_normal((b, t, d)).astype(np.float32)


def test_conv_front_column_sums_by_16_rows_match_jax():
    """The backward rows pass's column sums (dba, dbb, dgamma, dbeta), one
    partial row per 16 rows summed in row order and then in partial order
    as sum_partials_kernel does, against JAX's conv_front backward
    (interpret mode) at f32."""
    b, t, d = 2, 40, 24
    x, params, dout = _conv_inputs(SEED, b, t, d)
    xt, pt, dt = torch.tensor(x), [torch.tensor(a) for a in params], torch.tensor(dout)
    from tensorflowasr_tpu_torch.ops.cuda.ff_kernel import _ln_parts, dot_as

    y, xhat, _ = _ln_parts(xt, pt[0], pt[1], 1e-3)
    ha, hb = dot_as(y, pt[2]) + pt[3], dot_as(y, pt[4]) + pt[5]
    sg = torch.sigmoid(hb)
    dha, dhb = dt * sg, dt * ha * sg * (1 - sg)
    dy = dot_as(dha, pt[2].t()) + dot_as(dhb, pt[4].t())
    cols = torch.cat([dha, dhb, dy * xhat, dy], -1).reshape(-1, 4 * d)  # [N, 4D] per row
    parts = torch.stack([c.sum(0) for c in cols.split(16)])  # one partial row per 16 rows
    got = torch.zeros(4 * d)
    for row in parts:
        got = got + row
    dba, dbb, dg, dbeta = got.split(d)

    import jax
    import jax.numpy as jnp

    from tensorflowasr_tpu.ops.pallas import conv_kernel as jck

    jargs = [jnp.asarray(a) for a in (x, *params)]
    _, vjp = jax.vjp(lambda *a: jck.conv_front(*a, eps=1e-3, interpret=True), *jargs)
    ref = vjp(jnp.asarray(dout))
    for name, g, r in (("dgamma", dg, ref[1]), ("dbeta", dbeta, ref[2]), ("dba", dba, ref[4]), ("dbb", dbb, ref[6])):
        r = np.asarray(r, np.float64)
        assert np.abs(g.double().numpy() - r).max() <= 1e-5 * np.abs(r).max(), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_joint_and_conv_front_take_the_plain_versions(dtype):
    """On CPU tensors the fused joint loss and conv_front, with autograd,
    equal their plain versions bit for bit and launch no kernel (no
    library is built)."""
    before = tuple(launches[n] for n in ("kernel.joint_loss.fwd", "kernel.joint_loss.bwd", "kernel.conv_front.fwd", "kernel.conv_front.bwd"))
    enc_p, pred_p, wv, bv, labels = (torch.tensor(x) for x in _joint_inputs(SEED + 2, 2, 9, 5, 16, 20))
    leaves = [x.to(dtype).requires_grad_(True) for x in (enc_p, pred_p, wv)] + [bv.clone().requires_grad_(True)]
    t_len, u_len = torch.tensor([9, 6]), torch.tensor([5, 2])
    loss = jk.rnnt_loss_fused_joint(*leaves, t_len, labels, u_len)
    loss.sum().backward()
    ref, lse, gbl, gem = jk.rnnt_loss_fused_joint_plain(*[x.detach() for x in leaves], t_len, labels, u_len)
    assert torch.equal(loss.detach(), ref)
    for g, r in zip([x.grad for x in leaves], jk.rnnt_loss_fused_joint_plain_bwd(*[x.detach() for x in leaves], labels, lse, gbl, gem)):
        assert torch.equal(g, r)

    x, params, dout = _conv_inputs(SEED + 3, 2, 7, 24)
    xt = torch.tensor(x).to(dtype).requires_grad_(True)
    pt = [torch.tensor(params[0]), torch.tensor(params[1])] + [torch.tensor(a).to(dtype) for a in params[2:]]
    pt = [p.requires_grad_(True) for p in pt]
    out = ck.conv_front(xt, *pt)
    out.backward(torch.tensor(dout).to(dtype))
    assert torch.equal(out.detach(), ck.conv_front_plain(xt.detach(), *[p.detach() for p in pt]))
    ref_grads = ck.conv_front_plain_bwd(xt.detach(), *[p.detach() for p in pt], torch.tensor(dout).to(dtype))
    for g, r in zip([xt.grad] + [p.grad for p in pt], ref_grads):
        assert torch.equal(g, r)
    assert tuple(launches[n] for n in ("kernel.joint_loss.fwd", "kernel.joint_loss.bwd", "kernel.conv_front.fwd", "kernel.conv_front.bwd")) == before
    assert _build._lib is None
