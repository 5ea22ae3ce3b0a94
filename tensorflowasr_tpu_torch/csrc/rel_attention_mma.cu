// Kernel B in bf16 on the tensor cores: Transformer-XL relative attention,
// softmax(qc.k^T + rel + masks) with probability dropout, then P.V; and its
// backward. The f32 instantiation stays on the CUDA-core kernels of
// rel_attention.cu, whose C entry points dispatch here for bf16 inputs.
//
// Counterpart of tensorflowasr_tpu/ops/pallas/attention_kernel.py
// fused_rel_attention (_rel_shift :302, _rel_scores :346, _rel_bwd_kernel).
// The structure is kernel A's (attention_mma.cu): blocks of 4 warps x 16
// query rows, key tiles of 64 double-buffered with cp.async, the head padded
// to a multiple of 16 in shared memory only (36 and 44 -> 48), every product
// an mma.sync m16n8k16 with bf16 operands and f32 accumulators.
//
// The relative term as a band product. rel[i, s] = qp[i] . pos[s + (T-1-i) +
// extra], 0 where that index is >= R. For a warp's 16 rows i0.. and a key
// tile s0.. the positions read are the 79 consecutive rows from wbase = s0 +
// T-1-(i0+15) + extra, so one [16 x 80] product band = qp . pos_window^T
// (10 n-tiles, 1.25x the content product) holds every term the tile needs:
// row i, key s reads band column (s - s0) + 15 - (i - i0). The band goes
// through a warp-private f32 tile in shared memory to be read back at that
// skewed column. The block stages one 128-row window of pos per key tile
// (the four warps' windows at offsets 48, 32, 16, 0); positions < 0 or >= R
// stage as zero rows, so their term is exactly 0. No [T, R] product and no
// shift are formed.
//
// Forward, one block per (b.h, 64 query rows), two sweeps over the key tiles:
// the first keeps the row max m and sum l (online), the second forms pn =
// exp(s - m) / l, multiplies it by the dropout keep factor (the counter hash
// of common.cuh indexed by (row, column) under seed + bh * 40499), rounds it
// to bf16 and adds pn.v: JAX's rounding point exactly. m and l go to an f32
// [2, BH, T] output that the backward reads.
// The masks are the Keras merge of _rel_scores: q_len rows, the kv_bias key
// row, causal, chunk/history (streaming), pe_causal via extra, S = M + T with
// a KV memory, -1e9 clamping and -1e30 padded columns.
//
// Backward, three launches, no atomics:
//  - dq: one block per (b.h, 64 query rows) recomputes the scores and pn from
//    m and l, dP = do.v^T, ds = pn * (dP * keep - delta) with delta = sum do
//    * out from the saved output; dqc += ds_bf16 . k, and dqp from ds
//    scattered into the same [16 x 80] skewed band (bf16) times the pos
//    window. ds leaves in bf16 ([BH, T, Sp], Sp = S rounded up to 8): JAX
//    rounds ds to the input type for every product. pd = pn * keep leaves as
//    two bf16 planes hi + lo ([2, BH, T, Sp], mma.cuh's split), so that dv
//    keeps JAX's f32 pd operand on the tensor cores, as kernel A does. Each
//    thread stores its two adjacent columns of ds, hi and lo as one 4-byte
//    pair per plane (2-byte stores made the second plane cost ~45 us a call
//    at the flagship shape on an H100, several times its bytes).
//  - dk, dv: one block per (b.h, 64 keys) walks the query tiles of 32 in
//    order: dv += hi^T . do + lo^T . do, dk += ds^T . qc. Reading pd from the
//    dq pass costs 2 x 20 MB each way at b.h 64, T = S = 400 (~24 us);
//    recomputing it here would repeat the forward's score and rel-band
//    products (the rel term in key-major order, a 48 x 32 band per 16 x 32
//    tile), most of a forward pass.
//  - dpos: one block per (b.h, 64 positions) gathers ds along the diagonals
//    into a band tile, dw[i, p] = ds[i, p - (T-1-i) - extra], over the query
//    rows that reach those positions, and forms dpos += dw^T . qp.
// Heads above 64 (up to 128: the relative-PE Transformer's) run the same tiles
// with a 128-column head: the forward and dq take one block per SM (195,584 and
// 213,248 B of shared memory), and the dq pass runs each (b.h, 64 rows) as two
// blocks of 64 output columns (grid z), each recomputing the scores, so that
// its two accumulators stay at head 64's registers. Every tile is computed:
// none is skipped where the chunk mask hides it.
// What bounds it: at b.h 64, T = S = 400, head 36 (Dp 48) the forward is
// ~5.5 and the backward ~10 b.h.T.S.Dp tensor-core operations (~5 and ~10
// GFLOP: ~5 and ~10 us at 989 TFLOP/s) beside ~40 MB of bf16 ds and pd
// (~24 us); mma.sync, the per-score mask and exponent work and the skewed
// band reads keep it far above either.
#include "mma.cuh"

namespace tfasr {

namespace {

constexpr int RB_BLOCK = 64;    // query rows per block (forward, dq); keys or positions per block (dk/dv, dpos)
constexpr int RB_KT = 64;       // key tile of the forward and dq sweeps
constexpr int RB_QT = 32;       // query tile of the dk/dv and dpos sweeps
constexpr int RB_THREADS = 128; // 4 warps of 16 rows
constexpr int RB_WIN = 128;     // pos rows staged per key tile: the block's window
constexpr int RB_BAND = 80;     // band columns of a warp: 64 + 15 positions, padded to 16
constexpr int RB_BLD = 84;      // f32 band row stride
constexpr int RB_HLD = 88;      // bf16 band row stride (16-byte rows for ldmatrix)
constexpr int RB_TLD = RB_KT + AM_PAD;  // bf16 [query][key] tile row stride
constexpr float RB_NEG_PAD = -1e30f;
constexpr unsigned int RB_SALT_BH = 40499u;

struct RelMma {
  int BH, H, T, S, R, D, Dp, Sp, extra, causal, has_chunk, chunk, history;
  int mode;  // staging of [*, D] rows: 2 16-byte cp.async, 1 8-byte, 0 element copies
  const float* kv_bias;
  const int* q_len;
};

// Stage rows [r0, r0 + rows) of x ([n, D] bf16) into dst [rows][Dp + AM_PAD];
// rows outside [0, n) and columns D..Dp zero. Issued by the whole block.
__device__ __forceinline__ void rb_stage(bf16* dst, const bf16* x, int r0, int n, int rows, const RelMma& a) {
  const int D = a.D, Dp = a.Dp, LD = Dp + AM_PAD;
  if (a.mode) {
    const int w = a.mode == 2 ? 8 : 4, cpr = Dp / w;
    for (int i = threadIdx.x; i < rows * cpr; i += blockDim.x) {
      const int r = i / cpr, c = (i - r * cpr) * w, row = r0 + r;
      const bool ok = row >= 0 && row < n && c < D;
      const bf16* src = ok ? x + (size_t)row * D + c : x;
      if (a.mode == 2)
        cp_async16(smem_u32(dst + r * LD + c), src, ok ? 16 : 0);
      else
        cp_async8(smem_u32(dst + r * LD + c), src, ok ? 8 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < rows * Dp; i += blockDim.x) {
      const int r = i / Dp, c = i - r * Dp, row = r0 + r;
      dst[r * LD + c] = (row >= 0 && row < n && c < D) ? x[(size_t)row * D + c] : __float2bfloat16(0.f);
    }
  }
}

// The index maps of the relative term (exported below, so that the card
// can hold them against the plain index s + (T-1-i) + extra):
// the first pos row of the block's window for key tile j (rows i0..i0+63);
__host__ __device__ inline int rb_window_base(int j, int i0, int T, int extra) { return j * RB_KT + (T - 1 - (i0 + RB_BLOCK - 1)) + extra; }
// the band column at which a warp's row r (0..15) reads the tile's key sl (0..63);
__host__ __device__ inline int rb_band_col(int sl, int r) { return sl + 15 - r; }
// the query rows [lo, hi) that reach positions p0..p0+63 at some key in [0, S).
__host__ __device__ inline void rb_dpos_rows(int p0, int T, int S, int extra, int& lo, int& hi) {
  lo = T - 1 + extra - (p0 + RB_BLOCK - 1);
  hi = T - 1 + extra - p0 + S;
  lo = lo < 0 ? 0 : lo;
  hi = hi > T ? T : hi;
}

__device__ __forceinline__ int rb_win_base(int j, int i0, const RelMma& a) { return rb_window_base(j, i0, a.T, a.extra); }

// What one thread needs of its two fragment rows to apply the masks.
struct RowMask {
  int row[2], cs[2];
  bool qvalid[2];
  int b, hist;
};

__device__ __forceinline__ RowMask rb_rows(int row_lo, int bh, const RelMma& a) {
  RowMask m;
  m.b = bh / a.H;
  m.hist = a.history < 0 ? a.S : a.history;
  const int qlen = a.q_len != nullptr ? a.q_len[m.b] : a.T;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m.row[h] = row_lo + 8 * h;
    m.qvalid[h] = m.row[h] < qlen;
    m.cs[h] = a.has_chunk ? (m.row[h] / a.chunk) * a.chunk : 0;
  }
  return m;
}

// The Keras-parity merge of attention_kernel._rel_scores on val = content +
// rel at (row h of the thread, column col): column terms clamp at -1e9, an
// invalid query row takes -1e9 on every column, padded columns -1e30.
__device__ __forceinline__ float rb_mask(float val, int h, int col, const RowMask& m, const RelMma& a) {
  if (col >= a.S) return RB_NEG_PAD;
  const bool vis = a.causal || a.has_chunk;
  if (a.kv_bias != nullptr || vis) {
    float add = a.kv_bias != nullptr ? a.kv_bias[(size_t)m.b * a.S + col] : 0.f;
    if (vis) {
      const int frame = col - (a.S - a.T);
      bool allowed = true;
      if (a.causal) allowed = frame <= m.row[h];
      if (a.has_chunk) allowed = allowed && frame >= m.cs[h] - m.hist && frame < m.cs[h] + a.chunk;
      add = add + (allowed ? 0.f : -1e9f);
    }
    add = fmaxf(add, -1e9f);
    if (!m.qvalid[h]) add = -1e9f;
    return val + add;
  }
  return m.qvalid[h] ? val : val + -1e9f;
}

// Scores of this warp's 16 rows against key tile j: qc.k^T plus the rel term
// read from the band at its skewed column, masked. band: the warp's f32
// [16][RB_BLD] tile; posw: the warp's 80 pos rows.
template <int DMAX>
__device__ __forceinline__ void rb_scores(float (&s)[RB_KT / 8][4], const bf16* qcw, const bf16* qpw, const bf16* kt, const bf16* posw,
                                          float* band, int j, const RowMask& m, const RelMma& a, int lane) {
  const int LD = a.Dp + AM_PAD, nk = a.Dp / 16, g = lane >> 2, tig = lane & 3;
  am_abT<DMAX, RB_KT / 8>(s, qcw, kt, LD, nk, lane);
  float w[RB_BAND / 8][4];
  am_abT<DMAX, RB_BAND / 8>(w, qpw, posw, LD, nk, lane);
  __syncwarp();  // the previous tile's band reads are done
#pragma unroll
  for (int nt = 0; nt < RB_BAND / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) band[(g + 8 * (e >> 1)) * RB_BLD + nt * 8 + 2 * tig + (e & 1)] = w[nt][e];
  __syncwarp();
#pragma unroll
  for (int nt = 0; nt < RB_KT / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = g + 8 * (e >> 1), sl = nt * 8 + 2 * tig + (e & 1);
      s[nt][e] = rb_mask(s[nt][e] + band[r * RB_BLD + rb_band_col(sl, r)], e >> 1, j * RB_KT + sl, m, a);
    }
  }
}

struct FwdSmem {
  bf16 *qc, *qp, *k, *v, *pos;
  float* band;
};

__device__ __forceinline__ FwdSmem rb_layout(unsigned char* base, int LD, bool with_do, bf16** do_s) {
  FwdSmem p;
  p.qc = reinterpret_cast<bf16*>(base);  // [64][LD]
  p.qp = p.qc + RB_BLOCK * LD;            // [64][LD]
  bf16* next = p.qp + RB_BLOCK * LD;
  if (with_do) {
    *do_s = next;  // [64][LD]
    next += RB_BLOCK * LD;
  }
  p.k = next;                              // [2][64][LD]
  p.v = p.k + 2 * RB_KT * LD;              // [2][64][LD]
  p.pos = p.v + 2 * RB_KT * LD;            // [2][128][LD]
  p.band = reinterpret_cast<float*>(p.pos + 2 * RB_WIN * LD);  // [4][16][RB_BLD]
  return p;
}

template <int DMAX>
__global__ void __launch_bounds__(RB_THREADS) rel_mma_fwd(const bf16* __restrict__ qc, const bf16* __restrict__ qp, const bf16* __restrict__ k,
                                                          const bf16* __restrict__ v, const bf16* __restrict__ pos, bf16* __restrict__ out,
                                                          float* __restrict__ stats, RelMma a, Dropout dp) {
  extern __shared__ __align__(16) unsigned char rb_smem[];
  const int LD = a.Dp + AM_PAD, nk = a.Dp / 16, T = a.T, S = a.S;
  const FwdSmem sm = rb_layout(rb_smem, LD, false, nullptr);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, tig = lane & 3;
  const int bh = blockIdx.y, i0 = blockIdx.x * RB_BLOCK;
  const bf16* kb = k + (size_t)bh * S * a.D;
  const bf16* vb = v + (size_t)bh * S * a.D;
  const bf16* pb = pos + (size_t)bh * a.R * a.D;
  const int row_lo = i0 + warp * 16 + g;
  const RowMask rm = rb_rows(row_lo, bh, a);
  const int nkt = (S + RB_KT - 1) / RB_KT;
  const bf16* qcw = sm.qc + warp * 16 * LD;
  const bf16* qpw = sm.qp + warp * 16 * LD;
  float* band = sm.band + warp * 16 * RB_BLD;
  const int woff = (3 - warp) * 16;  // the warp's 80 rows in the block's 128-row window

  // sweep 1: row max and sum
  rb_stage(sm.qc, qc + (size_t)bh * T * a.D, i0, T, RB_BLOCK, a);
  rb_stage(sm.qp, qp + (size_t)bh * T * a.D, i0, T, RB_BLOCK, a);
  rb_stage(sm.k, kb, 0, S, RB_KT, a);
  rb_stage(sm.pos, pb, rb_win_base(0, i0, a), a.R, RB_WIN, a);
  cp_async_commit();
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int j = 0; j < nkt; ++j) {
    if (j + 1 < nkt) {
      const int nb = (j + 1) & 1;
      rb_stage(sm.k + nb * RB_KT * LD, kb, (j + 1) * RB_KT, S, RB_KT, a);
      rb_stage(sm.pos + nb * RB_WIN * LD, pb, rb_win_base(j + 1, i0, a), a.R, RB_WIN, a);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float s[RB_KT / 8][4];
    rb_scores<DMAX>(s, qcw, qpw, sm.k + (j & 1) * RB_KT * LD, sm.pos + ((j & 1) * RB_WIN + woff) * LD, band, j, rm, a, lane);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mt = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < RB_KT / 8; ++nt) mt = fmaxf(mt, fmaxf(s[nt][2 * h], s[nt][2 * h + 1]));
      const float mn = fmaxf(m[h], quad_max(mt));
      float add = 0.f;
#pragma unroll
      for (int nt = 0; nt < RB_KT / 8; ++nt) add += am_exp(s[nt][2 * h], mn) + am_exp(s[nt][2 * h + 1], mn);
      l[h] = l[h] * am_exp(m[h], mn) + add;
      m[h] = mn;
    }
    __syncthreads();
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] = quad_sum(l[h]);
    const int row = row_lo + h * 8;
    if (stats != nullptr && tig == 0 && row < T) {
      stats[(size_t)bh * T + row] = m[h];
      stats[(size_t)(a.BH + bh) * T + row] = l[h];
    }
  }

  // sweep 2: pn = exp(S - m) / l, dropped, rounded to bf16, times v
  rb_stage(sm.k, kb, 0, S, RB_KT, a);
  rb_stage(sm.v, vb, 0, S, RB_KT, a);
  rb_stage(sm.pos, pb, rb_win_base(0, i0, a), a.R, RB_WIN, a);
  cp_async_commit();
  const unsigned int seed = dp.seed + (unsigned int)bh * RB_SALT_BH;
  const float inv_l[2] = {1.f / l[0], 1.f / l[1]};
  float o[DMAX / 8][4];
#pragma unroll
  for (int dt = 0; dt < DMAX / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  for (int j = 0; j < nkt; ++j) {
    if (j + 1 < nkt) {
      const int nb = (j + 1) & 1;
      rb_stage(sm.k + nb * RB_KT * LD, kb, (j + 1) * RB_KT, S, RB_KT, a);
      rb_stage(sm.v + nb * RB_KT * LD, vb, (j + 1) * RB_KT, S, RB_KT, a);
      rb_stage(sm.pos + nb * RB_WIN * LD, pb, rb_win_base(j + 1, i0, a), a.R, RB_WIN, a);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float s[RB_KT / 8][4];
    rb_scores<DMAX>(s, qcw, qpw, sm.k + (j & 1) * RB_KT * LD, sm.pos + ((j & 1) * RB_WIN + woff) * LD, band, j, rm, a, lane);
#pragma unroll
    for (int nt = 0; nt < RB_KT / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = am_exp(s[nt][e], m[e >> 1]) * inv_l[e >> 1];
        if (dp.on) p *= dropout_keep(dp, seed, row_lo + (e >> 1) * 8, j * RB_KT + tig * 2 + nt * 8 + (e & 1));
        s[nt][e] = p;
      }
    }
    uint32_t pa[RB_KT / 16][4];
    frag_to_a<RB_KT / 16>(pa, s);
    am_pv<DMAX, RB_KT / 16>(o, pa, sm.v + (j & 1) * RB_KT * LD, LD, nk, lane);
    __syncthreads();
  }
  am_store<DMAX>(out + (size_t)bh * T * a.D, o, row_lo, T, a.D, tig * 2);
}

template <int DMAX, int DO>
__global__ void __launch_bounds__(RB_THREADS) rel_mma_dq(const bf16* __restrict__ qc, const bf16* __restrict__ qp, const bf16* __restrict__ k,
                                                         const bf16* __restrict__ v, const bf16* __restrict__ pos, const bf16* __restrict__ out,
                                                         const bf16* __restrict__ dout, const float* __restrict__ stats, bf16* __restrict__ ds_o,
                                                         bf16* __restrict__ pd_o, bf16* __restrict__ dqc, bf16* __restrict__ dqp, RelMma a,
                                                         Dropout dp) {
  extern __shared__ __align__(16) unsigned char rb_smem[];
  const int LD = a.Dp + AM_PAD, nk = a.Dp / 16, T = a.T, S = a.S, D = a.D;
  bf16* do_s;
  const FwdSmem sm = rb_layout(rb_smem, LD, true, &do_s);
  float* delta_s = sm.band + 4 * 16 * RB_BLD;  // [64]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, tig = lane & 3;
  const int bh = blockIdx.y, i0 = blockIdx.x * RB_BLOCK;
  // the block's output columns [c0, c0 + DO) of dqc and dqp; only the first column block writes ds and pd
  const int c0 = DO < DMAX ? (int)blockIdx.z * DO : 0, nko = min(DO, a.Dp - c0) / 16;
  const bool writes_ds = DO == DMAX || blockIdx.z == 0;
  const bf16* kb = k + (size_t)bh * S * D;
  const bf16* vb = v + (size_t)bh * S * D;
  const bf16* pb = pos + (size_t)bh * a.R * D;
  const size_t qoff = (size_t)bh * T * D;
  const int row_lo = i0 + warp * 16 + g;
  const RowMask rm = rb_rows(row_lo, bh, a);
  const int nkt = (S + RB_KT - 1) / RB_KT;
  const bf16* qcw = sm.qc + warp * 16 * LD;
  const bf16* qpw = sm.qp + warp * 16 * LD;
  const bf16* dow = do_s + warp * 16 * LD;
  float* band = sm.band + warp * 16 * RB_BLD;
  bf16* bandh = reinterpret_cast<bf16*>(band);  // the same tile as bf16 [16][RB_HLD] for dqp
  const int woff = (3 - warp) * 16;

  rb_stage(sm.qc, qc + qoff, i0, T, RB_BLOCK, a);
  rb_stage(sm.qp, qp + qoff, i0, T, RB_BLOCK, a);
  rb_stage(do_s, dout + qoff, i0, T, RB_BLOCK, a);
  rb_stage(sm.k, kb, 0, S, RB_KT, a);
  rb_stage(sm.v, vb, 0, S, RB_KT, a);
  rb_stage(sm.pos, pb, rb_win_base(0, i0, a), a.R, RB_WIN, a);
  cp_async_commit();
  // delta = sum over d of dout * out (f32 of the bf16 values), the warp's 16 rows
  for (int r = 0; r < 16; ++r) {
    const int row = i0 + warp * 16 + r;
    float sum = 0.f;
    if (row < T)
      for (int d = lane; d < D; d += 32) sum = fmaf(to_f32(dout[qoff + (size_t)row * D + d]), to_f32(out[qoff + (size_t)row * D + d]), sum);
    sum = warp_sum(sum);
    if (lane == 0) delta_s[warp * 16 + r] = sum;
  }
  __syncwarp();
  float m[2], inv_l[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_lo + h * 8;
    const bool ok = row < T;
    m[h] = ok ? stats[(size_t)bh * T + row] : 0.f;
    inv_l[h] = ok ? 1.f / stats[(size_t)(a.BH + bh) * T + row] : 1.f;
    dl[h] = delta_s[warp * 16 + g + 8 * h];
  }
  const unsigned int seed = dp.seed + (unsigned int)bh * RB_SALT_BH;
  const size_t soff = (size_t)bh * T * a.Sp;
  float aq[DO / 8][4], ap[DO / 8][4];
#pragma unroll
  for (int dt = 0; dt < DO / 8; ++dt) {
    aq[dt][0] = aq[dt][1] = aq[dt][2] = aq[dt][3] = 0.f;
    ap[dt][0] = ap[dt][1] = ap[dt][2] = ap[dt][3] = 0.f;
  }
  for (int j = 0; j < nkt; ++j) {
    if (j + 1 < nkt) {
      const int nb = (j + 1) & 1;
      rb_stage(sm.k + nb * RB_KT * LD, kb, (j + 1) * RB_KT, S, RB_KT, a);
      rb_stage(sm.v + nb * RB_KT * LD, vb, (j + 1) * RB_KT, S, RB_KT, a);
      rb_stage(sm.pos + nb * RB_WIN * LD, pb, rb_win_base(j + 1, i0, a), a.R, RB_WIN, a);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kt = sm.k + (j & 1) * RB_KT * LD;
    const bf16* posw = sm.pos + ((j & 1) * RB_WIN + woff) * LD;
    float s[RB_KT / 8][4], dpa[RB_KT / 8][4];
    rb_scores<DMAX>(s, qcw, qpw, kt, posw, band, j, rm, a, lane);
    am_abT<DMAX, RB_KT / 8>(dpa, dow, sm.v + (j & 1) * RB_KT * LD, LD, nk, lane);
#pragma unroll
    for (int nt = 0; nt < RB_KT / 8; ++nt) {
      float pd[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, row = row_lo + h * 8, col = j * RB_KT + tig * 2 + nt * 8 + (e & 1);
        const float pn = am_exp(s[nt][e], m[h]) * inv_l[h];
        float dpv = dpa[nt][e];
        pd[e] = pn;
        if (dp.on) {
          const float keep = dropout_keep(dp, seed, row, col);
          dpv *= keep;
          pd[e] *= keep;
        }
        const float ds = pn * (dpv - dl[h]);
        s[nt][e] = col < S ? ds : 0.f;
      }
      // a thread's two adjacent columns as one 4-byte store per plane (col even, Sp % 8 == 0: the pair stays in the
      // row; a column past S lands in the padding, which no pass reads as a key)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row_lo + h * 8, col = j * RB_KT + tig * 2 + nt * 8;
        if (writes_ds && row < T && col < S) {
          const size_t o = soff + (size_t)row * a.Sp + col;
          const __nv_bfloat162 hi = __floats2bfloat162_rn(pd[2 * h], pd[2 * h + 1]);
          *reinterpret_cast<__nv_bfloat162*>(ds_o + o) = __floats2bfloat162_rn(s[nt][2 * h], s[nt][2 * h + 1]);
          *reinterpret_cast<__nv_bfloat162*>(pd_o + o) = hi;
          *reinterpret_cast<__nv_bfloat162*>(pd_o + (size_t)a.BH * T * a.Sp + o) =
              __floats2bfloat162_rn(pd[2 * h] - __low2float(hi), pd[2 * h + 1] - __high2float(hi));
        }
      }
    }
    uint32_t pa[RB_KT / 16][4];
    frag_to_a<RB_KT / 16>(pa, s);
    am_pv<DO, RB_KT / 16>(aq, pa, kt + c0, LD, nko, lane);
    // dqp: ds scattered into the skewed band, times the pos window
    __syncwarp();  // the band's f32 reads are done
    for (int i = lane; i < 16 * RB_HLD / 2; i += 32) reinterpret_cast<uint32_t*>(bandh)[i] = 0u;
    __syncwarp();
#pragma unroll
    for (int nt = 0; nt < RB_KT / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = g + 8 * (e >> 1), sl = nt * 8 + 2 * tig + (e & 1);
        bandh[r * RB_HLD + rb_band_col(sl, r)] = __float2bfloat16(s[nt][e]);
      }
    }
    __syncwarp();
    uint32_t pb_[RB_BAND / 16][4];
#pragma unroll
    for (int ks = 0; ks < RB_BAND / 16; ++ks) load_a(pb_[ks], bandh + ks * 16, RB_HLD, lane);
    am_pv<DO, RB_BAND / 16>(ap, pb_, posw + c0, LD, nko, lane);
    __syncthreads();
  }
  am_store<DO>(dqc + qoff, aq, row_lo, T, D, c0 + tig * 2);
  am_store<DO>(dqp + qoff, ap, row_lo, T, D, c0 + tig * 2);
}

// Stage a [32 query rows][64 columns] bf16 tile of x ([T, Sp] rows of one b.h)
// from column c0; rows past T and columns past Sp zero. 16-byte cp.async (Sp % 8 == 0).
__device__ __forceinline__ void rb_stage_tile(bf16* dst, const bf16* x, int q0, int c0, const RelMma& a) {
  for (int i = threadIdx.x; i < RB_QT * (RB_KT / 8); i += blockDim.x) {
    const int r = i / (RB_KT / 8), c = (i % (RB_KT / 8)) * 8;
    const bool ok = q0 + r < a.T && c0 + c < a.Sp;
    cp_async16(smem_u32(dst + r * RB_TLD + c), ok ? x + (size_t)(q0 + r) * a.Sp + c0 + c : x, ok ? 16 : 0);
  }
}

template <int DMAX>
__global__ void __launch_bounds__(RB_THREADS) rel_mma_dkv(const bf16* __restrict__ qc, const bf16* __restrict__ dout, const bf16* __restrict__ ds,
                                                          const bf16* __restrict__ pd, bf16* __restrict__ dk, bf16* __restrict__ dv, RelMma a) {
  extern __shared__ __align__(16) unsigned char rb_smem[];
  const int LD = a.Dp + AM_PAD, nk = a.Dp / 16, T = a.T, S = a.S;
  bf16* ds_s = reinterpret_cast<bf16*>(rb_smem);  // [2][32][RB_TLD]
  bf16* pd_s = ds_s + 2 * RB_QT * RB_TLD;         // [2][32][RB_TLD] pd's hi plane
  bf16* pl_s = pd_s + 2 * RB_QT * RB_TLD;         // [2][32][RB_TLD] pd's lo plane
  bf16* q_s = pl_s + 2 * RB_QT * RB_TLD;          // [2][32][LD]
  bf16* do_s = q_s + 2 * RB_QT * LD;              // [2][32][LD]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, tig = lane & 3;
  const int bh = blockIdx.y, s0 = blockIdx.x * RB_BLOCK;
  const size_t qoff = (size_t)bh * T * a.D, soff = (size_t)bh * T * a.Sp;
  const int nqt = (T + RB_QT - 1) / RB_QT;
  auto stage = [&](int buf, int q0) {
    rb_stage_tile(ds_s + buf * RB_QT * RB_TLD, ds + soff, q0, s0, a);
    rb_stage_tile(pd_s + buf * RB_QT * RB_TLD, pd + soff, q0, s0, a);
    rb_stage_tile(pl_s + buf * RB_QT * RB_TLD, pd + (size_t)a.BH * T * a.Sp + soff, q0, s0, a);
    rb_stage(q_s + buf * RB_QT * LD, qc + qoff, q0, T, RB_QT, a);
    rb_stage(do_s + buf * RB_QT * LD, dout + qoff, q0, T, RB_QT, a);
  };
  stage(0, 0);
  cp_async_commit();
  float adk[DMAX / 8][4], adv[DMAX / 8][4];
#pragma unroll
  for (int dt = 0; dt < DMAX / 8; ++dt) {
    adk[dt][0] = adk[dt][1] = adk[dt][2] = adk[dt][3] = 0.f;
    adv[dt][0] = adv[dt][1] = adv[dt][2] = adv[dt][3] = 0.f;
  }
  for (int j = 0; j < nqt; ++j) {
    if (j + 1 < nqt) {
      stage((j + 1) & 1, (j + 1) * RB_QT);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int cb = j & 1;
    uint32_t pa[RB_QT / 16][4];
#pragma unroll
    for (int ks = 0; ks < RB_QT / 16; ++ks) load_a_t(pa[ks], pd_s + (cb * RB_QT + ks * 16) * RB_TLD + warp * 16, RB_TLD, lane);
    am_pv<DMAX, RB_QT / 16>(adv, pa, do_s + cb * RB_QT * LD, LD, nk, lane);
#pragma unroll
    for (int ks = 0; ks < RB_QT / 16; ++ks) load_a_t(pa[ks], pl_s + (cb * RB_QT + ks * 16) * RB_TLD + warp * 16, RB_TLD, lane);
    am_pv<DMAX, RB_QT / 16>(adv, pa, do_s + cb * RB_QT * LD, LD, nk, lane);
#pragma unroll
    for (int ks = 0; ks < RB_QT / 16; ++ks) load_a_t(pa[ks], ds_s + (cb * RB_QT + ks * 16) * RB_TLD + warp * 16, RB_TLD, lane);
    am_pv<DMAX, RB_QT / 16>(adk, pa, q_s + cb * RB_QT * LD, LD, nk, lane);
    __syncthreads();
  }
  const int key_lo = s0 + warp * 16 + g;
  am_store<DMAX>(dk + (size_t)bh * S * a.D, adk, key_lo, S, a.D, tig * 2);
  am_store<DMAX>(dv + (size_t)bh * S * a.D, adv, key_lo, S, a.D, tig * 2);
}

template <int DMAX>
__global__ void __launch_bounds__(RB_THREADS) rel_mma_dpos(const bf16* __restrict__ qp, const bf16* __restrict__ ds, bf16* __restrict__ dpos,
                                                           RelMma a) {
  extern __shared__ __align__(16) unsigned char rb_smem[];
  const int LD = a.Dp + AM_PAD, nk = a.Dp / 16, T = a.T, S = a.S, R = a.R;
  bf16* g_s = reinterpret_cast<bf16*>(rb_smem);  // [32][RB_TLD] dw^T tile: [query][position]
  bf16* q_s = g_s + RB_QT * RB_TLD;              // [32][LD]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, tig = lane & 3;
  const int bh = blockIdx.y, p0 = blockIdx.x * RB_BLOCK;
  const size_t qoff = (size_t)bh * T * a.D, soff = (size_t)bh * T * a.Sp;
  int lo, hi;  // query rows that reach positions p0..p0+63 at some key s in [0, S)
  rb_dpos_rows(p0, T, S, a.extra, lo, hi);
  float acc[DMAX / 8][4];
#pragma unroll
  for (int dt = 0; dt < DMAX / 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  for (int q0 = lo / RB_QT * RB_QT; q0 < hi; q0 += RB_QT) {
    __syncthreads();
    rb_stage(q_s, qp + qoff, q0, T, RB_QT, a);
    cp_async_commit();
    for (int i = threadIdx.x; i < RB_QT * RB_BLOCK; i += blockDim.x) {
      const int r = i / RB_BLOCK, pl = i % RB_BLOCK, row = q0 + r, p = p0 + pl;
      const int s = p - (T - 1 - row) - a.extra;
      const bool ok = row < T && p < R && s >= 0 && s < S;
      g_s[r * RB_TLD + pl] = ok ? ds[soff + (size_t)row * a.Sp + s] : __float2bfloat16(0.f);
    }
    cp_async_wait<0>();
    __syncthreads();
    uint32_t pa[RB_QT / 16][4];
#pragma unroll
    for (int ks = 0; ks < RB_QT / 16; ++ks) load_a_t(pa[ks], g_s + ks * 16 * RB_TLD + warp * 16, RB_TLD, lane);
    am_pv<DMAX, RB_QT / 16>(acc, pa, q_s, LD, nk, lane);
  }
  am_store<DMAX>(dpos + (size_t)bh * R * a.D, acc, p0 + warp * 16 + g, R, a.D, tig * 2);
}

size_t rb_fwd_smem(int Dp) { return (size_t)(2 * RB_BLOCK + 4 * RB_KT + 2 * RB_WIN) * (Dp + AM_PAD) * sizeof(bf16) + 4 * 16 * RB_BLD * sizeof(float); }
size_t rb_dq_smem(int Dp) { return rb_fwd_smem(Dp) + (size_t)RB_BLOCK * (Dp + AM_PAD) * sizeof(bf16) + RB_BLOCK * sizeof(float); }
size_t rb_dkv_smem(int Dp) { return (size_t)(6 * RB_QT * RB_TLD + 4 * RB_QT * (Dp + AM_PAD)) * sizeof(bf16); }
size_t rb_dpos_smem(int Dp) { return (size_t)(RB_QT * RB_TLD + RB_QT * (Dp + AM_PAD)) * sizeof(bf16); }

// Head sizes up to 64 run the DMAX 64 instantiation (the code and times of the heads 36, 44 and 64); up to 128 the
// DMAX 128 one. At 128 the forward keeps its 16 x 128 f32 output accumulator (64 registers a lane) and the dq pass
// splits the head into two column blocks of 64 (grid z): each recomputes the scores, so that a block's two
// accumulators (dqc and dqp) stay at 2 x 16 x 64 f32 as at head 64. Shared memory at 128: forward 195,584 B and
// dq 213,248 B (one block per SM), dk/dv 62,464 B, dpos 13,312 B.
constexpr int RB_DMAX = 64, RB_DMAX_WIDE = 128, RB_DQ_COLS = 64;

RelMma rb_args(const void* const* ptrs, int n, int BH, int H, int T, int S, int R, int D, int extra, int causal, int has_chunk, int chunk,
               int history, const void* kv_bias, const void* q_len) {
  uintptr_t bits = 0;
  for (int i = 0; i < n; ++i) bits |= reinterpret_cast<uintptr_t>(ptrs[i]);
  const int mode = (D % 8 == 0 && (bits & 15) == 0) ? 2 : (D % 4 == 0 && (bits & 7) == 0) ? 1 : 0;
  return RelMma{BH, H, T, S, R, D, (D + 15) / 16 * 16, (S + 7) / 8 * 8, extra, causal, has_chunk, chunk, history, mode,
                (const float*)kv_bias, (const int*)q_len};
}

template <int DMAX>
int rb_fwd_launch(const void* qc, const void* qp, const void* k, const void* v, const void* pos, void* out, float* stats, const RelMma& a, Dropout dp,
                  cudaStream_t stream) {
  const size_t smem = rb_fwd_smem(a.Dp);
  cudaError_t err = allow_smem(rel_mma_fwd<DMAX>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.T + RB_BLOCK - 1) / RB_BLOCK, a.BH);
  rel_mma_fwd<DMAX><<<grid, RB_THREADS, smem, stream>>>((const bf16*)qc, (const bf16*)qp, (const bf16*)k, (const bf16*)v, (const bf16*)pos,
                                                        (bf16*)out, stats, a, dp);
  return (int)cudaGetLastError();
}

template <int DMAX, int DO>
int rb_bwd_launch(const void* qc, const void* qp, const void* k, const void* v, const void* pos, const void* out, const void* dout, const float* stats,
                  void* ds, void* pd, void* dqc, void* dqp, void* dk, void* dv, void* dpos, const RelMma& a, Dropout dp, cudaStream_t stream) {
  const int T = a.T, S = a.S, R = a.R, BH = a.BH;
  size_t smem = rb_dq_smem(a.Dp);
  cudaError_t err = allow_smem(rel_mma_dq<DMAX, DO>, smem);
  if (err != cudaSuccess) return (int)err;
  rel_mma_dq<DMAX, DO><<<dim3((T + RB_BLOCK - 1) / RB_BLOCK, BH, DMAX / DO), RB_THREADS, smem, stream>>>(
      (const bf16*)qc, (const bf16*)qp, (const bf16*)k, (const bf16*)v, (const bf16*)pos, (const bf16*)out, (const bf16*)dout, stats, (bf16*)ds,
      (bf16*)pd, (bf16*)dqc, (bf16*)dqp, a, dp);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  smem = rb_dkv_smem(a.Dp);
  if ((err = allow_smem(rel_mma_dkv<DMAX>, smem)) != cudaSuccess) return (int)err;
  rel_mma_dkv<DMAX><<<dim3((S + RB_BLOCK - 1) / RB_BLOCK, BH), RB_THREADS, smem, stream>>>(
      (const bf16*)qc, (const bf16*)dout, (const bf16*)ds, (const bf16*)pd, (bf16*)dk, (bf16*)dv, a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  smem = rb_dpos_smem(a.Dp);
  if ((err = allow_smem(rel_mma_dpos<DMAX>, smem)) != cudaSuccess) return (int)err;
  rel_mma_dpos<DMAX><<<dim3((R + RB_BLOCK - 1) / RB_BLOCK, BH), RB_THREADS, smem, stream>>>((const bf16*)qp, (const bf16*)ds, (bf16*)dpos, a);
  return (int)cudaGetLastError();
}

template <int DMAX, int DO>
int rb_occupancy(int which, size_t smem, int& blocks) {
  cudaError_t err;
  switch (which) {
    case 0:
      if ((err = allow_smem(rel_mma_fwd<DMAX>, smem)) == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, rel_mma_fwd<DMAX>, RB_THREADS, smem);
      break;
    case 1:
      if ((err = allow_smem(rel_mma_dq<DMAX, DO>, smem)) == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, rel_mma_dq<DMAX, DO>, RB_THREADS, smem);
      break;
    case 2:
      if ((err = allow_smem(rel_mma_dkv<DMAX>, smem)) == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, rel_mma_dkv<DMAX>, RB_THREADS, smem);
      break;
    default:
      if ((err = allow_smem(rel_mma_dpos<DMAX>, smem)) == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, rel_mma_dpos<DMAX>, RB_THREADS, smem);
  }
  return (int)err;
}

}  // namespace

// bf16 qc/qp [BH, T, D], k/v [BH, S, D], pos [BH, R, D]; out [BH, T, D];
// stats [2, BH, T] f32 (m, then l) or NULL. D <= 128.
int launch_rel_attention_mma(const void* qc, const void* qp, const void* k, const void* v, const void* pos, const void* kv_bias, const void* q_len,
                             void* out, float* stats, int BH, int H, int T, int S, int R, int D, int extra, int causal, int has_chunk, int chunk,
                             int history, Dropout dp, cudaStream_t stream) {
  if (D > RB_DMAX_WIDE || out == nullptr) return (int)cudaErrorInvalidValue;
  const void* ptrs[5] = {qc, qp, k, v, pos};  // the staged inputs
  const RelMma a = rb_args(ptrs, 5, BH, H, T, S, R, D, extra, causal, has_chunk, chunk, history, kv_bias, q_len);
  return D > RB_DMAX ? rb_fwd_launch<RB_DMAX_WIDE>(qc, qp, k, v, pos, out, stats, a, dp, stream)
                     : rb_fwd_launch<RB_DMAX>(qc, qp, k, v, pos, out, stats, a, dp, stream);
}

// Gradients: out, dout [BH, T, D]; stats from the forward; ds [BH, T, Sp] and
// pd [2, BH, T, Sp] (hi, lo) bf16 scratch (Sp = S rounded up to 8); dqc, dqp [BH, T, D], dk, dv [BH, S,
// D], dpos [BH, R, D].
int launch_rel_attention_mma_bwd(const void* qc, const void* qp, const void* k, const void* v, const void* pos, const void* kv_bias,
                                 const void* q_len, const void* out, const void* dout, const float* stats, void* ds, void* pd, void* dqc, void* dqp,
                                 void* dk, void* dv, void* dpos, int BH, int H, int T, int S, int R, int D, int extra, int causal, int has_chunk,
                                 int chunk, int history, Dropout dp, cudaStream_t stream) {
  if (D > RB_DMAX_WIDE || stats == nullptr) return (int)cudaErrorInvalidValue;
  const void* ptrs[6] = {qc, qp, k, v, pos, dout};  // the staged inputs
  const RelMma a = rb_args(ptrs, 6, BH, H, T, S, R, D, extra, causal, has_chunk, chunk, history, kv_bias, q_len);
  if (D > RB_DMAX)
    return rb_bwd_launch<RB_DMAX_WIDE, RB_DQ_COLS>(qc, qp, k, v, pos, out, dout, stats, ds, pd, dqc, dqp, dk, dv, dpos, a, dp, stream);
  return rb_bwd_launch<RB_DMAX, RB_DMAX>(qc, qp, k, v, pos, out, dout, stats, ds, pd, dqc, dqp, dk, dv, dpos, a, dp, stream);
}

}  // namespace tfasr

// Dynamic shared memory (bytes) of the bf16 kernels at head size D: which 0
// forward, 1 dq, 2 dk/dv, 3 dpos; ops/cuda/attention_kernel.py:rel_mma_plan
// computes the same.
extern "C" long long tfasr_rel_mma_smem(int D, int which) {
  using namespace tfasr;
  const int Dp = (D + 15) / 16 * 16;
  switch (which) {
    case 0: return (long long)rb_fwd_smem(Dp);
    case 1: return (long long)rb_dq_smem(Dp);
    case 2: return (long long)rb_dkv_smem(Dp);
    default: return (long long)rb_dpos_smem(Dp);
  }
}

// Blocks per SM of that kernel on the current card (the instantiation that head size D runs); a negative value is
// the CUDA error.
extern "C" int tfasr_rel_mma_occupancy(int D, int which) {
  using namespace tfasr;
  const size_t smem = (size_t)tfasr_rel_mma_smem(D, which);
  int blocks = -1;
  const int err = D > RB_DMAX ? rb_occupancy<RB_DMAX_WIDE, RB_DQ_COLS>(which, smem, blocks) : rb_occupancy<RB_DMAX, RB_DMAX>(which, smem, blocks);
  return err == 0 ? blocks : -err;
}

// The kernels' index maps (rb_window_base, rb_band_col, rb_dpos_rows), for the card's check.
extern "C" int tfasr_rel_mma_window_base(int j, int i0, int T, int extra) { return tfasr::rb_window_base(j, i0, T, extra); }
extern "C" int tfasr_rel_mma_band_column(int sl, int r) { return tfasr::rb_band_col(sl, r); }
extern "C" int tfasr_rel_mma_dpos_rows(int p0, int T, int S, int extra, int* hi) {
  int lo;
  tfasr::rb_dpos_rows(p0, T, S, extra, lo, *hi);
  return lo;
}
