// Kernel A in bf16 on the tensor cores: softmax(q.k^T + bias) with
// probability dropout, then P.V; and its backward. The f32 instantiation
// stays on the CUDA-core kernels of attention.cu, which dispatches here for
// bf16 inputs.
//
// Counterpart of tensorflowasr_tpu/ops/pallas/attention_kernel.py
// fused_attention (_fwd_kernel, _bwd_kernel). Every product is an
// mma.sync m16n8k16 with bf16 operands and f32 accumulators; operands come
// from shared memory by ldmatrix, the key/value (or query/dout) tiles are
// double-buffered with cp.async. Head sizes up to 128: D is padded to a
// multiple of 16 with zeros in shared memory only.
//
// Forward, one block of 4 warps per (b.h, 64 query rows), each warp 16 rows:
//  1. a first sweep over the key tiles computes S = q.k^T + bias (padded
//     key columns -1e30) and keeps the row max m and the sum l = sum
//     exp(S - m) (online: l is rescaled when m grows);
//  2. a second sweep recomputes S, forms pn = exp(S - m) / l, multiplies it
//     by the dropout keep factor (the counter hash of common.cuh indexed by
//     (row, column) under seed + bh * 40499), rounds it to bf16 and adds
//     pn.v on the tensor cores.
// That is JAX's rounding point exactly: the normalised probabilities are cast
// to v's type before P.V (an online-softmax rescale of the output would move
// it). Recomputing q.k^T costs 6 instead of 4 b.h.T.S.D operations, all on
// tensor cores, and works at any S. m and l go to an f32 [2, BH, T] output
// that the backward reads (JAX recomputes them only to avoid the TPU's lane
// padding of a [BH, T, 1] output, which this card does not have).
//
// Backward, three launches, no atomics and no [BH, T, S] scratch (dbias is
// written only when the bias needs a gradient):
//  - delta = sum_d dout * out per row, from the saved output;
//  - dq: one block per (b.h, 64 query rows) recomputes pn from m and l,
//    dP = dout.v^T, ds = pn * (dP * keep - delta), and dq = ds_bf16 . k
//    (ds in f32 to dbias when asked);
//  - dk, dv: one block per (b.h, 64 keys) walks the query tiles in order,
//    recomputing S^T, pd = pn * keep and ds, and accumulates dv += pd^T.dout
//    and dk += ds^T.q in registers.
// JAX's _bwd_kernel forms dv = pd^T.do and dP = do.v^T with f32 operands;
// here pd enters the dv product as bf16 hi + lo (dv = hi^T.do + lo^T.do,
// mma.cuh's frag_to_a_split), which keeps its f32 precision (do and v are
// bf16 on this path already, so they lose nothing), and ds is rounded to
// bf16 for dq and dk as in JAX.
//
// What bounds it: at b.h 64, T = S = 400, D 128 the forward is 6 and the
// backward 10 b.h.T.S.D tensor-core operations (7.9 and 13.1 GFLOP at 989
// TFLOP/s: ~8 and ~13 us), against ~14 and ~22 us of bytes (the bf16 bias
// [BH, T, S] dominates). mma.sync reaches a fraction of the wgmma rate, and
// each block re-reads the bias in each sweep from L2.
#include "mma.cuh"

namespace tfasr {

namespace {

constexpr int AM_BLOCK = 64;    // query rows per block (forward, dq); keys per block (dk/dv)
constexpr int AM_KT = 64;       // key tile of the forward and dq sweeps
constexpr int AM_QT = 32;       // query tile of the dk/dv sweep
constexpr int AM_THREADS = 128; // 4 warps of 16 rows (or keys)
constexpr float AM_NEG_PAD = -1e30f;
constexpr unsigned int AM_SALT_BH = 40499u;

struct MmaArgs {
  int BH, T, S, D, Dp;    // Dp: D rounded up to 16
  size_t bias_bh_stride;  // T * S, or 0 for a broadcast bias
  int vec;                // 16-byte cp.async staging (D % 8 == 0 and aligned bases), else element copies
};

// Scores of a key tile: s += bias, columns past S -1e30. Fragment element e
// of n-tile nt is (row (e >> 1) of the thread's two rows, column col0 + nt *
// 8 + (e & 1)); b_lo / b_hi are the bias rows of those two rows (clamped to
// T - 1 for rows past T, which are never written).
template <typename TB, int NT>
__device__ __forceinline__ void am_scores(float (&s)[NT][4], const TB* b_lo, const TB* b_hi, int S, int col0) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = col0 + nt * 8 + (e & 1);
      s[nt][e] = col < S ? s[nt][e] + to_f32(((e >> 1) ? b_hi : b_lo)[col]) : AM_NEG_PAD;
    }
  }
}

template <typename TB, int DMAX>
__global__ void __launch_bounds__(AM_THREADS) attn_mma_fwd(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                                                           const TB* __restrict__ bias, bf16* __restrict__ out, float* __restrict__ stats,
                                                           MmaArgs a, Dropout dp) {
  extern __shared__ __align__(16) unsigned char am_smem[];
  const int LD = a.Dp + AM_PAD, nk = a.Dp / 16, T = a.T, S = a.S;
  bf16* q_s = reinterpret_cast<bf16*>(am_smem);  // [64][LD]
  bf16* k_s = q_s + AM_BLOCK * LD;               // [2][64][LD]
  bf16* v_s = k_s + 2 * AM_KT * LD;              // [2][64][LD]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, tig = lane & 3;
  const int bh = blockIdx.y, i0 = blockIdx.x * AM_BLOCK;
  const bf16* kb = k + (size_t)bh * S * a.D;
  const bf16* vb = v + (size_t)bh * S * a.D;
  const TB* brow = bias + (size_t)bh * a.bias_bh_stride;
  const int row_lo = i0 + warp * 16 + g;
  const TB* b_lo = brow + (size_t)min(row_lo, T - 1) * S;
  const TB* b_hi = brow + (size_t)min(row_lo + 8, T - 1) * S;
  const int nkt = (S + AM_KT - 1) / AM_KT;
  const bf16* qw = q_s + warp * 16 * LD;

  // sweep 1: row max and sum
  am_stage(q_s, q + (size_t)bh * T * a.D, i0, T, AM_BLOCK, a);
  am_stage(k_s, kb, 0, S, AM_KT, a);
  cp_async_commit();
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int j = 0; j < nkt; ++j) {
    if (j + 1 < nkt) {
      am_stage(k_s + ((j + 1) & 1) * AM_KT * LD, kb, (j + 1) * AM_KT, S, AM_KT, a);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float s[AM_KT / 8][4];
    am_abT<DMAX, AM_KT / 8>(s, qw, k_s + (j & 1) * AM_KT * LD, LD, nk, lane);
    am_scores<TB, AM_KT / 8>(s, b_lo, b_hi, S, j * AM_KT + tig * 2);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mt = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < AM_KT / 8; ++nt) mt = fmaxf(mt, fmaxf(s[nt][2 * h], s[nt][2 * h + 1]));
      const float mn = fmaxf(m[h], quad_max(mt));
      float add = 0.f;
#pragma unroll
      for (int nt = 0; nt < AM_KT / 8; ++nt) add += am_exp(s[nt][2 * h], mn) + am_exp(s[nt][2 * h + 1], mn);
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
  am_stage(k_s, kb, 0, S, AM_KT, a);
  am_stage(v_s, vb, 0, S, AM_KT, a);
  cp_async_commit();
  const unsigned int seed = dp.seed + (unsigned int)bh * AM_SALT_BH;
  const float inv_l[2] = {1.f / l[0], 1.f / l[1]};
  float o[DMAX / 8][4];
#pragma unroll
  for (int dt = 0; dt < DMAX / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  for (int j = 0; j < nkt; ++j) {
    if (j + 1 < nkt) {
      am_stage(k_s + ((j + 1) & 1) * AM_KT * LD, kb, (j + 1) * AM_KT, S, AM_KT, a);
      am_stage(v_s + ((j + 1) & 1) * AM_KT * LD, vb, (j + 1) * AM_KT, S, AM_KT, a);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float s[AM_KT / 8][4];
    am_abT<DMAX, AM_KT / 8>(s, qw, k_s + (j & 1) * AM_KT * LD, LD, nk, lane);
    am_scores<TB, AM_KT / 8>(s, b_lo, b_hi, S, j * AM_KT + tig * 2);
#pragma unroll
    for (int nt = 0; nt < AM_KT / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = am_exp(s[nt][e], m[e >> 1]) * inv_l[e >> 1];
        if (dp.on) p *= dropout_keep(dp, seed, row_lo + (e >> 1) * 8, j * AM_KT + tig * 2 + nt * 8 + (e & 1));
        s[nt][e] = p;
      }
    }
    uint32_t pa[AM_KT / 16][4];
    frag_to_a<AM_KT / 16>(pa, s);
    am_pv<DMAX, AM_KT / 16>(o, pa, v_s + (j & 1) * AM_KT * LD, LD, nk, lane);
    __syncthreads();
  }
  am_store<DMAX>(out + (size_t)bh * T * a.D, o, row_lo, T, a.D, tig * 2);
}

// delta[bh, row] = sum_d dout * out (f32 of the bf16 values), one warp per row.
__global__ void attn_mma_delta(const bf16* __restrict__ out, const bf16* __restrict__ dout, float* __restrict__ delta, int rows, int D) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;
  float s = 0.f;
  for (int d = lane; d < D; d += 32) s = fmaf(to_f32(dout[(size_t)row * D + d]), to_f32(out[(size_t)row * D + d]), s);
  s = warp_sum(s);
  if (lane == 0) delta[row] = s;
}

template <typename TB, int DMAX>
__global__ void __launch_bounds__(AM_THREADS) attn_mma_dq(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                                                          const TB* __restrict__ bias, const bf16* __restrict__ dout,
                                                          const float* __restrict__ stats, const float* __restrict__ delta,
                                                          float* __restrict__ dbias, bf16* __restrict__ dq, MmaArgs a, Dropout dp) {
  extern __shared__ __align__(16) unsigned char am_smem[];
  const int LD = a.Dp + AM_PAD, nk = a.Dp / 16, T = a.T, S = a.S;
  bf16* q_s = reinterpret_cast<bf16*>(am_smem);  // [64][LD]
  bf16* do_s = q_s + AM_BLOCK * LD;              // [64][LD]
  bf16* k_s = do_s + AM_BLOCK * LD;              // [2][64][LD]
  bf16* v_s = k_s + 2 * AM_KT * LD;              // [2][64][LD]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, tig = lane & 3;
  const int bh = blockIdx.y, i0 = blockIdx.x * AM_BLOCK;
  const bf16* kb = k + (size_t)bh * S * a.D;
  const bf16* vb = v + (size_t)bh * S * a.D;
  const TB* brow = bias + (size_t)bh * a.bias_bh_stride;
  const int row_lo = i0 + warp * 16 + g;
  const TB* b_lo = brow + (size_t)min(row_lo, T - 1) * S;
  const TB* b_hi = brow + (size_t)min(row_lo + 8, T - 1) * S;
  const int nkt = (S + AM_KT - 1) / AM_KT;

  am_stage(q_s, q + (size_t)bh * T * a.D, i0, T, AM_BLOCK, a);
  am_stage(do_s, dout + (size_t)bh * T * a.D, i0, T, AM_BLOCK, a);
  am_stage(k_s, kb, 0, S, AM_KT, a);
  am_stage(v_s, vb, 0, S, AM_KT, a);
  cp_async_commit();
  float m[2], inv_l[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_lo + h * 8;
    const bool ok = row < T;
    m[h] = ok ? stats[(size_t)bh * T + row] : 0.f;
    inv_l[h] = ok ? 1.f / stats[(size_t)(a.BH + bh) * T + row] : 1.f;
    dl[h] = ok ? delta[(size_t)bh * T + row] : 0.f;
  }
  const unsigned int seed = dp.seed + (unsigned int)bh * AM_SALT_BH;
  float acc[DMAX / 8][4];
#pragma unroll
  for (int dt = 0; dt < DMAX / 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  for (int j = 0; j < nkt; ++j) {
    if (j + 1 < nkt) {
      am_stage(k_s + ((j + 1) & 1) * AM_KT * LD, kb, (j + 1) * AM_KT, S, AM_KT, a);
      am_stage(v_s + ((j + 1) & 1) * AM_KT * LD, vb, (j + 1) * AM_KT, S, AM_KT, a);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kt = k_s + (j & 1) * AM_KT * LD;
    float s[AM_KT / 8][4], dpa[AM_KT / 8][4];
    am_abT<DMAX, AM_KT / 8>(s, q_s + warp * 16 * LD, kt, LD, nk, lane);
    am_abT<DMAX, AM_KT / 8>(dpa, do_s + warp * 16 * LD, v_s + (j & 1) * AM_KT * LD, LD, nk, lane);
    am_scores<TB, AM_KT / 8>(s, b_lo, b_hi, S, j * AM_KT + tig * 2);
#pragma unroll
    for (int nt = 0; nt < AM_KT / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, row = row_lo + h * 8, col = j * AM_KT + tig * 2 + nt * 8 + (e & 1);
        const float pn = am_exp(s[nt][e], m[h]) * inv_l[h];
        float dpv = dpa[nt][e];
        if (dp.on) dpv *= dropout_keep(dp, seed, row, col);
        const float ds = pn * (dpv - dl[h]);
        if (dbias != nullptr && row < T && col < S) dbias[((size_t)bh * T + row) * S + col] = ds;
        s[nt][e] = ds;
      }
    }
    uint32_t pa[AM_KT / 16][4];
    frag_to_a<AM_KT / 16>(pa, s);
    am_pv<DMAX, AM_KT / 16>(acc, pa, kt, LD, nk, lane);
    __syncthreads();
  }
  am_store<DMAX>(dq + (size_t)bh * T * a.D, acc, row_lo, T, a.D, tig * 2);
}

template <typename TB, int DMAX>
__global__ void __launch_bounds__(AM_THREADS) attn_mma_dkv(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                                                           const TB* __restrict__ bias, const bf16* __restrict__ dout,
                                                           const float* __restrict__ stats, const float* __restrict__ delta,
                                                           bf16* __restrict__ dk, bf16* __restrict__ dv, MmaArgs a, Dropout dp) {
  extern __shared__ __align__(16) unsigned char am_smem[];
  const int LD = a.Dp + AM_PAD, nk = a.Dp / 16, T = a.T, S = a.S;
  bf16* k_s = reinterpret_cast<bf16*>(am_smem);  // [64][LD] this block's keys
  bf16* v_s = k_s + AM_BLOCK * LD;               // [64][LD]
  bf16* q_s = v_s + AM_BLOCK * LD;               // [2][32][LD]
  bf16* do_s = q_s + 2 * AM_QT * LD;             // [2][32][LD]
  float* st_s = reinterpret_cast<float*>(do_s + 2 * AM_QT * LD);  // [2][3][32]: m, 1 / l, delta of the query tile
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, tig = lane & 3;
  const int bh = blockIdx.y, s0 = blockIdx.x * AM_BLOCK;
  const bf16* qb = q + (size_t)bh * T * a.D;
  const bf16* dob = dout + (size_t)bh * T * a.D;
  const TB* brow = bias + (size_t)bh * a.bias_bh_stride;
  const int key_lo = s0 + warp * 16 + g;
  const int nqt = (T + AM_QT - 1) / AM_QT;

  auto stage_stats = [&](int buf, int r0) {
    if (tid < AM_QT) {
      const int row = r0 + tid;
      const bool ok = row < T;
      float* st = st_s + buf * 3 * AM_QT;
      st[tid] = ok ? stats[(size_t)bh * T + row] : 0.f;
      st[AM_QT + tid] = ok ? 1.f / stats[(size_t)(a.BH + bh) * T + row] : 1.f;
      st[2 * AM_QT + tid] = ok ? delta[(size_t)bh * T + row] : 0.f;
    }
  };
  am_stage(k_s, k + (size_t)bh * S * a.D, s0, S, AM_BLOCK, a);
  am_stage(v_s, v + (size_t)bh * S * a.D, s0, S, AM_BLOCK, a);
  am_stage(q_s, qb, 0, T, AM_QT, a);
  am_stage(do_s, dob, 0, T, AM_QT, a);
  stage_stats(0, 0);
  cp_async_commit();
  const unsigned int seed = dp.seed + (unsigned int)bh * AM_SALT_BH;
  float adk[DMAX / 8][4], adv[DMAX / 8][4];
#pragma unroll
  for (int dt = 0; dt < DMAX / 8; ++dt) {
    adk[dt][0] = adk[dt][1] = adk[dt][2] = adk[dt][3] = 0.f;
    adv[dt][0] = adv[dt][1] = adv[dt][2] = adv[dt][3] = 0.f;
  }
  for (int j = 0; j < nqt; ++j) {
    if (j + 1 < nqt) {
      const int nb = (j + 1) & 1;
      am_stage(q_s + nb * AM_QT * LD, qb, (j + 1) * AM_QT, T, AM_QT, a);
      am_stage(do_s + nb * AM_QT * LD, dob, (j + 1) * AM_QT, T, AM_QT, a);
      stage_stats(nb, (j + 1) * AM_QT);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int cb = j & 1, q0 = j * AM_QT;
    const bf16* qt = q_s + cb * AM_QT * LD;
    const bf16* dot = do_s + cb * AM_QT * LD;
    const float* st = st_s + cb * 3 * AM_QT;
    float sT[AM_QT / 8][4], dpT[AM_QT / 8][4];
    am_abT<DMAX, AM_QT / 8>(sT, k_s + warp * 16 * LD, qt, LD, nk, lane);
    am_abT<DMAX, AM_QT / 8>(dpT, v_s + warp * 16 * LD, dot, LD, nk, lane);
#pragma unroll
    for (int nt = 0; nt < AM_QT / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key_lo + (e >> 1) * 8, qi = nt * 8 + tig * 2 + (e & 1), row = q0 + qi;
        float pd = 0.f, ds = 0.f;
        if (key < S && row < T) {
          const float pn = am_exp(sT[nt][e] + to_f32(brow[(size_t)row * S + key]), st[qi]) * st[AM_QT + qi];
          float dpv = dpT[nt][e];
          pd = pn;
          if (dp.on) {
            const float keep = dropout_keep(dp, seed, row, key);
            pd = pn * keep;
            dpv *= keep;
          }
          ds = pn * (dpv - st[2 * AM_QT + qi]);
        }
        sT[nt][e] = pd;
        dpT[nt][e] = ds;
      }
    }
    uint32_t pa[AM_QT / 16][4], plo[AM_QT / 16][4];
    frag_to_a_split<AM_QT / 16>(pa, plo, sT);
    am_pv<DMAX, AM_QT / 16>(adv, pa, dot, LD, nk, lane);
    am_pv<DMAX, AM_QT / 16>(adv, plo, dot, LD, nk, lane);
    frag_to_a<AM_QT / 16>(pa, dpT);
    am_pv<DMAX, AM_QT / 16>(adk, pa, qt, LD, nk, lane);
    __syncthreads();
  }
  am_store<DMAX>(dk + (size_t)bh * S * a.D, adk, key_lo, S, a.D, tig * 2);
  am_store<DMAX>(dv + (size_t)bh * S * a.D, adv, key_lo, S, a.D, tig * 2);
}

size_t am_fwd_smem(int Dp) { return (size_t)(AM_BLOCK + 4 * AM_KT) * (Dp + AM_PAD) * sizeof(bf16); }
size_t am_dq_smem(int Dp) { return (size_t)(2 * AM_BLOCK + 4 * AM_KT) * (Dp + AM_PAD) * sizeof(bf16); }
size_t am_dkv_smem(int Dp) { return (size_t)(2 * AM_BLOCK + 4 * AM_QT) * (Dp + AM_PAD) * sizeof(bf16) + 6 * AM_QT * sizeof(float); }

MmaArgs am_args(const void* const* ptrs, int n, int BH, int T, int S, int D, int bias_bh) {
  MmaArgs a{BH, T, S, D, (D + 15) / 16 * 16, bias_bh == 1 ? (size_t)0 : (size_t)T * S, D % 8 == 0};
  for (int i = 0; i < n; ++i) a.vec = a.vec && (reinterpret_cast<uintptr_t>(ptrs[i]) & 15) == 0;
  return a;
}

template <typename TB, int DMAX>
int fwd_launch(const void* q, const void* k, const void* v, const void* bias, void* out, float* stats, const MmaArgs& a, Dropout dp,
               cudaStream_t stream) {
  const size_t smem = am_fwd_smem(a.Dp);
  cudaError_t err = allow_smem(attn_mma_fwd<TB, DMAX>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.T + AM_BLOCK - 1) / AM_BLOCK, a.BH);
  attn_mma_fwd<TB, DMAX><<<grid, AM_THREADS, smem, stream>>>((const bf16*)q, (const bf16*)k, (const bf16*)v, (const TB*)bias, (bf16*)out,
                                                             stats, a, dp);
  return (int)cudaGetLastError();
}

template <typename TB, int DMAX>
int bwd_launch(const void* q, const void* k, const void* v, const void* bias, const void* out, const void* dout, const float* stats,
               float* delta, float* dbias, void* dq, void* dk, void* dv, const MmaArgs& a, Dropout dp, cudaStream_t stream) {
  const int rows = a.BH * a.T;
  attn_mma_delta<<<(rows + 7) / 8, 256, 0, stream>>>((const bf16*)out, (const bf16*)dout, delta, rows, a.D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  size_t smem = am_dq_smem(a.Dp);
  if ((err = allow_smem(attn_mma_dq<TB, DMAX>, smem)) != cudaSuccess) return (int)err;
  dim3 grid((a.T + AM_BLOCK - 1) / AM_BLOCK, a.BH);
  attn_mma_dq<TB, DMAX><<<grid, AM_THREADS, smem, stream>>>((const bf16*)q, (const bf16*)k, (const bf16*)v, (const TB*)bias,
                                                            (const bf16*)dout, stats, delta, dbias, (bf16*)dq, a, dp);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  smem = am_dkv_smem(a.Dp);
  if ((err = allow_smem(attn_mma_dkv<TB, DMAX>, smem)) != cudaSuccess) return (int)err;
  dim3 grid_kv((a.S + AM_BLOCK - 1) / AM_BLOCK, a.BH);
  attn_mma_dkv<TB, DMAX><<<grid_kv, AM_THREADS, smem, stream>>>((const bf16*)q, (const bf16*)k, (const bf16*)v, (const TB*)bias,
                                                                (const bf16*)dout, stats, delta, (bf16*)dk, (bf16*)dv, a, dp);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 q/k/v [BH, T|S, D]; bias [BH or 1, T, S] in bf16 (bias_bf16) or f32;
// out [BH, T, D]; stats [2, BH, T] f32 (m, then l) or NULL. D <= 128.
int launch_attention_mma(const void* q, const void* k, const void* v, const void* bias, int bias_bf16, void* out, float* stats, int BH, int T,
                         int S, int D, int bias_bh, Dropout dp, cudaStream_t stream) {
  const void* ptrs[4] = {q, k, v, out};
  const MmaArgs a = am_args(ptrs, 4, BH, T, S, D, bias_bh);
  if (a.Dp <= 64)
    return bias_bf16 ? fwd_launch<bf16, 64>(q, k, v, bias, out, stats, a, dp, stream) : fwd_launch<float, 64>(q, k, v, bias, out, stats, a, dp, stream);
  return bias_bf16 ? fwd_launch<bf16, 128>(q, k, v, bias, out, stats, a, dp, stream) : fwd_launch<float, 128>(q, k, v, bias, out, stats, a, dp, stream);
}

// Gradients: out, dout [BH, T, D]; stats from the forward; delta [BH, T] f32
// scratch; dbias [BH, T, S] f32 or NULL; dq [BH, T, D], dk, dv [BH, S, D].
int launch_attention_mma_bwd(const void* q, const void* k, const void* v, const void* bias, int bias_bf16, const void* out, const void* dout,
                             const float* stats, float* delta, float* dbias, void* dq, void* dk, void* dv, int BH, int T, int S, int D,
                             int bias_bh, Dropout dp, cudaStream_t stream) {
  const void* ptrs[8] = {q, k, v, dout, dq, dk, dv, out};
  const MmaArgs a = am_args(ptrs, 8, BH, T, S, D, bias_bh);
  if (a.Dp <= 64)
    return bias_bf16 ? bwd_launch<bf16, 64>(q, k, v, bias, out, dout, stats, delta, dbias, dq, dk, dv, a, dp, stream)
                     : bwd_launch<float, 64>(q, k, v, bias, out, dout, stats, delta, dbias, dq, dk, dv, a, dp, stream);
  return bias_bf16 ? bwd_launch<bf16, 128>(q, k, v, bias, out, dout, stats, delta, dbias, dq, dk, dv, a, dp, stream)
                   : bwd_launch<float, 128>(q, k, v, bias, out, dout, stats, delta, dbias, dq, dk, dv, a, dp, stream);
}

}  // namespace tfasr
