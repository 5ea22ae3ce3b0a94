// The fused Conformer feed-forward module in bf16 on the tensor cores,
// forward and backward:
//   out = x + factor * drop2(W2 . drop1(swish(W1 . LN(x) + b1)) + b2)
// The f32 instantiation stays on the CUDA-core kernels of ff.cu, whose C
// entry points dispatch here for bf16 inputs.
//
// Counterpart of tensorflowasr_tpu/ops/pallas/ff_kernel.py fused_ff
// (_fwd_kernel, _bwd_kernel, ff_kernel.py:63-159). Every product is an
// mma.sync m16n8k16 with bf16 operands and f32 accumulators; operands come
// from shared memory by ldmatrix. Widths need no alignment: D is padded to a
// multiple of 16 and F to the 64-wide chunk with zeros in shared memory only
// (D 144 = 9 x 16 and 176 = 11 x 16 need no padding).
//
// Row tile. A block of FQ x RG warps owns 16 x RG rows: warp w takes the 16
// rows (w % RG) and the part (w / RG) of FQ of every 64-wide F chunk (each F
// part forms its own z, summed in F order at the end). W1[:, chunk]
// and W2[chunk, :] are double-buffered in shared memory with cp.async, so a
// call reads the weights from L2 once per block. The backward uses RG = 4
// (64 rows, 8 warps, FQ = 2): ceil(N / 64) weight reads (100 at N = 6400,
// against 400 for the 16-row tiles of ff.cu), and one 64-row block per SM
// already holds 8 warps. The forward takes 64 rows (RG 4, FQ 2) or 32 rows
// (RG 2, FQ 4), both 8 warps, from the caller: ops/cuda/ff_kernel.py:
// ff_fwd_rows takes 32 where the grid of 32-row blocks runs in one wave
// (SMs x the card's blocks per SM of that kernel), else 64. A block's time
// is set by its warps' serial chain over the F chunks, not by its rows: at
// the serving N = 2000 (D 144) 64 rows take 0.073 ms in 32 blocks and 32
// rows 0.050 ms in 63; at N = 6400 32 rows win at D 144 (200 blocks, two
// per SM) and lose at D 176, where one block fits per SM (PERF.md, PR 8). Shared memory (ff_mma_plan in
// ops/cuda/ff_kernel.py; the card checks the kernel's own count against
// it): the LN output (and dz) as bf16 rows plus two weight chunks, ~117 KiB at D 144 and ~142 KiB at D 176 for
// 64 rows: one block per SM at both widths (the 16-row CUDA-core backward
// fit two per SM at D 144 and one at D 176 for its 400 blocks, which is
// what made D 176 take twice the time of D 144).
//
// Forward: h = y_bf16 . W1c, a = swish(h + b1) * keep1 rounded to bf16 in
// registers (JAX casts it before the W2 product), z += a . W2c; the F parts'
// z meet in shared memory at the end (a fixed order), and out = x + factor *
// (z + b2) * keep2.
//
// Backward (ff_kernel.py:114-159), recomputing LN, h, swish and both masks
// from the saved inputs as the Pallas VJP does:
//  1. ff_mma_bwd_rows: per 64 rows, dz = factor * dout * keep2, da = dz_bf16 .
//     W2c^T, dh = da * keep1 * swish'(h), dy += dh_bf16 . W1c^T, then the
//     LayerNorm backward into dx. The weight gradients' f32 row operands (y,
//     dz [N, D], the dropped activation ad and dh [N, F]) go to scratch split
//     into bf16 hi + lo (x = hi + lo to ~2^-18 relative; the bytes of f32),
//     and the column sums db1, db2, dgamma, dbeta leave as one partial row
//     per 16 rows (summed in that row order inside the warp).
//  2. ff_mma_atb: dW1 = y^T . dh and dW2 = ad^T . dz, f32 operands as JAX
//     forms them, as hi.hi + hi.lo + lo.hi on the tensor cores with f32
//     accumulation; 32-row stages double-buffered with cp.async. The rows
//     are cut into a fixed split
//     (a function of N, M and K only), each block sums its rows in order into
//     a partial, and sum_partials_kernel (row_reduce.cu) adds the partials,
//     and the column-sum partials, in order: the same bits on every run, no
//     atomics.
// What bounds it: at N 6400, D 144, F 576 the backward's row products are
// 3.2 GFLOP and the split weight-gradient products 6.4 GFLOP of tensor-core
// work (~10 us at 989 TFLOP/s), beside ~37 MB of split scratch written and
// read once (~22 us at 3.35 TB/s); mma.sync and one block per SM reach a fraction
// of either.
#include "mma.cuh"

namespace tfasr {

namespace {

constexpr int FM_ROWS = 64;      // rows per backward block: 4 row groups of 16
constexpr int FM_FC = 64;        // F columns per chunk; each F half takes 32
constexpr int FM_THREADS = 256;  // 8 warps
constexpr int FM_LDF = FM_FC + AM_PAD;
constexpr int FM_WT = 64;        // weight-gradient tile, M and K
constexpr int FM_WR = 32;        // rows per stage of the weight-gradient product
constexpr int FM_WLD = FM_WT + AM_PAD;
constexpr unsigned int FM_SALT_SITE2 = 7919u;  // ff_kernel._SALT_SITE2

struct FFArgs {
  int N, D, F, Dp, nch;  // Dp: D rounded up to 16; nch: F chunks
  int vec;               // 16-byte cp.async staging of the weights (8 | D, 8 | F, aligned), else element copies
  float eps, factor;
};

// Stage the weight chunk c into w1 [Dp][FM_LDF] (W1[:, chunk]) and w2
// [FM_FC][Dp + AM_PAD] (W2[chunk, :]); rows and columns past D or F zero.
__device__ __forceinline__ void fm_stage_w(bf16* w1s, bf16* w2s, const bf16* w1, const bf16* w2, int c, const FFArgs& a) {
  const int f0 = c * FM_FC, D = a.D, F = a.F, LDD = a.Dp + AM_PAD;
  if (a.vec) {
    for (int i = threadIdx.x; i < a.Dp * (FM_FC / 8); i += blockDim.x) {
      const int d = i / (FM_FC / 8), f = (i % (FM_FC / 8)) * 8;
      const bool ok = d < D && f0 + f < F;
      cp_async16(smem_u32(w1s + d * FM_LDF + f), ok ? w1 + (size_t)d * F + f0 + f : w1, ok ? 16 : 0);
    }
    am_stage(w2s, w2, f0, F, FM_FC, D, a.Dp, 1);
  } else {
    for (int i = threadIdx.x; i < a.Dp * FM_FC; i += blockDim.x) {
      const int d = i / FM_FC, f = i % FM_FC;
      w1s[d * FM_LDF + f] = (d < D && f0 + f < F) ? w1[(size_t)d * F + f0 + f] : __float2bfloat16(0.f);
    }
    for (int i = threadIdx.x; i < FM_FC * a.Dp; i += blockDim.x) {
      const int f = i / a.Dp, d = i % a.Dp;
      w2s[f * LDD + d] = (d < D && f0 + f < F) ? w2[(size_t)(f0 + f) * D + d] : __float2bfloat16(0.f);
    }
  }
}

// acc[NT] (16 rows x 8 NT columns at col0 of the chunk) = A (16 rows at
// a_s, [16][ld] bf16) . W1c[:, col0..] (stored [Dp][FM_LDF]).
template <int DMAX, int NT = 4>
__device__ __forceinline__ void fm_times_w1(float (&acc)[NT][4], const bf16* a_s, int ld, const bf16* w1s, int col0, int nk, int lane) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DMAX / 16; ++kk) {
    if (kk < nk) {
      uint32_t af[4];
      load_a(af, a_s + kk * 16, ld, lane);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        load_b_kn(b, w1s + kk * 16 * FM_LDF + col0 + np * 16, FM_LDF, lane);
        mma16816(acc[2 * np], af, b[0], b[1]);
        mma16816(acc[2 * np + 1], af, b[2], b[3]);
      }
    }
  }
}

// Zero the pad columns D..Dp of the block's `rows` bf16 rows.
__device__ __forceinline__ void fm_zero_pad(bf16* s, int rows, int ld, int D, int Dp) {
  for (int i = threadIdx.x; i < rows * (Dp - D); i += blockDim.x) s[(i / (Dp - D)) * ld + D + i % (Dp - D)] = __float2bfloat16(0.f);
}

// The forward: RG row groups of 16 rows, each F chunk split over FQ warps
// (FQ x RG warps; each takes 64 / FQ columns of the chunk).
template <int DMAX, int RG, int FQ>
__global__ void __launch_bounds__(32 * RG * FQ, 1) ff_mma_fwd(const bf16* __restrict__ x, const float* __restrict__ gamma,
                                                             const float* __restrict__ beta, const bf16* __restrict__ w1,
                                                             const bf16* __restrict__ b1, const bf16* __restrict__ w2,
                                                             const bf16* __restrict__ b2, bf16* __restrict__ out, FFArgs a, Dropout dp) {
  constexpr int ROWS = 16 * RG, WARPS = RG * FQ, FW = FM_FC / FQ;  // FW: the warp's columns of a chunk
  extern __shared__ __align__(16) unsigned char fm_smem[];
  const int Dp = a.Dp, LDD = Dp + AM_PAD, nk = Dp / 16, D = a.D, F = a.F, N = a.N;
  bf16* y_s = reinterpret_cast<bf16*>(fm_smem);  // [ROWS][LDD] LN output
  bf16* w1_s = y_s + ROWS * LDD;                 // [2][Dp][FM_LDF]
  bf16* w2_s = w1_s + 2 * Dp * FM_LDF;           // [2][FM_FC][LDD]
  float* zx_s = reinterpret_cast<float*>(w1_s);  // [FQ - 1][ROWS][Dp] the other F parts' z, after the loop
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, tig = lane & 3;
  const int rg = warp % RG, fh = warp / RG;
  const int row0 = blockIdx.x * ROWS;
  const int row_lo = row0 + rg * 16 + g;

  fm_stage_w(w1_s, w2_s, w1, w2, 0, a);
  cp_async_commit();
  for (int r = warp; r < ROWS; r += WARPS) {
    bf16* dst = y_s + r * LDD;
    if (row0 + r < N)
      ln_row_warp<bf16>(x + (size_t)(row0 + r) * D, gamma, beta, D, a.eps, dst, lane);
    else
      for (int c = lane; c < D; c += 32) dst[c] = __float2bfloat16(0.f);
  }
  fm_zero_pad(y_s, ROWS, LDD, D, Dp);

  float z[DMAX / 8][4];
#pragma unroll
  for (int dt = 0; dt < DMAX / 8; ++dt) z[dt][0] = z[dt][1] = z[dt][2] = z[dt][3] = 0.f;
  const bf16* yw = y_s + rg * 16 * LDD;
  for (int c = 0; c < a.nch; ++c) {
    if (c + 1 < a.nch) {
      fm_stage_w(w1_s + ((c + 1) & 1) * Dp * FM_LDF, w2_s + ((c + 1) & 1) * FM_FC * LDD, w1, w2, c + 1, a);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* w1c = w1_s + (c & 1) * Dp * FM_LDF;
    const bf16* w2c = w2_s + (c & 1) * FM_FC * LDD;
    float h[FW / 8][4];
    fm_times_w1<DMAX, FW / 8>(h, yw, LDD, w1c, fh * FW, nk, lane);
#pragma unroll
    for (int nt = 0; nt < FW / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int f = c * FM_FC + fh * FW + nt * 8 + 2 * tig + (e & 1);
        float act = 0.f;
        if (f < F) {
          const float hh = h[nt][e] + to_f32(b1[f]);
          act = hh * sigmoid_f32(hh);
          if (dp.on) act *= dropout_keep(dp, dp.seed, row_lo + (e >> 1) * 8, f);
        }
        h[nt][e] = act;
      }
    }
    uint32_t pa[FW / 16][4];
    frag_to_a<FW / 16>(pa, h);
    am_pv<DMAX, FW / 16>(z, pa, w2c + fh * FW * LDD, LDD, nk, lane);
    __syncthreads();
  }

  if (fh > 0) {
    float* zx = zx_s + (size_t)(fh - 1) * ROWS * Dp;
#pragma unroll
    for (int dt = 0; dt < DMAX / 8; ++dt)
      if (dt < Dp / 8)
#pragma unroll
        for (int e = 0; e < 4; ++e) zx[(rg * 16 + g + (e >> 1) * 8) * Dp + dt * 8 + 2 * tig + (e & 1)] = z[dt][e];
  }
  __syncthreads();
  if (fh == 0) {
#pragma unroll
    for (int dt = 0; dt < DMAX / 8; ++dt) {
      if (dt < Dp / 8) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = rg * 16 + g + (e >> 1) * 8, row = row0 + r, col = dt * 8 + 2 * tig + (e & 1);
          if (row < N && col < D) {
            const size_t off = (size_t)row * D + col;
            float zz = z[dt][e];
#pragma unroll
            for (int q = 0; q < FQ - 1; ++q) zz += zx_s[((size_t)q * ROWS + r) * Dp + col];  // in F order
            zz += to_f32(b2[col]);
            if (dp.on) zz *= dropout_keep(dp, dp.seed + FM_SALT_SITE2, row, col);
            out[off] = __float2bfloat16(to_f32(x[off]) + a.factor * zz);
          }
        }
      }
    }
  }
}

// Backward rows pass; see the header. part [4 * blocks][F + 3D]: per 16 rows
// the column sums of dh (db1), dz (db2), dy * xhat (dgamma) and dy (dbeta).
template <int DMAX>
__global__ void __launch_bounds__(FM_THREADS, 1) ff_mma_bwd_rows(const bf16* __restrict__ x, const float* __restrict__ gamma,
                                                                const float* __restrict__ beta, const bf16* __restrict__ w1,
                                                                const bf16* __restrict__ b1, const bf16* __restrict__ w2,
                                                                const bf16* __restrict__ dout, bf16* __restrict__ dx,
                                                                Split y_o, Split dz_o, Split ad_o, Split dh_o, float* __restrict__ part, FFArgs a,
                                                                Dropout dp) {
  extern __shared__ __align__(16) unsigned char fm_smem[];
  const int Dp = a.Dp, LDD = Dp + AM_PAD, nk = Dp / 16, D = a.D, F = a.F, N = a.N;
  bf16* y_s = reinterpret_cast<bf16*>(fm_smem);  // [64][LDD] LN output
  bf16* dz_s = y_s + FM_ROWS * LDD;              // [64][LDD] dz
  bf16* w1_s = dz_s + FM_ROWS * LDD;             // [2][Dp][FM_LDF]
  bf16* w2_s = w1_s + 2 * Dp * FM_LDF;           // [2][FM_FC][LDD]
  float* mu_s = reinterpret_cast<float*>(w2_s + 2 * FM_FC * LDD);  // [64]
  float* rstd_s = mu_s + FM_ROWS;                                   // [64]
  float* dyx_s = reinterpret_cast<float*>(w1_s);  // [64][Dp] the second F half's dy, after the loop
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, tig = lane & 3;
  const int rg = warp & 3, fh = warp >> 2;
  const int row0 = blockIdx.x * FM_ROWS;
  const int row_lo = row0 + rg * 16 + g;
  const int C = F + 3 * D;
  float* prow = part + (size_t)(blockIdx.x * 4 + rg) * C;  // this row group's column sums

  fm_stage_w(w1_s, w2_s, w1, w2, 0, a);
  cp_async_commit();
  for (int r = warp; r < FM_ROWS; r += FM_THREADS / 32) {
    const int row = row0 + r;
    bf16* ys = y_s + r * LDD;
    bf16* dzs = dz_s + r * LDD;
    if (row >= N) {
      for (int c = lane; c < D; c += 32) ys[c] = dzs[c] = __float2bfloat16(0.f);
      continue;
    }
    const bf16* xr = x + (size_t)row * D;
    float s = 0.f;
    for (int c = lane; c < D; c += 32) s += to_f32(xr[c]);
    const float mu = warp_sum(s) / (float)D;
    float q = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float cx = to_f32(xr[c]) - mu;
      q = fmaf(cx, cx, q);
    }
    const float rstd = rsqrtf(warp_sum(q) / (float)D + a.eps);
    if (lane == 0) mu_s[r] = mu, rstd_s[r] = rstd;
    for (int c = lane; c < D; c += 32) {
      const size_t off = (size_t)row * D + c;
      const float y = (to_f32(xr[c]) - mu) * rstd * gamma[c] + beta[c];
      ys[c] = __float2bfloat16(y);
      put_split(y_o, row, c, y);
      float dz = a.factor * to_f32(dout[off]);
      if (dp.on) dz *= dropout_keep(dp, dp.seed + FM_SALT_SITE2, row, c);
      dzs[c] = __float2bfloat16(dz);
      put_split(dz_o, row, c, dz);
    }
  }
  fm_zero_pad(y_s, FM_ROWS, LDD, D, Dp);
  fm_zero_pad(dz_s, FM_ROWS, LDD, D, Dp);

  float dy[DMAX / 8][4];
#pragma unroll
  for (int dt = 0; dt < DMAX / 8; ++dt) dy[dt][0] = dy[dt][1] = dy[dt][2] = dy[dt][3] = 0.f;
  const bf16* yw = y_s + rg * 16 * LDD;
  const bf16* dzw = dz_s + rg * 16 * LDD;
  for (int c = 0; c < a.nch; ++c) {
    if (c + 1 < a.nch) {
      fm_stage_w(w1_s + ((c + 1) & 1) * Dp * FM_LDF, w2_s + ((c + 1) & 1) * FM_FC * LDD, w1, w2, c + 1, a);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* w1c = w1_s + (c & 1) * Dp * FM_LDF;
    const bf16* w2c = w2_s + (c & 1) * FM_FC * LDD;
    float h[4][4], da[4][4];
    fm_times_w1<DMAX>(h, yw, LDD, w1c, fh * 32, nk, lane);
    am_abT<DMAX, 4>(da, dzw, w2c + fh * 32 * LDD, LDD, nk, lane);  // dz . W2c^T: W2c rows are the output columns
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int fc = c * FM_FC + fh * 32 + nt * 8 + 2 * tig;
      float ad[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int f = fc + (e & 1), row = row_lo + (e >> 1) * 8;
        float dh = 0.f;
        ad[e] = 0.f;
        if (f < F && row < N) {
          const float hh = h[nt][e] + to_f32(b1[f]);
          const float sig = sigmoid_f32(hh);
          float dav = da[nt][e];
          ad[e] = hh * sig;
          if (dp.on) {
            const float keep = dropout_keep(dp, dp.seed, row, f);
            ad[e] *= keep;
            dav *= keep;
          }
          dh = dav * (sig + hh * sig * (1.f - sig));
        }
        h[nt][e] = dh;
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {  // F columns fc, fc + 1 of rows row_lo, row_lo + 8 (fc + 1 < Fq: both even)
        const int row = row_lo + 8 * hf;
        if (fc < F && row < N) {
          put_split2(ad_o, row, fc, ad[2 * hf], ad[2 * hf + 1]);
          put_split2(dh_o, row, fc, h[nt][2 * hf], h[nt][2 * hf + 1]);
        }
      }
      const float s0 = col_sum8(h[nt][0] + h[nt][2]), s1 = col_sum8(h[nt][1] + h[nt][3]);
      if (g == 0) {
        if (fc < F) prow[fc] = s0;
        if (fc + 1 < F) prow[fc + 1] = s1;
      }
    }
    uint32_t pa[2][4];
    frag_to_a<2>(pa, h);
    // dy += dh_bf16 . W1c^T: W1c rows (d) are the output columns, its columns the summed index
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
      for (int dpn = 0; dpn < DMAX / 16; ++dpn) {
        if (dpn < nk) {
          uint32_t b[4];
          load_b_nk(b, w1c + dpn * 16 * FM_LDF + fh * 32 + ks * 16, FM_LDF, lane);
          mma16816(dy[2 * dpn], pa[ks], b[0], b[1]);
          mma16816(dy[2 * dpn + 1], pa[ks], b[2], b[3]);
        }
      }
    }
    __syncthreads();
  }

  if (fh == 1) {
#pragma unroll
    for (int dt = 0; dt < DMAX / 8; ++dt)
      if (dt < Dp / 8)
#pragma unroll
        for (int e = 0; e < 4; ++e) dyx_s[(rg * 16 + g + (e >> 1) * 8) * Dp + dt * 8 + 2 * tig + (e & 1)] = dy[dt][e];
  }
  __syncthreads();
  if (fh == 1) return;
  // LayerNorm backward (y = xhat * gamma + beta) of the row group's 16 rows
  float mu[2], rstd[2], s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) mu[hf] = mu_s[rg * 16 + g + 8 * hf], rstd[hf] = rstd_s[rg * 16 + g + 8 * hf];
#pragma unroll
  for (int dt = 0; dt < DMAX / 8; ++dt) {
    if (dt < Dp / 8) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hf = e >> 1, r = rg * 16 + g + 8 * hf, row = row0 + r, col = dt * 8 + 2 * tig + (e & 1);
        float v = 0.f;
        if (row < N && col < D) {
          v = dy[dt][e] + dyx_s[r * Dp + col];
          const float xhat = (to_f32(x[(size_t)row * D + col]) - mu[hf]) * rstd[hf];
          const float dxn = v * gamma[col];
          s1[hf] += dxn;
          s2[hf] = fmaf(dxn, xhat, s2[hf]);
        }
        dy[dt][e] = v;
      }
    }
  }
  float m1[2], m2[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) m1[hf] = quad_sum(s1[hf]) / (float)D, m2[hf] = quad_sum(s2[hf]) / (float)D;
#pragma unroll
  for (int dt = 0; dt < DMAX / 8; ++dt) {
    if (dt < Dp / 8) {
      float cg[2] = {0.f, 0.f}, cb[2] = {0.f, 0.f}, cz[2] = {0.f, 0.f};  // column sums of dy * xhat, dy, dz
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hf = e >> 1, row = row_lo + 8 * hf, col = dt * 8 + 2 * tig + (e & 1);
        if (row < N && col < D) {
          const size_t off = (size_t)row * D + col;
          const float xhat = (to_f32(x[off]) - mu[hf]) * rstd[hf];
          const float v = dy[dt][e], dov = to_f32(dout[off]);
          dx[off] = __float2bfloat16(dov + rstd[hf] * (v * gamma[col] - m1[hf] - xhat * m2[hf]));
          float dz = a.factor * dov;
          if (dp.on) dz *= dropout_keep(dp, dp.seed + FM_SALT_SITE2, row, col);
          cg[e & 1] += v * xhat;
          cb[e & 1] += v;
          cz[e & 1] += dz;
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float sz = col_sum8(cz[j]), sg = col_sum8(cg[j]), sb = col_sum8(cb[j]);
        const int col = dt * 8 + 2 * tig + j;
        if (g == 0 && col < D) prow[F + col] = sz, prow[F + D + col] = sg, prow[F + 2 * D + col] = sb;
      }
    }
  }
}

// partial[split][M][K] = sum over the split's rows n of A[n, m] B[n, k], A and
// B given as bf16 hi + lo: hi.hi + hi.lo + lo.hi, f32 accumulation. 4 warps,
// a 64 x 64 tile (warp w owns m rows 16w.., all 64 k columns); 32-row stages
// of the four bf16 operands double-buffered with cp.async.
__global__ void __launch_bounds__(128) ff_mma_atb(Split A, Split B, float* __restrict__ partial, int N, int M, int K, int rows_per_split) {
  __shared__ __align__(16) bf16 s[2][4][FM_WR][FM_WLD];  // per buffer: A hi, A lo, B hi, B lo, [row][column]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, tig = lane & 3;
  const int m0 = blockIdx.y * FM_WT, k0 = blockIdx.x * FM_WT, split = blockIdx.z;
  const int n_begin = split * rows_per_split, n_end = min(N, n_begin + rows_per_split);
  auto stage = [&](int buf, int n0) {
    for (int i = tid; i < 4 * FM_WR * (FM_WT / 8); i += blockDim.x) {
      const int arr = i / (FM_WR * (FM_WT / 8)), r = (i / (FM_WT / 8)) % FM_WR, c = (i % (FM_WT / 8)) * 8, n = n0 + r;
      const Split& x = arr < 2 ? A : B;
      const int c0 = arr < 2 ? m0 : k0;
      const bool ok = n < n_end && c0 + c < x.ld;
      const bf16* src = (arr & 1) ? x.lo : x.hi;
      cp_async16(smem_u32(&s[buf][arr][r][c]), ok ? src + (size_t)n * x.ld + c0 + c : src, ok ? 16 : 0);
    }
  };
  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  const int nst = (n_end - n_begin + FM_WR - 1) / FM_WR;
  if (nst > 0) stage(0, n_begin);
  cp_async_commit();
  for (int st = 0; st < nst; ++st) {
    if (st + 1 < nst) {
      stage((st + 1) & 1, n_begin + (st + 1) * FM_WR);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int b = st & 1;
#pragma unroll
    for (int ks = 0; ks < FM_WR / 16; ++ks) {
      uint32_t ah[4], al[4];
      load_a_t(ah, &s[b][0][ks * 16][warp * 16], FM_WLD, lane);
      load_a_t(al, &s[b][1][ks * 16][warp * 16], FM_WLD, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bh[4], bl[4];
        load_b_kn(bh, &s[b][2][ks * 16][np * 16], FM_WLD, lane);
        load_b_kn(bl, &s[b][3][ks * 16][np * 16], FM_WLD, lane);
        mma16816(acc[2 * np], al, bh[0], bh[1]);
        mma16816(acc[2 * np + 1], al, bh[2], bh[3]);
        mma16816(acc[2 * np], ah, bl[0], bl[1]);
        mma16816(acc[2 * np + 1], ah, bl[2], bl[3]);
        mma16816(acc[2 * np], ah, bh[0], bh[1]);
        mma16816(acc[2 * np + 1], ah, bh[2], bh[3]);
      }
    }
    __syncthreads();
  }
  float* out = partial + (size_t)split * M * K;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = m0 + warp * 16 + g + (e >> 1) * 8, k = k0 + nt * 8 + 2 * tig + (e & 1);
      if (m < M && k < K) out[(size_t)m * K + k] = acc[nt][e];
    }
  }
}

// Fixed row split of the weight-gradient product: ~2 blocks per SM of the
// 132, at least 256 rows per split; a function of N, M and K only.
int fm_splits(int N, int M, int K) {
  const int tiles = ((M + FM_WT - 1) / FM_WT) * ((K + FM_WT - 1) / FM_WT);
  const int most = (N + 255) / 256;
  int s = (264 + tiles - 1) / tiles;
  s = s > most ? most : s;
  return s < 1 ? 1 : s;
}

// Rows per split: ceil(N / splits) rounded up to the FM_WR-row stage.
int fm_rows_per_split(int N, int splits) { return ((N + splits - 1) / splits + FM_WR - 1) / FM_WR * FM_WR; }

// Scratch of the backward: the weight-gradient operands y, dz [N, Dq] and ad,
// dh [N, Fq] as bf16 hi and lo (Dq, Fq: D, F rounded up to 8, so that every
// row is 16-byte aligned), then f32 column-sum partials and weight-gradient
// partials; offsets in floats.
struct FMScratch {
  int Dq, Fq;
  size_t y, dz, ad, dh, part, partial, total;
  FMScratch(int N, int D, int F) {
    Dq = (D + 7) / 8 * 8;
    Fq = (F + 7) / 8 * 8;
    const size_t nd = (size_t)N * Dq, nf = (size_t)N * Fq;  // floats per hi + lo pair
    y = 0;
    dz = y + nd;
    ad = dz + nd;
    dh = ad + nf;
    part = dh + nf;
    partial = part + (size_t)4 * ((N + FM_ROWS - 1) / FM_ROWS) * (F + 3 * D);
    const size_t p1 = (size_t)fm_splits(N, D, F) * D * F, p2 = (size_t)fm_splits(N, F, D) * F * D;
    total = partial + (p1 > p2 ? p1 : p2);
  }
  // the pair at float offset off, n rows of ld bf16 each
  static Split split(float* scratch, size_t off, int N, int ld) {
    bf16* hi = reinterpret_cast<bf16*>(scratch + off);
    return Split{hi, hi + (size_t)N * ld, ld};
  }
};

FFArgs fm_args(int N, int D, int F, float eps, float factor, const void* w1, const void* w2) {
  const bool aligned = ((reinterpret_cast<uintptr_t>(w1) | reinterpret_cast<uintptr_t>(w2)) & 15) == 0;
  return FFArgs{N, D, F, (D + 15) / 16 * 16, (F + FM_FC - 1) / FM_FC, D % 8 == 0 && F % 8 == 0 && aligned, eps, factor};
}

// The kernel at a width: DMAX the padded width's bound among 64, 128, 160, 192, 256.
template <template <int> class K, typename... Args>
int fm_dispatch(int Dp, Args... args) {
  if (Dp <= 64) return K<64>::run(args...);
  if (Dp <= 128) return K<128>::run(args...);
  if (Dp <= 160) return K<160>::run(args...);
  if (Dp <= 192) return K<192>::run(args...);
  if (Dp <= 256) return K<256>::run(args...);
  return (int)cudaErrorInvalidValue;
}

size_t fm_fwd_smem(int Dp, int rows) { return (size_t)(rows * (Dp + AM_PAD) + 2 * Dp * FM_LDF + 2 * FM_FC * (Dp + AM_PAD)) * sizeof(bf16); }
size_t fm_bwd_smem(int Dp) { return fm_fwd_smem(Dp, FM_ROWS) + (size_t)FM_ROWS * (Dp + AM_PAD) * sizeof(bf16) + 2 * FM_ROWS * sizeof(float); }

template <int DMAX, int RG, int FQ>
int fm_fwd_launch(const void* x, const void* gamma, const void* beta, const void* w1, const void* b1, const void* w2, const void* b2, void* out,
                  FFArgs a, Dropout dp, cudaStream_t stream) {
  const size_t smem = fm_fwd_smem(a.Dp, 16 * RG);
  cudaError_t err = allow_smem(ff_mma_fwd<DMAX, RG, FQ>, smem);
  if (err != cudaSuccess) return (int)err;
  ff_mma_fwd<DMAX, RG, FQ><<<(a.N + 16 * RG - 1) / (16 * RG), 32 * RG * FQ, smem, stream>>>(
      (const bf16*)x, (const float*)gamma, (const float*)beta, (const bf16*)w1, (const bf16*)b1, (const bf16*)w2, (const bf16*)b2, (bf16*)out, a,
      dp);
  return (int)cudaGetLastError();
}

template <int DMAX>
struct FwdRun {
  static int run(int rows, const void* x, const void* gamma, const void* beta, const void* w1, const void* b1, const void* w2, const void* b2,
                 void* out, FFArgs a, Dropout dp, cudaStream_t stream) {
    switch (rows) {
      case 64: return fm_fwd_launch<DMAX, 4, 2>(x, gamma, beta, w1, b1, w2, b2, out, a, dp, stream);
      case 32: return fm_fwd_launch<DMAX, 2, 4>(x, gamma, beta, w1, b1, w2, b2, out, a, dp, stream);
      default: return (int)cudaErrorInvalidValue;
    }
  }
};

template <int DMAX>
struct BwdRun {
  static int run(const void* x, const void* gamma, const void* beta, const void* w1, const void* b1, const void* w2, const void* dout, void* dx,
                 float* scratch, FFArgs a, Dropout dp, cudaStream_t stream) {
    const FMScratch L(a.N, a.D, a.F);
    const size_t smem = fm_bwd_smem(a.Dp);
    cudaError_t err = allow_smem(ff_mma_bwd_rows<DMAX>, smem);
    if (err != cudaSuccess) return (int)err;
    ff_mma_bwd_rows<DMAX><<<(a.N + FM_ROWS - 1) / FM_ROWS, FM_THREADS, smem, stream>>>(
        (const bf16*)x, (const float*)gamma, (const float*)beta, (const bf16*)w1, (const bf16*)b1, (const bf16*)w2, (const bf16*)dout, (bf16*)dx,
        FMScratch::split(scratch, L.y, a.N, L.Dq), FMScratch::split(scratch, L.dz, a.N, L.Dq), FMScratch::split(scratch, L.ad, a.N, L.Fq),
        FMScratch::split(scratch, L.dh, a.N, L.Fq), scratch + L.part, a, dp);
    return (int)cudaGetLastError();
  }
};

// Blocks per SM of a kernel (the occupancy API, after the shared-memory limit is raised).
template <typename Kernel>
int fm_occupancy(Kernel kernel, int threads, size_t smem) {
  int blocks = -1;
  cudaError_t err = allow_smem(kernel, smem);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

// ... of the backward rows kernel (rows 0) or of the forward at 64 or 32 rows, at a width.
template <int DMAX>
struct Occupancy {
  static int run(int rows, int Dp) {
    switch (rows) {
      case 0: return fm_occupancy(ff_mma_bwd_rows<DMAX>, FM_THREADS, fm_bwd_smem(Dp));
      case 64: return fm_occupancy(ff_mma_fwd<DMAX, 4, 2>, 256, fm_fwd_smem(Dp, 64));
      case 32: return fm_occupancy(ff_mma_fwd<DMAX, 2, 4>, 256, fm_fwd_smem(Dp, 32));
      default: return -(int)cudaErrorInvalidValue;
    }
  }
};

}  // namespace

int launch_split_atb(Split A, Split B, float* out, float* partial, int N, int M, int K, cudaStream_t stream) {
  const int splits = fm_splits(N, M, K);
  const int rows_per_split = fm_rows_per_split(N, splits);
  dim3 grid((K + FM_WT - 1) / FM_WT, (M + FM_WT - 1) / FM_WT, splits);
  ff_mma_atb<<<grid, 128, 0, stream>>>(A, B, partial, N, M, K, rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_sum_partials(partial, out, splits, (size_t)M * K, stream);
}

long long split_atb_partial_floats(int N, int M, int K) { return (long long)fm_splits(N, M, K) * M * K; }

int launch_ff_mma(const void* x, const void* gamma, const void* beta, const void* w1, const void* b1, const void* w2, const void* b2, void* out,
                  int N, int D, int F, int rows, float eps, float factor, Dropout dp, cudaStream_t stream) {
  const FFArgs a = fm_args(N, D, F, eps, factor, w1, w2);
  return fm_dispatch<FwdRun>(a.Dp, rows, x, gamma, beta, w1, b1, w2, b2, out, a, dp, stream);
}

long long ff_mma_bwd_scratch(int N, int D, int F) { return (long long)FMScratch(N, D, F).total; }

// dgamma, dbeta [D], db1 [F], db2 [D] f32 are views of one column-sum output
// cols [F + 3D] (db1, db2, dgamma, dbeta); dw1 [D, F], dw2 [F, D] f32.
int launch_ff_mma_bwd(const void* x, const void* gamma, const void* beta, const void* w1, const void* b1, const void* w2, const void* dout,
                      void* dx, float* cols, float* dw1, float* dw2, float* scratch, int N, int D, int F, float eps, float factor, Dropout dp,
                      cudaStream_t stream) {
  const FFArgs a = fm_args(N, D, F, eps, factor, w1, w2);
  const FMScratch L(N, D, F);
  int e = fm_dispatch<BwdRun>(a.Dp, x, gamma, beta, w1, b1, w2, dout, dx, scratch, a, dp, stream);
  if (e) return e;
  if ((e = launch_sum_partials(scratch + L.part, cols, 4 * ((N + FM_ROWS - 1) / FM_ROWS), (size_t)F + 3 * D, stream))) return e;
  const Split y = FMScratch::split(scratch, L.y, N, L.Dq), dz = FMScratch::split(scratch, L.dz, N, L.Dq);
  const Split ad = FMScratch::split(scratch, L.ad, N, L.Fq), dh = FMScratch::split(scratch, L.dh, N, L.Fq);
  if ((e = launch_split_atb(y, dh, dw1, scratch + L.partial, N, D, F, stream))) return e;
  return launch_split_atb(ad, dz, dw2, scratch + L.partial, N, F, D, stream);
}

}  // namespace tfasr

// Dynamic shared memory (bytes) of the bf16 backward rows kernel (rows 0) or
// of the forward at 64 or 32 rows, at width D; ops/cuda/ff_kernel.py:
// ff_mma_plan computes the same.
extern "C" long long tfasr_ff_mma_smem(int D, int rows) {
  const int Dp = (D + 15) / 16 * 16;
  return (long long)(rows == 0 ? tfasr::fm_bwd_smem(Dp) : tfasr::fm_fwd_smem(Dp, rows));
}

// Blocks per SM of that kernel on the current card (cudaOccupancyMaxActiveBlocksPerMultiprocessor);
// a negative value is the CUDA error.
extern "C" int tfasr_ff_mma_occupancy(int D, int rows) {
  using namespace tfasr;
  const int Dp = (D + 15) / 16 * 16;
  return fm_dispatch<Occupancy>(Dp, rows, Dp);
}

// The fixed row split of the weight-gradient product [M, K] over N rows:
// the number of splits and the rows of each; ops/cuda/ff_kernel.py copies it.
extern "C" int tfasr_ff_mma_splits(int N, int M, int K, int* rows_per_split) {
  const int splits = tfasr::fm_splits(N, M, K);
  *rows_per_split = tfasr::fm_rows_per_split(N, splits);
  return splits;
}
