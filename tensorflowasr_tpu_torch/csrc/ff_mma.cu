// The fused Conformer feed-forward module in bf16 on the tensor cores,
// forward and backward:
//   out = x + factor * drop2(W2 . drop1(swish(W1 . LN(x) + b1)) + b2)
// The f32 instantiation stays on the CUDA-core kernels of ff.cu, whose C
// entry points dispatch here for bf16 inputs.
//
// Counterpart of tensorflowasr_tpu/ops/pallas/ff_kernel.py fused_ff
// (_fwd_kernel, _bwd_kernel, ff_kernel.py:63-159). Every product is an
// mma.sync m16n8k16 with bf16 operands and f32 accumulators (the wide
// backward's rows pass: wgmma, below); operands come
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
//     and the column-sum partials, as a balanced tree in a fixed order: the
//     same bits on every run, no atomics.
// What bounds it: at N 6400, D 144, F 576 the backward's row products are
// 3.2 GFLOP and the split weight-gradient products 6.4 GFLOP of tensor-core
// work (~10 us at 989 TFLOP/s), beside ~37 MB of split scratch written and
// read once (~22 us at 3.35 TB/s); mma.sync and one block per SM reach a fraction
// of either.
#include "hopper.cuh"

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

// Stage the weight chunk c (FC columns of F) into w1 [Dp][FC + AM_PAD]
// (W1[:, chunk]) and w2 [FC][Dp + AM_PAD] (W2[chunk, :]); rows and columns
// past D or F zero.
template <int FC = FM_FC>
__device__ __forceinline__ void fm_stage_w(bf16* w1s, bf16* w2s, const bf16* w1, const bf16* w2, int c, const FFArgs& a) {
  constexpr int LDF = FC + AM_PAD;
  const int f0 = c * FC, D = a.D, F = a.F, LDD = a.Dp + AM_PAD;
  if (a.vec) {
    for (int i = threadIdx.x; i < a.Dp * (FC / 8); i += blockDim.x) {
      const int d = i / (FC / 8), f = (i % (FC / 8)) * 8;
      const bool ok = d < D && f0 + f < F;
      cp_async16(smem_u32(w1s + d * LDF + f), ok ? w1 + (size_t)d * F + f0 + f : w1, ok ? 16 : 0);
    }
    am_stage(w2s, w2, f0, F, FC, D, a.Dp, 1);
  } else {
    for (int i = threadIdx.x; i < a.Dp * FC; i += blockDim.x) {
      const int d = i / FC, f = i % FC;
      w1s[d * LDF + f] = (d < D && f0 + f < F) ? w1[(size_t)d * F + f0 + f] : __float2bfloat16(0.f);
    }
    for (int i = threadIdx.x; i < FC * a.Dp; i += blockDim.x) {
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

// ---------------------- the wide kernels (256 < Dp <= 512) ---------------------- //
//
// At Conformer-L's D 512, F 2048 the narrow tile does not fit: a warp's
// [16, D] accumulator would take 256 f32 a thread, and two 64-column chunks
// of W1 and W2 beside 64 rows take 347 KB of shared memory. The wide
// forward takes 32 rows a block (8 warps) or 64 rows (16 warps, where the
// 32-row grid would take more than one wave) and 32-column F chunks, still
// double-buffered (W1c [Dp][40], W2c [32][Dp + 8]), and each chunk runs as
// two products with a barrier between: (1) h [32, 32] = y . W1c, warp (rg,
// q) the 16 rows rg and the 8 columns 8q over the whole of D (one n-tile);
// the activation goes to shared memory as bf16; (2) z [32, D] += a . W2c,
// warp (rg, q) the rows rg and the output columns q * 128 .. (16 n-tiles,
// 64 f32 a thread). Shared memory at Dp 512: 184,320 bytes (220,160 at 64
// rows): one block per SM. The backward's rows pass runs on wgmma (below).
// The forward's first product alternates its k-steps between two
// accumulators (two independent mma chains a warp; with the 64-row tile it
// took the forward from 0.539 to 0.361 ms at N 6400, PERF.md §6, row 5).
constexpr int FW_FC = 32;  // F columns per chunk of the wide kernels: 8 a warp quarter
constexpr int FW_LDF = FW_FC + AM_PAD;

// RG row groups of 16 (2: 32 rows, 8 warps; 4: 64 rows, 16 warps), warp w the row group w % RG and the column quarter w / RG.
template <int RG>
__global__ void __launch_bounds__(128 * RG, 1) ffw_fwd(const bf16* __restrict__ x, const float* __restrict__ gamma, const float* __restrict__ beta,
                                                      const bf16* __restrict__ w1, const bf16* __restrict__ b1, const bf16* __restrict__ w2,
                                                      const bf16* __restrict__ b2, bf16* __restrict__ out, FFArgs a, Dropout dp) {
  constexpr int ROWS = 16 * RG, WARPS = 4 * RG;
  extern __shared__ __align__(16) unsigned char fm_smem[];
  const int Dp = a.Dp, LDD = Dp + AM_PAD, nk = Dp / 16, D = a.D, F = a.F, N = a.N;
  bf16* y_s = reinterpret_cast<bf16*>(fm_smem);  // [ROWS][LDD] LN output
  bf16* w1_s = y_s + ROWS * LDD;                 // [2][Dp][FW_LDF]
  bf16* w2_s = w1_s + 2 * Dp * FW_LDF;           // [2][FW_FC][LDD]
  bf16* a_s = w2_s + 2 * FW_FC * LDD;            // [ROWS][FW_LDF] the chunk's activation
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, tig = lane & 3;
  const int rg = warp % RG, q = warp / RG, d0 = q * WD_DQ;
  const int row0 = blockIdx.x * ROWS, row_lo = row0 + rg * 16 + g;

  fm_stage_w<FW_FC>(w1_s, w2_s, w1, w2, 0, a);
  cp_async_commit();
  for (int r = warp; r < ROWS; r += WARPS) {
    bf16* dst = y_s + r * LDD;
    if (row0 + r < N)
      ln_row_warp<bf16>(x + (size_t)(row0 + r) * D, gamma, beta, D, a.eps, dst, lane);
    else
      for (int c = lane; c < D; c += 32) dst[c] = __float2bfloat16(0.f);
  }
  fm_zero_pad(y_s, ROWS, LDD, D, Dp);

  float z[WD_DQ / 8][4];
#pragma unroll
  for (int dt = 0; dt < WD_DQ / 8; ++dt) z[dt][0] = z[dt][1] = z[dt][2] = z[dt][3] = 0.f;
  const bf16* yw = y_s + rg * 16 * LDD;
  for (int c = 0; c < a.nch; ++c) {
    if (c + 1 < a.nch) {
      fm_stage_w<FW_FC>(w1_s + ((c + 1) & 1) * Dp * FW_LDF, w2_s + ((c + 1) & 1) * FW_FC * LDD, w1, w2, c + 1, a);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* w1c = w1_s + (c & 1) * Dp * FW_LDF;
    const bf16* w2c = w2_s + (c & 1) * FW_FC * LDD;
    float h[4] = {0.f, 0.f, 0.f, 0.f}, h2[4] = {0.f, 0.f, 0.f, 0.f};  // the even and the odd k-steps
#pragma unroll 2
    for (int kk = 0; kk < nk; kk += 2) {
      uint32_t af[4], b[2];
      load_a(af, yw + kk * 16, LDD, lane);
      load_b_kn_x2(b, w1c + kk * 16 * FW_LDF + q * 8, FW_LDF, lane);
      mma16816(h, af, b[0], b[1]);
      if (kk + 1 < nk) {
        load_a(af, yw + (kk + 1) * 16, LDD, lane);
        load_b_kn_x2(b, w1c + (kk + 1) * 16 * FW_LDF + q * 8, FW_LDF, lane);
        mma16816(h2, af, b[0], b[1]);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) h[e] += h2[e];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float act[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int f = c * FW_FC + q * 8 + 2 * tig + j;
        act[j] = 0.f;
        if (f < F) {
          const float hh = h[2 * hf + j] + to_f32(b1[f]);
          act[j] = hh * sigmoid_f32(hh);
          if (dp.on) act[j] *= dropout_keep(dp, dp.seed, row_lo + 8 * hf, f);
        }
      }
      *reinterpret_cast<uint32_t*>(a_s + (rg * 16 + g + 8 * hf) * FW_LDF + q * 8 + 2 * tig) = pack_bf16(act[0], act[1]);
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < FW_FC / 16; ++ks) {
      uint32_t af[4];
      load_a(af, a_s + rg * 16 * FW_LDF + ks * 16, FW_LDF, lane);
#pragma unroll
      for (int np = 0; np < WD_DQ / 16; ++np) {
        if (d0 + np * 16 < Dp) {
          uint32_t b[4];
          load_b_kn(b, w2c + ks * 16 * LDD + d0 + np * 16, LDD, lane);
          mma16816(z[2 * np], af, b[0], b[1]);
          mma16816(z[2 * np + 1], af, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // before the next chunk's copy refills this buffer and a_s is rewritten
  }
#pragma unroll
  for (int dt = 0; dt < WD_DQ / 8; ++dt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row_lo + (e >> 1) * 8, col = d0 + dt * 8 + 2 * tig + (e & 1);
      if (row < N && col < D) {
        const size_t off = (size_t)row * D + col;
        float zz = z[dt][e] + to_f32(b2[col]);
        if (dp.on) zz *= dropout_keep(dp, dp.seed + FM_SALT_SITE2, row, col);
        out[off] = __float2bfloat16(to_f32(x[off]) + a.factor * zz);
      }
    }
  }
}

// ------------------- the wide backward rows pass on wgmma (256 < Dp <= 512) ------------------- //
//
// Three kernels in place of one row loop, so that every product runs as a
// wgmma warpgroup product on operands the TMA brings (hopper.cuh):
//  1. ffw_bwd_prologue, per row: the LayerNorm statistics from x (f32), y =
//     LN(x) and dz = factor * dout * keep2 as bf16 hi + lo (the products'
//     operands are exactly the hi halves, bf16(y) and bf16(dz)), mean and
//     rstd, and per 64 rows the column sums of dz (db2). Blocks past the rows
//     transpose W1 into W1^T [F][Dq], so that every product reads both
//     operands K-major, and copy W1, W2 into padded rows where the TMA cannot
//     read them as they are (D or F not a multiple of 8, or unaligned).
//  2. ffw_bwd_products, persistent (a block per SM walks the tiles t, t +
//     grid, ... in order, F tiles fastest): a [128 rows x 128 F] tile of h =
//     y . W1 and da = dz . W2^T over K = D, two consumer warpgroups of 64 rows
//     each holding both accumulators (m64n128k16, 2 x 64 f32 a thread), fed
//     by a producer warp through a 3-stage ring of [128][64] tiles of y, dz,
//     W1^T and W2 (64 KB a stage); the epilogue forms ad and dh (swish with
//     sigmoid_f32, as the other FF kernels; dropout keep1) without branches,
//     writes them as hi + lo through a [64][128] staging tile a warpgroup in
//     16-byte row chunks, and the db1 partials, while the producer already
//     fills the ring with the next tile.
//  3. ffw_bwd_dy, a block per 64 rows: dy = dh . W1^T over K = F, the two
//     consumer warpgroups 256 columns each (m64n256k16, 128 f32 a thread; a
//     64 x 512 f32 tile is too large for one), a 3-stage ring of dh [64][64]
//     and W1 [512][64] (72 KB a stage); its epilogue is the LayerNorm
//     backward on the block's x rows staged in the free ring, the row sums
//     meeting across the two warpgroups in shared memory, dx staged and
//     written in 16-byte row chunks, and the dgamma, dbeta partials.
// Kept as the mma.sync kernel was: bf16 operands with f32 accumulation, f32
// LayerNorm statistics, the same swish and dropout_keep calls, the splits' layout
// (FMScratch) and the column-sum partials, now one row per 64 rows summed in
// fixed orders (the same bits on every run, no atomics).
// What bounds it at N 12,800, D 512, F 2048: three products of 26.8 GFLOP
// (0.081 ms at 989 TFLOP/s) and ~302 MB of operands and splits (0.090 ms at
// 3.35 TB/s); the 32-row mma.sync loop took 1.78 ms, these three 0.32-0.38
// ms (PERF.md, row 5).
constexpr int WB_THREADS = 384;                         // a producer warpgroup and two consumer warpgroups
constexpr int WB_BK = 64;                               // k columns a stage: one 128-byte swizzled row
constexpr int WB_STAGES = 3;                            // the ring's stages
constexpr int WB_ROWS = 128, WB_FC = 128;               // the products' tile: rows x F columns
constexpr int WB_OPER = WB_ROWS * WB_BK * 2;            // bytes of one operand tile [128][64]: 16 KB
constexpr int WB_STAGE = 4 * WB_OPER;                   // y, dz, W1^T, W2
constexpr int WC_ROWS = 64;                             // rows of a dy block, of a prologue block and of a column-sum partial
constexpr int WC_HALF = WD_DMAX / 2;                    // dy columns of a consumer warpgroup, and the rows of a W1 box
constexpr int WC_STAGE = (WC_ROWS + WD_DMAX) * WB_BK * 2;  // dh [64][64], W1 [512][64]: 72 KB
constexpr int WB_ALIGN = 1024;                          // the 128-byte swizzle's tiles start on 1024-byte boundaries

// Dynamic shared memory of the two wgmma kernels: the ring (aligned by hand, hence the slack), the products' staging
// tiles [2][64][128] bf16, and the ring's full and empty barriers.
size_t wb_products_smem() { return WB_ALIGN + (size_t)WB_STAGES * WB_STAGE + 2 * WC_ROWS * WB_FC * sizeof(bf16) + 2 * WB_STAGES * sizeof(uint64_t); }
size_t wb_dy_smem() { return WB_ALIGN + (size_t)WB_STAGES * WC_STAGE + 2 * WB_STAGES * sizeof(uint64_t); }

__device__ __forceinline__ unsigned char* wb_aligned(unsigned char* raw) { return raw + ((WB_ALIGN - (smem_u32(raw) & (WB_ALIGN - 1))) & (WB_ALIGN - 1)); }

// Eight consecutive values as bf16 hi + lo into a split's 16-byte-aligned row chunk.
__device__ __forceinline__ void put_split8(const Split& s, int row, int col, const float (&v)[8]) {
  uint32_t hi[4], lo[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    const __nv_bfloat162 l = __floats2bfloat162_rn(v[2 * i] - __low2float(h), v[2 * i + 1] - __high2float(h));
    hi[i] = *reinterpret_cast<const uint32_t*>(&h);
    lo[i] = *reinterpret_cast<const uint32_t*>(&l);
  }
  const size_t off = (size_t)row * s.ld + col;
  *reinterpret_cast<uint4*>(s.hi + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
  *reinterpret_cast<uint4*>(s.lo + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
}

// Columns 8q .. 8q + 7 of a bf16 row (zeros past D): one 16-byte load where the row allows it.
__device__ __forceinline__ void load8(float (&v)[8], const bf16* row, int c0, int D, bool vec) {
  if (vec && c0 + 8 <= D) {
    const uint4 u = *reinterpret_cast<const uint4*>(row + c0);
    const bf16* b = reinterpret_cast<const bf16*>(&u);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = to_f32(b[e]);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = c0 + e < D ? to_f32(row[c0 + e]) : 0.f;
  }
}

// 1. The prologue; see above. A row block of WP_WARPS warps takes 64 rows, 4 a warp; lane l the column chunks l and
// l + 32 (8 columns each). stats [2][N]: mean, rstd. part [P][F + 3D]: this kernel writes db2 (columns F .. F + D).
constexpr int WP_WARPS = 16;
__global__ void __launch_bounds__(32 * WP_WARPS) ffw_bwd_prologue(const bf16* __restrict__ x, const float* __restrict__ gamma, const float* __restrict__ beta,
                                                      const bf16* __restrict__ w1, const bf16* __restrict__ w2, const bf16* __restrict__ dout, Split y_o,
                                                      Split dz_o, float* __restrict__ stats, float* __restrict__ part, bf16* __restrict__ w1t,
                                                      bf16* __restrict__ w1p, bf16* __restrict__ w2p, FFArgs a, int vec_rows, Dropout dp) {
  __shared__ __align__(16) float cs[WP_WARPS][WD_DMAX];  // the warps' dz column sums; a block past the rows: the W1 tile
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int D = a.D, F = a.F, N = a.N, Dq = y_o.ld, Fq = (F + 7) / 8 * 8;
  const int row_blocks = (N + WC_ROWS - 1) / WC_ROWS;
  if ((int)blockIdx.x >= row_blocks) {
    const int tf = (F + 63) / 64, tt = blockIdx.x - row_blocks, d0 = (tt / tf) * 64, f0 = (tt % tf) * 64;
    bf16* tile = reinterpret_cast<bf16*>(cs);  // [64][66]: W1[d0 + d][f0 + f] at d * 66 + f
    for (int i = threadIdx.x; i < 64 * 64; i += blockDim.x) {
      const int d = d0 + i / 64, f = f0 + i % 64;
      const bf16 v = d < D && f < F ? w1[(size_t)d * F + f] : __float2bfloat16(0.f);
      tile[(i / 64) * 66 + i % 64] = v;
      if (!a.vec && d < D && f < Fq) w1p[(size_t)d * Fq + f] = v;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < 64 * 64; i += blockDim.x) {
      const int f = f0 + i / 64, d = d0 + i % 64;
      if (f < F && d < Dq) {
        w1t[(size_t)f * Dq + d] = tile[(i % 64) * 66 + i / 64];
        if (!a.vec) w2p[(size_t)f * Dq + d] = d < D ? w2[(size_t)f * D + d] : __float2bfloat16(0.f);
      }
    }
    return;
  }
  const int m0 = blockIdx.x * WC_ROWS;
  float zs[2][8];
#pragma unroll
  for (int k = 0; k < 2; ++k)
#pragma unroll
    for (int e = 0; e < 8; ++e) zs[k][e] = 0.f;
  for (int i = 0; i < WC_ROWS / WP_WARPS; ++i) {
    const int row = m0 + warp * (WC_ROWS / WP_WARPS) + i;
    if (row >= N) break;
    const bf16* xr = x + (size_t)row * D;
    const bf16* dr = dout + (size_t)row * D;
    float xv[2][8], s = 0.f;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      load8(xv[k], xr, 8 * (lane + 32 * k), D, vec_rows);
#pragma unroll
      for (int e = 0; e < 8; ++e) s += xv[k][e];
    }
    const float mu = warp_sum(s) / (float)D;
    float q = 0.f;
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (8 * (lane + 32 * k) + e < D) {
          const float cx = xv[k][e] - mu;
          q = fmaf(cx, cx, q);
        }
    const float rstd = rsqrtf(warp_sum(q) / (float)D + a.eps);
    if (lane == 0) stats[row] = mu, stats[N + row] = rstd;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int c0 = 8 * (lane + 32 * k);
      if (c0 < D) {
        float y[8], dz[8];
        load8(dz, dr, c0, D, vec_rows);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int c = c0 + e;
          y[e] = 0.f;
          if (c < D) {
            y[e] = (xv[k][e] - mu) * rstd * gamma[c] + beta[c];
            dz[e] *= a.factor;
            if (dp.on) dz[e] *= dropout_keep(dp, dp.seed + FM_SALT_SITE2, row, c);
            zs[k][e] += dz[e];
          }
        }
        put_split8(y_o, row, c0, y);
        put_split8(dz_o, row, c0, dz);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 2; ++k)
#pragma unroll
    for (int e = 0; e < 8; ++e) cs[warp][8 * (lane + 32 * k) + e] = zs[k][e];
  __syncthreads();
  const int C = F + 3 * D;
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WP_WARPS; ++w) s += cs[w][c];  // in warp (row) order
    part[(size_t)blockIdx.x * C + F + c] = s;
  }
}

// A [64][cols] bf16 tile in shared memory with its 16-byte chunks XOR-ed with the row (chunk q of row r at q ^ (r & 7)):
// the fragment's 8 rows g of one column pair fall in distinct banks, and 8 lanes on 8 chunks of a row too.
__device__ __forceinline__ int sw_off(int r, int col, int cols) { return r * cols + ((((col >> 3) ^ (r & 7))) << 3) + (col & 7); }

// Copy a warpgroup's (or block's) staged [64][cols] bf16 tile to rows r0 .. of a [n][ld] array in 16-byte chunks
// (`threads` threads, this one t): rows past n and chunks from `limit` on are left out.
__device__ __forceinline__ void sw_copy_out(bf16* dst, const bf16* tile, int cols, int r0, int n, int ld, int c0, int limit, int t, int threads) {
  for (int i = t; i < WC_ROWS * (cols / 8); i += threads) {
    const int r = i / (cols / 8), q = i % (cols / 8);
    if (r0 + r < n && c0 + 8 * q < limit)
      *reinterpret_cast<uint4*>(dst + (size_t)(r0 + r) * ld + c0 + 8 * q) = *reinterpret_cast<const uint4*>(tile + sw_off(r, 8 * q, cols));
  }
}

// The products' epilogue on a warpgroup's accumulators (rows r0, r0 + 8; columns f0 + 8 j + 2 tig, + 1): h and da
// become ad = swish(h + b1) keep1 and dh = da keep1 swish'(h + b1) in place. No branch: rows past N and columns past
// F arrive as zeros from the TMA, so their dh is 0 and their ad either 0 (columns) or never stored (rows).
template <bool DROP>
__device__ __forceinline__ void wb_activation(float (&h)[WB_FC / 2], float (&da)[WB_FC / 2], const bf16* __restrict__ b1, int r0, int f0, int F,
                                              int tig, const Dropout& dp) {
#pragma unroll
  for (int j = 0; j < WB_FC / 8; ++j) {
    const int fc = f0 + 8 * j + 2 * tig;
    const float bb[2] = {fc < F ? to_f32(b1[fc]) : 0.f, fc + 1 < F ? to_f32(b1[fc + 1]) : 0.f};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float hh = h[4 * j + e] + bb[e & 1];
      const float sig = sigmoid_f32(hh);
      float ad = hh * sig, dav = da[4 * j + e];
      if (DROP) {
        const float keep = dropout_keep(dp, dp.seed, r0 + 8 * (e >> 1), fc + (e & 1));
        ad *= keep;
        dav *= keep;
      }
      h[4 * j + e] = ad;
      da[4 * j + e] = dav * (sig + hh * sig * (1.f - sig));
    }
  }
}

// 2. The products pass; see above. Tile t: rows (t / tiles_f) * 128, F columns (t % tiles_f) * 128; nkb k-steps of
// 64 over D. part: db1 (columns 0 .. F) of each 64-row group. The epilogue turns h, da into ad, dh in place, then
// writes ad hi, ad lo, dh hi, dh lo in turn through the warpgroup's [64][128] staging tile as 16-byte row chunks,
// then the warps' db1 sums through the same tile.
__global__ void __launch_bounds__(WB_THREADS, 1) ffw_bwd_products(const __grid_constant__ CUtensorMap y_map, const __grid_constant__ CUtensorMap dz_map,
                                                                  const __grid_constant__ CUtensorMap w1t_map, const __grid_constant__ CUtensorMap w2_map,
                                                                  const bf16* __restrict__ b1, Split ad_o, Split dh_o, float* __restrict__ part, int N,
                                                                  int F, int C, int nkb, int tiles_f, int tiles, Dropout dp) {
  extern __shared__ unsigned char wb_raw[];
  unsigned char* ring = wb_aligned(wb_raw);
  bf16* staging = reinterpret_cast<bf16*>(ring + WB_STAGES * WB_STAGE);  // [2][64][128]
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + 2 * WC_ROWS * WB_FC);
  uint64_t* empty = full + WB_STAGES;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < WB_STAGES; ++s) mbar_init(&full[s], 1), mbar_init(&empty[s], 2);
    mbar_init_fence();
  }
  __syncthreads();
  if (wg == 0) {  // the producer: one thread keeps the ring full
    warpgroup_regs_dec<40>();
    if (threadIdx.x == 0) {
      int s = 0;
      uint32_t ph = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t / tiles_f) * WB_ROWS, f0 = (t % tiles_f) * WB_FC;
        for (int kb = 0; kb < nkb; ++kb) {
          mbar_wait(&empty[s], ph ^ 1);
          unsigned char* st = ring + s * WB_STAGE;
          mbar_expect_tx(&full[s], WB_STAGE);
          tma_load_2d(st, &y_map, &full[s], kb * WB_BK, m0);
          tma_load_2d(st + WB_OPER, &dz_map, &full[s], kb * WB_BK, m0);
          tma_load_2d(st + 2 * WB_OPER, &w1t_map, &full[s], kb * WB_BK, f0);
          tma_load_2d(st + 3 * WB_OPER, &w2_map, &full[s], kb * WB_BK, f0);
          if (++s == WB_STAGES) s = 0, ph ^= 1;
        }
      }
    }
  } else {  // consumer warpgroup c: rows 64 c .. 64 c + 63 of the tile
    warpgroup_regs_inc<232>();
    const int c = wg - 1, t128 = threadIdx.x - 128 * wg, w = t128 >> 5, lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
    bf16* stg = staging + c * WC_ROWS * WB_FC;
    float h[WB_FC / 2], da[WB_FC / 2];  // after the epilogue's first loop: ad and dh
#pragma unroll
    for (int i = 0; i < WB_FC / 2; ++i) h[i] = da[i] = 0.f;
    int s = 0;
    uint32_t ph = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t / tiles_f) * WB_ROWS, f0 = (t % tiles_f) * WB_FC;
      for (int kb = 0; kb < nkb; ++kb) {
        mbar_wait(&full[s], ph);
        const unsigned char* st = ring + s * WB_STAGE;
        const uint64_t ay = wgmma_desc(st + c * (WB_OPER / 2)), adz = wgmma_desc(st + WB_OPER + c * (WB_OPER / 2));
        const uint64_t bw1 = wgmma_desc(st + 2 * WB_OPER), bw2 = wgmma_desc(st + 3 * WB_OPER);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < WB_BK / 16; ++k) {  // k-step k16: 32 bytes on in the swizzled rows, 2 in the descriptor
          wgmma_128(h, ay + 2 * k, bw1 + 2 * k, kb > 0 || k > 0);
          wgmma_128(da, adz + 2 * k, bw2 + 2 * k, kb > 0 || k > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        wgmma_fence_acc(h);
        wgmma_fence_acc(da);
        if (t128 == 0) mbar_arrive(&empty[s]);
        if (++s == WB_STAGES) s = 0, ph ^= 1;
      }
      const int r0 = m0 + c * 64 + 16 * w + g;  // rows r0, r0 + 8 (tile rows 16 w + g, + 8 of the warpgroup's 64)
      if (dp.on)
        wb_activation<true>(h, da, b1, r0, f0, F, tig, dp);
      else
        wb_activation<false>(h, da, b1, r0, f0, F, tig, dp);
      const int tr0 = m0 + 64 * c;  // the warpgroup's first row
#pragma unroll
      for (int which = 0; which < 4; ++which) {  // ad hi, ad lo, dh hi, dh lo
#pragma unroll
        for (int j = 0; j < WB_FC / 8; ++j) {
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const float v0 = which < 2 ? h[4 * j + 2 * hf] : da[4 * j + 2 * hf];
            const float v1 = which < 2 ? h[4 * j + 2 * hf + 1] : da[4 * j + 2 * hf + 1];
            const __nv_bfloat162 hi = __floats2bfloat162_rn(v0, v1);
            const __nv_bfloat162 out = (which & 1) ? __floats2bfloat162_rn(v0 - __low2float(hi), v1 - __high2float(hi)) : hi;
            *reinterpret_cast<__nv_bfloat162*>(stg + sw_off(16 * w + g + 8 * hf, 8 * j + 2 * tig, WB_FC)) = out;
          }
        }
        named_sync(1 + c, 128);
        const Split& o = which < 2 ? ad_o : dh_o;
        sw_copy_out((which & 1) ? o.lo : o.hi, stg, WB_FC, tr0, N, o.ld, f0, F, t128, 128);
        named_sync(1 + c, 128);  // before the tile is written again
      }
      float* red = reinterpret_cast<float*>(stg);  // [4][WB_FC]: each warp's db1 sums over its 16 rows
#pragma unroll
      for (int j = 0; j < WB_FC / 8; ++j) {
        const float s0 = col_sum8(da[4 * j] + da[4 * j + 2]), s1 = col_sum8(da[4 * j + 1] + da[4 * j + 3]);
        if (g == 0) red[w * WB_FC + 8 * j + 2 * tig] = s0, red[w * WB_FC + 8 * j + 2 * tig + 1] = s1;
      }
      named_sync(1 + c, 128);
      if (tr0 < N && f0 + t128 < F)  // this warpgroup's 64-row group, column f0 + t128, the warps in row order
        part[(size_t)(tr0 >> 6) * C + f0 + t128] = ((red[t128] + red[WB_FC + t128]) + red[2 * WB_FC + t128]) + red[3 * WB_FC + t128];
      named_sync(1 + c, 128);  // before the next tile's values overwrite the staging tile
    }
  }
}

// 3. The dy pass with the LayerNorm backward; see above. Block b: rows 64 b ..; nkb k-steps of 64 over F. part:
// dgamma, dbeta (columns F + D .. F + 3D) of the block's 64 rows. Once both warpgroups are past their last product the
// ring holds the block's x rows [64][512] (read twice), its dx rows [64][512] (written out in 16-byte chunks) and the
// sums that meet across warps; vec: D % 8 == 0 and x, dout, dx 16-byte aligned, else element copies.
__global__ void __launch_bounds__(WB_THREADS, 1) ffw_bwd_dy(const __grid_constant__ CUtensorMap dh_map, const __grid_constant__ CUtensorMap w1_map,
                                                            const bf16* __restrict__ x, const float* __restrict__ gamma, const bf16* __restrict__ dout,
                                                            bf16* __restrict__ dx, const float* __restrict__ stats, float* __restrict__ part, int N, int D,
                                                            int F, int nkb, int vec) {
  extern __shared__ unsigned char wb_raw[];
  unsigned char* ring = wb_aligned(wb_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + WB_STAGES * WC_STAGE);
  uint64_t* empty = full + WB_STAGES;
  const int wg = threadIdx.x / 128, m0 = blockIdx.x * WC_ROWS;
  if (threadIdx.x == 0) {
    for (int s = 0; s < WB_STAGES; ++s) mbar_init(&full[s], 1), mbar_init(&empty[s], 2);
    mbar_init_fence();
  }
  __syncthreads();
  if (wg == 0) {
    warpgroup_regs_dec<40>();
    if (threadIdx.x == 0) {
      int s = 0;
      uint32_t ph = 0;
      for (int kb = 0; kb < nkb; ++kb) {
        mbar_wait(&empty[s], ph ^ 1);
        unsigned char* st = ring + s * WC_STAGE;
        mbar_expect_tx(&full[s], WC_STAGE);
        tma_load_2d(st, &dh_map, &full[s], kb * WB_BK, m0);
        tma_load_2d(st + WC_ROWS * WB_BK * 2, &w1_map, &full[s], kb * WB_BK, 0);
        tma_load_2d(st + (WC_ROWS + WC_HALF) * WB_BK * 2, &w1_map, &full[s], kb * WB_BK, WC_HALF);
        if (++s == WB_STAGES) s = 0, ph ^= 1;
      }
    }
  } else {  // consumer warpgroup c: dy columns 256 c .. 256 c + 255 of the block's 64 rows
    warpgroup_regs_inc<232>();
    const int c = wg - 1, t128 = threadIdx.x - 128 * wg, t256 = threadIdx.x - 128, w = t128 >> 5, lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
    float dy[WC_HALF / 2];
#pragma unroll
    for (int i = 0; i < WC_HALF / 2; ++i) dy[i] = 0.f;
    int s = 0;
    uint32_t ph = 0;
    for (int kb = 0; kb < nkb; ++kb) {
      mbar_wait(&full[s], ph);
      const unsigned char* st = ring + s * WC_STAGE;
      const uint64_t adh = wgmma_desc(st), bw1 = wgmma_desc(st + (WC_ROWS + c * WC_HALF) * WB_BK * 2);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < WB_BK / 16; ++k) wgmma_256(dy, adh + 2 * k, bw1 + 2 * k, kb > 0 || k > 0);
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_fence_acc(dy);
      if (t128 == 0) mbar_arrive(&empty[s]);
      if (++s == WB_STAGES) s = 0, ph ^= 1;
    }
    named_sync(1, 256);  // both warpgroups past their last product: the ring is free
    bf16* xs = reinterpret_cast<bf16*>(ring);                     // [64][512] x, swizzled chunks
    bf16* dxs = xs + WC_ROWS * WD_DMAX;                           // [64][512] dx
    float* rrow = reinterpret_cast<float*>(dxs + WC_ROWS * WD_DMAX);  // [2][64][2]: each warpgroup's row sums of dxn and dxn * xhat
    float* rcol = rrow + 2 * WC_ROWS * 2;                         // [2][4][256][2]: each warp's column sums of dy * xhat and dy
    for (int i = t256; i < WC_ROWS * (WD_DMAX / 8); i += 256) {
      const int r = i / (WD_DMAX / 8), c0 = 8 * (i % (WD_DMAX / 8)), row = m0 + r;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (row < N && c0 < D) {
        if (vec) {
          u = *reinterpret_cast<const uint4*>(x + (size_t)row * D + c0);
        } else {
          bf16* b = reinterpret_cast<bf16*>(&u);
          for (int e = 0; e < 8 && c0 + e < D; ++e) b[e] = x[(size_t)row * D + c0 + e];
        }
      }
      *reinterpret_cast<uint4*>(xs + sw_off(r, c0, WD_DMAX)) = u;
    }
    named_sync(1, 256);
    const int rl = 16 * w + g, r0 = m0 + rl;  // rows r0, r0 + 8 (block rows rl, rl + 8); columns 256 c + 8 j + 2 tig (+1)
    float mu[2], rstd[2], s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = r0 + 8 * hf;
      mu[hf] = row < N ? stats[row] : 0.f;
      rstd[hf] = row < N ? stats[N + row] : 0.f;
    }
    // rows past N and columns past D hold dy = 0 (the TMA's zeros in dh and W1) and x = 0: no branch needed
#pragma unroll
    for (int j = 0; j < WC_HALF / 8; ++j) {
      const int col = c * WC_HALF + 8 * j + 2 * tig;
      const float gm[2] = {col < D ? gamma[col] : 0.f, col + 1 < D ? gamma[col + 1] : 0.f};
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const __nv_bfloat162 xp = *reinterpret_cast<const __nv_bfloat162*>(xs + sw_off(rl + 8 * hf, col, WD_DMAX));
        const float xv[2] = {__low2float(xp), __high2float(xp)};
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const float xhat = (xv[jj] - mu[hf]) * rstd[hf];
          const float dxn = dy[4 * j + 2 * hf + jj] * gm[jj];
          s1[hf] += dxn;
          s2[hf] = fmaf(dxn, xhat, s2[hf]);
        }
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      s1[hf] = quad_sum(s1[hf]);
      s2[hf] = quad_sum(s2[hf]);
      if (tig == 0) {
        const int r = c * WC_ROWS + rl + 8 * hf;
        rrow[2 * r] = s1[hf];
        rrow[2 * r + 1] = s2[hf];
      }
    }
    named_sync(1, 256);
    float m1[2], m2[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = rl + 8 * hf;
      m1[hf] = (rrow[2 * r] + rrow[2 * (WC_ROWS + r)]) / (float)D;
      m2[hf] = (rrow[2 * r + 1] + rrow[2 * (WC_ROWS + r) + 1]) / (float)D;
    }
    float* rc = rcol + c * 4 * WC_HALF * 2;
#pragma unroll
    for (int j = 0; j < WC_HALF / 8; ++j) {
      const int col = c * WC_HALF + 8 * j + 2 * tig;
      const float gm[2] = {col < D ? gamma[col] : 0.f, col + 1 < D ? gamma[col + 1] : 0.f};
      float sg[2] = {0.f, 0.f}, sb[2] = {0.f, 0.f};  // column sums of dy * xhat and dy
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = r0 + 8 * hf;
        const __nv_bfloat162 xp = *reinterpret_cast<const __nv_bfloat162*>(xs + sw_off(rl + 8 * hf, col, WD_DMAX));
        const float xv[2] = {__low2float(xp), __high2float(xp)};
        float o[2];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const float xhat = (xv[jj] - mu[hf]) * rstd[hf];
          const float v = dy[4 * j + 2 * hf + jj];
          const float res = row < N && col + jj < D ? to_f32(dout[(size_t)row * D + col + jj]) : 0.f;
          o[jj] = res + rstd[hf] * (v * gm[jj] - m1[hf] - xhat * m2[hf]);
          sg[jj] += v * xhat;
          sb[jj] += v;
        }
        *reinterpret_cast<__nv_bfloat162*>(dxs + sw_off(rl + 8 * hf, col, WD_DMAX)) = __floats2bfloat162_rn(o[0], o[1]);
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const float tg = col_sum8(sg[jj]), tb = col_sum8(sb[jj]);
        if (g == 0) {
          const int q = 8 * j + 2 * tig + jj;
          rc[2 * (w * WC_HALF + q)] = tg;
          rc[2 * (w * WC_HALF + q) + 1] = tb;
        }
      }
    }
    named_sync(1, 256);
    if (vec) {
      sw_copy_out(dx, dxs, WD_DMAX, m0, N, D, 0, D, t256, 256);
    } else {
      for (int i = t256; i < WC_ROWS * WD_DMAX; i += 256) {
        const int r = i / WD_DMAX, col = i % WD_DMAX;
        if (m0 + r < N && col < D) dx[(size_t)(m0 + r) * D + col] = dxs[sw_off(r, col, WD_DMAX)];
      }
    }
    const int C = F + 3 * D;
    for (int q = t128; q < WC_HALF; q += 128) {
      const int col = c * WC_HALF + q;
      if (col < D) {  // the warps in row order
        const float sgv = ((rc[2 * q] + rc[2 * (WC_HALF + q)]) + rc[2 * (2 * WC_HALF + q)]) + rc[2 * (3 * WC_HALF + q)];
        const float sbv = ((rc[2 * q + 1] + rc[2 * (WC_HALF + q) + 1]) + rc[2 * (2 * WC_HALF + q) + 1]) + rc[2 * (3 * WC_HALF + q) + 1];
        part[(size_t)blockIdx.x * C + F + D + col] = sgv;
        part[(size_t)blockIdx.x * C + F + 2 * D + col] = sbv;
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
// partials; the wide pass adds the rows' mean and rstd [2][N], W1^T [F][Dq]
// and the padded weights W1 [D][Fq], W2 [F][Dq] (bf16; each region 128-byte
// aligned for the TMA). Offsets in floats.
struct FMScratch {
  int Dq, Fq, part_rows;
  size_t y, dz, ad, dh, part, partial, stats, w1t, w1p, w2p, total;
  // one column-sum partial per 16 rows (the narrow kernels) or per 64 rows (the wide pass)
  FMScratch(int N, int D, int F, bool wide = false) {
    Dq = (D + 7) / 8 * 8;
    Fq = (F + 7) / 8 * 8;
    const size_t nd = (size_t)N * Dq, nf = (size_t)N * Fq;  // floats per hi + lo pair
    y = 0;
    dz = y + nd;
    ad = dz + nd;
    dh = ad + nf;
    part = dh + nf;
    part_rows = (wide ? 1 : FM_ROWS / 16) * ((N + FM_ROWS - 1) / FM_ROWS);
    partial = part + (size_t)part_rows * (F + 3 * D);
    const size_t p1 = (size_t)fm_splits(N, D, F) * D * F, p2 = (size_t)fm_splits(N, F, D) * F * D;
    total = partial + (p1 > p2 ? p1 : p2);
    stats = w1t = w1p = w2p = total;
    if (wide) {
      auto up = [](size_t n) { return (n + 31) / 32 * 32; };
      stats = up(total);
      w1t = up(stats + 2 * (size_t)N);
      w1p = up(w1t + (size_t)F * Dq / 2);
      w2p = up(w1p + (size_t)D * Fq / 2);
      total = up(w2p + (size_t)F * Dq / 2);
    }
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

}  // namespace

// cuTensorMapEncodeTiled from the driver, found at run time (the library links only the runtime).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

int hopper_tensor_map(CUtensorMap* map, const void* base, int rows, int cols, int ld, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows}, strides[1] = {(cuuint64_t)ld * sizeof(bf16)};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows}, unit[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

namespace {

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

size_t fw_fwd_smem(int Dp, int rows) {
  return (size_t)(rows * (Dp + AM_PAD) + 2 * Dp * FW_LDF + 2 * FW_FC * (Dp + AM_PAD) + rows * FW_LDF) * sizeof(bf16);
}

// The wide kernels' arguments: F walked in FW_FC-column chunks.
FFArgs fw_args(FFArgs a) {
  a.nch = (a.F + FW_FC - 1) / FW_FC;
  return a;
}

template <int RG>
int fw_fwd_launch(const void* x, const void* gamma, const void* beta, const void* w1, const void* b1, const void* w2, const void* b2, void* out, FFArgs a,
                  Dropout dp, cudaStream_t stream) {
  const size_t smem = fw_fwd_smem(a.Dp, 16 * RG);
  cudaError_t err = allow_smem(ffw_fwd<RG>, smem);
  if (err != cudaSuccess) return (int)err;
  ffw_fwd<RG><<<(a.N + 16 * RG - 1) / (16 * RG), 128 * RG, smem, stream>>>((const bf16*)x, (const float*)gamma, (const float*)beta, (const bf16*)w1,
                                                                      (const bf16*)b1, (const bf16*)w2, (const bf16*)b2, (bf16*)out, fw_args(a), dp);
  return (int)cudaGetLastError();
}

// The products pass's tiles and persistent grid at N rows, F columns, on a card of `sms` SMs: tiles_f F tiles a row
// tile, and block b takes the tiles b, b + grid, ... in order (ffw_bwd_products).
struct WBSchedule {
  int tiles_f, tiles, grid;
  WBSchedule(int N, int F, int sms) {
    tiles_f = (F + WB_FC - 1) / WB_FC;
    tiles = ((N + WB_ROWS - 1) / WB_ROWS) * tiles_f;
    grid = tiles < sms ? tiles : sms;
  }
};

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 1;
  return sms > 0 ? sms : 1;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The wide rows pass (the three kernels above) into the scratch of FMScratch(N, D, F, true).
int fw_bwd_launch(const void* x, const void* gamma, const void* beta, const void* w1, const void* b1, const void* w2, const void* dout, void* dx,
                  float* scratch, FFArgs a, Dropout dp, cudaStream_t stream) {
  const int N = a.N, D = a.D, F = a.F, C = F + 3 * D;
  const FMScratch L(N, D, F, true);
  const Split y = FMScratch::split(scratch, L.y, N, L.Dq), dz = FMScratch::split(scratch, L.dz, N, L.Dq);
  const Split ad = FMScratch::split(scratch, L.ad, N, L.Fq), dh = FMScratch::split(scratch, L.dh, N, L.Fq);
  bf16* w1t = reinterpret_cast<bf16*>(scratch + L.w1t);
  bf16* w1p = reinterpret_cast<bf16*>(scratch + L.w1p);
  bf16* w2p = reinterpret_cast<bf16*>(scratch + L.w2p);
  float* stats = scratch + L.stats;
  float* part = scratch + L.part;
  const int row_blocks = (N + WC_ROWS - 1) / WC_ROWS, w_tiles = ((D + 63) / 64) * ((F + 63) / 64);
  ffw_bwd_prologue<<<row_blocks + w_tiles, 32 * WP_WARPS, 0, stream>>>((const bf16*)x, (const float*)gamma, (const float*)beta, (const bf16*)w1, (const bf16*)w2,
                                                            (const bf16*)dout, y, dz, stats, part, w1t, w1p, w2p, a,
                                                            D % 8 == 0 && aligned16(x) && aligned16(dout), dp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // W1 [D][F] and W2 [F][D] as the TMA reads them: as they are (a.vec) or the prologue's padded copies
  const bf16* w1k = a.vec ? (const bf16*)w1 : w1p;
  const bf16* w2k = a.vec ? (const bf16*)w2 : w2p;
  CUtensorMap ym, dzm, w1tm, w2m, dhm, w1m;
  int e;
  if ((e = hopper_tensor_map(&ym, y.hi, N, D, L.Dq, WB_ROWS)) || (e = hopper_tensor_map(&dzm, dz.hi, N, D, L.Dq, WB_ROWS)) ||
      (e = hopper_tensor_map(&w1tm, w1t, F, D, L.Dq, WB_FC)) || (e = hopper_tensor_map(&w2m, w2k, F, D, a.vec ? D : L.Dq, WB_FC)) ||
      (e = hopper_tensor_map(&dhm, dh.hi, N, F, L.Fq, WC_ROWS)) || (e = hopper_tensor_map(&w1m, w1k, D, F, a.vec ? F : L.Fq, WC_HALF)))
    return e;
  const WBSchedule S(N, F, sm_count());
  const int nkd = (D + WB_BK - 1) / WB_BK, nkf = (F + WB_BK - 1) / WB_BK;
  if ((err = allow_smem(ffw_bwd_products, wb_products_smem())) != cudaSuccess) return (int)err;
  ffw_bwd_products<<<S.grid, WB_THREADS, wb_products_smem(), stream>>>(ym, dzm, w1tm, w2m, (const bf16*)b1, ad, dh, part, N, F, C, nkd, S.tiles_f,
                                                                         S.tiles, dp);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = allow_smem(ffw_bwd_dy, wb_dy_smem())) != cudaSuccess) return (int)err;
  ffw_bwd_dy<<<row_blocks, WB_THREADS, wb_dy_smem(), stream>>>(dhm, w1m, (const bf16*)x, (const float*)gamma, (const bf16*)dout, (bf16*)dx, stats, part, N,
                                                              D, F, nkf, D % 8 == 0 && aligned16(x) && aligned16(dout) && aligned16(dx));
  return (int)cudaGetLastError();
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
  if (a.Dp > 256) {
    if (a.Dp > WD_DMAX) return (int)cudaErrorInvalidValue;
    switch (rows) {
      case 32: return fw_fwd_launch<2>(x, gamma, beta, w1, b1, w2, b2, out, a, dp, stream);
      case 64: return fw_fwd_launch<4>(x, gamma, beta, w1, b1, w2, b2, out, a, dp, stream);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return fm_dispatch<FwdRun>(a.Dp, rows, x, gamma, beta, w1, b1, w2, b2, out, a, dp, stream);
}

// Whether the bf16 backward at width D takes the wide rows pass (the three wgmma kernels) rather than ff_mma_bwd_rows.
bool ff_mma_bwd_wide(int D) { return (D + 15) / 16 * 16 > 256; }

long long ff_mma_bwd_scratch(int N, int D, int F) { return (long long)FMScratch(N, D, F, ff_mma_bwd_wide(D)).total; }

// dgamma, dbeta [D], db1 [F], db2 [D] f32 are views of one column-sum output
// cols [F + 3D] (db1, db2, dgamma, dbeta); dw1 [D, F], dw2 [F, D] f32.
int launch_ff_mma_bwd(const void* x, const void* gamma, const void* beta, const void* w1, const void* b1, const void* w2, const void* dout,
                      void* dx, float* cols, float* dw1, float* dw2, float* scratch, int N, int D, int F, float eps, float factor, Dropout dp,
                      cudaStream_t stream) {
  const FFArgs a = fm_args(N, D, F, eps, factor, w1, w2);
  const bool wide = ff_mma_bwd_wide(D);
  if (a.Dp > WD_DMAX) return (int)cudaErrorInvalidValue;
  const FMScratch L(N, D, F, wide);
  int e = wide ? fw_bwd_launch(x, gamma, beta, w1, b1, w2, dout, dx, scratch, a, dp, stream)
               : fm_dispatch<BwdRun>(a.Dp, x, gamma, beta, w1, b1, w2, dout, dx, scratch, a, dp, stream);
  if (e) return e;
  if ((e = launch_sum_partials(scratch + L.part, cols, L.part_rows, (size_t)F + 3 * D, stream))) return e;
  const Split y = FMScratch::split(scratch, L.y, N, L.Dq), dz = FMScratch::split(scratch, L.dz, N, L.Dq);
  const Split ad = FMScratch::split(scratch, L.ad, N, L.Fq), dh = FMScratch::split(scratch, L.dh, N, L.Fq);
  if ((e = launch_split_atb(y, dh, dw1, scratch + L.partial, N, D, F, stream))) return e;
  return launch_split_atb(ad, dz, dw2, scratch + L.partial, N, F, D, stream);
}

}  // namespace tfasr

// Dynamic shared memory (bytes) of the bf16 backward rows kernel (rows 0) or
// of the forward at 64 or 32 rows, at width D (above 256 the wide kernels:
// rows 0 is the larger of the rows pass's two wgmma kernels);
// ops/cuda/ff_kernel.py: ff_mma_plan computes the same.
extern "C" long long tfasr_ff_mma_smem(int D, int rows) {
  const int Dp = (D + 15) / 16 * 16;
  if (Dp > 256) {
    if (rows == 0) return (long long)(tfasr::wb_products_smem() > tfasr::wb_dy_smem() ? tfasr::wb_products_smem() : tfasr::wb_dy_smem());
    return rows == 32 || rows == 64 ? (long long)tfasr::fw_fwd_smem(Dp, rows) : -1;
  }
  return (long long)(rows == 0 ? tfasr::fm_bwd_smem(Dp) : tfasr::fm_fwd_smem(Dp, rows));
}

// Blocks per SM of that kernel on the current card (cudaOccupancyMaxActiveBlocksPerMultiprocessor);
// a negative value is the CUDA error.
extern "C" int tfasr_ff_mma_occupancy(int D, int rows) {
  using namespace tfasr;
  const int Dp = (D + 15) / 16 * 16;
  if (Dp > WD_DMAX) return -(int)cudaErrorInvalidValue;
  if (Dp > 256) {
    if (rows == 0) {  // the fewer of the two wgmma kernels'
      const int p = fm_occupancy(ffw_bwd_products, WB_THREADS, wb_products_smem()), q = fm_occupancy(ffw_bwd_dy, WB_THREADS, wb_dy_smem());
      return p < q ? p : q;
    }
    if (rows == 32) return fm_occupancy(ffw_fwd<2>, 256, fw_fwd_smem(Dp, 32));
    return rows == 64 ? fm_occupancy(ffw_fwd<4>, 512, fw_fwd_smem(Dp, 64)) : -(int)cudaErrorInvalidValue;
  }
  return fm_dispatch<Occupancy>(Dp, rows, Dp);
}

// The fixed row split of the weight-gradient product [M, K] over N rows:
// the number of splits and the rows of each; ops/cuda/ff_kernel.py copies it.
extern "C" int tfasr_ff_mma_splits(int N, int M, int K, int* rows_per_split) {
  const int splits = tfasr::fm_splits(N, M, K);
  *rows_per_split = tfasr::fm_rows_per_split(N, splits);
  return splits;
}
