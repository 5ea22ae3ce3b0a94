// The Conformer convolution module's two halves in bf16 on the tensor
// cores, forward and backward:
//   conv_front: out = GLU([y . Wa + ba, y . Wb + bb]) = (y . Wa + ba) * sigmoid(y . Wb + bb),  y = LN(x)
//   conv_back:  out = x + factor * drop(swish((y1 - mean) * rsqrt(var + eps) * scale + bias) . W2 + b2)
// The f32 instantiations stay on the CUDA-core kernels of conv_module.cu,
// whose C entry points dispatch here for bf16 inputs.
//
// Counterpart of tensorflowasr_tpu/ops/pallas/conv_kernel.py conv_front
// (_front_fwd_kernel, _front_bwd_kernel, conv_kernel.py:80-127) and
// conv_back (_back_fwd_kernel :268, _back_bwd_kernel :273). Both take the
// fused FF's design (ff_mma.cu): every product an mma.sync m16n8k16 with
// bf16 operands and f32 accumulators from shared memory by ldmatrix; the
// D x D weights staged 64 columns (or rows) at a time in a cp.async double
// buffer, so a block reads them from L2 once; D padded to a multiple of 16
// in shared memory only (D 144 = 9 x 16, 176 = 11 x 16). Rows past N are
// neither read nor written: the JAX kernels' zeroed padding rows are rows of
// their tiles, which the card's blocks mask instead.
//
// conv_front forward (cm_fwd): the LayerNorm in f32 rounded to bf16 into
// shared memory; warp (rg, fq) of RG x FQ owns 16 rows and 64 / FQ columns
// of each chunk: ha and hb share the A fragments, GLU in registers, the
// output written from the accumulators. The row tile is 32 rows (RG 2 x FQ
// 4 warps): a block's time is its warps' chain over the chunks, and a
// 64-row tile (RG 4 x FQ 2), which reads the weights half as often, was
// slower at every driven shape on an H100 (N 2000 and 6400 at D 144 and
// 176; PERF.md section 6, row 6).
//
// conv_front backward (_front_bwd_kernel), recomputing the forward from the
// saved inputs as the Pallas VJP does:
//  1. cm_bwd_rows, 64 rows a block (8 warps, each chunk's 64 columns over 2
//     warps): ha, hb as in the forward; dha = dg sigma(hb), dhb = dg ha
//     sigma(hb) (1 - sigma(hb)) in registers; dy += dha_bf16 . Wa_c^T +
//     dhb_bf16 . Wb_c^T with dha, dhb fed as A fragments straight from the
//     accumulators; then the LayerNorm backward into dx. y, dha and dhb go to
//     scratch as bf16 hi + lo (the f32 operands of the weight gradients), and
//     the column sums dba, dbb, dgamma, dbeta leave as one partial row per
//     16 rows (summed in row order inside the warp).
//  2. dWa = y^T . dha and dWb = y^T . dhb through ff_mma.cu's split product
//     (launch_split_atb: hi.hi + hi.lo + lo.hi, f32 accumulation, a fixed row
//     split summed as a fixed tree), and the column-sum partials through
//     sum_partials_kernel: the same bits on every run, no atomics.
//
// conv_back forward (cb_fwd), 32 rows a block (2 row groups x 4 column
// parts of each chunk): the BatchNorm apply and swish of the block's rows in
// f32, rounded to bf16 into shared memory (the reference's
// a.astype(w2.dtype)); W2 ([in, out]) staged 64 output columns at a time;
// z = a . W2_c on mma.sync; in registers + b2, the counter-hash dropout by
// (global row, column), x factor, + x; bf16 written from the accumulators.
// A 64-row tile was slower at N 6400 (0.0182 against 0.0158 ms at D 144,
// 0.0209 against 0.0171 at D 176; one NVIDIA H100 80GB HBM3, 700 W).
// conv_back backward (_back_bwd_kernel):
//  1. cb_bwd_rows, 32 rows a block as the forward (200 blocks at N 6400, in
//     one wave; 64-row blocks made the backward 0.0731 against 0.0668 ms at
//     D 144, 0.0815 against 0.0729 at D 176): y1 staged by cp.async; a = swish(bn) and dz = factor *
//     dout * keep of every element in f32, a and dz to scratch as bf16 hi +
//     lo, dz as bf16 into shared memory (the A operand); W2 staged 64 rows
//     (da's output columns) at a time; da = dz_bf16 . W2_c^T, then dbn = da
//     swish'(bn) and dy1 = dbn scale rstd in registers, written as bf16; the
//     column sums db2 (dz), dbias (dbn) and dscale (dbn xhat) leave as one
//     partial row per 16 rows. No product accumulates across chunks, so the
//     kernel holds one chunk's fragments, not a [16, D] accumulator.
//  2. dW2 = a^T . dz through launch_split_atb, the partials through
//     sum_partials_kernel; conv_module.cu's bn_stat_grads_kernel forms dmean
//     and dvar from dbias and dscale. The same bits on every run.
// What bounds them (N 6400, D 144): the products are 0.27 GFLOP
// (conv_back forward), 0.53 (its backward, da and dW2), 0.53 (conv_front
// forward) and 1.6 (its backward) of tensor-core work, ~1-2 us at 989
// TFLOP/s, beside ~2.7 MB of bf16 input and output each way (the bound is
// bytes: ~1-2 us); a block's chain of elementwise work, chunk loads and
// products sets the time. Times on one NVIDIA H100 80GB HBM3 at 700 W:
// PERF.md section 6, rows 6 and 7.
#include "mma.cuh"

namespace tfasr {

namespace {

constexpr int CM_CC = 64;  // output columns per Wa / Wb chunk
constexpr int CM_LDC = CM_CC + AM_PAD;
constexpr int CM_THREADS = 256;  // 8 warps
constexpr int CM_BWD_ROWS = 64;
constexpr int CM_FWD_RG = 2, CM_FWD_FQ = 4, CM_FWD_ROWS = 16 * CM_FWD_RG;  // forward: row groups of 16 x column quarters of a chunk

struct CMArgs {
  int N, D, Dp, nch;  // Dp: D rounded up to 16; nch: output-column chunks
  int vec;            // 16-byte cp.async staging of the weights (8 | D, aligned), else element copies
  float eps;
};

CMArgs cm_args(int N, int D, float eps, const void* wa, const void* wb) {
  const bool aligned = ((reinterpret_cast<uintptr_t>(wa) | reinterpret_cast<uintptr_t>(wb)) & 15) == 0;
  return CMArgs{N, D, (D + 15) / 16 * 16, (D + CM_CC - 1) / CM_CC, D % 8 == 0 && aligned, eps};
}

// Stage output-column chunk c (CC columns) of one [D][D] ([in][out]) weight
// into dst [Dp][CC + AM_PAD] (W[:, chunk]); rows and columns past D zero.
template <int CC = CM_CC>
__device__ __forceinline__ void cm_stage_cols(bf16* dst, const bf16* w, int c, int D, int Dp, int vec) {
  constexpr int LDC = CC + AM_PAD;
  const int c0 = c * CC;
  if (vec) {
    for (int i = threadIdx.x; i < Dp * (CC / 8); i += blockDim.x) {
      const int d = i / (CC / 8), f = (i % (CC / 8)) * 8;
      const bool ok = d < D && c0 + f < D;
      cp_async16(smem_u32(dst + d * LDC + f), ok ? w + (size_t)d * D + c0 + f : w, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < Dp * CC; i += blockDim.x) {
      const int d = i / CC, f = i % CC;
      dst[d * LDC + f] = (d < D && c0 + f < D) ? w[(size_t)d * D + c0 + f] : __float2bfloat16(0.f);
    }
  }
}

// Stage chunk c of Wa and Wb into wa_s, wb_s.
template <int CC = CM_CC>
__device__ __forceinline__ void cm_stage_w(bf16* wa_s, bf16* wb_s, const bf16* wa, const bf16* wb, int c, const CMArgs& a) {
  cm_stage_cols<CC>(wa_s, wa, c, a.D, a.Dp, a.vec);
  cm_stage_cols<CC>(wb_s, wb, c, a.D, a.Dp, a.vec);
}

// ha, hb [16 rows][8 NT columns] = y (16 rows at y_w, [16][ld]) . Wa_c, Wb_c at column col0 ([Dp][LDC]).
template <int NT, int LDC = CM_LDC>
__device__ __forceinline__ void cm_times_w(float (&ha)[NT][4], float (&hb)[NT][4], const bf16* y_w, int ld, const bf16* wa_c, const bf16* wb_c, int col0,
                                           int nk, int lane) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) ha[nt][e] = hb[nt][e] = 0.f;
#pragma unroll 3
  for (int kk = 0; kk < nk; ++kk) {
    uint32_t af[4];
    load_a(af, y_w + kk * 16, ld, lane);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      load_b_kn(b, wa_c + kk * 16 * LDC + col0 + np * 16, LDC, lane);
      mma16816(ha[2 * np], af, b[0], b[1]);
      mma16816(ha[2 * np + 1], af, b[2], b[3]);
      load_b_kn(b, wb_c + kk * 16 * LDC + col0 + np * 16, LDC, lane);
      mma16816(hb[2 * np], af, b[0], b[1]);
      mma16816(hb[2 * np + 1], af, b[2], b[3]);
    }
  }
}

// Zero the pad columns D..Dp of `rows` bf16 rows.
__device__ __forceinline__ void cm_zero_pad(bf16* s, int rows, int ld, int D, int Dp) {
  for (int i = threadIdx.x; i < rows * (Dp - D); i += blockDim.x) s[(i / (Dp - D)) * ld + D + i % (Dp - D)] = __float2bfloat16(0.f);
}

// RG row groups x FQ column parts of each CC-column chunk: 2 x 4 of 64
// columns up to D 256; 4 x 2 of 32 above (the wide tile: 64 rows, and the
// two double-buffered chunks of Wa and Wb at [Dp][40] fit beside them in
// 230,400 bytes at Dp 512, where 64-column chunks would take 328 KB).
template <int RG, int FQ, int CC>
__global__ void __launch_bounds__(CM_THREADS) cm_fwd(const bf16* __restrict__ x, const float* __restrict__ gamma, const float* __restrict__ beta,
                                                      const bf16* __restrict__ wa, const bf16* __restrict__ ba, const bf16* __restrict__ wb,
                                                      const bf16* __restrict__ bb, bf16* __restrict__ out, CMArgs a) {
  constexpr int ROWS = 16 * RG, WARPS = RG * FQ, FW = CC / FQ, NT = FW / 8, LDC = CC + AM_PAD;
  extern __shared__ __align__(16) unsigned char cm_smem[];
  const int Dp = a.Dp, LDD = Dp + AM_PAD, nk = Dp / 16, D = a.D, N = a.N;
  bf16* y_s = reinterpret_cast<bf16*>(cm_smem);  // [ROWS][LDD] LN output
  bf16* wa_s = y_s + ROWS * LDD;                 // [2][Dp][LDC]
  bf16* wb_s = wa_s + 2 * Dp * LDC;              // [2][Dp][LDC]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, tig = lane & 3;
  const int rg = warp % RG, fq = warp / RG;
  const int row0 = blockIdx.x * ROWS, row_lo = row0 + rg * 16 + g;

  cm_stage_w<CC>(wa_s, wb_s, wa, wb, 0, a);
  cp_async_commit();
  for (int r = warp; r < ROWS; r += WARPS) {
    bf16* dst = y_s + r * LDD;
    if (row0 + r < N)
      ln_row_warp<bf16>(x + (size_t)(row0 + r) * D, gamma, beta, D, a.eps, dst, lane);
    else
      for (int c = lane; c < D; c += 32) dst[c] = __float2bfloat16(0.f);
  }
  cm_zero_pad(y_s, ROWS, LDD, D, Dp);
  const bool pairs = (D & 1) == 0;
  for (int c = 0; c < a.nch; ++c) {
    if (c + 1 < a.nch) {
      cm_stage_w<CC>(wa_s + ((c + 1) & 1) * Dp * LDC, wb_s + ((c + 1) & 1) * Dp * LDC, wa, wb, c + 1, a);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int col0 = c * CC + fq * FW;
    if (col0 < D) {
      float ha[NT][4], hb[NT][4];
      cm_times_w<NT, LDC>(ha, hb, y_s + rg * 16 * LDD, LDD, wa_s + (c & 1) * Dp * LDC, wb_s + (c & 1) * Dp * LDC, fq * FW, nk, lane);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = col0 + nt * 8 + 2 * tig;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = row_lo + 8 * hf;
          if (row >= N || col >= D) continue;
          float gl[2];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int f = col + q < D ? col + q : col;
            gl[q] = (ha[nt][2 * hf + q] + to_f32(ba[f])) * sigmoid_f32(hb[nt][2 * hf + q] + to_f32(bb[f]));
          }
          bf16* o = out + (size_t)row * D + col;
          if (pairs) {
            *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(gl[0], gl[1]);
          } else {
            o[0] = __float2bfloat16(gl[0]);
            if (col + 1 < D) o[1] = __float2bfloat16(gl[1]);
          }
        }
      }
    }
    __syncthreads();  // before the next chunk's copy refills this buffer
  }
}

// Backward rows pass; see the header. part [4 * blocks][4D]: per 16 rows the
// column sums of dha (dba), dhb (dbb), dy * xhat (dgamma) and dy (dbeta).
template <int DMAX>
__global__ void __launch_bounds__(CM_THREADS, 1) cm_bwd_rows(const bf16* __restrict__ x, const float* __restrict__ gamma, const float* __restrict__ beta,
                                                            const bf16* __restrict__ wa, const bf16* __restrict__ ba, const bf16* __restrict__ wb,
                                                            const bf16* __restrict__ bb, const bf16* __restrict__ dout, bf16* __restrict__ dx, Split y_o,
                                                            Split dha_o, Split dhb_o, float* __restrict__ part, CMArgs a) {
  extern __shared__ __align__(16) unsigned char cm_smem[];
  const int Dp = a.Dp, LDD = Dp + AM_PAD, nk = Dp / 16, D = a.D, N = a.N;
  bf16* y_s = reinterpret_cast<bf16*>(cm_smem);                            // [64][LDD] LN output
  bf16* wa_s = y_s + CM_BWD_ROWS * LDD;                                    // [2][Dp][CM_LDC]
  bf16* wb_s = wa_s + 2 * Dp * CM_LDC;                                     // [2][Dp][CM_LDC]
  float* mu_s = reinterpret_cast<float*>(wb_s + 2 * Dp * CM_LDC);          // [64]
  float* rstd_s = mu_s + CM_BWD_ROWS;                                      // [64]
  float* dyx_s = reinterpret_cast<float*>(wa_s);                           // [64][Dp] the second column half's dy, after the loop
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, tig = lane & 3;
  const int rg = warp & 3, fh = warp >> 2;
  const int row0 = blockIdx.x * CM_BWD_ROWS, row_lo = row0 + rg * 16 + g;
  float* prow = part + (size_t)(blockIdx.x * 4 + rg) * 4 * D;  // this row group's column sums

  cm_stage_w(wa_s, wb_s, wa, wb, 0, a);
  cp_async_commit();
  for (int r = warp; r < CM_BWD_ROWS; r += CM_THREADS / 32) {
    const int row = row0 + r;
    bf16* ys = y_s + r * LDD;
    if (row >= N) {
      for (int c = lane; c < D; c += 32) ys[c] = __float2bfloat16(0.f);
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
      const float y = (to_f32(xr[c]) - mu) * rstd * gamma[c] + beta[c];
      ys[c] = __float2bfloat16(y);
      put_split(y_o, row, c, y);
    }
  }
  cm_zero_pad(y_s, CM_BWD_ROWS, LDD, D, Dp);

  float dy[DMAX / 8][4];
#pragma unroll
  for (int dt = 0; dt < DMAX / 8; ++dt) dy[dt][0] = dy[dt][1] = dy[dt][2] = dy[dt][3] = 0.f;
  const bf16* yw = y_s + rg * 16 * LDD;
  for (int c = 0; c < a.nch; ++c) {
    if (c + 1 < a.nch) {
      cm_stage_w(wa_s + ((c + 1) & 1) * Dp * CM_LDC, wb_s + ((c + 1) & 1) * Dp * CM_LDC, wa, wb, c + 1, a);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int col0 = c * CM_CC + fh * 32;
    if (col0 < D) {
      const bf16* wa_c = wa_s + (c & 1) * Dp * CM_LDC;
      const bf16* wb_c = wb_s + (c & 1) * Dp * CM_LDC;
      float ha[4][4], hb[4][4];
      cm_times_w<4>(ha, hb, yw, LDD, wa_c, wb_c, fh * 32, nk, lane);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int fc = col0 + nt * 8 + 2 * tig;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int f = fc + (e & 1), row = row_lo + (e >> 1) * 8;
          float dha = 0.f, dhb = 0.f;
          if (f < D && row < N) {
            const float ga = ha[nt][e] + to_f32(ba[f]), sg = sigmoid_f32(hb[nt][e] + to_f32(bb[f]));
            const float dg = to_f32(dout[(size_t)row * D + f]);
            dha = dg * sg;
            dhb = dg * ga * sg * (1.f - sg);
          }
          ha[nt][e] = dha;
          hb[nt][e] = dhb;
        }
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {  // columns fc, fc + 1 of rows row_lo, row_lo + 8 (fc + 1 < Dq: both even)
          const int row = row_lo + 8 * hf;
          if (fc < D && row < N) {
            put_split2(dha_o, row, fc, ha[nt][2 * hf], ha[nt][2 * hf + 1]);
            put_split2(dhb_o, row, fc, hb[nt][2 * hf], hb[nt][2 * hf + 1]);
          }
        }
        const float sa0 = col_sum8(ha[nt][0] + ha[nt][2]), sa1 = col_sum8(ha[nt][1] + ha[nt][3]);
        const float sb0 = col_sum8(hb[nt][0] + hb[nt][2]), sb1 = col_sum8(hb[nt][1] + hb[nt][3]);
        if (g == 0) {
          if (fc < D) prow[fc] = sa0, prow[D + fc] = sb0;
          if (fc + 1 < D) prow[fc + 1] = sa1, prow[D + fc + 1] = sb1;
        }
      }
      uint32_t pa[2][4], pb[2][4];
      frag_to_a<2>(pa, ha);
      frag_to_a<2>(pb, hb);
      // dy += dha_bf16 . Wa_c^T + dhb_bf16 . Wb_c^T: the chunk's rows (d) are the output columns, its columns the summed index
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
        for (int dpn = 0; dpn < DMAX / 16; ++dpn) {
          if (dpn < nk) {
            uint32_t b[4];
            load_b_nk(b, wa_c + dpn * 16 * CM_LDC + fh * 32 + ks * 16, CM_LDC, lane);
            mma16816(dy[2 * dpn], pa[ks], b[0], b[1]);
            mma16816(dy[2 * dpn + 1], pa[ks], b[2], b[3]);
            load_b_nk(b, wb_c + dpn * 16 * CM_LDC + fh * 32 + ks * 16, CM_LDC, lane);
            mma16816(dy[2 * dpn], pb[ks], b[0], b[1]);
            mma16816(dy[2 * dpn + 1], pb[ks], b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();  // before the next chunk's copy refills this buffer
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
      float cg[2] = {0.f, 0.f}, cb[2] = {0.f, 0.f};  // column sums of dy * xhat, dy
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hf = e >> 1, row = row_lo + 8 * hf, col = dt * 8 + 2 * tig + (e & 1);
        if (row < N && col < D) {
          const size_t off = (size_t)row * D + col;
          const float xhat = (to_f32(x[off]) - mu[hf]) * rstd[hf];
          const float v = dy[dt][e];
          dx[off] = __float2bfloat16(rstd[hf] * (v * gamma[col] - m1[hf] - xhat * m2[hf]));
          cg[e & 1] += v * xhat;
          cb[e & 1] += v;
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float sg = col_sum8(cg[j]), sb = col_sum8(cb[j]);
        const int col = dt * 8 + 2 * tig + j;
        if (g == 0 && col < D) prow[2 * D + col] = sg, prow[3 * D + col] = sb;
      }
    }
  }
}

// The wide backward rows pass (256 < Dp <= 512, Conformer-L): a [16, D]
// dy accumulator a warp and two 64-column chunks of Wa and Wb do not fit
// (256 f32 a thread; 295 KB), so, as the wide FF backward (ff_mma.cu), 32
// rows a block and 32-column chunks, double-buffered: (1) warp (rg, q)
// forms ha, hb of its 16 rows and the chunk's 8 columns 8q over the whole
// of D, then dha, dhb (to shared memory as bf16, to scratch as hi + lo, the
// column sums per 16 rows); (2) dy of the rows rg and the columns q * 128
// .. += dha . Wa_c^T + dhb . Wb_c^T; then wide_ln_bwd. part [2 * blocks][4D].
constexpr int CW_CC = 32, CW_LDC = CW_CC + AM_PAD;

__global__ void __launch_bounds__(CM_THREADS, 1) cmw_bwd_rows(const bf16* __restrict__ x, const float* __restrict__ gamma, const float* __restrict__ beta,
                                                             const bf16* __restrict__ wa, const bf16* __restrict__ ba, const bf16* __restrict__ wb,
                                                             const bf16* __restrict__ bb, const bf16* __restrict__ dout, bf16* __restrict__ dx, Split y_o,
                                                             Split dha_o, Split dhb_o, float* __restrict__ part, CMArgs a) {
  extern __shared__ __align__(16) unsigned char cm_smem[];
  const int Dp = a.Dp, LDD = Dp + AM_PAD, nk = Dp / 16, D = a.D, N = a.N;
  bf16* y_s = reinterpret_cast<bf16*>(cm_smem);                      // [32][LDD] LN output
  bf16* wa_s = y_s + WD_ROWS * LDD;                                  // [2][Dp][CW_LDC]
  bf16* wb_s = wa_s + 2 * Dp * CW_LDC;                               // [2][Dp][CW_LDC]
  bf16* dha_s = wb_s + 2 * Dp * CW_LDC;                              // [32][CW_LDC]
  bf16* dhb_s = dha_s + WD_ROWS * CW_LDC;                            // [32][CW_LDC]
  float* mu_s = reinterpret_cast<float*>(dhb_s + WD_ROWS * CW_LDC);  // [32]
  float* rstd_s = mu_s + WD_ROWS;                                    // [32]
  float* red_s = rstd_s + WD_ROWS;                                   // [2][4][32]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, tig = lane & 3;
  const int rg = warp & 1, q = warp >> 1, d0 = q * WD_DQ;
  const int row0 = blockIdx.x * WD_ROWS, row_lo = row0 + rg * 16 + g;
  float* prow = part + (size_t)(blockIdx.x * 2 + rg) * 4 * D;  // this row group's column sums

  cm_stage_w<CW_CC>(wa_s, wb_s, wa, wb, 0, a);
  cp_async_commit();
  for (int r = warp; r < WD_ROWS; r += CM_THREADS / 32) {
    const int row = row0 + r;
    bf16* ys = y_s + r * LDD;
    if (row >= N) {
      for (int c = lane; c < D; c += 32) ys[c] = __float2bfloat16(0.f);
      if (lane == 0) mu_s[r] = 0.f, rstd_s[r] = 0.f;
      continue;
    }
    const bf16* xr = x + (size_t)row * D;
    float s = 0.f;
    for (int c = lane; c < D; c += 32) s += to_f32(xr[c]);
    const float mu = warp_sum(s) / (float)D;
    float qv = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float cx = to_f32(xr[c]) - mu;
      qv = fmaf(cx, cx, qv);
    }
    const float rstd = rsqrtf(warp_sum(qv) / (float)D + a.eps);
    if (lane == 0) mu_s[r] = mu, rstd_s[r] = rstd;
    for (int c = lane; c < D; c += 32) {
      const float y = (to_f32(xr[c]) - mu) * rstd * gamma[c] + beta[c];
      ys[c] = __float2bfloat16(y);
      put_split(y_o, row, c, y);
    }
  }
  cm_zero_pad(y_s, WD_ROWS, LDD, D, Dp);

  float dy[WD_DQ / 8][4];
#pragma unroll
  for (int dt = 0; dt < WD_DQ / 8; ++dt) dy[dt][0] = dy[dt][1] = dy[dt][2] = dy[dt][3] = 0.f;
  const bf16* yw = y_s + rg * 16 * LDD;
  for (int c = 0; c < a.nch; ++c) {
    if (c + 1 < a.nch) {
      cm_stage_w<CW_CC>(wa_s + ((c + 1) & 1) * Dp * CW_LDC, wb_s + ((c + 1) & 1) * Dp * CW_LDC, wa, wb, c + 1, a);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* wa_c = wa_s + (c & 1) * Dp * CW_LDC;
    const bf16* wb_c = wb_s + (c & 1) * Dp * CW_LDC;
    float ha[4] = {0.f, 0.f, 0.f, 0.f}, hb[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int kk = 0; kk < nk; ++kk) {
      uint32_t af[4], b[2];
      load_a(af, yw + kk * 16, LDD, lane);
      load_b_kn_x2(b, wa_c + kk * 16 * CW_LDC + q * 8, CW_LDC, lane);
      mma16816(ha, af, b[0], b[1]);
      load_b_kn_x2(b, wb_c + kk * 16 * CW_LDC + q * 8, CW_LDC, lane);
      mma16816(hb, af, b[0], b[1]);
    }
    const int fc = c * CW_CC + q * 8 + 2 * tig;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int f = fc + (e & 1), row = row_lo + (e >> 1) * 8;
      float dha = 0.f, dhb = 0.f;
      if (f < D && row < N) {
        const float ga = ha[e] + to_f32(ba[f]), sg = sigmoid_f32(hb[e] + to_f32(bb[f]));
        const float dg = to_f32(dout[(size_t)row * D + f]);
        dha = dg * sg;
        dhb = dg * ga * sg * (1.f - sg);
      }
      ha[e] = dha;
      hb[e] = dhb;
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {  // columns fc, fc + 1 of rows row_lo, row_lo + 8 (fc + 1 < Dq: both even)
      const int row = row_lo + 8 * hf, r = rg * 16 + g + 8 * hf;
      if (fc < D && row < N) {
        put_split2(dha_o, row, fc, ha[2 * hf], ha[2 * hf + 1]);
        put_split2(dhb_o, row, fc, hb[2 * hf], hb[2 * hf + 1]);
      }
      *reinterpret_cast<uint32_t*>(dha_s + r * CW_LDC + q * 8 + 2 * tig) = pack_bf16(ha[2 * hf], ha[2 * hf + 1]);
      *reinterpret_cast<uint32_t*>(dhb_s + r * CW_LDC + q * 8 + 2 * tig) = pack_bf16(hb[2 * hf], hb[2 * hf + 1]);
    }
    const float sa0 = col_sum8(ha[0] + ha[2]), sa1 = col_sum8(ha[1] + ha[3]);
    const float sb0 = col_sum8(hb[0] + hb[2]), sb1 = col_sum8(hb[1] + hb[3]);
    if (g == 0) {
      if (fc < D) prow[fc] = sa0, prow[D + fc] = sb0;
      if (fc + 1 < D) prow[fc + 1] = sa1, prow[D + fc + 1] = sb1;
    }
    __syncthreads();
    // dy += dha_bf16 . Wa_c^T + dhb_bf16 . Wb_c^T: the chunk's rows (d) are the output columns, its columns the summed index
#pragma unroll
    for (int ks = 0; ks < CW_CC / 16; ++ks) {
      uint32_t pa[4], pb[4];
      load_a(pa, dha_s + rg * 16 * CW_LDC + ks * 16, CW_LDC, lane);
      load_a(pb, dhb_s + rg * 16 * CW_LDC + ks * 16, CW_LDC, lane);
#pragma unroll
      for (int np = 0; np < WD_DQ / 16; ++np) {
        if (d0 + np * 16 < Dp) {
          uint32_t b[4];
          load_b_nk(b, wa_c + (d0 + np * 16) * CW_LDC + ks * 16, CW_LDC, lane);
          mma16816(dy[2 * np], pa, b[0], b[1]);
          mma16816(dy[2 * np + 1], pa, b[2], b[3]);
          load_b_nk(b, wb_c + (d0 + np * 16) * CW_LDC + ks * 16, CW_LDC, lane);
          mma16816(dy[2 * np], pb, b[0], b[1]);
          mma16816(dy[2 * np + 1], pb, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // before the next chunk's copy refills this buffer and dha_s, dhb_s are rewritten
  }
  const Dropout off{0u, 0u, 1.f, 0};
  wide_ln_bwd(dy, red_s, mu_s, rstd_s, x, gamma, nullptr, dx, prow, 2 * D, 3 * D, 0, 0.f, off, 0u, row0, N, D, Dp, lane, warp);
}

size_t cm_fwd_smem(int Dp, int rows) { return (size_t)(rows * (Dp + AM_PAD) + 4 * Dp * CM_LDC) * sizeof(bf16); }
size_t cm_bwd_smem(int Dp) { return cm_fwd_smem(Dp, CM_BWD_ROWS) + 2 * CM_BWD_ROWS * sizeof(float); }
// The wide kernels (Dp > 256): the forward's 64 rows beside two 32-column chunks of Wa and Wb; the backward's 32 rows.
constexpr int CM_WIDE_RG = 4, CM_WIDE_FQ = 2;
size_t cmw_fwd_smem(int Dp) { return (size_t)(16 * CM_WIDE_RG * (Dp + AM_PAD) + 4 * Dp * CW_LDC) * sizeof(bf16); }
size_t cmw_bwd_smem(int Dp) {
  return (size_t)(WD_ROWS * (Dp + AM_PAD) + 4 * Dp * CW_LDC + 2 * WD_ROWS * CW_LDC) * sizeof(bf16) + (2 * WD_ROWS + 8 * 32) * sizeof(float);
}
// Column-sum partial rows of the conv_front backward: one per 16 rows of its blocks.
int cm_part_rows(int N, int Dp) { return Dp > 256 ? 2 * ((N + WD_ROWS - 1) / WD_ROWS) : 4 * ((N + CM_BWD_ROWS - 1) / CM_BWD_ROWS); }

// Scratch of the backward, in floats: y, dha, dhb [N, Dq] as bf16 hi and lo
// (Dq: D rounded up to 8, so that every row is 16-byte aligned), the
// column-sum partials [4 * blocks][4D], then the weight-gradient partials.
struct CMScratch {
  int Dq;
  size_t y, dha, dhb, part, partial, total;
  CMScratch(int N, int D) {
    Dq = (D + 7) / 8 * 8;
    const size_t nd = (size_t)N * Dq;  // floats per hi + lo pair
    y = 0;
    dha = y + nd;
    dhb = dha + nd;
    part = dhb + nd;
    partial = part + (size_t)4 * cm_part_rows(N, (D + 15) / 16 * 16) * D;
    total = partial + (size_t)split_atb_partial_floats(N, D, D);
  }
  static Split split(float* scratch, size_t off, int N, int ld) {
    bf16* hi = reinterpret_cast<bf16*>(scratch + off);
    return Split{hi, hi + (size_t)N * ld, ld};
  }
};

// The backward at a width: DMAX the padded width's bound among 64, 128, 160, 192, 256.
template <template <int> class K, typename... Args>
int cm_dispatch(int Dp, Args... args) {
  if (Dp <= 64) return K<64>::run(args...);
  if (Dp <= 128) return K<128>::run(args...);
  if (Dp <= 160) return K<160>::run(args...);
  if (Dp <= 192) return K<192>::run(args...);
  if (Dp <= 256) return K<256>::run(args...);
  return (int)cudaErrorInvalidValue;
}

template <int DMAX>
struct BwdRun {
  static int run(const void* x, const void* gamma, const void* beta, const void* wa, const void* ba, const void* wb, const void* bb, const void* dout,
                 void* dx, float* scratch, CMArgs a, cudaStream_t stream) {
    const CMScratch L(a.N, a.D);
    const size_t smem = cm_bwd_smem(a.Dp);
    cudaError_t err = allow_smem(cm_bwd_rows<DMAX>, smem);
    if (err != cudaSuccess) return (int)err;
    cm_bwd_rows<DMAX><<<(a.N + CM_BWD_ROWS - 1) / CM_BWD_ROWS, CM_THREADS, smem, stream>>>(
        (const bf16*)x, (const float*)gamma, (const float*)beta, (const bf16*)wa, (const bf16*)ba, (const bf16*)wb, (const bf16*)bb, (const bf16*)dout,
        (bf16*)dx, CMScratch::split(scratch, L.y, a.N, L.Dq), CMScratch::split(scratch, L.dha, a.N, L.Dq), CMScratch::split(scratch, L.dhb, a.N, L.Dq),
        scratch + L.part, a);
    return (int)cudaGetLastError();
  }
};

template <typename Kernel>
int cm_occupancy(Kernel kernel, size_t smem) {
  int blocks = -1;
  cudaError_t err = allow_smem(kernel, smem);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, CM_THREADS, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

template <int DMAX>
struct BwdOccupancy {
  static int run(int Dp) { return cm_occupancy(cm_bwd_rows<DMAX>, cm_bwd_smem(Dp)); }
};

// ---------------------------------- conv_back ---------------------------------- //

struct CBArgs {
  int N, D, Dp, nch;  // Dp: D rounded up to 16; nch: 64-column chunks of W2
  int vec;            // 16-byte cp.async staging of W2 and y1 rows and 8-wide activation loads (8 | D, aligned)
  float eps, factor;
};

CBArgs cb_args(int N, int D, float eps, float factor, const void* w2, const void* y1) {
  const bool aligned = ((reinterpret_cast<uintptr_t>(w2) | reinterpret_cast<uintptr_t>(y1)) & 15) == 0;
  return CBArgs{N, D, (D + 15) / 16 * 16, (D + CM_CC - 1) / CM_CC, D % 8 == 0 && aligned, eps, factor};
}

// The BatchNorm apply's per-column constants in shared memory, prm [4][Dp]:
// mean, rstd = rsqrt(var + eps), scale, bias (pad columns 0).
__device__ __forceinline__ void cb_stage_bn(float* prm, const float* mean, const float* var, const float* scale, const float* bias, int D, int Dp,
                                            float eps) {
  for (int c = threadIdx.x; c < Dp; c += blockDim.x) {
    const bool ok = c < D;
    prm[c] = ok ? mean[c] : 0.f;
    prm[Dp + c] = ok ? rsqrtf(var[c] + eps) : 0.f;
    prm[2 * Dp + c] = ok ? scale[c] : 0.f;
    prm[3 * Dp + c] = ok ? bias[c] : 0.f;
  }
}

// xhat = (y - mean) * rstd and bn = xhat * scale + bias of column c.
__device__ __forceinline__ float cb_xhat(const float* prm, int Dp, int c, float y) { return (y - prm[c]) * prm[Dp + c]; }
__device__ __forceinline__ float cb_bn(const float* prm, int Dp, int c, float xhat) { return xhat * prm[2 * Dp + c] + prm[3 * Dp + c]; }

// z [16 rows][8 NT columns] = a (16 rows at a_w, [16][ld]) . W_c at column col0 ([Dp][CM_LDC]).
template <int NT>
__device__ __forceinline__ void cb_times_w(float (&z)[NT][4], const bf16* a_w, int ld, const bf16* w_c, int col0, int nk, int lane) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) z[nt][0] = z[nt][1] = z[nt][2] = z[nt][3] = 0.f;
#pragma unroll 3
  for (int kk = 0; kk < nk; ++kk) {
    uint32_t af[4];
    load_a(af, a_w + kk * 16, ld, lane);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      load_b_kn(b, w_c + kk * 16 * CM_LDC + col0 + np * 16, CM_LDC, lane);
      mma16816(z[2 * np], af, b[0], b[1]);
      mma16816(z[2 * np + 1], af, b[2], b[3]);
    }
  }
}

constexpr int CB_RG = 2, CB_FQ = 4, CB_ROWS = 16 * CB_RG;  // both kernels: row groups of 16 x column parts of each 64-column chunk

// The forward; see the header.
__global__ void __launch_bounds__(CM_THREADS) cb_fwd(const bf16* __restrict__ x, const bf16* __restrict__ y1, const float* __restrict__ mean,
                                                      const float* __restrict__ var, const float* __restrict__ scale, const float* __restrict__ bias,
                                                      const bf16* __restrict__ w2, const bf16* __restrict__ b2, bf16* __restrict__ out, CBArgs a,
                                                      Dropout dp) {
  constexpr int RG = CB_RG, ROWS = CB_ROWS, FW = CM_CC / CB_FQ, NT = FW / 8;
  extern __shared__ __align__(16) unsigned char cm_smem[];
  const int Dp = a.Dp, LDD = Dp + AM_PAD, nk = Dp / 16, D = a.D, N = a.N;
  bf16* a_s = reinterpret_cast<bf16*>(cm_smem);             // [ROWS][LDD] swish(BN(y1)) rounded to bf16
  bf16* w_s = a_s + ROWS * LDD;                             // [2][Dp][CM_LDC] W2[:, chunk]
  float* prm = reinterpret_cast<float*>(w_s + 2 * Dp * CM_LDC);  // [4][Dp]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, tig = lane & 3;
  const int rg = warp % RG, fq = warp / RG;
  const int row0 = blockIdx.x * ROWS, row_lo = row0 + rg * 16 + g;

  cm_stage_cols(w_s, w2, 0, D, Dp, a.vec);
  cp_async_commit();
  cb_stage_bn(prm, mean, var, scale, bias, D, Dp, a.eps);
  __syncthreads();
  for (int i = threadIdx.x; i < ROWS * (Dp / 8); i += blockDim.x) {  // 8 columns a thread
    const int r = i / (Dp / 8), c0 = (i - r * (Dp / 8)) * 8, row = row0 + r;
    float v[8];
    if (row < N && a.vec && c0 < D) {
      const uint4 raw = *reinterpret_cast<const uint4*>(y1 + (size_t)row * D + c0);
      const bf16* h = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int q = 0; q < 8; ++q) v[q] = to_f32(h[q]);
    } else {
#pragma unroll
      for (int q = 0; q < 8; ++q) v[q] = row < N && c0 + q < D ? to_f32(y1[(size_t)row * D + c0 + q]) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int c = c0 + q;
      float s = 0.f;
      if (row < N && c < D) {
        const float bn = cb_bn(prm, Dp, c, cb_xhat(prm, Dp, c, v[q]));
        s = bn * sigmoid_f32(bn);
      }
      v[q] = s;
    }
    *reinterpret_cast<uint4*>(a_s + r * LDD + c0) = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
  }
  const bool pairs = (D & 1) == 0;
  for (int c = 0; c < a.nch; ++c) {
    if (c + 1 < a.nch) {
      cm_stage_cols(w_s + ((c + 1) & 1) * Dp * CM_LDC, w2, c + 1, D, Dp, a.vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int col0 = c * CM_CC + fq * FW;
    if (col0 < D) {
      float z[NT][4];
      cb_times_w<NT>(z, a_s + rg * 16 * LDD, LDD, w_s + (c & 1) * Dp * CM_LDC, fq * FW, nk, lane);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = col0 + nt * 8 + 2 * tig;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = row_lo + 8 * hf;
          if (row >= N || col >= D) continue;
          const size_t off = (size_t)row * D + col;
          float o[2];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int f = col + q < D ? col + q : col;
            float zz = z[nt][2 * hf + q] + to_f32(b2[f]);
            if (dp.on) zz *= dropout_keep(dp, dp.seed, row, f);
            o[q] = to_f32(x[off + (f - col)]) + a.factor * zz;
          }
          if (pairs) {
            *reinterpret_cast<__nv_bfloat162*>(out + off) = __floats2bfloat162_rn(o[0], o[1]);
          } else {
            out[off] = __float2bfloat16(o[0]);
            if (col + 1 < D) out[off + 1] = __float2bfloat16(o[1]);
          }
        }
      }
    }
    __syncthreads();  // before the next chunk's copy refills this buffer
  }
}

// Backward rows pass; see the header. part [CB_RG * blocks][3D]: per 16 rows
// the column sums of dz (db2), dbn (dbias) and dbn * xhat (dscale). DMAX:
// the bound of da's k-steps, 256, or 512 for the wide widths (the tile is
// the same; at Dp 512 it takes 207,872 bytes of shared memory).
template <int DMAX>
__global__ void __launch_bounds__(CM_THREADS) cb_bwd_rows(const bf16* __restrict__ y1, const float* __restrict__ mean, const float* __restrict__ var,
                                                           const float* __restrict__ scale, const float* __restrict__ bias, const bf16* __restrict__ w2,
                                                           const bf16* __restrict__ dout, bf16* __restrict__ dy1, Split a_o, Split dz_o,
                                                           float* __restrict__ part, CBArgs a, Dropout dp) {
  constexpr int RG = CB_RG, ROWS = CB_ROWS, FW = CM_CC / CB_FQ, NT = FW / 8;
  extern __shared__ __align__(16) unsigned char cm_smem[];
  const int Dp = a.Dp, LDD = Dp + AM_PAD, nk = Dp / 16, D = a.D, N = a.N;
  bf16* y_s = reinterpret_cast<bf16*>(cm_smem);  // [ROWS][LDD] y1
  bf16* dz_s = y_s + ROWS * LDD;                 // [ROWS][LDD] dz rounded to bf16
  bf16* w_s = dz_s + ROWS * LDD;                 // [2][CM_CC][LDD] W2[chunk, :]
  float* prm = reinterpret_cast<float*>(w_s + 2 * CM_CC * LDD);  // [4][Dp]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, tig = lane & 3;
  const int rg = warp % RG, fq = warp / RG;
  const int row0 = blockIdx.x * ROWS, row_lo = row0 + rg * 16 + g;
  float* prow = part + (size_t)(blockIdx.x * RG + rg) * 3 * D;  // this row group's column sums

  am_stage(y_s, y1, row0, N, ROWS, D, Dp, a.vec);
  cp_async_commit();
  am_stage(w_s, w2, 0, D, CM_CC, D, Dp, a.vec);
  cp_async_commit();
  cb_stage_bn(prm, mean, var, scale, bias, D, Dp, a.eps);
  cp_async_wait<1>();
  __syncthreads();
  for (int i = threadIdx.x; i < ROWS * (Dp / 2); i += blockDim.x) {  // column pairs
    const int r = i / (Dp / 2), c = (i - r * (Dp / 2)) * 2, row = row0 + r;
    float av[2] = {0.f, 0.f}, dz[2] = {0.f, 0.f};
    if (row < N) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (c + q < D) {
          const float bn = cb_bn(prm, Dp, c + q, cb_xhat(prm, Dp, c + q, to_f32(y_s[r * LDD + c + q])));
          av[q] = bn * sigmoid_f32(bn);
          dz[q] = a.factor * to_f32(dout[(size_t)row * D + c + q]);
          if (dp.on) dz[q] *= dropout_keep(dp, dp.seed, row, c + q);
        }
      }
      if (c + 1 < D) {
        put_split2(a_o, row, c, av[0], av[1]);
        put_split2(dz_o, row, c, dz[0], dz[1]);
      } else if (c < D) {
        put_split(a_o, row, c, av[0]);
        put_split(dz_o, row, c, dz[0]);
      }
    }
    *reinterpret_cast<__nv_bfloat162*>(dz_s + r * LDD + c) = __floats2bfloat162_rn(dz[0], dz[1]);
  }
  const bool pairs = (D & 1) == 0;
  const bf16* dzw = dz_s + rg * 16 * LDD;
  for (int c = 0; c < a.nch; ++c) {
    if (c + 1 < a.nch) {
      am_stage(w_s + ((c + 1) & 1) * CM_CC * LDD, w2, (c + 1) * CM_CC, D, CM_CC, D, Dp, a.vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int col0 = c * CM_CC + fq * FW;
    if (col0 < D) {
      float da[NT][4];  // da = dz_bf16 . W2^T: W2's chunk rows are da's columns
      am_abT<DMAX, NT>(da, dzw, w_s + (c & 1) * CM_CC * LDD + fq * FW * LDD, LDD, nk, lane);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int fc = col0 + nt * 8 + 2 * tig;
        float sz[2] = {0.f, 0.f}, sb[2] = {0.f, 0.f}, sx[2] = {0.f, 0.f};  // over rows g and g + 8: dz, dbn, dbn * xhat
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int f = fc + (e & 1), r = rg * 16 + g + (e >> 1) * 8, row = row0 + r;
          float d = 0.f;
          if (f < D && row < N) {
            const float xh = cb_xhat(prm, Dp, f, to_f32(y_s[r * LDD + f])), bn = cb_bn(prm, Dp, f, xh), sig = sigmoid_f32(bn);
            const float dbn = da[nt][e] * (sig + bn * sig * (1.f - sig));
            d = dbn * prm[2 * Dp + f] * prm[Dp + f];
            float dzv = a.factor * to_f32(dout[(size_t)row * D + f]);
            if (dp.on) dzv *= dropout_keep(dp, dp.seed, row, f);
            sz[e & 1] += dzv;
            sb[e & 1] += dbn;
            sx[e & 1] += dbn * xh;
          }
          da[nt][e] = d;
        }
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = row_lo + 8 * hf;
          if (fc >= D || row >= N) continue;
          bf16* o = dy1 + (size_t)row * D + fc;
          if (pairs) {
            *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(da[nt][2 * hf], da[nt][2 * hf + 1]);
          } else {
            o[0] = __float2bfloat16(da[nt][2 * hf]);
            if (fc + 1 < D) o[1] = __float2bfloat16(da[nt][2 * hf + 1]);
          }
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float s0 = col_sum8(sz[j]), s1 = col_sum8(sb[j]), s2 = col_sum8(sx[j]);
          if (g == 0 && fc + j < D) prow[fc + j] = s0, prow[D + fc + j] = s1, prow[2 * D + fc + j] = s2;
        }
      }
    }
    __syncthreads();  // before the next chunk's copy refills this buffer
  }
}

size_t cb_fwd_smem(int Dp) { return (size_t)(CB_ROWS * (Dp + AM_PAD) + 2 * Dp * CM_LDC) * sizeof(bf16) + 4 * Dp * sizeof(float); }
size_t cb_bwd_smem(int Dp) { return (size_t)(2 * CB_ROWS * (Dp + AM_PAD) + 2 * CM_CC * (Dp + AM_PAD)) * sizeof(bf16) + 4 * Dp * sizeof(float); }
int cb_blocks(int N) { return (N + CB_ROWS - 1) / CB_ROWS; }

// Scratch of the backward, in floats: a, dz [N, Dq] as bf16 hi and lo (Dq:
// D rounded up to 8), the column-sum partials [CB_RG * blocks][3D], then
// the weight-gradient partials.
struct CBScratch {
  int Dq;
  size_t a, dz, part, partial, total;
  CBScratch(int N, int D) {
    Dq = (D + 7) / 8 * 8;
    const size_t nd = (size_t)N * Dq;
    a = 0;
    dz = a + nd;
    part = dz + nd;
    partial = part + (size_t)3 * D * CB_RG * cb_blocks(N);
    total = partial + (size_t)split_atb_partial_floats(N, D, D);
  }
};

}  // namespace

int launch_conv_front_mma(const void* x, const void* gamma, const void* beta, const void* wa, const void* ba, const void* wb, const void* bb, void* out,
                          int N, int D, float eps, cudaStream_t stream) {
  CMArgs a = cm_args(N, D, eps, wa, wb);
  if (a.Dp > WD_DMAX) return (int)cudaErrorInvalidValue;
  if (a.Dp > 256) {
    constexpr int ROWS = 16 * CM_WIDE_RG;
    a.nch = (D + CW_CC - 1) / CW_CC;
    const size_t smem = cmw_fwd_smem(a.Dp);
    auto kernel = cm_fwd<CM_WIDE_RG, CM_WIDE_FQ, CW_CC>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(N + ROWS - 1) / ROWS, CM_THREADS, smem, stream>>>((const bf16*)x, (const float*)gamma, (const float*)beta, (const bf16*)wa, (const bf16*)ba,
                                                                 (const bf16*)wb, (const bf16*)bb, (bf16*)out, a);
    return (int)cudaGetLastError();
  }
  const size_t smem = cm_fwd_smem(a.Dp, CM_FWD_ROWS);
  auto kernel = cm_fwd<CM_FWD_RG, CM_FWD_FQ, CM_CC>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(N + CM_FWD_ROWS - 1) / CM_FWD_ROWS, CM_THREADS, smem, stream>>>((const bf16*)x, (const float*)gamma, (const float*)beta, (const bf16*)wa,
                                                                           (const bf16*)ba, (const bf16*)wb, (const bf16*)bb, (bf16*)out, a);
  return (int)cudaGetLastError();
}

long long conv_front_mma_bwd_scratch(int N, int D) { return (long long)CMScratch(N, D).total; }

// cols [4D] f32: dba, dbb, dgamma, dbeta in that order; dwa, dwb [D, D] f32.
int launch_conv_front_mma_bwd(const void* x, const void* gamma, const void* beta, const void* wa, const void* ba, const void* wb, const void* bb,
                              const void* dout, void* dx, float* cols, float* dwa, float* dwb, float* scratch, int N, int D, float eps,
                              cudaStream_t stream) {
  CMArgs a = cm_args(N, D, eps, wa, wb);
  if (a.Dp > WD_DMAX) return (int)cudaErrorInvalidValue;
  const CMScratch L(N, D);
  int e;
  if (a.Dp > 256) {
    a.nch = (D + CW_CC - 1) / CW_CC;
    const size_t smem = cmw_bwd_smem(a.Dp);
    cudaError_t err = allow_smem(cmw_bwd_rows, smem);
    if (err != cudaSuccess) return (int)err;
    cmw_bwd_rows<<<(N + WD_ROWS - 1) / WD_ROWS, CM_THREADS, smem, stream>>>(
        (const bf16*)x, (const float*)gamma, (const float*)beta, (const bf16*)wa, (const bf16*)ba, (const bf16*)wb, (const bf16*)bb, (const bf16*)dout,
        (bf16*)dx, CMScratch::split(scratch, L.y, N, L.Dq), CMScratch::split(scratch, L.dha, N, L.Dq), CMScratch::split(scratch, L.dhb, N, L.Dq),
        scratch + L.part, a);
    e = (int)cudaGetLastError();
  } else {
    e = cm_dispatch<BwdRun>(a.Dp, x, gamma, beta, wa, ba, wb, bb, dout, dx, scratch, a, stream);
  }
  if (e) return e;
  if ((e = launch_sum_partials(scratch + L.part, cols, cm_part_rows(N, a.Dp), (size_t)4 * D, stream))) return e;
  const Split y = CMScratch::split(scratch, L.y, N, L.Dq);
  if ((e = launch_split_atb(y, CMScratch::split(scratch, L.dha, N, L.Dq), dwa, scratch + L.partial, N, D, D, stream))) return e;
  return launch_split_atb(y, CMScratch::split(scratch, L.dhb, N, L.Dq), dwb, scratch + L.partial, N, D, D, stream);
}

int launch_conv_back_mma(const void* x, const void* y1, const void* mean, const void* var, const void* scale, const void* bias, const void* w2,
                         const void* b2, void* out, int N, int D, float eps, float factor, Dropout dp, cudaStream_t stream) {
  const CBArgs a = cb_args(N, D, eps, factor, w2, y1);
  if (a.Dp > WD_DMAX) return (int)cudaErrorInvalidValue;
  const size_t smem = cb_fwd_smem(a.Dp);
  cudaError_t err = allow_smem(cb_fwd, smem);
  if (err != cudaSuccess) return (int)err;
  cb_fwd<<<cb_blocks(N), CM_THREADS, smem, stream>>>((const bf16*)x, (const bf16*)y1, (const float*)mean, (const float*)var, (const float*)scale,
                                                     (const float*)bias, (const bf16*)w2, (const bf16*)b2, (bf16*)out, a, dp);
  return (int)cudaGetLastError();
}

long long conv_back_mma_bwd_scratch(int N, int D) { return (long long)CBScratch(N, D).total; }

// cols [3D] f32: db2, dbias, dscale in that order; dw2 [D, D] f32.
int launch_conv_back_mma_bwd(const void* y1, const void* mean, const void* var, const void* scale, const void* bias, const void* w2, const void* dout,
                             void* dy1, float* cols, float* dw2, float* scratch, int N, int D, float eps, float factor, Dropout dp,
                             cudaStream_t stream) {
  const CBArgs a = cb_args(N, D, eps, factor, w2, y1);
  if (a.Dp > WD_DMAX) return (int)cudaErrorInvalidValue;
  const CBScratch L(N, D);
  const size_t smem = cb_bwd_smem(a.Dp);
  auto kernel = &cb_bwd_rows<256>;
  if (a.Dp > 256) kernel = &cb_bwd_rows<WD_DMAX>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const Split as = CMScratch::split(scratch, L.a, N, L.Dq), dzs = CMScratch::split(scratch, L.dz, N, L.Dq);
  kernel<<<cb_blocks(N), CM_THREADS, smem, stream>>>((const bf16*)y1, (const float*)mean, (const float*)var, (const float*)scale,
                                                          (const float*)bias, (const bf16*)w2, (const bf16*)dout, (bf16*)dy1, as, dzs, scratch + L.part,
                                                          a, dp);
  int e = (int)cudaGetLastError();
  if (e) return e;
  if ((e = launch_sum_partials(scratch + L.part, cols, CB_RG * cb_blocks(N), (size_t)3 * D, stream))) return e;
  return launch_split_atb(as, dzs, dw2, scratch + L.partial, N, D, D, stream);
}

}  // namespace tfasr

// Dynamic shared memory (bytes) at width D of the bf16 kernels: conv_front's
// forward (which 0) and backward rows pass (1), conv_back's forward (2) and
// backward rows pass (3); tests/test_torch_joint_conv_mma.py and
// tests/test_torch_conv_back_fft.py plan the same (conv_front's wide
// kernels above Dp 256: ops/cuda/conv_kernel.py:conv_front_wide_smem).
extern "C" long long tfasr_conv_mma_smem(int D, int which) {
  using namespace tfasr;
  const int Dp = (D + 15) / 16 * 16;
  switch (which) {
    case 0: return (long long)(Dp > 256 ? cmw_fwd_smem(Dp) : cm_fwd_smem(Dp, CM_FWD_ROWS));
    case 1: return (long long)(Dp > 256 ? cmw_bwd_smem(Dp) : cm_bwd_smem(Dp));
    case 2: return (long long)cb_fwd_smem(Dp);
    case 3: return (long long)cb_bwd_smem(Dp);
    default: return -1;
  }
}

// Blocks per SM of that kernel on the current card; a negative value is the CUDA error.
extern "C" int tfasr_conv_mma_occupancy(int D, int which) {
  using namespace tfasr;
  const int Dp = (D + 15) / 16 * 16;
  if (Dp > WD_DMAX) return -(int)cudaErrorInvalidValue;
  switch (which) {
    case 0:
      return Dp > 256 ? cm_occupancy(cm_fwd<CM_WIDE_RG, CM_WIDE_FQ, CW_CC>, cmw_fwd_smem(Dp)) : cm_occupancy(cm_fwd<CM_FWD_RG, CM_FWD_FQ, CM_CC>, cm_fwd_smem(Dp, CM_FWD_ROWS));
    case 1: return Dp > 256 ? cm_occupancy(cmw_bwd_rows, cmw_bwd_smem(Dp)) : cm_dispatch<BwdOccupancy>(Dp, Dp);
    case 2: return cm_occupancy(cb_fwd, cb_fwd_smem(Dp));
    case 3: return Dp > 256 ? cm_occupancy(cb_bwd_rows<WD_DMAX>, cb_bwd_smem(Dp)) : cm_occupancy(cb_bwd_rows<256>, cb_bwd_smem(Dp));
    default: return -(int)cudaErrorInvalidValue;
  }
}

// Floats of scratch the bf16 backwards need.
extern "C" long long tfasr_conv_front_mma_scratch(int N, int D) { return tfasr::conv_front_mma_bwd_scratch(N, D); }
extern "C" long long tfasr_conv_back_mma_scratch(int N, int D) { return tfasr::conv_back_mma_bwd_scratch(N, D); }
