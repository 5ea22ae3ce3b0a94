// conv_front in bf16 on the tensor cores, forward and backward:
//   out = GLU([y . Wa + ba, y . Wb + bb]) = (y . Wa + ba) * sigmoid(y . Wb + bb),  y = LN(x)
// The f32 instantiation stays on the CUDA-core kernels of conv_module.cu,
// whose C entry points dispatch here for bf16 inputs.
//
// Counterpart of tensorflowasr_tpu/ops/pallas/conv_kernel.py conv_front
// (_front_fwd_kernel, _front_bwd_kernel, conv_kernel.py:80-127). Its maths is
// the fused FF's first half (ff_mma.cu) with two D x D products and GLU in
// place of swish, and it takes the FF's design: every product an mma.sync
// m16n8k16 with bf16 operands and f32 accumulators from shared memory by
// ldmatrix; Wa and Wb ([in, out]) staged 64 output columns at a time in a
// cp.async double buffer, so a block reads the weights from L2 once; D padded
// to a multiple of 16 in shared memory only (D 144 = 9 x 16, 176 = 11 x 16).
// Rows past N are neither read nor written: the JAX kernel's zeroed padding
// rows are rows of its tiles, which the card's blocks mask instead.
//
// Forward (cm_fwd): the LayerNorm in f32 rounded to bf16 into shared memory;
// warp (rg, fq) of RG x FQ owns 16 rows and 64 / FQ columns of each chunk:
// ha and hb share the A fragments, GLU in registers, the output written
// from the accumulators. The row tile is 32 rows (RG 2 x FQ 4 warps): a
// block's time is its warps' chain over the chunks, and a 64-row tile (RG 4
// x FQ 2), which reads the weights half as often, was slower at every
// driven shape on an H100 (N 2000 and 6400 at D 144 and 176; PERF.md §6).
//
// Backward (_front_bwd_kernel), recomputing the forward from the saved
// inputs as the Pallas VJP does:
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
//     split summed in order), and the column-sum partials through
//     sum_partials_kernel: the same bits on every run, no atomics.
// What bounds it: at N 6400, D 144 the forward's products are 0.53 GFLOP and
// the backward's six 1.6 GFLOP of tensor-core work (~2 us at 989 TFLOP/s),
// beside ~1.8 MB of input and output each way (the bound is bytes:
// ~1-2 us); a block's chain of LayerNorm, chunk loads and products sets the
// time.
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

// Stage chunk c of Wa and Wb ([D][D], [in][out]) into wa_s, wb_s [Dp][CM_LDC]
// (Wa[:, chunk]); rows and columns past D zero.
__device__ __forceinline__ void cm_stage_w(bf16* wa_s, bf16* wb_s, const bf16* wa, const bf16* wb, int c, const CMArgs& a) {
  const int c0 = c * CM_CC, D = a.D, per = a.Dp * (CM_CC / 8);
  if (a.vec) {
    for (int i = threadIdx.x; i < 2 * per; i += blockDim.x) {
      const int m = i / per, r = i - m * per, d = r / (CM_CC / 8), f = (r % (CM_CC / 8)) * 8;
      const bool ok = d < D && c0 + f < D;
      const bf16* src = m ? wb : wa;
      cp_async16(smem_u32((m ? wb_s : wa_s) + d * CM_LDC + f), ok ? src + (size_t)d * D + c0 + f : src, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < a.Dp * CM_CC; i += blockDim.x) {
      const int d = i / CM_CC, f = i % CM_CC;
      const bool ok = d < D && c0 + f < D;
      wa_s[d * CM_LDC + f] = ok ? wa[(size_t)d * D + c0 + f] : __float2bfloat16(0.f);
      wb_s[d * CM_LDC + f] = ok ? wb[(size_t)d * D + c0 + f] : __float2bfloat16(0.f);
    }
  }
}

// ha, hb [16 rows][8 NT columns] = y (16 rows at y_w, [16][ld]) . Wa_c, Wb_c at column col0 ([Dp][CM_LDC]).
template <int NT>
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
      load_b_kn(b, wa_c + kk * 16 * CM_LDC + col0 + np * 16, CM_LDC, lane);
      mma16816(ha[2 * np], af, b[0], b[1]);
      mma16816(ha[2 * np + 1], af, b[2], b[3]);
      load_b_kn(b, wb_c + kk * 16 * CM_LDC + col0 + np * 16, CM_LDC, lane);
      mma16816(hb[2 * np], af, b[0], b[1]);
      mma16816(hb[2 * np + 1], af, b[2], b[3]);
    }
  }
}

// Zero the pad columns D..Dp of `rows` bf16 rows.
__device__ __forceinline__ void cm_zero_pad(bf16* s, int rows, int ld, int D, int Dp) {
  for (int i = threadIdx.x; i < rows * (Dp - D); i += blockDim.x) s[(i / (Dp - D)) * ld + D + i % (Dp - D)] = __float2bfloat16(0.f);
}

__global__ void __launch_bounds__(CM_THREADS) cm_fwd(const bf16* __restrict__ x, const float* __restrict__ gamma, const float* __restrict__ beta,
                                                      const bf16* __restrict__ wa, const bf16* __restrict__ ba, const bf16* __restrict__ wb,
                                                      const bf16* __restrict__ bb, bf16* __restrict__ out, CMArgs a) {
  constexpr int RG = CM_FWD_RG, ROWS = CM_FWD_ROWS, WARPS = RG * CM_FWD_FQ, FW = CM_CC / CM_FWD_FQ, NT = FW / 8;
  extern __shared__ __align__(16) unsigned char cm_smem[];
  const int Dp = a.Dp, LDD = Dp + AM_PAD, nk = Dp / 16, D = a.D, N = a.N;
  bf16* y_s = reinterpret_cast<bf16*>(cm_smem);  // [ROWS][LDD] LN output
  bf16* wa_s = y_s + ROWS * LDD;                 // [2][Dp][CM_LDC]
  bf16* wb_s = wa_s + 2 * Dp * CM_LDC;           // [2][Dp][CM_LDC]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, tig = lane & 3;
  const int rg = warp % RG, fq = warp / RG;
  const int row0 = blockIdx.x * ROWS, row_lo = row0 + rg * 16 + g;

  cm_stage_w(wa_s, wb_s, wa, wb, 0, a);
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
      cm_stage_w(wa_s + ((c + 1) & 1) * Dp * CM_LDC, wb_s + ((c + 1) & 1) * Dp * CM_LDC, wa, wb, c + 1, a);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int col0 = c * CM_CC + fq * FW;
    if (col0 < D) {
      float ha[NT][4], hb[NT][4];
      cm_times_w<NT>(ha, hb, y_s + rg * 16 * LDD, LDD, wa_s + (c & 1) * Dp * CM_LDC, wb_s + (c & 1) * Dp * CM_LDC, fq * FW, nk, lane);
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

size_t cm_fwd_smem(int Dp, int rows) { return (size_t)(rows * (Dp + AM_PAD) + 4 * Dp * CM_LDC) * sizeof(bf16); }
size_t cm_bwd_smem(int Dp) { return cm_fwd_smem(Dp, CM_BWD_ROWS) + 2 * CM_BWD_ROWS * sizeof(float); }

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
    partial = part + (size_t)16 * ((N + CM_BWD_ROWS - 1) / CM_BWD_ROWS) * D;
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

}  // namespace

int launch_conv_front_mma(const void* x, const void* gamma, const void* beta, const void* wa, const void* ba, const void* wb, const void* bb, void* out,
                          int N, int D, float eps, cudaStream_t stream) {
  const CMArgs a = cm_args(N, D, eps, wa, wb);
  if (a.Dp > 256) return (int)cudaErrorInvalidValue;
  const size_t smem = cm_fwd_smem(a.Dp, CM_FWD_ROWS);
  cudaError_t err = allow_smem(cm_fwd, smem);
  if (err != cudaSuccess) return (int)err;
  cm_fwd<<<(N + CM_FWD_ROWS - 1) / CM_FWD_ROWS, CM_THREADS, smem, stream>>>((const bf16*)x, (const float*)gamma, (const float*)beta, (const bf16*)wa,
                                                                           (const bf16*)ba, (const bf16*)wb, (const bf16*)bb, (bf16*)out, a);
  return (int)cudaGetLastError();
}

long long conv_front_mma_bwd_scratch(int N, int D) { return (long long)CMScratch(N, D).total; }

// cols [4D] f32: dba, dbb, dgamma, dbeta in that order; dwa, dwb [D, D] f32.
int launch_conv_front_mma_bwd(const void* x, const void* gamma, const void* beta, const void* wa, const void* ba, const void* wb, const void* bb,
                              const void* dout, void* dx, float* cols, float* dwa, float* dwb, float* scratch, int N, int D, float eps,
                              cudaStream_t stream) {
  const CMArgs a = cm_args(N, D, eps, wa, wb);
  const CMScratch L(N, D);
  int e = cm_dispatch<BwdRun>(a.Dp, x, gamma, beta, wa, ba, wb, bb, dout, dx, scratch, a, stream);
  if (e) return e;
  if ((e = launch_sum_partials(scratch + L.part, cols, 4 * ((N + CM_BWD_ROWS - 1) / CM_BWD_ROWS), (size_t)4 * D, stream))) return e;
  const Split y = CMScratch::split(scratch, L.y, N, L.Dq);
  if ((e = launch_split_atb(y, CMScratch::split(scratch, L.dha, N, L.Dq), dwa, scratch + L.partial, N, D, D, stream))) return e;
  return launch_split_atb(y, CMScratch::split(scratch, L.dhb, N, L.Dq), dwb, scratch + L.partial, N, D, D, stream);
}

}  // namespace tfasr

// Dynamic shared memory (bytes) of the bf16 forward (which 0) or backward
// rows kernel (1) at width D; tests/test_torch_joint_conv_mma.py plans the same.
extern "C" long long tfasr_conv_mma_smem(int D, int which) {
  const int Dp = (D + 15) / 16 * 16;
  return (long long)(which == 0 ? tfasr::cm_fwd_smem(Dp, tfasr::CM_FWD_ROWS) : tfasr::cm_bwd_smem(Dp));
}

// Blocks per SM of that kernel on the current card; a negative value is the CUDA error.
extern "C" int tfasr_conv_mma_occupancy(int D, int which) {
  using namespace tfasr;
  const int Dp = (D + 15) / 16 * 16;
  return which == 0 ? cm_occupancy(cm_fwd, cm_fwd_smem(Dp, CM_FWD_ROWS)) : cm_dispatch<BwdOccupancy>(Dp, Dp);
}

// Floats of scratch the bf16 backward needs.
extern "C" long long tfasr_conv_front_mma_scratch(int N, int D) { return tfasr::conv_front_mma_bwd_scratch(N, D); }
