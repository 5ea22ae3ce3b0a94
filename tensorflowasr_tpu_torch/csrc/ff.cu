// Fused Conformer feed-forward module, forward and backward:
//   out = x + factor * drop2(W2 . drop1(swish(W1 . LN(x) + b1)) + b2)
//
// Counterpart of tensorflowasr_tpu/ops/pallas/ff_kernel.py fused_ff. The
// two dropout sites use the counter hash of common.cuh indexed by (global
// row, column): site 1 with the seed, site 2 with seed + 7919, as the JAX
// kernel does when it runs one grid step.
//
// Forward: one block owns FF_RT rows. The LayerNorm output stays in shared
// memory; F is walked in FF_FC-wide chunks: each chunk's W1 and W2 slices
// are staged in shared memory, the [FF_RT, FF_FC] activation is formed
// there, and its W2 product accumulates into registers. So the [rows, F]
// intermediate never reaches device memory. LN statistics, the residual and
// every accumulation are f32; product operands are rounded to the weights'
// type where the reference casts them.
//
// This file holds the f32 kernels (CUDA cores) and the C entry points; bf16
// inputs go to the tensor-core kernels of ff_mma.cu.
//
// Backward (replaces _bwd_kernel / _vjp_bwd, ff_kernel.py:114-159, 216-253):
// ff_bwd_rows_kernel recomputes LN, h, swish and both masks from the saved
// inputs for its FF_RT rows (the Pallas VJP saves inputs only), forms
// da = dz . W2^T, dh = da * swish'(h) and dy = dh . W1^T chunk by chunk as the
// forward does, and finishes the LayerNorm backward into dx. The row
// activations the weight gradients need (y, dh, the dropped activation, dz,
// dy * xhat, dy) go to f32 scratch, and the deterministic row reduction of
// row_reduce.cu sums them into dW1, dW2, db1, db2, dgamma, dbeta: the TPU
// accumulates these in revisited output blocks of a sequential grid, which
// the card has no counterpart for. What bounds it: the three [rows, D] x
// [D, F] products of the rows kernel on the CUDA cores in f32 (~3.2 GFLOP at
// 6400 rows) and the two weight-gradient products of the reductions (~2.1
// GFLOP), with the ~44 MB of f32 scratch written and read once between them.
#include "common.cuh"

namespace tfasr {

constexpr int FF_RT = 16;  // rows per block
// F columns per chunk and z accumulators per thread (FF_RT * D <= blockDim *
// ZPT): 64 and 16 up to D 256; 16 and 32 above, to D 512 (Conformer-L),
// where 64-column chunks of W1 and W2 would not fit in shared memory.
constexpr unsigned int FF_SALT_SITE2 = 7919u;  // ff_kernel._SALT_SITE2

template <typename T, int FF_FC, int FF_ZPT>
__global__ void ff_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma, const float* __restrict__ beta,
                              const T* __restrict__ w1, const T* __restrict__ b1, const T* __restrict__ w2,
                              const T* __restrict__ b2, T* __restrict__ out, int N, int D, int F, float eps,
                              float factor, Dropout dp) {
  extern __shared__ float smem[];
  float* y_s = smem;                  // [FF_RT][D]
  float* w1_s = y_s + FF_RT * D;      // [D][FF_FC]
  float* a_s = w1_s + D * FF_FC;      // [FF_RT][FF_FC]
  float* w2_s = a_s + FF_RT * FF_FC;  // [FF_FC][D]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const int row0 = blockIdx.x * FF_RT;

  for (int r = warp; r < FF_RT; r += nwarps) {
    float* dst = y_s + r * D;
    if (row0 + r < N)
      ln_row_warp<T>(x + (size_t)(row0 + r) * D, gamma, beta, D, eps, dst, lane);
    else
      for (int c = lane; c < D; c += 32) dst[c] = 0.f;
  }

  float z[FF_ZPT];
#pragma unroll
  for (int j = 0; j < FF_ZPT; ++j) z[j] = 0.f;
  const int nz = FF_RT * D;

  for (int f0 = 0; f0 < F; f0 += FF_FC) {
    const int fc = min(FF_FC, F - f0);
    __syncthreads();
    for (int i = tid; i < D * FF_FC; i += blockDim.x) {
      const int kk = i / FF_FC, f = i % FF_FC;
      w1_s[i] = f < fc ? to_f32(w1[(size_t)kk * F + f0 + f]) : 0.f;
    }
    for (int i = tid; i < FF_FC * D; i += blockDim.x) {
      const int f = i / D, c = i % D;
      w2_s[i] = f < fc ? to_f32(w2[(size_t)(f0 + f) * D + c]) : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < FF_RT * FF_FC; i += blockDim.x) {
      const int r = i / FF_FC, f = i % FF_FC;
      const float* yr = y_s + r * D;
      float h = 0.f;
      for (int kk = 0; kk < D; ++kk) h = fmaf(yr[kk], w1_s[kk * FF_FC + f], h);
      float a = 0.f;
      if (f < fc) {
        h += to_f32(b1[f0 + f]);
        a = h * sigmoid_f32(h);
        if (dp.on) a *= dropout_keep(dp, dp.seed, row0 + r, f0 + f);
        a = round_to<T>(a);
      }
      a_s[i] = a;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < FF_ZPT; ++j) {
      const int o = tid + j * blockDim.x;
      if (o < nz) {
        const int r = o / D, c = o % D;
        const float* ar = a_s + r * FF_FC;
        float acc = z[j];
        for (int f = 0; f < FF_FC; ++f) acc = fmaf(ar[f], w2_s[f * D + c], acc);
        z[j] = acc;
      }
    }
  }

#pragma unroll
  for (int j = 0; j < FF_ZPT; ++j) {
    const int o = tid + j * blockDim.x;
    if (o < nz) {
      const int r = o / D, c = o % D;
      const int row = row0 + r;
      if (row < N) {
        const size_t off = (size_t)row * D + c;
        float zz = z[j] + to_f32(b2[c]);
        if (dp.on) zz *= dropout_keep(dp, dp.seed + FF_SALT_SITE2, row, c);
        out[off] = from_f32<T>(to_f32(x[off]) + factor * zz);
      }
    }
  }
}

// Backward over FF_RT rows; see the header. Scratch rows (f32): y [N, D],
// dh [N, F], ad [N, F] (dropped activation), dz [N, D], dyx [N, D], dy [N, D].
template <typename T, int FF_FC, int FF_ZPT>
__global__ void ff_bwd_rows_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                                   const float* __restrict__ beta, const T* __restrict__ w1, const T* __restrict__ b1,
                                   const T* __restrict__ w2, const T* __restrict__ dout, T* __restrict__ dx,
                                   float* __restrict__ y_o, float* __restrict__ dh_o, float* __restrict__ ad_o,
                                   float* __restrict__ dz_o, float* __restrict__ dyx_o, float* __restrict__ dy_o, int N,
                                   int D, int F, float eps, float factor, Dropout dp) {
  extern __shared__ float smem[];
  const int ldw1 = FF_FC + 1, ldw2 = D + 1;  // odd strides: both access directions conflict-free
  float* xhat_s = smem;                // [FF_RT][D]
  float* yc_s = xhat_s + FF_RT * D;    // [FF_RT][D] LN output rounded to T (W1 operand)
  float* dzc_s = yc_s + FF_RT * D;     // [FF_RT][D] dz rounded to T (W2^T operand), later dy
  float* w1_s = dzc_s + FF_RT * D;     // [D][ldw1] W1[:, chunk]
  float* w2_s = w1_s + D * ldw1;       // [FF_FC][ldw2] W2[chunk, :]
  float* dh_s = w2_s + FF_FC * ldw2;   // [FF_RT][FF_FC] dh rounded to T (W1^T operand)
  float* rstd_s = dh_s + FF_RT * FF_FC;  // [FF_RT]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const int row0 = blockIdx.x * FF_RT;

  for (int r = warp; r < FF_RT; r += nwarps) {
    const int row = row0 + r;
    float* xh = xhat_s + r * D;
    float* yc = yc_s + r * D;
    float* dzc = dzc_s + r * D;
    if (row >= N) {
      for (int c = lane; c < D; c += 32) xh[c] = yc[c] = dzc[c] = 0.f;
      if (lane == 0) rstd_s[r] = 0.f;
      continue;
    }
    const T* xr = x + (size_t)row * D;
    float s = 0.f;
    for (int c = lane; c < D; c += 32) s += to_f32(xr[c]);
    const float mu = warp_sum(s) / (float)D;
    float q = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float cx = to_f32(xr[c]) - mu;
      q = fmaf(cx, cx, q);
    }
    const float rstd = rsqrtf(warp_sum(q) / (float)D + eps);
    if (lane == 0) rstd_s[r] = rstd;
    for (int c = lane; c < D; c += 32) {
      const size_t off = (size_t)row * D + c;
      const float xhat = (to_f32(xr[c]) - mu) * rstd;
      const float y = xhat * gamma[c] + beta[c];
      xh[c] = xhat;
      yc[c] = round_to<T>(y);
      y_o[off] = y;
      float dz = factor * to_f32(dout[off]);
      if (dp.on) dz *= dropout_keep(dp, dp.seed + FF_SALT_SITE2, row, c);
      dz_o[off] = dz;
      dzc[c] = round_to<T>(dz);
    }
  }

  float dyacc[FF_ZPT];
#pragma unroll
  for (int j = 0; j < FF_ZPT; ++j) dyacc[j] = 0.f;
  const int nz = FF_RT * D;

  for (int f0 = 0; f0 < F; f0 += FF_FC) {
    const int fc = min(FF_FC, F - f0);
    __syncthreads();
    for (int i = tid; i < D * FF_FC; i += blockDim.x) {
      const int kk = i / FF_FC, f = i % FF_FC;
      w1_s[kk * ldw1 + f] = f < fc ? to_f32(w1[(size_t)kk * F + f0 + f]) : 0.f;
    }
    for (int i = tid; i < FF_FC * D; i += blockDim.x) {
      const int f = i / D, c = i % D;
      w2_s[f * ldw2 + c] = f < fc ? to_f32(w2[(size_t)(f0 + f) * D + c]) : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < FF_RT * FF_FC; i += blockDim.x) {
      const int r = i / FF_FC, f = i % FF_FC;
      const int row = row0 + r;
      float dhc = 0.f;
      if (f < fc && row < N) {
        const float* yr = yc_s + r * D;
        const float* dzr = dzc_s + r * D;
        float h = 0.f, da = 0.f;
        for (int kk = 0; kk < D; ++kk) {
          h = fmaf(yr[kk], w1_s[kk * ldw1 + f], h);
          da = fmaf(dzr[kk], w2_s[f * ldw2 + kk], da);
        }
        h += to_f32(b1[f0 + f]);
        const float sig = sigmoid_f32(h);
        float ad = h * sig;
        if (dp.on) {
          const float keep = dropout_keep(dp, dp.seed, row, f0 + f);
          ad *= keep;
          da *= keep;
        }
        const float dh = da * (sig + h * sig * (1.f - sig));
        const size_t off = (size_t)row * F + f0 + f;
        ad_o[off] = ad;
        dh_o[off] = dh;
        dhc = round_to<T>(dh);
      }
      dh_s[r * FF_FC + f] = dhc;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < FF_ZPT; ++j) {
      const int o = tid + j * blockDim.x;
      if (o < nz) {
        const int r = o / D, c = o % D;
        const float* dhr = dh_s + r * FF_FC;
        const float* wr = w1_s + c * ldw1;
        float acc = dyacc[j];
        for (int f = 0; f < FF_FC; ++f) acc = fmaf(dhr[f], wr[f], acc);
        dyacc[j] = acc;
      }
    }
  }

  // LayerNorm backward (y = xhat * gamma + beta); dy replaces dz in dzc_s
  __syncthreads();
#pragma unroll
  for (int j = 0; j < FF_ZPT; ++j) {
    const int o = tid + j * blockDim.x;
    if (o < nz) dzc_s[o] = dyacc[j];
  }
  __syncthreads();
  for (int r = warp; r < FF_RT; r += nwarps) {
    const int row = row0 + r;
    if (row >= N) continue;
    const float* dy = dzc_s + r * D;
    const float* xh = xhat_s + r * D;
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float dxn = dy[c] * gamma[c];
      s1 += dxn;
      s2 = fmaf(dxn, xh[c], s2);
    }
    const float m1 = warp_sum(s1) / (float)D, m2 = warp_sum(s2) / (float)D;
    const float rstd = rstd_s[r];
    for (int c = lane; c < D; c += 32) {
      const size_t off = (size_t)row * D + c;
      const float dxn = dy[c] * gamma[c];
      dx[off] = from_f32<T>(to_f32(dout[off]) + rstd * (dxn - m1 - xh[c] * m2));
      dyx_o[off] = dy[c] * xh[c];
      dy_o[off] = dy[c];
    }
  }
}

template <typename T, int FF_FC, int FF_ZPT>
int launch_ff(const void* x, const void* gamma, const void* beta, const void* w1, const void* b1, const void* w2,
              const void* b2, void* out, int N, int D, int F, float eps, float factor, Dropout dp, cudaStream_t stream) {
  if (FF_RT * D > 256 * FF_ZPT) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(FF_RT * D + D * FF_FC + FF_RT * FF_FC + FF_FC * D) * sizeof(float);
  cudaError_t err = allow_smem(ff_fwd_kernel<T, FF_FC, FF_ZPT>, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (N + FF_RT - 1) / FF_RT;
  ff_fwd_kernel<T, FF_FC, FF_ZPT><<<blocks, 256, smem, stream>>>((const T*)x, (const float*)gamma, (const float*)beta, (const T*)w1,
                                                  (const T*)b1, (const T*)w2, (const T*)b2, (T*)out, N, D, F, eps,
                                                  factor, dp);
  return (int)cudaGetLastError();
}

// The bf16 kernels (ff_mma.cu).
int launch_ff_mma(const void* x, const void* gamma, const void* beta, const void* w1, const void* b1, const void* w2, const void* b2, void* out,
                  int N, int D, int F, int rows, float eps, float factor, Dropout dp, cudaStream_t stream);
int launch_ff_mma_bwd(const void* x, const void* gamma, const void* beta, const void* w1, const void* b1, const void* w2, const void* dout,
                      void* dx, float* cols, float* dw1, float* dw2, float* scratch, int N, int D, int F, float eps, float factor, Dropout dp,
                      cudaStream_t stream);
long long ff_mma_bwd_scratch(int N, int D, int F);
bool ff_mma_bwd_wide(int D);

// Scratch layout of the f32 backward, in floats.
struct FFBwdScratch {
  size_t y, dh, ad, dz, dyx, dy, partial, total;
  FFBwdScratch(int N, int D, int F) {
    const size_t nd = (size_t)N * D, nf = (size_t)N * F;
    y = 0;
    dh = y + nd;
    ad = dh + nf;
    dz = ad + nf;
    dyx = dz + nd;
    dy = dyx + nd;
    partial = dy + nd;
    size_t p = (size_t)atb_splits(N, D, F) * D * F;
    const size_t p2 = (size_t)atb_splits(N, F, D) * F * D;
    const size_t p3 = (size_t)atb_splits(N, 1, F) * F;
    p = p > p2 ? p : p2;
    p = p > p3 ? p : p3;
    total = partial + p;
  }
};

template <typename T, int FF_FC, int FF_ZPT>
int launch_ff_bwd(const void* x, const void* gamma, const void* beta, const void* w1, const void* b1, const void* w2,
                  const void* dout, void* dx, void* dgamma, void* dbeta, void* dw1, void* db1, void* dw2, void* db2,
                  float* scratch, int N, int D, int F, float eps, float factor, Dropout dp, cudaStream_t stream) {
  const FFBwdScratch L(N, D, F);
  float *y = scratch + L.y, *dh = scratch + L.dh, *ad = scratch + L.ad, *dz = scratch + L.dz;
  float *dyx = scratch + L.dyx, *dy = scratch + L.dy, *partial = scratch + L.partial;
  if (FF_RT * D > 256 * FF_ZPT) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(3 * FF_RT * D + D * (FF_FC + 1) + FF_FC * (D + 1) + FF_RT * FF_FC + FF_RT) * sizeof(float);
  cudaError_t err = allow_smem(ff_bwd_rows_kernel<T, FF_FC, FF_ZPT>, smem);
  if (err != cudaSuccess) return (int)err;
  ff_bwd_rows_kernel<T, FF_FC, FF_ZPT><<<(N + FF_RT - 1) / FF_RT, 256, smem, stream>>>(
      (const T*)x, (const float*)gamma, (const float*)beta, (const T*)w1, (const T*)b1, (const T*)w2, (const T*)dout,
      (T*)dx, y, dh, ad, dz, dyx, dy, N, D, F, eps, factor, dp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int e;
  if ((e = launch_atb(y, dh, (float*)dw1, partial, N, D, F, 0, stream))) return e;
  if ((e = launch_atb(ad, dz, (float*)dw2, partial, N, F, D, 0, stream))) return e;
  if ((e = launch_atb(nullptr, dh, (float*)db1, partial, N, 1, F, 0, stream))) return e;
  if ((e = launch_atb(nullptr, dz, (float*)db2, partial, N, 1, D, 0, stream))) return e;
  if ((e = launch_atb(nullptr, dyx, (float*)dgamma, partial, N, 1, D, 0, stream))) return e;
  return launch_atb(nullptr, dy, (float*)dbeta, partial, N, 1, D, 0, stream);
}

}  // namespace tfasr

// x [N, D]; gamma/beta [D] f32; w1 [D, F], b1 [F], w2 [F, D], b2 [D] in
// x's dtype; out [N, D]. Requires D <= 512. rows: the bf16 forward's row
// tile, 64 or 32 (32 above D 256; f32 ignores it). Dropout (drop_on) with seed, uint32
// threshold and keep scale.
extern "C" int tfasr_fused_ff(const void* x, const void* gamma, const void* beta, const void* w1, const void* b1,
                              const void* w2, const void* b2, void* out, int N, int D, int F, int rows, float eps, float factor,
                              unsigned int seed, unsigned int thresh, float keep_scale, int drop_on, int dtype,
                              void* stream) {
  using namespace tfasr;
  const Dropout dp{seed, thresh, keep_scale, drop_on};
  if (dtype == kBF16) return launch_ff_mma(x, gamma, beta, w1, b1, w2, b2, out, N, D, F, rows, eps, factor, dp, (cudaStream_t)stream);
  if (D <= 256) return launch_ff<float, 64, 16>(x, gamma, beta, w1, b1, w2, b2, out, N, D, F, eps, factor, dp, (cudaStream_t)stream);
  return launch_ff<float, 16, 32>(x, gamma, beta, w1, b1, w2, b2, out, N, D, F, eps, factor, dp, (cudaStream_t)stream);
}

// Floats of scratch tfasr_fused_ff_bwd needs.
extern "C" long long tfasr_fused_ff_bwd_scratch(int N, int D, int F, int dtype) {
  return dtype == tfasr::kBF16 ? tfasr::ff_mma_bwd_scratch(N, D, F) : (long long)tfasr::FFBwdScratch(N, D, F).total;
}

// Whether tfasr_fused_ff_bwd at width D in this dtype takes the wide bf16
// rows pass on wgmma (ff_mma.cu), as its own dispatch decides.
extern "C" int tfasr_fused_ff_bwd_wide(int D, int dtype) { return dtype == tfasr::kBF16 && tfasr::ff_mma_bwd_wide(D); }

// Gradients of tfasr_fused_ff: dout [N, D] in x's dtype → dx [N, D] in x's
// dtype; dgamma, dbeta [D], dw1 [D, F], db1 [F], dw2 [F, D], db2 [D] in f32.
// bf16 needs db1, db2, dgamma, dbeta to be consecutive views of one [F + 3D]
// buffer (the column sums leave the tensor-core kernels as one row).
extern "C" int tfasr_fused_ff_bwd(const void* x, const void* gamma, const void* beta, const void* w1, const void* b1,
                                  const void* w2, const void* dout, void* dx, void* dgamma, void* dbeta, void* dw1,
                                  void* db1, void* dw2, void* db2, void* scratch, int N, int D, int F, float eps,
                                  float factor, unsigned int seed, unsigned int thresh, float keep_scale, int drop_on,
                                  int dtype, void* stream) {
  using namespace tfasr;
  const Dropout dp{seed, thresh, keep_scale, drop_on};
  if (dtype == kBF16) {
    float* cols = (float*)db1;
    if ((float*)db2 != cols + F || (float*)dgamma != cols + F + D || (float*)dbeta != cols + F + 2 * D) return (int)cudaErrorInvalidValue;
    return launch_ff_mma_bwd(x, gamma, beta, w1, b1, w2, dout, dx, cols, (float*)dw1, (float*)dw2, (float*)scratch, N, D, F, eps, factor, dp,
                             (cudaStream_t)stream);
  }
  if (D <= 256)
    return launch_ff_bwd<float, 64, 16>(x, gamma, beta, w1, b1, w2, dout, dx, dgamma, dbeta, dw1, db1, dw2, db2, (float*)scratch, N, D, F, eps,
                                        factor, dp, (cudaStream_t)stream);
  return launch_ff_bwd<float, 16, 32>(x, gamma, beta, w1, b1, w2, dout, dx, dgamma, dbeta, dw1, db1, dw2, db2, (float*)scratch, N, D, F, eps,
                                      factor, dp, (cudaStream_t)stream);
}
