// Fused Conformer convolution module, the two halves around the depthwise
// conv (which stays a library op, as the reference leaves it to XLA):
//   conv_front: GLU([LN(x).Wa + ba, LN(x).Wb + bb]) = a * sigmoid(b)
//   conv_back:  x + factor * drop(swish((y1 - mean) * rsqrt(var + eps) * scale + bias) . W2 + b2)
//
// Counterpart of tensorflowasr_tpu/ops/pallas/conv_kernel.py conv_front and
// conv_back. Forward: one block owns CV_RT rows: the normalised (front) or
// activated (back) row tile sits in shared memory, and the D x D pointwise
// weights are staged CV_CC output columns at a time, so each weight element
// is read once per row tile. Elementwise math and accumulation are f32.
// conv_back's dropout uses the counter hash of common.cuh indexed by
// (global row b*T + t, column), which is the JAX kernel's index whenever it
// packs the whole batch into one grid step.
//
// Backward (replaces _front_bwd_kernel / _front_vjp_bwd, conv_kernel.py:92,
// 187-219, and _back_bwd_kernel / _back_vjp_bwd, :273-305, 359-400): one
// block per CV_RT rows recomputes the forward from the saved inputs, forms
// the row gradients (dx through the LayerNorm; dy1 through BatchNorm-apply
// and swish) with the weights staged as in the forward, and writes the row
// activations the parameter gradients need to f32 scratch. The
// deterministic row reduction of row_reduce.cu then sums dWa, dWb, dW2 and
// the vector gradients (the TPU accumulates them in revisited output blocks
// of a sequential grid). conv_back also emits dmean and dvar, which
// autograd carries into the batch-statistics path, and its skip gradient is
// the identity. What bounds them: the f32 products on the CUDA cores at 6400
// rows (conv_front ~1.6 GFLOP, rows kernel and reductions; conv_back ~0.5),
// and ~15-18 MB of f32 scratch written and read once.
//
// conv_front in bf16 runs on the tensor cores (conv_mma.cu), to which its C
// entry points dispatch; the kernels here run its f32 parity path and
// conv_back in both types.
#include "common.cuh"

namespace tfasr {

constexpr int CV_RT = 16;  // rows per block
constexpr int CV_CC = 64;  // output columns per staged weight chunk
constexpr int CV_PT = 16;  // row-gradient accumulators per thread: CV_RT * D <= 256 * CV_PT

template <typename T>
__global__ void conv_front_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                                  const float* __restrict__ beta, const T* __restrict__ wa, const T* __restrict__ ba,
                                  const T* __restrict__ wb, const T* __restrict__ bb, T* __restrict__ out, int N,
                                  int D, float eps) {
  extern __shared__ float smem[];
  float* y_s = smem;               // [CV_RT][D]
  float* wa_s = y_s + CV_RT * D;   // [D][CV_CC]
  float* wb_s = wa_s + D * CV_CC;  // [D][CV_CC]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const int row0 = blockIdx.x * CV_RT;

  for (int r = warp; r < CV_RT; r += nwarps) {
    float* dst = y_s + r * D;
    if (row0 + r < N)
      ln_row_warp<T>(x + (size_t)(row0 + r) * D, gamma, beta, D, eps, dst, lane);
    else
      for (int c = lane; c < D; c += 32) dst[c] = 0.f;
  }

  for (int c0 = 0; c0 < D; c0 += CV_CC) {
    const int cc = min(CV_CC, D - c0);
    __syncthreads();
    for (int i = tid; i < D * CV_CC; i += blockDim.x) {
      const int kk = i / CV_CC, c = i % CV_CC;
      const bool ok = c < cc;
      wa_s[i] = ok ? to_f32(wa[(size_t)kk * D + c0 + c]) : 0.f;
      wb_s[i] = ok ? to_f32(wb[(size_t)kk * D + c0 + c]) : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < CV_RT * CV_CC; i += blockDim.x) {
      const int r = i / CV_CC, c = i % CV_CC;
      const int row = row0 + r;
      if (c >= cc || row >= N) continue;
      const float* yr = y_s + r * D;
      float ha = 0.f, hb = 0.f;
      for (int kk = 0; kk < D; ++kk) {
        const float y = yr[kk];
        ha = fmaf(y, wa_s[kk * CV_CC + c], ha);
        hb = fmaf(y, wb_s[kk * CV_CC + c], hb);
      }
      ha += to_f32(ba[c0 + c]);
      hb += to_f32(bb[c0 + c]);
      out[(size_t)row * D + c0 + c] = from_f32<T>(ha * sigmoid_f32(hb));
    }
  }
}

template <typename T>
__global__ void conv_back_kernel(const T* __restrict__ x, const T* __restrict__ y1, const float* __restrict__ mean,
                                 const float* __restrict__ var, const float* __restrict__ scale,
                                 const float* __restrict__ bias, const T* __restrict__ w2, const T* __restrict__ b2,
                                 T* __restrict__ out, int N, int D, float eps, float factor, Dropout dp) {
  extern __shared__ float smem[];
  float* a_s = smem;              // [CV_RT][D]
  float* w_s = a_s + CV_RT * D;   // [D][CV_CC]
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * CV_RT;

  for (int i = tid; i < CV_RT * D; i += blockDim.x) {
    const int r = i / D, c = i % D;
    const int row = row0 + r;
    float a = 0.f;
    if (row < N) {
      const float rstd = rsqrtf(var[c] + eps);
      const float bn = (to_f32(y1[(size_t)row * D + c]) - mean[c]) * rstd * scale[c] + bias[c];
      a = round_to<T>(bn * sigmoid_f32(bn));
    }
    a_s[i] = a;
  }

  for (int c0 = 0; c0 < D; c0 += CV_CC) {
    const int cc = min(CV_CC, D - c0);
    __syncthreads();
    for (int i = tid; i < D * CV_CC; i += blockDim.x) {
      const int kk = i / CV_CC, c = i % CV_CC;
      w_s[i] = c < cc ? to_f32(w2[(size_t)kk * D + c0 + c]) : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < CV_RT * CV_CC; i += blockDim.x) {
      const int r = i / CV_CC, c = i % CV_CC;
      const int row = row0 + r;
      if (c >= cc || row >= N) continue;
      const float* ar = a_s + r * D;
      float z = 0.f;
      for (int kk = 0; kk < D; ++kk) z = fmaf(ar[kk], w_s[kk * CV_CC + c], z);
      z += to_f32(b2[c0 + c]);
      if (dp.on) z *= dropout_keep(dp, dp.seed, row, c0 + c);
      const size_t off = (size_t)row * D + c0 + c;
      out[off] = from_f32<T>(to_f32(x[off]) + factor * z);
    }
  }
}

// LayerNorm backward of CV_RT rows: dy [CV_RT][D] in shared memory, xhat and
// rstd from the forward recompute → dx; also writes dy * xhat and dy.
template <typename T>
__device__ void ln_bwd_rows(const float* dy_s, const float* xhat_s, const float* rstd_s, const float* gamma, int row0,
                            int N, int D, T* dx, float* dyx_o, float* dy_o) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int r = warp; r < CV_RT; r += nwarps) {
    const int row = row0 + r;
    if (row >= N) continue;
    const float* dy = dy_s + r * D;
    const float* xh = xhat_s + r * D;
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float dxn = dy[c] * gamma[c];
      s1 += dxn;
      s2 = fmaf(dxn, xh[c], s2);
    }
    const float m1 = warp_sum(s1) / (float)D, m2 = warp_sum(s2) / (float)D;
    for (int c = lane; c < D; c += 32) {
      const size_t off = (size_t)row * D + c;
      dx[off] = from_f32<T>(rstd_s[r] * (dy[c] * gamma[c] - m1 - xh[c] * m2));
      dyx_o[off] = dy[c] * xh[c];
      dy_o[off] = dy[c];
    }
  }
}

// conv_front backward rows. Scratch (f32): y [N, D] (LN output), dha, dhb
// [N, D] (gradients of the two GLU halves), dyx, dy [N, D].
template <typename T>
__global__ void conv_front_bwd_rows_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                                           const float* __restrict__ beta, const T* __restrict__ wa,
                                           const T* __restrict__ ba, const T* __restrict__ wb,
                                           const T* __restrict__ bb, const T* __restrict__ dout, T* __restrict__ dx,
                                           float* __restrict__ y_o, float* __restrict__ dha_o,
                                           float* __restrict__ dhb_o, float* __restrict__ dyx_o,
                                           float* __restrict__ dy_o, int N, int D, float eps) {
  extern __shared__ float smem[];
  const int ldw = CV_CC + 1;
  float* xhat_s = smem;                  // [CV_RT][D]
  float* yc_s = xhat_s + CV_RT * D;      // [CV_RT][D] LN output rounded to T, later dy
  float* wa_s = yc_s + CV_RT * D;        // [D][ldw] Wa[:, chunk]
  float* wb_s = wa_s + D * ldw;          // [D][ldw] Wb[:, chunk]
  float* dha_s = wb_s + D * ldw;         // [CV_RT][CV_CC] rounded to T
  float* dhb_s = dha_s + CV_RT * CV_CC;  // [CV_RT][CV_CC] rounded to T
  float* rstd_s = dhb_s + CV_RT * CV_CC;  // [CV_RT]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const int row0 = blockIdx.x * CV_RT;

  for (int r = warp; r < CV_RT; r += nwarps) {
    const int row = row0 + r;
    float* xh = xhat_s + r * D;
    float* yc = yc_s + r * D;
    if (row >= N) {
      for (int c = lane; c < D; c += 32) xh[c] = yc[c] = 0.f;
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
      const float xhat = (to_f32(xr[c]) - mu) * rstd;
      const float y = xhat * gamma[c] + beta[c];
      xh[c] = xhat;
      yc[c] = round_to<T>(y);
      y_o[(size_t)row * D + c] = y;
    }
  }

  float dyacc[CV_PT];
#pragma unroll
  for (int j = 0; j < CV_PT; ++j) dyacc[j] = 0.f;
  const int nz = CV_RT * D;

  for (int c0 = 0; c0 < D; c0 += CV_CC) {
    const int cc = min(CV_CC, D - c0);
    __syncthreads();
    for (int i = tid; i < D * CV_CC; i += blockDim.x) {
      const int kk = i / CV_CC, c = i % CV_CC;
      const bool ok = c < cc;
      wa_s[kk * ldw + c] = ok ? to_f32(wa[(size_t)kk * D + c0 + c]) : 0.f;
      wb_s[kk * ldw + c] = ok ? to_f32(wb[(size_t)kk * D + c0 + c]) : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < CV_RT * CV_CC; i += blockDim.x) {
      const int r = i / CV_CC, c = i % CV_CC;
      const int row = row0 + r;
      float dha_c = 0.f, dhb_c = 0.f;
      if (c < cc && row < N) {
        const float* yr = yc_s + r * D;
        float ha = 0.f, hb = 0.f;
        for (int kk = 0; kk < D; ++kk) {
          ha = fmaf(yr[kk], wa_s[kk * ldw + c], ha);
          hb = fmaf(yr[kk], wb_s[kk * ldw + c], hb);
        }
        ha += to_f32(ba[c0 + c]);
        hb += to_f32(bb[c0 + c]);
        const float sigb = sigmoid_f32(hb);
        const size_t off = (size_t)row * D + c0 + c;
        const float dg = to_f32(dout[off]);
        const float dha = dg * sigb;
        const float dhb = dg * ha * sigb * (1.f - sigb);
        dha_o[off] = dha;
        dhb_o[off] = dhb;
        dha_c = round_to<T>(dha);
        dhb_c = round_to<T>(dhb);
      }
      dha_s[i] = dha_c;
      dhb_s[i] = dhb_c;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < CV_PT; ++j) {
      const int o = tid + j * blockDim.x;
      if (o < nz) {
        const int r = o / D, kk = o % D;
        const float* ar = dha_s + r * CV_CC;
        const float* br = dhb_s + r * CV_CC;
        const float* war = wa_s + kk * ldw;
        const float* wbr = wb_s + kk * ldw;
        float acc = dyacc[j];
        for (int c = 0; c < CV_CC; ++c) acc = fmaf(ar[c], war[c], fmaf(br[c], wbr[c], acc));
        dyacc[j] = acc;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < CV_PT; ++j) {
    const int o = tid + j * blockDim.x;
    if (o < nz) yc_s[o] = dyacc[j];
  }
  __syncthreads();
  ln_bwd_rows<T>(yc_s, xhat_s, rstd_s, gamma, row0, N, D, dx, dyx_o, dy_o);
}

// conv_back backward rows. Scratch (f32): a [N, D] (swish output), dz
// [N, D], dbn [N, D], dbnx = dbn * xhat [N, D].
template <typename T>
__global__ void conv_back_bwd_rows_kernel(const T* __restrict__ y1, const float* __restrict__ mean,
                                          const float* __restrict__ var, const float* __restrict__ scale,
                                          const float* __restrict__ bias, const T* __restrict__ w2,
                                          const T* __restrict__ dout, T* __restrict__ dy1, float* __restrict__ a_o,
                                          float* __restrict__ dz_o, float* __restrict__ dbn_o,
                                          float* __restrict__ dbnx_o, int N, int D, float eps, float factor,
                                          Dropout dp) {
  extern __shared__ float smem[];
  const int ldw = D + 1;
  float* dzc_s = smem;               // [CV_RT][D] dz rounded to T (W2^T operand)
  float* w_s = dzc_s + CV_RT * D;    // [CV_CC][ldw] W2[chunk, :]
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * CV_RT;

  for (int i = tid; i < CV_RT * D; i += blockDim.x) {
    const int r = i / D, c = i % D;
    const int row = row0 + r;
    float dzc = 0.f;
    if (row < N) {
      const size_t off = (size_t)row * D + c;
      const float rstd = rsqrtf(var[c] + eps);
      const float bn = (to_f32(y1[off]) - mean[c]) * rstd * scale[c] + bias[c];
      a_o[off] = bn * sigmoid_f32(bn);
      float dz = factor * to_f32(dout[off]);
      if (dp.on) dz *= dropout_keep(dp, dp.seed, row, c);
      dz_o[off] = dz;
      dzc = round_to<T>(dz);
    }
    dzc_s[i] = dzc;
  }

  for (int k0 = 0; k0 < D; k0 += CV_CC) {
    const int kc = min(CV_CC, D - k0);
    __syncthreads();
    for (int i = tid; i < CV_CC * D; i += blockDim.x) {
      const int k = i / D, c = i % D;
      w_s[k * ldw + c] = k < kc ? to_f32(w2[(size_t)(k0 + k) * D + c]) : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < CV_RT * CV_CC; i += blockDim.x) {
      const int r = i / CV_CC, k = i % CV_CC;
      const int row = row0 + r;
      if (k >= kc || row >= N) continue;
      const float* dzr = dzc_s + r * D;
      const float* wr = w_s + k * ldw;
      float da = 0.f;
      for (int c = 0; c < D; ++c) da = fmaf(dzr[c], wr[c], da);
      const int kk = k0 + k;
      const size_t off = (size_t)row * D + kk;
      const float rstd = rsqrtf(var[kk] + eps);
      const float xhat = (to_f32(y1[off]) - mean[kk]) * rstd;
      const float bn = xhat * scale[kk] + bias[kk];
      const float sig = sigmoid_f32(bn);
      const float dbn = da * (sig + bn * sig * (1.f - sig));
      dbn_o[off] = dbn;
      dbnx_o[off] = dbn * xhat;
      dy1[off] = from_f32<T>(dbn * scale[kk] * rstd);
    }
  }
}

// dmean = sum(-dxhat * rstd), dvar = sum(dxhat * xhat) * -0.5 * rstd^2 with
// dxhat = dbn * scale: from the column sums of dbn and dbn * xhat.
__global__ void bn_stat_grads_kernel(const float* __restrict__ dbn_sum, const float* __restrict__ dbnx_sum,
                                     const float* __restrict__ var, const float* __restrict__ scale,
                                     float* __restrict__ dmean, float* __restrict__ dvar, int D, float eps) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= D) return;
  const float rstd = rsqrtf(var[c] + eps);
  dmean[c] = -(dbn_sum[c] * scale[c]) * rstd;
  dvar[c] = dbnx_sum[c] * scale[c] * -0.5f * rstd * rstd;
}

template <typename T>
int launch_front(const void* x, const void* gamma, const void* beta, const void* wa, const void* ba, const void* wb,
                 const void* bb, void* out, int N, int D, float eps, cudaStream_t stream) {
  const size_t smem = (size_t)(CV_RT * D + 2 * D * CV_CC) * sizeof(float);
  cudaError_t err = allow_smem(conv_front_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  conv_front_kernel<T><<<(N + CV_RT - 1) / CV_RT, 256, smem, stream>>>(
      (const T*)x, (const float*)gamma, (const float*)beta, (const T*)wa, (const T*)ba, (const T*)wb, (const T*)bb,
      (T*)out, N, D, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_back(const void* x, const void* y1, const void* mean, const void* var, const void* scale, const void* bias,
                const void* w2, const void* b2, void* out, int N, int D, float eps, float factor, Dropout dp,
                cudaStream_t stream) {
  const size_t smem = (size_t)(CV_RT * D + D * CV_CC) * sizeof(float);
  cudaError_t err = allow_smem(conv_back_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  conv_back_kernel<T><<<(N + CV_RT - 1) / CV_RT, 256, smem, stream>>>(
      (const T*)x, (const T*)y1, (const float*)mean, (const float*)var, (const float*)scale, (const float*)bias,
      (const T*)w2, (const T*)b2, (T*)out, N, D, eps, factor, dp);
  return (int)cudaGetLastError();
}

// Scratch of both backwards, in floats: four [N, D] row buffers, then the
// reduction partials.
inline size_t conv_bwd_partial(int N, int D) {
  const size_t a = (size_t)atb_splits(N, D, D) * D * D, b = (size_t)atb_splits(N, 1, D) * D;
  return a > b ? a : b;
}

template <typename T>
int launch_front_bwd(const void* x, const void* gamma, const void* beta, const void* wa, const void* ba,
                     const void* wb, const void* bb, const void* dout, void* dx, void* dgamma, void* dbeta, void* dwa,
                     void* dba, void* dwb, void* dbb, float* scratch, int N, int D, float eps, cudaStream_t stream) {
  const size_t nd = (size_t)N * D;
  float *y = scratch, *dha = y + nd, *dhb = dha + nd, *dyx = dhb + nd, *dy = dyx + nd, *partial = dy + nd;
  const size_t smem = (size_t)(2 * CV_RT * D + 2 * D * (CV_CC + 1) + 2 * CV_RT * CV_CC + CV_RT) * sizeof(float);
  cudaError_t err = allow_smem(conv_front_bwd_rows_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  conv_front_bwd_rows_kernel<T><<<(N + CV_RT - 1) / CV_RT, 256, smem, stream>>>(
      (const T*)x, (const float*)gamma, (const float*)beta, (const T*)wa, (const T*)ba, (const T*)wb, (const T*)bb,
      (const T*)dout, (T*)dx, y, dha, dhb, dyx, dy, N, D, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int e;
  if ((e = launch_atb(y, dha, (float*)dwa, partial, N, D, D, 0, stream))) return e;
  if ((e = launch_atb(y, dhb, (float*)dwb, partial, N, D, D, 0, stream))) return e;
  if ((e = launch_atb(nullptr, dha, (float*)dba, partial, N, 1, D, 0, stream))) return e;
  if ((e = launch_atb(nullptr, dhb, (float*)dbb, partial, N, 1, D, 0, stream))) return e;
  if ((e = launch_atb(nullptr, dyx, (float*)dgamma, partial, N, 1, D, 0, stream))) return e;
  return launch_atb(nullptr, dy, (float*)dbeta, partial, N, 1, D, 0, stream);
}

template <typename T>
int launch_back_bwd(const void* y1, const void* mean, const void* var, const void* scale, const void* bias,
                    const void* w2, const void* dout, void* dy1, void* dmean, void* dvar, void* dscale, void* dbias,
                    void* dw2, void* db2, float* scratch, int N, int D, float eps, float factor, Dropout dp,
                    cudaStream_t stream) {
  const size_t nd = (size_t)N * D;
  float *a = scratch, *dz = a + nd, *dbn = dz + nd, *dbnx = dbn + nd, *partial = dbnx + nd;
  const size_t smem = (size_t)(CV_RT * D + CV_CC * (D + 1)) * sizeof(float);
  cudaError_t err = allow_smem(conv_back_bwd_rows_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  conv_back_bwd_rows_kernel<T><<<(N + CV_RT - 1) / CV_RT, 256, smem, stream>>>(
      (const T*)y1, (const float*)mean, (const float*)var, (const float*)scale, (const float*)bias, (const T*)w2,
      (const T*)dout, (T*)dy1, a, dz, dbn, dbnx, N, D, eps, factor, dp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int e;
  if ((e = launch_atb(a, dz, (float*)dw2, partial, N, D, D, 0, stream))) return e;
  if ((e = launch_atb(nullptr, dz, (float*)db2, partial, N, 1, D, 0, stream))) return e;
  if ((e = launch_atb(nullptr, dbnx, (float*)dscale, partial, N, 1, D, 0, stream))) return e;
  if ((e = launch_atb(nullptr, dbn, (float*)dbias, partial, N, 1, D, 0, stream))) return e;
  bn_stat_grads_kernel<<<(D + 127) / 128, 128, 0, stream>>>((const float*)dbias, (const float*)dscale,
                                                            (const float*)var, (const float*)scale, (float*)dmean,
                                                            (float*)dvar, D, eps);
  return (int)cudaGetLastError();
}

// The bf16 conv_front kernels (conv_mma.cu).
int launch_conv_front_mma(const void* x, const void* gamma, const void* beta, const void* wa, const void* ba, const void* wb, const void* bb, void* out,
                          int N, int D, float eps, cudaStream_t stream);
int launch_conv_front_mma_bwd(const void* x, const void* gamma, const void* beta, const void* wa, const void* ba, const void* wb, const void* bb,
                              const void* dout, void* dx, float* cols, float* dwa, float* dwb, float* scratch, int N, int D, float eps,
                              cudaStream_t stream);

}  // namespace tfasr

// x [N, D]; gamma/beta [D] f32; wa/wb [D, D] ([in, out]) and ba/bb [D] in
// x's dtype; out [N, D].
extern "C" int tfasr_conv_front(const void* x, const void* gamma, const void* beta, const void* wa, const void* ba,
                                const void* wb, const void* bb, void* out, int N, int D, float eps, int dtype,
                                void* stream) {
  using namespace tfasr;
  if (dtype == kBF16) return launch_conv_front_mma(x, gamma, beta, wa, ba, wb, bb, out, N, D, eps, (cudaStream_t)stream);
  return launch_front<float>(x, gamma, beta, wa, ba, wb, bb, out, N, D, eps, (cudaStream_t)stream);
}

// x/y1 [N, D]; mean/var/scale/bias [D] f32; w2 [D, D] ([in, out]) and
// b2 [D] in x's dtype; out [N, D]. Dropout with seed, threshold, keep scale.
extern "C" int tfasr_conv_back(const void* x, const void* y1, const void* mean, const void* var, const void* scale,
                               const void* bias, const void* w2, const void* b2, void* out, int N, int D, float eps,
                               float factor, unsigned int seed, unsigned int thresh, float keep_scale, int drop_on,
                               int dtype, void* stream) {
  using namespace tfasr;
  const Dropout dp{seed, thresh, keep_scale, drop_on};
  if (dtype == kBF16)
    return launch_back<__nv_bfloat16>(x, y1, mean, var, scale, bias, w2, b2, out, N, D, eps, factor, dp,
                                      (cudaStream_t)stream);
  return launch_back<float>(x, y1, mean, var, scale, bias, w2, b2, out, N, D, eps, factor, dp, (cudaStream_t)stream);
}

// Floats of scratch tfasr_conv_front_bwd and tfasr_conv_back_bwd need.
extern "C" long long tfasr_conv_bwd_scratch(int N, int D) {
  return (long long)(5 * (size_t)N * D + tfasr::conv_bwd_partial(N, D));
}

// Gradients of tfasr_conv_front: dout [N, D] → dx [N, D] in x's dtype;
// dgamma, dbeta, dba, dbb [D] and dwa, dwb [D, D] in f32. bf16 needs dba,
// dbb, dgamma, dbeta to be consecutive views of one [4D] row and the scratch
// of tfasr_conv_front_mma_scratch.
extern "C" int tfasr_conv_front_bwd(const void* x, const void* gamma, const void* beta, const void* wa, const void* ba,
                                    const void* wb, const void* bb, const void* dout, void* dx, void* dgamma,
                                    void* dbeta, void* dwa, void* dba, void* dwb, void* dbb, void* scratch, int N,
                                    int D, float eps, int dtype, void* stream) {
  using namespace tfasr;
  if (dtype == kBF16) {
    float* cols = (float*)dba;
    if ((float*)dbb != cols + D || (float*)dgamma != cols + 2 * D || (float*)dbeta != cols + 3 * D) return (int)cudaErrorInvalidValue;
    return launch_conv_front_mma_bwd(x, gamma, beta, wa, ba, wb, bb, dout, dx, cols, (float*)dwa, (float*)dwb, (float*)scratch, N, D, eps,
                                     (cudaStream_t)stream);
  }
  return launch_front_bwd<float>(x, gamma, beta, wa, ba, wb, bb, dout, dx, dgamma, dbeta, dwa, dba, dwb, dbb,
                                 (float*)scratch, N, D, eps, (cudaStream_t)stream);
}

// Gradients of tfasr_conv_back except the skip path (the identity): dout
// [N, D] → dy1 [N, D] in y1's dtype; dmean, dvar, dscale, dbias, db2 [D] and
// dw2 [D, D] in f32.
extern "C" int tfasr_conv_back_bwd(const void* y1, const void* mean, const void* var, const void* scale,
                                   const void* bias, const void* w2, const void* dout, void* dy1, void* dmean,
                                   void* dvar, void* dscale, void* dbias, void* dw2, void* db2, void* scratch, int N,
                                   int D, float eps, float factor, unsigned int seed, unsigned int thresh,
                                   float keep_scale, int drop_on, int dtype, void* stream) {
  using namespace tfasr;
  const Dropout dp{seed, thresh, keep_scale, drop_on};
  if (dtype == kBF16)
    return launch_back_bwd<__nv_bfloat16>(y1, mean, var, scale, bias, w2, dout, dy1, dmean, dvar, dscale, dbias, dw2,
                                          db2, (float*)scratch, N, D, eps, factor, dp, (cudaStream_t)stream);
  return launch_back_bwd<float>(y1, mean, var, scale, bias, w2, dout, dy1, dmean, dvar, dscale, dbias, dw2, db2,
                                (float*)scratch, N, D, eps, factor, dp, (cudaStream_t)stream);
}
