// Fused Conformer convolution module, the two halves around the depthwise
// conv (which stays a library op, as the reference leaves it to XLA):
//   conv_front: GLU([LN(x).Wa + ba, LN(x).Wb + bb]) = a * sigmoid(b)
//   conv_back:  x + factor * (swish((y1 - mean) * rsqrt(var + eps) * scale + bias) . W2 + b2)
//
// Counterpart of tensorflowasr_tpu/ops/pallas/conv_kernel.py conv_front and
// conv_back (forward, rate 0). One block owns CV_RT rows: the normalised
// (front) or activated (back) row tile sits in shared memory, and the
// D x D pointwise weights are staged CV_CC output columns at a time, so
// each weight element is read once per row tile. Elementwise math and
// accumulation are f32.
#include "common.cuh"

namespace tfasr {

constexpr int CV_RT = 16;  // rows per block
constexpr int CV_CC = 64;  // output columns per staged weight chunk

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
                                 T* __restrict__ out, int N, int D, float eps, float factor) {
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
      const size_t off = (size_t)row * D + c0 + c;
      out[off] = from_f32<T>(to_f32(x[off]) + factor * (z + to_f32(b2[c0 + c])));
    }
  }
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
                const void* w2, const void* b2, void* out, int N, int D, float eps, float factor,
                cudaStream_t stream) {
  const size_t smem = (size_t)(CV_RT * D + D * CV_CC) * sizeof(float);
  cudaError_t err = allow_smem(conv_back_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  conv_back_kernel<T><<<(N + CV_RT - 1) / CV_RT, 256, smem, stream>>>(
      (const T*)x, (const T*)y1, (const float*)mean, (const float*)var, (const float*)scale, (const float*)bias,
      (const T*)w2, (const T*)b2, (T*)out, N, D, eps, factor);
  return (int)cudaGetLastError();
}

}  // namespace tfasr

// x [N, D]; gamma/beta [D] f32; wa/wb [D, D] ([in, out]) and ba/bb [D] in
// x's dtype; out [N, D].
extern "C" int tfasr_conv_front(const void* x, const void* gamma, const void* beta, const void* wa, const void* ba,
                                const void* wb, const void* bb, void* out, int N, int D, float eps, int dtype,
                                void* stream) {
  using namespace tfasr;
  if (dtype == kBF16)
    return launch_front<__nv_bfloat16>(x, gamma, beta, wa, ba, wb, bb, out, N, D, eps, (cudaStream_t)stream);
  return launch_front<float>(x, gamma, beta, wa, ba, wb, bb, out, N, D, eps, (cudaStream_t)stream);
}

// x/y1 [N, D]; mean/var/scale/bias [D] f32; w2 [D, D] ([in, out]) and
// b2 [D] in x's dtype; out [N, D].
extern "C" int tfasr_conv_back(const void* x, const void* y1, const void* mean, const void* var, const void* scale,
                               const void* bias, const void* w2, const void* b2, void* out, int N, int D, float eps,
                               float factor, int dtype, void* stream) {
  using namespace tfasr;
  if (dtype == kBF16)
    return launch_back<__nv_bfloat16>(x, y1, mean, var, scale, bias, w2, b2, out, N, D, eps, factor,
                                      (cudaStream_t)stream);
  return launch_back<float>(x, y1, mean, var, scale, bias, w2, b2, out, N, D, eps, factor, (cudaStream_t)stream);
}
