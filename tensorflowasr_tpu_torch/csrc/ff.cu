// Fused Conformer feed-forward module forward:
//   out = x + factor * (W2 . swish(W1 . LN(x) + b1) + b2)
//
// Counterpart of tensorflowasr_tpu/ops/pallas/ff_kernel.py fused_ff
// (forward, rate 0). One block owns FF_RT rows. The LayerNorm output stays
// in shared memory; F is walked in FF_FC-wide chunks: each chunk's W1 and
// W2 slices are staged in shared memory, the [FF_RT, FF_FC] activation is
// formed there, and its W2 product accumulates into registers. So the
// [rows, F] intermediate never reaches device memory. LN statistics, the
// residual and every accumulation are f32; product operands are rounded to
// the weights' type where the reference casts them.
//
// bf16 with 16 | D, 8 | F and 16-byte aligned weights (the serving path)
// runs ff_fwd_wmma_kernel: the same tiling, with both products on the
// tensor cores (WMMA 16x16x16 bf16 fragments, f32 accumulation), the
// operands kept as bf16 in shared memory and the weight chunks staged 16
// bytes at a time. Anything else runs the CUDA-core ff_fwd_kernel.
#include <mma.h>

#include "common.cuh"

namespace tfasr {

constexpr int FF_RT = 16;   // rows per block
constexpr int FF_FC = 64;   // F columns per chunk
constexpr int FF_ZPT = 16;  // z accumulators per thread: FF_RT * D <= blockDim * FF_ZPT

template <typename T>
__global__ void ff_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma, const float* __restrict__ beta,
                              const T* __restrict__ w1, const T* __restrict__ b1, const T* __restrict__ w2,
                              const T* __restrict__ b2, T* __restrict__ out, int N, int D, int F, float eps,
                              float factor) {
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
        a = round_to<T>(h * sigmoid_f32(h));
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
        out[off] = from_f32<T>(to_f32(x[off]) + factor * (z[j] + to_f32(b2[c])));
      }
    }
  }
}

constexpr int FFT_PAD = 8;  // bf16 row padding: keeps WMMA tile pointers 32-byte aligned, spreads banks
constexpr int FFT_ZTILES = 2;  // z accumulator tiles per warp: D / 16 <= 8 warps * 2

__global__ void ff_fwd_wmma_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ gamma,
                                   const float* __restrict__ beta, const __nv_bfloat16* __restrict__ w1,
                                   const __nv_bfloat16* __restrict__ b1, const __nv_bfloat16* __restrict__ w2,
                                   const __nv_bfloat16* __restrict__ b2, __nv_bfloat16* __restrict__ out, int N, int D,
                                   int F, float eps, float factor) {
  using namespace nvcuda;
  typedef __nv_bfloat16 bf16;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int ldy = D + FFT_PAD, ldw1 = FF_FC + FFT_PAD, lda = FF_FC + FFT_PAD, ldw2 = D + FFT_PAD;
  bf16* y_s = reinterpret_cast<bf16*>(smem_raw);         // [FF_RT][ldy] LN output
  bf16* w1_s = y_s + FF_RT * ldy;                         // [D][ldw1] W1 chunk
  bf16* a_s = w1_s + D * ldw1;                            // [FF_RT][lda] swish activation
  bf16* w2_s = a_s + FF_RT * lda;                         // [FF_FC][ldw2] W2 chunk
  float* h_s = reinterpret_cast<float*>(w2_s + FF_FC * ldw2);  // [FF_RT][FF_FC] W1 product
  float* z_s = h_s + FF_RT * FF_FC;                       // [FF_RT][D] W2 product
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const int row0 = blockIdx.x * FF_RT;
  const int ztiles = D / 16;

  for (int r = warp; r < FF_RT; r += nwarps) {
    bf16* dst = y_s + r * ldy;
    if (row0 + r < N)
      ln_row_warp<bf16>(x + (size_t)(row0 + r) * D, gamma, beta, D, eps, dst, lane);
    else
      for (int c = lane; c < D; c += 32) dst[c] = __float2bfloat16(0.f);
  }

  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bf;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> zacc[FFT_ZTILES];
#pragma unroll
  for (int j = 0; j < FFT_ZTILES; ++j) wmma::fill_fragment(zacc[j], 0.f);

  for (int f0 = 0; f0 < F; f0 += FF_FC) {
    const int fc = min(FF_FC, F - f0);
    __syncthreads();
    // stage the chunk 8 bf16 (16 bytes) at a time: 8 | F, 16 | D and
    // 16-byte aligned weights are checked by the launcher
    const uint4 zero8 = make_uint4(0, 0, 0, 0);
    for (int i = tid; i < D * (FF_FC / 8); i += blockDim.x) {
      const int kk = i / (FF_FC / 8), f = (i % (FF_FC / 8)) * 8;
      *reinterpret_cast<uint4*>(w1_s + kk * ldw1 + f) =
          f < fc ? *reinterpret_cast<const uint4*>(w1 + (size_t)kk * F + f0 + f) : zero8;
    }
    const int dv = D / 8;
    for (int i = tid; i < FF_FC * dv; i += blockDim.x) {
      const int f = i / dv, c = (i % dv) * 8;
      *reinterpret_cast<uint4*>(w2_s + f * ldw2 + c) =
          f < fc ? *reinterpret_cast<const uint4*>(w2 + (size_t)(f0 + f) * D + c) : zero8;
    }
    __syncthreads();
    if (warp < FF_FC / 16) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> hacc;
      wmma::fill_fragment(hacc, 0.f);
      for (int kk = 0; kk < D; kk += 16) {
        wmma::load_matrix_sync(af, y_s + kk, ldy);
        wmma::load_matrix_sync(bf, w1_s + kk * ldw1 + warp * 16, ldw1);
        wmma::mma_sync(hacc, af, bf, hacc);
      }
      wmma::store_matrix_sync(h_s + warp * 16, hacc, FF_FC, wmma::mem_row_major);
    }
    __syncthreads();
    for (int i = tid; i < FF_RT * FF_FC; i += blockDim.x) {
      const int r = i / FF_FC, f = i % FF_FC;
      float a = 0.f;
      if (f < fc) {
        const float h = h_s[i] + to_f32(b1[f0 + f]);
        a = h * sigmoid_f32(h);
      }
      a_s[r * lda + f] = __float2bfloat16(a);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < FFT_ZTILES; ++j) {
      const int n = warp + j * nwarps;
      if (n < ztiles) {
        for (int kk = 0; kk < FF_FC; kk += 16) {
          wmma::load_matrix_sync(af, a_s + kk, lda);
          wmma::load_matrix_sync(bf, w2_s + kk * ldw2 + n * 16, ldw2);
          wmma::mma_sync(zacc[j], af, bf, zacc[j]);
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < FFT_ZTILES; ++j) {
    const int n = warp + j * nwarps;
    if (n < ztiles) wmma::store_matrix_sync(z_s + n * 16, zacc[j], D, wmma::mem_row_major);
  }
  __syncthreads();
  for (int i = tid; i < FF_RT * D; i += blockDim.x) {
    const int r = i / D, c = i % D;
    const int row = row0 + r;
    if (row < N) {
      const size_t off = (size_t)row * D + c;
      out[off] = __float2bfloat16(to_f32(x[off]) + factor * (z_s[i] + to_f32(b2[c])));
    }
  }
}

int launch_ff_wmma(const void* x, const void* gamma, const void* beta, const void* w1, const void* b1, const void* w2,
                   const void* b2, void* out, int N, int D, int F, float eps, float factor, cudaStream_t stream) {
  const size_t smem = (size_t)(FF_RT * (D + FFT_PAD) + D * (FF_FC + FFT_PAD) + FF_RT * (FF_FC + FFT_PAD) +
                               FF_FC * (D + FFT_PAD)) * sizeof(__nv_bfloat16) +
                      (size_t)(FF_RT * FF_FC + FF_RT * D) * sizeof(float);
  cudaError_t err = allow_smem(ff_fwd_wmma_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (N + FF_RT - 1) / FF_RT;
  ff_fwd_wmma_kernel<<<blocks, 256, smem, stream>>>(
      (const __nv_bfloat16*)x, (const float*)gamma, (const float*)beta, (const __nv_bfloat16*)w1,
      (const __nv_bfloat16*)b1, (const __nv_bfloat16*)w2, (const __nv_bfloat16*)b2, (__nv_bfloat16*)out, N, D, F, eps,
      factor);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_ff(const void* x, const void* gamma, const void* beta, const void* w1, const void* b1, const void* w2,
              const void* b2, void* out, int N, int D, int F, float eps, float factor, cudaStream_t stream) {
  const size_t smem = (size_t)(FF_RT * D + D * FF_FC + FF_RT * FF_FC + FF_FC * D) * sizeof(float);
  cudaError_t err = allow_smem(ff_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (N + FF_RT - 1) / FF_RT;
  ff_fwd_kernel<T><<<blocks, 256, smem, stream>>>((const T*)x, (const float*)gamma, (const float*)beta, (const T*)w1,
                                                  (const T*)b1, (const T*)w2, (const T*)b2, (T*)out, N, D, F, eps,
                                                  factor);
  return (int)cudaGetLastError();
}

}  // namespace tfasr

// x [N, D]; gamma/beta [D] f32; w1 [D, F], b1 [F], w2 [F, D], b2 [D] in
// x's dtype; out [N, D]. Requires FF_RT * D <= 256 * FF_ZPT.
extern "C" int tfasr_fused_ff(const void* x, const void* gamma, const void* beta, const void* w1, const void* b1,
                              const void* w2, const void* b2, void* out, int N, int D, int F, float eps, float factor,
                              int dtype, void* stream) {
  using namespace tfasr;
  const bool aligned = ((reinterpret_cast<uintptr_t>(w1) | reinterpret_cast<uintptr_t>(w2)) & 15) == 0;
  if (dtype == kBF16 && D % 16 == 0 && F % 8 == 0 && aligned)
    return launch_ff_wmma(x, gamma, beta, w1, b1, w2, b2, out, N, D, F, eps, factor, (cudaStream_t)stream);
  if (dtype == kBF16)
    return launch_ff<__nv_bfloat16>(x, gamma, beta, w1, b1, w2, b2, out, N, D, F, eps, factor, (cudaStream_t)stream);
  return launch_ff<float>(x, gamma, beta, w1, b1, w2, b2, out, N, D, F, eps, factor, (cudaStream_t)stream);
}
