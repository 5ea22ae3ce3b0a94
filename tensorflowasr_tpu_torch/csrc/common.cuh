// Shared device helpers for the port's hand-written Hopper kernels.
//
// Every kernel here reads its activations and weights as T (float or
// __nv_bfloat16), computes in f32, and rounds a product operand to T
// exactly where the JAX reference casts it (`x.astype(w.dtype)` before a
// dot), so the bf16 kernels round at the same places as the TPU kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tfasr {

enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

// Round an f32 value to T and back (the cast a product operand takes).
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f32(from_f32<T>(x)); }

__device__ __forceinline__ float sigmoid_f32(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Store v rounded to T: as an f32 value, or as the bf16 operand itself.
template <typename T>
__device__ __forceinline__ void put_rounded(float* p, float v) { *p = round_to<T>(v); }
template <typename T>
__device__ __forceinline__ void put_rounded(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// One warp layer-normalises one row of D values: mean, centred variance
// and rsqrt in f32 (ff_kernel._ln_fwd), then y = xhat*gamma + beta rounded
// to T — the operand the following product reads.
template <typename T, typename O>
__device__ __forceinline__ void ln_row_warp(const T* x, const float* gamma, const float* beta, int D, float eps,
                                            O* dst, int lane) {
  float s = 0.f;
  for (int c = lane; c < D; c += 32) s += to_f32(x[c]);
  const float mu = warp_sum(s) / (float)D;
  float q = 0.f;
  for (int c = lane; c < D; c += 32) {
    const float cx = to_f32(x[c]) - mu;
    q = fmaf(cx, cx, q);
  }
  const float rstd = rsqrtf(warp_sum(q) / (float)D + eps);
  for (int c = lane; c < D; c += 32) put_rounded<T>(dst + c, (to_f32(x[c]) - mu) * rstd * gamma[c] + beta[c]);
}

// Raise a kernel's dynamic shared-memory limit when it needs more than the
// default 48 KB.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace tfasr
