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

// In-kernel dropout, the counter hash of attention_kernel._dropout_mask:
// murmur3's finaliser over (row * 2654435761) ^ (col * 97538843) ^ seed in
// uint32, kept iff the hash >= thresh = rate * 2^32, kept values scaled by
// 1 / (1 - rate) (computed by the wrapper as an f32 division, as JAX
// does). The forward and the backward regenerate the same mask from the
// same (seed, row, col); it never reaches device memory.
struct Dropout {
  unsigned int seed, thresh;
  float scale;
  int on;  // rate > 0
};

__device__ __forceinline__ float dropout_keep(const Dropout& dp, unsigned int seed, unsigned int row, unsigned int col) {
  unsigned int x = (row * 2654435761u) ^ (col * 97538843u) ^ seed;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x >= dp.thresh ? dp.scale : 0.f;
}

// C[M, K] = sum over rows n of A[n, M]^T B[n, K] (A == nullptr: a column of
// ones, so C[1, K] is B's column sum), f32, deterministic: the rows are cut
// into `splits` fixed chunks, each block sums its chunk in row order into
// partial[split], and a second pass adds the partials as a balanced tree in a
// fixed order.
// With splits <= 0 the split is atb_splits(N, M, K), and partial holds
// atb_splits(N, M, K) * M * K floats. Defined in row_reduce.cu.
inline int atb_splits(int N, int M, int K) {
  const int tiles = ((M + 31) / 32) * ((K + 31) / 32);
  int s = (264 + tiles - 1) / tiles;  // ~2 blocks per SM of the 132
  const int most = (N + 63) / 64;    // at least 64 rows per chunk
  return s < 1 ? 1 : (s > most ? (most < 1 ? 1 : most) : s);
}

int launch_atb(const float* A, const float* B, float* out, float* partial, int N, int M, int K, int splits,
               cudaStream_t stream);

// out[i] = sum over p of partial[p * mk + i] as a balanced binary tree over p
// in a fixed order (deterministic). Defined in row_reduce.cu.
int launch_sum_partials(const float* partial, float* out, int splits, size_t mk, cudaStream_t stream);

}  // namespace tfasr
