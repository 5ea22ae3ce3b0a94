// Deterministic reductions over rows for the backward kernels' weight
// gradients: C[M, K] = A^T B summed over N rows (dW = activation^T . grad)
// and column sums (db = sum of grad rows, A == nullptr).
//
// The TPU kernels accumulate these in output blocks revisited by every step
// of a sequential grid (e.g. ff_kernel.py:125-132). Blocks on the card run
// in parallel and in no order, so instead each block owns one 32 x 32 tile
// of C and one fixed chunk of rows, sums its chunk in row order into a
// partial, and a second pass adds the partials in chunk order: the same
// bits on every run, no atomics. What bounds it: reading A and B once
// (bytes) at large N; the split keeps >= ~2 blocks per SM in flight.
#include "common.cuh"

namespace tfasr {

constexpr int RR_TILE = 32;  // C tile is RR_TILE x RR_TILE; rows staged RR_TILE at a time

__global__ void atb_partial_kernel(const float* __restrict__ A, const float* __restrict__ B, float* __restrict__ partial,
                                   int N, int M, int K, int rows_per_split) {
  __shared__ float a_s[RR_TILE][RR_TILE + 1];
  __shared__ float b_s[RR_TILE][RR_TILE + 1];
  const int tid = threadIdx.x;  // 256 threads: 4 outputs each
  const int m0 = blockIdx.y * RR_TILE, k0 = blockIdx.x * RR_TILE;
  const int split = blockIdx.z;
  const int n_begin = split * rows_per_split, n_end = min(N, n_begin + rows_per_split);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  const int kk = tid % RR_TILE, mm = tid / RR_TILE;  // outputs (mm + 8j, kk)
  for (int n0 = n_begin; n0 < n_end; n0 += RR_TILE) {
    __syncthreads();
    for (int i = tid; i < RR_TILE * RR_TILE; i += blockDim.x) {
      const int r = i / RR_TILE, c = i % RR_TILE;
      const int n = n0 + r;
      const bool row_ok = n < n_end;
      a_s[r][c] = (row_ok && m0 + c < M) ? (A != nullptr ? A[(size_t)n * M + m0 + c] : 1.f) : 0.f;
      b_s[r][c] = (row_ok && k0 + c < K) ? B[(size_t)n * K + k0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = mm + 8 * j;
      float s = acc[j];
      for (int r = 0; r < RR_TILE; ++r) s = fmaf(a_s[r][m], b_s[r][kk], s);
      acc[j] = s;
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int m = m0 + mm + 8 * j, k = k0 + kk;
    if (m < M && k < K) partial[((size_t)split * M + m) * K + k] = acc[j];
  }
}

__global__ void sum_partials_kernel(const float* __restrict__ partial, float* __restrict__ out, int splits, size_t mk) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mk) return;
  float s = 0.f;
  for (int p = 0; p < splits; ++p) s += partial[(size_t)p * mk + i];
  out[i] = s;
}

int launch_atb(const float* A, const float* B, float* out, float* partial, int N, int M, int K, int splits,
               cudaStream_t stream) {
  if (A == nullptr) M = 1;
  if (splits <= 0) splits = atb_splits(N, M, K);
  const int rows_per_split = ((N + splits - 1) / splits + RR_TILE - 1) / RR_TILE * RR_TILE;
  dim3 grid((K + RR_TILE - 1) / RR_TILE, (M + RR_TILE - 1) / RR_TILE, splits);
  atb_partial_kernel<<<grid, 256, 0, stream>>>(A, B, partial, N, M, K, rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t mk = (size_t)M * K;
  return launch_sum_partials(partial, out, splits, mk, stream);
}

int launch_sum_partials(const float* partial, float* out, int splits, size_t mk, cudaStream_t stream) {
  if (mk == 0) return 0;
  sum_partials_kernel<<<(unsigned)((mk + 255) / 256), 256, 0, stream>>>(partial, out, splits, mk);
  return (int)cudaGetLastError();
}

}  // namespace tfasr
