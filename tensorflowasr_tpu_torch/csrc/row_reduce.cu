// Deterministic reductions over rows for the backward kernels' weight
// gradients: C[M, K] = A^T B summed over N rows (dW = activation^T . grad)
// and column sums (db = sum of grad rows, A == nullptr).
//
// The TPU kernels accumulate these in output blocks revisited by every step
// of a sequential grid (e.g. ff_kernel.py:125-132). Blocks on the card run
// in parallel and in no order, so instead each block owns one 32 x 32 tile
// of C and one fixed chunk of rows, sums its chunk in row order into a
// partial, and a second pass adds the partials as a balanced tree in a fixed
// order (sum_partials_kernel): the same bits on every run, no atomics. What bounds it: reading A and B once
// (bytes) at large N; the split keeps >= ~2 blocks per SM in flight.
#include <algorithm>

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

constexpr int SP_CHUNK = 32;  // partials a lane sums in registers
constexpr int SP_WARPS = 8;   // warps of a block (over the chunks of its 32 outputs)

// The partials of each output as a balanced binary tree in a fixed order,
// level by level: at level L the element at a (a multiple of 2^(L+1), the
// sum of partials a .. a + 2^L - 1) takes in the element at a + 2^L where
// that exists; an element without a partner moves up as it is. (This is the
// tree of pairwise summation: complete subtrees over aligned powers of two,
// the rest joined from the right.) A block owns 32 outputs, one per lane;
// each warp's lanes sum chunks of 32 partials in registers by the first five
// levels (32 independent loads in flight), the chunk sums go to shared
// memory and the levels go on over them there, one block barrier a level.
// The same bits on every run, no atomics; the rounding error grows with
// log2(splits), not with splits as a sum in order would.
__global__ void sum_partials_kernel(const float* __restrict__ partial, float* __restrict__ out, int splits, size_t mk) {
  extern __shared__ float cs[];  // [chunks][32]: chunk sums, then the levels above
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const size_t i = (size_t)blockIdx.x * 32 + lane;
  const bool col = i < mk;
  const int chunks = (splits + SP_CHUNK - 1) / SP_CHUNK;
  for (int c = warp; c < chunks; c += nw) {
    const int n = min(SP_CHUNK, splits - c * SP_CHUNK);
    float v[SP_CHUNK];
#pragma unroll
    for (int j = 0; j < SP_CHUNK; ++j) v[j] = col && j < n ? partial[(size_t)(c * SP_CHUNK + j) * mk + i] : 0.f;
#pragma unroll
    for (int step = 1; step < SP_CHUNK; step *= 2) {
#pragma unroll
      for (int a = 0; a + step < SP_CHUNK; a += 2 * step)
        if (a + step < n) v[a] += v[a + step];
    }
    cs[c * 32 + lane] = v[0];
  }
  __syncthreads();
  for (int step = 1; step < chunks; step *= 2) {
    for (int a = 2 * step * warp; a + step < chunks; a += 2 * step * nw) cs[a * 32 + lane] += cs[(a + step) * 32 + lane];
    __syncthreads();
  }
  if (warp == 0 && col) out[i] = cs[lane];
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
  if (mk == 0 || splits <= 0) return 0;
  const int chunks = (splits + SP_CHUNK - 1) / SP_CHUNK;
  const size_t smem = (size_t)chunks * 32 * sizeof(float);
  cudaError_t err = allow_smem(sum_partials_kernel, smem);  // refused past 227 KB: splits > 58112
  if (err != cudaSuccess) return (int)err;
  sum_partials_kernel<<<(unsigned)((mk + 31) / 32), 32 * std::min(chunks, SP_WARPS), smem, stream>>>(partial, out, splits, mk);
  return (int)cudaGetLastError();
}

}  // namespace tfasr
