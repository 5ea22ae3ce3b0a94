// Row kernels of the unfused RNN-T loss over materialised joint logits
// [B, T, U1, V] (one row per lattice cell (b, t, u)):
//   logprobs: lse = logsumexp_v x[v]; lp_blank = x[0] - lse;
//             lp_emit = x[labels[b, u]] - lse for u < U1 - 1, LOG_0 at u = U1 - 1
//   dlogits:  d[v] = (1[v=0] gbl + 1[v=lab] gem - exp(x[v] - lse) (gbl + gem)) * g[b],
//             rounded to the logits' dtype
// x is read as T (float or bf16) and computed in f32.
//
// Replaces tensorflowasr_tpu/ops/pallas/rnnt_kernel.py _logits_to_logprobs
// (_logprob_kernel) and _dlogits_assemble (_dlogits_kernel). The TPU
// kernels pad V to a multiple of 128 lanes with LOG_0, pad the rows to the
// block size and read a broadcast [rows, 1] label column; none of that is
// carried over. Here one warp owns one row: each lane loads 16 bytes at a
// time (8 bf16 or 4 f32 values; V = 256 bf16 is one load per lane), keeps a
// running max and sum of exponentials, and the warp reduces them with
// shuffles. The label is read from labels[b, u] by the row index. A row
// whose length is not a multiple of 16 bytes (or a misaligned tensor) takes
// the same kernel with one element per load, masked at V.
//
// What bounds it on the card: bytes. At the flagship (825,600 rows of
// V = 256 bf16) logprobs reads 423 MB and writes 10 MB (0.13 ms at
// 3.35 TB/s); dlogits reads and writes 423 MB each (0.26 ms). About five
// f32 operations per logit stay far below the f32 peak.
#include <float.h>

#include "common.cuh"

namespace tfasr {

constexpr int ROWS_THREADS = 256;  // 8 rows (warps) per block
constexpr float ROWS_NEG = -1e30f;  // LOG_0 of the JAX package

// E consecutive values of a row as f32: one 16-byte load (E = 16 / sizeof(T)), or one scalar (E = 1)
template <typename T, int E>
__device__ __forceinline__ void load_chunk(const T* p, float (&v)[E]) {
  if constexpr (E == 1) {
    v[0] = to_f32(p[0]);
  } else {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* r = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < E; ++i) v[i] = to_f32(r[i]);
  }
}

template <typename T, int E>
__device__ __forceinline__ void store_chunk(T* p, const float (&v)[E]) {
  if constexpr (E == 1) {
    p[0] = from_f32<T>(v[0]);
  } else {
    uint4 raw;
    T* r = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < E; ++i) r[i] = from_f32<T>(v[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
}

// The label of row `row` (-1 at u = U1 - 1: no label left to emit)
__device__ __forceinline__ int row_label(const int* labels, long long row, int Tn, int U1, int& b) {
  const int u = (int)(row % U1);
  b = (int)(row / ((long long)Tn * U1));
  return u < U1 - 1 ? labels[(size_t)b * (U1 - 1) + u] : -1;
}

template <typename T, int E>
__global__ void __launch_bounds__(ROWS_THREADS) rnnt_logprobs_kernel(const T* __restrict__ logits, const int* __restrict__ labels,
                                                                     float* __restrict__ lpb, float* __restrict__ lpe,
                                                                     float* __restrict__ lse, long long rows, int Tn, int U1,
                                                                     int V) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (ROWS_THREADS / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const T* x = logits + row * V;
  float m = -FLT_MAX, s = 0.f;  // this lane's running max and sum of exp(x - m)
  for (int c = lane * E; c < V; c += 32 * E) {
    float v[E];
    load_chunk<T, E>(x + c, v);
    float cm = v[0];
#pragma unroll
    for (int i = 1; i < E; ++i) cm = fmaxf(cm, v[i]);
    const float nm = fmaxf(m, cm);
    float cs = 0.f;
#pragma unroll
    for (int i = 0; i < E; ++i) cs += expf(v[i] - nm);
    s = s * expf(m - nm) + cs;
    m = nm;
  }
  const float mx = warp_max(m);
  const float sum = warp_sum(s * expf(m - mx));
  if (lane == 0) {
    int b;
    const int lab = row_label(labels, row, Tn, U1, b);
    const float l = mx + logf(sum);
    lse[row] = l;
    lpb[row] = to_f32(x[0]) - l;
    // as the TPU kernel's select-and-sum: a label outside [0, V) picks 0
    lpe[row] = lab < 0 ? ROWS_NEG : (lab < V ? to_f32(x[lab]) : 0.f) - l;
  }
}

template <typename T, int E>
__global__ void __launch_bounds__(ROWS_THREADS) rnnt_dlogits_kernel(const T* __restrict__ logits, const float* __restrict__ lse,
                                                                    const float* __restrict__ gbl, const float* __restrict__ gem,
                                                                    const int* __restrict__ labels, const float* __restrict__ g,
                                                                    T* __restrict__ out, long long rows, int Tn, int U1, int V) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (ROWS_THREADS / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  int b;
  const int lab = row_label(labels, row, Tn, U1, b);
  const float l = lse[row], gb = gbl[row], ge = gem[row], gs = g[b];
  const float gsum = gb + ge;
  const T* x = logits + row * V;
  T* o = out + row * V;
  for (int c = lane * E; c < V; c += 32 * E) {
    float v[E];
    load_chunk<T, E>(x + c, v);
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const int vi = c + i;
      const float d = (vi == 0 ? gb : 0.f) + (vi == lab ? ge : 0.f) - expf(v[i] - l) * gsum;
      v[i] = d * gs;
    }
    store_chunk<T, E>(o + c, v);
  }
}

template <typename T>
int launch_logprobs(const void* logits, const void* labels, void* lpb, void* lpe, void* lse, long long rows, int Tn, int U1,
                    int V, int vec, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((rows + ROWS_THREADS / 32 - 1) / (ROWS_THREADS / 32));
  const auto* x = (const T*)logits;
  if (vec)
    rnnt_logprobs_kernel<T, (int)(16 / sizeof(T))><<<blocks, ROWS_THREADS, 0, stream>>>(
        x, (const int*)labels, (float*)lpb, (float*)lpe, (float*)lse, rows, Tn, U1, V);
  else
    rnnt_logprobs_kernel<T, 1><<<blocks, ROWS_THREADS, 0, stream>>>(x, (const int*)labels, (float*)lpb, (float*)lpe,
                                                                   (float*)lse, rows, Tn, U1, V);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dlogits(const void* logits, const void* lse, const void* gbl, const void* gem, const void* labels, const void* g,
                   void* out, long long rows, int Tn, int U1, int V, int vec, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((rows + ROWS_THREADS / 32 - 1) / (ROWS_THREADS / 32));
  const auto* x = (const T*)logits;
  if (vec)
    rnnt_dlogits_kernel<T, (int)(16 / sizeof(T))><<<blocks, ROWS_THREADS, 0, stream>>>(
        x, (const float*)lse, (const float*)gbl, (const float*)gem, (const int*)labels, (const float*)g, (T*)out, rows, Tn,
        U1, V);
  else
    rnnt_dlogits_kernel<T, 1><<<blocks, ROWS_THREADS, 0, stream>>>(x, (const float*)lse, (const float*)gbl, (const float*)gem,
                                                                  (const int*)labels, (const float*)g, (T*)out, rows, Tn,
                                                                  U1, V);
  return (int)cudaGetLastError();
}

}  // namespace tfasr

// logits [B, T, U1, V] (dtype 0 f32, 1 bf16); labels [B, U1 - 1] int32;
// lpb, lpe, lse [B, T, U1] f32. vec: rows are 16-byte aligned (V * elt % 16 == 0, aligned base).
extern "C" int tfasr_rnnt_logprobs(const void* logits, const void* labels, void* lpb, void* lpe, void* lse, int B, int T,
                                   int U1, int V, int dtype, int vec, void* stream) {
  using namespace tfasr;
  const long long rows = (long long)B * T * U1;
  if (rows == 0) return 0;
  auto s = (cudaStream_t)stream;
  return dtype == kBF16 ? launch_logprobs<__nv_bfloat16>(logits, labels, lpb, lpe, lse, rows, T, U1, V, vec, s)
                        : launch_logprobs<float>(logits, labels, lpb, lpe, lse, rows, T, U1, V, vec, s);
}

// logits, out [B, T, U1, V] (dtype 0 f32, 1 bf16); lse, gbl, gem [B, T, U1] f32; labels [B, U1 - 1] int32; g [B] f32.
extern "C" int tfasr_rnnt_dlogits(const void* logits, const void* lse, const void* gbl, const void* gem, const void* labels,
                                  const void* g, void* out, int B, int T, int U1, int V, int dtype, int vec, void* stream) {
  using namespace tfasr;
  const long long rows = (long long)B * T * U1;
  if (rows == 0) return 0;
  auto s = (cudaStream_t)stream;
  return dtype == kBF16 ? launch_dlogits<__nv_bfloat16>(logits, lse, gbl, gem, labels, g, out, rows, T, U1, V, vec, s)
                        : launch_dlogits<float>(logits, lse, gbl, gem, labels, g, out, rows, T, U1, V, vec, s);
}
