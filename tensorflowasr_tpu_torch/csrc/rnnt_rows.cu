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
// carried over.
//
// logprobs, rows of 16-byte aligned bytes (the flagship's V = 256 bf16):
// one warp a tile of 32 / G consecutive rows (as many as fit 4 KB, at most
// 32; V 256 bf16: 8 rows, G = 4 lanes a row), a grid of as many warps as
// tiles. Lane q of row g's group loads the row's 16-byte chunks q, q + G,
// ... straight into registers, eight a lane a pass (one pass for rows up
// to 4 KB), with streaming (evict-first) loads issued together, so each
// warp keeps its whole tile in flight. A pass takes the max of its chunks
// (bf16 pairs by packed max, exact), combines it over the group by
// shuffles, then sums 2^(x log2 e - m) on the special-function unit (ex2);
// x[0] comes from the first chunk and x[label] from the lane holding the
// label's chunk by a shuffle, with no second read; a tile's labels come
// one row a lane in 32-bit arithmetic, and its three outputs go out as
// contiguous runs. Rows of another length or a misaligned tensor take one
// warp a row with one element per load, masked at V. dlogits: one warp a
// row, each lane 16 bytes at a time (8 bf16 or 4 f32 values), or one
// element per load for other rows.
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

// The one-element form of the log-probability rows, for rows that are not 16-byte aligned: one warp per row, one
// value per lane and load, masked at V.
template <typename T>
__global__ void __launch_bounds__(ROWS_THREADS) rnnt_logprobs_scalar(const T* __restrict__ logits, const int* __restrict__ labels,
                                                                     float* __restrict__ lpb, float* __restrict__ lpe,
                                                                     float* __restrict__ lse, long long rows, int Tn, int U1, int V) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (ROWS_THREADS / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const T* x = logits + row * V;
  float m = -FLT_MAX, s = 0.f;  // this lane's running max and sum of exp(x - m)
  for (int c = lane; c < V; c += 32) {
    const float v = to_f32(x[c]);
    const float nm = fmaxf(m, v);
    s = s * expf(m - nm) + expf(v - nm);
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

// ---- 16-byte aligned rows: one warp a tile of rows, the chunks in registers ----

constexpr int LP_THREADS = 256;   // 8 tiles (warps) per block
constexpr int LP_MIN_BLOCKS = 4;  // blocks an SM: at most 64 registers a thread
constexpr int LP_CHUNKS = 8;      // 16-byte chunks a lane loads in one pass
constexpr float LP_LOG2E = 1.4426950408889634f, LP_LN2 = 0.6931471805599453f;

__device__ __forceinline__ float lp_ex2(float x) {  // 2^x on the special-function unit
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A 16-byte chunk of -inf values: the fill of a chunk past the row's end (no term in the max or the sum).
template <typename T>
__device__ __forceinline__ uint4 lp_neg_inf() {
  constexpr uint32_t w = sizeof(T) == 2 ? 0xff80ff80u : 0xff800000u;
  return make_uint4(w, w, w, w);
}

template <typename T>
__device__ __forceinline__ float lp_chunk_max(const uint4& c) {
  if constexpr (sizeof(T) == 2) {
    const __nv_bfloat162* r = reinterpret_cast<const __nv_bfloat162*>(&c);
    const __nv_bfloat162 m = __hmax2(__hmax2(r[0], r[1]), __hmax2(r[2], r[3]));
    return fmaxf(__low2float(m), __high2float(m));
  } else {
    return fmaxf(fmaxf(__uint_as_float(c.x), __uint_as_float(c.y)), fmaxf(__uint_as_float(c.z), __uint_as_float(c.w)));
  }
}

// The sum of 2^(x log2 e - m) over a chunk's values (m in base-2 units; each exponent one fused rounding), in two chains.
template <typename T>
__device__ __forceinline__ float lp_chunk_sum(const uint4& c, float m) {
  constexpr int E = 16 / sizeof(T);
  const T* r = reinterpret_cast<const T*>(&c);
  float c0 = 0.f, c1 = 0.f;
#pragma unroll
  for (int i = 0; i < E; i += 2) {
    c0 += lp_ex2(fmaf(to_f32(r[i]), LP_LOG2E, -m));
    c1 += lp_ex2(fmaf(to_f32(r[i + 1]), LP_LOG2E, -m));
  }
  return c0 + c1;
}

// Element k (< E, not known at compile time) of a chunk in registers: its 32-bit word, then its half for bf16.
template <typename T>
__device__ __forceinline__ float lp_element(const uint4& c, int k) {
  const int w = k / (4 / (int)sizeof(T));
  const uint32_t word = w == 0 ? c.x : w == 1 ? c.y : w == 2 ? c.z : c.w;
  if constexpr (sizeof(T) == 2) return __uint_as_float((k & 1) ? (word & 0xffff0000u) : (word << 16));
  else return __uint_as_float(word);
}

template <int G>
__device__ __forceinline__ float lp_group_max(float v) {  // xor offsets below G stay inside the group
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int G>
__device__ __forceinline__ float lp_group_sum(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct LpArgs {
  int rows, Tn, U1, V;  // rows = B T U1 < 2^31
};

// Warp w of the grid takes rows [32 / G * w, 32 / G * (w + 1)): row g of its tile goes to lanes g G .. g G + G - 1.
// A pass loads chunks base + q + G i (i < LP_CHUNKS) of the lane's row into registers (-inf past the row), takes
// their max over the group, rescales the running sum to the new max m (base 2; uniform over the group) and adds
// the pass's terms. lse = m ln 2 + ln(sum) on the group's first lane, which also holds x[0]; x[label] comes by one
// shuffle from the lane holding the label's chunk, in the pass that loaded it.
template <typename T, int G>
__global__ void __launch_bounds__(LP_THREADS, LP_MIN_BLOCKS) rnnt_logprobs_tiles(const T* __restrict__ logits, const int* __restrict__ labels,
                                                                                float* __restrict__ lpb, float* __restrict__ lpe,
                                                                                float* __restrict__ lse, LpArgs a) {
  constexpr int E = 16 / sizeof(T), R = 32 / G;
  const int lane = threadIdx.x & 31, q = lane % G, g = lane / G;
  const int r0 = (blockIdx.x * (LP_THREADS / 32) + (threadIdx.x >> 5)) * R;
  if (r0 >= a.rows) return;
  const int n = min(R, a.rows - r0), chunks = a.V / E;
  int lab = -1;  // the label of row lane (-1 at u = U1 - 1), in 32-bit arithmetic
  if (lane < n) {
    const int r = r0 + lane, bt = r / a.U1, u = r - bt * a.U1;
    lab = u < a.U1 - 1 ? labels[(bt / a.Tn) * (a.U1 - 1) + u] : -1;
  }
  const int rl = __shfl_sync(0xffffffffu, lab, g);  // the label of this lane's row
  const int lc = rl >= 0 && rl < a.V ? rl / E : 0;   // its chunk: lane lc % G of the group, position lc / G
  const bool live = g < n;
  const uint4* row = reinterpret_cast<const uint4*>(logits + (size_t)(r0 + (live ? g : 0)) * a.V);
  float m = -FLT_MAX, s = 0.f, x0 = 0.f, xl = 0.f;
#pragma unroll 1
  for (int base = 0; base < chunks; base += G * LP_CHUNKS) {
    uint4 c[LP_CHUNKS];
#pragma unroll
    for (int i = 0; i < LP_CHUNKS; ++i) {
      const int ch = base + q + G * i;
      c[i] = ch < chunks ? __ldcs(row + ch) : lp_neg_inf<T>();
    }
    float mx = lp_chunk_max<T>(c[0]);
#pragma unroll
    for (int i = 1; i < LP_CHUNKS; ++i) mx = fmaxf(mx, lp_chunk_max<T>(c[i]));
    const float nm = fmaxf(m, lp_group_max<G>(mx) * LP_LOG2E);
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int i = 0; i < LP_CHUNKS; i += 2) {
      s0 += lp_chunk_sum<T>(c[i], nm);
      s1 += lp_chunk_sum<T>(c[i + 1], nm);
    }
    s = s * lp_ex2(m - nm) + (s0 + s1);
    m = nm;
    if (base == 0) x0 = lp_element<T>(c[0], 0);
    const int at = lc - base;  // the label's chunk from this pass's start: position at / G of lane lc % G
    uint4 sel = c[0];
#pragma unroll
    for (int i = 1; i < LP_CHUNKS; ++i)
      if (at - at % G == G * i) sel = c[i];
    const float v = __shfl_sync(0xffffffffu, lp_element<T>(sel, rl - lc * E), g * G + lc % G);
    if (at >= 0 && at < G * LP_CHUNKS) xl = v;
  }
  s = lp_group_sum<G>(s);
  float l = 0.f, pb = 0.f, pe = 0.f;
  if (q == 0 && live) {
    l = fmaf(m, LP_LN2, logf(s));
    pb = x0 - l;
    // as the TPU kernel's select-and-sum: a label outside [0, V) picks 0
    pe = rl < 0 ? ROWS_NEG : (rl < a.V ? xl : 0.f) - l;
  }
  const int src = (lane % R) * G;  // lane r takes row r's results
  const float kl = __shfl_sync(0xffffffffu, l, src), kb = __shfl_sync(0xffffffffu, pb, src), ke = __shfl_sync(0xffffffffu, pe, src);
  if (lane < n) {
    lse[r0 + lane] = kl;
    lpb[r0 + lane] = kb;
    lpe[r0 + lane] = ke;
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

// tile_rows 0: the one-element kernel; else tiles of tile_rows rows (16-byte aligned rows, tile_rows a power of two
// <= 32), 32 / tile_rows lanes a row.
template <typename T>
int launch_logprobs(const void* logits, const void* labels, void* lpb, void* lpe, void* lse, long long rows, int Tn, int U1, int V,
                    int tile_rows, cudaStream_t stream) {
  const auto* x = (const T*)logits;
  auto* o = (float*)lpb;
  auto* e = (float*)lpe;
  auto* l = (float*)lse;
  const int* lab = (const int*)labels;
  if (tile_rows == 0) {
    const unsigned blocks = (unsigned)((rows + ROWS_THREADS / 32 - 1) / (ROWS_THREADS / 32));
    rnnt_logprobs_scalar<T><<<blocks, ROWS_THREADS, 0, stream>>>(x, lab, o, e, l, rows, Tn, U1, V);
    return (int)cudaGetLastError();
  }
  if (rows >= (1ll << 31) || V * sizeof(T) % 16 != 0) return (int)cudaErrorInvalidValue;
  const LpArgs a{(int)rows, Tn, U1, V};
  const long long tiles = (rows + tile_rows - 1) / tile_rows;
  const unsigned blocks = (unsigned)((tiles + LP_THREADS / 32 - 1) / (LP_THREADS / 32));
  switch (tile_rows) {
    case 32: rnnt_logprobs_tiles<T, 1><<<blocks, LP_THREADS, 0, stream>>>(x, lab, o, e, l, a); break;
    case 16: rnnt_logprobs_tiles<T, 2><<<blocks, LP_THREADS, 0, stream>>>(x, lab, o, e, l, a); break;
    case 8: rnnt_logprobs_tiles<T, 4><<<blocks, LP_THREADS, 0, stream>>>(x, lab, o, e, l, a); break;
    case 4: rnnt_logprobs_tiles<T, 8><<<blocks, LP_THREADS, 0, stream>>>(x, lab, o, e, l, a); break;
    case 2: rnnt_logprobs_tiles<T, 16><<<blocks, LP_THREADS, 0, stream>>>(x, lab, o, e, l, a); break;
    case 1: rnnt_logprobs_tiles<T, 32><<<blocks, LP_THREADS, 0, stream>>>(x, lab, o, e, l, a); break;
    default: return (int)cudaErrorInvalidValue;
  }
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

// logits [B, T, U1, V] (dtype 0 f32, 1 bf16); labels [B, U1 - 1] int32; lpb, lpe, lse [B, T, U1] f32.
// tile_rows 0: one element a load (any row); else one warp a tile of tile_rows rows, 32 / tile_rows lanes a row
// (rows 16-byte aligned: V * elt % 16 == 0 and an aligned base; tile_rows a power of two <= 32).
extern "C" int tfasr_rnnt_logprobs(const void* logits, const void* labels, void* lpb, void* lpe, void* lse, int B, int T, int U1, int V,
                                   int dtype, int tile_rows, void* stream) {
  using namespace tfasr;
  const long long rows = (long long)B * T * U1;
  if (rows == 0) return 0;
  auto s = (cudaStream_t)stream;
  return dtype == kBF16 ? launch_logprobs<__nv_bfloat16>(logits, labels, lpb, lpe, lse, rows, T, U1, V, tile_rows, s)
                        : launch_logprobs<float>(logits, labels, lpb, lpe, lse, rows, T, U1, V, tile_rows, s);
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
