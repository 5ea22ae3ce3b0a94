// Fused attention with an additive bias: softmax(q.k^T + bias) with
// probability dropout, then P.V; and its backward. This file holds the f32
// kernels (CUDA cores) and the C entry points; bf16 inputs go to the
// tensor-core kernels of attention_mma.cu.
//
// Counterpart of tensorflowasr_tpu/ops/pallas/attention_kernel.py
// fused_attention (kernel A: _fwd_kernel, _bwd_kernel), the vanilla
// multi-head attention of the Transformer encoders. The bias [BH|1, T, S]
// (the Keras -1e9 query-row mask, or anything additive) is read in its own
// dtype and added to the f32 scores, as JAX does.
//
// Forward (f32): one block owns FA_TQ query rows of one (b.h). Key tiles are
// staged in shared memory, and the rows' whole score vectors stay resident
// there: the softmax is two-pass in f32, and the normalised probabilities
// (times the dropout keep factor, the counter hash of common.cuh indexed by
// (row, column) under seed + bh * 40499 as in JAX) are rounded to v's type
// before P.V exactly where the reference rounds them. Keeping whole rows is
// what makes the rounding equal to JAX's. The row max m and sum l go to the
// stats output [2, BH, T], as the bf16 forward's do.
//
// Backward (f32, replaces _bwd_kernel), two passes:
//  1. attention_bwd_rows_kernel, per (b.h, FA_TQ query rows): recompute the
//     probabilities, dp = do . v^T, the keep mask, delta = sum(do * out)
//     from the saved output (the value JAX recomputes with the forward's
//     rounding), ds = p * (dp * keep - delta); dq = ds . k. ds and the
//     dropped probabilities pd (f32) go to device memory; ds goes to dbias
//     when the bias needs a gradient (the wrapper sums it over b.h for a
//     broadcast bias).
//  2. attention_bwd_kv_kernel, per (b.h, FA_KVT keys): dk = ds^T . q and
//     dv = pd^T . do, summing all query rows in order (no atomics).
//
// What bounds the f32 path: the products, 4 (fwd) and 10 (bwd) b.h.T.S.D
// operations on the CUDA cores (67 TFLOP/s at most). f32 stays off the
// tensor cores: TF32 would break the card/CPU f32 parity. Head size up to 128.
#include "common.cuh"

namespace tfasr {

constexpr int FA_TQ = 16;       // query rows per block
constexpr int FA_KT = 64;       // key columns per staged tile (forward and pass 1)
constexpr int FA_OUT_PT = 8;    // output accumulators per thread: FA_TQ * D <= 256 * FA_OUT_PT
constexpr int FA_KVT = 32;      // keys per block in pass 2
constexpr int FA_KV_PT = 16;    // dk/dv accumulators per thread: FA_KVT * D <= 256 * FA_KV_PT
constexpr int FA_RC = 32;       // query rows per staged chunk in pass 2
constexpr int FA_THREADS = 256;
constexpr float FA_NEG_PAD = -1e30f;
constexpr unsigned int FA_SALT_BH = 40499u;  // per-(b.h) seed salt of the JAX kernel

struct AttnArgs {
  int T, S, D;
  size_t bias_bh_stride;  // T * S, or 0 for a broadcast bias
  float* stats;           // [2, BH, T] row max and sum, or null
  int BH;
};

int launch_attention_mma(const void* q, const void* k, const void* v, const void* bias, int bias_bf16, void* out, float* stats, int BH, int T,
                         int S, int D, int bias_bh, Dropout dp, cudaStream_t stream);
int launch_attention_mma_bwd(const void* q, const void* k, const void* v, const void* bias, int bias_bf16, const void* out, const void* dout,
                             const float* stats, float* delta, float* dbias, void* dq, void* dk, void* dv, int BH, int T, int S, int D,
                             int bias_bh, Dropout dp, cudaStream_t stream);

__host__ __device__ inline int fa_sp(int S) { return ((S + FA_KT - 1) / FA_KT) * FA_KT; }

// Stage the block's query rows and compute their scores into sc [FA_TQ][Sp]
// (FA_NEG_PAD past S), then softmax each row in place: sc holds the f32
// normalised probabilities on return. Shared by the forward and pass 1.
template <typename T, typename TB>
__device__ void attn_probs_rows(const T* q, const T* k, const TB* bias, const AttnArgs& a, int bh, int i0, int nrows,
                                float* q_s, float* kv_s, float* sc) {
  const int D = a.D, S = a.S;
  const int Dp = D + 1;
  const int Sp = fa_sp(S);
  const int tid = threadIdx.x;
  const size_t qoff = (size_t)bh * a.T * D, koff = (size_t)bh * S * D;
  const TB* brow = bias + (size_t)bh * a.bias_bh_stride + (size_t)i0 * S;

  for (int idx = tid; idx < FA_TQ * D; idx += blockDim.x) {
    const int i = idx / D, d = idx % D;
    q_s[idx] = i < nrows ? to_f32(q[qoff + (size_t)(i0 + i) * D + d]) : 0.f;
  }
  for (int s0 = 0; s0 < Sp; s0 += FA_KT) {
    __syncthreads();
    for (int idx = tid; idx < FA_KT * D; idx += blockDim.x) {
      const int s = idx / D, d = idx % D;
      kv_s[s * Dp + d] = (s0 + s < S) ? to_f32(k[koff + (size_t)(s0 + s) * D + d]) : 0.f;
    }
    __syncthreads();
    for (int idx = tid; idx < FA_TQ * FA_KT; idx += blockDim.x) {
      const int i = idx / FA_KT, sl = idx % FA_KT;
      if (i >= nrows) continue;
      const int s = s0 + sl;
      float val = FA_NEG_PAD;
      if (s < S) {
        const float* qr = q_s + i * D;
        const float* kr = kv_s + sl * Dp;
        float c = 0.f;
        for (int d = 0; d < D; ++d) c = fmaf(qr[d], kr[d], c);
        val = c + to_f32(brow[(size_t)i * S + s]);
      }
      sc[i * Sp + s] = val;
    }
  }
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  for (int i = warp; i < nrows; i += nwarps) {
    float* row = sc + i * Sp;
    float m = -INFINITY;
    for (int s = lane; s < S; s += 32) m = fmaxf(m, row[s]);
    m = warp_max(m);
    float l = 0.f;
    for (int s = lane; s < S; s += 32) {
      const float e = expf(row[s] - m);
      row[s] = e;
      l += e;
    }
    l = warp_sum(l);
    for (int s = lane; s < S; s += 32) row[s] = row[s] / l;
    if (a.stats != nullptr && lane == 0) {
      a.stats[(size_t)bh * a.T + i0 + i] = m;
      a.stats[(size_t)(a.BH + bh) * a.T + i0 + i] = l;
    }
  }
  __syncthreads();
}

// acc[j] += sum over the S columns of sc[i][s] * x[s][d] for the thread's
// (i, d) outputs o = tid + j * blockDim.x < FA_TQ * D, with x ([BH, S, D]
// at koff) staged FA_KT rows at a time through kv_s.
template <typename T>
__device__ void rows_times(const float* sc, const T* x, size_t koff, int S, int D, float* kv_s, float (&acc)[FA_OUT_PT]) {
  const int tid = threadIdx.x, Dp = D + 1, Sp = fa_sp(S);
  for (int s0 = 0; s0 < S; s0 += FA_KT) {
    const int ns = min(FA_KT, S - s0);
    __syncthreads();
    for (int idx = tid; idx < FA_KT * D; idx += blockDim.x) {
      const int s = idx / D, d = idx % D;
      kv_s[s * Dp + d] = (s < ns) ? to_f32(x[koff + (size_t)(s0 + s) * D + d]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < FA_OUT_PT; ++j) {
      const int o = tid + j * blockDim.x;
      if (o < FA_TQ * D) {
        const int i = o / D, d = o % D;
        const float* pr = sc + i * Sp + s0;
        float acc_j = acc[j];
        for (int sl = 0; sl < ns; ++sl) acc_j = fmaf(pr[sl], kv_s[sl * Dp + d], acc_j);
        acc[j] = acc_j;
      }
    }
  }
}

template <typename T, typename TB>
__global__ void attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                                     const TB* __restrict__ bias, T* __restrict__ out, AttnArgs a, Dropout dp) {
  extern __shared__ float smem[];
  const int D = a.D, S = a.S;
  const int Sp = fa_sp(S);
  float* q_s = smem;                  // [FA_TQ][D]
  float* kv_s = q_s + FA_TQ * D;      // [FA_KT][D + 1] key tile, later value tile
  float* sc = kv_s + FA_KT * (D + 1);  // [FA_TQ][Sp] scores, then probabilities

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int i0 = blockIdx.x * FA_TQ;
  const int nrows = min(FA_TQ, a.T - i0);
  attn_probs_rows<T, TB>(q, k, bias, a, bh, i0, nrows, q_s, kv_s, sc);

  const unsigned int seed = dp.seed + (unsigned int)bh * FA_SALT_BH;
  for (int idx = tid; idx < nrows * S; idx += blockDim.x) {
    const int i = idx / S, s = idx % S;
    float p = sc[i * Sp + s];
    if (dp.on) p *= dropout_keep(dp, seed, i0 + i, s);
    sc[i * Sp + s] = round_to<T>(p);
  }

  float acc[FA_OUT_PT];
#pragma unroll
  for (int j = 0; j < FA_OUT_PT; ++j) acc[j] = 0.f;
  rows_times<T>(sc, v, (size_t)bh * S * D, S, D, kv_s, acc);
  const size_t qoff = (size_t)bh * a.T * D;
#pragma unroll
  for (int j = 0; j < FA_OUT_PT; ++j) {
    const int o = tid + j * blockDim.x;
    if (o < FA_TQ * D) {
      const int i = o / D, d = o % D;
      if (i < nrows) out[qoff + (size_t)(i0 + i) * D + d] = from_f32<T>(acc[j]);
    }
  }
}

// Pass 1: ds, pd (and dbias) to device memory; dq written.
template <typename T, typename TB>
__global__ void attention_bwd_rows_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                                          const TB* __restrict__ bias, const T* __restrict__ out,
                                          const T* __restrict__ dout, T* __restrict__ ds_o, float* __restrict__ pd_o,
                                          float* __restrict__ dbias, T* __restrict__ dq, AttnArgs a, Dropout dp) {
  extern __shared__ float smem[];
  const int D = a.D, S = a.S, Tq = a.T;
  const int Dp = D + 1;
  const int Sp = fa_sp(S);
  float* q_s = smem;                   // [FA_TQ][D]
  float* kv_s = q_s + FA_TQ * D;       // [FA_KT][Dp]
  float* sc = kv_s + FA_KT * Dp;       // [FA_TQ][Sp] probabilities, then ds
  float* do_s = sc + FA_TQ * Sp;       // [FA_TQ][D]
  float* delta_s = do_s + FA_TQ * D;   // [FA_TQ]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const int bh = blockIdx.y;
  const int i0 = blockIdx.x * FA_TQ;
  const int nrows = min(FA_TQ, Tq - i0);
  const size_t qoff = (size_t)bh * Tq * D, koff = (size_t)bh * S * D;
  const size_t soff = (size_t)bh * Tq * S;
  attn_probs_rows<T, TB>(q, k, bias, a, bh, i0, nrows, q_s, kv_s, sc);

  for (int idx = tid; idx < FA_TQ * D; idx += blockDim.x) {
    const int i = idx / D, d = idx % D;
    do_s[idx] = i < nrows ? to_f32(dout[qoff + (size_t)(i0 + i) * D + d]) : 0.f;
  }
  __syncthreads();
  for (int i = warp; i < FA_TQ; i += nwarps) {
    float s = 0.f;
    if (i < nrows)
      for (int d = lane; d < D; d += 32) s = fmaf(do_s[i * D + d], to_f32(out[qoff + (size_t)(i0 + i) * D + d]), s);
    s = warp_sum(s);
    if (lane == 0) delta_s[i] = s;
  }

  // ds = p * (dp * keep - delta), dp = do . v^T; pd = p * keep
  const unsigned int seed = dp.seed + (unsigned int)bh * FA_SALT_BH;
  for (int s0 = 0; s0 < Sp; s0 += FA_KT) {
    __syncthreads();
    for (int idx = tid; idx < FA_KT * D; idx += blockDim.x) {
      const int s = idx / D, d = idx % D;
      kv_s[s * Dp + d] = (s0 + s < S) ? to_f32(v[koff + (size_t)(s0 + s) * D + d]) : 0.f;
    }
    __syncthreads();
    for (int idx = tid; idx < FA_TQ * FA_KT; idx += blockDim.x) {
      const int i = idx / FA_KT, sl = idx % FA_KT;
      const int s = s0 + sl;
      float dsv = 0.f;
      if (i < nrows && s < S) {
        const float* dor = do_s + i * D;
        const float* vr = kv_s + sl * Dp;
        float dpv = 0.f;
        for (int d = 0; d < D; ++d) dpv = fmaf(dor[d], vr[d], dpv);
        const float p = sc[i * Sp + s];
        float pd = p;
        if (dp.on) {
          const float keep = dropout_keep(dp, seed, i0 + i, s);
          pd = p * keep;
          dpv = dpv * keep;
        }
        const size_t off = soff + (size_t)(i0 + i) * S + s;
        pd_o[off] = pd;
        const float ds32 = p * (dpv - delta_s[i]);
        if (dbias != nullptr) dbias[off] = ds32;
        const T dsr = from_f32<T>(ds32);
        ds_o[off] = dsr;
        dsv = to_f32(dsr);
      }
      sc[i * Sp + s] = dsv;
    }
  }

  // dq = ds . k
  float acc[FA_OUT_PT];
#pragma unroll
  for (int j = 0; j < FA_OUT_PT; ++j) acc[j] = 0.f;
  rows_times<T>(sc, k, koff, S, D, kv_s, acc);
#pragma unroll
  for (int j = 0; j < FA_OUT_PT; ++j) {
    const int o = tid + j * blockDim.x;
    if (o < FA_TQ * D) {
      const int i = o / D, d = o % D;
      if (i < nrows) dq[qoff + (size_t)(i0 + i) * D + d] = from_f32<T>(acc[j]);
    }
  }
}

// Pass 2: dk = ds^T . q and dv = pd^T . do for FA_KVT keys of one (b.h).
template <typename T>
__global__ void attention_bwd_kv_kernel(const T* __restrict__ q, const T* __restrict__ dout, const T* __restrict__ ds,
                                        const float* __restrict__ pd, T* __restrict__ dk, T* __restrict__ dv, int Tq,
                                        int S, int D) {
  __shared__ float ds_s[FA_RC][FA_KVT + 1];
  __shared__ float pd_s[FA_RC][FA_KVT + 1];
  extern __shared__ float smem[];
  float* q_s = smem;              // [FA_RC][D]
  float* do_s = q_s + FA_RC * D;  // [FA_RC][D]
  const int tid = threadIdx.x;
  const int bh = blockIdx.y, s0 = blockIdx.x * FA_KVT;
  const size_t qoff = (size_t)bh * Tq * D, soff = (size_t)bh * Tq * S;
  float ak[FA_KV_PT], av[FA_KV_PT];
#pragma unroll
  for (int j = 0; j < FA_KV_PT; ++j) ak[j] = av[j] = 0.f;
  for (int r0 = 0; r0 < Tq; r0 += FA_RC) {
    __syncthreads();
    for (int idx = tid; idx < FA_RC * FA_KVT; idx += blockDim.x) {
      const int r = idx / FA_KVT, sl = idx % FA_KVT;
      const bool ok = r0 + r < Tq && s0 + sl < S;
      const size_t off = soff + (size_t)(r0 + r) * S + s0 + sl;
      ds_s[r][sl] = ok ? to_f32(ds[off]) : 0.f;
      pd_s[r][sl] = ok ? pd[off] : 0.f;
    }
    for (int idx = tid; idx < FA_RC * D; idx += blockDim.x) {
      const int r = idx / D, d = idx % D;
      const bool ok = r0 + r < Tq;
      q_s[idx] = ok ? to_f32(q[qoff + (size_t)(r0 + r) * D + d]) : 0.f;
      do_s[idx] = ok ? to_f32(dout[qoff + (size_t)(r0 + r) * D + d]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < FA_KV_PT; ++j) {
      const int o = tid + j * blockDim.x;
      if (o < FA_KVT * D) {
        const int sl = o / D, d = o % D;
        float a1 = ak[j], a2 = av[j];
        for (int r = 0; r < FA_RC; ++r) {
          a1 = fmaf(ds_s[r][sl], q_s[r * D + d], a1);
          a2 = fmaf(pd_s[r][sl], do_s[r * D + d], a2);
        }
        ak[j] = a1;
        av[j] = a2;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < FA_KV_PT; ++j) {
    const int o = tid + j * blockDim.x;
    if (o < FA_KVT * D) {
      const int sl = o / D, d = o % D;
      if (s0 + sl < S) {
        const size_t off = (size_t)bh * S * D + (size_t)(s0 + sl) * D + d;
        dk[off] = from_f32<T>(ak[j]);
        dv[off] = from_f32<T>(av[j]);
      }
    }
  }
}

inline size_t fa_fwd_smem(int S, int D) {
  return (size_t)(FA_TQ * D + FA_KT * (D + 1) + FA_TQ * fa_sp(S)) * sizeof(float);
}

template <typename T, typename TB>
int launch_attention(const void* q, const void* k, const void* v, const void* bias, void* out, int BH,
                     const AttnArgs& a, Dropout dp, cudaStream_t stream) {
  const size_t smem = fa_fwd_smem(a.S, a.D);
  cudaError_t err = allow_smem(attention_fwd_kernel<T, TB>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.T + FA_TQ - 1) / FA_TQ, BH);
  attention_fwd_kernel<T, TB><<<grid, FA_THREADS, smem, stream>>>((const T*)q, (const T*)k, (const T*)v,
                                                                  (const TB*)bias, (T*)out, a, dp);
  return (int)cudaGetLastError();
}

template <typename T, typename TB>
int launch_attention_bwd(const void* q, const void* k, const void* v, const void* bias, const void* out,
                         const void* dout, void* ds, void* pd, void* dbias, void* dq, void* dk, void* dv, int BH,
                         const AttnArgs& a, Dropout dp, cudaStream_t stream) {
  const size_t smem = fa_fwd_smem(a.S, a.D) + (size_t)(FA_TQ * a.D + FA_TQ) * sizeof(float);
  cudaError_t err = allow_smem(attention_bwd_rows_kernel<T, TB>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.T + FA_TQ - 1) / FA_TQ, BH);
  attention_bwd_rows_kernel<T, TB><<<grid, FA_THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const TB*)bias, (const T*)out, (const T*)dout, (T*)ds, (float*)pd,
      (float*)dbias, (T*)dq, a, dp);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const size_t smem_kv = (size_t)2 * FA_RC * a.D * sizeof(float);
  if ((err = allow_smem(attention_bwd_kv_kernel<T>, smem_kv)) != cudaSuccess) return (int)err;
  dim3 grid_kv((a.S + FA_KVT - 1) / FA_KVT, BH);
  attention_bwd_kv_kernel<T><<<grid_kv, FA_THREADS, smem_kv, stream>>>(
      (const T*)q, (const T*)dout, (const T*)ds, (const float*)pd, (T*)dk, (T*)dv, a.T, a.S, a.D);
  return (int)cudaGetLastError();
}

// The f32 kernels; dtype is the code of q/k/v (kF32 here) plus 2 x the code of the bias.
template <template <typename, typename> class F, typename... Args>
int dispatch_f32(int dtype, Args... args) {
  switch (dtype) {
    case kF32 + 2 * kF32: return F<float, float>::run(args...);
    case kF32 + 2 * kBF16: return F<float, __nv_bfloat16>::run(args...);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T, typename TB>
struct Fwd {
  template <typename... Args>
  static int run(Args... args) { return launch_attention<T, TB>(args...); }
};

template <typename T, typename TB>
struct Bwd {
  template <typename... Args>
  static int run(Args... args) { return launch_attention_bwd<T, TB>(args...); }
};

}  // namespace tfasr

// q [BH, T, D], k/v [BH, S, D] of one dtype; bias [BH or 1, T, S] (its own
// dtype; bias_bh 1 broadcasts it); out [BH, T, D]; stats [2, BH, T] f32 (the
// rows' softmax max m, then sum l) or NULL. Dropout on the probabilities with seed,
// threshold and keep scale. D <= 128. dtype: the code of q/k/v (kF32, kBF16)
// plus 2 x the code of the bias; bf16 q/k/v run the tensor-core kernels.
extern "C" int tfasr_attention(const void* q, const void* k, const void* v, const void* bias, void* out, float* stats, int BH, int T, int S,
                               int D, int bias_bh, unsigned int seed, unsigned int thresh, float keep_scale, int drop_on, int dtype,
                               void* stream) {
  using namespace tfasr;
  if (D > FA_THREADS * FA_OUT_PT / FA_TQ) return (int)cudaErrorInvalidValue;
  const Dropout dp{seed, thresh, keep_scale, drop_on};
  if (dtype % 2 == kBF16)
    return launch_attention_mma(q, k, v, bias, dtype / 2 == kBF16, out, stats, BH, T, S, D, bias_bh, dp, (cudaStream_t)stream);
  const AttnArgs a{T, S, D, bias_bh == 1 ? (size_t)0 : (size_t)T * S, stats, BH};
  return dispatch_f32<Fwd>(dtype, q, k, v, bias, out, BH, a, dp, (cudaStream_t)stream);
}

// Gradients of tfasr_attention: out is its output and stats its row
// statistics, dout [BH, T, D]; dbias [BH, T, S] f32 or NULL; dq [BH, T, D],
// dk, dv [BH, S, D] in the input dtype. Scratch: bf16 reads stats and uses
// delta [BH, T] f32; f32 recomputes the statistics and uses ds [BH, T, S]
// (input dtype) and pd [BH, T, S] f32 (the others may be NULL).
extern "C" int tfasr_attention_bwd(const void* q, const void* k, const void* v, const void* bias, const void* out, const void* dout,
                                   const float* stats, float* delta, void* ds, void* pd, void* dbias, void* dq, void* dk, void* dv, int BH,
                                   int T, int S, int D, int bias_bh, unsigned int seed, unsigned int thresh, float keep_scale, int drop_on,
                                   int dtype, void* stream) {
  using namespace tfasr;
  if (D > FA_THREADS * FA_OUT_PT / FA_TQ || FA_KVT * D > FA_THREADS * FA_KV_PT) return (int)cudaErrorInvalidValue;
  const Dropout dp{seed, thresh, keep_scale, drop_on};
  if (dtype % 2 == kBF16)
    return launch_attention_mma_bwd(q, k, v, bias, dtype / 2 == kBF16, out, dout, stats, delta, (float*)dbias, dq, dk, dv, BH, T, S, D, bias_bh,
                                    dp, (cudaStream_t)stream);
  const AttnArgs a{T, S, D, bias_bh == 1 ? (size_t)0 : (size_t)T * S, nullptr, BH};
  return dispatch_f32<Bwd>(dtype, q, k, v, bias, out, dout, ds, pd, dbias, dq, dk, dv, BH, a, dp, (cudaStream_t)stream);
}
