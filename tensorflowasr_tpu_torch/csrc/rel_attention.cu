// Transformer-XL relative attention forward, fully fused: content scores
// qc.k^T + the relative term qp.pos^T read at its shifted column, the
// Keras -1e9 mask merge, f32 softmax and P.V.
//
// Counterpart of tensorflowasr_tpu/ops/pallas/attention_kernel.py
// fused_rel_attention (kernel B, forward). One block owns AT_TQ query rows
// of one (batch, head). Key tiles and the window of relative positions
// those rows read are staged in shared memory; the rel shift is index
// arithmetic, rel[i, s] = qp[i] . pos[s + (T-1-i) + extra] (0 where that
// index is >= R), so no [T, R] product is ever formed. The row's whole
// score vector stays in shared memory: the softmax is two-pass, and the
// normalised probabilities are rounded to v's type before P.V exactly as
// the reference rounds them.
#include "common.cuh"

namespace tfasr {

constexpr int AT_TQ = 16;       // query rows per block
constexpr int AT_KT = 64;       // key columns per tile
constexpr int AT_OUT_PT = 4;    // output accumulators per thread: AT_TQ * D <= blockDim * AT_OUT_PT
constexpr float NEG_PAD = -1e30f;

template <typename T>
__global__ void rel_attention_fwd_kernel(const T* __restrict__ qc, const T* __restrict__ qp, const T* __restrict__ k,
                                         const T* __restrict__ v, const T* __restrict__ pos,
                                         const float* __restrict__ kv_bias, const int* __restrict__ q_len,
                                         T* __restrict__ out, int H, int Tq, int S, int R, int D, int extra, int causal,
                                         int has_chunk, int chunk, int history) {
  extern __shared__ float smem[];
  const int Dp = D + 1;  // odd row stride: column reads across threads hit distinct banks
  const int Sp = ((S + AT_KT - 1) / AT_KT) * AT_KT;
  float* qc_s = smem;                            // [AT_TQ][D]
  float* qp_s = qc_s + AT_TQ * D;                // [AT_TQ][D]
  float* kv_s = qp_s + AT_TQ * D;                // [AT_KT][Dp] key tile, later value tile
  float* pos_s = kv_s + AT_KT * Dp;              // [AT_KT + AT_TQ - 1][Dp]
  float* sc = pos_s + (AT_KT + AT_TQ - 1) * Dp;  // [AT_TQ][Sp] scores, then probabilities

  const int tid = threadIdx.x;
  const int bh = blockIdx.y, b = bh / H;
  const int i0 = blockIdx.x * AT_TQ;
  const int nrows = min(AT_TQ, Tq - i0);
  const int i_last = i0 + nrows - 1;
  const size_t qoff = (size_t)bh * Tq * D, koff = (size_t)bh * S * D, poff = (size_t)bh * R * D;

  for (int idx = tid; idx < AT_TQ * D; idx += blockDim.x) {
    const int i = idx / D, d = idx % D;
    const bool ok = i < nrows;
    qc_s[idx] = ok ? to_f32(qc[qoff + (size_t)(i0 + i) * D + d]) : 0.f;
    qp_s[idx] = ok ? to_f32(qp[qoff + (size_t)(i0 + i) * D + d]) : 0.f;
  }
  const int qlen = q_len != nullptr ? q_len[b] : Tq;
  const bool vis = causal || has_chunk;
  const bool has_add = kv_bias != nullptr || vis;
  const int hist = history < 0 ? S : history;

  for (int s0 = 0; s0 < Sp; s0 += AT_KT) {
    __syncthreads();
    for (int idx = tid; idx < AT_KT * D; idx += blockDim.x) {
      const int s = idx / D, d = idx % D;
      kv_s[s * Dp + d] = (s0 + s < S) ? to_f32(k[koff + (size_t)(s0 + s) * D + d]) : 0.f;
    }
    // rows i0..i_last and columns s0..s0+AT_KT-1 read positions
    // [p_base, p_base + npos)
    const int p_base = s0 + (Tq - 1 - i_last) + extra;
    const int npos = AT_KT + (i_last - i0);
    for (int idx = tid; idx < npos * D; idx += blockDim.x) {
      const int pr = idx / D, d = idx % D;
      const int p = p_base + pr;
      pos_s[pr * Dp + d] = (p < R) ? to_f32(pos[poff + (size_t)p * D + d]) : 0.f;
    }
    __syncthreads();
    for (int idx = tid; idx < AT_TQ * AT_KT; idx += blockDim.x) {
      const int i = idx / AT_KT, sl = idx % AT_KT;
      if (i >= nrows) continue;
      const int s = s0 + sl;
      float val = NEG_PAD;
      if (s < S) {
        const float* qr = qc_s + i * D;
        const float* kr = kv_s + sl * Dp;
        float c = 0.f;
        for (int d = 0; d < D; ++d) c = fmaf(qr[d], kr[d], c);
        const int row = i0 + i;
        const int p = s + (Tq - 1 - row) + extra;
        float rel = 0.f;
        if (p < R) {
          const float* pr = pos_s + (p - p_base) * Dp;
          const float* qpr = qp_s + i * D;
          for (int d = 0; d < D; ++d) rel = fmaf(qpr[d], pr[d], rel);
        }
        val = c + rel;
        // Keras-parity merge (attention_kernel._rel_scores): column terms
        // clamp at -1e9; an invalid query row adds -1e9 to every column.
        const bool qvalid = row < qlen;
        if (has_add) {
          float add = kv_bias != nullptr ? kv_bias[(size_t)b * S + s] : 0.f;
          if (vis) {
            const int frame = s - (S - Tq);
            bool allowed = true;
            if (causal) allowed = frame <= row;
            if (has_chunk) {
              const int cs = (row / chunk) * chunk;
              allowed = allowed && frame >= cs - hist && frame < cs + chunk;
            }
            add = add + (allowed ? 0.f : -1e9f);
          }
          add = fmaxf(add, -1e9f);
          if (!qvalid) add = -1e9f;
          val = val + add;
        } else if (!qvalid) {
          val = val + -1e9f;
        }
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
    for (int s = lane; s < S; s += 32) row[s] = round_to<T>(row[s] / l);
  }

  float acc[AT_OUT_PT];
#pragma unroll
  for (int j = 0; j < AT_OUT_PT; ++j) acc[j] = 0.f;
  for (int s0 = 0; s0 < S; s0 += AT_KT) {
    const int ns = min(AT_KT, S - s0);
    __syncthreads();
    for (int idx = tid; idx < AT_KT * D; idx += blockDim.x) {
      const int s = idx / D, d = idx % D;
      kv_s[s * Dp + d] = (s < ns) ? to_f32(v[koff + (size_t)(s0 + s) * D + d]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < AT_OUT_PT; ++j) {
      const int o = tid + j * blockDim.x;
      if (o < AT_TQ * D) {
        const int i = o / D, d = o % D;
        const float* pr = sc + i * Sp + s0;
        float a = acc[j];
        for (int sl = 0; sl < ns; ++sl) a = fmaf(pr[sl], kv_s[sl * Dp + d], a);
        acc[j] = a;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < AT_OUT_PT; ++j) {
    const int o = tid + j * blockDim.x;
    if (o < AT_TQ * D) {
      const int i = o / D, d = o % D;
      if (i < nrows) out[qoff + (size_t)(i0 + i) * D + d] = from_f32<T>(acc[j]);
    }
  }
}

template <typename T>
int launch_rel_attention(const void* qc, const void* qp, const void* k, const void* v, const void* pos,
                         const void* kv_bias, const void* q_len, void* out, int BH, int H, int Tq, int S, int R, int D,
                         int extra, int causal, int has_chunk, int chunk, int history, int threads, size_t smem,
                         cudaStream_t stream) {
  cudaError_t err = allow_smem(rel_attention_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Tq + AT_TQ - 1) / AT_TQ, BH);
  rel_attention_fwd_kernel<T><<<grid, threads, smem, stream>>>(
      (const T*)qc, (const T*)qp, (const T*)k, (const T*)v, (const T*)pos, (const float*)kv_bias, (const int*)q_len,
      (T*)out, H, Tq, S, R, D, extra, causal, has_chunk, chunk, history);
  return (int)cudaGetLastError();
}

}  // namespace tfasr

// qc/qp [BH, T, D], k/v [BH, S, D], pos [BH, R, D] of one dtype;
// kv_bias [B, S] f32 or NULL; q_len [B] int32 or NULL; out [BH, T, D].
extern "C" int tfasr_rel_attention(const void* qc, const void* qp, const void* k, const void* v, const void* pos,
                                   const void* kv_bias, const void* q_len, void* out, int BH, int H, int Tq, int S,
                                   int R, int D, int extra, int causal, int has_chunk, int chunk, int history,
                                   int dtype, void* stream) {
  using namespace tfasr;
  const int threads = 256;
  const int Sp = ((S + AT_KT - 1) / AT_KT) * AT_KT;
  const size_t smem =
      (size_t)(2 * AT_TQ * D + AT_KT * (D + 1) + (AT_KT + AT_TQ - 1) * (D + 1) + AT_TQ * Sp) * sizeof(float);
  if (dtype == kBF16)
    return launch_rel_attention<__nv_bfloat16>(qc, qp, k, v, pos, kv_bias, q_len, out, BH, H, Tq, S, R, D, extra,
                                               causal, has_chunk, chunk, history, threads, smem,
                                               (cudaStream_t)stream);
  return launch_rel_attention<float>(qc, qp, k, v, pos, kv_bias, q_len, out, BH, H, Tq, S, R, D, extra, causal,
                                     has_chunk, chunk, history, threads, smem, (cudaStream_t)stream);
}
