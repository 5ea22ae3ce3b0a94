// Transformer-XL relative attention, fully fused: content scores qc.k^T +
// the relative term qp.pos^T read at its shifted column, the Keras -1e9
// mask merge, f32 softmax, probability dropout and P.V; and its backward.
// This file holds the f32 kernels (CUDA cores) and the C entry points; bf16
// inputs go to the tensor-core kernels of rel_attention_mma.cu.
//
// Counterpart of tensorflowasr_tpu/ops/pallas/attention_kernel.py
// fused_rel_attention (kernel B). Forward: one block owns AT_TQ query rows
// of one (batch, head). Key tiles and the window of relative positions those
// rows read are staged in shared memory; the rel shift is index arithmetic,
// rel[i, s] = qp[i] . pos[s + (T-1-i) + extra] (0 where that index is >= R),
// so no [T, R] product is ever formed. The row's whole score vector stays in
// shared memory: the softmax is two-pass, and the normalised probabilities
// (times the dropout keep factor, the counter hash of common.cuh indexed by
// (row, column) under the per-(b.h) seed seed + bh * 40499 as in JAX) are
// rounded to v's type before P.V exactly as the reference rounds them.
//
// Backward (replaces _rel_bwd_kernel / _rel_vjp_bwd, attention_kernel.py
// :406-449, 560-612), three passes:
//  1. rel_attention_bwd_rows_kernel, per (b.h, AT_TQ query rows): recompute
//     the score rows and their softmax (the whole row is resident, so the
//     statistics are recomputed, not stored), dp = do . v^T, the mask,
//     ds = p * (dp * keep - delta) with delta = sum(do * out) from the saved
//     output (the value the reference recomputes), then dqc = ds . k and
//     dqp[i] = sum_s ds[i, s] pos[s + T-1-i + extra] with the forward's
//     window staging. ds (rounded to the input type, as every product of the
//     reference reads it) and the dropped probabilities pd (f32) go to
//     device memory.
//  2. rel_attention_bwd_kv_kernel, per (b.h, AT_KT keys): dk = ds^T . qc,
//     dv = pd^T . do, summing all query rows in order.
//  3. rel_attention_bwd_pos_kernel, per (b.h, AT_KT positions): dpos[p] =
//     sum_i ds[i, p - (T-1-i) - extra] qp[i], the diagonal scatter of the
//     rel term read as a gather, so no two blocks write one row.
// The TPU holds the whole [T, S] tile of one (b.h) in VMEM; the card's
// blocks hold 16 rows, so the score-shaped ds and pd pass through device
// memory once (bf16 ds + f32 pd: ~61 MB at b.h 64, T = S = 400). What
// bounds it: the f32 products on the CUDA cores, 16 b.h T S D operations
// (~5.9 GFLOP at b.h 64, T = S = 400, D = 36; ~3.7 of them in pass 1),
// well above the time those bytes take (~40 us at 3.35 TB/s).
#include "common.cuh"

namespace tfasr {

constexpr int AT_TQ = 16;       // query rows per block
constexpr int AT_KT = 64;       // key columns (or positions) per tile
// Accumulators per thread, a template argument: OPT outputs (AT_TQ * D <= blockDim * OPT) in the forward and pass 1,
// KVPT in passes 2 and 3 (AT_KT * D <= blockDim * KVPT): 4 and 16 up to head 64, 8 and 32 up to head 128.
constexpr int AT_D_SMALL = 64;
constexpr int AT_RC = 32;       // query rows per staged chunk in passes 2 and 3
constexpr float NEG_PAD = -1e30f;
constexpr unsigned int AT_SALT_BH = 40499u;  // per-(b.h) seed salt of the JAX kernel

struct RelArgs {
  int H, Tq, S, R, D, extra, causal, has_chunk, chunk, history;
};

// Stage the block's query rows and compute their scores into sc [AT_TQ][Sp]
// (NEG_PAD past S), then softmax each row in place: sc holds the f32
// normalised probabilities on return. Shared by the forward and pass 1.
template <typename T>
__device__ void rel_probs_rows(const T* qc, const T* qp, const T* k, const T* pos, const float* kv_bias,
                               const int* q_len, const RelArgs& a, int bh, int i0, int nrows, float* qc_s,
                               float* qp_s, float* kv_s, float* pos_s, float* sc) {
  const int D = a.D, Tq = a.Tq, S = a.S, R = a.R;
  const int Dp = D + 1;
  const int Sp = ((S + AT_KT - 1) / AT_KT) * AT_KT;
  const int tid = threadIdx.x;
  const int b = bh / a.H;
  const int i_last = i0 + nrows - 1;
  const size_t qoff = (size_t)bh * Tq * D, koff = (size_t)bh * S * D, poff = (size_t)bh * R * D;

  for (int idx = tid; idx < AT_TQ * D; idx += blockDim.x) {
    const int i = idx / D, d = idx % D;
    const bool ok = i < nrows;
    qc_s[idx] = ok ? to_f32(qc[qoff + (size_t)(i0 + i) * D + d]) : 0.f;
    qp_s[idx] = ok ? to_f32(qp[qoff + (size_t)(i0 + i) * D + d]) : 0.f;
  }
  const int qlen = q_len != nullptr ? q_len[b] : Tq;
  const bool vis = a.causal || a.has_chunk;
  const bool has_add = kv_bias != nullptr || vis;
  const int hist = a.history < 0 ? S : a.history;

  for (int s0 = 0; s0 < Sp; s0 += AT_KT) {
    __syncthreads();
    for (int idx = tid; idx < AT_KT * D; idx += blockDim.x) {
      const int s = idx / D, d = idx % D;
      kv_s[s * Dp + d] = (s0 + s < S) ? to_f32(k[koff + (size_t)(s0 + s) * D + d]) : 0.f;
    }
    // rows i0..i_last and columns s0..s0+AT_KT-1 read positions
    // [p_base, p_base + npos)
    const int p_base = s0 + (Tq - 1 - i_last) + a.extra;
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
        const int p = s + (Tq - 1 - row) + a.extra;
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
            if (a.causal) allowed = frame <= row;
            if (a.has_chunk) {
              const int cs = (row / a.chunk) * a.chunk;
              allowed = allowed && frame >= cs - hist && frame < cs + a.chunk;
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
    for (int s = lane; s < S; s += 32) row[s] = row[s] / l;
  }
  __syncthreads();
}

template <typename T, int OPT>
__global__ void rel_attention_fwd_kernel(const T* __restrict__ qc, const T* __restrict__ qp, const T* __restrict__ k,
                                         const T* __restrict__ v, const T* __restrict__ pos,
                                         const float* __restrict__ kv_bias, const int* __restrict__ q_len,
                                         T* __restrict__ out, RelArgs a, Dropout dp) {
  extern __shared__ float smem[];
  const int D = a.D, S = a.S;
  const int Dp = D + 1;  // odd row stride: column reads across threads hit distinct banks
  const int Sp = ((S + AT_KT - 1) / AT_KT) * AT_KT;
  float* qc_s = smem;                            // [AT_TQ][D]
  float* qp_s = qc_s + AT_TQ * D;                // [AT_TQ][D]
  float* kv_s = qp_s + AT_TQ * D;                // [AT_KT][Dp] key tile, later value tile
  float* pos_s = kv_s + AT_KT * Dp;              // [AT_KT + AT_TQ - 1][Dp]
  float* sc = pos_s + (AT_KT + AT_TQ - 1) * Dp;  // [AT_TQ][Sp] scores, then probabilities

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int i0 = blockIdx.x * AT_TQ;
  const int nrows = min(AT_TQ, a.Tq - i0);
  rel_probs_rows<T>(qc, qp, k, pos, kv_bias, q_len, a, bh, i0, nrows, qc_s, qp_s, kv_s, pos_s, sc);

  const unsigned int seed = dp.seed + (unsigned int)bh * AT_SALT_BH;
  for (int idx = tid; idx < nrows * S; idx += blockDim.x) {
    const int i = idx / S, s = idx % S;
    float p = sc[i * Sp + s];
    if (dp.on) p *= dropout_keep(dp, seed, i0 + i, s);
    sc[i * Sp + s] = round_to<T>(p);
  }

  const size_t qoff = (size_t)bh * a.Tq * D, koff = (size_t)bh * S * D;
  float acc[OPT];
#pragma unroll
  for (int j = 0; j < OPT; ++j) acc[j] = 0.f;
  for (int s0 = 0; s0 < S; s0 += AT_KT) {
    const int ns = min(AT_KT, S - s0);
    __syncthreads();
    for (int idx = tid; idx < AT_KT * D; idx += blockDim.x) {
      const int s = idx / D, d = idx % D;
      kv_s[s * Dp + d] = (s < ns) ? to_f32(v[koff + (size_t)(s0 + s) * D + d]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < OPT; ++j) {
      const int o = tid + j * blockDim.x;
      if (o < AT_TQ * D) {
        const int i = o / D, d = o % D;
        const float* pr = sc + i * Sp + s0;
        float acc_j = acc[j];
        for (int sl = 0; sl < ns; ++sl) acc_j = fmaf(pr[sl], kv_s[sl * Dp + d], acc_j);
        acc[j] = acc_j;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < OPT; ++j) {
    const int o = tid + j * blockDim.x;
    if (o < AT_TQ * D) {
      const int i = o / D, d = o % D;
      if (i < nrows) out[qoff + (size_t)(i0 + i) * D + d] = from_f32<T>(acc[j]);
    }
  }
}

// Pass 1: ds, pd to device memory; dqc, dqp written.
template <typename T, int OPT>
__global__ void rel_attention_bwd_rows_kernel(const T* __restrict__ qc, const T* __restrict__ qp,
                                              const T* __restrict__ k, const T* __restrict__ v,
                                              const T* __restrict__ pos, const float* __restrict__ kv_bias,
                                              const int* __restrict__ q_len, const T* __restrict__ out,
                                              const T* __restrict__ dout, T* __restrict__ ds_o,
                                              float* __restrict__ pd_o, T* __restrict__ dqc, T* __restrict__ dqp,
                                              RelArgs a, Dropout dp) {
  extern __shared__ float smem[];
  const int D = a.D, S = a.S, Tq = a.Tq, R = a.R;
  const int Dp = D + 1;
  const int Sp = ((S + AT_KT - 1) / AT_KT) * AT_KT;
  float* qc_s = smem;                            // [AT_TQ][D]
  float* qp_s = qc_s + AT_TQ * D;                // [AT_TQ][D]
  float* kv_s = qp_s + AT_TQ * D;                // [AT_KT][Dp]
  float* pos_s = kv_s + AT_KT * Dp;              // [AT_KT + AT_TQ - 1][Dp]
  float* sc = pos_s + (AT_KT + AT_TQ - 1) * Dp;  // [AT_TQ][Sp] probabilities, then ds
  float* do_s = sc + AT_TQ * Sp;                 // [AT_TQ][D]
  float* delta_s = do_s + AT_TQ * D;             // [AT_TQ]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const int bh = blockIdx.y;
  const int i0 = blockIdx.x * AT_TQ;
  const int nrows = min(AT_TQ, Tq - i0);
  const int i_last = i0 + nrows - 1;
  const size_t qoff = (size_t)bh * Tq * D, koff = (size_t)bh * S * D, poff = (size_t)bh * R * D;
  const size_t soff = (size_t)bh * Tq * S;
  rel_probs_rows<T>(qc, qp, k, pos, kv_bias, q_len, a, bh, i0, nrows, qc_s, qp_s, kv_s, pos_s, sc);

  for (int idx = tid; idx < AT_TQ * D; idx += blockDim.x) {
    const int i = idx / D, d = idx % D;
    do_s[idx] = i < nrows ? to_f32(dout[qoff + (size_t)(i0 + i) * D + d]) : 0.f;
  }
  __syncthreads();
  for (int i = warp; i < AT_TQ; i += nwarps) {
    float s = 0.f;
    if (i < nrows)
      for (int d = lane; d < D; d += 32) s = fmaf(do_s[i * D + d], to_f32(out[qoff + (size_t)(i0 + i) * D + d]), s);
    s = warp_sum(s);
    if (lane == 0) delta_s[i] = s;
  }

  // ds = p * (dp * keep - delta), dp = do . v^T; pd = p * keep
  const unsigned int seed = dp.seed + (unsigned int)bh * AT_SALT_BH;
  for (int s0 = 0; s0 < Sp; s0 += AT_KT) {
    __syncthreads();
    for (int idx = tid; idx < AT_KT * D; idx += blockDim.x) {
      const int s = idx / D, d = idx % D;
      kv_s[s * Dp + d] = (s0 + s < S) ? to_f32(v[koff + (size_t)(s0 + s) * D + d]) : 0.f;
    }
    __syncthreads();
    for (int idx = tid; idx < AT_TQ * AT_KT; idx += blockDim.x) {
      const int i = idx / AT_KT, sl = idx % AT_KT;
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
        const T dsr = from_f32<T>(p * (dpv - delta_s[i]));
        ds_o[off] = dsr;
        dsv = to_f32(dsr);
      }
      sc[i * Sp + s] = dsv;
    }
  }

  // dqc = ds . k
  float acc[OPT];
#pragma unroll
  for (int j = 0; j < OPT; ++j) acc[j] = 0.f;
  for (int s0 = 0; s0 < S; s0 += AT_KT) {
    const int ns = min(AT_KT, S - s0);
    __syncthreads();
    for (int idx = tid; idx < AT_KT * D; idx += blockDim.x) {
      const int s = idx / D, d = idx % D;
      kv_s[s * Dp + d] = (s < ns) ? to_f32(k[koff + (size_t)(s0 + s) * D + d]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < OPT; ++j) {
      const int o = tid + j * blockDim.x;
      if (o < AT_TQ * D) {
        const int i = o / D, d = o % D;
        const float* dr = sc + i * Sp + s0;
        float acc_j = acc[j];
        for (int sl = 0; sl < ns; ++sl) acc_j = fmaf(dr[sl], kv_s[sl * Dp + d], acc_j);
        acc[j] = acc_j;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < OPT; ++j) {
    const int o = tid + j * blockDim.x;
    if (o < AT_TQ * D) {
      const int i = o / D, d = o % D;
      if (i < nrows) dqc[qoff + (size_t)(i0 + i) * D + d] = from_f32<T>(acc[j]);
      acc[j] = 0.f;
    }
  }

  // dqp[i] = sum_s ds[i, s] pos[s + T-1-i + extra] over p < R
  for (int s0 = 0; s0 < S; s0 += AT_KT) {
    const int ns = min(AT_KT, S - s0);
    const int p_base = s0 + (Tq - 1 - i_last) + a.extra;
    const int npos = AT_KT + (i_last - i0);
    __syncthreads();
    for (int idx = tid; idx < npos * D; idx += blockDim.x) {
      const int pr = idx / D, d = idx % D;
      const int p = p_base + pr;
      pos_s[pr * Dp + d] = (p < R) ? to_f32(pos[poff + (size_t)p * D + d]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < OPT; ++j) {
      const int o = tid + j * blockDim.x;
      if (o < AT_TQ * D) {
        const int i = o / D, d = o % D;
        if (i < nrows) {
          const float* dr = sc + i * Sp + s0;
          // row i0+i reads position s + (T-1-row) + extra = p_base + sl + (i_last - row)
          const float* pr = pos_s + (i_last - (i0 + i)) * Dp + d;
          float acc_j = acc[j];
          for (int sl = 0; sl < ns; ++sl) acc_j = fmaf(dr[sl], pr[sl * Dp], acc_j);
          acc[j] = acc_j;
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < OPT; ++j) {
    const int o = tid + j * blockDim.x;
    if (o < AT_TQ * D) {
      const int i = o / D, d = o % D;
      if (i < nrows) dqp[qoff + (size_t)(i0 + i) * D + d] = from_f32<T>(acc[j]);
    }
  }
}

// Pass 2: dk = ds^T . qc and dv = pd^T . do for AT_KT keys of one (b.h).
template <typename T, int KVPT>
__global__ void rel_attention_bwd_kv_kernel(const T* __restrict__ qc, const T* __restrict__ dout,
                                            const T* __restrict__ ds, const float* __restrict__ pd,
                                            T* __restrict__ dk, T* __restrict__ dv, int Tq, int S, int D) {
  __shared__ float ds_s[AT_RC][AT_KT + 1];
  __shared__ float pd_s[AT_RC][AT_KT + 1];
  extern __shared__ float smem[];
  float* q_s = smem;             // [AT_RC][D]
  float* do_s = q_s + AT_RC * D;  // [AT_RC][D]
  const int tid = threadIdx.x;
  const int bh = blockIdx.y, s0 = blockIdx.x * AT_KT;
  const size_t qoff = (size_t)bh * Tq * D, soff = (size_t)bh * Tq * S;
  float ak[KVPT], av[KVPT];
#pragma unroll
  for (int j = 0; j < KVPT; ++j) ak[j] = av[j] = 0.f;
  for (int r0 = 0; r0 < Tq; r0 += AT_RC) {
    __syncthreads();
    for (int idx = tid; idx < AT_RC * AT_KT; idx += blockDim.x) {
      const int r = idx / AT_KT, sl = idx % AT_KT;
      const bool ok = r0 + r < Tq && s0 + sl < S;
      const size_t off = soff + (size_t)(r0 + r) * S + s0 + sl;
      ds_s[r][sl] = ok ? to_f32(ds[off]) : 0.f;
      pd_s[r][sl] = ok ? pd[off] : 0.f;
    }
    for (int idx = tid; idx < AT_RC * D; idx += blockDim.x) {
      const int r = idx / D, d = idx % D;
      const bool ok = r0 + r < Tq;
      q_s[idx] = ok ? to_f32(qc[qoff + (size_t)(r0 + r) * D + d]) : 0.f;
      do_s[idx] = ok ? to_f32(dout[qoff + (size_t)(r0 + r) * D + d]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < KVPT; ++j) {
      const int o = tid + j * blockDim.x;
      if (o < AT_KT * D) {
        const int sl = o / D, d = o % D;
        float a1 = ak[j], a2 = av[j];
        for (int r = 0; r < AT_RC; ++r) {
          a1 = fmaf(ds_s[r][sl], q_s[r * D + d], a1);
          a2 = fmaf(pd_s[r][sl], do_s[r * D + d], a2);
        }
        ak[j] = a1;
        av[j] = a2;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < KVPT; ++j) {
    const int o = tid + j * blockDim.x;
    if (o < AT_KT * D) {
      const int sl = o / D, d = o % D;
      if (s0 + sl < S) {
        const size_t off = (size_t)bh * S * D + (size_t)(s0 + sl) * D + d;
        dk[off] = from_f32<T>(ak[j]);
        dv[off] = from_f32<T>(av[j]);
      }
    }
  }
}

// Pass 3: dpos[p] = sum_i ds[i, p - (T-1-i) - extra] qp[i] for AT_KT positions.
template <typename T, int KVPT>
__global__ void rel_attention_bwd_pos_kernel(const T* __restrict__ qp, const T* __restrict__ ds,
                                             T* __restrict__ dpos, int Tq, int S, int R, int D, int extra) {
  __shared__ float g_s[AT_RC][AT_KT + 1];
  extern __shared__ float smem[];
  float* q_s = smem;  // [AT_RC][D]
  const int tid = threadIdx.x;
  const int bh = blockIdx.y, p0 = blockIdx.x * AT_KT;
  const size_t qoff = (size_t)bh * Tq * D, soff = (size_t)bh * Tq * S;
  float acc[KVPT];
#pragma unroll
  for (int j = 0; j < KVPT; ++j) acc[j] = 0.f;
  for (int r0 = 0; r0 < Tq; r0 += AT_RC) {
    __syncthreads();
    for (int idx = tid; idx < AT_RC * AT_KT; idx += blockDim.x) {
      const int r = idx / AT_KT, pl = idx % AT_KT;
      const int row = r0 + r, p = p0 + pl;
      const int s = p - (Tq - 1 - row) - extra;
      const bool ok = row < Tq && p < R && s >= 0 && s < S;
      g_s[r][pl] = ok ? to_f32(ds[soff + (size_t)row * S + s]) : 0.f;
    }
    for (int idx = tid; idx < AT_RC * D; idx += blockDim.x) {
      const int r = idx / D, d = idx % D;
      q_s[idx] = r0 + r < Tq ? to_f32(qp[qoff + (size_t)(r0 + r) * D + d]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < KVPT; ++j) {
      const int o = tid + j * blockDim.x;
      if (o < AT_KT * D) {
        const int pl = o / D, d = o % D;
        float a1 = acc[j];
        for (int r = 0; r < AT_RC; ++r) a1 = fmaf(g_s[r][pl], q_s[r * D + d], a1);
        acc[j] = a1;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < KVPT; ++j) {
    const int o = tid + j * blockDim.x;
    if (o < AT_KT * D) {
      const int pl = o / D, d = o % D;
      if (p0 + pl < R) dpos[(size_t)bh * R * D + (size_t)(p0 + pl) * D + d] = from_f32<T>(acc[j]);
    }
  }
}

// The bf16 kernels (rel_attention_mma.cu).
int launch_rel_attention_mma(const void* qc, const void* qp, const void* k, const void* v, const void* pos, const void* kv_bias, const void* q_len,
                             void* out, float* stats, int BH, int H, int T, int S, int R, int D, int extra, int causal, int has_chunk, int chunk,
                             int history, Dropout dp, cudaStream_t stream);
int launch_rel_attention_mma_bwd(const void* qc, const void* qp, const void* k, const void* v, const void* pos, const void* kv_bias,
                                 const void* q_len, const void* out, const void* dout, const float* stats, void* ds, void* pd, void* dqc, void* dqp,
                                 void* dk, void* dv, void* dpos, int BH, int H, int T, int S, int R, int D, int extra, int causal, int has_chunk,
                                 int chunk, int history, Dropout dp, cudaStream_t stream);

inline size_t fwd_smem(int S, int D) {
  const int Sp = ((S + AT_KT - 1) / AT_KT) * AT_KT;
  return (size_t)(2 * AT_TQ * D + AT_KT * (D + 1) + (AT_KT + AT_TQ - 1) * (D + 1) + AT_TQ * Sp) * sizeof(float);
}

template <typename T, int OPT>
int launch_rel_attention(const void* qc, const void* qp, const void* k, const void* v, const void* pos,
                         const void* kv_bias, const void* q_len, void* out, int BH, const RelArgs& a, Dropout dp,
                         cudaStream_t stream) {
  const size_t smem = fwd_smem(a.S, a.D);
  cudaError_t err = allow_smem(rel_attention_fwd_kernel<T, OPT>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Tq + AT_TQ - 1) / AT_TQ, BH);
  rel_attention_fwd_kernel<T, OPT><<<grid, 256, smem, stream>>>((const T*)qc, (const T*)qp, (const T*)k, (const T*)v,
                                                               (const T*)pos, (const float*)kv_bias, (const int*)q_len,
                                                               (T*)out, a, dp);
  return (int)cudaGetLastError();
}

template <typename T, int OPT, int KVPT>
int launch_rel_attention_bwd(const void* qc, const void* qp, const void* k, const void* v, const void* pos,
                             const void* kv_bias, const void* q_len, const void* out, const void* dout, void* ds,
                             void* pd, void* dqc, void* dqp, void* dk, void* dv, void* dpos, int BH, const RelArgs& a,
                             Dropout dp, cudaStream_t stream) {
  const size_t smem = fwd_smem(a.S, a.D) + (size_t)(AT_TQ * a.D + AT_TQ) * sizeof(float);
  cudaError_t err = allow_smem(rel_attention_bwd_rows_kernel<T, OPT>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Tq + AT_TQ - 1) / AT_TQ, BH);
  rel_attention_bwd_rows_kernel<T, OPT><<<grid, 256, smem, stream>>>(
      (const T*)qc, (const T*)qp, (const T*)k, (const T*)v, (const T*)pos, (const float*)kv_bias, (const int*)q_len,
      (const T*)out, (const T*)dout, (T*)ds, (float*)pd, (T*)dqc, (T*)dqp, a, dp);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // passes 2 and 3 also hold static tiles, so their dynamic size is always declared (above 48 KB in all at head 128)
  const size_t smem_kv = 2 * AT_RC * a.D * sizeof(float), smem_pos = AT_RC * a.D * sizeof(float);
  if ((err = cudaFuncSetAttribute(rel_attention_bwd_kv_kernel<T, KVPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv)) != cudaSuccess)
    return (int)err;
  dim3 grid_kv((a.S + AT_KT - 1) / AT_KT, BH);
  rel_attention_bwd_kv_kernel<T, KVPT><<<grid_kv, 256, smem_kv, stream>>>(
      (const T*)qc, (const T*)dout, (const T*)ds, (const float*)pd, (T*)dk, (T*)dv, a.Tq, a.S, a.D);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dim3 grid_pos((a.R + AT_KT - 1) / AT_KT, BH);
  rel_attention_bwd_pos_kernel<T, KVPT><<<grid_pos, 256, smem_pos, stream>>>(
      (const T*)qp, (const T*)ds, (T*)dpos, a.Tq, a.S, a.R, a.D, a.extra);
  return (int)cudaGetLastError();
}

}  // namespace tfasr

// qc/qp [BH, T, D], k/v [BH, S, D], pos [BH, R, D] of one dtype;
// kv_bias [B, S] f32 or NULL; q_len [B] int32 or NULL; out [BH, T, D].
// Dropout on the probabilities with seed, threshold and keep scale. bf16
// runs the tensor-core kernels and writes the rows' softmax statistics to
// stats [2, BH, T] f32 (m, then l) unless it is NULL; with out NULL it
// computes only them. f32 ignores stats.
extern "C" int tfasr_rel_attention(const void* qc, const void* qp, const void* k, const void* v, const void* pos,
                                   const void* kv_bias, const void* q_len, void* out, float* stats, int BH, int H, int Tq, int S,
                                   int R, int D, int extra, int causal, int has_chunk, int chunk, int history,
                                   unsigned int seed, unsigned int thresh, float keep_scale, int drop_on, int dtype,
                                   void* stream) {
  using namespace tfasr;
  const RelArgs a{H, Tq, S, R, D, extra, causal, has_chunk, chunk, history};
  const Dropout dp{seed, thresh, keep_scale, drop_on};
  if (dtype == kBF16)
    return launch_rel_attention_mma(qc, qp, k, v, pos, kv_bias, q_len, out, stats, BH, H, Tq, S, R, D, extra, causal, has_chunk, chunk, history,
                                    dp, (cudaStream_t)stream);
  if (D > 2 * AT_D_SMALL) return (int)cudaErrorInvalidValue;
  if (D > AT_D_SMALL) return launch_rel_attention<float, 8>(qc, qp, k, v, pos, kv_bias, q_len, out, BH, a, dp, (cudaStream_t)stream);
  return launch_rel_attention<float, 4>(qc, qp, k, v, pos, kv_bias, q_len, out, BH, a, dp, (cudaStream_t)stream);
}

// Gradients of tfasr_rel_attention: out is its output, dout [BH, T, D];
// dqc, dqp [BH, T, D], dk, dv [BH, S, D], dpos [BH, R, D] in the input
// dtype. Scratch: f32 uses ds [BH, T, S] f32 and pd [BH, T, S] f32; bf16
// reads the forward's stats and uses ds and pd [BH, T, Sp] bf16, Sp = S
// rounded up to 8.
extern "C" int tfasr_rel_attention_bwd(const void* qc, const void* qp, const void* k, const void* v, const void* pos,
                                       const void* kv_bias, const void* q_len, const void* out, const void* dout,
                                       const float* stats, void* ds, void* pd, void* dqc, void* dqp, void* dk, void* dv, void* dpos,
                                       int BH, int H, int Tq, int S, int R, int D, int extra, int causal,
                                       int has_chunk, int chunk, int history, unsigned int seed, unsigned int thresh,
                                       float keep_scale, int drop_on, int dtype, void* stream) {
  using namespace tfasr;
  const RelArgs a{H, Tq, S, R, D, extra, causal, has_chunk, chunk, history};
  const Dropout dp{seed, thresh, keep_scale, drop_on};
  if (dtype == kBF16)
    return launch_rel_attention_mma_bwd(qc, qp, k, v, pos, kv_bias, q_len, out, dout, stats, ds, pd, dqc, dqp, dk, dv, dpos, BH, H, Tq, S, R, D,
                                        extra, causal, has_chunk, chunk, history, dp, (cudaStream_t)stream);
  if (D > 2 * AT_D_SMALL) return (int)cudaErrorInvalidValue;
  if (D > AT_D_SMALL)
    return launch_rel_attention_bwd<float, 8, 32>(qc, qp, k, v, pos, kv_bias, q_len, out, dout, ds, pd, dqc, dqp, dk, dv, dpos, BH, a, dp,
                                                  (cudaStream_t)stream);
  return launch_rel_attention_bwd<float, 4, 16>(qc, qp, k, v, pos, kv_bias, q_len, out, dout, ds, pd, dqc, dqp, dk, dv, dpos, BH, a, dp,
                                                (cudaStream_t)stream);
}
