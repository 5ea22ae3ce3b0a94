// Fused transducer joint + RNN-T loss statistics, forward and backward, for
// the add/tanh joint with both prejoint linears:
//   a[b,t,u]      = tanh(enc_p[b,t] + pred_p[b,u])                (in E: bf16 or f32)
//   logits[b,t,u] = a[b,t,u] . Wv^T + bv                          ([V], f32 accumulation)
// forward:  lse, lp_blank = logits[0] - lse, lp_emit = logits[label[b,u]] - lse
//           (LOG_0 at u = U), each [B, T, U+1] f32;
// backward: with gbl, gem (the DP's gradients of lp_blank/lp_emit, already
//           scaled by the upstream cotangent):
//   dlog = 1[v=0] gbl + 1[v=label] gem - softmax (gbl + gem)
//   dWv = sum_cells dlog(in E)^T a,  dbv = sum_cells dlog,  da = dlog . Wv (f32)
//   dz = da (1 - a^2),  d_enc_p[b,t] = sum_u dz,  d_pred_p[b,u] = sum_t dz.
// The [B, T, U+1, V] logits never reach device memory.
//
// Replaces tensorflowasr_tpu/ops/pallas/joint_loss_kernel.py
// rnnt_loss_fused_joint: _joint_logprobs (_fwd_kernel) and _joint_backward
// (_bwd_kernel). The vocab weight comes in the port's layout, Wv [V, J] (the
// Pallas kernel's WvT). Not carried over: the lane-major statistics
// orientation, J/U/V padding to 128/16 multiples (J is zero-padded to 16
// here, rows and vocab columns are masked), the TFASR_FUSED_TT knob and the
// +1e9 lse padding.
//
// This file holds the f32 parity path, on the CUDA cores: with f32 inputs
// (the JAX kernel's HIGHEST products) every product is an f32 fmaf loop.
// bf16 inputs go to the tensor-core kernels of joint_loss_mma.cu, which the
// C entry points below dispatch to.
//
// joint_fwd_kernel: one block per FR consecutive cells of the flattened
// [B*T*(U+1)] lattice. The a tile stays in shared memory; Wv is streamed in
// FV-row chunks, each chunk's logits go to shared memory and fold into a
// per-row online max / sum-of-exp (one warp per row).
//
// The backward is three passes, because three of its sums run across
// blocks, which the TPU accumulates in output blocks revisited by a
// sequential grid and the card cannot (no order between blocks). No
// atomics: every partial has one owner and the partials are summed in a
// fixed order (launch_sum_partials, row_reduce.cu), so gradients repeat bit
// for bit from run to run.
//  - joint_bwd_rows_kernel: block (u tile of BR label positions, chunk of
//    JL_TT frames, b). Per frame it recomputes a and the logits chunk by
//    chunk, forms dlog and accumulates da in shared memory, then dz; it
//    writes the frame's d_enc_p partial over its u tile and keeps the
//    d_pred_p partial over its frames in shared memory, written once.
//  - joint_bwd_weight_kernel: block (vocab chunk of WV rows, range of cells),
//    about one block per SM: its Wv chunk stays in shared memory, and it
//    loops over its cells' tiles recomputing a, the logits and dlog for its
//    chunk only (lse is saved by the forward), accumulating dWv[chunk] in
//    shared memory and dbv[chunk] in registers.
//  - the fixed-order sums of the partials.
// What bounds it: the f32 products on the CUDA cores (forward 2·B·T·(U+1)·J·V
// operations, backward three times that and the logits once more); J <= 384
// and a multiple of 8.
#include "common.cuh"

namespace tfasr {

constexpr float JL_NEG = -1e30f;  // LOG_0
constexpr float JL_NINF = -3.0e38f;  // below every logit: the empty running max
constexpr int JL_TT = 16;         // frames per block of the backward rows kernel
constexpr int JL_SMS = 132;       // the H100's SMs: the weight pass runs about one block per SM

template <typename E>
struct JL;
template <>
struct JL<float> {
  static constexpr int FR = 32, FV = 32;  // forward: cells per block, vocab rows per chunk
  static constexpr int BR = 16, BV = 32;  // backward rows: label positions per block, vocab rows per chunk
  static constexpr int WR = 16, WV = 32;  // backward weight: cells per tile, vocab rows per block
  static constexpr int PAD = 4;           // row padding of the shared-memory tiles
};

__host__ __device__ inline int round16(int x) { return (x + 15) / 16 * 16; }

template <typename X>
__device__ __forceinline__ X* carve(unsigned char*& p, size_t n) {
  X* out = reinterpret_cast<X*>(p);
  p += (n * sizeof(X) + 127) / 128 * 128;
  return out;
}

template <typename X>
__host__ __device__ inline size_t carved(size_t n) {
  return (n * sizeof(X) + 127) / 128 * 128;
}

// C[M][N] (+)= sum_k A(m,k) B(k,n) over shared-memory operands, the whole
// block. A(m,k) = A[m*lda + k], or A[k*lda + m] with A_COL; B(k,n) =
// B[k*ldb + n], or B[n*ldb + k] with B_COL.
template <bool A_COL, bool B_COL>
__device__ void mm(const float* A, int lda, const float* B, int ldb, float* C, int ldc, int M, int N, int K,
                   bool accumulate) {
  for (int o = threadIdx.x; o < M * N; o += blockDim.x) {
    const int m = o / N, n = o % N;
    float s = accumulate ? C[(size_t)m * ldc + n] : 0.f;
    for (int k = 0; k < K; ++k)
      s = fmaf(A_COL ? A[(size_t)k * lda + m] : A[(size_t)m * lda + k], B_COL ? B[(size_t)n * ldb + k] : B[(size_t)k * ldb + n], s);
    C[(size_t)m * ldc + n] = s;
  }
}

// The tiles below move 16 bytes (8 bf16 or 4 f32 values) at a time: J is a
// multiple of 8 and the tensors are 16-byte aligned (checked by the wrapper).
template <typename E>
struct Vec16 {
  static constexpr int N = 16 / sizeof(E);
};

// a_s[i][j] = tanh(enc_p[b(i), t(i), j] + pred_p[b(i), u(i), j]) rounded to E
// (0 for an invalid row or j >= J); enc_row[i], pred_row[i] are row offsets
// or -1 for an invalid row.
template <typename E>
__device__ void build_a(E* a_s, int lda, const E* enc, const E* pred, const long long* enc_row,
                        const long long* pred_row, int rows, int J, int Jp) {
  constexpr int N = Vec16<E>::N;
  const int nv = Jp / N;
  for (int o = threadIdx.x; o < rows * nv; o += blockDim.x) {
    const int i = o / nv, j = (o % nv) * N;
    uint4 ev = make_uint4(0, 0, 0, 0), pv = ev, out;
    if (j < J && enc_row[i] >= 0) {
      ev = *reinterpret_cast<const uint4*>(enc + enc_row[i] + j);
      pv = *reinterpret_cast<const uint4*>(pred + pred_row[i] + j);
    }
    const E* e = reinterpret_cast<const E*>(&ev);
    const E* q = reinterpret_cast<const E*>(&pv);
    E* a = reinterpret_cast<E*>(&out);
#pragma unroll
    for (int k = 0; k < N; ++k) a[k] = from_f32<E>(tanhf(round_to<E>(to_f32(e[k]) + to_f32(q[k]))));
    *reinterpret_cast<uint4*>(a_s + (size_t)i * lda + j) = out;
  }
}

// w_s[v][j] = Wv[v0 + v, j] (0 past V or J)
template <typename E>
__device__ void stage_w(E* w_s, int lda, const E* wv, int v0, int rows, int V, int J, int Jp) {
  constexpr int N = Vec16<E>::N;
  const int nv = Jp / N;
  for (int o = threadIdx.x; o < rows * nv; o += blockDim.x) {
    const int v = o / nv, j = (o % nv) * N;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (v0 + v < V && j < J) x = *reinterpret_cast<const uint4*>(wv + (size_t)(v0 + v) * J + j);
    *reinterpret_cast<uint4*>(w_s + (size_t)v * lda + j) = x;
  }
}

// ----------------------------------- forward ----------------------------------- //

template <typename E>
__global__ void joint_fwd_kernel(const E* __restrict__ enc, const E* __restrict__ pred, const E* __restrict__ wv,
                                 const float* __restrict__ bv, const int* __restrict__ labels,
                                 float* __restrict__ lpb, float* __restrict__ lpe, float* __restrict__ lse, int B,
                                 int T, int U1, int J, int V) {
  typedef JL<E> C;
  extern __shared__ __align__(128) unsigned char smem[];
  const int Jp = round16(J), lda = Jp + C::PAD, ldl = C::FV + 4;
  unsigned char* p = smem;
  E* a_s = carve<E>(p, (size_t)C::FR * lda);
  E* w_s = carve<E>(p, (size_t)C::FV * lda);
  float* lg = carve<float>(p, (size_t)C::FR * ldl);
  float* m_s = carve<float>(p, C::FR);
  float* s_s = carve<float>(p, C::FR);
  float* blank_s = carve<float>(p, C::FR);
  float* lab_s = carve<float>(p, C::FR);
  int* labid = carve<int>(p, C::FR);
  long long* enc_row = carve<long long>(p, C::FR);
  long long* pred_row = carve<long long>(p, C::FR);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const long long R = (long long)B * T * U1, r0 = (long long)blockIdx.x * C::FR;

  for (int i = tid; i < C::FR; i += blockDim.x) {
    const long long r = r0 + i;
    enc_row[i] = pred_row[i] = -1;
    labid[i] = -1;
    m_s[i] = JL_NINF;
    s_s[i] = 0.f;
    blank_s[i] = lab_s[i] = 0.f;
    if (r < R) {
      const int b = (int)(r / ((long long)T * U1)), t = (int)((r / U1) % T), u = (int)(r % U1);
      enc_row[i] = ((long long)b * T + t) * J;
      pred_row[i] = ((long long)b * U1 + u) * J;
      if (u < U1 - 1) labid[i] = labels[(size_t)b * (U1 - 1) + u];
    }
  }
  __syncthreads();
  build_a<E>(a_s, lda, enc, pred, enc_row, pred_row, C::FR, J, Jp);

  for (int v0 = 0; v0 < V; v0 += C::FV) {
    __syncthreads();
    stage_w<E>(w_s, lda, wv, v0, C::FV, V, J, Jp);
    __syncthreads();
    mm<false, true>(a_s, lda, w_s, lda, lg, ldl, C::FR, C::FV, Jp, false);
    __syncthreads();
    for (int i = warp; i < C::FR; i += nwarps) {
      float cmax = JL_NINF;
      for (int c = lane; c < C::FV; c += 32) {
        const int v = v0 + c;
        if (v < V) {
          const float x = lg[(size_t)i * ldl + c] + bv[v];
          lg[(size_t)i * ldl + c] = x;
          cmax = fmaxf(cmax, x);
          if (v == 0) blank_s[i] = x;
          if (v == labid[i]) lab_s[i] = x;
        }
      }
      cmax = warp_max(cmax);
      const float m_new = fmaxf(m_s[i], cmax);
      float s = 0.f;
      for (int c = lane; c < C::FV; c += 32)
        if (v0 + c < V) s += expf(lg[(size_t)i * ldl + c] - m_new);
      s = warp_sum(s);
      if (lane == 0) {
        s_s[i] = s_s[i] * expf(m_s[i] - m_new) + s;
        m_s[i] = m_new;
      }
      __syncwarp();
    }
  }
  __syncthreads();
  for (int i = tid; i < C::FR; i += blockDim.x) {
    const long long r = r0 + i;
    if (r < R) {
      const float l = m_s[i] + logf(s_s[i]);
      lse[r] = l;
      lpb[r] = blank_s[i] - l;
      lpe[r] = labid[i] >= 0 ? lab_s[i] - l : JL_NEG;
    }
  }
}

// ----------------------------------- backward ----------------------------------- //

// dlog of one cell and vocab entry (0 where the cell or v is padding)
__device__ __forceinline__ float dlogit(float logit, float lse, float gb, float ge, int v, int lab) {
  const float p = expf(logit - lse);
  return (v == 0 ? gb : 0.f) + (v == lab ? ge : 0.f) - p * (gb + ge);
}

template <typename E>
__global__ void joint_bwd_rows_kernel(const E* __restrict__ enc, const E* __restrict__ pred,
                                      const E* __restrict__ wv, const float* __restrict__ bv,
                                      const int* __restrict__ labels, const float* __restrict__ lse,
                                      const float* __restrict__ gbl, const float* __restrict__ gem,
                                      float* __restrict__ denc_part, float* __restrict__ dpred_part, int B, int T,
                                      int U1, int J, int V) {
  typedef JL<E> C;
  extern __shared__ __align__(128) unsigned char smem[];
  const int Jp = round16(J), lda = Jp + C::PAD, ldl = C::BV + 4, lds = C::BV + C::PAD, ldz = Jp + 4;
  unsigned char* p = smem;
  E* a_s = carve<E>(p, (size_t)C::BR * lda);
  E* w_s = carve<E>(p, (size_t)C::BV * lda);
  float* lg = carve<float>(p, (size_t)C::BR * ldl);
  E* sp_s = carve<E>(p, (size_t)C::BR * lds);
  float* da = carve<float>(p, (size_t)C::BR * ldz);
  float* dp = carve<float>(p, (size_t)C::BR * ldz);
  float* lse_r = carve<float>(p, C::BR);
  float* gb_r = carve<float>(p, C::BR);
  float* ge_r = carve<float>(p, C::BR);
  int* lab_r = carve<int>(p, C::BR);
  long long* enc_row = carve<long long>(p, C::BR);
  long long* pred_row = carve<long long>(p, C::BR);
  const int tid = threadIdx.x;
  const int ut = blockIdx.x, tc = blockIdx.y, b = blockIdx.z, u0 = ut * C::BR;
  const int t_end = min(T, (tc + 1) * JL_TT);

  for (int o = tid; o < C::BR * ldz; o += blockDim.x) dp[o] = 0.f;
  for (int t = tc * JL_TT; t < t_end; ++t) {
    __syncthreads();
    for (int i = tid; i < C::BR; i += blockDim.x) {
      const int u = u0 + i;
      enc_row[i] = pred_row[i] = -1;
      lse_r[i] = gb_r[i] = ge_r[i] = 0.f;
      lab_r[i] = -1;
      if (u < U1) {
        const size_t cell = ((size_t)b * T + t) * U1 + u;
        enc_row[i] = ((long long)b * T + t) * J;
        pred_row[i] = ((long long)b * U1 + u) * J;
        lse_r[i] = lse[cell];
        gb_r[i] = gbl[cell];
        ge_r[i] = gem[cell];
        if (u < U1 - 1) lab_r[i] = labels[(size_t)b * (U1 - 1) + u];
      }
    }
    for (int o = tid; o < C::BR * ldz; o += blockDim.x) da[o] = 0.f;
    __syncthreads();
    build_a<E>(a_s, lda, enc, pred, enc_row, pred_row, C::BR, J, Jp);
    for (int v0 = 0; v0 < V; v0 += C::BV) {
      __syncthreads();
      stage_w<E>(w_s, lda, wv, v0, C::BV, V, J, Jp);
      __syncthreads();
      mm<false, true>(a_s, lda, w_s, lda, lg, ldl, C::BR, C::BV, Jp, false);
      __syncthreads();
      for (int o = tid; o < C::BR * C::BV; o += blockDim.x) {
        const int i = o / C::BV, c = o % C::BV, v = v0 + c;
        float d = 0.f;
        if (enc_row[i] >= 0 && v < V) d = dlogit(lg[(size_t)i * ldl + c] + bv[v], lse_r[i], gb_r[i], ge_r[i], v, lab_r[i]);
        sp_s[(size_t)i * lds + c] = d;
      }
      __syncthreads();
      mm<false, false>(sp_s, lds, w_s, lda, da, ldz, C::BR, Jp, C::BV, true);
      __syncthreads();
    }
    for (int i = 0; i < C::BR; ++i)
      for (int j = tid; j < Jp; j += blockDim.x) {
        const float a = to_f32(a_s[(size_t)i * lda + j]);
        const float z = da[(size_t)i * ldz + j] * (1.f - a * a);
        da[(size_t)i * ldz + j] = z;
        dp[(size_t)i * ldz + j] += z;
      }
    __syncthreads();
    for (int j = tid; j < J; j += blockDim.x) {
      float s = 0.f;
      for (int i = 0; i < C::BR; ++i) s += da[(size_t)i * ldz + j];
      denc_part[(((size_t)ut * B + b) * T + t) * J + j] = s;
    }
  }
  __syncthreads();
  for (int o = tid; o < C::BR * J; o += blockDim.x) {
    const int i = o / J, j = o % J, u = u0 + i;
    if (u < U1) dpred_part[(((size_t)tc * B + b) * U1 + u) * J + j] = dp[(size_t)i * ldz + j];
  }
}

template <typename E>
__global__ void joint_bwd_weight_kernel(const E* __restrict__ enc, const E* __restrict__ pred,
                                        const E* __restrict__ wv, const float* __restrict__ bv,
                                        const int* __restrict__ labels, const float* __restrict__ lse,
                                        const float* __restrict__ gbl, const float* __restrict__ gem,
                                        float* __restrict__ dwv_part, float* __restrict__ dbv_part, int B, int T,
                                        int U1, int J, int V, long long cells_per_range) {
  typedef JL<E> C;
  extern __shared__ __align__(128) unsigned char smem[];
  const int Jp = round16(J), lda = Jp + C::PAD, ldl = C::WV + 4, ldd = C::WV + C::PAD, ldz = Jp + 4;
  unsigned char* p = smem;
  E* w_s = carve<E>(p, (size_t)C::WV * lda);
  E* a_s = carve<E>(p, (size_t)C::WR * lda);
  float* lg = carve<float>(p, (size_t)C::WR * ldl);
  E* dl_s = carve<E>(p, (size_t)C::WR * ldd);
  float* acc = carve<float>(p, (size_t)C::WV * ldz);
  float* lse_r = carve<float>(p, C::WR);
  float* gb_r = carve<float>(p, C::WR);
  float* ge_r = carve<float>(p, C::WR);
  int* lab_r = carve<int>(p, C::WR);
  long long* enc_row = carve<long long>(p, C::WR);
  long long* pred_row = carve<long long>(p, C::WR);
  const int tid = threadIdx.x;
  const int v0 = blockIdx.x * C::WV, g = blockIdx.y;
  const long long R = (long long)B * T * U1;
  const long long c_begin = (long long)g * cells_per_range, c_end = min(R, c_begin + cells_per_range);

  for (int o = tid; o < C::WV * ldz; o += blockDim.x) acc[o] = 0.f;
  stage_w<E>(w_s, lda, wv, v0, C::WV, V, J, Jp);
  float dsum = 0.f;  // dbv[v0 + tid] for tid < WV
  for (long long r0 = c_begin; r0 < c_end; r0 += C::WR) {
    __syncthreads();
    for (int i = tid; i < C::WR; i += blockDim.x) {
      const long long r = r0 + i;
      enc_row[i] = pred_row[i] = -1;
      lse_r[i] = gb_r[i] = ge_r[i] = 0.f;
      lab_r[i] = -1;
      if (r < c_end) {
        const int b = (int)(r / ((long long)T * U1)), t = (int)((r / U1) % T), u = (int)(r % U1);
        enc_row[i] = ((long long)b * T + t) * J;
        pred_row[i] = ((long long)b * U1 + u) * J;
        lse_r[i] = lse[r];
        gb_r[i] = gbl[r];
        ge_r[i] = gem[r];
        if (u < U1 - 1) lab_r[i] = labels[(size_t)b * (U1 - 1) + u];
      }
    }
    __syncthreads();
    build_a<E>(a_s, lda, enc, pred, enc_row, pred_row, C::WR, J, Jp);
    __syncthreads();
    mm<false, true>(a_s, lda, w_s, lda, lg, ldl, C::WR, C::WV, Jp, false);
    __syncthreads();
    for (int o = tid; o < C::WR * C::WV; o += blockDim.x) {
      const int i = o / C::WV, c = o % C::WV, v = v0 + c;
      float d = 0.f;
      if (enc_row[i] >= 0 && v < V) d = dlogit(lg[(size_t)i * ldl + c] + bv[v], lse_r[i], gb_r[i], ge_r[i], v, lab_r[i]);
      lg[(size_t)i * ldl + c] = d;
      dl_s[(size_t)i * ldd + c] = from_f32<E>(d);
    }
    __syncthreads();
    if (tid < C::WV)
      for (int i = 0; i < C::WR; ++i) dsum += lg[(size_t)i * ldl + tid];
    mm<true, false>(dl_s, ldd, a_s, lda, acc, ldz, C::WV, Jp, C::WR, true);
  }
  __syncthreads();
  for (int o = tid; o < C::WV * J; o += blockDim.x) {
    const int v = o / J, j = o % J;
    if (v0 + v < V) dwv_part[((size_t)g * V + v0 + v) * J + j] = acc[(size_t)v * ldz + j];
  }
  if (tid < C::WV && v0 + tid < V) dbv_part[(size_t)g * V + v0 + tid] = dsum;
}

// ------------------------------------ launchers ------------------------------------ //

template <typename E>
size_t fwd_smem(int J) {
  typedef JL<E> C;
  const int lda = round16(J) + C::PAD;
  return carved<E>((size_t)C::FR * lda) + carved<E>((size_t)C::FV * lda) + carved<float>((size_t)C::FR * (C::FV + 4)) +
         4 * carved<float>(C::FR) + carved<int>(C::FR) + 2 * carved<long long>(C::FR);
}

template <typename E>
size_t rows_smem(int J) {
  typedef JL<E> C;
  const int Jp = round16(J), lda = Jp + C::PAD;
  return carved<E>((size_t)C::BR * lda) + carved<E>((size_t)C::BV * lda) + carved<float>((size_t)C::BR * (C::BV + 4)) +
         carved<E>((size_t)C::BR * (C::BV + C::PAD)) + 2 * carved<float>((size_t)C::BR * (Jp + 4)) +
         3 * carved<float>(C::BR) + carved<int>(C::BR) + 2 * carved<long long>(C::BR);
}

template <typename E>
size_t weight_smem(int J) {
  typedef JL<E> C;
  const int Jp = round16(J), lda = Jp + C::PAD;
  return carved<E>((size_t)C::WV * lda) + carved<E>((size_t)C::WR * lda) + carved<float>((size_t)C::WR * (C::WV + 4)) +
         carved<E>((size_t)C::WR * (C::WV + C::PAD)) + carved<float>((size_t)C::WV * (Jp + 4)) +
         3 * carved<float>(C::WR) + carved<int>(C::WR) + 2 * carved<long long>(C::WR);
}

// Scratch layout of the backward, in floats.
struct JointBwdScratch {
  int n_utiles, n_tchunks, n_vchunks, n_ranges;
  long long cells_per_range;
  size_t denc, dpred, dwv, dbv, total;
  template <typename E>
  static JointBwdScratch make(int B, int T, int U1, int J, int V) {
    typedef JL<E> C;
    JointBwdScratch s;
    const long long R = (long long)B * T * U1;
    const long long tiles = (R + C::WR - 1) / C::WR;
    s.n_utiles = (U1 + C::BR - 1) / C::BR;
    s.n_tchunks = (T + JL_TT - 1) / JL_TT;
    s.n_vchunks = (V + C::WV - 1) / C::WV;
    long long ranges = (JL_SMS + s.n_vchunks - 1) / s.n_vchunks;
    if (ranges > tiles) ranges = tiles;
    if (ranges < 1) ranges = 1;
    s.cells_per_range = (tiles + ranges - 1) / ranges * C::WR;
    s.n_ranges = (int)((R + s.cells_per_range - 1) / s.cells_per_range);
    if (s.n_ranges < 1) s.n_ranges = 1;
    s.denc = 0;
    s.dpred = s.denc + (size_t)s.n_utiles * B * T * J;
    s.dwv = s.dpred + (size_t)s.n_tchunks * B * U1 * J;
    s.dbv = s.dwv + (size_t)s.n_ranges * V * J;
    s.total = s.dbv + (size_t)s.n_ranges * V;
    return s;
  }
};

template <typename E>
int launch_joint_fwd(const void* enc, const void* pred, const void* wv, const void* bv, const void* labels, void* lpb,
                     void* lpe, void* lse, int B, int T, int U1, int J, int V, cudaStream_t stream) {
  const size_t smem = fwd_smem<E>(J);
  cudaError_t err = allow_smem(joint_fwd_kernel<E>, smem);
  if (err != cudaSuccess) return (int)err;
  const long long R = (long long)B * T * U1;
  const unsigned blocks = (unsigned)((R + JL<E>::FR - 1) / JL<E>::FR);
  joint_fwd_kernel<E><<<blocks, 256, smem, stream>>>((const E*)enc, (const E*)pred, (const E*)wv, (const float*)bv,
                                                     (const int*)labels, (float*)lpb, (float*)lpe, (float*)lse, B, T,
                                                     U1, J, V);
  return (int)cudaGetLastError();
}

template <typename E>
int launch_joint_bwd(const void* enc, const void* pred, const void* wv, const void* bv, const void* labels,
                     const void* lse, const void* gbl, const void* gem, void* denc, void* dpred, void* dwv, void* dbv,
                     float* scratch, int B, int T, int U1, int J, int V, cudaStream_t stream) {
  const JointBwdScratch L = JointBwdScratch::make<E>(B, T, U1, J, V);
  size_t smem = rows_smem<E>(J);
  cudaError_t err = allow_smem(joint_bwd_rows_kernel<E>, smem);
  if (err != cudaSuccess) return (int)err;
  joint_bwd_rows_kernel<E><<<dim3(L.n_utiles, L.n_tchunks, B), 256, smem, stream>>>(
      (const E*)enc, (const E*)pred, (const E*)wv, (const float*)bv, (const int*)labels, (const float*)lse,
      (const float*)gbl, (const float*)gem, scratch + L.denc, scratch + L.dpred, B, T, U1, J, V);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  smem = weight_smem<E>(J);
  if ((err = allow_smem(joint_bwd_weight_kernel<E>, smem)) != cudaSuccess) return (int)err;
  joint_bwd_weight_kernel<E><<<dim3(L.n_vchunks, L.n_ranges), 256, smem, stream>>>(
      (const E*)enc, (const E*)pred, (const E*)wv, (const float*)bv, (const int*)labels, (const float*)lse,
      (const float*)gbl, (const float*)gem, scratch + L.dwv, scratch + L.dbv, B, T, U1, J, V, L.cells_per_range);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  int e;
  if ((e = launch_sum_partials(scratch + L.denc, (float*)denc, L.n_utiles, (size_t)B * T * J, stream))) return e;
  if ((e = launch_sum_partials(scratch + L.dpred, (float*)dpred, L.n_tchunks, (size_t)B * U1 * J, stream))) return e;
  if ((e = launch_sum_partials(scratch + L.dwv, (float*)dwv, L.n_ranges, (size_t)V * J, stream))) return e;
  return launch_sum_partials(scratch + L.dbv, (float*)dbv, L.n_ranges, (size_t)V, stream);
}

// The bf16 kernels (joint_loss_mma.cu).
int launch_joint_mma_fwd(const void* enc, const void* pred, const void* wv, const void* bv, const void* labels, void* lpb, void* lpe, void* lse, int B,
                         int T, int U1, int J, int V, cudaStream_t stream);
long long joint_mma_bwd_scratch(int B, int T, int U1, int J, int V);
int launch_joint_mma_bwd(const void* enc, const void* pred, const void* wv, const void* bv, const void* labels, const void* lse, const void* gbl,
                         const void* gem, void* denc, void* dpred, void* dwv, void* dbv, float* scratch, int B, int T, int U1, int J, int V,
                         cudaStream_t stream);

}  // namespace tfasr

// enc_p [B, T, J], pred_p [B, U1, J], wv [V, J] in one dtype (f32 or bf16);
// bv [V] f32; labels [B, U1 - 1] int32 → lpb, lpe, lse [B, T, U1] f32. J <= 384,
// 8 | J, enc, pred and wv 16-byte aligned.
extern "C" int tfasr_joint_fwd(const void* enc, const void* pred, const void* wv, const void* bv, const void* labels,
                               void* lpb, void* lpe, void* lse, int B, int T, int U1, int J, int V, int dtype,
                               void* stream) {
  using namespace tfasr;
  if ((long long)B * T * U1 == 0) return 0;
  if (dtype == kBF16) return launch_joint_mma_fwd(enc, pred, wv, bv, labels, lpb, lpe, lse, B, T, U1, J, V, (cudaStream_t)stream);
  return launch_joint_fwd<float>(enc, pred, wv, bv, labels, lpb, lpe, lse, B, T, U1, J, V, (cudaStream_t)stream);
}

// Floats of scratch tfasr_joint_bwd needs.
extern "C" long long tfasr_joint_bwd_scratch(int B, int T, int U1, int J, int V, int dtype) {
  using namespace tfasr;
  return dtype == kBF16 ? joint_mma_bwd_scratch(B, T, U1, J, V) : (long long)JointBwdScratch::make<float>(B, T, U1, J, V).total;
}

// Gradients of the fused joint + loss: lse, gbl, gem [B, T, U1] f32 (gbl, gem
// scaled by the upstream cotangent) → denc [B, T, J], dpred [B, U1, J],
// dwv [V, J], dbv [V], all f32.
extern "C" int tfasr_joint_bwd(const void* enc, const void* pred, const void* wv, const void* bv, const void* labels,
                               const void* lse, const void* gbl, const void* gem, void* denc, void* dpred, void* dwv,
                               void* dbv, void* scratch, int B, int T, int U1, int J, int V, int dtype,
                               void* stream) {
  using namespace tfasr;
  if ((long long)B * T * U1 == 0) return 0;
  if (dtype == kBF16)
    return launch_joint_mma_bwd(enc, pred, wv, bv, labels, lse, gbl, gem, denc, dpred, dwv, dbv, (float*)scratch, B, T, U1, J, V,
                                (cudaStream_t)stream);
  return launch_joint_bwd<float>(enc, pred, wv, bv, labels, lse, gbl, gem, denc, dpred, dwv, dbv, (float*)scratch, B, T,
                                 U1, J, V, (cudaStream_t)stream);
}
