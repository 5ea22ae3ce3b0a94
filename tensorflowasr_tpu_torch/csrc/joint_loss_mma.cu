// The fused transducer joint + RNN-T loss statistics in bf16 on the tensor
// cores, forward and backward (the f32 instantiation stays on the CUDA-core
// kernels of joint_loss.cu, whose C entry points dispatch here for bf16):
//   a[b,t,u]      = tanh(enc_p[b,t] + pred_p[b,u])
//   logits[b,t,u] = a[b,t,u] . Wv^T + bv
// forward:  lse, lp_blank = logits[0] - lse, lp_emit = logits[label] - lse;
// backward: dlog = 1[v=0] gbl + 1[v=label] gem - softmax (gbl + gem),
//   da = dlog . Wv (f32), dz = da (1 - a^2), d_enc_p = sum_u dz,
//   d_pred_p = sum_t dz, dWv = sum_cells dlog_bf16^T a, dbv = sum_cells dlog.
//
// Counterpart of tensorflowasr_tpu/ops/pallas/joint_loss_kernel.py
// rnnt_loss_fused_joint (_fwd_kernel, _bwd_kernel). The structure is
// attention's: the lattice cells are the queries, the vocabulary rows are
// keys and values, and Wv is both K and V. Every product is an mma.sync
// m16n8k16 with bf16 operands and f32 accumulators, operands from shared
// memory by ldmatrix (Wv by ldmatrix.trans where it is the product's B of
// k = vocabulary).
//
// Cell tile. A block's 64 cells are 8 frames x 8 label positions of one
// utterance (row i: frame t0 + i / 8, label position u0 + i % 8), so a tile
// reads 8 enc_p rows and 8 pred_p rows. jm_build_a builds the tile's a into
// shared memory as bf16, and the forward, the rows pass and the weight pass
// all build it with that one function, so that the backward sees the
// activations the forward saw. Rounding as the JAX kernel's: enc_p + pred_p
// to bf16, tanh (one MUFU op, tanh.approx.f32, relative error ~2^-11) to
// bf16; the logits' f32 accumulation plus the f32 bv.
//
// Forward. The logits stay in the mma accumulators: the row max and sum of
// exp, the blank logit and the label logit are taken in registers and quad
// shuffles, and the warps of a row group merge their statistics once, in
// order. Where Wv fits in shared memory beside the tile (V <= 256 at J 320:
// 218 KB), jm_fwd_res keeps it resident in a persistent grid of one block
// of 16 warps per SM (warp (rg, q): 16 rows x a quarter of Wv), which reads
// Wv from L2 once per SM and needs no chunk loop. Else jm_fwd takes one tile
// a block of 8 warps (warp (rg, vh): 16 rows x half of each chunk) and
// streams Wv in 32-row chunks through a cp.async double buffer with an
// online max and rescaled sum (~85 KB at J 320: two blocks per SM); at the
// flagship it took 1.32 ms on an H100, against 2.81 for the WMMA kernel it
// replaced (PERF.md §6).
//
// Backward, three passes. Three of its sums run across cells that no one
// block owns; there are no atomics: every partial has one owner, and the
// partials are summed in a fixed order (launch_sum_partials, row_reduce.cu),
// so the gradients repeat bit for bit from run to run.
//  - jm_bwd_rows: a block of 16 warps owns 8 frames of one utterance and
//    walks their label-position tiles. Per tile and 64-row Wv chunk, warp
//    (rg, q) recomputes the logits of its 16 rows and 16 of the chunk's
//    vocabulary rows in registers and forms dlog there; dlog splits into
//    two bf16 terms (hi + lo: Wv is bf16-exact, so only dlog needs splitting
//    for the f32 da of the JAX kernel; a third term came no closer to
//    float64 on the card, PERF.md §6) packed straight into A fragments (the
//    C -> A reuse of kernel A's P.V product); the four warps of a row group
//    swap their fragments through shared memory, and each accumulates da over
//    all 64 vocabulary rows for its quarter of J in registers (16 warps, not
//    8 with halves of J: the same products over twice the warps, whose
//    latency the 8-warp version left exposed; PERF.md §6). Then dz = da (1 - a^2):
//    d_enc_p sums the fragment rows in a fixed butterfly and stays in shared
//    memory across the tiles (the block owns its frames: no partial), and
//    d_pred_p's partial over the block's 8 frames is written per tile.
//  - jm_bwd_weight: a block owns a 64-row vocabulary chunk of Wv (resident)
//    and a fixed interleaved set of cell tiles; per tile it recomputes a,
//    the logits of its chunk and dlog, and accumulates dWv[chunk] = dlog_bf16^T
//    . a in registers (warp: 16 vocabulary rows x half of J) and dbv in
//    registers. A separate pass, because dWv's [V, J] accumulator cannot sit
//    beside da's in the rows pass: at V 256, J 320 it is 82k f32 per block
//    (~320 KB), and sharing it across the rows pass's ~800 blocks would need
//    atomics or 800 partials of 327 KB (262 MB) where this pass writes 33.
//  - the fixed-order sums of the d_pred_p, dWv and dbv partials.
// A tile whose gbl and gem are all zero (cells outside every row's lattice)
// has dlog = 0 exactly, so both passes skip it and write zero partials: the
// same results as computing it.
//
// What bounds it: operations. At B 16, T 400, U+1 129, J 320, V 256 the
// forward's product is 2 B T (U+1) J V = 1.35e11 (0.137 ms at 989 TFLOP/s
// bf16); the backward's three products 4.06e11 (0.41 ms). These kernels do
// more: the tiles cover 8 x 136 of the 129 label positions (5% more
// cells), the rows pass recomputes the logits and runs da as two products
// (hi, lo), and the weight pass recomputes the logits again: 10 x B T (U+1)
// J V operations in the backward on the cells it does not skip. J <= 384,
// 8 | J; any V (the Wv chunks stream).
#include "mma.cuh"

namespace tfasr {

namespace {

constexpr int JM_TF = 8, JM_TU = 8, JM_ROWS = JM_TF * JM_TU;  // cell tile: 8 frames x 8 label positions
constexpr int JM_THREADS = 256;                                 // 8 warps
constexpr int JM_FV = 32;                                       // forward: vocabulary rows per Wv chunk
constexpr int JM_BV = 64;                                       // backward: vocabulary rows per Wv chunk
constexpr int JM_JMAX = 384;
constexpr int JM_SPLITS = 2;             // bf16 terms of dlog in the rows pass's f32 da product (hi + lo)
constexpr int JM_LDL = JM_BV + AM_PAD;  // the weight pass's dlog tile [64 cells][72]
constexpr int JM_SMS = 132;             // the H100's SMs: the weight pass runs about one block per SM
constexpr float JM_LOG0 = -1e30f;       // LOG_0
constexpr float JM_NINF = -3.0e38f;     // below every logit: the empty running max
constexpr float JM_LOG2E = 1.4426950408889634f;

struct JMArgs {
  int B, T, U1, J, V;
  int Jp, lda;     // J rounded up to 16; a and Wv rows in shared memory (Jp + AM_PAD)
  int n_tt, n_ut;  // frame and label-position tiles per utterance
};

JMArgs jm_args(int B, int T, int U1, int J, int V) {
  const int Jp = (J + 15) / 16 * 16;
  return JMArgs{B, T, U1, J, V, Jp, Jp + AM_PAD, (T + JM_TF - 1) / JM_TF, (U1 + JM_TU - 1) / JM_TU};
}

__device__ __forceinline__ float jm_tanh(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float jm_ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Stage the tile's 8 enc_p rows (frames t0..) and 8 pred_p rows (label
// positions u0..) into rows_s [16][lda] by 16-byte cp.async, all in flight
// at once (rows outside [T, U1] and the columns J..Jp zero). The caller
// commits and waits.
__device__ __forceinline__ void jm_stage_rows(bf16* rows_s, const bf16* __restrict__ enc, const bf16* __restrict__ pred, int b, int t0, int u0,
                                              const JMArgs& a) {
  const int cpr = a.Jp / 8;
  for (int i = threadIdx.x; i < 2 * JM_TF * cpr; i += blockDim.x) {
    const int r = i / cpr, c = (i - r * cpr) * 8;
    const bool is_enc = r < JM_TF;
    const int row = is_enc ? t0 + r : u0 + r - JM_TF;
    const bool ok = c < a.J && row < (is_enc ? a.T : a.U1);
    const bf16* src = ok ? (is_enc ? enc + ((size_t)b * a.T + row) * a.J + c : pred + ((size_t)b * a.U1 + row) * a.J + c) : enc;
    cp_async16(smem_u32(rows_s + r * a.lda + c), src, ok ? 16 : 0);
  }
}

// a_s [64][lda]: the tile's a from its staged rows (zero for a cell outside
// [T, U1] and for the columns J..Jp). The one function all three kernels
// build a with.
__device__ void jm_build_a(bf16* a_s, const bf16* rows_s, int t0, int u0, const JMArgs& a) {
  const int nv = a.Jp / 8;
  for (int o = threadIdx.x; o < JM_ROWS * nv; o += blockDim.x) {
    const int i = o / nv, j = (o - i * nv) * 8, t = t0 + i / JM_TU, u = u0 + i % JM_TU;
    uint4 out = make_uint4(0, 0, 0, 0);
    if (t < a.T && u < a.U1 && j < a.J) {
      const uint4 ev = *reinterpret_cast<const uint4*>(rows_s + (i / JM_TU) * a.lda + j);
      const uint4 pv = *reinterpret_cast<const uint4*>(rows_s + (JM_TF + i % JM_TU) * a.lda + j);
      const __nv_bfloat162* e2 = reinterpret_cast<const __nv_bfloat162*>(&ev);
      const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&pv);
      uint32_t* o2 = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 e = __bfloat1622float2(e2[k]), p = __bfloat1622float2(p2[k]);
        const float s0 = __bfloat162float(__float2bfloat16(e.x + p.x)), s1 = __bfloat162float(__float2bfloat16(e.y + p.y));
        o2[k] = pack_bf16(jm_tanh(s0), jm_tanh(s1));
      }
    }
    *reinterpret_cast<uint4*>(a_s + i * a.lda + j) = out;
  }
}

// The lattice cell of this thread's fragment row r (0..63) of the tile, with
// its saved statistics; ok is false outside [T, U1].
struct JMRow {
  float lse, gb, ge;
  int lab;  // the label at this cell (-1 at u = U1 - 1: no label left)
  bool ok;
};

__device__ __forceinline__ JMRow jm_row(int r, int b, int t0, int u0, const int* __restrict__ labels, const float* __restrict__ lse,
                                        const float* __restrict__ gbl, const float* __restrict__ gem, const JMArgs& a) {
  const int t = t0 + r / JM_TU, u = u0 + r % JM_TU;
  JMRow row{0.f, 0.f, 0.f, -1, t < a.T && u < a.U1};
  if (row.ok) {
    const size_t cell = ((size_t)b * a.T + t) * a.U1 + u;
    row.lse = lse[cell];
    row.gb = gbl[cell];
    row.ge = gem[cell];
    if (u < a.U1 - 1) row.lab = labels[(size_t)b * (a.U1 - 1) + u];
  }
  return row;
}

// dlog of one cell and vocabulary row from its f32 logit (0 outside the
// lattice or past V).
__device__ __forceinline__ float jm_dlog(float logit, const JMRow& row, int v, int V) {
  if (!row.ok || v >= V) return 0.f;
  const float p = jm_ex2((logit - row.lse) * JM_LOG2E);
  return (v == 0 ? row.gb : 0.f) + (v == row.lab ? row.ge : 0.f) - p * (row.gb + row.ge);
}

// -------------------------------------- forward -------------------------------------- //

// acc[NT] = A (16 rows at a_w) . B^T (8 NT rows at b_w), both [rows][lda]
// bf16, over nk k-steps: the even and the odd k-steps in two accumulators
// (two mma chains per n-tile), summed at the end.
template <int NT>
__device__ __forceinline__ void jm_abT2(float (&acc)[NT][4], const bf16* a_w, const bf16* b_w, int lda, int nk, int lane) {
  float odd[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = odd[nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < JM_JMAX / 16; kk += 2) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (kk + h < nk) {
        uint32_t af[4];
        load_a(af, a_w + (kk + h) * 16, lda, lane);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t b[4];
          load_b_nk(b, b_w + np * 16 * lda + (kk + h) * 16, lda, lane);
          mma16816(h ? odd[2 * np] : acc[2 * np], af, b[0], b[1]);
          mma16816(h ? odd[2 * np + 1] : acc[2 * np + 1], af, b[2], b[3]);
        }
      }
    }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] += odd[nt][e];
}

__global__ void __launch_bounds__(JM_THREADS, 2) jm_fwd(const bf16* __restrict__ enc, const bf16* __restrict__ pred, const bf16* __restrict__ wv,
                                                       const float* __restrict__ bv, const int* __restrict__ labels, float* __restrict__ lpb,
                                                       float* __restrict__ lpe, float* __restrict__ lse, JMArgs a) {
  extern __shared__ __align__(16) unsigned char jm_smem[];
  const int lda = a.lda, nk = a.Jp / 16, V = a.V;
  bf16* a_s = reinterpret_cast<bf16*>(jm_smem);                       // [64][lda]
  bf16* w_s = a_s + JM_ROWS * lda;                                    // [2][JM_FV][lda]
  float* st_s = reinterpret_cast<float*>(w_s + 2 * JM_FV * lda);      // [64][4] the vh 1 warps' (m, s, blank, label logit)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, tig = lane & 3;
  const int rg = warp & 3, vh = warp >> 2;
  const int b = blockIdx.y, t0 = (blockIdx.x / a.n_ut) * JM_TF, u0 = (blockIdx.x % a.n_ut) * JM_TU;
  const int nch = (V + JM_FV - 1) / JM_FV;

  am_stage(w_s, wv, 0, V, JM_FV, a.J, a.Jp, 1);
  jm_stage_rows(w_s + JM_FV * lda, enc, pred, b, t0, u0, a);  // the second Wv buffer holds the rows until the first prefetch
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  jm_build_a(a_s, w_s + JM_FV * lda, t0, u0, a);
  __syncthreads();
  int lab[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rg * 16 + g + 8 * h, t = t0 + r / JM_TU, u = u0 + r % JM_TU;
    lab[h] = (t < a.T && u < a.U1 - 1) ? labels[(size_t)b * (a.U1 - 1) + u] : -1;
  }
  float m[2] = {JM_NINF, JM_NINF}, s[2] = {0.f, 0.f}, xb[2] = {0.f, 0.f}, xl[2] = {0.f, 0.f};
  for (int c = 0; c < nch; ++c) {
    if (c + 1 < nch) {
      am_stage(w_s + ((c + 1) & 1) * JM_FV * lda, wv, (c + 1) * JM_FV, V, JM_FV, a.J, a.Jp, 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float acc[2][4];
    jm_abT2<2>(acc, a_s + rg * 16 * lda, w_s + (c & 1) * JM_FV * lda + vh * 16 * lda, lda, nk, lane);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float x[4], cmax = JM_NINF;
#pragma unroll
      for (int k = 0; k < 4; ++k) {  // k = 2 nt + q: column vh 16 + 8 nt + 2 tig + q of the chunk
        const int v = c * JM_FV + vh * 16 + (k >> 1) * 8 + 2 * tig + (k & 1);
        x[k] = JM_NINF;
        if (v < V) {
          x[k] = acc[k >> 1][2 * h + (k & 1)] + __ldg(bv + v);
          if (v == 0) xb[h] = x[k];
          if (v == lab[h]) xl[h] = x[k];
        }
        cmax = fmaxf(cmax, x[k]);
      }
      const float mn = fmaxf(m[h], quad_max(cmax));
      float ps = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (x[k] > JM_NINF) ps += jm_ex2((x[k] - mn) * JM_LOG2E);
      s[h] = s[h] * jm_ex2((m[h] - mn) * JM_LOG2E) + quad_sum(ps);
      m[h] = mn;
    }
    __syncthreads();  // before the next chunk's copy refills this buffer
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) xb[h] = quad_sum(xb[h]), xl[h] = quad_sum(xl[h]);  // one lane of the row group holds each
  if (vh == 1 && tig == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* st = st_s + (rg * 16 + g + 8 * h) * 4;
      st[0] = m[h], st[1] = s[h], st[2] = xb[h], st[3] = xl[h];
    }
  __syncthreads();
  if (vh == 0 && tig == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rg * 16 + g + 8 * h, t = t0 + r / JM_TU, u = u0 + r % JM_TU;
      if (t < a.T && u < a.U1) {
        const float* st = st_s + r * 4;
        const float mm = fmaxf(m[h], st[0]);
        const float ss = s[h] * jm_ex2((m[h] - mm) * JM_LOG2E) + st[1] * jm_ex2((st[0] - mm) * JM_LOG2E);
        const float l = mm + logf(ss);
        const size_t cell = ((size_t)b * a.T + t) * a.U1 + u;
        lse[cell] = l;
        lpb[cell] = (xb[h] + st[2]) - l;
        lpe[cell] = u < a.U1 - 1 ? (xl[h] + st[3]) - l : JM_LOG0;
      }
    }
}


// The forward with Wv resident, where it fits: Vp = 16 NVT >= V vocabulary
// rows [Vp][lda] in shared memory beside the tile's a and rows (218 KB at V
// 256, J 320). A persistent grid of one block of 16 warps per SM walks the
// cell tiles (tile += gridDim.x), so Wv is read from L2 once per SM, and a
// tile's logits are one product with no chunk loop: warp (rg, q) takes 16
// rows and the q-th quarter of the Vp vocabulary rows, the row max and sum
// of exp in registers and quad shuffles, the four warps of a row group
// merged once, in order. The next tile's rows are staged while this tile's
// product runs.
constexpr int JM_FWD_RES_THREADS = 512;

template <int NVT>
__global__ void __launch_bounds__(JM_FWD_RES_THREADS, 1) jm_fwd_res(const bf16* __restrict__ enc, const bf16* __restrict__ pred, const bf16* __restrict__ wv,
                                                           const float* __restrict__ bv, const int* __restrict__ labels, float* __restrict__ lpb,
                                                           float* __restrict__ lpe, float* __restrict__ lse, JMArgs a) {
  constexpr int VP = 16 * NVT, NT = NVT / 2;  // NT: n-tiles of a warp's VP / 4 vocabulary rows
  extern __shared__ __align__(16) unsigned char jm_smem[];
  const int lda = a.lda, nk = a.Jp / 16, V = a.V;
  bf16* w_s = reinterpret_cast<bf16*>(jm_smem);                    // [VP][lda] Wv
  bf16* a_s = w_s + VP * lda;                                      // [64][lda]
  bf16* rows_s = a_s + JM_ROWS * lda;                              // [16][lda]
  float* st_s = reinterpret_cast<float*>(rows_s + 2 * JM_TF * lda);  // [3][64][4] the q 1..3 warps' (m, s, blank, label logit)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, tig = lane & 3;
  const int rg = warp & 3, q = warp >> 2, v0 = q * (VP / 4);
  const int per_b = a.n_tt * a.n_ut, n_tiles = a.B * per_b;
  auto coords = [&](int tile, int& b, int& t0, int& u0) {
    b = tile / per_b;
    t0 = ((tile - b * per_b) / a.n_ut) * JM_TF;
    u0 = ((tile - b * per_b) % a.n_ut) * JM_TU;
  };

  am_stage(w_s, wv, 0, V, VP, a.J, a.Jp, 1);
  int b, t0, u0;
  if (blockIdx.x < n_tiles) {
    coords(blockIdx.x, b, t0, u0);
    jm_stage_rows(rows_s, enc, pred, b, t0, u0, a);
  }
  cp_async_commit();
  float bvr[NT][2];  // this thread's columns' bias (JM_NINF past V)
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int v = v0 + nt * 8 + 2 * tig + q;
      bvr[nt][q] = v < V ? __ldg(bv + v) : JM_NINF;
    }
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    coords(tile, b, t0, u0);
    cp_async_wait<0>();
    __syncthreads();
    jm_build_a(a_s, rows_s, t0, u0, a);
    __syncthreads();
    if (tile + gridDim.x < n_tiles) {  // the next tile's rows, in flight during this tile's product
      int nb, nt0, nu0;
      coords(tile + gridDim.x, nb, nt0, nu0);
      jm_stage_rows(rows_s, enc, pred, nb, nt0, nu0, a);
    }
    cp_async_commit();
    int lab[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rg * 16 + g + 8 * h, t = t0 + r / JM_TU, u = u0 + r % JM_TU;
      lab[h] = (t < a.T && u < a.U1 - 1) ? labels[(size_t)b * (a.U1 - 1) + u] : -1;
    }
    float acc[NT][4];
    am_abT<JM_JMAX, NT>(acc, a_s + rg * 16 * lda, w_s + v0 * lda, lda, nk, lane);
    float m[2], s[2], xb[2] = {0.f, 0.f}, xl[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float cmax = JM_NINF;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int v = v0 + nt * 8 + 2 * tig + q;
          const float x = acc[nt][2 * h + q] + bvr[nt][q];
          acc[nt][2 * h + q] = x;
          if (v == 0) xb[h] = x;
          if (v == lab[h] && v < V) xl[h] = x;
          cmax = fmaxf(cmax, x);
        }
      m[h] = quad_max(cmax);
      float ps = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int q = 0; q < 2; ++q)
          if (bvr[nt][q] > JM_NINF) ps += jm_ex2((acc[nt][2 * h + q] - m[h]) * JM_LOG2E);
      s[h] = quad_sum(ps);
      xb[h] = quad_sum(xb[h]);
      xl[h] = quad_sum(xl[h]);
    }
    if (q > 0 && tig == 0)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* st = st_s + ((q - 1) * JM_ROWS + rg * 16 + g + 8 * h) * 4;
        st[0] = m[h], st[1] = s[h], st[2] = xb[h], st[3] = xl[h];
      }
    __syncthreads();
    if (q == 0 && tig == 0)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = rg * 16 + g + 8 * h, t = t0 + r / JM_TU, u = u0 + r % JM_TU;
        if (t < a.T && u < a.U1) {
          float mm = m[h], ss, sb = xb[h], sl = xl[h];
#pragma unroll
          for (int k = 0; k < 3; ++k) mm = fmaxf(mm, st_s[(k * JM_ROWS + r) * 4]);
          ss = s[h] * jm_ex2((m[h] - mm) * JM_LOG2E);
#pragma unroll
          for (int k = 0; k < 3; ++k) {  // the quarters in order
            const float* st = st_s + (k * JM_ROWS + r) * 4;
            ss += st[1] * jm_ex2((st[0] - mm) * JM_LOG2E);
            sb += st[2];
            sl += st[3];
          }
          const float l = mm + logf(ss);
          const size_t cell = ((size_t)b * a.T + t) * a.U1 + u;
          lse[cell] = l;
          lpb[cell] = sb - l;
          lpe[cell] = u < a.U1 - 1 ? sl - l : JM_LOG0;
        }
      }
  }
  cp_async_wait<0>();
}

// ------------------------------------- backward ------------------------------------- //

// Whether any cell of the tile has a nonzero gbl or gem (the whole block
// votes; every thread passes its two fragment rows).
__device__ __forceinline__ bool jm_tile_active(const JMRow (&rows)[2]) {
  const bool mine = (rows[0].ok && (rows[0].gb != 0.f || rows[0].ge != 0.f)) || (rows[1].ok && (rows[1].gb != 0.f || rows[1].ge != 0.f));
  return __syncthreads_or(mine) != 0;
}

constexpr int JM_ROWS_THREADS = 512;  // the rows pass: 16 warps, 4 per row group

// dlog [16 rows][16 vocabulary rows] of a warp as JM_SPLITS bf16 terms packed
// into A fragments (one k-step); lg holds dlog in C layout and is consumed.
__device__ __forceinline__ void jm_split(uint32_t (&fr)[JM_SPLITS][4], float (&lg)[2][4]) {
#pragma unroll
  for (int sp = 0; sp < JM_SPLITS; ++sp) {
    fr[sp][0] = pack_bf16(lg[0][0], lg[0][1]);
    fr[sp][1] = pack_bf16(lg[0][2], lg[0][3]);
    fr[sp][2] = pack_bf16(lg[1][0], lg[1][1]);
    fr[sp][3] = pack_bf16(lg[1][2], lg[1][3]);
    if (sp + 1 < JM_SPLITS)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) lg[nt][e] -= __bfloat162float(__float2bfloat16(lg[nt][e]));
  }
}

// da [16 rows][the warp's np_mine 16-column pairs of J] += the fragments' 16
// vocabulary rows . the Wv rows at w ([16][lda] in shared memory, the warp's
// first column at 0), every split term.
template <int NP>
__device__ __forceinline__ void jm_da_step(float (&da)[2 * NP][4], const uint32_t (&fr)[JM_SPLITS][4], const bf16* w, int lda, int np_mine, int lane) {
#pragma unroll
  for (int np = 0; np < NP; ++np) {
    if (np < np_mine) {
      uint32_t bb[4];
      load_b_kn(bb, w + np * 16, lda, lane);
#pragma unroll
      for (int sp = 0; sp < JM_SPLITS; ++sp) {
        mma16816(da[2 * np], fr[sp], bb[0], bb[1]);
        mma16816(da[2 * np + 1], fr[sp], bb[2], bb[3]);
      }
    }
  }
}

// Named barrier of the four warps (128 threads) of a row group.
__device__ __forceinline__ void group_barrier(int id) { asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory"); }

// The rows pass, 16 warps: warp (rg, q) owns the tile's rows 16 rg.., the
// vocabulary rows 16 q.. of each 64-row chunk for the logits, and the q-th
// quarter of J's 16-column pairs for da (NP pairs at most).
template <int NP>
__global__ void __launch_bounds__(JM_ROWS_THREADS, 1) jm_bwd_rows(const bf16* __restrict__ enc, const bf16* __restrict__ pred, const bf16* __restrict__ wv,
                                                                 const float* __restrict__ bv, const int* __restrict__ labels, const float* __restrict__ lse,
                                                                 const float* __restrict__ gbl, const float* __restrict__ gem, float* __restrict__ denc,
                                                                 float* __restrict__ dpred_part, JMArgs a) {
  extern __shared__ __align__(16) unsigned char jm_smem[];
  const int lda = a.lda, Jp = a.Jp, J = a.J, V = a.V, nk = Jp / 16;
  bf16* a_s = reinterpret_cast<bf16*>(jm_smem);                           // [64][lda]; in each tile's epilogue dp_s [4][8][Jp] f32
  bf16* w_s = a_s + JM_ROWS * lda;                                        // [2][JM_BV][lda]
  bf16* rows_s = w_s + 2 * JM_BV * lda;                                   // [16][lda] the tile's enc_p and pred_p rows
  uint32_t* ex_s = reinterpret_cast<uint32_t*>(rows_s + 2 * JM_TF * lda);  // [16 warps][JM_SPLITS * 4][32] dlog fragments
  float* denc_s = reinterpret_cast<float*>(ex_s + 16 * JM_SPLITS * 4 * 32);  // [8 frames][Jp]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, tig = lane & 3;
  const int rg = warp & 3, q = warp >> 2;
  const int np_all = Jp / 16, p_lo = q * np_all / 4, np_mine = (q + 1) * np_all / 4 - p_lo, jofs = 16 * p_lo;
  const int tt = blockIdx.x, b = blockIdx.y, t0 = tt * JM_TF;
  const int nch = (V + JM_BV - 1) / JM_BV;

  for (int o = tid; o < JM_TF * Jp; o += blockDim.x) denc_s[o] = 0.f;
  for (int ut = 0; ut < a.n_ut; ++ut) {
    const int u0 = ut * JM_TU;
    JMRow rows[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) rows[h] = jm_row(rg * 16 + g + 8 * h, b, t0, u0, labels, lse, gbl, gem, a);
    if (!jm_tile_active(rows)) {  // dlog = 0 on every cell: d_pred_p's partial is zero, d_enc_p unchanged
      for (int o = tid; o < JM_TU * J; o += blockDim.x) {
        const int u = u0 + o / J;
        if (u < a.U1) dpred_part[(((size_t)tt * a.B + b) * a.U1 + u) * J + o % J] = 0.f;
      }
      continue;
    }
    am_stage(w_s, wv, 0, V, JM_BV, J, Jp, 1);
    jm_stage_rows(rows_s, enc, pred, b, t0, u0, a);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    jm_build_a(a_s, rows_s, t0, u0, a);
    float da[2 * NP][4];
#pragma unroll
    for (int nt = 0; nt < 2 * NP; ++nt) da[nt][0] = da[nt][1] = da[nt][2] = da[nt][3] = 0.f;
    for (int c = 0; c < nch; ++c) {
      if (c + 1 < nch) {
        am_stage(w_s + ((c + 1) & 1) * JM_BV * lda, wv, (c + 1) * JM_BV, V, JM_BV, J, Jp, 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const bf16* wc = w_s + (c & 1) * JM_BV * lda;
      float lg[2][4];
      jm_abT2<2>(lg, a_s + rg * 16 * lda, wc + q * 16 * lda, lda, nk, lane);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int v = c * JM_BV + q * 16 + nt * 8 + 2 * tig + (e & 1);
          lg[nt][e] = jm_dlog(lg[nt][e] + (v < V ? __ldg(bv + v) : 0.f), rows[e >> 1], v, V);
        }
      uint32_t own[JM_SPLITS][4];
      jm_split(own, lg);
      uint32_t* mine = ex_s + warp * (JM_SPLITS * 4 * 32);
#pragma unroll
      for (int sp = 0; sp < JM_SPLITS; ++sp)
#pragma unroll
        for (int r = 0; r < 4; ++r) mine[(sp * 4 + r) * 32 + lane] = own[sp][r];
      group_barrier(1 + rg);  // the row group's other warps have written their vocabulary rows
      // da over the chunk's 64 vocabulary rows, 16 from each warp of the row group, in order
#pragma unroll
      for (int kq = 0; kq < 4; ++kq) {
        const bf16* w = wc + kq * 16 * lda + jofs;
        if (kq == q) {
          jm_da_step<NP>(da, own, w, lda, np_mine, lane);
        } else {
          const uint32_t* other = ex_s + ((kq << 2) | rg) * (JM_SPLITS * 4 * 32);
          uint32_t fr[JM_SPLITS][4];
#pragma unroll
          for (int sp = 0; sp < JM_SPLITS; ++sp)
#pragma unroll
            for (int r = 0; r < 4; ++r) fr[sp][r] = other[(sp * 4 + r) * 32 + lane];
          jm_da_step<NP>(da, fr, w, lda, np_mine, lane);
        }
      }
      __syncthreads();  // before the next chunk's copy refills this buffer and the fragments are rewritten
    }
    // dz = da (1 - a^2); d_enc_p: the sum over the fragment rows g (the 8 label positions) of each of the warp's two frames
#pragma unroll
    for (int nt = 0; nt < 2 * NP; ++nt) {
      if (nt < 2 * np_mine) {
        const int col = jofs + nt * 8 + 2 * tig;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 av = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a_s + (rg * 16 + g + 8 * h) * lda + col));
          da[nt][2 * h] *= 1.f - av.x * av.x;
          da[nt][2 * h + 1] *= 1.f - av.y * av.y;
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float s0 = col_sum8(da[nt][e]), s1 = col_sum8(da[nt][2 + e]);
          if (g == 0) {
            denc_s[(2 * rg) * Jp + col + e] += s0;
            denc_s[(2 * rg + 1) * Jp + col + e] += s1;
          }
        }
      }
    }
    __syncthreads();  // every warp has read a_s: dp_s takes its place
    float* dp_s = reinterpret_cast<float*>(a_s);
#pragma unroll
    for (int nt = 0; nt < 2 * NP; ++nt)
      if (nt < 2 * np_mine)
#pragma unroll
        for (int e = 0; e < 2; ++e) dp_s[(rg * JM_TU + g) * Jp + jofs + nt * 8 + 2 * tig + e] = da[nt][e] + da[nt][2 + e];
    __syncthreads();
    // d_pred_p's partial over the block's 8 frames: the row groups' frame pairs in order
    for (int o = tid; o < JM_TU * J; o += blockDim.x) {
      const int ul = o / J, j = o - ul * J, u = u0 + ul;
      if (u < a.U1)
        dpred_part[(((size_t)tt * a.B + b) * a.U1 + u) * J + j] =
            ((dp_s[ul * Jp + j] + dp_s[(JM_TU + ul) * Jp + j]) + dp_s[(2 * JM_TU + ul) * Jp + j]) + dp_s[(3 * JM_TU + ul) * Jp + j];
    }
    // the next tile's vote is the barrier before a_s is rebuilt
  }
  __syncthreads();
  for (int o = tid; o < JM_TF * J; o += blockDim.x) {
    const int f = o / J, j = o - f * J;
    if (t0 + f < a.T) denc[((size_t)b * a.T + t0 + f) * J + j] = denc_s[f * Jp + j];
  }
}

// Blocks per SM the weight pass is built for: two where its register tile (NH n-tiles) fits 128 registers a thread.
constexpr int jm_weight_blocks(int nh) { return nh <= 20 ? 2 : 1; }

template <int NH>
__global__ void __launch_bounds__(JM_THREADS, jm_weight_blocks(NH)) jm_bwd_weight(const bf16* __restrict__ enc, const bf16* __restrict__ pred, const bf16* __restrict__ wv,
                                                              const float* __restrict__ bv, const int* __restrict__ labels, const float* __restrict__ lse,
                                                              const float* __restrict__ gbl, const float* __restrict__ gem, float* __restrict__ dwv_part,
                                                              float* __restrict__ dbv_part, JMArgs a, int ranges) {
  extern __shared__ __align__(16) unsigned char jm_smem[];
  const int lda = a.lda, Jp = a.Jp, J = a.J, V = a.V, nk = Jp / 16, nh = Jp / 16;
  bf16* w_s = reinterpret_cast<bf16*>(jm_smem);                    // [64][lda] this block's Wv chunk
  bf16* a_s = w_s + JM_BV * lda;                                   // [64][lda]
  bf16* rows_s = a_s + JM_ROWS * lda;                              // [16][lda] the tile's enc_p and pred_p rows
  bf16* dl_s = rows_s + 2 * JM_TF * lda;                           // [64 cells][JM_LDL] dlog in bf16
  float* db_s = reinterpret_cast<float*>(dl_s + JM_ROWS * JM_LDL);  // [4][64] dbv over each cell-row group
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, tig = lane & 3;
  const int rg = warp & 3, vh = warp >> 2;  // logits: 16 cells x 32 vocabulary rows; dWv: 16 vocabulary rows (rg) x half of J (vh)
  const int jofs = vh * (Jp / 2), v0 = blockIdx.x * JM_BV, range = blockIdx.y;
  const int n_tiles = a.B * a.n_tt * a.n_ut;

  am_stage(w_s, wv, v0, V, JM_BV, J, Jp, 1);
  cp_async_commit();
  float acc[NH][4], dsum[4][2];
#pragma unroll
  for (int nt = 0; nt < NH; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) dsum[nt][0] = dsum[nt][1] = 0.f;
  for (int tile = range; tile < n_tiles; tile += ranges) {
    const int b = tile / (a.n_tt * a.n_ut), rest = tile - b * (a.n_tt * a.n_ut);
    const int t0 = (rest / a.n_ut) * JM_TF, u0 = (rest % a.n_ut) * JM_TU;
    jm_stage_rows(rows_s, enc, pred, b, t0, u0, a);  // in flight while the tile's statistics load and the block votes
    cp_async_commit();
    JMRow rows[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) rows[h] = jm_row(rg * 16 + g + 8 * h, b, t0, u0, labels, lse, gbl, gem, a);
    const bool active = jm_tile_active(rows);
    cp_async_wait<0>();
    if (!active) continue;
    __syncthreads();
    jm_build_a(a_s, rows_s, t0, u0, a);
    __syncthreads();
    float lg[4][4];
    am_abT<JM_JMAX, 4>(lg, a_s + rg * 16 * lda, w_s + vh * 32 * lda, lda, nk, lane);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int vl = vh * 32 + nt * 8 + 2 * tig;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int v = v0 + vl + (e & 1);
        lg[nt][e] = jm_dlog(lg[nt][e] + (v < V ? __ldg(bv + v) : 0.f), rows[e >> 1], v, V);
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) dsum[nt][q] += lg[nt][q] + lg[nt][2 + q];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint32_t*>(dl_s + (rg * 16 + g + 8 * h) * JM_LDL + vl) = pack_bf16(lg[nt][2 * h], lg[nt][2 * h + 1]);
    }
    __syncthreads();
    // dWv[16 vocabulary rows rg][J half vh] += dlog^T . a over the tile's 64 cells
#pragma unroll
    for (int ks = 0; ks < JM_ROWS / 16; ++ks) {
      uint32_t af[4];
      load_a_t(af, dl_s + ks * 16 * JM_LDL + rg * 16, JM_LDL, lane);
#pragma unroll
      for (int np = 0; np < NH / 2; ++np) {
        if (2 * np < nh) {
          uint32_t bb[4];
          load_b_kn(bb, a_s + ks * 16 * lda + jofs + np * 16, lda, lane);
          mma16816(acc[2 * np], af, bb[0], bb[1]);
          if (2 * np + 1 < nh) mma16816(acc[2 * np + 1], af, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();  // before the next tile rebuilds a_s and dl_s
  }
  cp_async_wait<0>();
#pragma unroll
  for (int nt = 0; nt < NH; ++nt) {
    if (nt < nh) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int v = v0 + rg * 16 + g + 8 * (e >> 1), col = jofs + nt * 8 + 2 * tig + (e & 1);
        if (v < V && col < J) dwv_part[((size_t)range * V + v) * J + col] = acc[nt][e];
      }
    }
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float sm = col_sum8(dsum[nt][q]);
      if (g == 0) db_s[rg * JM_BV + vh * 32 + nt * 8 + 2 * tig + q] = sm;
    }
  __syncthreads();
  if (tid < JM_BV && v0 + tid < V)
    dbv_part[(size_t)range * V + v0 + tid] = ((db_s[tid] + db_s[JM_BV + tid]) + db_s[2 * JM_BV + tid]) + db_s[3 * JM_BV + tid];
}

// ------------------------------------- launchers ------------------------------------- //

size_t jm_fwd_smem(int lda) { return (size_t)(JM_ROWS + 2 * JM_FV) * lda * sizeof(bf16) + JM_ROWS * 4 * sizeof(float); }
size_t jm_fwd_res_smem(int lda, int nvt) { return (size_t)(16 * nvt + JM_ROWS + 2 * JM_TF) * lda * sizeof(bf16) + 3 * JM_ROWS * 4 * sizeof(float); }
constexpr size_t JM_MAX_SMEM = 227 * 1024;

// NVT of the resident forward for this J and V (Wv rows 16 NVT >= V, NVT in 4, 8, 16), or 0 where Wv does not fit:
// the streaming forward then runs.
int jm_fwd_resident(int lda, int V) {
  const int nvt = V <= 64 ? 4 : V <= 128 ? 8 : V <= 256 ? 16 : 0;
  return nvt && jm_fwd_res_smem(lda, nvt) <= JM_MAX_SMEM ? nvt : 0;
}

template <int NVT>
int jm_fwd_res_launch(const void* enc, const void* pred, const void* wv, const void* bv, const void* labels, void* lpb, void* lpe, void* lse, JMArgs a,
                      cudaStream_t stream) {
  const size_t smem = jm_fwd_res_smem(a.lda, NVT);
  cudaError_t err = allow_smem(jm_fwd_res<NVT>, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, jm_fwd_res<NVT>, JM_FWD_RES_THREADS, smem)) != cudaSuccess) return (int)err;
  const long long tiles = (long long)a.B * a.n_tt * a.n_ut;
  const int blocks = (int)(tiles < (long long)sms * per_sm ? tiles : (long long)sms * per_sm);
  jm_fwd_res<NVT><<<blocks < 1 ? 1 : blocks, JM_FWD_RES_THREADS, smem, stream>>>((const bf16*)enc, (const bf16*)pred, (const bf16*)wv, (const float*)bv,
                                                                         (const int*)labels, (float*)lpb, (float*)lpe, (float*)lse, a);
  return (int)cudaGetLastError();
}
size_t jm_rows_smem(int lda, int Jp) {
  return (size_t)(JM_ROWS + 2 * JM_BV + 2 * JM_TF) * lda * sizeof(bf16) + (size_t)16 * JM_SPLITS * 4 * 32 * sizeof(uint32_t) +
         (size_t)JM_TF * Jp * sizeof(float);
}
size_t jm_weight_smem(int lda) {
  return (size_t)(JM_BV + JM_ROWS + 2 * JM_TF) * lda * sizeof(bf16) + (size_t)JM_ROWS * JM_LDL * sizeof(bf16) + 4 * JM_BV * sizeof(float);
}

// The weight pass's fixed split of the cell tiles: about the blocks the 132
// SMs hold at once (two per SM for J <= 320) over the vocabulary chunks;
// range r takes tiles r, r + ranges, ... A function of the shapes only.
int jm_ranges(const JMArgs& a) {
  const int nv = (a.V + JM_BV - 1) / JM_BV;
  const long long tiles = (long long)a.B * a.n_tt * a.n_ut;
  long long r = JM_SMS * jm_weight_blocks(a.Jp / 16) / nv;
  if (r > tiles) r = tiles;
  return r < 1 ? 1 : (int)r;
}

// Scratch of the backward, in floats: d_pred_p partials [n_tt, B, U1, J],
// dWv partials [ranges, V, J], dbv partials [ranges, V].
struct JMScratch {
  size_t dpred, dwv, dbv, total;
  explicit JMScratch(const JMArgs& a) {
    const int r = jm_ranges(a);
    dpred = 0;
    dwv = dpred + (size_t)a.n_tt * a.B * a.U1 * a.J;
    dbv = dwv + (size_t)r * a.V * a.J;
    total = dbv + (size_t)r * a.V;
  }
};

// NH, the n-tiles of 8 columns in half of J, for the register arrays: Jp / 16 rounded up among 8, 16, 20, 24.
template <template <int> class K, typename... Args>
int jm_dispatch(int Jp, Args... args) {
  if (Jp <= 128) return K<8>::run(args...);
  if (Jp <= 256) return K<16>::run(args...);
  if (Jp <= 320) return K<20>::run(args...);
  if (Jp <= JM_JMAX) return K<24>::run(args...);
  return (int)cudaErrorInvalidValue;
}

template <int NH>
struct RowsRun {
  static int run(const void* enc, const void* pred, const void* wv, const void* bv, const void* labels, const void* lse, const void* gbl, const void* gem,
                 float* denc, float* dpred_part, JMArgs a, cudaStream_t stream) {
    const size_t smem = jm_rows_smem(a.lda, a.Jp);
    cudaError_t err = allow_smem(jm_bwd_rows<NH / 4>, smem);
    if (err != cudaSuccess) return (int)err;
    jm_bwd_rows<NH / 4><<<dim3(a.n_tt, a.B), JM_ROWS_THREADS, smem, stream>>>((const bf16*)enc, (const bf16*)pred, (const bf16*)wv, (const float*)bv,
                                                                      (const int*)labels, (const float*)lse, (const float*)gbl, (const float*)gem, denc,
                                                                      dpred_part, a);
    return (int)cudaGetLastError();
  }
};

template <int NH>
struct WeightRun {
  static int run(const void* enc, const void* pred, const void* wv, const void* bv, const void* labels, const void* lse, const void* gbl, const void* gem,
                 float* dwv_part, float* dbv_part, JMArgs a, int ranges, cudaStream_t stream) {
    const size_t smem = jm_weight_smem(a.lda);
    cudaError_t err = allow_smem(jm_bwd_weight<NH>, smem);
    if (err != cudaSuccess) return (int)err;
    jm_bwd_weight<NH><<<dim3((a.V + JM_BV - 1) / JM_BV, ranges), JM_THREADS, smem, stream>>>(
        (const bf16*)enc, (const bf16*)pred, (const bf16*)wv, (const float*)bv, (const int*)labels, (const float*)lse, (const float*)gbl,
        (const float*)gem, dwv_part, dbv_part, a, ranges);
    return (int)cudaGetLastError();
  }
};

// Blocks per SM of a kernel (the occupancy API, after the shared-memory limit is raised); a negative value is the CUDA error.
template <typename Kernel>
int jm_occupancy(Kernel kernel, size_t smem, int threads = JM_THREADS) {
  int blocks = -1;
  cudaError_t err = allow_smem(kernel, smem);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

template <int NH>
struct Occupancy {
  static int run(int which, const JMArgs& a) {
    switch (which) {
      case 0: return jm_occupancy(jm_fwd, jm_fwd_smem(a.lda));
      case 3: return jm_occupancy(jm_fwd_res<16>, jm_fwd_res_smem(a.lda, 16), JM_FWD_RES_THREADS);
      case 1: return jm_occupancy(jm_bwd_rows<NH / 4>, jm_rows_smem(a.lda, a.Jp), JM_ROWS_THREADS);
      case 2: return jm_occupancy(jm_bwd_weight<NH>, jm_weight_smem(a.lda));
      default: return -(int)cudaErrorInvalidValue;
    }
  }
};

}  // namespace

int launch_joint_mma_fwd(const void* enc, const void* pred, const void* wv, const void* bv, const void* labels, void* lpb, void* lpe, void* lse, int B,
                         int T, int U1, int J, int V, cudaStream_t stream) {
  const JMArgs a = jm_args(B, T, U1, J, V);
  if (a.Jp > JM_JMAX) return (int)cudaErrorInvalidValue;
  switch (jm_fwd_resident(a.lda, V)) {
    case 4: return jm_fwd_res_launch<4>(enc, pred, wv, bv, labels, lpb, lpe, lse, a, stream);
    case 8: return jm_fwd_res_launch<8>(enc, pred, wv, bv, labels, lpb, lpe, lse, a, stream);
    case 16: return jm_fwd_res_launch<16>(enc, pred, wv, bv, labels, lpb, lpe, lse, a, stream);
    default: break;
  }
  const size_t smem = jm_fwd_smem(a.lda);
  cudaError_t err = allow_smem(jm_fwd, smem);
  if (err != cudaSuccess) return (int)err;
  jm_fwd<<<dim3(a.n_tt * a.n_ut, B), JM_THREADS, smem, stream>>>((const bf16*)enc, (const bf16*)pred, (const bf16*)wv, (const float*)bv,
                                                                  (const int*)labels, (float*)lpb, (float*)lpe, (float*)lse, a);
  return (int)cudaGetLastError();
}

long long joint_mma_bwd_scratch(int B, int T, int U1, int J, int V) { return (long long)JMScratch(jm_args(B, T, U1, J, V)).total; }

int launch_joint_mma_bwd(const void* enc, const void* pred, const void* wv, const void* bv, const void* labels, const void* lse, const void* gbl,
                         const void* gem, void* denc, void* dpred, void* dwv, void* dbv, float* scratch, int B, int T, int U1, int J, int V,
                         cudaStream_t stream) {
  const JMArgs a = jm_args(B, T, U1, J, V);
  const JMScratch L(a);
  const int ranges = jm_ranges(a);
  int e;
  if ((e = jm_dispatch<RowsRun>(a.Jp, enc, pred, wv, bv, labels, lse, gbl, gem, (float*)denc, scratch + L.dpred, a, stream))) return e;
  if ((e = jm_dispatch<WeightRun>(a.Jp, enc, pred, wv, bv, labels, lse, gbl, gem, scratch + L.dwv, scratch + L.dbv, a, ranges, stream))) return e;
  if ((e = launch_sum_partials(scratch + L.dpred, (float*)dpred, a.n_tt, (size_t)B * U1 * J, stream))) return e;
  if ((e = launch_sum_partials(scratch + L.dwv, (float*)dwv, ranges, (size_t)V * J, stream))) return e;
  return launch_sum_partials(scratch + L.dbv, (float*)dbv, ranges, (size_t)V, stream);
}

}  // namespace tfasr

// Dynamic shared memory (bytes) of the bf16 streaming forward (which 0),
// rows pass (1), weight pass (2) or the forward with Wv resident at V 256
// (3) at joint width J; tests/test_torch_joint_conv_mma.py plans the same.
extern "C" long long tfasr_joint_mma_smem(int J, int which) {
  using namespace tfasr;
  const JMArgs a = jm_args(1, 1, 1, J, 1);
  switch (which) {
    case 0: return (long long)jm_fwd_smem(a.lda);
    case 1: return (long long)jm_rows_smem(a.lda, a.Jp);
    case 2: return (long long)jm_weight_smem(a.lda);
    case 3: return (long long)jm_fwd_res_smem(a.lda, 16);
    default: return -1;
  }
}

// The forward's Wv rows kept resident at J and V (0: the streaming forward runs).
extern "C" int tfasr_joint_mma_fwd_resident(int J, int V) { return 16 * tfasr::jm_fwd_resident(tfasr::jm_args(1, 1, 1, J, V).lda, V); }

// Blocks per SM of that kernel on the current card; a negative value is the CUDA error.
extern "C" int tfasr_joint_mma_occupancy(int J, int which) {
  using namespace tfasr;
  const JMArgs a = jm_args(1, 1, 1, J, 1);
  return jm_dispatch<Occupancy>(a.Jp, which, a);
}

// The cell-tile map and the weight pass's split: out = (frames per tile,
// label positions per tile, frame tiles, label-position tiles, weight-pass
// ranges); tests/test_torch_joint_conv_mma.py copies it.
extern "C" int tfasr_joint_mma_layout(int B, int T, int U1, int J, int V, int* out) {
  using namespace tfasr;
  const JMArgs a = jm_args(B, T, U1, J, V);
  out[0] = JM_TF, out[1] = JM_TU, out[2] = a.n_tt, out[3] = a.n_ut, out[4] = jm_ranges(a);
  return 0;
}
