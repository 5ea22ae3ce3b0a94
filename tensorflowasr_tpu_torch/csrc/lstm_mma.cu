// Whole-sequence LSTM recurrence in bf16 on the tensor cores, forward and
// backward (BPTT), gate order i, f, g, o, one launch each:
//   a_t = xg[:, t] + round_bf16(h_{t-1}) . Wh            (f32 accumulation)
//   c_t = sig(a_f) c_{t-1} + sig(a_i) tanh(a_g);  h_t = sig(a_o) tanh(c_t)
// The forward writes y = h, the cell sequence and the activated gates in
// bf16; the backward writes d(pre-activation) dxg in f32 and dh0, dc0, with
// dh += round_bf16(dxg_{t+1}) . Wh^T. The f32 instantiation stays on the
// CUDA-core kernels of lstm.cu (parity runs only).
//
// Replaces tensorflowasr_tpu/ops/pallas/lstm_kernel.py lstm_core
// (_fwd_kernel, _bwd_kernel). The TPU kernels keep all of Wh in VMEM and
// walk the time steps in a sequential grid. Here batch rows are
// independent, so one thread-block cluster of C blocks owns 16 batch rows
// (one mma M tile; rows past B are zero and never written) and runs all T
// steps alone: ceil(B / 16) clusters, no grid-wide barrier, no cooperative
// launch.
//
// The cluster splits the hidden units into groups of 8 (one mma n-tile per
// gate) and each block owns a contiguous run of groups; one warp owns one
// group with all four of its gates, so a thread's four gate fragments hold
// the same (row, unit) cells and the cell update stays in its registers.
// Each block keeps its slice of Wh in shared memory for the whole sequence,
// as far as it fits (the plan, below) (forward: the 4 x 8 gate columns of each of its groups, stored [k][n];
// backward: the Wh rows of its units, stored [unit][4 gate blocks of Hp]).
// A step is one [16, H] x [H, 32] product per warp on mma.sync m16n8k16
// (forward; the k-steps alternate between two accumulator sets, summed at
// the end) or [16, 4H] x [4H, 8] (backward; four accumulator sets by
// k-step mod 4, summed pairwise). The order is fixed: no atomics.
//
// h (forward) or round_bf16(dxg) (backward) is exchanged through
// distributed shared memory: each warp gathers its 16-byte row chunks with
// warp shuffles and pushes them into every block's copy of the step's
// vector with st.async, counted on the receiver's mbarrier; double-buffered
// by step parity. A warp waits only for its own block's copy to be
// complete. Before a block pushes step t's values into another block's
// buffer of parity t + 1, it has received that block's step t - 1 values,
// which each warp pushes only after its own reads of that buffer: no
// block barrier and no device-memory round trip in the loop. The next
// step's xg (forward) or gates, cell values and cotangents (backward) are
// loaded into registers a step ahead.
//
// The plan (lm_plan; the wrapper reads it through tfasr_lstm_mma_plan): C
// is the smallest of 1, 2, 4, 8, 16 for which a block holds at most 8
// groups and both kernels keep their whole slices and two exchange buffers
// in the 227 KB of shared memory (C 8 at H 320). Where none does (H above
// 448), C is 16 and each block keeps the first k-steps (forward) or column
// chunks (backward) of its slice that fit; the rest it reads each step from
// a copy in fragment order (lstm_mma_pack_fwd / _bwd, written at the start
// of each call and small enough to stay in L2): two 16-byte loads per lane
// and k-step (forward) or one per two k-steps (backward), prefetched two
// k-steps ahead, the first before the exchange wait. The accumulation order is the same either way. Where two
// backward dxg buffers do not fit (H above 896) the backward keeps one and
// takes one cluster barrier per step between its reads and its pushes.
// Widths above 1024 (more than 16 x 8 groups) are refused.
//
// What bounds it on the card: the chain of T dependent steps each way (129
// at the prediction net's U+1), each a product of 20 (forward) or 80
// (backward) dependent mma k-steps split over 2 or 4 accumulators, the
// activations and one cluster exchange; not the 1.7 GFLOP or the ~13 MB of
// traffic. PERF.md holds the measured times.
#include <cooperative_groups.h>

#include <algorithm>

#include "mma.cuh"

namespace cg = cooperative_groups;

namespace tfasr {

namespace {

constexpr int LM_ROWS = 16;        // batch rows per cluster: one mma M tile
constexpr int LM_GROUP = 8;        // hidden units per group: one mma n-tile per gate
constexpr int LM_MAX_WARPS = 8;    // groups (one warp each) per block
constexpr int LM_MAX_CLUSTER = 16;
constexpr int LM_PAD = 8;          // bf16 row padding: 8 ldmatrix rows on distinct banks
constexpr size_t LM_SMEM_LIMIT = 232448 - 16;  // the 227 KB a block may use, less the two static mbarriers

struct LmDims {
  int B, T, H, G, Hp, Kp, C, gpb;  // G groups, Hp = 8 G, Kp = Hp rounded up to 16, gpb = ceil(G / C)
  int kr;    // forward: the first kr of the Kp / 16 k-steps of the block's Wh slice are resident, the rest packed in L2
  int rc;    // backward: the first rc of the G chunks of 32 columns of the block's Wh rows are resident, the rest packed
  int nbuf;  // backward dxg buffers: 2 (by step parity), or 1 with a cluster barrier per step
};

__host__ __device__ inline int lm_split_start(int n, int C, int r) { return r * (n / C) + (r < n % C ? r : n % C); }
__host__ __device__ inline int lm_split_count(int n, int C, int r) { return n / C + (r < n % C ? 1 : 0); }

// forward: Wh slice [16 kr][32 gpb + PAD], h [2][16][Kp + PAD]; backward: Wh rows [8 gpb][32 rc + PAD], dxg
// [nbuf][16][4 Hp + PAD]; bf16. The packed copies: 32 lanes x 32 bytes per group and streamed k-step (forward),
// 32 lanes x 16 bytes per group and streamed chunk (backward).
inline size_t lm_fwd_smem(const LmDims& d) {
  return sizeof(bf16) * ((size_t)16 * d.kr * (32 * d.gpb + LM_PAD) + (size_t)2 * LM_ROWS * (d.Kp + LM_PAD));
}
inline size_t lm_bwd_smem(const LmDims& d) {
  return sizeof(bf16) * ((size_t)LM_GROUP * d.gpb * (32 * d.rc + LM_PAD) + (size_t)d.nbuf * LM_ROWS * (4 * d.Hp + LM_PAD));
}
inline size_t lm_fwd_pack(const LmDims& d) { return (size_t)d.G * (d.Kp / 16 - d.kr) * 32 * 32; }
inline size_t lm_bwd_pack(const LmDims& d) { return (size_t)d.G * (d.G - d.rc) * 32 * 16; }

// The largest resident count of `total` whose bytes (fixed + count x per) fit, even where it is not all of them
// (the streamed k-steps or chunks then start on the first accumulator set); -1 where not even the fixed part fits.
inline int lm_fit(size_t fixed, size_t per, int total) {
  if (fixed > LM_SMEM_LIMIT) return -1;
  const int n = (int)((LM_SMEM_LIMIT - fixed) / per);
  return n >= total ? total : n & ~1;
}

// The kernels' layout at width H (B and T left 0); false for a width no cluster can run.
inline bool lm_plan(int H, LmDims& d) {
  d = LmDims{};
  d.H = H;
  d.G = (H + LM_GROUP - 1) / LM_GROUP;
  d.Hp = LM_GROUP * d.G;
  d.Kp = (d.Hp + 15) / 16 * 16;
  if (H <= 0 || d.G > LM_MAX_CLUSTER * LM_MAX_WARPS) return false;
  for (int C = 1; C <= LM_MAX_CLUSTER; C *= 2) {
    d.C = C;
    d.gpb = (d.G + C - 1) / C;
    d.kr = d.Kp / 16;
    d.rc = d.G;
    d.nbuf = 2;
    if (C <= d.G && d.gpb <= LM_MAX_WARPS && lm_fwd_smem(d) <= LM_SMEM_LIMIT && lm_bwd_smem(d) <= LM_SMEM_LIMIT) return true;
  }
  d.C = LM_MAX_CLUSTER;  // G > 56 here: C 16 gives at most 8 groups a block
  d.gpb = (d.G + d.C - 1) / d.C;
  const size_t buf = sizeof(bf16) * LM_ROWS * (4 * (size_t)d.Hp + LM_PAD), rows = sizeof(bf16) * LM_GROUP * d.gpb * LM_PAD;
  d.nbuf = 2 * buf + rows <= LM_SMEM_LIMIT ? 2 : 1;
  d.kr = lm_fit(sizeof(bf16) * 2 * LM_ROWS * ((size_t)d.Kp + LM_PAD), sizeof(bf16) * 16 * (32 * (size_t)d.gpb + LM_PAD), d.Kp / 16);
  d.rc = lm_fit(d.nbuf * buf + rows, sizeof(bf16) * LM_GROUP * d.gpb * 32, d.G);
  return d.kr >= 0 && d.rc >= 0;
}

// Push 16 bytes to the shared address dst of block `rank`, counted on its barrier bar (a local address as well).
__device__ __forceinline__ void lm_push16(uint32_t dst, const uint32_t (&v)[4], uint32_t bar, int rank) {
  uint32_t rd, rb;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(rd) : "r"(dst), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(rb) : "r"(bar), "r"(rank));
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(rd), "r"(v[0]), "r"(v[1]),
               "r"(v[2]), "r"(v[3]), "r"(rb)
               : "memory");
}

// Wait (every thread of the calling warp) until `bytes` have arrived on barrier i for its current phase; thread 0
// of the block arms the phase. phases holds each barrier's parity.
__device__ __forceinline__ void lm_wait(unsigned long long* bars, int i, unsigned int bytes, unsigned int& phases) {
  const uint32_t bar = smem_u32(bars + i);
  if (threadIdx.x == 0) asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
  const unsigned int parity = (phases >> i) & 1u;
  unsigned int done = 0, spins = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && ++spins == (1u << 26)) __trap();  // a lost exchange fails the launch instead of hanging the card
  } while (!done);
  phases ^= 1u << i;
}

// Each lane holds two bf16x2 words: lo for fragment row g, hi for row g + 8 (units 2 tig, 2 tig + 1 of the
// warp's group). Every lane gathers the 16-byte chunk (the 8 units) of row g + 8 (tig & 1), the row it pushes.
__device__ __forceinline__ void lm_gather(uint32_t (&v)[4], uint32_t w_lo, uint32_t w_hi, int g, int tig) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t lo = __shfl_sync(0xffffffffu, w_lo, 4 * g + k), hi = __shfl_sync(0xffffffffu, w_hi, 4 * g + k);
    v[k] = (tig & 1) ? hi : lo;
  }
}

__device__ __forceinline__ void lm_cluster_init(unsigned long long* bars) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bars + i)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}

__device__ __forceinline__ float lm_ld(const bf16* p, bool ok) { return ok ? __bfloat162float(*p) : 0.f; }

// A thread's two adjacent units u, u + 1 (u even) of one row. V (H even, the
// arrays' bases aligned, so u and u + 1 are in range together): one 4-byte
// (bf16) or 8-byte (f32) access under ok0; else one element each. 0 out of range.
template <bool V>
__device__ __forceinline__ void lm_ld2(const bf16* p, bool ok0, bool ok1, float& x0, float& x1) {
  if constexpr (V) {
    const __nv_bfloat162 v = ok0 ? *reinterpret_cast<const __nv_bfloat162*>(p) : __floats2bfloat162_rn(0.f, 0.f);
    x0 = __low2float(v);
    x1 = __high2float(v);
  } else {
    x0 = ok0 ? __bfloat162float(p[0]) : 0.f;
    x1 = ok1 ? __bfloat162float(p[1]) : 0.f;
  }
}
template <bool V>
__device__ __forceinline__ void lm_ld2(const float* p, bool ok0, bool ok1, float& x0, float& x1) {
  if constexpr (V) {
    const float2 v = ok0 ? *reinterpret_cast<const float2*>(p) : make_float2(0.f, 0.f);
    x0 = v.x;
    x1 = v.y;
  } else {
    x0 = ok0 ? p[0] : 0.f;
    x1 = ok1 ? p[1] : 0.f;
  }
}
template <bool V>
__device__ __forceinline__ void lm_st2(bf16* p, bool ok0, bool ok1, float x0, float x1) {
  if constexpr (V) {
    if (ok0) *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
  } else {
    if (ok0) p[0] = __float2bfloat16(x0);
    if (ok1) p[1] = __float2bfloat16(x1);
  }
}
template <bool V>
__device__ __forceinline__ void lm_st2(float* p, bool ok0, bool ok1, float x0, float x1) {
  if constexpr (V) {
    if (ok0) *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
  } else {
    if (ok0) p[0] = x0;
    if (ok1) p[1] = x1;
  }
}
template <typename... Ps>
inline bool lm_aligned(size_t bytes, const Ps*... ps) {
  return ((reinterpret_cast<uintptr_t>(ps) % bytes == 0) && ...);
}

// Raw bits of two bf16 values as one mma operand word: lo in the low half.
__device__ __forceinline__ uint32_t lm_bits(const bf16* p, bool ok0, bool ok1) {
  const uint32_t lo = ok0 ? __bfloat16_as_ushort(p[0]) : 0u, hi = ok1 ? __bfloat16_as_ushort(p[1]) : 0u;
  return lo | hi << 16;
}

// The forward's streamed k-steps kr.. of every group in fragment order: for group gr, k-step kr + s and lane
// (g, tig), 8 words w[2 q + half] = B[16 (kr + s) + 8 half + 2 tig + {0, 1}][gate q, unit g], the b0, b1 of gate
// q's n-tile (B[k][q, j] = Wh[k, q H + 8 gr + j], 0 off the matrix), as two uint4 at pack[2 i], i = (gr ns + s) 32 + lane.
__global__ void lstm_mma_pack_fwd(const bf16* __restrict__ wh, uint4* __restrict__ pack, const LmDims d) {
  const int ns = d.Kp / 16 - d.kr, H = d.H;
  const long long n = (long long)d.G * ns * 32;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n; i += (long long)gridDim.x * blockDim.x) {
    const int lane = (int)(i & 31), s = (int)((i >> 5) % ns), gr = (int)((i >> 5) / ns);
    const int u = LM_GROUP * gr + (lane >> 2), k0 = 16 * (d.kr + s) + 2 * (lane & 3);
    uint32_t w[8];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int k = k0 + 8 * half;
        const bf16* p = wh + (size_t)k * 4 * H + q * H + u;
        const uint32_t lo = (u < H && k < H) ? __bfloat16_as_ushort(p[0]) : 0u;
        const uint32_t hi = (u < H && k + 1 < H) ? __bfloat16_as_ushort(p[4 * H]) : 0u;
        w[2 * q + half] = lo | hi << 16;
      }
    pack[2 * i] = make_uint4(w[0], w[1], w[2], w[3]);
    pack[2 * i + 1] = make_uint4(w[4], w[5], w[6], w[7]);
  }
}

// The backward's streamed chunks rc.. of every group's Wh rows in fragment order: for group gr, chunk rc + s and
// lane (g, tig), w[i] = W'[8 gr + g][32 (rc + s) + 8 i + 2 tig + {0, 1}] with W'[u][q Hp + v] = Wh[u, q H + v] (0
// off the matrix): the b0, b1 of k-steps 2 (rc + s) and 2 (rc + s) + 1, one uint4 at pack[(gr ns + s) 32 + lane].
__global__ void lstm_mma_pack_bwd(const bf16* __restrict__ wh, uint4* __restrict__ pack, const LmDims d) {
  const int ns = d.G - d.rc, H = d.H;
  const long long n = (long long)d.G * ns * 32;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n; i += (long long)gridDim.x * blockDim.x) {
    const int lane = (int)(i & 31), s = (int)((i >> 5) % ns), gr = (int)((i >> 5) / ns);
    const int u = LM_GROUP * gr + (lane >> 2), c0 = 32 * (d.rc + s) + 2 * (lane & 3);
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + 8 * j, q = c / d.Hp, v = c - q * d.Hp;  // v even, Hp even: v + 1 is in the same gate block
      w[j] = lm_bits(wh + (size_t)u * 4 * H + q * H + v, u < H && v < H, u < H && v + 1 < H);
    }
    pack[i] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

struct LmFwdArgs {
  const bf16* xg;    // [B, T, 4H]
  const bf16* wh;    // [H, 4H]
  const uint4* pack; // the streamed k-steps (lstm_mma_pack_fwd), or null where the slices are resident
  const bf16* h0;    // [B, H]
  const bf16* c0;
  bf16* y;      // [B, T, H]
  bf16* cseq;   // [B, T, H]
  bf16* gates;  // [B, T, 4H]
  LmDims d;
};

// V: two units a thread per access (see lm_ld2); S: part of the slice streamed from the packed copy.
template <bool V, bool S>
__global__ void __launch_bounds__(32 * LM_MAX_WARPS, 1) lstm_mma_fwd(const LmFwdArgs a) {
  extern __shared__ __align__(16) unsigned char lm_smem[];
  __shared__ __align__(8) unsigned long long bars[2];
  const cg::cluster_group cluster = cg::this_cluster();
  const LmDims d = a.d;
  const int H = d.H, T = d.T, C = d.C, rank = (int)cluster.block_rank();
  const int b0 = (blockIdx.x / C) * LM_ROWS, nb = min(LM_ROWS, d.B - b0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, tig = lane & 3;
  const int ng = lm_split_count(d.G, C, rank), gs = lm_split_start(d.G, C, rank);
  const int KS = d.Kp / 16, KR = d.kr, NS = S ? KS - KR : 0;
  const int LDN = 32 * d.gpb + LM_PAD, LDH = d.Kp + LM_PAD;
  bf16* w_s = reinterpret_cast<bf16*>(lm_smem);  // [16 KR][LDN]: column (4 gl + q) * 8 + j = Wh[k, q H + 8 (gs + gl) + j]
  bf16* hbuf = w_s + (size_t)16 * KR * LDN;      // [2][16][LDH]: h_{t-1} of step t at parity t & 1
  const bf16 zero = __float2bfloat16(0.f);

  // this block's resident slice of Wh, 8 units of one gate at a time (16 bytes where H % 8 == 0 and the base is aligned)
  const bool vec = H % 8 == 0 && (reinterpret_cast<uintptr_t>(a.wh) & 15) == 0;
  for (int i = tid; i < 16 * KR * 4 * d.gpb; i += blockDim.x) {
    const int k = i / (4 * d.gpb), n8 = i - k * 4 * d.gpb, gl = n8 >> 2, q = n8 & 3, u0 = LM_GROUP * (gs + gl);
    bf16* dst = w_s + (size_t)k * LDN + n8 * LM_GROUP;
    const bf16* src = a.wh + (size_t)k * 4 * H + q * H + u0;
    if (vec && k < H && gl < ng && u0 + LM_GROUP <= H) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int j = 0; j < LM_GROUP; ++j) dst[j] = (k < H && gl < ng && u0 + j < H) ? src[j] : zero;
    }
  }
  for (int i = tid; i < 2 * LM_ROWS * LDH; i += blockDim.x) {
    const int p = i / (LM_ROWS * LDH), r = (i / LDH) % LM_ROWS, k = i % LDH;
    hbuf[i] = (p == 0 && r < nb && k < H) ? a.h0[(size_t)(b0 + r) * H + k] : zero;
  }
  lm_cluster_init(bars);
  cluster.sync();  // every block has set up its barriers and buffers: pushes into its shared memory may begin

  if (warp < ng) {
    const int gl = warp, ub = LM_GROUP * (gs + gl) + 2 * tig;  // the thread's units ub, ub + 1
    const bf16* wcol = w_s + gl * 4 * LM_GROUP;
    const uint4* wp = NS > 0 ? a.pack + ((size_t)(gs + gl) * NS * 32 + lane) * 2 : nullptr;  // streamed k-step KR + s at wp[64 s]
    float c[4], xcur[4][4], xnext[4][4];
    bool ok[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = g + 8 * (e >> 1), u = ub + (e & 1);
      ok[e] = r < nb && u < H;
      c[e] = lm_ld(a.c0 + (size_t)(b0 + r) * H + u, ok[e]);
    }
    auto load_x = [&](float (&x)[4][4], int t) {
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const bf16* xr = a.xg + ((size_t)(b0 + g + 4 * e) * T + t) * 4 * H + ub;
#pragma unroll
        for (int q = 0; q < 4; ++q) lm_ld2<V>(xr + q * H, ok[e] && t < T, ok[e + 1] && t < T, x[q][e], x[q][e + 1]);
      }
    };
    // the streamed k-steps KR + s, KR + s + 1 (two uint4 each; nothing past NS)
    auto load_w = [&](uint4 (&w)[2][2], int s) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
        if (s + j < NS) {
          w[j][0] = wp[64 * (s + j)];
          w[j][1] = wp[64 * (s + j) + 1];
        }
    };
    load_x(xcur, 0);
    unsigned int phases = 0;
    const unsigned int bytes = (unsigned int)(LM_ROWS * d.Hp * sizeof(bf16));
    for (int t = 0; t < T; ++t) {
      load_x(xnext, t + 1);
      uint4 wnext[2][2] = {};
      load_w(wnext, 0);  // the weights do not wait for h
      if (t > 0) lm_wait(bars, t & 1, bytes, phases);
      const bf16* hb = hbuf + (t & 1) * LM_ROWS * LDH;
      float acc[2][4][4];
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[s][q][0] = acc[s][q][1] = acc[s][q][2] = acc[s][q][3] = 0.f;
      // k-step kk into the accumulator set ac (even k-steps into acc[0], odd into acc[1]), its b from shared memory
      auto kstep = [&](float (&ac)[4][4], int kk) {
        uint32_t af[4], b01[4], b23[4];
        load_a(af, hb + kk * 16, LDH, lane);
        load_b_kn(b01, wcol + (size_t)kk * 16 * LDN, LDN, lane);
        load_b_kn(b23, wcol + (size_t)kk * 16 * LDN + 2 * LM_GROUP, LDN, lane);
        mma16816(ac[0], af, b01[0], b01[1]);
        mma16816(ac[1], af, b01[2], b01[3]);
        mma16816(ac[2], af, b23[0], b23[1]);
        mma16816(ac[3], af, b23[2], b23[3]);
      };
      // the same from the packed copy (KR is even, so KR + s has the parity of s)
      auto kstep_l2 = [&](float (&ac)[4][4], int kk, const uint4 (&w)[2]) {
        uint32_t af[4];
        load_a(af, hb + kk * 16, LDH, lane);
        mma16816(ac[0], af, w[0].x, w[0].y);
        mma16816(ac[1], af, w[0].z, w[0].w);
        mma16816(ac[2], af, w[1].x, w[1].y);
        mma16816(ac[3], af, w[1].z, w[1].w);
      };
      for (int kk = 0; kk < KR; kk += 2) {
        kstep(acc[0], kk);
        if (kk + 1 < KR) kstep(acc[1], kk + 1);
      }
      for (int s = 0; s < NS; s += 2) {
        uint4 w[2][2];
#pragma unroll
        for (int j = 0; j < 2; ++j) w[j][0] = wnext[j][0], w[j][1] = wnext[j][1];
        load_w(wnext, s + 2);
        kstep_l2(acc[0], KR + s, w[0]);
        if (s + 1 < NS) kstep_l2(acc[1], KR + s + 1, w[1]);
      }
      float hv[4], gt[4][4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        gt[0][e] = sigmoid_f32(xcur[0][e] + (acc[0][0][e] + acc[1][0][e]));
        gt[1][e] = sigmoid_f32(xcur[1][e] + (acc[0][1][e] + acc[1][1][e]));
        gt[2][e] = tanhf(xcur[2][e] + (acc[0][2][e] + acc[1][2][e]));
        gt[3][e] = sigmoid_f32(xcur[3][e] + (acc[0][3][e] + acc[1][3][e]));
        c[e] = gt[1][e] * c[e] + gt[0][e] * gt[2][e];
        hv[e] = ok[e] ? gt[3][e] * tanhf(c[e]) : 0.f;  // rows past B and units past H enter the next product as zeros
      }
      if (t + 1 < T) {  // the exchange first: the other blocks wait on it, nothing waits on the stores
        uint32_t v[4];
        lm_gather(v, pack_bf16(hv[0], hv[1]), pack_bf16(hv[2], hv[3]), g, tig);
        const int r = g + 8 * (tig & 1);
        const uint32_t dst = smem_u32(hbuf + ((t + 1) & 1) * LM_ROWS * LDH + r * LDH + LM_GROUP * (gs + gl));
        const uint32_t bar = smem_u32(bars + ((t + 1) & 1));
        for (int q = tig >> 1; q < C; q += 2) lm_push16(dst, v, bar, q);
      }
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const size_t row = (size_t)(b0 + g + 4 * e) * T + t;
        lm_st2<V>(a.y + row * H + ub, ok[e], ok[e + 1], hv[e], hv[e + 1]);
        lm_st2<V>(a.cseq + row * H + ub, ok[e], ok[e + 1], c[e], c[e + 1]);
#pragma unroll
        for (int q = 0; q < 4; ++q) lm_st2<V>(a.gates + row * 4 * H + q * H + ub, ok[e], ok[e + 1], gt[q][e], gt[q][e + 1]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) xcur[q][e] = xnext[q][e];
    }
  }
  cluster.sync();  // no block leaves while another may still address its shared memory
}

struct LmBwdArgs {
  const float* dy;    // [B, T, H] f32
  const float* dc;    // [B, T, H] f32
  const bf16* gates;  // [B, T, 4H]
  const bf16* cseq;   // [B, T, H]
  const bf16* c0;     // [B, H]
  const bf16* wh;     // [H, 4H]
  const uint4* pack;  // the streamed chunks (lstm_mma_pack_bwd), or null where the rows are resident
  float* dxg;         // [B, T, 4H]
  float* dh0;         // [B, H]
  float* dc0;
  LmDims d;
};

// The backward's per-step inputs of a thread's four cells, loaded a step ahead.
struct LmBwdIn {
  float gt[4][4], cs[4], cp[4], dy[4], dc[4];
};

template <bool V, bool S>
__global__ void __launch_bounds__(32 * LM_MAX_WARPS, 1) lstm_mma_bwd(const LmBwdArgs a) {
  extern __shared__ __align__(16) unsigned char lm_smem[];
  __shared__ __align__(8) unsigned long long bars[2];
  const cg::cluster_group cluster = cg::this_cluster();
  const LmDims d = a.d;
  const int H = d.H, Hp = d.Hp, T = d.T, C = d.C, rank = (int)cluster.block_rank();
  const int b0 = (blockIdx.x / C) * LM_ROWS, nb = min(LM_ROWS, d.B - b0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, tig = lane & 3;
  const int ng = lm_split_count(d.G, C, rank), gs = lm_split_start(d.G, C, rank);
  const int RC = d.rc, NS = S ? d.G - RC : 0;    // 4 Hp = 32 G columns in G chunks of 32
  const int LDW = 32 * RC + LM_PAD, LDK = 4 * Hp + LM_PAD;
  bf16* w_s = reinterpret_cast<bf16*>(lm_smem);       // [8 gpb][LDW]: row 8 gl + j, column q Hp + v = Wh[8 (gs + gl) + j, q H + v]
  bf16* dbuf = w_s + (size_t)LM_GROUP * d.gpb * LDW;  // [nbuf][16][LDK]: round(dxg_{t+1}) of step t at parity (t + 1) & 1 (or 0)
  const bf16 zero = __float2bfloat16(0.f);

  const bool vec = H % 8 == 0 && (reinterpret_cast<uintptr_t>(a.wh) & 15) == 0;
  for (int i = tid; i < LM_GROUP * d.gpb * 4 * RC; i += blockDim.x) {  // 8-column chunks: 4 per 32 resident columns
    const int n = i / (4 * RC), col = (i - n * 4 * RC) * LM_GROUP, q = col / Hp, v0 = col - q * Hp;  // Hp % 8 == 0
    const int u = LM_GROUP * gs + n;  // the block's groups are contiguous: local row n is unit 8 gs + n
    bf16* dst = w_s + (size_t)n * LDW + col;
    const bf16* src = a.wh + (size_t)u * 4 * H + q * H + v0;
    const bool row_ok = n < LM_GROUP * ng && u < H;
    if (vec && row_ok && v0 + LM_GROUP <= H) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int j = 0; j < LM_GROUP; ++j) dst[j] = (row_ok && v0 + j < H) ? src[j] : zero;
    }
  }
  for (int i = tid; i < d.nbuf * LM_ROWS * LDK; i += blockDim.x) dbuf[i] = zero;
  lm_cluster_init(bars);
  cluster.sync();

  if (warp < ng) {
    const int gl = warp, ub = LM_GROUP * (gs + gl) + 2 * tig;
    const bf16* wrow = w_s + (size_t)gl * LM_GROUP * LDW;
    const uint4* wp = NS > 0 ? a.pack + (size_t)(gs + gl) * NS * 32 + lane : nullptr;  // streamed chunk RC + s at wp[32 s]
    bool ok[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) ok[e] = g + 8 * (e >> 1) < nb && ub + (e & 1) < H;
    auto load_in = [&](LmBwdIn& in, int t) {
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int r = g + 4 * e;
        const bool v0 = ok[e] && t >= 0, v1 = ok[e + 1] && t >= 0;
        const size_t row = (size_t)(b0 + r) * T + (t >= 0 ? t : 0);
#pragma unroll
        for (int q = 0; q < 4; ++q) lm_ld2<V>(a.gates + row * 4 * H + q * H + ub, v0, v1, in.gt[q][e], in.gt[q][e + 1]);
        lm_ld2<V>(a.cseq + row * H + ub, v0, v1, in.cs[e], in.cs[e + 1]);
        lm_ld2<V>(t > 0 ? a.cseq + (row - 1) * H + ub : a.c0 + (size_t)(b0 + r) * H + ub, v0, v1, in.cp[e], in.cp[e + 1]);
        lm_ld2<V>(a.dy + row * H + ub, v0, v1, in.dy[e], in.dy[e + 1]);
        lm_ld2<V>(a.dc + row * H + ub, v0, v1, in.dc[e], in.dc[e + 1]);
      }
    };
    // the streamed chunks RC + s, RC + s + 1 (one uint4 each; nothing past NS)
    auto load_w = [&](uint4 (&w)[2], int s) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
        if (s + j < NS) w[j] = wp[32 * (s + j)];
    };
    // dh of the thread's cells = round(dxg_{t+1}) . Wh^T over the 4 Hp columns, from the buffer of parity p; wnext
    // holds the first two streamed chunks on entry
    auto recurrent_dh = [&](float (&dh)[4], int p, uint4 (&wnext)[2]) {
      const bf16* db = dbuf + (d.nbuf == 2 ? p : 0) * LM_ROWS * LDK;
      float acc[4][4];
#pragma unroll
      for (int s = 0; s < 4; ++s) acc[s][0] = acc[s][1] = acc[s][2] = acc[s][3] = 0.f;
      // the 32 columns of chunk kc (k-steps 2 kc and 2 kc + 1) into the accumulator sets a0, a1: k-step kk into set kk mod 4
      auto chunk_mma = [&](float (&a0)[4], float (&a1)[4], int kc, const uint32_t (&bw)[4]) {
        uint32_t af[4];
        load_a(af, db + kc * 32, LDK, lane);
        mma16816(a0, af, bw[0], bw[1]);
        load_a(af, db + kc * 32 + 16, LDK, lane);
        mma16816(a1, af, bw[2], bw[3]);
      };
      auto chunk = [&](float (&a0)[4], float (&a1)[4], int kc) {
        uint32_t bw[4];
        ldsm_x4(bw, smem_u32(wrow + (lane & 7) * LDW + kc * 32 + (lane >> 3) * 8));  // b of k-step 2 kc, then 2 kc + 1
        chunk_mma(a0, a1, kc, bw);
      };
      for (int kc = 0; kc < RC; kc += 2) {
        chunk(acc[0], acc[1], kc);
        if (kc + 1 < RC) chunk(acc[2], acc[3], kc + 1);
      }
      for (int s = 0; s < NS; s += 2) {  // RC is even where chunks are streamed, so RC + s has the parity of s
        const uint32_t w0[4] = {wnext[0].x, wnext[0].y, wnext[0].z, wnext[0].w}, w1[4] = {wnext[1].x, wnext[1].y, wnext[1].z, wnext[1].w};
        load_w(wnext, s + 2);
        chunk_mma(acc[0], acc[1], RC + s, w0);
        if (s + 1 < NS) chunk_mma(acc[2], acc[3], RC + s + 1, w1);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) dh[e] = (acc[0][e] + acc[1][e]) + (acc[2][e] + acc[3][e]);
    };

    float dcar[4] = {0.f, 0.f, 0.f, 0.f}, dh[4] = {0.f, 0.f, 0.f, 0.f};
    LmBwdIn cur, nxt;
    load_in(cur, T - 1);
    unsigned int phases = 0;
    const unsigned int bytes = (unsigned int)(LM_ROWS * 4 * Hp * sizeof(bf16));
    for (int t = T - 1; t >= 0; --t) {
      load_in(nxt, t - 1);
      if (t + 1 < T) {
        uint4 wnext[2] = {};
        load_w(wnext, 0);  // the weights do not wait for dxg
        lm_wait(bars, (t + 1) & 1, bytes, phases);
        recurrent_dh(dh, (t + 1) & 1, wnext);
      }
      float da[4][4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float ig = cur.gt[0][e], fg = cur.gt[1][e], gg = cur.gt[2][e], og = cur.gt[3][e];
        const float tc = tanhf(cur.cs[e]);
        const float dhv = cur.dy[e] + dh[e];
        const float dov = dhv * tc;
        const float dct = dhv * og * (1.f - tc * tc) + dcar[e] + cur.dc[e];
        da[0][e] = dct * gg * ig * (1.f - ig);
        da[1][e] = dct * cur.cp[e] * fg * (1.f - fg);
        da[2][e] = dct * ig * (1.f - gg * gg);
        da[3][e] = dov * og * (1.f - og);
        dcar[e] = dct * fg;
        if (!ok[e]) {
#pragma unroll
          for (int q = 0; q < 4; ++q) da[q][e] = 0.f;  // rows past B and units past H enter the next product as zeros
        }
      }
      if (d.nbuf == 1 && t + 1 < T) cluster.sync();  // one buffer: every block has read dxg_{t+1} before any overwrites it
      const int r = g + 8 * (tig & 1);
      const uint32_t bar = smem_u32(bars + (t & 1));
      const bf16* drow = dbuf + (d.nbuf == 2 ? t & 1 : 0) * LM_ROWS * LDK + r * LDK + LM_GROUP * (gs + gl);
#pragma unroll
      for (int q = 0; q < 4; ++q) {  // the exchange first: the other blocks wait on it, nothing waits on the stores
        uint32_t v[4];
        lm_gather(v, pack_bf16(da[q][0], da[q][1]), pack_bf16(da[q][2], da[q][3]), g, tig);
        const uint32_t dst = smem_u32(drow + q * Hp);
        for (int k = tig >> 1; k < C; k += 2) lm_push16(dst, v, bar, k);
      }
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        float* dr = a.dxg + ((size_t)(b0 + g + 4 * e) * T + t) * 4 * H + ub;
#pragma unroll
        for (int q = 0; q < 4; ++q) lm_st2<V>(dr + q * H, ok[e], ok[e + 1], da[q][e], da[q][e + 1]);
      }
      cur = nxt;
    }
    uint4 wnext[2] = {};
    load_w(wnext, 0);
    lm_wait(bars, 0, bytes, phases);
    recurrent_dh(dh, 0, wnext);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (ok[e]) {
        const size_t o = (size_t)(b0 + g + 8 * (e >> 1)) * H + ub + (e & 1);
        a.dh0[o] = dh[e];
        a.dc0[o] = dcar[e];
      }
    }
  } else if (d.nbuf == 1) {
    for (int t = T - 2; t >= 0; --t) cluster.sync();  // a warp without a group takes the working warps' barriers
  }
  cluster.sync();
}

template <typename K, typename A>
int lm_launch(K kernel, const A& args, const LmDims& d, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cfg.gridDim = dim3((d.B + LM_ROWS - 1) / LM_ROWS * d.C);
  cfg.blockDim = dim3(32 * d.gpb);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = d.C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  if ((err = cudaLaunchKernelEx(&cfg, kernel, args)) != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The packing launch ahead of a kernel that streams part of its slices: `items` threads' worth of work.
template <typename K>
int lm_pack(K kernel, const bf16* wh, void* pack, const LmDims& d, long long items, cudaStream_t stream) {
  if (items == 0) return 0;
  if (!pack) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned int)std::min<long long>((items + 255) / 256, 4096), 256, 0, stream>>>(wh, (uint4*)pack, d);
  return (int)cudaGetLastError();
}

}  // namespace

}  // namespace tfasr

// The bf16 kernels' plan at width H, as lm_plan picks it: out[11] = C, groups (warps) per block, forward k-steps,
// of them resident, backward chunks, of them resident, backward dxg buffers, the forward's and the backward's
// dynamic shared memory per block and their packed copies' bytes. cudaErrorInvalidValue for a width no cluster runs.
extern "C" int tfasr_lstm_mma_plan(int H, long long* out) {
  using namespace tfasr;
  LmDims d;
  if (!lm_plan(H, d)) return (int)cudaErrorInvalidValue;
  const long long v[11] = {d.C, d.gpb, d.Kp / 16, d.kr, d.G, d.rc, d.nbuf, (long long)lm_fwd_smem(d), (long long)lm_bwd_smem(d),
                           (long long)lm_fwd_pack(d), (long long)lm_bwd_pack(d)};
  for (int i = 0; i < 11; ++i) out[i] = v[i];
  return 0;
}

// xg [B, T, 4H], wh [H, 4H], h0, c0 [B, H] bf16; y, cseq [B, T, H], gates [B, T, 4H] bf16; pack the plan's
// forward packed bytes (16-byte aligned; null where they are 0). The per-step loads and stores take two units at a
// time where H is even and the arrays are 4-byte aligned (one element at a time otherwise).
extern "C" int tfasr_lstm_mma_fwd(const void* xg, const void* wh, const void* h0, const void* c0, void* y, void* cseq, void* gates, void* pack,
                                  int B, int T, int H, void* stream) {
  using namespace tfasr;
  LmDims d;
  if (B <= 0 || T <= 0 || !lm_plan(H, d)) return (int)cudaErrorInvalidValue;
  d.B = B;
  d.T = T;
  const cudaStream_t st = (cudaStream_t)stream;
  int err = lm_pack(lstm_mma_pack_fwd, (const bf16*)wh, pack, d, (long long)d.G * (d.Kp / 16 - d.kr) * 32, st);
  if (err) return err;
  const LmFwdArgs a{(const bf16*)xg, (const bf16*)wh, (const uint4*)pack, (const bf16*)h0, (const bf16*)c0, (bf16*)y, (bf16*)cseq, (bf16*)gates, d};
  const bool v = H % 2 == 0 && lm_aligned(4, a.xg, a.y, a.cseq, a.gates), s = lm_fwd_pack(d) > 0;
  const auto kernel = v ? (s ? lstm_mma_fwd<true, true> : lstm_mma_fwd<true, false>) : (s ? lstm_mma_fwd<false, true> : lstm_mma_fwd<false, false>);
  return lm_launch(kernel, a, d, lm_fwd_smem(d), st);
}

// dy, dc [B, T, H] f32; gates, cseq, c0, wh bf16 as the forward saved them; pack the plan's backward packed bytes;
// dxg [B, T, 4H], dh0, dc0 [B, H] f32. Two units at a time as tfasr_lstm_mma_fwd (the f32 arrays 8-byte aligned).
extern "C" int tfasr_lstm_mma_bwd(const void* dy, const void* dc, const void* gates, const void* cseq, const void* c0, const void* wh, void* pack,
                                  void* dxg, void* dh0, void* dc0, int B, int T, int H, void* stream) {
  using namespace tfasr;
  LmDims d;
  if (B <= 0 || T <= 0 || !lm_plan(H, d)) return (int)cudaErrorInvalidValue;
  d.B = B;
  d.T = T;
  const cudaStream_t st = (cudaStream_t)stream;
  int err = lm_pack(lstm_mma_pack_bwd, (const bf16*)wh, pack, d, (long long)d.G * (d.G - d.rc) * 32, st);
  if (err) return err;
  const LmBwdArgs a{(const float*)dy, (const float*)dc, (const bf16*)gates, (const bf16*)cseq, (const bf16*)c0, (const bf16*)wh,
                    (const uint4*)pack, (float*)dxg, (float*)dh0, (float*)dc0, d};
  const bool v = H % 2 == 0 && lm_aligned(4, a.gates, a.cseq, a.c0) && lm_aligned(8, a.dy, a.dc, a.dxg), s = lm_bwd_pack(d) > 0;
  const auto kernel = v ? (s ? lstm_mma_bwd<true, true> : lstm_mma_bwd<true, false>) : (s ? lstm_mma_bwd<false, true> : lstm_mma_bwd<false, false>);
  return lm_launch(kernel, a, d, lm_bwd_smem(d), st);
}
