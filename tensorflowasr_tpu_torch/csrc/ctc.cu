// CTC loss over per-state log-probabilities on the extended lattice
// (states b, y1, b, y2, ..., b; S = 2U + 1): the alpha and beta sweeps over
// time, then the occupancy gradient (loss = -ll):
//   alpha[t, s] = lp[t, s] + LSE(alpha[t-1, s], alpha[t-1, s-1], alpha[t-1, s-2] + skip[s])
//   beta[t, s]  = LSE(beta[t+1, s] + lp[t+1, s], beta[t+1, s+1] + lp[t+1, s+1],
//                     beta[t+1, s+2] + lp[t+1, s+2] + skip[s+2])
//   ll = LSE(alpha[T_b-1, 2U_b], alpha[T_b-1, 2U_b-1]) (state 2U_b alone when U_b = 0)
//   occ[t, s] = -exp(alpha[t, s] + beta[t, s] - ll)
// States past 2U_b are LOG_0; occ is 0 past T_b and past state 2U_b.
//
// Replaces tensorflowasr_tpu/ops/pallas/ctc_kernel.py ctc_loss_pallas
// (_ctc_kernel via _ctc_pallas_call). The TPU kernel packs several examples
// into the lanes of one grid step (G lane groups, 384->512 lane padding,
// lengths by scalar prefetch) and stashes the loss in a spare row; none of
// that is carried over.
//
// Two launches. (1) beta does not depend on alpha, so the two sweeps of a
// row run at the same time, each in its own block of W = ceil(S / 32) warps
// (grid [2, B]): the chain per row is T_b dependent row updates, not 2 T_b.
// A lane owns one extended state and keeps its previous row in a register;
// its neighbours s-1 and s-2 (alpha) or s+1 and s+2 (beta) come by
// __shfl_up_sync / __shfl_down_sync, and across a warp boundary as a pair
// that the upstream warp's edge lane publishes into a double buffer in
// shared memory, with one named barrier of the W warps per step. Each lane loads
// its log-probability CTC_AHEAD rows ahead into registers (a warp's 32
// states are contiguous in lp_ext). alpha goes into the output buffer occ
// [B, T, S], beta into a scratch [B, T, S] (6.6 MB each at B 16, T 400,
// S 257: L2-resident); the alpha block writes the loss. (2) A parallel pass
// forms the occupancy of every cell in place over the alpha rows, 0 past T_b
// and past state 2U_b. lse3, the beta term (beta + lp) and
// (alpha + beta) - ll are the plain version's
// (ops/ctc_loss.py:ctc_occupancy_plain), operation for operation, and LOG_0
// sits exactly where the plain version puts it, so the two agree bit for bit.
//
// What bounds it on the card: not bytes (lp_ext read once, occ written once:
// 13.2 MB at the shape above, ~4 us at 3.35 TB/s) but the chain of T_b
// dependent row updates per row, each a log-sum-exp of three deep.
#include <algorithm>

#include "common.cuh"

namespace tfasr {

namespace {

constexpr float CTC_NEG = -1e30f;  // LOG_0 of the JAX package
constexpr int CTC_AHEAD = 8;       // rows of log-probabilities a lane keeps in flight in registers
constexpr int CTC_MAX_WARPS = 32;

// log(e^a + e^b + e^c) in the form of the JAX kernel's _lse3.
__device__ __forceinline__ float lse3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  return m + logf(expf(a - m) + expf(b - m) + expf(c - m));
}

struct CtcRow {
  int Tb, s_last;
};

__device__ __forceinline__ CtcRow ctc_row(const int* t_len, const int* u_len, int b, int T, int S) {
  // lengths clamped to the lattice for memory safety; callers pass 1 <= T_b <= T, 2 U_b + 1 <= S
  return CtcRow{min(max(t_len[b], 1), T), min(2 * max(u_len[b], 0), S - 1)};
}

// One block of W warps per (direction, row): blockIdx.x 0 sweeps alpha into `alpha`, 1 sweeps beta into `beta`.
// Step k takes row k (alpha) or row T_b - 1 - k (beta); each lane loads its log-probability of step k + CTC_AHEAD
// while it computes step k. The hand-off: step k of a warp reads its upstream neighbour's boundary pair of step
// k - 1 from slot (k - 1) & 1 and publishes its own pair of step k into slot k & 1; the named barrier that ends
// each step puts every write of a slot before its reads (one step later) and those reads before the slot's next
// write (two steps later), so two slots suffice.
__global__ void __launch_bounds__(32 * CTC_MAX_WARPS) ctc_sweep(const float* __restrict__ lp_ext, const float* __restrict__ skip_add,
                                                                const int* __restrict__ t_len, const int* __restrict__ u_len,
                                                                float* __restrict__ alpha, float* __restrict__ beta, float* __restrict__ loss,
                                                                int T, int S) {
  __shared__ float2 pairs[2][CTC_MAX_WARPS];  // [slot][warp]: the boundary pair each warp published
  __shared__ float fin[2];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, W = blockDim.x >> 5, s = threadIdx.x, b = blockIdx.y;
  const bool fwd = blockIdx.x == 0;
  const CtcRow row = ctc_row(t_len, u_len, b, T, S);
  const int Tb = row.Tb;
  const bool in = s < S, ok = s <= row.s_last;
  const float* lp = lp_ext + (size_t)b * T * S + s;
  auto load = [&](int k) { return in && k < Tb ? __ldg(lp + (size_t)(fwd ? k : Tb - 1 - k) * S) : 0.f; };
  const int up = fwd ? warp - 1 : (warp + 1 < W ? warp + 1 : -1);  // the warp this one reads (-1: none)
  const bool publish = fwd ? warp + 1 < W : warp > 0;               // a downstream warp reads this one
  // the upstream pair of step k (a broadcast); (CTC_NEG, CTC_NEG) where there is no upstream warp
  auto upstream = [&](int k) { return up < 0 ? make_float2(CTC_NEG, CTC_NEG) : pairs[k & 1][up]; };
  auto step_done = [&]() {
    if (W > 1) asm volatile("bar.sync 1, %0;\n" ::"r"(32 * W) : "memory");
  };
  float pre[CTC_AHEAD];
#pragma unroll
  for (int j = 0; j < CTC_AHEAD; ++j) pre[j] = load(j);
  __syncthreads();

  if (fwd) {
    // alpha: n1, n2 = alpha[s-1], alpha[s-2] of the previous row; lanes 0 and 1 take them from the upstream pair (its lanes 30, 31)
    const float skip = in ? skip_add[(size_t)b * S + s] : CTC_NEG;
    float* out = alpha + (size_t)b * T * S + s;
    float a = CTC_NEG, n1 = CTC_NEG, n2 = CTC_NEG;
    for (int k0 = 0; k0 < Tb; k0 += CTC_AHEAD) {
#pragma unroll
      for (int j = 0; j < CTC_AHEAD; ++j) {
        const int k = k0 + j;
        if (k >= Tb) break;
        const float lpk = pre[j];
        pre[j] = load(k + CTC_AHEAD);
        if (k == 0) {
          a = ok && s < 2 ? lpk : CTC_NEG;
        } else {
          const float2 e = upstream(k - 1);
          if (lane == 0) n1 = e.y;
          if (lane < 2) n2 = lane == 0 ? e.x : e.y;
          a = ok ? lse3(a, n1, n2 + skip) + lpk : CTC_NEG;
        }
        if (in) out[(size_t)k * S] = a;
        n1 = __shfl_up_sync(0xffffffffu, a, 1);
        n2 = __shfl_up_sync(0xffffffffu, a, 2);
        if (lane == 31 && publish) pairs[k & 1][warp] = make_float2(n1, a);  // (alpha of lane 30, of lane 31)
        step_done();
      }
    }
    if (s == row.s_last) fin[0] = a;
    if (s == row.s_last - 1) fin[1] = a;
    __syncthreads();
    if (s == 0) loss[b] = -lse3(fin[0], row.s_last > 0 ? fin[1] : CTC_NEG, CTC_NEG);
  } else {
    // beta: term = beta[t+1] + lp[t+1] of each state (CTC_NEG at and past S); n1, n2 = the terms of s+1 and s+2;
    // lanes 31 and 30 take them from the upstream pair (its lanes 0, 1)
    const float skip2 = s + 2 < S ? skip_add[(size_t)b * S + s + 2] : CTC_NEG;
    float* out = beta + (size_t)b * T * S + s;
    float term = CTC_NEG, n1 = CTC_NEG, n2 = CTC_NEG;
    for (int k0 = 0; k0 < Tb; k0 += CTC_AHEAD) {
#pragma unroll
      for (int j = 0; j < CTC_AHEAD; ++j) {
        const int k = k0 + j;
        if (k >= Tb) break;
        const float lpk = pre[j];
        pre[j] = load(k + CTC_AHEAD);
        float bt;
        if (k == 0) {
          bt = ok && (s == row.s_last || (s == row.s_last - 1 && row.s_last > 0)) ? 0.f : CTC_NEG;  // beta on row T_b - 1
        } else {
          const float2 e = upstream(k - 1);
          if (lane == 31) n1 = e.x;
          if (lane >= 30) n2 = lane == 31 ? e.y : e.x;
          bt = ok ? lse3(term, n1, n2 + skip2) : CTC_NEG;
        }
        const int r = Tb - 1 - k;
        if (in) out[(size_t)r * S] = bt;
        if (r > 0) {
          term = in ? bt + lpk : CTC_NEG;
          n1 = __shfl_down_sync(0xffffffffu, term, 1);
          n2 = __shfl_down_sync(0xffffffffu, term, 2);
          if (lane == 0 && publish) pairs[k & 1][warp] = make_float2(term, n1);  // (the term of lane 0, of lane 1)
          step_done();
        }
      }
    }
  }
}

// occ = -exp((alpha + beta) - ll) over every cell, in place over the alpha rows; 0 past T_b and past state 2U_b.
__global__ void ctc_occupancy(const float* __restrict__ beta, const int* __restrict__ t_len, const int* __restrict__ u_len,
                              const float* __restrict__ loss, float* __restrict__ occ, int B, int T, int S) {
  const size_t n = (size_t)B * T * S;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += (size_t)gridDim.x * blockDim.x) {
    const int b = (int)(i / ((size_t)T * S)), rem = (int)(i - (size_t)b * T * S), t = rem / S, s = rem - t * S;
    const CtcRow row = ctc_row(t_len, u_len, b, T, S);
    const float ll = -loss[b];
    float o = 0.f;
    if (t < row.Tb && s <= row.s_last) o = -expf(occ[i] + beta[i] - ll);
    occ[i] = o;
  }
}

}  // namespace

}  // namespace tfasr

// lp_ext [B, T, S] f32, skip_add [B, S] f32; t_len, u_len [B] int32; occ [B, T, S] f32 (the alpha rows pass through it);
// loss [B] f32; scratch: [B, T, S] f32 (the beta rows). S <= 1024.
extern "C" int tfasr_ctc(const void* lp_ext, const void* skip_add, const void* t_len, const void* u_len, void* occ, void* loss, void* scratch,
                         int B, int T, int S, void* stream) {
  using namespace tfasr;
  if (B == 0 || T == 0) return 0;
  if (S > 32 * CTC_MAX_WARPS) return (int)cudaErrorInvalidValue;
  const auto* tl = (const int*)t_len;
  const auto* ul = (const int*)u_len;
  auto s = (cudaStream_t)stream;
  ctc_sweep<<<dim3(2, B), 32 * ((S + 31) / 32), 0, s>>>((const float*)lp_ext, (const float*)skip_add, tl, ul, (float*)occ, (float*)scratch,
                                                    (float*)loss, T, S);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)B * T * S;
  ctc_occupancy<<<(int)std::min<size_t>((n + 255) / 256, 132 * 16), 256, 0, s>>>((const float*)scratch, tl, ul, (const float*)loss, (float*)occ, B,
                                                                                T, S);
  return (int)cudaGetLastError();
}
