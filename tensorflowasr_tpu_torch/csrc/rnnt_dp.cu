// RNN-T loss over per-cell log-probabilities: alpha forward along the
// anti-diagonals, then beta backward with the occupancy gradients in the
// same sweep (loss = -ll):
//   alpha[t,u] = LSE(alpha[t-1,u] + lpb[t-1,u], alpha[t,u-1] + lpe[t,u-1]), alpha[0,0] = 0
//   beta[t,u]  = LSE(lpb[t,u] + beta[t+1,u], lpe[t,u] + beta[t,u+1]), beta = 0 at the exit after (T_b-1, U_b)
//   ll = alpha[T_b-1,U_b] + lpb[T_b-1,U_b]
//   gbl[t,u] = -exp(alpha[t,u] + lpb[t,u] + beta[t+1,u] - ll)
//   gem[t,u] = -exp(alpha[t,u] + lpe[t,u] + beta[t,u+1] - ll)
// Cells outside t < T_b, u <= U_b hold 0 in gbl and gem.
//
// Replaces tensorflowasr_tpu/ops/pallas/rnnt_kernel.py rnnt_loss_from_logprobs
// (_rnnt_kernel via _rnnt_pallas_call). The TPU kernel works in skewed
// coordinates with lane-packed examples and stashes the loss in a spare
// row; none of that is carried over. Here one block owns one batch row and
// one thread owns one label position u (blockDim = U+1 rounded up to a warp
// multiple, at most 1024). A diagonal d = t + u is one step: each thread
// keeps its own column's previous value in a register and reads its left
// (forward) or right (backward) neighbour's from the previous diagonal in
// shared memory, double-buffered, so each diagonal costs one barrier. The
// loads of the next diagonal's log-probabilities are issued before the
// barrier. alpha goes to a device-memory scratch in natural (t, u)
// coordinates ([B, T, U+1] f32; 3.3 MB at the flagship, L2-resident) and is
// read back in the backward sweep; beta never leaves registers and shared
// memory. The sweeps stop at the row's last diagonal T_b - 1 + U_b, and the
// cells beyond it are written 0 at the end.
//
// What bounds it on the card: not bytes (lpb and lpe read once, gbl and gem
// written once: 13.2 MB at B 16, T 400, U+1 129, ~4 us at 3.35 TB/s) but
// the chain of dependent steps: 2 x (T_b + U_b) barriers per row, with only
// B blocks in flight. A first version; faster variants (several rows per
// block, fewer barriers per diagonal) are later work.
#include "common.cuh"

namespace tfasr {

constexpr float DP_NEG = -1e30f;  // LOG_0 of the JAX package

__device__ __forceinline__ float log_add_exp(float a, float b) {
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

__global__ void rnnt_dp_kernel(const float* __restrict__ lpb, const float* __restrict__ lpe,
                               const int* __restrict__ t_len, const int* __restrict__ u_len,
                               float* __restrict__ loss, float* __restrict__ gbl, float* __restrict__ gem,
                               float* __restrict__ alpha, int T, int U1) {
  extern __shared__ float sh[];  // two diagonals of U1 + 2 values: [0] and [U1 + 1] stay DP_NEG
  __shared__ float ll_s;
  const int b = blockIdx.x, u = threadIdx.x, W = U1 + 2;
  // lengths are clamped to the lattice for memory safety; callers pass 1 <= T_b <= T, 0 <= U_b <= U
  const int Tb = min(max(t_len[b], 1), T), Ub = min(max(u_len[b], 0), U1 - 1);
  const int d_final = Tb - 1 + Ub;
  const size_t base = (size_t)b * T * U1;
  const float* pb = lpb + base;
  const float* pe = lpe + base;
  float* al = alpha + base;
  float* gb = gbl + base;
  float* ge = gem + base;
  const bool col = u < U1 && u <= Ub;  // a lattice column of this row

  for (int i = u; i < 2 * W; i += blockDim.x) sh[i] = DP_NEG;
  __syncthreads();
  float* cur = sh;
  float* prev = sh + W;

  // ---- forward: alpha on diagonals 0..d_final ----
  float a = (u == 0) ? 0.f : DP_NEG;  // alpha on the previous diagonal, this column
  if (u == 0) al[0] = 0.f;
  if (u < U1) cur[u + 1] = a;
  // the operands of diagonal d for this column: lpb[t-1, u] and lpe[t, u-1], t = d - u
  auto fwd_load = [&](int d, float& fb, float& fe) {
    const int t = d - u;
    fb = fe = DP_NEG;
    if (col && t >= 0 && t < Tb) {
      if (t >= 1) fb = pb[(size_t)(t - 1) * U1 + u];
      if (u >= 1) fe = pe[(size_t)t * U1 + u - 1];
    }
  };
  float nb, ne;
  fwd_load(1, nb, ne);
  __syncthreads();
  for (int d = 1; d <= d_final; ++d) {
    float* tmp = prev;
    prev = cur;
    cur = tmp;
    const float fb = nb, fe = ne;
    fwd_load(d + 1, nb, ne);
    const int t = d - u;
    const bool valid = col && t >= 0 && t < Tb;
    a = valid ? log_add_exp(a + fb, prev[u] + fe) : DP_NEG;  // prev[u] is column u - 1
    if (u < U1) cur[u + 1] = a;
    if (valid) al[(size_t)t * U1 + u] = a;
    __syncthreads();
  }
  if (u == Ub) ll_s = a + pb[(size_t)(Tb - 1) * U1 + Ub];
  __syncthreads();
  const float ll = ll_s;
  if (u == 0) loss[b] = -ll;

  // ---- backward: beta and the gradients on diagonals d_final..0 ----
  float bn = (u == Ub) ? 0.f : DP_NEG;  // beta on the next diagonal (d + 1), this column: the exit seed
  {
    float* tmp = prev;
    prev = cur;
    cur = tmp;
  }
  if (u < U1) cur[u + 1] = bn;
  // the operands of diagonal d for this column: lpb, lpe and alpha at (t, u), t = d - u
  auto bwd_load = [&](int d, float& fb, float& fe, float& fa) {
    const int t = d - u;
    fb = fe = fa = DP_NEG;
    if (col && t >= 0 && t < Tb) {
      const size_t o = (size_t)t * U1 + u;
      fb = pb[o];
      fe = pe[o];
      fa = al[o];
    }
  };
  float na;
  bwd_load(d_final, nb, ne, na);
  __syncthreads();
  for (int d = d_final; d >= 0; --d) {
    float* tmp = prev;
    prev = cur;
    cur = tmp;
    const float fb = nb, fe = ne, fa = na;
    if (d > 0) bwd_load(d - 1, nb, ne, na);
    const int t = d - u;
    float beta = DP_NEG;
    if (col && t >= 0 && t < Tb) {
      const float right = prev[u + 2];  // beta[t, u + 1], column u + 1 of diagonal d + 1
      beta = log_add_exp(fb + bn, fe + right);
      const size_t o = (size_t)t * U1 + u;
      gb[o] = -expf(fa + fb + bn - ll);
      ge[o] = -expf(fa + fe + right - ll);
    } else if (u < U1 && t >= 0 && t < T) {
      const size_t o = (size_t)t * U1 + u;
      gb[o] = 0.f;
      ge[o] = 0.f;
    }
    bn = beta;
    if (u < U1) cur[u + 1] = bn;
    __syncthreads();
  }
  // cells past the last diagonal
  if (u < U1)
    for (int t = max(0, d_final + 1 - u); t < T; ++t) {
      const size_t o = (size_t)t * U1 + u;
      gb[o] = 0.f;
      ge[o] = 0.f;
    }
}

}  // namespace tfasr

// lpb, lpe [B, T, U1] f32 (lpe[..., U1 - 1] = LOG_0); t_len, u_len [B] int32;
// loss [B], gbl, gem [B, T, U1] f32; alpha: [B, T, U1] f32 scratch. U1 <= 1024.
extern "C" int tfasr_rnnt_dp(const void* lpb, const void* lpe, const void* t_len, const void* u_len, void* loss,
                             void* gbl, void* gem, void* alpha, int B, int T, int U1, void* stream) {
  using namespace tfasr;
  if (B == 0) return 0;
  const int threads = (U1 + 31) / 32 * 32;
  if (threads > 1024) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)2 * (U1 + 2) * sizeof(float);
  rnnt_dp_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      (const float*)lpb, (const float*)lpe, (const int*)t_len, (const int*)u_len, (float*)loss, (float*)gbl,
      (float*)gem, (float*)alpha, T, U1);
  return (int)cudaGetLastError();
}
