// RNN-T loss over per-cell log-probabilities: the alpha and beta sweeps
// along the anti-diagonals, then the occupancy gradients (loss = -ll):
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
// row; only the skew is kept, for coalesced loads.
//
// Three launches. (1) A parallel pass copies the operands into diagonal-major
// order, [B, T + U1 - 1, 32 W] for each row, diagonal d and label position
// u: lpb[d-u, u], lpe[d-u, u] and lpe[d-u, u-1] (zero off the lattice), so
// that one load instruction of a warp reads 32 consecutive floats. (2) beta
// does not depend on alpha, so the two sweeps of a row run at the same time,
// each in its own block of W = ceil(U1 / 32) warps (grid [2, B]): the chain
// per row is one sweep of T_b + U_b diagonals, not two. A lane owns one
// label position and keeps its previous diagonal in a register; its
// neighbour comes by one __shfl_up_sync (alpha) or __shfl_down_sync (beta),
// across a warp boundary through a double-buffered slot in shared memory,
// with one named barrier among the W warps per diagonal (none when W is 1).
// (Two or four positions per lane with fewer warps timed slower on an
// H100 at the flagship shape.) Each lane prefetches its own
// operands DP_RING - 2 diagonals ahead with 4-byte cp.async into a ring in
// shared memory and waits only on its own copies. alpha and beta go to
// scratch in the same diagonal-major order (coalesced stores); the alpha
// sweep writes the loss. (3) A fully parallel pass forms gbl and gem for
// every cell (0 off the lattice). The
// log-add-exp and the gradient expressions are those of the plain version
// (ops/rnnt_loss.py), operation for operation, so the two agree bit for bit.
//
// What bounds it on the card: not bytes (lpb and lpe read once, gbl and gem
// written once: 13.2 MB at B 16, T 400, U+1 129, ~4 us at 3.35 TB/s; the
// skewed copies and the lattices add ~30 MB of mostly L2 traffic) but the
// chain of T_b + U_b dependent diagonals per row, each a log-add-exp and a
// barrier deep.
#include <algorithm>

#include "mma.cuh"

namespace tfasr {

namespace {

constexpr float DP_NEG = -1e30f;  // LOG_0 of the JAX package
constexpr int DP_RING = 8;        // diagonals of operands a lane keeps in flight or in its ring (a power of two)
constexpr int DP_MAX_WARPS = 32;

struct DpDims {
  int B, T, U1, D, W, S;  // D = T + U1 - 1 diagonals; W warps a sweep; S = 32 W label positions a diagonal
};

__device__ __forceinline__ float log_add_exp(float a, float b) {
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

// The memory clobbers keep the compiler from moving shared-memory reads of the ring across the copies and waits.
__device__ __forceinline__ void dp_cp4(uint32_t dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(ok ? 4 : 0) : "memory");
}
__device__ __forceinline__ void dp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void dp_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(DP_RING - 2) : "memory"); }

struct DpRow {
  int Tb, Ub, d_final;
};

__device__ __forceinline__ DpRow dp_row(const int* t_len, const int* u_len, int b, int T, int U1) {
  DpRow r;
  // lengths are clamped to the lattice for memory safety; callers pass 1 <= T_b <= T, 0 <= U_b <= U
  r.Tb = min(max(t_len[b], 1), T);
  r.Ub = min(max(u_len[b], 0), U1 - 1);
  r.d_final = r.Tb - 1 + r.Ub;
  return r;
}

// sb, se, sf [B, D, S]: lpb[d-u, u], lpe[d-u, u], lpe[d-u, u-1] at [b, d, u], zero off the lattice.
__global__ void rnnt_dp_skew(const float* __restrict__ lpb, const float* __restrict__ lpe, float* __restrict__ sb, float* __restrict__ se,
                             float* __restrict__ sf, DpDims g) {
  const size_t n = (size_t)g.B * g.D * g.S;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += (size_t)gridDim.x * blockDim.x) {
    const int b = (int)(i / ((size_t)g.D * g.S)), rem = (int)(i - (size_t)b * g.D * g.S), d = rem / g.S, u = rem - d * g.S, t = d - u;
    const bool in = u < g.U1 && t >= 0 && t < g.T;
    const size_t o = in ? ((size_t)b * g.T + t) * g.U1 + u : 0;
    sb[i] = in ? lpb[o] : 0.f;
    se[i] = in ? lpe[o] : 0.f;
    sf[i] = in && u >= 1 ? lpe[o - 1] : 0.f;
  }
}

// One block of W warps per (direction, row): blockIdx.x 0 sweeps alpha, 1 beta. ring: [W][DP_RING][2][32] f32.
__global__ void __launch_bounds__(32 * DP_MAX_WARPS) rnnt_dp_sweep(const float* __restrict__ sb, const float* __restrict__ se,
                                                                   const float* __restrict__ sf, const float* __restrict__ lpb,
                                                                   const int* __restrict__ t_len, const int* __restrict__ u_len,
                                                                   float* __restrict__ loss, float* __restrict__ alpha, float* __restrict__ beta,
                                                                   DpDims g) {
  extern __shared__ float ring[];
  __shared__ float edge[2][DP_MAX_WARPS];  // a warp's boundary column of the diagonal just done, by parity
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, W = g.W, S = g.S, u = threadIdx.x;  // this lane's label position
  const DpRow row = dp_row(t_len, u_len, blockIdx.y, g.T, g.U1);
  const size_t rbase = (size_t)blockIdx.y * g.D * S + u;
  auto slot = [&](int d, int arr) { return ring + ((warp * DP_RING + (d & (DP_RING - 1))) * 2 + arr) * 32 + lane; };
  auto cell = [&](int d) { return u <= row.Ub && d - u >= 0 && d - u < row.Tb; };  // a lattice cell of this row (u < U1 follows)
  auto sync = [&]() {
    if (W > 1) asm volatile("bar.sync 1, %0;\n" ::"r"(32 * W) : "memory");
  };

  if (blockIdx.x == 0) {
    // alpha on diagonals 0..d_final; the operands of (t, u): lpb[t-1, u] (diagonal d - 1 of sb) and lpe[t, u-1] (diagonal d of sf)
    auto fetch = [&](int d) {
      if (d <= row.d_final) {
        const bool ok = cell(d);
        const size_t o = rbase + (size_t)d * S;
        dp_cp4(smem_u32(slot(d, 0)), ok && d - u >= 1 ? sb + o - S : sb, ok && d - u >= 1);
        dp_cp4(smem_u32(slot(d, 1)), ok && u >= 1 ? sf + o : sf, ok && u >= 1);
      }
      dp_commit();
    };
    float a = u == 0 ? 0.f : DP_NEG;  // alpha on the previous diagonal
    if (u == 0) alpha[rbase] = 0.f;
    if (lane == 31) edge[0][warp] = a;
    for (int d = 1; d < DP_RING - 1; ++d) fetch(d);
    sync();
    for (int d = 1; d <= row.d_final; ++d) {
      fetch(d + DP_RING - 2);
      dp_wait();
      float left = __shfl_up_sync(0xffffffffu, a, 1);  // column u - 1 on diagonal d - 1
      if (lane == 0) left = warp > 0 ? edge[(d - 1) & 1][warp - 1] : DP_NEG;
      const bool ok = cell(d);
      const float fb = ok && d - u >= 1 ? *slot(d, 0) : DP_NEG, fe = ok && u >= 1 ? *slot(d, 1) : DP_NEG;
      a = ok ? log_add_exp(a + fb, left + fe) : DP_NEG;
      if (ok) alpha[rbase + (size_t)d * S] = a;
      if (lane == 31) edge[d & 1][warp] = a;
      sync();
    }
    if (u == row.Ub) loss[blockIdx.y] = -(a + lpb[((size_t)blockIdx.y * g.T + row.Tb - 1) * g.U1 + row.Ub]);
  } else {
    // beta on diagonals d_final..0; the operands of (t, u): lpb[t, u] and lpe[t, u] (diagonal d of sb and se)
    auto fetch = [&](int d) {
      if (d >= 0) {
        const bool ok = cell(d);
        const size_t o = rbase + (size_t)d * S;
        dp_cp4(smem_u32(slot(d, 0)), ok ? sb + o : sb, ok);
        dp_cp4(smem_u32(slot(d, 1)), ok ? se + o : se, ok);
      }
      dp_commit();
    };
    float bn = u == row.Ub ? 0.f : DP_NEG;  // beta on diagonal d + 1: the exit seed first
    if (lane == 0) edge[(row.d_final + 1) & 1][warp] = bn;
    for (int i = 0; i < DP_RING - 2; ++i) fetch(row.d_final - i);
    sync();
    for (int d = row.d_final; d >= 0; --d) {
      fetch(d - (DP_RING - 2));
      dp_wait();
      float right = __shfl_down_sync(0xffffffffu, bn, 1);  // column u + 1 on diagonal d + 1
      if (lane == 31) right = warp + 1 < W ? edge[(d + 1) & 1][warp + 1] : DP_NEG;
      const bool ok = cell(d);
      bn = ok ? log_add_exp(*slot(d, 0) + bn, *slot(d, 1) + right) : DP_NEG;
      if (ok) beta[rbase + (size_t)d * S] = bn;
      if (lane == 0) edge[d & 1][warp] = bn;
      sync();
    }
  }
}

// gbl and gem of every cell from the two sweeps' lattices and the loss.
__global__ void rnnt_dp_grads(const float* __restrict__ lpb, const float* __restrict__ lpe, const int* __restrict__ t_len,
                              const int* __restrict__ u_len, const float* __restrict__ loss, const float* __restrict__ alpha,
                              const float* __restrict__ beta, float* __restrict__ gbl, float* __restrict__ gem, DpDims g) {
  const size_t n = (size_t)g.B * g.T * g.U1;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += (size_t)gridDim.x * blockDim.x) {
    const int b = (int)(i / ((size_t)g.T * g.U1)), rem = (int)(i - (size_t)b * g.T * g.U1), t = rem / g.U1, u = rem - t * g.U1;
    const DpRow row = dp_row(t_len, u_len, b, g.T, g.U1);
    float g0 = 0.f, g1 = 0.f;
    if (t < row.Tb && u <= row.Ub) {
      const size_t o = (size_t)b * g.D * g.S + (size_t)(t + u) * g.S + u;  // (t, u) on diagonal t + u; the next diagonal at + S
      const float ll = -loss[b], fa = alpha[o];
      const float bn = t + 1 < row.Tb ? beta[o + g.S] : (u == row.Ub ? 0.f : DP_NEG);  // beta[t+1, u], the exit seed past T_b - 1
      const float right = u + 1 <= row.Ub ? beta[o + g.S + 1] : DP_NEG;              // beta[t, u+1]
      g0 = -expf(fa + lpb[i] + bn - ll);
      g1 = -expf(fa + lpe[i] + right - ll);
    }
    gbl[i] = g0;
    gem[i] = g1;
  }
}

inline int dp_blocks(size_t n) { return (int)std::min<size_t>((n + 255) / 256, 132 * 16); }

}  // namespace

}  // namespace tfasr

// lpb, lpe [B, T, U1] f32 (lpe[..., U1 - 1] = LOG_0); t_len, u_len [B] int32; loss [B], gbl, gem [B, T, U1] f32;
// scratch: 5 [B, T + U1 - 1, 32 ceil(U1 / 32)] f32 arrays (the skewed operands and the two lattices). U1 <= 1024.
extern "C" int tfasr_rnnt_dp(const void* lpb, const void* lpe, const void* t_len, const void* u_len, void* loss, void* gbl, void* gem,
                             void* scratch, int B, int T, int U1, void* stream) {
  using namespace tfasr;
  if (B == 0) return 0;
  const int W = (U1 + 31) / 32;
  if (W > DP_MAX_WARPS) return (int)cudaErrorInvalidValue;
  const DpDims g{B, T, U1, T + U1 - 1, W, 32 * W};
  const size_t plane = (size_t)B * g.D * g.S;
  float* sb = (float*)scratch;
  float *se = sb + plane, *sf = se + plane, *al = sf + plane, *be = al + plane;
  const float *pb = (const float*)lpb, *pe = (const float*)lpe;
  const int *tl = (const int*)t_len, *ul = (const int*)u_len;
  auto s = (cudaStream_t)stream;
  rnnt_dp_skew<<<dp_blocks(plane), 256, 0, s>>>(pb, pe, sb, se, sf, g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)W * DP_RING * 2 * 32 * sizeof(float);
  if ((err = allow_smem(rnnt_dp_sweep, smem)) != cudaSuccess) return (int)err;
  rnnt_dp_sweep<<<dim3(2, B), 32 * W, smem, s>>>(sb, se, sf, pb, tl, ul, (float*)loss, al, be, g);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  rnnt_dp_grads<<<dp_blocks((size_t)B * T * U1), 256, 0, s>>>(pb, pe, tl, ul, (const float*)loss, al, be, (float*)gbl, (float*)gem, g);
  return (int)cudaGetLastError();
}
