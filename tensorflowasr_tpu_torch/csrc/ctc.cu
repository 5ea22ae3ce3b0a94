// CTC loss over per-state log-probabilities on the extended lattice
// (states b, y1, b, y2, ..., b; S = 2U + 1): alpha forward over time, then
// beta backward with the occupancy gradient in the same sweep (loss = -ll):
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
// that is carried over. Here one block owns one batch row and one thread
// owns one extended state (blockDim = S rounded up to a warp multiple, at
// most 1024). A time step is one row update: each thread keeps its own
// state's previous value in a register and reads its neighbours' (s-1, s-2
// forward; s+1, s+2 backward) from the previous row in shared memory,
// double-buffered, so each step costs one barrier; the next row's
// log-probability is loaded before the barrier. The alpha rows go into the
// output buffer occ [B, T, S] (6.6 MB at B 16, T 400, S 257: L2-resident),
// and the backward sweep reads each back and overwrites it with the
// occupancy, so the kernel needs no scratch. The sweeps run over the row's
// T_b frames only; the rows past T_b are written 0.
//
// What bounds it on the card: not bytes (lp_ext read once and occ written
// once: 13.2 MB at the shape above, ~4 us at 3.35 TB/s) but the chain of
// 2 x T_b dependent row updates, each a barrier, with only B blocks in
// flight. A single-warp variant with shuffles (no barrier) is later work.
#include "common.cuh"

namespace tfasr {

constexpr float CTC_NEG = -1e30f;  // LOG_0 of the JAX package

// log(e^a + e^b + e^c) in the form of the JAX kernel's _lse3.
__device__ __forceinline__ float lse3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  return m + logf(expf(a - m) + expf(b - m) + expf(c - m));
}

__global__ void ctc_kernel(const float* __restrict__ lp_ext, const float* __restrict__ skip_add,
                           const int* __restrict__ t_len, const int* __restrict__ u_len, float* __restrict__ occ,
                           float* __restrict__ loss, int T, int S) {
  extern __shared__ float sh[];  // two rows of S + 2 values
  __shared__ float fin_s[2];
  const int b = blockIdx.x, s = threadIdx.x, W = S + 2;
  // lengths clamped to the lattice for memory safety; callers pass 1 <= T_b <= T, 2 U_b + 1 <= S
  const int Tb = min(max(t_len[b], 1), T);
  const int s_last = min(2 * max(u_len[b], 0), S - 1);
  const bool in = s < S;
  const bool ok = s <= s_last;
  const float* lp = lp_ext + (size_t)b * T * S;
  float* oc = occ + (size_t)b * T * S;
  const float skip = in ? skip_add[(size_t)b * S + s] : CTC_NEG;

  for (int i = s; i < 2 * W; i += blockDim.x) sh[i] = CTC_NEG;
  __syncthreads();

  // ---- forward: alpha on rows 0..T_b-1; row r lives at sh[(r & 1) * W + 2 + s] ----
  float a = (ok && s < 2) ? lp[s] : CTC_NEG;
  if (in) {
    oc[s] = a;
    sh[2 + s] = a;
  }
  float nlp = (in && Tb > 1) ? lp[(size_t)S + s] : 0.f;
  __syncthreads();
  for (int t = 1; t < Tb; ++t) {
    const float* prev = sh + ((t - 1) & 1) * W;
    float* cur = sh + (t & 1) * W;
    const float lpt = nlp;
    if (in && t + 1 < Tb) nlp = lp[(size_t)(t + 1) * S + s];
    a = ok ? lse3(a, prev[1 + s], prev[s] + skip) + lpt : CTC_NEG;
    if (in) {
      cur[2 + s] = a;
      oc[(size_t)t * S + s] = a;
    }
    __syncthreads();
  }
  if (s == s_last) fin_s[0] = a;
  if (s == s_last - 1) fin_s[1] = a;
  __syncthreads();
  const float ll = lse3(fin_s[0], s_last > 0 ? fin_s[1] : CTC_NEG, CTC_NEG);
  if (s == 0) loss[b] = -ll;

  // ---- backward: beta on rows T_b-1..0 and the occupancy; term0 = beta + lp of row r
  //      lives at sh[(r & 1) * W + s], with CTC_NEG at S and S + 1 ----
  const float skip2 = (s + 2 < S) ? skip_add[(size_t)b * S + s + 2] : CTC_NEG;
  __syncthreads();  // every thread has read fin_s and the forward rows
  for (int i = s; i < 2 * W; i += blockDim.x) sh[i] = CTC_NEG;
  __syncthreads();
  float beta = (s == s_last || (s == s_last - 1 && s_last > 0)) ? 0.f : CTC_NEG;
  if (!ok) beta = CTC_NEG;
  for (int t = Tb - 1;; --t) {
    if (in) {
      const size_t o = (size_t)t * S + s;
      oc[o] = ok ? -expf(oc[o] + beta - ll) : 0.f;
    }
    if (t == 0) break;
    float* cur = sh + (t & 1) * W;
    if (in) cur[s] = beta + lp[(size_t)t * S + s];
    __syncthreads();
    beta = ok ? lse3(cur[s], cur[s + 1], cur[s + 2] + skip2) : CTC_NEG;
  }
  // rows past T_b
  if (in)
    for (int t = Tb; t < T; ++t) oc[(size_t)t * S + s] = 0.f;
}

}  // namespace tfasr

// lp_ext [B, T, S] f32, skip_add [B, S] f32; t_len, u_len [B] int32;
// occ [B, T, S] f32 (the alpha rows pass through it); loss [B] f32. S <= 1024.
extern "C" int tfasr_ctc(const void* lp_ext, const void* skip_add, const void* t_len, const void* u_len, void* occ,
                         void* loss, int B, int T, int S, void* stream) {
  using namespace tfasr;
  if (B == 0 || T == 0) return 0;
  const int threads = (S + 31) / 32 * 32;
  if (threads > 1024) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)2 * (S + 2) * sizeof(float);
  ctc_kernel<<<B, threads, smem, (cudaStream_t)stream>>>((const float*)lp_ext, (const float*)skip_add,
                                                        (const int*)t_len, (const int*)u_len, (float*)occ,
                                                        (float*)loss, T, S);
  return (int)cudaGetLastError();
}
