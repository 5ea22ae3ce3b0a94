// Fused log-mel frontend: in-kernel framing -> Hann-windowed DFT (cos/sin
// bases) -> power -> mel projection -> log(x + eps), all in f32 FMA.
//
// Counterpart of tensorflowasr_tpu/ops/pallas/frontend_kernel.py
// (log_mel_spectrogram_pallas and _v2). One block owns FE_FT frames of one
// utterance: it copies their samples into shared memory straight from the
// signal by index arithmetic (pad_end framing, zero past N), so the framed
// signal never exists in device memory. Threads own DFT bins; each keeps
// FE_FT (re, im) accumulators in registers while streaming the windowed
// bases from L2. The power spectrum stays in shared memory for the mel
// product.
#include "common.cuh"

namespace tfasr {

constexpr int FE_FT = 16;  // frames per block

__global__ void log_mel_kernel(const float* __restrict__ signal, const float* __restrict__ cos_b,
                               const float* __restrict__ sin_b, const float* __restrict__ mel, float* __restrict__ out,
                               int N, int T, int FL, int FS, int NB, int M, float eps) {
  extern __shared__ float smem[];
  float* fr = smem;             // [FE_FT][FL] frame samples
  float* pw = fr + FE_FT * FL;  // [FE_FT][NB] power spectrum
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * FE_FT;
  const int nf = min(FE_FT, T - t0);
  const float* sig = signal + (size_t)b * N;

  for (int idx = threadIdx.x; idx < FE_FT * FL; idx += blockDim.x) {
    const int f = idx / FL, j = idx % FL;
    const long n = (long)(t0 + f) * FS + j;
    fr[idx] = (f < nf && n < N) ? sig[n] : 0.f;
  }
  __syncthreads();

  for (int kb = threadIdx.x; kb < NB; kb += blockDim.x) {
    float re[FE_FT], im[FE_FT];
#pragma unroll
    for (int f = 0; f < FE_FT; ++f) re[f] = im[f] = 0.f;
    for (int j = 0; j < FL; ++j) {
      const float c = cos_b[(size_t)j * NB + kb];
      const float s = sin_b[(size_t)j * NB + kb];
#pragma unroll
      for (int f = 0; f < FE_FT; ++f) {
        const float xv = fr[f * FL + j];
        re[f] = fmaf(xv, c, re[f]);
        im[f] = fmaf(xv, s, im[f]);
      }
    }
#pragma unroll
    for (int f = 0; f < FE_FT; ++f) pw[f * NB + kb] = re[f] * re[f] + im[f] * im[f];
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < FE_FT * M; idx += blockDim.x) {
    const int f = idx / M, m = idx % M;
    if (f >= nf) continue;
    float acc = 0.f;
    for (int k = 0; k < NB; ++k) acc = fmaf(pw[f * NB + k], mel[(size_t)k * M + m], acc);
    out[((size_t)b * T + t0 + f) * M + m] = logf(acc + eps);
  }
}

}  // namespace tfasr

// signal [B, N] f32; cos_b/sin_b [FL, NB] windowed DFT bases; mel [NB, M];
// out [B, T, M] f32 with T = ceil(N / FS). Returns cudaGetLastError().
extern "C" int tfasr_log_mel(const void* signal, const void* cos_b, const void* sin_b, const void* mel, void* out,
                             int B, int N, int T, int FL, int FS, int NB, int M, float eps, void* stream) {
  using namespace tfasr;
  const size_t smem = (size_t)(FE_FT * FL + FE_FT * NB) * sizeof(float);
  cudaError_t err = allow_smem(log_mel_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = min(1024, ((NB + 31) / 32) * 32);
  dim3 grid((T + FE_FT - 1) / FE_FT, B);
  log_mel_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const float*)signal, (const float*)cos_b, (const float*)sin_b, (const float*)mel, (float*)out, N, T, FL, FS, NB,
      M, eps);
  return (int)cudaGetLastError();
}
