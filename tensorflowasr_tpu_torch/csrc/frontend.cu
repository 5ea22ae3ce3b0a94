// Fused log-mel frontend: in-kernel framing -> periodic Hann window -> |rfft|^2
// over nfft points -> mel product over each filter's nonzero bins ->
// log(x + eps), all in f32.
//
// Counterpart of tensorflowasr_tpu/ops/pallas/frontend_kernel.py
// log_mel_spectrogram_pallas (:80, pallas_call :120) and _v2 (:200,
// pallas_call :252): the JAX kernels take the DFT as two dense products
// against [frame_length, nfft/2+1] cos/sin bases, because the MXU is the
// TPU's only fast unit. One kernel here serves both rows, and the wrapper
// (ops/cuda/frontend_kernel.py) picks it by nfft:
//
// log_mel_fft_kernel, for a power-of-two nfft from 256 to 2048 (every
// example config takes 512): one warp per frame, FE_WARPS frames a block of
// one utterance. The block copies its frames' span of samples from the
// signal by index arithmetic (pad_end framing, zero past N) into shared
// memory, so the framed signal never exists in device memory; each warp
// windows its frame into M = nfft/2 complex points z[m] = x[2m] + i x[2m+1]
// (zero past frame_length), runs an in-place decimation-in-frequency FFT of
// M points in shared memory (a radix-2 stage first where log2 M is odd, then
// radix-4 stages; the output lands in mixed-radix digit-reversed order,
// fe_position), and the real split X[k] = (Z[k] + conj Z[M-k]) / 2 - i/2
// W^k (Z[k] - conj Z[M-k]) gives the nfft/2+1 bins, whose power stays in
// shared memory. Each mel filter sums only its nonzero bins (mel_lo,
// mel_off: ~2 per bin instead of nfft/2+1 per filter). The twiddles W_n^k =
// exp(-2 pi i k / nfft) come from a table built in float64 on the host and
// cast to f32 (no fast-math sine), copied into shared memory per block.
//
// log_mel_dft_kernel, for any other nfft (nfft = None is the 400-point
// case): the direct DFT against the host's Hann-windowed [FL, nfft/2+1]
// cos/sin bases, FE_FT frames a block, each thread one bin with FE_FT
// (re, im) accumulators in registers while the bases stream from L2; the
// same sparse mel stage.
//
// FL is the samples a frame the kernels read: the frame length, or nfft
// where nfft is below it (the wrapper passes min(frame_length, nfft)), so a
// frame longer than nfft is cropped to its first nfft windowed samples, as
// rfft(frames, n=nfft) does.
//
// What bounds them on an H100: the FFT does ~2.5 nfft log2 nfft operations
// a frame (~12 kFLOP at 512, against ~0.4 MFLOP for the direct DFT of 400
// samples), so the FFT kernel's bound is the signal read once and the
// features written once (~25 MB at [16, 256000], ~7 us at 3.35 TB/s); its
// times, the DFT kernel's and the plain rfft chain's on one NVIDIA H100
// 80GB HBM3 at 700 W are in PERF.md section 6, rows 1 and 2.
#include "common.cuh"

namespace tfasr {

constexpr int FE_WARPS = 8;  // frames per block of the FFT kernel, one warp each
constexpr int FE_FT = 16;    // frames per block of the DFT kernel

// log(sum over filter m's nonzero bins of power * weight + eps).
__device__ __forceinline__ float fe_mel_log(const float* pw, int m, const float* mel_w, const int* mel_lo, const int* mel_off, float eps) {
  const int lo = mel_lo[m], o0 = mel_off[m], cnt = mel_off[m + 1] - o0;
  float acc = 0.f;
  for (int q = 0; q < cnt; ++q) acc = fmaf(pw[lo + q], mel_w[o0 + q], acc);
  return logf(acc + eps);
}

__device__ __forceinline__ float2 fe_cmul(float2 a, float2 b) { return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x); }
__device__ __forceinline__ float2 fe_add(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 fe_sub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }

// Shared-memory slot of complex element i: one pad slot after every 16, so
// that the butterflies' strides (4 and 16 points) and the digit-reversed
// reads spread over the banks instead of meeting in two of them.
__device__ __forceinline__ int fe_pad(int i) { return i + (i >> 4); }

// Where the DIF FFT of M points leaves frequency k: the first stage's digit
// (k's lowest, base 2 if log2 M is odd, else 4) has the largest weight.
__device__ __forceinline__ int fe_position(int k, int M, bool radix2_first) {
  int pos = 0, span = M;
  if (radix2_first) {
    span >>= 1;
    pos += (k & 1) * span;
    k >>= 1;
  }
  while (span > 1) {
    span >>= 2;
    pos += (k & 3) * span;
    k >>= 2;
  }
  return pos;
}

__global__ void __launch_bounds__(32 * FE_WARPS) log_mel_fft_kernel(const float* __restrict__ signal, const float2* __restrict__ twiddle,
                                                                     const float* __restrict__ window, const float* __restrict__ mel_w,
                                                                     const int* __restrict__ mel_lo, const int* __restrict__ mel_off,
                                                                     float* __restrict__ out, int N, int T, int FL, int FS, int nfft, int log2M,
                                                                     int nmel, int nnz, float eps) {
  extern __shared__ __align__(16) unsigned char fe_smem[];
  const int M = nfft >> 1, MP = fe_pad(M), span_len = (FE_WARPS - 1) * FS + FL;
  float2* tw = reinterpret_cast<float2*>(fe_smem);  // [fe_pad(nfft)] W_n^k at fe_pad(k)
  float2* buf = tw + fe_pad(nfft);                  // [FE_WARPS][MP] each warp's frame at fe_pad(i)
  float* win = reinterpret_cast<float*>(buf + FE_WARPS * MP);  // [FL + 1]
  float* span = win + (FL + 1) / 2 * 2;             // [span_len] the block's samples
  float* pw = span + (span_len + 1) / 2 * 2;        // [FE_WARPS][M + 1] power spectrum
  float* mw = pw + FE_WARPS * (M + 1);              // [nnz] mel weights
  int* mlo = reinterpret_cast<int*>(mw + nnz);      // [nmel] first bins
  int* moff = mlo + nmel;                           // [nmel + 1] offsets
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.y, t0 = blockIdx.x * FE_WARPS;
  const float* sig = signal + (size_t)b * N;
  const long s0 = (long)t0 * FS;

  for (int i = threadIdx.x; i < nfft; i += blockDim.x) tw[fe_pad(i)] = twiddle[i];
  for (int i = threadIdx.x; i < FL; i += blockDim.x) win[i] = window[i];
  for (int i = threadIdx.x; i < span_len; i += blockDim.x) span[i] = s0 + i < N ? sig[s0 + i] : 0.f;
  for (int i = threadIdx.x; i < nnz; i += blockDim.x) mw[i] = mel_w[i];
  for (int i = threadIdx.x; i < nmel; i += blockDim.x) mlo[i] = mel_lo[i];
  for (int i = threadIdx.x; i <= nmel; i += blockDim.x) moff[i] = mel_off[i];
  __syncthreads();
  const int t = t0 + warp;
  if (t >= T) return;

  float2* z = buf + warp * MP;
  const float* fr = span + warp * FS;
  const bool pairs = ((FL | FS) & 1) == 0;  // window and frame start 8-byte aligned
  for (int m = lane; m < M; m += 32) {
    const int j = 2 * m;
    float2 v = make_float2(0.f, 0.f);
    if (pairs && j < FL) {
      const float2 w = *reinterpret_cast<const float2*>(win + j), x = *reinterpret_cast<const float2*>(fr + j);
      v = make_float2(w.x * x.x, w.y * x.y);
    } else if (!pairs) {
      v = make_float2(j < FL ? win[j] * fr[j] : 0.f, j + 1 < FL ? win[j + 1] * fr[j + 1] : 0.f);
    }
    z[fe_pad(m)] = v;
  }
  __syncwarp();

  const bool radix2_first = log2M & 1;
  int L = M;
  if (radix2_first) {  // span L = M, stride M / 2
    const int s = L >> 1, tstep = nfft / L;
    for (int bi = lane; bi < M / 2; bi += 32) {
      const int j = bi % s, base = (bi / s) * L + j;
      const float2 x0 = z[fe_pad(base)], x1 = z[fe_pad(base + s)];
      z[fe_pad(base)] = fe_add(x0, x1);
      z[fe_pad(base + s)] = fe_cmul(fe_sub(x0, x1), tw[fe_pad(j * tstep)]);
    }
    __syncwarp();
    L >>= 1;
  }
  for (; L >= 4; L >>= 2) {  // radix 4, span L, stride L / 4
    const int s = L >> 2, tstep = nfft / L;
    for (int bi = lane; bi < M / 4; bi += 32) {
      const int j = bi % s, base = (bi / s) * L + j;
      const int i0 = fe_pad(base), i1 = fe_pad(base + s), i2 = fe_pad(base + 2 * s), i3 = fe_pad(base + 3 * s);
      const float2 x0 = z[i0], x1 = z[i1], x2 = z[i2], x3 = z[i3];
      const float2 a0 = fe_add(x0, x2), a1 = fe_sub(x0, x2), a2 = fe_add(x1, x3), d = fe_sub(x1, x3);
      const float2 a3 = make_float2(d.y, -d.x);  // -i (x1 - x3)
      z[i0] = fe_add(a0, a2);
      z[i1] = fe_cmul(fe_add(a1, a3), tw[fe_pad(j * tstep)]);
      z[i2] = fe_cmul(fe_sub(a0, a2), tw[fe_pad(2 * j * tstep)]);
      z[i3] = fe_cmul(fe_sub(a1, a3), tw[fe_pad(3 * j * tstep)]);
    }
    __syncwarp();
  }

  float* p = pw + warp * (M + 1);
  for (int k = lane; k <= M; k += 32) {
    const float2 zk = z[fe_pad(fe_position(k & (M - 1), M, radix2_first))], zm = z[fe_pad(fe_position((M - k) & (M - 1), M, radix2_first))];
    const float2 e = make_float2(0.5f * (zk.x + zm.x), 0.5f * (zk.y - zm.y));
    const float2 o = make_float2(0.5f * (zk.y + zm.y), -0.5f * (zk.x - zm.x));  // -i/2 (Z[k] - conj Z[M-k])
    const float2 x = fe_add(e, fe_cmul(tw[fe_pad(k)], o));
    p[k] = x.x * x.x + x.y * x.y;
  }
  __syncwarp();
  float* o = out + ((size_t)b * T + t) * nmel;
  for (int m = lane; m < nmel; m += 32) o[m] = fe_mel_log(p, m, mw, mlo, moff, eps);
}

__global__ void log_mel_dft_kernel(const float* __restrict__ signal, const float* __restrict__ cos_b, const float* __restrict__ sin_b,
                                   const float* __restrict__ mel_w, const int* __restrict__ mel_lo, const int* __restrict__ mel_off,
                                   float* __restrict__ out, int N, int T, int FL, int FS, int NB, int nmel, float eps) {
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

  for (int idx = threadIdx.x; idx < FE_FT * nmel; idx += blockDim.x) {
    const int f = idx / nmel, m = idx % nmel;
    if (f >= nf) continue;
    out[((size_t)b * T + t0 + f) * nmel + m] = fe_mel_log(pw + f * NB, m, mel_w, mel_lo, mel_off, eps);
  }
}

size_t fe_fft_smem(int nfft, int FL, int FS, int nmel, int nnz) {
  const int M = nfft / 2, span_len = (FE_WARPS - 1) * FS + FL;
  return (size_t)((nfft + (nfft >> 4)) + FE_WARPS * (M + (M >> 4))) * sizeof(float2) +
         (size_t)((FL + 1) / 2 * 2 + (span_len + 1) / 2 * 2 + FE_WARPS * (M + 1) + nnz) * sizeof(float) + (size_t)(2 * nmel + 1) * sizeof(int);
}

}  // namespace tfasr

// signal [B, N] f32; twiddle [nfft] complex f32 (W_n^k); window [FL] f32;
// mel_w the mel filters' nnz nonzero weights, filter m's at mel_off[m] ..
// mel_off[m + 1] for bins mel_lo[m] ..; out [B, T, nmel] f32 with T =
// ceil(N / FS). nfft a power of two from 256 to 2048, at least FL (the
// frame length cropped to nfft).
extern "C" int tfasr_log_mel_fft(const void* signal, const void* twiddle, const void* window, const void* mel_w, const void* mel_lo, const void* mel_off,
                                 void* out, int B, int N, int T, int FL, int FS, int nfft, int nmel, int nnz, float eps, void* stream) {
  using namespace tfasr;
  if (nfft < 256 || nfft > 2048 || (nfft & (nfft - 1)) != 0 || FL > nfft) return (int)cudaErrorInvalidValue;
  int log2M = 0;
  while ((2 << log2M) < nfft) ++log2M;
  const size_t smem = fe_fft_smem(nfft, FL, FS, nmel, nnz);
  cudaError_t err = allow_smem(log_mel_fft_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + FE_WARPS - 1) / FE_WARPS, B);
  log_mel_fft_kernel<<<grid, 32 * FE_WARPS, smem, (cudaStream_t)stream>>>(
      (const float*)signal, (const float2*)twiddle, (const float*)window, (const float*)mel_w, (const int*)mel_lo, (const int*)mel_off, (float*)out, N,
      T, FL, FS, nfft, log2M, nmel, nnz, eps);
  return (int)cudaGetLastError();
}

// Dynamic shared memory (bytes) of the FFT kernel; tests/test_torch_cuda.py plans the same.
extern "C" long long tfasr_log_mel_fft_smem(int nfft, int FL, int FS, int nmel, int nnz) { return (long long)tfasr::fe_fft_smem(nfft, FL, FS, nmel, nnz); }

// signal [B, N] f32; cos_b/sin_b [FL, NB] Hann-windowed DFT bases; the mel
// filters as for tfasr_log_mel_fft; out [B, T, nmel] f32.
extern "C" int tfasr_log_mel_dft(const void* signal, const void* cos_b, const void* sin_b, const void* mel_w, const void* mel_lo, const void* mel_off,
                                 void* out, int B, int N, int T, int FL, int FS, int NB, int nmel, float eps, void* stream) {
  using namespace tfasr;
  const size_t smem = (size_t)(FE_FT * FL + FE_FT * NB) * sizeof(float);
  cudaError_t err = allow_smem(log_mel_dft_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = min(1024, ((NB + 31) / 32) * 32);
  dim3 grid((T + FE_FT - 1) / FE_FT, B);
  log_mel_dft_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>((const float*)signal, (const float*)cos_b, (const float*)sin_b, (const float*)mel_w,
                                                                    (const int*)mel_lo, (const int*)mel_off, (float*)out, N, T, FL, FS, NB, nmel, eps);
  return (int)cudaGetLastError();
}
