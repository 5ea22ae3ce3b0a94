// Whole-sequence LSTM recurrence in f32 on the CUDA cores (the parity runs;
// bf16 runs on the tensor cores in lstm_mma.cu), forward and backward
// (BPTT), gate order i, f, g, o, in one kernel launch each:
//   a_t = xg[:, t] + h_{t-1} . Wh                  (xg = x . Wx + b, precomputed)
//   c_t = sig(a_f) c_{t-1} + sig(a_i) tanh(a_g);  h_t = sig(a_o) tanh(c_t)
// The forward writes y = h, the cell sequence and the activated gates (all
// in the input dtype T) and keeps no recompute for the backward; the
// backward writes d(pre-activation) dxg in f32 and dh0, dc0. The weight
// gradient hprev^T . dxg has no recurrence and stays a matrix product
// outside the kernels. h (and the backward's dxg row) enters the recurrent
// product rounded to T; the carries stay f32.
//
// Replaces tensorflowasr_tpu/ops/pallas/lstm_kernel.py lstm_core: the
// forward _fwd_kernel and the backward _bwd_kernel. The TPU kernels keep
// the whole of Wh ([Hp, 4Hp], lanes padded to 512) in VMEM and loop over
// time tiles of a sequential grid. One SM's 227 KB of shared memory does
// not hold Wh (1.6 MB in f32 at H 320), so the design here is a
// cooperative grid: each of ceil(H / units) co-resident blocks (107 at
// H 320, units 3, at most one per SM) owns `units` hidden units with all
// four of their gates, keeps its slice of Wh (forward: the 4 x units
// columns; backward: the units rows) in shared memory as f32, and its
// cells' carries in shared memory. A step's h (forward: the y rows just
// written; backward: the dxg rows) is exchanged through device memory with
// one grid-wide barrier per step: a counter that every block increments, in
// a launch that cudaLaunchCooperativeKernel guarantees to be co-resident.
// After the barrier the block stages those rows into shared memory (read
// past L1, from L2, with up to 8 independent 16-byte loads in flight per
// thread; `rows` batch rows at a time where B rows do not fit). In the
// recurrent product a warp takes one batch row at a time, its lanes stride
// over the reduction axis, and warp shuffles reduce the per-lane partial
// sums: fixed order, no atomics.
//
// What bounds it on the card: the chain of 2 x T dependent steps (129 each
// way at the prediction net's U+1 = 129), not the 1.7 GFLOP of recurrent
// products or the ~13 MB of traffic (a few microseconds at peak). Each step
// pays a grid barrier, a dependent read from L2, the elementwise phase's
// loads and the block's product phase, whose per-column warp reductions
// run one after another (the step's time grows with `units`); PERF.md
// holds the measured times.
#include <algorithm>

#include "common.cuh"

namespace tfasr {

constexpr int LSTM_THREADS = 256;
constexpr int LSTM_MAX_UNITS = 8;  // hidden units per block
constexpr int LSTM_STAGE_LOADS = 8;  // independent loads in flight per thread while staging
constexpr size_t LSTM_SMEM_LIMIT = 200 * 1024;  // of the 227 KB a block may use

__device__ __forceinline__ float load_l2(const float* p) { return __ldcg(p); }

// Stage nb rows of `width` values (row r at src + r * stride) into dst[r * width + k] as f32, reading past
// L1 (other blocks wrote them in this launch). vec: 16-byte loads (width * sizeof(T) and every row start are
// multiples of 16 bytes); else one element per load.
template <typename T>
__device__ __forceinline__ void stage_rows(const T* src, size_t stride, int nb, int width, float* dst, bool vec) {
  constexpr int E = 16 / sizeof(T);
  if (vec) {
    const int per_row = width / E, n = nb * per_row;
    for (int base = threadIdx.x; base < n; base += LSTM_STAGE_LOADS * blockDim.x) {
      uint4 raw[LSTM_STAGE_LOADS];
#pragma unroll
      for (int j = 0; j < LSTM_STAGE_LOADS; ++j) {
        const int i = base + j * blockDim.x;
        if (i < n) raw[j] = __ldcg(reinterpret_cast<const uint4*>(src + (size_t)(i / per_row) * stride) + i % per_row);
      }
#pragma unroll
      for (int j = 0; j < LSTM_STAGE_LOADS; ++j) {
        const int i = base + j * blockDim.x;
        if (i < n) {
          const T* r = reinterpret_cast<const T*>(&raw[j]);
          float* d = dst + (size_t)(i / per_row) * width + (i % per_row) * E;
#pragma unroll
          for (int e = 0; e < E; ++e) d[e] = to_f32(r[e]);
        }
      }
    }
  } else {
    const int n = nb * width;
    for (int base = threadIdx.x; base < n; base += LSTM_STAGE_LOADS * blockDim.x) {
      float v[LSTM_STAGE_LOADS];
#pragma unroll
      for (int j = 0; j < LSTM_STAGE_LOADS; ++j) {
        const int i = base + j * blockDim.x;
        if (i < n) v[j] = load_l2(src + (size_t)(i / width) * stride + i % width);
      }
#pragma unroll
      for (int j = 0; j < LSTM_STAGE_LOADS; ++j) {
        const int i = base + j * blockDim.x;
        if (i < n) dst[i] = v[j];
      }
    }
  }
}

// Grid-wide barrier of a cooperative launch: each block adds one to a
// counter the wrapper zeroed; the k-th barrier waits for k * gridDim.x.
__device__ __forceinline__ void grid_barrier(unsigned int* counter, unsigned int target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
    while (*reinterpret_cast<volatile unsigned int*>(counter) < target) __nanosleep(32);
    __threadfence();
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(LSTM_THREADS) lstm_fwd_kernel(const T* __restrict__ xg, const T* __restrict__ wh,
                                                                const T* __restrict__ h0, const T* __restrict__ c0, T* y,
                                                                T* __restrict__ cseq, T* __restrict__ gates,
                                                                unsigned int* counter, int B, int Tn, int H, int units,
                                                                int rows, int vec) {
  extern __shared__ float smem[];
  const int G = 4 * units;  // this block's gate columns: gate q of unit jj at q * units + jj
  float* w_s = smem;               // [G][H]: w_s[c * H + k] = Wh[k, q H + j0 + jj]
  float* a_s = w_s + G * H;        // [B][G]: the step's recurrent product
  float* c_s = a_s + B * G;        // [B][units]: the cell carry
  float* h_s = c_s + B * units;    // [rows][H]: staged h_{t-1}
  const int j0 = blockIdx.x * units;
  const int nu = min(units, H - j0);
  for (int i = threadIdx.x; i < G * H; i += blockDim.x) {
    const int c = i / H, k = i % H, q = c / units, jj = c % units;
    w_s[i] = jj < nu ? to_f32(wh[(size_t)k * 4 * H + q * H + j0 + jj]) : 0.f;
  }
  for (int i = threadIdx.x; i < B * units; i += blockDim.x) {
    const int b = i / units, jj = i % units;
    c_s[i] = jj < nu ? to_f32(c0[(size_t)b * H + j0 + jj]) : 0.f;
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nwarps = blockDim.x / 32;
  for (int t = 0; t < Tn; ++t) {
    for (int b0 = 0; b0 < B; b0 += rows) {
      const int nb = min(rows, B - b0);
      if (t == 0)
        stage_rows(h0 + (size_t)b0 * H, (size_t)H, nb, H, h_s, vec);
      else
        stage_rows(y + ((size_t)b0 * Tn + t - 1) * H, (size_t)Tn * H, nb, H, h_s, vec);
      __syncthreads();
      for (int r = warp; r < nb; r += nwarps) {
        const float* hr = h_s + (size_t)r * H;
        float acc[4 * LSTM_MAX_UNITS];
#pragma unroll
        for (int c = 0; c < 4 * LSTM_MAX_UNITS; ++c) acc[c] = 0.f;
        for (int k = lane; k < H; k += 32) {
          const float hv = hr[k];
#pragma unroll
          for (int c = 0; c < 4 * LSTM_MAX_UNITS; ++c)
            if (c < G) acc[c] = fmaf(hv, w_s[c * H + k], acc[c]);
        }
#pragma unroll
        for (int c = 0; c < 4 * LSTM_MAX_UNITS; ++c)
          if (c < G) {
            const float s = warp_sum(acc[c]);
            if (lane == 0) a_s[(b0 + r) * G + c] = s;
          }
      }
      __syncthreads();
    }
    for (int i = threadIdx.x; i < B * nu; i += blockDim.x) {
      const int b = i / nu, jj = i % nu, j = j0 + jj;
      const size_t row = (size_t)b * Tn + t;
      const T* xr = xg + row * 4 * H;
      const float* a = a_s + b * G;
      const float ig = sigmoid_f32(to_f32(xr[j]) + a[jj]);
      const float fg = sigmoid_f32(to_f32(xr[H + j]) + a[units + jj]);
      const float gg = tanhf(to_f32(xr[2 * H + j]) + a[2 * units + jj]);
      const float og = sigmoid_f32(to_f32(xr[3 * H + j]) + a[3 * units + jj]);
      const float c = fg * c_s[b * units + jj] + ig * gg;
      c_s[b * units + jj] = c;
      y[row * H + j] = from_f32<T>(og * tanhf(c));
      cseq[row * H + j] = from_f32<T>(c);
      T* gr = gates + row * 4 * H;
      gr[j] = from_f32<T>(ig);
      gr[H + j] = from_f32<T>(fg);
      gr[2 * H + j] = from_f32<T>(gg);
      gr[3 * H + j] = from_f32<T>(og);
    }
    if (t + 1 < Tn) grid_barrier(counter, (unsigned)(t + 1) * gridDim.x);
  }
}

// dh_s[b][jj] = sum over the 4H columns of round_T(dxg[b, t]) . Wh[j0 + jj, :], the dxg rows staged `rows` at a time
template <typename T>
__device__ __forceinline__ void recurrent_dh(const float* dxg, const float* w_s, float* d_s, float* dh_s, int B, int Tn, int H,
                                             int units, int rows, int t) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nwarps = blockDim.x / 32;
  for (int b0 = 0; b0 < B; b0 += rows) {
    const int nb = min(rows, B - b0);
    stage_rows(dxg + ((size_t)b0 * Tn + t) * 4 * H, (size_t)Tn * 4 * H, nb, 4 * H, d_s, true);  // 16H-byte rows
    __syncthreads();
    for (int r = warp; r < nb; r += nwarps) {
      const float* dr = d_s + (size_t)r * 4 * H;
      float acc[LSTM_MAX_UNITS];
#pragma unroll
      for (int jj = 0; jj < LSTM_MAX_UNITS; ++jj) acc[jj] = 0.f;
      for (int col = lane; col < 4 * H; col += 32) {
        const float dv = round_to<T>(dr[col]);
#pragma unroll
        for (int jj = 0; jj < LSTM_MAX_UNITS; ++jj)
          if (jj < units) acc[jj] = fmaf(dv, w_s[jj * 4 * H + col], acc[jj]);
      }
#pragma unroll
      for (int jj = 0; jj < LSTM_MAX_UNITS; ++jj)
        if (jj < units) {
          const float s = warp_sum(acc[jj]);
          if (lane == 0) dh_s[(b0 + r) * units + jj] = s;
        }
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(LSTM_THREADS) lstm_bwd_kernel(const float* __restrict__ dy, const float* __restrict__ dc,
                                                                const T* __restrict__ gates, const T* __restrict__ cseq,
                                                                const T* __restrict__ c0, const T* __restrict__ wh, float* dxg,
                                                                float* __restrict__ dh0, float* __restrict__ dc0,
                                                                unsigned int* counter, int B, int Tn, int H, int units,
                                                                int rows) {
  extern __shared__ float smem[];
  float* w_s = smem;                     // [units][4H]: the rows j0 + jj of Wh
  float* dh_s = w_s + units * 4 * H;     // [B][units]: the recurrent dh of this step
  float* dc_s = dh_s + B * units;        // [B][units]: the cell-gradient carry
  float* d_s = dc_s + B * units;         // [rows][4H]: staged dxg rows of the step after
  const int j0 = blockIdx.x * units;
  const int nu = min(units, H - j0);
  for (int i = threadIdx.x; i < units * 4 * H; i += blockDim.x) {
    const int jj = i / (4 * H), col = i % (4 * H);
    w_s[i] = jj < nu ? to_f32(wh[(size_t)(j0 + jj) * 4 * H + col]) : 0.f;
  }
  for (int i = threadIdx.x; i < B * units; i += blockDim.x) dh_s[i] = dc_s[i] = 0.f;
  __syncthreads();
  for (int t = Tn - 1; t >= 0; --t) {
    if (t + 1 < Tn) recurrent_dh<T>(dxg, w_s, d_s, dh_s, B, Tn, H, units, rows, t + 1);
    for (int i = threadIdx.x; i < B * nu; i += blockDim.x) {
      const int b = i / nu, jj = i % nu, j = j0 + jj;
      const size_t row = (size_t)b * Tn + t;
      const T* gr = gates + row * 4 * H;
      const float ig = to_f32(gr[j]), fg = to_f32(gr[H + j]), gg = to_f32(gr[2 * H + j]), og = to_f32(gr[3 * H + j]);
      const float tc = tanhf(to_f32(cseq[row * H + j]));
      const float dh = dy[row * H + j] + dh_s[b * units + jj];
      const float dov = dh * tc;
      const float dct = dh * og * (1.f - tc * tc) + dc_s[b * units + jj] + dc[row * H + j];
      const float cprev = t > 0 ? to_f32(cseq[(row - 1) * H + j]) : to_f32(c0[(size_t)b * H + j]);
      float* dr = dxg + row * 4 * H;
      dr[j] = dct * gg * ig * (1.f - ig);
      dr[H + j] = dct * cprev * fg * (1.f - fg);
      dr[2 * H + j] = dct * ig * (1.f - gg * gg);
      dr[3 * H + j] = dov * og * (1.f - og);
      dc_s[b * units + jj] = dct * fg;
    }
    grid_barrier(counter, (unsigned)(Tn - t) * gridDim.x);
  }
  recurrent_dh<T>(dxg, w_s, d_s, dh_s, B, Tn, H, units, rows, 0);
  for (int i = threadIdx.x; i < B * nu; i += blockDim.x) {
    const int b = i / nu, jj = i % nu;
    dh0[(size_t)b * H + j0 + jj] = dh_s[b * units + jj];
    dc0[(size_t)b * H + j0 + jj] = dc_s[b * units + jj];
  }
}

template <typename K>
int launch_cooperative(K kernel, int blocks, size_t smem, void** args, cudaStream_t stream) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks), dim3(LSTM_THREADS), args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

inline bool lstm_args_ok(int B, int Tn, int H, int units) {
  return B > 0 && Tn > 0 && H > 0 && units >= 1 && units <= LSTM_MAX_UNITS;
}

// Shared memory of `fixed` floats plus `rows` staged rows of `width` floats, with as many rows as fit
// (at most B); 0 when not even one row fits.
inline int staged_rows(size_t fixed, int width, int B, size_t& smem) {
  const size_t room = LSTM_SMEM_LIMIT / sizeof(float);
  if (fixed + width > room) return 0;
  const int rows = (int)std::min<size_t>((size_t)B, (room - fixed) / width);
  smem = sizeof(float) * (fixed + (size_t)rows * width);
  return rows;
}

template <typename T>
int lstm_fwd(const void* xg, const void* wh, const void* h0, const void* c0, void* y, void* cseq, void* gates, void* counter,
             int B, int Tn, int H, int units, int vec, cudaStream_t stream) {
  const T *xg_ = (const T*)xg, *wh_ = (const T*)wh, *h0_ = (const T*)h0, *c0_ = (const T*)c0;
  T *y_ = (T*)y, *cseq_ = (T*)cseq, *gates_ = (T*)gates;
  unsigned int* counter_ = (unsigned int*)counter;
  size_t smem = 0;
  int rows = staged_rows((size_t)4 * units * H + (size_t)B * 4 * units + (size_t)B * units, H, B, smem);
  if (rows == 0) return (int)cudaErrorInvalidValue;
  void* args[] = {&xg_, &wh_, &h0_, &c0_, &y_, &cseq_, &gates_, &counter_, &B, &Tn, &H, &units, &rows, &vec};
  return launch_cooperative(lstm_fwd_kernel<T>, (H + units - 1) / units, smem, args, stream);
}

template <typename T>
int lstm_bwd(const void* dy, const void* dc, const void* gates, const void* cseq, const void* c0, const void* wh, void* dxg,
             void* dh0, void* dc0, void* counter, int B, int Tn, int H, int units, cudaStream_t stream) {
  const float *dy_ = (const float*)dy, *dc_ = (const float*)dc;
  const T *gates_ = (const T*)gates, *cseq_ = (const T*)cseq, *c0_ = (const T*)c0, *wh_ = (const T*)wh;
  float *dxg_ = (float*)dxg, *dh0_ = (float*)dh0, *dc0_ = (float*)dc0;
  unsigned int* counter_ = (unsigned int*)counter;
  size_t smem = 0;
  int rows = staged_rows((size_t)units * 4 * H + (size_t)2 * B * units, 4 * H, B, smem);
  if (rows == 0) return (int)cudaErrorInvalidValue;
  void* args[] = {&dy_, &dc_, &gates_, &cseq_, &c0_, &wh_, &dxg_, &dh0_, &dc0_, &counter_, &B, &Tn, &H, &units, &rows};
  return launch_cooperative(lstm_bwd_kernel<T>, (H + units - 1) / units, smem, args, stream);
}

}  // namespace tfasr

// xg [B, T, 4H], wh [H, 4H], h0, c0 [B, H] (dtype 0 f32; bf16 is refused); y, cseq [B, T, H] and gates [B, T, 4H] f32;
// counter: one zeroed uint32. Launches ceil(H / units) co-resident blocks (1 <= units <= 8). vec: h0 and y
// rows are 16-byte aligned (H * elt a multiple of 16 and aligned h0, y).
extern "C" int tfasr_lstm_fwd(const void* xg, const void* wh, const void* h0, const void* c0, void* y, void* cseq, void* gates,
                              void* counter, int B, int T, int H, int units, int dtype, int vec, void* stream) {
  using namespace tfasr;
  if (!lstm_args_ok(B, T, H, units) || dtype != kF32) return (int)cudaErrorInvalidValue;
  return lstm_fwd<float>(xg, wh, h0, c0, y, cseq, gates, counter, B, T, H, units, vec, (cudaStream_t)stream);
}

// dy, dc [B, T, H] f32 (cotangents of y and cseq); gates, cseq, c0, wh as saved by the forward (dtype 0 f32);
// dxg [B, T, 4H] (16-byte aligned), dh0, dc0 [B, H] f32; counter: one zeroed uint32.
extern "C" int tfasr_lstm_bwd(const void* dy, const void* dc, const void* gates, const void* cseq, const void* c0, const void* wh,
                              void* dxg, void* dh0, void* dc0, void* counter, int B, int T, int H, int units, int dtype,
                              void* stream) {
  using namespace tfasr;
  if (!lstm_args_ok(B, T, H, units) || dtype != kF32) return (int)cudaErrorInvalidValue;
  return lstm_bwd<float>(dy, dc, gates, cseq, c0, wh, dxg, dh0, dc0, counter, B, T, H, units, (cudaStream_t)stream);
}
