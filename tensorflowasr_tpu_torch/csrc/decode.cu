// Fused greedy transducer decode: the whole WIND greedy loop of one
// utterance in one thread block.
//
// Replaces scripts_dev/decode_kernel.py fused_greedy_decode (the Pallas
// _decode_kernel). Per iteration, for the row's frame pointer t:
//   start = min(t, T - K); for the frames start..start+K-1 that are valid
//   (>= t, < len) while the budget idx < max_tokens lasts:
//     z = tanh(enc_p[frame] + pred_p) (f32, rounded to T for the product),
//     logits = z . Wv^T + bv (f32 accumulation), id = argmax (lowest on ties);
//   the first valid non-blank frame emits its id at tokens[idx++] and moves
//   t to it; with none, t moves to min(start + K, len) (never backwards).
//   On emission the prediction network steps once on the new token: the
//   embedding row; per layer gates = x.Wih^T + h.Whh^T + b (i, f, g, o),
//   c' = sig(f) c + sig(i) tanh(g), h' = sig(o) tanh(c'), LayerNorm over the
//   H units (centred variance, eps), projection; then pred_p = x.Wp^T + bp.
//   The carried-out states are those from before the last emission's step.
//
// The TPU kernel decodes the whole batch in one instance (the rows' products
// as [B, .] MXU matmuls, 128-lane padding, a one-hot product for the
// embedding read, a 16-aligned window widened by 16, lengths by scalar
// prefetch). None of that is carried over: here one block owns one
// utterance and runs its own loop. A row that finishes early in the JAX
// shared loop only idles (its t, idx and states stop moving), so per-row
// loops give the same outputs with no grid barrier. The window is scored in
// groups of DEC_GROUP frames, and scoring stops at the first group that
// holds a valid non-blank frame: the frames after it cannot change the
// decision (each frame's argmax is independent), so the tokens are those of
// the whole-window joint.
//
// Every product is a matrix-vector product against a weight in PyTorch's
// [out, in] layout: each warp reads 8 rows at once, its lanes along the
// rows in 16-byte loads (coalesced, many independent loads in flight; single
// elements where a row length is not a multiple of 16 bytes), and sums each
// row with shuffles. The block's vectors (x, gates, c, h, the lag states,
// pred_p, the z rows) live in shared memory, each 16-byte aligned.
//
// What bounds it on the card: the chain of up to (factor + 1) T + 1
// dependent iterations, each reading the vocabulary weights (and, when it
// emits, the LSTM and prejoint weights: ~4 MB in f32, ~2 MB in bf16 at the
// flagship's E = H = J = 320, V = 256) through L2 into one SM per
// utterance, where the latency of the loads, not the bytes, sets each
// step's time. Keeping the weights resident in a cluster's distributed
// shared memory is later work.
#include "common.cuh"

namespace tfasr {

constexpr int DEC_THREADS = 512;
constexpr int DEC_WARPS = DEC_THREADS / 32;
constexpr int DEC_GROUP = 4;  // frames scored together (one read of Wv serves them all)
constexpr int DEC_MAX_LAYERS = 4;

struct DecodeLayer {
  const void* w_ih;    // [4H, In] T
  const void* w_hh;    // [4H, H] T
  const float* b;      // [4H]
  const float* ln;     // [2, H] scale, bias; or null
  const void* w_proj;  // [P, H] T; or null
  const float* b_proj; // [P]
};

struct DecodeArgs {
  const void* enc_p;  // [B, T, J] T
  const int* lens;    // [B]
  const int* tok0;    // [B]
  const void* embed;  // [V, E] T
  DecodeLayer layers[DEC_MAX_LAYERS];
  int n_layers;
  const void* wp;     // [J, In_last] T
  const float* bp;    // [J]
  const void* wv;     // [V, J] T
  const float* bv;    // [V]
  const float* st0;   // [L, 2, B, H] (c then h)
  int* tokens;        // [B, max_tokens], pre-filled with blank
  int* out_len;       // [B]
  int* next_tok;      // [B]
  float* st_out;      // [L, 2, B, H]
  int B, T, E, H, P, J, V, K, max_tokens, step_max, blank;
  float eps;
};

// Shared-memory layout of one block: each vector starts on a 16-byte
// boundary (the products read x in float4s); the int tail is separate.
__host__ __device__ inline int dec_a4(int n) { return (n + 3) & ~3; }
__host__ __device__ inline int dec_xn(const DecodeArgs& a) {
  int n = a.E > a.H ? a.E : a.H;
  return dec_a4(n > a.P ? n : a.P);
}
__host__ __device__ inline size_t dec_smem_floats(const DecodeArgs& a) {
  return (size_t)dec_xn(a) + dec_a4(4 * a.H) + 4 * dec_a4(a.n_layers * a.H) + dec_a4(a.H) + dec_a4(a.J) + dec_a4(DEC_GROUP * a.J) + DEC_WARPS +
         DEC_WARPS * DEC_GROUP;
}

// Sum of one value per thread over the block, in the same order on every thread.
__device__ __forceinline__ float dec_block_sum(float v, float* red, int warp, int lane) {
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < DEC_WARPS; ++w) s += red[w];
  __syncthreads();
  return s;
}

// Weight rows one warp reads together. Each load is an L2 round trip in a
// chain of dependent steps on one SM, so the products are bound by the loads
// in flight: each lane reads 16 bytes of DEC_ROWS rows at a time.
constexpr int DEC_ROWS = 8;

// 16 bytes of T at p (16-byte aligned) as f32 values.
__device__ __forceinline__ void dec_load16(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void dec_load16(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const unsigned int w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // a bf16 is the upper half of an f32; the lower address holds the lower half of the word
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// N f32 values of shared memory at x (16-byte aligned).
template <int N>
__device__ __forceinline__ void dec_load_x(const float* x, float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float4 q = reinterpret_cast<const float4*>(x)[i];
    v[4 * i] = q.x;
    v[4 * i + 1] = q.y;
    v[4 * i + 2] = q.z;
    v[4 * i + 3] = q.w;
  }
}

// A row length K (elements of T) and row base W that 16-byte loads can walk.
template <typename T>
__device__ __forceinline__ bool dec_vector_rows(const T* W, int K) {
  return K % (16 / (int)sizeof(T)) == 0 && (reinterpret_cast<uintptr_t>(W) & 15) == 0;
}

// acc[r] += x . W[n0 + r, :K] per lane, r < R: 16-byte chunks of each row
// (lane-strided) where the rows allow, else single elements; rows past N
// re-read row N - 1 and are discarded by the caller.
template <typename T, int R>
__device__ __forceinline__ void dec_dot_rows(const T* __restrict__ W, const float* __restrict__ x, int n0, int N, int K, float (&acc)[R], int lane) {
  const T* rows[R];
#pragma unroll
  for (int r = 0; r < R; ++r) rows[r] = W + (size_t)min(n0 + r, N - 1) * K;
  if (dec_vector_rows(W, K)) {
    constexpr int V = 16 / sizeof(T);
#pragma unroll 2
    for (int c = lane; c < K / V; c += 32) {
      float xv[V];
      dec_load_x<V>(x + c * V, xv);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float w[V];
        dec_load16(rows[r] + c * V, w);
#pragma unroll
        for (int i = 0; i < V; ++i) acc[r] = fmaf(xv[i], w[i], acc[r]);
      }
    }
    return;
  }
#pragma unroll 4
  for (int k = lane; k < K; k += 32) {
    const float xv = x[k];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = fmaf(xv, to_f32(rows[r][k]), acc[r]);
  }
}

// out[n] = x . W[n, :K] (+ bias[n]) for n < N: each warp DEC_ROWS rows at a time, a shuffle sum per row.
template <typename T>
__device__ __forceinline__ void dec_gemv(const T* __restrict__ W, const float* x, int N, int K, const float* __restrict__ bias, float* out,
                                         int warp, int lane) {
  for (int n0 = warp * DEC_ROWS; n0 < N; n0 += DEC_WARPS * DEC_ROWS) {
    float acc[DEC_ROWS] = {};
    dec_dot_rows<T, DEC_ROWS>(W, x, n0, N, K, acc, lane);
#pragma unroll
    for (int r = 0; r < DEC_ROWS; ++r) {
      const float s = warp_sum(acc[r]);
      if (lane == 0 && n0 + r < N) out[n0 + r] = bias ? s + bias[n0 + r] : s;
    }
  }
}

// One prediction-network step on token `tok`: updates c, h (layer l at l*H)
// and writes pred_p. Ends in a barrier.
template <typename T>
__device__ void dec_pred_step(const DecodeArgs& a, int tok, float* xin, float* gates, float* c, float* h, float* y, float* pred, float* red,
                              int tid, int warp, int lane) {
  const int H = a.H;
  const T* embed = static_cast<const T*>(a.embed);
  const bool in_table = tok >= 0 && tok < a.V;  // JAX's one-hot read gives 0 for an id outside the table
  for (int k = tid; k < a.E; k += DEC_THREADS) xin[k] = in_table ? to_f32(embed[(size_t)tok * a.E + k]) : 0.f;
  __syncthreads();
  int in_dim = a.E;
  for (int l = 0; l < a.n_layers; ++l) {
    const DecodeLayer& L = a.layers[l];
    const T* wih = static_cast<const T*>(L.w_ih);
    const T* whh = static_cast<const T*>(L.w_hh);
    float* cl = c + l * H;
    float* hl = h + l * H;
    for (int u = tid; u < H; u += DEC_THREADS) y[u] = round_to<T>(hl[u]);  // h enters its product in T
    __syncthreads();
    // gates = x . Wih^T + h . Whh^T + b, accumulated in f32
    for (int n0 = warp * DEC_ROWS; n0 < 4 * H; n0 += DEC_WARPS * DEC_ROWS) {
      float acc[DEC_ROWS] = {};
      dec_dot_rows<T, DEC_ROWS>(wih, xin, n0, 4 * H, in_dim, acc, lane);
      dec_dot_rows<T, DEC_ROWS>(whh, y, n0, 4 * H, H, acc, lane);
#pragma unroll
      for (int r = 0; r < DEC_ROWS; ++r) {
        const float s = warp_sum(acc[r]);
        if (lane == 0 && n0 + r < 4 * H) gates[n0 + r] = s + L.b[n0 + r];
      }
    }
    __syncthreads();
    for (int u = tid; u < H; u += DEC_THREADS) {
      const float gi = sigmoid_f32(gates[u]), gf = sigmoid_f32(gates[H + u]);
      const float gg = tanhf(gates[2 * H + u]), go = sigmoid_f32(gates[3 * H + u]);
      const float c2 = gf * cl[u] + gi * gg;
      const float h2 = go * tanhf(c2);
      cl[u] = c2;
      hl[u] = h2;
      y[u] = h2;
    }
    __syncthreads();
    if (L.ln) {
      float s = 0.f;
      for (int u = tid; u < H; u += DEC_THREADS) s += y[u];
      const float mean = dec_block_sum(s, red, warp, lane) / (float)H;
      float q = 0.f;
      for (int u = tid; u < H; u += DEC_THREADS) {
        const float d = y[u] - mean;
        q = fmaf(d, d, q);
      }
      const float rstd = rsqrtf(dec_block_sum(q, red, warp, lane) / (float)H + a.eps);
      for (int u = tid; u < H; u += DEC_THREADS) y[u] = (y[u] - mean) * rstd * L.ln[u] + L.ln[H + u];
      __syncthreads();
    }
    if (L.w_proj) {
      // the projection reads y rounded to T; its output is the next input, rounded when read
      for (int u = tid; u < H; u += DEC_THREADS) y[u] = round_to<T>(y[u]);
      __syncthreads();
      dec_gemv<T>(static_cast<const T*>(L.w_proj), y, a.P, H, L.b_proj, xin, warp, lane);
      __syncthreads();
      for (int p = tid; p < a.P; p += DEC_THREADS) xin[p] = round_to<T>(xin[p]);
      in_dim = a.P;
    } else {
      for (int u = tid; u < H; u += DEC_THREADS) xin[u] = round_to<T>(y[u]);
      in_dim = H;
    }
    __syncthreads();
  }
  dec_gemv<T>(static_cast<const T*>(a.wp), xin, a.J, in_dim, a.bp, pred, warp, lane);
  __syncthreads();
}

// Scores frames s0 .. s0+ng-1 under pred_p: ids[i] = argmax of their logits.
// Ends in a barrier.
template <typename T>
__device__ void dec_joint_argmax(const DecodeArgs& a, const T* enc, int s0, int ng, const float* pred, float* z, float* bestv, int* besti,
                                 int* ids, int tid, int warp, int lane) {
  const int J = a.J;
  for (int i = tid; i < ng * J; i += DEC_THREADS) {
    const int f = i / J, j = i - f * J;
    z[i] = round_to<T>(tanhf(to_f32(enc[(size_t)(s0 + f) * J + j]) + pred[j]));
  }
  __syncthreads();
  const T* wv = static_cast<const T*>(a.wv);
  float best[DEC_GROUP];
  int arg[DEC_GROUP];
#pragma unroll
  for (int i = 0; i < DEC_GROUP; ++i) {
    best[i] = -INFINITY;
    arg[i] = a.V;
  }
  constexpr int VR = 4;  // vocabulary rows per warp pass
  const bool vector_rows = dec_vector_rows(wv, J);
  for (int v0 = warp * VR; v0 < a.V; v0 += DEC_WARPS * VR) {
    const T* rows[VR];
#pragma unroll
    for (int r = 0; r < VR; ++r) rows[r] = wv + (size_t)min(v0 + r, a.V - 1) * J;
    float acc[VR][DEC_GROUP] = {};
    if (vector_rows) {
      constexpr int NV = 16 / sizeof(T);
#pragma unroll 2
      for (int c = lane; c < J / NV; c += 32) {
        float zk[DEC_GROUP][NV];
#pragma unroll
        for (int i = 0; i < DEC_GROUP; ++i) dec_load_x<NV>(z + i * J + c * NV, zk[i]);
#pragma unroll
        for (int r = 0; r < VR; ++r) {
          float w[NV];
          dec_load16(rows[r] + c * NV, w);
#pragma unroll
          for (int i = 0; i < DEC_GROUP; ++i) {
#pragma unroll
            for (int e = 0; e < NV; ++e) acc[r][i] = fmaf(zk[i][e], w[e], acc[r][i]);
          }
        }
      }
    } else {
#pragma unroll 4
      for (int k = lane; k < J; k += 32) {
        float zk[DEC_GROUP];
#pragma unroll
        for (int i = 0; i < DEC_GROUP; ++i) zk[i] = z[i * J + k];
#pragma unroll
        for (int r = 0; r < VR; ++r) {
          const float w = to_f32(rows[r][k]);
#pragma unroll
          for (int i = 0; i < DEC_GROUP; ++i) acc[r][i] = fmaf(zk[i], w, acc[r][i]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < VR; ++r) {
      const int v = v0 + r;
      const float bias = a.bv[min(v, a.V - 1)];
#pragma unroll
      for (int i = 0; i < DEC_GROUP; ++i) {
        const float s = warp_sum(acc[r][i]) + bias;
        if (v < a.V && s > best[i]) {  // this warp's v ascend: a tie keeps the lower index
          best[i] = s;
          arg[i] = v;
        }
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < DEC_GROUP; ++i) {
      bestv[warp * DEC_GROUP + i] = best[i];
      besti[warp * DEC_GROUP + i] = arg[i];
    }
  }
  __syncthreads();
  if (tid < ng) {
    float bv = -INFINITY;
    int bi = a.V;
    for (int w = 0; w < DEC_WARPS; ++w) {
      const float v = bestv[w * DEC_GROUP + tid];
      const int vi = besti[w * DEC_GROUP + tid];
      if (v > bv || (v == bv && vi < bi)) {
        bv = v;
        bi = vi;
      }
    }
    ids[tid] = bi;
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(DEC_THREADS) greedy_decode_kernel(const DecodeArgs a) {
  extern __shared__ float sm[];
  const int b = blockIdx.x, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int H = a.H, LH = a.n_layers * a.H;
  float* xin = sm;
  float* gates = xin + dec_xn(a);
  float* c = gates + dec_a4(4 * H);
  float* h = c + dec_a4(LH);
  float* lc = h + dec_a4(LH);
  float* lh = lc + dec_a4(LH);
  float* y = lh + dec_a4(LH);
  float* pred = y + dec_a4(H);
  float* z = pred + dec_a4(a.J);
  float* red = z + dec_a4(DEC_GROUP * a.J);
  float* bestv = red + DEC_WARPS;
  int* besti = reinterpret_cast<int*>(bestv + DEC_WARPS * DEC_GROUP);
  int* ids = besti + DEC_WARPS * DEC_GROUP;

  for (int i = tid; i < DEC_GROUP * a.J; i += DEC_THREADS) z[i] = 0.f;
  for (int i = tid; i < LH; i += DEC_THREADS) {
    const int l = i / H, u = i - l * H;
    c[i] = lc[i] = a.st0[((size_t)(2 * l) * a.B + b) * H + u];
    h[i] = lh[i] = a.st0[((size_t)(2 * l + 1) * a.B + b) * H + u];
  }
  __syncthreads();
  int prev = a.tok0[b];
  dec_pred_step<T>(a, prev, xin, gates, c, h, y, pred, red, tid, warp, lane);

  const int len = min(max(a.lens[b], 0), a.T);  // frames past T cannot emit: the outputs are those of the unclamped loop
  const T* enc = static_cast<const T*>(a.enc_p) + (size_t)b * a.T * a.J;
  int t = 0, idx = 0;
  for (int step = 0; step < a.step_max && t < len; ++step) {
    const int start = min(t, a.T - a.K);
    int first = a.K, tok = a.blank;
    if (idx < a.max_tokens) {
      for (int g0 = 0; g0 < a.K; g0 += DEC_GROUP) {
        const int s0 = start + g0, ng = min(DEC_GROUP, a.K - g0);
        if (s0 >= len) break;
        if (s0 + ng <= t) continue;
        dec_joint_argmax<T>(a, enc, s0, ng, pred, z, bestv, besti, ids, tid, warp, lane);
        for (int i = 0; i < ng; ++i) {
          if (s0 + i >= t && s0 + i < len && ids[i] != a.blank) {
            first = g0 + i;
            tok = ids[i];
            break;
          }
        }
        if (first < a.K) break;
      }
    }
    if (first < a.K) {
      if (tid == 0) a.tokens[(size_t)b * a.max_tokens + idx] = tok;
      ++idx;
      prev = tok;
      t = max(start + first, t);
      for (int i = tid; i < LH; i += DEC_THREADS) {
        lc[i] = c[i];
        lh[i] = h[i];
      }
      __syncthreads();
      dec_pred_step<T>(a, prev, xin, gates, c, h, y, pred, red, tid, warp, lane);
    } else {
      t = max(min(start + a.K, len), t);
    }
  }
  if (tid == 0) {
    a.out_len[b] = idx;
    a.next_tok[b] = prev;
  }
  for (int i = tid; i < LH; i += DEC_THREADS) {
    const int l = i / H, u = i - l * H;
    a.st_out[((size_t)(2 * l) * a.B + b) * H + u] = lc[i];
    a.st_out[((size_t)(2 * l + 1) * a.B + b) * H + u] = lh[i];
  }
}

template <typename T>
static int launch_decode(const DecodeArgs& a, cudaStream_t stream) {
  const size_t smem = dec_smem_floats(a) * sizeof(float) + (size_t)(DEC_WARPS * DEC_GROUP + DEC_GROUP) * sizeof(int);
  cudaError_t err = allow_smem(greedy_decode_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  greedy_decode_kernel<T><<<a.B, DEC_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace tfasr

extern "C" int tfasr_greedy_decode(const void* enc_p, const int* lens, const int* tok0, const void* embed, int n_layers,
                                   const void* const* w_ih, const void* const* w_hh, const void* const* b, const void* const* ln,
                                   const void* const* w_proj, const void* const* b_proj, const void* wp, const float* bp, const void* wv,
                                   const float* bv, const float* st0, int* tokens, int* out_len, int* next_tok, float* st_out, int B, int T,
                                   int E, int H, int P, int J, int V, int K, int max_tokens, int step_max, int blank, float eps, int dtype,
                                   cudaStream_t stream) {
  using namespace tfasr;
  if (n_layers < 1 || n_layers > DEC_MAX_LAYERS) return (int)cudaErrorInvalidValue;
  DecodeArgs a{};
  a.enc_p = enc_p;
  a.lens = lens;
  a.tok0 = tok0;
  a.embed = embed;
  a.n_layers = n_layers;
  for (int l = 0; l < n_layers; ++l) {
    a.layers[l] = DecodeLayer{w_ih[l], w_hh[l], static_cast<const float*>(b[l]), static_cast<const float*>(ln[l]), w_proj[l],
                              static_cast<const float*>(b_proj[l])};
  }
  a.wp = wp;
  a.bp = bp;
  a.wv = wv;
  a.bv = bv;
  a.st0 = st0;
  a.tokens = tokens;
  a.out_len = out_len;
  a.next_tok = next_tok;
  a.st_out = st_out;
  a.B = B;
  a.T = T;
  a.E = E;
  a.H = H;
  a.P = P;
  a.J = J;
  a.V = V;
  a.K = K;
  a.max_tokens = max_tokens;
  a.step_max = step_max;
  a.blank = blank;
  a.eps = eps;
  if (B == 0) return 0;
  return dtype == kBF16 ? launch_decode<__nv_bfloat16>(a, stream) : launch_decode<float>(a, stream);
}
