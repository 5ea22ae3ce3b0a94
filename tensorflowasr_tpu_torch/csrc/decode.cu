// Fused greedy transducer decode: the whole WIND greedy loop of one
// utterance in one thread-block cluster.
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
// prefetch). None of that is carried over: here one cluster of C blocks owns
// one utterance and runs its own loop. A row that finishes early in the JAX
// shared loop only idles (its t, idx and states stop moving), so per-row
// loops give the same outputs. The window is scored in groups of DEC_GROUP
// frames, and scoring stops at the first group that holds a valid non-blank
// frame: the frames after it cannot change the decision (each frame's argmax
// is independent), so the tokens are those of the whole-window joint.
//
// The cluster splits the weights: block r owns the four gate rows (i, f, g,
// o) of its H/C LSTM units in each layer (so the cell update stays local),
// its P/C rows of each projection, J/C rows of the prejoint Wp and V/C rows
// of the vocabulary Wv. Each block copies its slices into its own shared
// memory once, at the start, as far as they fit (the plan, computed by the
// wrapper: Wv first, then Wp, Whh, Wih, the projections); the rest of its
// slice it reads from L2 each step. After each product stage every block
// pushes its slice of the output vector (h, the projection, pred_p) into
// every block's shared memory (distributed shared memory, st.async counted
// on the receiver's mbarrier) and waits until its own copy of the whole
// vector has arrived: no cluster-wide barrier in the loop. LayerNorm runs in
// every warp of every block on the whole vector in one fixed order, so all
// agree bit for bit. Each block takes the argmax over its V/C vocabulary
// rows; the (value, index) pairs are exchanged and every block reduces them
// in rank order (lowest index on ties). So t, idx, the emissions and the
// carry-out are identical in every block. Vectors a block may still read
// while another writes the next step's values (h, the argmax pairs) are
// double-buffered.
//
// Every product is a matrix-vector product against a weight in PyTorch's
// [out, in] layout: each row's dot product stays inside one warp, its lanes
// along the row in 16-byte loads (single elements where a row length is not
// a multiple of 16 bytes) and one shuffle sum per row, in the same order as
// a single block would take it.
//
// What bounds it on the card: the chain of up to (factor + 1) T + 1
// dependent iterations. Each costs an exchange per stage (one per scored
// frame group; per emission one per layer, one per projection, one for
// pred_p) and the block's share of the weight rows (~125 KB per block and
// emission at the flagship in bf16 with C = 16, or part of them from L2),
// not the card's bandwidth or its arithmetic.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace tfasr {

constexpr int DEC_THREADS = 512;
constexpr int DEC_WARPS = DEC_THREADS / 32;
constexpr int DEC_GROUP = 4;  // frames scored together (one read of Wv serves them all)
constexpr int DEC_MAX_LAYERS = 4;
constexpr int DEC_MAX_CLUSTER = 16;
constexpr int DEC_ROWS = 5;  // weight rows one warp reads together (16 warps x 5 = the 80 gate rows of H 320 at C 16)
constexpr int DEC_VROWS = 2; // vocabulary rows one warp scores together (they share the z reads)
// Weight matrices in residency order: Wv, Wp, then Whh of each layer, Wih of each layer, the projections.
constexpr int DEC_MAX_MATS = 2 + 3 * DEC_MAX_LAYERS;

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
  int C;                   // blocks per cluster
  int res[DEC_MAX_MATS];   // resident rows of each matrix's per-block slice
};

__host__ __device__ inline int dec_a4(int n) { return (n + 3) & ~3; }
__host__ __device__ inline int dec_split_start(int n, int C, int r) { return r * (n / C) + (r < n % C ? r : n % C); }
__host__ __device__ inline int dec_split_count(int n, int C, int r) { return n / C + (r < n % C ? 1 : 0); }

// Float offsets of a block's vectors in shared memory (each 16-byte aligned;
// mirrored by decode_kernel._vec_floats).
struct DecVec {
  int xin, hr, y, hbuf, xp, pred, z, gates, grow, cbuf, wbest, wbesti, argv, argi, ids, total;
};
__host__ __device__ inline DecVec dec_vec(int E, int H, int P, int J, int L, int C) {
  DecVec o;
  const int nu = (H + C - 1) / C;
  int xn = E > H ? E : H;
  xn = xn > P ? xn : P;
  int n = 0;
  o.xin = n;    n += dec_a4(xn);                // the product input x, rounded
  o.hr = n;     n += dec_a4(H);                 // h of the layer, rounded (the Whh product's input)
  o.y = n;      n += dec_a4(H);                 // the layer's output (LayerNorm'd, rounded), the projection's input
  o.hbuf = n;   n += 2 * L * dec_a4(H);         // [parity][layer] h, written by every block
  o.xp = n;     n += L * dec_a4(P);             // [layer] projection output, written by every block
  o.pred = n;   n += dec_a4(J);                 // pred_p, written by every block
  o.z = n;      n += dec_a4(DEC_GROUP * J);     // tanh(enc_p + pred_p) of a frame group, rounded
  o.gates = n;  n += dec_a4(4 * nu);            // this block's gate rows
  o.grow = n;   n += dec_a4(4 * nu);            // (int) the global row of each of its gate rows
  o.cbuf = n;   n += 2 * L * dec_a4(nu);        // [parity][layer] c of this block's units
  o.wbest = n;  n += DEC_WARPS * DEC_GROUP;     // per warp best logit of each frame
  o.wbesti = n; n += DEC_WARPS * DEC_GROUP;     // (int)
  o.argv = n;   n += 2 * C * DEC_GROUP;         // [parity][rank][frame] best logit, written by every block
  o.argi = n;   n += 2 * C * DEC_GROUP;         // (int)
  o.ids = n;    n += DEC_GROUP;                 // (int) the group's argmax
  o.total = n;
  return o;
}

// Row length of weight matrix m (the residency order above).
__host__ __device__ inline int dec_mat_k(int m, int E, int H, int P, int J, int L) {
  const int in_last = P > 0 ? P : H;
  if (m == 0) return J;
  if (m == 1) return in_last;
  if (m < 2 + L) return H;
  if (m < 2 + 2 * L) return m == 2 + L ? E : in_last;
  return H;
}

__host__ __device__ inline size_t dec_a16(size_t bytes) { return (bytes + 15) & ~(size_t)15; }

// Dynamic shared memory of one block: its vectors, then the resident rows of each matrix.
__host__ __device__ inline size_t dec_smem_bytes(int E, int H, int P, int J, int L, int C, const int* res, int elt) {
  size_t n = (size_t)dec_vec(E, H, P, J, L, C).total * sizeof(float);
  for (int m = 0; m < 2 + 3 * L; ++m) n += dec_a16((size_t)res[m] * dec_mat_k(m, E, H, P, J, L) * elt);
  return n;
}

__device__ __forceinline__ uint32_t dec_smem(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

// 16 bytes at the 32-bit shared-memory address a.
__device__ __forceinline__ uint4 dec_lds(uint32_t a) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n" : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(a));
  return v;
}

// 16 bytes of T as f32 values.
__device__ __forceinline__ void dec_unpack(const uint4& q, float (&v)[4]) {
  v[0] = __uint_as_float(q.x);
  v[1] = __uint_as_float(q.y);
  v[2] = __uint_as_float(q.z);
  v[3] = __uint_as_float(q.w);
}
__device__ __forceinline__ void dec_unpack(const uint4& q, float (&v)[8]) {
  const unsigned int w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // a bf16 is the upper half of an f32; the lower address holds the lower half of the word
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// 16 bytes of T at p (16-byte aligned, shared or global) as f32 values.
template <typename T, int NV>
__device__ __forceinline__ void dec_load16(const T* p, float (&v)[NV]) { dec_unpack(*reinterpret_cast<const uint4*>(p), v); }

// N f32 values of shared memory at the shared address x (16-byte aligned).
template <int N>
__device__ __forceinline__ void dec_load_x(uint32_t x, float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const uint4 q = dec_lds(x + 16 * i);
    v[4 * i] = __uint_as_float(q.x);
    v[4 * i + 1] = __uint_as_float(q.y);
    v[4 * i + 2] = __uint_as_float(q.z);
    v[4 * i + 3] = __uint_as_float(q.w);
  }
}

template <typename T>
__device__ __forceinline__ bool dec_aligned(const T* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// acc[r] += x . rows[r][:K] per lane (x in shared memory; rows in shared or
// global memory): 16-byte chunks of each row (lane-strided) where every row
// allows it, else single elements.
template <typename T, int R>
__device__ __forceinline__ void dec_dot_rows(const T* const (&rows)[R], const float* x, int K, float (&acc)[R], int lane) {
  constexpr int NV = 16 / sizeof(T);
  bool vec = K % NV == 0;
#pragma unroll
  for (int r = 0; r < R; ++r) vec = vec && dec_aligned(rows[r]);
  if (vec) {
    const uint32_t xs = dec_smem(x);
#pragma unroll 2
    for (int c = lane; c < K / NV; c += 32) {
      float xv[NV];
      dec_load_x<NV>(xs + c * NV * 4, xv);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float w[NV];
        dec_load16(rows[r] + c * NV, w);
#pragma unroll
        for (int i = 0; i < NV; ++i) acc[r] = fmaf(xv[i], w[i], acc[r]);
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

// One weight slice of this block: local row lr is global row n0 + lr, or for
// gate rows grow[lr] (a table in shared memory: (lr / nu) * H + u0 + lr % nu,
// gate lr / nu of unit u0 + lr % nu); rows below res sit in shared memory at base.
template <typename T>
struct DecSlice {
  const T* w;       // the whole matrix [N, K] in global memory
  const T* base;    // resident rows [res, K] in shared memory
  const int* grow;  // gate rows: the global row of each local row; else null
  int n0, count, res, K;
  __device__ __forceinline__ int global_row(int lr) const { return grow ? grow[lr] : n0 + lr; }
  __device__ __forceinline__ const T* row(int lr) const {
    return lr < res ? base + (size_t)lr * K : w + (size_t)global_row(lr) * K;
  }
};

// acc[r] += x . row(lr0 + r) for r < R (rows past the slice re-read its last
// row), the same sums as dec_dot_rows: where those rows are resident and
// whole 16-byte chunks, by ld.shared at consecutive row addresses, else
// through per-row pointers.
template <typename T, int R>
__device__ __forceinline__ void dec_dot_slice(const DecSlice<T>& s, int lr0, const float* x, float (&acc)[R], int lane) {
  constexpr int NV = 16 / sizeof(T);
  const int last = min(R - 1, s.count - 1 - lr0), K = s.K;
  if (K % NV == 0 && lr0 + last < s.res) {
    const uint32_t stride = K * sizeof(T), row0 = dec_smem(s.base) + lr0 * stride, xs = dec_smem(x);
#pragma unroll 2
    for (int c = lane; c < K / NV; c += 32) {
      float xv[NV];
      dec_load_x<NV>(xs + c * NV * 4, xv);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float w[NV];
        dec_unpack(dec_lds(row0 + min(r, last) * stride + c * 16), w);
#pragma unroll
        for (int i = 0; i < NV; ++i) acc[r] = fmaf(xv[i], w[i], acc[r]);
      }
    }
    return;
  }
  const T* rows[R];
#pragma unroll
  for (int r = 0; r < R; ++r) rows[r] = s.row(lr0 + min(r, last));
  dec_dot_rows<T, R>(rows, x, K, acc, lane);
}

// Copy the resident rows of a slice into shared memory (the whole block).
template <typename T>
__device__ void dec_stage(const DecSlice<T>& s) {
  constexpr int NV = 16 / sizeof(T);
  const int rows = min(s.res, s.count);
  T* dst = const_cast<T*>(s.base);
  if (s.K % NV == 0 && dec_aligned(s.w)) {
    const int cpr = s.K / NV;
    for (int i = threadIdx.x; i < rows * cpr; i += DEC_THREADS) {
      const int lr = i / cpr, c = i - lr * cpr;
      reinterpret_cast<uint4*>(dst + (size_t)lr * s.K)[c] = reinterpret_cast<const uint4*>(s.w + (size_t)s.global_row(lr) * s.K)[c];
    }
  } else {
    for (int i = threadIdx.x; i < rows * s.K; i += DEC_THREADS) {
      const int lr = i / s.K, k = i - lr * s.K;
      dst[(size_t)lr * s.K + k] = s.w[(size_t)s.global_row(lr) * s.K + k];
    }
  }
}

// The exchanges. A block pushes each value it produces into the same place
// of every block's shared memory with st.async, which counts its bytes on
// the receiving block's mbarrier; a block waits on its own mbarrier until
// the whole vector has arrived. No cluster-wide barrier: each exchange is
// one write and one wait. Each mbarrier serves one exchange (h and the
// projection of each layer, pred_p, the argmax pairs of each parity);
// between two uses of one mbarrier by a block, every other block has
// passed the first use, so the phases never mix.
enum DecBar : int { kBarH = 0, kBarProj = DEC_MAX_LAYERS, kBarPred = 2 * DEC_MAX_LAYERS, kBarArg, DEC_BARS = kBarArg + 2 };

// Write the 32-bit value `bits` at the shared address `dst` of block `rank`,
// counting 4 bytes on its barrier `bar` (a local shared address as well).
__device__ __forceinline__ void dec_push(uint32_t dst, uint32_t bits, uint32_t bar, int rank) {
  uint32_t rd, rb;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(rd) : "r"(dst), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(rb) : "r"(bar), "r"(rank));
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n" ::"r"(rd), "r"(bits), "r"(rb) : "memory");
}

// Wait (every thread) until `bytes` have arrived on barrier i for its current
// phase; phases holds each barrier's phase parity, the same in every thread.
__device__ __forceinline__ void dec_wait(unsigned long long* bars, int i, unsigned int bytes, unsigned int& phases) {
  const uint32_t bar = dec_smem(bars + i);
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

// out[n0 + lr] = x . row(lr) (+ bias) for the slice's rows, pushed into the
// vector `dst` (a local shared-memory address) of every block of the
// cluster on barrier `bar`.
template <typename T>
__device__ __forceinline__ void dec_rows_to_cluster(const DecSlice<T> s, const float* x, const float* __restrict__ bias, float* dst,
                                                    unsigned long long* bar, int C, int warp, int lane) {
  for (int lr0 = warp * DEC_ROWS; lr0 < s.count; lr0 += DEC_WARPS * DEC_ROWS) {
    float acc[DEC_ROWS] = {};
    dec_dot_slice<T, DEC_ROWS>(s, lr0, x, acc, lane);
#pragma unroll
    for (int r = 0; r < DEC_ROWS; ++r) {
      const float v = warp_sum(acc[r]);
      const int n = s.n0 + lr0 + r;
      if (lr0 + r < s.count && lane < C) dec_push(dec_smem(dst + n), __float_as_uint(bias ? v + bias[n] : v), dec_smem(bar), lane);
    }
  }
}

struct DecShared {
  float *xin, *hr, *y, *hbuf, *xp, *pred, *z, *gates, *cbuf, *wbest, *argv;
  int *wbesti, *argi, *ids;
  unsigned long long* bars;
};

// One prediction-network step on token `tok` for the cluster: reads h and c
// at parity par, writes them at par ^ 1 and pred_p into every block.
template <typename T>
__device__ void dec_pred_step(const DecodeArgs& a, const DecodeLayer* layers, const DecSlice<T>* ih, const DecSlice<T>* hh, const DecSlice<T>* proj,
                              const DecSlice<T>& wp, int tok, int par, const DecShared& v, unsigned int& phases, int nu, int u0, int tid, int warp,
                              int lane) {
  const int H = a.H, C = a.C, L = a.n_layers;
  const int hstride = dec_a4(H), cstride = dec_a4(nu), pstride = dec_a4(a.P);
  const T* embed = static_cast<const T*>(a.embed);
  const bool in_table = tok >= 0 && tok < a.V;  // JAX's one-hot read gives 0 for an id outside the table
  for (int k = tid; k < a.E; k += DEC_THREADS) v.xin[k] = in_table ? to_f32(embed[(size_t)tok * a.E + k]) : 0.f;
  for (int l = 0; l < L; ++l) {
    const float* hprev = v.hbuf + (par * L + l) * hstride;
    float* hnew = v.hbuf + ((par ^ 1) * L + l) * hstride;
    const float* cprev = v.cbuf + (par * L + l) * cstride;
    float* cnew = v.cbuf + ((par ^ 1) * L + l) * cstride;
    for (int u = tid; u < H; u += DEC_THREADS) v.hr[u] = round_to<T>(hprev[u]);  // h enters its product in T
    __syncthreads();
    // this block's gate rows: x . Wih^T + h . Whh^T + b, accumulated in f32
    const DecodeLayer& Ly = layers[l];
    const DecSlice<T> si = ih[l], sh = hh[l];  // in registers for the loop
    for (int lr0 = warp * DEC_ROWS; lr0 < 4 * nu; lr0 += DEC_WARPS * DEC_ROWS) {
      float acc[DEC_ROWS] = {};
      dec_dot_slice<T, DEC_ROWS>(si, lr0, v.xin, acc, lane);
      dec_dot_slice<T, DEC_ROWS>(sh, lr0, v.hr, acc, lane);
#pragma unroll
      for (int r = 0; r < DEC_ROWS; ++r) {
        const float s = warp_sum(acc[r]);
        if (lane == 0 && lr0 + r < 4 * nu) v.gates[lr0 + r] = s + Ly.b[sh.global_row(lr0 + r)];
      }
    }
    __syncthreads();
    // the cell of this block's units; h' into every block (one thread per unit and rank)
    for (int i = tid; i < nu * C; i += DEC_THREADS) {
      const int q = i / nu, uu = i - q * nu;
      const float gi = sigmoid_f32(v.gates[uu]), gf = sigmoid_f32(v.gates[nu + uu]);
      const float gg = tanhf(v.gates[2 * nu + uu]), go = sigmoid_f32(v.gates[3 * nu + uu]);
      const float c2 = gf * cprev[uu] + gi * gg;
      const float h2 = go * tanhf(c2);
      if (q == 0) cnew[uu] = c2;
      dec_push(dec_smem(hnew + u0 + uu), __float_as_uint(h2), dec_smem(v.bars + kBarH + l), q);
    }
    dec_wait(v.bars, kBarH + l, 4u * H, phases);
    // LayerNorm statistics (centred variance), computed by every warp over the whole h in one order: every warp of every block agrees
    float mean = 0.f, rstd = 1.f;
    if (Ly.ln) {
      float s = 0.f;
      for (int u = lane; u < H; u += 32) s += hnew[u];
      mean = warp_sum(s) / (float)H;
      float q = 0.f;
      for (int u = lane; u < H; u += 32) {
        const float d = hnew[u] - mean;
        q = fmaf(d, d, q);
      }
      rstd = rsqrtf(warp_sum(q) / (float)H + a.eps);
    }
    // the layer's output, rounded to T: the projection's input, or the next product's
    float* out = Ly.w_proj ? v.y : v.xin;
    for (int u = tid; u < H; u += DEC_THREADS) out[u] = round_to<T>(Ly.ln ? (hnew[u] - mean) * rstd * Ly.ln[u] + Ly.ln[H + u] : hnew[u]);
    __syncthreads();
    if (Ly.w_proj) {
      float* xp = v.xp + l * pstride;
      dec_rows_to_cluster<T>(proj[l], v.y, Ly.b_proj, xp, v.bars + kBarProj + l, C, warp, lane);
      dec_wait(v.bars, kBarProj + l, 4u * a.P, phases);
      for (int p = tid; p < a.P; p += DEC_THREADS) v.xin[p] = round_to<T>(xp[p]);  // the next input, rounded when read
      __syncthreads();
    }
  }
  dec_rows_to_cluster<T>(wp, v.xin, a.bp, v.pred, v.bars + kBarPred, C, warp, lane);
  dec_wait(v.bars, kBarPred, 4u * a.J, phases);
}

// Scores frames s0 .. s0+ng-1 under pred_p: v.ids[i] = argmax of their
// logits over the whole vocabulary. gpar picks the exchange buffers.
template <typename T>
__device__ void dec_joint_argmax(const DecodeArgs& a, const DecSlice<T> wv, const T* enc, int s0, int ng, int gpar, int rank, const DecShared& v,
                                 unsigned int& phases, int tid, int warp, int lane) {
  const int J = a.J, C = a.C;
  for (int i = tid; i < ng * J; i += DEC_THREADS) {
    const int f = i / J, j = i - f * J;
    v.z[i] = round_to<T>(tanhf(to_f32(enc[(size_t)(s0 + f) * J + j]) + v.pred[j]));
  }
  __syncthreads();
  float best[DEC_GROUP];
  int arg[DEC_GROUP];
#pragma unroll
  for (int i = 0; i < DEC_GROUP; ++i) {
    best[i] = -INFINITY;
    arg[i] = a.V;
  }
  constexpr int NV = 16 / sizeof(T);
  const uint32_t zs = dec_smem(v.z), stride = J * sizeof(T), wbase = dec_smem(wv.base);
  for (int lr0 = warp * DEC_VROWS; lr0 < wv.count; lr0 += DEC_WARPS * DEC_VROWS) {
    const int last = min(DEC_VROWS - 1, wv.count - 1 - lr0);
    const T* rows[DEC_VROWS];
    bool vec = J % NV == 0;
#pragma unroll
    for (int r = 0; r < DEC_VROWS; ++r) {
      rows[r] = wv.row(lr0 + min(r, last));
      vec = vec && dec_aligned(rows[r]);
    }
    const bool shared = lr0 + last < wv.res;  // the rows are consecutive in shared memory
    float acc[DEC_VROWS][DEC_GROUP] = {};
    if (vec) {
#pragma unroll 2
      for (int c = lane; c < J / NV; c += 32) {
        float zk[DEC_GROUP][NV];
#pragma unroll
        for (int i = 0; i < DEC_GROUP; ++i) dec_load_x<NV>(zs + (i * J + c * NV) * 4, zk[i]);
#pragma unroll
        for (int r = 0; r < DEC_VROWS; ++r) {
          float w[NV];
          if (shared)
            dec_unpack(dec_lds(wbase + (lr0 + min(r, last)) * stride + c * 16), w);
          else
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
        for (int i = 0; i < DEC_GROUP; ++i) zk[i] = v.z[i * J + k];
#pragma unroll
        for (int r = 0; r < DEC_VROWS; ++r) {
          const float w = to_f32(rows[r][k]);
#pragma unroll
          for (int i = 0; i < DEC_GROUP; ++i) acc[r][i] = fmaf(zk[i], w, acc[r][i]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < DEC_VROWS; ++r) {
      const int id = wv.n0 + lr0 + min(r, last);
      const float bias = a.bv[id];
#pragma unroll
      for (int i = 0; i < DEC_GROUP; ++i) {
        const float s = warp_sum(acc[r][i]) + bias;
        if (lr0 + r < wv.count && s > best[i]) {  // this warp's ids ascend: a tie keeps the lower index
          best[i] = s;
          arg[i] = id;
        }
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < DEC_GROUP; ++i) {
      v.wbest[warp * DEC_GROUP + i] = best[i];
      v.wbesti[warp * DEC_GROUP + i] = arg[i];
    }
  }
  __syncthreads();
  // this block's best of each frame (warps in order) into every block's slot [gpar][rank][frame]
  unsigned long long* bar = v.bars + kBarArg + gpar;
  if (tid < ng * C) {
    const int q = tid / ng, f = tid - q * ng;
    float bv = -INFINITY;
    int bi = a.V;
    for (int w = 0; w < DEC_WARPS; ++w) {
      const float x = v.wbest[w * DEC_GROUP + f];
      const int xi = v.wbesti[w * DEC_GROUP + f];
      if (x > bv || (x == bv && xi < bi)) {
        bv = x;
        bi = xi;
      }
    }
    const int slot = (gpar * C + rank) * DEC_GROUP + f;
    dec_push(dec_smem(v.argv + slot), __float_as_uint(bv), dec_smem(bar), q);
    dec_push(dec_smem(v.argi + slot), (uint32_t)bi, dec_smem(bar), q);
  }
  dec_wait(v.bars, kBarArg + gpar, 8u * C * ng, phases);
  if (tid < ng) {
    float bv = -INFINITY;
    int bi = a.V;
    for (int q = 0; q < C; ++q) {  // ranks own ascending id ranges
      const int slot = (gpar * C + q) * DEC_GROUP + tid;
      const float x = v.argv[slot];
      const int xi = v.argi[slot];
      if (x > bv || (x == bv && xi < bi)) {
        bv = x;
        bi = xi;
      }
    }
    v.ids[tid] = bi;
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(DEC_THREADS, 1) greedy_decode_kernel(const DecodeArgs a) {
  extern __shared__ __align__(16) float sm[];
  __shared__ unsigned long long bars[DEC_BARS];
  const cg::cluster_group cluster = cg::this_cluster();
  const int C = a.C, rank = (int)cluster.block_rank(), b = blockIdx.x / C;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int H = a.H, L = a.n_layers, J = a.J;
  const int nu = dec_split_count(H, C, rank), u0 = dec_split_start(H, C, rank);
  const DecVec o = dec_vec(a.E, H, a.P, J, L, C);
  int* grow = reinterpret_cast<int*>(sm + o.grow);
  for (int lr = tid; lr < 4 * nu; lr += DEC_THREADS) grow[lr] = (lr / nu) * H + u0 + lr % nu;
  // The block's view of its vectors, weight slices and layers lives in shared
  // memory: in registers or the stack it would be per thread, and the hot
  // loops would reload it from local memory.
  __shared__ DecShared v;
  __shared__ DecSlice<T> ih[DEC_MAX_LAYERS], hh[DEC_MAX_LAYERS], proj[DEC_MAX_LAYERS], wp, wv;
  __shared__ DecodeLayer layers[DEC_MAX_LAYERS];
  if (tid == 0) {
    v.xin = sm + o.xin;
    v.hr = sm + o.hr;
    v.y = sm + o.y;
    v.hbuf = sm + o.hbuf;
    v.xp = sm + o.xp;
    v.pred = sm + o.pred;
    v.z = sm + o.z;
    v.gates = sm + o.gates;
    v.cbuf = sm + o.cbuf;
    v.wbest = sm + o.wbest;
    v.wbesti = reinterpret_cast<int*>(sm + o.wbesti);
    v.argv = sm + o.argv;
    v.argi = reinterpret_cast<int*>(sm + o.argi);
    v.ids = reinterpret_cast<int*>(sm + o.ids);
    v.bars = bars;
    for (int l = 0; l < L; ++l) layers[l] = a.layers[l];
    // this block's weight slices, resident rows after the vectors
    unsigned char* next = reinterpret_cast<unsigned char*>(sm + o.total);
    auto place = [&](DecSlice<T>& s, const void* w, int m, int n0, int count, const int* rows) {
      const int K = dec_mat_k(m, a.E, H, a.P, J, L);
      s = DecSlice<T>{static_cast<const T*>(w), reinterpret_cast<const T*>(next), rows, n0, count, a.res[m], K};
      next += dec_a16((size_t)a.res[m] * K * sizeof(T));
    };
    place(wv, a.wv, 0, dec_split_start(a.V, C, rank), dec_split_count(a.V, C, rank), nullptr);
    place(wp, a.wp, 1, dec_split_start(J, C, rank), dec_split_count(J, C, rank), nullptr);
    for (int l = 0; l < L; ++l) place(hh[l], a.layers[l].w_hh, 2 + l, u0, 4 * nu, grow);
    for (int l = 0; l < L; ++l) place(ih[l], a.layers[l].w_ih, 2 + L + l, u0, 4 * nu, grow);
    for (int l = 0; l < L; ++l)
      place(proj[l], a.layers[l].w_proj, 2 + 2 * L + l, dec_split_start(a.P, C, rank), a.layers[l].w_proj ? dec_split_count(a.P, C, rank) : 0,
            nullptr);
    for (int i = 0; i < DEC_BARS; ++i) asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(dec_smem(bars + i)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  unsigned int phases = 0;
  dec_stage(wv);
  dec_stage(wp);
  for (int l = 0; l < L; ++l) {
    dec_stage(hh[l]);
    dec_stage(ih[l]);
    if (layers[l].w_proj) dec_stage(proj[l]);
  }
  for (int i = tid; i < DEC_GROUP * J; i += DEC_THREADS) v.z[i] = 0.f;
  const int hstride = dec_a4(H), cstride = dec_a4(nu);
  for (int i = tid; i < L * H; i += DEC_THREADS) {
    const int l = i / H, u = i - l * H;
    v.hbuf[l * hstride + u] = a.st0[((size_t)(2 * l + 1) * a.B + b) * H + u];
    if (u >= u0 && u < u0 + nu) v.cbuf[l * cstride + u - u0] = a.st0[((size_t)(2 * l) * a.B + b) * H + u];
  }
  cluster.sync();  // every block of the cluster has started and set up its barriers: pushes into its shared memory may begin

  int par = 0, gpar = 0;
  int prev = a.tok0[b];
  dec_pred_step<T>(a, layers, ih, hh, proj, wp, prev, par, v, phases, nu, u0, tid, warp, lane);
  par ^= 1;

  const int len = min(max(a.lens[b], 0), a.T);  // frames past T cannot emit: the outputs are those of the unclamped loop
  const T* enc = static_cast<const T*>(a.enc_p) + (size_t)b * a.T * J;
  int t = 0, idx = 0;
  for (int step = 0; step < a.step_max && t < len; ++step) {
    const int start = min(t, a.T - a.K);
    int first = a.K, tok = a.blank;
    if (idx < a.max_tokens) {
      for (int g0 = 0; g0 < a.K; g0 += DEC_GROUP) {
        const int s0 = start + g0, ng = min(DEC_GROUP, a.K - g0);
        if (s0 >= len) break;
        if (s0 + ng <= t) continue;
        dec_joint_argmax<T>(a, wv, enc, s0, ng, gpar, rank, v, phases, tid, warp, lane);
        gpar ^= 1;
        for (int i = 0; i < ng; ++i) {
          if (s0 + i >= t && s0 + i < len && v.ids[i] != a.blank) {
            first = g0 + i;
            tok = v.ids[i];
            break;
          }
        }
        if (first < a.K) break;
      }
    }
    if (first < a.K) {
      if (rank == 0 && tid == 0) a.tokens[(size_t)b * a.max_tokens + idx] = tok;
      ++idx;
      prev = tok;
      t = max(start + first, t);
      dec_pred_step<T>(a, layers, ih, hh, proj, wp, prev, par, v, phases, nu, u0, tid, warp, lane);
      par ^= 1;
    } else {
      t = max(min(start + a.K, len), t);
    }
  }
  if (rank == 0 && tid == 0) {
    a.out_len[b] = idx;
    a.next_tok[b] = prev;
  }
  // the carry-out: the states from before the last step (parity par ^ 1), this block's units
  for (int i = tid; i < L * nu; i += DEC_THREADS) {
    const int l = i / nu, uu = i - l * nu;
    a.st_out[((size_t)(2 * l) * a.B + b) * H + u0 + uu] = v.cbuf[((par ^ 1) * L + l) * cstride + uu];
    a.st_out[((size_t)(2 * l + 1) * a.B + b) * H + u0 + uu] = v.hbuf[((par ^ 1) * L + l) * hstride + u0 + uu];
  }
  cluster.sync();  // no block leaves while another may still address its shared memory
}

typedef void (*DecodeKernel)(const DecodeArgs);

static DecodeKernel decode_kernel_for(int dtype) {
  return dtype == kBF16 ? greedy_decode_kernel<__nv_bfloat16> : greedy_decode_kernel<float>;
}

// Launch configuration of B clusters of C blocks; sets the kernel's attributes.
static cudaError_t decode_config(DecodeKernel kernel, int B, int C, size_t smem, cudaStream_t stream, cudaLaunchConfig_t& cfg,
                                 cudaLaunchAttribute& attr) {
  if (C < 1 || C > DEC_MAX_CLUSTER) return cudaErrorInvalidClusterSize;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) != cudaSuccess) return err;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(B * C);
  cfg.blockDim = dim3(DEC_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

}  // namespace tfasr

// Dynamic shared memory (bytes) of one block for these widths, cluster size
// and resident rows (res: one count per matrix, 2 + 3 * n_layers of them).
extern "C" long long tfasr_decode_smem_bytes(int E, int H, int P, int J, int n_layers, int C, const int* res, int dtype) {
  return (long long)tfasr::dec_smem_bytes(E, H, P, J, n_layers, C, res, dtype == tfasr::kBF16 ? 2 : 4);
}

// How many clusters of C blocks with smem bytes each can be resident at
// once (cudaOccupancyMaxActiveClusters), or minus the CUDA error code when
// such a cluster cannot launch at all.
extern "C" int tfasr_decode_clusters(int C, long long smem, int dtype) {
  using namespace tfasr;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const DecodeKernel kernel = decode_kernel_for(dtype);
  cudaError_t err = decode_config(kernel, 1, C, (size_t)smem, nullptr, cfg, attr);
  int n = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&n, (const void*)kernel, &cfg);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear the (non-sticky) error of the refused configuration
    return -(int)err;
  }
  return n;
}

extern "C" int tfasr_greedy_decode(const void* enc_p, const int* lens, const int* tok0, const void* embed, int n_layers,
                                   const void* const* w_ih, const void* const* w_hh, const void* const* b, const void* const* ln,
                                   const void* const* w_proj, const void* const* b_proj, const void* wp, const float* bp, const void* wv,
                                   const float* bv, const float* st0, int* tokens, int* out_len, int* next_tok, float* st_out, int B, int T,
                                   int E, int H, int P, int J, int V, int K, int max_tokens, int step_max, int blank, float eps, int C,
                                   const int* res, int dtype, cudaStream_t stream) {
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
  a.C = C;
  for (int m = 0; m < 2 + 3 * n_layers; ++m) a.res[m] = res[m];
  if (B == 0) return 0;
  const DecodeKernel kernel = decode_kernel_for(dtype);
  const size_t smem = dec_smem_bytes(E, H, P, J, n_layers, C, a.res, dtype == kBF16 ? 2 : 4);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = decode_config(kernel, B, C, smem, stream, cfg, attr);
  if (err == cudaSuccess) err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
