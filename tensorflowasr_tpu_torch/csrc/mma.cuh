// Tensor-core building blocks shared by the bf16 kernels (attention_mma.cu,
// rel_attention_mma.cu, ff_mma.cu, conv_mma.cu, joint_loss_mma.cu): ldmatrix loads from shared memory,
// mma.sync m16n8k16 with bf16 operands and f32 accumulators, cp.async
// staging and quad reductions over the four threads that share a fragment
// row.
//
// Fragment layout of mma.sync m16n8k16 (lane = 4 * g + tig): the C
// fragment's element e of an n-tile is row g + 8 * (e >> 1), column
// 2 * tig + (e & 1).
#pragma once

#include "common.cuh"

namespace tfasr {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a (16x16 bf16, row) . b (16x8 bf16, col), f32 accumulators.
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Sum over the eight fragment rows g of a warp (lanes with the same tig), in
// a fixed butterfly order: every lane ends with the column's sum.
__device__ __forceinline__ float col_sum8(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

// The C fragments of 2 * KS n-tiles (16 rows x 16 * KS columns) as bf16 A fragments.
template <int KS>
__device__ __forceinline__ void frag_to_a(uint32_t (&pa)[KS][4], const float (&p)[2 * KS][4]) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    pa[ks][0] = pack_bf16(p[2 * ks][0], p[2 * ks][1]);
    pa[ks][1] = pack_bf16(p[2 * ks][2], p[2 * ks][3]);
    pa[ks][2] = pack_bf16(p[2 * ks + 1][0], p[2 * ks + 1][1]);
    pa[ks][3] = pack_bf16(p[2 * ks + 1][2], p[2 * ks + 1][3]);
  }
}

// A fragment (16 rows x 16 k) of a row-major bf16 tile at a (rows along the
// fragment's rows, k contiguous; leading dimension ld).
__device__ __forceinline__ void load_a(uint32_t (&af)[4], const bf16* a, int ld, int lane) {
  ldsm_x4(af, smem_u32(a + (lane & 15) * ld + (lane >> 4) * 8));
}

// A fragment of the transpose of a tile stored [k][rows] (ld): rows m0.. of
// the fragment are columns of the storage.
__device__ __forceinline__ void load_a_t(uint32_t (&af)[4], const bf16* s, int ld, int lane) {
  ldsm_x4_t(af, smem_u32(s + ((lane & 7) + ((lane >> 4) << 3)) * ld + ((lane >> 3) & 1) * 8));
}

// B fragments of two n-tiles (16 n x 16 k) from a tile stored [n][k] (ld):
// b[0], b[1] for n 0..7 and b[2], b[3] for n 8..15.
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4], const bf16* s, int ld, int lane) {
  ldsm_x4(b, smem_u32(s + ((lane & 7) + ((lane >> 4) << 3)) * ld + ((lane >> 3) & 1) * 8));
}

// B fragments of two n-tiles (16 k x 16 n) from a tile stored [k][n] (ld).
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4], const bf16* s, int ld, int lane) {
  ldsm_x4_t(b, smem_u32(s + (lane & 15) * ld + (lane >> 4) * 8));
}

constexpr int AM_PAD = 8;  // bf16 of row padding in shared memory: 8 ldmatrix rows hit distinct banks

// Stage rows [r0, r0 + rows) of x ([n, D] bf16; rows past n and columns D..Dp
// zero) into dst [rows][Dp + AM_PAD], Dp a multiple of 16: 16-byte cp.async, or element copies
// where the rows are not 16-byte aligned. Issued by the whole block.
__device__ __forceinline__ void am_stage(bf16* dst, const bf16* x, int r0, int n, int rows, int D, int Dp, int vec) {
  const int LD = Dp + AM_PAD;
  if (vec) {
    const int cpr = Dp / 8;
    for (int i = threadIdx.x; i < rows * cpr; i += blockDim.x) {
      const int r = i / cpr, c = (i - r * cpr) * 8;
      const bool ok = r0 + r < n && c < D;
      cp_async16(smem_u32(dst + r * LD + c), ok ? x + (size_t)(r0 + r) * D + c : x, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < rows * Dp; i += blockDim.x) {
      const int r = i / Dp, c = i - r * Dp;
      dst[r * LD + c] = (r0 + r < n && c < D) ? x[(size_t)(r0 + r) * D + c] : __float2bfloat16(0.f);
    }
  }
}

// acc[nt] = A (this warp's 16 rows at a_s) . B^T (NT * 8 rows at b_s), both
// [rows][Dp] bf16 in shared memory, over the Dp columns.
template <int DMAX, int NT>
__device__ __forceinline__ void am_abT(float (&acc)[NT][4], const bf16* a_s, const bf16* b_s, int LD, int nk, int lane) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DMAX / 16; ++kk) {
    if (kk < nk) {
      uint32_t af[4];
      ldsm_x4(af, smem_u32(a_s + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8));
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bf[4];
        ldsm_x4(bf, smem_u32(b_s + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 + ((lane >> 3) & 1) * 8));
        mma16816(acc[2 * np], af, bf[0], bf[1]);
        mma16816(acc[2 * np + 1], af, bf[2], bf[3]);
      }
    }
  }
}

// acc[dt] += P (16 rows x 16 * KS, bf16 A fragments) . X (rows = the summed
// index at x_s, [16 * KS][Dp] bf16 in shared memory), over Dp output columns.
template <int DMAX, int KS>
__device__ __forceinline__ void am_pv(float (&acc)[DMAX / 8][4], const uint32_t (&pa)[KS][4], const bf16* x_s, int LD, int nk, int lane) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
    for (int dp = 0; dp < DMAX / 16; ++dp) {
      if (dp < nk) {
        uint32_t bf[4];
        ldsm_x4_t(bf, smem_u32(x_s + (ks * 16 + (lane & 15)) * LD + dp * 16 + (lane >> 4) * 8));
        mma16816(acc[2 * dp], pa[ks], bf[0], bf[1]);
        mma16816(acc[2 * dp + 1], pa[ks], bf[2], bf[3]);
      }
    }
  }
}

template <typename A>
__device__ __forceinline__ void am_stage(bf16* dst, const bf16* x, int r0, int n, int rows, const A& a) {
  am_stage(dst, x, r0, n, rows, a.D, a.Dp, a.vec);
}

// exp(s - m) as 2^((s - m) log2 e) on the SFU: a few ulp from expf, far
// inside the bf16 rounding that follows. s - m is formed first, so rows at
// the -1e9 mask (s and m both ~-1e9) keep their small difference exactly.
__device__ __forceinline__ float am_exp(float s, float m) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"((s - m) * 1.4426950408889634f));
  return y;
}

// Write a [16 rows][Dp] f32 fragment set as bf16 rows of [n, D] at row_lo / row_lo + 8.
template <int DMAX>
__device__ __forceinline__ void am_store(bf16* dst, const float (&acc)[DMAX / 8][4], int row_lo, int n, int D, int col0) {
#pragma unroll
  for (int dt = 0; dt < DMAX / 8; ++dt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row_lo + (e >> 1) * 8, col = col0 + dt * 8 + (e & 1);
      if (row < n && col < D) dst[(size_t)row * D + col] = __float2bfloat16(acc[dt][e]);
    }
  }
}

// An f32 operand of a weight-gradient product as bf16 hi + lo ([N][ld]
// each, ld a multiple of 8): x = hi + lo to ~2^-18 relative.
struct Split {
  bf16* hi;
  bf16* lo;
  int ld;
};

__device__ __forceinline__ void put_split(const Split& s, int row, int col, float v) {
  const bf16 h = __float2bfloat16(v);
  const size_t off = (size_t)row * s.ld + col;
  s.hi[off] = h;
  s.lo[off] = __float2bfloat16(v - __bfloat162float(h));
}

// Two adjacent columns (col even) in one 4-byte store each.
__device__ __forceinline__ void put_split2(const Split& s, int row, int col, float v0, float v1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const size_t off = (size_t)row * s.ld + col;
  *reinterpret_cast<__nv_bfloat162*>(s.hi + off) = h;
  *reinterpret_cast<__nv_bfloat162*>(s.lo + off) = __floats2bfloat162_rn(v0 - __low2float(h), v1 - __high2float(h));
}

// out[M, K] = A^T B over N rows, A and B given as Split: hi.hi + hi.lo +
// lo.hi on the tensor cores, f32 accumulation, in a fixed row split summed
// in order (ff_mma.cu's ff_mma_atb and sum_partials_kernel): the same bits
// on every run. partial holds split_atb_partial_floats(N, M, K) floats.
int launch_split_atb(Split A, Split B, float* out, float* partial, int N, int M, int K, cudaStream_t stream);
long long split_atb_partial_floats(int N, int M, int K);

}  // namespace tfasr
