// Pieces shared by K1 (rel_attention.cu) and K1b (rel_attention_bwd.cu):
// float32-accurate tensor-core products (3xTF32 on mma.sync m16n8k8), the
// cp.async copies that feed them (K3b, las_scan.cu, uses these too), and
// the rel-PE bias of one score.
//
// 3xTF32: a float32 x is split into x_hi = tf32(x) and x_lo = tf32(x -
// x_hi), each rounded to nearest (cvt.rna). x_hi carries 11 significant
// bits and x_lo the next 11, so a_hi b_hi + a_hi b_lo + a_lo b_hi, summed
// in float32 by the tensor cores, keeps about 22 bits of each product
// (a_lo b_lo, below 2^-22 of it, is dropped). One TF32 product alone
// keeps 11 bits, about three digits.
//
// The operand a block streams through (the B side of its products) is
// split once, by split_pairs, into (hi, lo) pairs in device memory, so the
// kernels load a B fragment's two halves with one 8-byte shared load and
// spend no instruction on splitting it; the A side (held per warp, or
// P from the scores) is split in registers.
//
// Fragments of mma.m16n8k8 (row.col, tf32), lane = 4 g + t:
//   A [16 x 8]: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B [8 x 8]:  b0 (k = t, n = g), b1 (k = t + 4, n = g)
//   C [16 x 8]: c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// A product P V, with P a C fragment of the scores, takes P as its A
// fragment without a shuffle by numbering the reduction index so that
// k = t is column 2t and k = t + 4 is column 2t + 1: a = (c0, c2, c1, c3),
// and B's rows follow the same order (b0 from row 2t, b1 from row 2t + 1).
#pragma once

#include <cuda_runtime.h>
#include <cfloat>
#include <cstdint>

namespace nsp_rel {

constexpr int kRows = 64;   // queries (K1, K1b dq) or keys (K1b dkdv) per block
constexpr int kStep = 32;   // keys (or queries) per streamed tile
constexpr int kWarps = 4;   // 16 of the block's rows per warp
constexpr int kThreads = 32 * kWarps;
constexpr int kGroup = 4;   // n-tiles whose products are interleaved
constexpr float kNeg = -FLT_MAX / 2.0f;  // a masked key's score

// Shared-memory tiles keep rows DK + 4 elements apart (floats for a raw
// tile, (hi, lo) pairs for a split one): 16-byte aligned for cp.async, and
// the fragment reads along a row (bank 4g + t) are free of conflicts; the
// reads down a split tile's column meet two-way conflicts.
template <int DK>
struct Tile {
  static constexpr int kStride = DK + 4;
  static constexpr int kRaw = kRows * kStride;       // floats of a raw tile
  static constexpr int kPairs = kStep * kStride;     // pairs of a split tile
};

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// An A fragment, split into its two TF32 halves.
struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(float a0, float a1, float a2, float a3) {
    split(a0, hi[0], lo[0]);
    split(a1, hi[1], lo[1]);
    split(a2, hi[2], lo[2]);
    split(a3, hi[3], lo[3]);
  }
};

// B fragments of up to kGroup neighbouring n-tiles, from split pairs.
struct FragsB {
  uint32_t hi[kGroup][2], lo[kGroup][2];
  __device__ __forceinline__ void set(int n, float2 b0, float2 b1) {
    hi[n][0] = __float_as_uint(b0.x);
    lo[n][0] = __float_as_uint(b0.y);
    hi[n][1] = __float_as_uint(b1.x);
    lo[n][1] = __float_as_uint(b1.y);
  }
};

// d[n] += a b[n] at float32 accuracy for N n-tiles: the two small cross
// terms first, each pass over the group, so that N independent products
// stand between two that add into the same accumulator.
template <int N>
__device__ __forceinline__ void mma3(float (*d)[4], const FragA& a, const FragsB& b) {
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(d[n], a.lo, b.hi[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(d[n], a.hi, b.lo[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(d[n], a.hi, b.hi[n]);
}

// The A fragment of rows r0 .. r0 + 15, columns k0 .. k0 + 7 of a raw tile.
template <int DK>
__device__ __forceinline__ FragA load_a(const float* tile, int r0, int k0, int g, int t) {
  constexpr int S = Tile<DK>::kStride;
  const float* x = tile + (r0 + g) * S + k0 + t;
  FragA a;
  a.set(x[0], x[8 * S], x[4], x[8 * S + 4]);
  return a;
}

// The tensor cores add into their float32 accumulator with truncation, so
// a long chain of products into one accumulator drifts toward zero: K1b
// chained over all keys came out an order of magnitude less accurate than
// float32 FMAs on the H100, too far for the training step's gradients.
// So the products below start from zero, per 8-column step in product_nt
// and per tile (and group of n-tiles) in product_pn, and join the running
// sum by a rounded float32 add.
template <int N>
__device__ __forceinline__ void add_to(float (*acc)[4], const float (*part)[4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
}

// s[16 x 32] += A . pairs^T over DK columns: A from a_of(kk) (columns
// 8 kk .. 8 kk + 7), the kStep rows of the split tile are the columns of s.
template <int DK, class AOf>
__device__ __forceinline__ void product_nt(float (&s)[kStep / 8][4], AOf a_of,
                                           const float2* pairs, int g, int t) {
  constexpr int S = Tile<DK>::kStride;
#pragma unroll
  for (int kk = 0; kk < DK / 8; ++kk) {
    const FragA a = a_of(kk);
    FragsB b;
#pragma unroll
    for (int n = 0; n < kStep / 8; ++n) {
      const float2* x = pairs + (n * 8 + g) * S + kk * 8 + t;
      b.set(n, x[0], x[4]);
    }
    float part[kStep / 8][4] = {};
    mma3<kStep / 8>(part, a, b);
    add_to<kStep / 8>(s, part);
  }
}

// acc[16 x DK] += P[16 x 32] . pairs[32 x DK]: P in C fragments (s), the
// kStep rows of the split tile the reduction (read down its columns, rows
// 2t and 2t + 1). A group of N n-tiles at a time, so that only one group's
// fresh sum is live (P's A fragments are split again for each group).
template <int DK>
__device__ __forceinline__ void product_pn(float (&acc)[DK / 8][4], const float (&s)[kStep / 8][4],
                                           const float2* pairs, int g, int t) {
  constexpr int S = Tile<DK>::kStride;
  constexpr int N = DK / 8 < kGroup ? DK / 8 : kGroup;
#pragma unroll
  for (int n0 = 0; n0 < DK / 8; n0 += N) {
    float part[N][4] = {};
#pragma unroll
    for (int kk = 0; kk < kStep / 8; ++kk) {
      FragA a;
      a.set(s[kk][0], s[kk][2], s[kk][1], s[kk][3]);
      FragsB b;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const float2* x = pairs + (kk * 8 + 2 * t) * S + (n0 + n) * 8 + g;
        b.set(n, x[0], x[S]);
      }
      mma3<N>(part, a, b);
    }
    add_to<N>(acc + n0, part);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = pred ? 16 : 0;  // 0: fill with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Starts the copy of rows r0 .. r0 + ROWS - 1 of a [T, W] matrix of 4-byte
// words into a tile whose rows are STRIDE words apart; rows past T are
// zero-filled.
template <int ROWS, int W, int STRIDE>
__device__ __forceinline__ void load_async(void* tile, const void* src, int r0, int T) {
  constexpr int kChunks = W / 4;  // 16-byte chunks per row
  float* dst = static_cast<float*>(tile);
  const float* from = static_cast<const float*>(src);
  for (int c = threadIdx.x; c < ROWS * kChunks; c += kThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 4, i = r0 + r;
    const bool in = i < T;
    cp_async16(dst + r * STRIDE + col, from + (size_t)(in ? i : 0) * W + col, in);
  }
}

// A block's raw [kRows, DK] tile and a streamed split [kStep, DK] tile.
template <int DK>
__device__ __forceinline__ void load_raw_async(float* tile, const float* src, int r0, int T) {
  load_async<kRows, DK, Tile<DK>::kStride>(tile, src, r0, T);
}
template <int DK>
__device__ __forceinline__ void load_pairs_async(float2* tile, const float2* src, int r0, int T) {
  load_async<kStep, 2 * DK, 2 * Tile<DK>::kStride>(tile, src, r0, T);
}

// The rel-PE bias of query i and key j from the query's row of p (in
// shared or device memory).
__device__ __forceinline__ float rel_bias(const float* p_row, int i, int j, int R) {
  return p_row[min(abs(i - j), R - 1)];
}

// A block copies the rows of the rel-PE table p it looks biases up in
// into shared memory when R <= kSmemR (the clamped tables, R = clamp + 1);
// a longer table is read through L1.
constexpr int kSmemR = 16;

// Rows r0 .. r0 + ROWS - 1 of p ([T, R], zeros past T) into dst [ROWS][R]
// when R <= kSmemR. Returns where row r0 of the table to read lies.
template <int ROWS>
__device__ __forceinline__ const float* stage_p_rows(float* dst, const float* pb, int r0, int T,
                                                     int R) {
  if (R > kSmemR) return pb + (size_t)r0 * R;
  for (int idx = threadIdx.x; idx < ROWS * R; idx += kThreads)
    dst[idx] = r0 + idx / R < T ? pb[(size_t)r0 * R + idx] : 0.0f;
  return dst;
}

// Least |i - j| over queries i0 .. i0 + ni - 1 and keys j0 .. j0 + nj - 1:
// at least R - 1 means every pair of the two ranges takes the far bucket.
__device__ __forceinline__ int min_distance(int i0, int ni, int j0, int nj) {
  return max(0, max(j0 - (i0 + ni - 1), i0 - (j0 + nj - 1)));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// pairs[i] = (tf32(x[i]), tf32(x[i] - tf32(x[i]))) and pairs[n + i] the
// same of y[i], for n floats each, n % 4 == 0. Static: each source that
// includes this has its own copy.
static __global__ void __launch_bounds__(256)
split_pairs_kernel(const float4* __restrict__ x, const float4* __restrict__ y,
                   float4* __restrict__ pairs, size_t n4) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < 2 * n4;
       i += (size_t)gridDim.x * blockDim.x) {
    const float4 v = i < n4 ? x[i] : y[i - n4];
    uint32_t h[4], l[4];
    split(v.x, h[0], l[0]);
    split(v.y, h[1], l[1]);
    split(v.z, h[2], l[2]);
    split(v.w, h[3], l[3]);
    pairs[2 * i] = make_float4(__uint_as_float(h[0]), __uint_as_float(l[0]),
                               __uint_as_float(h[1]), __uint_as_float(l[1]));
    pairs[2 * i + 1] = make_float4(__uint_as_float(h[2]), __uint_as_float(l[2]),
                                   __uint_as_float(h[3]), __uint_as_float(l[3]));
  }
}

// Splits x and y (n floats each) into pairs[0 .. n) and pairs[n .. 2n), in
// one launch.
static cudaError_t split_pairs(const float* x, const float* y, float2* pairs, size_t n,
                               cudaStream_t s) {
  const size_t n4 = n / 4;
  const int blocks = (int)(2 * n4 < 132 * 16 * 256 ? (2 * n4 + 255) / 256 : 132 * 16);
  split_pairs_kernel<<<blocks, 256, 0, s>>>(reinterpret_cast<const float4*>(x),
                                            reinterpret_cast<const float4*>(y),
                                            reinterpret_cast<float4*>(pairs), n4);
  return cudaGetLastError();
}

// Lets Kernel take `bytes` of dynamic shared memory; the attribute is set
// once per kernel (per process), not per launch.
template <auto Kernel>
cudaError_t allow_smem(int bytes) {
  static const cudaError_t err =
      cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  return err;
}

}  // namespace nsp_rel
