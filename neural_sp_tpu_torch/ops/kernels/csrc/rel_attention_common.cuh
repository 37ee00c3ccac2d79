// Pieces shared by K1 (rel_attention.cu) and K1b (rel_attention_bwd.cu):
// float32-accurate tensor-core products (3xTF32 on mma.sync m16n8k8), the
// cp.async copies that feed them (K3b, las_scan.cu, uses these too), and
// the rel-PE bias of one score; at the end of the file, the bf16 products
// (mma.sync m16n8k16, float32 accumulation) of the bf16 entries.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cfloat>
#include <climits>
#include <cstdint>

namespace nsp_rel {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

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
// shared or device memory; float32 or bf16), in float32.
template <class E>
__device__ __forceinline__ float rel_bias(const E* p_row, int i, int j, int R) {
  return to_float(p_row[min(abs(i - j), R - 1)]);
}

// A block copies the rows of the rel-PE table p it looks biases up in
// into shared memory when R <= kSmemR (the clamped tables, R = clamp + 1);
// a longer table is read through L1.
constexpr int kSmemR = 16;

// Rows r0 .. r0 + ROWS - 1 of p ([T, R], zeros past T; float32 or bf16)
// into dst [ROWS][R] when R <= kSmemR. Returns where row r0 of the table to
// read lies.
template <int ROWS, class E>
__device__ __forceinline__ const E* stage_p_rows(E* dst, const E* pb, int r0, int T, int R) {
  if (R > kSmemR) return pb + (size_t)r0 * R;
  for (int idx = threadIdx.x; idx < ROWS * R; idx += kThreads)
    dst[idx] = r0 + idx / R < T ? pb[(size_t)r0 * R + idx] : E{};
  return dst;
}

// ---- the keys a query may attend -----------------------------------------
//
// Query i (of Tq) sits at position i + qoff among the Tk keys (qoff = Tk -
// Tq: a streaming block against cached keys; 0 offline). It may attend key
// j iff kstart <= j < min(klens[b], Tk) and, with a window (nc > 0; the
// chunk of position a = i + qoff is c = a / nc), j < (c + 1) nc + nr and,
// when nl >= 0, j >= c nc - nl: make_chunkwise_san_mask, and with nc = 1,
// nr = 0, nl = -1 causal_mask. Every other key scores finfo.min / 2, like
// apply_mask_logits, so a row that may attend no key gets uniform weights
// over all Tk keys. All four entries (K1, K1b; float32, bf16) decide
// through key_range.
struct Window {
  int nc;      // chunk (0: no window)
  int nl;      // left context (-1: unlimited)
  int nr;      // right context
  int qoff;    // query i sits at key position i + qoff
  int kstart;  // keys below are masked
};

// [lo, hi): the keys query row i may attend (none when hi <= lo).
__device__ __forceinline__ void key_range(const Window& w, int i, int klen, int Tk, int& lo,
                                          int& hi) {
  lo = w.kstart;
  hi = min(klen, Tk);
  if (w.nc > 0) {
    const int c = (i + w.qoff) / w.nc;
    hi = min(hi, (c + 1) * w.nc + w.nr);
    if (w.nl >= 0) lo = max(lo, c * w.nc - w.nl);
  }
}

__device__ __forceinline__ int warp_min(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = min(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ int warp_max(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = max(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// A thread's two rows' key ranges (rows past Tq take [0, Tk): their results
// are never stored), and the keys [wlo, whi) that every row of its warp
// below Tq may attend.
struct RowKeys {
  int lo[2], hi[2], wlo, whi;
  __device__ __forceinline__ RowKeys(const Window& w, const int (&rows)[2], int klen, int Tq,
                                     int Tk) {
    int a = 0, b = Tk;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      lo[e] = 0;
      hi[e] = Tk;
      if (rows[e] < Tq) {
        key_range(w, rows[e], klen, Tk, lo[e], hi[e]);
        a = max(a, lo[e]);
        b = min(b, hi[e]);
      }
    }
    wlo = warp_max(a);
    whi = warp_min(b);
  }
  __device__ __forceinline__ bool allowed(int e, int j) const { return j >= lo[e] && j < hi[e]; }
};

// Without a window (the offline encoders) a row's keys are the padding's
// alone, j < min(klens[b], Tk), the same for every row: the kernels take
// this instead of RowKeys (a template choice), so their offline code is
// the klen test it was before windows came.
struct PadKeys {
  int wlo, whi;
  __device__ __forceinline__ PadKeys(int klen, int Tk) : wlo(0), whi(min(klen, Tk)) {}
  __device__ __forceinline__ bool allowed(int, int j) const { return j < whi; }
};

// The keys [kbeg, kend) that some row of the block (each thread's two rows
// below Tq, in rk) may attend, and whether a row may attend none. Every
// thread calls it; red is kWarps * 3 ints of shared memory, read only
// after the barrier inside.
__device__ __forceinline__ void block_keys(const RowKeys& rk, const int (&rows)[2], int Tq,
                                           int* red, int& kbeg, int& kend, bool& any_empty) {
  int b = INT_MAX, e = 0, em = 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= Tq) continue;
    if (rk.lo[r] < rk.hi[r]) {
      b = min(b, rk.lo[r]);
      e = max(e, rk.hi[r]);
    } else {
      em = 1;
    }
  }
  b = warp_min(b);
  e = warp_max(e);
  em = warp_max(em);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red[warp] = b;
    red[kWarps + warp] = e;
    red[2 * kWarps + warp] = em;
  }
  __syncthreads();
  b = INT_MAX;
  e = 0;
  em = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    b = min(b, red[w]);
    e = max(e, red[kWarps + w]);
    em = max(em, red[2 * kWarps + w]);
  }
  kbeg = b == INT_MAX ? 0 : b;
  kend = b == INT_MAX ? 0 : e;
  any_empty = em != 0;
}

// A row's keys: RowKeys with a window (or cached keys), PadKeys without.
template <bool WIN>
__device__ __forceinline__ auto row_keys(const Window& w, const int (&rows)[2], int klen, int Tq,
                                         int Tk) {
  if constexpr (WIN) {
    return RowKeys(w, rows, klen, Tq, Tk);
  } else {
    return PadKeys(klen, Tk);
  }
}

// The key tiles of STEP keys a block visits, n_tiles of them from key kt0:
// those some row of the block may attend (without a window, the keys below
// min(klens[b], Tk)); a row that may attend none makes the forward
// (``all_if_empty``) visit every key, its weights being uniform over all
// Tk, and adds nothing to the backward's dq pass (ds = 0 there).
template <bool WIN, int STEP, bool all_if_empty, class K>
__device__ __forceinline__ void key_tiles(const K& rk, const int (&rows)[2], int Tq, int Tk,
                                          int& kt0, int& n_tiles) {
  int kbeg = 0, kend;
  if constexpr (WIN) {
    __shared__ int red[3 * kWarps];
    bool any_empty;
    block_keys(rk, rows, Tq, red, kbeg, kend, any_empty);
    if (all_if_empty && any_empty) kbeg = 0, kend = Tk;
  } else {
    kend = rk.whi > 0 ? rk.whi : (all_if_empty ? Tk : 0);
  }
  kt0 = kbeg / STEP * STEP;
  n_tiles = kend > kbeg ? (kend - kt0 + STEP - 1) / STEP : 0;
}

// The query rows [ibeg, iend) of 0 .. Tq - 1 whose weights reach keys j0
// .. j0 + nj - 1 (of Tk) under a window: those whose range meets them, and
// those with an empty range (uniform over every key). The block's threads
// share the rows; red as in block_keys. iend <= ibeg: none.
__device__ __forceinline__ void query_span(const Window& w, int j0, int nj, int klen, int Tq,
                                           int Tk, int* red, int& ibeg, int& iend) {
  int b = INT_MAX, e = 0;
  for (int i = threadIdx.x; i < Tq; i += kThreads) {
    int lo, hi;
    key_range(w, i, klen, Tk, lo, hi);
    if (lo >= hi || (lo < j0 + nj && hi > j0)) {
      b = min(b, i);
      e = max(e, i + 1);
    }
  }
  b = warp_min(b);
  e = warp_max(e);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red[warp] = b;
    red[kWarps + warp] = e;
  }
  __syncthreads();
  b = INT_MAX;
  e = 0;
#pragma unroll
  for (int v = 0; v < kWarps; ++v) {
    b = min(b, red[v]);
    e = max(e, red[kWarps + v]);
  }
  ibeg = b == INT_MAX ? 0 : b;
  iend = b == INT_MAX ? 0 : e;
}

// The query tiles of STEP rows the backward's key-major pass visits for
// keys j0 .. j0 + kRows - 1, n_tiles of them from tile it0: without a
// window (Tq = Tk = T) every tile while j0 lies below the keys' end
// (min(klens[b], T), or all T when klens[b] is 0: uniform P), none past
// it; with one (or fewer queries than keys), query_span's.
template <bool WIN, int STEP>
__device__ __forceinline__ void query_tiles(const Window& win, int j0, int klen, int Tq, int Tk,
                                            int& it0, int& n_tiles) {
  it0 = 0;
  if constexpr (WIN) {
    __shared__ int red[3 * kWarps];
    int ibeg, iend;
    query_span(win, j0, kRows, klen, Tq, Tk, red, ibeg, iend);
    it0 = ibeg / STEP;
    n_tiles = iend > ibeg ? (iend + STEP - 1) / STEP - it0 : 0;
  } else {
    const int kend = (klen > 0) ? min(klen, Tk) : Tk;
    n_tiles = j0 < kend ? (Tq + STEP - 1) / STEP : 0;
  }
}

// Least |i - j| over queries i0 .. i0 + ni - 1 and keys j0 .. j0 + nj - 1:
// at least R - 1 means every pair of the two ranges takes the far bucket.
__device__ __forceinline__ int min_distance(int i0, int ni, int j0, int nj) {
  return max(0, max(j0 - (i0 + ni - 1), i0 - (j0 + nj - 1)));
}

// ---- dropout of the attention probabilities ------------------------------
//
// The JAX module's Dropout on its attention weights (neural_sp_tpu/ops/
// dropout.py::fast_uniform): element (b, h, i, j) of the [B, H, Tq, Tk]
// weights is kept iff the counter hash of its row-major index ((b H + h)
// Tq + i) Tk + j (uint32, as JAX's iota) under the two key words lies
// below keep = 1 - rate (a float32, as JAX compares); a kept weight is
// scaled by 1 / keep. No mask is stored: each kernel hashes an element
// where it uses it, so forward and backward draw the same mask.
struct Drop {
  uint32_t k0, k1;
  float keep;   // 1 - rate, in (0, 1)
  float scale;  // 1 / keep
};

// The factor of element idx: scale when kept, 0 when dropped.
__device__ __forceinline__ float drop_scale(const Drop& d, uint32_t idx) {
  uint32_t x = idx * 0x9E3779B9u + d.k0;
  x ^= x >> 16;
  x *= 0x7FEB352Du ^ d.k1;
  x ^= x >> 15;
  // a 24-bit mantissa: the float is exact, as fast_uniform's
  return static_cast<float>(x >> 8) * (1.0f / 16777216.0f) < d.keep ? d.scale : 0.0f;
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

// ---- bf16 entries ---------------------------------------------------------
//
// One mma.sync.m16n8k16 (bf16 operands, row.col, float32 accumulation) per
// 16-deep slice, where the float32 entries issue three m16n8k8 per 8-deep
// slice. Its fragments, lane = 4 g + t, each 32-bit register a pair of
// bf16 (the lower index in the low half):
//   A [16 x 16]: a0 (g, 2t..2t+1), a1 (g + 8, 2t..), a2 (g, 2t+8..), a3 (g + 8, 2t+8..)
//   B [16 x 8]:  b0 (k = 2t..2t+1, n = g), b1 (k = 2t+8..2t+9, n = g)
//   C [16 x 8]:  as m16n8k8's (c0, c1 row g; c2, c3 row g + 8; columns 2t, 2t + 1)
// So the C fragments of two neighbouring n-tiles of scores, rounded to bf16
// and paired, are the A fragment of a product over those 16 keys: P feeds
// P v from registers. The B side of a product along a tile's rows (q k^T:
// k's rows are the n columns) is two 32-bit shared loads; the B side of a
// product down a tile's columns (P v: v's rows are the reduction) comes
// from ldmatrix.trans. The tensor cores' truncating accumulator is no
// concern at bf16's 8 significant bits: a score chains DK / 16 <= 4
// products, a row of P v one per 16 keys.

constexpr int kStepB = 64;  // keys (or queries) per streamed bf16 tile

// bf16 tiles keep rows DK + 8 elements (DK / 2 + 4 words) apart: 16-byte
// aligned for cp.async and ldmatrix, and both the fragment loads along a
// row (bank (DK / 2 + 4) g + t) and ldmatrix's eight row addresses are
// free of bank conflicts for DK = 16, 32, 64.
template <int DK>
struct TileB {
  static constexpr int kWords = DK / 2 + 4;
};

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rounded to nearest bf16 and widened back to float32
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// (lo, hi) rounded to nearest bf16, as one register
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Four 8 x 8 bf16 matrices, transposed: lane 8 i + r gives the address of
// row r of matrix i; register i receives (row 2t, col g) and (row 2t + 1,
// col g) of matrix i.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem_row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem_row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// The A fragments of a warp's 16 rows w0 .. w0 + 15 of a [T, DK] bf16
// matrix (rows past T zero), from device memory, for all DK / 16 slices.
template <int DK>
__device__ __forceinline__ void load_a_rows(uint32_t (&a)[DK / 16][4], const bf16* x, int w0,
                                            int T, int g, int t) {
  const uint32_t* r0 =
      w0 + g < T ? reinterpret_cast<const uint32_t*>(x + (size_t)(w0 + g) * DK) : nullptr;
  const uint32_t* r1 =
      w0 + g + 8 < T ? reinterpret_cast<const uint32_t*>(x + (size_t)(w0 + g + 8) * DK) : nullptr;
#pragma unroll
  for (int kk = 0; kk < DK / 16; ++kk) {
    a[kk][0] = r0 ? r0[8 * kk + t] : 0u;
    a[kk][1] = r1 ? r1[8 * kk + t] : 0u;
    a[kk][2] = r0 ? r0[8 * kk + 4 + t] : 0u;
    a[kk][3] = r1 ? r1[8 * kk + 4 + t] : 0u;
  }
}

// s[16 x 8 N] += A . rows^T over DK columns: A the warp's 16 rows as A
// fragments (registers), the 8 N rows of a bf16 tile (TileB layout) its n
// columns.
template <int DK, int N>
__device__ __forceinline__ void product_nt_bf16(float (&s)[N][4], const uint32_t (&a)[DK / 16][4],
                                                const uint32_t* rows, int g, int t) {
  constexpr int W = TileB<DK>::kWords;
#pragma unroll
  for (int kk = 0; kk < DK / 16; ++kk)
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const uint32_t* x = rows + (n * 8 + g) * W + kk * 8 + t;
      mma_bf16(s[n], a[kk], x[0], x[4]);
    }
}

// acc[16 x DK] += P[16 x 8 N] . rows[8 N x DK]: P in C fragments s, rounded
// to bf16 here (two neighbouring n-tiles per A fragment); the 8 N rows of a
// bf16 tile are the reduction, their B fragments by ldmatrix.trans.
template <int DK, int N>
__device__ __forceinline__ void product_pn_bf16(float (&acc)[DK / 8][4], const float (&s)[N][4],
                                                const uint32_t* rows, int lane) {
  constexpr int W = TileB<DK>::kWords;
  const int mat = lane >> 3, r = lane & 7;
#pragma unroll
  for (int j = 0; j < N / 2; ++j) {
    const uint32_t a[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]), pack_bf16(s[2 * j][2], s[2 * j][3]),
                           pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                           pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
    for (int n = 0; n < DK / 8; n += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, rows + (16 * j + (mat & 1) * 8 + r) * W + (n + (mat >> 1)) * 4);
      mma_bf16(acc[n], a, b[0], b[1]);
      mma_bf16(acc[n + 1], a, b[2], b[3]);
    }
  }
}

}  // namespace nsp_rel
