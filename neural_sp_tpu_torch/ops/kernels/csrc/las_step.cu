// K2: one LAS decode step (LSTM layer 0 + location attention), float32,
// for sm_90a.
//
// Replaces the TPU kernel `_fwd_kernel` of
// neural_sp_tpu/ops/las_scan_pallas.py (last present at 63255ae~1),
// reached through `_fwd`, in its one-step decode form (U = 1, N rows =
// beam x utterances). Its math (docstring lines 25-31 there):
//
//   y   = eg + ctx_prev W_ctx + h_prev W_h + b          gate order i,f,g,o
//   c   = sig(y_f) c_prev + sig(y_i) tanh(y_g);  h = sig(y_o) tanh(c)
//   loc = conv1d(aw_prev, conv_w)   width K, SAME (left (K-1)/2), cross-corr.
//   e   = v . tanh(kc + h W_q + loc W_f);  aw = softmax_f32(e masked);
//   ctx = aw values
//
// What bounds it on the H100: a step is small (N rows), so each of its
// kernels is short and latency (a block's chain of dependent loads and
// barriers, and the boundary between two dependent launches), not
// bandwidth, sets its time. By bytes a step needs the gate weights once
// ((D + H) x 4H floats, 25 MB at the flagship's D = 512, H = 1024) and
// each row's keys and values over its valid frames (T x (A + D) floats per
// row). The design reads exactly that and prefetches what no step writes
// before a kernel waits for the one before it.
//
// A decode step (K2, `nsp_las_step_f32` and `nsp_las_step_plan_f32`) is
// sized for a beam's rows, four kernels as programmatic dependent launches:
//   1. las_gates_rows<NR> (N <= 16 rows): the product x [N, D + H] x
//      [W_ctx; W_h] shaped as a matrix-vector product. W goes from global
//      memory straight to registers, a float4 per lane and row, four rows
//      in flight while four are multiplied, two blocks of eight warps per
//      SM; x sits in shared memory as [k][NR] and is read by broadcast; NR
//      is N rounded up to 4, so 10 rows cost 12 rows' arithmetic. 32 x 8
//      blocks, 8 split-K partials. More rows take las_gates (below).
//   2. las_cell: a thread per (row, unit) adds the partials, eg and b,
//      applies the LSTM cell, and writes h, c and hd = h keep.
//   3. las_query: q = hd W_q^T, a warp per output for 8 rows.
//   4. las_attend: a block per (16 frames, row), only where the row has
//      frames (see attend_block); the block of a row that finishes last
//      (a counter per row, one atomicAdd per block, nobody waits) does the
//      row's softmax and sums the partial contexts.
// `parent` [N] (optional) makes row n read row parent[n] of the carry
// (ctx_prev, h_prev, c_prev, aw_prev): a beam's reorder costs no copy. The
// plan form reads one of two carry sets and writes the other.
//
// A step of the teacher-forced scan (K3, below) is five kernels:
//   1. las_gates: split-K product x [N, D + H] x [W_ctx; W_h]. A block per
//      (64 gate columns, 256 reduction rows, 32 rows n) streams its
//      disjoint tile of W once, in two cp.async stages, against all its
//      rows of x = [ctx_prev, h_prev] (their columns arriving with W's),
//      and writes its partial sum: [W_ctx; W_h] is read once per step.
//   2. las_cell, as above, also writing (K3) the gate activations.
//   3. las_query, the lanes loading their weights before the rows of hd
//      are awaited.
//   4. las_attend_part: a block per (16 frames, row), only where the row
//      has frames: the location features by half-warps, the energies with
//      W_f's rows in registers (W_f is used as laid out), then the block's
//      own max m_b, p = exp(e - m_b), their sum s_b and the unnormalised
//      partial context sum p values. kc and values come by cp.async, the
//      valid frames' rows only.
//   5. las_attend_combine: the row's softmax, once: M = max m_b, S = sum
//      s_b exp(m_b - M); aw = p exp(m_b - M) / S and ctx = sum_b partial_b
//      exp(m_b - M) / S, a pass over at most ceil(T / 16) x (2 + D) floats
//      per row. No barrier across blocks: the launch boundary orders 4
//      before 5.
// The masked value is finfo(f32).min / 2, as in apply_mask_logits, so a
// row with no valid frame (klen 0) gets uniform weights 1 / T over all T
// frames and the mean of all its T value rows as context: such a row's
// blocks skip the energies, take e = the masked value on every frame, and
// are the only ones that read frames past klen. A row with klen >= 1 gives
// its masked frames the weight exp(masked - M) = 0 exactly, so they are
// written as zeros and never read.
//
// K3, the teacher-forced U-step scan of training (`nsp_las_scan_f32`,
// the U-step form of the same TPU kernel), runs its five kernels once
// per step from a host loop (5 U launches per call), with the gate
// activations (i, f, g, o) stored for the backward and keep_t the step's
// dropout scale (dropout on the LSTM output feeds the attention and the
// readout; the carry keeps the undropped h). Every step's h, c, gates,
// query, attention weights and context stay in [U, N, ...] outputs, so
// step t reads step t-1's slots as its carry and the backward (K3b,
// las_scan.cu) has what it needs. Both chains run as programmatic
// dependent launches (las_common.cuh): each kernel starts while the one
// before it still runs and loads what no step writes (its weights, kc,
// values, eg, keep, parent) before it waits for that kernel. The energies
// use the fast tanh of las_common.cuh (absolute error about 1e-7);
// las_gates is bound by its shared-memory reads (8 float4 per 64 FMAs of a
// thread's 4 x 4 tile), not by the weights' bytes.

#include <algorithm>
#include <cfloat>

#include "las_common.cuh"

namespace {

using namespace nsp_las;

// las_gates: a block per (kGateN rows n, kGateCols gate columns, kGateK
// reduction rows); W streamed kGateSub reduction rows at a time
constexpr int kGateN = 32;
constexpr int kGateCols = 64;
constexpr int kGateK = 256;
constexpr int kGateSub = 64;
constexpr int kGateThreads = 128;
constexpr int kXStride = kGateK + 4;      // 16-byte rows, conflict-free float4 reads
constexpr int kWStride = kGateCols + 4;
constexpr int kCellThreads = 128;
constexpr int kQueryRows = 8;        // rows n per block of las_query
constexpr int kQueryAhead = 8;       // float4 of a weight row a lane loads ahead (H <= 1024)
constexpr int kCombineThreads = 128;
constexpr int kCombineSlices = 4;    // blocks per row of las_attend_combine
// las_attend's finishing block: the blocks' partial contexts a thread loads
// at once, and the frames it holds while the scales form
constexpr int kCombineAhead = 8;
constexpr int kCombineFrames = 2;

__device__ __forceinline__ float sigmoidf(float x) { return 1.0f / (1.0f + expf(-x)); }

// acc + x . (a, b, c, d)
__device__ __forceinline__ float dot4(const float4& x, float a, float b, float c, float d,
                                      float acc) {
  return fmaf(x.w, d, fmaf(x.z, c, fmaf(x.y, b, fmaf(x.x, a, acc))));
}

// Shared memory of las_gates, in floats: x's kGateN rows of the block's
// kGateK reduction columns, and two stages of kGateSub weight rows x
// kGateCols columns.
constexpr size_t kGateSmemFloats = (size_t)kGateN * kXStride + 2 * (size_t)kGateSub * kWStride;

// partial[s, n, g] = sum over the reduction rows k of chunk s of x[n, k]
// W[k, g], x = [ctx_prev, h_prev] ([N, D + H]), W = [W_ctx; W_h] ([D + H,
// 4H], row-major). A block per (kGateCols columns g, chunk s, kGateN rows
// n) streams its disjoint tile of W once, by cp.async in two stages, with
// x's same reduction columns arriving with each stage; a thread holds a
// 4 x 4 tile (n = tn + 8 i, g = 4 tc + j) and reads four reduction rows
// of each operand per float4 load. Rows past N and reduction rows past
// D + H are zeros. vec: every pointer is 16-byte aligned and D, H are
// multiples of 4, so that x moves in 16-byte copies too. parent (may be
// null): row n takes row parent[n] of ctx_prev and h_prev.
__global__ void __launch_bounds__(kGateThreads)
las_gates(const float* __restrict__ ctx_prev, const float* __restrict__ h_prev,
          const int* __restrict__ parent, const float* __restrict__ w_ctx,
          const float* __restrict__ w_h, float* __restrict__ partial, int N, int D, int H,
          bool vec) {
  extern __shared__ float4 gate_smem[];  // float4: 16-byte aligned for cp.async
  float* xs = reinterpret_cast<float*>(gate_smem);  // [kGateN][kXStride]
  float* ws = xs + (size_t)kGateN * kXStride;       // [2][kGateSub][kWStride]
  const int G = 4 * H, R = D + H;
  const int g0 = blockIdx.x * kGateCols, k0 = blockIdx.y * kGateK, n0 = blockIdx.z * kGateN;
  const int kn = min(kGateK, R - k0);
  const int tid = threadIdx.x;
  // x[n, k] for a reduction row k of [ctx_prev, h_prev]
  auto x_at = [&](int n, int k) {
    if (parent != nullptr) n = parent[n];
    return k < D ? ctx_prev + (size_t)n * D + k : h_prev + (size_t)n * H + (k - D);
  };
  // a stage: kGateSub rows of W's kGateCols columns into the ring ...
  auto load_w = [&](int stage, int sub) {
    float* dst = ws + (size_t)stage * kGateSub * kWStride;
    const int kb = sub * kGateSub;
    for (int c = tid; c < kGateSub * (kGateCols / 4); c += kGateThreads) {
      const int kk = kb + c / (kGateCols / 4), col = (c % (kGateCols / 4)) * 4;
      const int k = k0 + kk;
      const bool in = kk < kn && g0 + col < G;
      const float* row = (k < D) ? w_ctx + (size_t)k * G : w_h + (size_t)(k - D) * G;
      float* to = dst + (kk - kb) * kWStride + col;
      if (vec) {
        cp_async16(to, in ? row + g0 + col : w_h, in);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) cp_async4(to + e, in ? row + g0 + col + e : w_h, in);
      }
    }
  };
  // ... and x's same reduction columns
  auto load_x = [&](int sub) {
    const int kb = sub * kGateSub;
    for (int c = tid; c < kGateN * (kGateSub / 4); c += kGateThreads) {
      const int nn = c / (kGateSub / 4), kk = kb + (c % (kGateSub / 4)) * 4;
      const int n = n0 + nn, k = k0 + kk;
      float* to = xs + nn * kXStride + kk;
      if (vec) {
        const bool in = n < N && kk < kn;
        cp_async16(to, in ? x_at(n, k) : ctx_prev, in);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool in = n < N && kk + e < kn;
          cp_async4(to + e, in ? x_at(n, k + e) : ctx_prev, in);
        }
      }
    }
  };
  const int n_sub = (kn + kGateSub - 1) / kGateSub;
  load_w(0, 0);            // the weights do not wait for the step before
  grid_dependency_wait();  // x = [ctx_prev, h_prev] does
  grid_dependents_launch();
  load_x(0);
  cp_async_commit();
  const int tn = tid & 7, tc = tid >> 3;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  for (int sub = 0; sub < n_sub; ++sub) {
    if (sub + 1 < n_sub) {
      load_w((sub + 1) & 1, sub + 1);
      load_x(sub + 1);
      cp_async_commit();
      cp_async_wait_one();
    } else {
      cp_async_wait_none();
    }
    __syncthreads();
    const float* wb = ws + (size_t)(sub & 1) * kGateSub * kWStride + 4 * tc;
    const float* xb = xs + sub * kGateSub;
#pragma unroll 4
    for (int k = 0; k < kGateSub; k += 4) {
      float4 x[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        x[i] = *reinterpret_cast<const float4*>(xb + (tn + 8 * i) * kXStride + k);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        w[e] = *reinterpret_cast<const float4*>(wb + (k + e) * kWStride);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][0] = dot4(x[i], w[0].x, w[1].x, w[2].x, w[3].x, acc[i][0]);
        acc[i][1] = dot4(x[i], w[0].y, w[1].y, w[2].y, w[3].y, acc[i][1]);
        acc[i][2] = dot4(x[i], w[0].z, w[1].z, w[2].z, w[3].z, acc[i][2]);
        acc[i][3] = dot4(x[i], w[0].w, w[1].w, w[2].w, w[3].w, acc[i][3]);
      }
    }
    __syncthreads();  // the stage is refilled next
  }
  const int g = g0 + 4 * tc;
  if (g >= G) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + tn + 8 * i;
    if (n < N)
      *reinterpret_cast<float4*>(partial + ((size_t)blockIdx.y * N + n) * G + g) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

// las_gates_rows: the gate product of a decode step over at most 16 rows
// (a beam's), shaped as a matrix-vector product: no tile of W is staged in
// shared memory. A block of kRowsWarps warps takes kRowsCols gate columns
// (a float4 per lane) and kRowsK reduction rows, kRowsWarpK per warp; each
// lane streams its 16 bytes of every weight row from global memory
// straight into registers, kRowsAhead rows in flight while the kRowsAhead
// before them are multiplied, against x = [ctx_prev, h_prev] of all NR
// rows, which sits in shared memory as [k][NR] so that a warp reads it by
// broadcast float4s. Two blocks share an SM (under 128 registers a
// thread), so 16 warps keep loads in flight. NR (4, 8, 12 or 16) is the
// number of rows rounded up to a multiple of 4: 10 rows cost 12 rows'
// arithmetic, not 32.
constexpr int kRowsThreads = 256;
constexpr int kRowsWarps = kRowsThreads / 32;
constexpr int kRowsCols = 128;
constexpr int kRowsWarpK = 24;
constexpr int kRowsK = kRowsWarps * kRowsWarpK;
constexpr int kRowsAhead = 4;
constexpr int kRowsMax = 16;
static_assert(kRowsWarpK % (2 * kRowsAhead) == 0, "two register sets of weight rows in turns");

// Shared memory of las_gates_rows<NR>, in floats: x [kRowsK][NR], then, in
// its place, the warps' sums [kRowsWarps][NR][kRowsCols].
constexpr size_t rows_smem_floats(int nr) {
  return (size_t)nr * (kRowsK > kRowsWarps * kRowsCols ? kRowsK : kRowsWarps * kRowsCols);
}

// The reduction rows are dealt to the warps in chunks of kRowsWarpK rows
// that never straddle the two matrices: first the chunks of w_ctx's D rows
// (the last one short), then those of w_h's H rows, so a warp streams one
// matrix from one base pointer. The number of blocks along the reduction
// (the partials the cell kernel sums):
__host__ __device__ constexpr int rows_chunks(int rows) {
  return (rows + kRowsWarpK - 1) / kRowsWarpK;
}
__host__ __device__ constexpr int rows_splits(int D, int H) {
  return (rows_chunks(D) + rows_chunks(H) + kRowsWarps - 1) / kRowsWarps;
}

// partial[s, n, g] as las_gates writes it, s = blockIdx.y over the blocks'
// kRowsWarps chunks of reduction rows. w_ctx and w_h must be 16-byte
// aligned (4H floats per row keep every row so). parent (may be null): row
// n takes row parent[n] of ctx_prev and h_prev. The warps' sums meet in
// shared memory and are added in a fixed order: the result does not change
// from run to run.
template <int NR>
__global__ void __launch_bounds__(kRowsThreads, 2)
las_gates_rows(const float* __restrict__ ctx_prev, const float* __restrict__ h_prev,
               const int* __restrict__ parent, const float* __restrict__ w_ctx,
               const float* __restrict__ w_h, float* __restrict__ partial, int N, int D, int H) {
  extern __shared__ float4 rows_smem[];  // float4: 16-byte aligned
  float* xs = reinterpret_cast<float*>(rows_smem);  // [kRowsK][NR]
  const int G = 4 * H;
  const int g0 = blockIdx.x * kRowsCols;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = g0 + 4 * lane;
  const int ctx_chunks = rows_chunks(D);
  // the warp's chunk: rows kl .. kl + rows - 1 of w_ctx, or of w_h
  const int chunk = blockIdx.y * kRowsWarps + warp;
  const bool of_h = chunk >= ctx_chunks;
  const int kl = (of_h ? chunk - ctx_chunks : chunk) * kRowsWarpK;
  const int rows = g < G ? min(kRowsWarpK, (of_h ? H : D) - kl) : 0;  // <= 0: none
  const float* src = (of_h ? w_h : w_ctx) + (size_t)kl * G + g;
  // the lane's float4 of kRowsAhead weight rows from the chunk's row kb on
  auto load_w = [&](float4 (&w)[kRowsAhead], int kb) {
#pragma unroll
    for (int u = 0; u < kRowsAhead; ++u)
      w[u] = kb + u < rows ? __ldg(reinterpret_cast<const float4*>(src + (size_t)(kb + u) * G))
                           : make_float4(0.f, 0.f, 0.f, 0.f);
  };
  float4 wa[kRowsAhead], wb[kRowsAhead];
  load_w(wa, 0);  // the weights do not wait for the step before, nor does parent
  // x of the block's chunks -> xs[kk][n], zeros past N and past a matrix's
  // rows, all the loads in flight at once (kk fastest, so they are
  // coalesced)
  constexpr int kXPerThread = kRowsK * NR / kRowsThreads;
  static_assert(kRowsK * NR % kRowsThreads == 0, "x divides among the threads");
  int from[kXPerThread];  // the row of the carry that x's row n is
#pragma unroll
  for (int i = 0; i < kXPerThread; ++i) {
    const int n = (tid + i * kRowsThreads) / kRowsK;
    from[i] = (parent != nullptr && n < N) ? parent[n] : n;
  }
  grid_dependency_wait();  // x = [ctx_prev, h_prev] is the step before's
  grid_dependents_launch();
  float xv0[kXPerThread];
#pragma unroll
  for (int i = 0; i < kXPerThread; ++i) {
    const int idx = tid + i * kRowsThreads;
    const int n = idx / kRowsK, kk = idx % kRowsK;
    const int c = blockIdx.y * kRowsWarps + kk / kRowsWarpK;
    const bool h_row = c >= ctx_chunks;
    const int k = (h_row ? c - ctx_chunks : c) * kRowsWarpK + kk % kRowsWarpK;
    xv0[i] = 0.0f;
    if (n < N && k < (h_row ? H : D))
      xv0[i] = h_row ? h_prev[(size_t)from[i] * H + k] : ctx_prev[(size_t)from[i] * D + k];
  }
#pragma unroll
  for (int i = 0; i < kXPerThread; ++i) {
    const int idx = tid + i * kRowsThreads;
    xs[(idx % kRowsK) * NR + idx / kRowsK] = xv0[i];
  }
  __syncthreads();
  float acc[NR][4];
#pragma unroll
  for (int n = 0; n < NR; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[n][j] = 0.0f;
  const float* xw = xs + warp * kRowsWarpK * NR;
  auto multiply = [&](const float4 (&w)[kRowsAhead], int kb) {
#pragma unroll
    for (int u = 0; u < kRowsAhead; ++u) {
      const float4* xr = reinterpret_cast<const float4*>(xw + (kb + u) * NR);
#pragma unroll
      for (int q = 0; q < NR / 4; ++q) {
        const float4 x = xr[q];
        const float xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[4 * q + i][0] = fmaf(xv[i], w[u].x, acc[4 * q + i][0]);
          acc[4 * q + i][1] = fmaf(xv[i], w[u].y, acc[4 * q + i][1]);
          acc[4 * q + i][2] = fmaf(xv[i], w[u].z, acc[4 * q + i][2]);
          acc[4 * q + i][3] = fmaf(xv[i], w[u].w, acc[4 * q + i][3]);
        }
      }
    }
  };
#pragma unroll
  for (int kb = 0; kb < kRowsWarpK; kb += 2 * kRowsAhead) {
    load_w(wb, kb + kRowsAhead);
    multiply(wa, kb);
    if (kb + 2 * kRowsAhead < kRowsWarpK) load_w(wa, kb + 2 * kRowsAhead);
    multiply(wb, kb + kRowsAhead);
  }
  __syncthreads();  // every warp is done with xs
  float* red = xs;  // [kRowsWarps][NR][kRowsCols]
#pragma unroll
  for (int n = 0; n < NR; ++n)
    *reinterpret_cast<float4*>(red + ((size_t)warp * NR + n) * kRowsCols + 4 * lane) =
        make_float4(acc[n][0], acc[n][1], acc[n][2], acc[n][3]);
  __syncthreads();
  for (int o = tid; o < N * kRowsCols; o += kRowsThreads) {
    const int n = o / kRowsCols, col = o % kRowsCols;
    float sum = 0.0f;
#pragma unroll
    for (int w = 0; w < kRowsWarps; ++w) sum += red[((size_t)w * NR + n) * kRowsCols + col];
    if (g0 + col < G) partial[((size_t)blockIdx.y * N + n) * G + g0 + col] = sum;
  }
}

// A thread per (row n, unit j): sums the gate product's n_split partials
// (loads independent of each other), adds eg and the bias, applies the
// LSTM cell, and writes c, h (the carry), hd = h keep (what the query
// reads; keep may be null: no dropout) and, when asked, the gate
// activations (i, f, g, o). parent (may be null): row n takes row
// parent[n] of c_prev. counts (may be null): the rows' block counters of
// las_attend, zeroed here.
__global__ void __launch_bounds__(kCellThreads)
las_cell(const float* __restrict__ eg, const float* __restrict__ bias,
         const float* __restrict__ partial, const float* __restrict__ c_prev,
         const int* __restrict__ parent, const float* __restrict__ keep,
         float* __restrict__ h_out, float* __restrict__ hd_out,
         float* __restrict__ c_out, float* __restrict__ gates_out,
         unsigned* __restrict__ counts, int N, int H, int n_split) {
  const int idx = blockIdx.x * kCellThreads + threadIdx.x;
  if (idx >= N * H) return;
  if (counts != nullptr && idx < N) counts[idx] = 0u;  // las_attend's, later in the step
  const int n = idx / H, j = idx % H;
  const int G = 4 * H;
  const size_t at = (size_t)n * G + j;
  const float kp = (keep != nullptr) ? keep[idx] : 1.0f;
  float y[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) y[g] = eg[at + g * H] + bias[g * H + j];
  grid_dependency_wait();  // the partials and the carry
  grid_dependents_launch();
  const float cp = c_prev[parent != nullptr ? (size_t)parent[n] * H + j : (size_t)idx];
#pragma unroll 2
  for (int sp = 0; sp < n_split; ++sp) {
    const float* pt = partial + (size_t)sp * N * G + at;
#pragma unroll
    for (int g = 0; g < 4; ++g) y[g] += pt[g * H];
  }
  const float ig = sigmoidf(y[0]), fg = sigmoidf(y[1]), gg = tanhf(y[2]), og = sigmoidf(y[3]);
  if (gates_out != nullptr) {
    float* gt = gates_out + at;
    gt[0] = ig;
    gt[H] = fg;
    gt[2 * H] = gg;
    gt[3 * H] = og;
  }
  const float c = fg * cp + ig * gg;
  const float h = og * tanhf(c);
  c_out[idx] = c;
  h_out[idx] = h;
  hd_out[idx] = h * kp;
}

// q[n, a] = sum_k hd[n, k] w_q[a, k] (w_q is [A, H]): a warp per output a
// for kQueryRows rows at once, lanes along H, so each weight row is read
// once per block. Each lane loads its first kQueryAhead float4 of the
// weight row before the block's rows of hd (the cell's output) are
// awaited and staged; vec: hd and w_q are 16-byte aligned and H is a
// multiple of 4.
__global__ void __launch_bounds__(kThreads)
las_query(const float* __restrict__ hd, const float* __restrict__ w_q, float* __restrict__ q,
          int N, int H, int A, bool vec) {
  extern __shared__ float4 query_smem[];  // float4: 16-byte aligned for cp.async
  float* hs = reinterpret_cast<float*>(query_smem);  // [kQueryRows][H]
  const int n0 = blockIdx.y * kQueryRows;
  const int rows = min(kQueryRows, N - n0);
  const int lane = threadIdx.x & 31;
  const int a = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const float* row = w_q + (size_t)min(a, A - 1) * H;
  float acc[kQueryRows];
#pragma unroll
  for (int r = 0; r < kQueryRows; ++r) acc[r] = 0.0f;
  auto stage_rows = [&]() {  // hd is the cell's output
    grid_dependency_wait();
    grid_dependents_launch();
    copy_async(hs, hd + (size_t)n0 * H, rows * H);
    cp_async_commit();
    cp_async_wait_none();
    __syncthreads();
  };
  if (vec) {
    float4 w[kQueryAhead];
#pragma unroll
    for (int i = 0; i < kQueryAhead; ++i) {
      const int k = 4 * lane + 128 * i;
      w[i] = k < H ? *reinterpret_cast<const float4*>(row + k) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    stage_rows();
    auto add = [&](const float4& wv, int k) {
#pragma unroll
      for (int r = 0; r < kQueryRows; ++r) {
        if (r >= rows) break;
        const float4 x = *reinterpret_cast<const float4*>(hs + r * H + k);
        acc[r] = dot4(wv, x.x, x.y, x.z, x.w, acc[r]);
      }
    };
#pragma unroll
    for (int i = 0; i < kQueryAhead; ++i) {
      const int k = 4 * lane + 128 * i;
      if (k < H) add(w[i], k);
    }
    for (int k = 4 * lane + 128 * kQueryAhead; k < H; k += 128)
      add(*reinterpret_cast<const float4*>(row + k), k);
  } else {
    stage_rows();
    for (int k = lane; k < H; k += 32) {
      const float wv = row[k];
#pragma unroll
      for (int r = 0; r < kQueryRows; ++r)
        if (r < rows) acc[r] = fmaf(wv, hs[r * H + k], acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < kQueryRows; ++r) {
    const float s = warp_sum(acc[r]);
    if (lane == 0 && r < rows && a < A) q[(size_t)(n0 + r) * A + a] = s;
  }
}

// Shared memory of a block's attention (attend_block), in floats.
__host__ __device__ inline size_t attend_smem_floats(int D, int A, int C, int K) {
  return (size_t)kFrames * (A + D) + (size_t)C * K + (kFrames + K - 1) + (size_t)kFrames * C +
         kFrames + (size_t)kWarps * kFrames;
}

// The frames a row's softmax runs over: its klen, or all T frames for a
// row with none (every energy is then the same masked value, so the
// weights are uniform over the whole array, as the plain version's).
__device__ __forceinline__ int attend_frames(int klen, int T) {
  klen = max(0, min(klen, T));
  return klen == 0 ? T : klen;
}

// sum over the channels past the first group of l[c] w[c].
static __device__ __noinline__ float rest_dot(const float* l, const float* w, int C) {
  float s = 0.0f;
  for (int c = kGroupC; c < C; ++c) s = fmaf(l[c], w[c], s);
  return s;
}

// The attention of step t over the block's kFrames frames (blockIdx.x) of
// row n (blockIdx.y), up to the row's own softmax. A block whose frames
// all lie past the row's length returns 0 at once. For the others:
//   loc   = conv(aw_prev)        a half-warp per frame, lanes along K
//   e     = v . tanh(kc + q + loc W_f^T)    a thread per two attention
//           units (a, a + 256) with their rows of W_f in registers, frame
//           by frame; the frames' sums meet in shared memory
//   m = max e, p = exp(e - m), s = sum p     (warp 0)
//   part_ctx = sum p values      a thread per context column
// conv_w, the valid frames' kc rows and their values rows come by
// cp.async, in that order, each awaited where it is needed, and W_f's rows
// and v go to registers, all before the block waits for the kernels
// before it: only aw_prev's window and q depend on them. Nothing past the
// row's length is read. (m, s) goes to ms[0..1] and the partial context to
// pc[0..D), in global or in shared memory; p stays in shared memory (*ps_out)
// and, with kStoreP, also goes to aw_out (the combine kernel rescales it in
// place). A row with klen 0 skips the energies: e is the masked value on
// all its T frames. parent (may be null): row n takes row parent[n] of
// aw_prev. Returns the block's number of frames.
template <bool kStoreP>
__device__ __forceinline__ int attend_block(
    float* smem, const float* __restrict__ q, const float* __restrict__ aw_prev,
    const int* __restrict__ parent, const float* __restrict__ conv_w,
    const float* __restrict__ w_f, const float* __restrict__ v, const float* __restrict__ kc,
    const float* __restrict__ values, const int* __restrict__ klens, float* __restrict__ aw_out,
    float* ms, float* pc, float** ps_out, int T, int D, int A, int C, int K) {
  float* kcs = smem;                          // [kFrames][A]
  float* vals = kcs + (size_t)kFrames * A;    // [kFrames][D]
  float* cw = vals + (size_t)kFrames * D;     // [C][K]
  float* awp = cw + (size_t)C * K;            // [kFrames + K - 1]: aw_prev at t0 - left + i
  float* loc = awp + (kFrames + K - 1);       // [kFrames][C]
  float* ps = loc + (size_t)kFrames * C;      // [kFrames]
  float* red = ps + kFrames;                  // [kWarps][kFrames]
  *ps_out = ps;

  const int n = blockIdx.y, tb = blockIdx.x;
  const int t0 = tb * kFrames;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool empty = min(klens[n], T) <= 0;
  const int len = attend_frames(klens[n], T);
  if (t0 >= len) return 0;
  const int nf = min(kFrames, len - t0);      // the block's frames
  const size_t row0 = (size_t)n * T + t0;
  // what no step writes does not wait for the kernels before
  if (!empty) copy_async(cw, conv_w, C * K);
  cp_async_commit();
  if (!empty) copy_async(kcs, kc + row0 * A, nf * A);
  cp_async_commit();
  copy_async(vals, values + row0 * D, nf * D);
  cp_async_commit();
  if (!empty) {
    float ep[kFrames];
#pragma unroll
    for (int tl = 0; tl < kFrames; ++tl) ep[tl] = 0.0f;
    for (int base = 0; base < A; base += 2 * kThreads) {
      // units past A take unit 0's loads and weigh nothing
      const int a0 = base + tid, a1 = a0 + kThreads;
      const int a0c = a0 < A ? a0 : 0, a1c = a1 < A ? a1 : 0;
      float wf0[kGroupC], wf1[kGroupC];
#pragma unroll
      for (int c = 0; c < kGroupC; ++c) {
        wf0[c] = c < C ? w_f[(size_t)a0c * C + c] : 0.0f;
        wf1[c] = c < C ? w_f[(size_t)a1c * C + c] : 0.0f;
      }
      const float v0 = a0 < A ? v[a0] : 0.0f, v1 = a1 < A ? v[a1] : 0.0f;
      if (base == 0) {
        grid_dependency_wait();  // aw_prev and q are the steps' own
        grid_dependents_launch();
        const int left = (K - 1) / 2;
        const size_t prow = (size_t)(parent != nullptr ? parent[n] : n) * T;
        for (int i = tid; i < kFrames + K - 1; i += kThreads) {
          const int t = t0 + i - left;
          awp[i] = (t >= 0 && t < T) ? aw_prev[prow + t] : 0.0f;
        }
        cp_async_wait_two();  // conv_w
        __syncthreads();
        loc_group(awp, cw, loc, 0, C, K);
        if (C > kGroupC) loc_rest(awp, cw, loc, C, K);
      }
      const float q0 = q[(size_t)n * A + a0c], q1 = q[(size_t)n * A + a1c];
      if (base == 0) {
        cp_async_wait_one();  // kc
        __syncthreads();      // and loc
      }
#pragma unroll
      for (int tl = 0; tl < kFrames; ++tl) {
        if (tl >= nf) break;
        const float* lt = loc + tl * C;
        float f0 = 0.0f, f1 = 0.0f;
#pragma unroll
        for (int c = 0; c < kGroupC; ++c) {
          const float lc = c < C ? lt[c] : 0.0f;
          f0 = fmaf(lc, wf0[c], f0);
          f1 = fmaf(lc, wf1[c], f1);
        }
        if (C > kGroupC) {
          f0 += rest_dot(lt, w_f + (size_t)a0c * C, C);
          f1 += rest_dot(lt, w_f + (size_t)a1c * C, C);
        }
        const float* kr = kcs + tl * A;
        ep[tl] += v0 * tanh_fast(kr[a0c] + q0 + f0) + v1 * tanh_fast(kr[a1c] + q1 + f1);
      }
    }
#pragma unroll
    for (int tl = 0; tl < kFrames; ++tl) {
      const float s = warp_sum(ep[tl]);
      if (lane == 0) red[warp * kFrames + tl] = s;
    }
    __syncthreads();
  } else {
    grid_dependency_wait();  // aw_out was read by the step before
    grid_dependents_launch();
  }
  if (warp == 0) {
    float e = -INFINITY;
    if (lane < nf) {
      e = nsp_rel::kNeg;
      if (!empty) {
        e = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) e += red[w * kFrames + lane];
      }
    }
    const float m = warp_max(e);
    const float p = lane < nf ? expf(e - m) : 0.0f;
    const float s = warp_sum(p);
    if (lane < nf) {
      ps[lane] = p;
      if (kStoreP) aw_out[row0 + lane] = p;
    }
    if (lane == 0) {
      ms[0] = m;
      ms[1] = s;
    }
  }
  cp_async_wait_none();  // values
  __syncthreads();
  for (int d = tid; d < D; d += kThreads) {
    float s = 0.0f;
#pragma unroll 4
    for (int tl = 0; tl < nf; ++tl) s = fmaf(ps[tl], vals[tl * D + d], s);
    pc[d] = s;
  }
  return nf;
}

// The first half of a step's attention where a row's frames do not fit one
// cluster (and in the scan, K3): a block per (kFrames frames, row n) runs
// attend_block and leaves p in aw_out, (m, s) in part_ms [N, n_tb, 2] and
// the unnormalised partial context in part_ctx [N, n_tb, D];
// las_attend_combine finishes the row.
__global__ void __launch_bounds__(kThreads, 3)  // three blocks (their shared memory) per SM
las_attend_part(const float* __restrict__ q, const float* __restrict__ aw_prev,
                const int* __restrict__ parent, const float* __restrict__ conv_w,
                const float* __restrict__ w_f, const float* __restrict__ v,
                const float* __restrict__ kc, const float* __restrict__ values,
                const int* __restrict__ klens, float* __restrict__ aw_out,
                float* __restrict__ part_ms, float* __restrict__ part_ctx, int T, int D, int A,
                int C, int K) {
  extern __shared__ float4 attend_smem[];  // float4: 16-byte aligned for cp.async
  const size_t slot = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  float* ps;
  attend_block<true>(reinterpret_cast<float*>(attend_smem), q, aw_prev, parent, conv_w, w_f, v,
                     kc, values, klens, aw_out, part_ms + slot * 2, part_ctx + slot * D, &ps, T,
                     D, A, C, K);
}

// A decode step's whole attention in one launch (K2): every block runs
// attend_block as las_attend_part does, then counts itself done for its
// row (a fence, then one atomicAdd on the row's counter); the block that
// counts last finds every other block's (m, s), p and partial context
// written, and finishes the row itself as las_attend_combine would: M, S,
// the scales, aw = p scale (zeros past the row's length) and ctx = sum_b
// part_ctx_b scale_b. No block waits for another: the others have left.
// What other blocks wrote is read past the L1 (__ldcg). counts [N] must be
// zero at the launch (las_cell zeroes it earlier in the step). The scales
// of the row's gridDim.x blocks take the place of the block's keys in
// shared memory, so gridDim.x may not exceed attend_smem_floats().
__global__ void __launch_bounds__(kThreads, 3)
las_attend(const float* __restrict__ q, const float* __restrict__ aw_prev,
           const int* __restrict__ parent, const float* __restrict__ conv_w,
           const float* __restrict__ w_f, const float* __restrict__ v,
           const float* __restrict__ kc, const float* __restrict__ values,
           const int* __restrict__ klens, float* aw_out, float* part_ms, float* part_ctx,
           unsigned* __restrict__ counts, float* __restrict__ ctx_out, int T, int D, int A, int C,
           int K) {
  extern __shared__ float4 attend_smem[];  // float4: 16-byte aligned for cp.async
  const int n = blockIdx.y, n_tb = gridDim.x, tid = threadIdx.x, lane = tid & 31;
  const size_t slot = (size_t)n * n_tb + blockIdx.x;
  float* ps;
  const int nf = attend_block<true>(reinterpret_cast<float*>(attend_smem), q, aw_prev, parent,
                                    conv_w, w_f, v, kc, values, klens, aw_out,
                                    part_ms + slot * 2, part_ctx + slot * D, &ps, T, D, A, C, K);
  if (nf == 0) return;  // a block past the row's length: the last one writes its zeros
  const int len = attend_frames(klens[n], T);
  const int nb = (len + kFrames - 1) / kFrames;  // the row's blocks with frames
  __threadfence();  // this thread's p, (m, s) and partial context, before the count
  __syncthreads();
  const bool mine = tid == 0 && atomicAdd(counts + n, 1u) == (unsigned)(nb - 1);
  if (!__syncthreads_or(mine)) return;
  __threadfence();  // the other blocks' writes, after the count
  float* scale = reinterpret_cast<float*>(attend_smem);  // [nb]: exp(m_b - M) / S
  // each dependent read of what the other blocks wrote is a trip to the
  // L2, so every thread asks for all it needs of a kind at once
  const float2* ms = reinterpret_cast<const float2*>(part_ms) + (size_t)n * n_tb;
  auto pair = [&](int b) { return b < nb ? __ldcg(ms + b) : make_float2(-INFINITY, 0.0f); };
  const float2 first = pair(lane);  // every warp forms M and S itself
  float m = warp_max(first.x);
  for (int b0 = 32; b0 < nb; b0 += 32) m = fmaxf(m, warp_max(pair(b0 + lane).x));
  float sum = warp_sum(first.y * expf(first.x - m));
  for (int b0 = 32; b0 < nb; b0 += 32) {
    const float2 v = pair(b0 + lane);
    sum += warp_sum(v.y * expf(v.x - m));
  }
  if (tid < 32 && tid < nb) scale[tid] = expf(first.x - m) / sum;
  for (int b = 32 + tid; b < nb; b += kThreads) scale[b] = expf(pair(b).x - m) / sum;
  float* row = aw_out + (size_t)n * T;
  float p[kCombineFrames];  // the thread's frames tid, tid + kThreads, ..
#pragma unroll
  for (int i = 0; i < kCombineFrames; ++i) {
    const int t = tid + i * kThreads;
    p[i] = t < len ? __ldcg(row + t) : 0.0f;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kCombineFrames; ++i) {
    const int t = tid + i * kThreads;
    if (t < T) row[t] = t < len ? p[i] * scale[t / kFrames] : 0.0f;
  }
  for (int t = tid + kCombineFrames * kThreads; t < T; t += kThreads)
    row[t] = t < len ? __ldcg(row + t) * scale[t / kFrames] : 0.0f;
  const float* pc = part_ctx + (size_t)n * n_tb * D;
  for (int d0 = 0; d0 < D; d0 += 2 * kThreads) {
    // two context columns a thread, kCombineAhead blocks' partials in flight
    const int da = d0 + tid, db = da + kThreads;
    float sa = 0.0f, sb = 0.0f;
    for (int b0 = 0; b0 < nb; b0 += kCombineAhead) {
      float va[kCombineAhead], vb[kCombineAhead];
#pragma unroll
      for (int i = 0; i < kCombineAhead; ++i) {
        const float* at = pc + (size_t)(b0 + i) * D;
        va[i] = (b0 + i < nb && da < D) ? __ldcg(at + da) : 0.0f;
        vb[i] = (b0 + i < nb && db < D) ? __ldcg(at + db) : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < kCombineAhead; ++i) {
        const float sc = b0 + i < nb ? scale[b0 + i] : 0.0f;
        sa = fmaf(sc, va[i], sa);
        sb = fmaf(sc, vb[i], sb);
      }
    }
    if (da < D) ctx_out[(size_t)n * D + da] = sa;
    if (db < D) ctx_out[(size_t)n * D + db] = sb;
  }
}

// The row's softmax, once: from the blocks' (m_b, s_b), M = max m_b and
// S = sum s_b exp(m_b - M); aw[t] = p[t] exp(m_b - M) / S on the row's
// frames (0 past them) and ctx = sum_b part_ctx_b exp(m_b - M) / S. A
// block per (row n, one of gridDim.y slices of the context columns and of
// the frames); each block forms the scales of the row's n_b <= ceil(T /
// kFrames) blocks itself.
__global__ void __launch_bounds__(kCombineThreads)
las_attend_combine(const int* __restrict__ klens, const float* __restrict__ part_ms,
                   const float* __restrict__ part_ctx, float* __restrict__ aw,
                   float* __restrict__ ctx_out, int T, int D) {
  extern __shared__ float scale[];  // [n_tb]: exp(m_b - M) / S
  const int n = blockIdx.x, tid = threadIdx.x;
  const int n_tb = (T + kFrames - 1) / kFrames;
  const int len = attend_frames(klens[n], T);
  const int nb = (len + kFrames - 1) / kFrames;
  const float* ms = part_ms + (size_t)n * n_tb * 2;
  grid_dependency_wait();
  grid_dependents_launch();
  float m = -INFINITY;
  for (int b = 0; b < nb; ++b) m = fmaxf(m, ms[2 * b]);
  float sum = 0.0f;
  for (int b = 0; b < nb; ++b) sum = fmaf(ms[2 * b + 1], expf(ms[2 * b] - m), sum);
  for (int b = tid; b < nb; b += kCombineThreads) scale[b] = expf(ms[2 * b] - m) / sum;
  __syncthreads();
  const int d_slice = (D + gridDim.y - 1) / gridDim.y;
  const float* pc = part_ctx + (size_t)n * n_tb * D;
  for (int d = blockIdx.y * d_slice + tid; d < min(D, (blockIdx.y + 1) * d_slice);
       d += kCombineThreads) {
    float s = 0.0f;
#pragma unroll 4
    for (int b = 0; b < nb; ++b) s = fmaf(scale[b], pc[(size_t)b * D + d], s);
    ctx_out[(size_t)n * D + d] = s;
  }
  const int t_slice = (T + gridDim.y - 1) / gridDim.y;
  float* row = aw + (size_t)n * T;
  for (int t = blockIdx.y * t_slice + tid; t < min(T, (blockIdx.y + 1) * t_slice);
       t += kCombineThreads)
    row[t] = t < len ? row[t] * scale[t / kFrames] : 0.0f;
}

// Where the pieces of a step's scratch lie in one buffer, in floats (each
// a multiple of 4, so every piece is 16-byte aligned when the buffer is):
// the gate product's partials [n_split, N, 4H] (n_split of las_gates, the
// larger of the two gate kernels'), hd = h keep [N, H], the query [N, A]
// (K3 writes its saved q_all instead), and per block of kFrames frames its
// (max, sum of exponentials) [N, n_tb, 2] and unnormalised partial context
// [N, n_tb, D], and las_attend's block counter per row [N] (unsigned).
struct Scratch {
  size_t partial, hd, q, part_ms, part_ctx, counts, floats;
};

Scratch carve(int N, int T, int H, int D, int A) {
  const size_t n_tb = (T + kFrames - 1) / kFrames;
  // the finer of the two gate kernels' splits
  const size_t n_split = std::max((D + H + kGateK - 1) / kGateK, rows_splits(D, H));
  auto up = [](size_t x) { return (x + 3) / 4 * 4; };
  Scratch sc;
  sc.partial = 0;
  sc.hd = sc.partial + up(n_split * N * 4 * H);
  sc.q = sc.hd + up((size_t)N * H);
  sc.part_ms = sc.q + up((size_t)N * A);
  sc.part_ctx = sc.part_ms + up((size_t)N * n_tb * 2);
  sc.counts = sc.part_ctx + up((size_t)N * n_tb * D);
  sc.floats = sc.counts + up((size_t)N);
  return sc;
}

bool aligned16(std::initializer_list<const void*> ps) {
  size_t bits = 0;
  for (const void* x : ps) bits |= reinterpret_cast<size_t>(x);
  return (bits & 15) == 0;
}

// One step's operands. parent (row n reads row parent[n] of the carry),
// keep and gates_out may be null; q is where the step's query goes.
struct Step {
  const float *eg, *ctx_prev, *h_prev, *c_prev, *aw_prev, *w_ctx, *w_h, *bias, *w_q, *conv_w,
      *w_f, *v, *kc, *values;
  const int *klens, *parent;
  const float* keep;
  float *scratch, *q, *h_out, *c_out, *gates_out, *aw_out, *ctx_out;
  int N, T, H, D, A, C, K;
  bool count_blocks;  // a decode step: las_cell zeroes las_attend's counters
};

// Launches the kernels of a chain and counts them.
struct Chain {
  bool chained;  // as programmatic dependent launches
  cudaStream_t stream;
  int* launched;
  template <typename Kernel, typename... Args>
  cudaError_t run(Kernel kernel, dim3 grid, int threads, size_t smem, Args... args) const {
    const cudaError_t e = launch_kernel(chained, kernel, grid, threads, smem, stream, args...);
    if (e == cudaSuccess) *launched += 1;
    return e;
  }
};

// The rows' block counters of las_attend, where the step uses them (a
// decode step: K3's steps have no use for them).
unsigned* counts_of(const Step& st, const Scratch& sc) {
  return st.count_blocks ? reinterpret_cast<unsigned*>(st.scratch + sc.counts) : nullptr;
}

// las_gates (any number of rows, 32 at a time) and las_cell.
cudaError_t gates_and_cell(const Chain& ch, const Step& st) {
  const Scratch sc = carve(st.N, st.T, st.H, st.D, st.A);
  float* partial = st.scratch + sc.partial;
  const int G = 4 * st.H, N = st.N;
  const int n_split = (st.D + st.H + kGateK - 1) / kGateK;
  const size_t g_smem = sizeof(float) * kGateSmemFloats;
  cudaError_t err;
  if ((err = allow_smem<las_gates>(g_smem)) != cudaSuccess) return err;
  const bool vec = st.D % 4 == 0 && st.H % 4 == 0 &&
                   aligned16({st.ctx_prev, st.h_prev, st.w_ctx, st.w_h, partial});
  const dim3 grid((G + kGateCols - 1) / kGateCols, n_split, (N + kGateN - 1) / kGateN);
  if ((err = ch.run(las_gates, grid, kGateThreads, g_smem, st.ctx_prev, st.h_prev, st.parent,
                    st.w_ctx, st.w_h, partial, N, st.D, st.H, vec)) != cudaSuccess)
    return err;
  return ch.run(las_cell, (N * st.H + kCellThreads - 1) / kCellThreads, kCellThreads, 0, st.eg,
                st.bias, partial, st.c_prev, st.parent, st.keep, st.h_out, st.scratch + sc.hd,
                st.c_out, st.gates_out, counts_of(st, sc), N, st.H, n_split);
}

// las_attend_part and las_attend_combine: any number of frames.
cudaError_t attend_in_two(const Chain& ch, const Step& st) {
  const Scratch sc = carve(st.N, st.T, st.H, st.D, st.A);
  float* part_ms = st.scratch + sc.part_ms;
  float* part_ctx = st.scratch + sc.part_ctx;
  const int n_tb = (st.T + kFrames - 1) / kFrames;
  const size_t a_smem = sizeof(float) * attend_smem_floats(st.D, st.A, st.C, st.K);
  cudaError_t err;
  if ((err = allow_smem<las_attend_part>(a_smem)) != cudaSuccess) return err;
  if ((err = ch.run(las_attend_part, dim3(n_tb, st.N), kThreads, a_smem, st.q, st.aw_prev,
                    st.parent, st.conv_w, st.w_f, st.v, st.kc, st.values, st.klens, st.aw_out,
                    part_ms, part_ctx, st.T, st.D, st.A, st.C, st.K)) != cudaSuccess)
    return err;
  const size_t c_smem = sizeof(float) * n_tb;
  if ((err = allow_smem<las_attend_combine>(c_smem)) != cudaSuccess) return err;
  return ch.run(las_attend_combine, dim3(st.N, kCombineSlices), kCombineThreads, c_smem,
                st.klens, part_ms, part_ctx, st.aw_out, st.ctx_out, st.T, st.D);
}

// q = hd W_q^T.
cudaError_t query(const Chain& ch, const Step& st) {
  const float* hd = st.scratch + carve(st.N, st.T, st.H, st.D, st.A).hd;
  const size_t q_smem = sizeof(float) * kQueryRows * st.H;
  const cudaError_t err = allow_smem<las_query>(q_smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((st.A + kWarps - 1) / kWarps, (st.N + kQueryRows - 1) / kQueryRows);
  const bool vec = st.H % 4 == 0 && aligned16({hd, st.w_q});
  return ch.run(las_query, grid, kThreads, q_smem, hd, st.w_q, st.q, st.N, st.H, st.A, vec);
}

// A step of the teacher-forced scan (K3): five kernels as programmatic
// dependent launches (see the top of the file).
cudaError_t scan_step(const Step& st, int* launched, cudaStream_t s) {
  const Chain ch{true, s, launched};
  cudaError_t err;
  if ((err = gates_and_cell(ch, st)) != cudaSuccess) return err;
  if ((err = query(ch, st)) != cudaSuccess) return err;
  return attend_in_two(ch, st);
}

// las_gates_rows<NR> and las_cell, for at most kRowsMax rows.
template <int NR>
cudaError_t gates_rows_and_cell(const Chain& ch, const Step& st) {
  const Scratch sc = carve(st.N, st.T, st.H, st.D, st.A);
  float* partial = st.scratch + sc.partial;
  const int G = 4 * st.H, N = st.N;
  const int n_split = rows_splits(st.D, st.H);
  const size_t g_smem = sizeof(float) * rows_smem_floats(NR);
  cudaError_t err;
  if ((err = allow_smem<las_gates_rows<NR>>(g_smem)) != cudaSuccess) return err;
  const dim3 grid((G + kRowsCols - 1) / kRowsCols, n_split);
  if ((err = ch.run(las_gates_rows<NR>, grid, kRowsThreads, g_smem, st.ctx_prev, st.h_prev,
                    st.parent, st.w_ctx, st.w_h, partial, N, st.D, st.H)) != cudaSuccess)
    return err;
  return ch.run(las_cell, (N * st.H + kCellThreads - 1) / kCellThreads, kCellThreads, 0, st.eg,
                st.bias, partial, st.c_prev, st.parent, st.keep, st.h_out, st.scratch + sc.hd,
                st.c_out, st.gates_out, counts_of(st, sc), N, st.H, n_split);
}

// A decode step (K2), sized for a beam's rows: four kernels (see the top
// of the file) as programmatic dependent launches. More than kRowsMax rows (or weights that
// are not 16-byte aligned) take las_gates; rows of more blocks of frames
// than las_attend has room for scales take the attention in two kernels.
cudaError_t decode_step(const Step& st, int* launched, cudaStream_t s) {
  const Chain ch{true, s, launched};
  cudaError_t err;
  if (st.N > kRowsMax || !aligned16({st.w_ctx, st.w_h})) {
    err = gates_and_cell(ch, st);
  } else if (st.N > 12) {
    err = gates_rows_and_cell<16>(ch, st);
  } else if (st.N > 8) {
    err = gates_rows_and_cell<12>(ch, st);
  } else if (st.N > 4) {
    err = gates_rows_and_cell<8>(ch, st);
  } else {
    err = gates_rows_and_cell<4>(ch, st);
  }
  if (err != cudaSuccess) return err;
  if ((err = query(ch, st)) != cudaSuccess) return err;
  const int n_tb = (st.T + kFrames - 1) / kFrames;
  const size_t a_floats = attend_smem_floats(st.D, st.A, st.C, st.K);
  if ((size_t)n_tb > a_floats) return attend_in_two(ch, st);
  const Scratch sc = carve(st.N, st.T, st.H, st.D, st.A);
  const size_t a_smem = sizeof(float) * a_floats;
  if ((err = allow_smem<las_attend>(a_smem)) != cudaSuccess) return err;
  return ch.run(las_attend, dim3(n_tb, st.N), kThreads, a_smem, st.q, st.aw_prev, st.parent,
                st.conv_w, st.w_f, st.v, st.kc, st.values, st.klens, st.aw_out,
                st.scratch + sc.part_ms, st.scratch + sc.part_ctx, counts_of(st, sc), st.ctx_out,
                st.T, st.D, st.A, st.C, st.K);
}

bool bad_sizes(int N, int T, int H, int D, int A, int C, int K) {
  return N <= 0 || T <= 0 || H <= 0 || D <= 0 || A <= 0 || C <= 0 || K <= 0 || N > 65535;
}

}  // namespace

// Shared memory (bytes) the largest block of a step asks for.
extern "C" long long nsp_las_step_smem_bytes(int T, int H, int D, int A, int C, int K) {
  const size_t n_tb = (T + kFrames - 1) / kFrames;
  return (long long)(sizeof(float) *
                     max_of({kGateSmemFloats, rows_smem_floats(kRowsMax),
                             (size_t)kQueryRows * H, attend_smem_floats(D, A, C, K),
                             n_tb}));
}

// Floats of scratch a step over N rows needs (K2 and K3 alike).
extern "C" long long nsp_las_step_scratch_floats(int N, int T, int H, int D, int A) {
  return (long long)carve(N, T, H, D, A).floats;
}

#define F(x) static_cast<const float*>(x)
#define W(x) static_cast<float*>(x)

// What a decode loop fixes once for all its steps (K2's workspace form):
// the operands that do not change, the scratch, and two sets of the carry
// (h, c, aw, ctx) that the steps write in turns. Shapes as
// nsp_las_step_f32; eg [N, 4H] and parent [N] int32 are buffers the caller
// refills before a step. The layout is mirrored by a ctypes.Structure in
// ops/kernels/las_step.py.
struct NspLasStepPlan {
  const void *eg, *w_ctx, *w_h, *bias, *w_q, *conv_w, *w_f, *v, *kc, *values, *klens, *parent;
  void* scratch;
  void* h[2];
  void* c[2];
  void* aw[2];
  void* ctx[2];
  int N, T, H, D, A, C, K;
};

// One decode step from the plan: reads the carry of set `from` (0 or 1;
// row n reads row parent[n] when use_parent is not 0) and writes set
// 1 - from, so a step never writes what it reads. *launched (host memory,
// may be null) receives the number of kernels launched. Returns a
// cudaError_t.
extern "C" int nsp_las_step_plan_f32(const NspLasStepPlan* p, int from, int use_parent,
                                     void* launched, void* stream) {
  if (p == nullptr || (from != 0 && from != 1) ||
      bad_sizes(p->N, p->T, p->H, p->D, p->A, p->C, p->K))
    return (int)cudaErrorInvalidValue;
  const int to = 1 - from;
  const Step st{F(p->eg), F(p->ctx[from]), F(p->h[from]), F(p->c[from]), F(p->aw[from]),
                F(p->w_ctx), F(p->w_h), F(p->bias), F(p->w_q), F(p->conv_w), F(p->w_f), F(p->v),
                F(p->kc), F(p->values), static_cast<const int*>(p->klens),
                use_parent ? static_cast<const int*>(p->parent) : nullptr, nullptr,
                W(p->scratch), W(p->scratch) + carve(p->N, p->T, p->H, p->D, p->A).q,
                W(p->h[to]), W(p->c[to]), nullptr, W(p->aw[to]), W(p->ctx[to]),
                p->N, p->T, p->H, p->D, p->A, p->C, p->K, true};
  int count = 0;
  const cudaError_t err = decode_step(st, &count, static_cast<cudaStream_t>(stream));
  if (launched != nullptr) *static_cast<int*>(launched) = count;
  return (int)err;
}

// Rows N (hypotheses), frames T, LSTM units H, context width D, attention
// width A, conv channels C, conv width K. Shapes (row-major, contiguous):
//   eg [N, 4H], ctx_prev [N, D], h_prev [N, H], c_prev [N, H],
//   aw_prev [N, T], w_ctx [D, 4H], w_h [H, 4H], bias [4H], w_q [A, H],
//   conv_w [C, K], w_f [A, C], v [A], kc [N, T, A], values [N, T, D],
//   klens [N] int32; parent [N] int32 or null: row n reads row parent[n]
//   of ctx_prev, h_prev, c_prev and aw_prev;
//   scratch [nsp_las_step_scratch_floats(N, T, H, D, A)].
//   Outputs h_out [N, H], c_out [N, H], aw_out [N, T], ctx_out [N, D],
//   none of which may be one of the inputs. *launched (host memory, may be
//   null) receives the number of kernels launched. Returns a cudaError_t.
extern "C" int nsp_las_step_f32(const void* eg, const void* ctx_prev, const void* h_prev,
                                const void* c_prev, const void* aw_prev, const void* w_ctx,
                                const void* w_h, const void* bias, const void* w_q,
                                const void* conv_w, const void* w_f, const void* v,
                                const void* kc, const void* values, const void* klens,
                                const void* parent, void* scratch, void* h_out, void* c_out,
                                void* aw_out, void* ctx_out, void* launched, int N, int T, int H,
                                int D, int A, int C, int K, void* stream) {
  if (bad_sizes(N, T, H, D, A, C, K)) return (int)cudaErrorInvalidValue;
  const Step st{F(eg), F(ctx_prev), F(h_prev), F(c_prev), F(aw_prev), F(w_ctx), F(w_h), F(bias),
                F(w_q), F(conv_w), F(w_f), F(v), F(kc), F(values),
                static_cast<const int*>(klens), static_cast<const int*>(parent), nullptr,
                W(scratch), W(scratch) + carve(N, T, H, D, A).q, W(h_out), W(c_out), nullptr,
                W(aw_out), W(ctx_out), N, T, H, D, A, C, K, true};
  int count = 0;
  const cudaError_t err = decode_step(st, &count, static_cast<cudaStream_t>(stream));
  if (launched != nullptr) *static_cast<int*>(launched) = count;
  return (int)err;
}

// K3: U teacher-forced steps over N rows, time-major. Shapes as above,
// plus eg [U, N, 4H], keep [U, N, H] (the dropout scale of each step's
// output, 1 without dropout), the step-0 carry h0, c0 [N, H], aw0 [N, T],
// ctx0 [N, D] (zeros in training), and the outputs h_all, c_all [U, N, H],
// gates [U, N, 4H] (activations i, f, g, o), q_all [U, N, A], aw_all
// [U, N, T], ctx_all [U, N, D]. *launched (host memory) receives the
// number of kernels launched. Returns a cudaError_t.
extern "C" int nsp_las_scan_f32(const void* eg, const void* w_ctx, const void* w_h,
                                const void* bias, const void* w_q, const void* conv_w,
                                const void* w_f, const void* v, const void* kc,
                                const void* values, const void* klens, const void* keep,
                                const void* h0, const void* c0, const void* aw0,
                                const void* ctx0, void* scratch, void* h_all, void* c_all,
                                void* gates, void* q_all, void* aw_all, void* ctx_all,
                                void* launched, int U, int N, int T, int H, int D, int A, int C,
                                int K, void* stream) {
  int* count = static_cast<int*>(launched);
  *count = 0;
  if (U <= 0 || bad_sizes(N, T, H, D, A, C, K)) return (int)cudaErrorInvalidValue;
  const size_t nh = (size_t)N * H;
  for (int t = 0; t < U; ++t) {
    const bool first = t == 0;
    const size_t prev = (size_t)(t - 1);
    const Step st{F(eg) + (size_t)t * N * 4 * H,
                  first ? F(ctx0) : F(ctx_all) + prev * N * D,
                  first ? F(h0) : F(h_all) + prev * nh,
                  first ? F(c0) : F(c_all) + prev * nh,
                  first ? F(aw0) : F(aw_all) + prev * N * T,
                  F(w_ctx), F(w_h), F(bias), F(w_q), F(conv_w), F(w_f), F(v), F(kc), F(values),
                  static_cast<const int*>(klens), nullptr, F(keep) + (size_t)t * nh, W(scratch),
                  W(q_all) + (size_t)t * N * A, W(h_all) + (size_t)t * nh,
                  W(c_all) + (size_t)t * nh, W(gates) + (size_t)t * nh * 4,
                  W(aw_all) + (size_t)t * N * T, W(ctx_all) + (size_t)t * N * D,
                  N, T, H, D, A, C, K, false};
    const cudaError_t err = scan_step(st, count, static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

#undef F
#undef W
