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
// What bounds it on the H100: at decode the step is a batch-N GEMV, so it
// is bound by bytes: the gate weights ((D + H) x 4H floats, 25 MB at the
// flagship's D = 512, H = 1024) and each row's keys and values (T x (A +
// D) floats). With N = 10 rows a kernel needs more than one block per row
// to keep the 132 SMs reading, so the step is five kernels on one stream,
// each spread over ~100-400 blocks:
//   1. las_gates_partial: split-K GEMV. One thread per gate column, a
//      block per (128 columns, 128 reduction rows, 16 hypotheses); each
//      weight is read once per step, coalesced, and multiplied into all
//      the block's hypotheses held in registers.
//   2. las_cell: one thread per (hypothesis, unit) sums the partials,
//      adds eg and b, and applies the LSTM cell.
//   3. las_query: q = h W_q^T, a warp per output for 8 hypotheses.
//   4. las_energy: a block per (16 frames, hypothesis) computes the
//      frames' location features from the padded aw_prev in shared memory,
//      then their masked energies.
//   5. las_context: a block per (32 context columns, hypothesis) takes the
//      softmax of its row's energies and sums aw x values over T in 8
//      slices.
// The masked value is finfo(f32).min / 2, as in apply_mask_logits, so a
// row with no valid frame gets uniform weights.
//
// K3, the teacher-forced U-step scan of training (`nsp_las_scan_f32`,
// the U-step form of the same TPU kernel), runs these five kernels once
// per step from a host loop, with two additions: las_cell also stores the
// gate activations (i, f, g, o) for the backward, and las_query takes the
// query from the dropped output h * keep_t (dropout on the LSTM output
// feeds the attention and the readout; the carry keeps the undropped h).
// Every step's h, c, gates, query, attention weights and context stay in
// [U, N, ...] outputs, so step t reads step t-1's slots as its carry and
// the backward (K3b, las_scan.cu) has what it needs. A grid-wide sync
// across the U steps is left for later: the host loop costs five launches
// per step.

#include <cuda_runtime.h>
#include <cfloat>
#include <math.h>

namespace {

constexpr int kGateThreads = 128;  // gate columns per block
constexpr int kGateRows = 16;      // hypotheses per block (registers)
constexpr int kGateK = 128;        // reduction rows per block
constexpr int kCellThreads = 256;
constexpr int kAttnThreads = 256;
constexpr int kAttnWarps = kAttnThreads / 32;
constexpr int kQueryRows = 8;        // hypotheses per block of las_query
constexpr int kEnergyFrames = 16;    // frames per block of las_energy
constexpr int kContextCols = 32;     // context columns per block
constexpr int kContextSlices = kAttnThreads / kContextCols;
constexpr int kSmemDefault = 48 * 1024;

__device__ __forceinline__ float sigmoidf(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// partial[s, n, col] = sum_{k in split s} x[n, k] W[k, col], x = [ctx_prev, h_prev],
// W = [W_ctx; W_h] ([D + H, G], G = 4H, row-major).
__global__ void __launch_bounds__(kGateThreads)
las_gates_partial(const float* __restrict__ ctx_prev, const float* __restrict__ h_prev,
                  const float* __restrict__ w_ctx, const float* __restrict__ w_h,
                  float* __restrict__ partial, int N, int D, int H) {
  __shared__ float xs[kGateRows][kGateK];
  const int G = 4 * H;
  const int col = blockIdx.x * kGateThreads + threadIdx.x;
  const int split = blockIdx.y;
  const int n0 = blockIdx.z * kGateRows;
  const int kbeg = split * kGateK;
  const int kn = min(kGateK, D + H - kbeg);

  for (int idx = threadIdx.x; idx < kGateRows * kGateK; idx += kGateThreads) {
    const int r = idx / kGateK, kk = idx % kGateK;
    const int n = n0 + r, kg = kbeg + kk;
    float val = 0.0f;
    if (n < N && kk < kn) val = (kg < D) ? ctx_prev[(size_t)n * D + kg] : h_prev[(size_t)n * H + (kg - D)];
    xs[r][kk] = val;
  }
  __syncthreads();
  if (col >= G) return;

  float acc[kGateRows];
#pragma unroll
  for (int r = 0; r < kGateRows; ++r) acc[r] = 0.0f;
  for (int kk = 0; kk < kn; ++kk) {
    const int kg = kbeg + kk;
    const float w = (kg < D) ? w_ctx[(size_t)kg * G + col] : w_h[(size_t)(kg - D) * G + col];
#pragma unroll
    for (int r = 0; r < kGateRows; ++r) acc[r] += xs[r][kk] * w;
  }
#pragma unroll
  for (int r = 0; r < kGateRows; ++r) {
    const int n = n0 + r;
    if (n < N) partial[((size_t)split * N + n) * G + col] = acc[r];
  }
}

__global__ void __launch_bounds__(kCellThreads)
las_cell(const float* __restrict__ eg, const float* __restrict__ bias,
         const float* __restrict__ partial, const float* __restrict__ c_prev,
         float* __restrict__ h_out, float* __restrict__ c_out, float* __restrict__ gates_out,
         int N, int H, int n_split) {
  const int idx = blockIdx.x * kCellThreads + threadIdx.x;
  if (idx >= N * H) return;
  const int n = idx / H, j = idx % H;
  const int G = 4 * H;
  float y[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const int col = g * H + j;
    float s = 0.0f;
    for (int sp = 0; sp < n_split; ++sp) s += partial[((size_t)sp * N + n) * G + col];
    y[g] = eg[(size_t)n * G + col] + s + bias[col];
  }
  const float ig = sigmoidf(y[0]), fg = sigmoidf(y[1]), gg = tanhf(y[2]), og = sigmoidf(y[3]);
  if (gates_out != nullptr) {
    float* gt = gates_out + (size_t)n * G + j;
    gt[0] = ig;
    gt[H] = fg;
    gt[2 * H] = gg;
    gt[3 * H] = og;
  }
  const float c = fg * c_prev[idx] + ig * gg;
  c_out[idx] = c;
  h_out[idx] = og * tanhf(c);
}

// q[n, a] = sum_k h[n, k] keep[n, k] w_q[a, k] (w_q is [A, H]; keep may
// be null: no dropout): a warp per output a for kQueryRows hypotheses at
// once, lanes along H, so each weight row is read once per block.
__global__ void __launch_bounds__(kAttnThreads)
las_query(const float* __restrict__ h, const float* __restrict__ keep,
          const float* __restrict__ w_q, float* __restrict__ q, int N, int H, int A) {
  extern __shared__ float hs[];  // [kQueryRows][H]
  const int n0 = blockIdx.y * kQueryRows;
  const int rows = min(kQueryRows, N - n0);
  for (int i = threadIdx.x; i < kQueryRows * H; i += kAttnThreads) {
    const int r = i / H;
    const size_t at = (size_t)(n0 + r) * H + (i % H);
    hs[i] = (r < rows) ? h[at] * (keep != nullptr ? keep[at] : 1.0f) : 0.0f;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int a = blockIdx.x * kAttnWarps + (threadIdx.x >> 5);
  if (a >= A) return;
  const float* row = w_q + (size_t)a * H;
  float acc[kQueryRows];
#pragma unroll
  for (int r = 0; r < kQueryRows; ++r) acc[r] = 0.0f;
  for (int k = lane; k < H; k += 32) {
    const float w = row[k];
#pragma unroll
    for (int r = 0; r < kQueryRows; ++r) acc[r] += w * hs[r * H + k];
  }
#pragma unroll
  for (int r = 0; r < kQueryRows; ++r) {
    const float s = warp_sum(acc[r]);
    if (lane == 0 && r < rows) q[(size_t)(n0 + r) * A + a] = s;
  }
}

// Shared memory of las_energy, in floats.
__host__ __device__ inline size_t energy_smem_floats(int A, int C, int K) {
  return 2 * (size_t)A + (size_t)C * A + (size_t)C * K + (kEnergyFrames + K - 1) +
         (size_t)kEnergyFrames * C;
}

// e[n, t] for kEnergyFrames frames of one hypothesis: the location
// features of those frames (cross-correlation of the zero-padded aw_prev,
// left pad (K-1)/2), then v . tanh(kc + q + loc W_f) with a warp per
// frame, lanes along A. Masked frames get finfo(f32).min / 2.
__global__ void __launch_bounds__(kAttnThreads)
las_energy(const float* __restrict__ q, const float* __restrict__ aw_prev,
           const float* __restrict__ conv_w, const float* __restrict__ w_f,
           const float* __restrict__ v, const float* __restrict__ kc,
           const int* __restrict__ klens, float* __restrict__ e,
           int T, int A, int C, int K) {
  extern __shared__ float smem[];
  float* qs = smem;                          // [A]
  float* vs = qs + A;                        // [A]
  float* wft = vs + A;                       // [C][A]  (W_f transposed)
  float* cw = wft + (size_t)C * A;           // [C][K]
  float* awp = cw + (size_t)C * K;           // [kEnergyFrames + K - 1]
  float* loc = awp + (kEnergyFrames + K - 1);  // [kEnergyFrames][C]

  const int n = blockIdx.y;
  const int t0 = blockIdx.x * kEnergyFrames;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int left = (K - 1) / 2;
  for (int i = tid; i < A; i += kAttnThreads) {
    qs[i] = q[(size_t)n * A + i];
    vs[i] = v[i];
  }
  for (int i = tid; i < C * A; i += kAttnThreads) {
    const int a = i / C, c = i % C;  // w_f is [A, C]
    wft[c * A + a] = w_f[i];
  }
  for (int i = tid; i < C * K; i += kAttnThreads) cw[i] = conv_w[i];
  for (int i = tid; i < kEnergyFrames + K - 1; i += kAttnThreads) {
    const int t = t0 + i - left;
    awp[i] = (t >= 0 && t < T) ? aw_prev[(size_t)n * T + t] : 0.0f;
  }
  __syncthreads();
  for (int i = tid; i < kEnergyFrames * C; i += kAttnThreads) {
    const int tl = i / C, c = i % C;
    const float* w = cw + (size_t)c * K;
    const float* x = awp + tl;
    float s = 0.0f;
    for (int kk = 0; kk < K; ++kk) s += x[kk] * w[kk];
    loc[i] = s;
  }
  __syncthreads();
  const float kNeg = -FLT_MAX / 2.0f;
  const int klen = klens[n];
  for (int tl = warp; tl < kEnergyFrames; tl += kAttnWarps) {
    const int t = t0 + tl;
    if (t >= T) break;
    const float* kct = kc + ((size_t)n * T + t) * A;
    const float* lt = loc + (size_t)tl * C;
    float s = 0.0f;
    for (int a = lane; a < A; a += 32) {
      float f = 0.0f;
      for (int c = 0; c < C; ++c) f += lt[c] * wft[c * A + a];
      s += vs[a] * tanhf(kct[a] + qs[a] + f);
    }
    s = warp_sum(s);
    if (lane == 0) e[(size_t)n * T + t] = (t < klen) ? s : kNeg;
  }
}

// Masked softmax over T and ctx[n, d] = sum_t aw[t] values[n, t, d] for
// kContextCols columns: thread (slice, col) sums every kContextSlices-th
// frame, the slices meet in shared memory. Blocks with blockIdx.x == 0
// also write aw.
__global__ void __launch_bounds__(kAttnThreads)
las_context(const float* __restrict__ e, const float* __restrict__ values,
            float* __restrict__ aw_out, float* __restrict__ ctx_out, int T, int D) {
  extern __shared__ float smem[];
  float* aw = smem;        // [T]
  float* red = aw + T;     // [kAttnWarps]
  float* part = red + kAttnWarps;  // [kContextSlices][kContextCols]
  const int n = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  float m = -INFINITY;
  for (int t = tid; t < T; t += kAttnThreads) {
    const float x = e[(size_t)n * T + t];
    aw[t] = x;
    m = fmaxf(m, x);
  }
  m = warp_max(m);
  if (lane == 0) red[warp] = m;
  __syncthreads();
  m = red[0];
  for (int w = 1; w < kAttnWarps; ++w) m = fmaxf(m, red[w]);
  __syncthreads();
  float sum = 0.0f;
  for (int t = tid; t < T; t += kAttnThreads) {
    const float x = expf(aw[t] - m);
    aw[t] = x;
    sum += x;
  }
  sum = warp_sum(sum);
  if (lane == 0) red[warp] = sum;
  __syncthreads();
  sum = 0.0f;
  for (int w = 0; w < kAttnWarps; ++w) sum += red[w];
  for (int t = tid; t < T; t += kAttnThreads) {
    const float a = aw[t] / sum;
    aw[t] = a;
    if (blockIdx.x == 0) aw_out[(size_t)n * T + t] = a;
  }
  __syncthreads();

  const int col = tid % kContextCols, slice = tid / kContextCols;
  const int d = blockIdx.x * kContextCols + col;
  float s = 0.0f;
  if (d < D) {
    const float* vb = values + (size_t)n * T * D + d;
    for (int t = slice; t < T; t += kContextSlices) s += aw[t] * vb[(size_t)t * D];
  }
  part[slice * kContextCols + col] = s;
  __syncthreads();
  if (slice == 0 && d < D) {
    float c = 0.0f;
    for (int sl = 0; sl < kContextSlices; ++sl) c += part[sl * kContextCols + col];
    ctx_out[(size_t)n * D + d] = c;
  }
}

}  // namespace

// Shared memory (bytes) the largest block of a step asks for.
extern "C" long long nsp_las_step_smem_bytes(int T, int H, int A, int C, int K) {
  const size_t q = (size_t)kQueryRows * H;
  const size_t e = energy_smem_floats(A, C, K);
  const size_t c = (size_t)T + kAttnWarps + kContextSlices * kContextCols;
  return (long long)(sizeof(float) * (q > e ? (q > c ? q : c) : (e > c ? e : c)));
}

namespace {
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= kSmemDefault) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}
}  // namespace

namespace {

// The five kernels of one step (see the top of the file); keep and
// gates_out may be null.
cudaError_t las_step(const float* eg, const float* ctx_prev, const float* h_prev,
                     const float* c_prev, const float* aw_prev, const float* w_ctx,
                     const float* w_h, const float* bias, const float* w_q, const float* conv_w,
                     const float* w_f, const float* v, const float* kc, const float* values,
                     const int* klens, const float* keep, float* partial, float* q, float* e,
                     float* h_out, float* c_out, float* gates_out, float* aw_out, float* ctx_out,
                     int N, int T, int H, int D, int A, int C, int K, cudaStream_t s) {
  const int G = 4 * H;
  const int n_split = (D + H + kGateK - 1) / kGateK;
  dim3 g_gates((G + kGateThreads - 1) / kGateThreads, n_split, (N + kGateRows - 1) / kGateRows);
  las_gates_partial<<<g_gates, kGateThreads, 0, s>>>(ctx_prev, h_prev, w_ctx, w_h, partial, N,
                                                     D, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  las_cell<<<(N * H + kCellThreads - 1) / kCellThreads, kCellThreads, 0, s>>>(
      eg, bias, partial, c_prev, h_out, c_out, gates_out, N, H, n_split);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t q_smem = sizeof(float) * kQueryRows * H;
  if ((err = allow_smem(las_query, q_smem)) != cudaSuccess) return err;
  dim3 g_query((A + kAttnWarps - 1) / kAttnWarps, (N + kQueryRows - 1) / kQueryRows);
  las_query<<<g_query, kAttnThreads, q_smem, s>>>(h_out, keep, w_q, q, N, H, A);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t e_smem = sizeof(float) * energy_smem_floats(A, C, K);
  if ((err = allow_smem(las_energy, e_smem)) != cudaSuccess) return err;
  dim3 g_energy((T + kEnergyFrames - 1) / kEnergyFrames, N);
  las_energy<<<g_energy, kAttnThreads, e_smem, s>>>(q, aw_prev, conv_w, w_f, v, kc, klens, e,
                                                    T, A, C, K);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t c_smem = sizeof(float) * ((size_t)T + kAttnWarps + kContextSlices * kContextCols);
  if ((err = allow_smem(las_context, c_smem)) != cudaSuccess) return err;
  dim3 g_ctx((D + kContextCols - 1) / kContextCols, N);
  las_context<<<g_ctx, kAttnThreads, c_smem, s>>>(e, values, aw_out, ctx_out, T, D);
  return cudaGetLastError();
}

bool bad_sizes(int N, int T, int H, int D, int A, int C, int K) {
  return N <= 0 || T <= 0 || H <= 0 || D <= 0 || A <= 0 || C <= 0 || K <= 0 || N > 65535;
}

}  // namespace

#define F(x) static_cast<const float*>(x)
#define W(x) static_cast<float*>(x)

// Rows N (hypotheses), frames T, LSTM units H, context width D, attention
// width A, conv channels C, conv width K. Shapes (row-major, contiguous):
//   eg [N, 4H], ctx_prev [N, D], h_prev [N, H], c_prev [N, H],
//   aw_prev [N, T], w_ctx [D, 4H], w_h [H, 4H], bias [4H], w_q [A, H],
//   conv_w [C, K], w_f [A, C], v [A], kc [N, T, A], values [N, T, D],
//   klens [N] int32; scratch partial [ceil((D + H) / 128), N, 4H],
//   q [N, A], e [N, T]. Outputs h_out [N, H], c_out [N, H], aw_out [N, T],
//   ctx_out [N, D]. Returns a cudaError_t.
extern "C" int nsp_las_step_f32(const void* eg, const void* ctx_prev, const void* h_prev,
                                const void* c_prev, const void* aw_prev, const void* w_ctx,
                                const void* w_h, const void* bias, const void* w_q,
                                const void* conv_w, const void* w_f, const void* v,
                                const void* kc, const void* values, const void* klens,
                                void* partial, void* q, void* e, void* h_out, void* c_out,
                                void* aw_out, void* ctx_out, int N, int T, int H, int D,
                                int A, int C, int K, void* stream) {
  if (bad_sizes(N, T, H, D, A, C, K)) return (int)cudaErrorInvalidValue;
  return (int)las_step(F(eg), F(ctx_prev), F(h_prev), F(c_prev), F(aw_prev), F(w_ctx), F(w_h),
                       F(bias), F(w_q), F(conv_w), F(w_f), F(v), F(kc), F(values),
                       static_cast<const int*>(klens), nullptr, W(partial), W(q), W(e),
                       W(h_out), W(c_out), nullptr, W(aw_out), W(ctx_out), N, T, H, D, A, C, K,
                       static_cast<cudaStream_t>(stream));
}

// K3: U teacher-forced steps over N rows, time-major. Shapes as above,
// plus eg [U, N, 4H], keep [U, N, H] (the dropout scale of each step's
// output, 1 without dropout), the step-0 carry h0, c0 [N, H], aw0 [N, T],
// ctx0 [N, D] (zeros in training), and the outputs h_all, c_all [U, N, H],
// gates [U, N, 4H] (activations i, f, g, o), q_all [U, N, A], aw_all
// [U, N, T], ctx_all [U, N, D]. Returns a cudaError_t.
extern "C" int nsp_las_scan_f32(const void* eg, const void* w_ctx, const void* w_h,
                                const void* bias, const void* w_q, const void* conv_w,
                                const void* w_f, const void* v, const void* kc,
                                const void* values, const void* klens, const void* keep,
                                const void* h0, const void* c0, const void* aw0,
                                const void* ctx0, void* partial, void* e, void* h_all,
                                void* c_all, void* gates, void* q_all, void* aw_all,
                                void* ctx_all, int U, int N, int T, int H, int D, int A, int C,
                                int K, void* stream) {
  if (U <= 0 || bad_sizes(N, T, H, D, A, C, K)) return (int)cudaErrorInvalidValue;
  const size_t nh = (size_t)N * H;
  for (int t = 0; t < U; ++t) {
    const bool first = t == 0;
    const size_t prev = (size_t)(t - 1);
    cudaError_t err = las_step(
        F(eg) + (size_t)t * N * 4 * H,
        first ? F(ctx0) : F(ctx_all) + prev * N * D,
        first ? F(h0) : F(h_all) + prev * nh,
        first ? F(c0) : F(c_all) + prev * nh,
        first ? F(aw0) : F(aw_all) + prev * N * T,
        F(w_ctx), F(w_h), F(bias), F(w_q), F(conv_w), F(w_f), F(v), F(kc), F(values),
        static_cast<const int*>(klens), F(keep) + (size_t)t * nh, W(partial),
        W(q_all) + (size_t)t * N * A, W(e), W(h_all) + (size_t)t * nh,
        W(c_all) + (size_t)t * nh, W(gates) + (size_t)t * nh * 4, W(aw_all) + (size_t)t * N * T,
        W(ctx_all) + (size_t)t * N * D, N, T, H, D, A, C, K, static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

#undef F
#undef W
