// K3b: backward of the teacher-forced LAS scan (LSTM layer 0 + location
// attention, K3 in las_step.cu), float32, for sm_90a.
//
// Replaces the TPU kernel `_bwd_kernel` of neural_sp_tpu/ops/
// las_scan_pallas.py (last present at 63255ae~1), reached through `_bwd`.
// It walks the steps in reverse, carrying dh, dc, dctx and daw, and per
// step t (rows n in parallel):
//   dctx  = dctx_out[t] + dctx_carry
//   daw   = daw_carry + values . dctx          dvalues += aw_t dctx
//   de    = aw_t (daw - sum(aw_t daw)), 0 on masked frames
//   z     = kc + q_t + loc W_f^T,  s = tanh(z) (recomputed; loc from aw_{t-1})
//   dz    = de v (1 - s^2):  dkc += dz, dq_t = sum_T dz, dv += de s,
//           dW_f += dz loc, dloc = dz W_f
//   daw_carry = conv^T(dloc)                   dconv += dloc x aw_{t-1}
//   dh    = dh_out[t] + (dq_t W_q) keep_t + dh_carry   (query from h * keep)
//   LSTM adjoint from the saved gates and c:  dy_t [4H], dc_carry = dc f
//   dh_carry = dy_t W_h^T,  dctx_carry = dy_t W_ctx^T  (in-kernel GEMV)
// dy_t and dq_t are streamed out; the step-invariant weight gradients
// dW_h, dW_ctx, b, dW_q are reduced outside as single matmuls over all
// steps, as the Pallas `_bwd` did. dv, dW_f and dconv are summed into
// per-block partial buffers (each block owns its slot across the steps,
// so no atomics) and reduced outside; dkc and dvalues are owned per
// element and accumulated in place.
//
// What bounds it on the H100: as the forward, a step is small (B rows):
// the recurrent GEMV reads the 25 MB of gate weights once per row tile,
// and the attention part reads kc and values (B x T x (A + D) floats) and
// rewrites dkc and dvalues. The first design keeps to six kernels per step
// from a host loop, each spread over ~100-400 blocks at the flagship's
// training shape (B = 32, T = 188).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFrames = 16;     // frames per block of the energy / conv kernels
constexpr int kRows = 16;       // rows per block of the query / recurrent kernels
constexpr int kColThreads = 128;
constexpr int kChunk = 256;     // gate columns per shared-memory chunk

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// daw[n, t'] = daw_carry[n, t'] + values[n, t', :] . dctx[n, :],
// dvalues[n, t', :] += aw[n, t'] dctx[n, :], dctx = dctx_out + dctx_carry.
// A block per (kWarps frames, row n), a warp per frame, lanes along D.
__global__ void __launch_bounds__(kThreads)
bwd_context(const float* __restrict__ dctx_out, const float* __restrict__ dctx_c,
            const float* __restrict__ daw_c, const float* __restrict__ values,
            const float* __restrict__ aw, float* __restrict__ daw,
            float* __restrict__ dvalues, int T, int D) {
  extern __shared__ float dctx[];  // [D]
  const int n = blockIdx.y;
  for (int d = threadIdx.x; d < D; d += kThreads)
    dctx[d] = dctx_out[(size_t)n * D + d] + dctx_c[(size_t)n * D + d];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (t >= T) return;
  const size_t row = (size_t)n * T + t;
  const float a = aw[row];
  const float* vb = values + row * D;
  float* dvb = dvalues + row * D;
  float s = 0.0f;
  for (int d = lane; d < D; d += 32) {
    s += vb[d] * dctx[d];
    dvb[d] += a * dctx[d];
  }
  s = warp_sum(s);
  if (lane == 0) daw[row] = daw_c[row] + s;
}

// de = aw (daw - sum(aw daw)) on frames < klens[n], 0 elsewhere.
__global__ void __launch_bounds__(kThreads)
bwd_softmax(const float* __restrict__ aw, const float* __restrict__ daw,
            const int* __restrict__ klens, float* __restrict__ de, int T) {
  __shared__ float red[kWarps];
  const int n = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* awb = aw + (size_t)n * T;
  const float* dab = daw + (size_t)n * T;
  float s = 0.0f;
  for (int t = threadIdx.x; t < T; t += kThreads) s += awb[t] * dab[t];
  s = warp_sum(s);
  if (lane == 0) red[warp] = s;
  __syncthreads();
  s = 0.0f;
  for (int w = 0; w < kWarps; ++w) s += red[w];
  const int klen = klens[n];
  for (int t = threadIdx.x; t < T; t += kThreads)
    de[(size_t)n * T + t] = (t < klen) ? awb[t] * (dab[t] - s) : 0.0f;
}

// Shared memory of bwd_energy, in floats.
__host__ __device__ inline size_t energy_bwd_smem_floats(int A, int C, int K) {
  return 2 * (size_t)A + (size_t)C * A + (size_t)C * K + (kFrames + K - 1) +
         (size_t)kFrames * C + 2 * (size_t)kFrames * A + kFrames;
}

// A block per (kFrames frames, row n): recompute the location features and
// tanh(z) of its frames, then dz, dkc (in place), dloc (to global), and
// the block's sums of dq (dq_part, per step), dv and dW_f (partials owned
// by this block across the steps).
__global__ void __launch_bounds__(kThreads)
bwd_energy(const float* __restrict__ q, const float* __restrict__ aw_prev,
           const float* __restrict__ conv_w, const float* __restrict__ w_f,
           const float* __restrict__ v, const float* __restrict__ kc,
           const float* __restrict__ de, float* __restrict__ dkc,
           float* __restrict__ dloc, float* __restrict__ dq_part,
           float* __restrict__ dv_part, float* __restrict__ dwf_part,
           int N, int T, int A, int C, int K) {
  extern __shared__ float smem[];
  float* qs = smem;                          // [A]
  float* vs = qs + A;                        // [A]
  float* wft = vs + A;                       // [C][A]
  float* cw = wft + (size_t)C * A;           // [C][K]
  float* awp = cw + (size_t)C * K;           // [kFrames + K - 1]
  float* loc = awp + (kFrames + K - 1);      // [kFrames][C]
  float* dzs = loc + (size_t)kFrames * C;    // [kFrames][A]
  float* dvs = dzs + (size_t)kFrames * A;    // [kFrames][A]
  float* des = dvs + (size_t)kFrames * A;    // [kFrames]

  const int n = blockIdx.y, tb = blockIdx.x;
  const int t0 = tb * kFrames;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int left = (K - 1) / 2;
  for (int i = tid; i < A; i += kThreads) {
    qs[i] = q[(size_t)n * A + i];
    vs[i] = v[i];
  }
  for (int i = tid; i < C * A; i += kThreads) {
    const int a = i / C, c = i % C;  // w_f is [A, C]
    wft[c * A + a] = w_f[i];
  }
  for (int i = tid; i < C * K; i += kThreads) cw[i] = conv_w[i];
  for (int i = tid; i < kFrames + K - 1; i += kThreads) {
    const int t = t0 + i - left;
    awp[i] = (t >= 0 && t < T) ? aw_prev[(size_t)n * T + t] : 0.0f;
  }
  for (int i = tid; i < kFrames; i += kThreads) {
    const int t = t0 + i;
    des[i] = (t < T) ? de[(size_t)n * T + t] : 0.0f;
  }
  __syncthreads();
  for (int i = tid; i < kFrames * C; i += kThreads) {
    const int tl = i / C, c = i % C;
    const float* w = cw + (size_t)c * K;
    const float* x = awp + tl;
    float s = 0.0f;
    for (int kk = 0; kk < K; ++kk) s += x[kk] * w[kk];
    loc[i] = s;
  }
  __syncthreads();
  for (int tl = warp; tl < kFrames; tl += kWarps) {
    const int t = t0 + tl;
    const float* lt = loc + (size_t)tl * C;
    const float e = des[tl];
    for (int a = lane; a < A; a += 32) {
      float dz = 0.0f, dvv = 0.0f;
      if (t < T) {
        const size_t at = ((size_t)n * T + t) * A + a;
        float f = 0.0f;
        for (int c = 0; c < C; ++c) f += lt[c] * wft[c * A + a];
        const float sv = tanhf(kc[at] + qs[a] + f);
        dz = e * vs[a] * (1.0f - sv * sv);
        dvv = e * sv;
        dkc[at] += dz;
      }
      dzs[(size_t)tl * A + a] = dz;
      dvs[(size_t)tl * A + a] = dvv;
    }
  }
  __syncthreads();
  const size_t nb = (size_t)n * gridDim.x + tb;
  for (int i = tid; i < kFrames * C; i += kThreads) {
    const int tl = i / C, c = i % C, t = t0 + tl;
    if (t >= T) continue;
    const float* dz = dzs + (size_t)tl * A;
    const float* w = wft + (size_t)c * A;
    float s = 0.0f;
    for (int a = 0; a < A; ++a) s += dz[a] * w[a];
    dloc[((size_t)n * T + t) * C + c] = s;
  }
  for (int a = tid; a < A; a += kThreads) {
    float sq = 0.0f, sv = 0.0f;
    for (int tl = 0; tl < kFrames; ++tl) {
      sq += dzs[(size_t)tl * A + a];
      sv += dvs[(size_t)tl * A + a];
    }
    dq_part[((size_t)tb * N + n) * A + a] = sq;
    dv_part[nb * A + a] += sv;
  }
  for (int i = tid; i < A * C; i += kThreads) {
    const int a = i / C, c = i % C;
    float s = 0.0f;
    for (int tl = 0; tl < kFrames; ++tl) s += dzs[(size_t)tl * A + a] * loc[tl * C + c];
    dwf_part[nb * A * C + i] += s;
  }
}

// Shared memory of bwd_conv, in floats.
__host__ __device__ inline size_t conv_bwd_smem_floats(int C, int K) {
  return (size_t)C * K + (size_t)C * (kFrames + K - 1) + (kFrames + K - 1) +
         (size_t)kFrames * C;
}

// A block per (kFrames frames, row n): daw_carry[n, tau] = sum_c sum_k
// dloc[n, tau + left - k, c] conv[c, k] for the block's frames tau, and the
// block's sum of dconv[c, k] = sum_t' dloc[n, t', c] aw_prev[n, t' + k -
// left] (into its own partial).
__global__ void __launch_bounds__(kThreads)
bwd_conv(const float* __restrict__ dloc, const float* __restrict__ aw_prev,
         const float* __restrict__ conv_w, float* __restrict__ daw_c,
         float* __restrict__ dconv_part, int T, int C, int K) {
  extern __shared__ float smem[];
  const int W = kFrames + K - 1;
  float* cw = smem;                       // [C][K]
  float* win = cw + (size_t)C * K;        // [C][W]: dloc at frames w0 + i
  float* awp = win + (size_t)C * W;       // [W]: aw_prev at frames t0 - left + i
  float* part = awp + W;                  // [kFrames][C]
  const int n = blockIdx.y, tb = blockIdx.x;
  const int t0 = tb * kFrames;
  const int left = (K - 1) / 2;
  const int w0 = t0 + left - (K - 1);
  const int tid = threadIdx.x;
  for (int i = tid; i < C * K; i += kThreads) cw[i] = conv_w[i];
  for (int i = tid; i < C * W; i += kThreads) {
    const int c = i / W, f = w0 + i % W;
    win[i] = (f >= 0 && f < T) ? dloc[((size_t)n * T + f) * C + c] : 0.0f;
  }
  for (int i = tid; i < W; i += kThreads) {
    const int t = t0 + i - left;
    awp[i] = (t >= 0 && t < T) ? aw_prev[(size_t)n * T + t] : 0.0f;
  }
  __syncthreads();
  // frame tau = t0 + tl takes dloc at frame tau + left - k = window index
  // tl + K - 1 - k
  for (int i = tid; i < kFrames * C; i += kThreads) {
    const int tl = i / C, c = i % C;
    const float* w = cw + (size_t)c * K;
    const float* x = win + (size_t)c * W + tl + K - 1;
    float s = 0.0f;
    for (int kk = 0; kk < K; ++kk) s += x[-kk] * w[kk];
    part[i] = s;
  }
  const size_t nb = (size_t)n * gridDim.x + tb;
  // frame t' = t0 + tl sits at window index tl + K - 1 - left
  for (int i = tid; i < C * K; i += kThreads) {
    const int c = i / K, kk = i % K;
    const float* x = win + (size_t)c * W + K - 1 - left;
    float s = 0.0f;
    for (int tl = 0; tl < kFrames; ++tl) s += x[tl] * awp[tl + kk];
    dconv_part[nb * C * K + i] += s;
  }
  __syncthreads();
  for (int tl = tid; tl < kFrames; tl += kThreads) {
    const int t = t0 + tl;
    if (t >= T) continue;
    float s = 0.0f;
    for (int c = 0; c < C; ++c) s += part[tl * C + c];
    daw_c[(size_t)n * T + t] = s;
  }
}

__device__ __forceinline__ float sig_d(float g) { return g * (1.0f - g); }

// A block per (kColThreads units, kRows rows): dq_t = sum of the energy
// blocks' dq parts (written to dq_all by the first column block),
// dquery = dq_t W_q, then the LSTM cell adjoint of each (row, unit): dy_t
// and the dc carry.
__global__ void __launch_bounds__(kColThreads)
bwd_query_cell(const float* __restrict__ dq_part, const float* __restrict__ w_q,
               const float* __restrict__ gates, const float* __restrict__ c_t,
               const float* __restrict__ c_prev, const float* __restrict__ keep,
               const float* __restrict__ dh_out, const float* __restrict__ dh_c,
               float* __restrict__ dc_c, float* __restrict__ dy, float* __restrict__ dq,
               int N, int H, int A, int n_tb) {
  extern __shared__ float dqs[];  // [kRows][A]
  const int n0 = blockIdx.y * kRows;
  const int rows = min(kRows, N - n0);
  for (int i = threadIdx.x; i < kRows * A; i += kColThreads) {
    const int r = i / A, a = i % A;
    float s = 0.0f;
    if (r < rows)
      for (int tb = 0; tb < n_tb; ++tb) s += dq_part[((size_t)tb * N + n0 + r) * A + a];
    dqs[i] = s;
    if (blockIdx.x == 0 && r < rows) dq[(size_t)(n0 + r) * A + a] = s;
  }
  __syncthreads();
  const int j = blockIdx.x * kColThreads + threadIdx.x;
  if (j >= H) return;
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
  for (int a = 0; a < A; ++a) {
    const float w = w_q[(size_t)a * H + j];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] += dqs[r * A + a] * w;
  }
  const int G = 4 * H;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r >= rows) break;
    const int n = n0 + r;
    const size_t at = (size_t)n * H + j;
    const float* g = gates + (size_t)n * G + j;
    const float gi = g[0], gf = g[H], gg = g[2 * H], go = g[3 * H];
    const float dh = dh_out[at] + acc[r] * keep[at] + dh_c[at];
    const float tc = tanhf(c_t[at]);
    const float dc = dc_c[at] + dh * go * (1.0f - tc * tc);
    const float cp = (c_prev != nullptr) ? c_prev[at] : 0.0f;
    float* dyb = dy + (size_t)n * G + j;
    dyb[0] = dc * gg * sig_d(gi);
    dyb[H] = dc * cp * sig_d(gf);
    dyb[2 * H] = dc * gi * (1.0f - gg * gg);
    dyb[3 * H] = dh * tc * sig_d(go);
    dc_c[at] = dc * gf;
  }
}

// out[n, r] = sum_g dy[n, g] W[r, g], W = [W_ctx; W_h] ([D + H, 4H]):
// rows r < D go to dctx_c, the others to dh_c. A warp per output row r,
// lanes along g (coalesced), kRows rows n per block from shared memory.
__global__ void __launch_bounds__(kThreads)
bwd_recurrent(const float* __restrict__ dy, const float* __restrict__ w_ctx,
              const float* __restrict__ w_h, float* __restrict__ dctx_c,
              float* __restrict__ dh_c, int N, int D, int H) {
  __shared__ float ys[kRows][kChunk];
  const int G = 4 * H;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int n0 = blockIdx.y * kRows;
  const int rows = min(kRows, N - n0);
  const float* wr = (r < D) ? w_ctx + (size_t)r * G : w_h + (size_t)(r - D) * G;
  float acc[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) acc[i] = 0.0f;
  for (int g0 = 0; g0 < G; g0 += kChunk) {
    const int gn = min(kChunk, G - g0);
    __syncthreads();
    for (int i = threadIdx.x; i < kRows * kChunk; i += kThreads) {
      const int rr = i / kChunk, gg = i % kChunk;
      ys[rr][gg] = (rr < rows && gg < gn) ? dy[(size_t)(n0 + rr) * G + g0 + gg] : 0.0f;
    }
    __syncthreads();
    if (r < D + H) {
      for (int gg = lane; gg < gn; gg += 32) {
        const float w = wr[g0 + gg];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i] += ys[i][gg] * w;
      }
    }
  }
  if (r >= D + H) return;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const float s = warp_sum(acc[i]);
    if (lane == 0 && i < rows) {
      const int n = n0 + i;
      if (r < D) dctx_c[(size_t)n * D + r] = s;
      else dh_c[(size_t)n * H + (r - D)] = s;
    }
  }
}

size_t max3(size_t a, size_t b, size_t c) { return a > b ? (a > c ? a : c) : (b > c ? b : c); }

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// Shared memory (bytes) the largest block of a backward step asks for.
extern "C" long long nsp_las_scan_bwd_smem_bytes(int T, int D, int A, int C, int K) {
  (void)T;
  const size_t f = max3(energy_bwd_smem_floats(A, C, K), conv_bwd_smem_floats(C, K),
                        max3((size_t)D, (size_t)kRows * A, 0));
  return (long long)(sizeof(float) * f);
}

#define F(x) static_cast<const float*>(x)
#define W(x) static_cast<float*>(x)

// K3b over U steps, N rows, time-major as K3 (nsp_las_scan_f32).
// Inputs: the weights w_ctx [D, 4H], w_h [H, 4H], w_q [A, H], conv_w
// [C, K], w_f [A, C], v [A]; kc [N, T, A], values [N, T, D], klens [N]
// int32, keep [U, N, H]; K3's saved gates [U, N, 4H], c_all [U, N, H],
// q_all [U, N, A], aw_all [U, N, T]; aw0 [N, T] (the step-0 weights,
// zeros); the upstream gradients dh_out [U, N, H] (w.r.t. each step's
// undropped h) and dctx_out [U, N, D]. Carries (zeroed by the caller):
// dh_c, dc_c [N, H], dctx_c [N, D], daw_c [N, T]; scratch daw, de [N, T],
// dloc [N, T, C], dq_part [ceil(T / 16), N, A]. Outputs: dy_all [U, N, 4H],
// dq_all [U, N, A]; accumulated into (zeroed by the caller) dkc [N, T, A],
// dvalues [N, T, D], dv_part [N * ceil(T / 16), A], dwf_part [N * ceil(T /
// 16), A, C], dconv_part [N * ceil(T / 16), C, K]. Returns a cudaError_t.
extern "C" int nsp_las_scan_bwd_f32(
    const void* w_ctx, const void* w_h, const void* w_q, const void* conv_w, const void* w_f,
    const void* v, const void* kc, const void* values, const void* klens, const void* keep,
    const void* gates, const void* c_all, const void* q_all, const void* aw_all,
    const void* aw0, const void* dh_out, const void* dctx_out, void* dh_c, void* dc_c,
    void* dctx_c, void* daw_c, void* daw, void* de, void* dloc, void* dq_part, void* dy_all,
    void* dq_all, void* dkc, void* dvalues, void* dv_part, void* dwf_part, void* dconv_part,
    int U, int N, int T, int H, int D, int A, int C, int K, void* stream) {
  if (U <= 0 || N <= 0 || T <= 0 || H <= 0 || D <= 0 || A <= 0 || C <= 0 || K <= 0 ||
      N > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tb = (T + kFrames - 1) / kFrames;
  const size_t nh = (size_t)N * H, nt = (size_t)N * T;
  const size_t ctx_smem = sizeof(float) * D;
  const size_t e_smem = sizeof(float) * energy_bwd_smem_floats(A, C, K);
  const size_t c_smem = sizeof(float) * conv_bwd_smem_floats(C, K);
  const size_t q_smem = sizeof(float) * kRows * A;
  cudaError_t err;
  if ((err = allow_smem(bwd_context, ctx_smem)) != cudaSuccess) return (int)err;
  if ((err = allow_smem(bwd_energy, e_smem)) != cudaSuccess) return (int)err;
  if ((err = allow_smem(bwd_conv, c_smem)) != cudaSuccess) return (int)err;
  if ((err = allow_smem(bwd_query_cell, q_smem)) != cudaSuccess) return (int)err;
  for (int t = U - 1; t >= 0; --t) {
    const float* aw_t = F(aw_all) + (size_t)t * nt;
    const float* aw_prev = (t > 0) ? F(aw_all) + (size_t)(t - 1) * nt : F(aw0);
    bwd_context<<<dim3((T + kWarps - 1) / kWarps, N), kThreads, ctx_smem, s>>>(
        F(dctx_out) + (size_t)t * N * D, F(dctx_c), F(daw_c), F(values), aw_t, W(daw),
        W(dvalues), T, D);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    bwd_softmax<<<N, kThreads, 0, s>>>(aw_t, F(daw), static_cast<const int*>(klens), W(de), T);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    bwd_energy<<<dim3(n_tb, N), kThreads, e_smem, s>>>(
        F(q_all) + (size_t)t * N * A, aw_prev, F(conv_w), F(w_f), F(v), F(kc), F(de), W(dkc),
        W(dloc), W(dq_part), W(dv_part), W(dwf_part), N, T, A, C, K);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    bwd_conv<<<dim3(n_tb, N), kThreads, c_smem, s>>>(F(dloc), aw_prev, F(conv_w), W(daw_c),
                                                     W(dconv_part), T, C, K);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    bwd_query_cell<<<dim3((H + kColThreads - 1) / kColThreads, (N + kRows - 1) / kRows),
                     kColThreads, q_smem, s>>>(
        F(dq_part), F(w_q), F(gates) + (size_t)t * nh * 4, F(c_all) + (size_t)t * nh,
        (t > 0) ? F(c_all) + (size_t)(t - 1) * nh : nullptr, F(keep) + (size_t)t * nh,
        F(dh_out) + (size_t)t * nh, F(dh_c), W(dc_c), W(dy_all) + (size_t)t * nh * 4,
        W(dq_all) + (size_t)t * N * A, N, H, A, n_tb);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    if (t > 0) {
      bwd_recurrent<<<dim3((D + H + kWarps - 1) / kWarps, (N + kRows - 1) / kRows), kThreads, 0,
                      s>>>(F(dy_all) + (size_t)t * nh * 4, F(w_ctx), F(w_h), W(dctx_c), W(dh_c),
                           N, D, H);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
  }
  return (int)cudaSuccess;
}

#undef F
#undef W
