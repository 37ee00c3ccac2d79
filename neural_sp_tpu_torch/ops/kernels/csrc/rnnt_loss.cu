// K5: the RNN transducer's lattice loss, forward (alpha recurrence -> nll)
// and backward (beta recurrence -> d nll / d blank_lp, d nll / d emit_lp),
// for sm_90a: float32 log-probs and gradients, the recurrences' log-space
// values in float64.
//
// Replaces `rnnt_alphas_from_pair` of neural_sp_tpu/ops/rnnt.py (plain
// JAX: a lax.scan over T with an associative scan over U in each frame),
// the port's counterpart of upstream's native warp_rnnt kernel. Semantics
// as there: blank [B, T, U+1] and emit [B, T, U] log-probs (emit already
// -1e30 past each row's label length), alpha[0, 0] = 0,
//   alpha[t, u] = logaddexp(alpha[t-1, u] + blank[t-1, u],
//                           alpha[t, u-1] + emit[t, u-1]),
// clamped at NEG_INF = -1e30, and
//   nll = -(alpha[T_b-1, U_b] + blank[T_b-1, U_b]),
// T_b clipped to [1, T] and U_b to [0, U] (JAX's gathers clip them). The
// backward is the closed form from the mirrored beta recurrence,
// beta[T_b-1, U_b] = blank[T_b-1, U_b]:
//   grad_blank[t, u] = -g exp(alpha[t, u] + blank[t, u] + beta[t+1, u] + nll)
//   grad_emit[t, u]  = -g exp(alpha[t, u] + emit[t, u] + beta[t, u+1] + nll)
// (beta[T_b, U_b] read as 0: the final blank), for t < T_b and u <= U_b
// (u < U_b for emit); the wrapper zeroes the rest.
//
// What bounds it on the H100: a cell depends on its left and lower
// neighbours, so the lattice is T_b + U_b sequential anti-diagonals of at
// most U_b + 1 independent cells: a diagonal is latency (a log-add-exp and
// a barrier), not bytes or flops. Design: one block per utterance, a thread
// per label position u (U + 1 <= 1024 threads), the sweep by anti-diagonals
// t + u = d with one __syncthreads per diagonal. A thread keeps its own
// cell's value of the last diagonal in a register (alpha[t-1, u], the blank
// move's source) and publishes it in shared memory for thread u + 1 (its
// emit move's source alpha[t, u-1]); two rows in turns, so one barrier a
// diagonal is enough. The cells' log-probs (and in the backward the saved
// alphas) do not depend on the recurrence, so a group of diagonals ahead is
// loaded into registers while the current group is computed: no diagonal
// waits for global memory. The backward is one pass: where a thread
// produces beta[t, u] it has beta[t+1, u] (its register) and beta[t, u+1]
// (shared memory), the two terms of the cell's occupancies, and writes both
// gradients there. Only the valid cells of each utterance are visited.
//
// Precision: a log alpha falls by about log V per frame and label (to
// about -4000 at T = 400, U = 200, V = 1,000), where float32 spaces its
// values 2.4e-4 apart; each cell rounds at that magnitude, and the
// occupancy exp(alpha + beta + nll) takes the roundings of both
// recurrences. So the values are float64 (in registers, in shared memory
// and the alphas saved for the backward), and only what is small is done
// in float32: the exponential of minus the difference to the maximum and
// the logarithm of one plus it, in [0, log 2]. The occupancy's exponent is
// summed in float64 and rounded once.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr double kNegInfD = -1.0e30;
constexpr int kMaxThreads = 1024;
constexpr int kAhead = 4;  // diagonals whose operands are loaded ahead

// jnp.logaddexp on float64 values: the maximum and the difference in
// float64, exp and log1p of it in float32.
__device__ __forceinline__ double logaddexp2(double a, double b) {
  const double m = fmax(a, b);
  if (m <= kNegInfD) return kNegInfD;
  return m + (double)log1pf(expf((float)-fabs(a - b)));
}

struct Row {
  int tb, ub;  // the clipped lengths
};

__device__ __forceinline__ Row row_lengths(const int* tlens, const int* ulens, int b, int T,
                                           int U) {
  return {min(max(tlens[b], 1), T), min(max(ulens[b], 0), U)};
}

// shared layout: two rows of U + 1 float64 values, the last diagonal's and
// this one's
__global__ void __launch_bounds__(kMaxThreads)
rnnt_alpha(const float* __restrict__ blank, const float* __restrict__ emit,
           const int* __restrict__ tlens, const int* __restrict__ ulens,
           double* __restrict__ alphas, float* __restrict__ nll, int T, int U) {
  extern __shared__ double smem[];
  const int U1 = U + 1, b = blockIdx.x, u = threadIdx.x;
  const Row r = row_lengths(tlens, ulens, b, T, U);
  double* cur = smem;
  double* nxt = smem + U1;
  const float* bl = blank + (size_t)b * T * U1;
  const float* em = emit + (size_t)b * T * U;
  double* al = alphas + (size_t)b * T * U1;
  const bool lane = u <= r.ub;  // this thread holds a label position
  const int n_diag = r.tb + r.ub;
  if (u < U1) cur[u] = kNegInfD;
  // the operands of the cell (d - u, u): blank[t-1, u] and emit[t, u-1]
  float ahead_b[kAhead], ahead_e[kAhead];
  auto load_group = [&](int d0) {
#pragma unroll
    for (int f = 0; f < kAhead; ++f) {
      const int t = d0 + f - u;
      const bool on = lane && t >= 0 && t < r.tb;
      ahead_b[f] = (on && t >= 1) ? __ldg(bl + (size_t)(t - 1) * U1 + u) : 0.0f;
      ahead_e[f] = (on && u >= 1) ? __ldg(em + (size_t)t * U + u - 1) : 0.0f;
    }
  };
  load_group(0);
  __syncthreads();
  double prev = kNegInfD;  // alpha[t-1, u]: this thread's last value
  for (int d0 = 0; d0 < n_diag; d0 += kAhead) {
    float wb[kAhead], we[kAhead];
#pragma unroll
    for (int f = 0; f < kAhead; ++f) {
      wb[f] = ahead_b[f];
      we[f] = ahead_e[f];
    }
    load_group(d0 + kAhead);
#pragma unroll
    for (int f = 0; f < kAhead; ++f) {
      const int d = d0 + f;
      if (d >= n_diag) break;  // the same for every thread of the block
      const int t = d - u;
      double a = kNegInfD;
      if (lane && t >= 0 && t < r.tb) {
        if (d == 0) {
          a = 0.0;
        } else {
          const double from_blank = (t >= 1) ? prev + (double)wb[f] : kNegInfD;
          const double from_emit = (u >= 1) ? cur[u - 1] + (double)we[f] : kNegInfD;
          a = fmax(logaddexp2(from_blank, from_emit), kNegInfD);
        }
        al[(size_t)t * U1 + u] = a;
        if (u == r.ub && t == r.tb - 1)
          nll[b] = (float)-(a + (double)__ldg(bl + (size_t)t * U1 + u));
      }
      prev = a;
      if (u < U1) nxt[u] = a;
      __syncthreads();
      double* tmp = cur; cur = nxt; nxt = tmp;
    }
  }
}

// shared layout as the forward's: beta of the last diagonal and this one's
__global__ void __launch_bounds__(kMaxThreads)
rnnt_beta_grad(const float* __restrict__ blank, const float* __restrict__ emit,
               const int* __restrict__ tlens, const int* __restrict__ ulens,
               const double* __restrict__ alphas, const float* __restrict__ g,
               float* __restrict__ grad_blank, float* __restrict__ grad_emit, int T, int U) {
  extern __shared__ double smem[];
  const int U1 = U + 1, b = blockIdx.x, u = threadIdx.x;
  const Row r = row_lengths(tlens, ulens, b, T, U);
  double* cur = smem;
  double* nxt = smem + U1;
  const size_t off = (size_t)b * T * U1, off_e = (size_t)b * T * U;
  const float* bl = blank + off;
  const float* em = emit + off_e;
  const double* al = alphas + off;
  float* gb = grad_blank + off;
  float* ge = grad_emit + off_e;
  const bool lane = u <= r.ub;
  const int n_diag = r.tb + r.ub;
  const float gg = g[b];
  // the nll from the saved last cell, in float64
  const size_t last = (size_t)(r.tb - 1) * U1 + r.ub;
  const double nllb = -(al[last] + (double)bl[last]);
  if (u < U1) cur[u] = kNegInfD;
  // the operands of the cell (d - u, u): blank, emit and the saved alpha
  float ahead_b[kAhead], ahead_e[kAhead];
  double ahead_a[kAhead];
  auto load_group = [&](int d0) {  // diagonals d0, d0 - 1, .., d0 - kAhead + 1
#pragma unroll
    for (int f = 0; f < kAhead; ++f) {
      const int t = d0 - f - u;
      const bool on = lane && t >= 0 && t < r.tb;
      ahead_b[f] = on ? __ldg(bl + (size_t)t * U1 + u) : 0.0f;
      ahead_e[f] = (on && u < r.ub) ? __ldg(em + (size_t)t * U + u) : 0.0f;
      ahead_a[f] = on ? __ldg(al + (size_t)t * U1 + u) : 0.0;
    }
  };
  load_group(n_diag - 1);
  __syncthreads();
  // beta[t+1, u]: this thread's last value; at the final cell the final
  // blank's 0
  double below = (u == r.ub) ? 0.0 : kNegInfD;
  for (int d0 = n_diag - 1; d0 >= 0; d0 -= kAhead) {
    float wb[kAhead], we[kAhead];
    double wa[kAhead];
#pragma unroll
    for (int f = 0; f < kAhead; ++f) {
      wb[f] = ahead_b[f];
      we[f] = ahead_e[f];
      wa[f] = ahead_a[f];
    }
    load_group(d0 - kAhead);
#pragma unroll
    for (int f = 0; f < kAhead; ++f) {
      const int d = d0 - f;
      if (d < 0) break;  // the same for every thread of the block
      const int t = d - u;
      double beta = kNegInfD;
      if (lane && t >= 0 && t < r.tb) {
        const double xb = below + (double)wb[f];
        const double xe = (u < r.ub) ? cur[u + 1] + (double)we[f] : kNegInfD;
        beta = fmax(logaddexp2(xb, xe), kNegInfD);
        const size_t cell = (size_t)t * U1 + u;
        gb[cell] = -gg * expf(fminf((float)(wa[f] + xb + nllb), 0.0f));
        if (u < r.ub)
          ge[(size_t)t * U + u] = -gg * expf(fminf((float)(wa[f] + xe + nllb), 0.0f));
        below = beta;
      }
      if (u < U1) nxt[u] = beta;
      __syncthreads();
      double* tmp = cur; cur = nxt; nxt = tmp;
    }
  }
}

int threads_for(int U) { return ((U + 1 + 31) / 32) * 32; }

size_t smem_bytes(int U) { return (size_t)2 * (U + 1) * sizeof(double); }

}  // namespace

// The most labels the kernels hold (a thread per label position and blank).
extern "C" int nsp_rnnt_max_labels() { return kMaxThreads - 1; }

// blank [B, T, U + 1], emit [B, T, U] log-probs; tlens, ulens [B] int32.
// Outputs alphas [B, T, U + 1] (float64; only each utterance's valid cells
// are written) and nll [B]. Returns a cudaError_t.
extern "C" int nsp_rnnt_alpha_f32(const void* blank, const void* emit, const void* tlens,
                                  const void* ulens, void* alphas, void* nll, int B, int T,
                                  int U, void* stream) {
  if (B <= 0 || T <= 0 || U < 0 || U + 1 > kMaxThreads) return (int)cudaErrorInvalidValue;
  rnnt_alpha<<<B, threads_for(U), smem_bytes(U), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(blank), static_cast<const float*>(emit),
      static_cast<const int*>(tlens), static_cast<const int*>(ulens),
      static_cast<double*>(alphas), static_cast<float*>(nll), T, U);
  return (int)cudaGetLastError();
}

// As above plus the saved alphas, the upstream gradient g [B] and the two
// gradients grad_blank [B, T, U + 1] and grad_emit [B, T, U], which must
// be zeroed (the kernel writes the valid cells). Returns a cudaError_t.
extern "C" int nsp_rnnt_beta_grad_f32(const void* blank, const void* emit, const void* tlens,
                                      const void* ulens, const void* alphas, const void* g,
                                      void* grad_blank, void* grad_emit, int B, int T, int U,
                                      void* stream) {
  if (B <= 0 || T <= 0 || U < 0 || U + 1 > kMaxThreads) return (int)cudaErrorInvalidValue;
  rnnt_beta_grad<<<B, threads_for(U), smem_bytes(U), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(blank), static_cast<const float*>(emit),
      static_cast<const int*>(tlens), static_cast<const int*>(ulens),
      static_cast<const double*>(alphas), static_cast<const float*>(g),
      static_cast<float*>(grad_blank), static_cast<float*>(grad_emit), T, U);
  return (int)cudaGetLastError();
}
