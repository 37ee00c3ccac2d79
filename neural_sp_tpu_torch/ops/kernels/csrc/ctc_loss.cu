// K4: CTC loss, forward (alpha recurrence -> nll) and backward (beta
// recurrence -> dense d nll / d log_probs), float32, for sm_90a.
//
// Replaces the TPU kernels `_kernel` (`ctc_loss_pallas`, emit table
// prepared outside) and `_kernel_fused` (`ctc_loss_pallas_fused`, emit
// gathered in-kernel) of neural_sp_tpu/ops/ctc_pallas.py (last present at
// 63255ae~1): one kernel covers both and gathers lp[b, t, z[s]] in-kernel.
// The backward is the JAX package's `_ctc_nll_bwd` (ops/ctc.py, plain JAX
// there): the mirrored beta recurrence from the saved alphas, then
//   grad[b, t, z[s]] -= g[b] exp(min(alpha + beta + nll, 0)),
//   for t < T_b and s <= 2 U_b,
// summed over the states that share a vocabulary id (every blank, and
// repeated labels).
//
// Semantics as ops/ctc.py: extended labels z = [blank, y1, blank, ...,
// yU, blank] (S = 2U + 1, blank = 0), a skip from s-2 is allowed when
// z[s] != blank and z[s] != z[s-2]; log space with NEG_INF = -1e30 and the
// three-way logaddexp of `_logaddexp3`; frames t >= T_b freeze the alphas;
// an id outside [0, V) emits 0 (the one-hot contraction's value).
//
// What bounds it on the H100: the recurrence is T sequential steps of S
// independent states, so a step is latency, not bytes or flops (the
// gathers touch B * T * S floats of the [B, T, V] log-probs). Design: one
// block per utterance, threads over states, the alphas (or betas) of the
// current step in shared memory and one __syncthreads per step; the
// whole [B, T, S] alpha lattice is written for the backward (2.4 MB at
// B = 32, T = 188, S = 201). The backward scatters with atomicAdd into a
// zeroed dense gradient; only states of one utterance meet at one
// address, so contention is low.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kNegInf = -1.0e30f;
constexpr int kThreads = 256;

__device__ __forceinline__ float logaddexp3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  const float ms = fmaxf(m, kNegInf);
  const float out = ms + logf(expf(a - ms) + expf(b - ms) + expf(c - ms));
  return (m <= kNegInf) ? kNegInf : out;
}

// jnp.logaddexp for finite inputs
__device__ __forceinline__ float logaddexp2(float a, float b) {
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

__device__ __forceinline__ float emit(const float* lp_bt, int z, int V) {
  return (z >= 0 && z < V) ? lp_bt[z] : 0.0f;
}

// shared layout: z[S] (int), skip[S] (int), a0[S], a1[S]
__global__ void __launch_bounds__(kThreads)
ctc_alpha_kernel(const float* __restrict__ lp, const int* __restrict__ labels,
                 const int* __restrict__ tlens, const int* __restrict__ ulens,
                 float* __restrict__ alphas, float* __restrict__ nll,
                 int T, int V, int U) {
  extern __shared__ float smem[];
  const int S = 2 * U + 1;
  int* z = reinterpret_cast<int*>(smem);
  int* skip = z + S;
  float* cur = reinterpret_cast<float*>(skip + S);
  float* nxt = cur + S;
  const int b = blockIdx.x;
  const int tlen = tlens[b];
  const float* lpb = lp + (size_t)b * T * V;
  float* al = alphas + (size_t)b * T * S;

  for (int s = threadIdx.x; s < S; s += kThreads)
    z[s] = (s & 1) ? labels[(size_t)b * U + (s >> 1)] : 0;
  __syncthreads();
  for (int s = threadIdx.x; s < S; s += kThreads) {
    skip[s] = (s >= 2 && z[s] != 0 && z[s] != z[s - 2]) ? 1 : 0;
    const float a = (s <= 1) ? emit(lpb, z[s], V) : kNegInf;
    cur[s] = a;
    al[s] = a;
  }
  __syncthreads();
  for (int t = 1; t < T; ++t) {
    const float* lpt = lpb + (size_t)t * V;
    for (int s = threadIdx.x; s < S; s += kThreads) {
      float a = cur[s];
      if (t < tlen) {
        const float a1 = (s >= 1) ? cur[s - 1] : kNegInf;
        const float a2 = skip[s] ? cur[s - 2] : kNegInf;
        a = fmaxf(logaddexp3(cur[s], a1, a2) + emit(lpt, z[s], V), kNegInf);
      }
      nxt[s] = a;
      al[(size_t)t * S + s] = a;
    }
    __syncthreads();
    float* tmp = cur; cur = nxt; nxt = tmp;
  }
  if (threadIdx.x == 0) {
    const int ul = ulens[b];
    const int end = 2 * ul;
    const float a_end1 = (ul > 0) ? cur[end - 1] : kNegInf;
    nll[b] = -logaddexp2(cur[end], a_end1);
  }
}

// shared layout: z[S], skipf[S] (skip into s + 2), beta[S], b0[S]
__global__ void __launch_bounds__(kThreads)
ctc_beta_grad_kernel(const float* __restrict__ lp, const int* __restrict__ labels,
                     const int* __restrict__ tlens, const int* __restrict__ ulens,
                     const float* __restrict__ alphas, const float* __restrict__ nll,
                     const float* __restrict__ g, float* __restrict__ grad,
                     int T, int V, int U) {
  extern __shared__ float smem[];
  const int S = 2 * U + 1;
  int* z = reinterpret_cast<int*>(smem);
  int* skipf = z + S;
  float* beta = reinterpret_cast<float*>(skipf + S);
  float* b0 = beta + S;
  const int b = blockIdx.x;
  const int tlen = tlens[b];
  const int ul = ulens[b];
  const int end = 2 * ul;
  const int end1 = max(end - 1, 0);
  const float nllb = nll[b];
  const float gb = g[b];
  const float* lpb = lp + (size_t)b * T * V;
  const float* al = alphas + (size_t)b * T * S;
  float* gr = grad + (size_t)b * T * V;

  for (int s = threadIdx.x; s < S; s += kThreads)
    z[s] = (s & 1) ? labels[(size_t)b * U + (s >> 1)] : 0;
  __syncthreads();
  for (int s = threadIdx.x; s < S; s += kThreads) {
    const int s2 = s + 2;
    skipf[s] = (s2 < S && z[s2] != 0 && z[s2] != z[s]) ? 1 : 0;
    beta[s] = (s == end || s == end1) ? 0.0f : kNegInf;
  }
  __syncthreads();
  for (int t = T - 1; t >= 0; --t) {
    if (t < tlen - 1) {
      // beta holds step t + 1: b0 = beta_{t+1} + emit_{t+1}
      const float* lpn = lpb + (size_t)(t + 1) * V;
      for (int s = threadIdx.x; s < S; s += kThreads) b0[s] = beta[s] + emit(lpn, z[s], V);
      __syncthreads();
      for (int s = threadIdx.x; s < S; s += kThreads) {
        const float c1 = (s + 1 < S) ? b0[s + 1] : kNegInf;
        const float c2 = skipf[s] ? b0[s + 2] : kNegInf;
        beta[s] = fmaxf(logaddexp3(b0[s], c1, c2), kNegInf);
      }
      __syncthreads();
    }
    // t >= tlen - 1: beta stays the seed (0 at the two final states)
    if (t < tlen) {
      for (int s = threadIdx.x; s <= end && s < S; s += kThreads) {
        const float lg = al[(size_t)t * S + s] + beta[s] + nllb;
        const float gam = expf(fminf(lg, 0.0f));
        const int v = z[s];
        if (v >= 0 && v < V) atomicAdd(&gr[(size_t)t * V + v], -gb * gam);
      }
    }
  }
}

size_t smem_bytes(int U) { return (size_t)4 * (2 * U + 1) * sizeof(float); }

cudaError_t allow_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// Shared memory (bytes) one block needs for label length U.
extern "C" long long nsp_ctc_smem_bytes(int U) { return (long long)smem_bytes(U); }

// lp [B, T, V] log-probs; labels [B, U] int32; tlens, ulens [B] int32.
// Outputs alphas [B, T, 2U + 1], nll [B]. Returns a cudaError_t.
extern "C" int nsp_ctc_alpha_f32(const void* lp, const void* labels, const void* tlens,
                                 const void* ulens, void* alphas, void* nll, int B, int T,
                                 int V, int U, void* stream) {
  if (B <= 0 || T <= 0 || V <= 0 || U < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(U);
  cudaError_t err = allow_smem((const void*)ctc_alpha_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  ctc_alpha_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lp), static_cast<const int*>(labels),
      static_cast<const int*>(tlens), static_cast<const int*>(ulens),
      static_cast<float*>(alphas), static_cast<float*>(nll), T, V, U);
  return (int)cudaGetLastError();
}

// As above plus the saved alphas and nll, the upstream gradient g [B],
// and grad [B, T, V], which must be zeroed: the kernel adds into it.
extern "C" int nsp_ctc_beta_grad_f32(const void* lp, const void* labels, const void* tlens,
                                     const void* ulens, const void* alphas, const void* nll,
                                     const void* g, void* grad, int B, int T, int V, int U,
                                     void* stream) {
  if (B <= 0 || T <= 0 || V <= 0 || U < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(U);
  cudaError_t err = allow_smem((const void*)ctc_beta_grad_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  ctc_beta_grad_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lp), static_cast<const int*>(labels),
      static_cast<const int*>(tlens), static_cast<const int*>(ulens),
      static_cast<const float*>(alphas), static_cast<const float*>(nll),
      static_cast<const float*>(g), static_cast<float*>(grad), T, V, U);
  return (int)cudaGetLastError();
}
