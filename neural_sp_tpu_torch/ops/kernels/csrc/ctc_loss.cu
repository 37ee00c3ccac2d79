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
// gathers touch B * T * S floats of the [B, T, V] log-probs); the backward
// adds into a zeroed dense gradient, and zeroing its B * T * V floats is
// the byte bound of the whole loss (the wrapper's memset, outside these
// kernels). Design: one block of 256 threads per utterance, a thread per
// state (1, 2, 4, 8 or 16 states a thread: up to 4096 states, 2047
// labels), the alphas (or beta + emission) of the current frame in shared
// memory and one __syncthreads per frame. Nothing is fetched from global
// memory inside a frame: the emissions lp[b, t, z[s]], a gather that
// depends on no alpha, and in the backward the saved alphas, are loaded a
// group of frames ahead into registers (eight frames up to four states a
// thread, four frames for 8 states, two for 16, so that the registers
// hold them), so a frame is the chain shared memory -> log-add-exp ->
// shared memory -> barrier, and the backward is one pass per frame (the
// emission is added where beta is produced, not in a pass of its own).
// The whole [B, T, S] alpha lattice is written for the backward (2.4 MB at
// B = 32, T = 188, S = 201), fire and forget. The backward sums the states
// that share a vocabulary id in a fixed order, so its gradient is the same
// bits in every run (no float atomics): every blank state of an utterance
// (101 of 201) meets at grad[b, t, 0], so their occupancies are summed
// inside each warp by a fixed shuffle tree and each warp stores its sum to
// the frame's scratch row; a label seen once stores its occupancy (no
// other state writes that address); a repeated label stores its own to
// the scratch row. After the last frame the eight warp sums of each frame
// are added in warp order, and each repeated label's occurrences in label
// order by the first of them.
// 32 blocks leave 100 SMs idle: latency, not occupancy, sets the time.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kNegInf = -1.0e30f;
constexpr int kThreads = 256;

// jnp.logaddexp for finite inputs
__device__ __forceinline__ float logaddexp2(float a, float b) {
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

// A block per utterance and a barrier per frame; nothing a frame needs
// from global memory is asked for inside the frame: a thread holds its SPT
// states' ids in registers (state s = thread + 256 i) and loads their
// emissions (the backward: and their saved alphas) of the next AHEAD
// frames while the current AHEAD frames are computed. What is left of a
// frame is the chain shared memory -> log-add-exp -> shared memory ->
// barrier.
constexpr int kMaxSpt = 16;  // states per thread: the kernels reach 4096 states

// _logaddexp3 of ops/ctc.py; the exponentials of values <= 0 on the fast
// path (exact to float32 rounding of a sum in [1, 3]).
__device__ __forceinline__ float lse3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  const float ms = fmaxf(m, kNegInf);
  const float out = ms + logf(__expf(a - ms) + __expf(b - ms) + __expf(c - ms));
  return (m <= kNegInf) ? kNegInf : out;
}

// A thread's states: their ids (0 for a blank or past S), whether the id
// has an emission column, and whether the state takes the skip transition
// (from s - 2 when fwd, else into s + 2).
template <int SPT>
struct States {
  int z[SPT];
  bool in[SPT], skip[SPT];
};

template <int SPT>
__device__ __forceinline__ States<SPT> thread_states(const int* __restrict__ lab, int U, int V,
                                                     bool fwd) {
  States<SPT> st;
  const int S = 2 * U + 1;
#pragma unroll
  for (int i = 0; i < SPT; ++i) {
    const int s = threadIdx.x + i * kThreads, u = s >> 1;
    const bool label = (s & 1) && s < S;
    const int z = label ? lab[u] : 0;
    st.z[i] = z;
    st.in[i] = s < S && z >= 0 && z < V;
    if (fwd) {
      st.skip[i] = label && u >= 1 && z != 0 && z != lab[u - 1];
    } else {
      st.skip[i] = label && u + 1 < U && lab[u + 1] != 0 && lab[u + 1] != z;
    }
  }
  return st;
}

// shared layout: a0[S], a1[S]
template <int SPT, int AHEAD>
__global__ void __launch_bounds__(kThreads)
ctc_alpha_ahead(const float* __restrict__ lp, const int* __restrict__ labels,
                const int* __restrict__ tlens, const int* __restrict__ ulens,
                float* __restrict__ alphas, float* __restrict__ nll, int T, int V, int U) {
  extern __shared__ float smem[];
  const int S = 2 * U + 1;
  float* cur = smem;
  float* nxt = cur + S;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int tl = min(tlens[b], T);
  const float* lpb = lp + (size_t)b * T * V;
  float* al = alphas + (size_t)b * T * S;
  const States<SPT> st = thread_states<SPT>(labels + (size_t)b * U, U, V, true);
  // the emissions of frame t for the thread's states (0 for an id outside
  // [0, V), as the one-hot contraction)
  auto load = [&](float (&em)[SPT], int t) {
#pragma unroll
    for (int i = 0; i < SPT; ++i) em[i] = st.in[i] ? __ldg(lpb + (size_t)t * V + st.z[i]) : 0.0f;
  };
  float ahead[AHEAD][SPT];
  auto load_group = [&](int t) {  // frames t .. t + AHEAD - 1, those below tl
#pragma unroll
    for (int f = 0; f < AHEAD; ++f)
      if (t + f < tl) load(ahead[f], t + f);
  };
  {
    float em[SPT];
    load(em, 0);
    load_group(1);
#pragma unroll
    for (int i = 0; i < SPT; ++i) {
      const int s = tid + i * kThreads;
      if (s >= S) continue;
      const float a = (s <= 1) ? em[i] : kNegInf;
      cur[s] = a;
      al[s] = a;
    }
  }
  __syncthreads();
  for (int t0 = 1; t0 < tl; t0 += AHEAD) {
    float em[AHEAD][SPT];
#pragma unroll
    for (int f = 0; f < AHEAD; ++f)
#pragma unroll
      for (int i = 0; i < SPT; ++i) em[f][i] = ahead[f][i];
    load_group(t0 + AHEAD);
#pragma unroll
    for (int f = 0; f < AHEAD; ++f) {
      const int t = t0 + f;
      if (t >= tl) break;
#pragma unroll
      for (int i = 0; i < SPT; ++i) {
        const int s = tid + i * kThreads;
        if (s >= S) continue;
        const float a1 = (s >= 1) ? cur[s - 1] : kNegInf;
        const float a2 = st.skip[i] ? cur[s - 2] : kNegInf;
        const float a = fmaxf(lse3(cur[s], a1, a2) + em[f][i], kNegInf);
        nxt[s] = a;
        al[(size_t)t * S + s] = a;
      }
      __syncthreads();
      float* tmp = cur; cur = nxt; nxt = tmp;
    }
  }
  // frames past the utterance's keep the last alphas
#pragma unroll
  for (int i = 0; i < SPT; ++i) {
    const int s = tid + i * kThreads;
    if (s >= S) continue;
    const float a = cur[s];
    for (int t = max(tl, 1); t < T; ++t) al[(size_t)t * S + s] = a;
  }
  if (tid == 0) {
    const int ul = ulens[b];
    const int end = 2 * ul;
    const float a_end1 = (ul > 0) ? cur[end - 1] : kNegInf;
    nll[b] = -logaddexp2(cur[end], a_end1);
  }
}

// What a backward thread's state does with its occupancy: a blank (or a
// label of id 0) joins the warp's blank sum; a label seen once in the
// utterance stores it; a repeated label stores it to the scratch, where
// after the last frame the first of the repeats (a head) adds them up.
enum Role : int { kBlank, kSolo, kRepeat, kNone };

constexpr int kWarps = kThreads / 32;

// shared layout: b0[S], b1[S]: beta + emission of the frame after, in
// turns; next[U] (int): the next occurrence of label u's id, -1 after the
// last; heads[U] and their count (int): the first occurrences of repeated
// ids. The scratch row of a frame (8 + U floats): each warp's blank sum,
// then the repeated labels' occupancies.
template <int SPT, int AHEAD>
__global__ void __launch_bounds__(kThreads)
ctc_beta_grad_ahead(const float* __restrict__ lp, const int* __restrict__ labels,
                    const int* __restrict__ tlens, const int* __restrict__ ulens,
                    const float* __restrict__ alphas, const float* __restrict__ nll,
                    const float* __restrict__ g, float* __restrict__ grad,
                    float* __restrict__ scratch, int T, int V, int U) {
  extern __shared__ float smem[];
  const int S = 2 * U + 1, row = kWarps + U;
  float* cur = smem;   // beta_{t+1} + emit_{t+1}, what frame t reads
  float* nxt = cur + S;
  int* next = reinterpret_cast<int*>(nxt + S);
  int* heads = next + U;
  int* n_heads = heads + U;
  const int b = blockIdx.x, tid = threadIdx.x, warp = tid >> 5;
  const int tl = min(tlens[b], T);
  if (tl <= 0) return;
  if (tid == 0) *n_heads = 0;
  const int ul = ulens[b];
  const int end = 2 * ul, end1 = max(end - 1, 0);
  const float nllb = nll[b], gb = g[b];
  const float* lpb = lp + (size_t)b * T * V;
  const float* al = alphas + (size_t)b * T * S;
  const int* lab = labels + (size_t)b * U;
  float* gr = grad + (size_t)b * T * V;
  float* parts = scratch + (size_t)b * T * row;
  const States<SPT> st = thread_states<SPT>(lab, U, V, false);
  // frame t's operands for the thread's states: their emissions and their
  // saved alphas (only the states up to `end` take part in the gradient)
  float ahead_em[AHEAD][SPT], ahead_al[AHEAD][SPT];
  auto load_group = [&](int t) {  // frames t, t - 1, .., t - AHEAD + 1, those >= 0
#pragma unroll
    for (int f = 0; f < AHEAD; ++f) {
      const int tt = t - f;
      if (tt < 0) continue;
#pragma unroll
      for (int i = 0; i < SPT; ++i) {
        const int s = tid + i * kThreads;
        ahead_em[f][i] = st.in[i] ? __ldg(lpb + (size_t)tt * V + st.z[i]) : 0.0f;
        ahead_al[f][i] = (s <= end && s < S) ? __ldg(al + (size_t)tt * S + s) : 0.0f;
      }
    }
  };
  load_group(tl - 1);
  __syncthreads();  // n_heads is 0
  // each label's role and the next occurrence of its id (labels u < ul),
  // while the first frames' operands load; the heads listed (in any
  // order: each adds its own id's column)
  int role[SPT];
#pragma unroll
  for (int i = 0; i < SPT; ++i) {
    const int s = tid + i * kThreads, u = s >> 1;
    role[i] = (s > end || s >= S) ? kNone : (!(s & 1) || st.z[i] == 0) ? kBlank
              : st.in[i] ? kSolo : kNone;
    if (role[i] == kSolo) {
      bool before = false;
      int after = -1;
      for (int v = 0; v < ul; ++v) {
        if (v == u || lab[v] != st.z[i]) continue;
        if (v < u) before = true;
        else if (after < 0) after = v;
      }
      next[u] = after;
      if (before || after >= 0) role[i] = kRepeat;
      if (!before && after >= 0) heads[atomicAdd(n_heads, 1)] = u;
    }
  }
  for (int t0 = tl - 1; t0 >= 0; t0 -= AHEAD) {
    float em[AHEAD][SPT], av[AHEAD][SPT];
#pragma unroll
    for (int f = 0; f < AHEAD; ++f)
#pragma unroll
      for (int i = 0; i < SPT; ++i) {
        em[f][i] = ahead_em[f][i];
        av[f][i] = ahead_al[f][i];
      }
    load_group(t0 - AHEAD);
#pragma unroll
    for (int f = 0; f < AHEAD; ++f) {
      const int t = t0 - f;
      if (t < 0) break;
      float* part = parts + (size_t)t * row;
      float blank = 0.0f;  // the thread's blanks' occupancies, in state order
#pragma unroll
      for (int i = 0; i < SPT; ++i) {
        const int s = tid + i * kThreads;
        if (s >= S) continue;
        float beta;
        if (t == tl - 1) {  // the seed: 0 at the two final states
          beta = (s == end || s == end1) ? 0.0f : kNegInf;
        } else {
          const float c1 = (s + 1 < S) ? cur[s + 1] : kNegInf;
          const float c2 = st.skip[i] ? cur[s + 2] : kNegInf;
          beta = fmaxf(lse3(cur[s], c1, c2), kNegInf);
        }
        nxt[s] = beta + em[f][i];
        if (role[i] == kNone) continue;
        const float gam = -gb * __expf(fminf(av[f][i] + beta + nllb, 0.0f));
        if (role[i] == kBlank) blank += gam;
        else if (role[i] == kSolo) gr[(size_t)t * V + st.z[i]] = gam;
        else part[kWarps + (s >> 1)] = gam;
      }
      // the blanks: a fixed shuffle tree inside the warp, one store a warp
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) blank += __shfl_xor_sync(0xffffffffu, blank, o);
      if ((tid & 31) == 0) part[warp] = blank;
      __syncthreads();
      float* tmp = cur; cur = nxt; nxt = tmp;
    }
  }
  __syncthreads();  // the scratch rows, next[] and heads[] are written
  // a thread per frame: the warps' blank sums in warp order, then each
  // repeated id's occurrences in label order
  const int nh = *n_heads;
  for (int t = tid; t < tl; t += kThreads) {
    const float* part = parts + (size_t)t * row;
    float sum = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += part[w];
    gr[(size_t)t * V] = sum;
    for (int h = 0; h < nh; ++h) {
      const int u = heads[h];
      sum = part[kWarps + u];
      for (int v = next[u]; v >= 0; v = next[v]) sum += part[kWarps + v];
      gr[(size_t)t * V + lab[u]] = sum;
    }
  }
}

// two rows of S floats: the current frame's and the next one's
size_t smem_bytes(int U) { return (size_t)2 * (2 * U + 1) * sizeof(float); }

// the backward's: the two rows, the labels' next occurrences and the heads
size_t bwd_smem_bytes(int U) { return smem_bytes(U) + (size_t)(2 * U + 1) * sizeof(int); }

}  // namespace

// The longest label sequence the kernels hold.
extern "C" int nsp_ctc_max_labels() { return (kMaxSpt * kThreads - 1) / 2; }

// lp [B, T, V] log-probs; labels [B, U] int32; tlens, ulens [B] int32.
// Outputs alphas [B, T, 2U + 1], nll [B]. Returns a cudaError_t.
extern "C" int nsp_ctc_alpha_f32(const void* lp, const void* labels, const void* tlens,
                                 const void* ulens, void* alphas, void* nll, int B, int T,
                                 int V, int U, void* stream) {
  if (B <= 0 || T <= 0 || V <= 0 || U < 0) return (int)cudaErrorInvalidValue;
  const int S = 2 * U + 1;
  if (S > kMaxSpt * kThreads) return (int)cudaErrorInvalidValue;
  auto launch = [&](auto kernel) {
    kernel<<<B, kThreads, smem_bytes(U), static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(lp), static_cast<const int*>(labels),
        static_cast<const int*>(tlens), static_cast<const int*>(ulens),
        static_cast<float*>(alphas), static_cast<float*>(nll), T, V, U);
    return (int)cudaGetLastError();
  };
  if (S <= kThreads) return launch(ctc_alpha_ahead<1, 8>);
  if (S <= 2 * kThreads) return launch(ctc_alpha_ahead<2, 8>);
  if (S <= 4 * kThreads) return launch(ctc_alpha_ahead<4, 8>);
  if (S <= 8 * kThreads) return launch(ctc_alpha_ahead<8, 4>);
  return launch(ctc_alpha_ahead<16, 2>);
}

// As above plus the saved alphas and nll, the upstream gradient g [B],
// grad [B, T, V], which must be zeroed (the kernel writes only the ids the
// labels and the blank emit, at frames t < T_b), and the scratch
// [B, T, 8 + U]. Returns a cudaError_t.
extern "C" int nsp_ctc_beta_grad_f32(const void* lp, const void* labels, const void* tlens,
                                     const void* ulens, const void* alphas, const void* nll,
                                     const void* g, void* grad, void* scratch, int B, int T,
                                     int V, int U, void* stream) {
  if (B <= 0 || T <= 0 || V <= 0 || U < 0) return (int)cudaErrorInvalidValue;
  const int S = 2 * U + 1;
  if (S > kMaxSpt * kThreads) return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_smem_bytes(U);
  auto launch = [&](auto kernel) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(lp), static_cast<const int*>(labels),
        static_cast<const int*>(tlens), static_cast<const int*>(ulens),
        static_cast<const float*>(alphas), static_cast<const float*>(nll),
        static_cast<const float*>(g), static_cast<float*>(grad),
        static_cast<float*>(scratch), T, V, U);
    return (int)cudaGetLastError();
  };
  if (S <= kThreads) return launch(ctc_beta_grad_ahead<1, 8>);
  if (S <= 2 * kThreads) return launch(ctc_beta_grad_ahead<2, 8>);
  if (S <= 4 * kThreads) return launch(ctc_beta_grad_ahead<4, 8>);
  if (S <= 8 * kThreads) return launch(ctc_beta_grad_ahead<8, 4>);
  return launch(ctc_beta_grad_ahead<16, 2>);
}
