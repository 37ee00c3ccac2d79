// K1: relative-position self-attention forward, float32, for sm_90a.
//
// Replaces the TPU kernel `_fwd_kernel` of
// neural_sp_tpu/ops/rel_attention_pallas.py (last present at 583dfc4~1),
// reached through `_call` / `_rel_attention_fwd`. Same semantics:
//
//   s[b,h,i,j] = q[b,h,i,:] . k[b,h,j,:] + p[b,h,i, min(|i-j|, R-1)]
//   s          = finfo(f32).min / 2            for keys j >= klens[b]
//   o[b,h,i,:] = sum_j softmax_j(s)[i,j] v[b,h,j,:]
//
// q and p come pre-scaled by 1/sqrt(dk). An unclamped table is R = T.
//
// What bounds it on the H100: the score tile is O(T^2 dk) multiply-adds
// against O(T dk) bytes per (b, h), so at T = 200..800 it is bound by
// arithmetic, here on the float32 SIMT pipes (f32 in this port; bf16 and
// wgmma come later). Design: one block per (query tile of 32, head,
// batch); the block walks key tiles of 32 with an online float32 softmax,
// so no [B,H,T,T] tensor is ever written to device memory, and it forms
// the rel-PE bias in-kernel from the [T, R] table. Key tiles past klens[b]
// are skipped: their weights exp(min/2 - max) are exactly 0 once one
// valid key was seen. With klens[b] == 0 every key is masked and the row
// gets uniform weights, as the masked softmax of the JAX module does.
//
// The forward also writes each row's softmax statistics, the running max
// m and the sum l of exp(s - m), for the backward (K1b, below): P = exp(s
// - m) / l. Both are kept instead of one log-sum-exp m + log l because a
// row with every key masked has m = finfo.min / 2, where adding log l
// would be absorbed and P would come out 1 instead of 1 / T.

#include <cuda_runtime.h>
#include <cfloat>
#include <math.h>

namespace {

constexpr int kBQ = 32;       // queries per block
constexpr int kBK = 32;       // keys per tile
constexpr int kThreads = 256; // thread (ty, tx) = (tid / 16, tid % 16)

// Reduce over the 16 lanes of one row group (lanes tx = 0..15).
__device__ __forceinline__ float group_max(float x) {
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float group_sum(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Thread (ty, tx) owns query rows 2*ty and 2*ty+1 of the tile, score
// columns tx and tx+16 of each key tile, and output columns tx + 16*m.
template <int DK>
__global__ void __launch_bounds__(kThreads)
rel_attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ p,
                         const int* __restrict__ klens, float* __restrict__ o,
                         float* __restrict__ m_out, float* __restrict__ l_out,
                         int H, int T, int R) {
  __shared__ float qs[kBQ][DK + 1];
  __shared__ float ks[kBK][DK + 1];
  __shared__ float vs[kBK][DK];
  __shared__ float ps[kBQ][kBK + 1];

  constexpr int kDM = DK / 16;
  const float kNeg = -FLT_MAX / 2.0f;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const float* qb = q + bh * T * DK;
  const float* kb = k + bh * T * DK;
  const float* vb = v + bh * T * DK;
  const float* pb = p + bh * T * R;

  for (int idx = tid; idx < kBQ * DK; idx += kThreads) {
    const int r = idx / DK, d = idx % DK, i = q0 + r;
    qs[r][d] = (i < T) ? qb[(size_t)i * DK + d] : 0.0f;
  }

  const int klen = klens[b];
  const int kend = (klen > 0) ? min(klen, T) : T;
  const int n_tiles = (kend + kBK - 1) / kBK;

  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.0f, 0.0f};
  float acc[2][kDM];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int m = 0; m < kDM; ++m) acc[r][m] = 0.0f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's ks/vs/ps reads are done
    for (int idx = tid; idx < kBK * DK; idx += kThreads) {
      const int c = idx / DK, d = idx % DK, j = k0 + c;
      const bool in = j < T;
      ks[c][d] = in ? kb[(size_t)j * DK + d] : 0.0f;
      vs[c][d] = in ? vb[(size_t)j * DK + d] : 0.0f;
    }
    __syncthreads();

    float s[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll 8
    for (int d = 0; d < DK; ++d) {
      const float qa = qs[2 * ty][d], qb2 = qs[2 * ty + 1][d];
      const float k_a = ks[tx][d], k_b = ks[tx + 16][d];
      s[0][0] += qa * k_a;  s[0][1] += qa * k_b;
      s[1][0] += qb2 * k_a; s[1][1] += qb2 * k_b;
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = q0 + 2 * ty + r;
      float tile_max = -INFINITY;
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int j = k0 + tx + 16 * m;
        float val;
        if (j >= T) {
          val = -INFINITY;  // not a key at all
        } else if (j >= klen) {
          val = kNeg;       // masked key, like apply_mask_logits
        } else {
          const int dist = min(abs(i - j), R - 1);
          val = s[r][m] + ((i < T) ? pb[(size_t)i * R + dist] : 0.0f);
        }
        s[r][m] = val;
        tile_max = fmaxf(tile_max, val);
      }
      tile_max = group_max(tile_max);
      const float m_new = fmaxf(m_run[r], tile_max);  // finite: column k0 < T
      const float alpha = expf(m_run[r] - m_new);
      float psum = 0.0f;
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const float e = expf(s[r][m] - m_new);
        s[r][m] = e;
        psum += e;
      }
      psum = group_sum(psum);
      l_run[r] = l_run[r] * alpha + psum;
      m_run[r] = m_new;
#pragma unroll
      for (int m = 0; m < kDM; ++m) acc[r][m] *= alpha;
      ps[2 * ty + r][tx] = s[r][0];
      ps[2 * ty + r][tx + 16] = s[r][1];
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float p0 = ps[2 * ty][c], p1 = ps[2 * ty + 1][c];
#pragma unroll
      for (int m = 0; m < kDM; ++m) {
        const float vv = vs[c][tx + 16 * m];
        acc[0][m] += p0 * vv;
        acc[1][m] += p1 * vv;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = q0 + 2 * ty + r;
    if (i >= T) continue;
    const float inv = 1.0f / l_run[r];
    if (tx == 0) {
      m_out[bh * T + i] = m_run[r];
      l_out[bh * T + i] = l_run[r];
    }
    float* ob = o + (bh * T + i) * DK;
#pragma unroll
    for (int m = 0; m < kDM; ++m) ob[tx + 16 * m] = acc[r][m] * inv;
  }
}

template <int DK>
cudaError_t launch(const float* q, const float* k, const float* v, const float* p,
                   const int* klens, float* o, float* m, float* l, int B, int H, int T,
                   int R, cudaStream_t stream) {
  dim3 grid((T + kBQ - 1) / kBQ, H, B);
  rel_attention_fwd_kernel<DK><<<grid, kThreads, 0, stream>>>(q, k, v, p, klens, o, m, l, H,
                                                              T, R);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: [B, H, T, dk]; p: [B, H, T, R]; klens: [B] int32; m, l:
// [B, H, T] row statistics. All contiguous, on the device of `stream`.
// Returns a cudaError_t.
extern "C" int nsp_rel_attention_f32(const void* q, const void* k, const void* v,
                                     const void* p, const void* klens, void* o, void* m,
                                     void* l, int B, int H, int T, int R, int dk,
                                     void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || R <= 0 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* pf = static_cast<const float*>(p);
  const int* kl = static_cast<const int*>(klens);
  float* of = static_cast<float*>(o);
  float* mf = static_cast<float*>(m);
  float* lf = static_cast<float*>(l);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dk) {
    case 16: return (int)launch<16>(qf, kf, vf, pf, kl, of, mf, lf, B, H, T, R, s);
    case 32: return (int)launch<32>(qf, kf, vf, pf, kl, of, mf, lf, B, H, T, R, s);
    case 64: return (int)launch<64>(qf, kf, vf, pf, kl, of, mf, lf, B, H, T, R, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
